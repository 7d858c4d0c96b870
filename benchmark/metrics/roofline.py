"""The least time of each hand-written kernel's work on one NVIDIA H100
(SXM, dense rates, 700 W): the operations and bytes of the LIVE work of
each call, each input byte read once and each output byte written once,
over the published peaks. Padding rows of the class, node and label axes
are not work: a class row of zero requests, a node row of zero
allocatable, and an incidence row or label column with no entry are left
out."""

PEAK_BYTES_S = 3.35e12       # HBM3
PEAK_INT8_OPS_S = 1.979e15   # int8 tensor cores, dense


def capacity_bytes(c: int, n: int, r: int, headroom: bool) -> int:
    """The capacity kernel for c classes on n nodes over r resource
    columns: pod_req [c, r] int32 and the zero-request flags [c] in,
    alloc and requested [n, r] int32 in, fit [c, n] bool out; the
    headroom call also reads pod_count and allowed_pods [n] int32 and
    writes cap [c, n] int32."""
    b = 4 * c * r + c + 2 * 4 * n * r + c * n
    if headroom:
        b += 2 * 4 * n + 4 * c * n
    return b


def incidence_ops(m: int, n: int, l: int) -> int:
    return 2 * m * n * l


def incidence_bytes(m: int, n: int, l: int) -> int:
    """A [m, l] int32 and B_t [n, l] int8 in, C [m, n] int32 out."""
    return 4 * m * l + n * l + 4 * m * n


class CapacityWork:
    """Notes each capacity call's class and node operands by identity (the
    class encoding and the node arrays are reused across calls, so few
    distinct tensors are held) and counts their live rows after the
    window, with the card idle."""

    def __init__(self):
        self.calls = []
        self.keep = {}

    def note(self, name, args, kwargs):
        req = args[0]
        alloc = args[1] if name == "capacity_fit" else args[2]
        self.keep[id(req)] = req
        self.keep[id(alloc)] = alloc
        self.calls.append((id(req), id(alloc), int(req.shape[1]),
                           name == "capacity_headroom"))

    def least_s(self) -> float:
        live = {k: int((t != 0).any(dim=1).sum()) for k, t in
                self.keep.items()}
        return sum(capacity_bytes(live[c], live[n], r, h)
                   for c, n, r, h in self.calls) / PEAK_BYTES_S


class IncidenceWork:
    """Counts each incidence call's live rows of A and B_t and the label
    columns both use, on the device without a wait (three small
    reductions a call; the calls are few), and reads them after the
    window."""

    def __init__(self):
        self.calls = []

    def note(self, name, args, kwargs):
        import torch
        a, b_t = args[0], args[1]
        if a.numel() == 0 or b_t.numel() == 0:
            return
        an, bn = a != 0, b_t != 0
        self.calls.append(torch.stack([an.any(dim=1).sum(),
                                       bn.any(dim=1).sum(),
                                       (an.any(dim=0) & bn.any(dim=0)).sum()]))

    def least_s(self) -> float:
        total = 0.0
        for t in self.calls:
            m, n, l = (int(v) for v in t.tolist())
            total += max(incidence_ops(m, n, l) / PEAK_INT8_OPS_S,
                         incidence_bytes(m, n, l) / PEAK_BYTES_S)
        return total


def share(run, kernel: str):
    """100 x least time / device time of `kernel` in the traced window;
    None where the kernel did not run on the card there."""
    from benchmark.lib.devtrace import kernel_specs
    if run.trace is None:
        return None
    dev = run.trace.device_s(kernel_specs()[kernel]["symbols"])
    least = run.least_s.get(kernel, 0.0)
    if dev <= 0 or least <= 0:
        return None
    return 100.0 * least / dev
