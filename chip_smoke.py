#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kubernetes_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (CUDA_HOME, default /usr/local/cuda). It
exits non-zero, without a result line, when either is missing or any
phase fails. Phases:

  1. build both CUDA kernels from csrc/ and print the card and its power
     limit;
  2. hold each kernel against its plain PyTorch version on the card
     (exact equality) at the main path's shapes and at ragged ones: for
     the capacity kernel both outputs (the mask without and with the
     zero-request override, and the wave call's mask and headroom), also
     with over-committed nodes, pod counts past their ceiling, int32
     extremes that wrap and R = 12 and 40 (past the kernel's register
     window), and refused arguments; for the incidence kernel also
     wide-weight rows (entries up to +-2^22), int32 extremes whose sums
     still fit int32, L % 16 == 8, the wrapper's padding of L and of
     misaligned operands, and a refused launch plan. Time kernel, plain
     version, library yardstick and bound: `ms` is the time of
     back-to-back calls through the wrapper (the kernels line's figure);
     beside it `device_ms`, device time with the host's enqueue hidden,
     and (incidence) `cold_ms`, device time of one call with L2 flushed
     (dirty, and clean after a read-back); the pre-pass's share
     (profiler) and the launch plan per shape; capacity_fit's device-only
     time from the profiler, and the wave call (capacity_headroom) the
     same ways under `wave_*` keys;
  3. run the wave engine at 512 nodes x 3,000 binpack pods on the card and
     on the CPU: every placement, fit count and the RR counter agree;
  4. the main path: drain 30,000 density pods, then 30,000 binpack pods
     (fresh cache), on 5,000 hollow nodes through
     SchedulingEngine.schedule(mode="wave"), and audit the placements from
     the cache (capacity, pod caps, unplaced pods fit nowhere); the
     capacity kernel ran once per wave (plus once per pod of a strict-loop
     finish), and both its outputs equal their plain versions on each
     drain's end state;
  5. the extender verdict: evaluate_pod for affinity probes against a
     5,000-node cluster holding 3,000 bound mixed-affinity pods, on the
     card and on the CPU: fits and scores agree;
  6. print the per-kernel summary line, then the result line.

Launch counts are zeroed just before each main-path run (phases 4 and 5)
and read just after it; launches made by the comparisons do not count.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate for their type
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12      # float32 outside the tensor cores
INT8_TENSOR_OPS_PER_S = 1979e12  # int8 tensor cores

N_NODES = 5000
N_PODS = 30000
I32_MAX = 2 ** 31 - 1
FLUSH_BYTES = 256 << 20     # written between cold launches; L2 is 50 MB


def log(*a) -> None:
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_facts(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    return out[0] if out else ""


def log_clocks(when: str) -> None:
    log(f"card {when}: sm clock, max sm clock, power draw, limit, "
        f"temperature: " + card_facts(
            "clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"))


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Wrapper time: median over `rounds` of (CUDA-event time of `reps`
    back-to-back calls) / reps, after a warm-up. Where the host's path
    through a call is longer than its device work, this is the host's."""
    import torch
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


_SPIN_CYCLES_PER_MS = []


def _spin(ms: float) -> None:
    """Keep the stream busy for about `ms` (a spin kernel), so that what
    the host enqueues meanwhile runs back to back after it."""
    import torch
    if not _SPIN_CYCLES_PER_MS:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        a.record()
        torch.cuda._sleep(10_000_000)
        b.record()
        b.synchronize()
        _SPIN_CYCLES_PER_MS.append(10_000_000 / a.elapsed_time(b))
    torch.cuda._sleep(int(ms * _SPIN_CYCLES_PER_MS[0]))


def time_device_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time: as time_ms, but the calls are enqueued behind a spin
    kernel, so the events bracket device work only (back to back, operands
    warm in L2). The spin is doubled until the enqueue fits inside it."""
    import torch
    fn()
    torch.cuda.synchronize()
    spin_ms, per = 2.0, []
    while len(per) < rounds:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        _spin(spin_ms)
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        b.synchronize()
        if host_ms > 0.8 * spin_ms:
            if spin_ms >= 1000:
                fail(f"time_device_ms: {reps} calls take {host_ms:.1f} ms "
                     f"to enqueue behind a {spin_ms:.0f} ms spin (the call "
                     f"waits for the device)")
            spin_ms *= 2
            continue
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


def time_cold_ms(fn, flush, clean: bool = False, reps: int = 15) -> float:
    """Device time of one call with L2 cold: before each call, write the
    `flush` buffer (larger than the 50 MB L2), then enqueue the call behind
    a spin kernel and time it alone with its own events. Median. The
    written lines sit dirty in L2, so the call also pays their write-back;
    with clean=True the buffer is read back after it is written, which
    leaves L2 holding clean lines of it and nothing of the operands."""
    import torch
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        flush.fill_(1)
        if clean:
            flush.max()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        _spin(1.0)
        a.record()
        fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b))
    return statistics.median(per)


def profile_kernels(fn, reps: int = 20):
    """Mean device time per call (ms) of each CUDA kernel `fn` launches,
    from torch.profiler; None where this torch has no device tracing
    (built without Kineto) or the trace holds no device time. Any other
    error of the profiler fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.autograd.kineto_available():
        log("torch.profiler: no Kineto in this torch, device time not "
            "measured")
        return None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None)
        if total is None:
            total = getattr(e, "cuda_time_total", 0)
        if total > 0:
            out[e.key] = total / 1e3 / reps
    if not out:
        log("torch.profiler: the trace holds no device time")
    return out or None


# ---------------------------------------------------------------- phase 2


def abs_err(got, want) -> int:
    """max |kernel - plain| over the cells (synchronises the device)."""
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def capacity_operands(rng, p, n, r, dev):
    """Requests, allocatable and requested columns with nodes with and
    without overlay capacity and requests sitting exactly on the limit."""
    import numpy as np
    import torch
    alloc = rng.integers(0, 5000, size=(n, r)).astype(np.int32)
    alloc[rng.random(n) < 0.5, 4] = 0                  # no overlay
    requested = (alloc * rng.random((n, r))).astype(np.int32)
    req = rng.integers(0, 2500, size=(p, r)).astype(np.int32)
    req[rng.random(p) < 0.2] = 0                       # zero requests
    if p and n:
        # some (pod, node) pairs land exactly on the limit
        k = min(p, n)
        req[:k] = alloc[:k] - requested[:k]
    t = [torch.from_numpy(x).to(dev) for x in (req, alloc, requested)]
    return t


def headroom_operands(rng, req, alloc, requested, extremes=False):
    """The wave call's operands around capacity_operands' (req, alloc,
    requested): zero-request flags (the all-zero rows), pod counts with
    nodes below, at and past their ceiling, over-committed nodes
    (requested > alloc in some columns); with extremes=True int32 extremes
    in every operand, whose sums and differences wrap. Returns (req, zero,
    alloc, requested, pod_count, allowed_pods) on req's device."""
    import numpy as np
    import torch
    dev = req.device
    req, alloc, requested = (x.cpu().numpy().astype(np.int64)
                             for x in (req, alloc, requested))
    c, n = req.shape[0], alloc.shape[0]
    over = rng.random(requested.shape) < 0.1
    requested[over] = alloc[over] + rng.integers(1, 500, size=over.sum())
    allowed = rng.integers(0, 120, size=n)
    pod_count = np.maximum(allowed - rng.integers(1, 60, size=n), 0)
    full = rng.random(n) < 0.2
    pod_count[full] = allowed[full] + rng.integers(0, 3, size=full.sum())
    if extremes:
        ext = np.array([-2 ** 31, -2 ** 31 + 1, -1, 1, I32_MAX - 1, I32_MAX])
        for a in (req, alloc, requested, allowed, pod_count):
            hit = rng.random(a.shape) < 0.15
            a[hit] = rng.choice(ext, size=hit.sum())
    zero = ~req.any(axis=1)
    zero[rng.random(c) < 0.1] = True                   # forced zero rows
    req[zero] = 0
    return tuple(torch.from_numpy(x.astype(np.int32) if x.dtype != bool
                                  else x).to(dev)
                 for x in (req, zero, alloc, requested, pod_count, allowed))


def check_capacity_outputs(kernels, ops, tag):
    """Both outputs of the capacity kernel against their plain versions on
    the card, exactly: the mask without and with the override (one launch
    each) and the wave call's mask and headroom (one launch). Returns the
    max |kernel - plain|."""
    import torch
    req, zero, alloc, requested, pod_count, allowed = ops
    pairs = [
        ("mask", kernels.capacity_fit(req, alloc, requested),
         kernels.capacity_fit_plain(req, alloc, requested)),
        ("mask with override",
         kernels.capacity_fit(req, alloc, requested, zero),
         kernels.capacity_fit_plain(req, alloc, requested, zero))]
    fit, cap = kernels.capacity_headroom(*ops)
    pairs += [("wave mask", fit,
               kernels.capacity_fit_plain(req, alloc, requested, zero)),
              ("headroom", cap, kernels.class_capacity_plain(*ops))]
    err = 0
    for what, got, want in pairs:
        if got.dtype != want.dtype or got.shape != want.shape:
            fail(f"capacity {what} at {tag}: {got.dtype} {tuple(got.shape)}"
                 f" against plain {want.dtype} {tuple(want.shape)}")
        err = max(err, abs_err(got, want))
        if not torch.equal(got, want):
            fail(f"capacity {what} != plain at {tag}: "
                 f"{int((got != want).sum())} cells differ")
    return err


def incidence_check_operands(gen, m, n, l, dev):
    """A [m, l] int32 and B_t [n, l] int8 for the exactness checks: 0/1
    incidence rows, then (from m // 3) weight rows with entries up to
    +-2^22, and int32 extremes whose sums still fit int32. The last row
    holds -2^31 + 1 and 2^31 - 1; the one before it (the only row when
    m = 1) holds 2^31 - 2, 1 and -1 against B_t columns that make its top
    digit plane carry the kernel's recombination across the int32
    boundary. Columns 0..4 of B_t follow fixed patterns, the rest are
    random with 1% ones."""
    import torch
    a = (torch.rand((m, l), generator=gen, device=dev) < 0.3).to(torch.int32)
    w0 = m // 3
    a[w0:] *= torch.randint(-2 ** 22, 2 ** 22 + 1, (m - w0, l),
                            generator=gen, device=dev, dtype=torch.int32)
    extreme = [-I32_MAX, I32_MAX, 0, 0, 0]
    carry = [0, 0, I32_MAX - 1, 1, -1]
    for r, vals in ([(m - 1, extreme), (m - 2, carry)] if m > 1
                    else [(0, carry)]):
        a[r] = 0
        a[r, :5] = torch.tensor(vals, dtype=torch.int32)
    b = (torch.rand((n, l), generator=gen, device=dev) < 0.01).to(torch.int8)
    i = torch.arange(n, device=dev)
    b[:, 0] = (i % 2).to(torch.int8)
    b[:, 1] = ((i // 2) % 2).to(torch.int8)
    b[:, 2] = 1
    b[:, 3] = (i % 3 == 0).to(torch.int8)
    b[:, 4] = (i % 5 == 0).to(torch.int8)
    return a, b


def stacked_operands(rng, m, l, dev, wide=False):
    """A stacked [m, l] A against B_t [5120, l]: 2% ones; the upper half
    of the rows weighted by [-100, 100] (the earlier timing operands), or with
    wide=True laid out as stack_static lays out C = m / 10 classes of
    S = 8 terms: allow and forbid rows 0/1, the last C rows preferred
    weights up to 300,000 (three digit planes)."""
    import numpy as np
    import torch
    a = (rng.random((m, l)) < 0.02).astype(np.int32)
    if wide:
        c = m // 10
        a[m - c:] *= rng.integers(-300_000, 300_001, size=(c, l)) \
            .astype(np.int32)
    else:
        a[m // 2:] *= rng.integers(-100, 101, size=(m - m // 2, l)) \
            .astype(np.int32)
    b = (rng.random((5120, l)) < 0.01).astype(np.int8)
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


def check_incidence(kernels, extender_ops, dev):
    """Exactness of the incidence kernel and its pre-pass on the card;
    returns the max |kernel - plain| (0, or the smoke fails)."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    err, checks = 0, 0
    cases = []
    for m in (1, 6, 16, 17, 130):
        for n in (1, 255, N_NODES):
            for l in (4104, 5000, 5008):
                cases.append((f"M={m} N={n} L={l}",
                              *incidence_check_operands(gen, m, n, l, dev)))
    # L % 8 != 0 (the wrapper pads L), and operands whose base addresses
    # are not 16-byte aligned (the wrapper copies them)
    cases.append(("L=4100",
                  *incidence_check_operands(gen, 6, 255, 4100, dev)))
    a, b = incidence_check_operands(gen, 6, 255, 4104, dev)
    a_odd = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)
    b_odd = torch.empty(b.numel() + 1, dtype=b.dtype, device=dev)
    a_odd[1:] = a.flatten()
    b_odd[1:] = b.flatten()
    cases.append(("odd addresses", a_odd[1:].view(a.shape),
                  b_odd[1:].view(b.shape)))
    cases.append(("evaluate_pod",) + tuple(extender_ops))
    for tag, a, b in cases:
        want64 = a.double() @ b.double().T
        if want64.abs().max() > I32_MAX:
            fail(f"incidence check operands at {tag} overflow int32")
        got = kernels.incidence_matmul(a, b)
        want = kernels.incidence_matmul_plain(a, b)
        err = max(err, abs_err(got, want))
        if not torch.equal(got, want):
            fail(f"incidence_matmul != plain at {tag}: "
                 f"{int((got != want).sum())} cells differ")
        checks += 1
    log(f"incidence_matmul == plain at {checks} shapes (exact; M in "
        f"1/6/16/17/130 x N in 1/255/{N_NODES} x L in 4104/5000/5008 with "
        f"+-2^22 weights and int32 extremes; L = 4100, padded by the "
        f"wrapper; operands at odd addresses; the verdict's operands)")
    # the C side refuses a plan it cannot run (tile_m = 32 does not exist)
    code = kernels._lib("incidence_matmul")(
        None, None, None, None, None, 6, N_NODES, 5008, 32, 1, 40, 5120,
        None)
    if code != kernels.BAD_PLAN:
        fail(f"incidence_matmul_launch took a bad plan (returned {code})")
    log("incidence launch refuses a bad plan (returns BAD_PLAN)")
    return err


def time_incidence(kernels, tag, a, b, flush):
    import torch
    m, l = a.shape
    n = b.shape[0]
    af, bf = a.float(), b.float()
    plan = kernels.incidence_plan(m, n, l)
    by = (4 * m * l + n * l + 4 * m * n) / HBM_BYTES_PER_S
    op = 2 * m * n * l / INT8_TENSOR_OPS_PER_S
    row = {
        "ms": time_ms(lambda: kernels.incidence_matmul(a, b)),
        "device_ms": time_device_ms(lambda: kernels.incidence_matmul(a, b)),
        "cold_ms": time_cold_ms(lambda: kernels.incidence_matmul(a, b),
                                flush),
        "cold_clean_ms": time_cold_ms(
            lambda: kernels.incidence_matmul(a, b), flush, clean=True),
        "plain_ms": time_ms(lambda: kernels.incidence_matmul_plain(a, b)),
        "plain_device_ms": time_device_ms(
            lambda: kernels.incidence_matmul_plain(a, b)),
        "library_ms": time_ms(lambda: torch.matmul(af, bf.T)),
        "library_device_ms": time_device_ms(lambda: torch.matmul(af, bf.T)),
        "library_cold_ms": time_cold_ms(lambda: torch.matmul(af, bf.T),
                                        flush),
        "library_cold_clean_ms": time_cold_ms(
            lambda: torch.matmul(af, bf.T), flush, clean=True),
        "bound_ms": 1e3 * max(by, op),
        "bound_by": "bytes" if by >= op else "operations",
        "shape": f"M={m} N={n} L={l}",
        "plan": {k: plan[k] for k in ("tile_m", "block_k", "split",
                                      "grid")},
    }
    # the two kernels' device times from the profiler: the pre-pass's share
    prof = profile_kernels(lambda: kernels.incidence_matmul(a, b)) or {}
    pre = sum(v for k, v in prof.items() if "incidence_prepass" in k)
    main = sum(v for k, v in prof.items() if "incidence_mma" in k)
    row["prepass_ms"] = pre if prof else "not measured"
    row["main_ms"] = main if prof else "not measured"
    row["prepass_share"] = pre / (pre + main) if prof else "not measured"
    row["tera_ops_per_s"] = \
        2 * m * n * l / (row["device_ms"] * 1e-3) / 1e12
    log(f"incidence_matmul {tag}: " + json.dumps(row))
    return row


def check_kernels(kernels, extender_ops):
    import numpy as np
    import torch
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    max_err = {"capacity_fit": 0, "incidence_matmul": 0}
    checks = 0
    shapes = [(16, N_NODES, 5), (16, N_NODES, 7)]
    shapes += [(p, n, r) for p in (1, 7, 130) for n in (1, 255, 257, N_NODES)
               for r in (5, 7)]
    # extended-resource columns: R > 8 runs the kernel's loop past its
    # register window
    shapes += [(p, n, r) for p, n in ((16, N_NODES), (7, 257), (130, 255))
               for r in (12, 40)]
    for p, n, r in shapes:
        for extremes in (False, True):
            ops = headroom_operands(
                rng, *capacity_operands(rng, p, n, r, dev), extremes)
            tag = f"P={p} N={n} R={r}{' extremes' if extremes else ''}"
            max_err["capacity_fit"] = max(
                max_err["capacity_fit"],
                check_capacity_outputs(kernels, ops, tag))
            checks += 1
    log(f"capacity kernel == plain at {checks} cases (exact; mask, mask "
        f"with override, wave mask + headroom; P in 1/7/16/130 x N in "
        f"1/255/257/{N_NODES} x R in 5/7, and R in 12/40 at three shapes; "
        f"zero-request classes, nodes without overlay, over-committed "
        f"nodes, pod counts at and past the ceiling, and int32 extremes "
        f"that wrap)")
    # the C side refuses arguments it cannot run (it returns before any
    # pointer is read: 1 stands for a device pointer)
    ptrs = (1,) * 8
    no_counts = (1, 1, 1, 1, None, None, 1, 1)
    for what, args in (("R = 4", ptrs + (16, N_NODES, 4)),
                       ("R = 41", ptrs + (16, N_NODES, 41)),
                       ("65,536 node blocks", ptrs + (16, 65536 * 128, 5)),
                       ("headroom without pod counts",
                        no_counts + (16, N_NODES, 5))):
        code = kernels._lib("capacity_fit")(*args, None)
        if code != kernels.BAD_PLAN:
            fail(f"capacity_fit_launch took {what} (returned {code})")
    log("capacity launch refuses R out of range, a grid past 65,535 node "
        "blocks and a headroom without counts")

    max_err["incidence_matmul"] = check_incidence(kernels, extender_ops, dev)
    inc_shapes = [("evaluate_pod",) + tuple(extender_ops)]
    for m in (640, 2560):
        for l in (2048, 4096):
            inc_shapes.append((f"M={m} L={l}",
                               *stacked_operands(rng, m, l, dev)))
    inc_shapes.append(("stack C=256 S=8 L=4096 wide weights",
                       *stacked_operands(rng, 2560, 4096, dev, wide=True)))
    for tag, a, b in inc_shapes[1:]:
        got = kernels.incidence_matmul(a, b)
        want = kernels.incidence_matmul_plain(a, b)
        max_err["incidence_matmul"] = max(max_err["incidence_matmul"],
                                          abs_err(got, want))
        if not torch.equal(got, want):
            fail(f"incidence_matmul != plain at {tag}")
        log(f"incidence_matmul == plain at {tag} {tuple(a.shape)} x "
            f"{tuple(b.shape)} (exact)")

    # timings at the main path's shapes, plus the larger incidence shapes
    req, alloc, requested = capacity_operands(rng, 16, N_NODES, 5, dev)
    p, r = req.shape
    n = alloc.shape[0]

    def cap_call():
        return kernels.capacity_fit(req, alloc, requested)

    prof = profile_kernels(cap_call)
    cap = {
        "ms": time_ms(cap_call),
        "device_ms": time_device_ms(cap_call),
        "profiler_ms": None if prof is None else {
            k: v for k, v in prof.items() if "capacity" in k},
        "plain_ms": time_ms(
            lambda: kernels.capacity_fit_plain(req, alloc, requested)),
        "plain_device_ms": time_device_ms(
            lambda: kernels.capacity_fit_plain(req, alloc, requested)),
        "library_ms": None,
        "bound_ms": 1e3 * max((4 * r * (p + 2 * n) + p * n) / HBM_BYTES_PER_S,
                              p * n * (2 * r + 1) / CUDA_CORE_OPS_PER_S),
        "bound_by": "bytes", "shape": f"P={p} N={n} R={r}",
    }
    # the wave's call: mask with the override and headroom in one launch
    ops = headroom_operands(rng, req, alloc, requested)

    def wave_call():
        return kernels.capacity_headroom(*ops)

    def wave_plain():
        return (kernels.capacity_fit_plain(ops[0], ops[2], ops[3], ops[1]),
                kernels.class_capacity_plain(*ops))

    cap.update({
        "wave_ms": time_ms(wave_call),
        "wave_device_ms": time_device_ms(wave_call),
        # the plain versions run ~70 ops a call: 5 calls a round keep them
        # inside the launch queue behind the spin
        "wave_plain_ms": time_ms(wave_plain, reps=5),
        "wave_plain_device_ms": time_device_ms(wave_plain, reps=5),
        # read [C,R] + 2 x [N,R] int32, zero_req [C], pod_count and
        # allowed_pods [N] int32; write [C,N] bool + [C,N] int32
        "wave_bound_ms": 1e3 * (4 * r * (p + 2 * n) + p + 8 * n
                                + 5 * p * n) / HBM_BYTES_PER_S,
    })
    prof = profile_kernels(wave_call)
    cap["wave_profiler_ms"] = None if prof is None else {
        k: v for k, v in prof.items() if "capacity" in k}
    log("capacity_fit: " + json.dumps(cap))

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    log_clocks("before the incidence timings")
    inc = {}
    for tag, a, b in inc_shapes:
        inc.setdefault("main", time_incidence(kernels, tag, a, b, flush))
    log_clocks("after them")
    del flush
    return {"capacity_fit": cap, "incidence_matmul": inc["main"]}, max_err


# ---------------------------------------------------------------- phases 3-4


def build_cache(nodes):
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    cache = SchedulerCache()
    for nd in nodes:
        cache.add_node(nd)
    return cache


def card_vs_cpu(hollow, SchedulingEngine):
    results = []
    for dev in ("cuda", "cpu"):
        eng = SchedulingEngine(build_cache(hollow.hollow_nodes(512)),
                               device=dev)
        r = eng.schedule(hollow.binpack_pods(3000, seed=7), mode="wave")
        results.append(([x.node_name for x in r], [x.fit_count for x in r],
                        eng.rr.counter))
    (s_g, f_g, c_g), (s_c, f_c, c_c) = results
    if s_g != s_c or f_g != f_c or c_g != c_c:
        diff = sum(a != b for a, b in zip(s_g, s_c))
        fail(f"card and CPU runs differ: {diff} placements, "
             f"RR {c_g} vs {c_c}")
    log(f"card == CPU: 512 nodes x 3000 binpack pods, "
        f"{sum(x is not None for x in s_g)} placed, RR counter {c_g}")


def audit(cache, results, n_pods, require_all):
    placed = sum(r.node_name is not None for r in results)
    if require_all and placed != n_pods:
        fail(f"{n_pods - placed} of {n_pods} pods unplaced")
    for r in results:
        if r.node_name is None and r.fit_count != 0:
            fail(f"unplaced pod {r.pod.name} reports fit_count "
                 f"{r.fit_count}")
    for name, info in cache.node_infos().items():
        node = info.node
        cpu = sum(p.resource_request().milli_cpu for p in info.pods)
        mem = sum(p.resource_request().memory for p in info.pods)
        if cpu > node.allocatable.milli_cpu \
                or mem > node.allocatable.memory \
                or len(info.pods) > node.allowed_pod_number:
            fail(f"node {name} over capacity: cpu {cpu}, mem {mem}, "
                 f"pods {len(info.pods)}")
    return placed


def spans(prefix: str, per: int = 1) -> dict:
    """Wall ms of the engine's timed spans under `prefix` since the last
    COUNTERS.reset(), divided by `per`."""
    from kubernetes_tpu_torch.utils.trace import COUNTERS
    snap = sorted(COUNTERS.snapshot().items())
    return {k: 1e3 * t / per for k, (_, t) in snap
            if k.startswith(prefix) and t > 0}


def drain(hollow, kernels, SchedulingEngine, profile, card):
    import torch
    from kubernetes_tpu_torch.utils.trace import COUNTERS
    nodes = hollow.hollow_nodes(N_NODES)
    cache = build_cache(nodes)
    eng = SchedulingEngine(cache)   # device=None: the card
    pods = getattr(hollow, f"{profile}_pods")(N_PODS)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    COUNTERS.reset()
    t0 = time.perf_counter()
    results = eng.schedule(pods, mode="wave")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    placed = audit(cache, results, N_PODS, require_all=profile == "density")
    log(f"drain {profile}: {N_NODES} nodes x {N_PODS} pods, placed "
        f"{placed}, waves {eng.last_wave_stats}, wall {wall:.3f} s, "
        f"{N_PODS / wall:.0f} pods/s, launches {launches} [{card}]")
    log(f"drain {profile} spans (ms): " + json.dumps(spans("engine.")))
    # one capacity launch per wave, plus one per pod of a strict-loop
    # finish (padded to its bucket)
    from kubernetes_tpu_torch.ops import predicates as preds
    stats = eng.last_wave_stats
    want = stats["waves"] + (preds.bucket(stats["stragglers"])
                             if stats["stragglers"] else 0)
    if launches["capacity_fit"] != want:
        fail(f"drain {profile}: {launches['capacity_fit']} capacity "
             f"launches for {stats}")
    # both outputs of the capacity kernel against their plain versions on
    # the node state this drain left behind and on the profile's class rows
    from kubernetes_tpu_torch.state.classes import ClassBatch
    eng._refresh()
    nd = eng._nodes_on_device()
    fresh = getattr(hollow, f"{profile}_pods")(64, seed=1, namespace="chk")
    cls = preds.pod_arrays_padded(ClassBatch(fresh, eng.snapshot).reps_batch,
                                  16, torch.device("cuda"))
    check_capacity_outputs(
        kernels, (cls["req"], cls["zero_req"], nd["alloc"], nd["requested"],
                  nd["pod_count"], nd["allowed_pods"]),
        f"the {profile} drain's end state")
    return launches, wall


# ---------------------------------------------------------------- phase 5


def extender_cluster(hollow, types):
    from kubernetes_tpu_torch.state.snapshot import ClusterSnapshot
    nodes = hollow.hollow_nodes(N_NODES)
    cache = build_cache(nodes)
    for i, p in enumerate(hollow.mixed_affinity_pods(3000, seed=11)):
        p.node_name = nodes[i % N_NODES].name
        cache.add_pod(p)
    snap = ClusterSnapshot()
    snap.refresh(cache.node_infos())
    wl = [types.WorkloadObject("Service", "web", "bench",
                               match_labels={"app": "web-2"})]
    probes = (hollow.mixed_affinity_pods(40, seed=12)[::2]
              + hollow.affinity_pods(8, seed=13))
    return cache, snap, wl, probes


def incidence_operands(cache, snap, wl, probe, affinity, ClassBatch):
    """The stacked A and the labels that evaluate_pod hands the incidence
    kernel for `probe` (same host steps as evaluate_pod)."""
    import torch
    dev = torch.device("cuda")
    infos = cache.node_infos()
    all_pairs, aff_pairs = affinity.collect_pod_pairs(infos)
    affinity.intern_topology_pairs(snap, [probe], aff_pairs)
    batch = ClassBatch([probe], snap)
    adata = affinity.AffinityData(batch.reps, snap, all_pairs, aff_pairs,
                                  wl, 1)
    a = affinity.stack_static(adata.device_arrays(dev))
    b = torch.from_numpy(snap.labels.copy()).to(dev)
    return a, b


def verdicts(cache, snap, wl, probes, kernels, evaluate_pod, priorities,
             card):
    import numpy as np
    import torch
    from kubernetes_tpu_torch.utils.trace import COUNTERS
    infos = cache.node_infos()
    for p in probes:  # warm-up, and vocab growth lands before counting
        evaluate_pod(p, infos, snap, priorities, wl)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    COUNTERS.reset()
    card_out, lat = [], []
    for p in probes:
        t0 = time.perf_counter()
        m, s = evaluate_pod(p, infos, snap, priorities, wl)
        lat.append(time.perf_counter() - t0)
        card_out.append((m, s))
    launches = dict(kernels.LAUNCHES)
    per_call = spans("extender.", len(probes))
    for p, (m, s) in zip(probes, card_out):
        mc, sc = evaluate_pod(p, infos, snap, priorities, wl, device="cpu")
        if not (np.array_equal(m, mc) and np.array_equal(s, sc)):
            fail(f"evaluate_pod card != CPU for {p.name}")
    log(f"evaluate_pod: {len(probes)} probes, card == CPU (fits and "
        f"scores), verdict latency median {1e3 * statistics.median(lat):.2f}"
        f" ms (min {1e3 * min(lat):.2f}), launches {launches} [{card}]")
    log("evaluate_pod spans (mean ms per call): " + json.dumps(per_call))
    return launches


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from kubernetes_tpu_torch.api import types
        from kubernetes_tpu_torch.engine.scheduler_engine import (
            SchedulingEngine, evaluate_pod)
        from kubernetes_tpu_torch.models import hollow
        from kubernetes_tpu_torch.ops import affinity, kernels
        from kubernetes_tpu_torch.ops.priorities import DEFAULT_PRIORITIES
        from kubernetes_tpu_torch.state.classes import ClassBatch
    except ImportError as e:
        print(f"chip_smoke: the kubernetes_tpu_torch package is missing "
              f"({e})", file=sys.stderr)
        return 3
    # int_matmul needs full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off (torch.backends.cuda.matmul.allow_tf32 = False)")

    # 1. build + card facts
    t0 = time.perf_counter()
    reports = kernels.build()
    for name, rep in reports.items():
        log(f"built {name}:")
        for line in rep.splitlines():
            if "ptxas info" in line or "spill" in line:
                log("  " + line.strip())
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    card = card_facts()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")

    # 2. kernels vs plain versions (operands of the extender cluster first)
    cache5, snap5, wl5, probes = extender_cluster(hollow, types)
    ops = incidence_operands(cache5, snap5, wl5, probes[0], affinity,
                             ClassBatch)
    timing, max_err = check_kernels(kernels, ops)

    # 3. card vs CPU
    card_vs_cpu(hollow, SchedulingEngine)

    # 4. the drains
    launches_drain = {k: 0 for k in kernels.LAUNCHES}
    walls = {}
    for profile in ("density", "binpack"):
        got, walls[profile] = drain(hollow, kernels, SchedulingEngine,
                                    profile, card)
        for k, v in got.items():
            launches_drain[k] += v
    if launches_drain["capacity_fit"] == 0:
        fail("the drains never launched the capacity kernel")

    # 5. the extender verdict
    launches_eval = verdicts(cache5, snap5, wl5, probes, kernels,
                             evaluate_pod, DEFAULT_PRIORITIES, card)
    if launches_eval["incidence_matmul"] == 0:
        fail("evaluate_pod never launched the incidence kernel")

    # 6. summary
    replaces = {"capacity_fit": "kubernetes_tpu/ops/pallas_kernels.py:90",
                "incidence_matmul": "kubernetes_tpu/ops/pallas_kernels.py:144"}
    rows = []
    for name in ("capacity_fit", "incidence_matmul"):
        t = timing[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"kubernetes_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": launches_drain[name] + launches_eval[name],
            "max_abs_err": max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"], "cold_ms": t.get("cold_ms"),
            **{k: v for k, v in t.items() if k.startswith("wave_")
               and "profiler" not in k}})
    log(f"launches: drains {launches_drain}, verdicts {launches_eval}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
