"""The traced run's instruments: the harness's own host intervals around the
calls into each layer, the profiler's device intervals on the same clock,
and the shapes of each hand-written kernel's calls.

Device and host clocks are tied by two markers: with the card idle, one
small operation is launched right after the host reads its clock at the
window's start, and one at its end; the first and the last device
intervals of the trace are those two.
"""

import importlib
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Tuple

from benchmark.lib import stats

KERNELS_DIR = Path(__file__).resolve().parent.parent / "kernels"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host intervals (name, start, end) on time.perf_counter, recorded by
    wrapping a bound method or a module function in place; restore() puts
    every original back."""

    def __init__(self):
        self.intervals: List[Tuple[str, float, float]] = []
        self._undo = []

    def wrap(self, owner, attr: str, name: str) -> None:
        fn = getattr(owner, attr)
        record = self.intervals.append
        clock = time.perf_counter

        def timed(*args, **kwargs):
            t0 = clock()
            try:
                return fn(*args, **kwargs)
            finally:
                record((name, t0, clock()))
        self._undo.append((owner, attr, attr in vars(owner), fn))
        setattr(owner, attr, timed)

    def span(self, name: str, t0: float, t1: float) -> None:
        self.intervals.append((name, t0, t1))

    def restore(self) -> None:
        for owner, attr, had_own, fn in reversed(self._undo):
            if had_own:
                setattr(owner, attr, fn)
            else:               # a method of the class, wrapped on an instance
                delattr(owner, attr)
        self._undo.clear()

    def labels_at(self, instants) -> List[str]:
        """The innermost recorded interval open at each instant ("harness"
        where none is): the intervals paint the sorted instants widest
        first, so a narrower one painted later wins."""
        import numpy as np
        t = np.asarray(instants, dtype=np.float64)
        order = np.argsort(t)
        ts = t[order]
        lab = np.full(t.size, -1, dtype=np.int64)
        names = sorted({n for n, _, _ in self.intervals})
        code = {n: i for i, n in enumerate(names)}
        for name, a, b in sorted(self.intervals, key=lambda x: x[1] - x[2]):
            lo, hi = np.searchsorted(ts, a, "left"), np.searchsorted(
                ts, b, "right")
            lab[lo:hi] = code[name]
        out = np.empty(t.size, dtype=object)
        out[order] = [names[i] if i >= 0 else "harness" for i in lab]
        return list(out)


def kernel_specs() -> Dict[str, dict]:
    """Every kernel's data file: {name: {"wrappers", "symbols", "work"}}."""
    out = {}
    for path in sorted(KERNELS_DIR.glob("*.json")):
        with open(path) as f:
            out[path.stem] = json.load(f)
    return out


def _load(ref: str):
    mod, _, attr = ref.partition(":")
    return getattr(importlib.import_module(mod), attr)


class KernelCalls:
    """Wraps each kernel's wrapper functions in the program's kernels
    module, handing every call's arguments to the kernel's own recorder
    (named by its data file); work() gives each kernel's least time."""

    def __init__(self, spans: Spans):
        from kubernetes_tpu_torch.ops import kernels as kmod
        self.specs = kernel_specs()
        self.recorders = {}
        for name, spec in self.specs.items():
            rec = _load(spec["work"])()
            self.recorders[name] = rec
            for w in spec["wrappers"]:
                self._wrap(kmod, w, rec, spans)

    @staticmethod
    def _wrap(kmod, attr, rec, spans):
        fn = getattr(kmod, attr)

        def noted(*args, **kwargs):
            rec.note(attr, args, kwargs)
            return fn(*args, **kwargs)
        spans._undo.append((kmod, attr, True, fn))
        setattr(kmod, attr, noted)

    def least_s(self) -> Dict[str, float]:
        return {name: rec.least_s() for name, rec in self.recorders.items()}


class DeviceTrace:
    """torch.profiler over the window, CUDA activity only. After exit:
    `events` [(name, host start, host end)] of every kernel, copy and
    memset, `busy_s`, `window_s`, and `h0`, `h1` (the window on the host
    clock)."""

    def __init__(self, device):
        self.device = device

    def _marker(self):
        import torch
        torch.ones(1, device=self.device)

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.h0 = time.perf_counter()
        self._marker()
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize(self.device)
        self.h1 = time.perf_counter()
        self._marker()
        torch.cuda.synchronize(self.device)
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                            f"bench-trace-{os.getpid()}.json")
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f).get("traceEvents", [])
        finally:
            if os.path.exists(path):
                os.remove(path)
        dev = sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
                     for e in raw if e.get("ph") == "X"
                     and e.get("cat") in DEVICE_CATS)
        if len(dev) < 2:
            raise RuntimeError("the profiler's trace holds no device "
                               "interval: device time not measured")
        d0, d1 = dev[0][0], dev[-1][0]
        scale = (self.h1 - self.h0) / (d1 - d0) if d1 > d0 else 1e-6
        to_host = lambda ts: self.h0 + (ts - d0) * scale  # noqa: E731
        # the two markers are left out of what the window did
        self.events = [(name, to_host(a), to_host(b))
                       for a, b, name in dev[1:-1]]
        self.measure([(self.h0, self.h1)])
        return False

    def measure(self, intervals) -> None:
        """Limit the window to `intervals` (host clock; the backlog's
        timed episodes, leaving its resets out): `window_s` is their
        length, `busy_s` the device's busy time inside them."""
        self.intervals = list(intervals)
        self.window_s = sum(b - a for a, b in self.intervals)
        dev = [(a, b) for _, a, b in self.events]
        self.busy_s = sum(stats.busy(dev, a, b) for a, b in self.intervals)

    def device_s(self, symbols) -> float:
        """Device seconds of the events whose name holds any of
        `symbols`."""
        return sum(b - a for name, a, b in self.events
                   if any(s in name for s in symbols))

    def breakdown(self, spans: Spans, top: int = 10) -> dict:
        by_op: Dict[str, float] = {}
        for name, a, b in self.events:
            key = name.split("(")[0][:96]
            by_op[key] = by_op.get(key, 0.0) + (b - a)
        by_gap: Dict[str, float] = {}
        dev = [(a, b) for _, a, b in self.events]
        idle = [g for lo, hi in self.intervals
                for g in stats.gaps(dev, lo, hi)]
        for (a, b), label in zip(idle, spans.labels_at(
                [(a + b) / 2 for a, b in idle])):
            by_gap[label] = by_gap.get(label, 0.0) + (b - a)
        rank = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa
                                key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_gap)}
