"""Span counters for the port's hot path: named monotonic counts plus
accumulated wall time (a minimal copy of the reference package's
SpanCounters and timed_span)."""

from __future__ import annotations

import threading
import time
from typing import Dict, Tuple


class SpanCounters:
    """Named monotonic counters + accumulated wall time for hot-path spans.

    The profiling companion to Trace: Trace narrates ONE slow call;
    SpanCounters aggregate across thousands of fast ones (how many times
    did the extender rebuild AffinityData this session? where did the warm
    /filter's milliseconds go?). Tests assert on counts to pin cache
    behavior structurally; profile_bench reads times for attribution."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._times: Dict[str, float] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def add_time(self, name: str, seconds: float) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + 1
            self._times[name] = self._times.get(name, 0.0) + seconds

    def count(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def time(self, name: str) -> float:
        with self._lock:
            return self._times.get(name, 0.0)

    def snapshot(self) -> Dict[str, Tuple[int, float]]:
        with self._lock:
            return {k: (c, self._times.get(k, 0.0))
                    for k, c in self._counts.items()}

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._times.clear()


# process-wide registry: the snapshot's refresh paths and the engine's
# spans, read by tests and chip_smoke.py
COUNTERS = SpanCounters()


class timed_span:
    """`with timed_span("engine.place"): ...` — count + accumulate the
    wall time of the block (host clock; a block that ends in a device
    fetch includes the device work it waited for)."""

    __slots__ = ("name", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        COUNTERS.add_time(self.name, time.perf_counter() - self._t0)
        return False
