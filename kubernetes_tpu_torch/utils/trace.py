"""utiltrace analog: timestamped step traces dumped only when slow.

Mirror of staging/src/k8s.io/apiserver/pkg/util/trace/trace.go:33-90
(Trace.Step / LogIfLong): callers mark named steps; if the total latency
exceeds the threshold, the whole step breakdown is emitted — the
scheduler wraps every Schedule call at a 100ms threshold
(plugin/pkg/scheduler/core/generic_scheduler.go:89-90).
"""

from __future__ import annotations

import logging
import threading
from kubernetes_tpu_torch.analysis import lockcheck
import time
from typing import Callable, Dict, List, Optional, Tuple

LOG = logging.getLogger("kubernetes_tpu_torch.trace")

# the scheduler's slow-schedule threshold (generic_scheduler.go:90)
SCHEDULE_TRACE_THRESHOLD_S = 0.1


class SpanCounters:
    """Named monotonic counters + accumulated wall time for hot-path spans.

    The profiling companion to Trace: Trace narrates ONE slow call;
    SpanCounters aggregate across thousands of fast ones (how many times
    did the extender rebuild AffinityData this session? where did the warm
    /filter's milliseconds go?). Tests assert on counts to pin cache
    behavior structurally; profile_bench reads times for attribution."""

    def __init__(self):
        self._lock = lockcheck.make_lock("SpanCounters._lock")
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


# process-wide registry, used by the extender fast lane (server/extender.py,
# engine/scheduler_engine.evaluate_pod) and read by profile_bench + tests
COUNTERS = SpanCounters()


class timed_span:
    """`with timed_span("extender.refresh"): ...` — count + accumulate."""

    __slots__ = ("name", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        COUNTERS.add_time(self.name, time.perf_counter() - self._t0)
        return False


class Trace:
    def __init__(self, name: str, now: Callable[[], float] = time.monotonic,
                 sink: Optional[Callable[[str], None]] = None, **fields):
        self.name = name
        self._now = now
        self._start = now()
        self._steps: List[Tuple[float, str]] = []
        self._sink = sink or (lambda msg: LOG.info("%s", msg))
        self._fields = fields

    def step(self, msg: str) -> None:
        self._steps.append((self._now(), msg))

    def field(self, key: str, value) -> None:
        """Attach a context field learned after construction (shown in the
        dump header)."""
        self._fields[key] = value

    def total(self) -> float:
        return self._now() - self._start

    def log_if_long(self, threshold_s: float) -> bool:
        """Emit the breakdown when total exceeds threshold (trace.go:57
        LogIfLong). Returns True if dumped."""
        total = self.total()
        if total < threshold_s:
            return False
        fields = "".join(f" {k}={v}" for k, v in self._fields.items())
        lines = [f'Trace "{self.name}"{fields} (total {total * 1e3:.1f}ms):']
        last = self._start
        for t, msg in self._steps:
            lines.append(f'  [{(t - self._start) * 1e3:.1f}ms] '
                         f'(+{(t - last) * 1e3:.1f}ms) {msg}')
            last = t
        self._sink("\n".join(lines))
        return True
