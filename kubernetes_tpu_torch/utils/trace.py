"""utiltrace analog: timestamped step traces dumped only when slow, and the
process's span counters with their ring of span intervals.

Mirror of staging/src/k8s.io/apiserver/pkg/util/trace/trace.go:33-90
(Trace.Step / LogIfLong): callers mark named steps; if the total latency
exceeds the threshold, the whole step breakdown is emitted — the
scheduler wraps every Schedule call at a 100ms threshold
(plugin/pkg/scheduler/core/generic_scheduler.go:89-90).

Every span (``timed_span``) and every collection of Python's garbage
collector is stamped with ``clock`` (``time.perf_counter``), the host clock
that a device trace's intervals are mapped onto; the flight recorder
(observability/recorder.py) stamps its events with it too.
"""

from __future__ import annotations

import collections
import gc
import itertools
import logging
import threading
from kubernetes_tpu_torch.analysis import lockcheck
import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

LOG = logging.getLogger("kubernetes_tpu_torch.trace")

_get_ident = threading.get_ident

# the scheduler's slow-schedule threshold (generic_scheduler.go:90)
SCHEDULE_TRACE_THRESHOLD_S = 0.1

# The host clock of every span record and flight-recorder event: the clock
# onto which a profiler's device intervals are mapped, so a span can be laid
# over the card's busy and idle time.
clock = time.perf_counter

# span records kept; past it the oldest are overwritten and counted dropped
RING_CAPACITY = 65536

# the span a full (generation 2) collection is recorded as
GC_SPAN = "runtime.gc"


class Span(NamedTuple):
    """One closed span. `parent` is the sequence number of the span open
    on the same thread when this one opened (-1 at a root); `thread` the
    recording thread's ident; `wave` the wave id given at the root or
    inherited from the parent (-1 where none was given)."""
    seq: int
    name: str
    t0: float
    t1: float
    parent: int
    thread: int
    wave: int


class _Open(threading.local):
    """Each thread's stack of open spans: [(seq, wave)], innermost last."""

    def __init__(self):
        self.stack: List[Tuple[int, int]] = []


class SpanCounters:
    """Named monotonic counters + accumulated wall time for hot-path spans,
    and a bounded ring of the spans' intervals.

    The profiling companion to Trace: Trace narrates ONE slow call;
    SpanCounters aggregate across thousands of fast ones (how many times
    did the extender rebuild AffinityData this session? where did the warm
    /filter's milliseconds go?). Tests assert on counts to pin cache
    behavior structurally; the benchmark reads times for attribution.

    Each closed span is also written, under the same lock as its sums,
    into a preallocated ring of `capacity` records (name code, start, end,
    parent, thread, wave id); `spans(t0, t1)` reads them back. Recording
    is always on. Collections are recorded from gc.callbacks, which may
    run while this thread holds the lock, so the callback only appends to
    a lock-free queue that the next holder of the lock folds in."""

    def __init__(self, capacity: int = RING_CAPACITY):
        self._lock = lockcheck.make_lock("SpanCounters._lock")
        self._counts: Dict[str, int] = {}
        self._times: Dict[str, float] = {}
        self.capacity = max(int(capacity), 8)
        self._ring: List[Optional[tuple]] = [None] * self.capacity
        self._names: List[str] = [GC_SPAN]
        self._codes: Dict[str, int] = {GC_SPAN: 0}
        self._seq = itertools.count()
        self._written = 0
        self._dropped = 0
        self._lost_t1 = float("-inf")  # latest end of a dropped record
        self._pending: collections.deque = collections.deque()
        self._open = _Open()
        self._gc_t0: Optional[float] = None

    # ------------------------------------------------------------ counts

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            if self._pending:
                self._fold_locked()
            self._counts[name] = self._counts.get(name, 0) + n

    def add_time(self, name: str, seconds: float) -> None:
        with self._lock:
            if self._pending:
                self._fold_locked()
            self._counts[name] = self._counts.get(name, 0) + 1
            self._times[name] = self._times.get(name, 0.0) + seconds

    def count(self, name: str) -> int:
        with self._lock:
            if self._pending:
                self._fold_locked()
            return self._counts.get(name, 0)

    def time(self, name: str) -> float:
        with self._lock:
            if self._pending:
                self._fold_locked()
            return self._times.get(name, 0.0)

    def snapshot(self) -> Dict[str, Tuple[int, float]]:
        with self._lock:
            if self._pending:
                self._fold_locked()
            return {k: (c, self._times.get(k, 0.0))
                    for k, c in self._counts.items()}

    def reset(self) -> None:
        """Clear the counts and sums (the ring is kept: it is read by
        window, never by delta)."""
        with self._lock:
            if self._pending:
                self._fold_locked()
            self._counts.clear()
            self._times.clear()

    # -------------------------------------------------------------- ring

    def _close(self, name: str, seq: int, t0: float, t1: float,
               parent: int, wave: int) -> None:
        """One closed span: its sums and its ring record."""
        tid = _get_ident()
        with self._lock:
            if self._pending:
                self._fold_locked()
            counts, times = self._counts, self._times
            counts[name] = counts.get(name, 0) + 1
            times[name] = times.get(name, 0.0) + (t1 - t0)
            code = self._codes.get(name)
            if code is None:
                code = self._codes[name] = len(self._names)
                self._names.append(name)
            self._write_locked((seq, code, t0, t1, parent, tid, wave))

    def _write_locked(self, rec: tuple) -> None:
        """Store `rec` in its slot (seq modulo capacity). A slot keeps the
        newer of two records; the other is dropped."""
        i = rec[0] % self.capacity
        old = self._ring[i]
        self._written += 1
        if old is not None:
            self._dropped += 1
            if old[0] > rec[0]:
                old, rec = rec, old
            if old[3] > self._lost_t1:
                self._lost_t1 = old[3]
        self._ring[i] = rec

    def _fold_locked(self) -> None:
        """Fold in what gc callbacks queued: (counter, seconds, record)."""
        pending = self._pending
        while pending:
            name, seconds, rec = pending.popleft()
            self._counts[name] = self._counts.get(name, 0) + 1
            self._times[name] = self._times.get(name, 0.0) + seconds
            if rec is not None:
                self._write_locked(rec)

    def spans(self, t0: float = float("-inf"),
              t1: float = float("inf")) -> List[Span]:
        """The retained span records that overlap [t0, t1] (clock
        readings), in the order they opened."""
        with self._lock:
            if self._pending:
                self._fold_locked()
            recs = [r for r in self._ring
                    if r is not None and r[3] >= t0 and r[2] <= t1]
            names = list(self._names)
        recs.sort()
        return [Span(r[0], names[r[1]], r[2], r[3], r[4], r[5], r[6])
                for r in recs]

    def complete_since(self, t0: float) -> bool:
        """True when no span record that ended at or after `t0` was
        dropped: `spans(t0, ...)` then holds every span of the window."""
        with self._lock:
            if self._pending:
                self._fold_locked()
            return self._lost_t1 < t0

    def ring_stats(self) -> Dict[str, int]:
        """Records written, dropped, and the ring's capacity."""
        with self._lock:
            if self._pending:
                self._fold_locked()
            return {"written": self._written, "dropped": self._dropped,
                    "capacity": self.capacity}

    # -------------------------------------------------------- collections

    def _on_gc(self, phase: str, info: dict) -> None:
        """gc.callbacks hook: every collection adds to runtime.gc_full or
        runtime.gc_young; a full one is also a runtime.gc span on the
        thread that triggered it. Takes no lock (see the class)."""
        if phase == "start":
            self._gc_t0 = clock()
            return
        t0, self._gc_t0 = self._gc_t0, None
        if t0 is None:
            return
        t1 = clock()
        rec = None
        if info.get("generation") == 2:
            stack = self._open.stack
            parent, wave = stack[-1] if stack else (-1, -1)
            rec = (next(self._seq), 0, t0, t1, parent,
                   _get_ident(), wave)
            self._pending.append(("runtime.gc_full", t1 - t0, rec))
        else:
            self._pending.append(("runtime.gc_young", t1 - t0, None))


def self_times(spans: Iterable[Span]) -> Dict[int, float]:
    """Each span's self time by sequence number: its length less the union
    of its children's intervals (clipped to it)."""
    spans = list(spans)
    kids: Dict[int, List[Tuple[float, float]]] = {}
    for s in spans:
        if s.parent >= 0:
            kids.setdefault(s.parent, []).append((s.t0, s.t1))
    out = {}
    for s in spans:
        covered, end = 0.0, s.t0
        for a, b in sorted(kids.get(s.seq, ())):
            a, b = max(a, end), min(b, s.t1)
            if b > a:
                covered += b - a
                end = b
        out[s.seq] = (s.t1 - s.t0) - covered
    return out


# process-wide registry: the engine's and the extender's spans and
# counters, read by the benchmark, the telemetry registry and the tests
COUNTERS = SpanCounters()

_GC_HOOKED = False


def install_gc_hook() -> None:
    """Record Python's collections in COUNTERS, once per process (the
    scheduler's start() calls it)."""
    global _GC_HOOKED
    if not _GC_HOOKED:
        _GC_HOOKED = True
        gc.callbacks.append(COUNTERS._on_gc)


_FROZEN: Optional[int] = None


def freeze_long_lived() -> int:
    """Take the process's long-lived heap out of the collector's passes,
    once per process (the scheduler's start() calls it): one full
    collection, so that only objects still reachable are kept, then
    gc.freeze(). Counts runtime.gc_freeze (1) and
    runtime.gc_frozen_objects (the frozen count) in COUNTERS; returns
    that count, on every call. Later calls neither collect nor freeze.

    The cost: frozen objects are still freed by reference counting, but a
    reference cycle among them that becomes garbage after the freeze is
    never reclaimed. That is bounded by what was live at the first start:
    one process's modules, one cluster's node objects, one cache.
    Everything made after the freeze is collected as before."""
    global _FROZEN
    if _FROZEN is None:
        gc.collect()
        gc.freeze()
        _FROZEN = gc.get_freeze_count()
        COUNTERS.inc("runtime.gc_freeze")
        COUNTERS.inc("runtime.gc_frozen_objects", _FROZEN)
    return _FROZEN


class timed_span:
    """`with timed_span("extender.refresh"): ...` — count + accumulate, and
    record the interval in COUNTERS' ring. `wave` tags the span (and,
    through inheritance, its children) with a wave id."""

    __slots__ = ("name", "wave", "_t0", "_seq", "_parent", "_stack")

    def __init__(self, name: str, wave: int = -1):
        self.name = name
        self.wave = wave

    def __enter__(self):
        c = COUNTERS
        stack = self._stack = c._open.stack
        if stack:
            self._parent, inherited = stack[-1]
            if self.wave < 0:
                self.wave = inherited
        else:
            self._parent = -1
        seq = self._seq = next(c._seq)
        stack.append((seq, self.wave))
        self._t0 = clock()
        return self

    def __exit__(self, *exc):
        t1 = clock()
        stack = self._stack
        seq = self._seq
        if stack[-1][0] == seq:
            stack.pop()
        else:
            stack[:] = [e for e in stack if e[0] != seq]
        COUNTERS._close(self.name, seq, self._t0, t1, self._parent,
                        self.wave)
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
