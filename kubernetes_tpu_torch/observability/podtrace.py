"""Pod-level black box: sampled per-pod lifecycle tracing.

The flight recorder (recorder.py) answers "what did wave k do"; nothing
answered "why was THIS pod slow" — every tail investigation since r06
was a hand-built join of creator stamps against wave instants. Sparrow's
evaluation (PAPERS.md) rests on per-task latency decomposition; Borg's
operability on tasks self-publishing their own state. This module gives
every SAMPLED pod a typed event timeline stamped at the seams the pod
actually crosses:

    ENQUEUED        admitted to the scheduling queue (a=1 on a backoff
                    requeue, 0 on first admission).
    POPPED          left the queue in one admission batch (a=batch size
                    = the realized quantum, b=this pod's pop round).
    WAVE_DISPATCHED rode a fused wave eval (a=wave id).
    HARVESTED       its wave's device->host sync + fence completed and
                    the pod SURVIVED (a=wave id).
    FENCE_REQUEUED  the fence threw it back (a=typed reason code — see
                    REASON_NAMES: capacity / affinity / liveness / gang
                    / stale-encoding).
    GANG_GATED      parked below gang quorum (a=members waiting).
    PREEMPT_VICTIM  planned as a preemption victim (a=preemptor node
                    row when known).
    EVICTED         a committed preemption unbound it (it re-enters as
                    an ordinary arrival — the next ENQUEUED continues
                    the same timeline).
    BOUND           bind write confirmed (terminal: the timeline
                    completes, feeds the critical-path aggregate, and
                    competes for the tail-exemplar reservoir).
    WIRE_HOP        one transport hop of a fleet scheduleOne (a=
                    transport code — WIRE_HTTP/WIRE_BINARY/
                    WIRE_EMBEDDED, b=verb code HOP_FILTER/HOP_BIND).
    CREATED         wire-ingress birth stamp (a frontend beginning a
                    trace before any queue exists).

Cost model (the reason this can stay armed in production):

- OFF (the default): every emit site guards on ``TRACER.enabled`` —
  one attribute load and a branch; nothing allocates, no clock is read.
  Exact no-op.
- ON: HEAD-SAMPLING admits 1-in-``sample`` pods by a deterministic
  crc32 of the pod key (crc32(key) & mask == 0 — stable across
  processes, so a creator and a scheduler agree without coordination);
  non-sampled pods cost one dict probe per seam. Sampled timelines are
  bounded three ways: ``max_live`` concurrent timelines (past it, new
  begins are DROPPED and counted — never silent), ``max_events`` per
  timeline (fence-requeue loops cannot grow one pod unboundedly), and
  a per-window rotation that abandons stale live entries. bench.py
  measures the total as an interleaved on/off A/B on the arrival
  headline (podtrace_overhead_pct in the BENCH artifact).

Completion feeds three consumers:

- the CRITICAL-PATH aggregate: consecutive event deltas telescope into
  named phases (queue_wait / requeue_wait / dispatch / device /
  bind_flush / fence / gang_wait / classic_round / wire / other) whose
  per-pod sum equals the pod's first-event->BOUND span EXACTLY (by
  construction — the phases are a partition of the timeline), summed
  per window and served through the TelemetryRegistry;
- the TAIL-EXEMPLAR reservoir: the slowest ``exemplars`` completed
  timelines per window keep their FULL event lists (the forensics
  payload of /debug/pods and the Perfetto pod lanes);
- the SLO engine (slo.py) observes every bound pod's span separately —
  SLO math runs over ALL pods, not the sampled subset.

Trace context ACROSS transports: a fleet scheduleOne's filter->bind
hops join one timeline keyed by the trace id (the pod key). The HTTP
sidecar reads the ``X-Pod-Trace`` header, the binary wire carries
FLAG_TRACE + a trace-id field on FILTER/BIND (framing.wrap_trace), and
the embedded API passes ``trace_ctx=`` natively — presence of a context
forces the sample (the CLIENT made the head decision; servers honor
it), so a sampled pod's timeline is identical in shape whichever wire
carried it (transport parity is test-pinned).

Host-pure like the recorder: every stamp is a monotonic timestamp plus
host ints already in hand — fetching a device value to "trace" it would
be exactly the GL002 hidden-sync hazard, and the graftlint fixture pins
that the shipped seams stay silent while a fetching variant fires.
"""

from __future__ import annotations

import os
import threading
from kubernetes_tpu_torch.analysis import lockcheck
import time
import zlib
from typing import Dict, List, Optional, Sequence

# ---------------------------------------------------------- event kinds

CREATED = 0
ENQUEUED = 1
POPPED = 2
WAVE_DISPATCHED = 3
HARVESTED = 4
FENCE_REQUEUED = 5
GANG_GATED = 6
PREEMPT_VICTIM = 7
EVICTED = 8
BOUND = 9
WIRE_HOP = 10
# fast-lane eval: the pod's sampled power-of-k scoring ran —
# a carries the eval path (0=device [1,k] dispatch, 1=host twin), b the
# attempt number (0 first try, >0 a fence-loss resample)
FAST_DISPATCHED = 11

KIND_NAMES = ("created", "enqueued", "popped", "wave_dispatched",
              "harvested", "fence_requeued", "gang_gated",
              "preempt_victim", "evicted", "bound", "wire_hop",
              "fast_dispatched")

# typed fence-requeue reasons: the one folded
# "fence_requeued" count becomes attributable — capacity races vs
# topology vs dying nodes vs gang rollbacks vs stale encodings are
# different production stories with different fixes
REASON_CAPACITY = 0
REASON_AFFINITY = 1
REASON_LIVENESS = 2
REASON_GANG = 3
REASON_STALE = 4
# double_claim: the pod itself is already claimed — another
# scheduler process committed it through the shared cell's fence. Only
# the WIRE fence can attribute this reason (the wave engine owns its
# pods exclusively); it shares this vocabulary so the wire's typed
# bind_conflict_reason_* counters partition with the same names as the
# engine's fence_reason_* requeues.
REASON_DOUBLE_CLAIM = 5
# host_check / policy: the last two serializing chunk shapes
# now ride the wave blind — host-check classes against a precomputed
# static host column (or an exact harvest-tail oracle), Policy classes
# against frozen policy fit/score columns. Their fence losers are their
# own production story: a label or workload-set change raced the wave
# in flight, the conservative fence caught it, and the pod requeued
# instead of binding on stale truth.
REASON_HOSTCHECK = 6
REASON_POLICY = 7

REASON_NAMES = ("capacity", "affinity", "liveness", "gang",
                "stale_encoding", "double_claim", "host_check",
                "policy")

# wire-hop codes
WIRE_HTTP = 0
WIRE_BINARY = 1
WIRE_EMBEDDED = 2
WIRE_NAMES = ("http", "binary", "embedded")
HOP_FILTER = 0
HOP_BIND = 1
HOP_NAMES = ("filter", "bind")

# phase vocabulary of the critical-path decomposition (decompose()).
# fast_eval / fast_bind decompose a fast-lane pod's span:
# pop -> sampled eval, then eval -> bind-complete — the two halves of
# the sub-10 ms budget, attributable separately
PHASE_NAMES = ("queue_wait", "requeue_wait", "dispatch", "device",
               "bind_flush", "classic_round", "fence", "gang_wait",
               "wire", "fast_eval", "fast_bind", "other")


def phase_of(prev_k: int, k: int, requeued: bool) -> str:
    """Phase label for ONE consecutive-event transition — shared by the
    window aggregate (decompose) and the Perfetto pod lanes, so the
    picture and the numbers can never disagree."""
    if prev_k == GANG_GATED:
        return "gang_wait"
    if k == POPPED or k == ENQUEUED:
        return "requeue_wait" if requeued else "queue_wait"
    if k == WAVE_DISPATCHED:
        return "dispatch"
    if k == FAST_DISPATCHED:
        return "fast_eval"  # pop -> sampled [1,k] eval
    if k == HARVESTED:
        return "device"
    if k == BOUND:
        if prev_k == HARVESTED:
            return "bind_flush"
        if prev_k == FAST_DISPATCHED:
            return "fast_bind"  # eval -> fence + bind-complete
        if prev_k == POPPED:
            return "classic_round"
        if prev_k == WIRE_HOP:
            return "wire"  # wire-path bind verdict landing
        return "other"
    if k == FENCE_REQUEUED:
        return "fence"
    if k == WIRE_HOP:
        return "wire"
    return "other"


def decompose(events: Sequence[tuple]) -> Dict[str, float]:
    """Telescoping critical-path decomposition of one timeline: each
    consecutive event delta is attributed to ONE phase, so the phase
    sums partition the span exactly —
    ``sum(decompose(ev).values()) == ev[-1].t - ev[0].t`` to float
    resolution. Events are (kind, t, a, b) tuples, time-ordered."""
    out: Dict[str, float] = {}
    if len(events) < 2:
        return out
    requeued = False
    prev_k = events[0][0]
    prev_t = events[0][1]
    for k, t, _a, _b in events[1:]:
        ph = phase_of(prev_k, k, requeued)
        if k == FENCE_REQUEUED:
            requeued = True
        out[ph] = out.get(ph, 0.0) + (t - prev_t)
        prev_k, prev_t = k, t
    return out


class PodTracer:
    """Bounded, head-sampled per-pod lifecycle tracer (module docstring).

    One lock guards the live map, the done-set, the window aggregates
    and the exemplar heap; batch emit sites take it once per BATCH, not
    per pod. Everything here is host ints, floats and small lists —
    never a device value."""

    def __init__(self, sample: int = 0, max_live: int = 0,
                 exemplars: int = 0, window_s: float = 0.0,
                 max_events: int = 64, now=time.monotonic):
        if sample <= 0:
            sample = int(os.environ.get("GRAFT_PODTRACE_SAMPLE", 64))
        if max_live <= 0:
            max_live = int(os.environ.get("GRAFT_PODTRACE_MAX_LIVE", 4096))
        if exemplars <= 0:
            exemplars = int(os.environ.get("GRAFT_PODTRACE_EXEMPLARS", 32))
        if window_s <= 0:
            window_s = float(os.environ.get("GRAFT_PODTRACE_WINDOW_S", 60))
        # sample normalizes to a power of two so the admit check is one
        # AND (1-in-(mask+1)); sample=1 traces everything (tests/audits)
        self.sample = 1 << max(int(sample) - 1, 0).bit_length()
        self._mask = self.sample - 1
        self.max_live = max(int(max_live), 8)
        self.exemplar_k = max(int(exemplars), 1)
        self.window_s = float(window_s)
        self.max_events = max(int(max_events), 8)
        self.enabled = False
        self._now = now
        self._lock = lockcheck.make_lock("PodTracer._lock")
        self._live: Dict[str, List[tuple]] = {}
        self._done: set = set()         # completed this window (dup audit)
        self._seq = 0
        self._window_start = now()
        # slowest-K min-heap of (span, seq, key, events)
        self._heap: List[tuple] = []
        self._prev_exemplars: List[Dict] = []
        self._phases: Dict[str, List] = {}       # name -> [count, seconds]
        self._prev_phases: Dict[str, List] = {}
        # monotonic totals (never reset by rotation)
        self._sampled_total = 0
        self._completed_total = 0
        self._dropped_live = 0
        self._dropped_events = 0
        self._duplicate_bound = 0
        self._abandoned = 0

    # ------------------------------------------------------------ control

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._live.clear()
            self._done.clear()
            self._heap = []
            self._prev_exemplars = []
            self._phases = {}
            self._prev_phases = {}
            self._window_start = self._now()
            self._sampled_total = self._completed_total = 0
            self._dropped_live = self._dropped_events = 0
            self._duplicate_bound = self._abandoned = 0

    # ----------------------------------------------------------- sampling

    def sampled(self, key: str) -> bool:
        """The head decision, deterministic across processes: crc32 of
        the pod key against the power-of-two sample mask."""
        return (zlib.crc32(key.encode()) & self._mask) == 0

    def _admit_locked(self, key: str, t: float, kind: int,
                      a: int = 0) -> Optional[List[tuple]]:
        if len(self._live) >= self.max_live:
            self._dropped_live += 1
            return None
        ev = [(kind, t, a, 0)]
        self._live[key] = ev
        self._sampled_total += 1
        return ev

    # ------------------------------------------------------------- stamps

    def begin_batch(self, keys: Sequence[str], backoff: bool = False,
                    t0: float = 0.0) -> None:
        """Queue-admission seam (queue.add/add_many/add_backoff): apply
        the head decision per key, open timelines for the winners, or
        CONTINUE an existing timeline (a backoff requeue, a victim
        re-entering after EVICTED)."""
        t = t0 or self._now()
        a = 1 if backoff else 0
        crc = zlib.crc32
        mask = self._mask
        with self._lock:
            live = self._live
            for key in keys:
                ev = live.get(key)
                if ev is not None:
                    if len(ev) < self.max_events:
                        ev.append((ENQUEUED, t, a, 0))
                    else:
                        self._dropped_events += 1
                elif (crc(key.encode()) & mask) == 0 \
                        and key not in self._done:
                    self._admit_locked(key, t, ENQUEUED, a)

    def begin_forced(self, key: str, kind: int = CREATED,
                     t0: float = 0.0) -> None:
        """Wire ingress / trace-context honor: the caller already made
        (or received) the head decision — open unconditionally."""
        t = t0 or self._now()
        with self._lock:
            if key not in self._live and key not in self._done:
                self._admit_locked(key, t, kind)

    def batch_event(self, kind: int, keys: Sequence[str], a: int = 0,
                    b: int = 0, t0: float = 0.0) -> None:
        """One typed event for every SAMPLED key in a batch (one lock,
        one dict probe per key — the non-sampled common case costs
        exactly the probe)."""
        t = t0 or self._now()
        with self._lock:
            live = self._live
            max_ev = self.max_events
            for key in keys:
                ev = live.get(key)
                if ev is None:
                    continue
                if len(ev) >= max_ev:
                    self._dropped_events += 1
                    continue
                ev.append((kind, t, a, b))

    def pop_batch(self, keys: Sequence[str], t0: float = 0.0) -> None:
        """POPPED for a whole admission batch: a = the realized quantum
        (batch size), b = this pod's pop round (how many times it has
        left the queue — requeue loops made visible)."""
        t = t0 or self._now()
        n = len(keys)
        with self._lock:
            live = self._live
            max_ev = self.max_events
            for key in keys:
                ev = live.get(key)
                if ev is None:
                    continue
                if len(ev) >= max_ev:
                    self._dropped_events += 1
                    continue
                rounds = sum(1 for e in ev if e[0] == POPPED) + 1
                ev.append((POPPED, t, n, rounds))

    def event(self, key: str, kind: int, a: int = 0, b: int = 0,
              t0: float = 0.0) -> None:
        """Single-pod stamp (gang gating, preempt victims, wire hops)."""
        t = t0 or self._now()
        with self._lock:
            ev = self._live.get(key)
            if ev is None:
                return
            if len(ev) >= self.max_events:
                self._dropped_events += 1
                return
            ev.append((kind, t, a, b))

    def wire_hop(self, trace_id: str, transport: int, verb: int,
                 t0: float = 0.0) -> None:
        """One transport hop joins the trace: presence of a context IS
        the sample decision (begin_forced), so filter->bind hops of a
        fleet scheduleOne land on one timeline whichever wire carried
        them."""
        t = t0 or self._now()
        with self._lock:
            ev = self._live.get(trace_id)
            if ev is None:
                if trace_id in self._done:
                    return
                ev = self._admit_locked(trace_id, t, CREATED)
                if ev is None:
                    return
            if len(ev) >= self.max_events:
                self._dropped_events += 1
                return
            ev.append((WIRE_HOP, t, transport, verb))

    def evicted_batch(self, keys: Sequence[str], t0: float = 0.0) -> None:
        """A committed preemption unbound these pods: stamp EVICTED on
        any live timeline (rare — a victim usually completed long ago)
        and clear the done-mark, so the victim's RE-placement opens a
        fresh timeline whose eventual BOUND is a legitimate second bind,
        not a duplicate witness."""
        t = t0 or self._now()
        with self._lock:
            for key in keys:
                self._done.discard(key)
                ev = self._live.get(key)
                if ev is not None and len(ev) < self.max_events:
                    ev.append((EVICTED, t, 0, 0))

    # --------------------------------------------------------- completion

    def bound_batch(self, keys: Sequence[str], t0: float = 0.0) -> None:
        """Terminal BOUND for every sampled key: the timeline completes,
        its phase decomposition folds into the window aggregate, and it
        competes for the slowest-K exemplar reservoir. A key completing
        TWICE inside one window is a duplicate-bind witness — counted,
        never silently merged (the exactly-once trace audit reads
        this)."""
        import heapq
        t = t0 or self._now()
        with self._lock:
            self._rotate_locked(t)
            live = self._live
            done = self._done
            phases = self._phases
            for key in keys:
                ev = live.pop(key, None)
                if ev is None:
                    if key in done:
                        self._duplicate_bound += 1
                    continue
                ev.append((BOUND, t, 0, 0))
                if len(done) < 4 * self.max_live:
                    done.add(key)
                self._completed_total += 1
                span = t - ev[0][1]
                for ph, secs in decompose(ev).items():
                    slot = phases.get(ph)
                    if slot is None:
                        phases[ph] = [1, secs]
                    else:
                        slot[0] += 1
                        slot[1] += secs
                self._seq += 1
                heapq.heappush(self._heap, (span, self._seq, key, ev))
                if len(self._heap) > self.exemplar_k:
                    heapq.heappop(self._heap)

    def _rotate_locked(self, now: float) -> None:
        if now - self._window_start < self.window_s:
            return
        self._prev_exemplars = self._exemplars_locked()
        self._prev_phases = {k: list(v) for k, v in self._phases.items()}
        self._heap = []
        self._phases = {}
        self._done.clear()
        self._window_start = now
        # abandon stale live timelines (unschedulable forever, lost to a
        # relist): a live entry whose last stamp predates the PREVIOUS
        # window can never complete meaningfully — reclaim its slot
        cutoff = now - 2 * self.window_s
        stale = [k for k, ev in self._live.items() if ev[-1][1] < cutoff]
        for k in stale:
            del self._live[k]
        self._abandoned += len(stale)

    # ------------------------------------------------------------ reading

    @staticmethod
    def _timeline_dict(key: str, events: List[tuple]) -> Dict:
        span = events[-1][1] - events[0][1]
        phases = decompose(events)
        return {
            "key": key,
            # absolute (monotonic) first-event instant: the Perfetto pod
            # lanes align against the ring's time base with this — the
            # per-event t_ms below are pod-relative
            "t0": round(events[0][1], 6),
            "span_ms": round(span * 1e3, 6),
            "phases_ms": {ph: round(s * 1e3, 6)
                          for ph, s in sorted(phases.items())},
            "events": [{"kind": KIND_NAMES[k],
                        "t_ms": round((t - events[0][1]) * 1e3, 6),
                        "a": a, "b": b}
                       for k, t, a, b in events],
        }

    def _exemplars_locked(self) -> List[Dict]:
        out = [self._timeline_dict(key, ev)
               for _span, _seq, key, ev in
               sorted(self._heap, reverse=True)]
        return out

    def timeline(self, key: str) -> Optional[List[tuple]]:
        """The raw live timeline of one pod (tests/audits)."""
        with self._lock:
            ev = self._live.get(key)
            return list(ev) if ev is not None else None

    def snapshot(self) -> Dict:
        """The /debug/pods payload (identical on every transport):
        window phase aggregate + slowest-K exemplars, current and
        previous window, plus the bound/drop accounting."""
        with self._lock:
            self._rotate_locked(self._now())
            return {
                "sample_rate": self.sample,
                "window_s": self.window_s,
                "phases": {ph: {"count": c,
                                "seconds": round(s, 6)}
                           for ph, (c, s) in sorted(self._phases.items())},
                "exemplars": self._exemplars_locked(),
                "prev_phases": {ph: {"count": c, "seconds": round(s, 6)}
                                for ph, (c, s) in
                                sorted(self._prev_phases.items())},
                "prev_exemplars": self._prev_exemplars,
                "live": len(self._live),
                "stats": self._stats_locked(),
            }

    def _stats_locked(self) -> Dict[str, float]:
        return {"enabled": int(self.enabled),
                "sample_rate": self.sample,
                "live": len(self._live),
                "sampled_total": self._sampled_total,
                "completed_total": self._completed_total,
                "dropped_live": self._dropped_live,
                "dropped_events": self._dropped_events,
                "duplicate_bound": self._duplicate_bound,
                "abandoned": self._abandoned}

    def stats(self) -> Dict[str, float]:
        """Flat registry fold: bound accounting plus the per-window
        phase aggregate (podtrace.phase.<name>.count/seconds in the
        unified namespace — gauges, not counters: they reset with the
        window). Rotates like snapshot() so a scrape after binds stop
        never serves an arbitrarily stale window as current."""
        with self._lock:
            self._rotate_locked(self._now())
            out = self._stats_locked()
            for ph, (c, s) in self._phases.items():
                out[f"phase.{ph}.count"] = c
                out[f"phase.{ph}.seconds"] = round(s, 6)
            return out


# process-wide tracer, disabled unless armed — the emit sites all guard
# on TRACER.enabled (exact no-op off). GRAFT_PODTRACE=1 arms at import;
# bench.py flips it programmatically for the on/off A/B.
TRACER = PodTracer()
if os.environ.get("GRAFT_PODTRACE", "0") == "1":
    TRACER.enable()


__all__ = ["BOUND", "CREATED", "ENQUEUED", "EVICTED", "FAST_DISPATCHED",
           "FENCE_REQUEUED",
           "GANG_GATED", "HARVESTED", "HOP_BIND", "HOP_FILTER",
           "HOP_NAMES", "KIND_NAMES", "PHASE_NAMES", "POPPED",
           "PREEMPT_VICTIM", "PodTracer", "REASON_AFFINITY",
           "REASON_CAPACITY", "REASON_DOUBLE_CLAIM", "REASON_GANG",
           "REASON_HOSTCHECK", "REASON_LIVENESS",
           "REASON_NAMES", "REASON_POLICY", "REASON_STALE", "TRACER",
           "WAVE_DISPATCHED",
           "WIRE_BINARY", "WIRE_EMBEDDED", "WIRE_HOP", "WIRE_HTTP",
           "WIRE_NAMES", "decompose", "phase_of"]
