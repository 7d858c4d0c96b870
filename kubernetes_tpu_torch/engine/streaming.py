"""The always-on incremental scheduler loop (a copy of the reference
package's engine/streaming.py; the fast lane's device-idle test reads the
port's WaveHandle.is_ready).

BENCH_r09 exposed the shape of the old engine: a pre-loaded 30k-pod
backlog drained at 28.8k pods/s, but under a live 5k/s offered stream it
bound almost nothing while pods arrived (backlog 29k at offer end, p99
create->bound 2.2 s) — a batch drain wearing a streaming costume. A real
kube-scheduler is never drained; it runs forever against a churning
cluster. This module inverts the control flow: the LOOP owns the
scheduler (pop whatever is queued the moment the device frees up)
instead of a scenario owning rounds.

ScheduleLoop is the one engine for both shapes:

- FIXED mode (``budget_s=None``) is the pipelined drain: each step pops
  one fixed-size chunk, dispatches its fused wave eval without blocking,
  then harvests the previous chunk.
  ``Scheduler.pipeline()`` and ``run_until_drained`` ride this mode, so
  the pre-loaded drain scenarios (and their A/B tests) are unchanged.

- STREAMING mode (``budget_s`` set) admits MICRO-WAVES on a latency
  budget instead of fixed chunks: each step pops ``min(ready, quantum)``
  where the quantum is a power-of-2 admission cap adapted from the
  observed per-wave pop->bind-complete wall clock. The quantum doubles
  while full waves finish well under budget (amortizing per-wave fixed
  costs when the stream runs hot) and halves when a wave's latency
  crosses the budget (bounding what one wave can make the next arrival
  wait for). Each pop is dispatched at its own size.

Between micro-waves only the delta touches the device (the Firmament
insight, PAPERS.md §Firmament: incremental re-solve over deltas turns a
fast batch solver into a low-latency online scheduler): the class
encoding is reused via the (vocab_gen, aff_seq) key, the snapshot
refresh rides the owner's changed_hint, and fence-accepted assumes fold
in through snapshot.apply_assume_delta — zero re-tensorization and zero
full node walks while the loop is live (tests/test_stream_loop.py pins
this through span counters). Correctness is unchanged from the drain:
wave k+1 is encoded blind to wave k's commits and the harvest fence
re-validates (capacity, topology, gang quorum) — admission control
changes WHEN waves run, never what a wave means.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from kubernetes_tpu_torch.observability import recorder as flightrec
from kubernetes_tpu_torch.observability.podtrace import TRACER
from kubernetes_tpu_torch.observability.recorder import RECORDER
from kubernetes_tpu_torch.ops.predicates import bucket
from kubernetes_tpu_torch.utils.trace import COUNTERS, Trace, timed_span


class ScheduleLoop:
    """A live two-stage scheduling pipeline, optionally self-pacing.

    step() pops one admission of pods, dispatches its fused wave eval
    WITHOUT blocking, then harvests the PREVIOUS admission — so wave
    k+1's device time overlaps wave k's host bookkeeping (assume, bulk
    bind, watch drain). overlap=False is the sequential debug mode:
    identical dataflow (same blind window, same fence), device forced to
    complete before the host tail — placements are bit-identical, only
    the wall-clock overlap is forfeited.

    budget_s=None (fixed mode) admits exactly ``chunk`` pods per step —
    the drain pipeline. budget_s set (streaming mode) admits up
    to the adaptive ``quantum`` (see module docstring); ``chunk`` then
    serves as the initial quantum when given.
    """

    def __init__(self, sched, chunk: int = 0, overlap: bool = True,
                 budget_s: Optional[float] = None,
                 min_quantum: int = 256, max_quantum: int = 16384,
                 fastlane=None):
        self.sched = sched
        self.overlap = overlap
        self.budget_s = budget_s
        self.inflight = None
        self._pending: Dict[str, int] = {}  # stats from interrupt flushes
        # Sparrow fast lane: when given an engine.fastlane
        # .FastLane, latency-critical pods route to the queue's fast tier
        # and are pumped between micro-waves (and while a harvest blocks
        # on the device). None = the tier is off and every step below is
        # shape-identical to the pre-fast-lane loop.
        self.fastlane = fastlane
        # per-STEP cap on critical-path fast pops: the bulk stream pays
        # the fast tier's host time out of its own budget, so one burst
        # of fast arrivals must not starve a quantum (harvest-overlap
        # pumps are exempt — the host would otherwise just be blocked on
        # the device)
        self.fast_budget = 256
        if fastlane is not None:
            sched.queue.fast_classifier = fastlane.classify
        sched._pipeline = self
        if budget_s is None:
            # fixed mode: every step admits one chunk
            self.chunk = max(int(chunk or sched.pipeline_chunk), 1)
            self.min_quantum = self.max_quantum = self.quantum = self.chunk
        else:
            self.min_quantum = bucket(max(int(min_quantum), 1))
            self.max_quantum = max(bucket(max(int(max_quantum), 1)),
                                   self.min_quantum)
            q = bucket(max(int(chunk), 1)) if chunk else self.min_quantum
            self.quantum = min(max(q, self.min_quantum), self.max_quantum)
            self.chunk = 0
        # latency model (streaming mode): EWMA of per-wave pop ->
        # bind-complete wall clock, the exact span an arriving pod adds
        # to the next pod's worst case
        self._lat_ewma = 0.0
        self._grow_streak = 0
        # housekeeping under load: empty-round gating starved
        # backoff gc + assume-TTL expiry on a saturated stream — run them
        # on a wall-clock cadence regardless of load
        self.gc_interval_s = 2.0
        self._last_gc = time.monotonic()
        # DEGRADED MODE: when the fence keeps throwing waves
        # back (fence conflicts, liveness rejects, gang rollbacks breach
        # degrade_threshold of the attempts for degrade_window consecutive
        # pod-ful steps), the optimistic blind-wave pipeline is losing to
        # churn — drop to the classic SYNCHRONOUS round (every placement
        # sees every commit; no blind window to fence) for recover_steps
        # pod-ful steps, then re-try streaming. Re-entering is cheap and
        # the hysteresis window keeps one bad wave from flapping the mode.
        self.degraded = False
        self.degrade_threshold = 0.5
        self.degrade_window = 3
        self.recover_steps = 16
        self._breach_streak = 0
        self._degraded_left = 0
        # budget-breach tracing: a pod-ful streaming
        # step that outlives the latency budget dumps its step breakdown
        # (utils/trace.Trace.log_if_long — the reference's slow-Schedule
        # discipline at the micro-wave grain). trace_now/trace_sink are
        # the test seams (fake clock, captured sink); threshold 0
        # disables the trace construction entirely.
        self.trace_threshold_s = budget_s or 0.0
        self.trace_now = time.monotonic
        self.trace_sink = None
        # stream gauges into the owner's telemetry registry:
        # quantum/backlog/degraded are THE live-introspection answers to
        # "why is p99 moving" — re-registering under one key means a
        # replacement loop supersedes a closed one
        telemetry = getattr(sched, "telemetry", None)
        if telemetry is not None:
            telemetry.register_gauges("stream", self._gauges)

    # ------------------------------------------------------------- state

    def _gauges(self):
        """Live stream state for the telemetry registry: what every
        introspection transport reports next to the counters. A scrape
        races the loop thread, so the in-flight handle is read ONCE —
        re-reading after the None check could catch the flush swap
        mid-stride."""
        handle = self.inflight
        inflight = 0 if handle is None else len(handle.pods)
        return {"stream_quantum": self.quantum,
                "stream_backlog": self.sched.queue.ready_count() + inflight,
                "stream_inflight": inflight,
                "stream_degraded": int(self.degraded),
                "stream_budget_ms": (self.budget_s or 0.0) * 1e3,
                "stream_fast_pending": self.sched.queue.fast_count()}

    @property
    def idle(self) -> bool:
        return self.inflight is None

    def flush(self) -> None:
        """Harvest the in-flight wave NOW (watch-event interrupt, classic-
        path barrier, shutdown). Its stats fold into the next step."""
        h, self.inflight = self.inflight, None
        if h is not None:
            for k, v in self.sched._complete_wave(h).items():
                self._pending[k] = self._pending.get(k, 0) + v
            self._observe_wave(h)

    # --------------------------------------------------------- admission

    def _observe_wave(self, handle) -> None:
        """Feed one completed wave into the latency model and adapt the
        admission quantum (streaming mode only). The observed span is
        pop -> bind-complete — with the pipeline two deep it covers the
        residual device wait plus both host tails, which is exactly what
        the NEXT arrival's create->bound will inherit."""
        if self.budget_s is None:
            return
        lat = time.monotonic() - handle.pop_ts
        a = 0.3
        self._lat_ewma = lat if self._lat_ewma == 0.0 \
            else (1.0 - a) * self._lat_ewma + a * lat
        if self._lat_ewma > self.budget_s \
                and self.quantum > self.min_quantum:
            # one wave's latency crossed the budget: halve what the next
            # admission may make an arrival wait for
            self.quantum //= 2
            self._grow_streak = 0
            COUNTERS.inc("stream.quantum_shrink")
        elif len(handle.pods) >= self.quantum \
                and self._lat_ewma < 0.5 * self.budget_s \
                and self.quantum < self.max_quantum:
            # saturated waves finishing well under budget: the stream is
            # throughput-limited — grow to amortize per-wave fixed costs.
            # Two consecutive signals, so one lucky wave can't thrash the
            # quantum.
            self._grow_streak += 1
            if self._grow_streak >= 2:
                self.quantum *= 2
                self._grow_streak = 0
                COUNTERS.inc("stream.quantum_grow")
        else:
            self._grow_streak = 0

    # ---------------------------------------------------------- degraded

    def _note_health(self, stats: Dict[str, int]) -> None:
        """Feed one completed step into the churn-health model (streaming
        mode only). Attempts = binds + requeues this step surfaced; a step
        that surfaced none leaves the window untouched (idle ticks must
        not decay a breach streak the next loaded step would continue)."""
        if self.budget_s is None:
            return
        requeues = (stats.get("fence_requeued", 0)
                    + stats.get("liveness_requeued", 0)
                    + stats.get("gang_requeued", 0)
                    # sustained preemption-fence rollbacks: a
                    # store that keeps refusing atomic evict+bind commits
                    # is the same signal class as fence churn — the
                    # optimistic wave path is losing, drop to classic
                    + stats.get("preempt_rollbacks", 0))
        attempts = (stats.get("bound", 0) + requeues
                    + stats.get("preemptions", 0))
        if self.degraded:
            if attempts > 0:
                self._degraded_left -= 1
                if self._degraded_left <= 0:
                    self.degraded = False
                    self._breach_streak = 0
                    COUNTERS.inc("stream.degraded_exit")
                    if RECORDER.enabled:
                        RECORDER.record(flightrec.DEGRADED, a=0)
            return
        if attempts <= 0:
            return
        if requeues >= self.degrade_threshold * attempts:
            self._breach_streak += 1
            if self._breach_streak >= self.degrade_window:
                self.degraded = True
                self._degraded_left = self.recover_steps
                COUNTERS.inc("stream.degraded_enter")
                if RECORDER.enabled:
                    RECORDER.record(flightrec.DEGRADED, a=1,
                                    b=self._breach_streak)
        else:
            self._breach_streak = 0

    # --------------------------------------------------------- fast lane

    def _pump_fast(self, stats: Dict[str, int], limit: int = 0,
                   busy=None) -> int:
        """Drain the queue's fast tier through the FastLane executor —
        the tier-aware pop interleaved between micro-waves.
        ``limit`` caps pods this pump (0 = all); ``busy`` is an extra
        WaveHandle still owning the device (the harvest-overlap poll
        passes the wave it is waiting out). Routing is latency policy:
        the sampled eval runs on the resident device arrays only while
        NO wave is in flight (a launch queued behind a wave inherits the
        wave's latency), else the bit-equal host twin. "In flight" is
        the port's WaveHandle.is_ready: the wave's job (device work and
        its fetch) has not finished."""
        fl = self.fastlane
        if fl is None:
            return 0
        q = self.sched.queue
        if not q.fast_count():
            return 0
        pods = q.pop_fast(max_n=limit)
        if not pods:
            return 0
        pop_ts = time.monotonic()
        device_ok = True
        for h in (self.inflight, busy):
            if h is not None and not h.is_ready():
                device_ok = False
                break
        for p in pods:
            fl.schedule(p, pop_ts, device_ok=device_ok)
        stats["fast_popped"] = stats.get("fast_popped", 0) + len(pods)
        return len(pods)

    # -------------------------------------------------------------- step

    def step(self, wait: float = 0.0) -> Dict[str, int]:
        """One step: sync, pop a chunk, dispatch its wave, harvest the
        previous one (the module docstring); under a pipeline.step
        span."""
        with timed_span("pipeline.step"):
            return self._step(wait)

    def _step(self, wait: float) -> Dict[str, int]:
        s = self.sched
        stats = {"popped": 0, "bound": 0, "unschedulable": 0,
                 "bind_errors": 0, "preemptions": 0, "fence_requeued": 0,
                 "liveness_requeued": 0, "degraded_steps": 0}
        # budget-breach tracing (streaming mode): narrate THIS step's
        # phases; dumped only when the step outlives the budget — the
        # scheduler's slow-Schedule discipline at the micro-wave grain
        trace = None
        if self.budget_s is not None and self.trace_threshold_s > 0:
            trace = Trace("micro-wave step", now=self.trace_now,
                          sink=self.trace_sink, quantum=self.quantum)
        s.sync()  # columnar; node/volume events flush the pipeline first
        if trace is not None:
            trace.step("informer sync done")
        if self.fastlane is not None:
            # fast tier first: a latency-critical pod that
            # arrived in the sync above binds BEFORE this step's bulk
            # quantum even pops — budgeted so a fast burst can't starve
            # the bulk stream
            self._pump_fast(stats, limit=self.fast_budget)
        now = time.monotonic()
        if now - self._last_gc >= self.gc_interval_s:
            # housekeeping regardless of load: a saturated
            # stream never sees an empty round, so the empty-round-gated
            # gc would let backoff stamps for long-bound pods and expired
            # assumes grow without bound over a long run
            s._idle_gc()
            self._last_gc = now
        with timed_span("pipeline.pop"):
            pods = s.queue.pop_batch(max_n=self.quantum, wait=wait)
        stats["popped"] = len(pods)
        if trace is not None and pods:
            trace.field("popped", len(pods))
            trace.step("micro-wave popped")
        handle = None
        if not pods:
            # parked-gang sweep on empty steps only: a pod-ful step either
            # takes the wave path (no gang members by eligibility) and
            # sweeps below, or falls back to _process_batch which runs the
            # arrival-exempt sweep itself
            s._sweep_parked_gangs(())
        if pods and self.degraded:
            # degraded mode: churn is beating the blind-wave fence — run
            # the classic synchronous round (every placement sees every
            # commit; nothing to fence) until the health model recovers
            stats["degraded_steps"] = 1
        if pods:
            pop_ts = time.monotonic()
            chunk_pods = pods
            if not self.degraded and s._wave_eligible(pods):
                # quorum-ready gangs ride the wave path as ordinary
                # batches — the harvest applies their
                # all-or-nothing fence; below-quorum members park here
                chunk_pods, gang_spans = s._release_gangs_for_wave(
                    pods, stats)
                if chunk_pods:
                    handle = s.engine.dispatch_waves(chunk_pods, pop_ts,
                                                     gangs=gang_spans)
                    if trace is not None and handle is not None:
                        trace.step("wave dispatched (async)")
            if handle is None and chunk_pods:
                # classic fallback (no chunk SHAPE lands here
                # anymore — host-check and Policy chunks ride the wave).
                # Remaining triggers: gangs with gang_pipeline off, a
                # gang whose quorum is unreachable from its wave-eligible
                # members, degraded mode. The counter is the no-flush
                # routing guard's observable.
                COUNTERS.inc("stream.chunk_flush")
                self.flush()
                sub = s._process_batch(chunk_pods, pop_ts)
                sub["popped"] = 0  # already counted
                for k, v in sub.items():
                    stats[k] = stats.get(k, 0) + v
                if trace is not None:
                    trace.step("classic fallback round done")
            elif handle is not None and not self.overlap:
                # sequential mode: forfeit the overlap only. The span is
                # the profiler's measure of RAW per-wave device time (no
                # host work runs between dispatch and this block)
                with timed_span("pipeline.device_sync"):
                    handle.block()
        prev, self.inflight = self.inflight, handle
        if prev is not None:
            fl = self.fastlane
            if fl is not None and (s.queue.fast_count() or fl.hot()):
                # harvest-overlap poll: the host is about to
                # block on prev's wave job anyway, so until it lands,
                # serve fast pods (host-twin evals — the device is busy)
                # and SIP the watch stream for newly created ones
                # (sync_pods_sip drains only the leading run of simple
                # pod events and can never flush/reorder the pipeline).
                # Exempt from fast_budget: these pops cost the bulk
                # stream nothing — the alternative was idle blocking.
                while not prev.is_ready():
                    if self._pump_fast(stats, busy=prev) == 0 \
                            and s.sync_pods_sip() == 0:
                        time.sleep(0.0002)
            for k, v in s._complete_wave(prev).items():
                stats[k] = stats.get(k, 0) + v
            self._observe_wave(prev)
            if self.fastlane is not None and \
                    (s.queue.fast_count() or self.fastlane.hot()):
                # post-harvest pump: the harvest above is the
                # one host section the overlap poll can't thread through
                # — a fast pod that arrived inside it binds NOW, not
                # after the next step's sync + bulk quantum (budgeted:
                # the bulk stream already got this step's wave)
                s.sync_pods_sip()
                self._pump_fast(stats, limit=self.fast_budget)
            if trace is not None:
                trace.step("previous wave harvested + bound")
        if self._pending:
            for k, v in self._pending.items():
                stats[k] = stats.get(k, 0) + v
            self._pending = {}
        if not pods:
            s._idle_gc()
        self._note_health(stats)
        if trace is not None and (pods or prev is not None):
            # only steps that did wave work can breach meaningfully; an
            # idle tick dumping its (empty) breakdown would be noise
            trace.field("bound", stats["bound"])
            trace.field("degraded", int(self.degraded))
            if TRACER.enabled and trace.total() >= self.trace_threshold_s:
                # the pod-level black box joins the step forensics
                #: a breaching step's dump names the window's
                # slowest exemplar so the per-pod timeline is one
                # /debug/pods lookup away
                ex = TRACER.snapshot()["exemplars"]
                if ex:
                    trace.field("slowest_pod", ex[0]["key"])
                    trace.field("slowest_span_ms",
                                round(ex[0]["span_ms"], 1))
            trace.log_if_long(self.trace_threshold_s)
        return stats

    # ------------------------------------------------------------ quiesce

    def settled(self) -> bool:
        """The ONE quiesce predicate (bench stop conditions, drain(),
        tests): pipeline idle AND watch stream drained AND ready queue
        empty AND backoff heap empty. The deferred check matters: a pod
        requeued after a transient error is RETRIABLE, and declaring the
        loop settled before it re-enters would report results over a
        silently partial population. Calling this consumes watch events
        (sync side effect), like every other quiesce check before it."""
        s = self.sched
        return (self.idle and s.sync() == 0
                and s.queue.ready_count() == 0
                and not s.queue._deferred)

    def drain(self, idle_wait: float = 0.005) -> Dict[str, int]:
        """Step until settled; returns accumulated stats. Termination is
        the CALLER's contract — truly-unschedulable pods re-enter the
        ready queue forever, so scenario drivers wrap this in a
        wall-clock deadline (bench.run_arrival) or feed only placeable
        pods (warm/prime phases, tests)."""
        total: Dict[str, int] = {}
        while True:
            stats = self.step()
            for k, v in stats.items():
                total[k] = total.get(k, 0) + v
            if stats["popped"] == 0 and self.settled():
                return total
            if stats["popped"] == 0 and self.idle and idle_wait > 0:
                # a deferred pod's backoff must elapse — park on the
                # watch instead of spinning the step loop dry
                self.sched.sync(wait=idle_wait)

    # --------------------------------------------------------------- run

    def run(self, should_stop: Callable[[Dict[str, int], "ScheduleLoop"],
                                        bool],
            idle_wait: float = 0.002,
            on_step: Optional[Callable[[Dict[str, int], "ScheduleLoop"],
                                       None]] = None) -> Dict[str, int]:
        """Run continuously until ``should_stop(stats, loop)`` answers
        True — the loop owns the scheduler; scenarios observe through
        ``on_step`` and the scheduler's wave_observer instead of driving
        rounds themselves. Idle iterations (nothing popped, nothing in
        flight) block on the apiserver watch for up to ``idle_wait``
        seconds instead of busy-spinning, so an arrival wakes the loop
        the moment its event lands. Returns accumulated totals
        (close() is still the caller's job — an in-flight wave survives
        a stop so a later loop can resume it)."""
        total: Dict[str, int] = {}
        while True:
            stats = self.step()
            for k, v in stats.items():
                total[k] = total.get(k, 0) + v
            if on_step is not None:
                on_step(stats, self)
            if should_stop(stats, self):
                return total
            if stats["popped"] == 0 and self.idle and idle_wait > 0:
                # block for arrivals on the watch condition, not a sleep:
                # sync(wait=) parks on the apiserver's lock and wakes on
                # the next event broadcast
                self.sched.sync(wait=idle_wait)

    def close(self) -> Dict[str, int]:
        """Drain the in-flight wave and detach from the scheduler; returns
        any stats not yet reported through step()."""
        self.flush()
        out, self._pending = self._pending, {}
        if self.sched._pipeline is self:
            self.sched._pipeline = None
        # drop OUR gauges from the owner's registry (a replacement loop's
        # registration already superseded them — leave that one alone):
        # a closed loop serving stale quantum/degraded answers would be
        # introspection lying, and the registered bound method would pin
        # this loop (and its WaveHandle fields) alive
        telemetry = getattr(self.sched, "telemetry", None)
        if telemetry is not None:
            telemetry.unregister_gauges("stream", only_if=self._gauges)
        return out
