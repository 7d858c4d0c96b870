"""The scheduler daemon: informer sync -> queue -> batch engine -> bind.

PyTorch port of kubernetes_tpu/engine/scheduler.py. Structural mirror of
the reference's scheduler loop (plugin/pkg/scheduler/scheduler.go:149 Run
/ :253 scheduleOne and the factory's informer wiring,
factory.go:120-601), batched: instead of a single-goroutine one-pod loop,
each round drains the ready queue and places the whole batch on the
device, then binds each placement through the apiserver. The engine runs
on the card unless the caller passes ``device`` (the tests pass "cpu").

Two drain modes:

- schedule_round: the classic SYNCHRONOUS round (device placement blocks
  before host bookkeeping) through SchedulingEngine.schedule.
- run_until_drained / pipeline(): the pipelined drain
  (engine/streaming.py ScheduleLoop in its fixed-chunk mode) — wave k+1
  is dispatched to the engine's worker before wave k's harvest, so
  assume/bind/watch-drain of wave k overlap the device time of wave k+1.
  Wave k+1 is therefore encoded blind to wave k's commits; harvest
  re-validates against post-k occupancy (the fence in
  engine/scheduler_engine.harvest_waves) and capacity losers requeue —
  the same optimistic-concurrency shape as assume/expire. Host phases are
  columnar: the watch drain batches bind confirmations, assumes are
  grouped per (node, class), binds go through one bulk write, and the
  snapshot refresh rides the changed_hint / raw-delta fast paths.
  Required (anti-)affinity chunks are wave-eligible: the engine evaluates
  their masks per wave from device-resident topology occupancy, routes
  counter-inexpressible shapes to a seeded strict tail inside the harvest
  (a conflict-round loop), and the fence re-validates topology occupancy
  the same way it re-validates capacity. Quorum-ready GANGS ride the
  waves as ordinary batch rows and the harvest applies an all-or-nothing
  gang fence — below quorum, every member is dropped BEFORE anything is
  assumed (atomic rollback, zero residue) and requeues with backoff.
  With the PodPriority gate on, the harvest's unschedulable preemptors
  get a wave-path preemption round (device victim scan, exact
  verification, the store's atomic evict+bind).
- stream(fastlane=...): the always-on loop with the Sparrow fast tier
  (engine/fastlane.py) for latency-critical pods between micro-waves.

mesh=parallel/mesh.make_mesh(D): every node-indexed device tensor of the
engine stays RESIDENT sharded across the mesh's D shards, and the wave
loop runs its two-stage SPMD reduce; placements are bit-identical to the
unsharded engine (a one-device mesh is no mesh).

Error paths preserved:

- no fitting node -> FailedScheduling event + backoff requeue
  (scheduler.go:174-181; factory.go:897 MakeDefaultErrorFunc)
- bind Conflict/NotFound -> ForgetPod + backoff requeue (scheduler.go:234-249)
- bind success -> FinishBinding starts the assumed-pod TTL; the watch-stream
  confirmation (MODIFIED pod with node_name) calls cache.AddPod
  (cache.go:130,214), closing the optimistic-concurrency loop.

Watch handling mirrors client-go reflector semantics: initial List+Watch from
the returned resourceVersion; TooOldResourceVersion -> full relist rebuild.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Binding, Event, Node, Pod
from kubernetes_tpu_torch.api.workloads import to_workload_object
from kubernetes_tpu_torch.engine import gang as gangmod
from kubernetes_tpu_torch.engine.preempt_wave import (
    DisruptionBudget,
    plan_wave_preemptions,
)
from kubernetes_tpu_torch.engine.queue import SchedulingQueue
from kubernetes_tpu_torch.engine.scheduler_engine import (
    PlacementResult,
    SchedulingEngine,
)
from kubernetes_tpu_torch.engine.streaming import ScheduleLoop
from kubernetes_tpu_torch.observability import podtrace
from kubernetes_tpu_torch.observability import recorder as flightrec
from kubernetes_tpu_torch.observability.podtrace import TRACER
from kubernetes_tpu_torch.observability.recorder import RECORDER
from kubernetes_tpu_torch.observability.registry import TelemetryRegistry
from kubernetes_tpu_torch.observability.slo import SLO
from kubernetes_tpu_torch.ops import priorities as prio
from kubernetes_tpu_torch.ops.policy_algos import algorithms_from_policy
from kubernetes_tpu_torch.server.apiserver_lite import (
    ApiServerLite,
    NotFound,
    TooOldResourceVersion,
)
from kubernetes_tpu_torch.state.cache import SchedulerCache
from kubernetes_tpu_torch.utils import features
from kubernetes_tpu_torch.utils.metrics import SchedulerMetrics
from kubernetes_tpu_torch.utils.trace import SCHEDULE_TRACE_THRESHOLD_S, Trace

DEFAULT_SCHEDULER_NAME = "default-scheduler"


def _queue_copy(pod: Pod) -> Pod:
    """Shallow queue-admission copy — the isolation dataclasses.replace
    gave (both are shallow) at a fraction of the construction cost, which
    the 20k+/s arrival path pays per pod. The Pod.key memo travels
    deliberately (name/namespace are immutable identity), but the CLASS-
    KEY memo is dropped so the state/classes.py contract stays intact:
    spec mutations on one object can never carry a stale class key onto
    another across the watch→queue hop."""
    c = copy.copy(pod)
    c.__dict__.pop("_class_key", None)
    return c


class Scheduler:
    def __init__(self, api: ApiServerLite,
                 scheduler_name: str = DEFAULT_SCHEDULER_NAME,
                 priorities: Tuple[Tuple[str, int], ...] = prio.DEFAULT_PRIORITIES,
                 assumed_ttl: float = 30.0,
                 record_events: bool = True,
                 batch_mode: str = "wave",
                 policy=None,
                 now=time.monotonic,
                 mesh=None, device=None):
        self.api = api
        self.device = device
        self.scheduler_name = scheduler_name
        # "wave" = wave-parallel throughput mode (engine/waves.py, default);
        # "strict" = bit-exact sequential scheduleOne parity (engine/batch.py)
        self.batch_mode = batch_mode
        self._now = now
        self.cache = SchedulerCache(ttl_seconds=assumed_ttl, now=now)
        # Service/RC/RS/StatefulSet mirror for spreading & service affinity —
        # the extra informers of factory.go:120-140
        self._workloads: Dict[str, object] = {}
        # --policy-config-file (factory.go:619 CreateFromConfig): priority
        # set + parameterized algorithm args come from the Policy when given
        self._policy_algos = None
        if policy is not None:
            kernel_prios, self._policy_algos = algorithms_from_policy(policy)
            if policy.priorities is not None:
                priorities = kernel_prios
        # mesh: a 1-D node-axis parallel/mesh.Mesh makes every
        # node-indexed device tensor RESIDENT-SHARDED across its devices
        # and routes waves_loop through the two-stage SPMD reduce;
        # placements stay bit-identical to the unsharded engine
        self.engine = SchedulingEngine(
            self.cache, priorities=priorities, device=device,
            workloads_provider=lambda: list(self._workloads.values()),
            policy_algos=self._policy_algos, mesh=mesh)
        # this Scheduler owns its cache exclusively and routes every
        # mutation through the engine's dirty notes, so refreshes may take
        # the targeted changed_hint path instead of walking all N nodes
        self.engine.track_dirty = True
        self.queue = SchedulingQueue(now=now)
        # pipelined drain knobs (run_until_drained/run_arrival): chunk =
        # pods per wave (double-buffered), set by PIPELINE_CHUNK-style
        # callers; _pipeline is the live pipeline whose in-flight wave a
        # capacity-unsafe watch event must flush before applying
        self.pipeline_chunk = 4096
        self._pipeline = None
        # gangs ride the pipelined wave path: quorum-eligible
        # gangs dispatch as ordinary wave batches with an all-or-nothing
        # gang fence at harvest. False restores the r07/r08 behavior —
        # every gang-bearing chunk flushes the pipeline into the classic
        # synchronous round — kept reachable as the A/B baseline
        # (bench.measure_gang_mix flips this attribute for the
        # gangmix_flush_elapsed_s measurement).
        self.gang_pipeline = True
        # wave-path preemption: with the PodPriority gate on,
        # a harvest's unschedulable preemptors plan displacements against
        # the snapshot's priority bands and commit through the store's
        # ATOMIC evict+bind — the pipeline never flushes for priority.
        # False keeps the classic nominate-then-reschedule rounds as the
        # only preemption path (and run_until_drained's auto-select
        # still routes PodPriority drains classic regardless).
        self.wave_preemption = True
        # PodDisruptionBudget-shaped eviction rate limit: sliding
        # max-evictions-per-minute window plus optional per-band floors;
        # denied plans count budget_deferred and wait out their backoff.
        self.disruption_budget = DisruptionBudget(now=now)
        # bench hook: preempt_observer(commit_monotonic, latency_s,
        # victim_count) after every committed preemption. None = off.
        self.preempt_observer = None
        self.metrics = SchedulerMetrics()
        # unified telemetry: this scheduler's histograms +
        # counters in the one labeled namespace; a live ScheduleLoop
        # registers its stream gauges (quantum/backlog/degraded) here
        self.telemetry = TelemetryRegistry()
        self.telemetry.register_metrics("scheduler", self.metrics)
        self.record_events = record_events
        self.events: List[Event] = []
        # per-wave bind telemetry for loop owners (bench.run_arrival's
        # honest create->bound accounting): called as
        # wave_observer(bind_done_monotonic, bound_pod_keys) after every
        # successful bulk bind — classic rounds and pipelined harvests
        # alike — so a scenario can join bind instants against its own
        # creation stamps without touching scheduler internals. None = off.
        self.wave_observer = None
        # federation spill hook: when set, a pod whose
        # unschedulable verdicts reach spill_after_attempts LEAVES this
        # cell — handed to spill_handler(pods) instead of backoff-
        # requeued, so the front-door router can re-admit it to a
        # sibling cell with spare capacity (PAPERS.md §Borg spillover).
        # Gang members never spill individually: gangs route whole-cell
        # and their below-quorum retries stay on the backoff path. None
        # (the default) keeps single-cell behavior bit-identical.
        self.spill_handler = None
        self.spill_after_attempts = 3
        self._unsched_attempts: Dict[str, int] = {}
        # gangs parked below quorum: name -> {pod key: pod} (engine/gang.py)
        self._gang_waiting: Dict[str, Dict[str, Pod]] = {}
        # gangs whose quorum committed: members now schedule individually
        # (insertion-ordered; trimmed so unbounded gang churn can't leak)
        self._gang_degraded: Dict[str, None] = {}
        self._gang_parked_at: Dict[str, float] = {}
        self._rv = 0
        self._pods: Dict[str, Pod] = {}  # last-seen apiserver pod state
        # pod key -> wall-clock instant first seen unscheduled: the start
        # of the honest create->bound latency (always time.monotonic, even
        # when self._now is a fake test clock — latency is wall time)
        self._first_queued: Dict[str, float] = {}
        self._started = False

    # ------------------------------------------------------------ lifecycle

    WORKLOAD_KINDS = ("Service", "ReplicationController", "ReplicaSet",
                      "StatefulSet")
    VOLUME_KINDS = ("PersistentVolume", "PersistentVolumeClaim")

    def start(self) -> None:
        """Initial List (reflector handshake): nodes + pods into cache/queue."""
        nodes, _ = self.api.list("Node")
        for n in nodes:
            self.cache.add_node(n)
        for kind in self.WORKLOAD_KINDS:
            for w in self.api.list(kind)[0]:
                self._workloads[kind + "/" + getattr(w, "namespace", "")
                                + "/" + w.name] = to_workload_object(kind, w)
        vctx = self.engine.volume_ctx
        for pv in self.api.list("PersistentVolume")[0]:
            vctx.pvs[pv.name] = pv
        for pvc in self.api.list("PersistentVolumeClaim")[0]:
            vctx.pvcs[(pvc.namespace, pvc.name)] = pvc
        vctx.version += 1
        pods, rv = self.api.list("Pod")
        listed_at = time.monotonic()  # one instant for the whole List —
        # 30k per-pod clock reads would be pure accounting overhead
        for p in pods:
            self._pods[p.key()] = p
            if p.node_name:
                self.cache.add_pod(p)
            elif self._responsible_for(p):
                self._first_queued.setdefault(p.key(), listed_at)
                self.queue.add(_queue_copy(p))
        self._rv = rv
        self._started = True

    def sync(self, wait: float = 0.0) -> int:
        """Drain watch events into cache + queue (the informer event handlers
        of factory.go:188-260). Returns number of events processed.

        Columnar drain: a bind storm's confirmation events (MODIFIED pod,
        unbound -> bound — 30k of them per headline round) batch into ONE
        queue sweep + ONE cache lock pass, and an ARRIVAL storm's fresh
        unbound pods (ADDED, no node — 20k+/s offered under the always-on
        loop) batch into ONE queue admission, instead of a
        per-event dispatch loop. Events that can invalidate an in-flight
        pipelined wave's static assumptions (node spec/membership, PV/PVC)
        flush the pipeline BEFORE being applied, so the wave's fence only
        ever needs the capacity re-check."""
        if not self._started:
            self.start()
            return 0
        try:
            events = self.api.watch_since(
                ("Pod", "Node") + self.WORKLOAD_KINDS + self.VOLUME_KINDS,
                self._rv, timeout=wait)
        except TooOldResourceVersion:
            self._interrupt_pipeline()  # the in-flight wave belongs to the
            # pre-relist engine; harvest it against that state first
            self._relist()
            return 0
        if not events:
            return 0
        confirms: List[Pod] = []
        fresh: List[Pod] = []  # ADDED unbound pods we are responsible for:
        # admitted columnar (one queue lock), flushed BEFORE confirms at
        # every flush point so an add->bind pair inside one batch lands in
        # event order
        buffered: Dict[str, Pod] = {}  # key -> newest BUFFERED pod: the
        # confirm gate must see pods buffered earlier in this batch, but
        # self._pods only updates at flush so a mid-batch exception leaves
        # it consistent with what was actually applied
        simple_ok = not self._gang_waiting
        pods_map = self._pods
        # the cursor advances per PROCESSED event via a cheap local (an
        # attribute store per event is measurable at 30k confirmations per
        # round): buffered-but-unflushed confirms do NOT advance it, so a
        # handler exception mid-batch rolls the cursor back to the last
        # applied event and a retried sync() re-fetches the rest —
        # re-applying a flushed confirm is idempotent, skipping one is not
        last_rv = self._rv
        try:
            for ev in events:
                kind = ev.kind
                obj = ev.obj
                if simple_ok and kind == "Pod" and ev.type == "MODIFIED" \
                        and obj.node_name:
                    key = obj.key()
                    prev = buffered.get(key)
                    if prev is None:
                        prev = pods_map.get(key)
                    if prev is not None and not prev.node_name:
                        # unbound -> bound: a bind confirmation (ours or a
                        # foreign scheduler's). Capacity effects are noted
                        # by the bulk flush; no in-flight flush needed.
                        buffered[key] = obj
                        confirms.append(obj)
                        continue
                if simple_ok and kind == "Pod" and ev.type == "ADDED" \
                        and not obj.node_name \
                        and self._responsible_for(obj):
                    # fresh pending pod (the arrival-storm shape): buffer
                    # for one columnar queue admission. Mirrors
                    # _on_pod_event's ADDED-unbound branch exactly.
                    buffered[obj.key()] = obj
                    fresh.append(obj)
                    continue
                # slow path: apply buffered fresh adds then confirms FIRST
                # (per-pod event order preserved — a fresh add and its own
                # bind confirmation can only appear in that order without
                # a slow event between them), then dispatch the handler
                if fresh or confirms:
                    self._flush_fresh(fresh)
                    if confirms:
                        self._flush_confirms(confirms, buffered)
                    last_rv = ev.rv - 1
                if kind == "Pod":
                    self._on_pod_event(ev.type, obj)
                elif kind == "Node":
                    # liveness fence: a dying node (deletion,
                    # cordon, NotReady flap) is marked doomed BEFORE any
                    # pipeline flush, so a wave harvested against the
                    # pre-event cache requeues rows targeting it instead
                    # of binding into a ghost. Cleared after the event
                    # applies: the refreshed snapshot then carries the
                    # verdict itself.
                    dying = (ev.type == "DELETED" or obj.unschedulable
                             or not obj.is_ready())
                    if dying:
                        self.engine.note_node_doomed(obj.name)
                    if self._node_event_needs_flush(ev.type, obj):
                        self._interrupt_pipeline()
                    self._on_node_event(ev.type, obj)
                    if dying:
                        self.engine.clear_node_doomed(obj.name)
                elif kind in self.VOLUME_KINDS:
                    self._interrupt_pipeline()
                    self._on_volume_event(kind, ev.type, obj)
                else:
                    key = (kind + "/" + getattr(obj, "namespace", "")
                           + "/" + obj.name)
                    if ev.type == "DELETED":
                        self._workloads.pop(key, None)
                    else:
                        self._workloads[key] = to_workload_object(kind, obj)
                last_rv = ev.rv
            self._flush_fresh(fresh)
            if confirms:
                self._flush_confirms(confirms, buffered)
            self._rv = events[-1].rv
        except BaseException:
            self._rv = last_rv
            raise
        return len(events)

    def sync_pods_sip(self) -> int:
        """Drain ONLY the leading run of simple pod events — fresh
        pending ADDs and bind confirmations — from the watch stream: the
        fast lane's poll-during-harvest sip. While the
        streaming loop blocks on a wave's device array, this lets newly
        created latency-critical pods reach the queue WITHOUT running a
        full sync(): the first event the columnar fast paths can't
        absorb (node, volume, workload, deletes, spec mods) stops the
        sip with the cursor parked BEFORE it, so the next full sync()
        applies it in order — a sip can therefore never flush the
        pipeline or reorder harvests. Idempotency mirrors sync(): the
        cursor only advances after the flush lands, and re-applying a
        flushed run is safe."""
        if not self._started or self._gang_waiting:
            return 0
        try:
            events = self.api.watch_since(
                ("Pod", "Node") + self.WORKLOAD_KINDS + self.VOLUME_KINDS,
                self._rv, timeout=0.0)
        except TooOldResourceVersion:
            return 0  # the next full sync() owns the relist
        if not events:
            return 0
        confirms: List[Pod] = []
        fresh: List[Pod] = []
        buffered: Dict[str, Pod] = {}
        pods_map = self._pods
        last_rv = self._rv
        for ev in events:
            if ev.kind != "Pod":
                break
            obj = ev.obj
            if ev.type == "MODIFIED" and obj.node_name:
                key = obj.key()
                prev = buffered.get(key)
                if prev is None:
                    prev = pods_map.get(key)
                if prev is not None and not prev.node_name:
                    buffered[key] = obj
                    confirms.append(obj)
                    last_rv = ev.rv
                    continue
                break
            if ev.type == "ADDED" and not obj.node_name \
                    and self._responsible_for(obj):
                buffered[obj.key()] = obj
                fresh.append(obj)
                last_rv = ev.rv
                continue
            break
        applied = len(fresh) + len(confirms)
        if not applied:
            return 0
        self._flush_fresh(fresh)
        if confirms:
            self._flush_confirms(confirms, buffered)
        self._rv = last_rv  # advanced only past APPLIED events
        return applied

    def _flush_fresh(self, fresh: List[Pod]) -> None:
        """Admit a run of fresh pending pods columnar: one bookkeeping
        pass, one queue lock (queue.add_many). Per-pod semantics identical
        to _on_pod_event's ADDED-unbound branch; the queue copies are
        shallow (copy.copy), which also carries the Pod.key/_class_key
        memos forward instead of re-deriving them per admission.
        Idempotent per pod (queue dedup + setdefault), so a retried sync()
        may safely re-apply. One clock read for the whole run: the stamps
        feed the metrics distribution, and sync() runs per wave — finer
        granularity than the sync cadence would be fiction anyway (the
        bench's honest latency joins against the CREATOR's stamps)."""
        if not fresh:
            return
        now = time.monotonic()
        pods_map = self._pods
        fq = self._first_queued
        copies = []
        for p in fresh:
            k = p.key()
            pods_map[k] = p
            if k not in fq:
                fq[k] = now
            copies.append(_queue_copy(p))
        self.queue.add_many(copies)
        fresh.clear()

    def _flush_confirms(self, confirms: List[Pod],
                        buffered: Dict[str, Pod]) -> None:
        """Apply a run of bind confirmations columnar: one queue sweep, one
        cache lock, one bookkeeping pass. Per-pod semantics identical to
        _on_pod_event's unbound->bound branch, order preserved per pod.
        Idempotent per pod, so a retried sync() may safely re-apply."""
        keys = [p.key() for p in confirms]
        self.queue.remove_many(keys)
        touched = self.cache.add_pods_bulk(confirms)
        if touched:  # foreign binds / moves mutated NodeInfos
            self.engine.note_node_dirty(*touched)
        pods_map = self._pods
        fq = self._first_queued
        for k, p in zip(keys, confirms):
            pods_map[k] = p
            fq.pop(k, None)
        confirms.clear()
        buffered.clear()

    def _interrupt_pipeline(self) -> None:
        """Harvest any in-flight pipelined wave NOW — called before applying
        a watch event the wave's capacity fence cannot re-validate (node
        spec/membership, volume topology)."""
        if self._pipeline is not None:
            self._pipeline.flush()

    def _node_event_needs_flush(self, etype: str, node: Node) -> bool:
        """Does this node event invalidate anything the in-flight wave's
        fence cannot re-validate? (flushing per event was ~all of
        the churn throughput collapse — at 10%/min on 5k nodes the
        pipeline never kept two waves in flight.)

        LIVENESS-ONLY transitions don't need the flush anymore: rows
        targeting a dead/cordoned/NotReady node are caught by the fence's
        liveness re-validation (doomed set + refreshed schedulable/valid),
        and a DELETED node tombstones in place so node order — which the
        fence's row indices bake — never moves. A respawn onto a
        tombstone is safe too: the in-flight wave was dispatched while
        the row was invalid, so no row targets it. What still flushes:
        SPEC changes (labels/taints/allocatable/avoid — the static
        predicates are evaluated at dispatch and never re-checked) and
        genuinely NEW nodes (membership growth reorders the snapshot
        under the fence's indices)."""
        pipe = self._pipeline
        if pipe is None or pipe.idle:
            return False
        if etype == "DELETED":
            return False  # tombstone + liveness fence cover it
        with self.cache._lock:
            info = self.cache._nodes.get(node.name)
            prev = info.node if info is not None else None
        if info is None:
            return True   # new name: membership reorder at next refresh
        if prev is None:
            return False  # respawn onto a tombstone: no in-flight row
            # can target it, and the name keeps its row
        return not (prev.labels == node.labels
                    and prev.taints == node.taints
                    and prev.allocatable == node.allocatable
                    and prev.capacity == node.capacity
                    and prev.allowed_pod_number == node.allowed_pod_number
                    and prev.annotations == node.annotations)

    # ------------------------------------------------------------ scheduling

    def schedule_round(self, max_batch: int = 0, wait: float = 0.0) -> Dict[str, int]:
        """One batch round: pop ready pods, place on device, bind. Mirrors
        scheduleOne (scheduler.go:253) over a whole batch, wrapped in a
        slow-schedule trace (generic_scheduler.go:89-90's 100ms utiltrace).

        This is the SYNCHRONOUS round: device placement blocks before the
        host bookkeeping runs. run_until_drained/run_arrival use the
        pipelined drain (wave k+1's device time overlapping wave k's host
        phases) and fall back to this body per chunk when a batch needs the
        strict/oracle machinery."""
        trace = Trace("Scheduling round")
        self.sync()
        trace.step("informer sync done")
        pods = self.queue.pop_batch(max_n=max_batch, wait=wait)
        pop_ts = time.monotonic()  # NextPod-pop instant (scheduler.go:289)
        return self._process_batch(pods, pop_ts, trace)

    def _process_batch(self, pods: List[Pod], pop_ts: float,
                       trace: Optional[Trace] = None) -> Dict[str, int]:
        if trace is None:
            trace = Trace("Scheduling round")
        stats = {"popped": len(pods), "bound": 0, "unschedulable": 0,
                 "bind_errors": 0, "preemptions": 0}
        # gang (coscheduling) gating: pods in a group schedule atomically
        # once their quorum is in the queue (engine/gang.py); incomplete
        # gangs park in _gang_waiting until members arrive
        plain, gangs = gangmod.partition(pods)
        self._sweep_parked_gangs(gangs)
        if not pods:
            self._idle_gc()
            return stats
        trace.field("pods", len(pods))
        ready_gangs = self._gate_gangs(gangs, plain)
        t0 = time.monotonic()
        scheduled_count = len(plain) + sum(len(m) for _g, m, _q in
                                           ready_gangs)
        results = []
        # ready gangs place FIRST: their members were necessarily queued at
        # or before this round's plain pods, and placing plain first would
        # let a sustained plain stream starve contended gangs (each retry
        # seeing capacity already consumed)
        if ready_gangs:
            for gr in gangmod.schedule_gangs(self.engine, ready_gangs,
                                             mode=self.batch_mode):
                if gr.placed:
                    # quorum committed: the gang is past its atomicity
                    # point — later members/retries go solo
                    self._mark_gang_degraded(gr.name)
                    results.extend(PlacementResult(m, m.node_name, 1)
                                   for m in gr.placed_members)
                unschedulable = gr.unplaced_members
                stats["unschedulable"] += len(unschedulable)
                if unschedulable:
                    self.metrics.failed.inc(len(unschedulable))
                for m in unschedulable:
                    self._event(m, "Warning", "FailedScheduling",
                                f"gang {gr.name}: {gr.reason}")
                    self.queue.add_backoff(
                        dataclasses.replace(m, node_name=""))
        if plain:
            results.extend(self.engine.schedule(plain, assume=True,
                                                mode=self.batch_mode))
        t_alg = time.monotonic() - t0
        trace.step("batch placement computed (device)")
        placed = []
        unschedulable_pods = []
        record = self.record_events
        for r in results:
            if r.node_name is None:
                stats["unschedulable"] += 1
                self.metrics.failed.inc()
                if record:
                    self._event(
                        r.pod, "Warning", "FailedScheduling",
                        f"0/{len(self.engine.snapshot.node_names)} nodes "
                        f"available (fit_count={r.fit_count})")
                unschedulable_pods.append(r.pod)
                if self._requeue_unschedulable(r.pod):
                    stats["spilled"] = stats.get("spilled", 0) + 1
            else:
                placed.append(r)
        # one batched /binding pass (per-binding semantics identical to the
        # per-pod POST; scheduler.go:224-250 error paths preserved per pod)
        tb0 = time.monotonic()
        errs = self.api.bind_many(
            [Binding(r.pod.name, r.pod.namespace, r.pod.uid, r.node_name)
             for r in placed])
        bind_done = time.monotonic()
        t_bind = bind_done - tb0
        bound_pods, n_errors = self._finish_binds(
            [r.pod for r in placed], errs)
        if placed and RECORDER.enabled:
            RECORDER.record(flightrec.BIND_FLUSH, t0=tb0, dur=t_bind,
                            a=len(bound_pods), b=n_errors)
        stats["bind_errors"] += n_errors
        stats["bound"] += len(bound_pods)
        trace.step("bindings written")
        self.cache.finish_bindings_bulk(bound_pods)
        if unschedulable_pods and features.enabled("PodPriority"):
            # after the binding pass, so a victim choice can never race a
            # not-yet-posted Binding from this same round
            stats["preemptions"] = self._preempt_round(unschedulable_pods)
        n = len(bound_pods)
        self.metrics.scheduled.inc(n)
        # honest spans (not amortized t/n): every pod in the batch really
        # waited the FULL algorithm span and the FULL binding span — its
        # placement was not done until the round's was. e2e matches the
        # reference's pop->bind-complete window (scheduler.go:289)
        self.metrics.algorithm_latency.observe_many(t_alg, n)
        self.metrics.binding_latency.observe_many(t_bind, n)
        self.metrics.e2e_latency.observe_many(bind_done - pop_ts, n)
        # per-pod create->bound, queue wait + backoff rounds included:
        # distinct value per pod, the distribution the SLO check reads
        lats = [bind_done - self._first_queued.pop(p.key(), pop_ts)
                for p in bound_pods]
        self.metrics.create_to_bound.observe_batch(lats)
        if SLO.enabled and lats:
            # the SLO engine sees EVERY bound pod (not the tracer's
            # sampled subset) — burn-rate math over the full population
            SLO.observe_batch(lats, t=bind_done)
        if TRACER.enabled and bound_pods:
            TRACER.bound_batch([p.key() for p in bound_pods],
                               t0=bind_done)
        if self.wave_observer is not None and bound_pods:
            self.wave_observer(bind_done, [p.key() for p in bound_pods])
        self._idle_gc()
        # per-pod amortized threshold: a 30k-pod round is not "slow" the way
        # a 30k-pod-long one-pod trace would be; scale like the reference's
        # per-Schedule-call threshold
        trace.log_if_long(SCHEDULE_TRACE_THRESHOLD_S
                          * max(scheduled_count, 1))
        return stats

    def _gate_gangs(self, gangs: Dict[str, List[Pod]],
                    plain: List[Pod]) -> List[Tuple[str, List[Pod], int]]:
        """Quorum gating shared by the classic round and the pipelined
        drain: degraded gangs' members (quorum already bound —
        past the atomicity point) join the plain stream, below-quorum
        gangs park in _gang_waiting until members arrive, and gangs whose
        quorum is present are RELEASED from the parking lot and returned
        as (name, members, quorum) ready for atomic placement."""
        ready: List[Tuple[str, List[Pod], int]] = []
        for gname, members in gangs.items():
            if gname in self._gang_degraded:
                plain.extend(members)
                continue
            waiting = self._gang_waiting.setdefault(gname, {})
            if gname not in self._gang_parked_at:
                self._gang_parked_at[gname] = self._now()
            for m in members:
                waiting[m.key()] = m
            quorum = gangmod.min_available(list(waiting.values()))
            if len(waiting) >= quorum:
                ready.append((gname, list(waiting.values()), quorum))
                del self._gang_waiting[gname]
                self._gang_parked_at.pop(gname, None)
            elif TRACER.enabled:
                # parked below quorum: the wait shows on the timeline as
                # gang_wait instead of vanishing into queue time
                TRACER.batch_event(podtrace.GANG_GATED,
                                   [m.key() for m in members],
                                   a=len(waiting))
        return ready

    def _sweep_parked_gangs(self, gangs) -> None:
        """Parked-too-long gangs surface even on empty rounds — a gang below
        quorum with no new arrivals would otherwise never reach the sweep
        (quorum may never come: members deleted, minAvailable typo);
        members re-queue with backoff — retried AND visible via events.
        A gang receiving members THIS round (`gangs`) is exempt: the arrival
        may complete its quorum, and evicting it first would turn an on-time
        completion into a spurious backoff cycle."""
        if not self._gang_parked_at:
            return
        now = self._now()
        for gname in [g for g, t0_ in self._gang_parked_at.items()
                      if now - t0_ > self.GANG_WAIT_TIMEOUT_S
                      and g not in gangs]:
            waiting = self._gang_waiting.pop(gname, {})
            self._gang_parked_at.pop(gname, None)
            for m in waiting.values():
                self._event(m, "Warning", "FailedScheduling",
                            f"gang {gname} below quorum for "
                            f"{self.GANG_WAIT_TIMEOUT_S:.0f}s")
                self.queue.add_backoff(m)

    def _idle_gc(self) -> None:
        """Housekeeping (empty rounds + the streaming loop's wall-clock
        cadence): expire unconfirmed assumes, gc backoff stamps, compact
        node tombstones. An expiry mutates NodeInfos the scheduler cannot
        attribute to a node it tracked — force the next refresh to walk
        everything."""
        if self.cache.cleanup_assumed():
            self.engine.note_full_refresh()
        self.queue.backoff.gc()
        # amortized membership compaction: dead nodes tombstone
        # in place so churn never restructures the snapshot per event;
        # once enough podless tombstones accumulate, pay ONE full rebuild
        # to reclaim their rows. ONLY while the pipeline is idle: an
        # in-flight wave's fence/assume path maps row indices baked at
        # dispatch through the refreshed snapshot, and the whole point of
        # tombstoning is that node order never moves under it.
        if self._pipeline is not None and not self._pipeline.idle:
            return
        n_nodes = max(len(self.engine.snapshot.node_names), 8)
        if self.cache.purgeable_tombstones() > max(8, n_nodes // 8) \
                and self.cache.purge_tombstones():
            self.engine.note_full_refresh()

    def _preempt_round(self, unschedulable: List[Pod]) -> int:
        """Preemption pass (1.8 generic_scheduler.Preempt, feature-gated
        behind PodPriority like kube_features.go:122): for each
        unschedulable pod, highest priority first, pick a node + minimal
        victim set (engine/preemption.py) and evict the victims. The
        preemptor is already requeued; once the victims' DELETED events
        drain through sync(), the freed capacity places it in a following
        round (the nominate-then-reschedule flow)."""
        from kubernetes_tpu_torch.engine import preemption as preemptmod
        from kubernetes_tpu_torch.ops.oracle_ext import SchedulingContext
        # clones: the victim bookkeeping below must not mutate the live
        # cache (the DELETED watch events do that authoritatively)
        infos = self.cache.snapshot_infos()
        # full predicate context: without it the feasibility check would
        # ignore inter-pod affinity / volumes / policy algorithms and
        # evict victims that free nothing for the preemptor. Victims stay
        # in ctx.infos during the check — conservative: a node whose
        # feasibility depends on a victim's own anti-affinity going away
        # is skipped rather than over-evicted.
        ctx = SchedulingContext(
            infos, self.engine.workloads_provider(),
            hard_pod_affinity_weight=self.engine.hard_pod_affinity_weight,
            volume_ctx=self.engine.volume_ctx,
            policy_algos=self.engine.policy_algos)
        count = 0
        # lazy: a round whose unschedulable pods are all priority 0 (the
        # default) must not pay the O(total pods) array build
        state = None
        for pod in sorted(unschedulable, key=lambda p: -p.priority):
            if pod.priority <= 0:
                break  # sorted desc: nothing below can preempt either
            if state is None:
                state = preemptmod.PreemptionState(infos)
            plan = preemptmod.pick_preemption(pod, infos, ctx=ctx,
                                              state=state)
            if plan is None:
                continue
            if TRACER.enabled and plan.victims:
                TRACER.evicted_batch([v.key() for v in plan.victims])
            for vic in plan.victims:
                try:
                    self.api.delete("Pod", vic.namespace, vic.name)
                except NotFound:
                    pass
                self._event(vic, "Normal", "Preempted",
                            f"by {pod.key()} on node {plan.node_name}")
                # reflect the eviction in the local view immediately so a
                # second preemptor this round does not double-count the
                # same victims
                info = infos.get(plan.node_name)
                if info is not None:
                    info.remove_pod(vic)
            # reserve the freed capacity for THIS preemptor in the local
            # view (the 1.8 nominated-pod reservation): a second
            # preemptor this round must not plan into the same hole and
            # over-evict
            info = infos.get(plan.node_name)
            if info is not None:
                info.add_pod(pod)
            state.apply_plan(plan, pod)
            self._event(pod, "Normal", "TriggeredPreemption",
                        f"{len(plan.victims)} lower-priority pod(s) on "
                        f"{plan.node_name} evicted")
            count += 1
        return count

    # ------------------------------------------------------ pipelined drain

    def _wave_eligible(self, pods: List[Pod]) -> bool:
        """Cheap host-side gate before dispatch: with gang_pipeline off,
        gang-bearing chunks flush to the classic round (the A/B
        baseline). No chunk SHAPE is host-gated: required
        (anti-)affinity, gangs, host-check, and Policy classes all ride
        the wave path; the engine returns None only for the gang-quorum-
        unreachable corner, which the caller flushes per chunk."""
        if self.gang_pipeline:
            return True
        return all(gangmod.gang_name(p) is None for p in pods)

    def _release_gangs_for_wave(self, pods: List[Pod], stats: Dict[str, int]
                                ) -> Tuple[List[Pod], Optional[list]]:
        """Pipelined gang routing: partition a popped chunk,
        park/degrade/release through the shared quorum gate, reject
        provably-infeasible ready gangs host-side (capacity_precheck, the
        classic path's cheap gate), and return (chunk_pods, gang_spans)
        where gang_spans = [(name, member index range, quorum)] into
        chunk_pods. Ready gangs lead the chunk — their members were queued
        at or before this chunk's plain pods, and trailing them would let
        a sustained plain stream starve contended gangs."""
        plain, gangs = gangmod.partition(pods)
        self._sweep_parked_gangs(gangs)
        if not gangs:
            return plain, None
        ready = self._gate_gangs(gangs, plain)
        members_first: List[Pod] = []
        spans = []
        if ready:
            infos = self.cache.node_infos()
            for name, members, quorum in ready:
                if not gangmod.capacity_precheck(members, infos):
                    stats["unschedulable"] += len(members)
                    self.metrics.failed.inc(len(members))
                    for m in members:
                        self._event(m, "Warning", "FailedScheduling",
                                    f"gang {name}: "
                                    "InsufficientClusterCapacity")
                        self.queue.add_backoff(
                            dataclasses.replace(m, node_name=""))
                    continue
                start = len(members_first)
                members_first.extend(members)
                spans.append((name, list(range(start,
                                               start + len(members))),
                              quorum))
        return members_first + plain, spans or None

    def _bind_bulk(self, pods: List[Pod]) -> List[Optional[str]]:
        """One bulk binding write for already-placed pods. Prefers the
        store's identifier-reading fast path; any bind_many-only API
        implementation (the full authenticated apiserver, test doubles)
        gets the classic Binding batch instead."""
        bulk = getattr(self.api, "bind_pods_bulk", None)
        if bulk is not None:
            return bulk(pods)
        return self.api.bind_many(
            [Binding(p.name, p.namespace, p.uid, p.node_name)
             for p in pods])

    def _finish_binds(self, pods: List[Pod], errs) -> Tuple[List[Pod], int]:
        """The shared bind-result tail of BOTH drain paths (classic round
        and pipelined harvest): per-pod error rollback (ForgetPod + backoff
        requeue, scheduler.go:234-245) or Scheduled event. Returns
        (bound_pods, error_count)."""
        bound_pods: List[Pod] = []
        n_errors = 0
        record = self.record_events  # 30k f-strings nobody reads would
        # dominate this loop when event recording is off
        for pod, err in zip(pods, errs):
            if err is not None:
                # undo the optimistic assume
                n_errors += 1
                self.cache.forget_pod(pod)
                self.engine.note_node_dirty(pod.node_name)
                self._event(pod, "Warning", "FailedBinding", err)
                self.queue.add_backoff(
                    dataclasses.replace(pod, node_name=""))
                continue
            bound_pods.append(pod)
            if record:
                self._event(pod, "Normal", "Scheduled",
                            f"Successfully assigned {pod.key()} "
                            f"to {pod.node_name}")
        return bound_pods, n_errors

    def _complete_wave(self, handle) -> Dict[str, int]:
        """Host-side completion of one harvested wave: fence conflicts
        requeue WITHOUT backoff (a capacity race with the blind wave, not
        unschedulability), survivors bind in one bulk write, bookkeeping is
        columnar. This is the work wave k+1's device time hides."""
        res = self.engine.harvest_waves(handle)
        out = {"popped": 0, "bound": 0, "bind_errors": 0, "preemptions": 0,
               "preempt_rollbacks": 0, "victims_evicted": 0,
               "budget_deferred": 0,
               "unschedulable": len(res.unschedulable),
               "fence_requeued": len(res.conflicts),
               "gang_requeued": len(res.gang_requeued),
               "liveness_requeued": len(res.liveness_requeued)}
        record = self.record_events
        for pod in res.liveness_requeued:
            # the target node died/cordoned mid-flight: requeue
            # WITH backoff — the topology is not coming back on a
            # capacity-race timescale
            if record:
                self._event(pod, "Warning", "FailedScheduling",
                            f"node {pod.node_name or '?'} no longer live "
                            "at the wave fence")
            self.queue.add_backoff(dataclasses.replace(pod, node_name=""))
        for name in res.gang_committed:
            # quorum committed through the wave fence: the gang is past
            # its atomicity point — later members/retries go solo
            self._mark_gang_degraded(name)
            # a straggler that popped while this wave was in flight was
            # gated BEFORE the commit landed, so it parked below quorum;
            # release it to schedule solo now instead of waiting out the
            # 60s parked-gang sweep (the classic round marks degraded
            # synchronously and never hits this window)
            waiting = self._gang_waiting.pop(name, None)
            self._gang_parked_at.pop(name, None)
            if waiting:
                for m in waiting.values():
                    self.queue.add(m)
        for pod, reason in res.gang_requeued:
            # atomic gang rollback (nothing was assumed): requeue WITH
            # backoff — the gang lost as a unit, like the classic round's
            # below-quorum path; a retry re-waves it against fresh state
            if record:
                self._event(pod, "Warning", "FailedScheduling", reason)
            self.queue.add_backoff(pod)
        for pod in res.conflicts:
            self.queue.add(pod)  # node_name never set on a fenced pod
        preemptors = None
        if res.unschedulable:
            self.metrics.failed.inc(len(res.unschedulable))
            spilled_keys = set()
            for pod, fcnt in res.unschedulable:
                if record:
                    self._event(
                        pod, "Warning", "FailedScheduling",
                        f"0/{len(self.engine.snapshot.node_names)} nodes "
                        f"available (fit_count={fcnt})")
                if self._requeue_unschedulable(pod):
                    out["spilled"] = out.get("spilled", 0) + 1
                    spilled_keys.add(pod.key())
            # wave-path preemption: the harvest's unschedulable
            # preemptors displace lower bands WITHOUT flushing the
            # pipeline — planned below, AFTER this wave's binding pass,
            # so a victim choice can never race a not-yet-posted bind
            # (the classic round's ordering, kept). A spilled pod is
            # LEAVING this cell — it must not displace victims here while
            # the router re-admits it elsewhere.
            if self.wave_preemption and features.enabled("PodPriority"):
                preemptors = [p for p, _f in res.unschedulable
                              if p.key() not in spilled_keys]
                if not any(p.priority > 0 for p in preemptors):
                    preemptors = None
        if not res.bound:
            if preemptors:
                for k, v in self._preempt_wave(preemptors,
                                               handle.wave_id).items():
                    out[k] = out.get(k, 0) + v
            return out
        tb0 = time.monotonic()
        errs = self._bind_bulk(res.bound)
        t_bind = time.monotonic() - tb0
        bound_pods, n_errors = self._finish_binds(res.bound, errs)
        out["bind_errors"] += n_errors
        bind_done = time.monotonic()
        if RECORDER.enabled:
            RECORDER.record(flightrec.BIND_FLUSH, wave=handle.wave_id,
                            t0=tb0, dur=t_bind, a=len(bound_pods),
                            b=n_errors)
        keys = [p.key() for p in bound_pods]  # computed once, shared by the
        # TTL pass and the latency harvest below
        self.cache.finish_bindings_bulk(bound_pods, keys=keys)
        n = len(bound_pods)
        out["bound"] = n
        self.metrics.scheduled.inc(n)
        # honest per-wave spans: algorithm = the residual device wait this
        # wave's overlap did NOT hide; e2e = pop -> bind-complete including
        # the one-wave pipeline lag every pod in the chunk really waited
        self.metrics.algorithm_latency.observe_many(res.t_block, n)
        self.metrics.binding_latency.observe_many(t_bind, n)
        self.metrics.e2e_latency.observe_many(bind_done - handle.pop_ts, n)
        fq_pop = self._first_queued.pop
        pop_ts = handle.pop_ts
        lats = [bind_done - fq_pop(k, pop_ts) for k in keys]
        self.metrics.create_to_bound.observe_batch(lats)
        if SLO.enabled:
            SLO.observe_batch(lats, t=bind_done)
        if TRACER.enabled:
            TRACER.bound_batch(keys, t0=bind_done)
        if self.wave_observer is not None:
            self.wave_observer(bind_done, keys)
        if preemptors:
            for k, v in self._preempt_wave(preemptors,
                                           handle.wave_id).items():
                out[k] = out.get(k, 0) + v
        return out

    def _preempt_wave(self, preemptors: List[Pod],
                      wave_id: int = -1) -> Dict[str, int]:
        """One wave-path preemption round: plan displacements
        for this harvest's unschedulable preemptors (device victim scan +
        exact verification, engine/preempt_wave.py), rate-limit them
        through the disruption budget, and COMMIT each survivor through
        the store's atomic evict+bind:

        - success: victims leave the cache immediately (their watch
          MODIFIED-unbound events re-enter them as ordinary arrivals the
          streaming loop absorbs), the preemptor assumes + finishes
          binding exactly like a fenced wave placement — either EVERY
          victim eviction landed AND the preemptor bound, or nothing did;
        - error: rollback — the preemptor stays on the backoff requeue
          _complete_wave already gave it, local state untouched. If the
          error hid a landed commit (the at-most-once ambiguity the
          injected eviction TIMEOUT reproduces), the watch stream heals:
          sync() runs before every pop, so the preemptor's confirmation
          removes it from the queue before any retry could double-bind.

        Victims are restricted to store-confirmed bound pods (an assumed
        claim is unbound at the store; planning it would abort commits)."""
        from kubernetes_tpu_torch.utils.trace import COUNTERS

        out = {"preemptions": 0, "preempt_rollbacks": 0,
               "victims_evicted": 0, "budget_deferred": 0}
        api_op = getattr(self.api, "preempt_pods_bulk", None)
        if api_op is None:
            return out  # store cannot commit atomically: no wave path
        t_plan = time.monotonic()
        pods_map = self._pods

        def _evictable(p: Pod) -> bool:
            q = pods_map.get(p.key())
            return q is not None and bool(q.node_name)

        plans = plan_wave_preemptions(
            self.engine, preemptors, evictable=_evictable,
            workloads=self.engine.workloads_provider())
        if RECORDER.enabled:
            RECORDER.record(flightrec.PREEMPT_PROPOSE, wave=wave_id,
                            t0=t_plan, dur=time.monotonic() - t_plan,
                            a=len(preemptors), b=len(plans))
        if not plans:
            return out
        budget = self.disruption_budget
        band_counts = self.engine.snapshot.band_bound_counts() \
            if budget.band_floor else None
        record = self.record_events
        snap_index = self.engine.snapshot.node_index
        for plan in plans:
            pod = plan.pod
            if not budget.admit(plan.victims, band_counts):
                out["budget_deferred"] += 1
                COUNTERS.inc("engine.preempt_budget_deferred")
                if record:
                    self._event(pod, "Normal", "PreemptionDeferred",
                                "disruption budget exhausted")
                continue
            err = api_op(plan.victims,
                         Binding(pod.name, pod.namespace, pod.uid,
                                 plan.node_name))
            if err is not None:
                out["preempt_rollbacks"] += 1
                COUNTERS.inc("engine.preempt_rollbacks")
                if record:
                    self._event(pod, "Warning", "FailedPreemption", err)
                if RECORDER.enabled:
                    RECORDER.record(flightrec.PREEMPT_ROLLBACK,
                                    wave=wave_id, a=len(plan.victims),
                                    b=int("landed" in err))
                continue
            bind_done = time.monotonic()
            key = pod.key()
            # victims leave the cache NOW — the store op landed, and
            # phantom occupancy would hide the freed hole from the next
            # wave; the watch handlers re-apply both sides idempotently
            for vic in plan.victims:
                self.cache.remove_pod(vic)
                if record:
                    self._event(vic, "Normal", "Preempted",
                                f"by {key} on node {plan.node_name}")
            if TRACER.enabled:
                TRACER.evicted_batch([v.key() for v in plan.victims],
                                     t0=bind_done)
            self.queue.remove(key)  # it was backoff-requeued above
            pod.node_name = plan.node_name
            self.cache.assume_pod(pod)
            self.cache.finish_binding(pod)
            self.engine.note_node_dirty(plan.node_name)
            self.metrics.scheduled.inc(1)
            lat = bind_done - self._first_queued.pop(key, t_plan)
            self.metrics.create_to_bound.observe_batch([lat])
            if SLO.enabled:
                SLO.observe_batch([lat], t=bind_done)
            if TRACER.enabled:
                TRACER.bound_batch([key], t0=bind_done)
            if self.wave_observer is not None:
                self.wave_observer(bind_done, [key])
            out["preemptions"] += 1
            out["victims_evicted"] += len(plan.victims)
            COUNTERS.inc("engine.preempt_commits")
            COUNTERS.inc("engine.victims_evicted", len(plan.victims))
            if record:
                self._event(pod, "Normal", "TriggeredPreemption",
                            f"{len(plan.victims)} lower-priority pod(s) "
                            f"on {plan.node_name} evicted")
            if self.preempt_observer is not None:
                self.preempt_observer(bind_done, bind_done - t_plan,
                                      len(plan.victims))
            if RECORDER.enabled:
                RECORDER.record(flightrec.PREEMPT_COMMIT, wave=wave_id,
                                t0=t_plan, dur=bind_done - t_plan,
                                a=len(plan.victims),
                                b=snap_index.get(plan.node_name, -1))
                RECORDER.record(flightrec.VICTIM_REQUEUE, wave=wave_id,
                                a=len(plan.victims),
                                b=min(v.priority for v in plan.victims))
            if band_counts is not None:
                for v in plan.victims:
                    band_counts[v.priority] = \
                        band_counts.get(v.priority, 1) - 1
        return out

    def pipeline(self, chunk: int = 0, overlap: bool = True):
        """A live two-stage drain pipeline: the FIXED-chunk mode
        of the scheduling loop. step() pops one chunk, dispatches its fused
        wave eval WITHOUT blocking, then harvests the PREVIOUS chunk — so
        wave k+1's device time overlaps wave k's host bookkeeping.
        overlap=False is the sequential debug mode: identical dataflow
        (same blind window, same fence), device forced to complete before
        the host tail — placements are bit-identical, only the wall-clock
        overlap is forfeited."""
        return ScheduleLoop(self, chunk or self.pipeline_chunk, overlap)

    def _requeue_unschedulable(self, pod) -> bool:
        """Backoff-requeue an unschedulable pod — or SPILL it to the
        federation hook once its verdict count crosses the threshold.
        Returns True when the pod was spilled (it left this cell: no
        requeue, latency stamp cleared). With no spill_handler the
        attempt ledger is never touched — single-cell behavior stays
        bit-identical."""
        h = self.spill_handler
        if h is not None:
            key = pod.key()
            n = self._unsched_attempts.get(key, 0) + 1
            if n >= self.spill_after_attempts:
                self._unsched_attempts.pop(key, None)
                self._first_queued.pop(key, None)
                h([pod])
                return True
            self._unsched_attempts[key] = n
        self.queue.add_backoff(pod)
        return False

    def stream(self, budget_s: float = 0.25, min_quantum: int = 256,
               max_quantum: int = 16384, overlap: bool = True,
               chunk: int = 0, fastlane=False):
        """The ALWAYS-ON loop: micro-waves admitted on a latency
        budget instead of fixed chunks — pop whatever is queued when the
        device frees up, bounded by an adaptive power-of-2 quantum so one
        admission can never make the next arrival wait past ``budget_s``.
        Same dataflow and fence as pipeline(); only the admission policy
        differs (engine/streaming.py docstring). ``chunk`` seeds the
        initial quantum when given.

        ``fastlane=True`` arms the Sparrow fast tier:
        latency-critical pods bypass the micro-wave quantum through a
        sampled [1, k] eval + late-bind fence (engine/fastlane.py). Pass
        a FastLane instance instead of True to control k/retries/seed."""
        fl = None
        if fastlane:
            from kubernetes_tpu_torch.engine.fastlane import FastLane
            fl = fastlane if not isinstance(fastlane, bool) \
                else FastLane(self)
        return ScheduleLoop(self, chunk, overlap, budget_s=budget_s,
                            min_quantum=min_quantum,
                            max_quantum=max_quantum, fastlane=fl)

    def run_until_drained(self, max_rounds: int = 10_000,
                          max_batch: int = 0,
                          pipeline: Optional[bool] = None,
                          overlap: bool = True) -> Dict[str, int]:
        """Bench helper: rounds until queue is empty and no watch events.

        pipeline=None auto-selects: wave mode without PodPriority drains
        through the two-stage pipeline (chunked, overlapped); strict mode
        and priority scheduling keep the classic synchronous rounds, and
        any chunk the engine cannot wave-place falls back per chunk."""
        total = {"popped": 0, "bound": 0, "unschedulable": 0,
                 "bind_errors": 0, "preemptions": 0, "fence_requeued": 0,
                 "gang_requeued": 0, "liveness_requeued": 0}
        if pipeline is None:
            pipeline = (self.batch_mode == "wave"
                        and not features.enabled("PodPriority"))
        if not pipeline:
            for _ in range(max_rounds):
                stats = self.schedule_round(max_batch=max_batch)
                for k in stats:
                    total[k] = total.get(k, 0) + stats[k]
                if stats["popped"] == 0 and self.sync() == 0 \
                        and self.queue.ready_count() == 0:
                    break
            return total
        # chunk sizing: enough waves for the overlap to hide device time,
        # few enough that per-wave fixed costs (refresh, encode reuse,
        # group assume) stay amortized — a pre-loaded 30k queue drains as
        # two double-buffered waves (measured optimum on the CPU box;
        # PROFILE_r07.md)
        ready = self.queue.ready_count()
        chunk = max_batch or max(self.pipeline_chunk, -(-ready // 2))
        pipe = self.pipeline(chunk=chunk, overlap=overlap)
        try:
            for _ in range(max_rounds):
                stats = pipe.step()
                for k in stats:
                    total[k] = total.get(k, 0) + stats[k]
                if stats["popped"] == 0 and pipe.idle \
                        and self.sync() == 0 \
                        and self.queue.ready_count() == 0:
                    break
        finally:
            for k, v in pipe.close().items():
                total[k] = total.get(k, 0) + v
        return total

    # ------------------------------------------------------------- handlers

    _GANG_DEGRADED_MAX = 10_000
    GANG_WAIT_TIMEOUT_S = 60.0  # parked-below-quorum visibility timeout

    def _mark_gang_degraded(self, name: str) -> None:
        # re-marking refreshes recency so an active gang's entry is never
        # the one evicted
        self._gang_degraded.pop(name, None)
        self._gang_degraded[name] = None
        while len(self._gang_degraded) > self._GANG_DEGRADED_MAX:
            self._gang_degraded.pop(next(iter(self._gang_degraded)))

    def _responsible_for(self, pod: Pod) -> bool:
        return (pod.scheduler_name or DEFAULT_SCHEDULER_NAME) == self.scheduler_name

    def _on_volume_event(self, kind: str, etype: str, obj) -> None:
        """PV/PVC informer handlers (factory.go:120-140 wires both; events
        invalidate the equivalence cache there — here they bump the
        VolumeContext version so the snapshot re-resolves PD rows)."""
        vctx = self.engine.volume_ctx
        if kind == "PersistentVolume":
            if etype == "DELETED":
                vctx.pvs.pop(obj.name, None)
            else:
                vctx.pvs[obj.name] = obj
        else:
            key = (obj.namespace, obj.name)
            if etype == "DELETED":
                vctx.pvcs.pop(key, None)
            else:
                vctx.pvcs[key] = obj
        vctx.version += 1

    def _on_node_event(self, etype: str, node: Node) -> None:
        # membership or spec moved: the targeted-refresh hint cannot name
        # what changed (vocab interning, node order) — next refresh walks all
        self.engine.note_full_refresh()
        if etype == "DELETED":
            # assumed pods on the dead node are forgotten by the cache
            # (audit: their optimistic capacity claim pointed at a
            # node that no longer exists). Any that the apiserver still
            # shows UNBOUND requeue with backoff — the assume raced the
            # node's death and the bind never landed; already-bound ones
            # are ghost orphans for node lifecycle to evict, not ours to
            # double-bind.
            for pod in self.cache.remove_node(node.name):
                key = pod.key()
                prev = self._pods.get(key)
                if prev is not None and not prev.node_name:
                    self._event(pod, "Warning", "FailedScheduling",
                                f"assumed node {node.name} deleted "
                                "before bind")
                    self._first_queued.setdefault(key, time.monotonic())
                    self.queue.add_backoff(
                        dataclasses.replace(pod, node_name=""))
        else:
            self.cache.update_node(node)

    def _on_pod_event(self, etype: str, pod: Pod) -> None:
        key = pod.key()
        prev = self._pods.get(key)
        # any event invalidates a parked gang copy: the pod either left
        # (DELETED/bound) or changed spec — it re-enters via the queue and
        # re-partitions fresh, never schedules from a stale parked object
        for waiting in self._gang_waiting.values():
            waiting.pop(key, None)
        if etype == "DELETED":
            self._pods.pop(key, None)
            self._first_queued.pop(key, None)
            self.queue.remove(key)
            if prev is not None and prev.node_name:
                self.cache.remove_pod(prev)
                self.engine.note_node_dirty(prev.node_name)
            return
        self._pods[key] = pod
        if etype == "ADDED":
            if pod.node_name:
                self.cache.add_pod(pod)
                self.engine.note_node_dirty(pod.node_name)
            elif self._responsible_for(pod):
                self._first_queued.setdefault(key, time.monotonic())
                self.queue.add(_queue_copy(pod))
            return
        # MODIFIED
        was_bound = prev is not None and bool(prev.node_name)
        if not was_bound and pod.node_name:
            self.queue.remove(key)
            self._first_queued.pop(key, None)  # bound (possibly by a
            # foreign scheduler); our own binds already harvested it
            self.cache.add_pod(pod)  # confirms our assume, or records a
            # foreign scheduler's bind (cache.go:214)
            self.engine.note_node_dirty(pod.node_name)
        elif was_bound and pod.node_name:
            self.cache.update_pod(prev, pod)
            self.engine.note_node_dirty(prev.node_name, pod.node_name)
        elif was_bound and not pod.node_name:
            self.cache.remove_pod(prev)
            self.engine.note_node_dirty(prev.node_name)
            if self._responsible_for(pod):
                self._first_queued.setdefault(key, time.monotonic())
                self.queue.add(_queue_copy(pod))
        else:
            self.queue.remove(key)
            if self._responsible_for(pod):
                self._first_queued.setdefault(key, time.monotonic())
                self.queue.add(_queue_copy(pod))

    def _relist(self) -> None:
        """Watch fell behind the event log — rebuild everything from a fresh
        List, like a reflector restart. Assumed pods still pending
        confirmation are preserved by re-adding only confirmed state."""
        self.cache = SchedulerCache(ttl_seconds=self.cache._ttl, now=self._now)
        self._workloads = {}
        pad_floor = self.engine.wave_pad_floor  # a live pipeline's
        # padded-shape pin must survive the engine swap
        self.engine.close()
        self.engine = SchedulingEngine(
            self.cache, priorities=self.engine.priorities,
            device=self.device,
            workloads_provider=lambda: list(self._workloads.values()),
            policy_algos=self._policy_algos, mesh=self.engine.mesh)
        self.engine.track_dirty = True
        self.engine.wave_pad_floor = pad_floor
        self.queue = SchedulingQueue(now=self._now)
        self._pods = {}
        self._gang_waiting = {}
        self._gang_degraded = {}
        self._gang_parked_at = {}
        self._started = False
        self.start()
        # prune create->bound stamps for pods that bound or vanished
        # during the watch blackout (their terminal event is exactly what
        # the log compaction lost) — a stale stamp would otherwise inflate
        # a later reschedule's sample, or leak forever
        self._first_queued = {
            k: t for k, t in self._first_queued.items()
            if k in self._pods and not self._pods[k].node_name}

    def _event(self, pod: Pod, etype: str, reason: str, message: str) -> None:
        if not self.record_events:
            return
        self.events.append(Event(pod.key(), reason, message, etype))


# The two-stage pipeline body now lives in engine/streaming.py as the
# fixed-chunk mode of the always-on ScheduleLoop; the old name
# stays importable for callers that grew around the drain-shaped API.
_DrainPipeline = ScheduleLoop
