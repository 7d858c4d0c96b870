"""Seeded churn / fault-injection harness for the always-on engine.

A throughput headline measured on a QUIET cluster says little on its
own. The reference system's whole design is level-triggered
reconciliation under exactly the conditions such a number never saw
(SURVEY §5.3/§5.4): nodes die and flap mid-storm, pods are
evicted, labels mutate under rolling updates, and the bind API fails or
times out. This module makes those conditions a deterministic, seeded,
replayable input so the streaming loop's robustness claims are MEASURED:

- ``FaultyBindApi`` wraps an ApiServerLite and injects bind faults at
  seeded per-binding rates. Two fault shapes, because they heal
  differently: a FAILURE returns an error and the write never lands
  (the scheduler forgets + requeues — the clean retry); a TIMEOUT
  returns an error but the write DID land — the at-most-once ambiguity
  every RPC client lives with. The scheduler forgets + requeues, the
  retry's bind is refused by the store ("already assigned"), and the
  watch confirmation heals the cache — exactly-once holds at the store,
  which is the invariant tests/test_chaos.py audits end to end.

- ``make_churn_schedule`` compiles a ChurnConfig into a frozen,
  seed-deterministic list of timed operations (node kills + respawns,
  NotReady flaps, cordon/uncordon, zone relabels, evictions, rolling
  updates). The SAME schedule object can drive a wall-clock thread
  (bench.py's churn scenario) or be applied at step boundaries (the
  frozen churn-trace A/B in tests) — determinism is the point: a churn
  bug reproduces from (seed, config), not from a lucky race.

- ``ChurnInjector`` applies a schedule against a live apiserver and
  counts what it did, so the bench JSON reports the offered fault load
  next to the sustained throughput it was absorbed under.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.types import ConditionStatus, Node, NodeCondition
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, NotFound

ZONES = ["zone-a", "zone-b", "zone-c"]


# ---------------------------------------------------------------- bind faults


class FaultyBindApi:
    """ApiServerLite proxy injecting seeded bind faults on the BULK paths
    (the only bind paths the scheduler uses — engine/scheduler._bind_bulk
    prefers bind_pods_bulk and falls back to bind_many; both are wrapped,
    so injected faults exercise the backoff requeue on the streaming AND
    classic rounds). Reads delegate untouched.

    fail_rate:    probability a binding errors WITHOUT landing.
    timeout_rate: probability a binding errors but DID land (the
                  at-most-once ambiguity: the caller cannot distinguish a
                  lost request from a lost response).

    The VICTIM-DELETE seam: ``preempt_pods_bulk`` — the
    store's atomic evict+bind — gets the same two fault shapes, drawn
    PER VICTIM: any victim drawing a FAILURE aborts the whole commit
    with nothing landed (the store op is all-or-nothing, so a per-victim
    wire fault manifests as the batch erroring before application); any
    drawing a TIMEOUT lets the whole commit land and then loses the
    response — the scheduler must treat it as rolled back while the
    watch stream heals the divergence. Both shapes preserve zero
    partial preemptions by construction.

    evict_fail_rate:    per-victim probability the preempt commit errors
                        WITHOUT landing.
    evict_timeout_rate: per-victim probability the preempt commit LANDS
                        (evictions AND the bind) but errors anyway.
    """

    def __init__(self, api: ApiServerLite, fail_rate: float = 0.0,
                 timeout_rate: float = 0.0, seed: int = 0,
                 evict_fail_rate: float = 0.0,
                 evict_timeout_rate: float = 0.0):
        self._api = api
        self._rng = random.Random(seed)
        self.fail_rate = fail_rate
        self.timeout_rate = timeout_rate
        self.evict_fail_rate = evict_fail_rate
        self.evict_timeout_rate = evict_timeout_rate
        self.injected_failures = 0
        self.injected_timeouts = 0
        self.injected_evict_failures = 0
        self.injected_evict_timeouts = 0

    def __getattr__(self, name):
        return getattr(self._api, name)

    def _bind_with_faults(self, items, inner_bind) -> List[Optional[str]]:
        """Shared fault body: draw per-binding faults, delegate everything
        except pure failures to ``inner_bind`` as ONE batch (timeouts
        included — the write LANDS, only the response is lost), then
        stitch results back in order, injected errors winning."""
        out: List[Optional[str]] = [None] * len(items)
        apply_idx: List[int] = []
        for i in range(len(items)):
            r = self._rng.random()
            if r < self.fail_rate:
                out[i] = "injected: bind unavailable"
                self.injected_failures += 1
            elif r < self.fail_rate + self.timeout_rate:
                out[i] = "injected: bind timeout"
                self.injected_timeouts += 1
                apply_idx.append(i)
            else:
                apply_idx.append(i)
        if apply_idx:
            real = inner_bind([items[i] for i in apply_idx])
            for i, err in zip(apply_idx, real):
                if out[i] is None:  # keep the injected-timeout error
                    out[i] = err
        return out

    def bind_pods_bulk(self, pods) -> List[Optional[str]]:
        return self._bind_with_faults(pods, self._api.bind_pods_bulk)

    def bind_many(self, bindings) -> List[Optional[str]]:
        return self._bind_with_faults(bindings, self._api.bind_many)

    def preempt_pods_bulk(self, victims, binding) -> Optional[str]:
        """Atomic evict+bind with per-victim fault draws (class
        docstring): FAILURE wins over TIMEOUT, either yields ONE error
        for the whole commit — failure before the store op (nothing
        lands), timeout after it (everything lands, response lost)."""
        fail = timeout = False
        for _ in range(max(len(victims), 1)):
            r = self._rng.random()
            if r < self.evict_fail_rate:
                fail = True
            elif r < self.evict_fail_rate + self.evict_timeout_rate:
                timeout = True
        if fail:
            self.injected_evict_failures += 1
            return "injected: evict unavailable"
        err = self._api.preempt_pods_bulk(victims, binding)
        if err is None and timeout:
            self.injected_evict_timeouts += 1
            return "injected: evict timeout (landed)"
        return err


def extender_store_binder(api):
    """Adapt an ApiServerLite (or a FaultyBindApi proxy around one) into
    the extender backend's ``binder`` callable: the multi-
    frontend bench/tests bind through the REAL store so exactly-once is
    audited against store truth, with FaultyBindApi injecting the same
    failure/timeout shapes the streaming loop is hardened against.

    Store-level idempotence: a bind refused with "already assigned to
    node <same node>" heals to SUCCESS — that is precisely the landed-
    timeout replay (the write survived, only the response was lost), and
    treating it as an error would make the BindLedger's convergent replay
    impossible. "already assigned" to a DIFFERENT node stays an error
    (the caller is trying to double-book; the store's refusal IS the
    exactly-once guarantee)."""
    from kubernetes_tpu_torch.api.types import Pod

    def _bind(pod_name: str, pod_namespace: str, pod_uid: str,
              node: str) -> None:
        stub = Pod(name=pod_name, namespace=pod_namespace, uid=pod_uid)
        stub.node_name = node
        err = api.bind_pods_bulk([stub])[0]
        if err and f"already assigned to node {node}" in err:
            return  # landed-timeout replay: idempotent success
        if err:
            raise RuntimeError(err)

    return _bind


# ------------------------------------------------------------------ schedule


@dataclass(frozen=True)
class ChurnOp:
    t: float          # due instant, seconds from schedule start
    kind: str         # kill | respawn | flap_down | flap_up | cordon |
    #                   uncordon | relabel | evict
    node: str = ""
    zone: str = ""    # relabel target
    evict_slot: int = 0  # seeded pick among currently-bound pods


@dataclass
class ChurnConfig:
    """Production-shaped fault rates (all per minute, fractions of the
    node count where applicable). Defaults follow the ROADMAP acceptance
    shape: sustained 10%/min node churn plus flaps/evictions/relabels."""

    seed: int = 0
    node_churn_per_min: float = 0.10   # fraction of nodes killed/min
    respawn_s: float = 2.0             # dead node returns after this
    flap_per_min: float = 0.05         # fraction of nodes NotReady-flapped
    flap_down_s: float = 1.0
    cordon_per_min: float = 0.02
    cordon_s: float = 1.5
    relabel_per_min: float = 0.05      # zone-label mutations (rolling-
    #                                    update-shaped topology drift)
    evict_per_min_abs: float = 60.0    # absolute evictions per minute
    bind_fail_rate: float = 0.0
    bind_timeout_rate: float = 0.0


def make_churn_schedule(node_names: List[str], cfg: ChurnConfig,
                        duration_s: float) -> List[ChurnOp]:
    """Compile a config into a frozen op list, sorted by due time.
    Deterministic in (node_names, cfg, duration_s) — the replayable churn
    trace both the bench thread and the A/B tests consume. Kill targets
    are drawn without replacement per overlapping window so a node is
    never killed while already dead."""
    rng = random.Random(cfg.seed)
    ops: List[ChurnOp] = []
    n = len(node_names)
    minutes = duration_s / 60.0

    def uniform_times(count: float) -> List[float]:
        c = int(count)
        if rng.random() < count - c:
            c += 1
        return sorted(rng.uniform(0.0, duration_s) for _ in range(c))

    # node kills + respawns: draw targets without replacement among nodes
    # not currently dead at the kill instant
    dead_until: Dict[str, float] = {}
    for t in uniform_times(cfg.node_churn_per_min * n * minutes):
        alive = [nm for nm in node_names if dead_until.get(nm, -1.0) < t]
        if not alive:
            continue
        nm = alive[rng.randrange(len(alive))]
        dead_until[nm] = t + cfg.respawn_s
        ops.append(ChurnOp(t, "kill", node=nm))
        ops.append(ChurnOp(t + cfg.respawn_s, "respawn", node=nm))
    for t in uniform_times(cfg.flap_per_min * n * minutes):
        nm = node_names[rng.randrange(n)]
        ops.append(ChurnOp(t, "flap_down", node=nm))
        ops.append(ChurnOp(t + cfg.flap_down_s, "flap_up", node=nm))
    for t in uniform_times(cfg.cordon_per_min * n * minutes):
        nm = node_names[rng.randrange(n)]
        ops.append(ChurnOp(t, "cordon", node=nm))
        ops.append(ChurnOp(t + cfg.cordon_s, "uncordon", node=nm))
    for t in uniform_times(cfg.relabel_per_min * n * minutes):
        nm = node_names[rng.randrange(n)]
        ops.append(ChurnOp(t, "relabel", node=nm,
                           zone=ZONES[rng.randrange(len(ZONES))]))
    for t in uniform_times(cfg.evict_per_min_abs * minutes):
        ops.append(ChurnOp(t, "evict", evict_slot=rng.randrange(1 << 30)))
    ops.sort(key=lambda op: (op.t, op.kind, op.node))
    return ops


# ------------------------------------------------------------------ injector


class ChurnInjector:
    """Applies a frozen schedule against a live apiserver. Call
    ``apply_until(t)`` from the owner's clock (a wall-clock thread in the
    bench, a step counter in tests) — ops are consumed in order, each
    applied exactly once. Idempotent against the cluster's own drift: a
    kill of an already-gone node or an eviction with nothing bound is
    counted as a no-op, not an error."""

    def __init__(self, api: ApiServerLite, schedule: List[ChurnOp]):
        self.api = api
        self.schedule = schedule
        self._next = 0
        self._spec: Dict[str, Node] = {}  # last-seen spec for respawn
        self.applied: Dict[str, int] = {}
        self.noop = 0

    def done(self) -> bool:
        return self._next >= len(self.schedule)

    def apply_until(self, t: float) -> int:
        applied = 0
        while self._next < len(self.schedule) \
                and self.schedule[self._next].t <= t:
            self._apply(self.schedule[self._next])
            self._next += 1
            applied += 1
        return applied

    def _get_node(self, name: str) -> Optional[Node]:
        try:
            return self.api.get("Node", "", name)
        except NotFound:
            return None

    def _count(self, op: ChurnOp) -> None:
        self.applied[op.kind] = self.applied.get(op.kind, 0) + 1
        from kubernetes_tpu_torch.observability.recorder import (
            CHURN_OP,
            CHURN_OP_CODES,
            RECORDER,
        )
        if RECORDER.enabled:
            # flight-recorder marker: the fault lands on the
            # same time axis as the waves it perturbed
            RECORDER.record(CHURN_OP, a=CHURN_OP_CODES.get(op.kind, -1),
                            b=1)

    def _apply(self, op: ChurnOp) -> None:
        api = self.api
        if op.kind == "kill":
            node = self._get_node(op.node)
            if node is None:
                self.noop += 1
                return
            self._spec[op.node] = node
            try:
                api.delete("Node", "", op.node)
            except NotFound:
                self.noop += 1
                return
        elif op.kind == "respawn":
            spec = self._spec.get(op.node)
            if spec is None or self._get_node(op.node) is not None:
                self.noop += 1
                return
            api.create("Node", dataclasses.replace(
                spec, labels=dict(spec.labels),
                conditions=[dataclasses.replace(c) for c in spec.conditions],
                resource_version=0))
        elif op.kind in ("flap_down", "flap_up", "cordon", "uncordon",
                         "relabel"):
            node = self._get_node(op.node)
            if node is None:
                self.noop += 1
                return
            conditions = [dataclasses.replace(c) for c in node.conditions]
            if op.kind in ("flap_down", "flap_up"):
                status = ConditionStatus.FALSE if op.kind == "flap_down" \
                    else ConditionStatus.TRUE
                for c in conditions:
                    if c.type == "Ready":
                        c.status = status
                        break
                else:
                    conditions.append(NodeCondition("Ready", status))
            labels = dict(node.labels)
            if op.kind == "relabel":
                labels["failure-domain.beta.kubernetes.io/zone"] = op.zone
            api.update("Node", dataclasses.replace(
                node, labels=labels, conditions=conditions,
                unschedulable=(op.kind == "cordon"
                               if op.kind in ("cordon", "uncordon")
                               else node.unschedulable)))
        elif op.kind == "evict":
            bound = [p for p in api.list("Pod")[0] if p.node_name]
            if not bound:
                self.noop += 1
                return
            victim = bound[op.evict_slot % len(bound)]
            try:
                api.delete("Pod", victim.namespace, victim.name)
            except NotFound:
                self.noop += 1
                return
        self._count(op)

    # ------------------------------------------------------------- thread

    def run_thread(self, stop: threading.Event,
                   t0: Optional[float] = None) -> threading.Thread:
        """Wall-clock driver for the bench: applies ops as they come due
        until the schedule is exhausted or ``stop`` is set."""
        start = time.monotonic() if t0 is None else t0

        def _run():
            while not self.done() and not stop.is_set():
                now = time.monotonic() - start
                self.apply_until(now)
                if self._next < len(self.schedule):
                    delay = self.schedule[self._next].t - (
                        time.monotonic() - start)
                    if delay > 0:
                        stop.wait(min(delay, 0.05))

        th = threading.Thread(target=_run, daemon=True)
        th.start()
        return th


# ------------------------------------------------------- rolling updates


def diurnal_rate(base: float, amp: float = 0.5, period_s: float = 60.0):
    """Offered-rate curve shaped like a day: rate(t) = base * (1 + amp *
    sin(2*pi*t/period)). The rolling-update scenario rides its replacement
    waves on TOP of this curve, so the update is measured against a
    cluster whose background load is moving — deploy-shaped traffic,
    not a quiet box."""
    import math

    def rate(t: float) -> float:
        return max(0.0, base * (1.0 + amp *
                                math.sin(2.0 * math.pi * t / period_s)))

    return rate


@dataclass
class RollingUpdateConfig:
    """Deployment-shaped rolling update (the reference's deployment
    controller semantics, driven against store truth): `replicas` old-
    revision pods are replaced by new-revision pods under the two
    standard bounds — at most `max_surge` pods OVER the replica count
    may exist at once, and availability may fall at most
    `max_unavailable` UNDER it (a replacement counts available once it
    is bound)."""

    replicas: int = 200
    max_surge: int = 25
    max_unavailable: int = 25
    app: str = "web"
    old_rev: str = "1"
    new_rev: str = "2"


class RollingUpdateDriver:
    """Evict-and-recreate controller: each ``step()`` observes STORE
    truth (never its own bookkeeping — a controller trusting its own
    view would hide scheduler lag), creates replacements up to the surge
    bound, and evicts old-revision pods down to the unavailability
    bound. The driver records the observed extremes so the bench can
    report `surge_respected` / `unavailable_respected` as measured
    facts rather than configuration echoes.

    ``make_replacement(i)`` must return a pod labeled
    {app: cfg.app, rev: cfg.new_rev}; the driver stamps each creation
    in ``create_ts`` (key -> monotonic instant) for the caller's
    create->bound join."""

    def __init__(self, api: ApiServerLite, cfg: RollingUpdateConfig,
                 make_replacement):
        self.api = api
        self.cfg = cfg
        self.make_replacement = make_replacement
        self.create_ts: Dict[str, float] = {}
        self.replacement_keys: List[str] = []
        self._created = 0
        self.evicted = 0
        self.noop = 0
        self.started_at: Optional[float] = None
        self.completed_at: Optional[float] = None
        self.max_total_seen = 0
        self.min_available_seen = cfg.replicas

    def _observe(self):
        cfg = self.cfg
        pods = [p for p in self.api.list("Pod")[0]
                if p.labels.get("app") == cfg.app]
        old = [p for p in pods if p.labels.get("rev") == cfg.old_rev]
        new = [p for p in pods if p.labels.get("rev") == cfg.new_rev]
        return old, new

    def step(self) -> bool:
        """One controller pass; returns True once the update is complete
        (no old-revision pod remains and every replacement is bound)."""
        cfg = self.cfg
        now = time.monotonic()
        if self.started_at is None:
            self.started_at = now
        old, new = self._observe()
        new_bound = sum(1 for p in new if p.node_name)
        available = sum(1 for p in old if p.node_name) + new_bound
        total = len(old) + len(new)
        self.max_total_seen = max(self.max_total_seen, total)
        self.min_available_seen = min(self.min_available_seen, available)
        # surge-bounded creation: never exceed replicas + max_surge pods
        # of this app in the store, never create more than replicas
        # replacements overall
        n_create = min(cfg.replicas + cfg.max_surge - total,
                       cfg.replicas - self._created)
        for _ in range(max(n_create, 0)):
            p = self.make_replacement(self._created)
            self.api.create("Pod", p)
            self.create_ts[p.key()] = time.monotonic()
            self.replacement_keys.append(p.key())
            self._created += 1
        # unavailability-bounded eviction: only as many old pods as keeps
        # available >= replicas - max_unavailable (replacements created
        # above are NOT yet available — they count only once bound)
        n_evict = available - (cfg.replicas - cfg.max_unavailable)
        victims = sorted((p for p in old if p.node_name),
                         key=lambda p: p.name)
        for p in victims[:max(n_evict, 0)]:
            try:
                self.api.delete("Pod", p.namespace, p.name)
            except NotFound:
                self.noop += 1
            else:
                self.evicted += 1
        # completion is judged on THIS step's pre-action observation: the
        # step after the last eviction sees an empty old set and every
        # replacement bound
        done = not old and self._created >= cfg.replicas \
            and new_bound >= cfg.replicas
        if done and self.completed_at is None:
            self.completed_at = time.monotonic()
        return done

    def bounds_report(self) -> Dict[str, object]:
        cfg = self.cfg
        return {
            "replicas": cfg.replicas,
            "max_surge": cfg.max_surge,
            "max_unavailable": cfg.max_unavailable,
            "max_total_seen": int(self.max_total_seen),
            "min_available_seen": int(self.min_available_seen),
            "surge_respected":
                bool(self.max_total_seen <= cfg.replicas + cfg.max_surge),
            "unavailable_respected":
                bool(self.min_available_seen
                     >= cfg.replicas - cfg.max_unavailable),
            "evicted": int(self.evicted),
            "created": int(self._created),
        }

    def run_thread(self, stop: threading.Event,
                   poll_s: float = 0.01) -> threading.Thread:
        """Wall-clock driver for the bench: steps the controller until
        the update completes or ``stop`` is set."""

        def _run():
            while not stop.is_set():
                if self.step():
                    break
                stop.wait(poll_s)

        th = threading.Thread(target=_run, daemon=True)
        th.start()
        return th


# ----------------------------------------------------- store-truth audits


def audit_store_transitions(api) -> Dict[str, Dict[str, int]]:
    """Walk the store's retained event log and count per-pod BINDS
    (unbound -> bound transitions, preloaded-bound ADDs included) and
    EVICTIONS (bound -> unbound). The log orders transitions, so 'one
    bound node per preemptor ever' and 'every victim evicted at most
    once' are direct assertions over these counts — the exactly-once
    audit extended to the victim seam. Callers must size the
    store's max_log to retain the whole scenario."""
    binds: Dict[str, int] = {}
    evicts: Dict[str, int] = {}
    state: Dict[str, str] = {}
    for ev in list(getattr(api, "_log")):
        if ev.kind != "Pod":
            continue
        key = ev.obj.key()
        node = ev.obj.node_name or ""
        if ev.type == "DELETED":
            state.pop(key, None)
            continue
        prev = state.get(key, "")
        if node and not prev:
            binds[key] = binds.get(key, 0) + 1
        elif prev and not node:
            evicts[key] = evicts.get(key, 0) + 1
        state[key] = node
    return {"binds": binds, "evicts": evicts}


def audit_cache_vs_store(sched, api) -> List[str]:
    """Ghost-capacity audit: after quiesce, every pod the
    scheduler cache counts against a node must be bound there at the
    store, and vice versa — an evicted victim still resident in a
    NodeInfo would be phantom occupancy 'freeing' capacity that is not
    free. Assumed (in-flight optimistic) claims are exempt. Returns the
    discrepancy list (empty = clean)."""
    store_bound = {p.key(): p.node_name
                   for p in api.list("Pod")[0] if p.node_name}
    with sched.cache._lock:
        assumed = {k for k, st in sched.cache._pod_states.items()
                   if st.assumed}
        cache_bound = {p.key(): name
                       for name, info in sched.cache._nodes.items()
                       for p in info.pods}
    problems: List[str] = []
    for k, n in cache_bound.items():
        if k in assumed:
            continue
        if store_bound.get(k) != n:
            problems.append(
                f"cache counts {k} on {n}; store says "
                f"{store_bound.get(k, '<unbound>')}")
    for k in store_bound:
        if k not in cache_bound:
            problems.append(f"store-bound {k} missing from cache")
    return problems


# -------------------------------------------------------- cell brownout


@dataclass(frozen=True)
class CellBrownoutOp:
    """One cell-level fault for the federation tier: the cell
    goes NotReady at ``t`` (router evacuates its pending pods through
    the spillover path) and recovers at ``t + down_s``."""

    t: float
    cell: str
    down_s: float


def make_brownout_schedule(cell_names: List[str], duration_s: float,
                           down_s: float = 2.0, count: int = 1,
                           seed: int = 0) -> List[CellBrownoutOp]:
    """Frozen brownout schedule, deterministic in its arguments (the
    same replayable-trace contract as make_churn_schedule). Instants
    land in the middle 80% of the window — a brownout at the very edge
    would measure shutdown, not spillover — and never overlap on the
    same cell."""
    rng = random.Random(seed ^ 0xB10)
    ops: List[CellBrownoutOp] = []
    busy_until: Dict[str, float] = {}
    lo, hi = 0.1 * duration_s, 0.9 * duration_s
    for _ in range(max(int(count), 0)):
        t = rng.uniform(lo, max(hi - down_s, lo))
        free = [c for c in cell_names if busy_until.get(c, -1.0) < t]
        if not free:
            continue
        cell = free[rng.randrange(len(free))]
        busy_until[cell] = t + down_s
        ops.append(CellBrownoutOp(t, cell, down_s))
    ops.sort(key=lambda op: (op.t, op.cell))
    return ops


class BrownoutDriver:
    """Applies a frozen brownout schedule against a FederationRouter.
    Call ``apply_until(t)`` from the owner's clock; each op's down and
    up phases fire exactly once. Returns evacuated-pod count applied in
    this call."""

    def __init__(self, router, schedule: List[CellBrownoutOp]):
        self._router = router
        self._downs = sorted(schedule, key=lambda op: op.t)
        self._ups = sorted(schedule, key=lambda op: op.t + op.down_s)
        self._di = 0
        self._ui = 0
        self.evacuated = 0

    def apply_until(self, t: float) -> int:
        moved = 0
        while self._di < len(self._downs) and self._downs[self._di].t <= t:
            op = self._downs[self._di]
            self._di += 1
            moved += self._router.brownout(op.cell)
        while self._ui < len(self._ups) \
                and self._ups[self._ui].t + self._ups[self._ui].down_s <= t:
            op = self._ups[self._ui]
            self._ui += 1
            self._router.recover(op.cell)
        self.evacuated += moved
        return moved

    def done(self) -> bool:
        return self._di >= len(self._downs) and self._ui >= len(self._ups)


__all__ = ["BrownoutDriver", "CellBrownoutOp", "ChurnConfig",
           "ChurnInjector", "ChurnOp", "FaultyBindApi",
           "RollingUpdateConfig", "RollingUpdateDriver",
           "audit_cache_vs_store", "audit_store_transitions",
           "diurnal_rate", "extender_store_binder",
           "make_brownout_schedule", "make_churn_schedule", "ZONES"]
