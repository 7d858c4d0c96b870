"""One federation cell: the engine UNCHANGED behind the binary wire.

A cell is the unit of cluster management (PAPERS.md §Borg): its OWN
ApiServerLite store, its OWN engine Scheduler + always-on ScheduleLoop,
served to the front-door router over server/asyncwire.py. The federation
tier adds exactly three wire behaviors on top — nothing inside the
engine changes:

  - ``ADMIT``: the router hands this cell a batch of pending pods. Each
    pod enters the cell store with ``create`` (the scheduler's watch
    picks it up like any arrival); a (kind, ns, name) Conflict means the
    pod is ALREADY here — the replay half of cross-cell exactly-once
    (idempotency keys catch whole-batch replays, the store key catches
    per-pod ones).
  - ``CELL_AGG``: the cell's routing column (federation/aggregate.py),
    maintained delta-by-delta off the cell's OWN watch log on every pull
    — the Protean patch discipline one level up; a compacted log
    falls back to the store-walk rebuild. The drain flag also hands back
    (and forgets) the cell's spill buffer; the evacuate flag additionally
    uproots every still-pending pod — the brownout path.
  - ``RELIST``: overridden to answer from STORE truth (nodes + bound
    pods straight off ApiServerLite), because the router's aggregates
    and the cross-cell audits are defined against commit truth, not any
    evaluator cache.

Spillover: the engine's ``spill_handler`` hook (engine/scheduler.py)
hands pods whose unschedulable verdicts crossed the attempt threshold to
``CellService.spill`` — they wait in the spill buffer until the router's
next drain pulls them OUT of this cell (store delete included, so the
cell's pending count and the pod's cell-of-record move atomically under
the store lock ordering: deleted here before admitted anywhere else).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.analysis import lockcheck
from kubernetes_tpu_torch.federation.aggregate import (
    CellAggregate,
    aggregate_from_lists,
    fold_log,
)
from kubernetes_tpu_torch.server.apiserver_lite import (
    ApiServerLite,
    Conflict,
    NotFound,
    TooOldResourceVersion,
)
from kubernetes_tpu_torch.server.embedded import VerdictService

# idempotency-key memory: enough for every router retry burst in flight;
# beyond this the store's per-pod Conflict is still authoritative
MAX_IDEM_KEYS = 65536


class CellService(VerdictService):
    """The federation verbs over one cell's store + engine.

    ``backend=None`` is the normal federation shape: the router only
    speaks ADMIT / CELL_AGG / RELIST, none of which touch the extender
    backend — a cell co-hosting the sidecar verbs passes its backend
    through and everything composes."""

    def __init__(self, api: ApiServerLite, cell: str = "",
                 backend=None):
        super().__init__(backend)
        self.api = api
        self.cell = cell
        self._lock = lockcheck.make_lock(f"CellService[{cell}]._lock")
        self._agg = CellAggregate(cell=cell)
        self._cursor = 0
        self._spill: Dict[str, object] = {}          # pod key -> pod
        self._idem: Dict[str, Tuple[int, int]] = {}  # key -> result
        self.counters: Dict[str, int] = {
            "admits": 0, "admit_pods": 0, "admit_replays": 0,
            "spilled": 0, "spill_drained": 0, "evacuated": 0,
            "agg_pulls": 0, "agg_rebuilds": 0,
        }

    # ------------------------------------------------------------- verbs

    def relist(self):
        """(nodes, bound pods) from STORE truth — the hydration source
        for router aggregates and the surface the cross-cell audits
        read. The engine's own cache never answers federation reads."""
        nodes, _rv = self.api.list("Node")
        pods, _rv = self.api.list("Pod")
        return nodes, [p for p in pods if p.node_name]

    def admit(self, idem_key: str, pods: List) -> Tuple[int, int]:
        """Admit a router batch into this cell; returns (accepted,
        replayed). Exactly-once composes from two layers: a repeated
        ``idem_key`` replays the recorded answer without touching the
        store (the ambiguous-wire-fault retry), and a pod whose store
        key already exists counts replayed instead of double-entering
        (the pod-level layer that survives idem-cache eviction)."""
        with self._lock:
            if idem_key:
                hit = self._idem.get(idem_key)
                if hit is not None:
                    return hit
        accepted = replayed = 0
        for p in pods:
            try:
                self.api.create("Pod", p)
                accepted += 1
            except Conflict:
                replayed += 1
        out = (accepted, replayed)
        with self._lock:
            if idem_key:
                if len(self._idem) >= MAX_IDEM_KEYS:
                    self._idem.clear()
                self._idem[idem_key] = out
            self.counters["admits"] += 1
            self.counters["admit_pods"] += accepted
            self.counters["admit_replays"] += replayed
        return out

    def spill(self, pods: List) -> None:
        """Engine spill hook: pods THIS cell cannot place, staged for
        the router's next drain. Keyed — a pod the engine spills twice
        (requeue races) stages once."""
        with self._lock:
            for p in pods:
                self._spill[p.key()] = p
            self.counters["spilled"] = len(self._spill) \
                + self.counters["spill_drained"]

    def cell_aggregate(self, drain_spill: bool = False,
                       evacuate: bool = False):
        """The cell's routing column + (optionally) its outbound pods.

        Returns (aggregate dict, spilled pods). Every pull folds the
        watch log since the last cursor into the live aggregate —
        incremental by default, store-walk rebuild when the log was
        compacted past the cursor (monotone counters re-base to store
        truth then; the oracle A/B test covers the incremental path).
        Drained/evacuated pods are DELETED from the store before they
        are returned, so a pod's cell-of-record is never two cells."""
        with self._lock:
            self.counters["agg_pulls"] += 1
            self._fold_locked()
            out: List = []
            if drain_spill and self._spill:
                out.extend(self._spill.values())
                self.counters["spill_drained"] += len(self._spill)
                self._spill.clear()
            if evacuate:
                pods, _rv = self.api.list("Pod")
                seen = {p.key() for p in out}
                pending = [p for p in pods
                           if not p.node_name and p.key() not in seen]
                out.extend(pending)
                self.counters["evacuated"] += len(pending)
            for p in out:
                try:
                    self.api.delete("Pod", p.namespace, p.name)
                except NotFound:
                    pass
            if out:
                self._fold_locked()  # the deletes just logged
            return self._agg.to_dict(), out

    # ----------------------------------------------------------- internals

    def _fold_locked(self) -> None:
        lockcheck.assert_held(self._lock, "CellService._fold_locked")
        try:
            evs = self.api.watch_since(("Node", "Pod"), self._cursor,
                                       timeout=0)
            self._cursor = fold_log(self._agg, evs, self._cursor)
        except TooOldResourceVersion:
            nodes, _rv = self.api.list("Node")
            pods, rv = self.api.list("Pod")
            fresh = aggregate_from_lists(nodes, pods, cell=self.cell)
            fresh.ready = self._agg.ready
            fresh.gen = self._agg.gen + 1
            self._agg = fresh
            self._cursor = rv
            self.counters["agg_rebuilds"] += 1

    def counters_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counters)


class CellAgent:
    """One whole cell, composed: store + engine + always-on loop + wire.

    The engine is the Scheduler verbatim — the ONLY touchpoint is
    the spill_handler hook. ``start()`` boots the wire server and a pump
    thread driving the ScheduleLoop; pods arrive via ADMIT (store
    create), the loop's sync() admits them like any watch arrival.
    ``device`` (None = the card) is the engine's."""

    def __init__(self, name: str, nodes: List,
                 budget_s: float = 0.05, min_quantum: int = 64,
                 max_quantum: int = 4096,
                 spill_after_attempts: int = 2,
                 wire_workers: int = 2, port: int = 0, device=None):
        from kubernetes_tpu_torch.engine.scheduler import Scheduler
        from kubernetes_tpu_torch.server.asyncwire import AsyncBinaryServer

        self.name = name
        self.api = ApiServerLite(
            max_log=max(200_000, 8 * (len(nodes) + 4096)))
        for n in nodes:
            self.api.create("Node", n)
        self.sched = Scheduler(self.api, record_events=False,
                               device=device)
        self.service = CellService(self.api, cell=name)
        self.sched.spill_handler = self.service.spill
        self.sched.spill_after_attempts = spill_after_attempts
        self.sched.start()
        self.loop = self.sched.stream(budget_s=budget_s,
                                      min_quantum=min_quantum,
                                      max_quantum=max_quantum)
        self.server = AsyncBinaryServer(self.service, port=port,
                                        workers=wire_workers)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.server.port

    def start(self) -> None:
        self.server.start()
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name=f"cell-{self.name}")
        self._thread.start()

    def _pump(self) -> None:
        while not self._stop.is_set():
            self.loop.step(wait=0.002)

    def stop(self) -> Dict[str, int]:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        stats = self.loop.close()
        self.server.stop()
        return stats


def run_cell_process(cfg: Dict, out_q, ctrl_q) -> None:
    """One cell as a full OS process (spawn target — module level,
    import-safe). Announces {"cell", "port", "ok"} on out_q once the
    wire is up, pumps until ctrl_q delivers "stop", then reports the
    final accounting the federation audits need: every (pod, node)
    placement from STORE truth plus the service counters.
    ``cfg["device"]`` is the cell's device ("cuda", "cpu"; None = the
    card)."""
    from kubernetes_tpu_torch.models.hollow import hollow_nodes
    from kubernetes_tpu_torch.parallel.multiproc import audit_duplicate_binds

    name = cfg["cell"]
    nodes = hollow_nodes(int(cfg.get("n_nodes", 64)),
                         seed=int(cfg.get("seed", 0)))
    zones = max(int(cfg.get("zones", 8)), 1)
    zone_prefix = cfg.get("zone_prefix", f"{name}-z")
    for i, n in enumerate(nodes):
        n.labels["zone"] = f"{zone_prefix}{i % zones}"
    agent = CellAgent(
        name, nodes,
        budget_s=float(cfg.get("budget_s", 0.05)),
        min_quantum=int(cfg.get("min_quantum", 64)),
        max_quantum=int(cfg.get("max_quantum", 4096)),
        spill_after_attempts=int(cfg.get("spill_after_attempts", 2)),
        device=cfg.get("device"))
    try:
        agent.start()
        out_q.put({"cell": name, "port": agent.port, "ok": True})
        while True:
            try:
                msg = ctrl_q.get(timeout=0.5)
            except Exception:
                continue
            if msg == "stop":
                break
        agent.stop()
        pods, _rv = agent.api.list("Pod")
        bound = {p.key(): p.node_name for p in pods if p.node_name}
        out_q.put({
            "cell": name, "ok": True, "final": True,
            "bound": bound,
            "pending": sum(1 for p in pods if not p.node_name),
            "duplicate_binds": audit_duplicate_binds(agent.api),
            "counters": agent.service.counters_snapshot(),
        })
    except Exception as e:  # noqa: BLE001 — report, never hang the join
        out_q.put({"cell": name, "ok": False, "final": True,
                   "error": f"{type(e).__name__}: {e}"})


__all__ = ["CellAgent", "CellService", "MAX_IDEM_KEYS",
           "run_cell_process"]
