"""The federation front door: ONE router, M cells, a fused
[C, M] routing decision.

The dormant FederationSyncLoop seam grown into the real tier: the
router holds one CellAggregate column per cell (hydrated by RELIST,
maintained delta-by-delta from the cells' own CELL_AGG folds — the
Protean patch discipline one level up), scores every pending pod/gang
against every cell in ONE fused dispatch (ops/federation.py), and admits
each candidate to exactly ONE cell over the existing binary wire.

Cross-cell exactly-once composes from three layers, none of them new:
the router's per-batch idempotency keys (an ambiguous ADMIT replays the
SAME key and converges on the recorded answer), the cell store's
(kind, ns, name) Conflict (a pod can't double-enter one cell), and the
rule that a pod LEAVES its old cell's store — under that store's lock —
before the router may admit it anywhere else (CellService.cell_aggregate
deletes drained/evacuated pods in the same locked fold that returns
them). The acceptance audit is store truth: one bound cell per pod, ever.

Gangs route whole-cell (PAPERS.md §Tiresias): all members of a gang
enter the tensor as ONE row with summed demand, so the quorum fence
inside whichever cell wins never spans a cell boundary.

Brownout: ``brownout(cell)`` marks the column NotReady (routing skips it
instantly) and evacuates the cell's pending pods through the SAME
spillover path overflow uses — re-routed to the surviving cells, bound
once. ``recover(cell)`` re-hydrates the column from RELIST truth.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from kubernetes_tpu_torch import resolve_device
from kubernetes_tpu_torch.analysis import lockcheck
from kubernetes_tpu_torch.engine.gang import GANG_NAME_ANNOTATION
from kubernetes_tpu_torch.federation.aggregate import (
    CellAggregate,
    aggregate_from_lists,
)
from kubernetes_tpu_torch.observability.registry import TelemetryRegistry

# routing batches below this size take the numpy twin: on a [C, M] this
# small a device dispatch is pure overhead (the fast lane's host-twin
# rationale, one level up)
DEVICE_MIN_BATCH = 256

# events kept per cell lane (perfetto add_process_lanes payload bound)
MAX_EVENTS_PER_CELL = 4096


class WireCell:
    """One cell over the binary wire — the production handle shape."""

    def __init__(self, name: str, host: str, port: int,
                 timeout: float = 60.0):
        from kubernetes_tpu_torch.client.binarywire import BinaryWireClient
        self.name = name
        self._cli = BinaryWireClient(host, port, timeout=timeout)

    def relist(self):
        return self._cli.relist()

    def cell_agg(self, drain_spill: bool = False,
                 evacuate: bool = False):
        return self._cli.cell_agg(drain_spill=drain_spill,
                                  evacuate=evacuate)

    def admit(self, idem_key: str, pods: List) -> Tuple[int, int]:
        return self._cli.admit(idem_key, pods)

    def close(self) -> None:
        self._cli.close()


class LocalCell:
    """In-process handle over a CellService — the test/bench shape with
    zero wire between router and cell (same verbs, same semantics)."""

    def __init__(self, name: str, service):
        self.name = name
        self._svc = service

    def relist(self):
        return self._svc.relist()

    def cell_agg(self, drain_spill: bool = False,
                 evacuate: bool = False):
        return self._svc.cell_aggregate(drain_spill=drain_spill,
                                        evacuate=evacuate)

    def admit(self, idem_key: str, pods: List) -> Tuple[int, int]:
        return self._svc.admit(idem_key, pods)

    def close(self) -> None:
        pass


class FederationRouter:
    """Front-door admission over M cell handles (WireCell / LocalCell).

    ``device`` (None = the card, RuntimeError without one) is where the
    device route of the [C, M] scoring runs; ``use_device`` picks that
    route or the numpy twin per batch."""

    def __init__(self, cells: List, router_id: str = "fed0",
                 use_device: Optional[bool] = None, device=None):
        self.cells = list(cells)
        if not self.cells:
            raise ValueError("FederationRouter needs at least one cell")
        self.router_id = router_id
        # None = auto: device for batches >= DEVICE_MIN_BATCH. The twins
        # are A/B-pinned equal, so this is latency policy, not semantics.
        self.use_device = use_device
        self.device = resolve_device(device)
        self._lock = lockcheck.make_lock("FederationRouter._lock")
        self.aggs: Dict[str, CellAggregate] = {
            c.name: CellAggregate(cell=c.name) for c in self.cells}
        self._seq = 0
        # candidates no cell fits right now; retried on each pump
        self.backlog: List = []
        self.counters: Dict[str, int] = {
            "routed_pods": 0, "routed_gangs": 0, "admitted": 0,
            "admit_replays": 0, "unroutable": 0, "spill_moved": 0,
            "evacuated_moved": 0, "brownouts": 0, "recoveries": 0,
            "refreshes": 0, "hydrations": 0, "device_batches": 0,
            "host_batches": 0,
        }
        # per-cell lanes in perfetto.add_process_lanes worker shape
        self._events: Dict[str, List[Dict]] = {
            c.name: [] for c in self.cells}
        self.admit_spans: List[Tuple[float, float, int]] = []
        self.telemetry = TelemetryRegistry()
        self.telemetry.register_counters(
            "federation", self.counters_snapshot,
            prom_prefix="tpu_federation")

    # ------------------------------------------------------------ aggregates

    def hydrate(self) -> None:
        """RELIST every cell and rebuild its column from store truth —
        boot and recovery path (the oracle the incremental folds are
        audited against)."""
        for c in self.cells:
            t0 = time.monotonic()
            nodes, bound = c.relist()
            agg = aggregate_from_lists(nodes, bound, cell=c.name)
            with self._lock:
                agg.ready = self.aggs[c.name].ready
                self.aggs[c.name] = agg
                self.counters["hydrations"] += 1
            self._event(c.name, "relist", t0, nodes=len(nodes),
                        bound=len(bound))

    def refresh(self, drain_spill: bool = False) -> List:
        """Pull every ready cell's incrementally-folded column; with
        ``drain_spill`` also collect (and re-route later, via the
        caller) the pods those cells gave up on. Returns the drained
        pods tagged with their origin cell: [(origin, pod), ...]."""
        out: List = []
        for c in self.cells:
            with self._lock:
                cell_ready = self.aggs[c.name].ready
            if not cell_ready:
                continue
            t0 = time.monotonic()
            d, spilled = c.cell_agg(drain_spill=drain_spill)
            agg = CellAggregate.from_dict(d)
            agg.ready = True
            with self._lock:
                self.aggs[c.name] = agg
                self.counters["refreshes"] += 1
            self._event(c.name, "agg", t0, pending=agg.pending,
                        spilled=len(spilled))
            out.extend((c.name, p) for p in spilled)
        return out

    # --------------------------------------------------------------- routing

    def route(self, pods: List, exclude: Optional[Dict[str, str]] = None
              ) -> Tuple[Dict[str, List], List]:
        """Choose one cell per pod/gang; returns ({cell: pods}, leftover).

        Gang members collapse to ONE tensor row (summed demand, shared
        verdict) — a gang never splits. ``exclude`` maps pod key ->
        cell name the pod must NOT return to (spillover: re-admitting a
        spilled pod to its origin would just spill it again). Leftover
        = candidates no ready cell fits (callers backlog them)."""
        from kubernetes_tpu_torch.federation.aggregate import _pod_demand
        if not pods:
            return {}, []
        exclude = exclude or {}
        names = [c.name for c in self.cells]
        # ---- collapse to candidate rows (gangs whole, plain pods solo)
        rows: List[Dict] = []
        gang_rows: Dict[str, Dict] = {}
        for p in pods:
            ann = p.annotations or {}
            g = ann.get(GANG_NAME_ANNOTATION)
            cpu, mem = _pod_demand(p)
            zone = (p.node_selector or {}).get("zone", "")
            if g is None:
                rows.append({"pods": [p], "cpu": cpu, "mem": mem,
                             "zone": zone,
                             "not_cell": exclude.get(p.key(), "")})
            else:
                r = gang_rows.get(g)
                if r is None:
                    r = gang_rows[g] = {
                        "pods": [], "cpu": 0, "mem": 0, "zone": zone,
                        "not_cell": "", "gang": g}
                r["pods"].append(p)
                r["cpu"] += cpu
                r["mem"] += mem
                if zone:
                    r["zone"] = zone
                nc = exclude.get(p.key(), "")
                if nc:
                    r["not_cell"] = nc
        rows.extend(gang_rows.values())
        # ---- the [C, M] tensor off the live columns
        with self._lock:
            aggs = [self.aggs[n] for n in names]
        cpu_free = np.array([a.headroom()[0] for a in aggs],
                            dtype=np.int32)
        mem_free = np.array([a.headroom()[1] for a in aggs],
                            dtype=np.int32)
        cpu_cap = np.array([a.cpu_alloc_m for a in aggs], dtype=np.int32)
        mem_cap = np.array([a.mem_alloc_mib for a in aggs],
                           dtype=np.int32)
        pressure = np.array(
            [a.pending / max(a.nodes_ready, 1) for a in aggs],
            dtype=np.float32)
        ready = np.array([a.ready and a.nodes_ready > 0 for a in aggs],
                         dtype=bool)
        dem_cpu = np.array([r["cpu"] for r in rows], dtype=np.int32)
        dem_mem = np.array([r["mem"] for r in rows], dtype=np.int32)
        dom_ok = np.ones((len(rows), len(names)), dtype=bool)
        for i, r in enumerate(rows):
            if r["zone"]:
                dom_ok[i] = [r["zone"] in a.domains for a in aggs]
            if r["not_cell"] and r["not_cell"] in names:
                dom_ok[i, names.index(r["not_cell"])] = False
        verdict = self._score(dem_cpu, dem_mem, cpu_free, mem_free,
                              cpu_cap, mem_cap, pressure, ready, dom_ok)
        choice, fit = verdict[0], verdict[1]
        # ---- group + optimistic column update (charge pending now so a
        # same-pump second batch sees the admission pressure)
        assigned: Dict[str, List] = {}
        leftover: List = []
        with self._lock:
            for i, r in enumerate(rows):
                if fit[i] <= 0:
                    leftover.extend(r["pods"])
                    self.counters["unroutable"] += len(r["pods"])
                    continue
                cell = names[int(choice[i])]
                assigned.setdefault(cell, []).extend(r["pods"])
                agg = self.aggs[cell]
                agg.pending += len(r["pods"])
                if "gang" in r:
                    self.counters["routed_gangs"] += 1
                self.counters["routed_pods"] += len(r["pods"])
        return assigned, leftover

    def _score(self, dem_cpu, dem_mem, cpu_free, mem_free, cpu_cap,
               mem_cap, pressure, ready, dom_ok) -> np.ndarray:
        from kubernetes_tpu_torch.ops.federation import (
            route_scores,
            route_scores_host,
        )
        c = len(dem_cpu)
        dev = self.use_device
        if dev is None:
            dev = c >= DEVICE_MIN_BATCH
        if not dev:
            with self._lock:
                self.counters["host_batches"] += 1
            return route_scores_host(dem_cpu, dem_mem, cpu_free,
                                     mem_free, cpu_cap, mem_cap,
                                     pressure, ready, dom_ok)
        # pad the C axis to the bucket ladder so the device route sees
        # one shape per bucket, not one per batch size; padded rows
        # have zero demand and an all-True domain row — fit everywhere,
        # verdict discarded at the trim
        from kubernetes_tpu_torch.ops.predicates import bucket
        cb = bucket(c)
        if cb != c:
            pad = cb - c
            dem_cpu = np.pad(dem_cpu, (0, pad))
            dem_mem = np.pad(dem_mem, (0, pad))
            dom_ok = np.pad(dom_ok, ((0, pad), (0, 0)),
                            constant_values=True)
        with self._lock:
            self.counters["device_batches"] += 1
        # route_scores makes the batch's ONE routing-verdict fetch
        verdict = route_scores(dem_cpu, dem_mem, cpu_free, mem_free,
                               cpu_cap, mem_cap, pressure, ready, dom_ok,
                               device=self.device)
        return verdict[:, :c]

    # ------------------------------------------------------------- admission

    def admit(self, pods: List,
              exclude: Optional[Dict[str, str]] = None) -> Dict[str, int]:
        """Route + admit one batch; returns per-cell accepted counts.
        The admission span (route decision + every ADMIT round trip) is
        recorded per batch — the 'router admission on top of per-cell
        create->bound' number the bench reads as p99."""
        t0 = time.monotonic()
        assigned, leftover = self.route(pods, exclude=exclude)
        self.backlog.extend(leftover)
        out: Dict[str, int] = {}
        for c in self.cells:
            batch = assigned.get(c.name)
            if not batch:
                continue
            with self._lock:
                self._seq += 1
                idem = f"{self.router_id}:{c.name}:{self._seq}"
            ta = time.monotonic()
            try:
                accepted, replayed = c.admit(idem, batch)
            except Exception:
                # ambiguous wire fault: replay the SAME key once — the
                # cell's idem cache converges it to the recorded answer
                accepted, replayed = c.admit(idem, batch)
            self._event(c.name, "admit", ta, n=len(batch),
                        accepted=accepted)
            with self._lock:
                self.counters["admitted"] += accepted
                self.counters["admit_replays"] += replayed
            out[c.name] = accepted
        if pods:
            self.admit_spans.append(
                (t0, time.monotonic() - t0, len(pods)))
        return out

    def pump_backlog(self) -> int:
        """Retry the unroutable backlog after a refresh freed capacity."""
        if not self.backlog:
            return 0
        pods, self.backlog = self.backlog, []
        before = len(pods)
        self.admit(pods)
        return before - len(self.backlog)

    def spill_pump(self) -> int:
        """One spillover cycle: refresh every column, drain every cell's
        spill buffer, re-route the drained pods AWAY from their origin
        cells. Returns pods moved."""
        drained = self.refresh(drain_spill=True)
        moved = 0
        if drained:
            exclude = {p.key(): origin for origin, p in drained}
            self.admit([p for _o, p in drained], exclude=exclude)
            moved = len(drained)
            with self._lock:
                self.counters["spill_moved"] += moved
        self.pump_backlog()
        return moved

    # -------------------------------------------------------------- brownout

    def brownout(self, cell: str) -> int:
        """Mark a cell NotReady and drain it: spill buffer AND every
        still-pending pod leave its store, re-routed to the survivors
        through the ordinary spillover path. Returns pods evacuated."""
        handle = self._handle(cell)
        with self._lock:
            self.aggs[cell].ready = False
            self.counters["brownouts"] += 1
        t0 = time.monotonic()
        d, evacuated = handle.cell_agg(drain_spill=True, evacuate=True)
        agg = CellAggregate.from_dict(d)
        agg.ready = False
        with self._lock:
            self.aggs[cell] = agg
        self._event(cell, "brownout", t0, evacuated=len(evacuated))
        if evacuated:
            exclude = {p.key(): cell for p in evacuated}
            self.admit(evacuated, exclude=exclude)
            with self._lock:
                self.counters["evacuated_moved"] += len(evacuated)
        return len(evacuated)

    def recover(self, cell: str) -> None:
        """Bring a browned-out cell back: column re-hydrated from RELIST
        truth, ready again for routing."""
        handle = self._handle(cell)
        t0 = time.monotonic()
        nodes, bound = handle.relist()
        agg = aggregate_from_lists(nodes, bound, cell=cell)
        agg.ready = True
        with self._lock:
            self.aggs[cell] = agg
            self.counters["recoveries"] += 1
        self._event(cell, "recover", t0, bound=len(bound))

    # ------------------------------------------------------------ telemetry

    def _handle(self, cell: str):
        for c in self.cells:
            if c.name == cell:
                return c
        raise KeyError(cell)

    def _event(self, cell: str, kind: str, t0: float, **kw) -> None:
        lane = self._events[cell]
        if len(lane) < MAX_EVENTS_PER_CELL:
            e = {"kind": kind, "t": t0, "dur": time.monotonic() - t0}
            e.update(kw)
            lane.append(e)

    def counters_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counters)

    def lanes(self) -> List[Dict]:
        """Per-cell lanes in perfetto.add_process_lanes worker shape —
        one process row per cell with its relist/agg/admit/brownout
        spans, beside whatever the cells themselves traced."""
        with self._lock:
            return [{"worker": c.name,
                     "counts": {"events": len(self._events[c.name])},
                     "events": list(self._events[c.name])}
                    for c in self.cells]

    def admission_p99_ms(self) -> float:
        """p99 over per-batch admission spans (route + admit wire), ms."""
        if not self.admit_spans:
            return 0.0
        durs = sorted(d for _t, d, _n in self.admit_spans)
        i = min(len(durs) - 1, int(round(0.99 * (len(durs) - 1))))
        return durs[i] * 1e3

    def close(self) -> None:
        for c in self.cells:
            c.close()


__all__ = ["DEVICE_MIN_BATCH", "FederationRouter", "LocalCell",
           "MAX_EVENTS_PER_CELL", "WireCell"]
