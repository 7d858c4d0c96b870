"""Per-cell aggregate state for the federation router.

One cell collapses to ONE column of the router's [C, M] routing tensor:
capacity headroom (cpu/mem allocatable minus requested, quantized the
same way resource_row quantizes pod requests), band pressure (pending
backlog normalized by node count), and affinity-domain presence (which
topology domains — zone labels — exist in the cell at all, so a pod with
a required zone affinity never routes to a cell that cannot satisfy it).

Two producers, ONE math:

- ``aggregate_from_lists(nodes, pods)`` rebuilds the aggregate from a
  full (nodes, bound/pending pods) listing — the RELIST-hydration path
  and the store-truth ORACLE the incremental path is audited against;
- ``CellAggregate.apply_event(ev)`` folds one watch event into a live
  aggregate — the delta-by-delta maintenance the cell runs over its own
  event log (the Protean patch discipline one level up: bind/evict
  confirmations patch the column; only a RELIST rebuilds it wholesale).

The A/B test (tests/test_federation_router.py) pins that draining a
cell's whole event log through apply_event lands on the SAME aggregate
``aggregate_from_lists`` computes from the final store state — if the
incremental column ever drifts from store truth, routing decisions are
being made on a lie and the test fails, not the router.

Pure host math — no torch import; the [C, M] tensor assembly and scoring
live in ops/federation.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# quantization mirrors state/snapshot resource_row: cpu in millicores,
# memory in MiB — int headroom keeps the routing tensor integer-exact
_MEM_MIB = 1 << 20


def _pod_demand(pod) -> Tuple[int, int]:
    """(cpu_m, mem_mib) summed over containers — the same request shape
    resource_row quantizes, flattened to the two axes the router scores."""
    cpu = 0
    mem = 0
    for c in pod.containers:
        cpu += int(c.requests.get("cpu", 0))
        mem += int(c.requests.get("memory", 0))
    return cpu, mem // _MEM_MIB


def _node_alloc(node) -> Tuple[int, int]:
    return (int(node.allocatable.milli_cpu),
            int(node.allocatable.memory) // _MEM_MIB)


def _node_ready(node) -> bool:
    # Node.is_ready already folds unschedulable + Ready/OutOfDisk/
    # NetworkUnavailable conditions — the predicate layer's truth
    return node.is_ready()


@dataclass
class CellAggregate:
    """One cell's routing column. ``gen`` counts folds (events applied or
    rebuilds) so the router can tell a fresh column from a stale one."""

    cell: str = ""
    gen: int = 0
    nodes_total: int = 0
    nodes_ready: int = 0
    cpu_alloc_m: int = 0          # sum allocatable cpu (millicores), ready nodes
    mem_alloc_mib: int = 0
    cpu_used_m: int = 0           # sum requests of BOUND pods
    mem_used_mib: int = 0
    pending: int = 0              # pods in store without a node
    bound_total: int = 0          # monotone bind confirmations
    evictions_total: int = 0      # monotone unbind/delete-of-bound
    domains: Dict[str, int] = field(default_factory=dict)  # zone -> nodes
    # not-ready mark is ROUTER state (brownout), carried here so one
    # object is the whole column; the cell itself never sets it
    ready: bool = True
    # internal per-object memos the incremental fold needs (last-seen
    # charge per bound pod, per-node contribution) — not wire fields
    _pod_charge: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    _node_row: Dict[str, Tuple[int, int, bool, str]] = field(
        default_factory=dict)

    # ------------------------------------------------------------ wire form

    WIRE_KEYS = ("cell", "gen", "nodes_total", "nodes_ready",
                 "cpu_alloc_m", "mem_alloc_mib", "cpu_used_m",
                 "mem_used_mib", "pending", "bound_total",
                 "evictions_total", "domains", "ready")

    def to_dict(self) -> Dict:
        return {k: getattr(self, k) for k in self.WIRE_KEYS}

    @classmethod
    def from_dict(cls, d: Dict) -> "CellAggregate":
        agg = cls()
        for k in cls.WIRE_KEYS:
            if k in d:
                setattr(agg, k, d[k])
        agg.domains = dict(agg.domains)
        return agg

    # ------------------------------------------------------------- headroom

    def headroom(self) -> Tuple[int, int]:
        return (self.cpu_alloc_m - self.cpu_used_m,
                self.mem_alloc_mib - self.mem_used_mib)

    # --------------------------------------------------- incremental folds

    def _add_node(self, node) -> None:
        cpu, mem = _node_alloc(node)
        ready = _node_ready(node)
        zone = (getattr(node, "labels", None) or {}).get("zone", "")
        self._node_row[node.name] = (cpu, mem, ready, zone)
        self.nodes_total += 1
        if ready:
            self.nodes_ready += 1
            self.cpu_alloc_m += cpu
            self.mem_alloc_mib += mem
        if zone:
            self.domains[zone] = self.domains.get(zone, 0) + 1

    def _drop_node(self, name: str) -> None:
        row = self._node_row.pop(name, None)
        if row is None:
            return
        cpu, mem, ready, zone = row
        self.nodes_total -= 1
        if ready:
            self.nodes_ready -= 1
            self.cpu_alloc_m -= cpu
            self.mem_alloc_mib -= mem
        if zone:
            left = self.domains.get(zone, 0) - 1
            if left > 0:
                self.domains[zone] = left
            else:
                self.domains.pop(zone, None)

    def _charge_pod(self, pod) -> None:
        cpu, mem = _pod_demand(pod)
        self._pod_charge[pod.key()] = (cpu, mem)
        self.cpu_used_m += cpu
        self.mem_used_mib += mem

    def _discharge_pod(self, key: str) -> None:
        cpu, mem = self._pod_charge.pop(key, (0, 0))
        self.cpu_used_m -= cpu
        self.mem_used_mib -= mem

    def apply_event(self, ev) -> None:
        """Fold one ApiServerLite WatchEvent. Pod MODIFIED with a node is
        the bind confirmation (pending -> bound, capacity charged); a
        DELETED bound pod (or MODIFIED back to nodeless — eviction's
        unbind) discharges and counts an eviction."""
        self.gen += 1
        kind, typ, obj = ev.kind, ev.type, ev.obj
        if kind == "Node":
            if typ == "ADDED":
                self._add_node(obj)
            elif typ == "DELETED":
                self._drop_node(obj.name)
            elif typ == "MODIFIED":
                self._drop_node(obj.name)
                self._add_node(obj)
            return
        if kind != "Pod":
            return
        key = obj.key()
        bound_now = bool(getattr(obj, "node_name", None))
        was_bound = key in self._pod_charge
        if typ == "ADDED":
            if bound_now:
                self._charge_pod(obj)
                self.bound_total += 1
            else:
                self.pending += 1
        elif typ == "MODIFIED":
            if bound_now and not was_bound:
                self.pending = max(self.pending - 1, 0)
                self._charge_pod(obj)
                self.bound_total += 1
            elif not bound_now and was_bound:
                self._discharge_pod(key)
                self.pending += 1
                self.evictions_total += 1
        elif typ == "DELETED":
            if was_bound:
                self._discharge_pod(key)
                self.evictions_total += 1
            else:
                self.pending = max(self.pending - 1, 0)


def aggregate_from_lists(nodes: List, pods: List,
                         cell: str = "") -> CellAggregate:
    """Rebuild the whole column from a (nodes, pods) listing — the
    RELIST-hydration path and the oracle the incremental fold is audited
    against. ``pods`` is every pod the cell's store knows: bound pods
    charge capacity, nodeless ones count pending."""
    agg = CellAggregate(cell=cell, gen=1)
    for n in nodes:
        agg._add_node(n)
    for p in pods:
        if getattr(p, "node_name", None):
            agg._charge_pod(p)
            agg.bound_total += 1
        else:
            agg.pending += 1
    return agg


def fold_log(agg: CellAggregate, events, from_rv: int = 0) -> int:
    """Apply every event with resource_version > from_rv; returns the new
    cursor. The cell calls this on each aggregate() pull — delta-by-delta
    maintenance off its own watch log, never a store walk."""
    cursor = from_rv
    for ev in events:
        if ev.rv <= from_rv:
            continue
        agg.apply_event(ev)
        cursor = max(cursor, ev.rv)
    return cursor


__all__ = ["CellAggregate", "aggregate_from_lists", "fold_log"]
