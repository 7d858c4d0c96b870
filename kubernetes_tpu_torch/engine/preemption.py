"""Pod priority preemption — the PodPriority long-tail item.

The reference at v1.7 ships only the feature gate
(pkg/features/kube_features.go:122 PodPriority, alpha) — scheduler
preemption landed in 1.8 (plugin/pkg/scheduler/core/generic_scheduler.go
Preempt / pickOneNodeForPreemption / selectVictimsOnNode in that tree).
This implements that design against the batch engine, TPU-framework
style: a vectorized host-side pre-filter over ALL nodes (the numpy
analog of the device fits kernel, over "resources freeable below my
priority") narrows to candidate nodes, then the exact oracle predicate
chain verifies each candidate with its victims removed — the same
over-approximate-then-verify-exact pattern the snapshot kernels use
(SURVEY §7 hard part (e)).

Semantics kept from the 1.8 scheduler:
- only pods with LOWER priority than the preemptor are victims;
- candidate victims are reprieved highest-priority-first while the
  preemptor still fits (selectVictimsOnNode's reprieve loop);
- node choice minimizes (highest victim priority, sum of victim
  priorities, victim count) — pickOneNodeForPreemption's ordering;
- a node where the preemptor does not fit even with every lower-
  priority pod gone is infeasible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.ops import oracle
from kubernetes_tpu_torch.state.node_info import NodeInfo


# exact-verification budget per preemptor (the percentageOfNodesToScore
# idea): past this many candidate nodes, verify only the most promising
MAX_VERIFIED_CANDIDATES = 128


@dataclass
class PreemptionPlan:
    node_name: str
    victims: List[Pod]  # sorted lowest priority first (eviction order)


class PreemptionState:
    """Round-scoped arrays for the candidate pre-filter: built ONCE from
    the NodeInfo map (O(total pods) Python attribute access), then each
    preemptor's mask is pure numpy (bincount segment sums over the pod
    axis) and plan effects apply incrementally — a 200-preemptor burst
    costs one array build, not 200 (measured 80 ms/preemptor without
    this at 1k nodes / 4k pods)."""

    def __init__(self, infos: Dict[str, NodeInfo]):
        self.names = sorted(infos)
        self.infos = [infos[n] for n in self.names]
        n = len(self.infos)
        self.alloc_cpu = np.empty(n, dtype=np.int64)
        self.alloc_mem = np.empty(n, dtype=np.int64)
        self.alloc_pods = np.empty(n, dtype=np.int64)
        self.used_cpu = np.empty(n, dtype=np.int64)
        self.used_mem = np.empty(n, dtype=np.int64)
        self.used_count = np.empty(n, dtype=np.int64)
        node_idx, prio, cpu, mem = [], [], [], []
        keys = []
        for i, info in enumerate(self.infos):
            alloc = info.allocatable()
            self.alloc_cpu[i] = alloc.milli_cpu
            self.alloc_mem[i] = alloc.memory
            self.alloc_pods[i] = info.allowed_pod_number()
            self.used_cpu[i] = info.requested.milli_cpu
            self.used_mem[i] = info.requested.memory
            self.used_count[i] = len(info.pods)
            for vic in info.pods:
                r = vic.resource_request()
                node_idx.append(i)
                prio.append(vic.priority)
                cpu.append(r.milli_cpu)
                mem.append(r.memory)
                keys.append(vic.key())
        self.n = n
        self.pod_node = np.asarray(node_idx, dtype=np.int64)
        self.pod_prio = np.asarray(prio, dtype=np.int64)
        self.pod_cpu = np.asarray(cpu, dtype=np.int64)
        self.pod_mem = np.asarray(mem, dtype=np.int64)
        self.pod_keys = keys
        self.alive = np.ones(len(node_idx), dtype=bool)
        self._name_index = {name: i for i, name in enumerate(self.names)}
        # flat pod arrays sorted by (node, priority) + segment offsets —
        # the vectorized tight-bound pass reads priority-ordered prefixes
        # of every node at once (built lazily on first truncation)
        self._s_perm: Optional[np.ndarray] = None

    def _ensure_sorted(self) -> None:
        if self._s_perm is not None:
            return
        perm = np.lexsort((self.pod_prio, self.pod_node))
        self._s_perm = perm
        self._s_node = self.pod_node[perm]
        self._s_prio = self.pod_prio[perm]
        self._s_cpu = self.pod_cpu[perm]
        self._s_mem = self.pod_mem[perm]
        # first flat position of each node's segment
        self._seg_start = np.searchsorted(self._s_node, np.arange(self.n))

    def tight_bounds(self, pod: Pod) -> np.ndarray:
        """Per-node EXACT minimal max-victim-priority under the
        resources-only relaxation: evict pods ascending by priority until
        the preemptor fits; the bound is that prefix's max priority. A
        true achievable-key floor — neither the optimistic per-node MIN
        (a tiny pod that frees nothing ranks a node too well) nor the
        pessimistic MAX (one high-priority pod hides a cheap
        single-victim plan). One vectorized pass over the flat
        (node, priority)-sorted arrays; INT64_MAX = infeasible."""
        self._ensure_sorted()
        need = pod.resource_request()
        below = self.alive[self._s_perm] & (self._s_prio < pod.priority)
        freed_cpu = np.cumsum(np.where(below, self._s_cpu, 0))
        freed_mem = np.cumsum(np.where(below, self._s_mem, 0))
        # per-segment cumulative = global cumsum minus the segment base
        base_cpu = np.concatenate(([0], freed_cpu))[self._seg_start]
        base_mem = np.concatenate(([0], freed_mem))[self._seg_start]
        spare_cpu = (self.alloc_cpu - self.used_cpu)[self._s_node]
        spare_mem = (self.alloc_mem - self.used_mem)[self._s_node]
        ok = ((spare_cpu + freed_cpu - base_cpu[self._s_node]
               >= need.milli_cpu)
              & (spare_mem + freed_mem - base_mem[self._s_node]
                 >= need.memory) & below)
        big = np.iinfo(np.int64).max
        first_ok = np.full(self.n, len(ok), dtype=np.int64)
        flat_pos = np.flatnonzero(ok)
        np.minimum.at(first_ok, self._s_node[flat_pos], flat_pos)
        bounds = np.full(self.n, big, dtype=np.int64)
        has = first_ok < len(ok)
        bounds[has] = self._s_prio[first_ok[has]]
        return bounds

    def candidate_mask(self, pod: Pod) -> np.ndarray:
        need = pod.resource_request()
        below = self.alive & (self.pod_prio < pod.priority)
        idx = self.pod_node[below]
        free_cpu = np.bincount(idx, weights=self.pod_cpu[below],
                               minlength=self.n)
        free_mem = np.bincount(idx, weights=self.pod_mem[below],
                               minlength=self.n)
        free_count = np.bincount(idx, minlength=self.n)
        return ((self.used_cpu - free_cpu + need.milli_cpu
                 <= self.alloc_cpu)
                & (self.used_mem - free_mem + need.memory
                   <= self.alloc_mem)
                & (self.used_count - free_count + 1 <= self.alloc_pods)
                & (free_count > 0))  # no victims -> plain unschedulable,
                                     # not a preemption candidate

    def apply_plan(self, plan: "PreemptionPlan", pod: Pod) -> None:
        """Reflect a committed plan: victims leave the arrays (and the
        node totals), the preemptor's request is reserved. The preemptor
        itself is NOT added to the pod arrays: later preemptors in the
        round have lower priority (sorted desc), so it can never be
        their victim — its reservation lives only in used_*."""
        node_i = self._name_index[plan.node_name]
        victim_keys = {v.key() for v in plan.victims}
        for v in plan.victims:
            r = v.resource_request()
            self.used_cpu[node_i] -= r.milli_cpu
            self.used_mem[node_i] -= r.memory
            self.used_count[node_i] -= 1
        # mark victim entries dead by key — order-independent, so
        # multiple plans against the same node stay consistent even as
        # the caller mutates the NodeInfo between them
        for j in np.flatnonzero(self.pod_node == node_i):
            if self.pod_keys[int(j)] in victim_keys:
                self.alive[int(j)] = False
        need = pod.resource_request()
        self.used_cpu[node_i] += need.milli_cpu
        self.used_mem[node_i] += need.memory
        self.used_count[node_i] += 1


def _select_victims(pod: Pod, info: NodeInfo,
                    ctx=None, evictable=None) -> Optional[List[Pod]]:
    """selectVictimsOnNode: start from all lower-priority pods evicted;
    if the preemptor fits, reprieve highest-priority victims first while
    it keeps fitting. Returns the minimal victim set, or None if the
    node is infeasible even with everything gone.

    ``evictable``: optional predicate narrowing the potential
    victim set — the wave path passes a store-confirmed-bound filter so
    an assumed-but-unconfirmed pod (unbound at the store; its eviction
    write would abort the atomic preempt commit) is never planned as a
    victim. None keeps the classic all-lower-priority semantics."""
    potential = [p for p in info.pods if p.priority < pod.priority
                 and (evictable is None or evictable(p))]
    if not potential:
        return None
    pot_keys = {p.key() for p in potential}
    keep = [p for p in info.pods if p.key() not in pot_keys]
    base = NodeInfo(info.node)
    for p in keep:
        base.add_pod(p)
    if not oracle.pod_fits(pod, base, ctx=ctx):
        return None
    # reprieve pass: highest priority first (then larger pods last so
    # small high-priority pods come back first)
    victims: List[Pod] = []
    for vic in sorted(potential,
                      key=lambda p: (-p.priority,
                                     p.resource_request().milli_cpu)):
        base.add_pod(vic)
        if oracle.pod_fits(pod, base, ctx=ctx):
            continue  # reprieved — stays
        base.remove_pod(vic)
        victims.append(vic)
    return sorted(victims, key=lambda p: p.priority)


def pick_preemption(pod: Pod, node_infos: Dict[str, NodeInfo],
                    ctx=None,
                    state: Optional[PreemptionState] = None
                    ) -> Optional[PreemptionPlan]:
    """generic_scheduler.Preempt: pre-filter all nodes vectorized, verify
    candidates exactly, choose by pickOneNodeForPreemption's ordering.
    Pass a round-scoped PreemptionState to amortize the array build over
    many preemptors (the caller then applies plans via
    state.apply_plan)."""
    if pod.priority <= 0:
        return None
    if state is None:
        state = PreemptionState(node_infos)
    mask = state.candidate_mask(pod)
    candidates = np.flatnonzero(mask)
    if len(candidates) > MAX_VERIFIED_CANDIDATES:
        # bound the exact phase the way the newer reference bounds
        # scoring (percentageOfNodesToScore), ranked by the TIGHT bound
        # (tight_bounds): the minimal max-victim-priority that actually
        # frees enough resources. This avoids both truncation
        # pathologies — a MAX ranking hides cheap single-victim plans on
        # mixed nodes, a bare MIN ranking promotes nodes whose tiny
        # low-priority pod frees nothing.
        bounds = state.tight_bounds(pod)
        order = np.argsort(bounds[candidates], kind="stable")
        candidates = candidates[order][:MAX_VERIFIED_CANDIDATES]
    best: Optional[Tuple[Tuple[int, int, int], str, List[Pod]]] = None
    for i in candidates:
        info = state.infos[int(i)]
        victims = _select_victims(pod, info, ctx=ctx)
        if victims is None or not victims:
            continue
        key = (max(v.priority for v in victims),
               sum(v.priority for v in victims),
               len(victims))
        if best is None or key < best[0]:
            best = (key, state.names[int(i)], victims)
    if best is None:
        return None
    return PreemptionPlan(node_name=best[1], victims=best[2])
