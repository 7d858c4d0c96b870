"""Pure-Python object-level oracle: exact reimplementation of the reference's
predicate/priority semantics over api.types objects.

Three jobs:
 1. Golden reference for kernel tests (tests/ compare oracle vs TPU kernels on
    randomized + table-driven fixtures, the strategy of the reference's
    predicates_test.go / priorities_test.go table tests).
 2. Exact host-side verification of device-chosen candidates for pods flagged
    needs_host_check (features the kernels over-approximate).
 3. Readable spec of the semantics, with reference file:line citations.

Python ints are arbitrary precision, so the int64 arithmetic of the Go code
(floor division in calculateUnusedScore etc.) is reproduced exactly.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api.types import (
    MAX_PRIORITY,
    ConditionStatus,
    Node,
    Pod,
    TaintEffect,
)
from kubernetes_tpu_torch.state.node_info import NodeInfo

# ---------------------------------------------------------------------------
# predicates — each returns (fit, reasons)
# ---------------------------------------------------------------------------


def pod_fits_resources(pod: Pod, info: NodeInfo) -> Tuple[bool, List[str]]:
    """reference: predicates.go:556-624 PodFitsResources."""
    node = info.node
    if node is None:
        return False, ["NodeNotFound"]
    fails: List[str] = []
    if len(info.pods) + 1 > node.allowed_pod_number:
        fails.append("InsufficientPods")
    req = pod.resource_request()
    if (req.milli_cpu == 0 and req.memory == 0 and req.nvidia_gpu == 0
            and req.storage_overlay == 0 and req.storage_scratch == 0
            and not req.extended):
        return not fails, fails
    alloc = node.allocatable
    used = info.requested
    if alloc.milli_cpu < req.milli_cpu + used.milli_cpu:
        fails.append("InsufficientCPU")
    if alloc.memory < req.memory + used.memory:
        fails.append("InsufficientMemory")
    if alloc.nvidia_gpu < req.nvidia_gpu + used.nvidia_gpu:
        fails.append("InsufficientGPU")
    scratch_req = req.storage_scratch
    if alloc.storage_overlay == 0:
        scratch_req += req.storage_overlay
        node_scratch = used.storage_overlay + used.storage_scratch
        if alloc.storage_scratch < scratch_req + node_scratch:
            fails.append("InsufficientScratch")
    elif alloc.storage_scratch < scratch_req + used.storage_scratch:
        fails.append("InsufficientScratch")
    if alloc.storage_overlay > 0 and \
            alloc.storage_overlay < req.storage_overlay + used.storage_overlay:
        fails.append("InsufficientOverlay")
    for name, q in req.extended.items():
        if alloc.extended.get(name, 0) < q + used.extended.get(name, 0):
            fails.append(f"Insufficient{name}")
    return not fails, fails


def pod_matches_node_selector(pod: Pod, node: Node) -> bool:
    """reference: predicates.go:640-685 podMatchesNodeLabels."""
    if pod.node_selector:
        for k, v in pod.node_selector.items():
            if node.labels.get(k) != v:
                return False
    na = pod.affinity.node_affinity if pod.affinity else None
    if na is not None and na.required_terms is not None:
        # ORed terms; empty list matches nothing
        if not any(t.matches_labels(node.labels) for t in na.required_terms):
            return False
    return True


def pod_fits_host(pod: Pod, node: Node) -> bool:
    """reference: predicates.go:698-712 PodFitsHost."""
    return not pod.node_name or pod.node_name == node.name


def pod_fits_host_ports(pod: Pod, info: NodeInfo) -> bool:
    """reference: predicates.go:859-878 PodFitsHostPorts."""
    want = pod.used_ports()
    return not any(p in info.used_ports for p in want if p != 0)


def pod_tolerates_node_taints(pod: Pod, node: Node) -> bool:
    """reference: predicates.go:1241-1265; only NoSchedule|NoExecute filter."""
    for taint in node.taints:
        eff = TaintEffect(taint.effect)
        if eff not in (TaintEffect.NO_SCHEDULE, TaintEffect.NO_EXECUTE):
            continue
        if not any(tol.tolerates(taint) for tol in pod.tolerations):
            return False
    return True


def check_node_condition(node: Node) -> bool:
    """reference: predicates.go:1306-1337 CheckNodeConditionPredicate."""
    return node.is_ready()


def check_memory_pressure(pod: Pod, node: Node) -> bool:
    """reference: predicates.go:1274-1294 (best-effort pods only)."""
    if not pod.is_best_effort():
        return True
    return node.condition("MemoryPressure") != ConditionStatus.TRUE


def check_disk_pressure(node: Node) -> bool:
    """reference: predicates.go:1296-1304."""
    return node.condition("DiskPressure") != ConditionStatus.TRUE


def pod_fits(pod: Pod, info: NodeInfo, ctx=None, affinity_meta=None) -> bool:
    """Default-provider predicate chain (defaults.go:118): volume predicates
    + GeneralPredicates + taints + conditions + (with a SchedulingContext)
    MatchInterPodAffinity."""
    node = info.node
    if node is None:
        return False
    res_ok, _ = pod_fits_resources(pod, info)
    ok = (res_ok
          and pod_fits_host(pod, node)
          and pod_fits_host_ports(pod, info)
          and pod_matches_node_selector(pod, node)
          and pod_tolerates_node_taints(pod, node)
          and check_node_condition(node)
          and check_memory_pressure(pod, node)
          and check_disk_pressure(node))
    if ok and pod.volumes:
        from kubernetes_tpu_torch.ops.oracle_volumes import volume_predicates_fit
        ok = volume_predicates_fit(
            pod, info, getattr(ctx, "volume_ctx", None))
    if ok and ctx is not None:
        from kubernetes_tpu_torch.ops.oracle_ext import inter_pod_affinity_fits
        ok = inter_pod_affinity_fits(pod, node, ctx, affinity_meta)
    if ok and ctx is not None \
            and getattr(ctx, "policy_algos", None) is not None \
            and ctx.policy_algos.active:
        # Policy-configured ServiceAffinity / NodeLabelPresence
        ok = ctx.policy_algos.oracle_fit(pod, node, ctx)
    return ok


# ---------------------------------------------------------------------------
# priorities
# ---------------------------------------------------------------------------


def _unused_score(requested: int, capacity: int) -> int:
    """reference: least_requested.go:47-57."""
    if capacity == 0 or requested > capacity:
        return 0
    return ((capacity - requested) * MAX_PRIORITY) // capacity


def _used_score(requested: int, capacity: int) -> int:
    """reference: most_requested.go:52-60."""
    if capacity == 0 or requested > capacity:
        return 0
    return (requested * MAX_PRIORITY) // capacity


def _nonzero_totals(pod: Pod, info: NodeInfo) -> Tuple[int, int]:
    cpu, mem = pod.nonzero_request()
    return cpu + info.nonzero_cpu, mem + info.nonzero_mem


def least_requested_score(pod: Pod, info: NodeInfo) -> int:
    """reference: least_requested.go:33-90."""
    tot_cpu, tot_mem = _nonzero_totals(pod, info)
    alloc = info.allocatable()
    return (_unused_score(tot_cpu, alloc.milli_cpu)
            + _unused_score(tot_mem, alloc.memory)) // 2


def most_requested_score(pod: Pod, info: NodeInfo) -> int:
    """reference: most_requested.go:33-90."""
    tot_cpu, tot_mem = _nonzero_totals(pod, info)
    alloc = info.allocatable()
    return (_used_score(tot_cpu, alloc.milli_cpu)
            + _used_score(tot_mem, alloc.memory)) // 2


def balanced_allocation_score(pod: Pod, info: NodeInfo) -> int:
    """reference: balanced_resource_allocation.go:51-104."""
    tot_cpu, tot_mem = _nonzero_totals(pod, info)
    alloc = info.allocatable()
    frac_c = tot_cpu / alloc.milli_cpu if alloc.milli_cpu else 1.0
    frac_m = tot_mem / alloc.memory if alloc.memory else 1.0
    if frac_c >= 1 or frac_m >= 1:
        return 0
    return int((1 - abs(frac_c - frac_m)) * MAX_PRIORITY)


def taint_toleration_scores(pod: Pod, infos: Sequence[NodeInfo]) -> List[int]:
    """reference: taint_toleration.go:30-76 (map + normalizing reduce)."""
    counts = []
    for info in infos:
        node = info.node
        c = 0
        if node is not None:
            for taint in node.taints:
                if TaintEffect(taint.effect) != TaintEffect.PREFER_NO_SCHEDULE:
                    continue
                if not any(t.tolerates(taint) for t in pod.tolerations):
                    c += 1
        counts.append(c)
    max_c = max(counts) if counts else 0
    if max_c == 0:
        return [MAX_PRIORITY for _ in counts]
    return [int(MAX_PRIORITY * (1 - c / max_c)) for c in counts]


DEFAULT_PRIORITY_WEIGHTS: Tuple[Tuple[str, int], ...] = (
    ("LeastRequestedPriority", 1),
    ("BalancedResourceAllocation", 1),
    ("TaintTolerationPriority", 1),
)


def prioritize(pod: Pod, infos: Sequence[NodeInfo],
               priorities: Tuple[Tuple[str, int], ...] = DEFAULT_PRIORITY_WEIGHTS,
               ctx=None) -> List[int]:
    """Weighted sum across enabled priorities (generic_scheduler.go:368-375).
    Context-dependent priorities (spreading, inter-pod affinity) require a
    SchedulingContext and score 0 without one, mirroring their zero
    contribution when their listers are absent."""
    from kubernetes_tpu_torch.ops import oracle_ext
    n = len(infos)
    totals = [0] * n
    for name, weight in priorities:
        if name == "LeastRequestedPriority":
            per = [least_requested_score(pod, i) for i in infos]
        elif name == "MostRequestedPriority":
            per = [most_requested_score(pod, i) for i in infos]
        elif name == "BalancedResourceAllocation":
            per = [balanced_allocation_score(pod, i) for i in infos]
        elif name == "TaintTolerationPriority":
            per = taint_toleration_scores(pod, infos)
        elif name == "NodeAffinityPriority":
            per = oracle_ext.node_affinity_scores(pod, infos)
        elif name == "NodePreferAvoidPodsPriority":
            per = oracle_ext.prefer_avoid_scores(pod, infos)
        elif name == "ImageLocalityPriority":
            per = oracle_ext.image_locality_scores(pod, infos)
        elif name == "SelectorSpreadPriority":
            per = (oracle_ext.selector_spread_scores(pod, infos, ctx)
                   if ctx is not None else [0] * n)
        elif name == "InterPodAffinityPriority":
            per = (oracle_ext.interpod_affinity_scores(pod, infos, ctx)
                   if ctx is not None else [0] * n)
        elif name == "EqualPriority":
            per = [1] * n
        else:
            raise KeyError(name)
        for i in range(n):
            totals[i] += per[i] * weight
    if ctx is not None and getattr(ctx, "policy_algos", None) is not None \
            and ctx.policy_algos.active:
        # Policy-configured NodeLabel / ServiceAntiAffinity (weights folded)
        per = ctx.policy_algos.oracle_scores(pod, infos, ctx)
        for i in range(n):
            totals[i] += per[i]
    return totals


# ---------------------------------------------------------------------------
# schedule-one (oracle for the engine's sequential semantics)
# ---------------------------------------------------------------------------


class RoundRobin:
    """selectHost's lastNodeIndex counter (generic_scheduler.go:144-160).
    Ties among max-score nodes are broken round-robin; our canonical tie
    order is ascending node index in snapshot order (the reference's order
    after its unstable sort is implementation-defined)."""

    def __init__(self):
        self.counter = 0

    def pick(self, tie_count: int) -> int:
        ix = self.counter % tie_count
        self.counter += 1
        return ix


def schedule_one(pod: Pod, names: List[str], infos: Dict[str, NodeInfo],
                 rr: RoundRobin,
                 priorities: Tuple[Tuple[str, int], ...] = DEFAULT_PRIORITY_WEIGHTS,
                 ctx=None) -> Optional[str]:
    """genericScheduler.Schedule for one pod (generic_scheduler.go:88-142):
    filter -> prioritize -> selectHost. Returns node name or None."""
    meta = None
    if ctx is not None:
        from kubernetes_tpu_torch.ops.oracle_ext import AffinityMeta
        meta = AffinityMeta(pod, ctx)  # once per pod, not per node
    fit_names = [nm for nm in names if pod_fits(pod, infos[nm], ctx, meta)]
    if not fit_names:
        return None
    if len(fit_names) == 1:
        return fit_names[0]
    fit_infos = [infos[nm] for nm in fit_names]
    scores = prioritize(pod, fit_infos, priorities, ctx)
    best = max(scores)
    ties = [nm for nm, s in zip(fit_names, scores) if s == best]
    return ties[rr.pick(len(ties))]
