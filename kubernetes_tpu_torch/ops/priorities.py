"""Vectorized priority functions: the pod x node scorer as dense int32
[P, N] score matrices.

PyTorch port of kubernetes_tpu/ops/priorities.py (PrioritizeNodes,
generic_scheduler.go:285-414). Integer formulas keep the reference's
int32 floor divisions, every divisor guarded with a clamp to >= 1 exactly
where the reference guards it; BalancedResourceAllocation stays the
reference's float32 formula as separate elementwise ops (one IEEE result
per op, so the CPU and the card agree bit for bit — a fused FMA could move
a truncated score by one).

Parity map (reference: plugin/pkg/scheduler/algorithm/priorities/):
  LeastRequestedPriorityMap      least_requested.go:33   -> least_requested
  BalancedResourceAllocationMap  balanced_resource_allocation.go:105
  MostRequestedPriorityMap       most_requested.go:33    -> most_requested
  TaintTolerationPriorityMap     taint_toleration.go:56  -> taint_toleration
  NodeAffinityPriority           node_affinity.go:36-100 -> node_affinity
  NodePreferAvoidPodsPriority    node_prefer_avoid_pods.go:29-60
  ImageLocalityPriorityMap       image_locality.go:32-66
  EqualPriorityMap               core/generic_scheduler.go:416
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from kubernetes_tpu_torch.api.types import MAX_PRIORITY
from kubernetes_tpu_torch.ops.predicates import int_matmul

Arrays = Dict[str, torch.Tensor]

I32 = torch.int32


def _unused_score(total: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """((cap - total) * 10) / cap with int floor division; 0 when cap==0 or
    total>cap (least_requested.go:47-57 calculateUnusedScore)."""
    safe_cap = cap.clamp(min=1)
    score = ((cap - total) * MAX_PRIORITY) // safe_cap
    return torch.where((cap == 0) | (total > cap), 0, score)


def _used_score(total: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """(total * 10) / cap; 0 when cap==0 or total>cap
    (most_requested.go:52-60 calculateUsedScore)."""
    safe_cap = cap.clamp(min=1)
    score = (total * MAX_PRIORITY) // safe_cap
    return torch.where((cap == 0) | (total > cap), 0, score)


def _totals(pod_nonzero: torch.Tensor, node_nonzero: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """total = pod nonzero request + node nonzero-requested sum
    (least_requested.go:67-70). [P,2],[N,2] -> ([P,N] cpu, [P,N] mem)."""
    tot = pod_nonzero[:, None, :] + node_nonzero[None, :, :]
    return tot[..., 0], tot[..., 1]


def least_requested(pod_nonzero: torch.Tensor, node_nonzero: torch.Tensor,
                    alloc: torch.Tensor) -> torch.Tensor:
    """(cpu_score + mem_score) / 2, each (cap-req)*10/cap
    (least_requested.go:33-90). -> [P,N] int32."""
    tot_cpu, tot_mem = _totals(pod_nonzero, node_nonzero)
    cpu = _unused_score(tot_cpu, alloc[None, :, 0])
    mem = _unused_score(tot_mem, alloc[None, :, 1])
    return (cpu + mem) // 2


def most_requested(pod_nonzero: torch.Tensor, node_nonzero: torch.Tensor,
                   alloc: torch.Tensor) -> torch.Tensor:
    """(most_requested.go:33-90)."""
    tot_cpu, tot_mem = _totals(pod_nonzero, node_nonzero)
    cpu = _used_score(tot_cpu, alloc[None, :, 0])
    mem = _used_score(tot_mem, alloc[None, :, 1])
    return (cpu + mem) // 2


def _balanced_score(tot_cpu: torch.Tensor, tot_mem: torch.Tensor,
                    cap_cpu: torch.Tensor, cap_mem: torch.Tensor
                    ) -> torch.Tensor:
    """10 - |cpuFraction - memFraction|*10, truncated; 0 when either
    fraction >= 1; fraction(cap==0) := 1
    (balanced_resource_allocation.go:51-92,105). float32, one op at a time.
    Shape-generic: shared by the [P,N] priority and the wave engine's
    per-row acceptance window."""
    f32 = torch.float32
    frac_c = torch.where(cap_cpu == 0, 1.0,
                         tot_cpu.to(f32) / cap_cpu.clamp(min=1).to(f32))
    frac_m = torch.where(cap_mem == 0, 1.0,
                         tot_mem.to(f32) / cap_mem.clamp(min=1).to(f32))
    diff = (frac_c - frac_m).abs()
    score = ((1.0 - diff) * MAX_PRIORITY).to(I32)  # truncation toward 0
    return torch.where((frac_c >= 1.0) | (frac_m >= 1.0), 0, score)


def balanced_allocation(pod_nonzero: torch.Tensor,
                        node_nonzero: torch.Tensor,
                        alloc: torch.Tensor) -> torch.Tensor:
    """BalancedResourceAllocationMap [P,N]."""
    tot_cpu, tot_mem = _totals(pod_nonzero, node_nonzero)
    return _balanced_score(tot_cpu, tot_mem, alloc[None, :, 0],
                           alloc[None, :, 1])


def taint_toleration(intolerated_pref: torch.Tensor,
                     taints_pref: torch.Tensor,
                     fits: torch.Tensor = None) -> torch.Tensor:
    """Count of PreferNoSchedule taints not tolerated, normalized as
    10 * (max - c) // max over the pod's filtered nodes; 10 when max == 0
    (taint_toleration.go:30-76)."""
    cnt = int_matmul(intolerated_pref, taints_pref)
    masked = cnt if fits is None else torch.where(fits, cnt, 0)
    max_cnt = masked.amax(dim=1, keepdim=True)
    safe = max_cnt.clamp(min=1)
    score = (MAX_PRIORITY * (max_cnt - cnt)) // safe
    return torch.where(max_cnt == 0, MAX_PRIORITY, score)


def equal(p: int, n: int, device) -> torch.Tensor:
    """EqualPriorityMap (generic_scheduler.go:416-424): score 1 everywhere."""
    return torch.ones((p, n), dtype=I32, device=device)


def node_affinity_counts(pods: Arrays, labels: torch.Tensor) -> torch.Tensor:
    """NodeAffinityPriority map phase (node_affinity.go:36-77): per-node
    sum of the weights of matching preferred terms -> int32 [P,N]."""
    req_all = pods["pref_req_all"]
    all_cnt = int_matmul(req_all, labels)                   # [P,T,N]
    need = req_all.to(I32).sum(dim=-1, dtype=I32)
    all_ok = all_cnt == need[:, :, None]
    forbid_cnt = int_matmul(pods["pref_forbid"], labels)
    any_cnt = int_matmul(pods["pref_req_any"], labels)      # [P,T,A,N]
    any_ok = ((any_cnt > 0)
              | ~pods["pref_any_used"][:, :, :, None]).all(dim=2)
    match = (all_ok & (forbid_cnt == 0) & any_ok
             & ~pods["pref_unsat"][:, :, None]) | pods["pref_empty"][:, :, None]
    match = match & pods["pref_valid"][:, :, None]
    return (match.to(I32) * pods["pref_weight"][:, :, None]).sum(dim=1,
                                                                 dtype=I32)


def node_affinity(pods: Arrays, labels: torch.Tensor,
                  fits: torch.Tensor = None) -> torch.Tensor:
    """Map + normalizing reduce (node_affinity.go:79-100):
    int(10 * count / maxCount) over the filtered set; all-zero -> 0."""
    cnt = node_affinity_counts(pods, labels)
    masked = cnt if fits is None else torch.where(fits, cnt, 0)
    mx = masked.amax(dim=1, keepdim=True)
    return torch.where(mx > 0, (MAX_PRIORITY * cnt) // mx.clamp(min=1), 0)


def prefer_avoid(avoid_idx: torch.Tensor, node_avoid: torch.Tensor
                 ) -> torch.Tensor:
    """NodePreferAvoidPodsPriority (node_prefer_avoid_pods.go:29-60): 0 when
    the node's preferAvoidPods annotation names the pod's RC/RS controller,
    else MaxPriority. avoid_idx [P] (-1 = not RC/RS-owned), node_avoid
    int8 [N,U] -> [P,N]."""
    safe = avoid_idx.clamp(min=0).long()
    hit = node_avoid[:, safe].T.bool()                     # [P,N]
    avoided = hit & (avoid_idx >= 0)[:, None]
    return torch.where(avoided, 0, MAX_PRIORITY).to(I32)


# image_locality.go:30-34 thresholds, quantized to KiB like the snapshot
MIN_IMG_KIB = (23 * 1024 * 1024) >> 10
MAX_IMG_KIB = (1000 * 1024 * 1024) >> 10


def image_locality(img_count: torch.Tensor, image_sizes: torch.Tensor
                   ) -> torch.Tensor:
    """ImageLocalityPriorityMap (image_locality.go:32-66): bucket the summed
    KiB size of the pod's images present on the node into 0..10. The sizes
    exceed float32's exact range, so the sum is an int32 broadcast
    multiply-sum over the (small) image axis."""
    total = (img_count[:, None, :] * image_sizes[None, :, :]).sum(
        dim=-1, dtype=I32)
    mid = (MAX_PRIORITY * (total - MIN_IMG_KIB)) \
        // (MAX_IMG_KIB - MIN_IMG_KIB) + 1
    return torch.where(total < MIN_IMG_KIB, 0,
                       torch.where(total >= MAX_IMG_KIB, MAX_PRIORITY, mid)
                       ).to(I32)


# registry: name -> (fn(pods, nodes, fits) -> [P,N] int32); `fits` is the
# pod's filtered-node mask, consumed only by reduce-normalized priorities
def _lr(pods: Arrays, nodes: Arrays, fits) -> torch.Tensor:
    return least_requested(pods["nonzero"], nodes["nonzero"], nodes["alloc"])


def _mr(pods: Arrays, nodes: Arrays, fits) -> torch.Tensor:
    return most_requested(pods["nonzero"], nodes["nonzero"], nodes["alloc"])


def _ba(pods: Arrays, nodes: Arrays, fits) -> torch.Tensor:
    return balanced_allocation(pods["nonzero"], nodes["nonzero"],
                               nodes["alloc"])


def _tt(pods: Arrays, nodes: Arrays, fits) -> torch.Tensor:
    return taint_toleration(pods["intolerated_pref"], nodes["taints_pref"],
                            fits)


def _eq(pods: Arrays, nodes: Arrays, fits) -> torch.Tensor:
    return equal(pods["nonzero"].shape[0], nodes["alloc"].shape[0],
                 nodes["alloc"].device)


def _na(pods: Arrays, nodes: Arrays, fits) -> torch.Tensor:
    return node_affinity(pods, nodes["labels"], fits)


def _avoid(pods: Arrays, nodes: Arrays, fits) -> torch.Tensor:
    return prefer_avoid(pods["avoid_idx"], nodes["avoid"])


def _img(pods: Arrays, nodes: Arrays, fits) -> torch.Tensor:
    return image_locality(pods["img_count"], nodes["image_sizes"])


PRIORITY_REGISTRY = {
    "LeastRequestedPriority": _lr,
    "MostRequestedPriority": _mr,
    "BalancedResourceAllocation": _ba,
    "TaintTolerationPriority": _tt,
    "NodeAffinityPriority": _na,
    "NodePreferAvoidPodsPriority": _avoid,
    "ImageLocalityPriority": _img,
    "EqualPriority": _eq,
}

# the two cluster-topology priorities live in ops/affinity.py; score()
# raises on them rather than contributing a silent zero
AFFINITY_PRIORITIES = frozenset({
    "SelectorSpreadPriority", "InterPodAffinityPriority",
})


def score(pods: Arrays, nodes: Arrays,
          priorities: Tuple[Tuple[str, int], ...],
          fits: torch.Tensor = None) -> torch.Tensor:
    """Weighted sum over enabled priorities -> int32 [P,N]
    (generic_scheduler.go:368-375). Unknown or topology priority names
    raise."""
    p = pods["nonzero"].shape[0]
    n = nodes["alloc"].shape[0]
    total = torch.zeros((p, n), dtype=I32, device=nodes["alloc"].device)
    for name, weight in priorities:
        if name in AFFINITY_PRIORITIES:
            raise KeyError(
                f"{name} needs cluster topology state — evaluate through "
                "the engine or ops.affinity, not the pod x node score()")
        total = total + PRIORITY_REGISTRY[name](pods, nodes, fits) * weight
    return total


DEFAULT_PRIORITIES: Tuple[Tuple[str, int], ...] = (
    ("SelectorSpreadPriority", 1),
    ("InterPodAffinityPriority", 1),
    ("LeastRequestedPriority", 1),
    ("BalancedResourceAllocation", 1),
    ("NodePreferAvoidPodsPriority", 10000),
    ("NodeAffinityPriority", 1),
    ("TaintTolerationPriority", 1),
)
