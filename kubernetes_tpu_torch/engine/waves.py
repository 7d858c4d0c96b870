"""Wave-parallel batch placement: the whole queue in a handful of passes.

PyTorch port of kubernetes_tpu/engine/waves.py. The wave semantics are
the reference's, unchanged:

  1. All still-pending pods score every node against a FROZEN node state
     with the same predicate/priority functions as the strict loop.
  2. Each pod draws from the shared round-robin counter in FIFO order (a
     pod with >1 fitting nodes consumes one draw) and targets the
     (draw mod m)-th node of its class's max-score tie set.
  3. Per-node conflict resolution: pods that picked the same node are
     ordered FIFO; the longest prefix run of same-class pods that still
     fits (exact integer capacity) and keeps the node's score at or above
     the frozen runner-up commits; the rest re-enter the next wave. Pods
     with host ports or volumes commit at most one per node per wave.
  4. A pod whose class fits NO node under the frozen state is
     unschedulable (capacity only shrinks as pods commit).

With the affinity arrays of a wave-eligible class set, each wave also
re-evaluates the required-anti mask against a per-node occupancy carry
(_wave_aff_mask); classes whose required (anti-)affinity the counters
cannot express go to the seeded strict tail, which tail_rounds_loop runs
as conflict rounds (or engine/batch.py as a per-pod scan).

The reference iterates waves (and tail rounds) in a lax.while_loop on
the device; here the loops are Python with one ``active.any()`` host
check per wave or round. Inputs are CLASS-level arrays; fits/scores are
[C, N].

Node-axis mesh: every cross-node-axis operation of the wave body — row
reductions, the winner tie selection, per-row gathers, commit scatters —
goes through a column vtable (engine/batch: _GlobalCol, the whole-axis
form, the ops exactly as the unsharded body writes them; _ShardCol, the
per-shard form inside an SPMD program, parallel/mesh.run_spmd), a
TWO-STAGE reduce: local work over the shard's N/D rows, then a small
cross-shard combine. No step gathers a full-N tensor to one device; the
only cross-shard payloads are the [D, C] tie counts and the [C] / [P]
combines. waves_loop, tail_rounds_loop, frozen_affinity_scores and
precompute all run per shard, as does engine/batch.py's scan.

Integer parity notes: the RR counter is uint32 in the reference; the port
carries it as an int64 tensor in [0, 2^32) and reads it as int32 where the
reference casts. Scatters with the reference's drop-sentinel index N land
in an N+1-row buffer whose last row is sliced off.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.api.types import MAX_PRIORITY
from kubernetes_tpu_torch.convert import tensor_from_numpy
from kubernetes_tpu_torch.engine.batch import (
    U32_MASK,
    NodeState,
    _GlobalCol,
    _ShardCol,
    check_affinity_priorities,
    counter_as_i32,
    gather_place_batch,
    seed_occupancy,
)
from kubernetes_tpu_torch.ops import affinity as aff_ops
from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.ops import predicates as preds
from kubernetes_tpu_torch.ops import priorities as prio
from kubernetes_tpu_torch.ops.predicates import int_matmul
from kubernetes_tpu_torch.parallel import mesh as mesh_mod

Arrays = Dict[str, torch.Tensor]

I32 = torch.int32


def _dynamic_fits(cls: Arrays, nodes: Arrays, state: NodeState,
                  res_fit: torch.Tensor) -> torch.Tensor:
    """Capacity-dependent predicate chain vs the wave's frozen state, [C,N].
    `res_fit` is the resources-fit mask of _class_capacity, computed in the
    same launch as the headroom."""
    return (
        res_fit
        & preds.pod_count_fit(state.pod_count, nodes["allowed_pods"])[None, :]
        & preds.ports_fit(cls["ports"], state.port_bitmap)
        & preds.no_disk_conflict(cls["vol_hard"], cls["vol_ro"],
                                 state.vol_present, state.vol_rw)
        & preds.max_pd_fit(cls["pd_req"], cls["pd_req_count"],
                           nodes["pd_kind"], state.pd_present,
                           state.pd_counts, nodes["pd_max"])
    )


_DYNAMIC = ("LeastRequestedPriority", "MostRequestedPriority",
            "BalancedResourceAllocation")
_REDUCE = ("TaintTolerationPriority", "NodeAffinityPriority")


@mesh_mod.per_shard(axis=1)
def precompute(cls: Arrays, nodes: Arrays,
               priorities: Tuple[Tuple[str, int], ...]) -> Arrays:
    """Everything state-independent, computed once per batch outside the
    wave loop: the static predicate mask, the reduce-priority count
    matrices and the weighted sum of static priorities. Elementwise over
    the node axis, so mesh-placed inputs give [C, N] tensors sharded on
    axis 1."""
    c = cls["req"].shape[0]
    n = nodes["alloc"].shape[0]
    dev = nodes["alloc"].device
    static_score = torch.zeros((c, n), dtype=I32, device=dev)
    for name, weight in priorities:
        if name in _DYNAMIC or name in _REDUCE \
                or name in prio.AFFINITY_PRIORITIES:
            continue
        static_score = static_score \
            + prio.PRIORITY_REGISTRY[name](cls, nodes, None) * weight
    if "policy_score" in cls:
        # Policy-configured NodeLabel / ServiceAntiAffinity priorities
        # (weights pre-folded; ops/policy_algos.py)
        static_score = static_score + cls["policy_score"]
    names = {nm for nm, _ in priorities}
    tt_cnt = int_matmul(cls["intolerated_pref"], nodes["taints_pref"]) \
        if "TaintTolerationPriority" in names \
        else torch.zeros((c, n), dtype=I32, device=dev)
    na_cnt = prio.node_affinity_counts(cls, nodes["labels"]) \
        if "NodeAffinityPriority" in names \
        else torch.zeros((c, n), dtype=I32, device=dev)
    return {"static_fit": preds.static_fits(cls, nodes),
            "static_score": static_score, "tt_cnt": tt_cnt, "na_cnt": na_cnt}


def _wave_scores(cls: Arrays, nodes: Arrays, state: NodeState,
                 pre: Arrays, fits: torch.Tensor,
                 priorities: Tuple[Tuple[str, int], ...],
                 col=None) -> torch.Tensor:
    """Weighted priority sum [C,N] against the frozen state; `col` carries
    the node-axis reductions (the reduce-priority maxima)."""
    if col is None:
        col = _GlobalCol(nodes["alloc"].shape[0])
    total = pre["static_score"]
    alloc = nodes["alloc"]
    for name, weight in priorities:
        if name == "LeastRequestedPriority":
            s = prio.least_requested(cls["nonzero"], state.nonzero, alloc)
        elif name == "MostRequestedPriority":
            s = prio.most_requested(cls["nonzero"], state.nonzero, alloc)
        elif name == "BalancedResourceAllocation":
            s = prio.balanced_allocation(cls["nonzero"], state.nonzero,
                                         alloc)
        elif name == "TaintTolerationPriority":
            cnt = pre["tt_cnt"]
            mx = col.row_max(torch.where(fits, cnt, 0), keepdim=True)
            s = torch.where(mx == 0, MAX_PRIORITY,
                            (MAX_PRIORITY * (mx - cnt)) // mx.clamp(min=1))
        elif name == "NodeAffinityPriority":
            cnt = pre["na_cnt"]
            mx = col.row_max(torch.where(fits, cnt, 0), keepdim=True)
            s = torch.where(mx > 0, (MAX_PRIORITY * cnt) // mx.clamp(min=1),
                            0)
        else:  # static priorities are in pre["static_score"]
            continue
        total = total + s * weight
    return total


def _class_capacity(cls: Arrays, nodes: Arrays, state: NodeState
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wave's capacity step against the frozen state, one launch of the
    capacity kernel on the card (ops/kernels.capacity_headroom): the
    resources-fit mask [C,N] (PodFitsResources minus the pod-count check,
    zero-request override in; _dynamic_fits ANDs it) and cap[C,N], how
    many MORE pods of class c fit on node n, by exact integer division per
    resource column (the resources_fit semantics, overlay->scratch
    fallback and zero-request early exit included) plus the
    allowed-pod-number ceiling (kernels.class_capacity_plain)."""
    return kernels.capacity_headroom(
        cls["req"], cls["zero_req"], nodes["alloc"], state.requested,
        state.pod_count, nodes["allowed_pods"])


# per-wave per-node acceptance window; bounds rank*request products so all
# acceptance math stays exact in int32
K_WAVE = 4096


def _dyn_at(total_cpu, total_mem, cap_cpu, cap_mem,
            priorities: Tuple[Tuple[str, int], ...]) -> torch.Tensor:
    """Utilization-dependent priority sum for per-row totals (any shape).
    Mirrors least_requested/most_requested/balanced_allocation exactly."""
    out = torch.zeros_like(total_cpu)
    for name, weight in priorities:
        if name == "LeastRequestedPriority":
            s = (prio._unused_score(total_cpu, cap_cpu)
                 + prio._unused_score(total_mem, cap_mem)) // 2
        elif name == "MostRequestedPriority":
            s = (prio._used_score(total_cpu, cap_cpu)
                 + prio._used_score(total_mem, cap_mem)) // 2
        elif name == "BalancedResourceAllocation":
            s = prio._balanced_score(total_cpu, total_mem, cap_cpu, cap_mem)
        else:
            continue
        out = out + s * weight
    return out


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """jax.ops.segment_sum(vals, seg, n + 1)[:n]: rows at index n drop."""
    out = torch.zeros((n + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    out.index_add_(0, seg, vals)
    return out[:n]


def _wave_aff_mask(aff: Arrays, committed: torch.Tensor) -> torch.Tensor:
    """Per-wave required-anti-affinity mask [C, N] from the PER-NODE
    occupancy carry. Wave-eligible anti classes have singleton topology
    domains (AffinityData.wave_strict routes everything else to the seeded
    strict tail), so domain occupancy IS per-node occupancy and the mask
    never touches the label axis. A node n is forbidden for class c when it
    carries (a) a static forbid (existing pods' matching anti terms,
    precomputed [C, N] at encoding build), (b) a committed pod matching one
    of c's own required anti terms whose key n has, or (c) a committed pod
    of class d whose anti term matches c (the symmetry direction,
    predicates.go:1146) under a key n has. key_node[c, a, n] = node n has
    term (c, a)'s topology key.

    Both contractions run through int_matmul, exact here: their sums range
    over the pods on ONE node (committed[:, n] sums to at most the node's
    allowed pods, 110 on the hollow nodes), times at most the A anti slots
    for the symmetry sum — far below 2^24."""
    m_anti = aff["m_anti"].to(I32)                     # [C, A, C]
    kn = aff["key_node"].to(I32)                       # [C, A, N]
    c, a, _ = m_anti.shape
    n = committed.shape[1]
    m2 = m_anti.reshape(c * a, c)
    # own anti: committed pods matching (c, a) resident on n, key present
    occ = int_matmul(m2, committed.T).reshape(c, a, n)
    own = (occ * kn).sum(dim=1, dtype=I32)             # [C, N]
    # symmetry: committed pods of class d at n whose term a matches c
    kc = (kn * committed[:, None, :]).reshape(c * a, n)
    sym = int_matmul(m2.T, kc.T)                       # [C, N]
    forb = own + sym + aff["static_forbid"].to(I32)
    return forb == 0


def _pick(fits: torch.Tensor, scores: torch.Tensor, pod_class: torch.Tensor,
          active: torch.Tensor, counter: torch.Tensor, col):
    """Tie sets and the FIFO draws of one wave (or tail round): returns
    (masked [C,N], ties [C,N], fit_count [P], selected [P] (-1 = none;
    GLOBAL node ids whichever `col` runs), new counter)."""
    pcl = pod_class.long()
    fitcnt = col.row_sum(fits)                          # [C]
    masked = torch.where(fits, scores, -1)
    best = col.row_max(masked, keepdim=True)
    ties = (masked == best) & fits                      # [C,N]
    m = col.row_sum(ties)                               # [C] global count
    fc = fitcnt[pcl]                                    # [P]
    # FIFO draw from the shared RR counter (selectHost counter discipline)
    multi = (active & (fc > 1)).to(I32)
    draw = counter_as_i32(counter) + torch.cumsum(multi, 0, dtype=I32) \
        - multi
    mz = m[pcl].clamp(min=1)
    kz = draw % mz
    # the winner reduce: kz-th tie of each pod's class, ascending node
    # order (local rank + cross-shard prefix under _ShardCol)
    sel_multi = col.tie_select(ties, pod_class, kz)
    sel_single = col.first_fit(fits)[pcl]
    sel = torch.where(~active | (fc == 0), -1,
                      torch.where(fc == 1, sel_single, sel_multi))
    new_counter = (counter + multi.sum(dtype=torch.int64)) & U32_MASK
    return masked, ties, fc, sel, new_counter


def _special_classes(cls: Arrays) -> torch.Tensor:
    """Classes with host ports or volumes: at most one commit per node per
    wave (their within-wave interactions are not modeled)."""
    return ((cls["ports"][:, 0] >= 0)
            | (cls["vol_hard"].sum(dim=1, dtype=I32)
               + cls["vol_ro"].sum(dim=1, dtype=I32)
               + cls["pd_req"].sum(dim=1, dtype=I32) > 0))


def _accept(cls: Arrays, nodes: Arrays, state: NodeState, cap: torch.Tensor,
            masked: torch.Tensor, ties: torch.Tensor, sel: torch.Tensor,
            pod_class: torch.Tensor, special_cls: torch.Tensor,
            priorities: Tuple[Tuple[str, int], ...], col):
    """Per-node FIFO conflict resolution: pods that picked the same node
    are ordered FIFO; the longest prefix run of same-class pods that still
    fits (exact integer capacity) and keeps the node's score at or above
    the frozen runner-up commits. Returns (order [P], s_sel, s_class,
    safe_sel, special, acc_s) in node-sorted order."""
    P = pod_class.shape[0]
    dev = pod_class.device
    iota = torch.arange(P, dtype=I32, device=dev)
    placeable = sel >= 0
    key = torch.where(placeable, sel, col.n_global).to(torch.int64) * P \
        + iota
    order = torch.argsort(key, stable=True)
    s_sel = sel[order]
    s_class = pod_class[order].long()
    s_place = placeable[order]
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           s_sel[1:] != s_sel[:-1]])
    bs = torch.cummax(torch.where(seg_start, iota, 0), dim=0).values.long()
    rank_in_seg = iota - bs.to(I32)
    first_class = s_class[bs]
    same_run = torch.cumsum((s_class != first_class).to(I32), 0, dtype=I32)
    same_run = (same_run - same_run[bs]) == 0
    safe_sel = s_sel.clamp(min=0).long()
    cap_lim = col.take2(cap, s_class, safe_sel).clamp(max=K_WAVE)
    special = special_cls[s_class]
    thr = col.row_max(torch.where(ties, -1, masked))    # [C]
    r_eff = torch.minimum(rank_in_seg, cap_lim)
    nz_z = cls["nonzero"][s_class]                      # [P,2]
    nz_node = col.take_rows(state.nonzero, safe_sel)
    alloc_rows = col.take_rows(nodes["alloc"], safe_sel)
    tot0 = nz_node + nz_z
    tot_r = nz_node + (r_eff[:, None] + 1) * nz_z
    dyn0 = _dyn_at(tot0[:, 0], tot0[:, 1], alloc_rows[:, 0],
                   alloc_rows[:, 1], priorities)
    dyn_r = _dyn_at(tot_r[:, 0], tot_r[:, 1], alloc_rows[:, 0],
                    alloc_rows[:, 1], priorities)
    score_r = col.take2(masked, s_class, safe_sel) - dyn0 + dyn_r
    acc_core = (s_place & same_run & (rank_in_seg < cap_lim)
                & (~special | (rank_in_seg == 0))
                & ((rank_in_seg == 0) | (score_r >= thr[s_class])))
    # prefix closure: rank r commits only if ranks 0..r-1 all did
    fail = (~acc_core).to(I32)
    pre_fail = torch.cumsum(fail, 0, dtype=I32) - fail
    acc_s = acc_core & ((pre_fail - pre_fail[bs]) == 0)
    return order, s_sel, s_class, safe_sel, special, acc_s


def _commit(cls: Arrays, nodes: Arrays, state: NodeState,
            s_sel: torch.Tensor, s_class: torch.Tensor,
            acc_s: torch.Tensor, special: torch.Tensor, col) -> NodeState:
    """Batched AssumePod of the accepted rows (node-sorted order);
    `special` marks the rows of port/volume classes. Scatter ids translate
    to LOCAL rows under _ShardCol: each accepted row lands on exactly the
    shard owning its node."""
    nl = col.n_local
    seg_ids = col.to_local(torch.where(acc_s, s_sel, -1)).long()
    gain = acc_s.to(I32)
    requested = state.requested + _segment_sum(
        cls["req"][s_class] * gain[:, None], seg_ids, nl)
    nonzero = state.nonzero + _segment_sum(
        cls["nonzero"][s_class] * gain[:, None], seg_ids, nl)
    pod_count = state.pod_count + _segment_sum(gain, seg_ids, nl)
    # specials: at most one accepted per node per wave, so their rows are
    # distinct and the scatters below touch each node once
    sp_loc = col.to_local(torch.where(acc_s & special, s_sel, -1))
    own = sp_loc < nl
    sp_rows = sp_loc[own].long()
    ports = cls["ports"][s_class][own]                  # [k,8]
    want = ports >= 0
    wsafe = ports.clamp(min=0)
    w = state.port_bitmap.shape[1]
    words = (wsafe // 32).long()
    bits = torch.where(want, torch.ones_like(wsafe) << (wsafe % 32), 0)
    keep = want & (words < w)
    flat = state.port_bitmap.reshape(-1).clone()
    flat.index_add_(0, (sp_rows[:, None] * w + words)[keep], bits[keep])
    port_bitmap = flat.reshape(state.port_bitmap.shape)
    vh = cls["vol_hard"][s_class][own]
    vr = cls["vol_ro"][s_class][own]
    pdq = cls["pd_req"][s_class][own]
    vol_present = state.vol_present.clone()
    vol_present[sp_rows] = torch.maximum(vol_present[sp_rows], vh | vr)
    vol_rw = state.vol_rw.clone()
    vol_rw[sp_rows] = torch.maximum(vol_rw[sp_rows], vh)
    pd_present = state.pd_present.clone()
    pd_present[sp_rows] = torch.maximum(pd_present[sp_rows], pdq)
    # distinct new PD ids the pod brings to its node, per kind
    pd_new = []
    for k in range(3):
        req_k = (pdq * nodes["pd_kind"][k][None, :]).to(I32)
        overlap = (req_k * state.pd_present[sp_rows].to(I32)).sum(
            dim=1, dtype=I32)
        pd_new.append(cls["pd_req_count"][s_class][own][:, k] - overlap)
    pd_counts = state.pd_counts.clone()
    pd_counts[sp_rows] += torch.stack(pd_new, dim=1)
    return NodeState(requested, nonzero, pod_count, port_bitmap,
                     vol_present, vol_rw, pd_present, pd_counts)


def _wave_once(cls: Arrays, nodes: Arrays, state: NodeState, pre: Arrays,
               pod_class: torch.Tensor, active: torch.Tensor,
               counter: torch.Tensor,
               priorities: Tuple[Tuple[str, int], ...],
               aff: Arrays = None, committed: torch.Tensor = None,
               col=None):
    """One wave. With `aff` given, the required-anti mask is re-evaluated
    against the per-node occupancy carry `committed` [C, N] and commits
    update it (the on-device topology AssumePod). `col` is the node-axis
    vtable (_GlobalCol by default). Returns (selected [P] (-1 = no fit,
    else a GLOBAL node index), accepted [P] bool, fit_count [P] int32, new
    state, new counter, new committed (None without `aff`))."""
    P = pod_class.shape[0]
    if col is None:
        col = _GlobalCol(nodes["alloc"].shape[0])
    res_fit, cap = _class_capacity(cls, nodes, state)   # [C,N] each
    fits = pre["static_fit"] & preds.node_condition_fit(cls, nodes) \
        & _dynamic_fits(cls, nodes, state, res_fit)     # [C,N]
    if aff is not None:
        fits = fits & _wave_aff_mask(aff, committed)
    scores = _wave_scores(cls, nodes, state, pre, fits, priorities, col)
    masked, ties, fc, sel, new_counter = _pick(fits, scores, pod_class,
                                               active, counter, col)
    special_cls = _special_classes(cls)
    if aff is not None:
        # self-anti classes commit at most one pod per node per wave: the
        # second pod of the same FIFO run would land in a domain its first
        # just made forbidden (AffinityData.wave_gate)
        special_cls = special_cls | aff["wave_gate"]
    order, s_sel, s_class, safe_sel, special, acc_s = _accept(
        cls, nodes, state, cap, masked, ties, sel, pod_class, special_cls,
        priorities, col)
    accepted = torch.zeros(P, dtype=torch.bool, device=pod_class.device)
    accepted[order] = acc_s
    new_state = _commit(cls, nodes, state, s_sel, s_class, acc_s, special,
                        col)
    if aff is not None:
        # topology-occupancy commit: each accepted pod ticks its (class,
        # node) cell on the shard owning the node, visible to the NEXT
        # wave's mask (and to the seeded strict tail / harvest fence)
        loc = col.to_local(torch.where(acc_s, s_sel, -1))
        keep = loc < col.n_local
        committed = committed.index_put(
            (s_class[keep], loc[keep].long()), torch.ones_like(loc[keep]),
            accumulate=True)
    return sel, accepted, fc, new_state, new_counter, committed


def _waves_loop_inner(cls, nodes, state, pod_class, counter, pre,
                      committed, active, aff, priorities, max_waves, col):
    """The wave iteration proper, shared by the single-device path and
    every shard of the SPMD path (the `col` vtable is the only
    difference). Returns (packed, state, committed)."""
    P = pod_class.shape[0]
    dev = pod_class.device
    fsel = torch.full((P,), -1, dtype=I32, device=dev)
    ffc = torch.zeros(P, dtype=I32, device=dev)
    w = 0
    while w < max_waves and bool(active.any()):
        sel, accepted, fc, state, counter, committed = _wave_once(
            cls, nodes, state, pre, pod_class, active, counter, priorities,
            aff=aff, committed=committed, col=col)
        fsel = torch.where(active & accepted, sel, fsel)
        ffc = torch.where(active, fc, ffc)
        active = active & ~accepted & (sel >= 0)
        w += 1
    packed = torch.cat([fsel, ffc, active.to(I32),
                        counter_as_i32(counter).reshape(1),
                        torch.full((1,), w, dtype=I32, device=dev)])
    return packed, state, committed


def waves_loop(cls: Arrays, nodes: Arrays, state: NodeState,
               pod_class: torch.Tensor, counter: torch.Tensor,
               priorities: Tuple[Tuple[str, int], ...],
               max_waves: int = 32, extra_score: torch.Tensor = None,
               aff: Arrays = None, committed0: torch.Tensor = None,
               active0: torch.Tensor = None, pre: Arrays = None,
               spmd_mesh=None):
    """Iterate waves until no pod is active or max_waves ran. One host
    check (``active.any()``) per wave.

    With `aff`: committed0 seeds the [C, N] per-node topology occupancy
    carry (the engine's cumulative fence-accepted commits, so earlier
    chunks' placements are visible) and the per-wave mask + occupancy
    commit run inside the loop; active0 masks out pods routed to the
    seeded strict tail (AffinityData.wave_strict) — they exit with
    selected = -1 and still_active = 0 and the harvest places them.
    `extra_score` [C, N] adds the batch-frozen spread/interpod scores.

    With `spmd_mesh` (a parallel/mesh.Mesh; also taken from mesh-placed
    operands when None), the WHOLE loop runs once per shard
    (_waves_loop_spmd): every node-axis tensor stays on its shard, the
    winner selection is _ShardCol's two-stage reduce, and commits write
    exactly the shard owning each node. Placements are bit-identical to
    the single-device run.

    Returns (packed, final state[, committed]) with packed = int32
    [selected(P), fit_count(P), still_active(P), counter, waves_used]
    (the counter's uint32 bits read as int32, as the reference packs it);
    still_active pods exhausted max_waves (the caller finishes them with
    the strict loop). The trailing occupancy is returned only when `aff`
    is given. Under a mesh the state and the occupancy come back as
    ShardedTensors."""
    P = pod_class.shape[0]
    if active0 is None:
        active0 = torch.ones(P, dtype=torch.bool, device=pod_class.device)
    committed = committed0 if aff is not None else None
    mesh = spmd_mesh if spmd_mesh is not None else mesh_mod.mesh_of(
        cls, nodes, state, pre, extra_score, aff, committed)
    if mesh is not None:
        packed, state, committed = _waves_loop_spmd(
            cls, nodes, state, pod_class, counter, pre, extra_score,
            committed, active0, aff, priorities, max_waves, mesh)
    else:
        if pre is None:
            pre = precompute(cls, nodes, priorities)
        if extra_score is not None:  # batch-frozen spread/interpod scores
            pre = dict(pre, static_score=pre["static_score"] + extra_score)
        if committed is not None:
            committed = committed.to(I32)
        packed, state, committed = _waves_loop_inner(
            cls, nodes, state, pod_class, counter, pre, committed, active0,
            aff, priorities, max_waves, _GlobalCol(nodes["alloc"].shape[0]))
    if aff is None:
        return packed, state
    return packed, state, committed


def _waves_loop_spmd(cls, nodes, state, pod_class, counter, pre,
                     extra_score, committed, active, aff, priorities,
                     max_waves, mesh):
    """waves_loop on a mesh: node-axis operands enter placed by the shared
    spec tables (a plain tensor is split here, as shard_map's in_specs
    would), pod-side operands replicated, and _waves_loop_inner runs once
    per shard with _ShardCol supplying the cross-shard stages. Returns
    shard 0's packed result (every shard's is the same: it is built from
    combined values only), the state sharded on axis 0 and the occupancy
    on axis 1."""
    n_global = int(nodes["alloc"].shape[0])
    n_local = n_global // mesh.size
    cls = mesh_mod.shard_classes(cls, mesh)
    nodes = mesh_mod.shard_nodes(nodes, mesh)
    state = mesh_mod.place_tree(state, mesh, 0)
    if pre is not None:
        pre = mesh_mod.place_tree(pre, mesh, 1)
    if extra_score is not None:
        extra_score = mesh_mod.place(extra_score, mesh, 1)
    if aff is not None:
        aff = mesh_mod.shard_affinity(aff, mesh)
        committed = mesh_mod.place(committed, mesh,
                                   mesh_mod.committed_spec())

    def shard(d, group):
        def loc(t):
            return mesh_mod.local_tree(t, d, mesh)
        cls_d = mesh_mod.local_classes(cls, d, mesh, n_local)
        nodes_d = loc(nodes)
        pre_d = loc(pre) if pre is not None \
            else precompute(cls_d, nodes_d, priorities)
        if extra_score is not None:
            pre_d = dict(pre_d, static_score=pre_d["static_score"]
                         + loc(extra_score))
        comm_d = loc(committed).to(I32) if aff is not None else None
        return _waves_loop_inner(
            cls_d, nodes_d, loc(state), loc(pod_class), loc(counter), pre_d,
            comm_d, loc(active), loc(aff), priorities, max_waves,
            _ShardCol(group, d, n_global, n_local))

    outs = mesh_mod.run_spmd(mesh, shard)
    state = NodeState(*(mesh_mod.ShardedTensor(mesh, [o[1][i] for o in outs],
                                               0)
                        for i in range(len(NodeState._fields))))
    committed = mesh_mod.ShardedTensor(mesh, [o[2] for o in outs], 1) \
        if aff is not None else None
    return outs[0][0], state, committed


def frozen_affinity_scores(cls: Arrays, nodes: Arrays, state: NodeState,
                           aff: Arrays, weights: Tuple[int, int]
                           ) -> torch.Tensor:
    """SelectorSpread / InterPodAffinity scores [C, N] against the
    batch-frozen cluster state, for the wave engine's additive static score
    (weights = (w_interpod, w_spread)). Wave semantics score these once per
    BATCH, not per wave — within-batch drift of preferred-affinity/spread
    counts is the reference's documented wave-mode approximation; only the
    REQUIRED fit side is re-evaluated per wave. The fit mask takes one
    capacity-kernel launch (predicates.resources_fit); the interpod counts
    take the stacked static incidence product (affinity.precompute_static,
    the incidence kernel on the card), over `labels_aff` when the caller's
    aff arrays are sliced to a projected domain axis.

    Mesh-placed inputs run once per shard (mesh.run_spmd) at [C, N/D]:
    the products are elementwise over N (N is an output axis of the
    incidence product), and the normalizations' node-axis maxima, minima
    and zone sums combine across the shards. The result is then sharded
    on axis 1."""
    mesh = mesh_mod.mesh_of(cls, nodes, state, aff)
    if mesh is None:
        return _frozen_scores(cls, nodes, state, aff, weights, None)
    cls = mesh_mod.shard_classes(cls, mesh)
    nodes = mesh_mod.shard_nodes(nodes, mesh)
    state = mesh_mod.place_tree(state, mesh, 0)
    aff = mesh_mod.shard_affinity(aff, mesh)
    n_global = int(nodes["alloc"].shape[0])

    def shard(d, group):
        def loc(t):
            return mesh_mod.local_tree(t, d, mesh)
        n_local = n_global // mesh.size
        return _frozen_scores(
            mesh_mod.local_classes(cls, d, mesh, n_local), loc(nodes),
            loc(state), loc(aff), weights,
            _ShardCol(group, d, n_global, n_local))
    return mesh_mod.ShardedTensor(mesh, mesh_mod.run_spmd(mesh, shard), 1)


def _frozen_scores(cls, nodes, state, aff, weights, col) -> torch.Tensor:
    """frozen_affinity_scores on one device or one shard (`col` a
    _ShardCol, or None for the whole node axis)."""
    w_ip, w_sp = weights
    res_fit = preds.resources_fit(cls["req"], cls["zero_req"],
                                  nodes["alloc"], state.requested)
    fits = preds.static_fits(cls, nodes) \
        & preds.node_condition_fit(cls, nodes) \
        & _dynamic_fits(cls, nodes, state, res_fit)
    extra = torch.zeros(fits.shape, dtype=I32, device=fits.device)
    if w_ip:
        lab = aff["labels_aff"] if "labels_aff" in aff else nodes["labels"]
        pre = aff_ops.precompute_static(aff, lab)
        extra = extra + w_ip * aff_ops.interpod_score(pre["prio_counts"],
                                                      fits, col)
    if w_sp:
        extra = extra + w_sp * aff_ops.spread_score(
            aff, aff["sp_has"], aff["sp_static"], fits, col)
    return extra


def tail_rounds_loop(cls: Arrays, nodes: Arrays, state: NodeState,
                     pod_class: torch.Tensor, counter: torch.Tensor,
                     priorities: Tuple[Tuple[str, int], ...],
                     aff: Arrays = None,
                     aff_mode: Tuple[bool, bool, bool] = (False, False,
                                                          False),
                     aff_init=None, pre: Arrays = None):
    """The seeded strict tail as CONFLICT ROUNDS: sequential depth is the
    number of rounds, not the number of tail pods, with required-
    (anti-)affinity semantics exact at every commit. Each round

      1. re-evaluates the REQUIRED mask for every class against the
         cumulative occupancy carry (affinity.step_fits_all over the
         projected domain columns), plus exact capacity predicates and
         scores;
      2. places every still-active pod wave-style (FIFO prefix RR draws,
         per-node FIFO conflict resolution, the score-aware window);
      3. gates the commits the round-start mask cannot see: a class still
         BOOTSTRAPPING an allow-side group commits at most ONE pod per
         round, and classes coupled through any required ANTI term commit
         at most one pod per round ACROSS the whole coupled pool;
      4. retires placed pods; fit_count==0 pods stay active while any
         commit lands and retire as unschedulable the first round nothing
         commits, which is also the loop exit.

    The reference runs this as one lax.while_loop; here it is a Python
    loop with one host check (``active.any()``) per round. Spread scoring
    is not modeled (the harvest tail never runs it). `aff_init` =
    (commdom, committed, comm_cnt) seeds the occupancy, with commdom and
    comm_cnt derivable from committed (batch.seed_occupancy).

    Mesh-placed inputs run the rounds once per shard (_tail_rounds_spmd),
    as the reference's sharded loop does: the wave-style selection takes
    its _ShardCol forms, the commits land on the shards owning the nodes,
    and the state comes back sharded on axis 0.

    Returns (packed, final NodeState) with packed = int32 [selected(P),
    fit_count(P), counter, rounds_used]."""
    fits_on, prio_on, spread_on = aff_mode
    if spread_on:
        raise ValueError("tail_rounds_loop does not model spread scoring "
                         "(the harvest tail runs with spread off)")
    check_affinity_priorities(priorities, aff, None)
    mesh = mesh_mod.mesh_of(cls, nodes, state, aff, aff_init, pre)
    if mesh is not None:
        return _tail_rounds_spmd(cls, nodes, state, pod_class, counter,
                                 priorities, aff, aff_mode, aff_init, pre,
                                 mesh)
    if pre is None:
        pre = precompute(cls, nodes, priorities)
    return _tail_rounds_inner(cls, nodes, state, pod_class, counter,
                              priorities, aff, aff_mode, aff_init, pre,
                              _GlobalCol(nodes["alloc"].shape[0]))


def _tail_rounds_spmd(cls, nodes, state, pod_class, counter, priorities,
                      aff, aff_mode, aff_init, pre, mesh):
    """tail_rounds_loop on a mesh, built like _waves_loop_spmd: node-axis
    operands placed by the shared spec tables, pod-side ones replicated,
    _tail_rounds_inner once per shard. Returns shard 0's packed result
    (built from combined values only, so every shard's is the same) and
    the state sharded on axis 0."""
    n_global = int(nodes["alloc"].shape[0])
    n_local = n_global // mesh.size
    cls = mesh_mod.shard_classes(cls, mesh)
    nodes = mesh_mod.shard_nodes(nodes, mesh)
    state = mesh_mod.place_tree(state, mesh, 0)
    if pre is not None:
        pre = mesh_mod.place_tree(pre, mesh, 1)
    if aff is not None:
        aff = mesh_mod.shard_affinity(aff, mesh)
    if aff_init is not None:
        commdom, committed, comm_cnt = aff_init
        aff_init = (commdom, mesh_mod.place(committed, mesh,
                                            mesh_mod.committed_spec()),
                    comm_cnt)

    def shard(d, group):
        def loc(t):
            return mesh_mod.local_tree(t, d, mesh)
        cls_d = mesh_mod.local_classes(cls, d, mesh, n_local)
        nodes_d = loc(nodes)
        pre_d = loc(pre) if pre is not None \
            else precompute(cls_d, nodes_d, priorities)
        return _tail_rounds_inner(
            cls_d, nodes_d, loc(state), loc(pod_class), loc(counter),
            priorities, loc(aff), aff_mode, loc(aff_init), pre_d,
            _ShardCol(group, d, n_global, n_local))

    outs = mesh_mod.run_spmd(mesh, shard)
    state = NodeState(*(mesh_mod.ShardedTensor(mesh, [o[1][i] for o in outs],
                                               0)
                        for i in range(len(NodeState._fields))))
    return outs[0][0], state


def _tail_rounds_inner(cls, nodes, state, pod_class, counter, priorities,
                       aff, aff_mode, aff_init, pre, col):
    """The rounds proper, shared by the single-device path and every shard
    of the SPMD path (the `col` vtable is the only difference)."""
    fits_on, prio_on, _spread_on = aff_mode
    any_aff = aff is not None and (fits_on or prio_on)
    P = pod_class.shape[0]
    C = cls["req"].shape[0]
    dev = pod_class.device
    pcl = pod_class.long()
    iota = torch.arange(P, dtype=torch.int64, device=dev)
    w_ip = sum(w for nm, w in priorities
               if nm == "InterPodAffinityPriority") if prio_on else 0
    if any_aff:
        labels = aff["labels_aff"] if "labels_aff" in aff \
            else nodes["labels"]
        pre_aff = aff_ops.precompute_static(aff, labels)
        if aff_init is not None:
            commdom, _committed, comm_cnt = seed_occupancy(aff_init, labels,
                                                           col)
        else:
            commdom = torch.zeros((C, labels.shape[1]), dtype=I32,
                                  device=dev)
            comm_cnt = torch.zeros(C, dtype=I32, device=dev)
        # anti-coupled pool: classes in ANY required anti relation, as
        # matching target or term owner — their commits can shrink a
        # same-round mask, so the pool shares one commit quota
        m_anti_b = aff["m_anti"].bool()
        anti_pool = m_anti_b.any(dim=2).any(dim=1) \
            | m_anti_b.any(dim=1).any(dim=0)
        boot_candidate = aff["aff_active"] & ~aff["aff_has_static"]
        m_aff = aff["m_aff"].to(I32)
    special_cls = _special_classes(cls)
    active = torch.ones(P, dtype=torch.bool, device=dev)
    fsel = torch.full((P,), -1, dtype=I32, device=dev)
    ffc = torch.zeros(P, dtype=I32, device=dev)
    w = 0
    while w <= P and bool(active.any()):
        # ---- exact round-start evaluation, class-level [C, N] -----------
        res_fit, cap = _class_capacity(cls, nodes, state)
        fits_c = pre["static_fit"] & preds.node_condition_fit(cls, nodes) \
            & _dynamic_fits(cls, nodes, state, res_fit)
        if fits_on:
            fits_c = fits_c & aff_ops.step_fits_all(aff, pre_aff, commdom,
                                                    comm_cnt, labels)
        scores_c = _wave_scores(cls, nodes, state, pre, fits_c, priorities,
                                col)
        if prio_on:
            cnt = aff_ops.step_prio_counts_all(aff, pre_aff, commdom,
                                               labels)
            scores_c = scores_c + w_ip * aff_ops.interpod_score(cnt, fits_c,
                                                                col)
        # ---- wave-style selection and conflict resolution ---------------
        masked, ties, fc, sel, new_counter = _pick(fits_c, scores_c,
                                                   pod_class, active,
                                                   counter, col)
        order, s_sel, s_class, _safe, special, acc_s = _accept(
            cls, nodes, state, cap, masked, ties, sel, pod_class,
            special_cls, priorities, col)
        accepted = torch.zeros(P, dtype=torch.bool, device=dev)
        accepted[order] = acc_s
        # ---- the round gates (step 3 of the docstring) ------------------
        if any_aff:
            # boot_pending[c]: some active allow term has neither a static
            # nor a committed match — this round's commit IS the group's
            # domain choice, so it must be singular
            dyn_total = (m_aff * comm_cnt[None, None, :]).sum(dim=2,
                                                              dtype=I32)
            boot_pending = (boot_candidate & (dyn_total == 0)).any(dim=1)
            # quota group per class: bootstrapping classes serialize
            # individually (group id = class index); the anti-coupled pool
            # shares ONE group (id = C); everyone else is unquota'd
            cidx = torch.arange(C, dtype=I32, device=dev)
            qgroup = torch.where(anti_pool, C,
                                 torch.where(boot_pending, cidx, -1))
            g = qgroup[pcl]                                   # [P]
            member = accepted & (g >= 0)
            oh = member[:, None] & (
                g[:, None] == torch.arange(C + 1, dtype=I32,
                                           device=dev)[None, :])
            rank_in_group = torch.cumsum(oh.to(I32), 0, dtype=I32) \
                - oh.to(I32)
            keep = ~member | (rank_in_group[iota, g.clamp(min=0).long()]
                              == 0)
            accepted = accepted & keep
            acc_s = accepted[order]
        # ---- commit (batched AssumePod, dropped pods stay active) -------
        state = _commit(cls, nodes, state, s_sel, s_class, acc_s, special,
                        col)
        gain_p = accepted.to(I32)
        if any_aff:
            # occupancy carry: committed pods become visible to the NEXT
            # round's exact mask; each node's domain row comes from the
            # shard owning it
            rows = col.take_rows(labels, sel.clamp(min=0).long())
            commdom = commdom.index_add(0, pcl,
                                        rows.to(I32) * gain_p[:, None])
            comm_cnt = comm_cnt.index_add(0, pcl, gain_p)
        # ---- retire: placed pods always; fit_count==0 pods only once a
        # round commits nothing (an allow-side commit may still widen
        # their mask) — which is also the loop's natural exit
        none_committed = ~accepted.any()
        retire_unsched = active & (fc == 0) & none_committed
        done = accepted | retire_unsched
        fsel = torch.where(accepted, sel, fsel)
        ffc = torch.where(done, fc, ffc)
        active = active & ~done
        counter = new_counter
        w += 1
    packed = torch.cat([fsel, ffc, counter_as_i32(counter).reshape(1),
                        torch.full((1,), w, dtype=I32, device=dev)])
    return packed, state


def place_waves(cls: Arrays, nodes: Arrays, state: NodeState,
                pod_class: np.ndarray, counter: int,
                priorities: Tuple[Tuple[str, int], ...],
                max_waves: int = 64, stats: dict = None,
                extra_score: torch.Tensor = None, aff: Arrays = None,
                aff_mode: Tuple[bool, bool, bool] = (False, False, False)):
    """Run waves until every pod is placed or proven unplaceable. Returns
    (selected [P] int32 node index or -1, fit_count [P], final NodeState,
    final counter). Pods still active after max_waves are finished by the
    strict loop (engine/batch.py), which alone reads `aff`/`aff_mode`;
    `extra_score` [C, N] is the batch-frozen spread/interpod score of both.
    ``stats``, when given, receives the wave count and the straggler
    count. Mesh-placed node inputs run the waves as waves_loop's SPMD
    path and come back sharded."""
    P = len(pod_class)
    dev = nodes["alloc"].device
    pc_d = tensor_from_numpy(np.asarray(pod_class, dtype=np.int32), dev)
    c0 = torch.tensor(counter & U32_MASK, dtype=torch.int64, device=dev)
    packed, state = waves_loop(cls, nodes, state, pc_d, c0, priorities,
                               max_waves, extra_score)
    packed_h = packed.cpu().numpy()
    final_sel = packed_h[:P].copy()
    final_fc = packed_h[P:2 * P].copy()
    act_h = packed_h[2 * P:3 * P].astype(bool)
    counter_h = int(packed_h[3 * P]) & U32_MASK
    n_strag = int(act_h.sum())
    if stats is not None:
        stats["waves"] = int(packed_h[3 * P + 1])
        stats["stragglers"] = n_strag
    if n_strag:
        idx = np.nonzero(act_h)[0]
        # the stragglers alone: the scan steps only live rows
        pc = np.asarray(pod_class, dtype=np.int32)[idx]
        # the affinity class data rides along so priorities holding
        # SelectorSpread/InterPodAffinity pass place_batch's guard when
        # extra_score is None (fits-only affinity batches)
        sel, fcs, state, ctr = gather_place_batch(
            cls, tensor_from_numpy(pc, dev), nodes, state,
            torch.tensor(counter_h, dtype=torch.int64, device=dev),
            priorities, aff=aff, aff_mode=aff_mode, extra_score=extra_score)
        final_sel[idx] = sel.cpu().numpy()
        final_fc[idx] = fcs.cpu().numpy()
        counter_h = int(ctr)
    return final_sel, final_fc, state, counter_h
