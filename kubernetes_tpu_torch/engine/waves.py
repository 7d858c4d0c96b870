"""Wave-parallel batch placement: the whole queue in a handful of passes.

PyTorch port of kubernetes_tpu/engine/waves.py on one device (the
reference's single-device column ops, _GlobalCol; no mesh). The wave
semantics are the reference's, unchanged:

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

The reference iterates waves in a lax.while_loop on the device; here the
loop is Python with one ``active.any()`` host check per wave (typically
1-3 waves). Inputs are CLASS-level arrays; fits/scores are [C, N].

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
from kubernetes_tpu_torch.engine.batch import (
    NodeState,
    U32_MASK,
    counter_as_i32,
    gather_place_batch,
)
from kubernetes_tpu_torch.ops import predicates as preds
from kubernetes_tpu_torch.ops import priorities as prio
from kubernetes_tpu_torch.ops.predicates import int_matmul
from kubernetes_tpu_torch.state.snapshot import (
    NUM_BASE_RESOURCES,
    R_OVERLAY,
    R_SCRATCH,
)

Arrays = Dict[str, torch.Tensor]

I32 = torch.int32
_BIG = 2 ** 31 - 1


def _dynamic_fits(cls: Arrays, nodes: Arrays, state: NodeState
                  ) -> torch.Tensor:
    """Capacity-dependent predicate chain vs the wave's frozen state, [C,N]
    — the capacity kernel (ops/kernels.capacity_fit) on the card."""
    return (
        preds.resources_fit(cls["req"], cls["zero_req"], nodes["alloc"],
                            state.requested)
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


def precompute(cls: Arrays, nodes: Arrays,
               priorities: Tuple[Tuple[str, int], ...]) -> Arrays:
    """Everything state-independent, computed once per batch outside the
    wave loop: the static predicate mask, the reduce-priority count
    matrices and the weighted sum of static priorities."""
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
                 priorities: Tuple[Tuple[str, int], ...]) -> torch.Tensor:
    """Weighted priority sum [C,N] against the frozen state."""
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
            mx = torch.where(fits, cnt, 0).amax(dim=1, keepdim=True)
            s = torch.where(mx == 0, MAX_PRIORITY,
                            (MAX_PRIORITY * (mx - cnt)) // mx.clamp(min=1))
        elif name == "NodeAffinityPriority":
            cnt = pre["na_cnt"]
            mx = torch.where(fits, cnt, 0).amax(dim=1, keepdim=True)
            s = torch.where(mx > 0, (MAX_PRIORITY * cnt) // mx.clamp(min=1),
                            0)
        else:  # static priorities are in pre["static_score"]
            continue
        total = total + s * weight
    return total


def _class_capacity(cls: Arrays, nodes: Arrays, state: NodeState
                    ) -> torch.Tensor:
    """cap[C,N]: how many MORE pods of class c fit on node n, by exact
    integer division per resource column (the resources_fit semantics,
    overlay->scratch fallback and zero-request early exit included) plus
    the allowed-pod-number ceiling."""
    alloc = nodes["alloc"]
    rem = alloc - state.requested                       # [N,R]
    req = cls["req"]                                    # [C,R]

    def col_cap(rem_col, req_col):                      # [N],[C] -> [C,N]
        r = req_col.clamp(min=1)[:, None]
        cap = rem_col.clamp(min=0)[None, :] // r
        return torch.where(req_col[:, None] > 0, cap, _BIG)

    plain_cols = [0, 1, 2] + list(range(NUM_BASE_RESOURCES, alloc.shape[1]))
    cap = torch.full((req.shape[0], alloc.shape[0]), _BIG, dtype=I32,
                     device=alloc.device)
    for col in plain_cols:
        cap = torch.minimum(cap, col_cap(rem[:, col], req[:, col]))
    no_ov = alloc[:, R_OVERLAY] == 0                    # [N]
    scr_rem = torch.where(no_ov,
                          alloc[:, R_SCRATCH] - state.requested[:, R_SCRATCH]
                          - state.requested[:, R_OVERLAY],
                          rem[:, R_SCRATCH])
    scr_add = torch.where(no_ov[None, :],
                          (req[:, R_SCRATCH] + req[:, R_OVERLAY])[:, None],
                          req[:, R_SCRATCH][:, None])   # [C,N]
    scr_cap = torch.where(scr_add > 0,
                          scr_rem.clamp(min=0)[None, :]
                          // scr_add.clamp(min=1), _BIG)
    cap = torch.minimum(cap, scr_cap)
    ov_cap = torch.where(no_ov[None, :], _BIG,
                         col_cap(rem[:, R_OVERLAY], req[:, R_OVERLAY]))
    cap = torch.minimum(cap, ov_cap)
    cap = torch.where(cls["zero_req"][:, None], _BIG, cap)
    count_cap = (nodes["allowed_pods"] - state.pod_count).clamp(min=0)
    return torch.minimum(cap, count_cap[None, :])


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


def _tie_select(ties: torch.Tensor, pod_class: torch.Tensor,
                kz: torch.Tensor) -> torch.Tensor:
    """Node index of the kz-th tie (ascending node order) of each pod's
    class — the RR fan-out lookup."""
    c, n = ties.shape
    idx_n = torch.arange(n, dtype=I32, device=ties.device)
    rank = torch.cumsum(ties.to(I32), dim=1, dtype=I32) - 1
    cols = torch.where(ties, rank, n).long()
    tiemat = torch.zeros((c, n + 1), dtype=I32, device=ties.device)
    tiemat.scatter_(1, cols, idx_n.expand(c, n).contiguous())
    return tiemat[pod_class, kz.long()]


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """jax.ops.segment_sum(vals, seg, n + 1)[:n]: rows at index n drop."""
    out = torch.zeros((n + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    out.index_add_(0, seg, vals)
    return out[:n]


def _wave_once(cls: Arrays, nodes: Arrays, state: NodeState, pre: Arrays,
               pod_class: torch.Tensor, active: torch.Tensor,
               counter: torch.Tensor,
               priorities: Tuple[Tuple[str, int], ...]):
    """One wave. Returns (selected [P] (-1 = no fit), accepted [P] bool,
    fit_count [P] int32, new state, new counter)."""
    P = pod_class.shape[0]
    n = nodes["alloc"].shape[0]
    dev = pod_class.device
    pcl = pod_class.long()
    iota = torch.arange(P, dtype=I32, device=dev)

    fits = pre["static_fit"] & preds.node_condition_fit(cls, nodes) \
        & _dynamic_fits(cls, nodes, state)              # [C,N]
    fitcnt = fits.sum(dim=1, dtype=I32)                 # [C]
    scores = _wave_scores(cls, nodes, state, pre, fits, priorities)
    masked = torch.where(fits, scores, -1)
    best = masked.amax(dim=1, keepdim=True)
    ties = (masked == best) & fits                      # [C,N]
    m = ties.sum(dim=1, dtype=I32)                      # [C]

    fc = fitcnt[pcl]                                    # [P]
    # FIFO draw from the shared RR counter (selectHost counter discipline)
    multi = (active & (fc > 1)).to(I32)
    draw = counter_as_i32(counter) + torch.cumsum(multi, 0, dtype=I32) \
        - multi
    mz = m[pcl].clamp(min=1)
    kz = draw % mz
    sel_multi = _tie_select(ties, pod_class, kz)
    sel_single = fits.to(torch.uint8).argmax(dim=1).to(I32)[pcl]
    sel = torch.where(~active | (fc == 0), -1,
                      torch.where(fc == 1, sel_single, sel_multi))
    new_counter = (counter + multi.sum(dtype=torch.int64)) & U32_MASK

    # ---- per-node FIFO conflict resolution --------------------------------
    placeable = sel >= 0
    key = torch.where(placeable, sel, n).to(torch.int64) * P + iota
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
    cap = _class_capacity(cls, nodes, state)            # [C,N]
    safe_sel = s_sel.clamp(min=0).long()
    cap_lim = cap[s_class, safe_sel].clamp(max=K_WAVE)
    special_cls = ((cls["ports"][:, 0] >= 0)
                   | (cls["vol_hard"].sum(dim=1, dtype=I32)
                      + cls["vol_ro"].sum(dim=1, dtype=I32)
                      + cls["pd_req"].sum(dim=1, dtype=I32) > 0))
    special = special_cls[s_class]
    thr = torch.where(ties, -1, masked).amax(dim=1)     # [C]
    r_eff = torch.minimum(rank_in_seg, cap_lim)
    nz_z = cls["nonzero"][s_class]                      # [P,2]
    nz_node = state.nonzero[safe_sel]
    alloc_rows = nodes["alloc"][safe_sel]
    tot0 = nz_node + nz_z
    tot_r = nz_node + (r_eff[:, None] + 1) * nz_z
    dyn0 = _dyn_at(tot0[:, 0], tot0[:, 1], alloc_rows[:, 0],
                   alloc_rows[:, 1], priorities)
    dyn_r = _dyn_at(tot_r[:, 0], tot_r[:, 1], alloc_rows[:, 0],
                    alloc_rows[:, 1], priorities)
    score_r = masked[s_class, safe_sel] - dyn0 + dyn_r
    acc_core = (s_place & same_run & (rank_in_seg < cap_lim)
                & (~special | (rank_in_seg == 0))
                & ((rank_in_seg == 0) | (score_r >= thr[s_class])))
    # prefix closure: rank r commits only if ranks 0..r-1 all did
    fail = (~acc_core).to(I32)
    pre_fail = torch.cumsum(fail, 0, dtype=I32) - fail
    acc_s = acc_core & ((pre_fail - pre_fail[bs]) == 0)
    accepted = torch.zeros(P, dtype=torch.bool, device=dev)
    accepted[order] = acc_s

    # ---- commit (batched AssumePod) ---------------------------------------
    seg_ids = torch.where(acc_s, s_sel, n).long()
    gain = acc_s.to(I32)
    requested = state.requested + _segment_sum(
        cls["req"][s_class] * gain[:, None], seg_ids, n)
    nonzero = state.nonzero + _segment_sum(
        cls["nonzero"][s_class] * gain[:, None], seg_ids, n)
    pod_count = state.pod_count + _segment_sum(gain, seg_ids, n)
    # specials: at most one accepted per node per wave, so their rows are
    # distinct and the scatters below touch each node once
    sp = acc_s & special
    sp_rows = safe_sel[sp]
    ports = cls["ports"][s_class][sp]                   # [k,8]
    want = ports >= 0
    wsafe = ports.clamp(min=0)
    w = state.port_bitmap.shape[1]
    words = (wsafe // 32).long()
    bits = torch.where(want, torch.ones_like(wsafe) << (wsafe % 32), 0)
    keep = want & (words < w)
    flat = state.port_bitmap.reshape(-1).clone()
    flat.index_add_(0, (sp_rows[:, None] * w + words)[keep], bits[keep])
    port_bitmap = flat.reshape(state.port_bitmap.shape)
    vh = cls["vol_hard"][s_class][sp]
    vr = cls["vol_ro"][s_class][sp]
    pdq = cls["pd_req"][s_class][sp]
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
        pd_new.append(cls["pd_req_count"][s_class][sp][:, k] - overlap)
    pd_counts = state.pd_counts.clone()
    pd_counts[sp_rows] += torch.stack(pd_new, dim=1)

    new_state = NodeState(requested, nonzero, pod_count, port_bitmap,
                          vol_present, vol_rw, pd_present, pd_counts)
    return sel, accepted, fc, new_state, new_counter


def waves_loop(cls: Arrays, nodes: Arrays, state: NodeState,
               pod_class: torch.Tensor, counter: torch.Tensor,
               priorities: Tuple[Tuple[str, int], ...],
               max_waves: int = 32, pre: Arrays = None):
    """Iterate waves until no pod is active or max_waves ran. One host
    check (``active.any()``) per wave.

    Returns (selected [P], fit_count [P], still_active [P] bool,
             counter (int64 scalar tensor), waves_used, final state);
    still_active pods exhausted max_waves (the caller finishes them with
    the strict loop)."""
    P = pod_class.shape[0]
    dev = pod_class.device
    if pre is None:
        pre = precompute(cls, nodes, priorities)
    active = torch.ones(P, dtype=torch.bool, device=dev)
    fsel = torch.full((P,), -1, dtype=I32, device=dev)
    ffc = torch.zeros(P, dtype=I32, device=dev)
    w = 0
    while w < max_waves and bool(active.any()):
        sel, accepted, fc, state, counter = _wave_once(
            cls, nodes, state, pre, pod_class, active, counter, priorities)
        fsel = torch.where(active & accepted, sel, fsel)
        ffc = torch.where(active, fc, ffc)
        active = active & ~accepted & (sel >= 0)
        w += 1
    return fsel, ffc, active, counter, w, state


def place_waves(cls: Arrays, nodes: Arrays, state: NodeState,
                pod_class: np.ndarray, counter: int,
                priorities: Tuple[Tuple[str, int], ...],
                max_waves: int = 64, stats: dict = None):
    """Run waves until every pod is placed or proven unplaceable. Returns
    (selected [P] int32 node index or -1, fit_count [P], final NodeState,
    final counter). Pods still active after max_waves are finished by the
    strict loop (engine/batch.py). ``stats``, when given, receives the
    wave count and the straggler count."""
    P = len(pod_class)
    dev = nodes["alloc"].device
    pc_d = torch.from_numpy(np.array(pod_class, dtype=np.int32)).to(dev)
    c0 = torch.tensor(counter & U32_MASK, dtype=torch.int64, device=dev)
    fsel, ffc, active, ctr, waves_used, state = waves_loop(
        cls, nodes, state, pc_d, c0, priorities, max_waves)
    final_sel = fsel.cpu().numpy()
    final_fc = ffc.cpu().numpy()
    act_h = active.cpu().numpy()
    counter_h = int(ctr)
    n_strag = int(act_h.sum())
    if stats is not None:
        stats["waves"] = waves_used
        stats["stragglers"] = n_strag
    if n_strag:
        idx = np.nonzero(act_h)[0]
        if bool(cls["impossible"][-1]):
            pad_class = cls["req"].shape[0] - 1  # inert padding class row
            pc = np.full(preds.bucket(n_strag), pad_class, dtype=np.int32)
        else:  # unpadded class arrays: no inert row to map to
            pc = np.empty(n_strag, dtype=np.int32)
        pc[:n_strag] = pod_class[idx]
        sel, fcs, state, ctr = gather_place_batch(
            cls, torch.from_numpy(pc).to(dev), nodes, state,
            torch.tensor(counter_h, dtype=torch.int64, device=dev),
            priorities)
        final_sel[idx] = sel.cpu().numpy()[:n_strag]
        final_fc[idx] = fcs.cpu().numpy()[:n_strag]
        counter_h = int(ctr)
    return final_sel, final_fc, state, counter_h
