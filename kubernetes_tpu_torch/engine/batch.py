"""Strict batch placement: the reference's one-pod-at-a-time loop on device.

PyTorch port of kubernetes_tpu/engine/batch.py (NodeState, _batch_pre,
place_batch / gather_place_batch, check_affinity_priorities). The reference
runs the loop as a lax.scan; here it is a Python loop over the pods whose
carry (the mutable node state and the round-robin counter) stays on the
device, so a step costs no host sync. Each step re-evaluates the
capacity-dependent predicates and priorities against the carry, then
commits the chosen node (the on-device AssumePod).

selectHost parity (generic_scheduler.go:88-160):
  - 0 fitting nodes  -> selected = -1, counter unchanged
  - 1 fitting node   -> that node, counter NOT incremented
  - >1 fitting nodes -> max-score tie set, index = counter % ties
                        (counter++), tie order = ascending node index.

The reference's counter is uint32; the port carries it as an int64 tensor
holding the same value (0 <= counter < 2^32) and wraps it explicitly.
With ``aff`` the loop also carries the inter-pod affinity occupancy
(commdom [C, L], committed [C, N], comm_cnt [C]) that the reference's
sequential loop sees through the scheduler cache.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from kubernetes_tpu_torch.api.types import MAX_PRIORITY
from kubernetes_tpu_torch.ops import affinity as aff_ops
from kubernetes_tpu_torch.ops import predicates as preds
from kubernetes_tpu_torch.ops import priorities as prio
from kubernetes_tpu_torch.ops.predicates import int_matmul

Arrays = Dict[str, torch.Tensor]

I32 = torch.int32
U32_MASK = 0xFFFFFFFF


class NodeState(NamedTuple):
    """The mutable (carry) slice of node state."""

    requested: torch.Tensor    # int32 [N,R]
    nonzero: torch.Tensor      # int32 [N,2]
    pod_count: torch.Tensor    # int32 [N]
    port_bitmap: torch.Tensor  # int32 [N,W] (the reference's uint32 bits)
    vol_present: torch.Tensor  # int8 [N,Vc]
    vol_rw: torch.Tensor       # int8 [N,Vc]
    pd_present: torch.Tensor   # int8 [N,Vpd]
    pd_counts: torch.Tensor    # int32 [N,3]


def node_state(nodes: Arrays) -> NodeState:
    return NodeState(nodes["requested"], nodes["nonzero"], nodes["pod_count"],
                     nodes["port_bitmap"], nodes["vol_present"],
                     nodes["vol_rw"], nodes["pd_present"], nodes["pd_counts"])


def counter_as_i32(counter: torch.Tensor) -> torch.Tensor:
    """The reference's ``counter.astype(int32)`` of a uint32: the same 32
    bits read as two's complement."""
    return torch.where(counter >= 2 ** 31, counter - 2 ** 32,
                       counter).to(I32)


_STATIC_PRIORITIES = ("NodePreferAvoidPodsPriority", "ImageLocalityPriority",
                      "EqualPriority")


def _step_scores(pod_nonzero: torch.Tensor, state: NodeState,
                 alloc: torch.Tensor, tt_cnt: torch.Tensor,
                 na_cnt: torch.Tensor, static_score: torch.Tensor,
                 fits: torch.Tensor, priorities) -> torch.Tensor:
    """Per-pod priority sum against the evolving carry. [N] int32."""
    pz = pod_nonzero[None, :]
    total = static_score
    for name, weight in priorities:
        if name == "LeastRequestedPriority":
            s = prio.least_requested(pz, state.nonzero, alloc)[0]
        elif name == "MostRequestedPriority":
            s = prio.most_requested(pz, state.nonzero, alloc)[0]
        elif name == "BalancedResourceAllocation":
            s = prio.balanced_allocation(pz, state.nonzero, alloc)[0]
        elif name == "TaintTolerationPriority":
            mx = torch.where(fits, tt_cnt, 0).amax()
            s = torch.where(mx == 0, MAX_PRIORITY,
                            (MAX_PRIORITY * (mx - tt_cnt)) // mx.clamp(min=1))
        elif name == "NodeAffinityPriority":
            mx = torch.where(fits, na_cnt, 0).amax()
            s = torch.where(mx > 0, (MAX_PRIORITY * na_cnt) // mx.clamp(min=1),
                            0)
        elif name in _STATIC_PRIORITIES:
            continue  # folded into static_score
        elif name in prio.AFFINITY_PRIORITIES:
            continue  # computed by the caller from the affinity carry
        else:
            raise KeyError(name)
        total = total + s * weight
    return total


def _commit(state: NodeState, sel: torch.Tensor, ok: torch.Tensor,
            pod_req, pod_nonzero, pod_ports, pod_vol_hard, pod_vol_ro,
            pod_pd_req, pd_new_sel) -> NodeState:
    """Decrement capacity at the selected node (the on-device AssumePod).
    The carry is updated in place: callers hand place_batch fresh state."""
    safe = torch.where(ok, sel, 0).long()
    gain = ok.to(I32)
    state.requested[safe] += pod_req * gain
    state.nonzero[safe] += pod_nonzero * gain
    state.pod_count[safe] += gain
    # host ports are deduped host-side, so adding distinct bits into one
    # word is an OR; a bit 31 wraps to the sign bit exactly as uint32 adds
    want = (pod_ports >= 0) & ok
    wsafe = pod_ports.clamp(min=0)
    bits = torch.where(want, torch.ones_like(wsafe) << (wsafe % 32), 0)
    row = state.port_bitmap[safe].clone()
    row.index_add_(0, (wsafe // 32).long(), bits)
    state.port_bitmap[safe] = row
    zero8 = torch.zeros_like(pod_vol_hard)
    state.vol_present[safe] = torch.maximum(
        state.vol_present[safe],
        torch.where(ok, pod_vol_hard | pod_vol_ro, zero8))
    state.vol_rw[safe] = torch.maximum(
        state.vol_rw[safe], torch.where(ok, pod_vol_hard, zero8))
    state.pd_present[safe] = torch.maximum(
        state.pd_present[safe],
        torch.where(ok, pod_pd_req, torch.zeros_like(pod_pd_req)))
    state.pd_counts[safe] += pd_new_sel * gain
    return state


def _batch_pre(pods: Arrays, nodes: Arrays, priorities
               ) -> Tuple[torch.Tensor, ...]:
    """The [*, N] capacity-independent tensors of the loop: static
    predicate mask, reduce-priority counts and static priority score."""
    static_fit = preds.static_fits(pods, nodes) \
        & preds.node_condition_fit(pods, nodes)
    tt_cnt = int_matmul(pods["intolerated_pref"], nodes["taints_pref"])
    na_cnt = prio.node_affinity_counts(pods, nodes["labels"]) \
        if any(nm == "NodeAffinityPriority" for nm, _ in priorities) \
        else torch.zeros(static_fit.shape, dtype=I32,
                         device=static_fit.device)
    static_score = torch.zeros(static_fit.shape, dtype=I32,
                               device=static_fit.device)
    for name, weight in priorities:
        if name in _STATIC_PRIORITIES:
            static_score = static_score + \
                prio.PRIORITY_REGISTRY[name](pods, nodes, None) * weight
    return static_fit, tt_cnt, na_cnt, static_score


def check_affinity_priorities(priorities, aff, extra_score) -> None:
    """Affinity-priority guard shared by every batch-placement entry point
    (place_batch, waves.tail_rounds_loop): SelectorSpread/InterPodAffinity
    in the priority set without class data or a frozen extra_score would
    contribute silent zeros — a parity bug, never a fallback."""
    for nm, _w in priorities:
        if nm in prio.AFFINITY_PRIORITIES and aff is None \
                and extra_score is None:
            raise ValueError(
                f"{nm} in the priority set requires affinity/spread class "
                "data (pass aff= from ops.affinity.AffinityData, or a "
                "frozen extra_score) — silent zero contributions are a "
                "parity bug, not a fallback")


def copy_state(state: NodeState) -> NodeState:
    return NodeState(*(t.clone() for t in state))


def gather_place_batch(cls_arr: Arrays, pc: torch.Tensor, nodes: Arrays,
                       state: NodeState, rr: torch.Tensor, priorities,
                       aff: Arrays = None,
                       aff_mode: Tuple[bool, bool, bool] = (False, False,
                                                            False),
                       aff_init=None, extra_score: torch.Tensor = None):
    """place_batch over per-pod rows gathered from class rows (pc = class
    index per pod). The capacity-independent [C, N] tensors are computed
    once at class level and gathered; `aff` stays class-level (the loop
    indexes it by class) and `extra_score` is class-level [C, N]."""
    pcl = pc.long()
    parr = {k: v[pcl] for k, v in cls_arr.items()}
    ex = extra_score[pcl] if extra_score is not None else None
    pre = tuple(a[pcl] for a in _batch_pre(cls_arr, nodes, priorities))
    return place_batch(parr, nodes, state, rr, priorities, aff=aff, pc=pc,
                       aff_mode=aff_mode, aff_init=aff_init, extra_score=ex,
                       pre=pre)


def place_batch(pods: Arrays, nodes: Arrays, state: NodeState,
                rr_counter: torch.Tensor, priorities, aff: Arrays = None,
                pc: torch.Tensor = None,
                aff_mode: Tuple[bool, bool, bool] = (False, False, False),
                aff_init=None, extra_score: torch.Tensor = None,
                pre: Tuple[torch.Tensor, ...] = None):
    """Place every pod of the batch in order. ``state`` is not modified
    (the loop works on a copy); rr_counter is an int64 scalar tensor.

    `aff`/`pc`/`aff_mode` switch on the inter-pod affinity + selector-spread
    machinery (ops/affinity.py): aff holds the CLASS-level static arrays,
    pc [P] maps each pod to its class, and aff_mode = (fits_on, prio_on,
    spread_on) gates which parts run. `aff_init` = (commdom, committed,
    comm_cnt) seeds the occupancy carry with pods committed before this
    batch (the wave pass of the same chunk).

    Returns (selected [P] int32 node index or -1, fit_count [P] int32,
             final NodeState, final rr_counter)."""
    fits_on, prio_on, spread_on = aff_mode
    any_aff = aff is not None and (fits_on or prio_on or spread_on)
    check_affinity_priorities(priorities, aff, extra_score)
    w_ip = sum(w for nm, w in priorities
               if nm == "InterPodAffinityPriority") if prio_on else 0
    w_sp = sum(w for nm, w in priorities
               if nm == "SelectorSpreadPriority") if spread_on else 0
    if pre is None:
        pre = _batch_pre(pods, nodes, priorities)
    static_fit, tt_cnt, na_cnt, static_score = pre
    alloc = nodes["alloc"]
    allowed = nodes["allowed_pods"]
    pd_kind = nodes["pd_kind"]
    pd_max = nodes["pd_max"]
    n = alloc.shape[0]
    dev = alloc.device
    p_count = pods["req"].shape[0]
    idx_n = torch.arange(n, dtype=I32, device=dev)
    state = copy_state(state)
    counter = rr_counter.to(torch.int64).clone()
    selected = torch.empty(p_count, dtype=I32, device=dev)
    fit_counts = torch.empty(p_count, dtype=I32, device=dev)
    if any_aff:
        c_dim = aff["m_aff"].shape[0]
        # labels_aff (when present) is the PROJECTED domain incidence the
        # aff arrays' domain axes are sliced to (the pipelined tail's
        # column projection); the predicate/priority arrays keep the full
        # label matrix
        labels = aff["labels_aff"] if "labels_aff" in aff \
            else nodes["labels"]
        pre_aff = aff_ops.precompute_static(aff, labels)
        if aff_init is not None:
            commdom, committed, comm_cnt = (t.to(I32).clone()
                                            for t in aff_init)
        else:
            commdom = torch.zeros((c_dim, labels.shape[1]), dtype=I32,
                                  device=dev)
            committed = torch.zeros((c_dim, n), dtype=I32, device=dev)
            comm_cnt = torch.zeros(c_dim, dtype=I32, device=dev)
        # the class of every pod on the host, once: the loop indexes the
        # class-level affinity arrays with it
        pc_h = (pc.tolist() if pc is not None else [0] * p_count)
    for i in range(p_count):
        p_req = pods["req"][i]
        p_vol_hard, p_vol_ro = pods["vol_hard"][i], pods["vol_ro"][i]
        p_pd_req, p_pd_count = pods["pd_req"][i], pods["pd_req_count"][i]
        # NoDiskConflict against the evolving presence
        hard_hit = (state.vol_present.to(I32)
                    * p_vol_hard.to(I32)[None]).sum(dim=1, dtype=I32)
        ro_hit = (state.vol_rw.to(I32)
                  * p_vol_ro.to(I32)[None]).sum(dim=1, dtype=I32)
        disk_ok = (hard_hit == 0) & (ro_hit == 0)
        # MaxPDVolumeCount per filter kind against evolving counts
        pd_ok = torch.ones_like(disk_ok)
        pd_new = []
        for k in range(3):
            req_k = (p_pd_req * pd_kind[k]).to(I32)
            overlap = (state.pd_present.to(I32) * req_k[None]).sum(
                dim=1, dtype=I32)
            new_k = p_pd_count[k] - overlap
            pd_new.append(new_k)
            pd_ok = pd_ok & ((p_pd_count[k] == 0)
                             | (state.pd_counts[:, k] + new_k <= pd_max[k]))
        dyn = (preds.resources_fit(p_req[None], pods["zero_req"][i][None],
                                   alloc, state.requested)[0]
               & preds.pod_count_fit(state.pod_count, allowed)
               & preds.ports_fit(pods["ports"][i][None], state.port_bitmap)[0]
               & disk_ok & pd_ok)
        fits = static_fit[i] & dyn
        if fits_on:
            fits = fits & aff_ops.step_fits(aff, pre_aff, pc_h[i], commdom,
                                            comm_cnt, labels)
        fit_count = fits.sum(dtype=I32)
        scores = _step_scores(pods["nonzero"][i], state, alloc, tt_cnt[i],
                              na_cnt[i], static_score[i], fits, priorities)
        if extra_score is not None:
            scores = scores + extra_score[i]
        if prio_on:
            cnt_ip = aff_ops.step_prio_counts(aff, pre_aff, pc_h[i], commdom,
                                              labels)
            scores = scores + w_ip * aff_ops.interpod_score(cnt_ip, fits)
        if spread_on:
            cnt_sp = aff_ops.step_spread_counts(aff, pc_h[i], committed)
            scores = scores + w_sp * aff_ops.spread_score(
                aff, aff["sp_has"][pc_h[i]], cnt_sp, fits)
        masked = torch.where(fits, scores, -1)
        ties = masked == masked.amax()
        num_ties = ties.sum(dtype=torch.int64)
        kk = torch.where(num_ties > 0, counter % num_ties.clamp(min=1), 0)
        rank = torch.cumsum(ties.to(torch.int64), 0) - 1
        rr_sel = torch.where(ties & (rank == kk), idx_n, n).amin()
        one_sel = fits.to(torch.uint8).argmax().to(I32)
        sel = torch.where(fit_count == 0, -1,
                          torch.where(fit_count == 1, one_sel, rr_sel))
        ok = fit_count > 0
        counter = (counter + (fit_count > 1).to(torch.int64)) & U32_MASK
        safe_sel = torch.where(ok, sel, 0).long()
        pd_new_sel = torch.stack([v[safe_sel] for v in pd_new])
        state = _commit(state, sel, ok, p_req, pods["nonzero"][i],
                        pods["ports"][i], p_vol_hard, p_vol_ro, p_pd_req,
                        pd_new_sel)
        if any_aff:
            # affinity/spread carry: the committed pod's node-domain row
            # joins its class's occupancy (the on-device AssumePod for
            # topology state)
            gain = ok.to(I32)
            c = pc_h[i]
            commdom[c] += labels[safe_sel].to(I32) * gain
            committed[c, safe_sel] += gain
            comm_cnt[c] += gain
        selected[i] = sel
        fit_counts[i] = fit_count
    return selected, fit_counts, state, counter
