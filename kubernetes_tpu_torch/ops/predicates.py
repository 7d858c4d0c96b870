"""Vectorized fit predicates: the pod x node filter as dense [P, N] masks.

PyTorch port of kubernetes_tpu/ops/predicates.py. Replaces the
reference's findNodesThatFit hot loop
(plugin/pkg/scheduler/core/generic_scheduler.go:163-232) with dense
[P, N] masks over the arrays of state/snapshot.py (node side) and PodBatch
(pod side), passed as two dicts of tensors on one device.

Predicate parity map (reference: plugin/pkg/scheduler/algorithm/predicates/predicates.go):
  PodFitsResources        :556  -> resources_fit (the capacity kernel on a
                                   CUDA tensor, ops/kernels.capacity_fit)
  PodFitsHost             :698  -> host_fit
  PodFitsHostPorts        :859  -> ports_fit (bitmap gather, int32 words)
  PodMatchNodeSelector    :686  -> selector_fit
  PodToleratesNodeTaints  :1241 -> taints_fit
  CheckNodeCondition      :1306 -> node_condition_fit
  NoDiskConflict / MaxPD / VolumeZone / VolumeNode -> the volume predicates

Integer semantics are the reference's int32 arithmetic. The label-axis
products run as float32 matrix products of 0/1 (or small integer)
operands through ``int_matmul``: CUDA has no integer matmul, and float32
is exact while every sum stays below 2^24 — which holds for counts over
the label vocabulary — provided TF32 is off.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from kubernetes_tpu_torch.convert import tensor_from_numpy
from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.parallel import mesh as mesh_mod

Arrays = Dict[str, torch.Tensor]

I32 = torch.int32

_NODE_ARRAY_KEYS = ("alloc", "requested", "nonzero", "pod_count",
                    "allowed_pods", "schedulable", "mem_pressure",
                    "disk_pressure", "labels", "taints_sched",
                    "taints_pref", "port_bitmap", "valid", "avoid",
                    "image_sizes", "vol_present", "vol_rw", "pd_present",
                    "pd_counts", "pd_kind", "pd_max", "has_zone")


def int_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """Exact integer product a [..., K] x b_t [N, K] -> int32 [..., N],
    computed in float32 (exact while every partial sum is below 2^24 in
    magnitude). Raises when TF32 would round the float32 operands."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "int_matmul needs full float32 products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    lead = a.shape[:-1]
    out = a.reshape(-1, a.shape[-1]).to(torch.float32) \
        @ b_t.to(torch.float32).T
    return out.to(I32).reshape(*lead, b_t.shape[0])


def node_arrays(snap, device) -> Arrays:
    """The node-side tensor dict from a ClusterSnapshot: copies, through
    the sanitizer's view seam (verified copies under GRAFT_SANITIZE=1)."""
    from kubernetes_tpu_torch.analysis.sanitize import upload_view
    return {k: upload_view(getattr(snap, k), device)
            for k in _NODE_ARRAY_KEYS}


def bucket(n: int, lo: int = 16) -> int:
    """Power-of-2 shape bucket (kept from the reference so both packages
    pad every batch axis identically)."""
    p = lo
    while p < n:
        p *= 2
    return p


def _pad_rows(a: np.ndarray, rows: int, key: str) -> np.ndarray:
    c = a.shape[0]
    if rows <= c:
        return a
    pad = np.zeros((rows - c,) + a.shape[1:], dtype=a.dtype)
    if key == "impossible":
        pad[:] = True
    return np.concatenate([a, pad], axis=0)


def pod_arrays_padded(batch, rows: int, device) -> Arrays:
    """Pod arrays with the batch axis padded to `rows` in numpy, then one
    copy each to the device. Padding rows are `impossible`: they fit
    nothing, commit nothing and never tick the RR counter."""
    c = len(batch)
    if rows < c:
        raise ValueError(f"rows {rows} < batch size {c}")
    return {k: tensor_from_numpy(_pad_rows(a, rows, k), device)
            for k, a in _pod_arrays_np(batch).items()}


# selector/preference slot axes sized by actual usage (PodBatch): key ->
# (axis -> dim kind). Zero padding is inert on every one of them.
_SLOT_AXES = {
    "sel_req_all": {1: "T"}, "sel_req_any": {1: "T", 2: "A"},
    "sel_forbid": {1: "T"}, "sel_term_valid": {1: "T"},
    "sel_any_used": {1: "T", 2: "A"}, "sel_unsat": {1: "T"},
    "pref_req_all": {1: "TP"}, "pref_req_any": {1: "TP", 2: "A"},
    "pref_forbid": {1: "TP"}, "pref_any_used": {1: "TP", 2: "A"},
    "pref_valid": {1: "TP"}, "pref_unsat": {1: "TP"},
    "pref_empty": {1: "TP"}, "pref_weight": {1: "TP"},
    "pvaff_req_any": {1: "A"}, "pvaff_any_used": {1: "A"},
}


def pod_arrays_bucketed(batch, device, rows: int = 0) -> Arrays:
    """pod_arrays with the selector-term / any-group / preferred-term axes
    padded up to power-of-2 buckets (and, with ``rows``, the class axis
    padded with `impossible` rows) — the reference's extender encoding."""
    arrs = _pod_arrays_np(batch)
    c = len(batch)
    if rows and rows < c:
        raise ValueError(f"rows {rows} < batch size {c}")
    dims = {"T": bucket(arrs["sel_req_all"].shape[1], lo=1),
            "A": bucket(arrs["sel_req_any"].shape[2], lo=1),
            "TP": bucket(arrs["pref_req_all"].shape[1], lo=1)}
    out = {}
    for k, a in arrs.items():
        axes = _SLOT_AXES.get(k)
        if axes:
            widths = [(0, 0)] * a.ndim
            for ax, kind in axes.items():
                widths[ax] = (0, max(dims[kind] - a.shape[ax], 0))
            a = np.pad(a, widths)
        if rows:
            a = _pad_rows(a, rows, k)
        out[k] = tensor_from_numpy(a, device)
    return out


def _pod_arrays_np(batch):
    """The pod-side arrays of a PodBatch as host numpy."""
    return {k: getattr(batch, k) for k in (
        "req", "nonzero", "zero_req", "impossible", "best_effort", "ports",
        "intolerated", "intolerated_pref", "host_required", "has_host",
        "sel_req_all", "sel_req_any", "sel_forbid", "sel_term_valid",
        "sel_any_used", "sel_unsat", "has_selector", "pref_req_all",
        "pref_req_any", "pref_forbid", "pref_any_used", "pref_valid",
        "pref_unsat", "pref_empty", "pref_weight", "avoid_idx", "img_count",
        "vol_hard", "vol_ro", "pd_req", "pd_req_count", "vz_req", "vz_err",
        "pvaff_req_all", "pvaff_req_any", "pvaff_forbid", "pvaff_any_used",
        "pvaff_unsat", "pvaff_has")}


# ---------------------------------------------------------------------------
# capacity-dependent predicates (re-evaluated inside the placement loops)
# ---------------------------------------------------------------------------


def resources_fit(pod_req: torch.Tensor, zero_req: torch.Tensor,
                  alloc: torch.Tensor, requested: torch.Tensor
                  ) -> torch.Tensor:
    """PodFitsResources (predicates.go:556-624) minus the pod-count check.

    pod_req [P,R], zero_req [P], alloc [N,R], requested [N,R] -> bool [P,N].
    One call of ops/kernels.capacity_fit (one launch of the CUDA kernel on
    a CUDA tensor), which also folds in the override that lets an all-zero
    request skip the resource checks entirely (predicates.go:576-578)."""
    return kernels.capacity_fit(pod_req, alloc, requested, zero_req)


def pod_count_fit(pod_count: torch.Tensor, allowed_pods: torch.Tensor
                  ) -> torch.Tensor:
    """len(pods)+1 <= allowedPodNumber (predicates.go:563-566). [N]."""
    return pod_count + 1 <= allowed_pods


def ports_fit(ports: torch.Tensor, port_bitmap: torch.Tensor) -> torch.Tensor:
    """PodFitsHostPorts (predicates.go:859-878) via packed-bitmap gather.

    ports [P,8] int32 with -1 sentinel; port_bitmap [N,W] int32 words
    holding the reference's uint32 bits -> [P,N]. A word index past W reads
    as all ones, as the reference's filled out-of-range gather does."""
    want = ports >= 0
    safe = ports.clamp(min=0)
    word = (safe // 32).long()                             # [P,8]
    bit = safe % 32
    w = port_bitmap.shape[1]
    gathered = torch.where((word < w)[None],
                           port_bitmap[:, word.clamp(max=w - 1)],
                           -1)                             # [N,P,8]
    hit = ((gathered >> bit[None]) & 1).bool()
    conflict = (hit & want[None]).any(dim=-1)              # [N,P]
    return ~conflict.T


def no_disk_conflict(vol_hard: torch.Tensor, vol_ro: torch.Tensor,
                     vol_present: torch.Tensor, vol_rw: torch.Tensor
                     ) -> torch.Tensor:
    """NoDiskConflict (predicates.go:183-196): a HARD key conflicts with
    any presence; an RO key only with a read-write mount. -> bool [P,N]."""
    hard_hit = int_matmul(vol_hard, vol_present)
    ro_hit = int_matmul(vol_ro, vol_rw)
    return (hard_hit == 0) & (ro_hit == 0)


def max_pd_fit(pd_req: torch.Tensor, pd_req_count: torch.Tensor,
               pd_kind: torch.Tensor, pd_present: torch.Tensor,
               pd_counts: torch.Tensor, pd_max: torch.Tensor) -> torch.Tensor:
    """MaxPDVolumeCount for all three filters (predicates.go:285-323):
    numExisting + numNew <= max; a pod with no kind-f volumes passes
    filter f. -> bool [P,N]."""
    fit = None
    for k in range(3):
        req_k = pd_req * pd_kind[k][None, :]
        overlap = int_matmul(req_k, pd_present)
        new = pd_req_count[:, k][:, None] - overlap
        ok = ((pd_req_count[:, k][:, None] == 0)
              | (pd_counts[None, :, k] + new <= pd_max[k]))
        fit = ok if fit is None else fit & ok
    return fit


# ---------------------------------------------------------------------------
# capacity-independent predicates (computed once per batch)
# ---------------------------------------------------------------------------


def _need(req: torch.Tensor) -> torch.Tensor:
    return req.to(I32).sum(dim=-1, dtype=I32)


def volume_zone_fit(vz_req: torch.Tensor, vz_err: torch.Tensor,
                    labels: torch.Tensor, has_zone: torch.Tensor
                    ) -> torch.Tensor:
    """NoVolumeZoneConflict (predicates.go:404-474): nodes without zone or
    region labels pass; otherwise every zone pair the pod's bound PVs
    demand must be present (and no resolution error)."""
    cnt = int_matmul(vz_req, labels)
    need = _need(vz_req)[:, None]
    return (~has_zone[None, :]) | ((cnt == need) & ~vz_err[:, None])


def pv_affinity_fit(pods: Arrays, labels: torch.Tensor) -> torch.Tensor:
    """NoVolumeNodeConflict (predicates.go:1354-1411): the bound PVs'
    node-affinity requirements as one selector term; pass-through for pods
    without PV affinity."""
    all_cnt = int_matmul(pods["pvaff_req_all"], labels)
    need = _need(pods["pvaff_req_all"])[:, None]
    forbid_cnt = int_matmul(pods["pvaff_forbid"], labels)
    any_cnt = int_matmul(pods["pvaff_req_any"], labels)    # [P,A,N]
    any_ok = ((any_cnt > 0) | ~pods["pvaff_any_used"][:, :, None]).all(dim=1)
    ok = ((all_cnt == need) & (forbid_cnt == 0) & any_ok
          & ~pods["pvaff_unsat"][:, None])
    return ok | ~pods["pvaff_has"][:, None]


def selector_fit(pods: Arrays, labels: torch.Tensor) -> torch.Tensor:
    """PodMatchNodeSelector + required node affinity
    (predicates.go:625-696): terms ORed, requirements inside a term ANDed,
    as three label-axis products and compares."""
    req_all = pods["sel_req_all"]                          # [P,T,L]
    all_cnt = int_matmul(req_all, labels)                  # [P,T,N]
    all_ok = all_cnt == _need(req_all)[:, :, None]
    forbid_ok = int_matmul(pods["sel_forbid"], labels) == 0
    any_cnt = int_matmul(pods["sel_req_any"], labels)      # [P,T,A,N]
    any_ok = ((any_cnt > 0)
              | ~pods["sel_any_used"][:, :, :, None]).all(dim=2)
    term_ok = (all_ok & forbid_ok & any_ok
               & pods["sel_term_valid"][:, :, None]
               & ~pods["sel_unsat"][:, :, None])
    return term_ok.any(dim=1) | ~pods["has_selector"][:, None]


def taints_fit(intolerated: torch.Tensor, taints_sched: torch.Tensor
               ) -> torch.Tensor:
    """PodToleratesNodeTaints (predicates.go:1241): fail on any
    NoSchedule/NoExecute taint the pod does not tolerate."""
    return int_matmul(intolerated, taints_sched) == 0


def host_fit(has_host: torch.Tensor, host_required: torch.Tensor,
             n: int) -> torch.Tensor:
    """PodFitsHost (predicates.go:698-712). [P] -> [P,N]."""
    idx = torch.arange(n, dtype=I32, device=has_host.device)
    return (~has_host[:, None]) | (host_required[:, None] == idx[None, :])


def node_condition_fit(pods: Arrays, nodes: Arrays) -> torch.Tensor:
    """CheckNodeCondition + pressure predicates (predicates.go:1274-1337)
    from the host-side node verdicts."""
    ok = nodes["schedulable"] & nodes["valid"]
    mem_ok = (~pods["best_effort"][:, None]) | (~nodes["mem_pressure"][None, :])
    disk_ok = ~nodes["disk_pressure"][None, :]
    return ok[None, :] & mem_ok & disk_ok


def static_fits(pods: Arrays, nodes: Arrays) -> torch.Tensor:
    """All spec-independent predicates -> [P,N] (node conditions excluded:
    every consumer ANDs node_condition_fit against fresh node arrays)."""
    n = nodes["alloc"].shape[0]
    out = (
        selector_fit(pods, nodes["labels"])
        & taints_fit(pods["intolerated"], nodes["taints_sched"])
        & host_fit(pods["has_host"], pods["host_required"], n)
        & volume_zone_fit(pods["vz_req"], pods["vz_err"], nodes["labels"],
                          nodes["has_zone"])
        & pv_affinity_fit(pods, nodes["labels"])
        & ~pods["impossible"][:, None]
    )
    if "policy_fit" in pods:
        # Policy-configured NodeLabelPresence / ServiceAffinity masks,
        # precomputed host-side (ops/policy_algos.py)
        out = out & pods["policy_fit"]
    if "host_fit" in pods:
        # the exact label-pure host predicate for classes whose selector /
        # zone / PV shape overflowed the fused encoding, precomputed
        # host-side (PodBatch.host_static_fit); ANDing exact with the
        # over-approximate terms above keeps the composite exact
        out = out & pods["host_fit"]
    return out


@mesh_mod.per_shard(axis=1)
def fits(pods: Arrays, nodes: Arrays) -> torch.Tensor:
    """The full predicate chain against a frozen snapshot -> bool [P,N].
    Elementwise over the node axis: mesh-placed inputs (parallel/mesh)
    give [P, N] sharded on axis 1."""
    return (
        static_fits(pods, nodes)
        & node_condition_fit(pods, nodes)
        & resources_fit(pods["req"], pods["zero_req"], nodes["alloc"],
                        nodes["requested"])
        & pod_count_fit(nodes["pod_count"], nodes["allowed_pods"])[None, :]
        & ports_fit(pods["ports"], nodes["port_bitmap"])
        & no_disk_conflict(pods["vol_hard"], pods["vol_ro"],
                           nodes["vol_present"], nodes["vol_rw"])
        & max_pd_fit(pods["pd_req"], pods["pd_req_count"], nodes["pd_kind"],
                     nodes["pd_present"], nodes["pd_counts"], nodes["pd_max"])
    )
