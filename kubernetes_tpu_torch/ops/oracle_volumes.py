"""Exact object-level volume predicates (golden reference for the kernels).

Parity map (reference: plugin/pkg/scheduler/algorithm/predicates/predicates.go):
  NoDiskConflict          :183-196 (+ isVolumeConflict :128-177)
  MaxPDVolumeCount        :198-323 (EBS/GCEPD/AzureDisk filters :324-374)
  NoVolumeZoneConflict    :376-474
  NoVolumeNodeConflict    :1345-1411 (PersistentLocalVolumes-gated)
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod, Volume, VolumeKind
from kubernetes_tpu_torch.state.node_info import NodeInfo
from kubernetes_tpu_torch.state import volumes as volmod
from kubernetes_tpu_torch.state.volumes import (
    UnresolvedVolume,
    VolumeContext,
    max_pd_volumes,
    node_zone_check,
    pd_id_sets,
    pv_affinity_requirements,
    zone_constraints,
)
from kubernetes_tpu_torch.utils import features


def _is_volume_conflict(vol: Volume, existing_pod: Pod) -> bool:
    """predicates.go:128-177 isVolumeConflict."""
    kind = VolumeKind(vol.kind)
    if kind not in (VolumeKind.GCE_PD, VolumeKind.AWS_EBS, VolumeKind.RBD,
                    VolumeKind.ISCSI):
        return False
    for ev in existing_pod.volumes:
        ekind = VolumeKind(ev.kind)
        if kind == VolumeKind.GCE_PD and ekind == VolumeKind.GCE_PD:
            if (vol.volume_id == ev.volume_id
                    and not (vol.read_only and ev.read_only)):
                return True
        if kind == VolumeKind.AWS_EBS and ekind == VolumeKind.AWS_EBS:
            if vol.volume_id == ev.volume_id:
                return True
        if kind == VolumeKind.ISCSI and ekind == VolumeKind.ISCSI:
            if (vol.volume_id == ev.volume_id
                    and not (vol.read_only and ev.read_only)):
                return True
        if kind == VolumeKind.RBD and ekind == VolumeKind.RBD:
            if (set(vol.monitors) & set(ev.monitors)
                    and vol.pool == ev.pool and vol.image == ev.image
                    and not (vol.read_only and ev.read_only)):
                return True
    return False


def no_disk_conflict(pod: Pod, info: NodeInfo) -> bool:
    """predicates.go:183-196."""
    for v in pod.volumes:
        for ep in info.pods:
            if _is_volume_conflict(v, ep):
                return False
    return True


def max_pd_volume_count(pod: Pod, info: NodeInfo, ctx: VolumeContext,
                        limits: Optional[Tuple[int, int, int]] = None
                        ) -> List[bool]:
    """-> per-filter verdicts [ebs_ok, gce_ok, azure_ok]
    (predicates.go:285-323 MaxPDVolumeCountChecker.predicate, one checker
    per filter in the default provider)."""
    if limits is None:
        limits = max_pd_volumes()
    if not pod.volumes:
        return [True, True, True]
    new_sets = pd_id_sets(pod, ctx)
    out: List[bool] = []
    existing_sets = None
    for k, limit in enumerate(limits):
        new = new_sets[k]
        if not new:
            out.append(True)  # quick return (predicates.go:297-300)
            continue
        if existing_sets is None:
            existing_sets = [set() for _ in volmod.PD_KINDS]
            for ep in info.pods:
                for kk, vid in volmod.pd_filter_ids(ep, ctx):
                    existing_sets[kk].add(vid)
        existing = existing_sets[k]
        num_new = len(new - existing)
        out.append(len(existing) + num_new <= limit)
    return out


def no_volume_zone_conflict(pod: Pod, info: NodeInfo,
                            ctx: VolumeContext) -> bool:
    """predicates.go:404-474. Raises UnresolvedVolume where the reference
    returns a scheduling error."""
    if not pod.volumes or info.node is None:
        return info.node is not None
    node_zone = {k: v for k, v in info.node.labels.items()
                 if k in (volmod.ZONE_LABEL, volmod.REGION_LABEL)}
    if not node_zone:
        return True  # fast-path (predicates.go:425-430)
    return node_zone_check(info.node.labels, zone_constraints(pod, ctx))


def no_volume_node_conflict(pod: Pod, info: NodeInfo,
                            ctx: VolumeContext) -> bool:
    """predicates.go:1354-1411, gated on PersistentLocalVolumes."""
    if not features.enabled("PersistentLocalVolumes"):
        return True
    if not pod.volumes or info.node is None:
        return info.node is not None
    try:
        reqs = pv_affinity_requirements(pod, ctx)
    except UnresolvedVolume:
        raise
    labels = info.node.labels
    return all(r.matches_labels(labels) for r in reqs)


def volume_predicates_fit(pod: Pod, info: NodeInfo,
                          ctx: Optional[VolumeContext]) -> bool:
    """The default provider's four volume predicates ANDed
    (defaults.go:118-127: NoVolumeZoneConflict, MaxEBS/GCEPD/AzureDisk,
    NoDiskConflict, NoVolumeNodeConflict). UnresolvedVolume -> not fit
    (the reference propagates the error, failing the schedule attempt)."""
    if not pod.volumes:
        return True
    ctx = ctx or volmod.EMPTY_VOLUME_CONTEXT
    try:
        if not no_volume_zone_conflict(pod, info, ctx):
            return False
        if not all(max_pd_volume_count(pod, info, ctx)):
            return False
        if not no_disk_conflict(pod, info):
            return False
        if not no_volume_node_conflict(pod, info, ctx):
            return False
    except UnresolvedVolume:
        return False
    return True
