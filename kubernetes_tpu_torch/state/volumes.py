"""Host-side volume resolution: conflict keys, PD-count filters, zone labels,
PV node affinity.

This is the object→identity layer shared by the exact oracle predicates
(ops/oracle_volumes.py) and the tensorization (state/snapshot.py). The
reference spreads this logic across predicates.go:128-474 (isVolumeConflict,
MaxPDVolumeCountChecker.filterVolumes, VolumeZoneChecker, VolumeNodeChecker)
and pkg/volume/util/util.go:193 (CheckNodeAffinity).

Design note (TPU-first): every volume fact is reduced to an *interned string
key* so the kernels see multi-hot rows over small demand-driven vocabularies —
set intersection becomes an int8 matmul. Keys are exact (no hashing), so
kernel verdicts equal oracle verdicts; see state/snapshot.py docstring.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api.types import (
    ALPHA_STORAGE_NODE_AFFINITY_ANNOTATION,
    NodeSelectorTerm,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    SelectorOperator,
    SelectorRequirement,
    Volume,
    VolumeKind,
)

# zone/region labels (kubeletapis.LabelZoneFailureDomain / LabelZoneRegion,
# read by VolumeZoneChecker — predicates.go:420-426)
ZONE_LABEL = "failure-domain.beta.kubernetes.io/zone"
REGION_LABEL = "failure-domain.beta.kubernetes.io/region"

# Max PD volume defaults (algorithmprovider/defaults/defaults.go:33-47 +
# pkg/cloudprovider/providers/aws/aws.go DefaultMaxEBSVolumes=39)
DEFAULT_MAX_EBS_VOLUMES = 39
DEFAULT_MAX_GCE_PD_VOLUMES = 16
DEFAULT_MAX_AZURE_DISK_VOLUMES = 16
KUBE_MAX_PD_VOLS_ENV = "KUBE_MAX_PD_VOLS"

# PD filter kinds, in fixed column order for the [N,3] count tensors
PD_EBS, PD_GCE, PD_AZURE = 0, 1, 2
PD_KINDS = (VolumeKind.AWS_EBS, VolumeKind.GCE_PD, VolumeKind.AZURE_DISK)
PD_PREDICATE_NAMES = ("MaxEBSVolumeCount", "MaxGCEPDVolumeCount",
                      "MaxAzureDiskVolumeCount")


def max_pd_volumes() -> Tuple[int, int, int]:
    """(ebs, gce, azure) limits honoring KUBE_MAX_PD_VOLS
    (defaults.go:233-246 getMaxVols)."""
    raw = os.environ.get(KUBE_MAX_PD_VOLS_ENV, "")
    if raw:
        try:
            v = int(raw)
            if v > 0:
                return v, v, v
        except ValueError:
            pass
    return (DEFAULT_MAX_EBS_VOLUMES, DEFAULT_MAX_GCE_PD_VOLUMES,
            DEFAULT_MAX_AZURE_DISK_VOLUMES)


class VolumeContext:
    """PV/PVC lister mirror (the pvInfo/pvcInfo of
    NewMaxPDVolumeCountPredicate — factory.go wires informer listers).
    `version` bumps on any PV/PVC change so consumers can invalidate
    derived tensors."""

    def __init__(self,
                 pvs: Optional[Dict[str, PersistentVolume]] = None,
                 pvcs: Optional[Dict[Tuple[str, str], PersistentVolumeClaim]] = None):
        self.pvs = pvs if pvs is not None else {}
        self.pvcs = pvcs if pvcs is not None else {}
        self.version = 0

    def pv(self, name: str) -> Optional[PersistentVolume]:
        return self.pvs.get(name)

    def pvc(self, namespace: str, name: str) -> Optional[PersistentVolumeClaim]:
        return self.pvcs.get((namespace, name))


EMPTY_VOLUME_CONTEXT = VolumeContext()


# ---------------------------------------------------------------------------
# NoDiskConflict keys
# ---------------------------------------------------------------------------

# conflict "hardness": a HARD request conflicts with ANY existing mount of the
# same key (EBS always — predicates.go:143-147 — plus any read-write mount of
# an RO-capable kind); an RO request conflicts only with a read-write mount.


def conflict_keys(vol: Volume) -> List[Tuple[str, bool]]:
    """-> [(key, read_only)] identity keys for isVolumeConflict
    (predicates.go:128-177). RBD expands to one key per monitor so 'any
    shared monitor + same pool + image' is exact set intersection."""
    kind = VolumeKind(vol.kind)
    if kind == VolumeKind.GCE_PD:
        return [("gce\x00" + vol.volume_id, vol.read_only)]
    if kind == VolumeKind.AWS_EBS:
        # EBS conflicts regardless of read-only: model as never-RO
        return [("ebs\x00" + vol.volume_id, False)]
    if kind == VolumeKind.ISCSI:
        return [("iscsi\x00" + vol.volume_id, vol.read_only)]
    if kind == VolumeKind.RBD:
        return [("rbd\x00" + mon + "\x00" + vol.pool + "\x00" + vol.image,
                 vol.read_only) for mon in vol.monitors]
    return []


def pod_conflict_keys(pod: Pod) -> List[Tuple[str, bool]]:
    out: List[Tuple[str, bool]] = []
    for v in pod.volumes:
        out.extend(conflict_keys(v))
    return out


# ---------------------------------------------------------------------------
# MaxPDVolumeCount filters
# ---------------------------------------------------------------------------


def pd_filter_ids(pod: Pod, ctx: VolumeContext) -> List[Tuple[int, str]]:
    """-> [(pd_kind_index, unique_id)] applying the EBS/GCEPD/AzureDisk
    VolumeFilters with PVC→PV resolution (predicates.go:230-283
    filterVolumes). A missing/unbound PVC or missing PV counts as a unique
    relevant volume (the reference generates a random id; we use a
    deterministic per-(pod,volume) id which dedupes identically within one
    pod — strictly no less conservative)."""
    out: List[Tuple[int, str]] = []
    for i, vol in enumerate(pod.volumes):
        kind = VolumeKind(vol.kind)
        if kind in PD_KINDS:
            out.append((PD_KINDS.index(kind), vol.volume_id))
        elif kind == VolumeKind.PVC:
            claim = vol.volume_id
            if not claim:
                continue  # reference errors; treat as irrelevant
            pvc = ctx.pvc(pod.namespace, claim)
            if pvc is None or not pvc.volume_name:
                # missing or unbound PVC: counts toward EVERY filter's limit
                # in the reference (each predicate's filterVolumes adds it)
                for k in range(len(PD_KINDS)):
                    out.append((k, "\x00missing\x00%s\x00%d" % (pod.uid, i)))
                continue
            pv = ctx.pv(pvc.volume_name)
            if pv is None:
                for k in range(len(PD_KINDS)):
                    out.append((k, "\x00missingpv\x00%s\x00%d" % (pod.uid, i)))
                continue
            pv_kind = VolumeKind(pv.source.kind)
            if pv_kind in PD_KINDS:
                out.append((PD_KINDS.index(pv_kind), pv.source.volume_id))
    return out


def pd_id_sets(pod: Pod, ctx: VolumeContext) -> List[set]:
    """[(set of unique ids)] per PD kind."""
    sets: List[set] = [set() for _ in PD_KINDS]
    for k, vid in pd_filter_ids(pod, ctx):
        sets[k].add(vid)
    return sets


# ---------------------------------------------------------------------------
# VolumeZone
# ---------------------------------------------------------------------------


class UnresolvedVolume(Exception):
    """PVC/PV lookup failed where the reference returns a scheduling error
    (predicates.go:434-458) — the pod cannot be scheduled this round."""


def zone_constraints(pod: Pod, ctx: VolumeContext) -> List[Tuple[str, str]]:
    """Required (zone-label-key, value) pairs from the pod's bound PVs
    (predicates.go:404-474 VolumeZoneChecker.predicate). Raises
    UnresolvedVolume on missing/unbound PVC or missing PV."""
    out: List[Tuple[str, str]] = []
    for vol in pod.volumes:
        if VolumeKind(vol.kind) != VolumeKind.PVC:
            continue
        claim = vol.volume_id
        if not claim:
            raise UnresolvedVolume("PersistentVolumeClaim had no name")
        pvc = ctx.pvc(pod.namespace, claim)
        if pvc is None:
            raise UnresolvedVolume(f"PersistentVolumeClaim not found: {claim}")
        if not pvc.volume_name:
            raise UnresolvedVolume(f"PersistentVolumeClaim not bound: {claim}")
        pv = ctx.pv(pvc.volume_name)
        if pv is None:
            raise UnresolvedVolume(
                f"PersistentVolume not found: {pvc.volume_name}")
        for k, v in pv.labels.items():
            if k in (ZONE_LABEL, REGION_LABEL):
                out.append((k, v))
    return out


def node_zone_check(node_labels: Dict[str, str],
                    constraints: Sequence[Tuple[str, str]]) -> bool:
    """predicates.go:415-470: a node with no zone/region labels passes; else
    each PV zone label must equal the node's value for that key (missing key
    compares as \"\")."""
    node_zone = {k: v for k, v in node_labels.items()
                 if k in (ZONE_LABEL, REGION_LABEL)}
    if not node_zone:
        return True
    for k, v in constraints:
        if node_zone.get(k, "") != v:
            return False
    return True


# ---------------------------------------------------------------------------
# VolumeNode (PersistentLocalVolumes alpha)
# ---------------------------------------------------------------------------


def parse_pv_node_affinity(pv: PersistentVolume) -> Optional[List[NodeSelectorTerm]]:
    """Node-selector terms from the PV: explicit field, else the alpha
    annotation (helpers.go:418 GetStorageNodeAffinityFromAnnotation). Terms
    are ANDed at check time (util.go:202-214)."""
    if pv.node_affinity_terms is not None:
        return pv.node_affinity_terms
    raw = pv.annotations.get(ALPHA_STORAGE_NODE_AFFINITY_ANNOTATION, "")
    if not raw:
        return None
    try:
        obj = json.loads(raw)
    except ValueError as e:
        raise UnresolvedVolume(f"bad node-affinity annotation: {e}") from None
    req = (obj or {}).get("requiredDuringSchedulingIgnoredDuringExecution")
    if not req:
        return None
    terms = []
    for t in req.get("nodeSelectorTerms", []):
        exprs = [
            SelectorRequirement(e["key"], SelectorOperator(e["operator"]),
                                list(e.get("values", [])))
            for e in t.get("matchExpressions", [])
        ]
        terms.append(NodeSelectorTerm(exprs))
    return terms


def pv_affinity_requirements(pod: Pod, ctx: VolumeContext
                             ) -> List[SelectorRequirement]:
    """Flattened AND of every bound PV's node-affinity requirements
    (VolumeNodeChecker.predicate, predicates.go:1354-1411 + util.go:193).
    Raises UnresolvedVolume like the reference's error returns."""
    reqs: List[SelectorRequirement] = []
    for vol in pod.volumes:
        if VolumeKind(vol.kind) != VolumeKind.PVC:
            continue
        claim = vol.volume_id
        if not claim:
            raise UnresolvedVolume("PersistentVolumeClaim had no name")
        pvc = ctx.pvc(pod.namespace, claim)
        if pvc is None:
            raise UnresolvedVolume(f"PersistentVolumeClaim not found: {claim}")
        if not pvc.volume_name:
            raise UnresolvedVolume(f"PersistentVolumeClaim not bound: {claim}")
        pv = ctx.pv(pvc.volume_name)
        if pv is None:
            raise UnresolvedVolume(
                f"PersistentVolume not found: {pvc.volume_name}")
        terms = parse_pv_node_affinity(pv)
        if terms:
            for t in terms:
                reqs.extend(t.match_expressions)
    return reqs
