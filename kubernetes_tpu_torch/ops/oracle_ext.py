"""Oracle part 2: inter-pod affinity, selector spreading, and the remaining
priorities — exact object-level reimplementations (float64 semantics match Go).

Reference parity:
  InterPodAffinityMatches         predicates.go:982-1060 (+ symmetry check
                                  satisfiesExistingPodsAntiAffinity :1146,
                                  self-match bootstrap :1210-1230)
  CalculateInterPodAffinityPriority interpod_affinity.go:119-240
  CalculateSpreadPriority         selector_spreading.go:98-185 (2/3 zone weight)
  CalculateNodeAffinityPriority   node_affinity.go:36-100 (map + max reduce)
  CalculateNodePreferAvoidPods    node_prefer_avoid_pods.go:29-60
  ImageLocalityPriorityMap        image_locality.go:32-90 (23MB-1GB buckets)
  NodesHaveSameTopologyKey        priorities/util/topologies.go:50-70
  GetZoneKey                      pkg/util/node/node.go:115-132
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api.types import (
    MAX_PRIORITY,
    Node,
    Pod,
    PodAffinityTerm,
    WorkloadObject,
)
from kubernetes_tpu_torch.state.node_info import NodeInfo

ZONE_REGION_LABEL = "failure-domain.beta.kubernetes.io/region"
ZONE_LABEL = "failure-domain.beta.kubernetes.io/zone"
from kubernetes_tpu_torch.api.annotations import AVOID_PODS_ANNOTATION  # noqa: E402

MB = 1024 * 1024
MIN_IMG_SIZE = 23 * MB
MAX_IMG_SIZE = 1000 * MB


class SchedulingContext:
    """Cluster-wide state the object-level algorithms read beyond a single
    NodeInfo: every bound pod (with its node), and workload objects for
    spreading. Built from the cache's info map."""

    def __init__(self, infos: Dict[str, NodeInfo],
                 workloads: Sequence[WorkloadObject] = (),
                 hard_pod_affinity_weight: int = 1,
                 volume_ctx=None, policy_algos=None):
        self.infos = infos
        self.workloads = list(workloads)
        self.hard_pod_affinity_weight = hard_pod_affinity_weight
        # PV/PVC mirror for the volume predicates (state/volumes.VolumeContext)
        self.volume_ctx = volume_ctx
        # Policy-configured parameterized algorithms (ops/policy_algos.py)
        self.policy_algos = policy_algos
        self._all_pods: Optional[List[Tuple[Pod, Optional[Node]]]] = None
        self._affinity_pods: Optional[List[Tuple[Pod, Optional[Node]]]] = None

    def invalidate(self) -> None:
        """Call after mutating infos (e.g. an assume landed)."""
        self._all_pods = None
        self._affinity_pods = None

    def all_pods(self) -> List[Tuple[Pod, Optional[Node]]]:
        if self._all_pods is None:
            out = []
            for info in self.infos.values():
                for p in info.pods:
                    out.append((p, info.node))
            self._all_pods = out
        return self._all_pods

    def affinity_pods(self) -> List[Tuple[Pod, Optional[Node]]]:
        """Existing pods carrying any pod (anti-)affinity — the
        PodsWithAffinity fast list (node_info.go)."""
        if self._affinity_pods is None:
            out = []
            for info in self.infos.values():
                for p in info.pods_with_affinity:
                    out.append((p, info.node))
            self._affinity_pods = out
        return self._affinity_pods


class AffinityMeta:
    """Per-pending-pod precompute shared across all candidate nodes — the
    predicate-metadata analog (predicates/metadata.go:39
    matchingAntiAffinityTerms + per-term existing-pod match lists)."""

    def __init__(self, pod: Pod, ctx: "SchedulingContext"):
        # existing pods' required anti-affinity terms that MATCH this pod
        self.matching_anti: List[Tuple[PodAffinityTerm, Optional[Node]]] = []
        for existing, enode in ctx.affinity_pods():
            for term in _own_terms(existing, anti=True):
                if term_matches_pod(term, existing, pod):
                    self.matching_anti.append((term, enode))
        # for each of the pod's own required terms: matching existing pods
        self.own_aff: List[Tuple[PodAffinityTerm, List[Optional[Node]], bool]] = []
        self.own_anti: List[Tuple[PodAffinityTerm, List[Optional[Node]]]] = []
        aff = pod.affinity
        if aff is not None and (aff.pod_affinity or aff.pod_anti_affinity):
            all_pods = ctx.all_pods()
            for term in _own_terms(pod, anti=False):
                matches = [enode for existing, enode in all_pods
                           if term_matches_pod(term, pod, existing)]
                self.own_aff.append((term, matches,
                                     term_matches_pod(term, pod, pod)))
            for term in _own_terms(pod, anti=True):
                matches = [enode for existing, enode in all_pods
                           if term_matches_pod(term, pod, existing)]
                self.own_anti.append((term, matches))


def nodes_same_topology(a: Optional[Node], b: Optional[Node], key: str) -> bool:
    """topologies.go:50-70 — empty key or missing label on either -> False."""
    if not key or a is None or b is None:
        return False
    va = a.labels.get(key)
    vb = b.labels.get(key)
    return va is not None and vb is not None and va == vb


def get_zone_key(node: Optional[Node]) -> str:
    """node.go:115-132."""
    if node is None:
        return ""
    region = node.labels.get(ZONE_REGION_LABEL, "")
    zone = node.labels.get(ZONE_LABEL, "")
    if not region and not zone:
        return ""
    return region + ":\x00:" + zone


def term_namespaces(owner: Pod, term: PodAffinityTerm) -> List[str]:
    """topologies.go GetNamespacesFromPodAffinityTerm."""
    return list(term.namespaces) if term.namespaces else [owner.namespace]


def term_matches_pod(term: PodAffinityTerm, owner: Pod, target: Pod) -> bool:
    """PodMatchesTermsNamespaceAndSelector; nil selector matches nothing
    (LabelSelectorAsSelector(nil) -> labels.Nothing())."""
    if target.namespace not in term_namespaces(owner, term):
        return False
    if term.label_selector is None:
        return False
    return term.label_selector.matches(target.labels)


# ---------------------------------------------------------------------------
# inter-pod affinity predicate
# ---------------------------------------------------------------------------


def _own_terms(pod: Pod, anti: bool) -> List[PodAffinityTerm]:
    aff = pod.affinity
    if aff is None:
        return []
    pa = aff.pod_anti_affinity if anti else aff.pod_affinity
    return list(pa.required_terms) if pa is not None else []


def inter_pod_affinity_fits(pod: Pod, node: Node, ctx: SchedulingContext,
                            meta: Optional[AffinityMeta] = None) -> bool:
    """predicates.go:982-1060. `meta` is the once-per-pod precompute
    (AffinityMeta); without it, one is built on the fly."""
    if meta is None:
        meta = AffinityMeta(pod, ctx)
    # 1. symmetry: no existing pod's required anti-affinity may be violated
    for term, enode in meta.matching_anti:
        if not term.topology_key:
            return False  # empty key invalid for required anti-aff
        if nodes_same_topology(node, enode, term.topology_key):
            return False
    aff = pod.affinity
    if aff is None or (aff.pod_affinity is None and aff.pod_anti_affinity is None):
        return True
    # 2. pod's own required affinity terms
    for term, matches, self_match in meta.own_aff:
        if not term.topology_key:
            return False
        on_node = any(nodes_same_topology(node, enode, term.topology_key)
                      for enode in matches)
        if not on_node:
            if matches:  # matching pod exists somewhere else
                return False
            # bootstrap: first pod of a self-referencing group may land
            # (predicates.go:1210-1230)
            if not self_match:
                return False
    # 3. pod's own required anti-affinity terms
    for term, matches in meta.own_anti:
        if not term.topology_key:
            return False
        if any(nodes_same_topology(node, enode, term.topology_key)
               for enode in matches):
            return False
    return True


# ---------------------------------------------------------------------------
# inter-pod affinity priority
# ---------------------------------------------------------------------------


def interpod_affinity_scores(pod: Pod, filtered: Sequence[NodeInfo],
                             ctx: SchedulingContext) -> List[int]:
    """interpod_affinity.go:119-240. `filtered` is the post-predicate node
    list; existing pods from the whole cluster contribute."""
    counts: Dict[str, float] = {}
    nodes = [i.node for i in filtered if i.node is not None]

    def process(term: PodAffinityTerm, owner: Pod, target: Pod,
                fixed: Optional[Node], weight: float) -> None:
        if weight == 0 or not term_matches_pod(term, owner, target):
            return
        for n in nodes:
            if nodes_same_topology(n, fixed, term.topology_key):
                counts[n.name] = counts.get(n.name, 0.0) + weight

    aff = pod.affinity
    pa = aff.pod_affinity if aff else None
    paa = aff.pod_anti_affinity if aff else None
    for existing, enode in ctx.all_pods():
        eaff = existing.affinity
        if pa is not None:
            for w, term in pa.preferred_terms:
                process(term, pod, existing, enode, float(w))
        if paa is not None:
            for w, term in paa.preferred_terms:
                process(term, pod, existing, enode, -float(w))
        if eaff is not None and eaff.pod_affinity is not None:
            if ctx.hard_pod_affinity_weight > 0:
                for term in eaff.pod_affinity.required_terms:
                    process(term, existing, pod, enode,
                            float(ctx.hard_pod_affinity_weight))
            for w, term in eaff.pod_affinity.preferred_terms:
                process(term, existing, pod, enode, float(w))
        if eaff is not None and eaff.pod_anti_affinity is not None:
            for w, term in eaff.pod_anti_affinity.preferred_terms:
                process(term, existing, pod, enode, -float(w))

    max_c = max([counts.get(n.name, 0.0) for n in nodes], default=0.0)
    max_c = max(max_c, 0.0)
    min_c = min([counts.get(n.name, 0.0) for n in nodes], default=0.0)
    min_c = min(min_c, 0.0)
    out = []
    for n in nodes:
        if max_c - min_c > 0:
            out.append(int(MAX_PRIORITY * ((counts.get(n.name, 0.0) - min_c)
                                           / (max_c - min_c))))
        else:
            out.append(0)
    return out


# ---------------------------------------------------------------------------
# selector spreading
# ---------------------------------------------------------------------------


def pod_selectors(pod: Pod, workloads: Sequence[WorkloadObject]
                  ) -> List[WorkloadObject]:
    """getSelectors (selector_spreading.go:59): every Service/RC/RS/SS whose
    selector matches the pod."""
    return [w for w in workloads if w.selects(pod)]


def selector_spread_scores(pod: Pod, filtered: Sequence[NodeInfo],
                           ctx: SchedulingContext) -> List[int]:
    """selector_spreading.go:98-185."""
    from kubernetes_tpu_torch.ops.affinity import (
        SPREAD_NODE_COUNT_CAP,
        SPREAD_ZONE_COUNT_CAP,
    )
    selectors = pod_selectors(pod, ctx.workloads)
    nodes = [i.node for i in filtered if i.node is not None]
    counts: Dict[str, int] = {}
    counts_by_zone: Dict[str, int] = {}
    max_by_node = 0
    if selectors:
        for info in filtered:
            node = info.node
            if node is None:
                continue
            count = 0
            for np in info.pods:
                if np.namespace != pod.namespace or np.deleted:
                    continue
                if any(w.selects(np) for w in selectors):
                    count += 1
            count = min(count, SPREAD_NODE_COUNT_CAP)
            counts[node.name] = count
            max_by_node = max(max_by_node, count)
            zone = get_zone_key(node)
            if zone:
                counts_by_zone[zone] = counts_by_zone.get(zone, 0) + count
    for z in counts_by_zone:
        counts_by_zone[z] = min(counts_by_zone[z], SPREAD_ZONE_COUNT_CAP)
    have_zones = bool(counts_by_zone)
    max_by_zone = max(counts_by_zone.values(), default=0)
    out = []
    for node in nodes:
        # exact-rational spec (see ops/affinity.py spread_score: deliberate
        # deviation from the reference's float64 rounding crumbs): the
        # score is floor of r1n/r1d blended 1/3:2/3 with zn/zd, over ints
        if max_by_node > 0:
            r1n = MAX_PRIORITY * (max_by_node - counts.get(node.name, 0))
            r1d = max_by_node
        else:
            r1n, r1d = MAX_PRIORITY, 1
        zone = get_zone_key(node)
        if have_zones and zone:
            if max_by_zone > 0:
                zn = MAX_PRIORITY * (max_by_zone
                                     - counts_by_zone.get(zone, 0))
                zd = max_by_zone
            else:
                zn, zd = 0, 1
            out.append((r1n * zd + 2 * zn * r1d) // (3 * r1d * zd))
        else:
            out.append(r1n // r1d)
    return out


# ---------------------------------------------------------------------------
# node affinity (preferred) priority
# ---------------------------------------------------------------------------


def node_affinity_scores(pod: Pod, filtered: Sequence[NodeInfo]) -> List[int]:
    """node_affinity.go:36-100: sum weights of matching preferred terms, then
    normalize by max -> 0..10 (no min subtraction)."""
    counts = []
    na = pod.affinity.node_affinity if pod.affinity else None
    for info in filtered:
        node = info.node
        count = 0
        if node is not None and na is not None:
            for weight, term in na.preferred_terms:
                if weight == 0:
                    continue
                # empty term matches all objects (node_affinity.go:51 comment);
                # NodeSelectorTerm.matches_labels returns False on empty, so
                # special-case it here
                if not term.match_expressions or term.matches_labels(node.labels):
                    count += weight
        counts.append(count)
    max_c = max(counts, default=0)
    if max_c <= 0:
        return [0 for _ in counts]
    return [int(MAX_PRIORITY * (c / max_c)) for c in counts]


# ---------------------------------------------------------------------------
# node prefer-avoid-pods priority
# ---------------------------------------------------------------------------


def node_avoids_pod(node: Node, pod: Pod) -> bool:
    """node_prefer_avoid_pods.go:29-60 + GetAvoidPodsFromNodeAnnotations
    (parsing shared with the snapshot path — api/annotations.py)."""
    if pod.owner_kind not in ("ReplicationController", "ReplicaSet"):
        return False
    from kubernetes_tpu_torch.api.annotations import parse_avoid_annotation
    return (pod.owner_kind, pod.owner_uid) in \
        parse_avoid_annotation(node.annotations)


def prefer_avoid_scores(pod: Pod, filtered: Sequence[NodeInfo]) -> List[int]:
    out = []
    for info in filtered:
        node = info.node
        if node is None or not node_avoids_pod(node, pod):
            out.append(MAX_PRIORITY)
        else:
            out.append(0)
    return out


# ---------------------------------------------------------------------------
# image locality priority
# ---------------------------------------------------------------------------


def image_locality_scores(pod: Pod, filtered: Sequence[NodeInfo]) -> List[int]:
    """image_locality.go:32-90."""
    out = []
    for info in filtered:
        node = info.node
        total = 0
        if node is not None:
            for c in pod.containers:
                for img in node.images:
                    if c.image in img.names:
                        total += img.size_bytes
                        break
        if total == 0 or total < MIN_IMG_SIZE:
            out.append(0)
        elif total >= MAX_IMG_SIZE:
            out.append(MAX_PRIORITY)
        else:
            out.append(int(MAX_PRIORITY * (total - MIN_IMG_SIZE)
                           // (MAX_IMG_SIZE - MIN_IMG_SIZE)) + 1)
    return out
