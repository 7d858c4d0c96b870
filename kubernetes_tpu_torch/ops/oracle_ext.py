"""The affinity-term helpers of the exact object-level oracle that
ops/affinity.py builds its class arrays from (a copy of the reference
package's ops/oracle_ext.py helpers of the same names)."""

from __future__ import annotations

from typing import List

from kubernetes_tpu_torch.api.types import Pod, PodAffinityTerm

ZONE_REGION_LABEL = "failure-domain.beta.kubernetes.io/region"
ZONE_LABEL = "failure-domain.beta.kubernetes.io/zone"


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


def _own_terms(pod: Pod, anti: bool) -> List[PodAffinityTerm]:
    aff = pod.affinity
    if aff is None:
        return []
    pa = aff.pod_anti_affinity if anti else aff.pod_affinity
    return list(pa.required_terms) if pa is not None else []
