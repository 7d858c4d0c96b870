"""Quota evaluators: object -> resource usage deltas.

Mirror of pkg/quota/evaluator/core (pod.go PodUsageFunc, services.go,
persistent_volume_claims.go, the generic object-count evaluators) consumed by
both the resourcequota admission controller
(plugin/pkg/admission/resourcequota) and the quota reconciliation controller
(pkg/controller/resourcequota). Units: cpu millicores, memory bytes, counts.
"""

from __future__ import annotations

from typing import Dict, List

from kubernetes_tpu_torch.api.types import Pod

# quota resource names (pkg/api/types.go ResourceName constants)
PODS = "pods"
CPU = "cpu"  # == requests.cpu
MEMORY = "memory"
REQUESTS_CPU = "requests.cpu"
REQUESTS_MEMORY = "requests.memory"
LIMITS_CPU = "limits.cpu"
LIMITS_MEMORY = "limits.memory"

COUNT_KINDS = {
    "Service": "services",
    "ReplicationController": "replicationcontrollers",
    "ResourceQuota": "resourcequotas",
    "Secret": "secrets",
    "ConfigMap": "configmaps",
    "PersistentVolumeClaim": "persistentvolumeclaims",
}


def pod_usage(pod: Pod) -> Dict[str, int]:
    """PodUsageFunc (pkg/quota/evaluator/core/pods.go): requests + limits
    summed across containers; pods count 1. Terminal-phase pods consume no
    quota (filtered by the caller via is_terminal)."""
    cpu = mem = lcpu = lmem = 0
    for c in pod.containers:
        cpu += c.requests.get("cpu", 0)
        mem += c.requests.get("memory", 0)
        lcpu += c.limits.get("cpu", 0)
        lmem += c.limits.get("memory", 0)
    usage = {PODS: 1}
    if cpu:
        usage[CPU] = cpu
        usage[REQUESTS_CPU] = cpu
    if mem:
        usage[MEMORY] = mem
        usage[REQUESTS_MEMORY] = mem
    if lcpu:
        usage[LIMITS_CPU] = lcpu
    if lmem:
        usage[LIMITS_MEMORY] = lmem
    return usage


def is_terminal(pod: Pod) -> bool:
    return pod.phase in ("Succeeded", "Failed")


def object_count_usage(kind: str) -> Dict[str, int]:
    name = COUNT_KINDS.get(kind)
    return {name: 1} if name else {}


def usage_for(kind: str, obj) -> Dict[str, int]:
    if kind == "Pod":
        if is_terminal(obj):
            return {}
        return pod_usage(obj)
    return object_count_usage(kind)


def quota_scopes_match(scopes: List[str], kind: str, obj) -> bool:
    """Scope selectors (pods.go podMatchesScopeFunc): BestEffort /
    NotBestEffort / Terminating / NotTerminating; non-pod kinds match only
    scope-less quotas."""
    if not scopes:
        return True
    if kind != "Pod":
        return False
    for s in scopes:
        if s == "BestEffort" and not obj.is_best_effort():
            return False
        if s == "NotBestEffort" and obj.is_best_effort():
            return False
        if s == "Terminating" and not getattr(obj, "deleted", False):
            return False
        if s == "NotTerminating" and getattr(obj, "deleted", False):
            return False
    return True


def add_usage(into: Dict[str, int], delta: Dict[str, int]) -> None:
    for k, v in delta.items():
        into[k] = into.get(k, 0) + v


def sub_usage(into: Dict[str, int], delta: Dict[str, int]) -> None:
    for k, v in delta.items():
        into[k] = into.get(k, 0) - v


def exceeds(hard: Dict[str, int], used: Dict[str, int],
            delta: Dict[str, int]) -> List[str]:
    """Which constrained resources would go over hard limits if delta were
    admitted (resource_access.go CheckRequest semantics)."""
    over = []
    for k, lim in hard.items():
        if k in delta and used.get(k, 0) + delta[k] > lim:
            over.append(k)
    return over
