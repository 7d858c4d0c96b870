"""Workload API types: the controller-managed objects.

Mirrors the *consumed* slice of the reference's apps/batch/core workload
surface (staging/src/k8s.io/api/{apps,batch}/v1*, pkg/apis/extensions):
ReplicaSet / ReplicationController / Deployment / Job / DaemonSet /
StatefulSet carry a replica goal, a selector, and a pod template; Namespace
and Service/Endpoints carry lifecycle and routing state. Status fields are
the subset controllers actually reconcile on.

Pod templates are prototype `Pod` objects (name empty); controllers stamp
instances with `stamp_pod`, which fills identity + ownerRef — the moral
equivalent of pkg/controller/controller_utils.go GetPodFromTemplate.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import (
    LabelSelector,
    Pod,
    SelectorRequirement,
    WorkloadObject,
)


def stamp_pod(template: Pod, name: str, namespace: str,
              owner_kind: str, owner_name: str, owner_uid: str = "") -> Pod:
    """Instantiate a pod from a template with identity + controllerRef."""
    pod = copy.deepcopy(template)
    return dataclasses.replace(
        pod, name=name, namespace=namespace, uid=f"{namespace}/{name}",
        owner_kind=owner_kind, owner_name=owner_name,
        owner_uid=owner_uid or f"{owner_kind}/{namespace}/{owner_name}",
        resource_version=0, node_name=pod.node_name, phase="Pending")


@dataclass
class ReplicaSet:
    """apps/v1beta2 ReplicaSet reduced to spec.{replicas,selector,template} +
    reconciled status (pkg/controller/replicaset)."""

    name: str
    namespace: str = "default"
    annotations: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    replicas: int = 1
    selector: LabelSelector = field(default_factory=LabelSelector)
    template: Pod = field(default_factory=lambda: Pod(name=""))
    owner_kind: str = ""  # set when managed by a Deployment
    owner_name: str = ""
    # status
    observed_replicas: int = 0
    ready_replicas: int = 0
    resource_version: int = 0

    def key(self) -> str:
        return self.namespace + "/" + self.name


@dataclass
class ReplicationController:
    """core/v1 RC: map selector instead of LabelSelector
    (pkg/controller/replication shares ~all logic with replicaset)."""

    name: str
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    replicas: int = 1
    selector: Dict[str, str] = field(default_factory=dict)
    template: Pod = field(default_factory=lambda: Pod(name=""))
    observed_replicas: int = 0
    ready_replicas: int = 0
    resource_version: int = 0

    def key(self) -> str:
        return self.namespace + "/" + self.name


@dataclass
class Deployment:
    """apps Deployment: desired state for ReplicaSets
    (pkg/controller/deployment): RollingUpdate via maxSurge/maxUnavailable,
    template-hash child RS naming, revision tracking."""

    name: str
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    replicas: int = 1
    selector: LabelSelector = field(default_factory=LabelSelector)
    template: Pod = field(default_factory=lambda: Pod(name=""))
    max_surge: int = 1
    max_unavailable: int = 0
    paused: bool = False
    # status
    revision: int = 0
    updated_replicas: int = 0
    ready_replicas: int = 0
    resource_version: int = 0

    def key(self) -> str:
        return self.namespace + "/" + self.name


@dataclass
class Job:
    """batch/v1 Job (pkg/controller/job): run template pods to completion."""

    name: str
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    completions: int = 1
    parallelism: int = 1
    backoff_limit: int = 6
    template: Pod = field(default_factory=lambda: Pod(name="", restart_policy="Never"))
    # status
    active: int = 0
    succeeded: int = 0
    failed: int = 0
    complete: bool = False
    resource_version: int = 0

    def key(self) -> str:
        return self.namespace + "/" + self.name


@dataclass
class CronJob:
    """batch/v2alpha1 CronJob (pkg/controller/cronjob): spawn Jobs on a cron
    schedule. Schedule syntax supported: '@every <seconds>s' and the 5-field
    subset 'M H * * *' / '*/N * * * *' (the cronjob controller's needs)."""

    name: str
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    schedule: str = "@every 60s"
    suspend: bool = False
    concurrency_policy: str = "Allow"  # Allow | Forbid | Replace
    job_template: Job = field(default_factory=lambda: Job(name=""))
    successful_jobs_history_limit: int = 3
    failed_jobs_history_limit: int = 1
    # status
    last_schedule_time: float = 0.0
    active_jobs: List[str] = field(default_factory=list)
    resource_version: int = 0

    def key(self) -> str:
        return self.namespace + "/" + self.name


@dataclass
class HorizontalPodAutoscaler:
    """autoscaling/v1 HPA (pkg/controller/podautoscaler): scale a target
    workload by the ratio of observed to target CPU utilization —
    desired = ceil(current * observed/target), bounded to [min,max], with
    the reference's 10% tolerance dead-band (horizontal.go)."""

    name: str
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    target_kind: str = "ReplicaSet"
    target_name: str = ""
    min_replicas: int = 1
    max_replicas: int = 10
    target_cpu_utilization: int = 80  # percent of requests
    # status
    current_replicas: int = 0
    desired_replicas: int = 0
    current_cpu_utilization: int = 0
    resource_version: int = 0

    def key(self) -> str:
        return self.namespace + "/" + self.name


@dataclass
class DaemonSet:
    """extensions DaemonSet (pkg/controller/daemon): one pod per eligible
    node; eligibility mirrors the scheduler's GeneralPredicates-lite check
    the daemon controller does itself (daemoncontroller.go nodeShouldRunDaemonPod)."""

    name: str
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    selector: LabelSelector = field(default_factory=LabelSelector)
    template: Pod = field(default_factory=lambda: Pod(name=""))
    annotations: Dict[str, str] = field(default_factory=dict)
    # status
    desired_scheduled: int = 0
    current_scheduled: int = 0
    resource_version: int = 0

    def key(self) -> str:
        return self.namespace + "/" + self.name


@dataclass
class StatefulSet:
    """apps StatefulSet (pkg/controller/statefulset): ordinal identity pods
    <name>-0..N-1, created in order, scaled down in reverse."""

    name: str
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    replicas: int = 1
    selector: LabelSelector = field(default_factory=LabelSelector)
    template: Pod = field(default_factory=lambda: Pod(name=""))
    service_name: str = ""
    # status
    ready_replicas: int = 0
    resource_version: int = 0

    def key(self) -> str:
        return self.namespace + "/" + self.name


@dataclass
class Namespace:
    """core/v1 Namespace with the two-phase delete the namespace lifecycle
    controller drives (pkg/controller/namespace): Active -> Terminating ->
    (contents deleted) -> gone."""

    name: str
    phase: str = "Active"  # Active | Terminating
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    resource_version: int = 0


@dataclass
class ServicePort:
    port: int = 0
    target_port: int = 0
    protocol: str = "TCP"
    node_port: int = 0


@dataclass
class Service:
    """core/v1 Service reduced to what endpoints + proxy consume: the
    selector, ports, and a cluster VIP."""

    name: str
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    selector: Dict[str, str] = field(default_factory=dict)
    ports: List[ServicePort] = field(default_factory=list)
    cluster_ip: str = ""
    type: str = "ClusterIP"  # ClusterIP | NodePort | LoadBalancer
    load_balancer_ip: str = ""  # status.loadBalancer ingress (service ctrl)
    resource_version: int = 0

    def key(self) -> str:
        return self.namespace + "/" + self.name


@dataclass
class EndpointAddress:
    pod_key: str = ""
    node_name: str = ""
    ip: str = ""


@dataclass
class Endpoints:
    """core/v1 Endpoints: ready pod addresses behind a service, reconciled by
    the endpoint controller (pkg/controller/endpoint)."""

    name: str
    namespace: str = "default"
    addresses: List[EndpointAddress] = field(default_factory=list)
    resource_version: int = 0

    def key(self) -> str:
        return self.namespace + "/" + self.name


@dataclass
class PriorityClass:
    """scheduling.k8s.io PriorityClass (v1.7 had only the PodPriority gate;
    the class object is the forward-compatible config surface)."""

    name: str
    value: int = 0
    global_default: bool = False
    resource_version: int = 0


def selector_of(obj) -> LabelSelector:
    """Uniform LabelSelector view over RS/Deployment/DS/SS (LabelSelector)
    and RC/Service (map selector)."""
    sel = getattr(obj, "selector", None)
    if isinstance(sel, LabelSelector):
        return sel
    return LabelSelector(match_labels=dict(sel or {}))


def to_workload_object(kind: str, obj) -> WorkloadObject:
    """Normalize an apiserver workload (Service/RC/RS/StatefulSet) into the
    scheduler's WorkloadObject view (api/types.py) — the GetPodServices /
    GetPodControllers lister adaptation. The scheduler's spread/service-
    affinity code calls .selects(pod), which the raw api objects lack."""
    sel = selector_of(obj)
    return WorkloadObject(
        kind, obj.name, getattr(obj, "namespace", "default"),
        match_labels=dict(sel.match_labels),
        match_expressions=list(sel.match_expressions),
        resource_version=getattr(obj, "resource_version", 0))


def pods_matching(obj, pods: List[Pod]) -> List[Pod]:
    """Live (non-deleted) pods in obj's namespace matching its selector —
    the controller's filteredPods list (replica_set.go syncReplicaSet)."""
    sel = selector_of(obj)
    ns = getattr(obj, "namespace", "default")
    return [p for p in pods
            if p.namespace == ns and not p.deleted and sel.matches(p.labels)]
