"""Core API object model.

Python-native mirror of the *scheduling-relevant* slice of the Kubernetes v1 API
surface: the fields read by predicates and priorities (reference:
plugin/pkg/scheduler/schedulercache/node_info.go:34-75 and
plugin/pkg/scheduler/algorithm/predicates/predicates.go), plus the objects the
control plane moves around (Binding, events). This is deliberately NOT a port of
staging/src/k8s.io/api/core/v1/types.go (4,738 lines, mostly generated) — the
TPU-native design keeps the host-side object model minimal and puts the scale
axis in dense tensors (see kubernetes_tpu_torch/state/snapshot.py).

All resource quantities are plain integers in canonical units:
  - cpu: millicores (int)
  - memory / storage: bytes (int)
  - gpu / extended resources: counts (int)
mirroring resource.Quantity's MilliValue()/Value() accessors
(staging/src/k8s.io/apimachinery/pkg/api/resource/quantity.go).
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Resources
# ---------------------------------------------------------------------------

# Default requests applied *for priority scoring only* to containers that do
# not specify a request — reference:
# plugin/pkg/scheduler/algorithm/priorities/util/non_zero.go:29-31
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024

# MaxPriority — reference: plugin/pkg/scheduler/api/types.go:33
MAX_PRIORITY = 10


@dataclass
class Resource:
    """Aggregate resource vector.

    Mirrors schedulercache.Resource (reference: schedulercache/node_info.go:65-75):
    MilliCPU, Memory, NvidiaGPU, storage scratch/overlay, plus extended
    (opaque-integer) resources.
    """

    milli_cpu: int = 0
    memory: int = 0
    nvidia_gpu: int = 0
    storage_scratch: int = 0
    storage_overlay: int = 0
    extended: Dict[str, int] = field(default_factory=dict)

    def add(self, other: "Resource") -> "Resource":
        for k, v in other.extended.items():
            self.extended[k] = self.extended.get(k, 0) + v
        self.milli_cpu += other.milli_cpu
        self.memory += other.memory
        self.nvidia_gpu += other.nvidia_gpu
        self.storage_scratch += other.storage_scratch
        self.storage_overlay += other.storage_overlay
        return self

    def sub(self, other: "Resource") -> "Resource":
        for k, v in other.extended.items():
            self.extended[k] = self.extended.get(k, 0) - v
        self.milli_cpu -= other.milli_cpu
        self.memory -= other.memory
        self.nvidia_gpu -= other.nvidia_gpu
        self.storage_scratch -= other.storage_scratch
        self.storage_overlay -= other.storage_overlay
        return self

    def clone(self) -> "Resource":
        return Resource(
            self.milli_cpu,
            self.memory,
            self.nvidia_gpu,
            self.storage_scratch,
            self.storage_overlay,
            dict(self.extended),
        )


# ---------------------------------------------------------------------------
# Selectors / affinity
# ---------------------------------------------------------------------------


class SelectorOperator(str, enum.Enum):
    """Node-selector requirement operators — reference:
    staging/src/k8s.io/api/core/v1/types.go NodeSelectorOperator."""

    IN = "In"
    NOT_IN = "NotIn"
    EXISTS = "Exists"
    DOES_NOT_EXIST = "DoesNotExist"
    GT = "Gt"
    LT = "Lt"


@dataclass
class SelectorRequirement:
    key: str
    operator: SelectorOperator
    values: List[str] = field(default_factory=list)

    def matches_labels(self, labels: Dict[str, str]) -> bool:
        """Evaluate against a label map — semantics of
        labels.Selector.Matches over NodeSelectorRequirementsAsSelector
        (reference: pkg/api/v1/helper/helpers.go NodeSelectorRequirementsAsSelector)."""
        op = SelectorOperator(self.operator)
        present = self.key in labels
        if op == SelectorOperator.EXISTS:
            return present
        if op == SelectorOperator.DOES_NOT_EXIST:
            return not present
        if op == SelectorOperator.IN:
            return present and labels[self.key] in self.values
        if op == SelectorOperator.NOT_IN:
            # k8s labels.Requirement: NotIn fails when key absent? In k8s,
            # NotIn requires the key to exist with value not in set — absent
            # key *matches* NotIn for label selectors built via
            # NodeSelectorRequirementsAsSelector (operator -> selection.NotIn,
            # whose Matches returns true when key is absent).
            return (not present) or labels[self.key] not in self.values
        if op in (SelectorOperator.GT, SelectorOperator.LT):
            if not present or len(self.values) != 1:
                return False
            try:
                lhs = int(labels[self.key])
                rhs = int(self.values[0])
            except ValueError:
                return False
            return lhs > rhs if op == SelectorOperator.GT else lhs < rhs
        return False


@dataclass
class NodeSelectorTerm:
    """Expressions are ANDed; terms in a list are ORed
    (reference: predicates.go:625-646 nodeMatchesNodeSelectorTerms)."""

    match_expressions: List[SelectorRequirement] = field(default_factory=list)

    def matches_labels(self, labels: Dict[str, str]) -> bool:
        if not self.match_expressions:
            # non-nil empty NodeSelectorRequirement list matches no nodes
            # (predicates.go:646 comment, cases 4-5)
            return False
        return all(r.matches_labels(labels) for r in self.match_expressions)


@dataclass
class NodeAffinity:
    # None means "no required terms" (matches everything); [] matches nothing
    # (predicates.go:660-683).
    required_terms: Optional[List[NodeSelectorTerm]] = None
    # (weight, term) pairs — PreferredSchedulingTerm
    preferred_terms: List[Tuple[int, NodeSelectorTerm]] = field(default_factory=list)


@dataclass
class LabelSelector:
    """metav1.LabelSelector: match_labels ANDed with match_expressions.
    nil selector matches nothing in affinity context; empty selector matches
    everything (apimachinery LabelSelectorAsSelector semantics)."""

    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[SelectorRequirement] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        return all(r.matches_labels(labels) for r in self.match_expressions)


@dataclass
class PodAffinityTerm:
    """reference: v1.PodAffinityTerm — selector over pods, within topology_key
    domains, restricted to namespaces (empty = pod's own namespace)."""

    label_selector: Optional[LabelSelector] = None
    namespaces: List[str] = field(default_factory=list)
    topology_key: str = ""


@dataclass
class PodAffinity:
    required_terms: List[PodAffinityTerm] = field(default_factory=list)
    # (weight, term)
    preferred_terms: List[Tuple[int, PodAffinityTerm]] = field(default_factory=list)


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAffinity] = None


# ---------------------------------------------------------------------------
# Taints / tolerations
# ---------------------------------------------------------------------------


class TaintEffect(str, enum.Enum):
    NO_SCHEDULE = "NoSchedule"
    PREFER_NO_SCHEDULE = "PreferNoSchedule"
    NO_EXECUTE = "NoExecute"


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: TaintEffect = TaintEffect.NO_SCHEDULE


class TolerationOperator(str, enum.Enum):
    EXISTS = "Exists"
    EQUAL = "Equal"


@dataclass(frozen=True)
class Toleration:
    """reference: v1.Toleration; ToleratesTaint semantics in
    staging/src/k8s.io/api/core/v1/toleration.go — empty key with Exists
    tolerates everything; empty effect matches all effects."""

    key: str = ""
    operator: TolerationOperator = TolerationOperator.EQUAL
    value: str = ""
    effect: Optional[TaintEffect] = None  # None = all effects
    # NoExecute grace period (v1.Toleration.TolerationSeconds; None = forever)
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        if self.effect is not None and self.effect != taint.effect:
            return False
        if self.key != "" and self.key != taint.key:
            return False
        op = TolerationOperator(self.operator)
        if op == TolerationOperator.EXISTS:
            return True
        return self.value == taint.value


# ---------------------------------------------------------------------------
# Volumes
# ---------------------------------------------------------------------------


class VolumeKind(str, enum.Enum):
    """The volume-source kinds the scheduler's volume predicates read
    (reference: predicates.go:128-177 isVolumeConflict + the EBS/GCEPD/
    AzureDisk VolumeFilters at predicates.go:324-374). Other sources
    (EmptyDir, ConfigMap, Secret, HostPath, NFS, ...) are scheduling-inert
    and collapse to OTHER."""

    GCE_PD = "GCEPersistentDisk"
    AWS_EBS = "AWSElasticBlockStore"
    RBD = "RBD"
    ISCSI = "ISCSI"
    AZURE_DISK = "AzureDisk"
    PVC = "PersistentVolumeClaim"
    # scheduling-inert but authz-relevant: the node authorizer only grants a
    # kubelet access to secrets/configmaps referenced by pods bound to it
    # (plugin/pkg/auth/authorizer/node/node_authorizer.go)
    SECRET = "Secret"
    CONFIG_MAP = "ConfigMap"
    OTHER = "Other"


@dataclass
class Volume:
    """One pod-spec volume, reduced to scheduler-relevant identity fields.

    volume_id carries the per-kind identity: PDName (GCE), VolumeID (EBS),
    DiskName (AzureDisk), IQN (ISCSI), claim name (PVC). RBD identity is
    (any shared monitor, pool, image) — predicates.go:163-172."""

    name: str = ""
    kind: VolumeKind = VolumeKind.OTHER
    volume_id: str = ""
    read_only: bool = False
    monitors: List[str] = field(default_factory=list)  # RBD CephMonitors
    pool: str = ""  # RBD RBDPool
    image: str = ""  # RBD RBDImage
    # concrete source for scheduling-inert kinds (OTHER collapses EmptyDir/
    # HostPath/NFS/DownwardAPI/...) — the volume plugin layer
    # (volumes/plugins.py) selects its driver by this, the way
    # pkg/volume/plugins.go FindPluginBySpec switches on the populated
    # VolumeSource member
    driver: str = ""


# PV node-affinity alpha annotation — v1.AlphaStorageNodeAffinityAnnotation
# (staging/src/k8s.io/api/core/v1/types.go; read by
# pkg/api/v1/helper/helpers.go:418 GetStorageNodeAffinityFromAnnotation)
ALPHA_STORAGE_NODE_AFFINITY_ANNOTATION = \
    "volume.alpha.kubernetes.io/node-affinity"


@dataclass
class PersistentVolume:
    """Cluster-scoped PV, reduced to what VolumeZone / MaxPDVolumeCount /
    VolumeNode read: zone labels, the backing source, and (alpha) node
    affinity (reference: predicates.go:376-474, pkg/volume/util/util.go:193
    CheckNodeAffinity)."""

    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    capacity: int = 0  # bytes (spec.capacity.storage; PV binder matching)
    access_modes: List[str] = field(default_factory=list)
    source: Volume = field(default_factory=Volume)
    # RequiredDuringScheduling node-selector terms; unlike pod node affinity
    # these are ANDed (util.go:202-214 loops ALL terms, each must match)
    node_affinity_terms: Optional[List["NodeSelectorTerm"]] = None
    resource_version: int = 0


@dataclass
class PersistentVolumeClaim:
    """Namespaced PVC: binds a pod volume to a PV by name
    (pvc.Spec.VolumeName — predicates.go:253-262)."""

    name: str
    namespace: str = "default"
    volume_name: str = ""  # bound PV name; empty = unbound
    capacity: int = 0  # requested bytes (spec.resources.requests.storage)
    access_modes: List[str] = field(default_factory=list)
    # class selection rides the v1.7 beta annotation
    # (volume.beta.kubernetes.io/storage-class), set by the user or the
    # StorageClassDefault admission plugin
    annotations: Dict[str, str] = field(default_factory=dict)
    resource_version: int = 0


# ---------------------------------------------------------------------------
# Pod
# ---------------------------------------------------------------------------


@dataclass
class ContainerPort:
    host_port: int = 0
    container_port: int = 0
    protocol: str = "TCP"


@dataclass
class Probe:
    """v1.Probe reduced to the fields the kubelet's prober reads
    (reference: pkg/kubelet/prober/prober.go + worker.go). `kind` is the
    handler type; outcomes in the hollow runtime are driven by pod
    annotations (nodes/kubelet.py), the way kubemark fakes the runtime."""

    kind: str = "exec"  # exec | httpGet | tcpSocket
    initial_delay_s: float = 0.0  # InitialDelaySeconds
    period_s: float = 10.0  # PeriodSeconds
    failure_threshold: int = 3  # FailureThreshold (worker.go)
    success_threshold: int = 1  # SuccessThreshold


@dataclass
class SecurityContext:
    """v1.SecurityContext (container-level), reduced to the fields PSP and
    the kubelet's securitycontext provider read (pkg/securitycontext/,
    pkg/apis/extensions PSP validation)."""

    privileged: Optional[bool] = None
    run_as_user: Optional[int] = None
    run_as_non_root: Optional[bool] = None
    read_only_root_filesystem: Optional[bool] = None


@dataclass
class PodSecurityContext:
    """v1.PodSecurityContext: pod-wide defaults containers inherit (only
    the fields a strategy actually enforces; FSGroup/SupplementalGroups
    strategies are not modeled)."""

    run_as_user: Optional[int] = None
    run_as_non_root: Optional[bool] = None


@dataclass
class Container:
    name: str = ""
    image: str = ""
    # None values mean "not specified" (relevant for nonzero-request defaults:
    # priorities/util/non_zero.go distinguishes unset from explicit zero).
    requests: Dict[str, int] = field(default_factory=dict)
    limits: Dict[str, int] = field(default_factory=dict)
    ports: List[ContainerPort] = field(default_factory=list)
    liveness_probe: Optional[Probe] = None
    readiness_probe: Optional[Probe] = None
    security_context: Optional[SecurityContext] = None


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    containers: List[Container] = field(default_factory=list)
    volumes: List[Volume] = field(default_factory=list)
    node_name: str = ""  # spec.nodeName; non-empty once bound
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    scheduler_name: str = "default-scheduler"
    priority: int = 0
    priority_class: str = ""
    # PodStatus.Phase (v1.PodPhase): Pending | Running | Succeeded | Failed.
    # Set by the node agent (models/hollow kubelet) after bind; controllers
    # and endpoints read it.
    phase: str = "Pending"
    restart_policy: str = "Always"  # Always | OnFailure | Never
    # PodCondition[Ready] (status manager): gates Endpoints membership.
    # A Running pod with no readiness probe is ready (prober results_manager
    # defaults); the kubelet flips this from probe outcomes.
    ready: bool = True
    restart_count: int = 0  # sum of ContainerStatus.RestartCount
    host_network: bool = False  # spec.hostNetwork (PSP HostNetwork check)
    security_context: Optional[PodSecurityContext] = None
    resource_version: int = 0
    owner_kind: str = ""  # controllerRef: equivalence classes, spreading,
    owner_name: str = ""  # NodePreferAvoidPods
    owner_uid: str = ""
    deleted: bool = False  # DeletionTimestamp != nil (spreading skips these)

    def key(self) -> str:
        # memoized: the drain hot path calls key() ~7x per pod per round
        # (queue, cache, metrics bookkeeping). Not a dataclass field, so
        # dataclasses.replace() never copies it; shallow queue-admission
        # copies (scheduler._queue_copy) DO carry it deliberately —
        # name/namespace are identity and never mutated in place, so the
        # memo cannot go stale across the hop.
        k = self.__dict__.get("_key")
        if k is None:
            k = self.namespace + "/" + self.name
            self.__dict__["_key"] = k
        return k

    def has_pod_affinity(self) -> bool:
        """Any pod (anti-)affinity term, required or preferred. The ONE
        definition behind both the cache's aff_seq bumps and the engine's
        encoding-staleness accounting (ops/affinity._has_affinity) — the
        two counters must agree pod-for-pod or encoding reuse either
        thrashes or trusts stale topology arrays."""
        a = self.affinity
        return a is not None and (a.pod_affinity is not None
                                  or a.pod_anti_affinity is not None)

    def resource_request(self) -> Resource:
        """Sum of container requests — GetResourceRequest
        (reference: predicates.go:478 computePodResourceRequest; init
        containers take elementwise max, not modeled yet)."""
        out = Resource()
        for c in self.containers:
            out.milli_cpu += c.requests.get("cpu", 0)
            out.memory += c.requests.get("memory", 0)
            out.nvidia_gpu += c.requests.get("nvidia.com/gpu", 0)
            out.storage_scratch += c.requests.get("storage.kubernetes.io/scratch", 0)
            out.storage_overlay += c.requests.get("storage.kubernetes.io/overlay", 0)
            for k, v in c.requests.items():
                if k not in ("cpu", "memory", "nvidia.com/gpu",
                             "storage.kubernetes.io/scratch",
                             "storage.kubernetes.io/overlay"):
                    out.extended[k] = out.extended.get(k, 0) + v
        return out

    def nonzero_request(self) -> Tuple[int, int]:
        """(milli_cpu, memory) with per-container defaults for unset requests —
        reference: priorities/util/non_zero.go:36-50 (unset ≠ explicit zero)."""
        cpu = 0
        mem = 0
        for c in self.containers:
            cpu += c.requests["cpu"] if "cpu" in c.requests else DEFAULT_MILLI_CPU_REQUEST
            mem += c.requests["memory"] if "memory" in c.requests else DEFAULT_MEMORY_REQUEST
        return cpu, mem

    def used_ports(self) -> List[int]:
        """Host ports requested, deduplicated — schedutil.GetUsedPorts returns
        a map (reference: plugin/pkg/scheduler/util/utils.go), so duplicates
        collapse; dedup also keeps per-word port bits distinct for the
        scatter-add commit in engine/batch.py."""
        return list(dict.fromkeys(
            p.host_port for c in self.containers for p in c.ports if p.host_port != 0))

    def is_best_effort(self) -> bool:
        """True when no container has any request or limit — v1qos.GetPodQOS
        BestEffort case (reference: pkg/api/v1/helper/qos/qos.go)."""
        for c in self.containers:
            if c.requests or c.limits:
                return False
        return True


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------


class ConditionStatus(str, enum.Enum):
    TRUE = "True"
    FALSE = "False"
    UNKNOWN = "Unknown"


@dataclass
class NodeCondition:
    type: str  # Ready | MemoryPressure | DiskPressure | OutOfDisk | NetworkUnavailable
    status: ConditionStatus = ConditionStatus.FALSE


@dataclass
class ContainerImage:
    names: List[str] = field(default_factory=list)
    size_bytes: int = 0


@dataclass
class Node:
    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    allocatable: Resource = field(default_factory=Resource)
    # status.capacity when it differs from allocatable: the kubelet's
    # node-allocatable reservation (kube/system-reserved; pkg/kubelet/cm/
    # node_container_manager.go) publishes capacity - reserved as
    # allocatable. None = no reservation (capacity == allocatable).
    capacity: Optional[Resource] = None
    allowed_pod_number: int = 110
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False
    pod_cidr: str = ""  # spec.podCIDR (route controller, kubenet)
    conditions: List[NodeCondition] = field(default_factory=list)
    images: List[ContainerImage] = field(default_factory=list)
    # LastHeartbeatTime of the Ready condition (v1.NodeCondition) — written by
    # the kubelet status loop, read by the node lifecycle controller's
    # monitorNodeStatus (pkg/controller/node/node_controller.go:523)
    heartbeat: float = 0.0
    resource_version: int = 0

    def condition(self, ctype: str) -> ConditionStatus:
        for c in self.conditions:
            if c.type == ctype:
                return ConditionStatus(c.status)
        return ConditionStatus.UNKNOWN

    def is_ready(self) -> bool:
        """CheckNodeConditionPredicate truth (reference: predicates.go:1306-1337):
        Ready==True, OutOfDisk!=True-ish (must be False), NetworkUnavailable
        must be False, and not Unschedulable."""
        ok = True
        for c in self.conditions:
            if c.type == "Ready" and c.status != ConditionStatus.TRUE:
                ok = False
            elif c.type == "OutOfDisk" and c.status != ConditionStatus.FALSE:
                ok = False
            elif c.type == "NetworkUnavailable" and c.status != ConditionStatus.FALSE:
                ok = False
        if self.unschedulable:
            ok = False
        return ok


# ---------------------------------------------------------------------------
# Binding / events
# ---------------------------------------------------------------------------


@dataclass
class WorkloadObject:
    """Owner-ish object for SelectorSpreadPriority / ServiceAffinity: a
    Service, ReplicationController, ReplicaSet or StatefulSet reduced to the
    fields the scheduler reads — a namespaced label selector
    (reference: selector_spreading.go:59-85 getSelectors; algorithm listers
    GetPodServices/GetPodControllers/GetPodReplicaSets/GetPodStatefulSets).
    Services/RCs use map-equality selectors; RS/SS use LabelSelector."""

    kind: str  # Service | ReplicationController | ReplicaSet | StatefulSet
    name: str
    namespace: str = "default"
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[SelectorRequirement] = field(default_factory=list)
    resource_version: int = 0

    def selects(self, pod: "Pod") -> bool:
        if pod.namespace != self.namespace:
            return False
        if not self.match_labels and not self.match_expressions:
            return False  # nil/empty selector objects are skipped by listers
        for k, v in self.match_labels.items():
            if pod.labels.get(k) != v:
                return False
        return all(r.matches_labels(pod.labels) for r in self.match_expressions)


@dataclass
class Binding:
    """POST pods/<name>/binding payload — sets pod.spec.nodeName atomically
    (reference: pkg/registry/core/pod/storage/storage.go:128 BindingREST)."""

    pod_name: str
    pod_namespace: str
    pod_uid: str
    node_name: str


@dataclass
class Event:
    """tools/record-style event (reference: scheduler.go:174,248 emits
    Scheduled / FailedScheduling)."""

    object_key: str
    reason: str
    message: str
    type: str = "Normal"


def make_pod(
    name: str,
    namespace: str = "default",
    cpu: Optional[int] = None,
    memory: Optional[int] = None,
    gpu: Optional[int] = None,
    labels: Optional[Dict[str, str]] = None,
    node_selector: Optional[Dict[str, str]] = None,
    tolerations: Optional[List[Toleration]] = None,
    affinity: Optional[Affinity] = None,
    ports: Optional[List[int]] = None,
    node_name: str = "",
    owner: Tuple[str, str] = ("", ""),
    extended: Optional[Dict[str, int]] = None,
    volumes: Optional[List[Volume]] = None,
) -> Pod:
    """Test/bench convenience constructor (one container)."""
    requests: Dict[str, int] = {}
    if cpu is not None:
        requests["cpu"] = cpu
    if memory is not None:
        requests["memory"] = memory
    if gpu is not None:
        requests["nvidia.com/gpu"] = gpu
    if extended:
        requests.update(extended)
    container = Container(
        name="c0",
        requests=requests,
        ports=[ContainerPort(host_port=p) for p in (ports or [])],
    )
    return Pod(
        name=name,
        namespace=namespace,
        uid=namespace + "/" + name,
        labels=labels or {},
        containers=[container],
        volumes=volumes or [],
        node_selector=node_selector or {},
        tolerations=tolerations or [],
        affinity=affinity,
        node_name=node_name,
        owner_kind=owner[0],
        owner_name=owner[1],
    )


def make_node(
    name: str,
    cpu: int = 4000,
    memory: int = 32 * 1024 ** 3,
    pods: int = 110,
    gpu: int = 0,
    labels: Optional[Dict[str, str]] = None,
    taints: Optional[List[Taint]] = None,
    ready: bool = True,
    unschedulable: bool = False,
    extended: Optional[Dict[str, int]] = None,
) -> Node:
    """Bench node shape defaults match scheduler_perf
    (reference: test/integration/scheduler_perf/scheduler_test.go:49-68:
    4 CPU / 32Gi / 110 pods)."""
    return Node(
        name=name,
        labels=labels or {},
        allocatable=Resource(
            milli_cpu=cpu, memory=memory, nvidia_gpu=gpu, extended=dict(extended or {})
        ),
        allowed_pod_number=pods,
        taints=taints or [],
        unschedulable=unschedulable,
        conditions=[
            NodeCondition("Ready", ConditionStatus.TRUE if ready else ConditionStatus.FALSE),
            NodeCondition("MemoryPressure", ConditionStatus.FALSE),
            NodeCondition("DiskPressure", ConditionStatus.FALSE),
            NodeCondition("OutOfDisk", ConditionStatus.FALSE),
            NodeCondition("NetworkUnavailable", ConditionStatus.FALSE),
        ],
    )
