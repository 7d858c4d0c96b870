"""Cluster-scoped / config API objects consumed by the apiserver chain:
quota, limits, service accounts, secrets, configmaps, disruption budgets.

References: pkg/api/types.go ResourceQuota/LimitRange/ServiceAccount/Secret/
ConfigMap; pkg/apis/policy/types.go PodDisruptionBudget + Eviction
(the pods/eviction subresource consumes Eviction,
pkg/registry/core/pod/storage/eviction.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.types import LabelSelector


@dataclass
class ResourceQuota:
    """ResourceQuota (pkg/api/types.go; enforced by the resourcequota
    admission controller + recomputed by the quota controller). `hard` and
    `used` are resource-name -> integer quantity (canonical units: millicores
    for cpu, bytes for memory, counts otherwise)."""

    name: str
    namespace: str = "default"
    hard: Dict[str, int] = field(default_factory=dict)
    used: Dict[str, int] = field(default_factory=dict)
    # scopes: Terminating | NotTerminating | BestEffort | NotBestEffort
    scopes: List[str] = field(default_factory=list)
    resource_version: int = 0


@dataclass
class LimitRangeItem:
    """LimitRangeItem (type Container|Pod): min/max/default/defaultRequest
    per resource name."""

    type: str = "Container"
    min: Dict[str, int] = field(default_factory=dict)
    max: Dict[str, int] = field(default_factory=dict)
    default: Dict[str, int] = field(default_factory=dict)  # default limits
    default_request: Dict[str, int] = field(default_factory=dict)


@dataclass
class LimitRange:
    name: str
    namespace: str = "default"
    limits: List[LimitRangeItem] = field(default_factory=list)
    resource_version: int = 0


@dataclass
class ServiceAccount:
    name: str
    namespace: str = "default"
    secrets: List[str] = field(default_factory=list)  # token secret names
    image_pull_secrets: List[str] = field(default_factory=list)
    automount_token: bool = True
    resource_version: int = 0
    uid: str = ""


@dataclass
class Secret:
    name: str
    namespace: str = "default"
    type: str = "Opaque"  # kubernetes.io/service-account-token for SA tokens
    data: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    resource_version: int = 0


@dataclass
class ConfigMap:
    name: str
    namespace: str = "default"
    data: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    resource_version: int = 0


@dataclass
class PodDisruptionBudget:
    """policy/v1beta1 PDB (pkg/apis/policy/types.go): minAvailable gate
    consumed by the eviction subresource + maintained by the disruption
    controller."""

    name: str
    namespace: str = "default"
    min_available: int = 0
    selector: Optional[LabelSelector] = None
    # status (disruption controller): currently healthy / allowed disruptions
    current_healthy: int = 0
    desired_healthy: int = 0
    disruptions_allowed: int = 0
    expected_pods: int = 0
    resource_version: int = 0


@dataclass
class StorageClass:
    """storage.k8s.io/v1 StorageClass (staging/src/k8s.io/api/storage/v1/
    types.go): the provisioner + parameters the PV dynamic-provisioning
    story keys off; cluster-scoped."""

    name: str
    provisioner: str = "kubernetes.io/no-provisioner"
    parameters: Dict[str, str] = field(default_factory=dict)
    reclaim_policy: str = "Delete"  # Delete | Retain
    # the is-default-class marker (the beta annotation in v1.7) the
    # StorageClassDefault admission plugin keys on
    is_default: bool = False
    namespace: str = ""  # cluster-scoped; kept for store uniformity
    resource_version: int = 0


@dataclass
class Eviction:
    """The pods/eviction subresource body."""

    pod_name: str
    namespace: str = "default"


@dataclass
class CertificateSigningRequest:
    """certificates.k8s.io CSR (pkg/apis/certificates/types.go): a kubelet
    requests a client identity; csrapproving auto-approves node requests
    from bootstrap identities, csrsigning signs approved requests. The
    'certificate' issued is the signed identity record CertAuthenticator
    verifies (auth/authn.py)."""

    name: str
    namespace: str = ""  # cluster-scoped
    requestor: str = ""  # authenticated user who posted the CSR
    groups: List[str] = field(default_factory=list)
    cn: str = ""  # requested common name (system:node:<name>)
    orgs: List[str] = field(default_factory=list)  # requested groups
    approved: bool = False
    denied: bool = False
    certificate: Optional[dict] = None  # signed record once issued
    resource_version: int = 0
