"""RBAC API group objects.

Mirror of the rbac.authorization.k8s.io/v1beta1 types the reference serves
(staging/src/k8s.io/api/rbac/v1beta1/types.go) and resolves in
plugin/pkg/auth/authorizer/rbac/rbac.go: PolicyRule matching with verb /
apiGroup / resource / resourceName / nonResourceURL wildcards, Roles bound to
subjects by RoleBindings (namespaced) and ClusterRoleBindings (global).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

WILDCARD = "*"


@dataclass
class PolicyRule:
    """rbac/v1beta1 PolicyRule (types.go:47-76)."""

    verbs: List[str] = field(default_factory=list)
    api_groups: List[str] = field(default_factory=list)
    resources: List[str] = field(default_factory=list)
    resource_names: List[str] = field(default_factory=list)
    non_resource_urls: List[str] = field(default_factory=list)

    def matches_verb(self, verb: str) -> bool:
        return WILDCARD in self.verbs or verb in self.verbs

    def matches_resource(self, resource: str) -> bool:
        if WILDCARD in self.resources:
            return True
        if resource in self.resources:
            return True
        # subresource rules: "pods/status" etc.; "*/status" wildcard form
        if "/" in resource:
            parent, sub = resource.split("/", 1)
            return ("*/" + sub) in self.resources
        return False

    def matches_name(self, name: str) -> bool:
        return not self.resource_names or name in self.resource_names

    def matches_non_resource_url(self, path: str) -> bool:
        for url in self.non_resource_urls:
            if url == WILDCARD or url == path:
                return True
            if url.endswith("*") and path.startswith(url[:-1]):
                return True
        return False


@dataclass
class Subject:
    """rbac Subject (types.go:78-98): kind User | Group | ServiceAccount."""

    kind: str
    name: str
    namespace: str = ""


@dataclass
class Role:
    name: str
    namespace: str = "default"
    rules: List[PolicyRule] = field(default_factory=list)
    resource_version: int = 0


@dataclass
class ClusterRole:
    name: str
    namespace: str = ""  # cluster-scoped
    rules: List[PolicyRule] = field(default_factory=list)
    resource_version: int = 0


@dataclass
class RoleRef:
    kind: str  # Role | ClusterRole
    name: str


@dataclass
class RoleBinding:
    name: str
    namespace: str = "default"
    subjects: List[Subject] = field(default_factory=list)
    role_ref: Optional[RoleRef] = None
    resource_version: int = 0


@dataclass
class ClusterRoleBinding:
    name: str
    namespace: str = ""  # cluster-scoped
    subjects: List[Subject] = field(default_factory=list)
    role_ref: Optional[RoleRef] = None
    resource_version: int = 0


@dataclass
class UserInfo:
    """authentication.k8s.io user.Info (the post-authentication identity —
    staging/src/k8s.io/apiserver/pkg/authentication/user/user.go)."""

    name: str
    groups: List[str] = field(default_factory=list)
    uid: str = ""
    extra: dict = field(default_factory=dict)

    def in_group(self, g: str) -> bool:
        return g in self.groups


SYSTEM_MASTERS = "system:masters"
SYSTEM_AUTHENTICATED = "system:authenticated"
SYSTEM_UNAUTHENTICATED = "system:unauthenticated"
NODES_GROUP = "system:nodes"
SERVICE_ACCOUNTS_GROUP = "system:serviceaccounts"


def bootstrap_cluster_roles() -> List[ClusterRole]:
    """The bootstrap policy slice relevant to the built-in components —
    plugin/pkg/auth/authorizer/rbac/bootstrappolicy/policy.go: cluster-admin,
    admin/edit/view aggregates (flattened), and the component roles the
    scheduler/controller-manager/kubelet/proxy run under."""
    rule = PolicyRule
    return [
        ClusterRole("cluster-admin", rules=[
            rule(verbs=[WILDCARD], api_groups=[WILDCARD], resources=[WILDCARD]),
            rule(verbs=[WILDCARD], non_resource_urls=[WILDCARD]),
        ]),
        ClusterRole("admin", rules=[
            rule(verbs=[WILDCARD], api_groups=[WILDCARD], resources=[WILDCARD]),
        ]),
        ClusterRole("edit", rules=[
            rule(verbs=["get", "list", "watch", "create", "update", "patch",
                        "delete"],
                 api_groups=[WILDCARD], resources=[WILDCARD]),
        ]),
        ClusterRole("view", rules=[
            rule(verbs=["get", "list", "watch"], api_groups=[WILDCARD],
                 resources=[WILDCARD]),
        ]),
        ClusterRole("system:kube-scheduler", rules=[
            rule(verbs=["get", "list", "watch"], api_groups=[""],
                 resources=["pods", "nodes", "persistentvolumes",
                            "persistentvolumeclaims", "services",
                            "replicationcontrollers", "replicasets",
                            "statefulsets"]),
            rule(verbs=["create"], api_groups=[""],
                 resources=["pods/binding", "bindings", "events"]),
            rule(verbs=["update", "patch"], api_groups=[""],
                 resources=["pods/status", "events"]),
            rule(verbs=["get", "create", "update"], api_groups=[""],
                 resources=["endpoints", "configmaps"]),  # leader election
        ]),
        ClusterRole("system:kube-controller-manager", rules=[
            rule(verbs=[WILDCARD], api_groups=[WILDCARD],
                 resources=[WILDCARD]),
        ]),
        ClusterRole("system:node", rules=[
            rule(verbs=["get", "list", "watch"], api_groups=[""],
                 resources=["pods", "services", "endpoints", "nodes"]),
            # secrets/configmaps/PV/PVC are deliberately ABSENT: access is
            # granted per-object by the NodeAuthorizer's reachability check
            # (get of objects referenced by pods bound to the node) — an
            # RBAC grant here would bypass that scoping via union semantics
            # (the reference drops these from the role when Node
            # authorization is enabled)
            rule(verbs=["create", "update", "patch", "delete"],
                 api_groups=[""],
                 resources=["nodes", "nodes/status", "pods", "pods/status",
                            "events"]),
        ]),
        ClusterRole("system:node-proxier", rules=[
            rule(verbs=["get", "list", "watch"], api_groups=[""],
                 resources=["services", "endpoints", "nodes"]),
            rule(verbs=["create", "update", "patch"], api_groups=[""],
                 resources=["events"]),
        ]),
    ]


def bootstrap_cluster_role_bindings() -> List[ClusterRoleBinding]:
    """bootstrappolicy/policy.go ClusterRoleBindings: system:masters ->
    cluster-admin, component users -> component roles, nodes group ->
    system:node."""
    return [
        ClusterRoleBinding(
            "cluster-admin",
            subjects=[Subject("Group", SYSTEM_MASTERS)],
            role_ref=RoleRef("ClusterRole", "cluster-admin")),
        ClusterRoleBinding(
            "system:kube-scheduler",
            subjects=[Subject("User", "system:kube-scheduler")],
            role_ref=RoleRef("ClusterRole", "system:kube-scheduler")),
        ClusterRoleBinding(
            "system:kube-controller-manager",
            subjects=[Subject("User", "system:kube-controller-manager")],
            role_ref=RoleRef("ClusterRole", "system:kube-controller-manager")),
        ClusterRoleBinding(
            "system:node",
            subjects=[Subject("Group", NODES_GROUP)],
            role_ref=RoleRef("ClusterRole", "system:node")),
        ClusterRoleBinding(
            "system:node-proxier",
            subjects=[Subject("User", "system:kube-proxy")],
            role_ref=RoleRef("ClusterRole", "system:node-proxier")),
    ]
