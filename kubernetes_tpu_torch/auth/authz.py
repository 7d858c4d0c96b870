"""Authorizers: (user, verb, resource, ...) -> allow / no-opinion / deny.

Mirror of the reference's authorization modes
(pkg/kubeapiserver/authorizer/config.go: union of Node, ABAC, RBAC, webhook,
AlwaysAllow/AlwaysDeny — first authorizer with an opinion wins):

- RBAC:  plugin/pkg/auth/authorizer/rbac/rbac.go RBACAuthorizer.Authorize —
  visit all ClusterRoleBindings + namespace RoleBindings applying to the
  user, match rules by verb/apiGroup/resource/resourceName.
- Node:  plugin/pkg/auth/authorizer/node/node_authorizer.go — kubelets
  (group system:nodes, user system:node:<name>) restricted to their own
  Node object/status and to secrets/configmaps/PV/PVCs of pods bound to
  them (modeled via the api store's pod index).
- ABAC:  pkg/auth/authorizer/abac/abac.go — ordered policy list.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.rbac import (
    ClusterRole,
    ClusterRoleBinding,
    NODES_GROUP,
    Role,
    RoleBinding,
    UserInfo,
)

ALLOW = "allow"
DENY = "deny"
NO_OPINION = "no-opinion"


@dataclass
class Attributes:
    """authorizer.Attributes (apiserver/pkg/authorization/authorizer)."""

    user: UserInfo
    verb: str  # get|list|watch|create|update|patch|delete|...
    resource: str = ""  # plural, e.g. "pods" or "pods/binding"
    namespace: str = ""
    name: str = ""
    api_group: str = ""
    path: str = ""  # non-resource request path

    @property
    def is_resource_request(self) -> bool:
        return bool(self.resource)


class Forbidden(Exception):
    """Authorization denied (403)."""


class RBACAuthorizer:
    """Rule resolution over role/binding objects kept in the API store (the
    informer-backed registries of rbac.go's RoleGetter et al.)."""

    def __init__(self, store):
        # store must expose list(kind) -> (objects, rv)
        self._store = store

    def _roles_for(self, user: UserInfo, namespace: str):
        crbs, _ = self._store.list("ClusterRoleBinding")
        rbs, _ = self._store.list("RoleBinding")
        crs = {r.name: r for r in self._store.list("ClusterRole")[0]}
        rs = {(r.namespace, r.name): r
              for r in self._store.list("Role")[0]}
        for b in crbs:
            if b.role_ref and self._subject_matches(b.subjects, user, ""):
                role = crs.get(b.role_ref.name) \
                    if b.role_ref.kind == "ClusterRole" else None
                if role is not None:
                    yield role.rules, ""  # cluster-wide
        if namespace:
            for b in rbs:
                if b.namespace != namespace or not b.role_ref:
                    continue
                if not self._subject_matches(b.subjects, user, namespace):
                    continue
                if b.role_ref.kind == "ClusterRole":
                    role = crs.get(b.role_ref.name)
                    rules = role.rules if role else None
                else:
                    role = rs.get((namespace, b.role_ref.name))
                    rules = role.rules if role else None
                if rules is not None:
                    yield rules, namespace

    @staticmethod
    def _subject_matches(subjects, user: UserInfo, namespace: str) -> bool:
        for s in subjects:
            if s.kind == "User" and s.name == user.name:
                return True
            if s.kind == "Group" and s.name in user.groups:
                return True
            if s.kind == "ServiceAccount":
                sa_user = f"system:serviceaccount:{s.namespace or namespace}:{s.name}"
                if user.name == sa_user:
                    return True
        return False

    def authorize(self, attrs: Attributes) -> str:
        for rules, scope in self._roles_for(attrs.user, attrs.namespace):
            for rule in rules:
                if not attrs.is_resource_request:
                    if rule.matches_verb(attrs.verb) \
                            and rule.matches_non_resource_url(attrs.path):
                        return ALLOW
                    continue
                if (rule.matches_verb(attrs.verb)
                        and (not rule.api_groups
                             or "*" in rule.api_groups
                             or attrs.api_group in rule.api_groups)
                        and rule.matches_resource(attrs.resource)
                        and rule.matches_name(attrs.name)):
                    return ALLOW
        return NO_OPINION


class NodeAuthorizer:
    """Kubelet identity system:node:<name> limited to its own objects
    (plugin/pkg/auth/authorizer/node/node_authorizer.go): its Node + status,
    pods bound to it, and — for secrets/configmaps/PVCs/PVs — only GET of a
    NAMED object reachable from a pod bound to this node (the reference walks
    its graph of pod->secret/configmap/pvc->pv edges; here we walk the
    store's pod objects directly). Everything out of scope is NO_OPINION, not
    DENY, so a node identity that also holds other role bindings still gets
    RBAC's verdict (union semantics, node_authorizer.go:77-103)."""

    READ_VERBS = ("get", "list", "watch")

    def __init__(self, store):
        self._store = store
        # per-node reference-set cache keyed by store rv — the poor man's
        # node/graph.go: rebuilt only when the store has moved, so repeated
        # secret gets by the same kubelet don't rescan the pod table
        self._ref_cache: Dict[str, Tuple[int, set]] = {}

    def authorize(self, attrs: Attributes) -> str:
        user = attrs.user
        if NODES_GROUP not in user.groups \
                or not user.name.startswith("system:node:"):
            return NO_OPINION
        node_name = user.name[len("system:node:"):]
        res = attrs.resource
        if res in ("nodes", "nodes/status"):
            if attrs.name in ("", node_name):
                return ALLOW
            return NO_OPINION  # another node's object: leave it to RBAC
        if res in ("pods", "pods/status"):
            if attrs.verb in self.READ_VERBS:
                return ALLOW
            if not attrs.name:
                return NO_OPINION  # writes need a named pod
            pod = self._get("Pod", attrs.namespace, attrs.name)
            if pod is not None and getattr(pod, "node_name", "") == node_name:
                return ALLOW
            return NO_OPINION
        if res in ("secrets", "configmaps",
                   "persistentvolumeclaims", "persistentvolumes"):
            # only get-by-name, and only when a pod bound to this node
            # references the object (node_authorizer.go authorizeGet)
            if attrs.verb != "get" or not attrs.name:
                return NO_OPINION
            if self._reachable(res, attrs.namespace, attrs.name, node_name):
                return ALLOW
            return NO_OPINION
        if res in ("services", "endpoints"):
            if attrs.verb in self.READ_VERBS:
                return ALLOW
            return NO_OPINION
        if res == "events":
            if attrs.verb in ("create", "update", "patch"):
                return ALLOW
            return NO_OPINION
        return NO_OPINION

    def _reachable(self, res: str, ns: str, name: str, node: str) -> bool:
        """Is the named object referenced by any pod bound to `node`?
        (the graph edges of node/graph.go, walked into a cached per-node
        reference set, invalidated whenever the store rv moves)"""
        return (res, ns, name) in self._refs(node)

    def _refs(self, node: str) -> set:
        from kubernetes_tpu_torch.api.types import VolumeKind
        try:
            pods, rv = self._store.list("Pod")
        except Exception:
            return set()
        cached = self._ref_cache.get(node)
        if cached is not None and cached[0] == rv:
            return cached[1]
        kind_res = {VolumeKind.SECRET: "secrets",
                    VolumeKind.CONFIG_MAP: "configmaps",
                    VolumeKind.PVC: "persistentvolumeclaims"}
        refs: set = set()
        for pod in pods:
            if getattr(pod, "node_name", "") != node:
                continue
            pod_ns = getattr(pod, "namespace", "")
            for vol in getattr(pod, "volumes", None) or []:
                res = kind_res.get(vol.kind)
                if res is None:
                    continue
                refs.add((res, pod_ns, vol.volume_id))
                if vol.kind == VolumeKind.PVC:
                    pvc = self._get("PersistentVolumeClaim", pod_ns,
                                    vol.volume_id)
                    if pvc is not None and getattr(pvc, "volume_name", ""):
                        refs.add(("persistentvolumes", "", pvc.volume_name))
        # prune entries from older store revisions so the cache tracks only
        # the live rv (bounded by the node count)
        self._ref_cache = {n: v for n, v in self._ref_cache.items()
                           if v[0] == rv}
        self._ref_cache[node] = (rv, refs)
        return refs

    def _get(self, kind, ns, name):
        try:
            return self._store.get(kind, ns, name)
        except Exception:
            return None


@dataclass
class ABACPolicy:
    """pkg/apis/abac v1beta1 Policy line."""

    user: str = ""
    group: str = ""
    verb: str = "*"
    resource: str = "*"
    namespace: str = "*"
    readonly: bool = False


class ABACAuthorizer:
    """Ordered policy-file authorizer (pkg/auth/authorizer/abac)."""

    READ_VERBS = ("get", "list", "watch")

    def __init__(self, policies: List[ABACPolicy]):
        self.policies = list(policies)

    def authorize(self, attrs: Attributes) -> str:
        for p in self.policies:
            if p.user and p.user != "*" and p.user != attrs.user.name:
                continue
            if p.group and p.group != "*" and p.group not in attrs.user.groups:
                continue
            if p.readonly and attrs.verb not in self.READ_VERBS:
                continue
            if p.verb != "*" and p.verb != attrs.verb:
                continue
            if p.resource != "*" and p.resource != attrs.resource:
                continue
            if p.namespace != "*" and p.namespace != attrs.namespace:
                continue
            return ALLOW
        return NO_OPINION


class AlwaysAllowAuthorizer:
    def authorize(self, attrs: Attributes) -> str:
        return ALLOW


class AlwaysDenyAuthorizer:
    def authorize(self, attrs: Attributes) -> str:
        return DENY


class WebhookAuthorizer:
    """SubjectAccessReview-over-webhook stand-in: delegate to a callable
    (plugin/pkg/auth/authorizer/webhook)."""

    def __init__(self, fn: Callable[[Attributes], str]):
        self._fn = fn

    def authorize(self, attrs: Attributes) -> str:
        return self._fn(attrs)


class UnionAuthorizer:
    """First authorizer with an opinion wins (union.New)."""

    def __init__(self, authorizers: List):
        self.authorizers = list(authorizers)

    def authorize(self, attrs: Attributes) -> str:
        for a in self.authorizers:
            verdict = a.authorize(attrs)
            if verdict != NO_OPINION:
                return verdict
        return NO_OPINION
