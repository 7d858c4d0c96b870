"""The full apiserver: handler chain around the apiserver-lite store.

Mirror of DefaultBuildHandlerChain
(staging/src/k8s.io/apiserver/pkg/server/config.go:469) — the filters a
request traverses before the registry:

    panic-recovery -> request-info -> [timeout] -> authentication -> audit ->
    [impersonation] -> max-in-flight -> authorization -> admission ->
    registry strategy -> storage

plus the subresources the control plane depends on: pods/binding
(pkg/registry/core/pod/storage/storage.go:128 BindingREST), pods/status,
pods/eviction with PDB enforcement (pkg/registry/core/pod/storage/
eviction.go), scale for replicated workloads, and namespace two-phase
delete. Audit entries (apiserver/pkg/audit) land in a bounded ring.

Transport note (SURVEY.md §5.8): in-process calls are the fast path, the
HTTP facade (server/rest_http.py) exposes the same handler over REST for
out-of-process clients — the control-plane fabric stays request/response
exactly like the reference; the TPU fabric is the engine's device arrays.
"""

from __future__ import annotations

import threading
from kubernetes_tpu_torch.analysis import lockcheck
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.admission import (
    AdmissionChain,
    AdmissionRequest,
    Rejected,
    default_plugins,
)
from kubernetes_tpu_torch.api.cluster import Eviction
from kubernetes_tpu_torch.api.rbac import (
    UserInfo,
    bootstrap_cluster_role_bindings,
    bootstrap_cluster_roles,
)
from kubernetes_tpu_torch.api.types import Binding, Pod
from kubernetes_tpu_torch.api.workloads import pods_matching
from kubernetes_tpu_torch.auth.authn import Credential, Unauthenticated, UnionAuthenticator
from kubernetes_tpu_torch.auth.authz import (
    ALLOW,
    Attributes,
    DENY,
    Forbidden,
    NO_OPINION,
    NodeAuthorizer,
    RBACAuthorizer,
    UnionAuthorizer,
)
from kubernetes_tpu_torch.server.apiserver_lite import (
    ApiServerLite,
    Conflict,
    NotFound,
)
from kubernetes_tpu_torch.server.extensions import (
    crd_delete_cascade,
    crd_on_create,
    discovery_doc,
    resolve_crd,
    validate_custom_create,
)

# kind -> (resource plural, cluster-scoped)
KIND_INFO: Dict[str, Tuple[str, bool]] = {
    "Pod": ("pods", False),
    "Node": ("nodes", True),
    "Service": ("services", False),
    "Endpoints": ("endpoints", False),
    "Namespace": ("namespaces", True),
    "ReplicaSet": ("replicasets", False),
    "ReplicationController": ("replicationcontrollers", False),
    "Deployment": ("deployments", False),
    "StatefulSet": ("statefulsets", False),
    "DaemonSet": ("daemonsets", False),
    "Job": ("jobs", False),
    "CronJob": ("cronjobs", False),
    "PersistentVolume": ("persistentvolumes", True),
    "PersistentVolumeClaim": ("persistentvolumeclaims", False),
    "Secret": ("secrets", False),
    "ConfigMap": ("configmaps", False),
    "ServiceAccount": ("serviceaccounts", False),
    "ResourceQuota": ("resourcequotas", False),
    "LimitRange": ("limitranges", False),
    "PodDisruptionBudget": ("poddisruptionbudgets", False),
    "PriorityClass": ("priorityclasses", True),
    "StorageClass": ("storageclasses", True),
    "Role": ("roles", False),
    "ClusterRole": ("clusterroles", True),
    "RoleBinding": ("rolebindings", False),
    "ClusterRoleBinding": ("clusterrolebindings", True),
    "Event": ("events", False),
    "HorizontalPodAutoscaler": ("horizontalpodautoscalers", False),
    "CertificateSigningRequest": ("certificatesigningrequests", True),
    "CustomResourceDefinition": ("customresourcedefinitions", True),
    "APIService": ("apiservices", True),
    "PodSecurityPolicy": ("podsecuritypolicies", True),
}


class TooManyRequests(Exception):
    """429 — eviction blocked by a PodDisruptionBudget, or max-in-flight."""


class Invalid(Exception):
    """422 — registry strategy validation failure."""


@dataclass
class AuditEvent:
    """apiserver/pkg/audit event (one per request, ResponseComplete stage)."""

    user: str
    verb: str
    resource: str
    namespace: str
    name: str
    code: int
    ts: float = 0.0
    level: str = "Metadata"


@dataclass
class AuditRule:
    """One policy rule (apiserver/pkg/apis/audit Policy.Rules): first
    match wins; empty selector lists match everything."""

    level: str  # "None" | "Metadata" | "Request"
    users: List[str] = field(default_factory=list)
    verbs: List[str] = field(default_factory=list)
    resources: List[str] = field(default_factory=list)
    namespaces: List[str] = field(default_factory=list)

    def matches(self, user: str, verb: str, resource: str,
                namespace: str) -> bool:
        return ((not self.users or user in self.users)
                and (not self.verbs or verb in self.verbs)
                and (not self.resources or resource in self.resources)
                and (not self.namespaces or namespace in self.namespaces))


@dataclass
class AuditPolicy:
    """Policy-driven auditing (apiserver/pkg/audit/policy): the level for
    a request is the FIRST matching rule's; no match falls through to
    `default_level`. Level None suppresses the entry entirely."""

    rules: List[AuditRule] = field(default_factory=list)
    default_level: str = "Metadata"

    def level_for(self, user: str, verb: str, resource: str,
                  namespace: str) -> str:
        for rule in self.rules:
            if rule.matches(user, verb, resource, namespace):
                return rule.level
        return self.default_level


class ApiServer:
    """Authenticated/authorized/admitted facade over ApiServerLite.

    auth=False (default) keeps the open in-process behavior benches and
    controllers use (the reference's --insecure-port localhost path);
    auth=True enforces the full chain, like the secure port.
    """

    def __init__(self, store: Optional[ApiServerLite] = None,
                 authenticator: Optional[UnionAuthenticator] = None,
                 auth: bool = False,
                 admission: Optional[AdmissionChain] = None,
                 max_audit: int = 10_000,
                 audit_policy: Optional[AuditPolicy] = None,
                 now=time.time):
        self.store = store if store is not None else ApiServerLite()
        self.auth_enabled = auth
        self.authenticator = authenticator
        self.admission = admission if admission is not None else \
            AdmissionChain(default_plugins(), store=self.store)
        self.authorizer = UnionAuthorizer(
            [NodeAuthorizer(self.store), RBACAuthorizer(self.store)])
        self.audit_log: List[AuditEvent] = []
        self._max_audit = max_audit
        self.audit_policy = audit_policy if audit_policy is not None \
            else AuditPolicy()
        self._now = now
        self._audit_lock = lockcheck.make_lock("ApiServer._audit_lock")
        self._inflight = threading.Semaphore(400)  # --max-requests-inflight

    # ---------------------------------------------------------------- setup

    def bootstrap_rbac(self) -> None:
        """Install the bootstrap policy (rbac/bootstrappolicy) if absent —
        the post-start hook of the rbac rest storage provider."""
        existing = {r.name for r in self.store.list("ClusterRole")[0]}
        for role in bootstrap_cluster_roles():
            if role.name not in existing:
                self.store.create("ClusterRole", role)
        existing_b = {b.name for b in self.store.list("ClusterRoleBinding")[0]}
        for b in bootstrap_cluster_role_bindings():
            if b.name not in existing_b:
                self.store.create("ClusterRoleBinding", b)

    # ------------------------------------------------------------- the chain

    def _authn(self, cred: Optional[Credential]) -> UserInfo:
        return self._impersonate(self._authn_base(cred), cred)

    def _authn_base(self, cred: Optional[Credential]) -> UserInfo:
        if not self.auth_enabled:
            return UserInfo("system:admin", groups=["system:masters"])
        if cred is None or self.authenticator is None:
            raise Unauthenticated("no credentials provided")
        return self.authenticator.authenticate(cred)

    def _impersonate(self, user: UserInfo,
                     cred: Optional[Credential]) -> UserInfo:
        """The impersonation filter (endpoints/filters/impersonation.go):
        the AUTHENTICATED user needs the "impersonate" verb on users (and
        on groups for each requested group); the rest of the chain then
        sees the impersonated identity, with the real one recorded for
        audit attribution."""
        if cred is None or not cred.impersonate_user:
            return user
        checks = [("users", cred.impersonate_user)] + \
            [("groups", g) for g in cred.impersonate_groups]
        for resource, name in checks:
            attrs = Attributes(user=user, verb="impersonate",
                               resource=resource, namespace="", name=name)
            if self.authorizer.authorize(attrs) != ALLOW:
                raise Forbidden(
                    f'User "{user.name}" cannot impersonate '
                    f'{resource[:-1]} "{name}"')
        groups = list(cred.impersonate_groups)
        if "system:authenticated" not in groups:
            # every non-anonymous identity carries system:authenticated
            # (UnionAuthenticator appends it to real logins; the
            # impersonation filter must preserve the invariant or --as
            # stops previewing the impersonated user's real permissions)
            groups.append("system:authenticated")
        return UserInfo(cred.impersonate_user, groups=groups,
                        extra={"impersonated-by": user.name})

    def _serving_info(self, kind: str, for_write: bool = False):
        """Dynamic discovery: (plural, cluster_scoped, crd-or-None) for a
        served kind — built-in or backed by an Established CRD; anything
        else 404s like an unregistered resource on the real server
        (apiextensions customresource_handler.go)."""
        if kind in KIND_INFO:
            plural, cluster_scoped = KIND_INFO[kind]
            return plural, cluster_scoped, None
        crd = resolve_crd(self.store, kind, for_write=for_write)
        if crd is None:
            raise NotFound(
                f"the server could not find the requested resource "
                f"(kind {kind!r})")
        return crd.names.plural, crd.scope == "Cluster", crd

    def _authz(self, user: UserInfo, verb: str, kind: str, namespace: str,
               name: str, subresource: str = "") -> None:
        if not self.auth_enabled:
            return
        resource, cluster_scoped = KIND_INFO.get(kind, (kind.lower() + "s",
                                                        False))
        crd = None if kind in KIND_INFO else resolve_crd(self.store, kind)
        if crd is not None:
            resource, cluster_scoped = (crd.names.plural,
                                        crd.scope == "Cluster")
        if subresource:
            resource = resource + "/" + subresource
        attrs = Attributes(user=user, verb=verb, resource=resource,
                           namespace="" if cluster_scoped else namespace,
                           name=name)
        if self.authorizer.authorize(attrs) != ALLOW:
            raise Forbidden(
                f'User "{user.name}" cannot {verb} {resource} '
                f'in namespace "{namespace}"')

    def _audit(self, user: UserInfo, verb: str, kind: str, namespace: str,
               name: str, code: int) -> None:
        resource, _ = KIND_INFO.get(kind, (kind.lower() + "s", False))
        # policy decides the level per request; None drops the entry
        # (audit/policy checker.go LevelForRequest)
        level = self.audit_policy.level_for(user.name, verb, resource,
                                            namespace)
        if level == "None":
            return
        with self._audit_lock:
            self.audit_log.append(AuditEvent(
                user.name, verb, resource, namespace, name, code,
                ts=self._now(), level=level))
            if len(self.audit_log) > self._max_audit:
                del self.audit_log[: len(self.audit_log) - self._max_audit]

    def _run(self, cred, verb, kind, namespace, name, fn, subresource=""):
        """panic-recovery + authn + authz + audit around fn()."""
        with self._inflight:
            user = self._authn_base(cred)
            code = 200
            try:
                # impersonation INSIDE the audited span: a denied
                # escalation attempt must land in the audit log,
                # attributed to the REAL user with code 403
                user = self._impersonate(user, cred)
                self._authz(user, verb, kind, namespace, name, subresource)
                return fn(user)
            except Unauthenticated:
                code = 401
                raise
            except Forbidden:
                code = 403
                raise
            except Rejected:
                code = 403
                raise
            except NotFound:
                code = 404
                raise
            except Conflict:
                code = 409
                raise
            except TooManyRequests:
                code = 429
                raise
            except Invalid:
                code = 422
                raise
            finally:
                self._audit(user, verb, kind, namespace, name, code)

    # ---------------------------------------------------------------- verbs

    def create(self, kind: str, obj: Any,
               cred: Optional[Credential] = None) -> int:
        ns = getattr(obj, "namespace", "")

        def do(user: UserInfo) -> int:
            _, _, crd = self._serving_info(kind, for_write=True)
            if kind == "CustomResourceDefinition":
                # naming + establishing controller work, done atomically
                # at admission time (server/extensions.py)
                crd_on_create(self.store, obj, KIND_INFO)
            elif crd is not None:
                validate_custom_create(crd, obj)
            if self.auth_enabled and kind == "CertificateSigningRequest":
                # registry strategy PrepareForCreate: requestor identity is
                # stamped from the authenticated user, never client-supplied
                # (pkg/registry/certificates/certificates/strategy.go) —
                # else any CSR creator could claim system:bootstrappers and
                # mint auto-approved node certs
                obj.requestor = user.name
                obj.groups = list(user.groups)
            # admission (mutating) precedes registry strategy validation,
            # matching the chain order in the module doc — so defaults
            # applied by plugins are themselves validated
            req = AdmissionRequest(
                "CREATE", kind, ns, obj.name, obj=obj, user=user)
            self.admission.admit(req)
            try:
                self._validate(kind, obj, None)
                return self.store.create(kind, obj)
            except Exception:
                # undo admission side effects (quota usage CAS) so a failed
                # create doesn't leak usage until the controller resync
                self.admission.rollback(req)
                raise

        return self._run(cred, "create", kind, ns, obj.name, do)

    def get(self, kind: str, namespace: str, name: str,
            cred: Optional[Credential] = None) -> Any:
        def do(user: UserInfo) -> Any:
            self._serving_info(kind)
            return self.store.get(kind, namespace, name)

        return self._run(cred, "get", kind, namespace, name, do)

    def list(self, kind: str, cred: Optional[Credential] = None,
             namespace: str = "", field_selector: str = "",
             include_uninitialized: bool = False):
        """namespace="" = cluster-wide list (needs cluster-wide authority);
        a namespace scopes both the RBAC check and the result set, like the
        namespaced list endpoints. field_selector is the apimachinery
        fields axis ("spec.nodeName=n1,status.phase!=Failed") applied
        through the per-kind GetAttrs (api/fields.py).
        include_uninitialized=False hides objects with pending initializers
        (the ?includeUninitialized=true list knob of the 1.7 alpha
        initializers feature)."""

        def do(user: UserInfo):
            self._serving_info(kind)
            objs, rv = self.store.list(kind)
            if not include_uninitialized:
                from kubernetes_tpu_torch.admission.webhook import is_uninitialized
                objs = [o for o in objs if not is_uninitialized(o)]
            if namespace:
                objs = [o for o in objs
                        if getattr(o, "namespace", "") == namespace]
            if field_selector:
                from kubernetes_tpu_torch.api.fields import (
                    FieldSelectorError,
                    filter_objects,
                    parse_field_selector,
                )
                try:
                    objs = filter_objects(
                        kind, objs, parse_field_selector(field_selector))
                except FieldSelectorError as e:
                    raise Invalid(str(e)) from None
            return objs, rv

        return self._run(cred, "list", kind, namespace, "", do)

    def update(self, kind: str, obj: Any, expect_rv: Optional[int] = None,
               cred: Optional[Credential] = None) -> int:
        ns = getattr(obj, "namespace", "")

        def do(user: UserInfo) -> int:
            _, _, crd = self._serving_info(kind, for_write=True)
            if crd is not None:
                validate_custom_create(crd, obj)
            if kind == "CustomResourceDefinition":
                # updates re-run the naming/structure checks create
                # enforces — else a PUT could rename plural/kind/group
                # into a collision or break the plural.group invariant
                crd_on_create(self.store, obj, KIND_INFO)
            old = self._try_get(kind, ns, obj.name)
            if kind == "CertificateSigningRequest" and old is not None:
                # ValidateUpdate (certificates/strategy.go): the request
                # identity and spec are immutable after create — else an
                # updater could restore groups=[system:bootstrappers] and
                # re-open the escalation the create-time stamp closed
                if obj.requestor != old.requestor \
                        or list(obj.groups) != list(old.groups) \
                        or obj.cn != old.cn or list(obj.orgs) != list(old.orgs):
                    raise Invalid(
                        "CertificateSigningRequest spec and requestor "
                        "identity are immutable after creation")
                if self.auth_enabled and (obj.approved != old.approved
                                          or obj.denied != old.denied):
                    # approval flips require the approval subresource
                    # permission (certificates/approval gating)
                    self._authz(user, "update", kind, ns, obj.name,
                                subresource="approval")
            self.admission.admit(AdmissionRequest(
                "UPDATE", kind, ns, obj.name, obj=obj, old_obj=old,
                user=user))
            self._validate(kind, obj, old)
            return self.store.update(kind, obj, expect_rv=expect_rv)

        return self._run(cred, "update", kind, ns, obj.name, do)

    def delete(self, kind: str, namespace: str, name: str,
               cred: Optional[Credential] = None) -> None:
        def do(user: UserInfo) -> None:
            self._serving_info(kind)
            old = self._try_get(kind, namespace, name)
            self.admission.admit(AdmissionRequest(
                "DELETE", kind, namespace, name, old_obj=old, user=user))
            if kind == "CustomResourceDefinition":
                if old is None:
                    raise NotFound(
                        f"customresourcedefinitions {name!r} not found")
                # customresourcecleanup finalizer: purge instances
                # before the definition row goes away
                crd_delete_cascade(self.store, old)
                return
            if kind == "Namespace":
                # two-phase delete: mark Terminating; the namespace
                # controller empties it then finalizes (pkg/controller/
                # namespace + registry/core/namespace strategy)
                ns_obj = self.store.get("Namespace", "", name)
                if ns_obj.phase != "Terminating":
                    ns_obj.phase = "Terminating"
                    self.store.update("Namespace", ns_obj)
                    return
            self.store.delete(kind, namespace, name)

        return self._run(cred, "delete", kind, namespace, name, do)

    def watch_since(self, kinds, from_rv, timeout=None,
                    cred: Optional[Credential] = None):
        user = self._audited_authn(cred, "watch",
                                   kinds[0] if kinds else "")
        if self.auth_enabled:
            for k in kinds:
                try:
                    self._authz(user, "watch", k, "", "")
                except Forbidden:
                    # a denied watch is audited like every other denial
                    self._audit(user, "watch", k, "", "", 403)
                    raise
        if self.auth_enabled:
            # allowed watches audit too (secure port only: the in-process
            # insecure path is the scheduler/informer sync loop, whose
            # sub-second polls would flood the 10k ring and evict the 403
            # entries that matter; per-rule suppression via AuditPolicy
            # remains available for noisy authenticated watchers)
            for k in kinds:
                self._audit(user, "watch", k, "", "", 200)
        return self.store.watch_since(kinds, from_rv, timeout=timeout)

    def _audited_authn(self, cred, verb: str, kind: str) -> UserInfo:
        """authn + impersonation for the paths that bypass _run: a DENIED
        impersonation must land in the audit log attributed to the real
        user (code 403) on every entry point, not just the CRUD verbs."""
        user = self._authn_base(cred)
        try:
            return self._impersonate(user, cred)
        except Forbidden:
            self._audit(user, verb, kind, "", "", 403)
            raise

    # ----------------------------------------------------------- subresources

    def bind(self, binding: Binding, cred: Optional[Credential] = None) -> int:
        def do(user: UserInfo) -> int:
            return self.store.bind(binding)

        return self._run(cred, "create", "Pod", binding.pod_namespace,
                         binding.pod_name, do, subresource="binding")

    def bind_many(self, bindings, cred: Optional[Credential] = None):
        """Batched bindings with per-binding authorization (one RBAC check
        per distinct namespace — bindings in a namespace the caller cannot
        create pods/binding in are rejected without touching the store) and
        a single aggregated audit entry for the batch."""
        if not bindings:
            return []
        user = self._audited_authn(cred, "create", "Pod")
        if self.auth_enabled:
            try:
                for ns in {b.pod_namespace for b in bindings}:
                    self._authz(user, "create", "Pod", ns, "",
                                subresource="binding")
            except Forbidden:
                self._audit(user, "create", "Pod",
                            bindings[0].pod_namespace,
                            f"<batch of {len(bindings)} bindings>", 403)
                raise
        self._audit(user, "create", "Pod", bindings[0].pod_namespace,
                    f"<batch of {len(bindings)} bindings>", 200)
        return self.store.bind_many(bindings)

    def update_status(self, kind: str, obj: Any,
                      cred: Optional[Credential] = None) -> int:
        ns = getattr(obj, "namespace", "")

        def do(user: UserInfo) -> int:
            # status writes run the admission chain too (the reference's
            # subresource REST goes through the same handler chain) — this
            # is what lets NodeRestriction block cross-node pod status writes
            old = self._try_get(kind, ns, obj.name)
            self.admission.admit(AdmissionRequest(
                "UPDATE", kind, ns, obj.name, obj=obj, old_obj=old,
                user=user, subresource="status"))
            return self.store.update(kind, obj)

        return self._run(cred, "update", kind, ns, obj.name, do,
                         subresource="status")

    def evict(self, ev: Eviction, cred: Optional[Credential] = None) -> None:
        """pods/eviction (eviction.go): honor PodDisruptionBudgets — refuse
        with 429 when disruptions_allowed is exhausted."""

        def do(user: UserInfo) -> None:
            import copy as _copy
            for _ in range(10):  # CAS retry (eviction.go retries on Conflict)
                pod = self.store.get("Pod", ev.namespace, ev.pod_name)
                matching = [
                    pdb for pdb in self.store.list("PodDisruptionBudget")[0]
                    if pdb.namespace == ev.namespace
                    and pdb.selector is not None
                    and pods_matching(pdb, [pod])]
                if len(matching) > 1:
                    # eviction.go: "only one PodDisruptionBudget is allowed"
                    raise Invalid(
                        "This pod has more than one PodDisruptionBudget, "
                        "which the Eviction subresource does not support")
                if matching:
                    pdb = matching[0]
                    if pdb.disruptions_allowed <= 0:
                        raise TooManyRequests(
                            f"Cannot evict pod as it would violate the pod's "
                            f"disruption budget {pdb.name}")
                    npdb = _copy.deepcopy(pdb)
                    npdb.disruptions_allowed -= 1
                    try:
                        # guarded status update so concurrent evictions
                        # cannot overspend the budget (eviction.go
                        # checkAndDecrement via UpdateStatus + rv)
                        self.store.update("PodDisruptionBudget", npdb,
                                          expect_rv=pdb.resource_version)
                    except Conflict:
                        continue
                self.store.delete("Pod", ev.namespace, ev.pod_name)
                return
            raise Conflict("eviction: PodDisruptionBudget update conflicts")

        return self._run(cred, "create", "Pod", ev.namespace, ev.pod_name,
                         do, subresource="eviction")

    def scale(self, kind: str, namespace: str, name: str,
              replicas: Optional[int] = None,
              cred: Optional[Credential] = None) -> int:
        """The scale subresource (registry/.../scale): get or set replicas
        on RS/RC/Deployment/StatefulSet."""

        def do(user: UserInfo) -> int:
            obj = self.store.get(kind, namespace, name)
            if replicas is None:
                return obj.replicas
            if replicas < 0:
                raise Invalid("replicas must be >= 0")
            obj.replicas = replicas
            self.store.update(kind, obj)
            return replicas

        verb = "get" if replicas is None else "update"
        return self._run(cred, verb, kind, namespace, name, do,
                         subresource="scale")

    def finalize_namespace(self, name: str,
                           cred: Optional[Credential] = None) -> None:
        """namespaces/finalize: the namespace controller calls this once the
        namespace is empty; the store row is removed."""

        def do(user: UserInfo) -> None:
            self.store.delete("Namespace", "", name)

        return self._run(cred, "update", "Namespace", "", name, do,
                         subresource="finalize")

    # -------------------------------------------------------------- helpers

    def healthz(self) -> Dict[str, str]:
        return {"status": "ok"}

    def discovery(self) -> Dict[str, Any]:
        """/apis discovery document (group/version/resource triples for
        built-ins + Established CRDs + aggregated groups) — what the
        discovery client and `ktctl api-resources` consume."""
        try:
            apiservices = self.store.list("APIService")[0]
        except NotFound:
            apiservices = []
        return discovery_doc(self.store, KIND_INFO, apiservices)

    def configz(self) -> Dict[str, Any]:
        return {"admission": [type(p).__name__ for p in
                              self.admission.plugins],
                "authorization": ["Node", "RBAC"] if self.auth_enabled
                else ["AlwaysAllow"]}

    def _try_get(self, kind, ns, name):
        try:
            return self.store.get(kind, ns, name)
        except NotFound:
            return None

    def _validate(self, kind: str, obj: Any, old: Any) -> None:
        """Registry strategy validation (pkg/registry/core/*/strategy.go),
        the load-bearing subset."""
        name = getattr(obj, "name", "")
        if not name:
            raise Invalid(f"{kind}: metadata.name is required")
        if kind == "Pod":
            if old is not None and old.node_name and \
                    obj.node_name != old.node_name:
                raise Invalid("pod spec.nodeName is immutable after binding")
            for c in obj.containers:
                for res, v in list(c.requests.items()):
                    if v < 0:
                        raise Invalid(f"negative request {res}={v}")
                for res, v in c.limits.items():
                    if res in c.requests and c.requests[res] > v:
                        raise Invalid(
                            f"request {res} must be <= limit")
        elif kind in ("ReplicaSet", "ReplicationController", "Deployment",
                      "StatefulSet"):
            if getattr(obj, "replicas", 0) < 0:
                raise Invalid("spec.replicas must be >= 0")
