"""ResourceQuota + ServiceAccount/token + TTL + bootstrap controllers.

References:
- pkg/controller/resourcequota/resource_quota_controller.go: full
  recalculation of quota status.used from live objects on a resync cadence
  and on deletes (replenishment).
- pkg/controller/serviceaccount/serviceaccounts_controller.go: ensure the
  'default' ServiceAccount in every active namespace;
  tokens_controller.go: mint a token Secret per ServiceAccount.
- pkg/controller/ttl/ttl_controller.go: annotate nodes with a TTL for
  kubelet secret/configmap caching, stepped by cluster size.
- pkg/controller/bootstrap/{bootstrapsigner,tokencleaner}.go: sign the
  cluster-info ConfigMap with bootstrap tokens; delete expired tokens.
"""

from __future__ import annotations

import hashlib
import hmac
import time
from typing import Dict, Optional

from kubernetes_tpu_torch.api.cluster import Secret, ServiceAccount
from kubernetes_tpu_torch.client.informer import SharedInformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.quota import quota_scopes_match, usage_for, add_usage
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, Conflict, NotFound

QUOTA_KINDS = ("Pod", "Service", "ReplicationController", "Secret",
               "ConfigMap", "PersistentVolumeClaim")


class ResourceQuotaController(Controller):
    """Recompute status.used for each quota from live objects — the
    reconciliation that heals drift from the admission plugin's optimistic
    increments (resource_quota_controller.go syncResourceQuota)."""

    name = "resourcequota-controller"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 record_events: bool = True):
        super().__init__(api, record_events=record_events)
        self.informer = factory.informer("ResourceQuota")
        self.informer.add_event_handler(
            on_add=lambda o: self.enqueue(o.namespace + "/" + o.name),
            on_update=lambda o, n: self.enqueue(n.namespace + "/" + n.name))
        # replenishment: object churn of quota-tracked kinds requeues the
        # namespace's quotas (replenishment_controller.go watches deletes;
        # adds are watched too so usage heals promptly even for writes that
        # bypassed the admission plugin's optimistic increment)
        for kind in QUOTA_KINDS:
            factory.informer(kind).add_event_handler(
                on_add=lambda o, _k=kind: self._replenish(o),
                on_delete=lambda o, _k=kind: self._replenish(o))

    def _replenish(self, obj) -> None:
        ns = getattr(obj, "namespace", "")
        for q in self.informer.store.list():
            if q.namespace == ns:
                self.enqueue(q.namespace + "/" + q.name)

    def resync_all(self) -> None:
        for q in self.api.list("ResourceQuota")[0]:
            self.enqueue(q.namespace + "/" + q.name)

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            quota = self.api.get("ResourceQuota", namespace, name)
        except NotFound:
            return
        used: Dict[str, int] = {}
        for kind in QUOTA_KINDS:
            for obj in self.api.list(kind)[0]:
                if getattr(obj, "namespace", "") != namespace:
                    continue
                if not quota_scopes_match(quota.scopes, kind, obj):
                    continue
                add_usage(used, usage_for(kind, obj))
        tracked = {k: used.get(k, 0) for k in quota.hard}
        if tracked != quota.used:
            quota.used = tracked
            self.api.update("ResourceQuota", quota,
                            expect_rv=quota.resource_version)


class ServiceAccountController(Controller):
    """Ensure 'default' SA per active namespace + a token Secret per SA
    (serviceaccounts_controller.go + tokens_controller.go)."""

    name = "serviceaccount-controller"
    TOKEN_SECRET_TYPE = "kubernetes.io/service-account-token"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 token_issuer=None, record_events: bool = True):
        super().__init__(api, record_events=record_events)
        self.token_issuer = token_issuer  # ServiceAccountTokenAuthenticator
        factory.informer("Namespace").add_event_handler(
            on_add=lambda o: self.enqueue("ns/" + o.name),
            on_update=lambda o, n: self.enqueue("ns/" + n.name))
        factory.informer("ServiceAccount").add_event_handler(
            on_add=lambda o: self.enqueue("sa/" + o.namespace + "/" + o.name),
            on_delete=lambda o: self.enqueue("ns/" + o.namespace))

    def sync(self, key: str) -> None:
        parts = key.split("/")
        if parts[0] == "ns":
            self._ensure_default_sa(parts[1])
        else:
            self._ensure_token(parts[1], parts[2])

    def _ensure_default_sa(self, ns_name: str) -> None:
        try:
            ns = self.api.get("Namespace", "", ns_name)
        except NotFound:
            return
        if ns.phase != "Active":
            return
        try:
            self.api.get("ServiceAccount", ns_name, "default")
        except NotFound:
            try:
                self.api.create("ServiceAccount",
                                ServiceAccount("default", namespace=ns_name,
                                               uid=f"{ns_name}/default"))
            except Conflict:
                pass
            self.enqueue("sa/" + ns_name + "/default")

    def _ensure_token(self, ns: str, name: str) -> None:
        try:
            sa = self.api.get("ServiceAccount", ns, name)
        except NotFound:
            return
        secret_name = f"{name}-token"
        if secret_name in sa.secrets:
            return
        token = self.token_issuer.issue(ns, name, uid=sa.uid) \
            if self.token_issuer else f"fake-token-{ns}-{name}"
        try:
            self.api.create("Secret", Secret(
                secret_name, namespace=ns, type=self.TOKEN_SECRET_TYPE,
                data={"token": token, "namespace": ns},
                annotations={"kubernetes.io/service-account.name": name}))
        except Conflict:
            pass
        sa.secrets = list(sa.secrets) + [secret_name]
        self.api.update("ServiceAccount", sa, expect_rv=sa.resource_version)


class TTLController(Controller):
    """Node TTL annotation stepped by cluster size (ttl_controller.go
    ttlBoundaries: 0s <=100 nodes, 15s <=500, 30s <=1000, 60s <=2000,
    300s above)."""

    name = "ttl-controller"
    ANNOTATION = "node.alpha.kubernetes.io/ttl"
    BOUNDARIES = ((100, 0), (500, 15), (1000, 30), (2000, 60))

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 record_events: bool = True):
        super().__init__(api, record_events=record_events)
        self.informer = factory.informer("Node")
        self.informer.add_event_handler(
            on_add=lambda o: self.enqueue(o.name),
            on_update=lambda o, n: self.enqueue(n.name))

    def desired_ttl(self, n_nodes: int) -> int:
        for bound, ttl in self.BOUNDARIES:
            if n_nodes <= bound:
                return ttl
        return 300

    def sync(self, key: str) -> None:
        try:
            node = self.api.get("Node", "", key)
        except NotFound:
            return
        want = str(self.desired_ttl(len(self.informer.store)))
        if node.annotations.get(self.ANNOTATION) != want:
            node.annotations[self.ANNOTATION] = want
            self.api.update("Node", node, expect_rv=node.resource_version)


class BootstrapSignerController(Controller):
    """Sign the cluster-info ConfigMap with each bootstrap token
    (bootstrapsigner.go: jws-kubeconfig-<tokenID> HMAC entries)."""

    name = "bootstrap-signer"
    CLUSTER_INFO = "cluster-info"
    NS = "kube-public"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 record_events: bool = True):
        super().__init__(api, record_events=record_events)
        factory.informer("Secret").add_event_handler(
            on_add=lambda o: self.enqueue("sign"),
            on_update=lambda o, n: self.enqueue("sign"),
            on_delete=lambda o: self.enqueue("sign"))
        factory.informer("ConfigMap").add_event_handler(
            on_update=lambda o, n: self.enqueue("sign"))

    def sync(self, key: str) -> None:
        try:
            cm = self.api.get("ConfigMap", self.NS, self.CLUSTER_INFO)
        except NotFound:
            return
        kubeconfig = cm.data.get("kubeconfig", "")
        want = {k: v for k, v in cm.data.items()
                if not k.startswith("jws-kubeconfig-")}
        for s in self.api.list("Secret")[0]:
            if s.type != "bootstrap.kubernetes.io/token":
                continue
            tid = s.data.get("token-id", "")
            tsecret = s.data.get("token-secret", "")
            if not tid or not tsecret:
                continue
            sig = hmac.new((tid + "." + tsecret).encode(),
                           kubeconfig.encode(), hashlib.sha256).hexdigest()
            want["jws-kubeconfig-" + tid] = sig
        if want != cm.data:
            cm.data = want
            self.api.update("ConfigMap", cm, expect_rv=cm.resource_version)


class TokenCleanerController(Controller):
    """Delete expired bootstrap token secrets (tokencleaner.go)."""

    name = "token-cleaner"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 record_events: bool = True, now=time.time):
        super().__init__(api, record_events=record_events)
        self._now = now
        factory.informer("Secret").add_event_handler(
            on_add=lambda o: self.enqueue(o.namespace + "/" + o.name),
            on_update=lambda o, n: self.enqueue(n.namespace + "/" + n.name))

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            s = self.api.get("Secret", namespace, name)
        except NotFound:
            return
        if s.type != "bootstrap.kubernetes.io/token":
            return
        exp = s.data.get("expiration", "")
        if exp and float(exp) <= self._now():
            self.api.delete("Secret", namespace, name)
