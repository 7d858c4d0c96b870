"""Garbage collector + pod GC.

GarbageCollector: ownerRef-based cascade deletion
(pkg/controller/garbagecollector): an object whose controllerRef points at a
no-longer-existing owner is deleted. The reference builds a full dependency
graph from every resource; here the ownership DAG is two levels deep by
construction (Deployment -> ReplicaSet -> Pod; {RC,Job,DaemonSet,StatefulSet}
-> Pod), so the scan is direct.

PodGCController (pkg/controller/podgc/gc_controller.go): reaps terminated
pods beyond a threshold (oldest first) and pods bound to nodes that no
longer exist.
"""

from __future__ import annotations

from kubernetes_tpu_torch.client.informer import SharedInformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, NotFound

# gc_controller.go terminatedPodGCThreshold default (12500 in kube-controller-
# manager options); tests override
DEFAULT_TERMINATED_POD_THRESHOLD = 12500

_OWNER_KINDS = ("ReplicaSet", "ReplicationController", "Job", "DaemonSet",
                "StatefulSet", "Deployment")


class GarbageCollector(Controller):
    """Keys are "<kind>/<ns>/<name>" of a *dependent* to re-check."""

    name = "garbage-collector"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 record_events: bool = False):
        super().__init__(api, record_events=record_events)
        self.factory = factory
        self.pod_informer = factory.informer("Pod")
        self.rs_informer = factory.informer("ReplicaSet")
        for kind in _OWNER_KINDS:
            factory.informer(kind).add_event_handler(
                on_delete=lambda o, k=kind: self._on_owner_deleted(k, o))
        self.pod_informer.add_event_handler(
            on_add=lambda p: self._maybe_enqueue_pod(p))
        self.rs_informer.add_event_handler(
            on_add=lambda rs: self._maybe_enqueue_rs(rs))

    def _on_owner_deleted(self, kind: str, owner) -> None:
        ns = getattr(owner, "namespace", "")
        uid = f"{kind}/{ns}/{owner.name}"
        for p in self.pod_informer.store.list():
            if p.owner_uid == uid:
                self.enqueue(f"Pod/{p.namespace}/{p.name}")
        for rs in self.rs_informer.store.list():
            if rs.owner_kind == kind and rs.owner_name == owner.name \
                    and rs.namespace == ns:
                self.enqueue(f"ReplicaSet/{rs.namespace}/{rs.name}")

    def _maybe_enqueue_pod(self, pod) -> None:
        if pod.owner_kind:
            self.enqueue(f"Pod/{pod.namespace}/{pod.name}")

    def _maybe_enqueue_rs(self, rs) -> None:
        if rs.owner_kind:
            self.enqueue(f"ReplicaSet/{rs.namespace}/{rs.name}")

    def resync(self) -> None:
        """Full orphan scan (the reference's graph rebuild on sync)."""
        for p in self.pod_informer.store.list():
            if p.owner_kind:
                self.enqueue(f"Pod/{p.namespace}/{p.name}")
        for rs in self.rs_informer.store.list():
            if rs.owner_kind:
                self.enqueue(f"ReplicaSet/{rs.namespace}/{rs.name}")

    def sync(self, key: str) -> None:
        kind, namespace, name = key.split("/", 2)
        try:
            obj = self.api.get(kind, namespace, name)
        except NotFound:
            return
        owner_kind = getattr(obj, "owner_kind", "")
        owner_name = getattr(obj, "owner_name", "")
        if not owner_kind:
            return
        owner_ns = namespace  # owners are namespace-local
        try:
            self.api.get(owner_kind, owner_ns, owner_name)
        except NotFound:
            try:
                self.api.delete(kind, namespace, name)
            except NotFound:
                pass


class PodGCController(Controller):
    name = "podgc-controller"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 terminated_threshold: int = DEFAULT_TERMINATED_POD_THRESHOLD,
                 record_events: bool = False):
        super().__init__(api, record_events=record_events)
        self.pod_informer = factory.informer("Pod")
        self.node_informer = factory.informer("Node")
        self.terminated_threshold = terminated_threshold

    def resync(self) -> None:
        self.enqueue("gc")  # single periodic work item (gc_controller.go gc())

    def sync(self, key: str) -> None:
        pods = self.pod_informer.store.list()
        # 1. terminated pods beyond the threshold, oldest (lowest rv) first
        terminated = sorted(
            (p for p in pods if p.phase in ("Succeeded", "Failed")),
            key=lambda p: p.resource_version)
        excess = len(terminated) - self.terminated_threshold
        for p in terminated[:max(0, excess)]:
            self._delete(p)
        # 2. pods bound to vanished nodes (gcOrphaned)
        node_names = {n.name for n in self.node_informer.store.list()}
        for p in pods:
            if p.node_name and p.node_name not in node_names:
                self._delete(p)

    def _delete(self, pod) -> None:
        try:
            self.api.delete("Pod", pod.namespace, pod.name)
        except NotFound:
            pass
