"""Namespace lifecycle controller (pkg/controller/namespace).

Two-phase delete: delete_namespace() marks the Namespace Terminating (the
apiserver's finalizer-gated delete); the controller then deletes every
namespaced object in it and finally removes the Namespace itself
(namespaced_resources_deleter.go Delete).
"""

from __future__ import annotations

import dataclasses

from kubernetes_tpu_torch.api.workloads import Namespace
from kubernetes_tpu_torch.client.informer import SharedInformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, Conflict, NotFound

# every namespaced kind the store can hold (the deleter's dynamic discovery
# equivalent — SURVEY.md §2.2 namespace controller)
NAMESPACED_KINDS = (
    "Pod", "Service", "Endpoints", "ReplicaSet", "ReplicationController",
    "Deployment", "Job", "DaemonSet", "StatefulSet",
    "PersistentVolumeClaim", "Event", "ResourceQuota", "LimitRange",
)


def delete_namespace(api: ApiServerLite, name: str) -> None:
    """The DELETE /namespaces/<name> behavior: flip to Terminating."""
    ns: Namespace = api.get("Namespace", "", name)
    if ns.phase != "Terminating":
        api.update("Namespace", dataclasses.replace(ns, phase="Terminating"),
                   expect_rv=ns.resource_version)


class NamespaceController(Controller):
    name = "namespace-controller"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 record_events: bool = False):
        super().__init__(api, record_events=record_events)
        self.ns_informer = factory.informer("Namespace")
        self.ns_informer.add_event_handler(
            on_add=lambda o: self.enqueue(o.name),
            on_update=lambda old, new: self.enqueue(new.name))

    def sync(self, key: str) -> None:
        try:
            ns = self.api.get("Namespace", "", key)
        except NotFound:
            return
        if ns.phase != "Terminating":
            return
        remaining = 0
        for kind in NAMESPACED_KINDS:
            objs, _ = self.api.list(kind)
            for obj in objs:
                if getattr(obj, "namespace", None) == key:
                    remaining += 1
                    try:
                        self.api.delete(kind, key, obj.name)
                    except NotFound:
                        pass
        if remaining == 0:
            try:
                self.api.delete("Namespace", "", key)
            except NotFound:
                pass
        else:
            self.enqueue(key)  # re-check until empty
