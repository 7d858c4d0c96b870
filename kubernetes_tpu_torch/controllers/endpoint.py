"""Endpoints controller — Service selector -> ready pod addresses.

Mirrors pkg/controller/endpoint/endpoints_controller.go: for each Service,
the Endpoints object lists addresses of Running, non-deleted, bound pods
matching the selector. kube-proxy-lite (models/hollow.py HollowProxy)
consumes these to program its routing table.
"""

from __future__ import annotations

import dataclasses
import hashlib

from kubernetes_tpu_torch.api.workloads import Endpoints, EndpointAddress
from kubernetes_tpu_torch.client.informer import SharedInformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, Conflict, NotFound


def _pod_ip(pod_key: str) -> str:
    """Deterministic synthetic pod IP in 10/8 (stable across runs, unlike
    builtin hash() which is seed-randomized)."""
    h = hashlib.sha1(pod_key.encode()).digest()
    return f"10.{h[0]}.{h[1]}.{1 + h[2] % 254}"


class EndpointController(Controller):
    name = "endpoint-controller"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 record_events: bool = True):
        super().__init__(api, record_events=record_events)
        self.svc_informer = factory.informer("Service")
        self.pod_informer = factory.informer("Pod")
        self.svc_informer.add_event_handler(
            on_add=lambda o: self.enqueue(o.key()),
            on_update=lambda old, new: self.enqueue(new.key()),
            on_delete=lambda o: self.enqueue(o.key()))
        self.pod_informer.add_event_handler(
            on_add=self._on_pod,
            # both old and new: a label change out of a selector must requeue
            # the service that used to select the pod
            on_update=lambda o, n: (self._on_pod(o), self._on_pod(n)),
            on_delete=self._on_pod)

    def _on_pod(self, pod) -> None:
        # requeue services selecting this pod (endpoints_controller.go getPodServices)
        for svc in self.svc_informer.store.list():
            if svc.namespace != pod.namespace or not svc.selector:
                continue
            if all(pod.labels.get(k) == v for k, v in svc.selector.items()):
                self.enqueue(svc.key())

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            svc = self.api.get("Service", namespace, name)
        except NotFound:
            try:
                self.api.delete("Endpoints", namespace, name)
            except NotFound:
                pass
            return
        addrs = []
        if svc.selector:
            for p in self.pod_informer.store.list():
                if (p.namespace == namespace and not p.deleted
                        and p.phase == "Running" and p.node_name
                        and getattr(p, "ready", True)  # readiness gating
                        # (endpoints_controller.go only lists Ready pods)
                        and all(p.labels.get(k) == v
                                for k, v in svc.selector.items())):
                    addrs.append(EndpointAddress(
                        pod_key=p.key(), node_name=p.node_name,
                        ip=_pod_ip(p.key())))
        addrs.sort(key=lambda a: a.pod_key)
        try:
            cur = self.api.get("Endpoints", namespace, name)
            if cur.addresses != addrs:
                self.api.update("Endpoints",
                                dataclasses.replace(cur, addresses=addrs),
                                expect_rv=cur.resource_version)
        except NotFound:
            self.api.create("Endpoints",
                            Endpoints(name=name, namespace=namespace,
                                      addresses=addrs))
