"""StatefulSet controller — ordinal identity pods.

Mirrors pkg/controller/statefulset/stateful_set_control.go's ordered-ready
semantics: pods <name>-0 .. <name>-N-1; create ordinal i only once i-1 is
Running; scale down from the highest ordinal, one at a time. Each sync makes
one step; convergence via pod-status watch requeues.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.workloads import stamp_pod
from kubernetes_tpu_torch.client.informer import SharedInformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.controllers.replicaset import owner_uid_of
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, Conflict, NotFound
import dataclasses


class StatefulSetController(Controller):
    name = "statefulset-controller"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 record_events: bool = True):
        super().__init__(api, record_events=record_events)
        self.ss_informer = factory.informer("StatefulSet")
        self.pod_informer = factory.informer("Pod")
        self.ss_informer.add_event_handler(
            on_add=lambda o: self.enqueue(o.key()),
            on_update=lambda old, new: self.enqueue(new.key()))
        self.pod_informer.add_event_handler(
            on_add=self._on_pod, on_update=lambda o, n: self._on_pod(n),
            on_delete=self._on_pod)

    def _on_pod(self, pod) -> None:
        if pod.owner_kind == "StatefulSet" and pod.owner_name:
            self.enqueue(f"{pod.namespace}/{pod.owner_name}")

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            ss = self.api.get("StatefulSet", namespace, name)
        except NotFound:
            return
        my_uid = owner_uid_of("StatefulSet", namespace, name)
        owned = {p.name: p for p in self.pod_informer.store.list()
                 if p.owner_uid == my_uid and not p.deleted}
        # walk ordinals in order; create the first hole and stop (ordered-ready)
        ready = 0
        for i in range(ss.replicas):
            pod_name = f"{ss.name}-{i}"
            pod = owned.get(pod_name)
            if pod is None:
                stamped = stamp_pod(ss.template, pod_name, namespace,
                                    "StatefulSet", name)
                try:
                    self.api.create("Pod", stamped)
                except Conflict:
                    pass
                break
            if pod.phase != "Running":
                break  # wait for this ordinal before advancing
            ready += 1
        # scale down: delete highest ordinal beyond replicas, one per sync
        extra = sorted((n for n in owned
                        if self._ordinal(ss.name, n) >= ss.replicas),
                       key=lambda n: -self._ordinal(ss.name, n))
        if extra:
            try:
                self.api.delete("Pod", namespace, extra[0])
            except NotFound:
                pass
        if ss.ready_replicas != ready:
            fresh = self.api.get("StatefulSet", namespace, name)
            self.api.update("StatefulSet",
                            dataclasses.replace(fresh, ready_replicas=ready),
                            expect_rv=fresh.resource_version)

    @staticmethod
    def _ordinal(base: str, pod_name: str) -> int:
        try:
            return int(pod_name.rsplit("-", 1)[1])
        except (IndexError, ValueError):
            return -1
