"""DaemonSet controller — one pod per eligible node.

Mirrors pkg/controller/daemon/daemoncontroller.go: nodeShouldRunDaemonPod
checks node readiness, unschedulable, the template's node selector, and
taint toleration; the controller writes pods with spec.nodeName set directly,
bypassing the scheduler (the 1.7 behavior — scheduled DaemonSets came later).
"""

from __future__ import annotations

import dataclasses

from kubernetes_tpu_torch.api.types import Node, Pod, TaintEffect
from kubernetes_tpu_torch.api.workloads import stamp_pod
from kubernetes_tpu_torch.client.informer import SharedInformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.controllers.replicaset import owner_uid_of
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, Conflict, NotFound


def node_should_run(ds_template: Pod, node: Node) -> bool:
    """nodeShouldRunDaemonPod, reduced to the checks our model carries:
    Ready condition, unschedulable (DS tolerates it in 1.7 only via
    annotation — we require schedulable), node selector, NoSchedule/NoExecute
    taints vs template tolerations."""
    if not node.is_ready():
        return False
    for k, v in ds_template.node_selector.items():
        if node.labels.get(k) != v:
            return False
    for taint in node.taints:
        if taint.effect in (TaintEffect.NO_SCHEDULE, TaintEffect.NO_EXECUTE):
            if not any(t.tolerates(taint) for t in ds_template.tolerations):
                return False
    return True


class DaemonSetController(Controller):
    name = "daemonset-controller"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 record_events: bool = True):
        super().__init__(api, record_events=record_events)
        self.ds_informer = factory.informer("DaemonSet")
        self.node_informer = factory.informer("Node")
        self.pod_informer = factory.informer("Pod")
        self.ds_informer.add_event_handler(
            on_add=lambda o: self.enqueue(o.key()),
            on_update=lambda old, new: self.enqueue(new.key()))
        # node add/change re-evaluates every DS (daemoncontroller.go addNode)
        self.node_informer.add_event_handler(
            on_add=lambda n: self._enqueue_all(),
            on_update=lambda o, n: self._enqueue_all(),
            on_delete=lambda n: self._enqueue_all())
        self.pod_informer.add_event_handler(
            on_delete=self._on_pod)

    def _enqueue_all(self) -> None:
        for ds in self.ds_informer.store.list():
            self.enqueue(ds.key())

    def _on_pod(self, pod) -> None:
        if pod.owner_kind == "DaemonSet" and pod.owner_name:
            self.enqueue(f"{pod.namespace}/{pod.owner_name}")

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            ds = self.api.get("DaemonSet", namespace, name)
        except NotFound:
            return
        my_uid = owner_uid_of("DaemonSet", namespace, name)
        by_node = {}
        for p in self.pod_informer.store.list():
            if p.owner_uid == my_uid and not p.deleted:
                by_node.setdefault(p.node_name, []).append(p)
        nodes = self.node_informer.store.list()
        desired = current = 0
        for node in nodes:
            should = node_should_run(ds.template, node)
            have = by_node.pop(node.name, [])
            if should:
                desired += 1
                if not have:
                    pod = stamp_pod(ds.template, f"{ds.name}-{node.name}",
                                    namespace, "DaemonSet", name)
                    pod = dataclasses.replace(pod, node_name=node.name)
                    try:
                        self.api.create("Pod", pod)
                        current += 1
                    except Conflict:
                        pass
                else:
                    current += 1
                    for extra in have[1:]:  # dedupe
                        self._delete(extra)
            else:
                for p in have:
                    self._delete(p)
        for orphaned in by_node.values():  # pods on vanished nodes
            for p in orphaned:
                self._delete(p)
        if (ds.desired_scheduled, ds.current_scheduled) != (desired, current):
            fresh = self.api.get("DaemonSet", namespace, name)
            self.api.update("DaemonSet", dataclasses.replace(
                fresh, desired_scheduled=desired, current_scheduled=current),
                expect_rv=fresh.resource_version)

    def _delete(self, pod) -> None:
        try:
            self.api.delete("Pod", pod.namespace, pod.name)
        except NotFound:
            pass
