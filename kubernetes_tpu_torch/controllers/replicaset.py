"""ReplicaSet / ReplicationController reconciler.

Mirrors pkg/controller/replicaset/replica_set.go (and replication/, which the
reference implements as a thin fork of the same logic): syncReplicaSet diffs
spec.replicas against filtered live pods, then issues slow-start batched
creates or ranked deletes, then writes status. One class serves both kinds —
the only difference is the selector type (workloads.selector_of).

Adoption: matching orphan pods (no ownerRef) are claimed by stamping the
controllerRef, the PodControllerRefManager behavior
(pkg/controller/controller_ref_manager.go).
"""

from __future__ import annotations

import dataclasses
from typing import List

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.api.workloads import pods_matching, selector_of, stamp_pod
from kubernetes_tpu_torch.client.informer import SharedInformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, Conflict, NotFound

# controller_utils.go SlowStartInitialBatchSize
SLOW_START_INITIAL_BATCH = 1
# replica_set.go BurstReplicas
BURST_REPLICAS = 500


def _active(pod: Pod) -> bool:
    """controller.IsPodActive: not deleted, not terminated."""
    return not pod.deleted and pod.phase not in ("Succeeded", "Failed")


def _deletion_rank(pod: Pod) -> tuple:
    """ActivePods sort order (controller_utils.go:722 ActivePods.Less):
    prefer deleting unassigned, then pending, then not-running — i.e. the
    cheapest pods die first."""
    return (
        pod.node_name != "",        # unassigned first
        pod.phase != "Pending",     # pending before running
        pod.phase == "Running",     # running last
    )


def owner_uid_of(kind: str, namespace: str, name: str) -> str:
    return f"{kind}/{namespace}/{name}"


class ReplicaSetController(Controller):
    """Also serves ReplicationController via kind='ReplicationController'."""

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 kind: str = "ReplicaSet", record_events: bool = True):
        self.kind = kind
        self.name = kind.lower() + "-controller"
        super().__init__(api, record_events=record_events)
        self.factory = factory
        self.rs_informer = factory.informer(kind)
        self.pod_informer = factory.informer("Pod")
        self._suffix = 0
        self.rs_informer.add_event_handler(
            on_add=lambda o: self.enqueue(o.key()),
            on_update=lambda old, new: self.enqueue(new.key()),
            on_delete=lambda o: self.enqueue(o.key()))
        # pod events requeue the owning controller (addPod :228 / deletePod :345)
        self.pod_informer.add_event_handler(
            on_add=self._on_pod, on_update=lambda o, n: self._on_pod(n),
            on_delete=self._on_pod)

    def _on_pod(self, pod: Pod) -> None:
        if pod.owner_kind == self.kind and pod.owner_name:
            self.enqueue(f"{pod.namespace}/{pod.owner_name}")

    # ----------------------------------------------------------------- sync

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            rs = self.api.get(self.kind, namespace, name)
        except NotFound:
            return  # cascade deletion is the GC controller's job
        my_uid = owner_uid_of(self.kind, namespace, name)
        # Selector must select the template's pods, or every create is an
        # invisible orphan and the diff never closes -> unbounded creation.
        # The real apiserver rejects this at validation
        # (pkg/apis/extensions/validation ValidateReplicaSetSpec).
        effective_labels = rs.template.labels or dict(
            getattr(rs, "labels", {}) or {})
        if not selector_of(rs).matches(effective_labels):
            self.event(self.kind, rs.key(), "Warning", "SelectorMismatch",
                       "selector does not match pod template labels")
            return
        pods = pods_matching(rs, self.pod_informer.store.list())
        owned: List[Pod] = []
        for p in pods:
            if p.owner_uid == my_uid:
                owned.append(p)
            elif not p.owner_kind:  # adopt matching orphan
                claimed = dataclasses.replace(
                    p, owner_kind=self.kind, owner_name=name, owner_uid=my_uid)
                try:
                    self.api.update("Pod", claimed, expect_rv=p.resource_version)
                    owned.append(claimed)
                except (Conflict, NotFound):
                    pass  # retry via requeue on the watch event
        active = [p for p in owned if _active(p)]
        diff = rs.replicas - len(active)
        if diff > 0:
            self._create_pods(rs, min(diff, BURST_REPLICAS))
        elif diff < 0:
            self._delete_pods(active, -diff)
        # IsPodReady, not just phase: a Running pod failing its readiness
        # probe is not ready (replica_set.go calculateStatus)
        ready = sum(1 for p in active
                    if p.phase == "Running" and getattr(p, "ready", True))
        if rs.observed_replicas != len(active) or rs.ready_replicas != ready:
            fresh = self.api.get(self.kind, namespace, name)
            updated = dataclasses.replace(
                fresh, observed_replicas=len(active), ready_replicas=ready)
            self.api.update(self.kind, updated, expect_rv=fresh.resource_version)

    def _create_pods(self, rs, count: int) -> None:
        """Slow-start batching: 1, 2, 4, ... so a crash-looping template fails
        fast (controller_utils.go slowStartBatch)."""
        remaining = count
        batch = SLOW_START_INITIAL_BATCH
        while remaining > 0:
            n = min(batch, remaining)
            failures = 0
            for _ in range(n):
                if not self._create_one(rs):
                    failures += 1
            if failures:
                return  # stop the ramp; requeue comes from watch/backoff
            remaining -= n
            batch *= 2

    def _create_one(self, rs) -> bool:
        template = rs.template
        if not template.labels:
            template = dataclasses.replace(
                template, labels=dict(getattr(rs, "labels", {}) or {}))
        for _ in range(20):  # name collision retry
            self._suffix += 1
            pod_name = f"{rs.name}-{self._suffix:05d}"
            pod = stamp_pod(template, pod_name, rs.namespace,
                            self.kind, rs.name)
            try:
                self.api.create("Pod", pod)
                self.event(self.kind, rs.key(), "Normal", "SuccessfulCreate",
                           f"Created pod {pod_name}")
                return True
            except Conflict:
                continue
        return False

    def _delete_pods(self, active: List[Pod], count: int) -> None:
        victims = sorted(active, key=_deletion_rank)[:count]
        for p in victims:
            try:
                self.api.delete("Pod", p.namespace, p.name)
                self.event(self.kind, f"{p.namespace}/{p.owner_name}", "Normal",
                           "SuccessfulDelete", f"Deleted pod {p.name}")
            except NotFound:
                pass
