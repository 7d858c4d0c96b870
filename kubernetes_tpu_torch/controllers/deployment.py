"""Deployment controller: declarative rollout over child ReplicaSets.

Mirrors pkg/controller/deployment (deployment_controller.go + rolling.go):
- each template revision gets a child RS named <deployment>-<template-hash>
  with the pod-template-hash label (deployment_util.go GetNewReplicaSet).
- RollingUpdate scales the new RS up within maxSurge and old RSes down within
  maxUnavailable, using ready counts as availability
  (rolling.go reconcileNewReplicaSet/reconcileOldReplicaSets).
- Recreate semantics fall out of max_surge=0, max_unavailable=replicas.
Each sync makes one step of progress; convergence comes from requeueing on
child RS status updates — the same level-triggered loop as the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List

from kubernetes_tpu_torch.api.workloads import Deployment, ReplicaSet
from kubernetes_tpu_torch.client.informer import SharedInformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, Conflict, NotFound

TEMPLATE_HASH_LABEL = "pod-template-hash"


def template_hash(template) -> str:
    """Stable content hash of a pod template (fnv-of-spec analog,
    deployment_util.go GetPodTemplateSpecHash)."""
    blob = repr(dataclasses.asdict(template)).encode()
    return hashlib.sha1(blob).hexdigest()[:10]


class DeploymentController(Controller):
    name = "deployment-controller"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 record_events: bool = True):
        super().__init__(api, record_events=record_events)
        self.factory = factory
        self.dep_informer = factory.informer("Deployment")
        self.rs_informer = factory.informer("ReplicaSet")
        self.dep_informer.add_event_handler(
            on_add=lambda o: self.enqueue(o.key()),
            on_update=lambda old, new: self.enqueue(new.key()),
            on_delete=lambda o: self.enqueue(o.key()))
        self.rs_informer.add_event_handler(
            on_add=self._on_rs, on_update=lambda o, n: self._on_rs(n),
            on_delete=self._on_rs)

    def _on_rs(self, rs: ReplicaSet) -> None:
        if rs.owner_kind == "Deployment" and rs.owner_name:
            self.enqueue(f"{rs.namespace}/{rs.owner_name}")

    # ----------------------------------------------------------------- sync

    def _children(self, dep: Deployment) -> List[ReplicaSet]:
        return [rs for rs in self.rs_informer.store.list()
                if rs.namespace == dep.namespace
                and rs.owner_kind == "Deployment" and rs.owner_name == dep.name]

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            dep = self.api.get("Deployment", namespace, name)
        except NotFound:
            return  # GC collects children
        if dep.paused:
            return
        want_hash = template_hash(dep.template)
        children = self._children(dep)
        new_rs = next((rs for rs in children
                       if rs.labels.get(TEMPLATE_HASH_LABEL) == want_hash), None)
        old_rses = [rs for rs in children if rs is not new_rs]

        if new_rs is None:
            new_rs = self._create_new_rs(dep, want_hash)
            if new_rs is None:
                return  # name conflict; watch event requeues

        self._reconcile_scale(dep, new_rs, old_rses)
        ready = sum(rs.ready_replicas for rs in self._children(dep))
        if (dep.updated_replicas != new_rs.ready_replicas
                or dep.ready_replicas != ready):
            fresh = self.api.get("Deployment", namespace, name)
            self.api.update("Deployment", dataclasses.replace(
                fresh, updated_replicas=new_rs.ready_replicas,
                ready_replicas=ready), expect_rv=fresh.resource_version)

    def _create_new_rs(self, dep: Deployment, want_hash: str):
        labels = dict(dep.template.labels)
        labels[TEMPLATE_HASH_LABEL] = want_hash
        template = dataclasses.replace(dep.template, labels=labels)
        selector = dataclasses.replace(
            dep.selector,
            match_labels={**dep.selector.match_labels,
                          TEMPLATE_HASH_LABEL: want_hash})
        rs = ReplicaSet(
            name=f"{dep.name}-{want_hash}", namespace=dep.namespace,
            labels=labels, replicas=0, selector=selector, template=template,
            owner_kind="Deployment", owner_name=dep.name)
        try:
            self.api.create("ReplicaSet", rs)
        except Conflict:
            return None
        fresh_dep = self.api.get("Deployment", dep.namespace, dep.name)
        self.api.update("Deployment",
                        dataclasses.replace(fresh_dep,
                                            revision=fresh_dep.revision + 1),
                        expect_rv=fresh_dep.resource_version)
        self.event("Deployment", dep.key(), "Normal", "ScalingReplicaSet",
                   f"Created new replica set {rs.name}")
        return self.api.get("ReplicaSet", rs.namespace, rs.name)

    def _reconcile_scale(self, dep: Deployment, new_rs: ReplicaSet,
                         old_rses: List[ReplicaSet]) -> None:
        total = new_rs.replicas + sum(rs.replicas for rs in old_rses)
        max_total = dep.replicas + dep.max_surge
        if new_rs.replicas > dep.replicas:
            # deployment was scaled down: shrink the new RS directly
            # (rolling.go reconcileNewReplicaSet's scale-down branch)
            self._scale_rs(new_rs, dep.replicas)
            return
        # scale new up within the surge budget (rolling.go:54)
        grow = min(dep.replicas - new_rs.replicas, max_total - total)
        if grow > 0:
            self._scale_rs(new_rs, new_rs.replicas + grow)
        # scale old down within the availability budget (rolling.go:87):
        # ready pods may drop to at most replicas - max_unavailable
        if old_rses:
            ready_total = new_rs.ready_replicas + sum(
                rs.ready_replicas for rs in old_rses)
            min_ready = dep.replicas - dep.max_unavailable
            budget = ready_total - min_ready
            # also shed any not-ready surplus on old RSes for free
            for rs in sorted(old_rses, key=lambda r: r.name):
                if rs.replicas == 0:
                    continue
                unready = rs.replicas - rs.ready_replicas
                shed = unready + max(0, min(budget, rs.ready_replicas))
                shed = min(shed, rs.replicas)
                if shed > 0:
                    budget -= max(0, shed - unready)
                    self._scale_rs(rs, rs.replicas - shed)

    def _scale_rs(self, rs: ReplicaSet, replicas: int) -> None:
        try:
            fresh = self.api.get("ReplicaSet", rs.namespace, rs.name)
            self.api.update("ReplicaSet",
                            dataclasses.replace(fresh, replicas=replicas),
                            expect_rv=fresh.resource_version)
        except (Conflict, NotFound):
            pass  # watch event will requeue the deployment
