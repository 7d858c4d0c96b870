"""Job controller — run pods to completion (pkg/controller/job/jobcontroller.go).

syncJob counts owned pods by phase: active (Pending/Running) backfill up to
min(parallelism, completions - succeeded); succeeded >= completions marks the
job complete and leaves terminated pods in place (the reference keeps them
for log retrieval; podgc reaps them past the threshold). Failures count
toward backoff_limit; past it the job stops creating pods.
"""

from __future__ import annotations

import dataclasses

from kubernetes_tpu_torch.api.workloads import stamp_pod
from kubernetes_tpu_torch.client.informer import SharedInformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.controllers.replicaset import owner_uid_of
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, Conflict, NotFound


class JobController(Controller):
    name = "job-controller"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 record_events: bool = True):
        super().__init__(api, record_events=record_events)
        self.job_informer = factory.informer("Job")
        self.pod_informer = factory.informer("Pod")
        self._suffix = 0
        self.job_informer.add_event_handler(
            on_add=lambda o: self.enqueue(o.key()),
            on_update=lambda old, new: self.enqueue(new.key()))
        self.pod_informer.add_event_handler(
            on_add=self._on_pod, on_update=lambda o, n: self._on_pod(n),
            on_delete=self._on_pod)

    def _on_pod(self, pod) -> None:
        if pod.owner_kind == "Job" and pod.owner_name:
            self.enqueue(f"{pod.namespace}/{pod.owner_name}")

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            job = self.api.get("Job", namespace, name)
        except NotFound:
            return
        if job.complete:
            return
        my_uid = owner_uid_of("Job", namespace, name)
        owned = [p for p in self.pod_informer.store.list()
                 if p.owner_uid == my_uid and not p.deleted]
        active = sum(1 for p in owned if p.phase in ("Pending", "Running"))
        succeeded = sum(1 for p in owned if p.phase == "Succeeded")
        failed = sum(1 for p in owned if p.phase == "Failed")

        if succeeded < job.completions and failed <= job.backoff_limit:
            want_active = min(job.parallelism, job.completions - succeeded)
            for _ in range(max(0, want_active - active)):
                self._suffix += 1
                pod = stamp_pod(job.template, f"{job.name}-{self._suffix:05d}",
                                namespace, "Job", name)
                try:
                    self.api.create("Pod", pod)
                    active += 1
                except Conflict:
                    break
        complete = succeeded >= job.completions
        if (job.active, job.succeeded, job.failed, job.complete) != (
                active, succeeded, failed, complete):
            fresh = self.api.get("Job", namespace, name)
            self.api.update("Job", dataclasses.replace(
                fresh, active=active, succeeded=succeeded, failed=failed,
                complete=complete), expect_rv=fresh.resource_version)
            if complete and not job.complete:
                self.event("Job", job.key(), "Normal", "Completed",
                           f"Job completed ({succeeded}/{job.completions})")
