"""HPA + disruption (PDB) + cronjob controllers.

References:
- pkg/controller/podautoscaler/horizontal.go: desired = ceil(current *
  observed/target) with a 10% tolerance dead-band, clamped to [min,max];
  scale via the scale subresource.
- pkg/controller/disruption/disruption.go: PDB status — count healthy pods
  behind the selector, disruptionsAllowed = max(0, healthy - minAvailable).
- pkg/controller/cronjob/cronjob_controller.go: spawn Jobs on schedule,
  concurrency policies Allow/Forbid/Replace, history limits.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.api.workloads import Job, pods_matching, stamp_pod
from kubernetes_tpu_torch.client.informer import SharedInformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, Conflict, NotFound


class StaticMetricsClient:
    """Test/bench metrics source: per-pod CPU usage in millicores.
    Stands in for heapster (the 1.7 metrics pipeline the HPA queried via
    pkg/controller/podautoscaler/metrics)."""

    def __init__(self):
        self.usage: Dict[str, int] = {}  # pod key -> mCPU used
        self.default = 0

    def pod_cpu_usage(self, pod) -> int:
        return self.usage.get(pod.key(), self.default)


class HorizontalPodAutoscalerController(Controller):
    name = "horizontal-pod-autoscaler"
    TOLERANCE = 0.1  # horizontal.go tolerance
    # scale-stabilization windows (horizontal.go upscaleForbiddenWindow 3m /
    # downscaleForbiddenWindow 5m) — without them the controller re-scales
    # against metrics gathered before the previous scale converged
    UPSCALE_WINDOW = 180.0
    DOWNSCALE_WINDOW = 300.0

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 metrics_client: Optional[StaticMetricsClient] = None,
                 record_events: bool = True, now=time.time):
        super().__init__(api, record_events=record_events)
        self.metrics = metrics_client or StaticMetricsClient()
        self._now = now
        self._last_scale: Dict[str, float] = {}
        self.pod_informer = factory.informer("Pod")
        factory.informer("HorizontalPodAutoscaler").add_event_handler(
            on_add=lambda o: self.enqueue(o.key()),
            on_update=lambda o, n: self.enqueue(n.key()))

    def resync_all(self) -> None:
        for h in self.api.list("HorizontalPodAutoscaler")[0]:
            self.enqueue(h.key())

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            hpa = self.api.get("HorizontalPodAutoscaler", namespace, name)
        except NotFound:
            return
        try:
            target = self.api.get(hpa.target_kind, namespace, hpa.target_name)
        except NotFound:
            return
        pods = pods_matching(target, self.pod_informer.store.list())
        current = target.replicas
        if not pods:
            desired = hpa.min_replicas
            utilization = 0
        else:
            used = sum(self.metrics.pod_cpu_usage(p) for p in pods)
            requested = sum(p.resource_request().milli_cpu for p in pods)
            if requested == 0:
                return  # horizontal.go: missing requests -> no decision
            utilization = int(round(100.0 * used / requested))
            ratio = utilization / max(hpa.target_cpu_utilization, 1)
            if abs(ratio - 1.0) <= self.TOLERANCE:
                desired = current
            else:
                desired = int(math.ceil(current * ratio))
        desired = max(hpa.min_replicas, min(hpa.max_replicas, desired))
        last = self._last_scale.get(key)
        now = self._now()
        window = self.UPSCALE_WINDOW if desired > current \
            else self.DOWNSCALE_WINDOW
        if desired != current and (last is None or now - last >= window):
            target.replicas = desired
            self.api.update(hpa.target_kind, target,
                            expect_rv=target.resource_version)
            self._last_scale[key] = now
        if (hpa.current_replicas, hpa.desired_replicas,
                hpa.current_cpu_utilization) != (current, desired, utilization):
            hpa.current_replicas = current
            hpa.desired_replicas = desired
            hpa.current_cpu_utilization = utilization
            self.api.update("HorizontalPodAutoscaler", hpa,
                            expect_rv=hpa.resource_version)


class DisruptionController(Controller):
    """Maintain PDB status from live pods (disruption.go updatePdbStatus)."""

    name = "disruption-controller"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 record_events: bool = True):
        super().__init__(api, record_events=record_events)
        self.pod_informer = factory.informer("Pod")
        factory.informer("PodDisruptionBudget").add_event_handler(
            on_add=lambda o: self.enqueue(o.namespace + "/" + o.name),
            on_update=lambda o, n: self.enqueue(n.namespace + "/" + n.name))
        self.pod_informer.add_event_handler(
            on_add=self._on_pod, on_delete=self._on_pod,
            on_update=lambda o, n: self._on_pod(n))

    def _on_pod(self, pod) -> None:
        for pdb in self.api.list("PodDisruptionBudget")[0]:
            if pdb.namespace == pod.namespace and pdb.selector is not None \
                    and pdb.selector.matches(pod.labels):
                self.enqueue(pdb.namespace + "/" + pdb.name)

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            pdb = self.api.get("PodDisruptionBudget", namespace, name)
        except NotFound:
            return
        pods = pods_matching(pdb, self.pod_informer.store.list())
        healthy = sum(1 for p in pods if p.phase == "Running")
        expected = len(pods)
        allowed = max(0, healthy - pdb.min_available)
        status = (healthy, pdb.min_available, allowed, expected)
        if (pdb.current_healthy, pdb.desired_healthy,
                pdb.disruptions_allowed, pdb.expected_pods) != status:
            pdb.current_healthy = healthy
            pdb.desired_healthy = pdb.min_available
            pdb.disruptions_allowed = allowed
            pdb.expected_pods = expected
            self.api.update("PodDisruptionBudget", pdb,
                            expect_rv=pdb.resource_version)


def parse_schedule(spec: str) -> float:
    """Seconds between runs for the supported schedule forms:
    '@every Ns', '*/N * * * *' (every N minutes), 'M H * * *' (daily —
    interval approximation 86400s). The reference uses robfig/cron; the
    controller only needs the next-fire delta."""
    spec = spec.strip()
    if spec.startswith("@every "):
        v = spec[len("@every "):]
        if v.endswith("s"):
            return float(v[:-1])
        if v.endswith("m"):
            return float(v[:-1]) * 60
        if v.endswith("h"):
            return float(v[:-1]) * 3600
        return float(v)
    fields = spec.split()
    if len(fields) == 5:
        minute = fields[0]
        if minute.startswith("*/"):
            return float(minute[2:]) * 60
        if fields[1].startswith("*/"):
            return float(fields[1][2:]) * 3600
        if minute == "*" :
            return 60.0
        return 86400.0
    raise ValueError(f"unsupported schedule {spec!r}")


class CronJobController(Controller):
    """cronjob_controller.go syncOne: fire when now >= last + interval."""

    name = "cronjob-controller"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 record_events: bool = True, now=time.time):
        super().__init__(api, record_events=record_events)
        self._now = now
        factory.informer("CronJob").add_event_handler(
            on_add=lambda o: self.enqueue(o.key()),
            on_update=lambda o, n: self.enqueue(n.key()))

    def tick(self) -> None:
        """Cadence entry (the reference polls every 10s — cronjob_controller
        .go Run's wait.Until)."""
        for cj in self.api.list("CronJob")[0]:
            self.enqueue(cj.key())

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            cj = self.api.get("CronJob", namespace, name)
        except NotFound:
            return
        if cj.suspend:
            return
        jobs = [j for j in self.api.list("Job")[0]
                if j.namespace == namespace
                and j.name.startswith(name + "-")]
        active = [j for j in jobs if not j.complete]
        finished = [j for j in jobs if j.complete]
        now = self._now()
        interval = parse_schedule(cj.schedule)
        changed = False
        if now - cj.last_schedule_time >= interval:
            if active and cj.concurrency_policy == "Forbid":
                pass  # skip this window (syncOne's Forbid branch)
            else:
                if active and cj.concurrency_policy == "Replace":
                    for j in active:
                        self.api.delete("Job", namespace, j.name)
                    active = []
                job = Job(
                    name=f"{name}-{int(now)}", namespace=namespace,
                    completions=cj.job_template.completions,
                    parallelism=cj.job_template.parallelism,
                    template=cj.job_template.template)
                try:
                    self.api.create("Job", job)
                except Conflict:
                    return
                cj.last_schedule_time = now
                active.append(job)
                changed = True
        # history limits (cleanup in syncOne)
        succeeded = sorted([j for j in finished if j.failed == 0],
                           key=lambda j: j.name)
        failed = sorted([j for j in finished if j.failed > 0],
                        key=lambda j: j.name)
        for j in succeeded[: max(0, len(succeeded)
                                 - cj.successful_jobs_history_limit)]:
            self.api.delete("Job", namespace, j.name)
        for j in failed[: max(0, len(failed) - cj.failed_jobs_history_limit)]:
            self.api.delete("Job", namespace, j.name)
        actives = sorted(j.name for j in active)
        if changed or actives != cj.active_jobs:
            cj.active_jobs = actives
            self.api.update("CronJob", cj, expect_rv=cj.resource_version)
