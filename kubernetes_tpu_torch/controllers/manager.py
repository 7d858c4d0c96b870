"""Controller manager: runs every reconcile controller over one shared
informer factory, under leader election.

Mirrors cmd/kube-controller-manager/app/controllermanager.go:107 (Run with
leaderelection.RunOrDie) and the initializer map at :313-339. The node
lifecycle controller (failure detection) registers here too once constructed
(controllers/nodelifecycle.py).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from kubernetes_tpu_torch.client.informer import SharedInformerFactory
from kubernetes_tpu_torch.client.leaderelection import LeaderElector, LeaseLock
from kubernetes_tpu_torch.controllers.autoscale import (
    CronJobController,
    DisruptionController,
    HorizontalPodAutoscalerController,
)
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.controllers.certificates import (
    CSRApprovingController,
    CSRSigningController,
)
from kubernetes_tpu_torch.controllers.cloudctrl import (
    AttachDetachController,
    PersistentVolumeBinder,
    RouteController,
    ServiceLBController,
)
from kubernetes_tpu_torch.controllers.daemonset import DaemonSetController
from kubernetes_tpu_torch.controllers.deployment import DeploymentController
from kubernetes_tpu_torch.controllers.endpoint import EndpointController
from kubernetes_tpu_torch.controllers.gc import GarbageCollector, PodGCController
from kubernetes_tpu_torch.controllers.job import JobController
from kubernetes_tpu_torch.controllers.namespace import NamespaceController
from kubernetes_tpu_torch.controllers.nodelifecycle import NodeLifecycleController
from kubernetes_tpu_torch.controllers.quota_sa import (
    BootstrapSignerController,
    ResourceQuotaController,
    ServiceAccountController,
    TokenCleanerController,
    TTLController,
)
from kubernetes_tpu_torch.controllers.replicaset import ReplicaSetController
from kubernetes_tpu_torch.controllers.statefulset import StatefulSetController
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite


class ControllerManager:
    """The initializer map of controllermanager.go:313-339, one entry per
    reference controller (cloud-facing ones take the provider like
    --cloud-provider)."""

    def __init__(self, api: ApiServerLite, record_events: bool = True,
                 leader_elect: bool = False, identity: str = "cm-0",
                 cloud=None, token_issuer=None, ca=None):
        from kubernetes_tpu_torch.auth.authn import CertAuthenticator
        from kubernetes_tpu_torch.cloud import FakeCloud

        self.api = api
        self.factory = SharedInformerFactory(api)
        self.cloud = cloud if cloud is not None else FakeCloud()
        ca = ca if ca is not None else CertAuthenticator(b"cluster-ca-key")
        kw = dict(record_events=record_events)
        self.controllers: Dict[str, Controller] = {
            "replicaset": ReplicaSetController(api, self.factory, "ReplicaSet", **kw),
            "replicationcontroller": ReplicaSetController(
                api, self.factory, "ReplicationController", **kw),
            "deployment": DeploymentController(api, self.factory, **kw),
            "job": JobController(api, self.factory, **kw),
            "cronjob": CronJobController(api, self.factory, **kw),
            "daemonset": DaemonSetController(api, self.factory, **kw),
            "statefulset": StatefulSetController(api, self.factory, **kw),
            "endpoint": EndpointController(api, self.factory, **kw),
            "namespace": NamespaceController(api, self.factory),
            "garbagecollector": GarbageCollector(api, self.factory),
            "podgc": PodGCController(api, self.factory),
            "nodelifecycle": NodeLifecycleController(api, self.factory, **kw),
            "resourcequota": ResourceQuotaController(api, self.factory, **kw),
            "serviceaccount": ServiceAccountController(
                api, self.factory, token_issuer=token_issuer, **kw),
            "ttl": TTLController(api, self.factory, **kw),
            "bootstrapsigner": BootstrapSignerController(api, self.factory, **kw),
            "tokencleaner": TokenCleanerController(api, self.factory, **kw),
            "horizontalpodautoscaling": HorizontalPodAutoscalerController(
                api, self.factory, **kw),
            "disruption": DisruptionController(api, self.factory, **kw),
            "service": ServiceLBController(api, self.factory, self.cloud, **kw),
            "route": RouteController(api, self.factory, self.cloud, **kw),
            "persistentvolume-binder": PersistentVolumeBinder(
                api, self.factory, **kw),
            "attachdetach": AttachDetachController(api, self.factory,
                                                   cloud=self.cloud, **kw),
            "csrapproving": CSRApprovingController(api, self.factory, **kw),
            "csrsigning": CSRSigningController(api, self.factory, ca, **kw),
        }
        self.monitor_period = 5.0  # --node-monitor-period
        self.gc_resync_period = 60.0  # GC full-orphan-scan cadence
        self._ticker: Optional[threading.Thread] = None
        self._ticker_stop = threading.Event()
        self.elector: Optional[LeaderElector] = None
        if leader_elect:
            self.elector = LeaderElector(
                LeaseLock(api, "kube-controller-manager"), identity,
                on_started_leading=self._start_workers)
        self._running = False

    def register(self, name: str, controller: Controller) -> None:
        self.controllers[name] = controller
        if self._running:
            controller.run(workers=2)

    # ------------------------------------------------------- deterministic

    def pump_until_stable(self, max_rounds: int = 60) -> int:
        """Single-threaded convergence loop for tests/benchmarks: pump
        informers + every controller queue until a full round does nothing."""
        rounds = 0
        for _ in range(max_rounds):
            moved = self.factory.step_all()
            for c in self.controllers.values():
                moved += c.pump()
            rounds += 1
            if moved == 0:
                return rounds
        return rounds

    # ------------------------------------------------------------ threaded

    def start(self, workers: int = 2, poll: float = 0.02) -> None:
        self.factory.start(poll=poll)
        self.factory.wait_for_cache_sync()
        if self.elector is not None:
            self.elector.run()
        else:
            self._start_workers(workers)

    def _start_workers(self, workers: int = 2) -> None:
        if self._running:
            return  # leadership re-acquired: workers/ticker already live
        self._running = True
        for c in self.controllers.values():
            c.run(workers=workers)
        # periodic monitors: node heartbeat checks every --node-monitor-period
        # (5s); GC resyncs on their own much slower cadence (the reference
        # resyncs GC on the order of minutes, not the heartbeat period)
        def guarded(fn):
            # one bad tick must not kill monitoring forever
            # (Controller._worker gives workers the same shield)
            try:
                fn()
            except Exception:
                pass

        def tick_loop():
            last_gc = time.monotonic()
            while not self._ticker_stop.wait(self.monitor_period):
                guarded(self.controllers["nodelifecycle"].monitor_tick)
                guarded(self.controllers["cronjob"].tick)
                guarded(self.controllers["horizontalpodautoscaling"].resync_all)
                if time.monotonic() - last_gc >= self.gc_resync_period:
                    last_gc = time.monotonic()
                    guarded(self.controllers["garbagecollector"].resync)
                    guarded(self.controllers["podgc"].resync)
                    guarded(self.controllers["resourcequota"].resync_all)

        t = threading.Thread(target=tick_loop, daemon=True, name="cm-ticker")
        t.start()
        self._ticker = t

    def stop(self) -> None:
        self._ticker_stop.set()
        if self._ticker is not None:
            self._ticker.join(timeout=2.0)
        if self.elector is not None:
            self.elector.stop()
        for c in self.controllers.values():
            c.stop()
        self.factory.stop()
