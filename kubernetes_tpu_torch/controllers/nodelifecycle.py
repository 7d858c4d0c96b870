"""Node lifecycle controller: heartbeat monitoring + zone-aware eviction.

Mirrors pkg/controller/node/node_controller.go:

- monitorNodeStatus (:523): a node whose heartbeat is older than
  node_monitor_grace_period gets its Ready condition forced to Unknown (the
  controller, not the dead kubelet, writes this).
- pod eviction (:399): nodes NotReady/Unknown longer than
  pod_eviction_timeout have their pods deleted — via per-zone token-bucket
  rate limiters (scheduler/rate_limited_queue.go), default
  --node-eviction-rate=0.1/s.
- zone disruption dampening (:701): per-zone health states — Normal /
  PartialDisruption (>= unhealthy_threshold unhealthy -> reduced
  secondary rate) / FullDisruption (ALL unhealthy -> evictions STOP; the
  partition is assumed to be on the master's side).
- TaintBasedEvictions (kube_features.go:83, off by default): instead of
  deleting pods, taint the node NoExecute `unreachable`/`not-ready`; the
  NoExecuteTaintManager (scheduler/taint_controller.go) then deletes pods
  lacking a matching toleration.

Tick-driven (monitor_tick), clock-injectable; ControllerManager registers a
periodic thread in threaded mode.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List

from kubernetes_tpu_torch.api.types import (
    ConditionStatus,
    Node,
    NodeCondition,
    Taint,
    TaintEffect,
)
from kubernetes_tpu_torch.client.informer import SharedInformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, Conflict, NotFound
from kubernetes_tpu_torch.utils import features

ZONE_LABEL = "failure-domain.beta.kubernetes.io/zone"
TAINT_UNREACHABLE = "node.alpha.kubernetes.io/unreachable"
TAINT_NOT_READY = "node.alpha.kubernetes.io/notReady"

# defaults from cmd/kube-controller-manager/app/options (v1.7)
DEFAULT_GRACE_PERIOD = 40.0          # --node-monitor-grace-period
DEFAULT_EVICTION_TIMEOUT = 300.0     # --pod-eviction-timeout
DEFAULT_EVICTION_RATE = 0.1          # --node-eviction-rate
DEFAULT_SECONDARY_RATE = 0.01        # --secondary-node-eviction-rate
DEFAULT_UNHEALTHY_THRESHOLD = 0.55   # --unhealthy-zone-threshold
DEFAULT_LARGE_CLUSTER_SIZE = 50      # --large-cluster-size-threshold


class _TokenBucket:
    """RateLimitedTimedQueue's flowcontrol bucket, reduced: capacity 1 burst
    in spirit of the default qps=0.1."""

    def __init__(self, rate: float, now: Callable[[], float]):
        self.rate = rate
        self._now = now
        self._tokens = 1.0
        self._last = now()

    def set_rate(self, rate: float) -> None:
        self.rate = rate

    def try_take(self) -> bool:
        now = self._now()
        self._tokens = min(1.0, self._tokens + (now - self._last) * self.rate)
        self._last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


class NodeLifecycleController(Controller):
    name = "node-lifecycle-controller"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 grace_period: float = DEFAULT_GRACE_PERIOD,
                 eviction_timeout: float = DEFAULT_EVICTION_TIMEOUT,
                 eviction_rate: float = DEFAULT_EVICTION_RATE,
                 secondary_rate: float = DEFAULT_SECONDARY_RATE,
                 unhealthy_threshold: float = DEFAULT_UNHEALTHY_THRESHOLD,
                 large_cluster_size: int = DEFAULT_LARGE_CLUSTER_SIZE,
                 record_events: bool = True,
                 now: Callable[[], float] = time.monotonic):
        super().__init__(api, record_events=record_events)
        self._now = now
        self.grace_period = grace_period
        self.eviction_timeout = eviction_timeout
        self.eviction_rate = eviction_rate
        self.secondary_rate = secondary_rate
        self.unhealthy_threshold = unhealthy_threshold
        self.large_cluster_size = large_cluster_size
        self.node_informer = factory.informer("Node")
        self.pod_informer = factory.informer("Pod")
        self.pod_informer.store.add_index(
            "node", lambda p: [p.node_name] if p.node_name else [])
        self._zone_buckets: Dict[str, _TokenBucket] = {}
        # node -> time we first observed it (probeTimestamp in the reference's
        # nodeStatusMap): a node that has never heartbeat — static/decoded
        # Node objects have heartbeat=0.0 — gets grace from first observation,
        # not from the epoch
        self._first_seen: Dict[str, float] = {}
        # node -> monotonic time it was first seen unhealthy
        self._unhealthy_since: Dict[str, float] = {}
        # nodes already drained — out of the eviction queue until they
        # recover (the RateLimitedTimedQueue Remove-on-process behavior)
        self._evicted: set = set()
        self.zone_states: Dict[str, str] = {}

    # --------------------------------------------------------------- monitor

    def monitor_tick(self) -> None:
        """One monitorNodeStatus pass over all nodes."""
        now = self._now()
        nodes: List[Node] = self.node_informer.store.list()
        by_zone: Dict[str, List[Node]] = {}
        for node in nodes:
            by_zone.setdefault(node.labels.get(ZONE_LABEL, ""), []).append(node)

        for zone, zone_nodes in by_zone.items():
            unhealthy = [n for n in zone_nodes if not self._healthy(n, now)]
            state = self._zone_state(len(zone_nodes), len(unhealthy))
            self.zone_states[zone] = state
            bucket = self._zone_buckets.get(zone)
            if bucket is None:
                bucket = _TokenBucket(self.eviction_rate, self._now)
                self._zone_buckets[zone] = bucket
            if state == "PartialDisruption":
                # large zones throttle; small zones stop entirely
                # (node_controller.go:701 ReducedQPSFunc)
                bucket.set_rate(self.secondary_rate
                                if len(zone_nodes) > self.large_cluster_size
                                else 0.0)
            else:
                bucket.set_rate(self.eviction_rate)

            for node in zone_nodes:
                if self._healthy(node, now):
                    self._unhealthy_since.pop(node.name, None)
                    self._evicted.discard(node.name)
                    self._mark_healthy(node)
                    continue
                since = self._unhealthy_since.setdefault(node.name, now)
                self._mark_unknown(node)
                if state == "FullDisruption":
                    continue  # assume master-side partition; don't evict
                if now - since >= self.eviction_timeout:
                    if features.enabled("TaintBasedEvictions"):
                        self._apply_noexecute_taint(node)
                        self._evict_intolerant_pods(node, bucket)
                    elif node.name not in self._evicted and bucket.try_take():
                        self._evicted.add(node.name)
                        self._evict_pods(node)

    def _healthy(self, node: Node, now: float) -> bool:
        last = max(node.heartbeat, self._first_seen.setdefault(node.name, now))
        return now - last < self.grace_period

    def _zone_state(self, total: int, unhealthy: int) -> str:
        if total == 0:
            return "Normal"
        if unhealthy == total:
            return "FullDisruption"
        if unhealthy / total >= self.unhealthy_threshold:
            return "PartialDisruption"
        return "Normal"

    # -------------------------------------------------------------- actions

    def _mark_unknown(self, node: Node) -> None:
        """Force Ready=Unknown: the kubelet stopped reporting
        (node_controller.go tryUpdateNodeStatus)."""
        if node.condition("Ready") == ConditionStatus.UNKNOWN:
            return
        conds = [c for c in node.conditions if c.type != "Ready"]
        conds.append(NodeCondition("Ready", ConditionStatus.UNKNOWN))
        try:
            fresh = self.api.get("Node", "", node.name)
            self.api.update("Node", dataclasses.replace(fresh, conditions=conds),
                            expect_rv=fresh.resource_version)
            self.event("Node", node.name, "Normal", "NodeNotReady",
                       f"Node {node.name} status is now: Unknown")
        except (Conflict, NotFound):
            pass

    def _mark_healthy(self, node: Node) -> None:
        """Clear our NoExecute taints once the node reports again."""
        ours = {TAINT_UNREACHABLE, TAINT_NOT_READY}
        if not any(t.key in ours for t in node.taints):
            return
        try:
            fresh = self.api.get("Node", "", node.name)
            taints = [t for t in fresh.taints if t.key not in ours]
            self.api.update("Node", dataclasses.replace(fresh, taints=taints),
                            expect_rv=fresh.resource_version)
        except (Conflict, NotFound):
            pass

    def _apply_noexecute_taint(self, node: Node) -> None:
        if any(t.key == TAINT_UNREACHABLE for t in node.taints):
            return
        try:
            fresh = self.api.get("Node", "", node.name)
            taints = list(fresh.taints) + [
                Taint(TAINT_UNREACHABLE, effect=TaintEffect.NO_EXECUTE)]
            self.api.update("Node", dataclasses.replace(fresh, taints=taints),
                            expect_rv=fresh.resource_version)
        except (Conflict, NotFound):
            pass

    def _pods_on(self, node_name: str):
        return [p for p in self.pod_informer.store.by_index("node", node_name)
                if p.phase not in ("Succeeded", "Failed")]

    def _evict_pods(self, node: Node) -> None:
        """Delete-based eviction (whole node drained in one rate-limit token,
        matching deletePods in the reference)."""
        evicted = 0
        for p in self._pods_on(node.name):
            try:
                self.api.delete("Pod", p.namespace, p.name)
                evicted += 1
            except NotFound:
                pass
        if evicted:
            self.event("Node", node.name, "Normal", "DeletingAllPods",
                       f"Deleting {evicted} pods from unresponsive node")

    def _evict_intolerant_pods(self, node: Node, bucket: _TokenBucket) -> None:
        """NoExecuteTaintManager: pods without a matching NoExecute toleration
        are deleted (taint_controller.go processPodOnNode)."""
        noexec = [t for t in node.taints if t.effect == TaintEffect.NO_EXECUTE]
        noexec.append(Taint(TAINT_UNREACHABLE, effect=TaintEffect.NO_EXECUTE))
        for p in self._pods_on(node.name):
            tolerated = all(any(tol.tolerates(t) for tol in p.tolerations)
                            for t in noexec)
            if not tolerated and bucket.try_take():
                try:
                    self.api.delete("Pod", p.namespace, p.name)
                except NotFound:
                    pass

    # -------------------------------------------------------- queue plumbing

    def sync(self, key: str) -> None:
        self.monitor_tick()

    def resync(self) -> None:
        self.enqueue("monitor")
