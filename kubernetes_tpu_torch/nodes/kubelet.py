"""Hollow kubelet: the node agent's pod lifecycle + status machinery.

What is mirrored from pkg/kubelet (kubelet.go syncLoop/syncPod and kubemark's
hollow_kubelet.go):

- consume bound pods for this node from the watch stream (the apiserver pod
  source, pkg/kubelet/config/apiserver.go), merged with STATIC pod sources
  (file/dict manifests, pkg/kubelet/config/file.go) that surface as mirror
  pods on the apiserver (kubelet.go mirror-pod handling)
- per-pod serialized workers with latest-wins coalescing (PodWorkers;
  pkg/kubelet/pod_workers.go managePodLoop/UpdatePod)
- node-side admission re-running GeneralPredicates against local state
  (kubelet lifecycle handler, pkg/kubelet/lifecycle/predicate.go) — a pod the
  scheduler raced onto a full node goes Failed/OutOfResources, it does not run
- pod startup: Pending -> Running after a simulated runtime latency (the
  kubemark FakeDockerClient EnableSleep behavior,
  cmd/kubemark/hollow-node.go:119-121)
- liveness/readiness probes (ProberManager; pkg/kubelet/prober/
  prober_manager.go + worker.go): readiness outcomes flip the pod's Ready
  condition (gating Endpoints membership), liveness failures past
  FailureThreshold restart the container per restartPolicy (restart_count++)
  or fail the pod (Never)
- resource-pressure eviction (EvictionManager; pkg/kubelet/eviction/
  eviction_manager.go): usage signals above threshold set the node's
  MemoryPressure/DiskPressure conditions (which CheckNodeMemoryPressure /
  CheckNodeDiskPressure read scheduler-side) and evict pods in QoS order
  (BestEffort -> Burstable by usage-over-request -> Guaranteed) until the
  signal clears
- run-to-completion: pods annotated `bench/run-seconds` go Succeeded (or
  Failed via `bench/fail`) when their runtime elapses — restartPolicy Never
  semantics for Job benchmarking
- status loop: heartbeat on the Node object (status manager + node status
  update, kubelet.go:1255 Run's updateRuntimeUp/syncNodeStatus), now
  carrying the pressure conditions

Probe/usage outcomes in the hollow runtime are annotation-driven, the way
kubemark's FakeDockerClient scripts runtime behavior:
  bench/ready-after=<s>      readiness False until s seconds post-start
  bench/liveness-fail-at=<s> liveness starts failing s seconds post-start
  bench/actual-mem=<bytes>   working-set bytes the pod "really" uses
  bench/actual-disk=<bytes>  disk bytes the pod "really" uses

HollowFleet multiplexes one informer across N kubelets by node-name index —
5k kubelets cost one watch cursor, the way kubemark's shared apiserver watch
cache absorbs 5k real watches.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import (
    ConditionStatus,
    Node,
    NodeCondition,
    Pod,
    Resource,
)
from kubernetes_tpu_torch.client.informer import SharedInformerFactory
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, Conflict, NotFound

# scripted-workload annotation keys live with the runtime manager that
# consumes them (nodes/kuberuntime.py); re-exported for compatibility
from kubernetes_tpu_torch.nodes.kuberuntime import (  # noqa: F401
    FAIL_ANNOTATION,
    RUN_SECONDS_ANNOTATION,
)

READY_AFTER_ANNOTATION = "bench/ready-after"
LIVENESS_FAIL_AT_ANNOTATION = "bench/liveness-fail-at"
ACTUAL_MEM_ANNOTATION = "bench/actual-mem"
ACTUAL_DISK_ANNOTATION = "bench/actual-disk"
MIRROR_ANNOTATION = "kubernetes.io/config.mirror"


class PodWorkers:
    """Per-pod serialized sync with latest-wins coalescing — the semantics
    of pod_workers.go: one worker per pod; an update arriving while a sync
    is in flight replaces any still-pending update (UpdatePod :158-196);
    the worker drains until no pending update remains."""

    def __init__(self, sync_fn: Callable[[Pod, str], None]):
        self._sync = sync_fn
        self._pending: Dict[str, Tuple[Pod, str]] = {}
        self._working: set = set()
        self.syncs = 0  # diagnostics
        self.coalesced = 0

    def update_pod(self, pod: Pod, op: str) -> None:
        key = pod.key()
        if key in self._pending:
            self.coalesced += 1
        self._pending[key] = (pod, op)

    def forget(self, pod_key: str) -> None:
        self._pending.pop(pod_key, None)

    def drain(self) -> int:
        """Run every pod's pending sync exactly once (one pass = one
        managePodLoop wakeup per pod); re-queued work waits for the next
        drain, preserving per-pod serialization."""
        n = 0
        work = list(self._pending.items())
        self._pending.clear()
        for key, (pod, op) in work:
            if key in self._working:  # re-entrancy guard
                self._pending[key] = (pod, op)
                continue
            self._working.add(key)
            try:
                self._sync(pod, op)
                self.syncs += 1
                n += 1
            finally:
                self._working.discard(key)
        return n


class _ProbeState:
    __slots__ = ("started_at", "failures", "successes", "ready", "next_at")

    def __init__(self, started_at: float):
        self.started_at = started_at
        self.failures = 0
        self.successes = 0
        self.ready = False
        self.next_at: Optional[float] = None  # next probe instant


class ProberManager:
    """Liveness + readiness workers for one kubelet's admitted pods
    (prober_manager.go AddPod/RemovePod; worker.go probe loop). Outcomes
    come from the pod's bench/* annotations (hollow runtime)."""

    def __init__(self, now: Callable[[], float]):
        self._now = now
        self._liveness: Dict[str, _ProbeState] = {}
        self._readiness: Dict[str, _ProbeState] = {}

    def add_pod(self, pod: Pod, started_at: float) -> None:
        key = pod.key()
        for c in pod.containers:
            if c.liveness_probe is not None:
                self._liveness[key] = _ProbeState(started_at)
            if c.readiness_probe is not None:
                self._readiness[key] = _ProbeState(started_at)

    def remove_pod(self, pod_key: str) -> None:
        self._liveness.pop(pod_key, None)
        self._readiness.pop(pod_key, None)

    @staticmethod
    def _due(st: _ProbeState, spec, now: float) -> bool:
        """PeriodSeconds gating (worker.go's probe ticker): a probe fires at
        started_at+initial_delay, then every period_s — regardless of how
        often the sync loop runs."""
        if now < st.started_at + spec.initial_delay_s:
            return False
        if st.next_at is None:
            st.next_at = st.started_at + spec.initial_delay_s
        if now < st.next_at:
            return False
        # catch up to the present without replaying missed periods (the
        # worker runs one probe per wakeup, late or not)
        st.next_at = now + spec.period_s
        return True

    def has_readiness(self, pod_key: str) -> bool:
        return pod_key in self._readiness

    @staticmethod
    def _probe_spec(pod: Pod, liveness: bool):
        for c in pod.containers:
            p = c.liveness_probe if liveness else c.readiness_probe
            if p is not None:
                return p
        return None

    def tick(self, pod: Pod) -> Tuple[Optional[bool], Optional[bool]]:
        """(ready, live) for the pod at this instant; None = no probe of
        that kind. Thresholds per worker.go: a state flips only after
        FailureThreshold consecutive failures / SuccessThreshold
        successes."""
        key = pod.key()
        now = self._now()
        ready = live = None
        rs = self._readiness.get(key)
        if rs is not None:
            spec = self._probe_spec(pod, liveness=False)
            if self._due(rs, spec, now):
                ready_after = float(pod.annotations.get(
                    READY_AFTER_ANNOTATION, 0.0))
                ok = now >= rs.started_at + ready_after
                if ok:
                    rs.successes += 1
                    rs.failures = 0
                    if rs.successes >= spec.success_threshold:
                        rs.ready = True
                else:
                    rs.failures += 1
                    rs.successes = 0
                    if rs.failures >= spec.failure_threshold:
                        rs.ready = False
            ready = rs.ready
        ls = self._liveness.get(key)
        if ls is not None:
            spec = self._probe_spec(pod, liveness=True)
            if self._due(ls, spec, now):
                fail_at = pod.annotations.get(LIVENESS_FAIL_AT_ANNOTATION)
                failing = fail_at is not None \
                    and now >= ls.started_at + float(fail_at)
                if failing:
                    ls.failures += 1
                else:
                    ls.failures = 0
            live = ls.failures < spec.failure_threshold
        return ready, live

    def restart(self, pod: Pod, started_at: float) -> None:
        """Container restarted: probe state restarts with it (worker.go
        onHoldUntil + fresh result window)."""
        key = pod.key()
        if key in self._liveness:
            self._liveness[key] = _ProbeState(started_at)
        if key in self._readiness:
            self._readiness[key] = _ProbeState(started_at)


# eviction-hard thresholds, as fractions of allocatable (the shape of
# --eviction-hard=memory.available<X,nodefs.available<Y;
# eviction/eviction_manager.go synchronize + helpers.go thresholds)
DEFAULT_MEMORY_EVICTION_FRACTION = 0.95
DEFAULT_DISK_EVICTION_FRACTION = 0.95


class EvictionManager:
    """Pressure detection + QoS-ranked pod eviction for one node
    (eviction_manager.go:synchronize). Usage signals are the sum of the
    admitted pods' bench/actual-* annotations (fallback: their requests)."""

    def __init__(self, node: Node,
                 memory_fraction: float = DEFAULT_MEMORY_EVICTION_FRACTION,
                 disk_fraction: float = DEFAULT_DISK_EVICTION_FRACTION):
        self._alloc_mem = node.allocatable.memory
        self._alloc_disk = node.allocatable.storage_scratch
        self.memory_limit = int(self._alloc_mem * memory_fraction)
        self.disk_limit = int(self._alloc_disk * disk_fraction) \
            if self._alloc_disk else 0
        self.memory_pressure = False
        self.disk_pressure = False

    @staticmethod
    def _pod_usage(pod: Pod) -> Tuple[int, int]:
        req = pod.resource_request()
        mem = int(pod.annotations.get(ACTUAL_MEM_ANNOTATION, req.memory))
        disk = int(pod.annotations.get(ACTUAL_DISK_ANNOTATION,
                                       req.storage_scratch))
        return mem, disk

    @staticmethod
    def _qos_rank(pod: Pod, usage: int, request: int) -> Tuple[int, int]:
        """Eviction order (eviction/helpers.go rankMemoryPressure for 1.7:
        QoS class first — BestEffort, Burstable, Guaranteed — then usage
        above the MATCHING resource's request, descending)."""
        if pod.is_best_effort():
            qos = 0
        elif any(c.requests and c.requests == c.limits and c.requests
                 for c in pod.containers):
            qos = 2  # Guaranteed-ish: requests == limits
        else:
            qos = 1  # Burstable
        return (qos, -(usage - request))

    def synchronize(self, admitted: Dict[str, Pod], extra_disk: int = 0,
                    disk_reclaim=None) -> List[str]:
        """Returns pod keys to evict, updating the pressure flags. Evicts
        greedily in rank order until the signal clears, like the manager's
        one-eviction-per-sync loop collapsed into one pass.

        `extra_disk` is non-pod disk usage (the image filesystem);
        `disk_reclaim(bytes)` frees node-level disk (image GC) and returns
        bytes freed — tried BEFORE any pod is evicted, mirroring
        eviction_manager.go reclaimNodeLevelResources."""
        mem_use = disk_use = 0
        per_pod = {}
        for key, pod in admitted.items():
            m, d = self._pod_usage(pod)
            per_pod[key] = (m, d)
            mem_use += m
            disk_use += d
        # static (mirror) pods are exempt, like the manager's critical-pod
        # carve-out (eviction_manager.go; static pods are kubelet-owned and
        # would just be restarted by their source)
        evictable = {k: p for k, p in admitted.items()
                     if MIRROR_ANNOTATION not in p.annotations}
        to_evict: List[str] = []
        self.memory_pressure = self._alloc_mem > 0 \
            and mem_use > self.memory_limit
        if self.memory_pressure:
            ranked = sorted(
                evictable.items(),
                key=lambda kv: self._qos_rank(
                    kv[1], per_pod[kv[0]][0],
                    kv[1].resource_request().memory))
            for key, _pod in ranked:
                if mem_use <= self.memory_limit:
                    break
                to_evict.append(key)
                mem_use -= per_pod[key][0]
        if self.disk_limit:
            disk_use += extra_disk
            self.disk_pressure = disk_use > self.disk_limit
            if self.disk_pressure and disk_reclaim is not None:
                disk_use -= disk_reclaim(disk_use - self.disk_limit)
                self.disk_pressure = disk_use > self.disk_limit
            if self.disk_pressure:
                ranked = sorted(
                    evictable.items(),
                    key=lambda kv: self._qos_rank(
                        kv[1], per_pod[kv[0]][1],
                        kv[1].resource_request().storage_scratch))
                for key, _pod in ranked:
                    if disk_use <= self.disk_limit:
                        break
                    if key not in to_evict:
                        to_evict.append(key)
                        disk_use -= per_pod[key][1]
        return to_evict


class HollowKubelet:
    def __init__(self, api: ApiServerLite, node: Node,
                 startup_latency: float = 0.0,
                 now: Callable[[], float] = time.monotonic,
                 volume_manager=None, checkpointer=None,
                 runtime=None, reserved=None):
        from kubernetes_tpu_torch.nodes.cri import FakeRuntimeService
        from kubernetes_tpu_torch.nodes.images import (
            ImageGCManager,
            ImageManager,
        )
        from kubernetes_tpu_torch.nodes.kuberuntime import RuntimeManager
        self.api = api
        self.node_name = node.name
        self._now = now
        self.startup_latency = startup_latency
        # node-allocatable reservation (--kube-reserved/--system-reserved;
        # pkg/kubelet/cm/node_container_manager.go GetNodeAllocatable
        # Reservation): the node's given resources are its CAPACITY;
        # what registers as allocatable — what the scheduler and the
        # node-side admission see — is capacity minus the reservation
        if reserved is not None:
            import dataclasses as _dc
            cap = node.allocatable
            node = _dc.replace(node, capacity=cap, allocatable=Resource(
                milli_cpu=max(0, cap.milli_cpu - reserved.milli_cpu),
                memory=max(0, cap.memory - reserved.memory),
                nvidia_gpu=max(0, cap.nvidia_gpu - reserved.nvidia_gpu),
                storage_scratch=max(
                    0, cap.storage_scratch - reserved.storage_scratch),
                storage_overlay=max(
                    0, cap.storage_overlay - reserved.storage_overlay),
                extended=dict(cap.extended)))
        self._template = node
        # THE runtime boundary (nodes/cri.py; ref pkg/kubelet/apis/cri/
        # services.go): any RuntimeService+ImageService plugs in here; the
        # default is the scripted fake (the kubemark hollow runtime)
        if runtime is None:
            runtime = FakeRuntimeService(boot_latency=startup_latency,
                                         now=now)
        self.runtime = runtime
        self.images = ImageManager(runtime)
        # image fs capacity = the node's scratch disk (cadvisor
        # ImagesFsInfo in the reference)
        self.image_gc = ImageGCManager(
            runtime, capacity_bytes=node.allocatable.storage_scratch)
        self.runtime_mgr = RuntimeManager(runtime, image_manager=self.images,
                                          now=now)
        # pod keys whose containers are not all Running yet (startup or
        # liveness-restart in flight); the step() loop polls the runtime
        # for them — the PLEG relist analog (pkg/kubelet/pleg/)
        self._starting: Dict[str, float] = {}
        self._admitted: Dict[str, Pod] = {}  # local running set
        self._restarts: Dict[str, int] = {}  # pod key -> restart count
        self._ready: Dict[str, bool] = {}  # last written Ready condition
        self.workers = PodWorkers(self._sync_pod)
        self.prober = ProberManager(now)
        self.eviction = EvictionManager(node)
        self._static: Dict[str, Pod] = {}  # static (mirror-backed) pods
        # volumes/manager.py VolumeManager; None keeps the hollow-fleet
        # fast path volume-free (kubemark's hollow kubelet does the same)
        self.volumes = volume_manager
        # node-local sandbox checkpoints (nodes/checkpoint.py, the
        # dockershim checkpoint_store analog): restart counters survive a
        # kubelet restart instead of resetting to zero
        self.checkpointer = checkpointer
        # restore_all validates + prunes corrupt blobs in one pass and
        # never raises — kubelet startup must survive any checkpoint state
        self._restored: Dict[str, Dict] = {} if checkpointer is None \
            else checkpointer.restore_all()

    # ----------------------------------------------------------- node status

    def register(self) -> None:
        """Initial node registration (kubelet registerWithAPIServer)."""
        node = dataclasses.replace(self._template, heartbeat=self._now())
        try:
            self.api.create("Node", node)
        except Conflict:
            self.heartbeat()

    def heartbeat(self) -> None:
        """syncNodeStatus: bump heartbeat, assert Ready, and report the
        eviction manager's pressure signals as node conditions (the
        kubelet-side source of CheckNodeMemoryPressure/DiskPressure)."""
        try:
            cur: Node = self.api.get("Node", "", self.node_name)
        except NotFound:
            return
        keep = ("Ready", "MemoryPressure", "DiskPressure")
        conds = [c for c in cur.conditions if c.type not in keep]
        conds.append(NodeCondition("Ready", ConditionStatus.TRUE))
        conds.append(NodeCondition(
            "MemoryPressure", ConditionStatus.TRUE
            if self.eviction.memory_pressure else ConditionStatus.FALSE))
        conds.append(NodeCondition(
            "DiskPressure", ConditionStatus.TRUE
            if self.eviction.disk_pressure else ConditionStatus.FALSE))
        ann = dict(cur.annotations)
        if self.volumes is not None:
            # node.status.volumesInUse: the attach-detach controller's
            # detach guard (volume_manager.go GetVolumesInUse)
            from kubernetes_tpu_torch.controllers.cloudctrl import \
                IN_USE_ANNOTATION
            in_use = ",".join(self.volumes.volumes_in_use())
            if in_use:
                ann[IN_USE_ANNOTATION] = in_use
            else:
                ann.pop(IN_USE_ANNOTATION, None)
        self.api.update("Node", dataclasses.replace(
            cur, heartbeat=self._now(), conditions=conds,
            annotations=ann))

    # ------------------------------------------------------------- pod flow

    def _local_usage(self) -> tuple:
        cpu = mem = count = 0
        for p in self._admitted.values():
            r = p.resource_request()
            cpu += r.milli_cpu
            mem += r.memory
            count += 1
        return cpu, mem, count

    def _admit(self, pod: Pod) -> Optional[str]:
        """GeneralPredicates node-side: capacity re-check against local state
        (lifecycle/predicate.go). Returns rejection reason or None."""
        r = pod.resource_request()
        cpu, mem, count = self._local_usage()
        alloc = self._template.allocatable
        if count + 1 > self._template.allowed_pod_number:
            return "OutOfPods"
        if cpu + r.milli_cpu > alloc.milli_cpu:
            return "OutOfcpu"
        if mem + r.memory > alloc.memory:
            return "OutOfmemory"
        return None

    def handle_pod(self, pod: Pod) -> None:
        """A bound pod appeared/changed for this node (syncLoopIteration
        ADD/UPDATE) — enqueued through the per-pod workers."""
        self.workers.update_pod(pod, "sync")

    def _sync_pod(self, pod: Pod, op: str) -> None:
        """The serialized per-pod sync body (kubelet.go:1390 syncPod)."""
        key = pod.key()
        if op == "remove" or pod.phase in ("Succeeded", "Failed"):
            self._forget(key)
            return
        if key in self._admitted or key in self._starting:
            return
        reason = self._admit(pod)
        if reason is not None:
            self._write_status(pod, phase="Failed", reason=reason)
            return
        if self.volumes is not None and pod.volumes:
            # syncPod blocks on WaitForAttachAndMount before containers
            # start (kubelet.go:1390 → volume_manager.go:339); failure
            # leaves the pod Pending for the next sync retry
            from kubernetes_tpu_torch.volumes.plugins import VolumeError
            try:
                # non-blocking (timeout=0): one reconcile attempt per sync
                # pass; a pending attach retries on the next sync instead
                # of stalling the serialized pod workers on wall-clock
                self.volumes.wait_for_attach_and_mount(pod, timeout=0)
            except VolumeError:
                self._write_status(pod, reason="FailedMount")
                return
        self._admitted[key] = pod
        self._starting[key] = self._now()
        # sandbox + image pulls + container create/start, through the CRI
        # boundary (kuberuntime SyncPod); step() polls for Running
        self.runtime_mgr.sync_pod(pod)
        self.prober.add_pod(pod, self._now())
        rec = self._restored.pop(key, None)
        if rec is not None and rec.get("restarts"):
            # resume the pre-restart counter (docker_checkpoint.go's
            # sandbox state reconstruction)
            self._restarts[key] = rec["restarts"]
        self._checkpoint(key)

    def _checkpoint(self, key: str) -> None:
        if self.checkpointer is None:
            return
        self.checkpointer.checkpoint(key, {
            "restarts": self._restarts.get(key, 0),
            "node": self.node_name})

    def forget_pod(self, pod: Pod) -> None:
        """Pod deleted from the apiserver (kubelet HandlePodRemoves)."""
        self.workers.update_pod(pod, "remove")

    def _forget(self, key: str) -> None:
        self._admitted.pop(key, None)
        self._starting.pop(key, None)
        self.runtime_mgr.kill_pod(key)
        self._restarts.pop(key, None)
        self._ready.pop(key, None)
        self.workers.forget(key)
        self.prober.remove_pod(key)
        if self.volumes is not None:
            self.volumes.teardown_pod(key)
        if self.checkpointer is not None:
            self.checkpointer.remove(key)

    # ---------------------------------------------------- kubelet API serving

    def serve_pods(self) -> list:
        """/pods: the admitted pod set (server.go InstallDefaultHandlers).
        dict() snapshot: handler threads must not iterate the live dict
        while the sync loop mutates it."""
        admitted = dict(self._admitted)
        restarts = dict(self._restarts)
        return [{"name": p.name, "namespace": p.namespace,
                 "phase": p.phase, "restartCount": restarts.get(key, 0)}
                for key, p in sorted(admitted.items())]

    def serve_stats(self) -> dict:
        """/stats/summary: the cadvisor summary shape."""
        cpu = mem = count = 0
        for p in dict(self._admitted).values():
            r = p.resource_request()
            cpu += r.milli_cpu
            mem += r.memory
            count += 1
        return {"node": {"nodeName": self.node_name,
                         "cpu": {"usageMilli": cpu},
                         "memory": {"workingSetBytes": mem}},
                "pods": count}

    def serve_logs(self, namespace: str, name: str,
                   tail=None) -> str:
        """/containerLogs/<ns>/<pod>: the one source of truth for the
        hollow log semantics (both the HTTP server and in-process ktctl
        route here). tail=0 prints nothing, like kubectl --tail=0."""
        from kubernetes_tpu_torch.nodes.kubelet_server import (
            KubeletApiError,
            LOG_LINES_ANNOTATION,
        )
        pod = self._admitted.get(namespace + "/" + name)
        if pod is None:
            raise KubeletApiError(
                404, f'pod "{namespace}/{name}" is not running on node '
                     f'"{self.node_name}"')
        lines = pod.annotations.get(LOG_LINES_ANNOTATION, "").split("\n")
        if tail is not None:
            try:
                n = int(tail)
            except (TypeError, ValueError):
                raise KubeletApiError(
                    400, f"invalid tailLines {tail!r}") from None
            lines = lines[-n:] if n > 0 else []
        return "\n".join(lines)

    def serve_attach(self, namespace: str, name: str) -> str:
        """POST /attach/<ns>/<pod>: attach to the running container's
        output stream (server.go InstallDebuggingHandlers attach; the
        hollow stream is the pod's current log tail). Attaching to a pod
        that is not Running is an error, unlike logs."""
        from kubernetes_tpu_torch.nodes.kubelet_server import KubeletApiError
        pod = self._admitted.get(namespace + "/" + name)
        if pod is None or pod.key() in self._starting:
            raise KubeletApiError(
                404, f'cannot attach: pod "{namespace}/{name}" is not '
                     f'running on node "{self.node_name}"')
        return self.serve_logs(namespace, name)

    PORT_ANNOTATION_PREFIX = "bench/port-"

    def serve_port(self, namespace: str, name: str, port: int) -> bytes:
        """GET /portForward/<ns>/<pod>?port=N: one round of the
        port-forward stream — what the pod "serves" on that port (the
        hollow runtime scripts it via the bench/port-<N> annotation, the
        way it scripts exec outputs)."""
        from kubernetes_tpu_torch.nodes.kubelet_server import KubeletApiError
        pod = self._admitted.get(namespace + "/" + name)
        if pod is None:
            raise KubeletApiError(
                404, f'pod "{namespace}/{name}" is not running on node '
                     f'"{self.node_name}"')
        payload = pod.annotations.get(
            self.PORT_ANNOTATION_PREFIX + str(port))
        if payload is None:
            raise KubeletApiError(
                400, f"pod {namespace}/{name} does not serve port {port}")
        return payload.encode()

    def serve_exec(self, namespace: str, name: str, cmd: str) -> str:
        """POST /exec/<ns>/<pod>?command=...: canned hollow outputs."""
        from kubernetes_tpu_torch.nodes.kubelet_server import (
            EXEC_PREFIX_ANNOTATION,
            KubeletApiError,
        )
        pod = self._admitted.get(namespace + "/" + name)
        if pod is None:
            raise KubeletApiError(
                404, f'pod "{namespace}/{name}" is not running on node '
                     f'"{self.node_name}"')
        out = pod.annotations.get(EXEC_PREFIX_ANNOTATION + cmd)
        if out is None:
            raise KubeletApiError(
                501, f"no handler for command {cmd!r} in the hollow "
                     f"runtime")
        return out

    # ----------------------------------------------------------- static pods

    def add_static_pod(self, pod: Pod) -> None:
        """A static-pod manifest (file/HTTP source, pkg/kubelet/config/):
        runs locally without a scheduler and surfaces on the apiserver as a
        MIRROR pod the kubelet owns (kubelet.go mirror-pod handling)."""
        pod = dataclasses.replace(
            pod, node_name=self.node_name,
            annotations={**pod.annotations, MIRROR_ANNOTATION: "true"})
        self._static[pod.key()] = pod
        self.workers.update_pod(pod, "sync")
        self._ensure_mirror(pod)

    def load_static_dir(self, path: str) -> int:
        """Read every *.json manifest in `path` (config/file.go source)."""
        import json
        import os

        from kubernetes_tpu_torch.api import serde
        n = 0
        for fn in sorted(os.listdir(path)):
            if not fn.endswith(".json"):
                continue
            with open(os.path.join(path, fn)) as f:
                self.add_static_pod(serde.decode_pod(json.load(f)))
                n += 1
        return n

    def _ensure_mirror(self, pod: Pod) -> None:
        """Recreate the mirror pod if absent — the apiserver copy is a
        projection the kubelet owns; deleting it does not stop the static
        pod."""
        try:
            self.api.get("Pod", pod.namespace, pod.name)
        except NotFound:
            mirror = dataclasses.replace(pod, resource_version=0)
            try:
                self.api.create("Pod", mirror)
            except Conflict:
                pass

    # ------------------------------------------------------------- sync loop

    def step(self) -> int:
        """One syncLoop iteration: drain the pod workers, advance startups
        and completions, run the probe workers, run the eviction manager.
        Returns number of status transitions written."""
        now = self._now()
        wrote = 0
        self.workers.drain()
        # orphaned-checkpoint GC: a restored record whose pod was deleted
        # (or rebound) while this kubelet was down never gets re-admitted
        # — without this sweep its file lives forever and a future
        # same-named pod would inherit a dead pod's restart counter
        if self.checkpointer is not None and self._restored:
            for pod_key in list(self._restored):
                ns, _, name = pod_key.partition("/")
                try:
                    cur = self.api.get("Pod", ns, name)
                    stale = cur.node_name != self.node_name
                except NotFound:
                    stale = True
                if stale:
                    self._restored.pop(pod_key, None)
                    self.checkpointer.remove(pod_key)
        for pod in self._static.values():
            self._ensure_mirror(pod)
        # ---- runtime relist for in-flight startups (the PLEG pass) ------
        for key in list(self._starting):
            pod = self._admitted.get(key)
            if pod is None:
                del self._starting[key]
                continue
            # one status read; execute actions only when there are any (a
            # liveness restart leaves killed containers behind —
            # computePodActions starts the fresh attempt here)
            status = self.runtime_mgr.pod_status(pod)
            actions = self.runtime_mgr.compute_pod_actions(pod, status)
            if self.runtime_mgr.actions_needed(actions):
                self.runtime_mgr.execute_pod_actions(pod, actions)
                status = self.runtime_mgr.pod_status(pod)
            if not (status.all_running or status.completed_phase):
                continue
            del self._starting[key]
            if status.completed_phase:
                # already terminal at relist time — e.g. a liveness-killed
                # (137) pod whose restartPolicy Never forbids the fresh
                # attempt: report Failed/Succeeded and release it, never
                # "Running" (it would sit unready forever — the scripted
                # completion sweep below only polls annotated workloads)
                self._admitted.pop(key, None)
                if self._write_status(pod, phase=status.completed_phase):
                    wrote += 1
                continue
            # a pod with a readiness probe starts NOT-ready; the probe
            # flips it (results_manager initial state)
            ready0 = not self.prober.has_readiness(key)
            if self._write_status(pod, phase="Running", ready=ready0,
                                  restart_count=self._restarts.get(key, 0)):
                wrote += 1
            self._ready[key] = ready0
        # ---- probe workers over running pods ----------------------------
        for key, pod in list(self._admitted.items()):
            if key in self._starting:
                continue
            ready, live = self.prober.tick(pod)
            if live is False:
                wrote += self._restart_container(key, pod)
                continue
            if ready is not None and ready != self._ready.get(key):
                if self._write_status(pod, ready=ready):
                    wrote += 1
                    self._ready[key] = ready
        # ---- eviction manager -------------------------------------------
        for key in self.eviction.synchronize(
                {k: p for k, p in self._admitted.items()
                 if k not in self._starting},
                extra_disk=self.runtime.image_fs_info(),
                disk_reclaim=self.image_gc.free_space):
            pod = self._admitted.get(key)
            if pod is not None:
                if self._write_status(pod, phase="Failed", reason="Evicted"):
                    wrote += 1
                self._forget(key)
        # ---- run-to-completion: the runtime reports natural exits -------
        for key, pod in list(self._admitted.items()):
            if key in self._starting:
                continue
            # scripted runtime: only pods with a scripted exit can finish;
            # a REAL runtime's containers can die anytime, so poll them all
            if self.runtime.exits_are_scripted \
                    and RUN_SECONDS_ANNOTATION not in pod.annotations:
                continue
            status = self.runtime_mgr.pod_status(pod)
            if not status.completed_phase:
                continue
            self._admitted.pop(key, None)
            if self._write_status(pod, phase=status.completed_phase):
                wrote += 1
        return wrote

    def _restart_container(self, key: str, pod: Pod) -> int:
        """Liveness failure past threshold: restart per restartPolicy
        (kuberuntime SyncPod computePodActions kill+recreate; restartPolicy
        Never -> the pod fails)."""
        if pod.restart_policy == "Never":
            self._write_status(pod, phase="Failed", reason="Unhealthy")
            self._forget(key)
            return 1
        self._restarts[key] = self._restarts.get(key, 0) + 1
        self._checkpoint(key)
        # CRI kill + immediate re-sync: the fresh attempt starts NOW (with
        # the runtime's boot latency), not one step later — keeping restart
        # downtime and the prober's restart clock in agreement
        self.runtime_mgr.restart_pod_containers(pod)
        self.runtime_mgr.sync_pod(pod)
        started_at = self._now() + self.startup_latency
        self._starting[key] = self._now()
        self.prober.restart(pod, started_at)
        wrote = 0
        # pod goes unready while the container restarts
        if self._write_status(pod, ready=False,
                              restart_count=self._restarts[key]):
            self._ready[key] = False
            wrote = 1
        return wrote

    def _write_status(self, pod: Pod, phase: Optional[str] = None,
                      ready: Optional[bool] = None,
                      restart_count: Optional[int] = None,
                      reason: str = "") -> bool:
        """Status-manager PATCH with conflict retry."""
        for _ in range(3):
            try:
                cur: Pod = self.api.get("Pod", pod.namespace, pod.name)
            except NotFound:
                self._forget(pod.key())
                return False
            if cur.node_name != self.node_name:
                return False  # rebound elsewhere
            ann = dict(cur.annotations)
            if reason:
                ann["kubernetes.io/failure-reason"] = reason
            changes = dict(annotations=ann)
            if phase is not None:
                changes["phase"] = phase
            if ready is not None:
                changes["ready"] = ready
            if restart_count is not None:
                changes["restart_count"] = restart_count
            try:
                self.api.update("Pod", dataclasses.replace(cur, **changes),
                                expect_rv=cur.resource_version)
                return True
            except Conflict:
                continue
            except NotFound:
                return False
        return False


class HollowFleet:
    """N hollow kubelets behind ONE pod informer (by-node index dispatch)."""

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 startup_latency: float = 0.0,
                 now: Callable[[], float] = time.monotonic):
        self.api = api
        self._now = now
        self.startup_latency = startup_latency
        self.kubelets: Dict[str, HollowKubelet] = {}
        self.pod_informer = factory.informer("Pod")
        self.pod_informer.add_event_handler(
            on_add=self._dispatch_add,
            on_update=self._dispatch_update,
            on_delete=self._dispatch_delete)

    def add_node(self, node: Node, register: bool = True) -> HollowKubelet:
        kl = HollowKubelet(self.api, node,
                           startup_latency=self.startup_latency, now=self._now)
        self.kubelets[node.name] = kl
        if register:
            kl.register()
        return kl

    def _dispatch_add(self, pod: Pod) -> None:
        if pod.node_name and pod.node_name in self.kubelets:
            self.kubelets[pod.node_name].handle_pod(pod)

    def _dispatch_update(self, old: Pod, new: Pod) -> None:
        if old.node_name and old.node_name != new.node_name \
                and old.node_name in self.kubelets:
            self.kubelets[old.node_name].forget_pod(old)
        self._dispatch_add(new)

    def _dispatch_delete(self, pod: Pod) -> None:
        if pod.node_name and pod.node_name in self.kubelets:
            self.kubelets[pod.node_name].forget_pod(pod)

    def step(self) -> int:
        """Advance every kubelet's pod state machines."""
        return sum(kl.step() for kl in self.kubelets.values())

    def heartbeat_all(self) -> None:
        for kl in self.kubelets.values():
            kl.heartbeat()
