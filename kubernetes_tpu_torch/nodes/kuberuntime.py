"""Runtime manager: the kubelet's bridge from Pod specs to the CRI.

The reference's kubeGenericRuntimeManager
(pkg/kubelet/kuberuntime/kuberuntime_manager.go) is the only code that
speaks both languages: it reads v1.Pod specs from above and drives the CRI
RuntimeService below. Its core is `computePodActions`
(kuberuntime_manager.go:414, acting on the podActions struct at :337):
given the pod spec and the runtime's observed state, decide — create a
sandbox? kill the pod? which containers to kill, which to start — then
SyncPod executes those actions in order (sandbox first, then containers).

RuntimeManager is that design over nodes/cri.py: pure decision
(`compute_pod_actions`) separated from execution (`sync_pod`), so any
RuntimeService implementation — the scripted fake, the process runtime —
gets identical lifecycle semantics. Restart-count bookkeeping rides the
CRI attempt counter (a same-named container re-created in the same sandbox
is attempt N+1), matching how the reference derives restart counts from
container attempts rather than keeping a side ledger.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.nodes.cri import (
    CREATED,
    EXITED,
    RUNNING,
    SANDBOX_READY,
    ContainerConfig,
    ContainerStatus,
    PodSandboxConfig,
    RuntimeService,
)

# Scripted-workload annotations (see nodes/kubelet.py module docstring).
RUN_SECONDS_ANNOTATION = "bench/run-seconds"
FAIL_ANNOTATION = "bench/fail"
IMAGE_SIZE_ANNOTATION = "bench/image-size"  # bytes per pulled image


@dataclass
class PodActions:
    """computePodActions' output (kuberuntime_manager.go:337 podActions)."""

    create_sandbox: bool = False
    sandbox_id: str = ""
    kill_pod: bool = False
    containers_to_start: List[ContainerConfig] = field(default_factory=list)
    containers_to_kill: List[str] = field(default_factory=list)


@dataclass
class PodRuntimeStatus:
    """The manager's aggregate view of one pod, derived purely from CRI
    statuses (the kubecontainer.PodStatus analog the kubelet's sync loop
    consumes)."""

    sandbox_id: str = ""
    exists: bool = False
    all_running: bool = False
    # "Succeeded"/"Failed" once every container ran to completion (scripted
    # run_seconds workloads); "" while anything still runs
    completed_phase: str = ""
    restarts: int = 0  # sum over containers of (attempt number)
    containers: List[ContainerStatus] = field(default_factory=list)


class RuntimeManager:
    def __init__(self, runtime: RuntimeService,
                 image_manager=None,
                 now: Callable[[], float] = time.monotonic):
        self.runtime = runtime
        self.images = image_manager
        self._now = now
        self._sandbox_ids: Dict[str, str] = {}  # pod key -> sandbox id

    # ---------------------------------------------------------- spec → CRI

    @staticmethod
    def container_configs(pod: Pod) -> List[ContainerConfig]:
        """Translate the pod's container specs to CRI container configs,
        attaching the scripted workload (run-seconds / fail) the hollow
        runtimes execute. A pod with no declared containers still gets one
        synthetic container — a sandbox with nothing in it is not a
        runnable pod."""
        run_s = pod.annotations.get(RUN_SECONDS_ANNOTATION)
        run_seconds = float(run_s) if run_s is not None else None
        fail = bool(pod.annotations.get(FAIL_ANNOTATION))
        specs = pod.containers or [None]
        out = []
        for i, c in enumerate(specs):
            name = c.name if c is not None and c.name else f"ctr-{i}"
            image = c.image if c is not None and c.image else "pause:latest"
            out.append(ContainerConfig(name=name, image=image,
                                       run_seconds=run_seconds,
                                       fail_exit=fail))
        return out

    # ------------------------------------------------------------ observe

    def pod_status(self, pod: Pod) -> PodRuntimeStatus:
        key = pod.key()
        sid = self._sandbox_ids.get(key)
        st = PodRuntimeStatus()
        if sid is None:
            return st
        sb = self.runtime.pod_sandbox_status(sid)
        if sb is None:
            return st
        st.sandbox_id = sid
        st.exists = True
        containers = self.runtime.list_containers(sandbox_id=sid)
        st.containers = containers
        # latest attempt per container name is the live one
        latest: Dict[str, ContainerStatus] = {}
        for c in containers:
            cur = latest.get(c.name)
            if cur is None or c.attempt > cur.attempt:
                latest[c.name] = c
        want = self.container_configs(pod)
        st.restarts = sum(c.attempt for c in latest.values())
        if latest and len(latest) == len(want) \
                and all(c.state == RUNNING for c in latest.values()):
            st.all_running = True
        if latest and len(latest) == len(want) \
                and all(c.state == EXITED for c in latest.values()):
            # natural completion only — a 137 means the kubelet killed it
            # (liveness restart in flight), not that the workload finished
            if all(c.exit_code != 137 for c in latest.values()):
                st.completed_phase = "Failed" if any(
                    c.exit_code != 0 for c in latest.values()) else "Succeeded"
            elif pod.restart_policy == "Never":
                # kubelet-killed (137) with restartPolicy Never: no fresh
                # attempt will ever start (compute_pod_actions refuses), so
                # without a terminal phase the pod would sit in the
                # kubelet's _starting set unready forever. The reference
                # resolves this in GetPhase (kuberuntime_manager.go /
                # kubelet_pods.go:1311): stopped containers that cannot
                # restart make the pod Failed.
                st.completed_phase = "Failed"
        return st

    # ------------------------------------------------------------- decide

    def compute_pod_actions(self, pod: Pod,
                            status: PodRuntimeStatus) -> PodActions:
        """kuberuntime_manager.go:414 computePodActions, for the hollow
        lifecycle: create the sandbox if absent; start any container whose
        latest attempt is missing; restart (start a fresh attempt of) a
        container the kubelet killed (exit 137) when restartPolicy allows;
        never restart a naturally-completed workload."""
        actions = PodActions(sandbox_id=status.sandbox_id)
        if not status.exists:
            actions.create_sandbox = True
            actions.containers_to_start = self.container_configs(pod)
            return actions
        latest: Dict[str, ContainerStatus] = {}
        for c in status.containers:
            cur = latest.get(c.name)
            if cur is None or c.attempt > cur.attempt:
                latest[c.name] = c
        for cfg in self.container_configs(pod):
            cur = latest.get(cfg.name)
            if cur is None:
                actions.containers_to_start.append(cfg)
            elif cur.state == EXITED and cur.exit_code == 137 \
                    and pod.restart_policy != "Never":
                actions.containers_to_start.append(cfg)
        return actions

    # ------------------------------------------------------------ execute

    def sync_pod(self, pod: Pod) -> PodActions:
        """SyncPod (kuberuntime_manager.go SyncPod): compute, then act —
        sandbox first, then image pulls, then container create+start."""
        status = self.pod_status(pod)
        actions = self.compute_pod_actions(pod, status)
        self.execute_pod_actions(pod, actions)
        return actions

    def execute_pod_actions(self, pod: Pod, actions: PodActions) -> None:
        """The action-execution half, split from decision so callers that
        already hold a fresh PodRuntimeStatus (the kubelet's per-step
        relist) don't pay a second status read just to find no-op."""
        sid = actions.sandbox_id
        if actions.create_sandbox:
            sid = self.runtime.run_pod_sandbox(PodSandboxConfig(
                name=pod.name, namespace=pod.namespace, uid=pod.uid,
                annotations=dict(pod.annotations)))
            self._sandbox_ids[pod.key()] = sid
        for cid in actions.containers_to_kill:
            self.runtime.stop_container(cid)
        for cfg in actions.containers_to_start:
            if self.images is not None:
                size = int(pod.annotations.get(IMAGE_SIZE_ANNOTATION, 0))
                self.images.ensure_image_exists(pod, cfg.image, size)
            cid = self.runtime.create_container(sid, cfg)
            self.runtime.start_container(cid)

    @staticmethod
    def actions_needed(actions: PodActions) -> bool:
        return bool(actions.create_sandbox or actions.containers_to_start
                    or actions.containers_to_kill)

    def restart_pod_containers(self, pod: Pod) -> None:
        """Kill the pod's running containers (liveness failure: the
        kubelet's restart is CRI kill + fresh attempt on the next sync —
        kuberuntime_manager.go SyncPod's kill-then-start path)."""
        key = pod.key()
        sid = self._sandbox_ids.get(key)
        if sid is None:
            return
        for c in self.runtime.list_containers(sandbox_id=sid):
            if c.state in (CREATED, RUNNING):
                self.runtime.stop_container(c.id)

    def kill_pod(self, pod_key: str) -> None:
        """Tear the pod down: stop + remove its sandbox (KillPod)."""
        sid = self._sandbox_ids.pop(pod_key, None)
        if sid is None:
            return
        self.runtime.stop_pod_sandbox(sid)
        self.runtime.remove_pod_sandbox(sid)

    def sandbox_ready(self, pod_key: str) -> bool:
        sid = self._sandbox_ids.get(pod_key)
        if sid is None:
            return False
        sb = self.runtime.pod_sandbox_status(sid)
        return sb is not None and sb.state == SANDBOX_READY
