"""CRI-shaped container runtime boundary.

The reference kubelet talks to ANY container runtime through one interface
pair — RuntimeService (sandbox + container lifecycle) and ImageService
(pull/list/remove/fs-info) — defined in pkg/kubelet/apis/cri/services.go:33
(ContainerManager), :59 (PodSandboxManager), :89 (RuntimeService), :103
(ImageManagerService). Shims (dockershim/, rktshim/, remote/) implement it;
the kubelet's runtime manager (kuberuntime/) drives it and nothing above the
manager knows which runtime is behind it.

This module is that seam for the TPU build:

- `RuntimeService` / `ImageService`: the abstract boundary. In-process
  method calls stand in for the reference's gRPC hop — the contract (ids,
  states, attempt counters, idempotent stops) is what matters, not the
  transport; the hollow fleet runs 5k kubelets in one process and a gRPC
  round-trip per sandbox op would be pure overhead on the bench path.
- `FakeRuntimeService`: the kubemark move (NewFakeDockerClient,
  cmd/kubemark/hollow-node.go:119-121) — the hollow kubelet's previous
  inline annotation-scripted behavior, reimplemented BEHIND the interface.
  Boot latency and run-to-completion are simulated against the kubelet's
  (possibly fake) clock, so the virtual-clock tests keep working.
- `ProcessRuntimeService`: a second, real runtime — sandboxes and
  containers are actual OS processes (`build/bin/pause` when built, else
  /bin/sleep). It exists to prove the boundary: the kubelet runs against it
  with zero kubelet changes (tests/test_cri.py).

States mirror the CRI enums (PodSandboxState / ContainerState in the CRI
protobuf, pkg/kubelet/apis/cri/v1alpha1/runtime/): a sandbox is READY or
NOTREADY; a container is CREATED -> RUNNING -> EXITED.
"""

from __future__ import annotations

import abc
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

# Container states (CRI ContainerState enum).
CREATED = "created"
RUNNING = "running"
EXITED = "exited"

# Sandbox states (CRI PodSandboxState enum).
SANDBOX_READY = "ready"
SANDBOX_NOTREADY = "notready"


@dataclass
class PodSandboxConfig:
    """What the manager hands RunPodSandbox (CRI PodSandboxConfig): enough
    identity to find the sandbox again and the pod-level annotations the
    fake runtime scripts behavior from."""

    name: str = ""
    namespace: str = ""
    uid: str = ""
    annotations: Dict[str, str] = field(default_factory=dict)

    def pod_key(self) -> str:
        return self.namespace + "/" + self.name


@dataclass
class ContainerConfig:
    """CRI ContainerConfig reduced to what the hollow runtimes consume.
    run_seconds/fail_exit are the scripted workload (parsed from pod
    annotations by the manager, the way kubemark scripts its fake docker)."""

    name: str = ""
    image: str = ""
    run_seconds: Optional[float] = None
    fail_exit: bool = False


@dataclass
class PodSandboxStatus:
    id: str = ""
    state: str = SANDBOX_READY
    created_at: float = 0.0
    config: PodSandboxConfig = field(default_factory=PodSandboxConfig)


@dataclass
class ContainerStatus:
    """CRI ContainerStatus: the manager reads state/attempt/exit_code to
    compute pod phase and restart counts."""

    id: str = ""
    name: str = ""
    sandbox_id: str = ""
    image: str = ""
    state: str = CREATED
    attempt: int = 0
    created_at: float = 0.0
    # the instant it becomes RUNNING; None until StartContainer (a None
    # sentinel, not 0.0 — virtual test clocks legitimately start at 0.0)
    started_at: Optional[float] = None
    finished_at: float = 0.0
    exit_code: int = 0


@dataclass
class Image:
    """CRI Image (ImageService.ListImages element)."""

    ref: str = ""
    size_bytes: int = 0
    pulled_at: float = 0.0
    last_used_at: float = 0.0


class RuntimeService(abc.ABC):
    """Sandbox + container lifecycle (services.go:89 RuntimeService =
    PodSandboxManager + ContainerManager). All ops are idempotent where the
    CRI requires it (StopPodSandbox/StopContainer on an already-stopped
    target must not error)."""

    # -- PodSandboxManager (services.go:59) --------------------------------
    @abc.abstractmethod
    def run_pod_sandbox(self, config: PodSandboxConfig) -> str:
        """Create+start the pod-level sandbox; returns its id."""

    @abc.abstractmethod
    def stop_pod_sandbox(self, sandbox_id: str) -> None:
        """Stop the sandbox (and any containers in it). Idempotent."""

    @abc.abstractmethod
    def remove_pod_sandbox(self, sandbox_id: str) -> None:
        """Remove a stopped sandbox and its containers. Idempotent."""

    @abc.abstractmethod
    def pod_sandbox_status(self, sandbox_id: str) -> Optional[PodSandboxStatus]:
        pass

    @abc.abstractmethod
    def list_pod_sandboxes(self) -> List[PodSandboxStatus]:
        pass

    # -- ContainerManager (services.go:33) ---------------------------------
    @abc.abstractmethod
    def create_container(self, sandbox_id: str,
                         config: ContainerConfig) -> str:
        """Create (not start) a container in the sandbox; returns its id.
        The attempt counter is per (sandbox, container-name): creating a
        same-named container again is a restart."""

    @abc.abstractmethod
    def start_container(self, container_id: str) -> None:
        pass

    @abc.abstractmethod
    def stop_container(self, container_id: str) -> None:
        """Idempotent; an EXITED container stays EXITED."""

    @abc.abstractmethod
    def remove_container(self, container_id: str) -> None:
        pass

    @abc.abstractmethod
    def container_status(self, container_id: str) -> Optional[ContainerStatus]:
        pass

    @abc.abstractmethod
    def list_containers(self, sandbox_id: Optional[str] = None
                        ) -> List[ContainerStatus]:
        pass

    def version(self) -> str:
        return "0.1.0"

    # True when container exits only happen through scripted run_seconds
    # configs (the fake runtime): the kubelet then skips the per-step exit
    # poll for pods with no scripted exit — a real runtime's containers
    # can die at any time, so it stays False by default
    exits_are_scripted = False


class ImageService(abc.ABC):
    """Image lifecycle (services.go:103 ImageManagerService)."""

    @abc.abstractmethod
    def pull_image(self, ref: str, size_bytes: int = 0) -> str:
        pass

    @abc.abstractmethod
    def list_images(self) -> List[Image]:
        pass

    @abc.abstractmethod
    def remove_image(self, ref: str) -> None:
        pass

    @abc.abstractmethod
    def image_fs_info(self) -> int:
        """Total bytes used by images (CRI ImageFsInfo, collapsed to the
        one number ImageGC needs)."""


class FakeRuntimeService(RuntimeService, ImageService):
    """The hollow runtime: kubemark's scripted fake docker client behind
    the CRI boundary. Time-driven behavior is computed lazily from the
    injected clock so virtual-clock tests drive it:

    - a started container reports CREATED until `boot_latency` has elapsed
      since StartContainer, then RUNNING (the FakeDockerClient EnableSleep
      startup simulation, hollow-node.go:119-121)
    - a container whose config carries run_seconds reports EXITED (exit
      code 1 if fail_exit) once that long RUNNING
    """

    exits_are_scripted = True

    def __init__(self, boot_latency: float = 0.0,
                 now: Callable[[], float] = time.monotonic):
        self.boot_latency = boot_latency
        self._now = now
        self._sandboxes: Dict[str, PodSandboxStatus] = {}
        self._containers: Dict[str, ContainerStatus] = {}
        self._configs: Dict[str, ContainerConfig] = {}
        self._attempts: Dict[str, int] = {}  # (sandbox_id, name) -> count
        # sandbox id -> container ids, so per-pod relists are O(pod
        # containers) — a 5k-kubelet hollow fleet polls every pod every
        # step and a flat scan would make that quadratic
        self._by_sandbox: Dict[str, List[str]] = {}
        self._images: Dict[str, Image] = {}
        self._seq = 0
        self.ops: Dict[str, int] = {}  # op-name -> call count (test probe)

    def _id(self, prefix: str) -> str:
        self._seq += 1
        return f"{prefix}-{self._seq}"

    def _count(self, op: str) -> None:
        self.ops[op] = self.ops.get(op, 0) + 1

    # -- sandboxes ---------------------------------------------------------

    def run_pod_sandbox(self, config: PodSandboxConfig) -> str:
        self._count("RunPodSandbox")
        sid = self._id("sandbox")
        self._sandboxes[sid] = PodSandboxStatus(
            id=sid, state=SANDBOX_READY, created_at=self._now(),
            config=config)
        self._by_sandbox[sid] = []
        return sid

    def stop_pod_sandbox(self, sandbox_id: str) -> None:
        self._count("StopPodSandbox")
        sb = self._sandboxes.get(sandbox_id)
        if sb is None:
            return
        sb.state = SANDBOX_NOTREADY
        for cid in self._by_sandbox.get(sandbox_id, []):
            c = self._containers.get(cid)
            if c is not None:
                self._stop(c)

    def remove_pod_sandbox(self, sandbox_id: str) -> None:
        self._count("RemovePodSandbox")
        self._sandboxes.pop(sandbox_id, None)
        for cid in self._by_sandbox.pop(sandbox_id, []):
            self._containers.pop(cid, None)
            self._configs.pop(cid, None)

    def pod_sandbox_status(self, sandbox_id: str) -> Optional[PodSandboxStatus]:
        return self._sandboxes.get(sandbox_id)

    def list_pod_sandboxes(self) -> List[PodSandboxStatus]:
        return list(self._sandboxes.values())

    # -- containers --------------------------------------------------------

    def create_container(self, sandbox_id: str,
                         config: ContainerConfig) -> str:
        self._count("CreateContainer")
        if sandbox_id not in self._sandboxes:
            raise KeyError(f"no sandbox {sandbox_id!r}")
        cid = self._id("ctr")
        akey = sandbox_id + "/" + config.name
        attempt = self._attempts.get(akey, 0)
        self._attempts[akey] = attempt + 1
        self._containers[cid] = ContainerStatus(
            id=cid, name=config.name, sandbox_id=sandbox_id,
            image=config.image, state=CREATED, attempt=attempt,
            created_at=self._now())
        self._configs[cid] = config
        self._by_sandbox[sandbox_id].append(cid)
        img = self._images.get(config.image)
        if img is not None:
            img.last_used_at = self._now()
        return cid

    def start_container(self, container_id: str) -> None:
        self._count("StartContainer")
        c = self._containers[container_id]
        # becomes RUNNING at started_at; _refresh computes the lazy state
        c.started_at = self._now() + self.boot_latency

    def _stop(self, c: ContainerStatus) -> None:
        if c.state == EXITED:
            return
        self._refresh(c)
        if c.state == EXITED:
            return
        c.state = EXITED
        c.finished_at = self._now()
        c.exit_code = 137  # SIGKILLed, as docker reports a stopped container

    def stop_container(self, container_id: str) -> None:
        self._count("StopContainer")
        c = self._containers.get(container_id)
        if c is not None:
            self._stop(c)

    def remove_container(self, container_id: str) -> None:
        self._count("RemoveContainer")
        c = self._containers.pop(container_id, None)
        self._configs.pop(container_id, None)
        if c is not None and c.sandbox_id in self._by_sandbox:
            try:
                self._by_sandbox[c.sandbox_id].remove(container_id)
            except ValueError:
                pass

    def _refresh(self, c: ContainerStatus) -> None:
        """Advance the lazily-computed state to the current clock."""
        if c.state == EXITED:
            return
        now = self._now()
        if c.started_at is not None and now >= c.started_at:
            c.state = RUNNING
            cfg = self._configs.get(c.id)
            if cfg is not None and cfg.run_seconds is not None \
                    and now >= c.started_at + cfg.run_seconds:
                c.state = EXITED
                c.finished_at = c.started_at + cfg.run_seconds
                c.exit_code = 1 if cfg.fail_exit else 0

    def container_status(self, container_id: str) -> Optional[ContainerStatus]:
        c = self._containers.get(container_id)
        if c is not None:
            self._refresh(c)
        return c

    def list_containers(self, sandbox_id: Optional[str] = None
                        ) -> List[ContainerStatus]:
        if sandbox_id is not None:
            cids = self._by_sandbox.get(sandbox_id, [])
            out = [self._containers[cid] for cid in cids
                   if cid in self._containers]
        else:
            out = list(self._containers.values())
        for c in out:
            self._refresh(c)
        return out

    # -- images ------------------------------------------------------------

    def pull_image(self, ref: str, size_bytes: int = 0) -> str:
        self._count("PullImage")
        img = self._images.get(ref)
        if img is None:
            img = Image(ref=ref, size_bytes=size_bytes,
                        pulled_at=self._now())
            self._images[ref] = img
        img.last_used_at = self._now()
        return ref

    def list_images(self) -> List[Image]:
        return list(self._images.values())

    def remove_image(self, ref: str) -> None:
        self._count("RemoveImage")
        self._images.pop(ref, None)

    def image_fs_info(self) -> int:
        return sum(i.size_bytes for i in self._images.values())

    def images_in_use(self) -> set:
        """Image refs referenced by any non-removed container — protected
        from GC (image_gc_manager.go detectImages' imagesInUse)."""
        return {c.image for c in self._containers.values() if c.image}


class ProcessRuntimeService(RuntimeService, ImageService):
    """A real runtime behind the same boundary: every sandbox is a real
    `pause` process (build/bin/pause if compiled, else /bin/sleep) holding
    the pod's existence the way the reference's pause container holds its
    network namespace (build/pause/pause.c), and every container is a real
    child process. Proves the kubelet is runtime-agnostic; wall-clock only
    (real processes don't run on a virtual clock)."""

    def __init__(self, pause_path: Optional[str] = None):
        import os
        self._pause = pause_path
        if self._pause is None:
            cand = os.path.join(os.path.dirname(__file__), os.pardir,
                                os.pardir, "build", "bin", "pause")
            self._pause = cand if os.path.exists(cand) else None
        self._sandboxes: Dict[str, PodSandboxStatus] = {}
        self._procs: Dict[str, object] = {}  # sandbox/container id -> Popen
        self._containers: Dict[str, ContainerStatus] = {}
        self._configs: Dict[str, ContainerConfig] = {}
        self._attempts: Dict[str, int] = {}
        self._images: Dict[str, Image] = {}
        self._seq = 0

    def _id(self, prefix: str) -> str:
        self._seq += 1
        return f"{prefix}-{self._seq}"

    def _spawn(self, argv: List[str]):
        import subprocess
        return subprocess.Popen(
            argv, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    # -- sandboxes ---------------------------------------------------------

    def run_pod_sandbox(self, config: PodSandboxConfig) -> str:
        sid = self._id("sandbox")
        argv = [self._pause] if self._pause else ["/bin/sleep", "86400"]
        self._procs[sid] = self._spawn(argv)
        self._sandboxes[sid] = PodSandboxStatus(
            id=sid, state=SANDBOX_READY, created_at=time.monotonic(),
            config=config)
        return sid

    def stop_pod_sandbox(self, sandbox_id: str) -> None:
        sb = self._sandboxes.get(sandbox_id)
        if sb is None:
            return
        sb.state = SANDBOX_NOTREADY
        for cid, c in self._containers.items():
            if c.sandbox_id == sandbox_id:
                self.stop_container(cid)
        self._kill(sandbox_id)

    def remove_pod_sandbox(self, sandbox_id: str) -> None:
        self.stop_pod_sandbox(sandbox_id)
        self._sandboxes.pop(sandbox_id, None)
        for cid in [cid for cid, c in self._containers.items()
                    if c.sandbox_id == sandbox_id]:
            self._containers.pop(cid)
            self._configs.pop(cid, None)
            self._procs.pop(cid, None)

    def pod_sandbox_status(self, sandbox_id: str) -> Optional[PodSandboxStatus]:
        return self._sandboxes.get(sandbox_id)

    def list_pod_sandboxes(self) -> List[PodSandboxStatus]:
        return list(self._sandboxes.values())

    def _kill(self, proc_id: str) -> None:
        proc = self._procs.get(proc_id)
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()

    # -- containers --------------------------------------------------------

    def create_container(self, sandbox_id: str,
                         config: ContainerConfig) -> str:
        if sandbox_id not in self._sandboxes:
            raise KeyError(f"no sandbox {sandbox_id!r}")
        cid = self._id("ctr")
        akey = sandbox_id + "/" + config.name
        attempt = self._attempts.get(akey, 0)
        self._attempts[akey] = attempt + 1
        self._containers[cid] = ContainerStatus(
            id=cid, name=config.name, sandbox_id=sandbox_id,
            image=config.image, state=CREATED, attempt=attempt,
            created_at=time.monotonic())
        self._configs[cid] = config
        return cid

    def start_container(self, container_id: str) -> None:
        cfg = self._configs[container_id]
        run_s = cfg.run_seconds if cfg.run_seconds is not None else 86400
        argv = ["/bin/sh", "-c",
                f"sleep {run_s}; exit {1 if cfg.fail_exit else 0}"]
        self._procs[container_id] = self._spawn(argv)
        c = self._containers[container_id]
        c.state = RUNNING
        c.started_at = time.monotonic()

    def stop_container(self, container_id: str) -> None:
        c = self._containers.get(container_id)
        if c is None or c.state == EXITED:
            return
        self._refresh(c)
        if c.state == EXITED:
            return
        self._kill(container_id)
        c.state = EXITED
        c.finished_at = time.monotonic()
        c.exit_code = 137

    def remove_container(self, container_id: str) -> None:
        self.stop_container(container_id)
        self._containers.pop(container_id, None)
        self._configs.pop(container_id, None)
        self._procs.pop(container_id, None)

    def _refresh(self, c: ContainerStatus) -> None:
        if c.state != RUNNING:
            return
        proc = self._procs.get(c.id)
        if proc is not None:
            rc = proc.poll()
            if rc is not None:
                c.state = EXITED
                c.finished_at = time.monotonic()
                c.exit_code = rc

    def container_status(self, container_id: str) -> Optional[ContainerStatus]:
        c = self._containers.get(container_id)
        if c is not None:
            self._refresh(c)
        return c

    def list_containers(self, sandbox_id: Optional[str] = None
                        ) -> List[ContainerStatus]:
        out = []
        for c in self._containers.values():
            if sandbox_id is not None and c.sandbox_id != sandbox_id:
                continue
            self._refresh(c)
            out.append(c)
        return out

    # -- images (instant pulls; a process runtime has no registry) ---------

    def pull_image(self, ref: str, size_bytes: int = 0) -> str:
        if ref not in self._images:
            self._images[ref] = Image(ref=ref, size_bytes=size_bytes,
                                      pulled_at=time.monotonic())
        return ref

    def list_images(self) -> List[Image]:
        return list(self._images.values())

    def remove_image(self, ref: str) -> None:
        self._images.pop(ref, None)

    def image_fs_info(self) -> int:
        return sum(i.size_bytes for i in self._images.values())

    def images_in_use(self) -> set:
        return {c.image for c in self._containers.values() if c.image}

    def close(self) -> None:
        """Kill every process this runtime spawned (test teardown)."""
        for pid in list(self._procs):
            self._kill(pid)
        self._procs.clear()
