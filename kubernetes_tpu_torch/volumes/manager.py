"""Kubelet-side volume manager: desired/actual state + reconciler.

Mirror of pkg/kubelet/volumemanager/:

- DesiredStateOfWorld (cache/desired_state_of_world.go): volumes the
  pods assigned to this node need mounted.
- ActualStateOfWorld (cache/actual_state_of_world.go): what is mounted.
- Reconciler (reconciler/reconciler.go): mount what's desired and not
  actual (waiting for attach on attachable plugins), unmount what's
  actual and no longer desired.
- WaitForAttachAndMount (volume_manager.go:339): what syncPod blocks on
  before containers start; a timeout surfaces as the FailedMount event.

The controller-attaches model is assumed (the v1.7 default on cloud
nodes): this manager never attaches — it observes the attach-detach
controller's record on the Node object (controllers/cloudctrl.py) and
reports `volumes_in_use` so the controller will not detach a mounted
volume (the node.status.volumesInUse contract,
volume_manager.go GetVolumesInUse).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from kubernetes_tpu_torch.api.types import Pod, VolumeKind
from kubernetes_tpu_torch.volumes.plugins import (
    VolumeError,
    VolumeHost,
    VolumePluginManager,
    VolumeSpec,
    resolve_spec,
)


@dataclass
class _MountRecord:
    spec: VolumeSpec
    plugin_name: str


class VolumeManager:
    def __init__(self, plugin_mgr: VolumePluginManager, host: VolumeHost):
        self.plugins = plugin_mgr
        self.host = host
        # desired: pod_key -> volume_name -> VolumeSpec
        self._desired: Dict[str, Dict[str, VolumeSpec]] = {}
        self._desired_pods: Dict[str, Pod] = {}
        # actual: pod_key -> volume_name -> record
        self._actual: Dict[str, Dict[str, _MountRecord]] = {}
        self._mount_errors: Dict[str, Dict[str, str]] = {}

    # ------------------------------------------------- desired state (DSW)

    def add_pod(self, pod: Pod) -> None:
        """desired_state_of_world_populator: register every pod volume;
        PVC dereference happens here so an unbound claim is a visible
        error, not a silent skip."""
        wants: Dict[str, VolumeSpec] = {}
        for v in pod.volumes:
            wants[v.name] = resolve_spec(v, self.host.api, pod.namespace)
        self._desired[pod.key()] = wants
        self._desired_pods[pod.key()] = pod

    def remove_pod(self, pod_key: str) -> None:
        self._desired.pop(pod_key, None)
        self._desired_pods.pop(pod_key, None)
        self._mount_errors.pop(pod_key, None)

    # ------------------------------------------------------- actual state

    def mounted_volumes(self, pod_key: str) -> Set[str]:
        return set(self._actual.get(pod_key, {}))

    def volumes_in_use(self) -> List[str]:
        """node.status.volumesInUse: attachable devices currently mounted
        by any pod on this node — the detach guard the attach-detach
        controller honors."""
        devs: Set[str] = set()
        for mounts in self._actual.values():
            for rec in mounts.values():
                src = rec.spec.source
                if self.plugins.find_plugin_by_name(
                        rec.plugin_name).attachable:
                    devs.add(f"{VolumeKind(src.kind).value}:{src.volume_id}")
        return sorted(devs)

    # --------------------------------------------------------- reconciler

    def reconcile(self) -> Tuple[int, int]:
        """One reconciler pass: (mounted, unmounted) this round. Mount
        failures are recorded per volume (read back by
        wait_for_attach_and_mount) and retried next pass — the
        reconciler never throws, like reconciler.go's
        operation-executor error swallowing."""
        mounted = unmounted = 0
        # unmount: actual but no longer desired
        for pod_key in list(self._actual):
            for vname in list(self._actual[pod_key]):
                if vname not in self._desired.get(pod_key, {}):
                    rec = self._actual[pod_key][vname]
                    plugin = self.plugins.find_plugin_by_name(
                        rec.plugin_name)
                    plugin.new_unmounter(
                        vname, pod_key, self.host).tear_down()
                    del self._actual[pod_key][vname]
                    unmounted += 1
            if not self._actual[pod_key]:
                del self._actual[pod_key]
                self.host.remove_pod_dir(pod_key)
        # mount: desired but not actual
        for pod_key, wants in self._desired.items():
            pod = self._desired_pods[pod_key]
            for vname, spec in wants.items():
                if vname in self._actual.get(pod_key, {}):
                    continue
                try:
                    plugin = self.plugins.find_plugin_by_spec(spec)
                    m = plugin.new_mounter(spec, pod, self.host)
                    m.set_up()
                except VolumeError as e:
                    self._mount_errors.setdefault(
                        pod_key, {})[vname] = str(e)
                    continue
                self._mount_errors.get(pod_key, {}).pop(vname, None)
                self._actual.setdefault(pod_key, {})[vname] = \
                    _MountRecord(spec, plugin.name)
                mounted += 1
        return mounted, unmounted

    # ------------------------------------------------ the syncPod contract

    def wait_for_attach_and_mount(self, pod: Pod, timeout: float = 2.0,
                                  poll: float = 0.01,
                                  now=time.monotonic,
                                  sleep=time.sleep) -> None:
        """volume_manager.go:339 WaitForAttachAndMount: block until every
        pod volume is mounted or raise with the unmounted set + last
        per-volume errors (kubelet turns this into FailedMount).

        timeout=0 is the non-blocking form: one reconcile pass, then
        report — what the hollow kubelet uses per sync pass so an
        unmountable volume never stalls the serialized pod workers on
        real wall-clock (the retry is the next sync, like the kubelet's
        periodic syncCh resync)."""
        self.add_pod(pod)
        want = set(self._desired[pod.key()])
        deadline = now() + timeout
        while True:
            self.reconcile()
            missing = want - self.mounted_volumes(pod.key())
            if not missing:
                return
            if now() >= deadline:
                errs = self._mount_errors.get(pod.key(), {})
                detail = "; ".join(
                    f"{v}: {errs.get(v, 'not yet attached/mounted')}"
                    for v in sorted(missing))
                raise VolumeError(
                    f"unmounted volumes={sorted(missing)}: {detail}")
            sleep(poll)

    def teardown_pod(self, pod_key: str) -> int:
        """Pod gone: drop desire and reconcile the unmounts."""
        self.remove_pod(pod_key)
        _, unmounted = self.reconcile()
        return unmounted
