"""Volume plugin interface — the in-framework mirror of
pkg/volume/plugins.go.

The reference's contract, kept shape-for-shape:

- ``VolumePlugin``: `GetPluginName`, `CanSupport(spec)`, `NewMounter`,
  `NewUnmounter` (plugins.go:60-103); attachable plugins additionally
  produce an `Attacher`/`Detacher` (pkg/volume/*/attacher.go).
- ``VolumePluginMgr.FindPluginBySpec``: exactly one plugin must claim a
  spec — zero or multiple matches is an error (plugins.go:372-392).
- ``VolumeSpec``: either a direct pod volume or a PersistentVolume
  resolved from a PVC (volume/plugins.go Spec struct).
- ``VolumeHost``: what plugins may touch of the outside world
  (plugins.go:244 VolumeHost interface) — here: the pod-dir filesystem
  (an in-memory dict standing in for /var/lib/kubelet/pods/...), the API
  store (ConfigMap/Secret payloads), and the cloud provider (attach).

Mount results materialize files into `host.pod_dir(pod_key)[volume_name]`
so tests and the kubelet can assert actual content, the way the
reference's fake mounters land files under a tmp dir.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from kubernetes_tpu_torch.api.types import (
    PersistentVolume,
    Pod,
    Volume,
    VolumeKind,
)


class VolumeError(Exception):
    """Mount/attach layer failure (surfaces as a FailedMount pod event)."""


@dataclass
class VolumeSpec:
    """volume/plugins.go Spec: a pod-inline volume OR a bound PV."""

    volume: Optional[Volume] = None
    pv: Optional[PersistentVolume] = None
    read_only: bool = False
    # for PVC-resolved specs: the pod-spec volume name the mount must land
    # under (the pod addresses the volume by ITS name, not the PV's)
    pod_volume_name: str = ""

    @property
    def source(self) -> Volume:
        if self.pv is not None:
            return self.pv.source
        if self.volume is None:
            raise VolumeError("empty VolumeSpec")
        return self.volume

    @property
    def name(self) -> str:
        if self.pod_volume_name:
            return self.pod_volume_name
        if self.volume is not None:
            return self.volume.name
        return self.pv.name if self.pv is not None else ""


class VolumeHost:
    """plugins.go VolumeHost: the kubelet-side world plugins operate in.

    `fs` maps pod_key -> volume_name -> {path: bytes} (the pod volume
    dirs); `node_fs` is the per-node host filesystem HostPath/Local bind
    into; `shared_fs` models remote backends (NFS exports, attached
    disks' content) keyed by backend identity so two nodes mounting the
    same export see the same files.
    """

    def __init__(self, api=None, cloud=None, node_name: str = ""):
        self.api = api
        self.cloud = cloud
        self.node_name = node_name
        self.fs: Dict[str, Dict[str, Dict[str, bytes]]] = {}
        self.node_fs: Dict[str, Dict[str, bytes]] = {}
        self.shared_fs: Dict[str, Dict[str, bytes]] = {}

    def pod_dir(self, pod_key: str) -> Dict[str, Dict[str, bytes]]:
        return self.fs.setdefault(pod_key, {})

    def remove_pod_dir(self, pod_key: str) -> None:
        self.fs.pop(pod_key, None)


class Mounter:
    """volume.Mounter: SetUp materializes the volume for one pod."""

    def __init__(self, spec: VolumeSpec, pod: Pod, host: VolumeHost):
        self.spec = spec
        self.pod = pod
        self.host = host

    def can_mount(self) -> Optional[str]:
        """Pre-mount check (volume.Mounter.CanMount); None = ok, else the
        reason mounting is impossible."""
        return None

    def set_up(self) -> None:
        raise NotImplementedError

    def _target(self) -> Dict[str, bytes]:
        return self.host.pod_dir(self.pod.key()).setdefault(
            self.spec.name, {})


class Unmounter:
    """volume.Unmounter: TearDown removes the pod's view of the volume."""

    def __init__(self, volume_name: str, pod_key: str, host: VolumeHost):
        self.volume_name = volume_name
        self.pod_key = pod_key
        self.host = host

    def tear_down(self) -> None:
        self.host.pod_dir(self.pod_key).pop(self.volume_name, None)


class Attacher:
    """volume.Attacher (pkg/volume/*/attacher.go): node-level attach +
    wait-for-attach. Device identity is "<Kind>:<volume_id>", matching the
    attach-detach controller's node-annotation record
    (controllers/cloudctrl.py ATTACHED_ANNOTATION)."""

    def __init__(self, plugin: "VolumePlugin", host: VolumeHost):
        self.plugin = plugin
        self.host = host

    def attach(self, spec: VolumeSpec, node_name: str) -> str:
        src = spec.source
        dev = f"{VolumeKind(src.kind).value}:{src.volume_id}"
        if self.host.cloud is not None:
            self.host.cloud.attach_disk(src.volume_id, node_name)
        return dev

    def volumes_are_attached(self, devs: List[str], node) -> List[str]:
        """Subset of devs recorded attached on the node object."""
        from kubernetes_tpu_torch.controllers.cloudctrl import ATTACHED_ANNOTATION
        current = set(filter(None, node.annotations.get(
            ATTACHED_ANNOTATION, "").split(",")))
        return [d for d in devs if d in current]


class Detacher:
    def __init__(self, plugin: "VolumePlugin", host: VolumeHost):
        self.plugin = plugin
        self.host = host

    def detach(self, dev: str, node_name: str) -> None:
        if self.host.cloud is not None:
            vol_id = dev.split(":", 1)[1] if ":" in dev else dev
            self.host.cloud.detach_disk(vol_id, node_name)


class VolumePlugin:
    """Base plugin; concrete drivers override name/can_support/mounters."""

    name = ""
    attachable = False  # requires attach before mount (EBS/GCE-PD/...)

    def can_support(self, spec: VolumeSpec) -> bool:
        raise NotImplementedError

    def new_mounter(self, spec: VolumeSpec, pod: Pod,
                    host: VolumeHost) -> Mounter:
        raise NotImplementedError

    def new_unmounter(self, volume_name: str, pod_key: str,
                      host: VolumeHost) -> Unmounter:
        return Unmounter(volume_name, pod_key, host)

    def new_attacher(self, host: VolumeHost) -> Attacher:
        if not self.attachable:
            raise VolumeError(f"plugin {self.name} is not attachable")
        return Attacher(self, host)

    def new_detacher(self, host: VolumeHost) -> Detacher:
        if not self.attachable:
            raise VolumeError(f"plugin {self.name} is not attachable")
        return Detacher(self, host)


class VolumePluginManager:
    """plugins.go VolumePluginMgr: registry + FindPluginBySpec with the
    no-match / multi-match error semantics (plugins.go:372-392)."""

    def __init__(self, plugins: Optional[List[VolumePlugin]] = None):
        self._plugins: Dict[str, VolumePlugin] = {}
        for p in plugins or []:
            self.register(p)

    def register(self, plugin: VolumePlugin) -> None:
        if plugin.name in self._plugins:
            raise VolumeError(
                f"volume plugin {plugin.name!r} registered twice")
        self._plugins[plugin.name] = plugin

    def find_plugin_by_spec(self, spec: VolumeSpec) -> VolumePlugin:
        matches = [p for p in self._plugins.values() if p.can_support(spec)]
        if not matches:
            raise VolumeError(
                f"no volume plugin matched spec {spec.name!r}")
        if len(matches) > 1:
            raise VolumeError(
                f"multiple volume plugins matched spec {spec.name!r}: "
                + ", ".join(sorted(p.name for p in matches)))
        return matches[0]

    def find_plugin_by_name(self, name: str) -> VolumePlugin:
        if name not in self._plugins:
            raise VolumeError(f"no volume plugin named {name!r}")
        return self._plugins[name]

    def plugin_names(self) -> List[str]:
        return sorted(self._plugins)


def resolve_spec(volume: Volume, api, namespace: str) -> VolumeSpec:
    """Turn a pod-spec volume into a mountable VolumeSpec, dereferencing a
    PVC through its bound PV (volume/plugins.go CreateVolumeSpec in the
    desired-state populator)."""
    if VolumeKind(volume.kind) is not VolumeKind.PVC:
        return VolumeSpec(volume=volume, read_only=volume.read_only)
    if api is None:
        raise VolumeError(f"PVC volume {volume.name!r} needs an API host")
    from kubernetes_tpu_torch.server.apiserver_lite import NotFound
    try:
        pvc = api.get("PersistentVolumeClaim", namespace, volume.volume_id)
    except NotFound:
        raise VolumeError(
            f"PVC {namespace}/{volume.volume_id} not found") from None
    if not pvc.volume_name:
        raise VolumeError(
            f"PVC {namespace}/{volume.volume_id} is not bound yet")
    try:
        pv = api.get("PersistentVolume", "", pvc.volume_name)
    except NotFound:
        raise VolumeError(
            f"PV {pvc.volume_name} (bound to PVC "
            f"{namespace}/{volume.volume_id}) not found") from None
    return VolumeSpec(pv=pv, read_only=volume.read_only,
                      pod_volume_name=volume.name)
