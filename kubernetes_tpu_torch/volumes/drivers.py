"""Concrete volume drivers — the in-framework mirror of the per-driver
dirs under pkg/volume/ (empty_dir/, host_path/, configmap/, secret/,
downwardapi/, projected/, local/, nfs/, gce_pd/, aws_ebs/, rbd/).

Selection mirrors FindPluginBySpec switching on the populated
VolumeSource member: scheduler-relevant kinds (GCE_PD/AWS_EBS/RBD/ISCSI/
SECRET/CONFIG_MAP) select by `Volume.kind`; the scheduling-inert kinds
that collapse to OTHER select by the `Volume.driver` source hint.

Semantics kept from the reference drivers:
- EmptyDir: fresh per-pod dir; medium "Memory" = tmpfs
  (pkg/volume/empty_dir/empty_dir.go mediumMemory).
- HostPath: binds the node filesystem — two pods on one node share it,
  pods on different nodes do not (pkg/volume/host_path/).
- ConfigMap/Secret: payload fetched from the API at SetUp; missing
  object = mount failure (pkg/volume/configmap/configmap.go SetUpAt);
  Secret values land base64-decoded (secret.go).
- DownwardAPI: pod fields rendered to files (downwardapi.go).
- Projected: configmap+secret+downwardAPI sources merged into one dir
  (pkg/volume/projected/).
- NFS: server:path export shared across nodes (pkg/volume/nfs/).
- Local: node-pinned PV (pkg/volume/local/) — mount fails on the wrong
  node, the error VolumeNode-predicate misconfigurations produce.
- GCE-PD / AWS-EBS / RBD: attachable block devices; mount requires the
  device attached first (pkg/volume/gce_pd/attacher.go WaitForAttach),
  content rides shared_fs keyed by device id so remount on another node
  sees the same bytes.
"""

from __future__ import annotations

import base64
from typing import List, Optional

from kubernetes_tpu_torch.api.types import Pod, VolumeKind
from kubernetes_tpu_torch.server.apiserver_lite import NotFound
from kubernetes_tpu_torch.volumes.plugins import (
    Mounter,
    VolumeError,
    VolumeHost,
    VolumePlugin,
    VolumeSpec,
)


class _KindPlugin(VolumePlugin):
    """Selects on the scheduler-visible VolumeKind."""

    kind: VolumeKind = VolumeKind.OTHER

    def can_support(self, spec: VolumeSpec) -> bool:
        return VolumeKind(spec.source.kind) is self.kind


class _DriverPlugin(VolumePlugin):
    """Selects on the `driver` source hint for OTHER-kind volumes."""

    driver = ""

    def can_support(self, spec: VolumeSpec) -> bool:
        src = spec.source
        return VolumeKind(src.kind) is VolumeKind.OTHER \
            and src.driver == self.driver


# ------------------------------------------------------------ inert drivers


class EmptyDirMounter(Mounter):
    def set_up(self) -> None:
        self._target()  # fresh empty dict = the new empty dir


class EmptyDirPlugin(_DriverPlugin):
    name = "kubernetes.io/empty-dir"
    driver = "EmptyDir"

    def can_support(self, spec: VolumeSpec) -> bool:
        src = spec.source
        # EmptyDir is also the fallback for an OTHER volume with no
        # driver hint — the schedulers' tests build such pods freely
        return VolumeKind(src.kind) is VolumeKind.OTHER \
            and src.driver in ("EmptyDir", "")

    def new_mounter(self, spec, pod, host):
        return EmptyDirMounter(spec, pod, host)


class HostPathMounter(Mounter):
    def set_up(self) -> None:
        # bind mount: the pod dir aliases the node fs path
        path = self.spec.source.volume_id or "/"
        shared = self.host.node_fs.setdefault(path, {})
        self.host.pod_dir(self.pod.key())[self.spec.name] = shared


class HostPathPlugin(_DriverPlugin):
    name = "kubernetes.io/host-path"
    driver = "HostPath"

    def new_mounter(self, spec, pod, host):
        return HostPathMounter(spec, pod, host)


class ConfigMapMounter(Mounter):
    def set_up(self) -> None:
        if self.host.api is None:
            raise VolumeError("configmap volume needs an API host")
        try:
            cm = self.host.api.get("ConfigMap", self.pod.namespace,
                                   self.spec.source.volume_id)
        except NotFound:
            raise VolumeError(
                f'configmap "{self.spec.source.volume_id}" not found'
            ) from None
        tgt = self._target()
        tgt.clear()
        for k, v in cm.data.items():
            tgt[k] = v.encode() if isinstance(v, str) else v


class ConfigMapPlugin(_KindPlugin):
    name = "kubernetes.io/configmap"
    kind = VolumeKind.CONFIG_MAP

    def new_mounter(self, spec, pod, host):
        return ConfigMapMounter(spec, pod, host)


def _decode_secret_value(v) -> bytes:
    """Secret payloads are stored base64 (api/cluster.py Secret); files
    land decoded (pkg/volume/secret/secret.go). Non-base64 strings pass
    through encoded, bytes pass through untouched."""
    if not isinstance(v, str):
        return v
    try:
        return base64.b64decode(v, validate=True)
    except Exception:
        return v.encode()


class SecretMounter(Mounter):
    def set_up(self) -> None:
        if self.host.api is None:
            raise VolumeError("secret volume needs an API host")
        try:
            sec = self.host.api.get("Secret", self.pod.namespace,
                                    self.spec.source.volume_id)
        except NotFound:
            raise VolumeError(
                f'secret "{self.spec.source.volume_id}" not found'
            ) from None
        tgt = self._target()
        tgt.clear()
        for k, v in sec.data.items():
            tgt[k] = _decode_secret_value(v)


class SecretPlugin(_KindPlugin):
    name = "kubernetes.io/secret"
    kind = VolumeKind.SECRET

    def new_mounter(self, spec, pod, host):
        return SecretMounter(spec, pod, host)


def render_downward_api(pod: Pod) -> dict:
    """The downward-API field set v1.7 serves via fieldRef
    (pkg/fieldpath/fieldpath.go ExtractFieldPathAsString)."""
    return {
        "metadata.name": pod.name.encode(),
        "metadata.namespace": pod.namespace.encode(),
        "metadata.labels": "\n".join(
            f'{k}="{v}"' for k, v in sorted(pod.labels.items())).encode(),
        "metadata.annotations": "\n".join(
            f'{k}="{v}"' for k, v in
            sorted(pod.annotations.items())).encode(),
        "spec.nodeName": (pod.node_name or "").encode(),
    }


class DownwardAPIMounter(Mounter):
    def set_up(self) -> None:
        tgt = self._target()
        tgt.clear()
        tgt.update(render_downward_api(self.pod))


class DownwardAPIPlugin(_DriverPlugin):
    name = "kubernetes.io/downward-api"
    driver = "DownwardAPI"

    def new_mounter(self, spec, pod, host):
        return DownwardAPIMounter(spec, pod, host)


class ProjectedMounter(Mounter):
    """All-sources-in-one-dir (pkg/volume/projected/): volume_id is a
    comma-separated source list "configmap:name,secret:name,downwardAPI"."""

    def set_up(self) -> None:
        tgt = self._target()
        tgt.clear()
        for part in filter(None, self.spec.source.volume_id.split(",")):
            stype, _, sname = part.partition(":")
            if stype == "downwardAPI":
                tgt.update(render_downward_api(self.pod))
                continue
            kind = {"configmap": "ConfigMap", "secret": "Secret"}.get(stype)
            if kind is None:
                raise VolumeError(f"unknown projected source {stype!r}")
            if self.host.api is None:
                raise VolumeError("projected volume needs an API host")
            try:
                obj = self.host.api.get(kind, self.pod.namespace, sname)
            except NotFound:
                raise VolumeError(
                    f'projected source {kind} "{sname}" not found'
                ) from None
            for k, v in obj.data.items():
                if kind == "Secret":
                    tgt[k] = _decode_secret_value(v)
                else:
                    tgt[k] = v.encode() if isinstance(v, str) else v


class ProjectedPlugin(_DriverPlugin):
    name = "kubernetes.io/projected"
    driver = "Projected"

    def new_mounter(self, spec, pod, host):
        return ProjectedMounter(spec, pod, host)


class NFSMounter(Mounter):
    def set_up(self) -> None:
        export = "nfs:" + self.spec.source.volume_id  # "server:/path"
        shared = self.host.shared_fs.setdefault(export, {})
        self.host.pod_dir(self.pod.key())[self.spec.name] = shared


class NFSPlugin(_DriverPlugin):
    name = "kubernetes.io/nfs"
    driver = "NFS"

    def new_mounter(self, spec, pod, host):
        return NFSMounter(spec, pod, host)


class LocalMounter(Mounter):
    def can_mount(self) -> Optional[str]:
        # a local PV is node-pinned; mounting from another node is the
        # hard failure the VolumeNode predicate exists to prevent
        # (pkg/volume/local/local.go + predicates.go:1345)
        pv = self.spec.pv
        if pv is not None and pv.node_affinity_terms:
            node = None
            if self.host.api is not None:
                try:
                    node = self.host.api.get("Node", "", self.host.node_name)
                except NotFound:
                    pass
            labels = node.labels if node is not None else {}
            # PV terms are ANDed (util.go:202-214), unlike pod affinity
            if not all(t.matches_labels(labels)
                       for t in pv.node_affinity_terms):
                return (f"local volume {pv.name!r} has a node affinity "
                        f"conflict with node {self.host.node_name!r}")
        return None

    def set_up(self) -> None:
        reason = self.can_mount()
        if reason:
            raise VolumeError(reason)
        path = "local:" + (self.spec.source.volume_id or "/")
        shared = self.host.node_fs.setdefault(path, {})
        self.host.pod_dir(self.pod.key())[self.spec.name] = shared


class LocalPlugin(_DriverPlugin):
    name = "kubernetes.io/local-volume"
    driver = "Local"

    def new_mounter(self, spec, pod, host):
        return LocalMounter(spec, pod, host)


# -------------------------------------------------------- attachable drivers


class BlockDeviceMounter(Mounter):
    """Mount an attached device: refuses when the device has not been
    attached to this node (WaitForAttach semantics, gce_pd/attacher.go)."""

    def can_mount(self) -> Optional[str]:
        src = self.spec.source
        dev = f"{VolumeKind(src.kind).value}:{src.volume_id}"
        node = None
        if self.host.api is not None:
            try:
                node = self.host.api.get("Node", "", self.host.node_name)
            except NotFound:
                pass
        from kubernetes_tpu_torch.controllers.cloudctrl import ATTACHED_ANNOTATION
        attached = set() if node is None else set(filter(
            None, node.annotations.get(ATTACHED_ANNOTATION, "").split(",")))
        if dev not in attached:
            return (f"volume {self.spec.name!r} device {dev} is not "
                    f"attached to node {self.host.node_name!r}")
        return None

    def set_up(self) -> None:
        reason = self.can_mount()
        if reason:
            raise VolumeError(reason)
        src = self.spec.source
        dev = f"{VolumeKind(src.kind).value}:{src.volume_id}"
        shared = self.host.shared_fs.setdefault(dev, {})
        self.host.pod_dir(self.pod.key())[self.spec.name] = shared


class _AttachablePlugin(_KindPlugin):
    attachable = True

    def new_mounter(self, spec, pod, host):
        return BlockDeviceMounter(spec, pod, host)


class GCEPDPlugin(_AttachablePlugin):
    name = "kubernetes.io/gce-pd"
    kind = VolumeKind.GCE_PD


class AWSEBSPlugin(_AttachablePlugin):
    name = "kubernetes.io/aws-ebs"
    kind = VolumeKind.AWS_EBS


class AzureDiskPlugin(_AttachablePlugin):
    name = "kubernetes.io/azure-disk"
    kind = VolumeKind.AZURE_DISK


class NetworkBlockMounter(Mounter):
    """RBD/iSCSI are kubelet-mounted network block devices in v1.7 — no
    controller attach step (no attacher.go in pkg/volume/{rbd,iscsi})."""

    def set_up(self) -> None:
        src = self.spec.source
        dev = f"{VolumeKind(src.kind).value}:{src.volume_id or src.image}"
        shared = self.host.shared_fs.setdefault(dev, {})
        self.host.pod_dir(self.pod.key())[self.spec.name] = shared


class RBDPlugin(_KindPlugin):
    name = "kubernetes.io/rbd"
    kind = VolumeKind.RBD

    def new_mounter(self, spec, pod, host):
        return NetworkBlockMounter(spec, pod, host)


class ISCSIPlugin(_KindPlugin):
    name = "kubernetes.io/iscsi"
    kind = VolumeKind.ISCSI

    def new_mounter(self, spec, pod, host):
        return NetworkBlockMounter(spec, pod, host)


def default_plugins() -> List[VolumePlugin]:
    """ProbeVolumePlugins — the in-tree driver set
    (cmd/kube-controller-manager/app/plugins.go + kubelet's)."""
    return [
        EmptyDirPlugin(), HostPathPlugin(), ConfigMapPlugin(),
        SecretPlugin(), DownwardAPIPlugin(), ProjectedPlugin(),
        NFSPlugin(), LocalPlugin(), GCEPDPlugin(), AWSEBSPlugin(),
        AzureDiskPlugin(), RBDPlugin(), ISCSIPlugin(),
    ]
