"""Cloud-facing controllers: service load balancers, routes, PV binding,
attach/detach.

References:
- pkg/controller/service/servicecontroller.go: type=LoadBalancer services
  get an LB ensured via the cloud provider; node-set changes update members;
  deletes tear the LB down.
- pkg/controller/route/routecontroller.go: one cloud route per node's
  podCIDR; stale routes removed.
- pkg/controller/volume/persistentvolume/pv_controller.go: bind pending
  PVCs to the smallest matching available PV (capacity + access modes),
  two-way binding annotations.
- pkg/controller/volume/attachdetach/attach_detach_controller.go: desired
  state = volumes of scheduled pods; attach missing, detach orphaned —
  recorded per node (the reference mutates node.status.volumesAttached).
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from kubernetes_tpu_torch.api.types import VolumeKind
from kubernetes_tpu_torch.client.informer import SharedInformerFactory
from kubernetes_tpu_torch.cloud import CloudProvider
from kubernetes_tpu_torch.cloud.provider import Route
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, NotFound

ATTACHED_ANNOTATION = "volumes.kubernetes.io/attached"
# node.status.volumesInUse analog: devices some pod on the node has
# mounted — the kubelet publishes it (nodes/kubelet.py heartbeat), this
# controller refuses to detach them (attach_detach_controller.go honoring
# volumesInUse via the operation executor's VerifyVolumesAreAttached)
IN_USE_ANNOTATION = "volumes.kubernetes.io/in-use"
# volume kinds that require attach before mount (the attachable plugins:
# EBS/GCE-PD/AzureDisk/Cinder... — pkg/volume/*/attacher.go)
ATTACHABLE = {VolumeKind.AWS_EBS, VolumeKind.GCE_PD, VolumeKind.AZURE_DISK}


class ServiceLBController(Controller):
    name = "service-controller"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 cloud: CloudProvider, record_events: bool = True):
        super().__init__(api, record_events=record_events)
        self.cloud = cloud
        self.node_informer = factory.informer("Node")
        factory.informer("Service").add_event_handler(
            on_add=lambda o: self.enqueue(o.key()),
            on_update=lambda o, n: self.enqueue(n.key()),
            on_delete=lambda o: self.enqueue(o.key()))
        self.node_informer.add_event_handler(
            on_add=lambda o: self._all_lbs(),
            on_delete=lambda o: self._all_lbs())

    def _all_lbs(self) -> None:
        for svc in self.api.list("Service")[0]:
            if svc.type == "LoadBalancer":
                self.enqueue(svc.key())

    def sync(self, key: str) -> None:
        if not self.cloud.has_load_balancer():
            return
        namespace, name = key.split("/", 1)
        try:
            svc = self.api.get("Service", namespace, name)
        except NotFound:
            self.cloud.ensure_load_balancer_deleted(key)
            return
        if svc.type != "LoadBalancer":
            if svc.load_balancer_ip:
                self.cloud.ensure_load_balancer_deleted(key)
                svc.load_balancer_ip = ""
                self.api.update("Service", svc, expect_rv=svc.resource_version)
            return
        nodes = [n.name for n in self.node_informer.store.list()
                 if n.is_ready() and not n.unschedulable]
        status = self.cloud.ensure_load_balancer(key, nodes)
        if svc.load_balancer_ip != status.ingress_ip:
            svc.load_balancer_ip = status.ingress_ip
            self.api.update("Service", svc, expect_rv=svc.resource_version)
            self.event("Service", key, "Normal", "EnsuredLoadBalancer",
                       f"Ensured load balancer {status.ingress_ip}")


class RouteController(Controller):
    name = "route-controller"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 cloud: CloudProvider, record_events: bool = True):
        super().__init__(api, record_events=record_events)
        self.cloud = cloud
        self.node_informer = factory.informer("Node")
        self.node_informer.add_event_handler(
            on_add=lambda o: self.enqueue("reconcile"),
            on_update=lambda o, n: self.enqueue("reconcile"),
            on_delete=lambda o: self.enqueue("reconcile"))

    def sync(self, key: str) -> None:
        if not self.cloud.has_routes():
            return
        want: Dict[str, Tuple[str, str]] = {}
        for n in self.node_informer.store.list():
            if n.pod_cidr:
                want[n.name] = (n.name, n.pod_cidr)
        have = {r.target_node: r for r in self.cloud.list_routes()}
        for node_name, (target, cidr) in want.items():
            cur = have.get(node_name)
            if cur is None or cur.destination_cidr != cidr:
                self.cloud.create_route(Route(node_name, target, cidr))
        for node_name, r in have.items():
            if node_name not in want:
                self.cloud.delete_route(r.name)


CLASS_ANNOTATION = "volume.beta.kubernetes.io/storage-class"
PROVISIONED_BY_ANNOTATION = "pv.kubernetes.io/provisioned-by"
CLAIM_ANNOTATION = "pv.kubernetes.io/claim"
RECLAIM_ANNOTATION = "pv.kubernetes.io/reclaim-policy"

# provisioner name -> the volume-source kind the provisioned PV carries
_PROVISIONER_KINDS = {
    "kubernetes.io/gce-pd": VolumeKind.GCE_PD,
    "kubernetes.io/aws-ebs": VolumeKind.AWS_EBS,
    "kubernetes.io/azure-disk": VolumeKind.AZURE_DISK,
}


class PersistentVolumeBinder(Controller):
    """Bind unbound PVCs to available PVs: smallest PV whose capacity covers
    the claim (pv_controller.go findBestMatchForClaim ordering). Claims
    carrying a storage-class annotation bind only same-class PVs, and when
    none exists the class's provisioner dynamically creates one
    (pv_controller.go provisionClaim); on claim deletion a provisioned PV
    with reclaim policy Delete is removed (reclaimVolume)."""

    name = "persistentvolume-binder"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 record_events: bool = True):
        super().__init__(api, record_events=record_events)
        factory.informer("PersistentVolumeClaim").add_event_handler(
            on_add=lambda o: self.enqueue(o.namespace + "/" + o.name),
            on_update=lambda o, n: self.enqueue(n.namespace + "/" + n.name),
            on_delete=lambda o: self.enqueue(
                "reclaim:" + o.namespace + "/" + o.name))
        factory.informer("PersistentVolume").add_event_handler(
            on_add=lambda o: self._requeue_pending(),
            on_update=lambda o, n: self._requeue_pending())

    def _requeue_pending(self) -> None:
        for pvc in self.api.list("PersistentVolumeClaim")[0]:
            if not pvc.volume_name:
                self.enqueue(pvc.namespace + "/" + pvc.name)

    def sync(self, key: str) -> None:
        if key.startswith("reclaim:"):
            return self._reclaim(key[len("reclaim:"):])
        namespace, name = key.split("/", 1)
        try:
            pvc = self.api.get("PersistentVolumeClaim", namespace, name)
        except NotFound:
            return
        if pvc.volume_name:
            return
        bound: Set[str] = {c.volume_name
                           for c in self.api.list("PersistentVolumeClaim")[0]
                           if c.volume_name}
        request = pvc.capacity
        want_modes = set(pvc.access_modes)
        want_class = getattr(pvc, "annotations", {}).get(
            CLASS_ANNOTATION, "")
        candidates = []
        for pv in self.api.list("PersistentVolume")[0]:
            if pv.name in bound:
                continue
            # class match: a classed claim binds only same-class PVs and
            # vice versa (pv_controller findMatchingVolume class check)
            if pv.annotations.get(CLASS_ANNOTATION, "") != want_class:
                continue
            # access modes: the PV must offer every mode the claim asks for
            # (pv_controller checkAccessModes)
            if want_modes and not want_modes.issubset(set(pv.access_modes)):
                continue
            if pv.capacity >= request:
                candidates.append((pv.capacity, pv.name))
        if not candidates:
            if want_class:
                self._provision(pvc, want_class)
            return
        candidates.sort()
        pvc.volume_name = candidates[0][1]
        self.api.update("PersistentVolumeClaim", pvc,
                        expect_rv=pvc.resource_version)
        self.event("PersistentVolumeClaim", key, "Normal", "Bound",
                   f"bound to {pvc.volume_name}")

    def _provision(self, pvc, class_name: str) -> None:
        """provisionClaim: the class's provisioner mints a PV sized to the
        request; it binds on the requeue its ADDED event triggers."""
        from kubernetes_tpu_torch.api.types import PersistentVolume, Volume
        try:
            sc = self.api.get("StorageClass", "", class_name)
        except NotFound:
            self.event("PersistentVolumeClaim",
                       pvc.namespace + "/" + pvc.name, "Warning",
                       "ProvisioningFailed",
                       f'storageclass "{class_name}" not found')
            return
        kind = _PROVISIONER_KINDS.get(sc.provisioner)
        if kind is None:  # no-provisioner classes wait for manual PVs
            return
        import zlib
        claim_key = pvc.namespace + "/" + pvc.name
        # hashed name: "pvc-a-b"+"c" and "pvc-a"+"b-c" must not collide
        # (upstream avoids this with the claim UID)
        pv_name = (f"pvc-{zlib.adler32(claim_key.encode()) & 0xffffffff:08x}"
                   f"-{pvc.name[:40]}")
        try:
            existing = self.api.get("PersistentVolume", "", pv_name)
            if existing.annotations.get(CLAIM_ANNOTATION) == claim_key \
                    and existing.capacity >= pvc.capacity:
                return  # already provisioned; binding follows
            bound = {c.volume_name for c in self.api.list(
                "PersistentVolumeClaim")[0] if c.volume_name}
            if pv_name in bound:
                self.event("PersistentVolumeClaim", claim_key, "Warning",
                           "ProvisioningFailed",
                           f"volume {pv_name} exists and is bound "
                           f"elsewhere")
                return
            # stale (e.g. the claim was recreated larger): replace it
            self.api.delete("PersistentVolume", "", pv_name)
        except NotFound:
            pass
        self.api.create("PersistentVolume", PersistentVolume(
            pv_name, capacity=pvc.capacity,
            access_modes=list(pvc.access_modes),
            source=Volume(name=pv_name, kind=kind, volume_id=pv_name),
            annotations={
                CLASS_ANNOTATION: class_name,
                PROVISIONED_BY_ANNOTATION: sc.provisioner,
                CLAIM_ANNOTATION: pvc.namespace + "/" + pvc.name,
                RECLAIM_ANNOTATION: sc.reclaim_policy,
            }))
        self.event("PersistentVolumeClaim",
                   pvc.namespace + "/" + pvc.name, "Normal",
                   "ProvisioningSucceeded",
                   f"provisioned volume {pv_name}")

    def _reclaim(self, claim_key: str) -> None:
        """reclaimVolume: a dynamically provisioned PV whose claim is gone
        is deleted under reclaim policy Delete (Retain keeps it)."""
        live_bound = {c.volume_name for c in self.api.list(
            "PersistentVolumeClaim")[0] if c.volume_name}
        for pv in self.api.list("PersistentVolume")[0]:
            if pv.annotations.get(CLAIM_ANNOTATION) != claim_key:
                continue
            if pv.name in live_bound:
                # another (or a recreated) claim bound this PV between the
                # delete and this reclaim pass — deleting now would leave
                # a live claim dangling (pv_controller's bound/UID guard)
                continue
            if pv.annotations.get(RECLAIM_ANNOTATION, "Delete") == "Delete":
                try:
                    self.api.delete("PersistentVolume", "", pv.name)
                except NotFound:
                    pass
                self.event("PersistentVolume", pv.name, "Normal",
                           "VolumeDeleted", "reclaim policy Delete")


class AttachDetachController(Controller):
    """Reconcile attachable volumes to nodes hosting their pods; the
    attachment record is a node annotation (the reference writes
    node.status.volumesAttached)."""

    name = "attachdetach-controller"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 record_events: bool = True, cloud=None):
        super().__init__(api, record_events=record_events)
        # optional cloud: real AttachDisk/DetachDisk calls ride along with
        # the node-annotation record (the reference's operation executor
        # calling the volume plugin attacher, which calls the cloud)
        self.cloud = cloud
        self.pod_informer = factory.informer("Pod")
        self.pod_informer.add_event_handler(
            on_add=lambda o: o.node_name and self.enqueue(o.node_name),
            on_update=lambda o, n: n.node_name and self.enqueue(n.node_name),
            on_delete=lambda o: o.node_name and self.enqueue(o.node_name))

    def sync(self, key: str) -> None:
        try:
            node = self.api.get("Node", "", key)
        except NotFound:
            return
        from kubernetes_tpu_torch.volumes.plugins import VolumeError, resolve_spec
        want: Set[str] = set()
        for p in self.pod_informer.store.list():
            if p.node_name != key or p.deleted:
                continue
            for v in p.volumes:
                try:
                    # dereferences claim -> bound PV, like the desired-state
                    # populator's CreateVolumeSpec (attachdetach/cache/
                    # desired_state_of_world_populator.go)
                    src = resolve_spec(v, self.api, p.namespace).source
                except VolumeError:
                    continue  # missing/unbound claim: nothing to attach yet
                if VolumeKind(src.kind) in ATTACHABLE and src.volume_id:
                    want.add(str(VolumeKind(src.kind).value) + ":"
                             + src.volume_id)
        current = set(filter(None, node.annotations.get(
            ATTACHED_ANNOTATION, "").split(",")))
        # in-use protection: a device the kubelet still has mounted stays
        # attached even with no desiring pod (multi-attach corruption guard)
        in_use = set(filter(None, node.annotations.get(
            IN_USE_ANNOTATION, "").split(",")))
        want |= current & in_use
        attach_failures = []
        if want != current:
            if self.cloud is not None and self.cloud.has_disks():
                from kubernetes_tpu_torch.cloud.provider import DiskError

                def vol_id(dev: str) -> str:
                    # tolerant of colon-less entries, like the volume
                    # plugins' Detacher parse
                    return dev.partition(":")[2] or dev

                for dev in sorted(want - current):
                    try:
                        self.cloud.attach_disk(vol_id(dev), key)
                    except DiskError as e:
                        # multi-attach / node limit: leave it un-recorded
                        # so the kubelet keeps waiting
                        self.event("Node", key, "Warning",
                                   "FailedAttachVolume", str(e))
                        attach_failures.append(str(e))
                        want.discard(dev)
                for dev in sorted(current - want):
                    self.cloud.detach_disk(vol_id(dev), key)
            if want != current:
                node.annotations[ATTACHED_ANNOTATION] = ",".join(sorted(want))
                self.api.update("Node", node,
                                expect_rv=node.resource_version)
        if attach_failures:
            # successful work above is committed; raising hands the key
            # back to the rate-limited queue so a refused attach is
            # RETRIED (the cloud state it lost to — e.g. a detach on the
            # other node — changes without any event landing on this one)
            raise RuntimeError(
                f"attach failures on {key}: " + "; ".join(attach_failures))
