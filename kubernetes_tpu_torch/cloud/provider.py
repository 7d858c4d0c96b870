"""Cloud provider interface + providers.

Mirror of pkg/cloudprovider/cloud.go's Interface: Instances / Zones /
LoadBalancer / Routes (the slices the service and route controllers consume)
with the provider registry of pkg/cloudprovider/plugins.go. The reference
ships 9 providers (aws, azure, cloudstack, gce, openstack, ovirt, photon,
rackspace, vsphere) whose value is API-client plumbing against real clouds;
here the contract is carried by FakeCloud (the reference's
pkg/cloudprovider/providers/fake used by every controller test) plus two
named providers exercising provider-specific behavior the controllers can
observe (zone layout, LB naming, route semantics)."""

from __future__ import annotations

import threading
from kubernetes_tpu_torch.analysis import lockcheck
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class LoadBalancerStatus:
    ingress_ip: str = ""


@dataclass
class Route:
    name: str
    target_node: str
    destination_cidr: str


class CloudProvider:
    """cloudprovider.Interface: nil-able sub-interfaces are modeled as
    has_*() capability flags (Interface() (T, bool) in Go)."""

    provider_name = "abstract"

    # Instances
    def has_instances(self) -> bool:
        return False

    def node_addresses(self, node_name: str) -> List[str]:
        raise NotImplementedError

    def instance_exists(self, node_name: str) -> bool:
        raise NotImplementedError

    # Zones
    def has_zones(self) -> bool:
        return False

    def zone_for(self, node_name: str) -> Tuple[str, str]:  # (zone, region)
        raise NotImplementedError

    # LoadBalancer
    def has_load_balancer(self) -> bool:
        return False

    def ensure_load_balancer(self, service_key: str,
                             node_names: List[str]) -> LoadBalancerStatus:
        raise NotImplementedError

    def update_load_balancer(self, service_key: str,
                             node_names: List[str]) -> None:
        raise NotImplementedError

    def ensure_load_balancer_deleted(self, service_key: str) -> None:
        raise NotImplementedError

    # Routes
    def has_routes(self) -> bool:
        return False

    def list_routes(self) -> List[Route]:
        raise NotImplementedError

    def create_route(self, route: Route) -> None:
        raise NotImplementedError

    def delete_route(self, name: str) -> None:
        raise NotImplementedError

    # -- Disks (the volume-attacher surface: providers/{gce,aws,azure}
    # AttachDisk/DetachDisk/DisksAreAttached, consumed by
    # volumes/plugins.py Attacher and the attach-detach controller)

    def has_disks(self) -> bool:
        return False  # capability flag: absent sub-interface = False,
        # like has_instances/has_zones/has_load_balancer/has_routes

    def create_disk(self, volume_id: str, size_gb: int = 10) -> None:
        raise NotImplementedError

    def delete_disk(self, volume_id: str) -> None:
        raise NotImplementedError

    def attach_disk(self, volume_id: str, node_name: str) -> None:
        raise NotImplementedError

    def detach_disk(self, volume_id: str, node_name: str) -> None:
        raise NotImplementedError

    def disks_attached(self, node_name: str) -> List[str]:
        raise NotImplementedError


class DiskError(Exception):
    """Attach/detach failure (multi-attach, unknown disk, node limit)."""


class FakeCloud(CloudProvider):
    """pkg/cloudprovider/providers/fake: records calls, serves canned data."""

    provider_name = "fake"

    def __init__(self):
        self._lock = lockcheck.make_lock("FakeCloud._lock")
        self.instances: Dict[str, List[str]] = {}
        self.zones: Dict[str, Tuple[str, str]] = {}
        self.balancers: Dict[str, LoadBalancerStatus] = {}
        self.balancer_nodes: Dict[str, List[str]] = {}
        self.routes: Dict[str, Route] = {}
        self.calls: List[str] = []
        self._next_ip = 1
        self.disks: Dict[str, int] = {}  # volume_id -> size_gb
        # volume_id -> (zone, region); what PersistentVolumeLabel admission
        # reads (plugin/pkg/admission/persistentvolume/label)
        self.disk_zones: Dict[str, Tuple[str, str]] = {}
        self.attachments: Dict[str, str] = {}  # volume_id -> node
        # per-node attachable-disk ceiling (the cloud-side analog of the
        # MaxPDVolumeCount predicate defaults)
        self.max_disks_per_node = 16

    # Instances
    def has_instances(self) -> bool:
        return True

    def add_instance(self, name: str, addresses: Optional[List[str]] = None,
                     zone: str = "zone-a", region: str = "region-1") -> None:
        self.instances[name] = addresses or [f"192.168.0.{len(self.instances)+1}"]
        self.zones[name] = (zone, region)

    def node_addresses(self, node_name: str) -> List[str]:
        with self._lock:
            self.calls.append("node-addresses")
            return self.instances.get(node_name, [])

    def instance_exists(self, node_name: str) -> bool:
        with self._lock:
            self.calls.append("instance-exists")
            return node_name in self.instances

    # Zones
    def has_zones(self) -> bool:
        return True

    def zone_for(self, node_name: str) -> Tuple[str, str]:
        return self.zones.get(node_name, ("zone-a", "region-1"))

    # LoadBalancer
    def has_load_balancer(self) -> bool:
        return True

    def ensure_load_balancer(self, service_key, node_names):
        with self._lock:
            self.calls.append("ensure-lb")
            st = self.balancers.get(service_key)
            if st is None:
                st = LoadBalancerStatus(f"172.24.0.{self._next_ip}")
                self._next_ip += 1
                self.balancers[service_key] = st
            self.balancer_nodes[service_key] = sorted(node_names)
            return st

    def update_load_balancer(self, service_key, node_names):
        with self._lock:
            self.calls.append("update-lb")
            self.balancer_nodes[service_key] = sorted(node_names)

    def ensure_load_balancer_deleted(self, service_key):
        with self._lock:
            self.calls.append("delete-lb")
            self.balancers.pop(service_key, None)
            self.balancer_nodes.pop(service_key, None)

    # Routes
    def has_routes(self) -> bool:
        return True

    def list_routes(self):
        with self._lock:
            return list(self.routes.values())

    def create_route(self, route: Route) -> None:
        with self._lock:
            self.calls.append("create-route")
            self.routes[route.name] = route

    def delete_route(self, name: str) -> None:
        with self._lock:
            self.calls.append("delete-route")
            self.routes.pop(name, None)

    # Disks
    def has_disks(self) -> bool:
        return True

    def create_disk(self, volume_id: str, size_gb: int = 10,
                    zone: str = "zone-a", region: str = "region-1") -> None:
        with self._lock:
            self.disks[volume_id] = size_gb
            self.disk_zones[volume_id] = (zone, region)

    def disk_zone(self, volume_id: str) -> Optional[Tuple[str, str]]:
        """Where the disk lives — the cloud's authoritative answer the PV
        label admission stamps onto PVs. None for a disk this cloud never
        created (the reference plugin errors rather than fabricate a
        zone)."""
        with self._lock:
            return self.disk_zones.get(volume_id)

    def delete_disk(self, volume_id: str) -> None:
        with self._lock:
            if volume_id in self.attachments:
                raise DiskError(
                    f"disk {volume_id!r} is attached to "
                    f"{self.attachments[volume_id]!r}")
            self.disks.pop(volume_id, None)
            self.disk_zones.pop(volume_id, None)

    def _validate_attach_locked(self, volume_id: str) -> None:
        """Flavor hook, called UNDER self._lock so existence checks cannot
        race delete_disk (OpenStack's no-lazy-provisioning rule)."""

    def attach_disk(self, volume_id: str, node_name: str) -> None:
        """Single-writer attach: attaching a disk already on another node
        fails (the multi-attach error every block-store cloud raises);
        re-attach to the same node is idempotent."""
        with self._lock:
            self.calls.append("attach-disk")
            self._validate_attach_locked(volume_id)
            self.disks.setdefault(volume_id, 10)  # lazily provisioned
            cur = self.attachments.get(volume_id)
            if cur is not None and cur != node_name:
                raise DiskError(
                    f"disk {volume_id!r} is already attached to {cur!r}")
            if cur is None and sum(
                    1 for n in self.attachments.values()
                    if n == node_name) >= self.max_disks_per_node:
                raise DiskError(
                    f"node {node_name!r} is at its attachable-disk limit")
            self.attachments[volume_id] = node_name

    def detach_disk(self, volume_id: str, node_name: str) -> None:
        with self._lock:
            self.calls.append("detach-disk")
            if self.attachments.get(volume_id) == node_name:
                del self.attachments[volume_id]

    def disks_attached(self, node_name: str) -> List[str]:
        with self._lock:
            return sorted(v for v, n in self.attachments.items()
                          if n == node_name)


class GCELikeCloud(FakeCloud):
    """GCE-shaped behavior (providers/gce): per-zone instance groups, LB IPs
    from a regional pool, route names prefixed by cluster."""

    provider_name = "gce-like"

    def __init__(self, cluster: str = "ktpu"):
        super().__init__()
        self.cluster = cluster

    def ensure_load_balancer(self, service_key, node_names):
        st = super().ensure_load_balancer(service_key, node_names)
        st.ingress_ip = "35.0.0." + st.ingress_ip.rsplit(".", 1)[1]
        return st

    def create_route(self, route: Route) -> None:
        route = Route(f"{self.cluster}-{route.name}", route.target_node,
                      route.destination_cidr)
        super().create_route(route)


class AWSLikeCloud(FakeCloud):
    """AWS-shaped behavior (providers/aws): hostname-style LB ingress."""

    provider_name = "aws-like"

    def ensure_load_balancer(self, service_key, node_names):
        st = super().ensure_load_balancer(service_key, node_names)
        slug = service_key.replace("/", "-")
        st.ingress_ip = f"{slug}.elb.region-1.example.amazonaws.com"
        return st


class AzureLikeCloud(FakeCloud):
    """Azure-shaped behavior (providers/azure): LB frontend IPs from a
    resource-group pool, tight default disk-per-node limit (the DS-series
    data-disk caps the AzureDisk MaxPD filter mirrors)."""

    provider_name = "azure-like"

    def __init__(self, resource_group: str = "ktpu-rg"):
        super().__init__()
        self.resource_group = resource_group
        self.max_disks_per_node = 8

    def ensure_load_balancer(self, service_key, node_names):
        st = super().ensure_load_balancer(service_key, node_names)
        st.ingress_ip = "20.0.0." + st.ingress_ip.rsplit(".", 1)[1]
        return st


class OpenStackLikeCloud(FakeCloud):
    """OpenStack-shaped behavior (providers/openstack): Cinder volumes
    must be created before attach (no lazy provisioning), Neutron-style
    floating IPs."""

    provider_name = "openstack-like"

    def _validate_attach_locked(self, volume_id: str) -> None:
        if volume_id not in self.disks:
            raise DiskError(
                f"cinder volume {volume_id!r} does not exist")

    def ensure_load_balancer(self, service_key, node_names):
        st = super().ensure_load_balancer(service_key, node_names)
        st.ingress_ip = "10.250.0." + st.ingress_ip.rsplit(".", 1)[1]
        return st


class VSphereLikeCloud(FakeCloud):
    """vSphere-shaped behavior (providers/vsphere): no cloud
    load-balancer or routes — instances/zones/disks only, like the
    reference driver."""

    provider_name = "vsphere-like"

    def has_load_balancer(self) -> bool:
        return False

    def has_routes(self) -> bool:
        return False


_REGISTRY: Dict[str, Callable[[], CloudProvider]] = {
    "fake": FakeCloud,
    "gce-like": GCELikeCloud,
    "aws-like": AWSLikeCloud,
    "azure-like": AzureLikeCloud,
    "openstack-like": OpenStackLikeCloud,
    "vsphere-like": VSphereLikeCloud,
}


def register_provider(name: str, factory: Callable[[], CloudProvider]) -> None:
    """cloudprovider.RegisterCloudProvider (plugins.go)."""
    _REGISTRY[name] = factory


def get_provider(name: str) -> CloudProvider:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown cloud provider {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None
