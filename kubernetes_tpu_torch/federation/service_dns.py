"""Federated Services + cross-cluster service DNS.

The reference's federation service story
(federation/pkg/federation-controller/service/ + federation/pkg/
dnsprovider/):

- the service controller materializes a federated Service into every
  ready member cluster;
- the servicedns controller writes a three-level DNS hierarchy per
  service into a dnsprovider (google-clouddns/aws-route53 in-tree;
  an in-memory provider here):

      <svc>.<ns>.<fed>.svc.<zone>.<region>.<domain>   (zone level)
      <svc>.<ns>.<fed>.svc.<region>.<domain>          (region level)
      <svc>.<ns>.<fed>.svc.<domain>                   (global level)

  A level with healthy endpoints gets A records of the serving clusters'
  ingress IPs; a level with NO healthy endpoints gets a CNAME to the
  next level up (dns.go:ensureDNSRrsets) — so a zone-local client is
  always routed somewhere live.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.workloads import Service
from kubernetes_tpu_torch.federation.controller import (
    CLUSTER_KIND,
    FederationControlPlane,
)
from kubernetes_tpu_torch.server.apiserver_lite import Conflict, NotFound

FEDERATED_SERVICE_KIND = "FederatedService"


@dataclass
class FederatedService:
    """The federated object: a Service template spread to every ready
    cluster (the federation apiserver stores plain v1.Service; kept as a
    wrapper for status aggregation symmetry with the workload types)."""

    name: str
    namespace: str = "default"
    template: Service = field(default_factory=lambda: Service(name=""))
    # aggregated status: clusters currently serving healthy endpoints
    serving_clusters: List[str] = field(default_factory=list)
    resource_version: int = 0

    def key(self) -> str:
        return self.namespace + "/" + self.name


@dataclass
class DNSRecord:
    name: str
    rtype: str  # "A" | "CNAME"
    values: List[str]
    ttl: int = 180


class InMemoryDNSProvider:
    """federation/pkg/dnsprovider Interface, collapsed to the rrsets
    surface the service controller drives (ResourceRecordSets.Get/
    StartChangeset Add/Remove/Apply)."""

    def __init__(self):
        self.records: Dict[Tuple[str, str], DNSRecord] = {}

    def ensure(self, name: str, rtype: str, values: List[str],
               ttl: int = 180) -> None:
        self.records[(name, rtype)] = DNSRecord(name, rtype,
                                                sorted(values), ttl)

    def remove(self, name: str, rtype: str) -> None:
        self.records.pop((name, rtype), None)

    def lookup(self, name: str) -> Optional[DNSRecord]:
        for (n, _t), rec in self.records.items():
            if n == name:
                return rec
        return None

    def resolve(self, name: str, _depth: int = 0) -> List[str]:
        """Follow CNAME chains to the A values, like a resolver would."""
        rec = self.lookup(name)
        if rec is None or _depth > 5:
            return []
        if rec.rtype == "A":
            return list(rec.values)
        return self.resolve(rec.values[0], _depth + 1)


class FederatedServiceController:
    """service controller + servicedns controller in one sync body."""

    def __init__(self, plane: FederationControlPlane,
                 dns: Optional[InMemoryDNSProvider] = None,
                 federation: str = "myfed",
                 domain: str = "example.com"):
        self.plane = plane
        # default to the plane's provider so records persist across
        # controller instances (each `ktctl federate sync` builds a new
        # controller but must see the same zone)
        self.dns = dns if dns is not None \
            else getattr(plane, "dns", None) or InMemoryDNSProvider()
        self.federation = federation
        self.domain = domain

    # ----------------------------------------------------------------- sync

    def sync_all(self) -> None:
        fsvcs, _ = self.plane.api.list(FEDERATED_SERVICE_KIND)
        for fsvc in fsvcs:
            self.sync(fsvc)

    def sync(self, fsvc: FederatedService) -> None:
        ready = self.plane.ready_clusters()
        serving: List[str] = []
        for cname, api in list(self.plane.members.items()):
            if cname not in ready:
                continue
            # ensure the member service exists (servicecontroller
            # ensureClusterService)
            tmpl = dataclasses.replace(
                fsvc.template, name=fsvc.name, namespace=fsvc.namespace,
                resource_version=0)
            try:
                api.create("Service", tmpl)
            except Conflict:
                pass
            if self._cluster_healthy(cname, fsvc):
                serving.append(cname)
        self._write_dns(fsvc, serving)
        try:
            cur: FederatedService = self.plane.api.get(
                FEDERATED_SERVICE_KIND, fsvc.namespace, fsvc.name)
            if cur.serving_clusters != sorted(serving):
                self.plane.api.update(
                    FEDERATED_SERVICE_KIND,
                    dataclasses.replace(cur,
                                        serving_clusters=sorted(serving)),
                    expect_rv=cur.resource_version)
        except (NotFound, Conflict):
            pass

    # -------------------------------------------------------------- helpers

    def _cluster_healthy(self, cname: str, fsvc: FederatedService) -> bool:
        """A cluster serves the federated service iff its local Endpoints
        object has ready addresses (servicedns getHealthyEndpoints)."""
        api = self.plane.members.get(cname)
        if api is None:
            return False
        try:
            eps = api.get("Endpoints", fsvc.namespace, fsvc.name)
        except NotFound:
            return False
        return bool(eps.addresses)

    def _ingress_ip(self, cname: str, fsvc: FederatedService) -> str:
        api = self.plane.members[cname]
        try:
            svc = api.get("Service", fsvc.namespace, fsvc.name)
        except NotFound:
            return ""
        return svc.load_balancer_ip or svc.cluster_ip

    def _cluster_meta(self) -> Dict[str, Tuple[str, str]]:
        out = {}
        for c in self.plane.api.list(CLUSTER_KIND)[0]:
            out[c.name] = (c.zone or "zone-x", c.region or "region-x")
        return out

    def dns_name(self, fsvc: FederatedService, zone: str = "",
                 region: str = "") -> str:
        base = f"{fsvc.name}.{fsvc.namespace}.{self.federation}.svc"
        if zone:
            return f"{base}.{zone}.{region}.{self.domain}"
        if region:
            return f"{base}.{region}.{self.domain}"
        return f"{base}.{self.domain}"

    def _write_dns(self, fsvc: FederatedService,
                   serving: List[str]) -> None:
        """ensureDNSRrsets for each level: A records where endpoints
        exist, CNAME one level up where they don't."""
        meta = self._cluster_meta()
        zones: Dict[Tuple[str, str], List[str]] = {}
        regions: Dict[str, List[str]] = {}
        for cname in serving:
            ip = self._ingress_ip(cname, fsvc)
            if not ip:
                continue
            zone, region = meta.get(cname, ("zone-x", "region-x"))
            zones.setdefault((zone, region), []).append(ip)
            regions.setdefault(region, []).append(ip)
        global_ips = sorted({ip for ips in regions.values() for ip in ips})
        gname = self.dns_name(fsvc)
        if global_ips:
            self.dns.ensure(gname, "A", global_ips)
        else:
            self.dns.remove(gname, "A")
        # every known zone/region gets a record so local resolvers always
        # find the chain, even where the service is not (or no longer)
        # locally healthy
        all_zones = {(z, r) for (z, r) in
                     (meta[c] for c in meta)} | set(zones)
        for region in {r for _z, r in all_zones}:
            rname = self.dns_name(fsvc, region=region)
            if regions.get(region):
                self.dns.ensure(rname, "A", sorted(set(regions[region])))
                self.dns.remove(rname, "CNAME")
            elif global_ips:
                self.dns.remove(rname, "A")
                self.dns.ensure(rname, "CNAME", [gname])
            else:
                self.dns.remove(rname, "A")
                self.dns.remove(rname, "CNAME")
        for (zone, region) in all_zones:
            zname = self.dns_name(fsvc, zone=zone, region=region)
            if zones.get((zone, region)):
                self.dns.ensure(zname, "A",
                                sorted(set(zones[(zone, region)])))
                self.dns.remove(zname, "CNAME")
            else:
                self.dns.remove(zname, "A")
                self.dns.ensure(zname, "CNAME",
                                [self.dns_name(fsvc, region=region)])
