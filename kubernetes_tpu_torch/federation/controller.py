"""Federation control plane: member-cluster registry + federated-ReplicaSet
sync controller.

The minimal L9 slice of the reference's federation/ tree (38.9k LoC):

- FederationControlPlane owns its OWN apiserver-lite (the
  federation-apiserver) holding Cluster objects
  (federation/apis/federation/types.go Cluster) and FederatedReplicaSet
  objects (a plain workloads.ReplicaSet stored under the federated kind,
  exactly how the federation apiserver re-uses the member type).
- FederatedReplicaSetController is the per-type sync controller
  (federation/pkg/federatedtypes/replicaset.go + scheduling.go +
  sync controller): for each federated RS it reads the replica-set-
  preferences annotation, gathers each READY member cluster's current
  replica state, runs the planner, and creates/updates/deletes the
  per-cluster ReplicaSets to match the plan. A cluster going NotReady
  (or being unjoined) drops out of the plan and its replicas move —
  the rebalance-on-cluster-loss story.

Member clusters are in-process ApiServerLite instances (the rig's answer
to multi-cluster), each typically running its own ReplicaSetController +
Scheduler + fleet; the federation layer only talks to their API servers,
like the reference's federated clientsets.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.workloads import ReplicaSet
from kubernetes_tpu_torch.federation.planner import (
    DEFAULT_PREFERENCES,
    PREFERENCES_ANNOTATION,
    Planner,
    ReplicaAllocationPreferences,
)
from kubernetes_tpu_torch.server.apiserver_lite import (
    ApiServerLite,
    Conflict,
    NotFound,
)

FEDERATED_RS_KIND = "FederatedReplicaSet"
FEDERATED_DEPLOY_KIND = "FederatedDeployment"
CLUSTER_KIND = "Cluster"


@dataclass
class Cluster:
    """federation Cluster object: name + readiness (types.go Cluster/
    ClusterStatus; readiness is maintained by the cluster controller's
    healthz probes — here set by join/mark_ready). zone/region feed the
    service-DNS record hierarchy (types.go ClusterStatus.Zones/Region)."""

    name: str
    ready: bool = True
    zone: str = ""
    region: str = ""
    resource_version: int = 0


@dataclass
class FederatedReplicaSet:
    """The federated object: a ReplicaSet template + total replicas +
    preferences annotation (replicaset.go reuses extensions/ReplicaSet)."""

    name: str
    namespace: str = "default"
    replicas: int = 0
    template: ReplicaSet = field(default_factory=lambda: ReplicaSet(name=""))
    annotations: Dict[str, str] = field(default_factory=dict)
    # status (UpdateFederatedStatus): aggregated across clusters
    ready_replicas: int = 0
    resource_version: int = 0

    def key(self) -> str:
        return self.namespace + "/" + self.name


class FederationControlPlane:
    """The federation-apiserver + cluster registry. The DNS provider
    lives here (one zone per federation, like the reference's dnsprovider
    config on the federation-controller-manager) so records persist
    across sync invocations."""

    def __init__(self):
        self.api = ApiServerLite()
        self.members: Dict[str, ApiServerLite] = {}
        from kubernetes_tpu_torch.federation.service_dns import InMemoryDNSProvider
        self.dns = InMemoryDNSProvider()

    # ------------------------------------------------------------ clusters

    def join(self, name: str, api: ApiServerLite, zone: str = "",
             region: str = "") -> None:
        """kubefed join: register a member cluster."""
        self.members[name] = api
        try:
            self.api.create(CLUSTER_KIND,
                            Cluster(name=name, zone=zone, region=region))
        except Conflict:
            self.mark_ready(name, True)

    def unjoin(self, name: str) -> None:
        """kubefed unjoin: deregister. Like the reference, unjoin is pure
        deregistration — objects already in the cluster are left alone and
        simply stop being reconciled (the cluster's owner keeps them)."""
        self.members.pop(name, None)
        try:
            self.api.delete(CLUSTER_KIND, "", name)
        except NotFound:
            pass

    def mark_ready(self, name: str, ready: bool) -> None:
        cur: Cluster = self.api.get(CLUSTER_KIND, "", name)
        self.api.update(CLUSTER_KIND,
                        dataclasses.replace(cur, ready=ready))

    def ready_clusters(self) -> List[str]:
        clusters, _ = self.api.list(CLUSTER_KIND)
        return sorted(c.name for c in clusters
                      if c.ready and c.name in self.members)


class FederatedReplicaSetController:
    """The per-type sync controller, ReplicaSet flavor. The class attrs
    are the federatedtypes adapter surface (federation/pkg/federatedtypes/
    adapter.go): every replica-carrying federated type shares this sync
    body and differs only in its kinds — FederatedDeploymentController
    below is the deployment.go adapter."""

    FED_KIND = FEDERATED_RS_KIND
    CHILD_KIND = "ReplicaSet"

    def __init__(self, plane: FederationControlPlane):
        self.plane = plane

    # ----------------------------------------------------------------- sync

    def sync_all(self) -> None:
        frs_list, _ = self.plane.api.list(self.FED_KIND)
        for frs in frs_list:
            self.sync(frs)

    def sync(self, frs: FederatedReplicaSet) -> None:
        """GetSchedule + ScheduleObject for every member
        (federatedtypes/scheduling.go:90,141): plan, then reconcile each
        cluster's ReplicaSet to its planned replica count."""
        prefs = DEFAULT_PREFERENCES
        ann = frs.annotations.get(PREFERENCES_ANNOTATION)
        if ann:
            prefs = ReplicaAllocationPreferences.parse(ann)
        ready = self.plane.ready_clusters()
        # one child-RS read per member, reused by planning AND reconcile
        child_rs: Dict[str, Optional[ReplicaSet]] = {
            cname: self._cluster_rs(cname, frs)
            for cname in self.plane.members}
        current = {cname: rs.replicas for cname in ready
                   if (rs := child_rs.get(cname)) is not None}
        plan, _overflow = Planner(prefs).plan(
            frs.replicas, ready, current=current, key=frs.key())

        total_ready = 0
        for cname, api in list(self.plane.members.items()):
            want = plan.get(cname, 0)
            rs = child_rs.get(cname)
            if cname not in ready or want == 0:
                # ScheduleAction remove (scheduling.go:141-170)
                if rs is not None and cname in self.plane.members:
                    try:
                        api.delete(self.CHILD_KIND, frs.namespace, frs.name)
                    except NotFound:
                        pass
                continue
            if rs is None:
                child = dataclasses.replace(
                    frs.template, name=frs.name, namespace=frs.namespace,
                    replicas=want, resource_version=0,
                    annotations={**getattr(frs.template, "annotations", {}),
                                 MANAGED_ANNOTATION: "true"})
                try:
                    api.create(self.CHILD_KIND, child)
                except Conflict:
                    pass
            elif rs.replicas != want:
                api.update(self.CHILD_KIND,
                           dataclasses.replace(rs, replicas=want),
                           expect_rv=rs.resource_version)
            if rs is not None:
                total_ready += rs.ready_replicas
        # UpdateFederatedStatus (scheduling.go:172)
        try:
            cur: FederatedReplicaSet = self.plane.api.get(
                self.FED_KIND, frs.namespace, frs.name)
            if cur.ready_replicas != total_ready:
                self.plane.api.update(
                    self.FED_KIND,
                    dataclasses.replace(cur, ready_replicas=total_ready),
                    expect_rv=cur.resource_version)
        except (NotFound, Conflict):
            pass

    def _cluster_rs(self, cname: str, frs: FederatedReplicaSet
                    ) -> Optional[ReplicaSet]:
        api = self.plane.members.get(cname)
        if api is None:
            return None
        try:
            return api.get(self.CHILD_KIND, frs.namespace, frs.name)
        except NotFound:
            return None


@dataclass
class FederatedDeployment:
    """FederatedDeployment (federatedtypes/deployment.go): same shape as
    the RS flavor with a Deployment template."""

    name: str
    namespace: str = "default"
    replicas: int = 0
    template: object = None
    annotations: Dict[str, str] = field(default_factory=dict)
    ready_replicas: int = 0
    resource_version: int = 0

    def key(self) -> str:
        return self.namespace + "/" + self.name


class FederatedDeploymentController(FederatedReplicaSetController):
    """federatedtypes/deployment.go: the Deployment adapter over the
    shared replica-scheduling sync body."""

    FED_KIND = FEDERATED_DEPLOY_KIND
    CHILD_KIND = "Deployment"


# Namespace rides the same body (federatedtypes/namespace.go): a federated
# namespace lands in every ready member; cluster-scoped (namespace "")
PROPAGATED_KINDS = ("ConfigMap", "Secret", "Namespace")
FEDERATED_DS_KIND = "FederatedDaemonSet"


def propagate_kind(plane: FederationControlPlane, conflicts: List[str],
                   fed_kind: str, child_kind: str,
                   status_fields: tuple = ()) -> None:
    """The ONE sync body for every non-scheduled federated type: create
    where missing, overwrite drift (comparing the wire form minus
    resourceVersion and the member-owned status fields), never adopt a
    member-local object of the same name (surfaced via `conflicts`
    instead of destroying data federation never owned), and delete
    managed copies whose federated parent is gone."""
    import copy as _copy

    from kubernetes_tpu_torch.api import wire
    ready = set(plane.ready_clusters())
    fed_objs, _ = plane.api.list(fed_kind)
    fed_keys = {(getattr(o, "namespace", ""), o.name) for o in fed_objs}
    wants = []  # desired state computed ONCE, reused for every member
    for obj in fed_objs:
        want = _copy.deepcopy(obj)
        want.resource_version = 0
        want.annotations = {**getattr(obj, "annotations", {}),
                            MANAGED_ANNOTATION: "true"}
        enc = wire.encode(want)
        enc.pop("resource_version", None)
        for f in status_fields:
            enc.pop(f, None)
        wants.append((obj, want, enc))
    for cname, api in list(plane.members.items()):
        if cname not in ready:
            continue
        for obj, want, want_enc in wants:
            try:
                cur = api.get(child_kind, getattr(obj, "namespace", ""),
                              obj.name)
            except NotFound:
                try:
                    api.create(child_kind, _copy.deepcopy(want))
                except Conflict:
                    pass
                continue
            if getattr(cur, "annotations", {}).get(MANAGED_ANNOTATION) \
                    != "true":
                conflicts.append(
                    f"{cname}/{child_kind}/"
                    f"{getattr(obj, 'namespace', '')}/{obj.name}")
                continue
            cur_enc = wire.encode(cur)
            cur_enc.pop("resource_version", None)
            for f in status_fields:
                cur_enc.pop(f, None)
            if cur_enc != want_enc:
                fresh = _copy.deepcopy(want)
                fresh.resource_version = cur.resource_version
                api.update(child_kind, fresh)
        for existing in api.list(child_kind)[0]:
            if (getattr(existing, "namespace", ""),
                    existing.name) in fed_keys:
                continue
            if getattr(existing, "annotations", {}).get(
                    MANAGED_ANNOTATION) == "true":
                try:
                    api.delete(child_kind,
                               getattr(existing, "namespace", ""),
                               existing.name)
                except NotFound:
                    pass


class FederatedDaemonSetController:
    """federatedtypes/daemonset.go: no replica planning — the DaemonSet
    lands verbatim in EVERY ready member cluster (each cluster's own
    DaemonSet controller then runs one pod per node); the shared
    propagation body supplies the conflict guard and orphan cleanup,
    with the member-owned status fields excluded from drift."""

    def __init__(self, plane: FederationControlPlane):
        self.plane = plane
        self.conflicts: List[str] = []

    def sync_all(self) -> None:
        self.conflicts = []
        propagate_kind(self.plane, self.conflicts, FEDERATED_DS_KIND,
                       "DaemonSet",
                       status_fields=("desired_scheduled",
                                      "current_scheduled"))


MANAGED_ANNOTATION = "federation.kubernetes.io/managed"


class FederatedPropagationController:
    """The non-scheduled federated types (federatedtypes/{configmap,
    secret}.go): objects stored in the federation apiserver under the
    federated kind are copied verbatim into every READY member cluster
    and kept in sync — create where missing, overwrite on drift (data,
    annotations, and Secret type alike), delete from members when the
    federated object goes away. Ownership rides an ANNOTATION, the
    payload is untouched, and a pre-existing member-local object of the
    same name is never adopted or overwritten (a propagation conflict is
    surfaced, not silently resolved by destroying local data)."""

    def __init__(self, plane: FederationControlPlane):
        self.plane = plane
        self.conflicts: List[str] = []  # "<cluster>/<kind>/<ns>/<name>"

    def sync_all(self) -> None:
        self.conflicts = []
        for kind in PROPAGATED_KINDS:
            propagate_kind(self.plane, self.conflicts,
                           "Federated" + kind, kind)
