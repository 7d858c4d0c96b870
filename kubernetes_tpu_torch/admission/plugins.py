"""Admission plugin implementations (reference: plugin/pkg/admission/*).

Each plugin mirrors the decision logic of its Go counterpart; store access is
through the apiserver-lite store handed to the chain (the reference plugins
use informers/listers — same data, same freshness model in-process).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional

from kubernetes_tpu_torch.admission.chain import (
    AdmissionRequest,
    CREATE,
    DELETE,
    Rejected,
    UPDATE,
)
from kubernetes_tpu_torch.api.cluster import LimitRange, ResourceQuota
from kubernetes_tpu_torch.api.types import (
    Pod,
    Taint,
    TaintEffect,
    Toleration,
    TolerationOperator,
)
from kubernetes_tpu_torch.quota import (
    exceeds,
    quota_scopes_match,
    usage_for,
)


class _StorePlugin:
    store = None

    def set_store(self, store) -> None:
        self.store = store

    def _get(self, kind, ns, name):
        try:
            return self.store.get(kind, ns, name)
        except Exception:
            return None


class NamespaceLifecycle(_StorePlugin):
    """plugin/pkg/admission/namespace/lifecycle: creates in a missing or
    terminating namespace are rejected; deletes of the immortal namespaces
    (default, kube-system) are rejected."""

    IMMORTAL = ("default", "kube-system")
    NAMESPACED_KINDS_EXEMPT = ("Namespace", "Node", "PersistentVolume",
                               "ClusterRole", "ClusterRoleBinding")

    def handles(self, req: AdmissionRequest) -> bool:
        return req.operation in (CREATE, DELETE)

    def admit(self, req: AdmissionRequest) -> None:
        if req.operation == DELETE and req.kind == "Namespace" \
                and req.name in self.IMMORTAL:
            raise Rejected(f"namespace {req.name} is immortal")
        if req.operation != CREATE or req.kind in self.NAMESPACED_KINDS_EXEMPT:
            return
        if not req.namespace or self.store is None:
            return
        ns = self._get("Namespace", "", req.namespace)
        if ns is None:
            # auto-provision default like the provision plugin? The reference
            # runs lifecycle which 404s unknown namespaces.
            raise Rejected(f"namespace {req.namespace} not found")
        if getattr(ns, "phase", "Active") == "Terminating":
            raise Rejected(
                f"namespace {req.namespace} is terminating: cannot create")


class AlwaysPullImages:
    """plugin/pkg/admission/alwayspullimages: force imagePullPolicy=Always.
    Modeled as an annotation since the pull policy lives node-side here."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled

    def handles(self, req: AdmissionRequest) -> bool:
        return self.enabled and req.kind == "Pod" \
            and req.operation in (CREATE, UPDATE)

    def admit(self, req: AdmissionRequest) -> None:
        req.obj.annotations["kubernetes.io/image-pull-policy"] = "Always"


class LimitRanger(_StorePlugin):
    """plugin/pkg/admission/limitranger: apply container default requests/
    limits from LimitRange objects, reject min/max violations."""

    def handles(self, req: AdmissionRequest) -> bool:
        return req.kind == "Pod" and req.operation == CREATE

    def admit(self, req: AdmissionRequest) -> None:
        if self.store is None:
            return
        pod: Pod = req.obj
        ranges = [lr for lr in self.store.list("LimitRange")[0]
                  if lr.namespace == req.namespace]
        for lr in ranges:
            for item in lr.limits:
                if item.type != "Container":
                    continue
                for c in pod.containers:
                    for res, dv in item.default_request.items():
                        c.requests.setdefault(res, dv)
                    for res, dv in item.default.items():
                        c.limits.setdefault(res, dv)
                    for res, mn in item.min.items():
                        if res in c.requests and c.requests[res] < mn:
                            raise Rejected(
                                f"minimum {res} usage per Container is {mn}")
                    for res, mx in item.max.items():
                        if c.requests.get(res, 0) > mx \
                                or c.limits.get(res, 0) > mx:
                            raise Rejected(
                                f"maximum {res} usage per Container is {mx}")


class ServiceAccountPlugin(_StorePlugin):
    """plugin/pkg/admission/serviceaccount: default the pod's service
    account, reject references to missing service accounts. The SA name is
    carried in annotations (the Pod model doesn't reserve a field)."""

    KEY = "kubernetes.io/service-account.name"

    def handles(self, req: AdmissionRequest) -> bool:
        return req.kind == "Pod" and req.operation == CREATE

    def admit(self, req: AdmissionRequest) -> None:
        pod: Pod = req.obj
        name = pod.annotations.get(self.KEY) or "default"
        pod.annotations[self.KEY] = name
        if self.store is None:
            return
        sa = self._get("ServiceAccount", req.namespace, name)
        if sa is None and name != "default":
            raise Rejected(
                f"service account {req.namespace}/{name} does not exist")


class PodNodeSelector(_StorePlugin):
    """plugin/pkg/admission/podnodeselector: merge the namespace's
    node-selector annotation into the pod; conflicts reject."""

    ANNOTATION = "scheduler.alpha.kubernetes.io/node-selector"

    def handles(self, req: AdmissionRequest) -> bool:
        return req.kind == "Pod" and req.operation == CREATE

    def admit(self, req: AdmissionRequest) -> None:
        if self.store is None:
            return
        ns = self._get("Namespace", "", req.namespace)
        if ns is None:
            return
        raw = getattr(ns, "annotations", {}).get(self.ANNOTATION, "")
        if not raw:
            return
        selector: Dict[str, str] = {}
        for part in raw.split(","):
            if "=" in part:
                k, _, v = part.partition("=")
                selector[k.strip()] = v.strip()
        pod: Pod = req.obj
        for k, v in selector.items():
            if k in pod.node_selector and pod.node_selector[k] != v:
                raise Rejected(
                    f"pod node label selector conflicts with namespace "
                    f"node label selector for key {k}")
            pod.node_selector[k] = v


class PodTolerationRestriction(_StorePlugin):
    """plugin/pkg/admission/podtolerationrestriction: merge namespace
    default tolerations; enforce the namespace whitelist."""

    DEFAULT_KEY = "scheduler.alpha.kubernetes.io/defaultTolerations"
    WHITELIST_KEY = "scheduler.alpha.kubernetes.io/tolerationsWhitelist"

    def handles(self, req: AdmissionRequest) -> bool:
        return req.kind == "Pod" and req.operation == CREATE

    def admit(self, req: AdmissionRequest) -> None:
        if self.store is None:
            return
        ns = self._get("Namespace", "", req.namespace)
        if ns is None:
            return
        anns = getattr(ns, "annotations", {})
        pod: Pod = req.obj
        defaults = self._parse(anns.get(self.DEFAULT_KEY, ""))
        if defaults and not pod.tolerations:
            pod.tolerations = defaults
        whitelist = self._parse(anns.get(self.WHITELIST_KEY, ""))
        if whitelist:
            allowed = {(t.key, t.value) for t in whitelist}
            for t in pod.tolerations:
                if (t.key, t.value) not in allowed:
                    raise Rejected(
                        f"pod toleration {t.key}={t.value} not in namespace "
                        "whitelist")

    @staticmethod
    def _parse(raw: str):
        out = []
        for part in raw.split(";"):
            if "=" in part:
                k, _, v = part.partition("=")
                out.append(Toleration(key=k.strip(), value=v.strip()))
        return out


# TaintBasedEvictions not-ready/unreachable taint keys
# (pkg/controller/node + plugin/pkg/admission/defaulttolerationseconds)
NOT_READY_TAINT = "node.alpha.kubernetes.io/notReady"
UNREACHABLE_TAINT = "node.alpha.kubernetes.io/unreachable"
DEFAULT_TOLERATION_SECONDS = 300


class DefaultTolerationSeconds:
    """plugin/pkg/admission/defaulttolerationseconds: add 300s NoExecute
    tolerations for notReady/unreachable unless the pod already has one."""

    def handles(self, req: AdmissionRequest) -> bool:
        return req.kind == "Pod" and req.operation in (CREATE, UPDATE)

    def admit(self, req: AdmissionRequest) -> None:
        pod: Pod = req.obj
        has_nr = any(t.key == NOT_READY_TAINT and
                     t.effect in (None, TaintEffect.NO_EXECUTE)
                     for t in pod.tolerations)
        has_ur = any(t.key == UNREACHABLE_TAINT and
                     t.effect in (None, TaintEffect.NO_EXECUTE)
                     for t in pod.tolerations)
        if not has_nr:
            pod.tolerations = list(pod.tolerations) + [Toleration(
                key=NOT_READY_TAINT, operator=TolerationOperator.EXISTS,
                effect=TaintEffect.NO_EXECUTE,
                toleration_seconds=DEFAULT_TOLERATION_SECONDS)]
        if not has_ur:
            pod.tolerations = list(pod.tolerations) + [Toleration(
                key=UNREACHABLE_TAINT, operator=TolerationOperator.EXISTS,
                effect=TaintEffect.NO_EXECUTE,
                toleration_seconds=DEFAULT_TOLERATION_SECONDS)]


class NodeRestriction:
    """plugin/pkg/admission/noderestriction: a kubelet may only modify its
    own Node object and pods bound to it, and may only CREATE mirror-style
    pods bound to itself that reference no secrets/configmaps/PVCs — else a
    compromised kubelet could mint a pod referencing any secret and ride
    the node authorizer's reachability grant to read it
    (admission.go:112-141 in the reference)."""

    def handles(self, req: AdmissionRequest) -> bool:
        return req.user is not None \
            and req.user.name.startswith("system:node:") \
            and req.kind in ("Node", "Pod")

    def admit(self, req: AdmissionRequest) -> None:
        from kubernetes_tpu_torch.api.types import VolumeKind

        node_name = req.user.name[len("system:node:"):]
        if req.kind == "Node":
            if req.operation in (UPDATE, DELETE) and req.name != node_name:
                raise Rejected(
                    f"node {node_name} cannot modify node {req.name}")
        elif req.kind == "Pod" and req.operation == CREATE:
            pod = req.obj
            if getattr(pod, "node_name", "") != node_name:
                raise Rejected(
                    f"node {node_name} can only create pods bound to itself")
            for vol in getattr(pod, "volumes", None) or []:
                if vol.kind in (VolumeKind.SECRET, VolumeKind.CONFIG_MAP,
                                VolumeKind.PVC):
                    raise Rejected(
                        f"node {node_name} cannot create pods that reference "
                        f"{vol.kind.value} volumes")
        elif req.kind == "Pod" and req.operation in (UPDATE, DELETE):
            pod = req.old_obj or req.obj
            if pod is not None and getattr(pod, "node_name", "") \
                    not in ("", node_name):
                raise Rejected(
                    f"node {node_name} cannot modify pods bound elsewhere")


class PriorityPlugin(_StorePlugin):
    """plugin/pkg/admission/priority (behind the PodPriority gate in 1.7):
    resolve priorityClassName -> priority value."""

    def handles(self, req: AdmissionRequest) -> bool:
        from kubernetes_tpu_torch.utils import features

        return features.enabled("PodPriority") and req.kind == "Pod" \
            and req.operation == CREATE

    def admit(self, req: AdmissionRequest) -> None:
        pod: Pod = req.obj
        if not pod.priority_class:
            return
        pc = self._get("PriorityClass", "", pod.priority_class)
        if pc is None:
            raise Rejected(
                f"no PriorityClass with name {pod.priority_class} was found")
        pod.priority = pc.value


class StorageClassDefault(_StorePlugin):
    """plugin/pkg/admission/storageclass/default: annotate PVCs without a
    class with the default StorageClass."""

    ANNOTATION = "volume.beta.kubernetes.io/storage-class"

    def handles(self, req: AdmissionRequest) -> bool:
        return req.kind == "PersistentVolumeClaim" and req.operation == CREATE

    def admit(self, req: AdmissionRequest) -> None:
        if self.store is None:
            return
        anns = getattr(req.obj, "annotations", None)
        if anns is None or self.ANNOTATION in anns:
            return
        for sc in self.store.list("StorageClass")[0]:
            if getattr(sc, "is_default", False):
                anns[self.ANNOTATION] = sc.name
                return


class PodSecurityPolicyPlugin(_StorePlugin):
    """plugin/pkg/admission/security/podsecuritypolicy (admission.go:120
    Admit): on pod CREATE, try every PodSecurityPolicy in name order; the
    first whose generated defaults validate wins — the pod is mutated with
    those defaults and annotated kubernetes.io/psp=<name>. No policy
    passing (or none existing while the plugin is enabled) rejects the pod.

    Opt-in, like the reference (not in the 1.7 recommended set):
    AdmissionChain(default_plugins() + [PodSecurityPolicyPlugin()], ...)."""

    def handles(self, req: AdmissionRequest) -> bool:
        return req.operation == CREATE and req.kind == "Pod"

    def admit(self, req: AdmissionRequest) -> None:
        from kubernetes_tpu_torch.security.psp import (
            PSP_ANNOTATION,
            PSP_KIND,
            Provider,
        )
        if self.store is None:
            return
        policies = sorted(self.store.list(PSP_KIND)[0],
                          key=lambda p: p.name)
        pod: Pod = req.obj
        all_errs = []
        for psp in policies:
            provider = Provider(psp)
            candidate = provider.apply_defaults(pod)
            errs = provider.validate(candidate)
            if not errs:
                candidate.annotations = dict(candidate.annotations)
                candidate.annotations[PSP_ANNOTATION] = psp.name
                # commit the mutation (the chain passes req.obj onward)
                pod.__dict__.update(candidate.__dict__)
                return
            all_errs.extend(f"{psp.name}: {e}" for e in errs)
        raise Rejected(
            "unable to validate against any pod security policy: "
            + ("; ".join(all_errs) if all_errs else "no policies defined"))


class ResourceQuotaPlugin(_StorePlugin):
    """plugin/pkg/admission/resourcequota: on CREATE, check the delta
    against every matching quota's hard limits and commit the new usage
    through the apiserver's guarded update (the reference's quota CAS loop —
    resource_access.go UpdateQuotaStatus), so a watch event + rv bump is
    emitted for every usage change. Committed increments are recorded on the
    request (req.undo) and rolled back by the chain if registry validation
    or the store create fails afterwards — no leaked usage until resync."""

    _CAS_RETRIES = 5

    def handles(self, req: AdmissionRequest) -> bool:
        return req.operation == CREATE and req.kind in (
            "Pod", "Service", "ReplicationController", "Secret", "ConfigMap",
            "PersistentVolumeClaim", "ResourceQuota")

    def admit(self, req: AdmissionRequest) -> None:
        if self.store is None:
            return
        delta = usage_for(req.kind, req.obj)
        if not delta:
            return
        from kubernetes_tpu_torch.server.apiserver_lite import Conflict
        for _ in range(self._CAS_RETRIES):
            quotas = [q for q in self.store.list("ResourceQuota")[0]
                      if q.namespace == req.namespace
                      and quota_scopes_match(q.scopes, req.kind, req.obj)]
            affected = []
            for q in quotas:
                constrained = [k for k in delta if k in q.hard]
                if not constrained:
                    continue
                over = exceeds(q.hard, q.used, delta)
                if over:
                    raise Rejected(
                        f"exceeded quota: {q.name}, requested: "
                        + ",".join(f"{k}={delta[k]}" for k in over)
                        + ", limited: "
                        + ",".join(f"{k}={q.hard[k]}" for k in over))
                affected.append(q)
            try:
                for q in affected:
                    nq = copy.deepcopy(q)
                    for k, v in delta.items():
                        if k in nq.hard:
                            nq.used[k] = nq.used.get(k, 0) + v
                    self.store.update("ResourceQuota", nq,
                                      expect_rv=q.resource_version)
                    req.undo.append(
                        lambda name=q.name, d=dict(delta):
                        self._decrement(name, req.namespace, d))
                return
            except Conflict:
                # another writer moved a quota between list and update:
                # roll back what this attempt committed and re-check
                while req.undo:
                    req.undo.pop()()
                continue
        raise Rejected("quota update conflict: too many retries")

    def _decrement(self, name: str, namespace: str,
                   delta: Dict[str, int]) -> None:
        from kubernetes_tpu_torch.server.apiserver_lite import Conflict, NotFound
        for _ in range(self._CAS_RETRIES):
            try:
                cur = self.store.get("ResourceQuota", namespace, name)
            except NotFound:
                return
            nq = copy.deepcopy(cur)
            for k, v in delta.items():
                if k in nq.used:
                    nq.used[k] = max(0, nq.used[k] - v)
            try:
                self.store.update("ResourceQuota", nq,
                                  expect_rv=cur.resource_version)
                return
            except Conflict:
                continue


# ---------------------------------------------------------------------------
# the remaining static plugins of plugin/pkg/admission/
# ---------------------------------------------------------------------------


@dataclass
class PodPreset:
    """settings.k8s.io PodPreset, reduced to the injection surface this
    model carries: annotations to merge and volumes to append into pods
    matched by a label selector (plugin/pkg/admission/podpreset/admission.go
    injects env/envFrom/volumes/volumeMounts; env lives in annotations
    here)."""

    name: str
    namespace: str = "default"
    selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    volumes: List = dataclasses.field(default_factory=list)
    resource_version: int = 0
    deleted: bool = False


class PodPresetPlugin(_StorePlugin):
    """plugin/pkg/admission/podpreset: merge matching presets into pods at
    CREATE. Reference conflict semantics (admission.go mergePodPresets):
    ANY conflict across the matched presets aborts injection entirely —
    the pod is admitted unmodified, never rejected. Applied presets are
    recorded as podpreset.admission.kubernetes.io/podpreset-<name>
    annotations, like the reference's bookkeeping stamp."""

    STAMP_PREFIX = "podpreset.admission.kubernetes.io/podpreset-"

    def handles(self, req: AdmissionRequest) -> bool:
        return req.operation == CREATE and req.kind == "Pod"

    def admit(self, req: AdmissionRequest) -> None:
        pod: Pod = req.obj
        try:
            presets, _ = self.store.list("PodPreset")
        except Exception:
            return
        matched = [
            p for p in presets
            if p.namespace == req.namespace
            and all(pod.labels.get(k) == v for k, v in p.selector.items())]
        if not matched:
            return
        new_ann: Dict[str, str] = {}
        new_vols = []
        vol_names = {v.name for v in pod.volumes}
        for p in matched:
            for k, v in p.annotations.items():
                if pod.annotations.get(k, v) != v or new_ann.get(k, v) != v:
                    return  # conflict: skip ALL presets, admit unmodified
                new_ann[k] = v
            for vol in p.volumes:
                if vol.name in vol_names:
                    return  # volume-name conflict
                vol_names.add(vol.name)
                new_vols.append(vol)
        pod.annotations.update(new_ann)
        pod.volumes.extend(new_vols)
        for p in matched:
            pod.annotations[self.STAMP_PREFIX + p.name] = \
                str(p.resource_version)


class LimitPodHardAntiAffinityTopology:
    """plugin/pkg/admission/antiaffinity: deny pods whose REQUIRED pod
    anti-affinity uses a topology key other than kubernetes.io/hostname —
    a hard zone/region anti-affinity lets one pod fence whole failure
    domains (admission.go checkPodsWithAntiAffinityTerm)."""

    HOSTNAME = "kubernetes.io/hostname"

    def set_store(self, store) -> None:
        pass

    def handles(self, req: AdmissionRequest) -> bool:
        return req.kind == "Pod" and req.operation in (CREATE, UPDATE)

    def admit(self, req: AdmissionRequest) -> None:
        pod: Pod = req.obj
        aff = pod.affinity
        if aff is None or aff.pod_anti_affinity is None:
            return
        for term in aff.pod_anti_affinity.required_terms:
            if term.topology_key and term.topology_key != self.HOSTNAME:
                raise Rejected(
                    "affinity.podAntiAffinity."
                    "requiredDuringSchedulingIgnoredDuringExecution with "
                    f"topologyKey {term.topology_key!r} is not allowed "
                    f"(only {self.HOSTNAME})")


class DenyEscalatingExec(_StorePlugin):
    """plugin/pkg/admission/exec DenyEscalatingExec: block exec/attach
    CONNECTs into pods that escalate to the host (privileged containers;
    host-network stands in for the reference's hostPID/hostIPC checks —
    the host axes this pod model carries)."""

    def handles(self, req: AdmissionRequest) -> bool:
        from kubernetes_tpu_torch.admission.chain import CONNECT
        return req.operation == CONNECT \
            and req.subresource in ("exec", "attach")

    def admit(self, req: AdmissionRequest) -> None:
        pod = req.obj
        if pod is None:
            pod = self._get("Pod", req.namespace, req.name)
        if pod is None:
            return
        if getattr(pod, "host_network", False):
            raise Rejected(
                "cannot exec into or attach to a container using host "
                "network")
        for c in getattr(pod, "containers", []):
            sc = c.security_context
            if sc is not None and sc.privileged:
                raise Rejected(
                    "cannot exec into or attach to a privileged container")


class OwnerReferencesPermissionEnforcement:
    """plugin/pkg/admission/gc: setting or changing ownerReferences
    requires delete permission on the object — otherwise any writer could
    mark an object for cascade deletion by a controller they don't own
    (gc_admission.go Admit)."""

    def __init__(self, authorize=None):
        # authorize(user, verb, kind, namespace) -> bool; None = allow all
        # (the plugin is inert without an authorizer, like the reference
        # wired without RBAC)
        self._authorize = authorize

    def set_store(self, store) -> None:
        pass

    def handles(self, req: AdmissionRequest) -> bool:
        return req.operation in (CREATE, UPDATE)

    @staticmethod
    def _owner(obj) -> tuple:
        return (getattr(obj, "owner_kind", ""),
                getattr(obj, "owner_name", ""))

    def admit(self, req: AdmissionRequest) -> None:
        if self._authorize is None:
            return
        new_owner = self._owner(req.obj)
        if req.operation == CREATE:
            changed = new_owner != ("", "")
        else:
            changed = req.old_obj is not None \
                and new_owner != self._owner(req.old_obj)
        if not changed:
            return
        if not self._authorize(req.user, "delete", req.kind, req.namespace):
            raise Rejected(
                f"cannot set an ownerReference on a {req.kind} without "
                f"delete permission")


class PersistentVolumeLabel(_StorePlugin):
    """plugin/pkg/admission/persistentvolume/label PersistentVolumeLabel:
    stamp cloud zone/region failure-domain labels onto EBS/GCE-PD PVs at
    CREATE so the VolumeZone predicate can enforce them (admission.go
    findVolumeLabels via the cloud's disk API)."""

    CLOUD_KINDS = ("GCEPersistentDisk", "AWSElasticBlockStore", "AzureDisk")

    def __init__(self, cloud=None):
        self.cloud = cloud

    def handles(self, req: AdmissionRequest) -> bool:
        return req.operation == CREATE and req.kind == "PersistentVolume"

    def admit(self, req: AdmissionRequest) -> None:
        pv = req.obj
        if self.cloud is None or pv.source.kind.value not in self.CLOUD_KINDS:
            return
        zone_of = getattr(self.cloud, "disk_zone", None)
        if zone_of is None:
            return
        zr = zone_of(pv.source.volume_id)
        if zr is None:
            # the reference plugin errors when the cloud can't find the
            # volume (admission.go findVolumeLabels) — stamping a made-up
            # zone would let VolumeZone schedule against fiction
            raise Rejected(
                f"error querying volume {pv.source.volume_id!r}: "
                f"disk not found in cloud provider")
        zone, region = zr
        from kubernetes_tpu_torch.ops.oracle_ext import (
            ZONE_LABEL,
            ZONE_REGION_LABEL,
        )
        # admission labels win over client-supplied ones (the reference
        # overwrites: the cloud is authoritative about where a disk lives)
        pv.labels[ZONE_LABEL] = zone
        pv.labels[ZONE_REGION_LABEL] = region
