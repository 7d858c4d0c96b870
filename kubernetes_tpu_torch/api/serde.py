"""Kubernetes JSON wire-format codecs.

Decodes real k8s v1 JSON objects (Pod, Node, the scheduler-extender wire
structs) into the framework's object model, so the extender sidecar speaks
the reference's exact HTTP contract (plugin/pkg/scheduler/core/extender.go:226
`send` posts JSON-encoded ExtenderArgs; structs at
plugin/pkg/scheduler/api/types.go:158-204 & their v1 mirror api/v1/types.go).

Includes a resource.Quantity parser
(staging/src/k8s.io/apimachinery/pkg/api/resource/quantity.go semantics:
plain/decimal numbers, "m" milli suffix, decimal K/M/G/T/P/E and binary
Ki/Mi/Gi/Ti/Pi/Ei suffixes, scientific notation). CPU decodes to millicores
(MilliValue), everything else to integer units rounded up (Value)."""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Any, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import (
    Affinity,
    Container,
    ContainerPort,
    LabelSelector,
    Node,
    NodeAffinity,
    NodeCondition,
    NodeSelectorTerm,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodSecurityContext,
    Probe,
    Resource,
    SecurityContext,
    SelectorOperator,
    SelectorRequirement,
    Taint,
    TaintEffect,
    Toleration,
    TolerationOperator,
    Volume,
    VolumeKind,
)

_SUFFIX = {
    "k": 10 ** 3, "M": 10 ** 6, "G": 10 ** 9, "T": 10 ** 12,
    "P": 10 ** 15, "E": 10 ** 18,
    "Ki": 2 ** 10, "Mi": 2 ** 20, "Gi": 2 ** 30, "Ti": 2 ** 40,
    "Pi": 2 ** 50, "Ei": 2 ** 60,
}


def parse_quantity(s) -> Fraction:
    """-> exact Fraction of base units."""
    if isinstance(s, (int, float)):
        return Fraction(s).limit_denominator(10 ** 9)
    s = s.strip()
    if not s:
        return Fraction(0)
    for suf in ("Ki", "Mi", "Gi", "Ti", "Pi", "Ei", "k", "M", "G", "T", "P", "E"):
        if s.endswith(suf):
            return Fraction(s[: -len(suf)]) * _SUFFIX[suf]
    if s.endswith("m"):
        return Fraction(s[:-1]) / 1000
    return Fraction(s)


def quantity_milli(s) -> int:
    """MilliValue: ceil to millis (quantity.go ScaledValue(resource.Milli))."""
    return int(math.ceil(parse_quantity(s) * 1000))


def quantity_value(s) -> int:
    """Value: ceil to whole units."""
    return int(math.ceil(parse_quantity(s)))


def decode_resource_list(rl: Optional[Dict[str, Any]]) -> Dict[str, int]:
    """k8s ResourceList -> canonical int units (cpu: millicores; rest: value)."""
    out: Dict[str, int] = {}
    for name, q in (rl or {}).items():
        if name == "cpu":
            out["cpu"] = quantity_milli(q)
        elif name == "memory":
            out["memory"] = quantity_value(q)
        else:
            out[name] = quantity_value(q)
    return out


# ---------------------------------------------------------------------------
# selectors / affinity
# ---------------------------------------------------------------------------


def _decode_requirements(reqs: Optional[List[Dict]]) -> List[SelectorRequirement]:
    out = []
    for r in reqs or []:
        out.append(SelectorRequirement(
            key=r.get("key", ""),
            operator=SelectorOperator(r.get("operator", "In")),
            values=list(r.get("values") or []),
        ))
    return out


def _decode_node_affinity(na: Optional[Dict]) -> Optional[NodeAffinity]:
    if na is None:
        return None
    required = None
    req = na.get("requiredDuringSchedulingIgnoredDuringExecution")
    if req is not None:
        required = [NodeSelectorTerm(_decode_requirements(t.get("matchExpressions")))
                    for t in req.get("nodeSelectorTerms") or []]
    preferred = []
    for p in na.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
        pref = p.get("preference") or {}
        preferred.append((int(p.get("weight", 1)),
                          NodeSelectorTerm(_decode_requirements(
                              pref.get("matchExpressions")))))
    return NodeAffinity(required_terms=required, preferred_terms=preferred)


def _decode_label_selector(ls: Optional[Dict]) -> Optional[LabelSelector]:
    if ls is None:
        return None
    return LabelSelector(
        match_labels=dict(ls.get("matchLabels") or {}),
        match_expressions=_decode_requirements(ls.get("matchExpressions")),
    )


def _decode_pod_affinity_terms(terms: Optional[List[Dict]]) -> List[PodAffinityTerm]:
    out = []
    for t in terms or []:
        out.append(PodAffinityTerm(
            label_selector=_decode_label_selector(t.get("labelSelector")),
            namespaces=list(t.get("namespaces") or []),
            topology_key=t.get("topologyKey", ""),
        ))
    return out


def _decode_pod_affinity(pa: Optional[Dict]) -> Optional[PodAffinity]:
    if pa is None:
        return None
    preferred = []
    for w in pa.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
        term = w.get("podAffinityTerm") or {}
        preferred.append((int(w.get("weight", 1)),
                          _decode_pod_affinity_terms([term])[0]))
    return PodAffinity(
        required_terms=_decode_pod_affinity_terms(
            pa.get("requiredDuringSchedulingIgnoredDuringExecution")),
        preferred_terms=preferred,
    )


def decode_affinity(aff: Optional[Dict]) -> Optional[Affinity]:
    if not aff:
        return None
    return Affinity(
        node_affinity=_decode_node_affinity(aff.get("nodeAffinity")),
        pod_affinity=_decode_pod_affinity(aff.get("podAffinity")),
        pod_anti_affinity=_decode_pod_affinity(aff.get("podAntiAffinity")),
    )


# -- encoders inverting the decoders above (conversion round-trip support) --


def _encode_requirements(reqs: List[SelectorRequirement]) -> List[Dict]:
    return [{"key": r.key,
             "operator": r.operator.value
             if hasattr(r.operator, "value") else r.operator,
             "values": list(r.values)} for r in reqs]


def _encode_label_selector(ls: Optional[LabelSelector]) -> Optional[Dict]:
    if ls is None:
        return None  # nil selector (matches nothing) != empty (matches all)
    out: Dict[str, Any] = {}
    if ls.match_labels:
        out["matchLabels"] = dict(ls.match_labels)
    if ls.match_expressions:
        out["matchExpressions"] = _encode_requirements(ls.match_expressions)
    return out


def _encode_pod_affinity_term(t: PodAffinityTerm) -> Dict:
    out: Dict[str, Any] = {"topologyKey": t.topology_key}
    sel = _encode_label_selector(t.label_selector)
    if sel is not None:
        out["labelSelector"] = sel
    if t.namespaces:
        out["namespaces"] = list(t.namespaces)
    return out


def _encode_pod_affinity(pa: Optional[PodAffinity]) -> Optional[Dict]:
    if pa is None:
        return None
    out: Dict[str, Any] = {}
    if pa.required_terms:
        out["requiredDuringSchedulingIgnoredDuringExecution"] = [
            _encode_pod_affinity_term(t) for t in pa.required_terms]
    if pa.preferred_terms:
        out["preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": w, "podAffinityTerm": _encode_pod_affinity_term(t)}
            for w, t in pa.preferred_terms]
    # a present-but-empty PodAffinity must stay present ({}), not vanish —
    # decode({'podAffinity': {}}) produced it and must get it back
    return out


def encode_affinity(aff: Optional[Affinity]) -> Optional[Dict]:
    """Inverse of decode_affinity: decode(encode(x)) == x, preserving the
    nil-vs-empty distinctions the predicates read (required_terms None vs
    [], nil vs empty labelSelector)."""
    if aff is None:
        return None
    out: Dict[str, Any] = {}
    na = aff.node_affinity
    if na is not None:
        d: Dict[str, Any] = {}
        if na.required_terms is not None:
            d["requiredDuringSchedulingIgnoredDuringExecution"] = {
                "nodeSelectorTerms": [
                    {"matchExpressions":
                     _encode_requirements(t.match_expressions)}
                    for t in na.required_terms]}
        if na.preferred_terms:
            d["preferredDuringSchedulingIgnoredDuringExecution"] = [
                {"weight": w, "preference": {
                    "matchExpressions":
                    _encode_requirements(t.match_expressions)}}
                for w, t in na.preferred_terms]
        out["nodeAffinity"] = d  # {} round-trips to NodeAffinity(None, [])
    pa = _encode_pod_affinity(aff.pod_affinity)
    if pa is not None:
        out["podAffinity"] = pa
    paa = _encode_pod_affinity(aff.pod_anti_affinity)
    if paa is not None:
        out["podAntiAffinity"] = paa
    return out or None


# ---------------------------------------------------------------------------
# Pod / Node
# ---------------------------------------------------------------------------


def decode_volume(v: Dict[str, Any]) -> Volume:
    """v1 VolumeSource union -> scheduler-relevant identity
    (the sources read by predicates.go:128-374; others -> OTHER)."""
    name = v.get("name", "")
    if "gcePersistentDisk" in v:
        s = v["gcePersistentDisk"] or {}
        return Volume(name=name, kind=VolumeKind.GCE_PD,
                      volume_id=s.get("pdName", ""),
                      read_only=bool(s.get("readOnly", False)))
    if "awsElasticBlockStore" in v:
        s = v["awsElasticBlockStore"] or {}
        return Volume(name=name, kind=VolumeKind.AWS_EBS,
                      volume_id=s.get("volumeID", ""),
                      read_only=bool(s.get("readOnly", False)))
    if "rbd" in v:
        s = v["rbd"] or {}
        return Volume(name=name, kind=VolumeKind.RBD,
                      monitors=list(s.get("monitors") or []),
                      pool=s.get("pool", ""), image=s.get("image", ""),
                      read_only=bool(s.get("readOnly", False)))
    if "iscsi" in v:
        s = v["iscsi"] or {}
        return Volume(name=name, kind=VolumeKind.ISCSI,
                      volume_id=s.get("iqn", ""),
                      read_only=bool(s.get("readOnly", False)))
    if "azureDisk" in v:
        s = v["azureDisk"] or {}
        return Volume(name=name, kind=VolumeKind.AZURE_DISK,
                      volume_id=s.get("diskName", ""),
                      read_only=bool(s.get("readOnly", False)))
    if "persistentVolumeClaim" in v:
        s = v["persistentVolumeClaim"] or {}
        return Volume(name=name, kind=VolumeKind.PVC,
                      volume_id=s.get("claimName", ""),
                      read_only=bool(s.get("readOnly", False)))
    if "secret" in v:
        s = v["secret"] or {}
        return Volume(name=name, kind=VolumeKind.SECRET,
                      volume_id=s.get("secretName", ""))
    if "configMap" in v:
        s = v["configMap"] or {}
        return Volume(name=name, kind=VolumeKind.CONFIG_MAP,
                      volume_id=s.get("name", ""))
    return Volume(name=name, kind=VolumeKind.OTHER)


def encode_volume(v: Volume) -> Dict[str, Any]:
    kind = VolumeKind(v.kind)
    out: Dict[str, Any] = {"name": v.name}
    if kind == VolumeKind.GCE_PD:
        out["gcePersistentDisk"] = {"pdName": v.volume_id,
                                    "readOnly": v.read_only}
    elif kind == VolumeKind.AWS_EBS:
        out["awsElasticBlockStore"] = {"volumeID": v.volume_id,
                                       "readOnly": v.read_only}
    elif kind == VolumeKind.RBD:
        out["rbd"] = {"monitors": list(v.monitors), "pool": v.pool,
                      "image": v.image, "readOnly": v.read_only}
    elif kind == VolumeKind.ISCSI:
        out["iscsi"] = {"iqn": v.volume_id, "readOnly": v.read_only}
    elif kind == VolumeKind.AZURE_DISK:
        out["azureDisk"] = {"diskName": v.volume_id,
                            "readOnly": v.read_only}
    elif kind == VolumeKind.PVC:
        out["persistentVolumeClaim"] = {"claimName": v.volume_id,
                                        "readOnly": v.read_only}
    elif kind == VolumeKind.SECRET:
        out["secret"] = {"secretName": v.volume_id}
    elif kind == VolumeKind.CONFIG_MAP:
        out["configMap"] = {"name": v.volume_id}
    return out


def decode_pod(obj: Dict[str, Any]) -> Pod:
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    def _decode_sc(s, pod_level: bool):
        if not s:
            return None
        if pod_level:
            return PodSecurityContext(
                run_as_user=(int(s["runAsUser"])
                             if s.get("runAsUser") is not None else None),
                run_as_non_root=s.get("runAsNonRoot"))
        return SecurityContext(
            privileged=s.get("privileged"),
            run_as_user=(int(s["runAsUser"])
                         if s.get("runAsUser") is not None else None),
            run_as_non_root=s.get("runAsNonRoot"),
            read_only_root_filesystem=s.get("readOnlyRootFilesystem"))

    def _decode_probe(p):
        if not p:
            return None
        kind = "exec"
        for k in ("httpGet", "tcpSocket", "exec"):
            if p.get(k) is not None:
                kind = k
                break
        return Probe(kind=kind,
                     initial_delay_s=float(p.get("initialDelaySeconds", 0)),
                     period_s=float(p.get("periodSeconds", 10)),
                     failure_threshold=int(p.get("failureThreshold", 3)),
                     success_threshold=int(p.get("successThreshold", 1)))

    containers = []
    for c in spec.get("containers") or []:
        res = c.get("resources") or {}
        containers.append(Container(
            name=c.get("name", ""),
            image=c.get("image", ""),
            requests=decode_resource_list(res.get("requests")),
            limits=decode_resource_list(res.get("limits")),
            ports=[ContainerPort(host_port=int(p.get("hostPort", 0)),
                                 container_port=int(p.get("containerPort", 0)),
                                 protocol=p.get("protocol", "TCP"))
                   for p in c.get("ports") or []],
            liveness_probe=_decode_probe(c.get("livenessProbe")),
            readiness_probe=_decode_probe(c.get("readinessProbe")),
            security_context=_decode_sc(c.get("securityContext"), False),
        ))
    tolerations = []
    for t in spec.get("tolerations") or []:
        eff = t.get("effect") or None
        tolerations.append(Toleration(
            key=t.get("key", ""),
            operator=TolerationOperator(t.get("operator", "Equal")),
            value=t.get("value", ""),
            effect=TaintEffect(eff) if eff else None,
        ))
    owner_kind, owner_name, owner_uid = "", "", ""
    for ref in meta.get("ownerReferences") or []:
        if ref.get("controller"):
            owner_kind = ref.get("kind", "")
            owner_name = ref.get("name", "")
            owner_uid = ref.get("uid", "")
            break
    return Pod(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        uid=meta.get("uid", ""),
        labels=dict(meta.get("labels") or {}),
        annotations=dict(meta.get("annotations") or {}),
        containers=containers,
        volumes=[decode_volume(v) for v in spec.get("volumes") or []],
        node_name=spec.get("nodeName", ""),
        node_selector=dict(spec.get("nodeSelector") or {}),
        affinity=decode_affinity(spec.get("affinity")),
        tolerations=tolerations,
        scheduler_name=spec.get("schedulerName", "default-scheduler"),
        priority=int(spec.get("priority") or 0),
        restart_policy=spec.get("restartPolicy", "Always"),
        host_network=bool(spec.get("hostNetwork", False)),
        security_context=_decode_sc(spec.get("securityContext"), True),
        owner_kind=owner_kind,
        owner_name=owner_name,
        owner_uid=owner_uid,
        deleted=meta.get("deletionTimestamp") is not None,
    )


def _decode_resource(rl: Dict[str, int]) -> Resource:
    extended = {k: v for k, v in rl.items()
                if k not in ("cpu", "memory", "pods",
                             "nvidia.com/gpu", "alpha.kubernetes.io/nvidia-gpu",
                             "storage.kubernetes.io/scratch",
                             "storage.kubernetes.io/overlay")}
    return Resource(
        milli_cpu=rl.get("cpu", 0),
        memory=rl.get("memory", 0),
        nvidia_gpu=rl.get("nvidia.com/gpu",
                          rl.get("alpha.kubernetes.io/nvidia-gpu", 0)),
        storage_scratch=rl.get("storage.kubernetes.io/scratch", 0),
        storage_overlay=rl.get("storage.kubernetes.io/overlay", 0),
        extended=extended,
    )


def decode_node(obj: Dict[str, Any]) -> Node:
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    alloc_rl = decode_resource_list(status.get("allocatable")
                                    or status.get("capacity"))
    alloc = _decode_resource(alloc_rl)
    taints = []
    for t in spec.get("taints") or []:
        taints.append(Taint(t.get("key", ""), t.get("value", ""),
                            TaintEffect(t.get("effect", "NoSchedule"))))
    conditions = [NodeCondition(c.get("type", ""), c.get("status", "Unknown"))
                  for c in status.get("conditions") or []]
    # a capacity distinct from allocatable (node-allocatable reservation)
    capacity = None
    if status.get("capacity") and status.get("allocatable") \
            and status["capacity"] != status["allocatable"]:
        capacity = _decode_resource(
            decode_resource_list(status["capacity"]))
    return Node(
        name=meta.get("name", ""),
        labels=dict(meta.get("labels") or {}),
        annotations=dict(meta.get("annotations") or {}),
        allocatable=alloc,
        capacity=capacity,
        allowed_pod_number=alloc_rl.get("pods", 110),
        taints=taints,
        unschedulable=bool(spec.get("unschedulable", False)),
        conditions=conditions,
    )


def encode_pod(pod: Pod) -> Dict[str, Any]:
    """Inverse of decode_pod over the full spec surface it reads —
    decode(encode(p)) == p for every wire-carried field (the codec
    round-trip invariant the core-group conversion tests pin)."""
    def _enc_sc(s) -> Optional[Dict[str, Any]]:
        if s is None:
            return None
        out = {}
        if getattr(s, "privileged", None) is not None:
            out["privileged"] = s.privileged
        if s.run_as_user is not None:
            out["runAsUser"] = s.run_as_user
        if s.run_as_non_root is not None:
            out["runAsNonRoot"] = s.run_as_non_root
        if getattr(s, "read_only_root_filesystem", None) is not None:
            out["readOnlyRootFilesystem"] = s.read_only_root_filesystem
        return out or None

    def _enc_rl(rl: Dict[str, int]) -> Dict[str, str]:
        return {k: (f"{v}m" if k == "cpu" else str(v))
                for k, v in rl.items()}

    def _enc_probe(p) -> Optional[Dict[str, Any]]:
        if p is None:
            return None
        return {p.kind: {},
                "initialDelaySeconds": p.initial_delay_s,
                "periodSeconds": p.period_s,
                "failureThreshold": p.failure_threshold,
                "successThreshold": p.success_threshold}

    containers = []
    for c in pod.containers:
        enc = {
            "name": c.name, "image": c.image,
            "resources": {"requests": _enc_rl(c.requests),
                          **({"limits": _enc_rl(c.limits)}
                             if c.limits else {})},
            "ports": [{"hostPort": p.host_port, "containerPort": p.container_port,
                       "protocol": p.protocol} for p in c.ports],
        }
        lp = _enc_probe(c.liveness_probe)
        if lp:
            enc["livenessProbe"] = lp
        rp = _enc_probe(c.readiness_probe)
        if rp:
            enc["readinessProbe"] = rp
        csc = _enc_sc(c.security_context)
        if csc:
            enc["securityContext"] = csc
        containers.append(enc)
    spec: Dict[str, Any] = {
        "containers": containers, "nodeName": pod.node_name,
        "nodeSelector": pod.node_selector,
        "schedulerName": pod.scheduler_name,
        "restartPolicy": pod.restart_policy,
        "volumes": [encode_volume(v) for v in pod.volumes]}
    if pod.priority:
        spec["priority"] = pod.priority
    if pod.tolerations:
        spec["tolerations"] = [
            {"key": t.key,
             "operator": t.operator.value
             if hasattr(t.operator, "value") else t.operator,
             "value": t.value,
             **({"effect": t.effect.value
                 if hasattr(t.effect, "value") else t.effect}
                if t.effect else {})}
            for t in pod.tolerations]
    aff = encode_affinity(pod.affinity)
    if aff is not None:
        spec["affinity"] = aff
    if pod.host_network:
        spec["hostNetwork"] = True
    psc = _enc_sc(pod.security_context)
    if psc:
        spec["securityContext"] = psc
    meta: Dict[str, Any] = {
        "name": pod.name, "namespace": pod.namespace,
        "uid": pod.uid, "labels": pod.labels}
    if pod.annotations:
        meta["annotations"] = dict(pod.annotations)
    if pod.owner_kind:
        meta["ownerReferences"] = [{
            "kind": pod.owner_kind, "name": pod.owner_name,
            "uid": pod.owner_uid, "controller": True}]
    if pod.deleted:
        meta["deletionTimestamp"] = "1970-01-01T00:00:00Z"
    return {"metadata": meta, "spec": spec}


def _encode_resource_list(res, pods: int) -> Dict[str, str]:
    out = {"cpu": f"{res.milli_cpu}m",
           "memory": str(res.memory),
           "pods": str(pods)}
    if res.nvidia_gpu:
        out["nvidia.com/gpu"] = str(res.nvidia_gpu)
    for k, v in res.extended.items():
        out[k] = str(v)
    return out


def encode_node(node: Node) -> Dict[str, Any]:
    alloc = _encode_resource_list(node.allocatable,
                                  node.allowed_pod_number)
    meta: Dict[str, Any] = {"name": node.name, "labels": node.labels}
    if node.annotations:
        meta["annotations"] = dict(node.annotations)
    return {
        "metadata": meta,
        "spec": {
            "unschedulable": node.unschedulable,
            "taints": [{"key": t.key, "value": t.value,
                        "effect": (t.effect.value if isinstance(t.effect, TaintEffect)
                                   else t.effect)} for t in node.taints],
        },
        "status": {
            "allocatable": alloc,
            **({"capacity": _encode_resource_list(
                node.capacity, node.allowed_pod_number)}
               if node.capacity is not None else {}),
            "conditions": [{"type": c.type,
                            "status": (c.status.value if hasattr(c.status, "value")
                                       else c.status)}
                           for c in node.conditions],
        },
    }
