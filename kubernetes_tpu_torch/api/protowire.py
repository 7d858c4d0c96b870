"""Binary (protobuf) codec for bulk Node/Pod transfer — the fast path of
the extender's cache sync beside the JSON contract (SURVEY §5.8; the
reference ships protobuf for every API group via generated.proto and
selects it with --kube-api-content-type, cmd/kubemark/hollow-node.go:71).

Conversion covers exactly the scheduling-read field surface (everything
state/snapshot.py and ops/* consume, including the full affinity tree);
status/runtime-only fields stay on the JSON path. The proto definition is
proto/ktpb.proto; kubernetes_tpu_torch/api/pb generates bindings on demand.
"""

from __future__ import annotations

from typing import List, Optional

from kubernetes_tpu_torch.api import pb
from kubernetes_tpu_torch.api.types import (
    Affinity,
    ConditionStatus,
    Container,
    ContainerImage,
    ContainerPort,
    LabelSelector,
    Node,
    NodeAffinity,
    NodeCondition,
    NodeSelectorTerm,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    Resource,
    SelectorOperator,
    SelectorRequirement,
    Taint,
    TaintEffect,
    Toleration,
    TolerationOperator,
    Volume,
    VolumeKind,
)

CONTENT_TYPE = "application/vnd.ktpb.v1+protobuf"


def available() -> bool:
    return pb.load() is not None


# ------------------------------------------------------------------- nodes


def encode_nodes(nodes: List[Node]) -> bytes:
    m = pb.load()
    out = m.NodeList()
    for n in nodes:
        p = out.items.add()
        p.name = n.name
        p.labels.update(n.labels)
        p.annotations.update(n.annotations)
        a = n.allocatable
        p.milli_cpu = a.milli_cpu
        p.memory = a.memory
        p.nvidia_gpu = a.nvidia_gpu
        p.storage_scratch = a.storage_scratch
        p.storage_overlay = a.storage_overlay
        p.extended.update(a.extended)
        p.allowed_pod_number = n.allowed_pod_number
        p.unschedulable = n.unschedulable
        for t in n.taints:
            pt = p.taints.add()
            pt.key = t.key
            pt.value = t.value
            pt.effect = t.effect.value if isinstance(t.effect, TaintEffect) \
                else str(t.effect)
        for c in n.conditions:
            pc = p.conditions.add()
            pc.type = c.type
            pc.status = c.status.value if hasattr(c.status, "value") \
                else str(c.status)
        p.heartbeat = n.heartbeat
        for img in n.images:
            pi = p.images.add()
            pi.names.extend(img.names)
            pi.size_bytes = img.size_bytes
    return out.SerializeToString()


def decode_nodes(data: bytes) -> List[Node]:
    m = pb.load()
    lst = m.NodeList()
    lst.ParseFromString(data)
    out = []
    for p in lst.items:
        node = Node(
            name=p.name,
            labels=dict(p.labels),
            annotations=dict(p.annotations),
            allocatable=Resource(
                milli_cpu=p.milli_cpu, memory=p.memory,
                nvidia_gpu=p.nvidia_gpu,
                storage_scratch=p.storage_scratch,
                storage_overlay=p.storage_overlay,
                extended=dict(p.extended)),
            allowed_pod_number=p.allowed_pod_number,
            unschedulable=p.unschedulable,
            taints=[Taint(t.key, t.value, TaintEffect(t.effect))
                    for t in p.taints],
            conditions=[NodeCondition(c.type, ConditionStatus(c.status))
                        for c in p.conditions],
            heartbeat=p.heartbeat,
            images=[ContainerImage(list(i.names), i.size_bytes)
                    for i in p.images],
        )
        out.append(node)
    return out


# -------------------------------------------------------------------- pods


def _enc_reqs(dst, reqs: List[SelectorRequirement]) -> None:
    for r in reqs:
        pr = dst.add()
        pr.key = r.key
        pr.operator = r.operator.value \
            if isinstance(r.operator, SelectorOperator) else str(r.operator)
        pr.values.extend(r.values)


def _dec_reqs(src) -> List[SelectorRequirement]:
    return [SelectorRequirement(r.key, SelectorOperator(r.operator),
                                list(r.values)) for r in src]


def _enc_pod_term(dst, t: PodAffinityTerm) -> None:
    if t.label_selector is not None:
        dst.has_selector = True
        dst.label_selector.match_labels.update(t.label_selector.match_labels)
        _enc_reqs(dst.label_selector.match_expressions,
                  t.label_selector.match_expressions)
    dst.namespaces.extend(t.namespaces)
    dst.topology_key = t.topology_key


def _dec_pod_term(src) -> PodAffinityTerm:
    sel = None
    if src.has_selector:
        sel = LabelSelector(
            match_labels=dict(src.label_selector.match_labels),
            match_expressions=_dec_reqs(
                src.label_selector.match_expressions))
    return PodAffinityTerm(label_selector=sel,
                           namespaces=list(src.namespaces),
                           topology_key=src.topology_key)


def _enc_pod_affinity(dst, pa: PodAffinity) -> None:
    for t in pa.required_terms:
        _enc_pod_term(dst.required_terms.add(), t)
    for w, t in pa.preferred_terms:
        wt = dst.preferred_terms.add()
        wt.weight = w
        _enc_pod_term(wt.term, t)


def _dec_pod_affinity(src) -> PodAffinity:
    return PodAffinity(
        required_terms=[_dec_pod_term(t) for t in src.required_terms],
        preferred_terms=[(wt.weight, _dec_pod_term(wt.term))
                         for wt in src.preferred_terms])


def _enc_affinity(dst, aff: Affinity) -> None:
    na = aff.node_affinity
    if na is not None:
        dst.has_node_affinity = True
        if na.required_terms is not None:
            dst.node_affinity.has_required = True
            for t in na.required_terms:
                _enc_reqs(dst.node_affinity.required_terms.add()
                          .match_expressions, t.match_expressions)
        for w, t in na.preferred_terms:
            wt = dst.node_affinity.preferred_terms.add()
            wt.weight = w
            _enc_reqs(wt.term.match_expressions, t.match_expressions)
    if aff.pod_affinity is not None:
        dst.has_pod_affinity = True
        _enc_pod_affinity(dst.pod_affinity, aff.pod_affinity)
    if aff.pod_anti_affinity is not None:
        dst.has_pod_anti_affinity = True
        _enc_pod_affinity(dst.pod_anti_affinity, aff.pod_anti_affinity)


def _dec_affinity(src) -> Affinity:
    na = None
    if src.has_node_affinity:
        req = None
        if src.node_affinity.has_required:
            req = [NodeSelectorTerm(_dec_reqs(t.match_expressions))
                   for t in src.node_affinity.required_terms]
        na = NodeAffinity(
            required_terms=req,
            preferred_terms=[
                (wt.weight,
                 NodeSelectorTerm(_dec_reqs(wt.term.match_expressions)))
                for wt in src.node_affinity.preferred_terms])
    return Affinity(
        node_affinity=na,
        pod_affinity=_dec_pod_affinity(src.pod_affinity)
        if src.has_pod_affinity else None,
        pod_anti_affinity=_dec_pod_affinity(src.pod_anti_affinity)
        if src.has_pod_anti_affinity else None)


def encode_pods(pods: List[Pod]) -> bytes:
    m = pb.load()
    out = m.PodList()
    for pod in pods:
        p = out.items.add()
        p.name = pod.name
        p.namespace = pod.namespace
        p.uid = pod.uid
        p.labels.update(pod.labels)
        p.annotations.update(pod.annotations)
        for c in pod.containers:
            pc = p.containers.add()
            pc.name = c.name
            pc.image = c.image
            pc.requests.update(c.requests)
            pc.limits.update(c.limits)
            for port in c.ports:
                pp = pc.ports.add()
                pp.host_port = port.host_port
                pp.container_port = port.container_port
                pp.protocol = port.protocol
        for v in pod.volumes:
            pv = p.volumes.add()
            pv.name = v.name
            pv.kind = v.kind.value if hasattr(v.kind, "value") else str(v.kind)
            pv.volume_id = v.volume_id
            pv.read_only = v.read_only
            pv.monitors.extend(v.monitors)
            pv.pool = v.pool
            pv.image = v.image
        p.node_name = pod.node_name
        p.node_selector.update(pod.node_selector)
        if pod.affinity is not None:
            p.has_affinity = True
            _enc_affinity(p.affinity, pod.affinity)
        for t in pod.tolerations:
            pt = p.tolerations.add()
            pt.key = t.key
            pt.operator = t.operator.value \
                if isinstance(t.operator, TolerationOperator) else str(t.operator)
            pt.value = t.value
            if t.effect is not None:
                pt.effect = t.effect.value \
                    if isinstance(t.effect, TaintEffect) else str(t.effect)
        p.scheduler_name = pod.scheduler_name
        p.priority = pod.priority
        p.phase = pod.phase
        p.owner_kind = pod.owner_kind
        p.owner_name = pod.owner_name
        p.owner_uid = pod.owner_uid
        p.deleted = pod.deleted
    return out.SerializeToString()


def decode_pods(data: bytes) -> List[Pod]:
    m = pb.load()
    lst = m.PodList()
    lst.ParseFromString(data)
    out = []
    for p in lst.items:
        pod = Pod(
            name=p.name,
            namespace=p.namespace,
            uid=p.uid,
            labels=dict(p.labels),
            annotations=dict(p.annotations),
            containers=[Container(
                name=c.name, image=c.image,
                requests=dict(c.requests), limits=dict(c.limits),
                ports=[ContainerPort(pp.host_port, pp.container_port,
                                     pp.protocol) for pp in c.ports])
                for c in p.containers],
            volumes=[Volume(name=v.name, kind=VolumeKind(v.kind),
                            volume_id=v.volume_id, read_only=v.read_only,
                            monitors=list(v.monitors), pool=v.pool,
                            image=v.image) for v in p.volumes],
            node_name=p.node_name,
            node_selector=dict(p.node_selector),
            affinity=_dec_affinity(p.affinity) if p.has_affinity else None,
            tolerations=[Toleration(
                t.key, TolerationOperator(t.operator), t.value,
                TaintEffect(t.effect) if t.effect else None)
                for t in p.tolerations],
            scheduler_name=p.scheduler_name,
            priority=p.priority,
            phase=p.phase or "Pending",
            owner_kind=p.owner_kind,
            owner_name=p.owner_name,
            owner_uid=p.owner_uid,
            deleted=p.deleted,
        )
        out.append(pod)
    return out
