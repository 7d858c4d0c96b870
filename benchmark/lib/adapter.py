"""The benchmark's plain inputs as the program's objects."""

import copy

from benchmark.gen.cluster import HOSTNAME_KEY, ZONE_KEY


def port_nodes(cluster):
    from kubernetes_tpu_torch.api.types import make_node
    return [make_node(name, cpu=int(cluster.cpu[i]),
                      memory=int(cluster.mem[i]), pods=int(cluster.pods[i]),
                      labels={HOSTNAME_KEY: name,
                              ZONE_KEY: cluster.zones[int(cluster.zone[i])]})
            for i, name in enumerate(cluster.names)]


def _affinity(t):
    from kubernetes_tpu_torch.api.types import (Affinity, LabelSelector,
                                                PodAffinity, PodAffinityTerm)
    if not (t.anti or t.aff):
        return None

    def terms(ts):
        return PodAffinity(required_terms=[PodAffinityTerm(
            label_selector=LabelSelector(match_labels=dict(sel)),
            namespaces=[], topology_key=key) for sel, key in ts]) \
            if ts else None
    return Affinity(pod_affinity=terms(t.aff),
                    pod_anti_affinity=terms(t.anti))


class PodMaker:
    """The program's Pod for pod i of `podset`, made when asked: a template
    object per template, shallow-copied per pod with its own identity
    (name, uid, labels, annotations); the spec members stay shared, as
    every consumer treats a pod's spec as read-only."""

    def __init__(self, podset):
        from kubernetes_tpu_torch.api.types import make_pod
        self.podset = podset
        self.protos = []
        for i, t in enumerate(podset.templates):
            p = make_pod(f"template-{i}", namespace=podset.namespace,
                         cpu=t.cpu, memory=t.mem, labels=dict(t.labels))
            p.affinity = _affinity(t)
            self.protos.append(p)
        self.tmpl = podset.tmpl.tolist()

    def __call__(self, i: int):
        proto = self.protos[self.tmpl[i]]
        name = self.podset.names[i]
        p = copy.copy(proto)
        p.name = name
        p.uid = f"{self.podset.namespace}/{name}"
        p.labels = dict(proto.labels)
        p.annotations = {}
        p.__dict__.pop("_class_key", None)
        return p


def port_pods(podset):
    """Every pod of `podset` as the program's Pod (PodMaker)."""
    make = PodMaker(podset)
    return [make(i) for i in range(len(podset))]
