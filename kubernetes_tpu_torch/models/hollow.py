"""Hollow-cluster generator: the kubemark-equivalent load rig.

The reference benchmarks against (a) scheduler_perf's fake nodes/pods
(test/integration/scheduler_perf/scheduler_test.go:42-68: 4 CPU / 32Gi /
110-pod nodes, trivial pods) and (b) kubemark hollow nodes
(cmd/kubemark/hollow-node.go — real kubelet logic, faked externalities).
This module generates equivalent synthetic clusters and the workload profiles
of BASELINE.json's five configs, loaded through the apiserver-lite.
"""

from __future__ import annotations

import copy
import random
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import (
    Affinity,
    LabelSelector,
    Node,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    Taint,
    TaintEffect,
    Toleration,
    TolerationOperator,
    make_node,
    make_pod,
)
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite

Mi = 1024 * 1024
Gi = 1024 * Mi

ZONES = ["zone-a", "zone-b", "zone-c"]


# ------------------------------------------------------------- columnar
# at 50k nodes / 300k pods the per-object constructor path
# (make_pod -> Container -> Pod, ~20us each) costs seconds of pure
# setup per sweep point — enough to drown the measurement it feeds. The
# bulk builders go columnar: ONE template object per distinct spec,
# then a tight shallow-copy materialization per name. The templates'
# spec members (containers, tolerations, condition lists) are shared —
# every consumer treats pod/node SPEC as immutable (the churn harness
# rebuilds via dataclasses.replace; schedulers write only node_name /
# annotations, which each copy owns fresh).


def _stamp(p: Pod, name: str, prefix: str,
           labels: Optional[Dict[str, str]] = None) -> Pod:
    """Fresh per-pod identity on a shallow template copy (name, uid,
    labels, annotations); spec members stay shared with the template.
    The class-key memo pops are LOAD-BEARING: a copied template would
    otherwise keep the template's memoized class key and silently
    misclassify every pod of the profile."""
    p.name = name
    p.uid = prefix + name
    p.labels = {} if labels is None else labels
    p.annotations = {}
    d = p.__dict__
    d.pop("_class_key", None)
    d.pop("_class_node", None)
    return p


def _materialize_pods(template: Pod, names: List[str], namespace: str,
                      labels: Optional[List[Dict[str, str]]] = None
                      ) -> List[Pod]:
    """Shallow-copy `template` per name; per-pod identity fields (name,
    uid, labels, annotations) are fresh, spec members shared."""
    prefix = namespace + "/"
    cc = copy.copy
    return [_stamp(cc(template), nm, prefix,
                   labels[i] if labels is not None else None)
            for i, nm in enumerate(names)]


def hollow_nodes(n: int, seed: int = 0, heterogeneous: bool = False,
                 gpu_fraction: float = 0.0, taint_fraction: float = 0.0
                 ) -> List[Node]:
    """scheduler_perf node shape by default (scheduler_test.go:49-68).
    The homogeneous no-gpu/no-taint shape (every scale sweep point)
    materializes from one template columnar-style; heterogeneous/gpu/
    tainted clusters keep the per-node constructor (seeded rng per
    node — identical output to every prior round)."""
    if not heterogeneous and gpu_fraction == 0.0 and taint_fraction == 0.0:
        template = make_node("hollow-node-0", cpu=4000, memory=32 * Gi,
                             pods=110)
        out: List[Node] = []
        cc = copy.copy
        for i in range(n):
            node = cc(template)
            node.name = f"hollow-node-{i}"
            node.labels = {
                "kubernetes.io/hostname": node.name,
                "failure-domain.beta.kubernetes.io/zone":
                    ZONES[i % len(ZONES)],
            }
            out.append(node)
        return out
    rng = random.Random(seed)
    nodes = []
    for i in range(n):
        if heterogeneous:
            cpu = rng.choice([2000, 4000, 8000, 16000, 32000])
            mem = rng.choice([8, 16, 32, 64, 128]) * Gi
        else:
            cpu, mem = 4000, 32 * Gi
        gpu = 8 if rng.random() < gpu_fraction else 0
        taints = []
        if gpu and taint_fraction:
            taints.append(Taint("nvidia.com/gpu", "present", TaintEffect.NO_SCHEDULE))
        elif rng.random() < taint_fraction:
            taints.append(Taint("dedicated", "infra", TaintEffect.NO_SCHEDULE))
        labels = {
            "kubernetes.io/hostname": f"hollow-node-{i}",
            "failure-domain.beta.kubernetes.io/zone": ZONES[i % len(ZONES)],
        }
        if gpu:
            labels["accelerator"] = "nvidia"
        nodes.append(make_node(f"hollow-node-{i}", cpu=cpu, memory=mem, pods=110,
                               gpu=gpu, labels=labels, taints=taints))
    return nodes


def density_pods(n: int, seed: int = 0, namespace: str = "bench") -> List[Pod]:
    """Config 1: uniform small pods (the 'nginx' density workload —
    scheduler_perf creates pods with no requests; we give them the classic
    100m/500Mi shape so bin-packing is exercised). Columnar: one spec
    template, shallow-copied per name."""
    template = make_pod("density-0", namespace=namespace, cpu=100,
                        memory=500 * Mi)
    return _materialize_pods(template, [f"density-{i}" for i in range(n)],
                             namespace)


def binpack_pods(n: int, seed: int = 0, namespace: str = "bench") -> List[Pod]:
    """Config 2: mixed-size pods for PodFitsResources + BalancedResourceAllocation.
    Columnar: one template per shape, rng draws the shape sequence only."""
    rng = random.Random(seed)
    shapes = [(100, 128 * Mi), (250, 512 * Mi), (500, 1 * Gi), (1000, 2 * Gi),
              (2000, 4 * Gi)]
    templates = [make_pod(f"binpack-shape-{j}", namespace=namespace,
                          cpu=cpu, memory=mem)
                 for j, (cpu, mem) in enumerate(shapes)]
    prefix = namespace + "/"
    cc = copy.copy
    return [_stamp(cc(templates[rng.randrange(len(shapes))]),
                   f"binpack-{i}", prefix)
            for i in range(n)]


def affinity_pods(n: int, seed: int = 0, namespace: str = "bench") -> List[Pod]:
    """Config 3: selector/affinity-heavy (zone spreads via node selectors;
    inter-pod affinity lands when that kernel arrives)."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        pod = make_pod(f"affinity-{i}", namespace=namespace, cpu=100, memory=256 * Mi,
                       labels={"app": f"svc-{i % 20}"})
        if rng.random() < 0.5:
            pod.node_selector = {
                "failure-domain.beta.kubernetes.io/zone": rng.choice(ZONES)}
        out.append(pod)
    return out


HOSTNAME_KEY = "kubernetes.io/hostname"
ZONE_KEY = "failure-domain.beta.kubernetes.io/zone"


def mixed_affinity_pods(n: int, seed: int = 0,
                        namespace: str = "bench") -> List[Pod]:
    """The headline affinity mix: a density drain where required pod
    (anti-)affinity is a first-class share of the load instead of a
    corner case.

      15%  "one replica per host": required anti-affinity on the hostname
           key against the pod's own app label (6 apps) — the shape the
           wave path's per-topology occupancy counters absorb.
       2%  "pack into one zone": required affinity on the zone key against
           the pod's own app (4 apps) — zone domains span many nodes and
           the group bootstraps from nothing, so these route to the
           seeded strict tail, never the throughput path.
       5%  plain pods LABELED like the anti apps — anti-affinity TARGETS:
           their placements must respect the symmetry check against every
           committed iso pod (predicates.go:1146) per wave.
      78%  plain density pods (distinct app labels, no interactions).
    """
    # columnar: one template per (kind, app) — the Affinity objects are
    # shared per app (spec, read-only to every consumer)
    t_small = make_pod("mixed-t0", namespace=namespace, cpu=100,
                       memory=256 * Mi)
    t_big = make_pod("mixed-t1", namespace=namespace, cpu=100,
                     memory=500 * Mi)
    iso_aff = {}
    for a in range(6):
        app = f"iso-{a}"
        iso_aff[app] = Affinity(pod_anti_affinity=PodAffinity(
            required_terms=[PodAffinityTerm(
                label_selector=LabelSelector(match_labels={"app": app}),
                namespaces=[], topology_key=HOSTNAME_KEY)]))
    pack_aff = {}
    for a in range(4):
        app = f"pack-{a}"
        pack_aff[app] = Affinity(pod_affinity=PodAffinity(
            required_terms=[PodAffinityTerm(
                label_selector=LabelSelector(match_labels={"app": app}),
                namespaces=[], topology_key=ZONE_KEY)]))
    prefix = namespace + "/"
    out: List[Pod] = []
    cc = copy.copy
    for i in range(n):
        r = i % 100
        if r < 15:
            app = f"iso-{r % 6}"
            p = _stamp(cc(t_small), f"mixed-iso-{i}", prefix,
                       {"app": app})
            p.affinity = iso_aff[app]
        elif r < 17:
            app = f"pack-{i % 4}"
            p = _stamp(cc(t_small), f"mixed-pack-{i}", prefix,
                       {"app": app})
            p.affinity = pack_aff[app]
        elif r < 22:
            p = _stamp(cc(t_big), f"mixed-tgt-{i}", prefix,
                       {"app": f"iso-{r % 6}"})
        else:
            p = _stamp(cc(t_big), f"mixed-web-{i}", prefix,
                       {"app": f"web-{i % 8}"})
        out.append(p)
    return out


def churn_pods(n: int, seed: int = 0, namespace: str = "bench") -> List[Pod]:
    """The churn-hardening mix: the density stream with enough
    affinity structure that node churn exercises every invalidation path
    instead of only capacity rows.

       6%  "one replica per host" anti-affinity pods (4 apps) — their
           topology views are what Protean delta-patching protects; a
           node kill mid-wave is what the liveness fence protects.
      10%  plain pods LABELED like the anti apps — anti-affinity TARGETS:
           their churn (binds, evictions) is the patchable foreign-event
           stream (a plain target entering/leaving a node patches one
           forbid row; it must NOT rebuild AffinityData wholesale).
      84%  plain density pods — the no-op patch majority.
    """
    t_small = make_pod("churn-t0", namespace=namespace, cpu=100,
                       memory=256 * Mi)
    t_big = make_pod("churn-t1", namespace=namespace, cpu=100,
                     memory=500 * Mi)
    anti_aff = {}
    for a in range(4):
        app = f"churn-iso-{a}"
        anti_aff[app] = Affinity(pod_anti_affinity=PodAffinity(
            required_terms=[PodAffinityTerm(
                label_selector=LabelSelector(match_labels={"app": app}),
                namespaces=[], topology_key=HOSTNAME_KEY)]))
    prefix = namespace + "/"
    out: List[Pod] = []
    cc = copy.copy
    for i in range(n):
        r = i % 100
        if r < 6:
            app = f"churn-iso-{r % 4}"
            p = _stamp(cc(t_small), f"churn-anti-{i}", prefix,
                       {"app": app})
            p.affinity = anti_aff[app]
        elif r < 16:
            p = _stamp(cc(t_big), f"churn-tgt-{i}", prefix,
                       {"app": f"churn-iso-{r % 4}"})
        else:
            p = _stamp(cc(t_big), f"churn-web-{i}", prefix,
                       {"app": f"web-{i % 8}"})
        out.append(p)
    return out


# Borg-shaped priority bands: free/best-effort, batch,
# prod, system — the four-tier shape PAPERS.md §Borg describes. Values
# spread far apart so the bands are unambiguous in audits.
PRIORITY_BANDS = {"free": 0, "batch": 100, "prod": 1000, "system": 10000}


def priority_churn_pods(n: int, seed: int = 0,
                        namespace: str = "bench") -> List[Pod]:
    """The overcommit mix: the arrival stream that makes
    displacement load-bearing. Offered against a deliberately
    UNDERSIZED cluster, the low bands fill it first and the high bands
    can only land by evicting — every preemption path (device victim
    scan, atomic evict+bind, victim requeue-and-age) runs at rate.

      45%  free (priority 0)      — the evictable floor; 200m/256Mi
      30%  batch (priority 100)   — evicts free when the cluster fills
      20%  prod (priority 1000)   — evicts batch and free
       5%  system (priority 10000) — evicts everything below

    Interleaved by index so bands arrive MIXED (a high-band pod is
    always chasing capacity the earlier low-band stream consumed).
    Columnar like every other profile: one template per band, shallow
    copies, priorities part of the spec class key."""
    templates = {}
    for band, prio in PRIORITY_BANDS.items():
        t = make_pod(f"prio-{band}-0", namespace=namespace, cpu=200,
                     memory=256 * Mi)
        t.priority = prio
        t.priority_class = band
        templates[band] = t
    prefix = namespace + "/"
    out: List[Pod] = []
    cc = copy.copy
    for i in range(n):
        r = i % 100
        if r < 45:
            band = "free"
        elif r < 75:
            band = "batch"
        elif r < 95:
            band = "prod"
        else:
            band = "system"
        p = _stamp(cc(templates[band]), f"prio-{band}-{i}", prefix,
                   {"band": band})
        out.append(p)
    return out


def hetero_gpu_pods(n: int, seed: int = 0, namespace: str = "bench") -> List[Pod]:
    """Config 5: GPU/extended-resource requests + tolerations on 10k
    heterogeneous nodes."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        if rng.random() < 0.3:
            pod = make_pod(f"hetero-{i}", namespace=namespace, cpu=1000,
                           memory=4 * Gi, gpu=rng.choice([1, 2, 4, 8]))
            pod.tolerations = [Toleration("nvidia.com/gpu",
                                          TolerationOperator.EXISTS, "", None)]
        else:
            pod = make_pod(f"hetero-{i}", namespace=namespace,
                           cpu=rng.choice([100, 500, 2000]),
                           memory=rng.choice([256 * Mi, 1 * Gi, 8 * Gi]))
        out.append(pod)
    return out


def gang_pods(n: int, seed: int = 0, namespace: str = "bench",
              gang_size: int = 8) -> List[Pod]:
    """BASELINE.json config 4: coscheduled batch jobs — n pods in gangs of
    `gang_size` (scheduling.k8s.io/group-name), all-or-nothing placement.
    Every ~16th gang is provably infeasible (one member requests more CPU
    than any node has) so atomic rollback is exercised, not just the happy
    path."""
    from kubernetes_tpu_torch.engine.gang import (
        GANG_MIN_AVAILABLE_ANNOTATION,
        GANG_NAME_ANNOTATION,
    )
    out: List[Pod] = []
    rng = random.Random(seed)
    n_gangs = (n + gang_size - 1) // gang_size
    for g in range(n_gangs):
        infeasible = g % 16 == 15
        for m in range(min(gang_size, n - g * gang_size)):
            cpu = 100 if not (infeasible and m == 0) else 1_000_000
            pod = make_pod(f"gang-{g:04d}-{m:02d}", namespace=namespace,
                           cpu=cpu, memory=128 * Mi,
                           labels={"job": f"job-{g:04d}"})
            pod.annotations[GANG_NAME_ANNOTATION] = f"job-{g:04d}"
            pod.annotations[GANG_MIN_AVAILABLE_ANNOTATION] = str(
                min(gang_size, n - g * gang_size))
            out.append(pod)
    rng.shuffle(out)  # members arrive interleaved, like real job storms
    return out


def gang_mix_pods(n: int, seed: int = 0,
                  namespace: str = "bench") -> List[Pod]:
    """The gang storm: ~20% of the pods arrive in 8–64-member gangs
    (scheduling.k8s.io/group-name with a FULL-SIZE quorum annotation — the
    strictest all-or-nothing contract); the rest is the `mixed_affinity`
    stream (hostname anti, zone co-location groups, symmetry targets,
    density). The blend is the point: when a gang-bearing chunk flushes
    the pipeline (the older routing), it drags the stream's
    affinity classes back through the CLASSIC path — per-chunk
    AffinityData rebuilds and the full-label-axis strict scan, the exact
    costs PROFILE_r08 measured as the PR-start collapse — so "gangs stop
    flushing" is worth far more than the gangs themselves. Every gang pod
    shares ONE spec class (annotations are identity, not spec —
    state/classes.pod_class_key), so the wave encoding's class axis stays
    flat no matter how many gangs ride a chunk; the shuffle interleaves
    members across arrival order, so gangs complete their quorum
    mid-drain and join whatever chunk releases them."""
    from kubernetes_tpu_torch.engine.gang import (
        GANG_MIN_AVAILABLE_ANNOTATION,
        GANG_NAME_ANNOTATION,
    )
    rng = random.Random(seed)
    sizes = [8, 16, 32, 64]
    n_gang = n // 5
    out: List[Pod] = []
    g = 0
    i = 0
    while i < n_gang:
        size = min(sizes[g % len(sizes)], n_gang - i)
        for m in range(size):
            p = make_pod(f"gmix-gang-{g:04d}-{m:02d}", namespace=namespace,
                         cpu=100, memory=256 * Mi, labels={"app": "gangmix"})
            p.annotations[GANG_NAME_ANNOTATION] = f"gmix-{g:04d}"
            p.annotations[GANG_MIN_AVAILABLE_ANNOTATION] = str(size)
            out.append(p)
        i += size
        g += 1
    out.extend(mixed_affinity_pods(n - n_gang, seed=seed,
                                   namespace=namespace))
    rng.shuffle(out)  # members arrive interleaved, like real job storms
    return out


PROFILES = {
    "density": density_pods,
    "binpack": binpack_pods,
    "affinity": affinity_pods,
    "mixed_affinity": mixed_affinity_pods,
    "churn": churn_pods,
    "priority_churn": priority_churn_pods,
    "hetero": hetero_gpu_pods,
    "gang": gang_pods,
    "gang_mix": gang_mix_pods,
}


def load_cluster(api: ApiServerLite, nodes: List[Node], pods: List[Pod]) -> None:
    for node in nodes:
        api.create("Node", node)
    for pod in pods:
        api.create("Pod", pod)
