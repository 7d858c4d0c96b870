"""The reference's kernel-versus-oracle tables on both packages: the
predicate tables (tests/test_predicates_kernel.py), the priority tables
(tests/test_priorities_kernel.py), NodeAffinity, PreferAvoidPods,
ImageLocality, SelectorSpread and the inter-pod tables
(tests/test_priorities_ext.py) and the volume predicates with their
kernel table (tests/test_volumes.py). Each body is the reference's, with
its imports through the `k` fixture and every port entry point on the
CPU. The reference's `k` hands the bodies the reference's own table
helpers; the port's hands them tests/torch_tables.py's, which hold every
(pod, node) verdict and score equal to the reference's helper on the
reference's twins of the same objects, and route the inter-pod oracle
answers through the fused verdict as well.

The reference is imported only when a case asks for it, so chip_smoke.py
runs these bodies on the card (`port_tables`) with neither JAX nor the
reference importable."""

from __future__ import annotations

import functools
import importlib
import json
import random

import numpy as np
import pytest

from tests.torch_packages import PORT, REF, Pkg, twin

MODULES = {
    "api_types": "api.types",
    "engine_batch": "engine.batch",
    "engine_scheduler_engine": "engine.scheduler_engine",
    "ops_oracle_ext": "ops.oracle_ext",
    "oracle": "ops.oracle",
    "ov": "ops.oracle_volumes",
    "features": "utils.features",
    "state_cache": "state.cache",
    "state_node_info": "state.node_info",
    "state_snapshot": "state.snapshot",
    "state_volumes": "state.volumes",
}


HELPER_NAMES = ("Gi", "Mi", "random_nodes", "random_pod")


def _shared(root):
    """Names of the bodies that several modules bind: test_volumes takes
    its labels from state.volumes."""
    vol = importlib.import_module(f"{root}.state.volumes")
    return {"ZONE_LABEL": vol.ZONE_LABEL, "REGION_LABEL": vol.REGION_LABEL}


def port_tables(device, against=None, translate=None):
    """The port's `k` on `device`, its tables held against `against`."""
    from tests.torch_packages import helpers
    from tests.torch_tables import NAMES, Tables
    tables = Tables(device, against, translate)
    h = helpers(PORT)
    pkg = Pkg(PORT, MODULES, extra={
        **{n: getattr(h, n) for n in HELPER_NAMES}, **_shared(PORT),
        **{n: getattr(tables, n) for n in NAMES}})
    pkg.dev = {"device": device}
    pkg.tables = tables
    return pkg


def _ref_tables():
    """The reference's own table helpers, from its test files."""
    import types
    mods = {n: importlib.import_module(f"tests.test_{n}")
            for n in ("predicates_kernel", "priorities_kernel",
                      "priorities_ext", "volumes")}
    engine = importlib.import_module(f"{REF}.engine.scheduler_engine")
    node_info = importlib.import_module(f"{REF}.state.node_info")
    snapshot = importlib.import_module(f"{REF}.state.snapshot")

    def verdict(pod, nodes, bound, priorities):
        infos = node_info.node_info_map(nodes, bound)
        snap = snapshot.ClusterSnapshot()
        snap.refresh(infos)
        fits, scores = engine.evaluate_pod(pod, infos, snap, priorities)
        return fits, scores, snap.node_names

    return types.SimpleNamespace(
        kernel_fits_matrix=mods["predicates_kernel"].kernel_fits_matrix,
        build=mods["priorities_kernel"].build,
        kernel_scores=mods["priorities_ext"].kernel_scores,
        _kernel_matrix=mods["volumes"]._kernel_matrix,
        prio=importlib.import_module(f"{REF}.ops.priorities"),
        verdict=verdict)


@functools.cache
def _pkg(root):
    if root == PORT:
        return port_tables("cpu", _ref_tables(),
                           functools.partial(twin, root=REF))
    ref = _ref_tables()
    h = importlib.import_module("tests.helpers")
    pred = importlib.import_module(f"{REF}.ops.predicates")
    return Pkg(REF, MODULES, extra={
        **{n: getattr(h, n) for n in HELPER_NAMES}, **_shared(REF),
        "kernel_fits_matrix": ref.kernel_fits_matrix, "build": ref.build,
        "kernel_scores": ref.kernel_scores,
        "_kernel_matrix": ref._kernel_matrix,
        "pod_arrays": pred.pod_arrays, "node_arrays": pred.node_arrays,
        "place_batch": importlib.import_module(
            f"{REF}.engine.batch").place_batch,
        "prio": ref.prio,
        "oracle_ext": importlib.import_module(f"{REF}.ops.oracle_ext"),
        "jnp": importlib.import_module("jax.numpy")})


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return _pkg(request.param)


# -------------------- tests/test_predicates_kernel.py


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_cluster_matches_oracle(k, seed):
    rng = random.Random(seed)
    nodes = k.random_nodes(rng, 24)
    names = [n.name for n in nodes]
    pending = [k.random_pod(rng, i, names) for i in range(40)]
    # some already-bound pods occupying capacity/ports
    bound = []
    for i in range(30):
        p = k.random_pod(rng, 1000 + i, names)
        p.node_name = rng.choice(names)
        p.node_selector = {}
        p.affinity = None
        bound.append(p)

    m, snap_names, infos, batch = k.kernel_fits_matrix(pending, nodes, bound)
    mismatches = []
    for pi, pod in enumerate(pending):
        for ni, nm in enumerate(snap_names):
            expect = k.oracle.pod_fits(pod, infos[nm])
            if batch.needs_host_check[pi]:
                # over-approximation allowed: kernel True, oracle False is OK
                if expect and not m[pi, ni]:
                    mismatches.append((pod.name, nm, expect, bool(m[pi, ni])))
            elif bool(m[pi, ni]) != expect:
                mismatches.append((pod.name, nm, expect, bool(m[pi, ni])))
    assert not mismatches, mismatches[:10]


def test_zero_request_pod_only_checks_pod_count(k):
    node = k.make_node("n1", cpu=100, memory=128 * k.Mi, pods=2)
    hog = k.make_pod("hog", cpu=100, memory=128 * k.Mi, node_name="n1")
    zero = k.Pod(name="zero", containers=[k.Container(name="c0")])
    m, names, infos, _ = k.kernel_fits_matrix([zero], [node], [hog])
    assert m[0, 0]  # full node, but zero-request pod fits (predicates.go:576)
    # second bound pod exhausts allowedPodNumber=2
    hog2 = k.make_pod("hog2", node_name="n1")
    m, names, infos, _ = k.kernel_fits_matrix([zero], [node], [hog, hog2])
    assert not m[0, 0]


def test_host_port_conflict(k):
    node = k.make_node("n1")
    holder = k.make_pod("holder", ports=[8080], node_name="n1")
    want_same = k.make_pod("w1", ports=[8080])
    want_other = k.make_pod("w2", ports=[8081])
    m, *_ = k.kernel_fits_matrix([want_same, want_other], [node], [holder])
    assert not m[0, 0]
    assert m[1, 0]


def test_node_selector_and_affinity_or_terms(k):
    n_ssd = k.make_node("ssd-node", labels={"disk": "ssd"})
    n_hdd = k.make_node("hdd-node", labels={"disk": "hdd"})
    n_bare = k.make_node("bare-node")
    sel = k.make_pod("sel", node_selector={"disk": "ssd"})
    aff = k.make_pod("aff")
    aff.affinity = k.Affinity(node_affinity=k.NodeAffinity(required_terms=[
        k.NodeSelectorTerm([k.SelectorRequirement("disk", k.SelectorOperator.IN, ["ssd"])]),
        k.NodeSelectorTerm([k.SelectorRequirement("disk", k.SelectorOperator.IN, ["hdd"])]),
    ]))
    none_match = k.make_pod("none")
    none_match.affinity = k.Affinity(node_affinity=k.NodeAffinity(required_terms=[]))
    m, names, *_ = k.kernel_fits_matrix(
        [sel, aff, none_match], [n_ssd, n_hdd, n_bare])
    col = {nm: i for i, nm in enumerate(names)}
    assert m[0, col["ssd-node"]] and not m[0, col["hdd-node"]] and not m[0, col["bare-node"]]
    assert m[1, col["ssd-node"]] and m[1, col["hdd-node"]] and not m[1, col["bare-node"]]
    # empty required_terms list matches NO nodes (predicates.go:646)
    assert not m[2].any()


def test_selector_not_in_matches_absent_key(k):
    labeled = k.make_node("labeled", labels={"arch": "arm64"})
    unlabeled = k.make_node("unlabeled")
    p = k.make_pod("p")
    p.affinity = k.Affinity(node_affinity=k.NodeAffinity(required_terms=[
        k.NodeSelectorTerm([k.SelectorRequirement("arch", k.SelectorOperator.NOT_IN, ["arm64"])]),
    ]))
    m, names, *_ = k.kernel_fits_matrix([p], [labeled, unlabeled])
    col = {nm: i for i, nm in enumerate(names)}
    assert not m[0, col["labeled"]]
    assert m[0, col["unlabeled"]]


def test_taints_and_tolerations(k):
    tainted = k.make_node("tainted", taints=[k.Taint("dedicated", "gpu", k.TaintEffect.NO_SCHEDULE)])
    prefer = k.make_node("prefer", taints=[k.Taint("noisy", "", k.TaintEffect.PREFER_NO_SCHEDULE)])
    plain = k.make_pod("plain")
    tolerant = k.make_pod("tolerant", tolerations=[
        k.Toleration("dedicated", k.TolerationOperator.EQUAL, "gpu", k.TaintEffect.NO_SCHEDULE)])
    wildcard = k.make_pod("wild", tolerations=[
        k.Toleration("", k.TolerationOperator.EXISTS, "", None)])
    m, names, *_ = k.kernel_fits_matrix([plain, tolerant, wildcard], [tainted, prefer])
    col = {nm: i for i, nm in enumerate(names)}
    assert not m[0, col["tainted"]]
    assert m[0, col["prefer"]]  # PreferNoSchedule never filters
    assert m[1, col["tainted"]]
    assert m[2, col["tainted"]]


def test_unready_and_unschedulable_nodes_filtered(k):
    bad = k.make_node("bad", ready=False)
    cordoned = k.make_node("cordoned", unschedulable=True)
    good = k.make_node("good")
    p = k.make_pod("p", cpu=100)
    m, names, *_ = k.kernel_fits_matrix([p], [bad, cordoned, good])
    col = {nm: i for i, nm in enumerate(names)}
    assert not m[0, col["bad"]]
    assert not m[0, col["cordoned"]]
    assert m[0, col["good"]]


def test_gpu_and_resource_accounting(k):
    gpu_node = k.make_node("gpu", gpu=2)
    cpu_node = k.make_node("cpu")
    holder = k.make_pod("holder", gpu=1, node_name="gpu")
    one = k.make_pod("one", gpu=1)
    two = k.make_pod("two", gpu=2)
    m, names, *_ = k.kernel_fits_matrix([one, two], [gpu_node, cpu_node], [holder])
    col = {nm: i for i, nm in enumerate(names)}
    assert m[0, col["gpu"]]
    assert not m[1, col["gpu"]]  # 1 used + 2 wanted > 2
    assert not m[0, col["cpu"]]


# -------------------- tests/test_priorities_kernel.py


PRIORITY_SETS = [
    (("LeastRequestedPriority", 1),),
    (("MostRequestedPriority", 1),),
    (("BalancedResourceAllocation", 1),),
    (("LeastRequestedPriority", 1), ("BalancedResourceAllocation", 1),
     ("TaintTolerationPriority", 1)),
]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("pset", PRIORITY_SETS)
def test_scores_match_oracle(k, seed, pset):
    rng = random.Random(seed)
    nodes = k.random_nodes(rng, 16)
    names = [n.name for n in nodes]
    pending = [k.random_pod(rng, i, names) for i in range(25)]
    bound = []
    for i in range(20):
        p = k.random_pod(rng, 500 + i, names)
        p.node_name = rng.choice(names)
        bound.append(p)
    parrs, narrs, snap, infos = k.build(pending, nodes, bound)
    got = np.asarray(k.prio.score(parrs, narrs, pset))
    n_real = len(snap.node_names)
    for pi, pod in enumerate(pending):
        ordered = [infos[nm] for nm in snap.node_names]
        want = k.oracle.prioritize(pod, ordered, pset)
        np.testing.assert_array_equal(
            got[pi, :n_real], want,
            err_msg=f"pod {pod.name} priorities {pset}")


def test_least_requested_exact_values(k):
    # cap 4000m/32Gi; existing nonzero request 1000m/8Gi; pod 1000m/8Gi
    node = k.make_node("n", cpu=4000, memory=32 * k.Gi)
    holder = k.make_pod("h", cpu=1000, memory=8 * k.Gi, node_name="n")
    pod = k.make_pod("p", cpu=1000, memory=8 * k.Gi)
    parrs, narrs, snap, infos = k.build([pod], [node], [holder])
    got = int(np.asarray(k.prio.score(parrs, narrs, (("LeastRequestedPriority", 1),)))[0, 0])
    # cpu: (4000-2000)*10/4000 = 5 ; mem: (32-16)*10/32 = 5 ; avg = 5
    assert got == 5
    assert got == k.oracle.least_requested_score(pod, infos["n"])


def test_least_requested_default_requests(k):
    # unset requests count as 100m / 200Mi for scoring only
    node = k.make_node("n", cpu=1000, memory=2000 * k.Mi)
    pod = k.make_pod("p")  # no explicit requests
    parrs, narrs, snap, infos = k.build([pod], [node])
    got = int(np.asarray(k.prio.score(parrs, narrs, (("LeastRequestedPriority", 1),)))[0, 0])
    # cpu: (1000-100)*10/1000 = 9 ; mem: (2000-200)*10/2000 = 9
    assert got == 9


def test_balanced_allocation_perfect_balance(k):
    node = k.make_node("n", cpu=4000, memory=32 * k.Gi)
    pod = k.make_pod("p", cpu=2000, memory=16 * k.Gi)  # both fractions = 0.5
    parrs, narrs, snap, infos = k.build([pod], [node])
    got = int(np.asarray(k.prio.score(parrs, narrs, (("BalancedResourceAllocation", 1),)))[0, 0])
    assert got == 10
    assert got == k.oracle.balanced_allocation_score(pod, infos["n"])


def test_balanced_allocation_overcommit_scores_zero(k):
    node = k.make_node("n", cpu=1000, memory=1 * k.Gi)
    pod = k.make_pod("p", cpu=2000, memory=128 * k.Mi)
    parrs, narrs, snap, infos = k.build([pod], [node])
    got = int(np.asarray(k.prio.score(parrs, narrs, (("BalancedResourceAllocation", 1),)))[0, 0])
    assert got == 0


def test_taint_toleration_normalized(k):
    n0 = k.make_node("n0")
    n1 = k.make_node("n1", taints=[k.Taint("noisy", "", k.TaintEffect.PREFER_NO_SCHEDULE)])
    n2 = k.make_node("n2", taints=[
        k.Taint("noisy", "", k.TaintEffect.PREFER_NO_SCHEDULE),
        k.Taint("louder", "", k.TaintEffect.PREFER_NO_SCHEDULE)])
    pod = k.make_pod("p")
    parrs, narrs, snap, infos = k.build([pod], [n0, n1, n2])
    got = np.asarray(k.prio.score(parrs, narrs, (("TaintTolerationPriority", 1),)))[0]
    ordered = [infos[nm] for nm in snap.node_names]
    want = k.oracle.taint_toleration_scores(pod, ordered)
    assert list(got[: len(want)]) == want  # n0:10 n1:5 n2:0


# -------------------- tests/test_priorities_ext.py


def test_node_affinity_priority_matches_oracle(k):
    nodes = [k.make_node("n0", labels={"disk": "ssd", "zone": "a"}),
             k.make_node("n1", labels={"disk": "hdd", "zone": "a"}),
             k.make_node("n2", labels={"zone": "b"})]
    pod = k.make_pod("p")
    pod.affinity = k.Affinity(node_affinity=k.NodeAffinity(preferred_terms=[
        (5, k.NodeSelectorTerm([k.SelectorRequirement("disk", k.SelectorOperator.IN, ["ssd"])])),
        (3, k.NodeSelectorTerm([k.SelectorRequirement("zone", k.SelectorOperator.IN, ["a"])])),
        (2, k.NodeSelectorTerm([])),  # empty term matches everything
    ]))
    got, snap, infos = k.kernel_scores([pod], nodes, (("NodeAffinityPriority", 1),))
    ordered = [infos[nm] for nm in snap.node_names]
    want = k.oracle_ext.node_affinity_scores(pod, ordered)
    # counts: n0=10, n1=5, n2=2 -> scores int(10*c/10) = [10, 5, 2]
    assert list(got[0]) == want == [10, 5, 2]


def test_node_affinity_priority_no_preferences_scores_zero(k):
    nodes = [k.make_node("n0"), k.make_node("n1")]
    got, snap, infos = k.kernel_scores([k.make_pod("p")], nodes,
                                     (("NodeAffinityPriority", 1),))
    assert list(got[0]) == [0, 0]


def test_prefer_avoid_pods_matches_oracle(k):
    annotation = json.dumps({"preferAvoidPods": [
        {"podSignature": {"podController": {"kind": "ReplicaSet",
                                            "uid": "rs-1",
                                            "apiVersion": "v1"}},
         "reason": "some reason"}]})
    n0 = k.make_node("n0")
    n0.annotations[k.AVOID_PODS_ANNOTATION] = annotation
    n1 = k.make_node("n1")
    owned = k.make_pod("owned")
    owned.owner_kind, owned.owner_uid = "ReplicaSet", "rs-1"
    other_rs = k.make_pod("other")
    other_rs.owner_kind, other_rs.owner_uid = "ReplicaSet", "rs-2"
    bare = k.make_pod("bare")
    got, snap, infos = k.kernel_scores(
        [owned, other_rs, bare], [n0, n1],
        (("NodePreferAvoidPodsPriority", 1),))
    ordered = [infos[nm] for nm in snap.node_names]
    for i, pod in enumerate([owned, other_rs, bare]):
        assert list(got[i]) == k.oracle_ext.prefer_avoid_scores(pod, ordered)
    col = {nm: i for i, nm in enumerate(snap.node_names)}
    assert got[0, col["n0"]] == 0 and got[0, col["n1"]] == 10
    assert got[1, col["n0"]] == 10  # different RS uid not avoided
    assert got[2, col["n0"]] == 10  # non-controller pod never avoided


def test_image_locality_matches_oracle(k):
    Mi_ = 1024 * 1024
    n0 = k.make_node("n0")
    n0.images = [k.ContainerImage(["nginx:1.13"], 500 * Mi_),
                 k.ContainerImage(["redis:3.2", "redis:latest"], 100 * Mi_)]
    n1 = k.make_node("n1")
    n1.images = [k.ContainerImage(["nginx:1.13"], 10 * Mi_)]  # < 23MB floor
    n2 = k.make_node("n2")
    pod = k.make_pod("p")
    pod.containers[0].image = "nginx:1.13"
    got, snap, infos = k.kernel_scores([pod], [n0, n1, n2],
                                     (("ImageLocalityPriority", 1),))
    ordered = [infos[nm] for nm in snap.node_names]
    want = k.oracle_ext.image_locality_scores(pod, ordered)
    assert list(got[0]) == want
    col = {nm: i for i, nm in enumerate(snap.node_names)}
    # 500MB -> int(10*(500-23)/(1000-23))+1 = 5 ; below floor -> 0 ; absent -> 0
    assert got[0, col["n0"]] == 5
    assert got[0, col["n1"]] == 0
    assert got[0, col["n2"]] == 0


def test_selector_spread_oracle_zone_weighting(k):
    zoneA = {"failure-domain.beta.kubernetes.io/zone": "a"}
    zoneB = {"failure-domain.beta.kubernetes.io/zone": "b"}
    nodes = [k.make_node("a0", labels=zoneA), k.make_node("a1", labels=zoneA),
             k.make_node("b0", labels=zoneB)]
    svc = k.WorkloadObject("Service", "web", "default", match_labels={"app": "web"})
    bound = []
    for i, nm in enumerate(["a0", "a0", "a1"]):
        p = k.make_pod(f"w{i}", labels={"app": "web"})
        p.node_name = nm
        bound.append(p)
    infos = k.node_info_map(nodes, bound)
    ctx = k.oracle_ext.SchedulingContext(infos, [svc])
    pod = k.make_pod("new", labels={"app": "web"})
    ordered = [infos[nm] for nm in sorted(infos)]
    scores = k.oracle_ext.selector_spread_scores(pod, ordered, ctx)
    by = dict(zip(sorted(infos), scores))
    # counts: a0=2, a1=1, b0=0; zoneA=3, zoneB=0; maxNode=2, maxZone=3
    # a0: node (2-2)/2*10=0,  zone 0   -> 0
    # a1: node (2-1)/2*10=5,  zone 0   -> 5*(1/3) = 1
    # b0: node 10, zone 10             -> 10
    assert by == {"a0": 0, "a1": 1, "b0": 10}


def test_selector_spread_no_owners_scores_max(k):
    nodes = [k.make_node("n0"), k.make_node("n1")]
    infos = k.node_info_map(nodes, [])
    ctx = k.oracle_ext.SchedulingContext(infos, [])
    scores = k.oracle_ext.selector_spread_scores(
        k.make_pod("p"), [infos["n0"], infos["n1"]], ctx)
    assert scores == [10, 10]


def _aff_term(k, labels, key="zone", namespaces=()):
    return k.PodAffinityTerm(
        label_selector=k.LabelSelector(match_labels=labels),
        namespaces=list(namespaces), topology_key=key)


def test_interpod_affinity_predicate_oracle(k):
    zoneA = {"zone": "a"}
    zoneB = {"zone": "b"}
    nodes = [k.make_node("na", labels=zoneA), k.make_node("nb", labels=zoneB)]
    store = k.make_pod("store", labels={"app": "store"})
    store.node_name = "na"
    infos = k.node_info_map(nodes, [store])
    ctx = k.oracle_ext.SchedulingContext(infos)
    # required affinity to app=store in same zone -> only na
    web = k.make_pod("web")
    web.affinity = k.Affinity(pod_affinity=k.PodAffinity(
        required_terms=[_aff_term(k, {"app": "store"})]))
    assert k.oracle_ext.inter_pod_affinity_fits(web, nodes[0], ctx)
    assert not k.oracle_ext.inter_pod_affinity_fits(web, nodes[1], ctx)
    # required anti-affinity to app=store in same zone -> only nb
    anti = k.make_pod("anti")
    anti.affinity = k.Affinity(pod_anti_affinity=k.PodAffinity(
        required_terms=[_aff_term(k, {"app": "store"})]))
    assert not k.oracle_ext.inter_pod_affinity_fits(anti, nodes[0], ctx)
    assert k.oracle_ext.inter_pod_affinity_fits(anti, nodes[1], ctx)


def test_interpod_affinity_bootstrap_self_match(k):
    # first pod of a self-referencing group may schedule anywhere
    nodes = [k.make_node("na", labels={"zone": "a"})]
    infos = k.node_info_map(nodes, [])
    ctx = k.oracle_ext.SchedulingContext(infos)
    first = k.make_pod("first", labels={"app": "db"})
    first.affinity = k.Affinity(pod_affinity=k.PodAffinity(
        required_terms=[_aff_term(k, {"app": "db"})]))
    assert k.oracle_ext.inter_pod_affinity_fits(first, nodes[0], ctx)
    # but a pod NOT matching its own term is stuck when no match exists
    wannabe = k.make_pod("wannabe", labels={"app": "web"})
    wannabe.affinity = k.Affinity(pod_affinity=k.PodAffinity(
        required_terms=[_aff_term(k, {"app": "db"})]))
    assert not k.oracle_ext.inter_pod_affinity_fits(wannabe, nodes[0], ctx)


def test_interpod_existing_anti_affinity_symmetry(k):
    # an existing pod's required anti-affinity blocks the incoming pod
    nodes = [k.make_node("na", labels={"zone": "a"}),
             k.make_node("nb", labels={"zone": "b"})]
    guard = k.make_pod("guard", labels={"app": "guard"})
    guard.node_name = "na"
    guard.affinity = k.Affinity(pod_anti_affinity=k.PodAffinity(
        required_terms=[_aff_term(k, {"app": "web"})]))
    infos = k.node_info_map(nodes, [guard])
    ctx = k.oracle_ext.SchedulingContext(infos)
    web = k.make_pod("web", labels={"app": "web"})
    assert not k.oracle_ext.inter_pod_affinity_fits(web, nodes[0], ctx)
    assert k.oracle_ext.inter_pod_affinity_fits(web, nodes[1], ctx)
    # unrelated pod unaffected
    other = k.make_pod("other", labels={"app": "other"})
    assert k.oracle_ext.inter_pod_affinity_fits(other, nodes[0], ctx)


def test_interpod_affinity_priority_counts(k):
    zoneA = {"zone": "a"}
    zoneB = {"zone": "b"}
    nodes = [k.make_node("na", labels=zoneA), k.make_node("nb", labels=zoneB)]
    store = k.make_pod("store", labels={"app": "store"})
    store.node_name = "na"
    infos = k.node_info_map(nodes, [store])
    ctx = k.oracle_ext.SchedulingContext(infos)
    pod = k.make_pod("web")
    pod.affinity = k.Affinity(pod_affinity=k.PodAffinity(
        preferred_terms=[(10, _aff_term(k, {"app": "store"}))]))
    ordered = [infos[nm] for nm in sorted(infos)]
    scores = k.oracle_ext.interpod_affinity_scores(pod, ordered, ctx)
    # na gets +10 (same zone as store), nb 0 -> normalized [10, 0]
    assert scores == [10, 0]


def test_engine_schedules_affinity_pods_via_host_path(k):
    """End-to-end through the engine: affinity pods take the oracle path and
    land correctly relative to device-placed pods."""
    cache = k.SchedulerCache()
    cache.add_node(k.make_node("na", labels={"zone": "a"}))
    cache.add_node(k.make_node("nb", labels={"zone": "b"}))
    eng = k.SchedulingEngine(cache, **k.dev)
    store = k.make_pod("store", labels={"app": "store"},
                     node_selector={"zone": "a"})
    [r] = eng.schedule([store])
    assert r.node_name == "na"
    web = k.make_pod("web", labels={"app": "web"})
    web.affinity = k.Affinity(pod_affinity=k.PodAffinity(
        required_terms=[_aff_term(k, {"app": "store"})]))
    [r2] = eng.schedule([web])
    assert r2.node_name == "na"
    anti = k.make_pod("anti")
    anti.affinity = k.Affinity(pod_anti_affinity=k.PodAffinity(
        required_terms=[_aff_term(k, {"app": "store"})]))
    [r3] = eng.schedule([anti])
    assert r3.node_name == "nb"


def test_engine_symmetry_blocks_non_affinity_pod(k):
    """Regression: a plain pod matching an EXISTING pod's required
    anti-affinity must not be placed by the device fast path onto a
    conflicting topology (predicates.go:1146 symmetry)."""
    cache = k.SchedulerCache()
    cache.add_node(k.make_node("na", labels={"zone": "a"}))
    cache.add_node(k.make_node("nb", labels={"zone": "b"}))
    guard = k.make_pod("guard", labels={"app": "guard"})
    guard.node_name = "na"
    guard.affinity = k.Affinity(pod_anti_affinity=k.PodAffinity(
        required_terms=[_aff_term(k, {"app": "web"})]))
    cache.add_pod(guard)
    eng = k.SchedulingEngine(cache, **k.dev)
    web = k.make_pod("web", labels={"app": "web"})  # NO affinity of its own
    [r] = eng.schedule([web])
    assert r.node_name == "nb"
    # and a second web pod has nowhere to go once nb hosts... nothing blocks
    # nb, so it also lands on nb
    web2 = k.make_pod("web2", labels={"app": "web"})
    [r2] = eng.schedule([web2])
    assert r2.node_name == "nb"
    # unrelated pod is unaffected and uses the fast path
    other = k.make_pod("other", labels={"app": "other"})
    [r3] = eng.schedule([other])
    assert r3.node_name is not None


# -------------------- tests/test_volumes.py


def gce(k, pd, ro=False):
    return k.Volume(name=pd, kind=k.VolumeKind.GCE_PD, volume_id=pd, read_only=ro)


def ebs(k, vid, ro=False):
    return k.Volume(name=vid, kind=k.VolumeKind.AWS_EBS, volume_id=vid, read_only=ro)


def rbd(k, mons, pool, image, ro=False):
    return k.Volume(name=image, kind=k.VolumeKind.RBD, monitors=list(mons),
                  pool=pool, image=image, read_only=ro)


def iscsi(k, iqn, ro=False):
    return k.Volume(name=iqn, kind=k.VolumeKind.ISCSI, volume_id=iqn, read_only=ro)


def azure(k, name):
    return k.Volume(name=name, kind=k.VolumeKind.AZURE_DISK, volume_id=name)


def pvc(k, claim):
    return k.Volume(name=claim, kind=k.VolumeKind.PVC, volume_id=claim)


def _info(k, node, pods=()):
    return k.node_info_map([node], list(pods))[node.name]


# ---------------------------------------------------------------- oracle


def test_no_disk_conflict_tables(k):
    node = k.make_node("n1")
    # (pod volume, existing volume, conflict?)
    cases = [
        (gce(k, "a"), gce(k, "a"), True),
        (gce(k, "a"), gce(k, "b"), False),
        (gce(k, "a", ro=True), gce(k, "a", ro=True), False),  # both RO OK
        (gce(k, "a", ro=True), gce(k, "a"), True),  # existing RW
        (gce(k, "a"), gce(k, "a", ro=True), True),  # new RW
        (ebs(k, "v1"), ebs(k, "v1"), True),
        (ebs(k, "v1", ro=True), ebs(k, "v1", ro=True), True),  # EBS: RO irrelevant
        (ebs(k, "v1"), ebs(k, "v2"), False),
        (rbd(k, ["m1", "m2"], "p", "i"), rbd(k, ["m2", "m3"], "p", "i"), True),
        (rbd(k, ["m1"], "p", "i"), rbd(k, ["m2"], "p", "i"), False),  # no shared mon
        (rbd(k, ["m1"], "p", "i"), rbd(k, ["m1"], "q", "i"), False),  # diff pool
        (rbd(k, ["m1"], "p", "i", ro=True), rbd(k, ["m1"], "p", "i", ro=True), False),
        (iscsi(k, "iqn1"), iscsi(k, "iqn1"), True),
        (iscsi(k, "iqn1", ro=True), iscsi(k, "iqn1", ro=True), False),
        (gce(k, "a"), ebs(k, "a"), False),  # cross-kind never conflicts
    ]
    for new_vol, old_vol, want_conflict in cases:
        holder = k.make_pod("holder", node_name="n1", volumes=[old_vol])
        info = _info(k, node, [holder])
        pod = k.make_pod("p", volumes=[new_vol])
        assert k.ov.no_disk_conflict(pod, info) == (not want_conflict), \
            (new_vol, old_vol)


def test_max_pd_volume_count_inline_and_pvc(k):
    node = k.make_node("n1")
    ctx = k.VolumeContext(
        pvs={"pv-ebs": k.PersistentVolume("pv-ebs", source=ebs(k, "pv-vol"))},
        pvcs={("default", "claim1"): k.PersistentVolumeClaim(
            "claim1", volume_name="pv-ebs")},
    )
    # node already has 2 distinct EBS volumes (one inline, one via PVC)
    holders = [
        k.make_pod("h1", node_name="n1", volumes=[ebs(k, "v1")]),
        k.make_pod("h2", node_name="n1", volumes=[pvc(k, "claim1")]),
    ]
    info = _info(k, node, holders)
    limits = (2, 2, 2)
    # new distinct volume exceeds the limit of 2
    assert k.ov.max_pd_volume_count(
        k.make_pod("p", volumes=[ebs(k, "v9")]), info, ctx, limits) == [False, True, True]
    # re-using an existing volume does not count as new
    assert k.ov.max_pd_volume_count(
        k.make_pod("p", volumes=[ebs(k, "v1")]), info, ctx, limits) == [True, True, True]
    # no relevant volumes -> quick pass even at the limit
    assert k.ov.max_pd_volume_count(
        k.make_pod("p", volumes=[gce(k, "g")]), info, ctx, limits)[0] is True
    # missing PVC counts as a unique volume toward every filter
    missing = k.make_pod("p", volumes=[pvc(k, "nope")])
    assert k.ov.max_pd_volume_count(missing, info, ctx, limits)[0] is False


def test_volume_zone_tables(k):
    ctx = k.VolumeContext(
        pvs={"pv1": k.PersistentVolume("pv1", labels={k.ZONE_LABEL: "us-1a"}),
             "pv2": k.PersistentVolume("pv2", labels={k.REGION_LABEL: "us"})},
        pvcs={("default", "c1"): k.PersistentVolumeClaim("c1", volume_name="pv1"),
              ("default", "c2"): k.PersistentVolumeClaim("c2", volume_name="pv2")},
    )
    pod = k.make_pod("p", volumes=[pvc(k, "c1")])
    same = _info(k, k.make_node("n1", labels={k.ZONE_LABEL: "us-1a"}))
    other = _info(k, k.make_node("n2", labels={k.ZONE_LABEL: "us-1b"}))
    nozone = _info(k, k.make_node("n3"))
    assert k.ov.no_volume_zone_conflict(pod, same, ctx)
    assert not k.ov.no_volume_zone_conflict(pod, other, ctx)
    assert k.ov.no_volume_zone_conflict(pod, nozone, ctx)  # fast-path
    # region-labeled PV vs zone-labeled node: missing region key fails
    pod2 = k.make_pod("p2", volumes=[pvc(k, "c2")])
    assert not k.ov.no_volume_zone_conflict(pod2, same, ctx)
    region_node = _info(k, k.make_node("n4", labels={k.REGION_LABEL: "us"}))
    assert k.ov.no_volume_zone_conflict(pod2, region_node, ctx)
    # unresolvable claim -> error (pod fails the round)
    with pytest.raises(Exception):
        k.ov.no_volume_zone_conflict(
            k.make_pod("p3", volumes=[pvc(k, "missing")]), same, ctx)


def test_volume_node_affinity_gated(k):
    ann = json.dumps({
        "requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [
                {"matchExpressions": [
                    {"key": "kubernetes.io/hostname", "operator": "In",
                     "values": ["n1"]}]}]}})
    ctx = k.VolumeContext(
        pvs={"local1": k.PersistentVolume(
            "local1", annotations={k.ALPHA_STORAGE_NODE_AFFINITY_ANNOTATION: ann})},
        pvcs={("default", "lc"): k.PersistentVolumeClaim("lc", volume_name="local1")},
    )
    pod = k.make_pod("p", volumes=[pvc(k, "lc")])
    n1 = _info(k, k.make_node("n1", labels={"kubernetes.io/hostname": "n1"}))
    n2 = _info(k, k.make_node("n2", labels={"kubernetes.io/hostname": "n2"}))
    # gate off (default): predicate passes everywhere
    assert k.ov.no_volume_node_conflict(pod, n2, ctx)
    k.features.DEFAULT_FEATURE_GATE.set("PersistentLocalVolumes", True)
    try:
        assert k.ov.no_volume_node_conflict(pod, n1, ctx)
        assert not k.ov.no_volume_node_conflict(pod, n2, ctx)
    finally:
        k.features.DEFAULT_FEATURE_GATE.reset()


# ---------------------------------------------------------------- kernel




def _rand_volume(k, rng):
    r = rng.random()
    ro = rng.random() < 0.4
    if r < 0.25:
        return gce(k, rng.choice(["pd1", "pd2", "pd3"]), ro=ro)
    if r < 0.5:
        return ebs(k, rng.choice(["v1", "v2", "v3"]), ro=ro)
    if r < 0.65:
        return rbd(k, rng.sample(["m1", "m2", "m3"], rng.randint(1, 2)),
                   rng.choice(["p1", "p2"]), rng.choice(["i1", "i2"]), ro=ro)
    if r < 0.8:
        return iscsi(k, rng.choice(["q1", "q2"]), ro=ro)
    if r < 0.9:
        return azure(k, rng.choice(["d1", "d2"]))
    return pvc(k, rng.choice(["c1", "c2", "c-missing"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_matches_oracle_with_volumes(k, seed):
    rng = random.Random(seed)
    ctx = k.VolumeContext(
        pvs={"pv1": k.PersistentVolume("pv1", source=gce(k, "pd-shared"),
                                     labels={k.ZONE_LABEL: "us-1a"}),
             "pv2": k.PersistentVolume("pv2", source=ebs(k, "ebs-shared"))},
        pvcs={("default", "c1"): k.PersistentVolumeClaim("c1", volume_name="pv1"),
              ("default", "c2"): k.PersistentVolumeClaim("c2", volume_name="pv2")},
    )
    nodes = []
    for i in range(12):
        labels = {}
        if rng.random() < 0.5:
            labels[k.ZONE_LABEL] = rng.choice(["us-1a", "us-1b"])
        nodes.append(k.make_node(f"vn-{i:02d}", labels=labels))
    names = [n.name for n in nodes]
    bound = []
    for i in range(25):
        vols = [_rand_volume(k, rng) for _ in range(rng.randint(0, 2))]
        p = k.make_pod(f"bound-{i}", volumes=vols, node_name=rng.choice(names))
        bound.append(p)
    pending = [k.make_pod(f"pend-{i}", cpu=100,
                        volumes=[_rand_volume(k, rng)
                                 for _ in range(rng.randint(0, 2))])
               for i in range(30)]

    import os
    os.environ["KUBE_MAX_PD_VOLS"] = "3"  # small limit to exercise MaxPD
    try:
        m, snap, infos, batch = k._kernel_matrix(pending, nodes, bound, ctx)
        octx = k.SchedulingContext(infos, [], volume_ctx=ctx)
        mismatches = []
        for pi, pod in enumerate(pending):
            for ni, nm in enumerate(snap.node_names):
                expect = k.oracle.pod_fits(pod, infos[nm], octx)
                if batch.needs_host_check[pi]:
                    if expect and not m[pi, ni]:
                        mismatches.append((pod.name, nm, expect))
                elif bool(m[pi, ni]) != expect:
                    mismatches.append((pod.name, nm, expect, bool(m[pi, ni])))
        assert not mismatches, mismatches[:10]
    finally:
        del os.environ["KUBE_MAX_PD_VOLS"]


def test_batch_carry_sees_committed_volumes(k):
    """Two pods mounting the same EBS volume must land on different nodes —
    the on-device commit makes pod 0's volume visible to pod 1 (the assume
    semantics of scheduler.go:188 inside one device program)."""
    nodes = [k.make_node("a"), k.make_node("b")]
    infos = k.node_info_map(nodes, [])
    snap = k.ClusterSnapshot()
    snap.refresh(infos)
    pods = [k.make_pod("p0", cpu=100, volumes=[ebs(k, "shared")]),
            k.make_pod("p1", cpu=100, volumes=[ebs(k, "shared")]),
            k.make_pod("p2", cpu=100, volumes=[ebs(k, "shared")])]
    batch = k.PodBatch(pods, snap)
    narr = k.node_arrays(snap)
    # direct place_batch callers without AffinityData must strip the two
    # cluster-topology priorities (the engine does the same when no class
    # carries affinity/spread state — batch.py's guard rejects silent zeros)
    plain = tuple((nm, w) for nm, w in k.prio.DEFAULT_PRIORITIES
                  if nm not in k.prio.AFFINITY_PRIORITIES)
    selected, fit_counts, state, _ = k.place_batch(
        k.pod_arrays(batch), narr, k.node_state(narr), k.jnp.uint32(0), plain)
    sel = np.asarray(selected)
    assert sel[0] >= 0 and sel[1] >= 0
    assert sel[0] != sel[1]  # conflict forced apart
    assert sel[2] == -1  # only two nodes; third pod cannot fit anywhere
    assert int(np.asarray(fit_counts)[2]) == 0
