"""The reference's golden test of the strict batch placement
(tests/test_batch_engine.py) on both packages: the engine's sequential
scan must give EXACTLY the pod->node sequence of the object-level oracle
running the one-pod-at-a-time loop (schedule -> assume -> next pod),
round-robin tie-break evolution included. Each body runs through the `k`
fixture (every SchedulingEngine of the port on the CPU) with the seeded
cluster generator built on that package's types; one more case runs the
port's scan on an 8-shard CPU mesh."""

from __future__ import annotations

import copy
import random

import pytest

from tests.torch_packages import PORT, REF, Pkg, helpers

MODULES = {
    "api_types": "api.types",
    "engine": "engine.scheduler_engine",
    "oracle": "ops.oracle",
    "cache": "state.cache",
    "node_info": "state.node_info",
}

PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}
HELPERS = {REF: helpers(REF), PORT: helpers(PORT)}
DEVICE = {REF: {}, PORT: {"device": "cpu"}}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


def oracle_sequence(k, nodes, pending, priorities):
    """Reference semantics: schedule one, assume, repeat."""
    infos = k.node_info_map(nodes, [])
    names = sorted(infos.keys())  # snapshot order
    rr = k.oracle.RoundRobin()
    out = []
    for pod in pending:
        name = k.oracle.schedule_one(pod, names, infos, rr, priorities)
        out.append(name)
        if name is not None:
            p = copy.deepcopy(pod)
            p.node_name = name
            infos[name].add_pod(p)
    return out


def engine_sequence(k, nodes, pending, priorities, mesh=None):
    cache = k.SchedulerCache()
    for n in nodes:
        cache.add_node(n)
    kw = dict(DEVICE[k.root])
    if mesh is not None:
        kw["mesh"] = mesh
    eng = k.SchedulingEngine(cache, priorities=priorities, **kw)
    results = eng.schedule([copy.deepcopy(p) for p in pending])
    return [r.node_name for r in results]


PSETS = [
    (("LeastRequestedPriority", 1), ("BalancedResourceAllocation", 1),
     ("TaintTolerationPriority", 1)),
    (("MostRequestedPriority", 1),),
    (("EqualPriority", 1),),
]


def _random_world(k, seed):
    h = HELPERS[k.root]
    rng = random.Random(seed)
    nodes = h.random_nodes(rng, 12)
    names = [n.name for n in nodes]
    pending = [h.random_pod(rng, i, names) for i in range(60)]
    for p in pending:
        p.node_name = ""  # ensure all are actually pending
    return nodes, pending


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("pset", PSETS)
def test_batch_matches_sequential_oracle(k, seed, pset):
    nodes, pending = _random_world(k, seed)
    want = oracle_sequence(k, nodes, pending, pset)
    got = engine_sequence(k, nodes, pending, pset)
    assert got == want


@pytest.mark.parametrize("seed", [0, 5])
def test_batch_on_a_mesh_matches_sequential_oracle(seed):
    """The port's strict scan on an 8-shard CPU mesh (the scan runs once
    per shard) gives the oracle's sequence, and the reference's engine on
    its 8-device mesh gives the same."""
    from kubernetes_tpu.parallel.mesh import make_mesh as jmake
    from kubernetes_tpu_torch.parallel.mesh import make_mesh
    pset = PSETS[0]
    k = PKGS[PORT]
    nodes, pending = _random_world(k, seed)
    want = oracle_sequence(k, nodes, pending, pset)
    assert engine_sequence(k, nodes, pending, pset,
                           mesh=make_mesh(8, device="cpu")) == want
    r = PKGS[REF]
    nodes, pending = _random_world(r, seed)
    assert engine_sequence(r, nodes, pending, pset, mesh=jmake(8)) == want


def test_capacity_decrement_spreads_pods(k):
    # 3 identical nodes, pods sized so each node fits exactly 2
    Gi = HELPERS[k.root].Gi
    nodes = [k.make_node(f"n{i}", cpu=2000, memory=4 * Gi, pods=110)
             for i in range(3)]
    pods = [k.make_pod(f"p{i}", cpu=1000, memory=2 * Gi) for i in range(7)]
    got = engine_sequence(k, nodes, pods, (("LeastRequestedPriority", 1),))
    # 6 fit (2 per node), 7th has nowhere to go
    assert got[:6].count("n0") == 2
    assert got[:6].count("n1") == 2
    assert got[:6].count("n2") == 2
    assert got[6] is None


def test_round_robin_tie_break_cycles(k):
    nodes = [k.make_node(f"n{i}") for i in range(4)]
    # zero-request pods: all nodes tie -> RR cycles through all 4
    pods = [k.make_pod(f"p{i}") for i in range(8)]
    got = engine_sequence(k, nodes, pods, (("EqualPriority", 1),))
    assert got == ["n0", "n1", "n2", "n3", "n0", "n1", "n2", "n3"]


def test_single_fit_skips_rr_counter(k):
    # one node matches the selector -> early return must NOT advance RR
    nodes = [k.make_node("labeled", labels={"disk": "ssd"}),
             k.make_node("a"), k.make_node("b")]
    sel_pod = k.make_pod("sel", node_selector={"disk": "ssd"})
    tie_pod1 = k.make_pod("t1")
    tie_pod2 = k.make_pod("t2")
    got = engine_sequence(k, nodes, [sel_pod, tie_pod1, tie_pod2],
                          (("EqualPriority", 1),))
    # snapshot order: a, b, labeled. sel -> labeled (no RR tick);
    # t1 ties on all three -> counter 0 -> "a"; t2 -> counter 1 -> "b"
    assert got == ["labeled", "a", "b"]


def test_assume_updates_cache_and_next_batch_sees_it(k):
    Gi = HELPERS[k.root].Gi
    cache = k.SchedulerCache()
    cache.add_node(k.make_node("n0", cpu=1000, memory=2 * Gi))
    cache.add_node(k.make_node("n1", cpu=1000, memory=2 * Gi))
    eng = k.SchedulingEngine(cache, priorities=(("LeastRequestedPriority",
                                                 1),), **DEVICE[k.root])
    [r1] = eng.schedule([k.make_pod("a", cpu=800, memory=Gi)])
    assert r1.node_name is not None
    other = {"n0": "n1", "n1": "n0"}[r1.node_name]
    # second batch: the big pod must land on the other node
    [r2] = eng.schedule([k.make_pod("b", cpu=800, memory=Gi)])
    assert r2.node_name == other
    # third can't fit anywhere
    [r3] = eng.schedule([k.make_pod("c", cpu=800, memory=Gi)])
    assert r3.node_name is None
    assert r3.fit_count == 0
