"""The reference's wave-placement contracts (tests/test_waves.py) on both
packages: class dedup, the wave equal to the strict scan without ties,
valid and exhaustive placements, ties spread, exact capacity, host ports
serialized per node, determinism, and a second batch seeing the first's
commits. Each body runs through the `k` fixture (every SchedulingEngine
of the port on the CPU) with the seeded cluster generator built on that
package's types."""

from __future__ import annotations

import random
from collections import Counter

import numpy as np
import pytest

from tests.torch_packages import PORT, REF, Pkg, helpers

MODULES = {
    "api_types": "api.types",
    "engine_scheduler_engine": "engine.scheduler_engine",
    "state_cache": "state.cache",
    "state_classes": "state.classes",
    "state_node_info": "state.node_info",
    "state_snapshot": "state.snapshot",
}
HELPER_NAMES = ('Gi', 'Mi', 'random_nodes', 'random_pod')


def _pkg(root):
    h = helpers(root)
    return Pkg(root, MODULES,
               extra={n: getattr(h, n) for n in HELPER_NAMES})


PKGS = {root: _pkg(root) for root in (REF, PORT)}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


PRIO = (("LeastRequestedPriority", 1), ("BalancedResourceAllocation", 1))


def run_mode(k, nodes, pods, mode, priorities=PRIO):
    import copy
    cache = k.SchedulerCache()
    for n in nodes:
        cache.add_node(n)
    eng = k.SchedulingEngine(cache, priorities=priorities, **k.dev)
    return eng.schedule([copy.deepcopy(p) for p in pods], mode=mode), eng


def test_class_key_groups_identical_specs(k):
    a = k.make_pod("a", cpu=100, memory=k.Mi)
    b = k.make_pod("b", cpu=100, memory=k.Mi)
    c = k.make_pod("c", cpu=200, memory=k.Mi)
    assert k.pod_class_key(a) == k.pod_class_key(b)
    assert k.pod_class_key(a) != k.pod_class_key(c)


def test_class_batch_dedup_and_gather(k):
    cache = k.SchedulerCache()
    for n in k.random_nodes(random.Random(0), 6):
        cache.add_node(n)
    eng = k.SchedulingEngine(cache, **k.dev)
    eng.snapshot.refresh(cache.node_infos())
    pods = [k.make_pod(f"p{i}", cpu=100 * (i % 3), memory=k.Mi) for i in range(12)]
    batch = k.ClassBatch(pods, eng.snapshot)
    assert batch.num_classes == 3
    assert len(batch.pod_class) == 12
    # class rows reproduce per-pod encoding: gather == direct PodBatch
    direct = k.PodBatch(pods, eng.snapshot)
    np.testing.assert_array_equal(
        batch.reps_batch.req[batch.pod_class], direct.req)
    np.testing.assert_array_equal(
        batch.reps_batch.nonzero[batch.pod_class], direct.nonzero)


def test_wave_matches_strict_when_no_ties(k):
    # distinct node sizes -> distinct scores -> no RR involvement
    nodes = [k.make_node(f"n{i}", cpu=1000 * (i + 1), memory=(i + 1) * 2 * k.Gi,
                       pods=110) for i in range(5)]
    pods = [k.make_pod(f"p{i}", cpu=300, memory=512 * k.Mi) for i in range(8)]
    got_w, _ = run_mode(k, nodes, pods, "wave")
    got_s, _ = run_mode(k, nodes, pods, "strict")
    # wave re-scores after each conflict round; strict after every pod. With
    # all-identical pods both must produce the same multiset of placements
    # and identical per-pod feasibility.
    assert [r.node_name is None for r in got_w] \
        == [r.node_name is None for r in got_s]
    assert Counter(r.node_name for r in got_w) \
        == Counter(r.node_name for r in got_s)


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_wave_placements_are_valid_and_exhaustive(k, seed):
    """Every wave placement must fit (validated object-level), and every
    unschedulable verdict must be real (no node fits even on the empty run)."""
    rng = random.Random(seed)
    nodes = k.random_nodes(rng, 10)
    names = [n.name for n in nodes]
    pods = [k.random_pod(rng, i, names) for i in range(50)]
    for p in pods:
        p.node_name = ""
    results, eng = run_mode(k, nodes, pods, "wave")
    infos = k.node_info_map(nodes, [])
    placed = 0
    for r in results:
        if r.node_name is None:
            continue
        placed += 1
        info = infos[r.node_name]
        import copy
        q = copy.deepcopy(r.pod)
        q.node_name = r.node_name
        info.add_pod(q)
    # capacity is never exceeded after all commits
    for nm, info in infos.items():
        node = info.node
        assert info.requested.milli_cpu <= node.allocatable.milli_cpu, nm
        assert info.requested.memory <= node.allocatable.memory, nm
        assert len(info.pods) <= node.allowed_pod_number, nm
    assert placed > 0


def test_wave_spreads_identical_pods_across_tie_set(k):
    nodes = [k.make_node(f"n{i}", cpu=4000, memory=8 * k.Gi, pods=110)
             for i in range(8)]
    pods = [k.make_pod(f"p{i}", cpu=100, memory=128 * k.Mi) for i in range(24)]
    results, _ = run_mode(k, nodes, pods, "wave")
    counts = Counter(r.node_name for r in results)
    assert None not in counts
    assert set(counts.values()) == {3}  # perfectly even 24/8


def test_wave_capacity_exact_with_overflow(k):
    nodes = [k.make_node(f"n{i}", cpu=1000, memory=2 * k.Gi, pods=110)
             for i in range(3)]
    # each node fits exactly 2 (cpu) -> 6 slots, 9 pods
    pods = [k.make_pod(f"p{i}", cpu=500, memory=256 * k.Mi) for i in range(9)]
    results, _ = run_mode(k, nodes, pods, "wave")
    ok = [r for r in results if r.node_name is not None]
    bad = [r for r in results if r.node_name is None]
    assert len(ok) == 6 and len(bad) == 3
    assert all(v == 2 for v in Counter(r.node_name for r in ok).values())
    assert all(r.fit_count == 0 for r in bad)


def test_wave_host_ports_serialize_per_node(k):
    nodes = [k.make_node(f"n{i}", cpu=4000, memory=8 * k.Gi) for i in range(2)]
    pods = [k.make_pod(f"p{i}", cpu=100, memory=k.Mi, ports=[8080])
            for i in range(4)]
    results, _ = run_mode(k, nodes, pods, "wave")
    names = [r.node_name for r in results]
    # only one 8080 per node -> exactly 2 placed
    assert Counter(n is not None for n in names)[True] == 2
    placed = [n for n in names if n is not None]
    assert len(set(placed)) == 2


def test_wave_deterministic(k):
    rng = random.Random(11)
    nodes = k.random_nodes(rng, 9)
    pods = [k.random_pod(rng, i, [n.name for n in nodes]) for i in range(40)]
    for p in pods:
        p.node_name = ""
    a, _ = run_mode(k, nodes, pods, "wave")
    b, _ = run_mode(k, nodes, pods, "wave")
    assert [r.node_name for r in a] == [r.node_name for r in b]


def test_wave_second_batch_sees_committed_state(k):
    cache = k.SchedulerCache()
    cache.add_node(k.make_node("n0", cpu=1000, memory=2 * k.Gi))
    cache.add_node(k.make_node("n1", cpu=1000, memory=2 * k.Gi))
    eng = k.SchedulingEngine(cache, priorities=PRIO, **k.dev)
    [r1] = eng.schedule([k.make_pod("a", cpu=800, memory=k.Gi)], mode="wave")
    assert r1.node_name is not None
    other = {"n0": "n1", "n1": "n0"}[r1.node_name]
    [r2] = eng.schedule([k.make_pod("b", cpu=800, memory=k.Gi)], mode="wave")
    assert r2.node_name == other
    [r3] = eng.schedule([k.make_pod("c", cpu=800, memory=k.Gi)], mode="wave")
    assert r3.node_name is None and r3.fit_count == 0
