"""The hostname anti-affinity cell: its three readers, a whole tiny run at
a size where every pod has a node of its own, the faults it can see, and
on the card the port's first-wave mask and gate at the published size
held against the plain reference (reference/anti_mask.py)."""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import run
from benchmark.lib import faults

CELL = "antiaffinity-5k.backlog-2k"
READERS = ("aff_build_s.backlog", "gate_share_pct.backlog",
           "inner_waves.backlog", "forbid_cells.backlog")


def _run(counters, episodes=2):
    return SimpleNamespace(counters=counters,
                           res={"episodes": [{}] * episodes})


def test_new_readers_return_none_without_their_counters():
    """A program without the span and the three counters (the parent's)
    reads nothing, and raises nothing."""
    for name in READERS:
        assert run.reader(name)(_run({})) is None
    # a dispatch counted but no gate counter: still nothing
    assert run.reader("gate_share_pct.backlog")(_run(
        {"engine.wave_dispatch_pods": (4000, 0.0)})) is None


def test_new_readers_per_episode():
    c = {"pipeline.aff_build": (2, 0.25), "engine.wave_gate_rows": (3000, 0.0),
         "engine.wave_dispatch_pods": (4000, 0.0),
         "engine.inner_waves": (10, 0.0),
         "engine.wave_forbid_cells": (0, 0.0)}
    assert run.reader("aff_build_s.backlog")(_run(c)) == pytest.approx(0.125)
    assert run.reader("gate_share_pct.backlog")(_run(c)) == pytest.approx(75.0)
    assert run.reader("inner_waves.backlog")(_run(c)) == pytest.approx(5.0)
    # a counter read as 0 is a reading, not an absence
    assert run.reader("forbid_cells.backlog")(_run(c)) == 0.0
    c["engine.wave_forbid_cells"] = (3000, 0.0)
    assert run.reader("forbid_cells.backlog")(_run(c)) == 1500.0


# 20 pods an episode on the tiny fixture's 30 nodes: each pod's term keeps
# it off every node that holds another, so the episode must fit one a node
FITS = {"pods_per_episode": 20, "settle_s": 3.0}


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_where_every_pod_fits(trace, tiny_spec):
    line = run.run_cell(tiny_spec, CELL, 2**31 + 4242, 0.6, bool(trace),
                        device="cpu", params=dict(FITS))
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 40
    assert line["checks"]["anti_own"]["value"] == 0
    assert line["checks"]["anti_sym"]["value"] == 0
    got = line["metrics"]
    if trace:
        assert got["aff_builds.backlog"]["value"] >= 1
        assert got["aff_build_s.backlog"]["value"] > 0
        assert got["gate_share_pct.backlog"]["value"] == 100.0
        assert got["inner_waves.backlog"]["value"] >= 1
        assert got["forbid_cells.backlog"]["value"] >= 0
    else:
        assert got["backlog_pods_s"]["value"] > 0


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_planted_fault_turns_correct_false_where_every_pod_fits(
        kind, tiny_spec):
    """first_fit is left out: every empty node scores alike for these
    pods, so a first-fit placement is a best one (score_regret 0)."""
    try:
        line = run.run_cell(tiny_spec, CELL, 78, 0.4, False, device="cpu",
                            params=dict(FITS), tweak=faults.tweak(kind))
    finally:
        faults.undo()
    assert line["correct"] is False
    if kind == "altered":
        assert line["checks"]["anti_own"]["value"] > 0


def _first_waves(spec, device, nodes, bound_n, block):
    """upstream's state before its measured pods: `bound_n` bound pods of
    the template on as many of `nodes` nodes, `bound_n` pending. The
    port's first-wave mask equals the reference's forbidden nodes,
    computed on `device` in blocks of `block` nodes, and every wave's
    gate admits what the reference's gate admits."""
    import json

    import torch

    from benchmark.gen.cluster import HOSTNAME_KEY, make_cluster
    from benchmark.gen.pods import make_pods
    from benchmark.lib.adapter import port_nodes, port_pods
    from benchmark.reference import anti_mask
    from kubernetes_tpu_torch.engine import waves
    from kubernetes_tpu_torch.engine.scheduler_engine import \
        SchedulingEngine
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.utils.trace import COUNTERS

    conf_file = {c["name"]: c["file"] for c in spec["configs"]}[
        "antiaffinity-5k"]
    with open(run.ROOT / conf_file) as f:
        conf = json.load(f)
    conf["cluster"]["nodes"] = nodes
    seed = 2**31 + 2024
    cluster = make_cluster(conf, seed)
    podset = make_pods(conf, 2 * bound_n, seed, 0, prefix="p-")
    pods = port_pods(podset)
    on = np.random.default_rng(seed).permutation(len(cluster))[:bound_n]
    cache = SchedulerCache()
    for nd in port_nodes(cluster):
        cache.add_node(nd)
    for i, node in enumerate(on):
        pods[i].node_name = cluster.names[int(node)]
        cache.add_pod(pods[i])
    eng = SchedulingEngine(cache, device=device)
    seen = []
    real = waves._wave_once

    def spy(cls, nodes, state, pre, pod_class, active, counter, priorities,
            aff=None, committed=None, col=None):
        out = real(cls, nodes, state, pre, pod_class, active, counter,
                   priorities, aff=aff, committed=committed, col=col)
        seen.append({"mask": waves._wave_aff_mask(aff, committed).cpu(),
                     "gate": aff["wave_gate"].cpu(),
                     "pod_class": pod_class.cpu(), "active": active.cpu(),
                     "sel": out[0].cpu(), "accepted": out[1].cpu()})
        return out

    waves._wave_once = spy
    c0 = COUNTERS.snapshot().get("engine.wave_forbid_cells", (0, 0.0))[0]
    try:
        h = eng.dispatch_waves(pods[bound_n:])
        res = eng.harvest_waves(h)
    finally:
        waves._wave_once = real
        eng.close()
    forbid_cells = COUNTERS.snapshot()["engine.wave_forbid_cells"][0] - c0
    assert len(res.bound) == bound_n and seen
    order = eng.snapshot.node_names
    n_pad = seen[0]["mask"].shape[1]
    index = {nm: i for i, nm in enumerate(cluster.names)}
    rows = [index.get(nm, -1) for nm in order] + [-1] * (n_pad - len(order))
    host = cluster.domain(HOSTNAME_KEY)
    dom = torch.tensor([int(host[r]) if r >= 0 else -1 for r in rows],
                       dtype=torch.int64, device=device)
    row_of = {nm: i for i, nm in enumerate(order)}
    t = podset.templates[0]
    bound = [(dict(t.labels), list(t.anti),
              row_of[cluster.names[int(node)]]) for node in on]
    ref = anti_mask.forbidden({HOSTNAME_KEY: dom}, bound,
                              [(dict(t.labels), list(t.anti))],
                              block=block).cpu()
    real_rows = torch.tensor([r >= 0 for r in rows])
    assert int(ref[0][real_rows].sum()) == bound_n
    c = int(h.pc[0])
    assert torch.equal(seen[0]["mask"][c][real_rows], ~ref[0][real_rows])
    # the dispatch counted the cells its first wave forbade: one class,
    # the bound pods' nodes
    assert forbid_cells == bound_n
    for w in seen:
        sel = torch.where(w["active"], w["sel"], -1)
        admit = anti_mask.gate_accept(sel, w["pod_class"], w["gate"])
        acc = w["accepted"] & w["active"]
        assert not (acc & ~admit).any()
        gated = w["gate"][w["pod_class"].long()] & (sel >= 0)
        assert torch.equal(acc[gated], admit[gated])
    # every pending pod placed off the bound pods' nodes, one a node
    placed = {p.node_name for p in res.bound}
    assert len(placed) == bound_n
    assert not placed & {cluster.names[int(node)] for node in on}


def test_first_waves_at_a_tiny_size(spec):
    _first_waves(spec, "cpu", 120, 40, 50)


@pytest.mark.card
def test_first_waves_at_the_published_size(card, spec):
    _first_waves(spec, card, 5000, 1000, 1000)
