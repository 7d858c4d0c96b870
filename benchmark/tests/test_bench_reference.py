"""The reference catches each planted fault, and the controls read as not
correct while the plain placer reads as correct."""

import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

from benchmark.gen.cluster import make_cluster
from benchmark.gen.pods import make_pods
from benchmark.gen.cluster import HOSTNAME_KEY, ZONE_KEY
from benchmark.reference.check import aggregate, check, failing
from benchmark.reference.placer import place

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
Mi = 1 << 20


def _term(app, key):
    return [{"match_labels": {"app": app}, "topology_key": key}]


# every kind of required term both ways, in three zones: pods with
# hostname anti-affinity against their own app, pods with zone affinity
# with their own app, plain pods labelled like the anti apps, plain pods
MIXED = {"cluster": {"nodes": 40, "zones": ["a", "b", "c"],
                     "name_prefix": "n",
                     "node_template": {"cpu_milli": 4000, "pods": 110,
                                       "memory_bytes": 32 << 30}},
         "pods": {"generator": "shares", "namespace": "t", "templates":
                  [{"share": 0.05, "cpu_milli": 100, "memory_bytes": 256 * Mi,
                    "labels": {"app": f"iso-{a}"},
                    "anti": _term(f"iso-{a}", HOSTNAME_KEY)}
                   for a in range(3)]
                  + [{"share": 0.01, "cpu_milli": 100,
                      "memory_bytes": 256 * Mi, "labels": {"app": f"pack-{a}"},
                      "affinity": _term(f"pack-{a}", ZONE_KEY)}
                     for a in range(2)]
                  + [{"share": 0.05, "cpu_milli": 100,
                      "memory_bytes": 500 * Mi, "labels": {"app": "iso-0"}},
                     {"share": 0.78, "cpu_milli": 100,
                      "memory_bytes": 500 * Mi, "labels": {"app": "web"}}]}}


def world(config, nodes=40, pods=600, seed=3):
    conf = MIXED if config == "mixed" else json.loads(
        (CONFIGS / f"{config}.json").read_text())
    conf = json.loads(json.dumps(conf))
    conf["cluster"]["nodes"] = nodes
    cluster = make_cluster(conf, seed)
    return conf, cluster, make_pods(conf, pods, seed, 1, "p-")


CONFIG_NAMES = sorted(p.stem for p in CONFIGS.glob("*.json")) + ["mixed"]


@pytest.mark.parametrize("config", CONFIG_NAMES)
def test_plain_placer_is_correct(config):
    _, cluster, ps = world(config)
    assert failing(aggregate([check(cluster, ps, place(cluster, ps))])) == []


@pytest.mark.parametrize("config,control,fails", [
    (c, "first_fit", "score_regret") for c in CONFIG_NAMES] + [
    ("mixed", "skip_symmetry", "anti_sym")])
def test_control_is_not_correct(config, control, fails):
    _, cluster, ps = world(config)
    got = aggregate([check(cluster, ps, place(cluster, ps, control))])
    assert fails in failing(got), got


def judge(cluster, ps, out):
    return aggregate([check(cluster, ps, out)])


def _good(config="mixed"):
    _, cluster, ps = world(config)
    return cluster, ps, place(cluster, ps)


def test_pod_bound_twice():
    cluster, ps, out = _good()
    count = out.bind_count.copy()
    count[5] = 2
    assert failing(judge(cluster, ps, replace(out, bind_count=count))) == [
        "double_binds"]


def test_acknowledged_bind_not_read_back():
    cluster, ps, out = _good()
    node = out.node_of.copy()
    node[7] = -1
    got = judge(cluster, ps, replace(out, node_of=node))
    assert got["unread_binds"] == 1


def test_node_over_capacity():
    cluster, ps, out = _good("density-5k")
    node = np.where(np.arange(len(ps)) < 120, 0, out.node_of)
    assert "over_capacity" in failing(judge(cluster, ps,
                                            replace(out, node_of=node)))


def _iso_pair(ps, out):
    """An anti-affinity pod and a pod of its app on another host."""
    tpl = ps.templates
    iso = [i for i in range(len(ps)) if tpl[ps.tmpl[i]].anti]
    a = iso[0]
    app = tpl[ps.tmpl[a]].labels["app"]
    b = next(i for i in range(len(ps)) if i != a and
             tpl[ps.tmpl[i]].labels.get("app") == app and
             out.node_of[i] != out.node_of[a])
    return a, b


def test_anti_affinity_broken_by_the_later_pod_itself():
    cluster, ps, out = _good()
    a, b = _iso_pair(ps, out)
    first, later = (a, b) if out.bind_rv[a] < out.bind_rv[b] else (b, a)
    node = out.node_of.copy()
    node[later] = node[first]
    # the later pod is the anti pod, or the earlier one is: both directions
    got = judge(cluster, ps, replace(out, node_of=node))
    assert got["anti_own"] + got["anti_sym"] >= 1


@pytest.mark.parametrize("direction", ["anti_own", "anti_sym"])
def test_anti_affinity_broken_in_either_direction(direction):
    cluster, ps, out = _good()
    a, b = _iso_pair(ps, out)        # a carries the term, b matches it
    node, rv = out.node_of.copy(), out.bind_rv.copy()
    node[b] = node[a]
    hi = rv.max() + 10
    # anti_own: the term's pod joins the matching pod's host later;
    # anti_sym: the matching pod joins the term's pod's host later
    rv[a], rv[b] = (hi + 1, hi) if direction == "anti_own" else (hi, hi + 1)
    got = judge(cluster, ps, replace(out, node_of=node, bind_rv=rv))
    assert got[direction] >= 1


def test_affinity_group_split_across_zones():
    cluster, ps, out = _good()
    tpl = ps.templates
    pack = [i for i in range(len(ps)) if tpl[ps.tmpl[i]].aff]
    i = max(pack, key=lambda j: out.bind_rv[j])
    node = out.node_of.copy()
    zone = cluster.zone[node[i]]
    node[i] = int(np.nonzero(cluster.zone != zone)[0][0])
    assert judge(cluster, ps, replace(out, node_of=node))["affinity"] >= 1


def test_pending_pod_that_fits():
    cluster, ps, out = _good("density-5k")
    node = out.node_of.copy()
    node[11] = -1
    acked = out.acked.copy()
    acked[11] = False
    got = judge(cluster, ps, replace(out, node_of=node, acked=acked))
    assert failing(got) == ["pending_fit"]


@pytest.mark.parametrize("config", CONFIG_NAMES)
def test_bind_not_the_best_scoring_one(config):
    """Binds sent to the fullest node that still fits them, instead of
    their best one: every pod whose index is a multiple of 8."""
    from benchmark.reference.check import LIMITS, score_regret
    cluster, ps, out = _good(config)
    node = out.node_of.copy()
    counts = np.zeros(len(cluster), dtype=np.int64)
    for i in np.argsort(out.bind_rv):
        if i % 8 == 0:
            room = counts < 36
            node[i] = int(np.argmax(np.where(room, counts, -1)))
        counts[node[i]] += 1
    bad = replace(out, node_of=node)
    pts, pods = score_regret(cluster, ps, bad)
    assert pts / pods > LIMITS["score_regret"]
    assert "score_regret" in failing(judge(cluster, ps, bad))
