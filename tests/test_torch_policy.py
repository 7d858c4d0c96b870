"""The Policy algorithms in the port on the CPU against the reference
package's, exactly. Mirrors the reference's compatibility suite (itself a
mirror of Kubernetes v1.7's compatibility_test.go): the v1.7 knob set
parses to the same kernel priorities and algorithms; each knob
(NodeLabelPresence, ServiceAffinity, NodeLabel, ServiceAntiAffinity)
changes placements the same way in both packages, in wave and strict
mode; the randomized policy fuzz gives the same placements as the
reference engine and its object-level oracle; and the verdict
(evaluate_pod, evaluate_pods_batch) with an active Policy returns the
reference's fits and scores."""

from __future__ import annotations

import copy
import random

import numpy as np
import pytest

from kubernetes_tpu.api import policy as jpolicy
from kubernetes_tpu.api import types as jt
from kubernetes_tpu.engine import scheduler as jsched
from kubernetes_tpu.engine import scheduler_engine as jse
from kubernetes_tpu.ops import policy_algos as jpa
from kubernetes_tpu.server import apiserver_lite as japi
from kubernetes_tpu.state import cache as jcache
from kubernetes_tpu.state import snapshot as jsnap
from kubernetes_tpu_torch.api import policy as tpolicy
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.engine import scheduler as tsched
from kubernetes_tpu_torch.engine import scheduler_engine as tse
from kubernetes_tpu_torch.ops import policy_algos as tpa
from kubernetes_tpu_torch.server import apiserver_lite as tapi
from kubernetes_tpu_torch.state import cache as tcache
from kubernetes_tpu_torch.state import snapshot as tsnap
from tests.test_policy_compat import FUZZ_POLICY, V17_POLICY_JSON

Gi = 1 << 30
REF = dict(t=jt, policy=jpolicy, pa=jpa, se=jse, sched=jsched, api=japi,
           cache=jcache, snap=jsnap, kw={})
PORT = dict(t=tt, policy=tpolicy, pa=tpa, se=tse, sched=tsched, api=tapi,
            cache=tcache, snap=tsnap, kw={"device": "cpu"})

# the v1.7 knob set without its extender (the port runs no extender calls)
V17_NO_EXTENDER = V17_POLICY_JSON[:V17_POLICY_JSON.index(',\n  "extenders"')] \
    + "\n}"


def _both(fn):
    return fn(REF), fn(PORT)


def test_v17_policy_parses_to_the_same_algorithms():
    def run(side):
        pol = side["policy"].parse_policy(V17_POLICY_JSON)
        kernel_prios, algos = side["pa"].algorithms_from_policy(pol)
        return (len(pol.predicates), len(pol.priorities), kernel_prios,
                repr(algos.predicates), repr(algos.priorities),
                algos.active, pol.extenders[0].weight)

    ref, port = _both(run)
    assert port == ref
    assert port[:2] == (18, 9)
    assert ("NodePreferAvoidPodsPriority", 10000) in port[2]
    assert port[5] is True
    pol = tpolicy.parse_policy(V17_NO_EXTENDER)
    assert not pol.extenders and len(pol.priorities) == 9


def test_unknown_names_raise_alike():
    for side in (REF, PORT):
        with pytest.raises(ValueError, match="unknown predicate"):
            side["pa"].algorithms_from_policy(side["policy"].parse_policy(
                '{"predicates": [{"name": "NoSuchPredicate"}]}'))
        with pytest.raises(ValueError, match="unknown priority"):
            side["pa"].algorithms_from_policy(side["policy"].parse_policy(
                '{"priorities": [{"name": "NoSuchPriority", "weight": 1}]}'))


def _engine(side, nodes, existing, workloads, policy_json):
    kernel_prios, algos = side["pa"].algorithms_from_policy(
        side["policy"].parse_policy(policy_json))
    cache = side["cache"].SchedulerCache()
    for n in nodes:
        cache.add_node(n)
    for p in existing:
        cache.add_pod(copy.deepcopy(p))
    return side["se"].SchedulingEngine(
        cache, priorities=kernel_prios,
        workloads_provider=lambda: workloads, policy_algos=algos,
        **side["kw"])


def _place(side, mode, world, policy_json, n_pods=4, labels=None):
    t = side["t"]
    nodes, existing, workloads = world(t)
    eng = _engine(side, nodes, existing, workloads, policy_json)
    res = eng.schedule([t.make_pod(f"p{i}", cpu=100, labels=labels or {})
                        for i in range(n_pods)], mode=mode)
    return [(r.node_name, r.fit_count) for r in res], eng.rr.counter


NLP_REQUIRED = """{
  "predicates": [{"name": "P", "argument":
    {"labelsPresence": {"labels": ["foo"], "presence": true}}}],
  "priorities": [{"name": "EqualPriority", "weight": 1}]}"""
NLP_FORBIDDEN = """{
  "predicates": [{"name": "P", "argument":
    {"labelsPresence": {"labels": ["retiring"], "presence": false}}}],
  "priorities": [{"name": "EqualPriority", "weight": 1}]}"""
SA_POLICY = """{
  "predicates": [{"name": "SA", "argument":
    {"serviceAffinity": {"labels": ["region"]}}}],
  "priorities": [{"name": "EqualPriority", "weight": 1}]}"""
NODE_LABEL = """{
  "priorities": [{"name": "L", "weight": 4, "argument":
    {"labelPreference": {"label": "bar", "presence": true}}}]}"""
SAA_POLICY = """{
  "priorities": [{"name": "AA", "weight": 3, "argument":
    {"serviceAntiAffinity": {"label": "zone"}}}]}"""


def _svc(t):
    return t.WorkloadObject("Service", "svc", "default",
                            match_labels={"app": "a"})


KNOBS = {
    "labels_presence_required": (
        NLP_REQUIRED, lambda t: ([t.make_node("labeled", labels={"foo": "x"}),
                                  t.make_node("bare")], [], []),
        None, lambda got: all(n == "labeled" for n, _ in got)),
    "labels_presence_forbidden": (
        NLP_FORBIDDEN,
        lambda t: ([t.make_node("labeled", labels={"retiring": "2017"}),
                    t.make_node("bare")], [], []),
        None, lambda got: all(n == "bare" for n, _ in got)),
    "service_affinity_in_batch": (
        SA_POLICY, lambda t: ([t.make_node("a-r1", labels={"region": "r1"}),
                               t.make_node("b-r2", labels={"region": "r2"})],
                              [], [_svc(t)]),
        {"app": "a"}, lambda got: len({n[-2:] for n, _ in got}) == 1),
    "service_affinity_existing_region": (
        SA_POLICY,
        lambda t: ([t.make_node(f"n-r{r}-{i}", labels={"region": f"r{r}"})
                    for r in (1, 2) for i in range(2)],
                   [t.make_pod("svc-first", cpu=100, labels={"app": "a"},
                               node_name="n-r2-0")], [_svc(t)]),
        {"app": "a"}, lambda got: all(n.startswith("n-r2-") for n, _ in got)),
    "node_label_preference": (
        NODE_LABEL, lambda t: ([t.make_node("plain"),
                                t.make_node("preferred", labels={"bar": "1"})],
                               [], []),
        None, lambda got: all(n == "preferred" for n, _ in got)),
    "service_anti_affinity": (
        SAA_POLICY, lambda t: ([t.make_node("z1", labels={"zone": "z1"}),
                                t.make_node("z2", labels={"zone": "z2"})],
                               [t.make_pod("svc-0", cpu=100,
                                           labels={"app": "a"},
                                           node_name="z1")], [_svc(t)]),
        {"app": "a"}, lambda got: got[0][0] == "z2"),
}


@pytest.mark.parametrize("mode", ["strict", "wave"])
@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_each_knob_places_like_the_reference(knob, mode):
    policy_json, world, labels, holds = KNOBS[knob]
    ref, port = _both(lambda side: _place(side, mode, world, policy_json,
                                          labels=labels))
    assert port == ref
    assert holds(port[0]), port


def test_service_affinity_without_service_uses_node_selector_only():
    def run(side):
        t = side["t"]
        nodes = [t.make_node("r1", labels={"region": "r1"}),
                 t.make_node("r2", labels={"region": "r2"})]
        a = _engine(side, nodes, [], [], SA_POLICY).schedule(
            [t.make_pod("p0", cpu=100, node_selector={"region": "r2"})])
        b = _engine(side, nodes, [], [], SA_POLICY).schedule(
            [t.make_pod("p1", cpu=100)])
        return a[0].node_name, b[0].fit_count

    ref, port = _both(run)
    assert port == ref == ("r2", 2)


def test_scheduler_takes_a_policy_end_to_end():
    """Scheduler(policy=...) through the store, pipelined and classic."""
    def run(side):
        out = []
        for pipeline in (None, False):
            t = side["t"]
            api = side["api"].ApiServerLite()
            api.create("Node", t.make_node("labeled", labels={"foo": "x"}))
            api.create("Node", t.make_node("bare"))
            for i in range(3):
                api.create("Pod", t.make_pod(f"p{i}", cpu=100))
            s = side["sched"].Scheduler(
                api, record_events=False,
                policy=side["policy"].parse_policy("""{
              "predicates": [{"name": "P", "argument":
                {"labelsPresence": {"labels": ["foo"], "presence": true}}}],
              "priorities": [{"name": "LeastRequestedPriority",
                              "weight": 1}]}"""), **side["kw"])
            s.start()
            tot = s.run_until_drained(pipeline=pipeline)
            if side is PORT:
                s.engine.close()
            out.append((tot["bound"], sorted(
                (p.name, p.node_name) for p in api.list("Pod")[0])))
        return out

    ref, port = _both(run)
    assert port == ref
    assert all(b == 3 and all(n == "labeled" for _, n in placed)
               for b, placed in port)


def _fuzz_world(t, seed):
    rng = random.Random(seed)
    nodes = []
    for i in range(8):
        labels = {"host": f"h{i}"}
        if rng.random() < 0.8:
            labels["ok"] = "1"
        if rng.random() < 0.7:
            labels["region"] = f"r{rng.randint(0, 2)}"
        if rng.random() < 0.7:
            labels["zone"] = f"z{rng.randint(0, 2)}"
        if rng.random() < 0.5:
            labels["fast"] = "ssd"
        nodes.append(t.make_node(f"node-{i}", cpu=8000, memory=32 * Gi,
                                 labels=labels))
    apps = ["a", "b", "c"]
    workloads = [t.WorkloadObject("Service", f"svc-{a}", "default",
                                  match_labels={"app": a})
                 for a in apps if rng.random() < 0.8]
    existing = []
    for i in range(6):
        p = t.make_pod(f"bound-{i}", cpu=100,
                       labels={"app": rng.choice(apps)})
        p.node_name = rng.choice(nodes).name
        existing.append(p)
    pending = [t.make_pod(f"pend-{i}", cpu=rng.choice([100, 400]),
                          labels={"app": rng.choice(apps)})
               for i in range(12)]
    return nodes, existing, workloads, pending


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_fuzz_matches_reference(seed):
    """All four Policy knobs live on a random cluster: the strict engine
    of both packages and the wave engine of both packages, pod for pod."""
    def run(side):
        out = []
        for mode in ("strict", "wave"):
            nodes, existing, workloads, pending = _fuzz_world(side["t"],
                                                              seed)
            eng = _engine(side, nodes, existing, workloads, FUZZ_POLICY)
            res = eng.schedule(pending, mode=mode)
            out.append(([(r.node_name, r.fit_count) for r in res],
                        eng.rr.counter))
        return out

    ref, port = _both(run)
    assert port == ref
    assert any(n is not None for n, _ in port[0][0])


def _verdict_world(side):
    t = side["t"]
    nodes, existing, workloads, pending = _fuzz_world(t, 7)
    cache = side["cache"].SchedulerCache()
    for n in nodes:
        cache.add_node(n)
    for p in existing:
        cache.add_pod(p)
    snap = side["snap"].ClusterSnapshot()
    snap.refresh(cache.node_infos())
    kernel_prios, algos = side["pa"].algorithms_from_policy(
        side["policy"].parse_policy(FUZZ_POLICY))
    return cache, snap, workloads, pending, kernel_prios, algos


def test_evaluate_pod_with_an_active_policy_matches_reference():
    def run(side):
        cache, snap, wl, pending, prios, algos = _verdict_world(side)
        return [side["se"].evaluate_pod(p, cache.node_infos(), snap, prios,
                                        wl, policy_algos=algos,
                                        **side["kw"])
                for p in pending[:6]]

    ref, port = _both(run)
    for (gm, gs), (wm, ws) in zip(port, ref):
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gs, ws)
    assert any(m.any() for m, _ in port)


def test_evaluate_pods_batch_with_an_active_policy_matches_reference():
    def run(side):
        cache, snap, wl, pending, prios, algos = _verdict_world(side)
        return side["se"].evaluate_pods_batch(
            pending, cache.node_infos(), snap, prios, wl,
            policy_algos=algos, eval_cache=side["se"].EvalCache(),
            **side["kw"])

    ref, port = _both(run)
    assert len(port) == len(ref) == 12
    for (gm, gs), (wm, ws) in zip(port, ref):
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gs, ws)
