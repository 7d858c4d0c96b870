"""Host-check and Policy chunks on the port's pipelined drain, held against
the reference package's on the CPU, exactly. Mirrors the reference's own
suite of the same routes (label-pure host-check classes ride the wave with
a precomputed host_fit column; live-state host-check classes ride as
inactive rows and place at the harvest's exact oracle tail; Policy chunks
carry frozen policy columns and an exact fence re-check): each scenario
runs through both packages and the classifications, placements, fence
verdicts and counters must be equal, as well as right."""

from __future__ import annotations

import copy

import pytest

from kubernetes_tpu.api import policy as jpolicy
from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api import workloads as jw
from kubernetes_tpu.engine import scheduler as jsched
from kubernetes_tpu.engine import scheduler_engine as jse
from kubernetes_tpu.models import hollow as jh
from kubernetes_tpu.observability import podtrace as jpt
from kubernetes_tpu.ops import policy_algos as jpalgos
from kubernetes_tpu.server import apiserver_lite as japi
from kubernetes_tpu.state import cache as jcache
from kubernetes_tpu.utils import trace as jtrace
from kubernetes_tpu_torch.api import policy as tpolicy
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api import workloads as tw
from kubernetes_tpu_torch.engine import scheduler as tsched
from kubernetes_tpu_torch.engine import scheduler_engine as tse
from kubernetes_tpu_torch.models import hollow as th
from kubernetes_tpu_torch.observability import podtrace as tpt
from kubernetes_tpu_torch.ops import policy_algos as tpalgos
from kubernetes_tpu_torch.server import apiserver_lite as tapi
from kubernetes_tpu_torch.state import cache as tcache
from kubernetes_tpu_torch.utils import trace as ttrace

Gi = 1 << 30
REF = dict(t=jt, wl=jw, policy=jpolicy, sched=jsched, se=jse, hollow=jh,
           pt=jpt, api=japi, cache=jcache, COUNTERS=jtrace.COUNTERS, kw={})
PORT = dict(t=tt, wl=tw, policy=tpolicy, sched=tsched, se=tse, hollow=th,
            pt=tpt, api=tapi, cache=tcache, COUNTERS=ttrace.COUNTERS,
            kw={"device": "cpu"})
SIDES = (REF, PORT)

NLP_POLICY = """{
  "predicates": [{"name": "CustomLabelsPresence", "argument":
    {"labelsPresence": {"labels": ["foo"], "presence": true}}}],
  "priorities": [{"name": "EqualPriority", "weight": 1}]}"""

COUNTER_KEYS = ("stream.chunk_flush", "engine.wave_dispatch",
                "engine.wave_host_rows", "engine.wave_host_tail",
                "engine.hostcheck_fence_requeues",
                "engine.policy_fence_requeues",
                "engine.fence_reason_host_check", "engine.fence_reason_policy",
                "engine.fence_reason_capacity")


def _counts(side):
    snap = side["COUNTERS"].snapshot()
    return {k: snap.get(k, (0, 0))[0] for k in COUNTER_KEYS}


def zone_term(t, z):
    return t.NodeSelectorTerm([t.SelectorRequirement(
        "zone", t.SelectorOperator.IN, [z])])


def overflow_affinity(t, zone, n_bogus=4):
    """5 ORed required terms (past the encoding's 4) -> a host-check
    class; only `zone` exists on any node."""
    terms = [zone_term(t, zone)] + [zone_term(t, f"bogus-{i}")
                                    for i in range(n_bogus)]
    return t.Affinity(node_affinity=t.NodeAffinity(required_terms=terms))


def ports_pod(t, name, n_ports=10, **kw):
    """More host ports than the encoding holds -> a live-state host-check
    class: an inactive row placed by the exact oracle tail."""
    p = t.make_pod(name, cpu=100, memory=128 << 20, **kw)
    p.containers[0].ports = [t.ContainerPort(host_port=9000 + i)
                             for i in range(n_ports)]
    return p


def _engine(side, nodes):
    cache = side["cache"].SchedulerCache()
    for nd in nodes:
        cache.add_node(nd)
    return cache, side["se"].SchedulingEngine(cache, **side["kw"])


def _mk_sched(side, nodes, pods, chunk, policy=None):
    api = side["api"].ApiServerLite()
    side["hollow"].load_cluster(api, nodes, pods)
    pol = side["policy"].parse_policy(policy) if policy else None
    s = side["sched"].Scheduler(api, record_events=False, policy=pol,
                                **side["kw"])
    s.pipeline_chunk = chunk
    s.start()
    return api, s


def _placements(api):
    return {p.name: p.node_name for p in api.list("Pod")[0]}


def _both(fn):
    out = []
    for side in SIDES:
        side["COUNTERS"].reset()
        out.append(fn(side))
    return out


def test_host_static_vs_dynamic_classification():
    """Label-pure causes become host_static (exact column, active on the
    wave); live-state causes become host_exact (inactive row, oracle
    tail). Both packages classify and place alike."""
    def run(side):
        t = side["t"]
        _, eng = _engine(side, [
            t.make_node(f"n{i}", cpu=4000, memory=16 * Gi, pods=110,
                        labels={"zone": f"z{i}"}) for i in range(4)])
        static_pod = t.make_pod("hs", cpu=100, memory=128 << 20)
        static_pod.affinity = overflow_affinity(t, "z1")
        pods = [static_pod, ports_pod(t, "hx"),
                t.make_pod("plain", cpu=100, memory=128 << 20)]
        handle = eng.dispatch_waves(pods)
        enc, pc = handle.enc, handle.pc
        cls = [(bool(enc.host_static[c]), bool(enc.host_exact[c]))
               for c in pc]
        h = eng.harvest_waves(handle)
        return (cls, handle.host_idx.tolist(),
                {p.name: p.node_name for p in h.bound},
                len(h.unschedulable), len(h.conflicts), eng.rr.counter)

    ref, port = _both(run)
    assert port == ref
    cls, host_idx, bound = port[:3]
    assert cls == [(True, False), (False, True), (False, False)]
    assert host_idx == [1]
    assert bound["hs"] == "n1" and set(bound) == {"hs", "hx", "plain"}
    assert port[3:5] == (0, 0)


def test_host_exact_only_chunk_dispatches():
    """A chunk that is entirely live-state host-check still dispatches;
    the oracle tail places it, holding host-port exclusivity."""
    def run(side):
        t = side["t"]
        _, eng = _engine(side, [
            t.make_node(f"n{i}", cpu=4000, memory=16 * Gi, pods=110)
            for i in range(2)])
        h = eng.harvest_waves(eng.dispatch_waves(
            [ports_pod(t, "hx-0"), ports_pod(t, "hx-1")]))
        return ({p.name: p.node_name for p in h.bound}, eng.rr.counter,
                _counts(side))

    ref, port = _both(run)
    assert port == ref
    assert set(port[0]) == {"hx-0", "hx-1"}
    assert len(set(port[0].values())) == 2
    assert port[2]["engine.wave_host_tail"] == 2


def _mixed_world(t):
    nodes = [t.make_node(f"n{i}", cpu=8000, memory=32 * Gi, pods=110,
                         labels={"zone": f"z{i % 4}", "foo": "x"})
             for i in range(6)]
    nodes += [t.make_node(f"bare{i}", cpu=8000, memory=32 * Gi, pods=110)
              for i in range(2)]
    pods = [t.make_pod(f"plain-{i}", cpu=100, memory=128 << 20)
            for i in range(6)]
    for i in range(4):
        p = t.make_pod(f"hs-{i}", cpu=100, memory=128 << 20)
        p.affinity = overflow_affinity(t, f"z{i % 4}")
        pods.append(p)
    pods.append(ports_pod(t, "hx-0"))
    return nodes, pods


def test_mixed_hostcheck_policy_drain_matches_reference():
    """A drain of plain + host_static + host_exact pods under a Policy:
    equal placements, totals and counters, no pipeline flush, and every
    constraint held."""
    def run(side):
        nodes, pods = _mixed_world(side["t"])
        api, s = _mk_sched(side, nodes, pods, chunk=4, policy=NLP_POLICY)
        tot = s.run_until_drained()
        if side is PORT:
            s.engine.close()
        return _placements(api), tot, s.engine.rr.counter, _counts(side)

    ref, port = _both(run)
    assert port == ref
    got, tot, _, cnt = port
    assert tot["bound"] == 11
    assert cnt["stream.chunk_flush"] == 0
    assert cnt["engine.wave_dispatch"] >= 2
    assert cnt["engine.wave_host_rows"] >= 1
    assert cnt["engine.wave_host_tail"] >= 1
    nodes, _ = _mixed_world(tt)
    zone = {n.name: n.labels.get("zone") for n in nodes}
    assert not any(v.startswith("bare") for v in got.values())
    for i in range(4):
        assert zone[got[f"hs-{i}"]] == f"z{i % 4}"


def _unique_winner_trace(t):
    nodes = [t.make_node(f"n{i}", cpu=8000, memory=32 * Gi, pods=110,
                         labels={"zone": f"z{i}", "foo": "x"})
             for i in range(6)]
    pods = []
    for i in range(4):
        p = t.make_pod(f"hs-{i}", cpu=100, memory=128 << 20)
        p.affinity = overflow_affinity(t, f"z{i}")
        pods.append(p)
    pods.append(ports_pod(t, "hx-0", node_selector={"zone": "z4"}))
    pods.append(t.make_pod("pin-5", cpu=100, memory=128 << 20,
                           node_selector={"zone": "z5"}))
    return nodes, pods


@pytest.mark.parametrize("policy", [None, NLP_POLICY],
                         ids=["hostcheck", "policy"])
def test_wave_routes_match_classic_round(policy):
    """The same trace through the pipelined drain, the classic round and
    the drain with overlap off: one placement set, in both packages."""
    def run(side):
        out = []
        for kw in ({}, {"pipeline": False}, {"overlap": False}):
            nodes, pods = _unique_winner_trace(side["t"])
            api, s = _mk_sched(side, copy.deepcopy(nodes),
                               copy.deepcopy(pods), chunk=3, policy=policy)
            s.run_until_drained(**kw)
            if side is PORT:
                s.engine.close()
            out.append(_placements(api))
        return out

    ref, port = _both(run)
    assert port == ref
    assert port[0] == port[1] == port[2] == {
        "hs-0": "n0", "hs-1": "n1", "hs-2": "n2", "hs-3": "n3",
        "hx-0": "n4", "pin-5": "n5"}


def _relabel_run(side, relabel):
    t = side["t"]
    n0 = t.make_node("n0", cpu=4000, memory=16 * Gi, pods=110,
                     labels={"zone": "z0"})
    n1 = t.make_node("n1", cpu=4000, memory=16 * Gi, pods=110,
                     labels={"zone": "zx"})
    cache, eng = _engine(side, [n0, n1])
    pod = t.make_pod("hs", cpu=100, memory=128 << 20)
    pod.affinity = overflow_affinity(t, "z0")
    side["COUNTERS"].reset()
    handle = eng.dispatch_waves([pod])
    static = bool(handle.enc.host_static[handle.pc[0]])
    if relabel:
        # the blind window: z0 moves from n0 to n1 while the wave flies
        n0b = copy.deepcopy(n0)
        n0b.labels = {"zone": "zb"}
        n1b = copy.deepcopy(n1)
        n1b.labels = {"zone": "z0"}
        cache.update_node(n0b)
        cache.update_node(n1b)
    h = eng.harvest_waves(handle)
    first = ([(p.name, p.node_name) for p in h.bound],
             [p.name for p in h.conflicts], list(h.conflict_reasons),
             _counts(side))
    second = None
    if h.conflicts:
        h2 = eng.harvest_waves(eng.dispatch_waves([pod]))
        second = [(p.name, p.node_name) for p in h2.bound]
    return static, first, second


def test_relabel_in_flight_requeues_hostcheck():
    """A relabel landing while a host_static wave flies makes the baked
    column stale: the fence requeues with REASON_HOSTCHECK, and the
    re-dispatch places on the node that now matches."""
    ref, port = _both(lambda side: _relabel_run(side, True))
    assert port == ref
    static, (bound, conflicts, reasons, cnt), second = port
    assert static and not bound and conflicts == ["hs"]
    assert reasons == [tpt.REASON_HOSTCHECK] == [jpt.REASON_HOSTCHECK]
    assert cnt["engine.hostcheck_fence_requeues"] == 1
    assert cnt["engine.fence_reason_host_check"] == 1
    assert second == [("hs", "n1")]


def test_fresh_labels_do_not_requeue_hostcheck():
    ref, port = _both(lambda side: _relabel_run(side, False))
    assert port == ref
    static, (bound, conflicts, _, cnt), second = port
    assert static and bound == [("hs", "n0")] and not conflicts
    assert cnt["engine.hostcheck_fence_requeues"] == 0
    assert second is None


def test_service_affinity_drain_keeps_one_region():
    """One Service's pods under ServiceAffinity on `region`, in chunks:
    the service-coupled class is order-dependent, so it rides to the
    exact oracle tail and every pod lands in the first pod's region — in
    both packages alike."""
    pol = """{
      "predicates": [{"name": "SA", "argument":
        {"serviceAffinity": {"labels": ["region"]}}}],
      "priorities": [{"name": "EqualPriority", "weight": 1}]}"""

    def run(side):
        t = side["t"]
        nodes = [t.make_node(f"r{r}-{i}", cpu=8000, memory=32 * Gi,
                             pods=110, labels={"region": f"r{r}"})
                 for r in range(2) for i in range(3)]
        pods = [t.make_pod(f"s-{i}", cpu=100, memory=128 << 20,
                           labels={"app": "a"}) for i in range(12)]
        pods += [t.make_pod(f"free-{i}", cpu=100, memory=128 << 20)
                 for i in range(6)]
        api = side["api"].ApiServerLite()
        api.create("Service", side["wl"].Service(
            "svc", "default", selector={"app": "a"}))
        side["hollow"].load_cluster(api, nodes, pods)
        s = side["sched"].Scheduler(
            api, record_events=False,
            policy=side["policy"].parse_policy(pol), **side["kw"])
        s.pipeline_chunk = 4
        s.start()
        tot = s.run_until_drained()
        if side is PORT:
            s.engine.close()
        return _placements(api), tot, _counts(side)

    ref, port = _both(run)
    assert port == ref
    got, tot, cnt = port
    assert tot["bound"] == 18
    assert len({got[f"s-{i}"].split("-")[0] for i in range(12)}) == 1
    assert cnt["engine.wave_host_tail"] == 12
    assert cnt["stream.chunk_flush"] == 0


def test_policy_fence_requeues_a_relabelled_row():
    """Label presence under a Policy: the frozen policy_fit column admits
    both nodes at dispatch; `foo` leaves n0 while the wave flies, so the
    fence's exact re-check requeues the rows on n0 with REASON_POLICY."""
    def run(side):
        t = side["t"]
        n0 = t.make_node("n0", cpu=4000, memory=16 * Gi, pods=110,
                         labels={"foo": "x"})
        n1 = t.make_node("n1", cpu=4000, memory=16 * Gi, pods=110,
                         labels={"foo": "x"})
        cache = side["cache"].SchedulerCache()
        cache.add_node(n0)
        cache.add_node(n1)
        algos = (jpalgos if side is REF else tpalgos).algorithms_from_policy(
            side["policy"].parse_policy(NLP_POLICY))[1]
        eng = side["se"].SchedulingEngine(cache, policy_algos=algos,
                                          **side["kw"])
        pods = [t.make_pod(f"p{i}", cpu=100, memory=128 << 20)
                for i in range(4)]
        handle = eng.dispatch_waves(pods)
        n0b = copy.deepcopy(n0)
        n0b.labels = {}
        cache.update_node(n0b)
        h = eng.harvest_waves(handle)
        return ([(p.name, p.node_name) for p in h.bound],
                [p.name for p in h.conflicts], list(h.conflict_reasons),
                _counts(side))

    ref, port = _both(run)
    assert port == ref
    bound, conflicts, reasons, cnt = port
    assert conflicts and all(n == "n1" for _, n in bound)
    assert set(reasons) == {tpt.REASON_POLICY}
    assert cnt["engine.policy_fence_requeues"] == len(conflicts)
    assert cnt["engine.fence_reason_policy"] == len(conflicts)
