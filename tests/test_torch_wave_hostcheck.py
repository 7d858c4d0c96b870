"""The reference's host-check + Policy on the wave path
(tests/test_wave_hostcheck.py) on both packages: label-pure host-check
classes ride the fused evaluation as a precomputed host_fit column,
dynamic ones ride as inactive rows to the harvest's exact oracle tail,
Policy chunks ride with frozen columns and a fence-side re-check, and no
chunk shape flushes the pipeline. Each body runs through the `k` fixture
with every Scheduler and SchedulingEngine of the port on the CPU."""

from __future__ import annotations

import copy

import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "policy": "api.policy",
    "api_types": "api.types",
    "sched": "engine.scheduler",
    "engine": "engine.scheduler_engine",
    "hollow": "models.hollow",
    "podtrace": "observability.podtrace",
    "apiserver_lite": "server.apiserver_lite",
    "cache": "state.cache",
    "trace": "utils.trace",
}

PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}
DEVICE = {REF: {}, PORT: {"device": "cpu"}}

Gi = 1 << 30


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


def _engine(k, cache):
    return k.engine.SchedulingEngine(cache, **DEVICE[k.root])


def zone_term(k, z):
    return k.NodeSelectorTerm([k.SelectorRequirement(
        "zone", k.SelectorOperator.IN, [z])])


def overflow_affinity(k, zone, n_bogus=4):
    """5 ORed required terms (> max_terms=4) -> the class overflows the
    batch encoding and becomes a host-check class; only `zone` exists on
    any node, so the pod has a unique feasible zone."""
    terms = [zone_term(k, zone)] + [zone_term(k, f"bogus-{i}")
                                    for i in range(n_bogus)]
    return k.Affinity(node_affinity=k.NodeAffinity(required_terms=terms))


def ports_pod(k, name, n_ports=10, **kw):
    """> MAX_PORTS_PER_POD host ports -> dynamic host-check (live pod
    state), rides as an inactive row to the exact oracle tail."""
    p = k.make_pod(name, cpu=100, memory=128 << 20, **kw)
    p.containers[0].ports = [k.ContainerPort(host_port=9000 + i)
                             for i in range(n_ports)]
    return p


def mk_sched(k, nodes, pods, chunk, policy=None):
    api = k.ApiServerLite()
    k.load_cluster(api, nodes, pods)
    s = k.sched.Scheduler(api, record_events=False, policy=policy,
                          **DEVICE[k.root])
    s.pipeline_chunk = chunk
    s.start()
    return api, s


def placements(api):
    return {p.name: p.node_name for p in api.list("Pod")[0]}


# ------------------------------------------------------- classification


def test_host_static_vs_dynamic_classification(k):
    """The split that makes the ride possible: label-pure causes become
    host_static (exact precomputed column, stays active on the wave);
    live-state causes become host_exact (inactive row, oracle tail)."""
    cache = k.SchedulerCache()
    for i in range(4):
        cache.add_node(k.make_node(f"n{i}", cpu=4000, memory=16 * Gi,
                                   pods=110, labels={"zone": f"z{i}"}))
    eng = _engine(k, cache)
    static_pod = k.make_pod("hs", cpu=100, memory=128 << 20)
    static_pod.affinity = overflow_affinity(k, "z1")
    plain = k.make_pod("plain", cpu=100, memory=128 << 20)
    pods = [static_pod, ports_pod(k, "hx"), plain]
    handle = eng.dispatch_waves(pods)
    assert handle is not None, "host-check chunks must dispatch"
    enc, pc = handle.enc, handle.pc
    assert enc.host_static[pc[0]] and not enc.host_exact[pc[0]]
    assert enc.host_exact[pc[1]] and not enc.host_static[pc[1]]
    assert not enc.host_static[pc[2]] and not enc.host_exact[pc[2]]
    h = eng.harvest_waves(handle)
    by_name = {p.name: p.node_name for p in h.bound}
    assert by_name["hs"] == "n1", by_name  # exact host_fit column applied
    assert "hx" in by_name and "plain" in by_name
    assert not h.unschedulable and not h.conflicts


def test_host_exact_only_chunk_dispatches(k):
    """A chunk that is ENTIRELY dynamic host-check still dispatches (the
    wave retires immediately; the tail places everything) — no shape
    triggers the classic fallback."""
    cache = k.SchedulerCache()
    cache.add_node(k.make_node("n0", cpu=4000, memory=16 * Gi, pods=110))
    cache.add_node(k.make_node("n1", cpu=4000, memory=16 * Gi, pods=110))
    eng = _engine(k, cache)
    handle = eng.dispatch_waves([ports_pod(k, "hx-0"), ports_pod(k, "hx-1")])
    assert handle is not None
    h = eng.harvest_waves(handle)
    assert {p.name for p in h.bound} == {"hx-0", "hx-1"}
    # host-port exclusivity held by the FIFO oracle tail (assume between
    # pods): the two 10-port pods cannot share a node
    assert len({p.node_name for p in h.bound}) == 2


# ------------------------------------------------- the no-flush routing


NLP_POLICY = """{
  "predicates": [{"name": "CustomLabelsPresence", "argument":
    {"labelsPresence": {"labels": ["foo"], "presence": true}}}],
  "priorities": [{"name": "EqualPriority", "weight": 1}]}"""


def test_mixed_hostcheck_policy_drain_never_flushes(k):
    """The routing guard: a mixed drain of plain + host_static +
    host_exact + Policy-constrained chunks must complete with ZERO
    pipeline flushes (span counters prove it) while every constraint
    holds exactly."""
    nodes = [k.make_node(f"n{i}", cpu=8000, memory=32 * Gi, pods=110,
                         labels={"zone": f"z{i % 4}", "foo": "x"})
             for i in range(6)]
    nodes += [k.make_node(f"bare{i}", cpu=8000, memory=32 * Gi, pods=110)
              for i in range(2)]  # no foo -> Policy must exclude these
    pods = []
    for i in range(6):
        pods.append(k.make_pod(f"plain-{i}", cpu=100, memory=128 << 20))
    for i in range(4):
        p = k.make_pod(f"hs-{i}", cpu=100, memory=128 << 20)
        p.affinity = overflow_affinity(k, f"z{i % 4}")
        pods.append(p)
    pods.append(ports_pod(k, "hx-0"))
    COUNTERS = k.trace.COUNTERS
    COUNTERS.reset()
    api, s = mk_sched(k, nodes, pods, chunk=4,
                      policy=k.parse_policy(NLP_POLICY))
    tot = s.run_until_drained()
    snap = COUNTERS.snapshot()
    assert tot["bound"] == len(pods), tot
    assert snap.get("stream.chunk_flush", (0, 0))[0] == 0, \
        "host-check/Policy chunks must not flush the pipeline"
    assert snap["engine.wave_dispatch"][0] >= 2
    assert snap["engine.wave_host_rows"][0] >= 1   # the ports pod rode
    assert snap["engine.wave_host_tail"][0] >= 1   # ... and placed at tail
    got = placements(api)
    for nm, node in got.items():
        assert not node.startswith("bare"), \
            f"{nm} on {node}: Policy labelsPresence violated on the wave"
    for i in range(4):
        node = got[f"hs-{i}"]
        want_zone = f"z{i % 4}"
        node_obj = {n.name: n for n in nodes}[node]
        assert node_obj.labels.get("zone") == want_zone, \
            f"hs-{i} on {node}: host_static selector violated"


# ------------------------------------------------- frozen-trace A/B


def _unique_winner_trace(k):
    """Every pod has exactly one feasible/best node, so wave-kernel vs
    strict-oracle tie-breaking cannot diverge: the A/B pins SEMANTICS,
    not scheduling luck."""
    nodes = [k.make_node(f"n{i}", cpu=8000, memory=32 * Gi, pods=110,
                         labels={"zone": f"z{i}", "foo": "x"})
             for i in range(6)]
    pods = []
    for i in range(4):        # host_static, unique winner n{i}
        p = k.make_pod(f"hs-{i}", cpu=100, memory=128 << 20)
        p.affinity = overflow_affinity(k, f"z{i}")
        pods.append(p)
    # host_exact (ports) pinned to n4 by an equality selector
    pods.append(ports_pod(k, "hx-0", node_selector={"zone": "z4"}))
    # plain pod pinned to n5 (equality selector is batch-expressible,
    # stays on the fast path — covers the mixed chunk)
    pods.append(k.make_pod("pin-5", cpu=100, memory=128 << 20,
                           node_selector={"zone": "z5"}))
    return nodes, pods


def test_wave_routed_hostcheck_matches_classic_bit_identical(k):
    """Frozen-trace A/B: the same trace through (a) the pipelined wave
    path, (b) the classic serialized rounds, and (c) the wave path with
    overlap forced off must produce bit-identical placements."""
    nodes, pods = _unique_winner_trace(k)
    api_a, s_a = mk_sched(k, copy.deepcopy(nodes), copy.deepcopy(pods),
                          chunk=3)
    s_a.run_until_drained()
    api_b, s_b = mk_sched(k, copy.deepcopy(nodes), copy.deepcopy(pods),
                          chunk=3)
    s_b.run_until_drained(pipeline=False)
    api_c, s_c = mk_sched(k, copy.deepcopy(nodes), copy.deepcopy(pods),
                          chunk=3)
    s_c.run_until_drained(overlap=False)
    got = placements(api_a)
    assert got == placements(api_b), "wave-routed != classic round"
    assert got == placements(api_c), "overlap on/off diverged"
    want = {"hs-0": "n0", "hs-1": "n1", "hs-2": "n2", "hs-3": "n3",
            "hx-0": "n4", "pin-5": "n5"}
    assert got == want, got


def test_policy_wave_matches_classic_bit_identical(k):
    """Same A/B for a Policy-constrained trace: labelsPresence admits a
    single node, so the frozen policy_fit column, the fence re-check,
    and the classic oracle must all land every pod identically."""
    nodes = [k.make_node("ok", cpu=8000, memory=32 * Gi, pods=110,
                         labels={"foo": "x"}),
             k.make_node("bare-a", cpu=8000, memory=32 * Gi, pods=110),
             k.make_node("bare-b", cpu=8000, memory=32 * Gi, pods=110)]
    pods = [k.make_pod(f"p{i}", cpu=100, memory=128 << 20)
            for i in range(5)]
    policy = k.parse_policy(NLP_POLICY)
    api_a, s_a = mk_sched(k, copy.deepcopy(nodes), copy.deepcopy(pods),
                          chunk=2, policy=policy)
    s_a.run_until_drained()
    api_b, s_b = mk_sched(k, copy.deepcopy(nodes), copy.deepcopy(pods),
                          chunk=2, policy=policy)
    s_b.run_until_drained(pipeline=False)
    got = placements(api_a)
    assert got == placements(api_b)
    assert all(v == "ok" for v in got.values()), got


# ------------------------------------------------- the stale fence


def test_relabel_in_flight_requeues_hostcheck_conservatively(k):
    """A relabel landing while a host_static wave is in flight makes the
    baked host_fit column stale: the fence must requeue the row with
    REASON_HOSTCHECK, and the re-dispatch must rebuild against fresh label
    truth and place on the NEW matching node."""
    cache = k.SchedulerCache()
    n0 = k.make_node("n0", cpu=4000, memory=16 * Gi, pods=110,
                     labels={"zone": "z0"})
    n1 = k.make_node("n1", cpu=4000, memory=16 * Gi, pods=110,
                     labels={"zone": "zx"})
    cache.add_node(n0)
    cache.add_node(n1)
    eng = _engine(k, cache)
    pod = k.make_pod("hs", cpu=100, memory=128 << 20)
    pod.affinity = overflow_affinity(k, "z0")
    COUNTERS = k.trace.COUNTERS
    COUNTERS.reset()
    handle = eng.dispatch_waves([pod])
    assert handle is not None
    assert handle.enc.host_static[handle.pc[0]]
    # the blind window: z0 MOVES from n0 to n1 while the wave is in flight
    n0b = copy.deepcopy(n0)
    n0b.labels = {"zone": "zb"}
    n1b = copy.deepcopy(n1)
    n1b.labels = {"zone": "z0"}
    cache.update_node(n0b)
    cache.update_node(n1b)
    h = eng.harvest_waves(handle)
    assert not h.bound, "stale host_fit row must not bind"
    assert [p.name for p in h.conflicts] == ["hs"]
    assert h.conflict_reasons == [k.podtrace.REASON_HOSTCHECK]
    snap = COUNTERS.snapshot()
    assert snap["engine.hostcheck_fence_requeues"][0] == 1
    assert snap["engine.fence_reason_host_check"][0] == 1
    # conservative requeue -> re-dispatch rebuilds the column against the
    # refreshed labels and places on the node that NOW carries z0
    handle2 = eng.dispatch_waves([pod])
    h2 = eng.harvest_waves(handle2)
    assert [(p.name, p.node_name) for p in h2.bound] == [("hs", "n1")]


def test_fresh_labels_do_not_requeue_hostcheck(k):
    """Control for the stale fence: with no relabel in the blind window a
    host_static row binds first try — the conservative requeue must not
    fire spuriously."""
    cache = k.SchedulerCache()
    cache.add_node(k.make_node("n0", cpu=4000, memory=16 * Gi, pods=110,
                               labels={"zone": "z0"}))
    eng = _engine(k, cache)
    pod = k.make_pod("hs", cpu=100, memory=128 << 20)
    pod.affinity = overflow_affinity(k, "z0")
    COUNTERS = k.trace.COUNTERS
    COUNTERS.reset()
    h = eng.harvest_waves(eng.dispatch_waves([pod]))
    assert [(p.name, p.node_name) for p in h.bound] == [("hs", "n0")]
    snap = COUNTERS.snapshot()
    assert snap.get("engine.hostcheck_fence_requeues", (0, 0))[0] == 0
