"""The reference's churn-hardening contracts of the always-on engine
(tests/test_churn.py) on both packages: the liveness fence (a node
deleted or cordoned while its wave is in flight requeues every row,
remove_node forgets the assumed pods), the Protean patches (a foreign
plain bind or unbind patches forbid rows, a foreign affinity carrier
rebuilds, a relabel of an unoccupied node patches label rows), degraded
mode with its hysteresis and classic fallback, housekeeping under load,
the frozen churn trace placed equally by the stream and the fixed-chunk
pipeline, the rolling update's bounds and the diurnal rate curve. Each
body runs through the `k` fixture with every Scheduler of the port on
the CPU; one more case holds the port's frozen-trace placements equal to
the reference's."""

from __future__ import annotations

import time

from tests.test_nodes import FakeClock

import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "api_types": "api.types",
    "engine_scheduler": "engine.scheduler",
    "engine_streaming": "engine.streaming",
    "models_hollow": "models.hollow",
    "server_apiserver_lite": "server.apiserver_lite",
    "state_cache": "state.cache",
    "testing_churn": "testing.churn",
    "utils_trace": "utils.trace",
}
PKGS = {root: Pkg(root, MODULES) for root in (REF, PORT)}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]

Gi = 1 << 30
HOSTNAME_KEY = "kubernetes.io/hostname"


def iso_pod(k, name, app="iso"):
    p = k.make_pod(name, cpu=100, memory=128 << 20, labels={"app": app})
    p.affinity = k.Affinity(pod_anti_affinity=k.PodAffinity(
        required_terms=[k.PodAffinityTerm(
            label_selector=k.LabelSelector(match_labels={"app": app}),
            namespaces=[], topology_key=HOSTNAME_KEY)]))
    return p


def mk_nodes(k, n, cpu=4000):
    return [k.make_node(f"n{i:02d}", cpu=cpu, memory=16 * Gi, pods=110,
                      labels={HOSTNAME_KEY: f"n{i:02d}",
                              "zone": "z0" if i % 2 == 0 else "z1"})
            for i in range(n)]


def mk_sched(k, nodes, now=None):
    api = k.ApiServerLite()
    k.load_cluster(api, nodes, [])
    kw = {"record_events": False}
    if now is not None:
        kw["now"] = now
    s = k.Scheduler(api, **kw, **k.dev)
    s.start()
    return api, s


def placements(api, prefix=""):
    return {p.name: p.node_name for p in api.list("Pod")[0]
            if p.name.startswith(prefix)}


# ---------------------------------------------------------- liveness fence


def test_node_deleted_mid_wave_liveness_fence_requeues_every_row(k):
    """The acceptance shape: a wave is IN FLIGHT when its target
    node is deleted. The fence must requeue every affected row (not bind
    into the ghost), and the pods must land on surviving nodes."""
    api, s = mk_sched(k, mk_nodes(k, 2))
    loop = s.pipeline(chunk=64)
    # 60 x 100m pods on 2 x 4000m nodes: the wave MUST spread over both
    for i in range(60):
        api.create("Pod", k.make_pod(f"lv-{i:03d}", cpu=100,
                                   memory=128 << 20))
    k.COUNTERS.reset()
    loop.step()                      # dispatch in flight, nothing harvested
    assert loop.inflight is not None
    api.delete("Node", "", "n01")    # the node dies mid-wave
    loop.step()                      # sync dooms n01, flushes, fences
    snap = k.COUNTERS.snapshot()
    assert snap.get("engine.liveness_fence_requeues", (0, 0))[0] > 0, snap
    # nothing may have bound into the ghost — at any point
    for p in api.list("Pod")[0]:
        assert p.node_name != "n01", f"{p.name} bound into deleted n01"
    # capacity for the requeued rows arrives; the backoff elapses; all bind
    api.create("Node", k.make_node("n99", cpu=4000, memory=16 * Gi, pods=110,
                                 labels={HOSTNAME_KEY: "n99"}))
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        loop.step()
        if loop.settled():
            break
        s.sync(wait=0.05)
    loop.close()
    where = placements(api, "lv-")
    assert len(where) == 60 and all(where.values()), where
    assert set(where.values()) <= {"n00", "n99"}, set(where.values())


def test_remove_node_forgets_and_returns_assumed_pods(k):
    """The cache-level audit: an assumed pod on a removed node is
    forgotten (no phantom capacity until TTL) and handed back for
    requeue; confirmed pods survive into the nodeless stub."""
    cache = k.SchedulerCache()
    cache.add_node(k.make_node("nx", cpu=4000, memory=16 * Gi))
    confirmed = k.make_pod("conf", cpu=100, node_name="nx")
    cache.add_pod(confirmed)
    assumed = k.make_pod("assumed", cpu=100)
    assumed.node_name = "nx"
    cache.assume_pod(assumed)
    assert cache.is_assumed(assumed.key())
    back = cache.remove_node("nx")
    assert [p.name for p in back] == ["assumed"]
    assert not cache.is_assumed(assumed.key())
    assert cache.pod_count() == 1  # only the confirmed pod remains
    infos = cache.node_infos()
    assert [q.name for q in infos["nx"].pods] == ["conf"]


def test_cordon_mid_wave_liveness_fence_requeues(k):
    """Cordon (spec.unschedulable) is a dying event for the in-flight
    wave exactly like deletion: rows targeting the cordoned node requeue
    with backoff and bind elsewhere."""
    api, s = mk_sched(k, mk_nodes(k, 2))
    loop = s.pipeline(chunk=64)
    for i in range(60):
        api.create("Pod", k.make_pod(f"cd-{i:03d}", cpu=100,
                                   memory=128 << 20))
    k.COUNTERS.reset()
    loop.step()
    assert loop.inflight is not None
    node = api.get("Node", "", "n01")
    import dataclasses
    api.update("Node", dataclasses.replace(node, unschedulable=True))
    loop.step()
    snap = k.COUNTERS.snapshot()
    assert snap.get("engine.liveness_fence_requeues", (0, 0))[0] > 0, snap
    for p in api.list("Pod")[0]:
        assert p.node_name != "n01", f"{p.name} bound into cordoned n01"
    loop.close()


# ------------------------------------------------------ Protean invalidation


def warm_iso(k, api, s, loop, n=4):
    for i in range(n):
        api.create("Pod", iso_pod(k, f"warm-iso-{i}"))
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        loop.step()
        if loop.settled():
            return
        s.sync(wait=0.02)
    raise AssertionError("warm drain did not settle")


def drain_loop(s, loop, deadline_s=30):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        loop.step()
        if loop.settled():
            return
        s.sync(wait=0.02)
    raise AssertionError("drain did not settle")


def test_foreign_plain_bind_patches_not_rebuilds(k):
    """A PLAIN foreign pod labeled like an anti-affinity target binding
    onto a node is exactly one new forbidden source: the cached encoding
    PATCHES that row (aff_patch_rows), never rebuilds (aff_full_rebuilds
    == 0) — and the constraint HOLDS: the next iso pod avoids the node
    the foreign target landed on."""
    api, s = mk_sched(k, mk_nodes(k, 8))
    loop = s.pipeline(chunk=64)
    warm_iso(k, api, s, loop, n=4)
    occupied = {p.node_name for p in api.list("Pod")[0]}
    free = sorted(set(f"n{i:02d}" for i in range(8)) - occupied)
    assert free
    k.COUNTERS.reset()
    # foreign bind: an already-bound pod arrives on the watch (a foreign
    # scheduler's work) with labels MATCHING the iso anti selector
    api.create("Pod", k.make_pod("foreign-tgt", cpu=100,
                               labels={"app": "iso"},
                               node_name=free[0]))
    api.create("Pod", iso_pod(k, "iso-after-foreign"))
    drain_loop(s, loop)
    snap = k.COUNTERS.snapshot()
    assert snap.get("engine.aff_full_rebuilds", (0, 0))[0] == 0, snap
    assert snap.get("engine.aff_patch_rows", (0, 0))[0] >= 1, snap
    where = placements(api)
    assert where["iso-after-foreign"], where
    assert where["iso-after-foreign"] != free[0], \
        (where["iso-after-foreign"], free[0])
    assert where["iso-after-foreign"] not in occupied
    loop.close()


def test_foreign_unbind_patches_and_frees_the_node(k):
    """The foreign target leaving decrements the patched forbid count
    exactly — the freed node is placeable again, still without a rebuild."""
    api, s = mk_sched(k, mk_nodes(k, 6, cpu=400))  # 4 pods per node by cpu
    loop = s.pipeline(chunk=64)
    warm_iso(k, api, s, loop, n=4)
    occupied = {p.node_name for p in api.list("Pod")[0]}
    free = sorted(set(f"n{i:02d}" for i in range(6)) - occupied)
    assert len(free) >= 2
    k.COUNTERS.reset()
    api.create("Pod", k.make_pod("foreign-tgt", cpu=100,
                               labels={"app": "iso"}, node_name=free[0]))
    api.create("Pod", iso_pod(k, "iso-a"))
    drain_loop(s, loop)
    assert placements(api)["iso-a"] == free[1]  # only free[1] is legal
    api.delete("Pod", "default", "foreign-tgt")  # the target leaves
    api.create("Pod", iso_pod(k, "iso-b"))
    drain_loop(s, loop)
    snap = k.COUNTERS.snapshot()
    assert snap.get("engine.aff_full_rebuilds", (0, 0))[0] == 0, snap
    assert snap.get("engine.aff_patch_rows", (0, 0))[0] >= 2, snap
    assert placements(api)["iso-b"] == free[0]  # freed exactly
    loop.close()


def test_foreign_affinity_carrier_forces_rebuild(k):
    """A foreign pod CARRYING anti-affinity is a potential symmetry
    source — its own terms bake into forbid_static, which no row patch
    can express. The encoding must rebuild, and the symmetry must hold
    against the rebuilt arrays."""
    api, s = mk_sched(k, mk_nodes(k, 6))
    loop = s.pipeline(chunk=64)
    # warm with PLAIN pods labeled like a guard's target, so the
    # encoding exists and carries the 'tgt' class
    for i in range(3):
        api.create("Pod", k.make_pod(f"warm-tgt-{i}", cpu=100,
                                   labels={"app": "tgt"}))
    drain_loop(s, loop)
    k.COUNTERS.reset()
    guard = iso_pod(k, "foreign-guard", app="tgt")
    guard.node_name = "n05"
    api.create("Pod", guard)  # bound foreign pod WITH anti-affinity
    api.create("Pod", k.make_pod("tgt-after", cpu=100,
                               labels={"app": "tgt"}))
    drain_loop(s, loop)
    snap = k.COUNTERS.snapshot()
    assert snap.get("engine.aff_full_rebuilds", (0, 0))[0] >= 1, snap
    # symmetry: the new target may not land beside the foreign guard
    assert placements(api)["tgt-after"] != "n05", placements(api)
    loop.close()


def test_relabel_of_unoccupied_node_patches_not_rebuilds(k):
    """Label-content churn on a node hosting nothing affinity-relevant
    re-derives just that ROW of the topology views (label_patch_rows);
    the selector side reads the refreshed labels either way."""
    import dataclasses
    api, s = mk_sched(k, mk_nodes(k, 8))
    loop = s.pipeline(chunk=64)
    # intern the zone pairs via a selector class, and build an affinity
    # encoding via iso pods
    sel = k.make_pod("warm-sel", cpu=100)
    sel.node_selector = {"zone": "z0"}
    api.create("Pod", sel)
    warm_iso(k, api, s, loop, n=2)
    empty = sorted(set(f"n{i:02d}" for i in range(8))
                   - {p.node_name for p in api.list("Pod")[0]})
    assert empty
    k.COUNTERS.reset()
    node = api.get("Node", "", empty[0])
    api.update("Node", dataclasses.replace(
        node, labels=dict(node.labels, zone="z1" if
                          node.labels["zone"] == "z0" else "z0")))
    api.create("Pod", iso_pod(k, "iso-after-relabel"))
    drain_loop(s, loop)
    snap = k.COUNTERS.snapshot()
    assert snap.get("engine.label_patch_rows", (0, 0))[0] >= 1, snap
    assert snap.get("engine.aff_full_rebuilds", (0, 0))[0] == 0, snap
    assert placements(api)["iso-after-relabel"], placements(api)
    loop.close()


# ------------------------------------------------------------ degraded mode


class _FakeEngine:
    pass


class _FakeSched:
    def __init__(self):
        self.engine = _FakeEngine()
        self._pipeline = None
        self.pipeline_chunk = 4096


def test_degraded_mode_hysteresis_and_recovery(k):
    """Unit contract of the churn-health model: enter only after
    degrade_window CONSECUTIVE breached pod-ful steps (one bad wave must
    not flap the mode), idle steps freeze the window, recovery after
    recover_steps pod-ful classic steps."""
    loop = k.ScheduleLoop(_FakeSched(), budget_s=0.2, min_quantum=64,
                        max_quantum=256)
    loop.degrade_window = 3
    loop.recover_steps = 2

    def stats(bound, requeues):
        return {"bound": bound, "fence_requeued": requeues,
                "liveness_requeued": 0, "gang_requeued": 0}

    loop._note_health(stats(10, 90))
    loop._note_health(stats(10, 90))
    assert not loop.degraded          # 2 < window
    loop._note_health(stats(0, 0))    # idle: freezes, does not reset...
    loop._note_health(stats(90, 10))  # ...a healthy step DOES reset
    loop._note_health(stats(10, 90))
    loop._note_health(stats(10, 90))
    assert not loop.degraded
    loop._note_health(stats(10, 90))  # third consecutive: enter
    assert loop.degraded
    loop._note_health(stats(0, 0))    # idle: not a recovery step
    assert loop.degraded
    loop._note_health(stats(50, 0))
    loop._note_health(stats(50, 0))   # recover_steps pod-ful steps: exit
    assert not loop.degraded


def test_degraded_mode_classic_round_still_binds(k):
    """End-to-end: force the loop degraded and verify pods still bind
    through the classic synchronous fallback, the step is counted, and
    the mode recovers."""
    api, s = mk_sched(k, mk_nodes(k, 4))
    loop = s.stream(budget_s=30.0, min_quantum=64, max_quantum=64)
    loop.degraded = True
    loop.recover_steps = 2
    k.COUNTERS.reset()
    for i in range(40):
        api.create("Pod", k.make_pod(f"dg-{i:03d}", cpu=100))
    total = {}
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        stats = loop.step()
        for kk, v in stats.items():
            total[kk] = total.get(kk, 0) + v
        if loop.settled():
            break
        s.sync(wait=0.02)
    loop.close()
    where = placements(api, "dg-")
    assert len(where) == 40 and all(where.values()), where
    assert total.get("degraded_steps", 0) >= 1, total
    assert not loop.degraded  # recovered after the storm bound


# -------------------------------------------------- housekeeping under load


def test_housekeeping_runs_under_sustained_load(k):
    """A saturated stream never has an empty round — backoff stamps and
    assume-TTL expiry must still gc on the wall-clock cadence (the
    empty-round gate starved them before)."""
    clock = FakeClock()
    api, s = mk_sched(k, mk_nodes(k, 4), now=clock)
    loop = s.stream(budget_s=30.0, min_quantum=64, max_quantum=64)
    loop.gc_interval_s = 0.0  # every step, regardless of load
    # a stale backoff stamp for a pod long since bound
    s.queue.backoff.next_delay("ghost-pod")
    assert "ghost-pod" in s.queue.backoff._durations
    clock.t += 1000.0  # far past 2 * MAX_BACKOFF
    api.create("Pod", k.make_pod("hk-0", cpu=100))
    stats = loop.step()  # pod-ful step: housekeeping must run anyway
    assert stats["popped"] == 1, stats
    assert "ghost-pod" not in s.queue.backoff._durations
    loop.close()


# ------------------------------------------------- frozen churn-trace A/B


TRACE = (
    # (arrival group size, churn ops applied BEFORE the step), each op as
    # ChurnOp's (kind, fields), built on the package under test
    (37, ()),
    (48, (("kill", {"node": "n03"}),)),
    (25, (("respawn", {"node": "n03"}),
          ("cordon", {"node": "n05"}),
          ("evict", {"evict_slot": 7}),)),
    (40, (("uncordon", {"node": "n05"}),
          ("relabel", {"node": "n06", "zone": "zone-b"}),
          ("evict", {"evict_slot": 3}),)),
)


def _run_trace(k, streaming: bool):
    clock = FakeClock()
    api, s = mk_sched(k, mk_nodes(k, 16), now=clock)
    if streaming:
        loop = s.stream(budget_s=30.0, min_quantum=64, max_quantum=64)
    else:
        loop = s.pipeline(chunk=64)
    injector = k.ChurnInjector(api, [])
    gi = 0
    for group, ops in TRACE:
        injector.schedule = [k.ChurnOp(0.0, kind, **fields)
                             for kind, fields in ops]
        injector._next = 0
        injector.apply_until(0.0)
        for i in range(group):
            kind = "iso" if i % 10 == 0 else "web"
            if kind == "iso":
                p = iso_pod(k, f"tr-g{gi}-iso-{i:03d}")
            else:
                p = k.make_pod(f"tr-g{gi}-web-{i:03d}", cpu=100,
                             memory=128 << 20)
            api.create("Pod", p)
        loop.step()
        gi += 1
    # make every backoff deterministic-ready before the final drain: the
    # fake clock jumps past MAX_BACKOFF, so both sides promote the same
    # deferred set in the same order
    clock.t += 120.0
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        loop.step()
        if loop.settled():
            break
        clock.t += 120.0
        s.sync(wait=0.02)
    assert loop.settled(), "trace drain did not settle"
    loop.close()
    return {p.name: p.node_name for p in api.list("Pod")[0]}


def test_frozen_churn_trace_streaming_equals_pipelined(k):
    """The A/B: the same frozen arrival + churn trace consumed by
    the streaming loop and by the fixed-chunk pipelined drain — same
    quantum, same step boundaries, same seeded churn ops — places every
    surviving pod on the SAME node. Churn (node kills, cordons, relabels,
    evictions, liveness requeues) changes what the cluster IS, never what
    a wave means."""
    pa = _run_trace(k, streaming=True)
    pb = _run_trace(k, streaming=False)
    assert set(pa) == set(pb), set(pa) ^ set(pb)
    diff = {kk: (pa[kk], pb[kk]) for kk in pa if pa[kk] != pb[kk]}
    assert not diff, diff
    assert all(v for v in pa.values()), \
        [kk for kk, v in pa.items() if not v]


# ------------------------------------------------------- rolling updates


def test_rolling_update_respects_bounds_and_binds_exactly_once(k):
    """Deployment-shaped rolling update: the evict-and-
    recreate controller stepped deterministically against store truth,
    scheduler drained between steps. The surge bound (never more than
    replicas + max_surge pods of the app), the availability bound
    (never fewer than replicas - max_unavailable bound pods), full
    completion, and the store-truth exactly-once audit (every
    replacement bound exactly once, zero ghost residue in the cache)
    must all hold."""

    replicas, surge, unavail = 12, 3, 3
    api = k.ApiServerLite()
    k.load_cluster(api, mk_nodes(k, 8), [])
    s = k.Scheduler(api, record_events=False, **k.dev)
    s.start()

    def web_pod(rev, i):
        return k.make_pod(f"web-{rev}-{i:03d}", cpu=100,
                        memory=128 << 20,
                        labels={"app": "web", "rev": rev})

    for i in range(replicas):
        api.create("Pod", web_pod("1", i))
    assert s.run_until_drained()["bound"] == replicas

    cfg = k.RollingUpdateConfig(replicas=replicas, max_surge=surge,
                              max_unavailable=unavail)
    driver = k.RollingUpdateDriver(api, cfg, lambda i: web_pod("2", i))
    steps = 0
    while not driver.step():
        s.run_until_drained()
        steps += 1
        assert steps < 60, f"rolling update did not converge: " \
            f"{driver.bounds_report()}"
    rep = driver.bounds_report()
    assert rep["surge_respected"], rep
    assert rep["unavailable_respected"], rep
    # a bounded update is necessarily multi-step: with surge=3 it takes
    # at least replicas/surge controller passes
    assert steps >= replicas // surge, (steps, rep)
    assert rep["evicted"] == replicas and rep["created"] == replicas
    # end state: only new-revision pods, all bound
    pods = api.list("Pod")[0]
    web = [p for p in pods if p.labels.get("app") == "web"]
    assert len(web) == replicas
    assert all(p.labels["rev"] == "2" and p.node_name for p in web)
    # store-truth audits: every replacement bound exactly once, zero
    # ghost residue in the scheduler cache
    trans = k.audit_store_transitions(api)
    repl = {kk for kk in driver.replacement_keys}
    assert all(trans["binds"].get(kk, 0) == 1 for kk in repl), trans["binds"]
    assert k.audit_cache_vs_store(s, api) == []


def test_diurnal_rate_curve_shape(k):

    rate = k.diurnal_rate(1000.0, amp=0.5, period_s=60.0)
    assert abs(rate(0.0) - 1000.0) < 1e-6          # mean at phase 0
    assert abs(rate(15.0) - 1500.0) < 1e-6         # peak at quarter period
    assert abs(rate(45.0) - 500.0) < 1e-6          # trough at 3/4 period
    # never negative, even at amp > 1
    deep = k.diurnal_rate(100.0, amp=1.5, period_s=10.0)
    assert min(deep(t / 10.0) for t in range(100)) >= 0.0


def test_frozen_churn_trace_port_equals_reference():
    """The frozen churn trace through the stream places every pod of the
    port (on the CPU) on the node the reference's stream chose."""
    want = _run_trace(PKGS[REF], streaming=True)
    got = _run_trace(PKGS[PORT], streaming=True)
    assert set(got) == set(want), set(got) ^ set(want)
    diff = {x: (got[x], want[x]) for x in want if got[x] != want[x]}
    assert not diff, diff


def _respawn_after_rebuild(k, kept):
    """Kill the node that holds `kept`, rebuild the encoding while it is
    dead (a class first seen then), respawn it, then place five
    anti-affinity pods of the app. Returns (pods beside `kept` on its
    node, placements, whether the wave encoding was rebuilt after the
    respawn)."""
    api, s = mk_sched(k, mk_nodes(k, 8))
    loop = s.stream(budget_s=30.0, min_quantum=64, max_quantum=64)
    api.create("Pod", k.make_pod("tgt", cpu=100, memory=128 << 20,
                                 labels={"app": "iso"}))
    api.create("Pod", iso_pod(k, "iso-warm"))
    drain_loop(s, loop)
    host = api.get("Pod", "default", kept).node_name
    injector = k.ChurnInjector(api, [k.ChurnOp(0.0, "kill", node=host),
                                     k.ChurnOp(1.0, "respawn", node=host)])
    injector.apply_until(0.0)
    drain_loop(s, loop)
    api.create("Pod", k.make_pod("new-class", cpu=250, memory=128 << 20))
    drain_loop(s, loop)
    enc = s.engine._wave_enc
    injector.apply_until(1.0)
    drain_loop(s, loop)
    # five fit the five nodes free of the app either way
    for i in range(5):
        api.create("Pod", iso_pod(k, f"iso-{i}"))
    drain_loop(s, loop)
    loop.close()
    where = placements(api)
    assert all(where.values()), where
    beside = sorted(n for n, v in where.items() if v == host)
    return beside, where, s.engine._wave_enc is not enc


def test_node_respawned_after_a_rebuild_loses_its_pods_forbid_rows(k):
    """An encoding rebuilt while a node is dead gives the pods its
    node-less NodeInfo kept no domain (AffinityData's domain_id is -1
    without a node). In the reference nothing is logged when the node
    returns, and iso-4 lands beside the target on it: the departure this
    case records. The port's cache logs the returning pods and the patch
    path writes the plain target's forbid row in place (no rebuild), so
    no anti-affinity pod lands beside it."""
    beside, where, rebuilt = _respawn_after_rebuild(k, "tgt")
    if k.root == PORT:
        assert beside == ["tgt"] and not rebuilt, (where, rebuilt)
    else:
        assert beside == ["iso-4", "tgt"], where


def test_respawned_anti_pod_after_a_rebuild_keeps_its_symmetry(k):
    """The same with an anti-affinity pod on the node that returns: the
    rebuild while it was dead dropped its own term's domain. The port
    rebuilds once when it returns and places no pod of its app beside
    it; the reference places iso-4 beside it."""
    beside, where, rebuilt = _respawn_after_rebuild(k, "iso-warm")
    if k.root == PORT:
        assert beside == ["iso-warm"] and rebuilt, (where, rebuilt)
    else:
        assert beside == ["iso-4", "iso-warm"], where
