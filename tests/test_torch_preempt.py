"""PodPriority preemption in the port, held against the reference package
on the CPU, exactly.

- ``ops/preempt.victim_scan`` against the reference's jitted
  ``victim_scan_jit`` on the same seeded int32 inputs: random bands,
  band_mem sums past 2^24 (where a float32 product would round), int32
  sums that wrap, tied unused band slots, PAD_PRIO padding rows; and
  ``SchedulingEngine.preempt_scan`` on one cluster through both engines,
  band overflow -> None included.
- The classic round (tests/test_preemption.py): minimal victims, the
  cheapest node, no victim at or above the preemptor, two preemptors not
  over-evicting, anti-affinity respected, truncation under a small
  verification budget, and the end-to-end round through the Scheduler.
- The wave path (tests/test_preempt_wave.py): wave plans == classic
  plans (fuzz), affinity residents, the atomic evict+bind with injected
  failures and landed timeouts, the disruption budget's window and band
  floor, preemption riding the stream without a flush, and its
  counters and flight-recorder lane (the perfetto export, the telemetry
  registry and VerdictService's debug snapshot).
Each end-to-end case runs through both packages; placements, victims and
counters must be equal."""

from __future__ import annotations

import importlib
import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.engine import preempt_wave as jpw
from kubernetes_tpu.engine import preemption as jpm
from kubernetes_tpu.engine import scheduler as jsched
from kubernetes_tpu.engine import scheduler_engine as jse
from kubernetes_tpu.models import hollow as jh
from kubernetes_tpu.ops import oracle_ext as joe
from kubernetes_tpu.ops import preempt as jops
from kubernetes_tpu.server import apiserver_lite as japi
from kubernetes_tpu.state import cache as jcache
from kubernetes_tpu.state import node_info as jni
from kubernetes_tpu.state import volumes as jvol
from kubernetes_tpu.testing import churn as jchurn
from kubernetes_tpu.utils import features as jfeat
from kubernetes_tpu.utils import trace as jtrace
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.engine import preempt_wave as tpw
from kubernetes_tpu_torch.engine import preemption as tpm
from kubernetes_tpu_torch.engine import scheduler as tsched
from kubernetes_tpu_torch.engine import scheduler_engine as tse
from kubernetes_tpu_torch.models import hollow as th
from kubernetes_tpu_torch.ops import oracle_ext as toe
from kubernetes_tpu_torch.ops import preempt as tops
from kubernetes_tpu_torch.server import apiserver_lite as tapi
from kubernetes_tpu_torch.state import cache as tcache
from kubernetes_tpu_torch.state import node_info as tni
from kubernetes_tpu_torch.state import volumes as tvol
from kubernetes_tpu_torch.testing import churn as tchurn
from kubernetes_tpu_torch.utils import features as tfeat
from kubernetes_tpu_torch.utils import trace as ttrace
from tests.test_nodes import FakeClock

Mi = 1 << 20
Gi = 1 << 30
REF = dict(t=jt, pw=jpw, pm=jpm, sched=jsched, se=jse, hollow=jh, oe=joe,
           api=japi, cache=jcache, ni=jni, vol=jvol, churn=jchurn,
           COUNTERS=jtrace.COUNTERS, kw={})
PORT = dict(t=tt, pw=tpw, pm=tpm, sched=tsched, se=tse, hollow=th, oe=toe,
            api=tapi, cache=tcache, ni=tni, vol=tvol, churn=tchurn,
            COUNTERS=ttrace.COUNTERS, kw={"device": "cpu"})
SIDES = (REF, PORT)
PREEMPT_COUNTERS = ("engine.preempt_scan_dispatch",
                    "engine.preempt_scan_host_fallback",
                    "engine.preempt_commits", "engine.preempt_rollbacks",
                    "engine.victims_evicted",
                    "engine.preempt_budget_deferred")
B = 16  # ClusterSnapshot.PRIO_BANDS in both packages


@pytest.fixture()
def pod_priority():
    jfeat.DEFAULT_FEATURE_GATE.set("PodPriority", True)
    tfeat.DEFAULT_FEATURE_GATE.set("PodPriority", True)
    yield
    jfeat.DEFAULT_FEATURE_GATE.reset()
    tfeat.DEFAULT_FEATURE_GATE.reset()


def _both(fn):
    """Run one scenario through both packages (counters reset before
    each); the results must be equal."""
    out = []
    for side in SIDES:
        side["COUNTERS"].reset()
        out.append(fn(side))
    assert out[1] == out[0]
    return out[1]


def _counts(side):
    snap = side["COUNTERS"].snapshot()
    return {k: snap.get(k, (0, 0))[0] for k in PREEMPT_COUNTERS}


def _close(sched):
    close = getattr(sched.engine, "close", None)
    if close is not None:
        close()


def prio_pod(side, name, priority, cpu=200, mem=256 * Mi, node_name=""):
    p = side["t"].make_pod(name, cpu=cpu, memory=mem, node_name=node_name)
    p.priority = priority
    return p


def _placements(api):
    return {p.name: (p.node_name or None) for p in api.list("Pod")[0]}


# ------------------------------------------------------------ victim_scan


def _scan_inputs(seed, c=8, n=64, mem_big=False, extremes=False,
                 ties=False):
    """Seeded int32 operands of the victim scan (numpy)."""
    rng = np.random.default_rng(seed)
    i32 = np.int32
    band_prio = rng.choice(np.arange(-50, 50), size=B,
                           replace=False).astype(i32)
    if ties:
        # unused slots (and clipped priorities) all sit at 2^31 - 1
        band_prio[10:] = tops.UNUSED_BAND_PRIO
    band_cpu = rng.integers(0, 2000, size=(n, B)).astype(i32)
    band_cnt = rng.integers(0, 12, size=(n, B)).astype(i32)
    if mem_big:
        # KiB quanta of 8-32 GiB a band: prefix sums pass 2^24
        band_mem = rng.integers(8 << 20, 32 << 20, size=(n, B)).astype(i32)
    else:
        band_mem = rng.integers(0, 4 << 20, size=(n, B)).astype(i32)
    if extremes:
        band_cpu[:, :4] = np.iinfo(i32).max - rng.integers(0, 9, (n, 4))
        band_mem[:, :4] = np.iinfo(i32).max // 2
    if ties:
        band_cpu[:, 10:] = 0
        band_mem[:, 10:] = 0
        band_cnt[:, 10:] = 0
    spare_cpu = rng.integers(-500, 1500, size=n).astype(i32)
    spare_mem = rng.integers(-(1 << 20), 4 << 20, size=n).astype(i32)
    if extremes:
        spare_cpu[: n // 2] = np.iinfo(i32).max - 3
        spare_mem[n // 2:] = np.iinfo(i32).min + 5
    pod_count = rng.integers(0, 110, size=n).astype(i32)
    allowed = rng.integers(1, 111, size=n).astype(i32)
    need_cpu = rng.integers(0, 6000, size=c).astype(i32)
    need_mem = rng.integers(0, 40 << 20, size=c).astype(i32)
    prio = rng.integers(-60, 60, size=c).astype(i32)
    prio[-2:] = tops.PAD_PRIO  # padding rows: no candidates
    return (need_cpu, need_mem, prio, spare_cpu, spare_mem, pod_count,
            allowed, band_cpu, band_mem, band_cnt, band_prio)


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, {}), (2, {"c": 4, "n": 8}),
    (3, {"mem_big": True}), (4, {"mem_big": True, "n": 257}),
    (5, {"extremes": True}), (6, {"extremes": True, "mem_big": True}),
    (7, {"ties": True}), (8, {"ties": True, "extremes": True}),
])
def test_victim_scan_equals_reference(seed, kw):
    args = _scan_inputs(seed, **kw)
    cand_j, bound_j = jops.victim_scan_jit(*args)
    cand_t, bound_t = tops.victim_scan(*(torch.from_numpy(a)
                                         for a in args))
    assert cand_t.dtype == torch.bool and bound_t.dtype == torch.int32
    np.testing.assert_array_equal(cand_t.numpy(), np.asarray(cand_j))
    np.testing.assert_array_equal(bound_t.numpy(), np.asarray(bound_j))
    # padding rows never have a candidate
    assert not cand_t[-2:].any()
    assert (bound_t[-2:] == tops.INFEASIBLE).all()
    if kw.get("mem_big"):
        cum = tops.band_prefix(torch.from_numpy(args[8]),
                               torch.from_numpy(args[10])[None, :]
                               <= torch.from_numpy(args[10])[:, None])
        assert int(cum.max()) > 2 ** 24  # past float32's exact range


def test_band_prefix_is_exact_where_float32_rounds():
    """One 32 GiB hollow node's memory band sums to 2^25 KiB; an odd sum
    of quanta above 2^24 is not representable in float32, and the masked
    int64 sum keeps it exact (wrapping like int32 above 2^31)."""
    band = torch.tensor([[2 ** 24 + 1, 2, 7] + [0] * (B - 3),
                         [2 ** 31 - 1, 5, 0] + [0] * (B - 3)],
                        dtype=torch.int32)
    prio = torch.tensor([1, 2, 3] + [tops.UNUSED_BAND_PRIO] * (B - 3),
                        dtype=torch.int32)
    le = prio[None, :] <= prio[:, None]
    cum = tops.band_prefix(band, le)
    assert int(cum[0, 1]) == 2 ** 24 + 3
    assert int(cum[0, 2]) == 2 ** 24 + 10
    assert int(cum[1, 1]) == -(2 ** 31) + 4       # int32 wrap
    # the tied unused slots sum every band (all share 2^31 - 1)
    assert (cum[:, 3:] == cum[:, 3:4]).all()
    f32 = (band.float() @ le.float().T)
    assert float(f32[0, 1]) != 2 ** 24 + 3       # float32 rounds here


def _fuzz_cache(side, seed):
    """Both sides draw the same cluster from one seed (the reference's
    _fuzz_cluster)."""
    rng = random.Random(seed)
    cache = side["cache"].SchedulerCache()
    t = side["t"]
    n_nodes = rng.randint(4, 10)
    for i in range(n_nodes):
        cache.add_node(t.make_node(f"n{i:02d}",
                                   cpu=rng.choice([1000, 1600, 2400]),
                                   memory=rng.choice([4, 8]) * Gi,
                                   pods=rng.choice([6, 10, 110])))
    k = 0
    for i in range(n_nodes):
        for _ in range(rng.randint(0, 6)):
            cache.add_pod(prio_pod(side, f"b{k:03d}",
                                   rng.choice([0, 0, 1, 2, 5, 10]),
                                   cpu=rng.choice([100, 200, 400, 700]),
                                   mem=rng.choice([128, 256, 512]) * Mi,
                                   node_name=f"n{i:02d}"))
            k += 1
    pre = [prio_pod(side, f"pre{j}", rng.choice([1, 3, 5, 8, 20]),
                    cpu=rng.choice([300, 600, 900, 1500, 50_000]),
                    mem=rng.choice([256, 512, 1024]) * Mi)
           for j in range(rng.randint(1, 5))]
    return cache, pre


def _engine(side, cache):
    eng = side["se"].SchedulingEngine(cache, **side["kw"])
    eng._refresh()
    return eng


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_preempt_scan_equals_reference(seed):
    def run(side):
        cache, pre = _fuzz_cache(side, seed)
        cand, bound, class_of = _engine(side, cache).preempt_scan(pre)
        return cand.tolist(), bound.tolist(), list(class_of), \
            _counts(side)
    _both(run)


def test_band_overflow_returns_none_and_falls_back_to_host():
    """More distinct priorities than band columns: preempt_scan bows
    out with None, the host pre-filter serves the round (counted), and
    the plans equal the classic ones and the reference's."""
    def run(side):
        cache = side["cache"].SchedulerCache()
        cache.add_node(side["t"].make_node("n00", cpu=2000, memory=8 * Gi))
        for j in range(20):   # 20 distinct priorities > 16 band columns
            cache.add_pod(prio_pod(side, f"b{j}", j, cpu=90,
                                   node_name="n00"))
        eng = _engine(side, cache)
        assert eng.snapshot.prio_band_overflow
        assert eng.preempt_scan([prio_pod(side, "pre", 50, cpu=500)]) \
            is None
        pre = [prio_pod(side, "pre", 50, cpu=500)]
        wave = _wave_plans(side, eng, pre)
        assert wave == _classic_plans(side, cache, pre)
        c = _counts(side)
        assert c["engine.preempt_scan_host_fallback"] == 1
        assert c["engine.preempt_scan_dispatch"] == 0
        return wave, c
    _both(run)


# ----------------------------------------------------- pick / victims


def _info_with(side, node, *pods):
    info = side["ni"].NodeInfo(node)
    for p in pods:
        info.add_pod(p)
    return info


def _plan_key(plan):
    if plan is None:
        return None
    return plan.node_name, [v.name for v in plan.victims]


@pytest.mark.parametrize("case", ["minimal", "cheapest", "equal_or_higher",
                                  "infeasible"])
def test_pick_preemption_matches_reference(case):
    def run(side):
        t = side["t"]
        pick = side["pm"].pick_preemption
        if case == "minimal":
            node = t.make_node("n1", cpu=1000, memory=8 * Gi)
            infos = {"n1": _info_with(
                side, node,
                prio_pod(side, "low-a", 1, cpu=400, node_name="n1"),
                prio_pod(side, "low-b", 2, cpu=400, node_name="n1"),
                prio_pod(side, "hi", 100, cpu=200, node_name="n1"))}
            plan = pick(prio_pod(side, "pre", 50, cpu=400), infos)
            assert [v.name for v in plan.victims] == ["low-a"]
        elif case == "cheapest":
            infos = {}
            for nm, pr in (("n1", 10), ("n2", 3)):
                infos[nm] = _info_with(
                    side, t.make_node(nm, cpu=1000, memory=8 * Gi),
                    prio_pod(side, f"v-{nm}", pr, cpu=900, node_name=nm))
            plan = pick(prio_pod(side, "pre", 50, cpu=500), infos)
            assert plan.node_name == "n2"
        elif case == "equal_or_higher":
            infos = {"n1": _info_with(
                side, t.make_node("n1", cpu=1000, memory=8 * Gi),
                prio_pod(side, "peer", 50, cpu=900, node_name="n1"))}
            plan = pick(prio_pod(side, "pre", 50, cpu=500), infos)
            assert plan is None
        else:
            infos = {"n1": _info_with(
                side, t.make_node("n1", cpu=1000, memory=8 * Gi),
                prio_pod(side, "low", 1, cpu=500, node_name="n1"))}
            plan = pick(prio_pod(side, "pre", 50, cpu=5000), infos)
            assert plan is None
        return _plan_key(plan)
    _both(run)


@pytest.mark.parametrize("case", ["cheapest_victims", "mixed_node",
                                  "tight_bound"])
def test_truncated_verification_matches_reference(case):
    """MAX_VERIFIED_CANDIDATES = 2: the kept candidates are the cheapest
    by the tight bound, in both packages alike."""
    def run(side):
        pm = side["pm"]
        t = side["t"]
        old = pm.MAX_VERIFIED_CANDIDATES
        pm.MAX_VERIFIED_CANDIDATES = 2
        try:
            infos = {}
            if case == "cheapest_victims":
                for i, pr in enumerate([90, 90, 90, 1, 1]):
                    infos[f"n{i}"] = _info_with(
                        side, t.make_node(f"n{i}", cpu=1000, memory=8 * Gi),
                        prio_pod(side, f"v{i}", pr, cpu=900,
                                 node_name=f"n{i}"))
                plan = pm.pick_preemption(prio_pod(side, "pre", 100,
                                                   cpu=500), infos)
                assert plan.victims[0].priority == 1
            elif case == "mixed_node":
                infos["a-mixed"] = _info_with(
                    side, t.make_node("a-mixed", cpu=1000, memory=8 * Gi),
                    prio_pod(side, "hi", 89, cpu=500, node_name="a-mixed"),
                    prio_pod(side, "cheap", 1, cpu=500,
                             node_name="a-mixed"))
                for i in range(4):
                    infos[f"b{i}"] = _info_with(
                        side, t.make_node(f"b{i}", cpu=1000, memory=8 * Gi),
                        prio_pod(side, f"mid{i}", 50, cpu=900,
                                 node_name=f"b{i}"))
                plan = pm.pick_preemption(prio_pod(side, "pre", 100,
                                                   cpu=400), infos)
                assert _plan_key(plan) == ("a-mixed", ["cheap"])
            else:
                for i in range(8):
                    infos[f"a{i}"] = _info_with(
                        side, t.make_node(f"a{i}", cpu=1000, memory=8 * Gi),
                        prio_pod(side, f"tiny{i}", 1, cpu=10,
                                 node_name=f"a{i}"),
                        prio_pod(side, f"big{i}", 90, cpu=900,
                                 node_name=f"a{i}"))
                infos["z"] = _info_with(
                    side, t.make_node("z", cpu=1000, memory=8 * Gi),
                    prio_pod(side, "mid", 50, cpu=900, node_name="z"))
                plan = pm.pick_preemption(prio_pod(side, "pre", 100,
                                                   cpu=800), infos)
                assert plan.node_name == "z"
            return _plan_key(plan)
        finally:
            pm.MAX_VERIFIED_CANDIDATES = old
    _both(run)


def test_pick_preemption_fuzz_matches_reference():
    """Randomized clusters through both packages' pick_preemption: equal
    plans, no victim at or above the preemptor."""
    def run(side):
        rng = np.random.default_rng(42)
        t = side["t"]
        out = []
        for _trial in range(15):
            n_nodes = int(rng.integers(2, 8))
            infos = {}
            for i in range(n_nodes):
                info = side["ni"].NodeInfo(t.make_node(
                    f"n{i}", cpu=int(rng.integers(500, 2000)),
                    memory=8 * Gi))
                for j in range(int(rng.integers(0, 5))):
                    info.add_pod(prio_pod(
                        side, f"v{i}-{j}", int(rng.integers(0, 100)),
                        cpu=int(rng.integers(50, 600)), node_name=f"n{i}"))
                infos[f"n{i}"] = info
            pre = prio_pod(side, "pre", int(rng.integers(1, 200)),
                           cpu=int(rng.integers(100, 1200)))
            plan = side["pm"].pick_preemption(pre, infos)
            if plan is not None:
                assert all(v.priority < pre.priority for v in plan.victims)
            out.append(_plan_key(plan))
        return out
    _both(run)


# ------------------------------------------------ classic round, e2e


def _classic_rig(side, n_nodes, clock):
    api = side["api"].ApiServerLite()
    for i in range(n_nodes):
        node = side["t"].make_node(f"n{i + 1}", cpu=1000 if n_nodes < 3
                                   else 2000, memory=8 * Gi)
        node.labels["kubernetes.io/hostname"] = f"n{i + 1}"
        api.create("Node", node)
    sched = side["sched"].Scheduler(api, now=clock, **side["kw"])
    sched.start()
    return api, sched


def _settle(sched, api, clock, done, rounds=40):
    for _ in range(rounds):
        sched.schedule_round()
        if done():
            break
        clock.t += 2.0   # past the preemptor's backoff


@pytest.mark.parametrize("gate", [True, False])
def test_classic_preemption_end_to_end(gate):
    """Gate on: the high-priority pod evicts two 250m victims and lands on
    the freed node in a following round. Gate off: nothing is evicted."""
    def run(side):
        if gate:
            jfeat.DEFAULT_FEATURE_GATE.set("PodPriority", True)
            tfeat.DEFAULT_FEATURE_GATE.set("PodPriority", True)
        try:
            clock = FakeClock()
            api, sched = _classic_rig(side, 1, clock)
            for i in range(4):
                api.create("Pod", prio_pod(side, f"low-{i}", 1, cpu=250,
                                           mem=64 * Mi))
            sched.run_until_drained()
            api.create("Pod", prio_pod(side, "critical", 1000, cpu=500,
                                       mem=64 * Mi))
            stats = sched.schedule_round()
            assert stats["unschedulable"] == 1
            assert stats["preemptions"] == (1 if gate else 0)
            _settle(sched, api, clock, lambda: bool(
                api.get("Pod", "default", "critical").node_name))
            placed = _placements(api)
            lows = [n for n in placed if n.startswith("low-")]
            assert len(lows) == (2 if gate else 4)
            assert (placed["critical"] == "n1") == gate
            evs = sorted(e.message for e in sched.events
                         if e.reason in ("Preempted", "TriggeredPreemption"))
            _close(sched)
            return placed, stats["preemptions"], evs
        finally:
            jfeat.DEFAULT_FEATURE_GATE.reset()
            tfeat.DEFAULT_FEATURE_GATE.reset()
    _both(run)


def test_two_preemptors_do_not_over_evict_same_node(pod_priority):
    def run(side):
        clock = FakeClock()
        api, sched = _classic_rig(side, 2, clock)
        for i in range(4):
            api.create("Pod", prio_pod(side, f"low-{i}", 1, cpu=500,
                                       mem=64 * Mi))
        sched.run_until_drained()
        api.create("Pod", prio_pod(side, "crit-a", 1000, cpu=500,
                                   mem=64 * Mi))
        api.create("Pod", prio_pod(side, "crit-b", 900, cpu=500,
                                   mem=64 * Mi))
        stats = sched.schedule_round()
        assert stats["preemptions"] == 2
        lows = [p for p in api.list("Pod")[0] if p.name.startswith("low-")]
        assert len(lows) == 2

        def crits_bound():
            return sum(1 for p in api.list("Pod")[0]
                       if p.name.startswith("crit-") and p.node_name) == 2
        _settle(sched, api, clock, crits_bound)
        assert crits_bound()
        _close(sched)
        return _placements(api)
    _both(run)


def test_preemption_respects_anti_affinity(pod_priority):
    """A preemptor blocked by anti-affinity against a HIGHER-priority pod
    evicts nothing."""
    def run(side):
        t = side["t"]
        clock = FakeClock()
        api = side["api"].ApiServerLite()
        node = t.make_node("n1", cpu=2000, memory=8 * Gi)
        node.labels["kubernetes.io/hostname"] = "n1"
        api.create("Node", node)
        sched = side["sched"].Scheduler(api, now=clock, **side["kw"])
        sched.start()
        blocker = prio_pod(side, "blocker", 2000, cpu=100, mem=64 * Mi)
        blocker.labels["app"] = "db"
        api.create("Pod", blocker)
        for i in range(2):
            api.create("Pod", prio_pod(side, f"low-{i}", 1, cpu=900,
                                       mem=64 * Mi))
        sched.run_until_drained()
        pre = prio_pod(side, "pre", 500, cpu=900, mem=64 * Mi)
        pre.affinity = t.Affinity(pod_anti_affinity=t.PodAffinity(
            required_terms=[t.PodAffinityTerm(
                label_selector=t.LabelSelector(match_labels={"app": "db"}),
                topology_key="kubernetes.io/hostname")]))
        api.create("Pod", pre)
        stats = sched.schedule_round()
        assert stats["unschedulable"] == 1 and stats["preemptions"] == 0
        placed = _placements(api)
        assert all(placed[f"low-{i}"] for i in range(2))
        _close(sched)
        return placed
    _both(run)


# ------------------------------------------------------- the wave path


def _classic_plans(side, cache, preemptors):
    """The classic `_preempt_round` planning loop, side effects stripped
    (the reference's own oracle for the wave path)."""
    infos = cache.snapshot_infos()
    ctx = side["oe"].SchedulingContext(
        infos, [], hard_pod_affinity_weight=1,
        volume_ctx=side["vol"].VolumeContext(), policy_algos=None)
    state = None
    out = []
    for pod in sorted(preemptors, key=lambda p: -p.priority):
        if pod.priority <= 0:
            break
        if state is None:
            state = side["pm"].PreemptionState(infos)
        plan = side["pm"].pick_preemption(pod, infos, ctx=ctx, state=state)
        if plan is None:
            continue
        info = infos.get(plan.node_name)
        for vic in plan.victims:
            info.remove_pod(vic)
        info.add_pod(pod)
        state.apply_plan(plan, pod)
        ctx.infos = infos
        ctx.invalidate()
        out.append((pod.key(), plan.node_name,
                    sorted(v.key() for v in plan.victims)))
    return out


def _wave_plans(side, eng, pre):
    return [(pl.pod.key(), pl.node_name,
             sorted(v.key() for v in pl.victims))
            for pl in side["pw"].plan_wave_preemptions(eng, pre)]


def test_fuzz_wave_plans_equal_classic_and_reference():
    def run(side):
        out = []
        for seed in range(24):
            cache, pre = _fuzz_cache(side, seed)
            wave = _wave_plans(side, _engine(side, cache), pre)
            assert wave == _classic_plans(side, cache, pre), seed
            out.append(wave)
        c = _counts(side)
        assert c["engine.preempt_scan_dispatch"] > 0
        assert c["engine.preempt_scan_host_fallback"] == 0
        return out, c
    _both(run)


def test_fuzz_equal_with_affinity_residents():
    """Affinity-carrying residents gate the verification memo off; the
    plans still equal the classic ones and the reference's."""
    def run(side):
        t = side["t"]
        out = []
        for seed in (3, 7, 11):
            cache, pre = _fuzz_cache(side, seed)
            carrier = prio_pod(side, f"carrier-{seed}", 0, cpu=100,
                               node_name="n00")
            carrier.labels = {"app": "x"}
            carrier.affinity = t.Affinity(pod_anti_affinity=t.PodAffinity(
                required_terms=[t.PodAffinityTerm(
                    label_selector=t.LabelSelector(
                        match_labels={"app": "x"}),
                    namespaces=[],
                    topology_key="kubernetes.io/hostname")]))
            cache.add_pod(carrier)
            wave = _wave_plans(side, _engine(side, cache), pre)
            assert wave == _classic_plans(side, cache, pre), seed
            out.append(wave)
        return out
    _both(run)


def _full_cluster(side, n_nodes=2, slots=4, evict_fail=0.0,
                  evict_timeout=0.0, clock=None):
    """A cluster preloaded FULL of bound low-priority pods, wrapped in
    the eviction-fault proxy, plus a streaming scheduler."""
    api = side["api"].ApiServerLite()
    t = side["t"]
    nodes = [t.make_node(f"n{i:02d}", cpu=slots * 200, memory=16 * Gi,
                         pods=slots) for i in range(n_nodes)]
    pods = [prio_pod(side, f"low-{i * slots + j:02d}", 0,
                     node_name=f"n{i:02d}")
            for i in range(n_nodes) for j in range(slots)]
    side["hollow"].load_cluster(api, nodes, pods)
    fapi = side["churn"].FaultyBindApi(api, evict_fail_rate=evict_fail,
                                       evict_timeout_rate=evict_timeout)
    s = side["sched"].Scheduler(fapi, record_events=False,
                                now=clock or FakeClock(), **side["kw"])
    s.start()
    return api, fapi, s


def _steps(loop, n, clock=None, stop=None, total=None):
    total = {} if total is None else total
    for _ in range(n):
        for k, v in loop.step().items():
            total[k] = total.get(k, 0) + v
        if clock is not None:
            clock.t += 3.0
        if stop is not None and stop(total):
            break
    return total


def _transitions(side, api):
    tr = side["churn"].audit_store_transitions(api)
    return tr["binds"], tr["evicts"]


def test_preempt_commit_binds_preemptor_and_requeues_victims(pod_priority):
    def run(side):
        api, fapi, s = _full_cluster(side)
        loop = s.stream(budget_s=30.0, min_quantum=16, max_quantum=16)
        api.create("Pod", prio_pod(side, "hi", 1000))
        total = _steps(loop, 6, stop=lambda t: t.get("preemptions", 0))
        assert total.get("preemptions", 0) == 1, total
        assert total.get("victims_evicted", 0) == 1
        placed = _placements(api)
        assert placed["hi"]
        unbound = [n for n, v in placed.items() if not v and n != "hi"]
        assert len(unbound) == 1
        _steps(loop, 3)
        loop.flush()
        assert f"default/{unbound[0]}" in s.queue._keys
        assert not side["churn"].audit_cache_vs_store(s, api)
        loop.close()
        _close(s)
        return placed, total, _counts(side)
    _both(run)


@pytest.mark.parametrize("fault", ["evict_fail", "evict_timeout"])
def test_injected_eviction_faults(pod_priority, fault):
    """evict_fail: every commit fails and rolls back with zero residue;
    once faults stop the same preemptor commits once. evict_timeout: the
    commit LANDS but errors — the watch stream heals it and the store
    shows exactly one bind of the preemptor and one eviction a victim."""
    def run(side):
        clock = FakeClock()
        api, fapi, s = _full_cluster(side, clock=clock, **{fault: 1.0})
        loop = s.stream(budget_s=30.0, min_quantum=16, max_quantum=16)
        loop.degrade_window = 99
        api.create("Pod", prio_pod(side, "hi", 1000))
        if fault == "evict_fail":
            total = _steps(loop, 4, clock)
            assert total.get("preempt_rollbacks", 0) >= 1, total
            assert total.get("preemptions", 0) == 0
            assert not api.get("Pod", "default", "hi").node_name
            assert not s.cache.is_assumed("default/hi")
            assert "default/hi" in s.queue._keys
            assert not side["churn"].audit_cache_vs_store(s, api)
            fapi.evict_fail_rate = 0.0
            clock.t += 3.0
            total = _steps(loop, 4, clock,
                           stop=lambda t: t.get("preemptions", 0),
                           total=total)
            assert total.get("preemptions", 0) == 1, total
        else:
            total = _steps(loop, 6, clock, stop=lambda t: bool(
                api.get("Pod", "default", "hi").node_name
                and "default/hi" not in s.queue._keys))
            assert total.get("preempt_rollbacks", 0) >= 1, total
            assert "default/hi" not in s.queue._keys
            assert not s.cache.is_assumed("default/hi")
        assert api.get("Pod", "default", "hi").node_name
        binds, evicts = _transitions(side, api)
        assert binds["default/hi"] == 1
        assert all(c == 1 for c in evicts.values()), evicts
        assert not side["churn"].audit_cache_vs_store(s, api)
        loop.close()
        _close(s)
        return _placements(api), total, _counts(side), binds, evicts
    _both(run)


def test_crash_mid_preemption_relist_audit(pod_priority):
    def run(side):
        clock = FakeClock()
        api, fapi, s = _full_cluster(side, evict_timeout=1.0, clock=clock)
        loop = s.stream(budget_s=30.0, min_quantum=16, max_quantum=16)
        loop.degrade_window = 99
        api.create("Pod", prio_pod(side, "hi", 1000))
        _steps(loop, 3, clock, stop=lambda t: t.get("preempt_rollbacks", 0))
        _close(s)
        s2 = side["sched"].Scheduler(fapi, record_events=False, now=clock,
                                     **side["kw"])
        s2.start()
        loop2 = s2.stream(budget_s=30.0, min_quantum=16, max_quantum=16)
        loop2.degrade_window = 99
        _steps(loop2, 4, clock)
        binds, evicts = _transitions(side, api)
        assert binds.get("default/hi", 0) == 1
        assert all(c == 1 for c in evicts.values()), evicts
        assert not side["churn"].audit_cache_vs_store(s2, api)
        loop2.close()
        _close(s2)
        return _placements(api), binds, evicts
    _both(run)


@pytest.mark.parametrize("case", ["window", "band_floor"])
def test_disruption_budget(case):
    def run(side):
        DB = side["pw"].DisruptionBudget
        if case == "window":
            clock = FakeClock()
            b = DB(max_evictions_per_min=3, now=clock)
            vics = [prio_pod(side, f"v{i}", 0) for i in range(2)]
            got = [b.admit(vics), b.admit([vics[0]]), b.admit([vics[1]]),
                   b.window_evictions()]
            clock.t += 61.0
            got += [b.admit(vics), b.window_evictions()]
            assert got == [True, True, False, 3, True, 2]
        else:
            b = DB(max_evictions_per_min=100, band_floor={0: 5})
            vics = [prio_pod(side, f"v{i}", 0) for i in range(3)]
            got = [b.admit(vics, band_counts={0: 7}),
                   b.admit(vics, band_counts={0: 9}),
                   b.admit([prio_pod(side, "x", 100)],
                           band_counts={0: 5, 100: 99})]
            assert got == [False, True, True]
        return got
    _both(run)


def test_budget_deferred_blocks_eviction_e2e(pod_priority):
    def run(side):
        api, fapi, s = _full_cluster(side)
        s.disruption_budget = side["pw"].DisruptionBudget(
            max_evictions_per_min=0)
        loop = s.stream(budget_s=30.0, min_quantum=16, max_quantum=16)
        api.create("Pod", prio_pod(side, "hi", 1000))
        total = _steps(loop, 4)
        assert total.get("budget_deferred", 0) >= 1, total
        assert total.get("preemptions", 0) == 0
        placed = _placements(api)
        assert all(v for n, v in placed.items() if n != "hi")
        assert not placed["hi"]
        loop.close()
        _close(s)
        return placed, total, _counts(side)
    _both(run)


def test_preemption_rides_wave_path_without_flush(pod_priority):
    """Victims are unbound (not deleted), the scan runs on the engine's
    device, the commit is reported through the wave path's stats and the
    loop never degrades."""
    def run(side):
        api, fapi, s = _full_cluster(side, n_nodes=3, slots=4)
        loop = s.stream(budget_s=30.0, min_quantum=16, max_quantum=16)
        api.create("Pod", prio_pod(side, "hi", 1000))
        total = _steps(loop, 6, stop=lambda t: t.get("preemptions", 0))
        c = _counts(side)
        assert total.get("preemptions", 0) == 1
        assert c["engine.preempt_scan_dispatch"] >= 1
        assert c["engine.preempt_commits"] == 1
        assert c["engine.preempt_scan_host_fallback"] == 0
        assert len(api.list("Pod")[0]) == 3 * 4 + 1
        assert not loop.degraded
        snap = side["COUNTERS"].snapshot()
        chunk_flush = snap.get("stream.chunk_flush", (0, 0))[0]
        assert chunk_flush == 0
        loop.close()
        _close(s)
        return _placements(api), total, c
    _both(run)


def test_preempt_counters_and_recorder_lane(pod_priority):
    """The propose / commit / victim-requeue events land on the ring, the
    perfetto export draws them on the preempt lane, and the counters
    reach the unified registry and VerdictService's debug snapshot."""
    def run(side):
        root = side["t"].__name__.split(".")[0]
        mod = {m: importlib.import_module(f"{root}.{p}") for m, p in (
            ("rec", "observability.recorder"),
            ("perfetto", "observability.perfetto"),
            ("registry", "observability.registry"),
            ("embedded", "server.embedded"),
            ("extender", "server.extender"))}
        recorder = mod["rec"].RECORDER
        api, fapi, s = _full_cluster(side)
        loop = s.stream(budget_s=30.0, min_quantum=16, max_quantum=16)
        recorder.clear()
        recorder.enable()
        try:
            api.create("Pod", prio_pod(side, "hi", 1000))
            total = _steps(loop, 6, stop=lambda t: t.get("preemptions", 0))
        finally:
            recorder.disable()
        assert total.get("preemptions", 0) == 1
        events = recorder.snapshot()
        recorder.clear()
        kinds = {e["kind"] for e in events}
        assert {"preempt_propose", "preempt_commit",
                "victim_requeue"} <= kinds, kinds
        trace = mod["perfetto"].build_chrome_trace(events)
        lanes = {e["args"]["name"] for e in trace["traceEvents"]
                 if e.get("name") == "thread_name"}
        assert "preempt" in lanes
        names = [e["name"] for e in trace["traceEvents"]]
        assert any(n.startswith("victim-select") for n in names), names
        assert any(n.startswith("preempt-commit") for n in names), names
        snap = mod["registry"].TelemetryRegistry().snapshot()
        assert snap.get("span.engine.preempt_commits.count", 0) >= 1
        assert "span.engine.victims_evicted.count" in snap
        backend = mod["extender"].TPUExtenderBackend(**side["kw"])
        dv = mod["embedded"].VerdictService(backend).debug_snapshot()["vars"]
        assert dv.get("span.engine.preempt_commits.count", 0) >= 1
        assert "span.engine.preempt_scan_dispatch.count" in dv
        loop.close()
        _close(s)
        return (sorted(kinds), sorted(lanes),
                sorted(n for n in names if n.startswith(
                    ("victim-select", "preempt-commit"))),
                _placements(api), total, _counts(side))
    _both(run)


def test_sustained_preempt_rollbacks_trip_degraded_mode(pod_priority):
    def run(side):
        clock = FakeClock()
        api, fapi, s = _full_cluster(side, evict_fail=1.0, clock=clock)
        loop = s.stream(budget_s=30.0, min_quantum=16, max_quantum=16)
        loop.degrade_window = 3
        api.create("Pod", prio_pod(side, "hi", 1000))
        steps = 0
        for _ in range(8):
            loop.step()
            clock.t += 3.0
            steps += 1
            if loop.degraded:
                break
        assert loop.degraded
        loop.close()
        _close(s)
        return steps, _counts(side)
    _both(run)
