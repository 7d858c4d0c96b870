"""Gangs (coscheduling) on the port's two drain paths, held against the
reference package's on the CPU, exactly. Mirrors the reference's
tests/test_gang.py case by case: each scenario runs through both packages
and the placements, drain totals, gang bookkeeping and gang counters must
be equal — and each side is held to the all-or-nothing contract itself
(a gang that cannot fully place leaves zero residue)."""

from __future__ import annotations

import numpy as np
import pytest

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.engine import gang as jgang
from kubernetes_tpu.engine import scheduler as jsched
from kubernetes_tpu.models import hollow as jh
from kubernetes_tpu.server import apiserver_lite as japi
from kubernetes_tpu.utils import trace as jtrace
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.engine import gang as tgang
from kubernetes_tpu_torch.engine import scheduler as tsched
from kubernetes_tpu_torch.models import hollow as th
from kubernetes_tpu_torch.server import apiserver_lite as tapi
from kubernetes_tpu_torch.utils import trace as ttrace

Mi = 1 << 20
Gi = 1 << 30
REF = dict(t=jt, gang=jgang, sched=jsched, hollow=jh, api=japi,
           COUNTERS=jtrace.COUNTERS, kw={})
PORT = dict(t=tt, gang=tgang, sched=tsched, hollow=th, api=tapi,
            COUNTERS=ttrace.COUNTERS, kw={"device": "cpu"})
SIDES = (REF, PORT)
GANG_COUNTERS = ("engine.gang_wave_dispatch", "engine.gang_fence_rollbacks",
                 "engine.fence_reason_gang", "engine.wave_flush_gang_host",
                 "engine.wave_dispatch", "stream.chunk_flush")


def _both(fn):
    """Run one scenario through both packages (counters reset before
    each); the results must be equal. Drain totals other than "bound"
    count pops, so only the bound count is compared. Every scheduler
    here runs on a fake clock (a backoff expires only when a test moves
    the clock), so the counters do not depend on how fast a side runs."""
    out = []
    for side in SIDES:
        side["COUNTERS"].reset()
        out.append(fn(side))
    assert out[1] == out[0]
    return out[1]


def _counts(side):
    snap = side["COUNTERS"].snapshot()
    return {k: snap.get(k, (0, 0))[0] for k in GANG_COUNTERS}


def _gang_pod(side, name, gang, quorum, cpu=100):
    g = side["gang"]
    p = side["t"].make_pod(name, cpu=cpu, memory=64 * Mi)
    p.annotations[g.GANG_NAME_ANNOTATION] = gang
    p.annotations[g.GANG_MIN_AVAILABLE_ANNOTATION] = str(quorum)
    return p


def _frozen():
    return 1000.0


def _rig(side, n_nodes=4, cpu=1000, **kw):
    api = side["api"].ApiServerLite()
    for i in range(n_nodes):
        api.create("Node", side["t"].make_node(f"n{i}", cpu=cpu,
                                               memory=8 * Gi))
    sched = side["sched"].Scheduler(api, **{"record_events": False,
                                            "now": _frozen,
                                            **kw, **side["kw"]})
    sched.start()
    return api, sched


def _placements(api):
    return {p.name: (p.node_name or None) for p in api.list("Pod")[0]}


def _by_gang(side, api):
    key = side["gang"].GANG_NAME_ANNOTATION
    by_gang = {}
    for p in api.list("Pod")[0]:
        by_gang.setdefault(p.annotations[key], []).append(bool(p.node_name))
    return by_gang


def _close(sched):
    """Stop the port engine's wave worker (the reference has none)."""
    close = getattr(sched.engine, "close", None)
    if close is not None:
        close()


def _zero_residue(sched):
    return all(info.requested.milli_cpu == 0 and not info.pods
               for info in sched.cache.node_infos().values())


# ------------------------------------------------------- classic semantics


@pytest.mark.parametrize("pipeline", [None, False])
def test_gang_schedules_atomically_when_it_fits(pipeline):
    def run(side):
        api, sched = _rig(side)
        for i in range(6):
            api.create("Pod", _gang_pod(side, f"g-{i}", "job-a", 6))
        totals = sched.run_until_drained(pipeline=pipeline)
        assert totals["bound"] == 6
        placed = _placements(api)
        assert all(placed.values())
        _close(sched)
        return placed, totals["bound"], _counts(side), sched.engine.rr.counter
    _both(run)


def test_gang_waits_for_quorum():
    def run(side):
        api, sched = _rig(side)
        for i in range(3):
            api.create("Pod", _gang_pod(side, f"g-{i}", "job-a", 6))
        sched.run_until_drained()
        first = _placements(api)
        assert not any(first.values()), "below quorum: nothing binds"
        assert "job-a" in sched._gang_waiting
        for i in range(3, 6):
            api.create("Pod", _gang_pod(side, f"g-{i}", "job-a", 6))
        totals = sched.run_until_drained()
        assert totals["bound"] == 6
        assert "job-a" not in sched._gang_waiting
        _close(sched)
        return first, _placements(api), totals["bound"], _counts(side)
    _both(run)


@pytest.mark.parametrize("case", ["infeasible", "partial_fit"])
def test_gang_that_cannot_place_leaves_zero_residue(case):
    """infeasible: one member can never fit and quorum is the full gang;
    partial_fit: 3 x 650m on 2 x 1000m passes the aggregate precheck but
    only one member fits per node. Either way no member binds and no
    member stays assumed."""
    def run(side):
        if case == "infeasible":
            api, sched = _rig(side, n_nodes=4, cpu=1000)
            for i in range(4):
                api.create("Pod", _gang_pod(side, f"g-{i}", "job-x", 5))
            api.create("Pod", _gang_pod(side, "g-huge", "job-x", 5,
                                        cpu=50_000))
        else:
            api, sched = _rig(side, n_nodes=2, cpu=1000)
            for i in range(3):
                api.create("Pod", _gang_pod(side, f"g-{i}", "job-p", 3,
                                            cpu=650))
        totals = sched.run_until_drained()
        assert totals["bound"] == 0
        placed = _placements(api)
        assert not any(placed.values())
        assert _zero_residue(sched)
        _close(sched)
        return placed, totals["bound"], _counts(side)
    _both(run)


def test_quorum_commit_with_stragglers_retrying_solo():
    """The gang commits when minAvailable members place; the extra member
    retries individually once capacity frees."""
    def run(side):
        t = [1000.0]
        api, sched = _rig(side, n_nodes=2, cpu=1000, now=lambda: t[0])
        for i in range(3):
            api.create("Pod", _gang_pod(side, f"g-{i}", "job-q", 2,
                                        cpu=650))
        totals = sched.run_until_drained()
        assert totals["bound"] == 2
        first = _placements(api)
        assert "job-q" in sched._gang_degraded
        bound = sorted(n for n, v in first.items() if v)
        victim = api.get("Pod", "default", bound[0])
        api.delete("Pod", victim.namespace, victim.name)
        for _ in range(20):
            sched.schedule_round()
            if all(p.node_name for p in api.list("Pod")[0]):
                break
            t[0] += 2.0   # past the straggler's backoff
        final = _placements(api)
        assert sum(1 for v in final.values() if v) == 2
        _close(sched)
        return first, final, totals["bound"]
    _both(run)


def test_gangs_mix_with_plain_pods():
    def run(side):
        api, sched = _rig(side, n_nodes=4, cpu=4000)
        for i in range(4):
            api.create("Pod", _gang_pod(side, f"g-{i}", "job-m", 4))
        for i in range(8):
            api.create("Pod", side["t"].make_pod(f"plain-{i}", cpu=100))
        totals = sched.run_until_drained()
        assert totals["bound"] == 12
        _close(sched)
        return _placements(api), totals["bound"], _counts(side)
    _both(run)


def _storm(side, gang_pipeline=True, max_batch=None, overlap=True):
    api = side["api"].ApiServerLite()
    for i in range(50):
        api.create("Node", side["t"].make_node(f"node-{i:03d}", cpu=16_000,
                                               memory=64 * Gi))
    for p in side["hollow"].gang_pods(32 * 8):  # gangs 15, 31 infeasible
        api.create("Pod", p)
    sched = side["sched"].Scheduler(api, record_events=False, now=_frozen,
                                    **side["kw"])
    sched.gang_pipeline = gang_pipeline
    sched.start()
    kw = {} if max_batch is None else {"max_batch": max_batch}
    totals = sched.run_until_drained(overlap=overlap, **kw)
    return api, sched, totals


def test_gang_bench_profile_places_feasible_gangs_only():
    """The gang storm profile: every feasible gang fully binds, every
    infeasible gang fully stays pending."""
    def run(side):
        api, sched, totals = _storm(side)
        by_gang = _by_gang(side, api)
        assert len(by_gang) == 32
        for gname, flags in by_gang.items():
            assert len(set(flags)) == 1, f"{gname} partially bound"
        assert sum(1 for f in by_gang.values() if f[0]) == 30
        assert totals["bound"] == 30 * 8
        _close(sched)
        return _placements(api), totals["bound"], _counts(side), \
            sched.engine.rr.counter
    _both(run)


@pytest.mark.parametrize("case", ["fires_on_empty_rounds",
                                  "completing_in_timeout_round"])
def test_gang_park_timeout(case):
    """A parked below-quorum gang hits the timeout sweep on an empty
    round (FailedScheduling, backoff requeue); a gang whose last quorum
    member arrives in the timeout round schedules instead."""
    def run(side):
        t = [1000.0]
        api = side["api"].ApiServerLite()
        n = 1 if case == "fires_on_empty_rounds" else 3
        for i in range(n):
            api.create("Node", side["t"].make_node(f"n{i}", cpu=4000,
                                                   memory=8 * Gi))
        sched = side["sched"].Scheduler(api, now=lambda: t[0],
                                        **side["kw"])
        sched.start()
        quorum = 3 if case == "fires_on_empty_rounds" else 2
        api.create("Pod", _gang_pod(side, "g-a", "g", quorum))
        sched.schedule_round()           # parks below quorum
        assert sched._gang_waiting.get("g")
        t[0] += sched.GANG_WAIT_TIMEOUT_S + 1
        if case == "completing_in_timeout_round":
            api.create("Pod", _gang_pod(side, "g-b", "g", 2))
        sched.schedule_round()
        swept = [e.message for e in sched.events
                 if e.reason == "FailedScheduling"
                 and "below quorum" in e.message]
        placed = _placements(api)
        if case == "fires_on_empty_rounds":
            assert not sched._gang_waiting.get("g") and swept
        else:
            assert sum(1 for v in placed.values() if v) == 2 and not swept
        _close(sched)
        return placed, swept
    _both(run)


# ------------------------------------------------------- the wave path


def test_gang_pipelined_vs_classic_flush_ab():
    """The same gang storm with gangs riding the pipelined wave path and
    in FLUSH mode (every gang chunk drained into the classic round): the
    same gangs fully bind in both, the pipelined run dispatches gangs
    through waves, and the infeasible gangs leave zero residue."""
    def run(side):
        res = {}
        for mode in (True, False):
            side["COUNTERS"].reset()
            api, sched, totals = _storm(side, gang_pipeline=mode,
                                        max_batch=64)
            by_gang = _by_gang(side, api)
            for gname, flags in by_gang.items():
                assert len(set(flags)) == 1, f"{gname} partially bound"
            assert {g for g, f in by_gang.items() if f[0]} == \
                {f"job-{g:04d}" for g in range(32) if g % 16 != 15}
            assert totals["bound"] == 30 * 8
            c = _counts(side)
            if mode:
                assert c["engine.gang_wave_dispatch"] >= 30, c
                used = sum(i.requested.milli_cpu
                           for i in sched.cache.node_infos().values())
                assert used == 30 * 8 * 100, used
            else:
                assert c["engine.gang_wave_dispatch"] == 0, c
            res[mode] = (_placements(api), totals["bound"], c,
                         sched.engine.rr.counter)
            _close(sched)
        return res
    _both(run)


def test_gang_pipelined_overlap_ab_bit_identical():
    """The gang-bearing pipelined drain with overlap off gives the same
    placements as with overlap on (the gang fence, not timing, decides
    every commit and rollback) — and the port's equal the reference's."""
    def run(side):
        res = []
        for overlap in (True, False):
            api = side["api"].ApiServerLite()
            for i in range(8):
                api.create("Node", side["t"].make_node(
                    f"n{i}", cpu=2000, memory=8 * Gi))
            for g in range(4):
                for m in range(4):
                    api.create("Pod", _gang_pod(side, f"g{g}-{m}",
                                                f"job-{g}", 4, cpu=450))
            for i in range(6):
                api.create("Pod", side["t"].make_pod(
                    f"plain-{i}", cpu=300, memory=64 * Mi))
            sched = side["sched"].Scheduler(api, record_events=False,
                                            now=_frozen, **side["kw"])
            sched.start()
            sched.run_until_drained(max_batch=5, overlap=overlap)
            res.append(_placements(api))
            _close(sched)
        assert res[0] == res[1]
        return res[0]
    _both(run)


def test_gang_straggler_released_when_quorum_commits_in_flight():
    def run(side):
        api, sched = _rig(side, n_nodes=4, cpu=4000)
        for i in range(2):
            api.create("Pod", _gang_pod(side, f"q-{i}", "job-s", 2))
        api.create("Pod", _gang_pod(side, "q-late", "job-s", 2))
        totals = sched.run_until_drained(max_batch=2)
        assert totals["bound"] == 3, totals
        assert "job-s" in sched._gang_degraded
        assert not sched._gang_waiting.get("job-s")
        placed = _placements(api)
        assert all(placed.values())
        _close(sched)
        return placed, totals["bound"], _counts(side)
    _both(run)


def test_gang_fence_rollback_is_atomic_with_zero_residue():
    """Gang B's wave is dispatched blind to gang A's unharvested commits
    on the only node: at harvest B fails the capacity re-validation and
    rolls back WHOLE — nothing of B is assumed — and requeues."""
    def run(side):
        api = side["api"].ApiServerLite()
        api.create("Node", side["t"].make_node("n0", cpu=2000,
                                               memory=8 * Gi))
        for g in ("a", "b"):
            for i in range(2):
                api.create("Pod", _gang_pod(side, f"{g}-{i}", f"job-{g}",
                                            2, cpu=1000))
        sched = side["sched"].Scheduler(api, record_events=True,
                                        now=_frozen, **side["kw"])
        sched.start()
        totals = sched.run_until_drained(max_batch=2)
        c = _counts(side)
        assert totals["bound"] == 2, totals
        assert totals["gang_requeued"] >= 2, totals
        assert c["engine.gang_fence_rollbacks"] >= 1, c
        by_gang = _by_gang(side, api)
        assert all(len(set(f)) == 1 for f in by_gang.values())
        assert sum(1 for f in by_gang.values() if f[0]) == 1, by_gang
        info = sched.cache.node_infos()["n0"]
        assert info.requested.milli_cpu == 2000 and len(info.pods) == 2
        evs = [e.message for e in sched.events
               if e.reason == "FailedScheduling" and "wave fence"
               in e.message]
        assert evs
        _close(sched)
        return _placements(api), totals["bound"], c, evs
    _both(run)


def test_gang_with_host_exact_member_flushes_to_the_classic_round():
    """The one disclosed flush corner: a gang whose quorum cannot be
    reached from its wave-eligible rows (a member with more host ports
    than the encoding holds is a host-exact row) makes dispatch_waves
    return None, counted engine.wave_flush_gang_host, and the chunk goes
    to the classic round — which places the whole gang."""
    def run(side):
        t = side["t"]
        api, sched = _rig(side, n_nodes=4, cpu=4000)
        for i in range(3):
            api.create("Pod", _gang_pod(side, f"h-{i}", "job-h", 4))
        p = _gang_pod(side, "h-ports", "job-h", 4)
        p.containers[0].ports = [t.ContainerPort(host_port=9000 + i)
                                 for i in range(10)]
        api.create("Pod", p)
        for i in range(4):
            api.create("Pod", t.make_pod(f"plain-{i}", cpu=100))
        totals = sched.run_until_drained()
        c = _counts(side)
        assert c["engine.wave_flush_gang_host"] >= 1, c
        placed = _placements(api)
        assert all(placed.values()), placed
        _close(sched)
        return placed, totals["bound"], c
    _both(run)


def test_gang_fuzz_all_or_nothing_invariant():
    """Randomized gang mixes: every gang is fully placed (>= quorum
    bound) or leaves zero residue, no node is over capacity, and the
    port places every trial exactly as the reference."""
    rng = np.random.default_rng(1234)
    trials = []
    for _ in range(8):
        n_nodes = int(rng.integers(2, 6))
        gangs = {}
        for g in range(int(rng.integers(1, 4))):
            size = int(rng.integers(1, 5))
            gangs[f"g{g}"] = (size, int(rng.integers(1, size + 1)),
                              int(rng.integers(100, 700)))
        plain = [int(rng.integers(50, 400))
                 for _ in range(int(rng.integers(0, 4)))]
        trials.append((n_nodes, gangs, plain))

    def run(side):
        out = []
        for trial, (n_nodes, gangs, plain) in enumerate(trials):
            api, sched = _rig(side, n_nodes=n_nodes, cpu=1000,
                              record_events=True)
            for gname, (size, quorum, cpu) in gangs.items():
                for m in range(size):
                    api.create("Pod", _gang_pod(side, f"{gname}-{m}",
                                                gname, quorum, cpu=cpu))
            for j, cpu in enumerate(plain):
                api.create("Pod", side["t"].make_pod(
                    f"plain-{j}", cpu=cpu, memory=64 * Mi))
            sched.run_until_drained(max_rounds=50)
            pods = api.list("Pod")[0]
            for gname, (size, quorum, _cpu) in gangs.items():
                bound = [p for p in pods
                         if p.name.startswith(gname + "-") and p.node_name]
                assert len(bound) == 0 or len(bound) >= quorum, \
                    (trial, gname, len(bound), size, quorum)
            per_node = {}
            for p in pods:
                if p.node_name:
                    per_node[p.node_name] = per_node.get(p.node_name, 0) \
                        + p.resource_request().milli_cpu
            assert all(v <= 1000 for v in per_node.values()), trial
            out.append(_placements(api))
            _close(sched)
        return out
    _both(run)
