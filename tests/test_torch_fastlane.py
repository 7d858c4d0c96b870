"""The Sparrow fast lane in the port, held against the reference package on
the CPU, exactly.

- ``ops/fastlane.sample_eval`` (torch) against the reference's jitted
  ``sample_eval`` and the numpy twin ``sample_eval_host`` on the same
  seeded node rows and index sets: ties, all-unfit samples, memory and
  disk pressure, taints, cordoned and invalid rows, zero requests and
  best-effort pods, the scratch/overlay storage rule.
- The cases of the reference's tests/test_fastlane.py that run without a
  wall clock, through both packages: the tier contract and eligibility,
  the armed-but-unused lane giving the lane-less placements, fast pods
  binding through the lane with a partition of outcomes, the delta-free
  fast-only window, the contended last slot (exactly one bind), the
  capacity-fence resample and fallback, the doomed-node note, the device
  route when no wave is in flight, and the queue's tiering.
- The trend gate's fast-lane headlines, its box-shape annotation and its
  CPU-count fallback, through both packages' ``observability/trend``.
Placements and outcome counters must be equal. Which twin served an
eval depends on whether the port's wave job had finished, so the
device/host dispatch split is compared only where the test fixes it."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.engine import fastlane as jfl
from kubernetes_tpu.engine import scheduler as jsched
from kubernetes_tpu.models import hollow as jh
from kubernetes_tpu.observability import trend as jtrend
from kubernetes_tpu.ops import fastlane as jops
from kubernetes_tpu.server import apiserver_lite as japi
from kubernetes_tpu.state import snapshot as jsnap
from kubernetes_tpu.utils import features as jfeat
from kubernetes_tpu.utils import trace as jtrace
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.engine import fastlane as tfl
from kubernetes_tpu_torch.engine import scheduler as tsched
from kubernetes_tpu_torch.models import hollow as th
from kubernetes_tpu_torch.observability import trend as ttrend
from kubernetes_tpu_torch.ops import fastlane as tops
from kubernetes_tpu_torch.server import apiserver_lite as tapi
from kubernetes_tpu_torch.state import snapshot as tsnap
from kubernetes_tpu_torch.utils import features as tfeat
from kubernetes_tpu_torch.utils import trace as ttrace

Mi = 1 << 20
Gi = 1 << 30
REF = dict(t=jt, fl=jfl, sched=jsched, hollow=jh, api=japi, feat=jfeat,
           COUNTERS=jtrace.COUNTERS, kw={})
PORT = dict(t=tt, fl=tfl, sched=tsched, hollow=th, api=tapi, feat=tfeat,
            COUNTERS=ttrace.COUNTERS, kw={"device": "cpu"})
SIDES = (REF, PORT)
TRACE = (37, 128, 5, 96)
OUTCOMES = ("fastlane.bound", "fastlane.fell_back", "fastlane.bind_error",
            "fastlane.superseded")


def _both(fn):
    out = []
    for side in SIDES:
        side["COUNTERS"].reset()
        out.append(fn(side))
    assert out[1] == out[0]
    return out[1]


def _close(sched):
    close = getattr(sched.engine, "close", None)
    if close is not None:
        close()


def mk_sched(side, n_nodes=64):
    api = side["api"].ApiServerLite()
    side["hollow"].load_cluster(api, side["hollow"].hollow_nodes(n_nodes),
                                [])
    s = side["sched"].Scheduler(api, record_events=False, **side["kw"])
    s.start()
    return api, s


def feed(side, api, group, tag):
    for p in side["hollow"].PROFILES["density"](group):
        p.name = f"{tag}-{p.name}"
        api.create("Pod", p)


def fast_pod(side, name, cpu=100, mem=128 * Mi):
    p = side["t"].make_pod(name, cpu=cpu, memory=mem)
    p.annotations[side["fl"].FASTLANE_ANNOTATION] = "true"
    return p


def placements(api):
    return {p.name: (p.node_name or None) for p in api.list("Pod")[0]}


def fast_counters(side, split=False):
    """fastlane.* counters; the device/host dispatch split only when
    `split` (it depends on wave timing in the port)."""
    return {k: v[0] for k, v in side["COUNTERS"].snapshot().items()
            if k.startswith("fastlane.")
            and (split or not k.startswith("fastlane.dispatch_"))}


def _solo(side, cpu=150, name="solo", mem=1 * Gi):
    api = side["api"].ApiServerLite()
    side["hollow"].load_cluster(api, [side["t"].make_node(
        name, cpu=cpu, memory=mem, pods=110)], [])
    s = side["sched"].Scheduler(api, record_events=False, **side["kw"])
    s.start()
    return api, s


# ------------------------------------------------------------ sample_eval


def _node_rows(seed, n=96, r=6):
    """Seeded resident node rows in the snapshot's layout (int32 [N, R]
    resources, bool conditions, a taint matrix)."""
    rng = np.random.default_rng(seed)
    alloc = np.zeros((n, r), dtype=np.int32)
    alloc[:, jsnap.R_CPU] = rng.choice([1000, 2000, 4000], n)
    alloc[:, jsnap.R_MEM] = rng.choice([4 << 20, 8 << 20], n)
    alloc[:, jsnap.R_SCRATCH] = rng.choice([0, 1 << 20], n)
    alloc[:, jsnap.R_OVERLAY] = rng.choice([0, 0, 1 << 19], n)
    if r > jsnap.NUM_BASE_RESOURCES:
        alloc[:, jsnap.NUM_BASE_RESOURCES:] = rng.integers(0, 4, (n, r - 5))
    requested = (alloc * rng.uniform(0, 1.1, (n, 1))).astype(np.int32)
    rows = {
        "alloc": alloc, "requested": requested,
        "pod_count": rng.integers(0, 110, n).astype(np.int32),
        "allowed_pods": np.full(n, 110, dtype=np.int32),
        "schedulable": rng.random(n) > 0.1,
        "valid": rng.random(n) > 0.05,
        "mem_pressure": rng.random(n) > 0.8,
        "disk_pressure": rng.random(n) > 0.9,
        "taints_sched": rng.random((n, 3)) > 0.85,
    }
    for v in rows.values():   # ties: every fourth row a copy of row 0
        v[::4] = v[0]
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("req_kind,zero_req,best_effort", [
    ("small", False, False), ("small", False, True), ("zero", True, True),
    ("big", False, False), ("storage", False, False)])
def test_sample_eval_equals_reference_and_host_twin(seed, req_kind,
                                                    zero_req, best_effort):
    nodes = _node_rows(seed)
    assert len(nodes) == len(tops.FAST_NODE_KEYS)
    req = np.zeros(nodes["alloc"].shape[1], dtype=np.int32)
    if req_kind == "small":
        req[jsnap.R_CPU], req[jsnap.R_MEM] = 100, 128 << 10
    elif req_kind == "big":   # fits almost nowhere: all-unfit samples
        req[jsnap.R_CPU], req[jsnap.R_MEM] = 3900, 7 << 20
    elif req_kind == "storage":
        req[jsnap.R_CPU], req[jsnap.R_MEM] = 100, 64 << 10
        req[jsnap.R_SCRATCH], req[jsnap.R_OVERLAY] = 1 << 18, 1 << 17
    tnodes = {k: torch.from_numpy(v.copy()) for k, v in nodes.items()}
    rng = np.random.default_rng(100 + seed)
    for k in (16, 16, 1, 5):
        idx = rng.integers(0, 96, size=k).astype(np.int32)
        ref = np.asarray(jops.sample_eval(idx, req, zero_req, best_effort,
                                          nodes))
        host = tops.sample_eval_host(idx, req, zero_req, best_effort, nodes)
        out = tops.sample_eval(idx, req, zero_req, best_effort, tnodes)
        assert out.dtype == torch.int32 and out.device.type == "cpu"
        np.testing.assert_array_equal(out.numpy(), ref)
        np.testing.assert_array_equal(host, ref)
    # the ties: a sample of copies of row 0 picks its first occurrence
    idx = np.array([4, 0, 8, 12], dtype=np.int32)
    out = tops.sample_eval(idx, req, zero_req, best_effort, tnodes).numpy()
    ref = np.asarray(jops.sample_eval(idx, req, zero_req, best_effort,
                                      nodes))
    np.testing.assert_array_equal(out, ref)
    if out[1] > 0:
        assert out[0] == 0


def test_fast_node_keys_are_resident_in_the_port_engine():
    """The port's resident node dict carries every key the sampled eval
    gathers, under the reference's names."""
    from kubernetes_tpu_torch.ops import predicates
    assert set(tops.FAST_NODE_KEYS) <= set(predicates._NODE_ARRAY_KEYS)
    assert tops.FAST_NODE_KEYS == jops.FAST_NODE_KEYS
    assert tsnap.R_CPU == jsnap.R_CPU and tsnap.R_OVERLAY == jsnap.R_OVERLAY


# ------------------------------------------------------------ eligibility


def test_tier_contract_and_eligibility_match_reference():
    def run(side):
        t, fl = side["t"], side["fl"]
        out = []
        p = t.make_pod("plain", cpu=100, memory=64 * Mi)
        out.append(fl.is_latency_critical(p))
        p.annotations[fl.FASTLANE_ANNOTATION] = "true"
        out.append((fl.is_latency_critical(p), fl.eligible(p)))
        q = t.make_pod("banded", cpu=100, memory=64 * Mi)
        q.priority = 2_000_000_000
        out.append((fl.is_latency_critical(q), fl.eligible(q)))
        for attr, val in (("node_name", "pinned"),
                          ("node_selector", {"zone": "a"}),
                          ("tolerations", [object()])):
            p = fast_pod(side, "f2")
            setattr(p, attr, val)
            out.append(fl.eligible(p))
        for kw in ({"ports": [8080]}, {"extended": {"example.com/foo": 1}}):
            p = t.make_pod("x", cpu=100, memory=64 * Mi, **kw)
            p.annotations[fl.FASTLANE_ANNOTATION] = "true"
            out.append(fl.eligible(p))
        assert out == [False, (True, True), (True, True), False, False,
                       False, False, False]
        return out
    _both(run)


# ------------------------------------------------------- the loop, e2e


def test_lane_armed_but_unused_is_bit_identical():
    """The lane armed with zero latency-critical pods gives the lane-less
    placements and wave count, touches no fast-lane counter, and the
    port's placements equal the reference's."""
    def run(side):
        res = []
        for fastlane in (True, False):
            api, s = mk_sched(side)
            side["COUNTERS"].reset()
            loop = s.stream(budget_s=30.0, min_quantum=128,
                            max_quantum=128, fastlane=fastlane)
            for gi, group in enumerate(TRACE):
                feed(side, api, group, f"g{gi}")
                loop.step()
            loop.drain()
            loop.close()
            _close(s)
            snap = side["COUNTERS"].snapshot()
            res.append((placements(api),
                        snap.get("engine.wave_dispatch", (0, 0))[0],
                        fast_counters(side, split=True)))
        assert res[0][:2] == res[1][:2] and all(res[0][0].values())
        assert not any(res[0][2].values())
        return res
    _both(run)


@pytest.mark.parametrize("n_fast", [8, 16])
def test_fast_pods_bind_through_the_lane(n_fast):
    """Fast pods after a warm wave bind through the lane; the outcome
    counters partition the fast pods; the fast-only window builds no
    encoding, dispatches no wave and walks no full snapshot."""
    def run(side):
        api, s = mk_sched(side)
        loop = s.stream(budget_s=30.0, fastlane=True)
        feed(side, api, 64, "warm")
        loop.drain()
        side["COUNTERS"].reset()
        for i in range(n_fast):
            api.create("Pod", fast_pod(side, f"fast-{i}"))
        loop.drain()
        loop.close()
        _close(s)
        c = fast_counters(side)
        snap = side["COUNTERS"].snapshot()
        assert c.get("fastlane.bound", 0) == n_fast, c
        assert sum(c.get(k, 0) for k in OUTCOMES) == n_fast
        for k in ("engine.wave_encode_build", "engine.wave_dispatch",
                  "snapshot.refresh_scan", "snapshot.refresh_rebuild"):
            assert snap.get(k, (0, 0))[0] == 0, (k, snap)
        placed = placements(api)
        assert all(placed[f"fast-{i}"] for i in range(n_fast))
        return placed, c
    _both(run)


def test_contended_node_store_truth_shows_exactly_one_bind():
    """A fast bind and an in-flight wave race the one free slot: the fast
    pod lands through its fence, the wave row loses at the harvest."""
    def run(side):
        api, s = _solo(side)
        loop = s.stream(budget_s=30.0, fastlane=True)
        side["COUNTERS"].reset()
        api.create("Pod", side["t"].make_pod("bulk-0", cpu=100,
                                             memory=64 * Mi))
        s.sync()
        pods = s.queue.pop_batch()
        assert [p.name for p in pods] == ["bulk-0"]
        handle = s.engine.dispatch_waves(pods, time.monotonic())
        api.create("Pod", fast_pod(side, "fast-0"))
        s.sync()
        assert loop._pump_fast({}, busy=handle) == 1
        s._complete_wave(handle)
        placed = placements(api)
        assert placed == {"bulk-0": None, "fast-0": "solo"}
        c = fast_counters(side)
        assert c.get("fastlane.bound", 0) == 1, c
        loop.close()
        _close(s)
        return placed, c
    _both(run)


def test_capacity_fence_loss_resamples_then_falls_back():
    def run(side):
        api, s = _solo(side)
        loop = s.stream(budget_s=30.0, fastlane=True)
        side["COUNTERS"].reset()
        api.create("Pod", fast_pod(side, "fast-0"))
        s.sync()
        assert loop._pump_fast({}) == 1
        api.create("Pod", fast_pod(side, "fast-1"))
        s.sync()
        assert loop._pump_fast({}) == 1   # stale eval fits, fence says no
        c = fast_counters(side)
        assert c.get("fastlane.bound", 0) == 1, c
        assert c.get("fastlane.fence_capacity", 0) >= 1, c
        assert c.get("fastlane.fell_back", 0) == 1, c
        assert s.queue.ready_count() == 1
        loop.close()
        _close(s)
        return placements(api), c
    _both(run)


def test_doomed_note_blocks_fast_bind_before_liveness():
    def run(side):
        api, s = _solo(side, cpu=4000, name="dying", mem=4 * Gi)
        loop = s.stream(budget_s=30.0, fastlane=True)
        side["COUNTERS"].reset()
        s.engine.note_node_doomed("dying")
        api.create("Pod", fast_pod(side, "fast-0"))
        s.sync()
        assert loop._pump_fast({}) == 1
        c = fast_counters(side)
        assert c.get("fastlane.fence_doomed", 0) >= 1, c
        assert c.get("fastlane.fell_back", 0) == 1, c
        assert c.get("fastlane.bound", 0) == 0, c
        assert not placements(api)["fast-0"]
        s.engine.clear_node_doomed("dying")
        loop.drain()
        loop.close()
        _close(s)
        assert placements(api)["fast-0"] == "dying"
        return placements(api), c
    _both(run)


def test_device_path_used_when_device_idle_and_current():
    """No wave in flight and the resident node tensors at the snapshot's
    version: the eval runs on the engine's device (counted) and binds
    where the reference's does."""
    def run(side):
        api, s = mk_sched(side, 8)
        loop = s.stream(budget_s=30.0, fastlane=True)
        feed(side, api, 16, "warm")
        loop.drain()
        s.engine._refresh()
        s.engine._nodes_on_device()
        side["COUNTERS"].reset()
        api.create("Pod", fast_pod(side, "fast-dev"))
        s.sync()
        pods = s.queue.pop_fast()
        assert len(pods) == 1
        loop.fastlane.schedule(pods[0], time.monotonic(), device_ok=True)
        c = fast_counters(side, split=True)
        assert c.get("fastlane.dispatch_device", 0) == 1, c
        assert c.get("fastlane.bound", 0) == 1, c
        loop.close()
        _close(s)
        return placements(api), c
    _both(run)


def test_device_and_host_eval_twins_agree_on_the_resident_tensors():
    """After a warm drain, the port's sample_eval over the engine's
    resident tensors equals its host twin over the snapshot arrays, and
    the reference's jitted eval over the reference's snapshot."""
    def run(side):
        api, s = mk_sched(side, 16)
        loop = s.stream(budget_s=30.0, fastlane=True)
        feed(side, api, 48, "warm")
        loop.drain()
        loop.close()
        snap = s.engine.snapshot
        s.engine._refresh()
        dev = s.engine._nodes_on_device()
        host_nodes = {k: np.asarray(getattr(snap, k))
                      for k in jops.FAST_NODE_KEYS}
        req = snap.resource_row(milli_cpu=100, memory=128 * Mi, gpu=0,
                                scratch=0, overlay=0, extended={}, up=True,
                                width=snap.num_resources)
        rng = np.random.default_rng(7)
        out = []
        for _ in range(8):
            idx = rng.integers(0, len(snap.node_names), size=16).astype(
                np.int32)
            if side is PORT:
                host = tops.sample_eval_host(idx, req, False, False,
                                             host_nodes)
                res = tops.sample_eval(idx, req, False, False,
                                       {k: dev[k] for k in
                                        tops.FAST_NODE_KEYS}).numpy()
                np.testing.assert_array_equal(res, host)
            else:
                res = np.asarray(jops.sample_eval(idx, req, False, False,
                                                  host_nodes))
            out.append(res.tolist())
        _close(s)
        return out
    _both(run)


def test_fallback_pod_never_reroutes_into_the_fast_tier():
    def run(side):
        api, s = mk_sched(side, 4)
        loop = s.stream(budget_s=30.0, fastlane=True)
        s.queue.add_bulk([fast_pod(side, "loopy")])
        got = (s.queue.fast_count(), s.queue.ready_count(),
               [q.name for q in s.queue.pop_batch()])
        assert got == (0, 1, ["loopy"])
        loop.close()
        _close(s)
        return got
    _both(run)


def test_bulk_aging_guard_untouched_by_fast_tier():
    def run(side):
        t = side["t"]
        api, s = mk_sched(side, 4)
        loop = s.stream(budget_s=30.0, fastlane=True)
        q = s.queue
        old = t.make_pod("old-victim", cpu=100, memory=64 * Mi)
        young = t.make_pod("young-vip", cpu=100, memory=64 * Mi)
        young.priority = 1000
        side["feat"].DEFAULT_FEATURE_GATE.set("PodPriority", True)
        try:
            q.add(old)
            q.add(young)
            q.add(fast_pod(side, "fast-0"))
            q._queued_at[old.key()] -= q.aging_threshold_s + 1.0
            assert q.fast_count() == 1
            popped = [p.name for p in q.pop_batch()]
        finally:
            side["feat"].DEFAULT_FEATURE_GATE.set("PodPriority", False)
        fast = [p.name for p in q.pop_fast()]
        assert popped == ["old-victim", "young-vip"] and fast == ["fast-0"]
        loop.close()
        _close(s)
        return popped, fast
    _both(run)


# ------------------------------------------------------------ trend gate

TRENDS = pytest.mark.parametrize("trend", [jtrend, ttrend],
                                 ids=["ref", "port"])


def _write_round(tmp_path, r, **metrics):
    import json
    doc = {"n": 1, "cmd": "python bench.py", "rc": 0, "parsed": metrics}
    (tmp_path / f"BENCH_r{r:02d}.json").write_text(json.dumps(doc))


@TRENDS
def test_trend_learns_fastlane_headlines(tmp_path, trend):
    """The trend gate reads `fastlane_p99_ms` (down) and
    `mixed_bulk_sustained` (up) from r19 on: absent history tolerated,
    a past-band move in the bad direction flags."""
    assert ("fastlane_p99_ms", "fastlane p99 ms", "down") \
        in trend.HEADLINE_METRICS
    assert ("mixed_bulk_sustained", "mixed bulk frac", "up") \
        in trend.HEADLINE_METRICS
    _write_round(tmp_path, 18, value=30000.0)  # before r19: no fast keys
    _write_round(tmp_path, 19, value=30000.0, fastlane_p99_ms=7.5,
                 mixed_bulk_sustained=1.0)
    assert trend.find_regressions(trend.load_rounds(str(tmp_path))) == []
    _write_round(tmp_path, 20, value=30000.0, fastlane_p99_ms=25.0,
                 mixed_bulk_sustained=0.5)  # both past the band, bad way
    regs = trend.find_regressions(trend.load_rounds(str(tmp_path)))
    assert sorted(g["metric"] for g in regs) == \
        ["fastlane_p99_ms", "mixed_bulk_sustained"]


@TRENDS
def test_trend_annotates_box_shape_change(tmp_path, capsys, trend):
    """A flagged delta whose two rounds ran on DIFFERENT cpu counts
    carries `box_change` and is reported but NOT gated (exit 0); the
    same delta on a same-shape box gates."""
    _write_round(tmp_path, 18, churn_vs_quiet=0.85, cpus=2)
    _write_round(tmp_path, 19, churn_vs_quiet=0.45, cpus=1)  # 2->1 core
    regs = trend.find_regressions(trend.load_rounds(str(tmp_path)))
    assert [g["metric"] for g in regs] == ["churn_vs_quiet"]
    assert regs[0]["box_change"] == "2 -> 1 cpus"
    assert trend.main(["--root", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "box change: 2 -> 1 cpus" in out and "not gated" in out
    # same drop, same box shape: a real regression, exit 1
    _write_round(tmp_path, 20, churn_vs_quiet=0.85, cpus=1)
    _write_round(tmp_path, 21, churn_vs_quiet=0.45, cpus=1)
    regs = trend.find_regressions(trend.load_rounds(str(tmp_path)))
    assert regs and "box_change" not in regs[0]
    assert trend.main(["--root", str(tmp_path)]) == 1


@TRENDS
def test_round_cpus_reads_r18_multiproc_fallback(trend):
    """Artifacts before r19 disclosed the box only inside the multiproc
    sub-dict; `round_cpus` must still see it."""
    assert trend.round_cpus({"cpus": 2}) == 2
    assert trend.round_cpus({"multiproc": {"cpus": 1}}) == 1
    assert trend.round_cpus({"value": 1.0}) is None
