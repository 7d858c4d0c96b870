"""chip_smoke.py's arrival harness (phase 16: bench.py run_arrival,
measure_churn and measure_rolling_update on the port) at CI scale on the
CPU, as tests/test_bench_scenarios.py runs bench's: every offered pod
binds, create->bound is a real distribution (p50 != p99), the interval
series keeps full buckets only and equals bench.py's on the same events,
a churn leg under seeded faults binds every pod once with clean store
and cache audits, the rolling update keeps its bounds, and a traced
window's tail exemplars telescope exactly."""

from __future__ import annotations

import pytest

import bench
import chip_smoke

M = chip_smoke.stream_mods()


def _run(**kw):
    args = dict(n_nodes=64, rate=300.0, duration_s=2.0, min_quantum=64,
                max_quantum=256, budget_ms=500.0, device="cpu")
    args.update(kw)
    return chip_smoke.arrival(M, **args)


@pytest.fixture(scope="module")
def quiet():
    out = _run()
    yield out
    out["sched"].engine.close()


def test_every_offered_pod_binds(quiet):
    assert quiet["bound"] == 600 and quiet["unbound"] == 0
    assert quiet["duplicate_binds"] == 0
    # the observer is armed after the 64 prime pods: the series holds the
    # offered pods alone, full buckets plus the partial tail
    assert sum(quiet["intervals"]) + quiet["tail_partial"]["binds"] == 600
    assert sum(quiet["offered_series"]) \
        + quiet["tail_partial"]["offered"] == 600
    assert chip_smoke.audit_stream(M, quiet["api"], quiet["sched"],
                                   "quiet", "density") == 600 + 64
    assert quiet["offered_pods_s"] == 300.0
    assert quiet["sustained_pods_s"] > 0
    assert isinstance(quiet["creator_jitter_ok"], bool)
    assert quiet["launches"] == {"capacity_fit": 0, "incidence_matmul": 0}


def test_create_to_bound_is_a_real_distribution(quiet):
    assert 0 < quiet["p50_ms"] < quiet["p99_ms"], quiet


def test_interval_series_drops_trailing_partial_bucket():
    """The cases of tests/test_bench_scenarios.py: full buckets only,
    the remainder apart with its true width, exact telescoping; and the
    harness's series equal to bench.py's on the same events."""
    cases = [
        ([(0.2, ["a"] * 100), (1.3, ["b"] * 100), (2.4, ["c"] * 100),
          (3.05, ["d"] * 19)], [(0.1, 160), (1.1, 159)],
         [(0.5, 40), (1.5, 10), (3.02, 3)]),
        ([(0.5, ["x"] * 5), (2.0, ["y"] * 5)], [(0.1, 10)], []),
        ([(0.2, ["x"])], [(0.1, 1)], []),
    ]
    got = [chip_smoke.interval_series(b, c, q, 1.0) for b, c, q in cases]
    iv, off, bk, tail = got[0]
    assert iv == [100, 100, 100]
    assert tail["binds"] == 19 and abs(tail["width_s"] - 0.05) < 1e-9
    assert off == [160, 159, 0] and tail["offered"] == 0
    assert bk == [40, 10, 0] and tail["backlog"] == 3
    assert got[1][0] == [5, 0] and got[1][3]["binds"] == 5 \
        and got[1][3]["width_s"] == 0.0
    assert got[2][0] == [] and got[2][3]["binds"] == 1
    for (b, c, q), mine in zip(cases, got):
        assert mine == bench.interval_series(b, c, q, 1.0)


def test_churn_leg_binds_once_with_clean_audits():
    """A 64-node churn leg: faults far denser than the bench's (so that a
    2 s window applies kills and evictions) behind FaultyBindApi's
    failures and
    landed timeouts; no pod bound twice, the store's transitions and the
    cache agree, every pod bound, the anti-affinity held."""
    cfg = M.churn.ChurnConfig(seed=11, node_churn_per_min=6.0,
                              flap_per_min=3.0, cordon_per_min=3.0,
                              relabel_per_min=3.0, evict_per_min_abs=300.0,
                              bind_fail_rate=0.02, bind_timeout_rate=0.02)
    out = _run(profile="churn", churn_cfg=cfg)
    try:
        assert out["duplicate_binds"] == 0
        applied = out["churn_ops_applied"]
        assert {"kill", "evict"} <= set(applied), applied
        assert out["injected_bind_timeouts"] > 0
        assert out["injected_bind_failures"] > 0
        assert out["unbound"] == 0
        n = chip_smoke.audit_stream(M, out["api"], out["sched"], "churn",
                                    "churn")
        assert n == 600 + 64 - applied["evict"]
    finally:
        out["sched"].engine.close()


def test_rolling_update_keeps_its_bounds():
    cfg = dict(chip_smoke.P16C, replicas=24, max_surge=4,
               max_unavailable=4, bg_rate=40.0)
    out = chip_smoke.rolling_update(M, cfg, device="cpu")
    b = out["bounds"]
    assert b["surge_respected"] and b["unavailable_respected"], b
    assert b["max_total_seen"] <= 28 and b["min_available_seen"] >= 20
    assert b["created"] == b["evicted"] == 24
    assert out["replacements_bound"] == 24 and out["duplicate_binds"] == 0
    assert out["completion_s"] > 0


def test_traced_window_attribution_is_exact():
    out = _run(duration_s=1.0, recorder=True, podtrace=True)
    try:
        ex = out["podtrace"]["tail_exemplars"]
        assert ex and all(e["attribution_exact"] for e in ex), ex
        # the wave the exemplar rode is read from its dispatch event
        assert all(e["wave"] is not None for e in ex), ex
        assert out["recorder_events"] > 0
        assert not M.recorder.RECORDER.enabled
        assert not M.podtrace.TRACER.enabled
    finally:
        out["sched"].engine.close()
