"""The arithmetic of the end-to-end metrics, of the trace, and of the
reference's mean score regret."""

import numpy as np
import pytest

from benchmark.lib import stats
from benchmark.lib.devtrace import Spans


def test_rate_is_all_binds_over_all_timed_time():
    # a stalled episode moves the rate; a median of chunks would not
    assert stats.rate(90_000, [2.0, 2.0, 2.0]) == 15_000
    assert stats.rate(90_000, [2.0, 2.0, 8.0]) == 7_500
    with pytest.raises(ValueError):
        stats.rate(10, [])


def test_idle_share_of_a_synthetic_interval_set():
    iv = [(0.0, 1.0), (0.5, 2.0), (4.0, 5.0), (9.5, 12.0)]
    assert stats.busy(iv, 0.0, 10.0) == pytest.approx(3.5)
    assert stats.gaps(iv, 0.0, 10.0) == [(2.0, 4.0), (5.0, 9.5)]
    assert 1.0 - stats.busy(iv, 0.0, 10.0) / 10.0 == pytest.approx(0.65)


def test_gaps_labelled_by_the_innermost_host_interval():
    s = Spans()
    s.span("loop.step", 0.0, 10.0)
    s.span("engine.dispatch_waves", 1.0, 2.0)
    assert s.labels_at([1.5, 5.0, 11.0]) == [
        "engine.dispatch_waves", "loop.step", "harness"]


def _regret_by_replay(cluster, ps, out):
    """score_regret the slow way: replay the binds one by one, scoring
    every node for each pod."""
    from benchmark.reference.scores import nonzero, score
    tpl = ps.templates
    rc = np.array([t.cpu for t in tpl])
    rm = np.array([t.mem for t in tpl])
    zc, zm = nonzero(rc, rm)
    n = len(cluster)
    cpu, mem, nzc, nzm, cnt = (np.zeros(n, dtype=np.int64) for _ in range(5))
    total = 0
    idx = np.nonzero(out.node_of >= 0)[0]
    for i in idx[np.argsort(out.bind_rv[idx], kind="stable")]:
        u, nd = ps.tmpl[i], out.node_of[i]
        fit = ((cpu + rc[u] <= cluster.cpu) & (mem + rm[u] <= cluster.mem)
               & (cnt + 1 <= cluster.pods))
        s = np.where(fit, score(nzc + zc[u], nzm + zm[u], cluster.cpu,
                                cluster.mem), -1)
        total += int(s.max() - s[nd])
        cpu[nd] += rc[u]
        mem[nd] += rm[u]
        nzc[nd] += zc[u]
        nzm[nd] += zm[u]
        cnt[nd] += 1
    return total, idx.size


@pytest.mark.parametrize("placement", ["best", "first_fit", "shuffled"])
def test_score_regret_equals_a_replay(placement):
    """The vectorised regret equals a bind-by-bind replay, on a mix of
    three request shapes (scores that need not fall as a node fills)."""
    from dataclasses import replace
    from benchmark.gen.cluster import make_cluster
    from benchmark.gen.pods import make_pods
    from benchmark.reference.check import score_regret
    from benchmark.reference.placer import place
    conf = {"cluster": {"nodes": 25, "zones": ["a"], "name_prefix": "n",
                        "node_template": {"cpu_milli": 4000, "pods": 110,
                                          "memory_bytes": 32 << 30}},
            "pods": {"generator": "shares", "namespace": "t", "templates": [
                {"share": 0.5, "cpu_milli": 100, "memory_bytes": 500 << 20},
                {"share": 0.3, "cpu_milli": 700, "memory_bytes": 1 << 30},
                {"share": 0.2, "cpu_milli": 0, "memory_bytes": 6 << 30}]}}
    cluster = make_cluster(conf, 4)
    ps = make_pods(conf, 400, 4, 1, "p-")
    out = place(cluster, ps, "" if placement == "best" else "first_fit")
    if placement == "shuffled":       # the same binds in another order
        rv = out.bind_rv.copy()
        b = rv >= 0
        rv[b] = np.random.default_rng(0).permutation(rv[b])
        out = replace(out, bind_rv=rv)
    got = score_regret(cluster, ps, out)
    assert got == _regret_by_replay(cluster, ps, out)
    if placement == "best":
        assert got[0] == 0
    else:
        assert got[0] > got[1]
