"""The wave encoding's affinity spans and the wave path's gate and loop
counters, as the scheduler records them in a pipelined drain on the CPU:
pipeline.aff_build (with pipeline.aff_node_views inside it) under
pipeline.encode, once per AffinityData build; engine.wave_gate_rows, the
dispatched rows the one-pod-per-node gate holds; engine.inner_waves, the
wave loop's own iteration count (packed[3P+1]) summed at every harvest.
A mix without inter-pod terms records none of the first two."""

from __future__ import annotations

import pytest

from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.engine.scheduler import Scheduler
from kubernetes_tpu_torch.models.hollow import hollow_nodes
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite
from kubernetes_tpu_torch.utils.trace import COUNTERS, clock

HOST = "kubernetes.io/hostname"


def _pods(n, anti_share):
    """n pods: every `anti_share`-th one of no term, the rest green pods
    each requiring hostname anti-affinity with green (scheduler_perf's
    pod-with-pod-anti-affinity template); anti_share 0: no terms at all."""
    out = []
    for i in range(n):
        if anti_share and i % anti_share:
            aff = tt.Affinity(pod_anti_affinity=tt.PodAffinity(
                required_terms=[tt.PodAffinityTerm(
                    label_selector=tt.LabelSelector(
                        match_labels={"color": "green"}),
                    namespaces=[], topology_key=HOST)]))
            out.append(tt.make_pod(f"g-{i}", namespace="bench", cpu=100,
                                   memory=1 << 28,
                                   labels={"color": "green"}, affinity=aff))
        else:
            out.append(tt.make_pod(f"p-{i}", namespace="bench", cpu=100,
                                   memory=1 << 28))
    return out


def _drain(anti_share):
    """One pipelined drain of 96 pods on 64 nodes (chunks of 32), with
    the handles each dispatch returned and the counters around it."""
    api = ApiServerLite()
    for nd in hollow_nodes(64):
        api.create("Node", nd)
    s = Scheduler(api, record_events=False, device="cpu")
    s.start()
    for p in _pods(96, anti_share):
        api.create("Pod", p)
    handles = []
    eng = s.engine
    real = eng.dispatch_waves

    def dispatch(*a, **k):
        h = real(*a, **k)
        if h is not None:
            handles.append(h)
        return h

    eng.dispatch_waves = dispatch
    c0 = COUNTERS.snapshot()
    t0 = clock()
    try:
        s.sync()
        tot = s.run_until_drained(max_batch=32)
    finally:
        t1 = clock()
        c1 = COUNTERS.snapshot()
        vars(eng).pop("dispatch_waves", None)
        eng.close()

    def delta(name, i=0):
        return c1.get(name, (0, 0.0))[i] - c0.get(name, (0, 0.0))[i]
    return tot, handles, COUNTERS.spans(t0, t1), delta


@pytest.fixture(scope="module")
def anti():
    return _drain(3)


@pytest.fixture(scope="module")
def plain():
    return _drain(0)


def test_aff_build_nests_under_encode_once_per_build(anti):
    tot, _h, spans, delta = anti
    assert tot["bound"] > 0
    by = {s.seq: s for s in spans}
    builds = [s for s in spans if s.name == "pipeline.aff_build"]
    assert builds and len(builds) == delta("engine.wave_aff_build")
    assert delta("pipeline.aff_build") == len(builds)
    for b in builds:
        assert by[b.parent].name == "pipeline.encode"
        assert by[by[b.parent].parent].name == "pipeline.dispatch"
    views = [s for s in spans if s.name == "pipeline.aff_node_views"]
    assert len(views) == len(builds)
    for v in views:
        assert by[v.parent].name == "pipeline.aff_build"
        b = by[v.parent]
        assert b.t0 <= v.t0 <= v.t1 <= b.t1


def test_gate_rows_count_the_gated_rows_dispatched(anti):
    _tot, handles, _spans, delta = anti
    want = 0
    for h in handles:
        gated = h.enc.adata.wave_gate[h.pc].copy()
        gated[h.host_idx] = False
        want += int(gated.sum())
    assert want > 0
    assert delta("engine.wave_gate_rows") == want
    # two of every three pods are green: the share is below 100%
    assert want < delta("engine.wave_dispatch_pods")


def test_inner_waves_sum_the_wave_loops_own_count(anti, plain):
    for _tot, handles, _spans, delta in (anti, plain):
        assert handles
        # packed = [selected(P), fit_count(P), still_active(P), counter,
        # waves_used]: the last entry, read after each harvest
        want = sum(int(h.packed_h[-1]) for h in handles)
        assert want >= len(handles)
        assert delta("engine.inner_waves") == want


def test_no_terms_no_build_span_and_no_gate_rows(plain):
    tot, handles, spans, delta = plain
    assert tot["bound"] == 96 and handles
    assert not [s for s in spans if s.name in ("pipeline.aff_build",
                                               "pipeline.aff_node_views")]
    assert delta("pipeline.aff_build") == 0
    assert delta("engine.wave_gate_rows") == 0
    assert delta("engine.wave_forbid_cells") == 0
    assert delta("engine.wave_aff_build") == 0
