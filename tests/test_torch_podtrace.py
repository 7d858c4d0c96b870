"""The reference's pod-level black box (tests/test_podtrace.py) on both
packages: the tracer an exact no-op when off, deterministic head
sampling, memory bounds under a 500k-pod offer, the exemplar reservoir
and window rotation, phases that telescope exactly on a real drain,
typed fence-requeue reasons, SLO burn rates, one trace context across
HTTP, the binary wire and the embedded API, the exactly-once audit under
a churn and fault storm, the Perfetto flow arrows and pod lanes, the
trend reader, and the telemetry registry's fold. Each body runs through
the `k` fixture with every Scheduler and extender backend of the port on
the CPU."""

from __future__ import annotations

import json
import threading

import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "api_types": "api.types",
    "engine_scheduler": "engine.scheduler",
    "models_hollow": "models.hollow",
    "pt": "observability.podtrace",
    "trend": "observability.trend",
    "observability_podtrace": "observability.podtrace",
    "observability_recorder": "observability.recorder",
    "observability_slo": "observability.slo",
    "server_apiserver_lite": "server.apiserver_lite",
    "utils_trace": "utils.trace",
    "server_asyncwire": "server.asyncwire",
    "server_embedded": "server.embedded",
    "server_extender": "server.extender",
    "serde": "api.serde",
    "client_binarywire": "client.binarywire",
    "testing_churn": "testing.churn",
    "perfetto": "observability.perfetto",
}
PKGS = {root: Pkg(root, MODULES) for root in (REF, PORT)}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


Gi = 1 << 30


@pytest.fixture
def tracer(k):
    """The process-wide tracer armed at sample=1 for one test and ALWAYS
    disarmed after — global state must never leak across tests."""
    k.TRACER.clear()
    old_sample, old_mask = k.TRACER.sample, k.TRACER._mask
    k.TRACER.sample, k.TRACER._mask = 1, 0
    k.TRACER.enable()
    try:
        yield k.TRACER
    finally:
        k.TRACER.disable()
        k.TRACER.sample, k.TRACER._mask = old_sample, old_mask
        k.TRACER.clear()


@pytest.fixture
def slo(k):
    k.SLO.clear()
    k.SLO.enable()
    try:
        yield k.SLO
    finally:
        k.SLO.disable()
        k.SLO.clear()


def mk_sched(k, nodes, pods, chunk=64):
    api = k.ApiServerLite()
    k.load_cluster(api, nodes, pods)
    s = k.Scheduler(api, record_events=False, **k.dev)
    s.pipeline_chunk = chunk
    s.start()
    return api, s


# ------------------------------------------------------------ off = no-op


def test_tracer_off_is_exact_noop(k):
    assert not k.TRACER.enabled
    before = k.TRACER.stats()
    api, s = mk_sched(k, k.hollow_nodes(16), k.PROFILES["density"](200))
    s.run_until_drained(max_batch=64)
    after = k.TRACER.stats()
    assert after["sampled_total"] == before["sampled_total"]
    assert after["completed_total"] == before["completed_total"]


# --------------------------------------------------------------- sampling


def test_head_sampling_deterministic_and_near_rate(k):
    t = k.PodTracer(sample=64, max_live=1 << 20, window_s=3600)
    keys = [f"ns/pod-{i:06d}" for i in range(40_000)]
    hits = [kk for kk in keys if t.sampled(kk)]
    # crc32 is uniform: 40k keys at 1-in-64 -> ~625 expected
    assert 380 <= len(hits) <= 900, len(hits)
    assert hits == [kk for kk in keys if t.sampled(kk)]  # deterministic
    t1 = k.PodTracer(sample=64, window_s=3600)
    assert [kk for kk in keys[:2000] if t1.sampled(kk)] == \
        [kk for kk in keys[:2000] if t.sampled(kk)]  # cross-instance too


def test_memory_bounds_under_500k_pod_offer(k):
    """The 500k-pod bound: live map capped at max_live with drops
    COUNTED, per-timeline events capped, exemplar heap capped at K —
    memory is O(max_live * max_events), never O(offer)."""
    t = k.PodTracer(sample=64, max_live=1024, exemplars=16,
                  window_s=3600.0, max_events=16)
    t.enable()
    n = 500_000
    chunk = 8192
    for lo in range(0, n, chunk):
        keys = [f"ns/p{i:07d}" for i in range(lo, min(lo + chunk, n))]
        t.begin_batch(keys)
        t.pop_batch(keys)
        # half the chunks complete, half stay live (the backlog shape)
        if (lo // chunk) % 2 == 0:
            t.bound_batch(keys)
    st = t.stats()
    assert st["live"] <= 1024
    assert len(t._heap) <= 16
    assert st["sampled_total"] + st["dropped_live"] >= n // 64 * 0.5
    assert st["dropped_live"] > 0  # the cap really engaged and counted
    # a fence-requeue loop cannot grow one timeline unboundedly
    t2 = k.PodTracer(sample=1, max_live=8, max_events=8, window_s=3600)
    t2.enable()
    t2.begin_batch(["ns/loop"])
    for _ in range(50):
        t2.event("ns/loop", k.pt.FENCE_REQUEUED, a=k.pt.REASON_CAPACITY)
    assert len(t2.timeline("ns/loop")) <= 8
    assert t2.stats()["dropped_events"] > 0


def test_exemplar_reservoir_keeps_slowest_k(k):
    clock = [0.0]
    t = k.PodTracer(sample=1, exemplars=4, window_s=3600,
                  now=lambda: clock[0])
    t.enable()
    for i, span in enumerate([5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 8.0, 4.0]):
        clock[0] = 100.0 * i
        t.begin_batch([f"ns/x{i}"])
        clock[0] = 100.0 * i + span
        t.bound_batch([f"ns/x{i}"])
    spans = [e["span_ms"] for e in t.snapshot()["exemplars"]]
    assert spans == [9000.0, 8000.0, 7000.0, 5000.0]  # slowest-K, desc


def test_window_rotation_and_abandonment(k):
    clock = [1000.0]
    t = k.PodTracer(sample=1, exemplars=4, window_s=10.0,
                  now=lambda: clock[0])
    t.enable()
    t.begin_batch(["ns/w1", "ns/stale"])
    clock[0] = 1001.0
    t.bound_batch(["ns/w1"])
    assert t.snapshot()["exemplars"]
    clock[0] = 1015.0  # next window
    t.begin_batch(["ns/w2"])
    clock[0] = 1016.0
    t.bound_batch(["ns/w2"])
    snap = t.snapshot()
    assert [e["key"] for e in snap["exemplars"]] == ["ns/w2"]
    assert [e["key"] for e in snap["prev_exemplars"]] == ["ns/w1"]
    # the never-completing live entry is abandoned once it predates the
    # previous window
    clock[0] = 1040.0
    snap = t.snapshot()
    assert t.stats()["abandoned"] == 1
    assert t.timeline("ns/stale") is None


def test_duplicate_bound_is_counted_and_eviction_clears_it(k):
    t = k.PodTracer(sample=1, window_s=3600)
    t.enable()
    t.begin_batch(["ns/dup"])
    t.bound_batch(["ns/dup"])
    t.bound_batch(["ns/dup"])  # second BOUND: a duplicate witness
    assert t.stats()["duplicate_bound"] == 1
    # a committed eviction clears the done-mark: the re-placement's
    # second BOUND is legitimate
    t.evicted_batch(["ns/dup"])
    t.begin_batch(["ns/dup"])
    t.bound_batch(["ns/dup"])
    assert t.stats()["duplicate_bound"] == 1  # unchanged


# ------------------------------------------------- phases + fence reasons


def test_phases_telescope_exactly_on_a_real_drain(k, tracer):
    api, s = mk_sched(k, k.hollow_nodes(32), k.PROFILES["density"](400),
                      chunk=128)
    tot = s.run_until_drained()
    assert tot["bound"] == 400
    snap = tracer.snapshot()
    assert snap["stats"]["completed_total"] == 400
    assert snap["exemplars"]
    for ex in snap["exemplars"]:
        assert abs(sum(ex["phases_ms"].values()) - ex["span_ms"]) < 1e-6
        kinds = [e["kind"] for e in ex["events"]]
        assert kinds[0] == "enqueued" and kinds[-1] == "bound"
        assert "wave_dispatched" in kinds and "harvested" in kinds
    # the window aggregate saw every completion
    agg = snap["phases"]
    assert sum(v["count"] for v in agg.values()) >= 400
    assert {"queue_wait", "dispatch", "device", "bind_flush"} <= set(agg)


def test_fence_requeue_typed_capacity_reason(k, tracer):
    """The blind capacity-conflict shape (test_pipeline_drain): every
    fence requeue in this scenario is a capacity race — the typed
    per-reason counters must partition the folded count exactly, and
    the requeued pods' timelines carry the reason code."""
    c0 = {n: k.COUNTERS.count("engine.fence_reason_" + n)
          for n in k.pt.REASON_NAMES}
    nodes = [k.make_node(f"n{i:03d}", cpu=2000, memory=8 * Gi, pods=110)
             for i in range(16)]  # each fits exactly 2 pods
    pods = [k.make_pod(f"p{i:03d}", cpu=1000, memory=256 << 20)
            for i in range(40)]
    api, s = mk_sched(k, nodes, pods, chunk=8)
    tot = s.run_until_drained()
    assert tot["bound"] == 32 and tot["fence_requeued"] > 0
    deltas = {n: k.COUNTERS.count("engine.fence_reason_" + n) - c0[n]
              for n in k.pt.REASON_NAMES}
    assert deltas["capacity"] == tot["fence_requeued"], deltas
    assert sum(deltas.values()) == tot["fence_requeued"], deltas
    # timelines of fenced pods carry the typed code — the losers of the
    # capacity race are often the pods that never bind, so look at BOTH
    # completed exemplars and still-live timelines
    codes = [e["a"] for ex in tracer.snapshot()["exemplars"]
             for e in ex["events"] if e["kind"] == "fence_requeued"]
    with tracer._lock:
        codes += [a for ev in tracer._live.values()
                  for kk, _t, a, _b in ev if kk == k.pt.FENCE_REQUEUED]
    assert codes and all(c == k.pt.REASON_CAPACITY for c in codes)


# -------------------------------------------------------------------- SLO


def test_slo_burn_rates_and_alert_flip_fake_clock(k):
    clock = [10_000.0]
    mon = k.SLOMonitor(budget_s=0.25, target=0.99, fast_window_s=10.0,
                     slow_window_s=40.0, bucket_s=1.0, alert_burn=5.0,
                     now=lambda: clock[0])
    mon.enable()
    k.RECORDER.clear()
    k.RECORDER.enable()
    try:
        # healthy stream: everything under budget, burn 0, no alert
        for i in range(10):
            clock[0] = 10_000.0 + i
            mon.observe_batch([0.05] * 100)
        s = mon.snapshot()
        assert s["burn_fast"] == 0.0 and s["alert"] == 0
        assert s["p99_ms"] <= 100.0
        # sustained breach: 50% of pods over budget -> burn 50/1 = 50x
        for i in range(10, 20):
            clock[0] = 10_000.0 + i
            mon.observe_batch([0.05] * 50 + [0.9] * 50)
        s = mon.snapshot()
        assert s["burn_fast"] > 5.0 and s["burn_slow"] >= 1.0
        assert s["alert"] == 1 and s["alerts_total"] == 1
        # the flip landed on the flight-recorder ring
        flips = [e for e in k.RECORDER.snapshot()
                 if e["kind"] == "slo_alert"]
        assert flips and flips[0]["a"] == 1
        # recovery: the breach ages out of the fast window
        for i in range(20, 35):
            clock[0] = 10_000.0 + i
            mon.observe_batch([0.05] * 100)
        s = mon.snapshot()
        assert s["alert"] == 0
        assert [e["a"] for e in k.RECORDER.snapshot()
                if e["kind"] == "slo_alert"] == [1, 0]
    finally:
        k.RECORDER.disable()
        k.RECORDER.clear()
        mon.disable()


def test_scheduler_feeds_slo_all_pods(k, slo):
    api, s = mk_sched(k, k.hollow_nodes(16), k.PROFILES["density"](150))
    s.run_until_drained(max_batch=64)
    snap = slo.snapshot()
    assert snap["slow_good"] + snap["slow_bad"] == 150
    assert "slo.budget_ms" in s.telemetry.snapshot()


# ------------------------------------------------- trace-context parity


def _parity_rig(k, n_nodes=24):

    b = k.TPUExtenderBackend(coalesce_window_s=0.0005, **k.dev)
    b.sync_nodes(k.hollow_nodes(n_nodes))
    b.filter(k.make_pod("warm", cpu=100, memory=256 << 20), None, None)
    svc = k.VerdictService(b)
    http_srv = k.ExtenderHTTPServer(b)
    http_srv.start()
    bin_srv = k.AsyncBinaryServer(svc)
    bin_srv.start()
    return b, svc, http_srv, bin_srv


def _http_post(port, path, payload, headers=None):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=15)
    try:
        body = json.dumps(payload).encode()
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _http_get(port, path):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=15)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def test_trace_context_transport_parity(k, tracer):
    """One trace context through each transport's filter->bind hop pair:
    the resulting timelines are IDENTICAL in shape (kinds + verb codes;
    only the transport code and timestamps differ), and the
    /debug/pods + /debug/slo views are byte-identical across HTTP,
    binary STATS, and the embedded debug_snapshot."""

    b, svc, http_srv, bin_srv = _parity_rig(k)
    try:
        pod = k.make_pod("traced", cpu=100, memory=256 << 20)
        pod_doc = k.serde.encode_pod(pod)
        # HTTP: header-carried context
        _http_post(http_srv.port, "/filter",
                   {"Pod": pod_doc, "Compact": True, "TopK": 4},
                   headers={"X-Pod-Trace": "trace/http"})
        resp = _http_post(http_srv.port, "/bind",
                          {"PodName": "traced", "PodNamespace": "default",
                           "PodUID": pod.uid, "Node": "hollow-node-0"},
                          headers={"X-Pod-Trace": "trace/http"})
        assert not resp.get("Error"), resp
        # binary wire: FLAG_TRACE + trace-id field
        c = k.BinaryWireClient("127.0.0.1", bin_srv.port).connect()
        c.filter_fused(pod, top_k=4, trace_ctx="trace/bin")
        assert c.bind("traced-b", "default", pod.uid, "hollow-node-1",
                      trace_ctx="trace/bin").ok
        c.close()
        # embedded: native trace_ctx
        svc.filter(pod, top_k=4, compact=True, trace_ctx="trace/emb")
        assert svc.bind("traced-e", "default", pod.uid, "hollow-node-2",
                        trace_ctx="trace/emb").ok

        # successful binds COMPLETE the wire-path timelines (no
        # scheduler bind path exists here to do it): read them back as
        # completed exemplars
        by_key = {ex["key"]: ex
                  for ex in tracer.snapshot()["exemplars"]}
        shapes = {}
        codes = {}
        for tid in ("trace/http", "trace/bin", "trace/emb"):
            assert tracer.timeline(tid) is None, \
                f"{tid} never completed — wire timelines must not pin " \
                "live slots"
            ex = by_key[tid]
            shapes[tid] = [(e["kind"], e["b"]) for e in ex["events"]]
            codes[tid] = {e["a"] for e in ex["events"]
                          if e["kind"] == "wire_hop"}
            assert abs(sum(ex["phases_ms"].values())
                       - ex["span_ms"]) < 1e-6
        # identical shape: CREATED, filter hop, bind hop, BOUND
        assert shapes["trace/http"] == shapes["trace/bin"] \
            == shapes["trace/emb"]
        assert shapes["trace/http"] == [
            ("created", 0), ("wire_hop", k.pt.HOP_FILTER),
            ("wire_hop", k.pt.HOP_BIND), ("bound", 0)]
        # the transport code is the ONLY difference
        assert codes["trace/http"] == {k.pt.WIRE_HTTP}
        assert codes["trace/bin"] == {k.pt.WIRE_BINARY}
        assert codes["trace/emb"] == {k.pt.WIRE_EMBEDDED}

        # debug views byte-identical across all three transports
        c = k.BinaryWireClient("127.0.0.1", bin_srv.port).connect()
        try:
            stats = c.stats(last=5)
            emb = svc.debug_snapshot(last=5)
            http_pods = _http_get(http_srv.port, "/debug/pods")
            http_slo = _http_get(http_srv.port, "/debug/slo")
            assert http_pods == stats["pods"] == emb["pods"]
            assert http_slo == stats["slo"] == emb["slo"]
            assert json.dumps(http_pods, sort_keys=True) \
                == json.dumps(emb["pods"], sort_keys=True)
        finally:
            c.close()
    finally:
        bin_srv.stop()
        http_srv.stop()


def test_embedded_schedule_one_traces_sampled_pods(k, tracer):

    api = k.EmbeddedVerdictAPI(stale_window_s=0.0, **k.dev)
    api.backend.sync_nodes(k.hollow_nodes(8))
    pod = k.make_pod("fleet-pod", cpu=100, memory=128 << 20)
    node, attempts = api.schedule_one(pod)
    assert node and attempts >= 1
    # the successful bind completed the timeline — it shows up as a
    # finished exemplar, not a live slot
    assert tracer.timeline(pod.key()) is None
    ex = {e["key"]: e for e in tracer.snapshot()["exemplars"]}[pod.key()]
    hops = [(e["a"], e["b"]) for e in ex["events"]
            if e["kind"] == "wire_hop"]
    assert (k.pt.WIRE_EMBEDDED, k.pt.HOP_FILTER) in hops
    assert (k.pt.WIRE_EMBEDDED, k.pt.HOP_BIND) in hops
    assert ex["events"][-1]["kind"] == "bound"


# ------------------------------------------- exactly-once under the storm


def test_exactly_once_trace_audit_under_churn_fault_storm(k, tracer):
    """Churn ops + injected bind failures AND landed-timeouts: the trace
    audit mirrors the store audit — no duplicate BOUND events, every
    completed timeline names a store-bound pod, and the only sampled
    bound pods WITHOUT a BOUND event are the landed-timeout ambiguities
    (bound at the store, never confirmed through the bind path)."""

    api = k.ApiServerLite()
    nodes = k.hollow_nodes(24)
    k.load_cluster(api, nodes, [])
    faulty = k.FaultyBindApi(api, fail_rate=0.05, timeout_rate=0.03, seed=11)
    sched = k.Scheduler(faulty, record_events=False, **k.dev)
    sched.start()
    loop = sched.stream(budget_s=5.0, min_quantum=64, max_quantum=256)
    inj = k.ChurnInjector(faulty, k.make_churn_schedule(
        [n.name for n in nodes],
        k.ChurnConfig(seed=5, node_churn_per_min=20.0, evict_per_min_abs=6),
        duration_s=1.5))
    for i in range(600):
        api.create("Pod", k.make_pod(f"storm-{i:04d}", cpu=100,
                                   memory=64 << 20))
        if i % 120 == 0:
            inj.apply_until(i / 400.0)
            loop.step()
    inj.apply_until(10.0)
    import time as _time
    deadline = _time.monotonic() + 90
    while _time.monotonic() < deadline:
        loop.step()
        if loop.settled():
            break
        sched.sync(wait=0.02)
    loop.close()
    assert faulty.injected_failures > 0 or faulty.injected_timeouts > 0

    st = tracer.stats()
    assert st["duplicate_bound"] == 0, st
    store_bound = {p.key() for p in api.list("Pod")[0] if p.node_name}
    # every completed timeline is a store-bound pod (no orphan BOUND)
    with tracer._lock:
        done = set(tracer._done)
    assert done <= store_bound, (done - store_bound)
    # sampled-but-never-completed bound pods are bounded by the injected
    # landed-timeout ambiguity (bound at the store, error on the wire)
    missing = len(store_bound) - st["completed_total"]
    assert 0 <= missing <= faulty.injected_timeouts + 8, \
        (missing, faulty.injected_timeouts)


# --------------------------------------------------------------- perfetto


def test_perfetto_flow_arrows_link_wave_stages(k):

    events = [
        {"kind": "dispatch", "wave": 3, "t": 1.0, "dur": 0.002,
         "a": 64, "b": 0},
        {"kind": "harvest", "wave": 3, "t": 1.010, "dur": 0.001,
         "a": 60, "b": 4},
        {"kind": "bind_flush", "wave": 3, "t": 1.012, "dur": 0.003,
         "a": 60, "b": 0},
        {"kind": "dispatch", "wave": 4, "t": 1.005, "dur": 0.002,
         "a": 64, "b": 0},
    ]
    trace = k.perfetto.build_chrome_trace(events)
    flows = [e for e in trace["traceEvents"] if e.get("cat") == "wave"]
    w3 = [e for e in flows if e["id"] == 3]
    assert [e["ph"] for e in w3] == ["s", "t", "f"]
    assert w3[-1]["bp"] == "e"
    assert not [e for e in flows if e["id"] == 4]  # lone stage: no arrow
    # span args carry span_ms on every lane
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert all("span_ms" in e["args"] for e in spans)


def test_perfetto_pod_lanes_render_exemplars(k, tracer):

    api, s = mk_sched(k, k.hollow_nodes(16), k.PROFILES["density"](120))
    s.run_until_drained(max_batch=64)
    exemplars = tracer.snapshot()["exemplars"]
    trace = k.perfetto.build_chrome_trace([])
    k.perfetto.add_pod_lanes(trace, exemplars)
    lanes = [e for e in trace["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "thread_name"
             and e["args"]["name"].startswith("pod ")]
    assert len(lanes) == len(exemplars)
    pod_spans = [e for e in trace["traceEvents"]
                 if e.get("ph") == "X"
                 and e["tid"] >= k.perfetto.TID_POD_BASE]
    assert pod_spans
    names = {e["name"] for e in pod_spans}
    assert names <= set(k.pt.PHASE_NAMES), names
    assert {"queue_wait", "device"} <= names


# ------------------------------------------------------------------ trend


def _write_round(tmp_path, r, **metrics):
    doc = {"n": 1, "cmd": "python bench.py", "rc": 0, "parsed": metrics}
    (tmp_path / f"BENCH_r{r:02d}.json").write_text(json.dumps(doc))


def test_trend_flags_seeded_regression_nonzero_exit(k, tmp_path, capsys):
    _write_round(tmp_path, 1, value=30000.0,
                 arrival_sustained_pods_s=20000.0,
                 arrival_p99_create_to_bound_ms=120.0)
    _write_round(tmp_path, 2, value=29000.0,
                 arrival_sustained_pods_s=9000.0,   # -55%: regression
                 arrival_p99_create_to_bound_ms=125.0)
    rc = k.trend.main(["--root", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "arrival_sustained_pods_s" in out and "REGRESSIONS" in out


def test_trend_quiet_inside_noise_band(k, tmp_path, capsys):
    _write_round(tmp_path, 1, value=30000.0,
                 arrival_p99_create_to_bound_ms=120.0)
    _write_round(tmp_path, 2, value=24000.0,   # -20%: inside the band
                 arrival_p99_create_to_bound_ms=140.0)
    assert k.trend.main(["--root", str(tmp_path)]) == 0
    assert "no regressions" in capsys.readouterr().out
    # latency direction: an INCREASE past the band flags
    _write_round(tmp_path, 3, value=30000.0,
                 arrival_p99_create_to_bound_ms=250.0)
    assert k.trend.main(["--root", str(tmp_path)]) == 1


def test_trend_skips_missing_metrics_and_gaps(k, tmp_path):
    _write_round(tmp_path, 1, value=30000.0,
                 multi_frontend_pods_s=600.0)
    _write_round(tmp_path, 2, value=29000.0)  # fleet metric absent
    _write_round(tmp_path, 4, value=28000.0,  # gap + nearest-prev rule
                 multi_frontend_pods_s=550.0)
    assert k.trend.find_regressions(k.trend.load_rounds(str(tmp_path))) == []
    _write_round(tmp_path, 5, value=27000.0,
                 multi_frontend_pods_s=300.0)  # vs r04 550: -45%
    regs = k.trend.find_regressions(k.trend.load_rounds(str(tmp_path)))
    assert [g["metric"] for g in regs] == ["multi_frontend_pods_s"]
    assert regs[0]["vs_round"] == 4


# -------------------------------------------------------- registry fold


def test_registry_folds_podtrace_and_slo(k, tracer, slo):
    api, s = mk_sched(k, k.hollow_nodes(8), k.PROFILES["density"](40))
    s.run_until_drained(max_batch=32)
    snap = s.telemetry.snapshot()
    assert snap["podtrace.completed_total"] == 40
    assert snap["podtrace.duplicate_bound"] == 0
    assert any(kk.startswith("podtrace.phase.") for kk in snap)
    assert snap["slo.slow_good"] + snap["slo.slow_bad"] == 40
    text = s.telemetry.render_prometheus()
    assert "tpu_podtrace_completed_total" in text
    assert "tpu_slo_burn_fast" in text
