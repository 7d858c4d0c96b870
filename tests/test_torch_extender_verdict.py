"""The reference's verdict-surface contracts on both packages: the
extender's HTTP endpoints (tests/test_extender_http.py), its latency and
vocabulary isolation under churn at 5,000 nodes, the p99 ceiling
included (tests/test_extender_latency.py), the warm fast lane's memo and
device-resident cache (tests/test_extender_fastlane.py) and the embedded
verdict API (tests/test_embedded.py). Each body is the reference's, with
its imports through the `k` fixture and every port entry point on the
CPU; where two reference files share a top-level name, the later one's
carries a prefix of its file."""

from __future__ import annotations

import http.client
import json
import random
import threading
import time

import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "api_types": "api.types",
    "models_hollow": "models.hollow",
    "serde": "api.serde",
    "server_apiserver_lite": "server.apiserver_lite",
    "server_embedded": "server.embedded",
    "server_extender": "server.extender",
    "testing_churn": "testing.churn",
    "utils_trace": "utils.trace",
}
PKGS = {root: Pkg(root, MODULES) for root in (REF, PORT)}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"], scope="module")
def k(request):
    return PKGS[request.param]


# -------------------- tests/test_extender_http.py


class FakeBackend:
    """machine1/2/3-style predicate backend (extender_test.go FakeExtender)."""

    def __init__(self):
        self.bound = []
        self.synced_nodes = []
        self.synced_pods = []

    def filter(self, pod, nodes, node_names):
        cands = node_names if node_names is not None else [n.name for n in nodes]
        passed = [n for n in cands if not n.endswith("1")]
        failed = {n: "ends with 1" for n in cands if n.endswith("1")}
        return passed, failed

    def prioritize(self, pod, nodes, node_names):
        cands = node_names if node_names is not None else [n.name for n in nodes]
        return [(n, 10 if n.endswith("2") else 1) for n in cands]

    def bind(self, pod_name, pod_namespace, pod_uid, node):
        self.bound.append((pod_namespace, pod_name, node))
        return ""

    def sync_nodes(self, nodes):
        self.synced_nodes = nodes

    def sync_pods(self, pods):
        self.synced_pods = pods

    def metrics_text(self):
        return "# fake"


@pytest.fixture()
def server(k):
    backend = FakeBackend()
    srv = k.ExtenderHTTPServer(backend, prefix="/scheduler")
    srv.start()
    yield srv, backend
    srv.stop()


def post(port, path, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    body = json.dumps(obj)
    conn.request("POST", path, body, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _args_cache_capable(k):
    pod = k.make_pod("p1", cpu=100)
    return {"Pod": k.serde.encode_pod(pod),
            "NodeNames": ["machine1", "machine2", "machine3"]}


def test_filter_node_cache_capable(k, server):
    srv, _ = server
    status, out = post(srv.port, "/scheduler/filter", _args_cache_capable(k))
    assert status == 200
    assert out["NodeNames"] == ["machine2", "machine3"]
    assert out["FailedNodes"] == {"machine1": "ends with 1"}
    assert out["Error"] == ""


def test_filter_with_full_nodes(k):
    backend = FakeBackend()
    srv = k.ExtenderHTTPServer(backend)
    srv.start()
    try:
        nodes = [k.make_node("machine1"), k.make_node("machine2")]
        args = {"Pod": k.serde.encode_pod(k.make_pod("p", cpu=100)),
                "Nodes": {"Items": [k.serde.encode_node(n) for n in nodes]}}
        status, out = post(srv.port, "/filter", args)
        assert status == 200
        names = [n["metadata"]["name"] for n in out["Nodes"]["Items"]]
        assert names == ["machine2"]
    finally:
        srv.stop()


def test_prioritize(k, server):
    srv, _ = server
    status, out = post(srv.port, "/scheduler/prioritize", _args_cache_capable(k))
    assert status == 200
    assert out == [{"Host": "machine1", "Score": 1},
                   {"Host": "machine2", "Score": 10},
                   {"Host": "machine3", "Score": 1}]


def test_bind(k, server):
    srv, backend = server
    status, out = post(srv.port, "/scheduler/bind", {
        "PodName": "p1", "PodNamespace": "default", "PodUID": "u1",
        "Node": "machine2"})
    assert status == 200
    assert out == {"Error": ""}
    assert backend.bound == [("default", "p1", "machine2")]


def test_lowercase_keys_accepted(k, server):
    # v1 wire mirror uses lowercase tags (api/v1/types.go) — accept both
    srv, _ = server
    pod = k.make_pod("p1", cpu=100)
    status, out = post(srv.port, "/scheduler/filter",
                       {"pod": k.serde.encode_pod(pod),
                        "nodenames": ["machine1", "machine2"]})
    assert status == 200
    assert out["NodeNames"] == ["machine2"]


def test_cache_sync_endpoints(k, server):
    srv, backend = server
    nodes = [k.serde.encode_node(k.make_node("n1")), k.serde.encode_node(k.make_node("n2"))]
    status, out = post(srv.port, "/scheduler/cache/nodes", {"items": nodes})
    assert status == 200 and out["synced"] == 2
    assert [n.name for n in backend.synced_nodes] == ["n1", "n2"]
    p = k.make_pod("bp", cpu=100)
    p.node_name = "n1"
    status, out = post(srv.port, "/scheduler/cache/pods",
                       {"items": [k.serde.encode_pod(p)]})
    assert status == 200 and out["synced"] == 1
    assert backend.synced_pods[0].node_name == "n1"


def test_healthz_and_metrics(k, server):
    srv, _ = server
    assert get(srv.port, "/healthz") == (200, b"ok")
    status, body = get(srv.port, "/metrics")
    assert status == 200 and b"fake" in body


def test_malformed_json_yields_in_band_error(k, server):
    srv, _ = server
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
    conn.request("POST", "/scheduler/filter", "{not json",
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    assert resp.status == 500
    assert "Error" in data


def test_tpu_backend_sync_pods_removes_deleted_pods(k):
    backend = k.TPUExtenderBackend(**k.dev)
    backend.sync_nodes([k.make_node("n1")])
    p = k.make_pod("gone", cpu=500)
    p.node_name = "n1"
    backend.sync_pods([p])
    assert backend.cache.node_infos()["n1"].requested.milli_cpu == 500
    # next full sync omits the pod -> its capacity is released
    backend.sync_pods([])
    assert backend.cache.node_infos()["n1"].requested.milli_cpu == 0
    assert backend._known_pods == {}


def test_tpu_backend_stale_node_labels_not_served_in_args_mode(k):
    # non-cache-capable: node state ships per request; a label change between
    # requests must be honored (regression: shared-snapshot generation diffing)
    backend = k.TPUExtenderBackend(**k.dev)
    pod = k.make_pod("p", cpu=100, node_selector={"zone": "b"})
    n = k.make_node("n2", labels={"zone": "b"})
    passed, _ = backend.filter(pod, [n], None)
    assert passed == ["n2"]
    n_changed = k.make_node("n2", labels={"zone": "c"})
    passed, failed = backend.filter(pod, [n_changed], None)
    assert passed == [] and "n2" in failed


# -------------------- tests/test_extender_latency.py


LAT_N_NODES = 5000
BUDGET_S = 5.0  # extender.go:36 default HTTP timeout
CI_P99_S = 2.5  # generous CPU-CI ceiling, still ~2x under budget


@pytest.fixture(scope="module")
def lat_backend(k):
    b = k.TPUExtenderBackend(**k.dev)
    nodes = k.hollow_nodes(LAT_N_NODES)
    for i, n in enumerate(nodes):  # zones so affinity domains exist
        n.labels["zone"] = f"z{i % 16}"
    b.sync_nodes(nodes)
    # warm: first call pays snapshot build + kernel compile
    b.filter(k.make_pod("warm", cpu=100), None, None)
    return b


def _churn_pod(k, i: int):
    """Fresh never-seen selector key+value every request (adversarial)."""
    req = k.SelectorRequirement(key=f"churn-key-{i}",
                              operator=k.SelectorOperator.IN,
                              values=[f"churn-val-{i}"])
    return k.make_pod(f"churn-{i}", cpu=100, affinity=k.Affinity(
        node_affinity=k.NodeAffinity(
            required_terms=[k.NodeSelectorTerm(match_expressions=[req])])))


def test_churn_requests_cannot_force_rebuilds(k, lat_backend):
    snap = lat_backend.engine.snapshot
    v0 = snap.version
    routes0 = lat_backend.eval_cache.oracle_routes
    lat = []
    for i in range(25):
        t0 = time.perf_counter()
        passed, failed = lat_backend.filter(_churn_pod(k, i), None, None)
        lat.append(time.perf_counter() - t0)
        assert passed == []  # no node carries the churned label
        assert len(failed) == LAT_N_NODES
    assert snap.version == v0, \
        "adversarial churn must not rebuild the shared snapshot"
    assert lat_backend.eval_cache.oracle_routes == routes0 + 25
    lat.sort()
    p99 = lat[int(len(lat) * 0.99)]
    assert p99 < CI_P99_S < BUDGET_S, f"churn p99 {p99:.3f}s"


def test_image_churn_cannot_force_rebuilds(k, lat_backend):
    """Container-image names intern into the snapshot too (ImageLocality);
    image churn must route like label churn, not rebuild per request."""
    snap = lat_backend.engine.snapshot
    v0 = snap.version
    routes0 = lat_backend.eval_cache.oracle_routes
    for i in range(10):
        p = k.make_pod(f"img-{i}", cpu=100)
        p.containers[0].image = f"registry.example/churn:{i}"
        passed, _ = lat_backend.filter(p, None, None)
        assert len(passed) == LAT_N_NODES  # image only affects scoring
    assert snap.version == v0
    assert lat_backend.eval_cache.oracle_routes == routes0 + 10


def test_steady_requests_hit_the_lru(k, lat_backend):
    builds0 = lat_backend.eval_cache.builds
    lat = []
    for i in range(25):
        t0 = time.perf_counter()
        passed, _ = lat_backend.filter(k.make_pod(f"steady-{i}", cpu=100),
                                   None, None)
        lat.append(time.perf_counter() - t0)
        assert len(passed) == LAT_N_NODES
    # same spec class + same snapshot version -> at most one tensorization
    assert lat_backend.eval_cache.builds <= builds0 + 1
    lat.sort()
    p99 = lat[int(len(lat) * 0.99)]
    assert p99 < CI_P99_S < BUDGET_S, f"steady p99 {p99:.3f}s"


def test_prioritize_scores_under_budget(k, lat_backend):
    t0 = time.perf_counter()
    scores = lat_backend.prioritize(k.make_pod("prio", cpu=100), None, None)
    dt = time.perf_counter() - t0
    assert len(scores) == LAT_N_NODES
    assert dt < BUDGET_S
    assert {s for _, s in scores} != {0}  # real integer scores, not a stub


def test_churned_pairs_intern_in_one_batch_at_next_sync(k, lat_backend):
    """The queued churn pairs land in ONE vocab rebuild at the next cache
    sync, after which an equivalent pod takes the device path."""
    snap = lat_backend.engine.snapshot
    assert lat_backend.eval_cache._pending_pairs  # queued by the churn test
    nodes = lat_backend.cache.node_infos()
    resync = [info.node for info in nodes.values() if info.node is not None]
    lat_backend.sync_nodes(resync)
    routes_before = lat_backend.eval_cache.oracle_routes
    passed, _ = lat_backend.filter(_churn_pod(k, 0), None, None)
    assert passed == []  # still fits nothing (no node has the label)
    # but it went through the device path this time, not the oracle
    assert lat_backend.eval_cache.oracle_routes == routes_before
    assert not lat_backend.eval_cache._pending_pairs


# -------------------- tests/test_extender_fastlane.py


FL_N_NODES = 200


@pytest.fixture()
def fl_backend(k):
    b = k.TPUExtenderBackend(**k.dev)
    nodes = k.hollow_nodes(FL_N_NODES)
    for i, n in enumerate(nodes):
        n.labels["zone"] = f"z{i % 4}"
    b.sync_nodes(nodes)
    b.filter(k.make_pod("warm", cpu=100), None, None)  # compile + first encode
    return b


def _fl_pod(k, name: str, cpu: int = 100):
    return k.make_pod(name, cpu=cpu, memory=256 << 20)


def test_second_filter_serves_from_result_memo(k, fl_backend):
    """Equivalent pod, unchanged cluster: the second /filter must not
    rebuild AffinityData, re-run the static precompute, or even dispatch
    the kernel — pure memo hit."""
    fl_backend.filter(_fl_pod(k, "a"), None, None)
    before = k.COUNTERS.snapshot()
    builds0 = fl_backend.eval_cache.builds
    passed, failed = fl_backend.filter(_fl_pod(k, "b"), None, None)
    assert len(passed) == FL_N_NODES and not failed
    assert fl_backend.eval_cache.builds == builds0
    assert k.COUNTERS.count("extender.affinity_data_build") == \
        before.get("extender.affinity_data_build", (0, 0))[0]
    assert k.COUNTERS.count("extender.fused_eval") == \
        before.get("extender.fused_eval", (0, 0))[0]
    assert k.COUNTERS.count("extender.result_hit") == \
        before.get("extender.result_hit", (0, 0))[0] + 1


def test_prioritize_rides_the_filter_evaluation(k, fl_backend):
    """The fused-verb contract: /prioritize for the pod /filter just
    evaluated reuses the (fits, scores) pair — zero device work."""
    pod = _fl_pod(k, "fused")
    fl_backend.filter(pod, None, None)
    evals0 = k.COUNTERS.count("extender.fused_eval")
    hits0 = fl_backend.eval_cache.result_hits
    scores = fl_backend.prioritize(pod, None, None)
    assert len(scores) == FL_N_NODES
    assert k.COUNTERS.count("extender.fused_eval") == evals0
    assert fl_backend.eval_cache.result_hits == hits0 + 1


def test_sync_nodes_invalidates_device_resident_cache(k, fl_backend):
    fl_backend.filter(_fl_pod(k, "pre-sync"), None, None)
    refresh0 = k.COUNTERS.count("extender.refresh_full")
    uploads0 = k.COUNTERS.count("engine.device_upload_arrays")
    builds0 = fl_backend.eval_cache.builds
    # re-sync with one node's allocatable changed: full refresh + fresh
    # evaluation (the memo and encodings keyed on the old version/sync gen
    # must not serve)
    nodes = [info.node for info in fl_backend.cache.node_infos().values()]
    nodes[0] = k.make_node(nodes[0].name, cpu=8000, memory=64 << 30, pods=110,
                         labels=dict(nodes[0].labels))
    fl_backend.sync_nodes(nodes)
    passed, _ = fl_backend.filter(_fl_pod(k, "post-sync"), None, None)
    assert len(passed) == FL_N_NODES
    assert k.COUNTERS.count("extender.refresh_full") == refresh0 + 1
    assert k.COUNTERS.count("engine.device_upload_arrays") > uploads0
    assert fl_backend.eval_cache.builds == builds0 + 1


def test_bind_invalidates_results_but_keeps_encoding(k, fl_backend):
    """A bind moves capacity: the (fits, scores) memo for the new snapshot
    version must MISS (one fused dispatch), but the pod-side encoding is
    capacity-independent and survives (vocab_gen keying) — and the refresh
    is the targeted one-row delta, not a full N-node generation walk."""
    fl_backend.filter(_fl_pod(k, "pre-bind"), None, None)
    builds0 = fl_backend.eval_cache.builds
    evals0 = k.COUNTERS.count("extender.fused_eval")
    full0 = k.COUNTERS.count("extender.refresh_full")
    hint0 = k.COUNTERS.count("extender.refresh_hint")
    version0 = fl_backend.engine.snapshot.version
    assert fl_backend.bind("bound-1", "default", "u1", "hollow-node-3") == ""
    scores = fl_backend.prioritize(_fl_pod(k, "post-bind"), None, None)
    assert len(scores) == FL_N_NODES
    assert fl_backend.engine.snapshot.version == version0 + 1
    assert k.COUNTERS.count("extender.fused_eval") == evals0 + 1  # re-eval
    assert fl_backend.eval_cache.builds == builds0                 # no re-encode
    assert k.COUNTERS.count("extender.refresh_full") == full0     # no full walk
    assert k.COUNTERS.count("extender.refresh_hint") == hint0 + 1
    # the committed pod really moved the node's row
    i = fl_backend.engine.snapshot.node_index["hollow-node-3"]
    assert fl_backend.engine.snapshot.pod_count[i] == 1


def test_warm_path_agrees_with_stateless_args_mode(k, fl_backend):
    """Same pod, same cluster: the cached fast lane and the per-request
    args-mode evaluation (fresh snapshot per call) must agree on both the
    verdicts and the integer scores."""
    pod = _fl_pod(k, "parity")
    warm_passed, _ = fl_backend.filter(pod, None, None)
    warm_scores = dict(fl_backend.prioritize(pod, None, None))
    nodes = [info.node for info in fl_backend.cache.node_infos().values()
             if info.node is not None]
    args_passed, _ = fl_backend.filter(pod, nodes, None)
    args_scores = dict(fl_backend.prioritize(pod, nodes, None))
    assert sorted(warm_passed) == sorted(args_passed)
    assert warm_scores == args_scores


def test_affinity_sync_demotes_the_aff_free_lane(k, fl_backend):
    """The /bind wire carries identifiers only, so affinity knowledge
    arrives with the BULK SYNC: once a synced bound pod carries
    pod-affinity, cluster_aff_free flips and later evaluations rebuild
    AffinityData against the live pair set (the symmetry check now has
    something to check)."""
    assert fl_backend.eval_cache.cluster_aff_free
    aff = k.Affinity(pod_affinity=k.PodAffinity(required_terms=[
        k.PodAffinityTerm(label_selector=k.LabelSelector(
            match_labels={"app": "guard"}), topology_key="zone")]))
    guard = k.make_pod("guard", cpu=100, labels={"app": "guard"}, affinity=aff)
    guard.node_name = "hollow-node-0"
    fl_backend.sync_pods([guard])
    assert not fl_backend.eval_cache.cluster_aff_free
    # plain pods now take the affinity-aware path (symmetry vs the guard)
    builds0 = fl_backend.eval_cache.builds
    passed, _ = fl_backend.filter(_fl_pod(k, "plain-after-aff"), None, None)
    assert len(passed) == FL_N_NODES  # guard's affinity forbids nothing here
    assert fl_backend.eval_cache.builds == builds0 + 1
    # and a later sync that removes the guard restores the fast lane
    fl_backend.sync_pods([])
    assert fl_backend.eval_cache.cluster_aff_free


def test_compat_scheduleone_loop_commits_capacity(k, fl_backend):
    """A scheduleOne-shaped stream (filter -> prioritize -> bind) against
    the warm lane: every bind is visible to the next evaluation, and the
    full-refresh count stays flat (per-bind refreshes ride the hint)."""
    full0 = k.COUNTERS.count("extender.refresh_full")
    chosen = []
    for i in range(8):
        pod = _fl_pod(k, f"so-{i}")
        passed, _ = fl_backend.filter(pod, None, None)
        scores = fl_backend.prioritize(pod, None, None)
        host = max(scores, key=lambda e: e[1])[0]
        assert fl_backend.bind(pod.name, pod.namespace, pod.uid, host) == ""
        chosen.append(host)
    snap = fl_backend.engine.snapshot
    for host in set(chosen):
        assert snap.pod_count[snap.node_index[host]] >= 1
    assert k.COUNTERS.count("extender.refresh_full") == full0


# -------------------- tests/test_embedded.py


EMB_N_NODES = 96


def _emb_pod(k, name: str, cpu: int = 100):
    return k.make_pod(name, cpu=cpu, memory=256 << 20)


def _embedded(k, binder=None, **kw) -> k.EmbeddedVerdictAPI:
    api = k.EmbeddedVerdictAPI(binder=binder, **kw, **k.dev)
    nodes = k.hollow_nodes(EMB_N_NODES)
    api.sync_nodes(nodes)
    api.filter(_emb_pod(k, "warm"))
    return api


def test_filter_verdict_contract_and_compact_elision(k):
    api = _embedded(k)
    v = api.filter(_emb_pod(k, "fv"), top_k=8, compact=True)
    assert isinstance(v, k.FilterVerdict)
    assert v.all_passed and v.passed_count == EMB_N_NODES
    assert v.passed is None  # compact + all passed: elided
    assert len(v.top_scores) == 8 and v.snapshot_gen is not None
    # non-compact keeps the echo; top_k=0 keeps /prioritize separate
    v = api.filter(_emb_pod(k, "fv2"))
    assert v.passed is not None and len(v.passed) == EMB_N_NODES
    assert v.top_scores is None
    # restricted candidate set: never elided, split honors the names
    v = api.filter(_emb_pod(k, "fv3"), node_names=[v.passed[0], "no-such-node"],
                   top_k=4, compact=True)
    assert v.passed_count == 1 and len(v.failed) == 1
    assert [h for h, _s in v.top_scores] == v.passed


def test_bind_result_typed_fence_conflict(k):
    api = k.EmbeddedVerdictAPI(stale_window_s=0.0, **k.dev)
    api.sync_nodes([k.make_node(f"tiny-{i}", cpu=1000, memory=4 << 30,
                              pods=110) for i in range(2)])
    spec = k.make_pod("a", cpu=900, memory=256 << 20)
    v = api.filter(spec, top_k=4)
    res = api.bind("a", "default", "u-a", "tiny-0",
                   snapshot_gen=v.snapshot_gen, idem_key="a:1", pod=spec)
    assert isinstance(res, k.BindResult) and res.ok
    spec_b = k.make_pod("b", cpu=900, memory=256 << 20)
    res = api.bind("b", "default", "u-b", "tiny-0",
                   snapshot_gen=v.snapshot_gen, idem_key="b:1", pod=spec_b)
    assert res.retryable and res.kind == "conflict"
    assert res.error.startswith("CONFLICT") and res.retry_after_s > 0
    # TopScores after the fix: a non-fitting node must NOT appear even
    # when fewer than k nodes fit (the int32 sentinel-wrap regression)
    v2 = api.filter(spec_b, top_k=4)
    assert [h for h, _s in v2.top_scores] == ["tiny-1"]


def test_schedule_one_embedded_frontends_store_audited(k):
    """N embedded frontend threads drive schedule_one concurrently under
    injected bind faults: every pod lands on exactly one node at the
    store, evaluations coalesce, capacity accrues."""
    store = k.ApiServerLite(max_log=100_000)
    nodes = k.hollow_nodes(EMB_N_NODES)
    for n in nodes:
        store.create("Node", n)
    faulty = k.FaultyBindApi(store, fail_rate=0.1, timeout_rate=0.1, seed=5)
    api = k.EmbeddedVerdictAPI(binder=k.extender_store_binder(faulty),
                             coalesce_window_s=0.001, **k.dev)
    api.sync_nodes(nodes)
    api.filter(_emb_pod(k, "warm"))
    n_clients, per = 6, 8
    for c in range(n_clients):
        for i in range(per):
            store.create("Pod", _emb_pod(k, f"emb-{c}-{i}"))
    errors, lock = [], threading.Lock()
    start = threading.Barrier(n_clients)

    def drive(c):
        rng = random.Random(9000 + c)
        try:
            start.wait(timeout=20)
            for i in range(per):
                api.schedule_one(_emb_pod(k, f"emb-{c}-{i}"), top_k=16, rng=rng)
        except Exception as e:  # noqa: BLE001 — surfaced below
            with lock:
                errors.append(f"{c}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=drive, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    pods, _rv = store.list("Pod")
    bound = [p for p in pods if p.name.startswith("emb-") and p.node_name]
    assert len(bound) == n_clients * per
    # store-truth exactly-once: one bound node per pod, ever
    first = {}
    for e in store._log:
        if e.kind == "Pod" and e.type == "MODIFIED" and e.obj.node_name \
                and e.obj.name.startswith("emb-"):
            prev = first.setdefault(e.obj.name, e.obj.node_name)
            assert prev == e.obj.node_name, e.obj.name
    # embedding kept the coalescer in the loop (not one eval per call)
    with api.backend._counters_lock:
        snap = dict(api.backend._counters)
    assert snap.get("coalesce_requests", 0) >= n_clients * per
    assert faulty.injected_failures + faulty.injected_timeouts > 0
    # capacity accrued in the embedded cache — allowing the landed-
    # timeout ambiguity its contract: a bind that landed at the store
    # but errored back may stay cache-unknown until the next bulk sync
    # delivers the spec (the store, not the cache, is truth)
    infos = api.backend.cache.node_infos()
    accrued = sum(len(i.pods) for i in infos.values())
    assert 0 < accrued <= n_clients * per
    assert accrued >= n_clients * per - faulty.injected_timeouts \
        - faulty.injected_failures


def test_service_core_is_shared_with_http_transport(k):
    """The HTTP extender serves THROUGH the same VerdictService class the
    embedding exposes — the refactor's point: no transport owns a
    semantic."""
    b = k.TPUExtenderBackend(**k.dev)
    b.sync_nodes(k.hollow_nodes(4))
    srv = k.ExtenderHTTPServer(b)
    assert isinstance(srv.service, k.VerdictService)
    assert srv.service.backend is b
    out = srv.handle_filter({"Pod": {"metadata": {"name": "x"},
                                     "spec": {"containers": []}},
                             "Compact": True, "TopK": 2})
    assert out["AllPassed"] and out["PassedCount"] == 4
    assert len(out["TopScores"]) == 2
