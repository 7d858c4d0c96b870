"""The port's scheduler-extender service (ExtenderHTTPServer over
TPUExtenderBackend) on the CPU: side by side with the reference package's
over real HTTP — the same serde-encoded cache syncs and the same request
sequence must give byte-equal response bodies — and the backend's own
contracts (warm-lane memo and encodings, vocab isolation, coalescing,
typed 409 fence conflicts, exactly-once replay under injected bind faults,
shedding, deadlines, the lock checker) as the reference's extender tests
pin them, at 64-256 nodes."""

from __future__ import annotations

import http.client
import json
import random
import threading
import time

import numpy as np
import pytest

import kubernetes_tpu.api.serde as jserde
import kubernetes_tpu.api.types as jt
import kubernetes_tpu.models.hollow as jh
import kubernetes_tpu.server.extender as jext
import kubernetes_tpu_torch.api.serde as tserde
import kubernetes_tpu_torch.api.types as tt
import kubernetes_tpu_torch.models.hollow as th
import kubernetes_tpu_torch.server.extender as text
from kubernetes_tpu_torch.analysis import lockcheck
from kubernetes_tpu_torch.api import protowire
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite
from kubernetes_tpu_torch.server.coalescer import DeadlineExceeded, Overloaded
from kubernetes_tpu_torch.testing.churn import (
    FaultyBindApi,
    extender_store_binder,
)
from kubernetes_tpu_torch.utils.trace import COUNTERS

REF = (jt, jh, jserde, jext)
PORT = (tt, th, tserde, text)
N_NODES = 96
ZONE = "failure-domain.beta.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def _pod(name: str, cpu: int = 100):
    return tt.make_pod(name, cpu=cpu, memory=256 << 20)


def _cpu_backend(**kw) -> text.TPUExtenderBackend:
    return text.TPUExtenderBackend(device="cpu", **kw)


def _backend(n_nodes: int = N_NODES, **kw) -> text.TPUExtenderBackend:
    b = _cpu_backend(**kw)
    nodes = th.hollow_nodes(n_nodes)
    for i, n in enumerate(nodes):
        n.labels["zone"] = f"z{i % 4}"
    b.sync_nodes(nodes)
    b.filter(_pod("warm"), None, None)  # first encode
    return b


# ------------------------------------------------ side by side over HTTP


def _oracle_probes(t):
    """Pods whose features outgrow the device encoding (more host ports
    than it holds, too many ORed selector terms or preferred terms, too
    many anti-affinity terms) or would grow a snapshot vocab."""
    zones = ["zone-a", "zone-b", "zone-c"]

    def term(v):
        return t.NodeSelectorTerm([t.SelectorRequirement(
            ZONE, t.SelectorOperator.IN, [v])])
    anti = [t.PodAffinityTerm(t.LabelSelector(match_labels={"app": f"web-{i}"}),
                              [], HOST) for i in range(5)]
    return [
        t.make_pod("o-ports", namespace="bench", cpu=100, memory=256 << 20,
                   ports=list(range(7000, 7009))),
        t.make_pod("o-terms", namespace="bench", cpu=100, affinity=t.Affinity(
            node_affinity=t.NodeAffinity(
                required_terms=[term(zones[i % 3]) for i in range(5)]))),
        t.make_pod("o-pref", namespace="bench", cpu=100, affinity=t.Affinity(
            node_affinity=t.NodeAffinity(preferred_terms=[
                (i + 1, term(zones[i % 3])) for i in range(9)]))),
        t.make_pod("o-anti", namespace="bench", cpu=100, labels={"app": "x"},
                   affinity=t.Affinity(pod_anti_affinity=t.PodAffinity(
                       required_terms=anti))),
        t.make_pod("o-vocab", namespace="bench", cpu=100,
                   node_selector={"disk": "ssd"}),
    ]


def _cluster(mods):
    t, h, serde, _ext = mods
    nodes = h.hollow_nodes(N_NODES)
    for i, n in enumerate(nodes):
        n.labels["zone"] = f"z{i % 4}"
    bound = h.mixed_affinity_pods(300, seed=11)
    for i, p in enumerate(bound):
        p.node_name = nodes[(5 * i) % N_NODES].name
    probes = (h.mixed_affinity_pods(40, seed=12)[::5]
              + h.affinity_pods(3, seed=13)
              + [t.make_pod(f"plain-{i}", namespace="bench", cpu=100 * (i + 1),
                            memory=256 << 20) for i in range(3)]
              + _oracle_probes(t))
    return ({"items": [serde.encode_node(n) for n in nodes]},
            {"items": [serde.encode_pod(p) for p in bound]},
            [serde.encode_pod(p) for p in probes],
            [serde.encode_node(n) for n in nodes[:6]])


class _Wire:
    """One keep-alive client connection; every call returns the status
    and the raw response body."""

    def __init__(self, port):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)

    def post(self, path, body):
        raw = body if isinstance(body, (bytes, str)) \
            else json.dumps(body, separators=(",", ":"))
        self.conn.request("POST", "/scheduler" + path, raw,
                          {"Content-Type": "application/json"})
        resp = self.conn.getresponse()
        return resp.status, resp.read()

    def get(self, path):
        self.conn.request("GET", path)
        resp = self.conn.getresponse()
        return resp.status, resp.read()

    def close(self):
        self.conn.close()


def _sequence(wire, nodes_body, pods_body, probes, args_nodes):
    """The request sequence both servers answer: syncs, then for every
    probe /filter and /prioritize over the whole cluster and over a
    candidate list, the Compact/TopK forms, args mode with full Nodes,
    binds (legacy and fenced), lowercase keys, malformed JSON and an
    unknown path on the same keep-alive connection."""
    out = [wire.post("/cache/nodes", nodes_body),
           wire.post("/cache/pods", pods_body)]
    cands = [f"hollow-node-{i}" for i in range(0, N_NODES, 3)] + ["missing"]
    for enc in probes:
        out.append(wire.post("/filter", {"Pod": enc, "NodeNames": None,
                                         "Nodes": None}))
        out.append(wire.post("/prioritize", {"Pod": enc, "NodeNames": None,
                                             "Nodes": None}))
        out.append(wire.post("/filter", {"Pod": enc, "NodeNames": cands}))
        out.append(wire.post("/prioritize", {"Pod": enc, "NodeNames": cands}))
        out.append(wire.post("/filter", {"Pod": enc, "NodeNames": None,
                                         "Compact": True, "TopK": 5}))
        out.append(wire.post("/prioritize", {"Pod": enc, "NodeNames": None,
                                             "TopK": 4}))
    for enc in probes[:3] + probes[-5:-3]:
        items = {"Items": args_nodes}
        out.append(wire.post("/filter", {"Pod": enc, "Nodes": items}))
        out.append(wire.post("/prioritize", {"Pod": enc, "Nodes": items}))
    # binds: legacy identifiers only, then fenced with a generation and
    # an idempotency key (and its replay), then a stale-generation bind
    status, body = wire.post("/filter", {"Pod": probes[0], "NodeNames": None,
                                         "Compact": True, "TopK": 3})
    out.append((status, body))
    verdict = json.loads(body)
    gen = verdict["SnapshotGen"]
    host = verdict["TopScores"][0]["Host"]
    out.append(wire.post("/bind", {"PodName": "b-legacy",
                                   "PodNamespace": "bench", "PodUID": "u0",
                                   "Node": "hollow-node-1"}))
    fenced = {"PodName": "b-fenced", "PodNamespace": "bench",
              "PodUID": "u1", "Node": host, "SnapshotGen": gen,
              "IdempotencyKey": "b-fenced:0", "Pod": probes[0]}
    out.append(wire.post("/bind", fenced))
    out.append(wire.post("/bind", fenced))
    out.append(wire.post("/bind", {**fenced, "PodName": "b-stale",
                                   "PodUID": "u2",
                                   "IdempotencyKey": "b-stale:0"}))
    for enc in probes[:4]:
        out.append(wire.post("/filter", {"Pod": enc, "NodeNames": None}))
        out.append(wire.post("/prioritize", {"Pod": enc, "NodeNames": None}))
    out.append(wire.post("/filter", {"pod": probes[1],
                                     "nodenames": cands[:5]}))
    out.append(wire.post("/prioritize", {"pod": probes[1],
                                         "nodeNames": cands[:5]}))
    out.append(wire.post("/filter", "{not json"))
    out.append(wire.post("/nope", {"junk": "x" * 4096}))
    out.append(wire.get("/healthz"))
    return out


@pytest.fixture(scope="module")
def served():
    """Both servers answer the sequence; (reference, port) response
    lists, each (status, raw body)."""
    got = []
    for mods, kw in ((REF, {}), (PORT, {"device": "cpu"})):
        backend = mods[3].TPUExtenderBackend(**kw)
        srv = mods[3].ExtenderHTTPServer(backend, prefix="/scheduler")
        srv.start()
        wire = _Wire(srv.port)
        try:
            got.append(_sequence(wire, *_cluster(mods)))
        finally:
            wire.close()
            srv.stop()
    return got


def test_http_sequence_bodies_equal_the_reference(served):
    ref, port = served
    assert len(ref) == len(port)
    for i, (r, p) in enumerate(zip(ref, port)):
        assert p == r, f"response {i}: {p[:200]} != {r[:200]}"


def test_http_sequence_covers_the_wire_contracts(served):
    ref, port = served
    codes = [s for s, _b in port]
    assert codes.count(500) == 1 and codes.count(404) == 1
    assert codes[-1] == 200 and port[-1][1] == b"ok"
    bodies = [json.loads(b) for s, b in port[:-1] if s in (200, 409)]
    assert any(isinstance(b, dict) and b.get("AllPassed") for b in bodies) \
        or any(isinstance(b, dict) and "TopScores" in b for b in bodies)
    # fits vary across probes, and the oracle probes fit nothing or less
    passed = [len(b["NodeNames"]) for b in bodies
              if isinstance(b, dict) and isinstance(b.get("NodeNames"), list)
              and "FailedNodes" in b]
    assert len(set(passed)) > 2
    assert port[1] == ref[1] and json.loads(port[1][1]) == {"synced": 300}


def test_protobuf_cache_sync_matches_json():
    """The binary cache sync decodes to the same cluster as the JSON one
    (415 with a JSON fallback when protobuf is unavailable)."""
    nodes = th.hollow_nodes(24)
    pods = th.mixed_affinity_pods(40, seed=5)
    for i, p in enumerate(pods):
        p.node_name = nodes[i % 24].name
    by_json, by_pb = _cpu_backend(), _cpu_backend()
    srv = text.ExtenderHTTPServer(by_pb, prefix="/scheduler")
    srv.start()
    try:
        wire = _Wire(srv.port)
        for path, items, enc in (
                ("/cache/nodes", nodes, protowire.encode_nodes
                 if protowire.available() else None),
                ("/cache/pods", pods, protowire.encode_pods
                 if protowire.available() else None)):
            if enc is None:
                wire.conn.request("POST", "/scheduler" + path, b"",
                                  {"Content-Type": protowire.CONTENT_TYPE})
                resp = wire.conn.getresponse()
                assert resp.status == 415
                resp.read()
                body = {"items": [tserde.encode_node(n) if path.endswith(
                    "nodes") else tserde.encode_pod(n) for n in items]}
                assert wire.post(path, body)[0] == 200
                continue
            wire.conn.request("POST", "/scheduler" + path, enc(items),
                              {"Content-Type": protowire.CONTENT_TYPE})
            resp = wire.conn.getresponse()
            assert resp.status == 200
            assert json.loads(resp.read()) == {"synced": len(items)}
        wire.close()
    finally:
        srv.stop()
    by_json.sync_nodes(nodes)
    by_json.sync_pods(pods)
    probe = th.affinity_pods(2, seed=6)
    for p in probe:
        a = by_json._eval_many([p])[0]
        b = by_pb._eval_many([p])[0]
        np.testing.assert_array_equal(a.m, b.m)
        np.testing.assert_array_equal(a.s, b.s)


def test_coalesced_batch_equals_the_reference():
    """`_eval_many` over a batch of nine classes — plain, affinity and
    host-oracle ones — gives the reference's (fits, scores) rows."""
    nodes_body, pods_body, probes, _ = _cluster(PORT)
    ref = jext.TPUExtenderBackend()
    port = _cpu_backend()
    for b, serde in ((ref, jserde), (port, tserde)):
        b.sync_nodes([serde.decode_node(o) for o in nodes_body["items"]])
        b.sync_pods([serde.decode_pod(o) for o in pods_body["items"]])
    picks = probes[:4] + probes[8:10] + probes[-5:-2]
    f0 = COUNTERS.count("extender.fused_eval_batch")
    want = ref._eval_many([jserde.decode_pod(o) for o in picks])
    got = port._eval_many([tserde.decode_pod(o) for o in picks])
    assert COUNTERS.count("extender.fused_eval_batch") == f0 + 1
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.m, np.asarray(w.m))
        np.testing.assert_array_equal(g.s, np.asarray(w.s))
        assert g.names == w.names and g.gen == w.gen


# ---------------------------------------------------- the warm fast lane


def test_second_filter_serves_from_result_memo():
    b = _backend()
    b.filter(_pod("a"), None, None)
    builds0 = b.eval_cache.builds
    evals0 = COUNTERS.count("extender.fused_eval")
    hits0 = COUNTERS.count("extender.result_hit")
    passed, failed = b.filter(_pod("b"), None, None)
    assert len(passed) == N_NODES and not failed
    assert b.eval_cache.builds == builds0
    assert COUNTERS.count("extender.fused_eval") == evals0
    assert COUNTERS.count("extender.result_hit") == hits0 + 1


def test_prioritize_rides_the_filter_evaluation():
    b = _backend()
    pod = _pod("fused")
    b.filter(pod, None, None)
    evals0 = COUNTERS.count("extender.fused_eval")
    hits0 = b.eval_cache.result_hits
    assert len(b.prioritize(pod, None, None)) == N_NODES
    assert COUNTERS.count("extender.fused_eval") == evals0
    assert b.eval_cache.result_hits == hits0 + 1


def test_sync_nodes_invalidates_device_resident_cache():
    b = _backend()
    refresh0 = COUNTERS.count("extender.refresh_full")
    uploads0 = COUNTERS.count("engine.device_upload_arrays")
    builds0 = b.eval_cache.builds
    nodes = [info.node for info in b.cache.node_infos().values()]
    nodes[0] = tt.make_node(nodes[0].name, cpu=8000, memory=64 << 30,
                            pods=110, labels=dict(nodes[0].labels))
    b.sync_nodes(nodes)
    passed, _ = b.filter(_pod("post-sync"), None, None)
    assert len(passed) == N_NODES
    assert COUNTERS.count("extender.refresh_full") == refresh0 + 1
    assert COUNTERS.count("engine.device_upload_arrays") > uploads0
    assert b.eval_cache.builds == builds0 + 1


def test_bind_invalidates_results_but_keeps_encoding():
    b = _backend()
    builds0 = b.eval_cache.builds
    evals0 = COUNTERS.count("extender.fused_eval")
    full0 = COUNTERS.count("extender.refresh_full")
    hint0 = COUNTERS.count("extender.refresh_hint")
    version0 = b.engine.snapshot.version
    assert b.bind("bound-1", "default", "u1", "hollow-node-3") == ""
    assert len(b.prioritize(_pod("post-bind"), None, None)) == N_NODES
    assert b.engine.snapshot.version == version0 + 1
    assert COUNTERS.count("extender.fused_eval") == evals0 + 1
    assert b.eval_cache.builds == builds0
    assert COUNTERS.count("extender.refresh_full") == full0
    assert COUNTERS.count("extender.refresh_hint") == hint0 + 1
    i = b.engine.snapshot.node_index["hollow-node-3"]
    assert b.engine.snapshot.pod_count[i] == 1


def test_warm_path_agrees_with_stateless_args_mode():
    b = _backend()
    pod = _pod("parity")
    warm_passed, _ = b.filter(pod, None, None)
    warm_scores = dict(b.prioritize(pod, None, None))
    nodes = [i.node for i in b.cache.node_infos().values()
             if i.node is not None]
    args_passed, _ = b.filter(pod, nodes, None)
    assert sorted(warm_passed) == sorted(args_passed)
    assert warm_scores == dict(b.prioritize(pod, nodes, None))


def test_affinity_sync_demotes_the_aff_free_lane():
    b = _backend()
    assert b.eval_cache.cluster_aff_free
    aff = tt.Affinity(pod_affinity=tt.PodAffinity(required_terms=[
        tt.PodAffinityTerm(label_selector=tt.LabelSelector(
            match_labels={"app": "guard"}), topology_key="zone")]))
    guard = tt.make_pod("guard", cpu=100, labels={"app": "guard"},
                        affinity=aff)
    guard.node_name = "hollow-node-0"
    b.sync_pods([guard])
    assert not b.eval_cache.cluster_aff_free
    builds0 = b.eval_cache.builds
    passed, _ = b.filter(_pod("plain-after-aff"), None, None)
    assert len(passed) == N_NODES
    assert b.eval_cache.builds == builds0 + 1
    b.sync_pods([])
    assert b.eval_cache.cluster_aff_free


def test_churn_requests_route_to_the_oracle_and_intern_at_sync():
    """A fresh selector pair per request routes to the exact oracle
    without touching the snapshot; the queued pairs intern in one batch
    at the next sync, after which the pod takes the device path."""
    b = _backend()
    snap = b.engine.snapshot
    v0 = snap.version
    routes0 = b.eval_cache.oracle_routes

    def churn(i):
        req = tt.SelectorRequirement(key=f"churn-key-{i}",
                                     operator=tt.SelectorOperator.IN,
                                     values=[f"churn-val-{i}"])
        return tt.make_pod(f"churn-{i}", cpu=100, affinity=tt.Affinity(
            node_affinity=tt.NodeAffinity(required_terms=[
                tt.NodeSelectorTerm(match_expressions=[req])])))
    for i in range(6):
        passed, failed = b.filter(churn(i), None, None)
        assert passed == [] and len(failed) == N_NODES
    img = _pod("img")
    img.containers[0].image = "registry.example/churn:1"
    assert len(b.filter(img, None, None)[0]) == N_NODES
    assert snap.version == v0
    assert b.eval_cache.oracle_routes == routes0 + 7
    b.sync_nodes([i.node for i in b.cache.node_infos().values()])
    routes1 = b.eval_cache.oracle_routes
    assert b.filter(churn(0), None, None)[0] == []
    assert b.eval_cache.oracle_routes == routes1
    assert not b.eval_cache._pending_pairs


def test_compat_scheduleone_loop_commits_capacity():
    b = _backend()
    full0 = COUNTERS.count("extender.refresh_full")
    chosen = []
    for i in range(6):
        pod = _pod(f"so-{i}")
        b.filter(pod, None, None)
        host = max(b.prioritize(pod, None, None), key=lambda e: e[1])[0]
        assert b.bind(pod.name, pod.namespace, pod.uid, host) == ""
        chosen.append(host)
    snap = b.engine.snapshot
    for host in set(chosen):
        assert snap.pod_count[snap.node_index[host]] >= 1
    assert COUNTERS.count("extender.refresh_full") == full0


# -------------------------------------------------------------- coalescing


def test_concurrent_filters_coalesce_into_shared_dispatches():
    b = _backend(coalesce_window_s=0.002)
    n_threads = 12
    start = threading.Barrier(n_threads)
    results, errors = [], []
    lock = threading.Lock()

    def drive(i):
        try:
            start.wait(timeout=10)
            passed, failed, gen = b.filter_verdict(_pod(f"storm-{i}"))
            with lock:
                results.append((len(passed), len(failed), gen))
        except Exception as e:  # noqa: BLE001 — surfaced below
            with lock:
                errors.append(e)

    f0 = COUNTERS.count("extender.fused_eval")
    fb0 = COUNTERS.count("extender.fused_eval_batch")
    threads = [threading.Thread(target=drive, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == n_threads
    assert all(r == (N_NODES, 0, results[0][2]) for r in results)
    dispatches = (COUNTERS.count("extender.fused_eval") - f0
                  + COUNTERS.count("extender.fused_eval_batch") - fb0)
    assert dispatches <= 1, dispatches   # the warm-up already evaluated
    with b._counters_lock:
        assert b._counters["coalesce_requests"] >= n_threads


def test_coalescer_fault_degrades_to_per_request(monkeypatch):
    """A faulting batch evaluation falls back to per-request evaluation on
    the backend's own device, and the fault is counted."""
    b = _backend()
    real = b._eval_many
    devices = []
    eval_one = b._eval_one

    def boom(pods):
        raise RuntimeError("injected coalescer fault")

    def spy_one(pod):
        devices.append(b.engine.device)
        return eval_one(pod)

    monkeypatch.setattr(b, "_eval_many", boom)
    monkeypatch.setattr(b, "_eval_one", spy_one)
    passed, failed, _gen = b.filter_verdict(_pod("degraded", cpu=300))
    assert len(passed) == N_NODES and not failed
    assert [d.type for d in devices] == ["cpu"]
    with b._counters_lock:
        assert b._counters["coalesce_faults"] == 1
    monkeypatch.setattr(b, "_eval_many", real)
    assert len(b.filter_verdict(_pod("recovered"))[0]) == N_NODES


# ---------------------------------------------------- fence and exactly-once


def _tiny_backend(**kw):
    b = _cpu_backend(**kw)
    b.sync_nodes([tt.make_node(f"tiny-{i}", cpu=1000, memory=4 << 30,
                               pods=110) for i in range(2)])
    return b


def test_bind_fence_conflict_is_typed_and_retryable():
    b = _tiny_backend()
    spec = tt.make_pod("a", cpu=900, memory=256 << 20)
    passed, _f, gen = b.filter_verdict(spec)
    assert sorted(passed) == ["tiny-0", "tiny-1"]
    assert b.bind_verdict("a", "default", "u-a", "tiny-0", snapshot_gen=gen,
                          idem_key="a:1", pod_spec=spec)[:2] == ("", "ok")
    spec_b = tt.make_pod("b", cpu=900, memory=256 << 20)
    err, kind, retry_s = b.bind_verdict("b", "default", "u-b", "tiny-0",
                                        snapshot_gen=gen, idem_key="b:1",
                                        pod_spec=spec_b)
    assert kind == "conflict" and err.startswith("CONFLICT") and retry_s > 0
    with b._counters_lock:
        assert b._counters["bind_conflicts"] == 1
        assert b._counters["bind_conflict_reason_capacity"] == 1
    passed, _f, gen2 = b.filter_verdict(spec_b)
    assert passed == ["tiny-1"]
    assert b.bind_verdict("b", "default", "u-b", "tiny-1", snapshot_gen=gen2,
                          idem_key="b:2", pod_spec=spec_b)[:2] == ("", "ok")


def test_bind_skips_fence_when_generation_current():
    b = _backend()
    spec = _pod("cur")
    passed, _f, gen = b.filter_verdict(spec)
    assert b.bind_verdict("cur", "default", "u-c", passed[0],
                          snapshot_gen=gen, pod_spec=spec)[:2] == ("", "ok")
    with b._counters_lock:
        assert b._counters.get("bind_fence_skipped", 0) == 1
    assert b.bind_verdict("cur2", "default", "u-c2", passed[1],
                          snapshot_gen=gen,
                          pod_spec=_pod("cur2"))[:2] == ("", "ok")
    with b._counters_lock:
        assert b._counters.get("bind_fence_skipped", 0) == 1


def test_stale_window_serves_memo_and_fence_guards():
    b = _backend(stale_window_s=30.0)
    passed, _f, gen = b.filter_verdict(_pod("sw-0"))
    evals0 = (COUNTERS.count("extender.fused_eval")
              + COUNTERS.count("extender.fused_eval_batch"))
    stale0 = COUNTERS.count("extender.stale_served")
    for i in range(4):
        assert b.bind_verdict(f"sw-{i}", "default", f"u-{i}", passed[i],
                              snapshot_gen=gen,
                              pod_spec=_pod(f"sw-{i}"))[:2] == ("", "ok")
        p2, _f2, g2 = b.filter_verdict(_pod(f"sw-chk-{i}"))
        assert len(p2) == N_NODES and g2 == gen
    assert (COUNTERS.count("extender.fused_eval")
            + COUNTERS.count("extender.fused_eval_batch")) == evals0
    assert COUNTERS.count("extender.stale_served") > stale0
    assert sum(len(i.pods) for i in b.cache.node_infos().values()) == 4


def test_idempotent_replay_returns_recorded_outcome():
    b = _backend()
    spec = _pod("idem")
    passed, _f, gen = b.filter_verdict(spec)
    assert b.bind_verdict("idem", "default", "u-i", passed[0],
                          snapshot_gen=gen, idem_key="idem:1",
                          pod_spec=spec)[1] == "ok"
    pods0 = b.cache.pod_count()
    assert b.bind_verdict("idem", "default", "u-i", passed[0],
                          snapshot_gen=gen, idem_key="idem:1",
                          pod_spec=spec)[:2] == ("", "ok")
    assert b.cache.pod_count() == pods0
    with b._counters_lock:
        assert b._counters["bind_replays"] == 1


def test_timeout_bind_replays_to_exactly_once_at_store():
    api = ApiServerLite()
    for n in th.hollow_nodes(8):
        api.create("Node", n)
    pod = _pod("ghost")
    api.create("Pod", pod)
    faulty = FaultyBindApi(api, timeout_rate=1.0, seed=7)
    b = _cpu_backend(binder=extender_store_binder(faulty))
    b.sync_nodes([api.get("Node", "", f"hollow-node-{i}") for i in range(8)])
    passed, _f, gen = b.filter_verdict(pod)
    node = passed[0]
    err, kind, _ = b.bind_verdict("ghost", "default", pod.uid, node,
                                  snapshot_gen=gen, idem_key="ghost:1",
                                  pod_spec=pod)
    assert kind == "error" and "timeout" in err
    assert api.get("Pod", "default", "ghost").node_name == node
    faulty.timeout_rate = 0.0
    assert b.bind_verdict("ghost", "default", pod.uid, "ignored",
                          snapshot_gen=None, idem_key="ghost:1",
                          pod_spec=pod)[:2] == ("", "ok")
    assert api.get("Pod", "default", "ghost").node_name == node
    binds = [e for e in api._log
             if e.kind == "Pod" and e.type == "MODIFIED"
             and e.obj.name == "ghost" and e.obj.node_name]
    assert len(binds) == 1


def test_concurrent_client_storm_exactly_once_under_faults():
    """Eight frontends hammer filter/prioritize/bind on one backend with
    injected bind failures and timeouts, retrying conflicts: every pod
    ends bound to exactly one node at the store."""
    api = ApiServerLite(max_log=100_000)
    nodes = th.hollow_nodes(64)
    for n in nodes:
        api.create("Node", n)
    faulty = FaultyBindApi(api, fail_rate=0.10, timeout_rate=0.10, seed=11)
    b = _cpu_backend(binder=extender_store_binder(faulty),
                     stale_window_s=0.02, coalesce_window_s=0.001)
    b.sync_nodes(nodes)
    n_clients, per = 8, 6
    for c in range(n_clients):
        for i in range(per):
            api.create("Pod", _pod(f"storm-{c}-{i}"))
    errors, lock = [], threading.Lock()
    start = threading.Barrier(n_clients)

    def drive(c):
        rng = random.Random(1000 + c)
        try:
            start.wait(timeout=20)
            for i in range(per):
                name = f"storm-{c}-{i}"
                spec = _pod(name)
                for attempt in range(25):
                    passed, _f, gen = b.filter_verdict(spec)
                    scores, _g = b.prioritize_verdict(spec, passed)
                    best = max(s for _n, s in scores)
                    top = [n for n, s in scores if s == best]
                    node = top[rng.randrange(len(top))]
                    err, kind, retry_s = b.bind_verdict(
                        name, "default", spec.uid, node, snapshot_gen=gen,
                        idem_key=f"{name}:{attempt}", pod_spec=spec)
                    if kind == "ok":
                        break
                    if kind in ("conflict", "pending"):
                        time.sleep(retry_s * rng.uniform(0.5, 1.5))
                        continue
                    if "already assigned" in err:
                        break
                    err2, kind2, _ = b.bind_verdict(
                        name, "default", spec.uid, node, snapshot_gen=None,
                        idem_key=f"{name}:{attempt}", pod_spec=spec)
                    if kind2 == "ok" or "already assigned" in err2:
                        break
                else:
                    raise AssertionError(f"{name} never bound")
        except Exception as e:  # noqa: BLE001 — surfaced below
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=drive, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    storm = [p for p in api.list("Pod")[0] if p.name.startswith("storm-")]
    assert len(storm) == n_clients * per and all(p.node_name for p in storm)
    first = {}
    for e in api._log:
        if e.kind == "Pod" and e.type == "MODIFIED" and e.obj.node_name:
            assert first.setdefault(e.obj.name, e.obj.node_name) \
                == e.obj.node_name, f"duplicate bind of {e.obj.name}"
    assert faulty.injected_failures + faulty.injected_timeouts > 0
    with b._counters_lock:
        assert b._counters.get("bind_errors", 0) > 0


# ------------------------------------------------------------ backpressure


def test_admission_control_sheds_past_queue_depth():
    b = _backend(coalesce_max_depth=2)
    entered, release = threading.Event(), threading.Event()
    real = b._eval_many

    def slow(pods):
        entered.set()
        release.wait(timeout=10)
        return real(pods)

    b._eval_many = slow
    outs, overloads, lock = [], [], threading.Lock()

    def drive(i):
        try:
            out = b.coalescer.submit(_pod(f"adm-{i}"))
            with lock:
                outs.append(out)
        except Overloaded as e:
            assert e.retry_after_s > 0
            with lock:
                overloads.append(e)

    leader = threading.Thread(target=drive, args=(0,))
    leader.start()
    assert entered.wait(timeout=10)
    followers = [threading.Thread(target=drive, args=(i,)) for i in (1, 2)]
    for t in followers:
        t.start()
    deadline = time.monotonic() + 10
    while len(b.coalescer._queue) < 2:
        assert time.monotonic() < deadline, "queue never filled"
        time.sleep(0.001)
    for i in range(3, 8):
        drive(i)
    release.set()
    for t in [leader] + followers:
        t.join(timeout=30)
        assert not t.is_alive()
    b._eval_many = real
    assert len(overloads) == 5 and len(outs) == 3
    with b._counters_lock:
        assert b._counters["admission_shed"] == 5


def test_expired_deadline_is_shed_not_evaluated():
    b = _backend()
    with pytest.raises(DeadlineExceeded):
        b.coalescer.submit(_pod("dead"), deadline_s=-0.001)
    with b._counters_lock:
        assert b._counters["deadline_shed"] >= 1
    spec = _pod("dead-bind")
    passed, _f, gen = b.filter_verdict(spec)
    assert b.bind_verdict("dead-bind", "default", "u-d", passed[0],
                          snapshot_gen=gen, idem_key="db:1",
                          deadline_s=-0.001,
                          pod_spec=spec)[:2] == ("DEADLINE_EXCEEDED", "shed")
    assert b.bind_verdict("dead-bind", "default", "u-d", passed[0],
                          snapshot_gen=gen, idem_key="db:1",
                          pod_spec=spec)[:2] == ("", "ok")


def test_http_wire_conflict_429_compact_and_keepalive():
    b = _tiny_backend()
    srv = text.ExtenderHTTPServer(b, prefix="/scheduler")
    srv.start()
    try:
        wire = _Wire(srv.port)
        enc = tserde.encode_pod(tt.make_pod("w1", cpu=900, memory=256 << 20))
        status, body = wire.post("/filter", {"Pod": enc, "NodeNames": None,
                                             "Compact": True, "TopK": 8})
        out = json.loads(body)
        assert status == 200 and out["AllPassed"]
        assert out["PassedCount"] == 2 and len(out["TopScores"]) == 2
        gen = out["SnapshotGen"]
        status, body = wire.post("/bind", {
            "PodName": "w1", "PodNamespace": "default", "PodUID": "u1",
            "Node": "tiny-0", "SnapshotGen": gen, "IdempotencyKey": "w1:1",
            "Pod": enc})
        assert status == 200 and json.loads(body)["Error"] == ""
        enc2 = tserde.encode_pod(tt.make_pod("w2", cpu=900,
                                             memory=256 << 20))
        status, body = wire.post("/bind", {
            "PodName": "w2", "PodNamespace": "default", "PodUID": "u2",
            "Node": "tiny-0", "SnapshotGen": gen, "IdempotencyKey": "w2:1",
            "Pod": enc2})
        out = json.loads(body)
        assert status == 409 and out["Conflict"] and out["RetryAfterMs"] >= 1
        srv.max_inflight = 0
        wire.conn.request("POST", "/scheduler/filter",
                          json.dumps({"Pod": enc, "NodeNames": None}),
                          {"Content-Type": "application/json"})
        resp = wire.conn.getresponse()
        assert resp.status == 429 and resp.getheader("Retry-After")
        resp.read()
        srv.max_inflight = 256
        status, body = wire.get("/metrics")
        text_body = body.decode()
        for needle in ("tpu_extender_bind_conflicts_total 1",
                       "tpu_extender_admission_shed_total",
                       "tpu_extender_coalesce_requests_total",
                       "tpu_extender_commit_gen"):
            assert needle in text_body, needle
        wire.close()
    finally:
        srv.stop()


# ------------------------------------------------------------ lock checker


def test_lockcheck_leg_coalesced_storm_bit_identical(monkeypatch):
    """The coalesced storm with every lock instrumented (GRAFT_LOCKCHECK=1
    at construction), the extender's, the cache's and the bind ledger's
    included: results bit-identical to the unarmed world, binds go
    through the checked ledger, and zero recorded violations."""
    ref = _backend()
    pods = [_pod(f"lc-{i}", cpu=100 * (1 + i % 3)) for i in range(9)]
    want = ref._eval_many(pods)

    monkeypatch.setenv("GRAFT_LOCKCHECK", "1")
    lockcheck.reset()
    b = _backend(coalesce_window_s=0.002)
    plain = type(threading.Lock())
    for lk in (b.cache._lock, b.ledger._lock, b._counters_lock):
        assert type(lk) is not plain, type(lk)
    for v, w in zip(b._eval_many(pods), want):
        np.testing.assert_array_equal(v.m, w.m)
        np.testing.assert_array_equal(v.s, w.s)

    n_threads = 8
    start = threading.Barrier(n_threads)
    results, errors = [], []
    lock = threading.Lock()

    def drive(i):
        try:
            start.wait(timeout=10)
            spec = _pod(f"lcs-{i}")
            passed, failed, gen = b.filter_verdict(spec)
            err, kind, _ = b.bind_verdict(
                spec.name, "default", spec.uid, passed[i], snapshot_gen=gen,
                idem_key=f"lcs-{i}:0", pod_spec=spec)
            with lock:
                results.append((len(passed), len(failed), kind))
        except Exception as e:  # noqa: BLE001 — surfaced below
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=drive, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert results == [(N_NODES, 0, "ok")] * n_threads
    assert b.cache.pod_count() == n_threads
    lockcheck.assert_clean()
