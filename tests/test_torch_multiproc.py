"""The port's process fleet over one shared cell (parallel/multiproc.py
over server/asyncwire.py) on the CPU, as the reference's
tests/test_multiproc.py pins it: the RELIST round trip and commit truth,
two schedulers racing one pod to exactly one bind, the double-claim probe
sparing a same-node replay, the fence-conflict counters partitioning
exactly on all three transports, the typed conflict landing in the flight
recorder's ring, the reader-task accounting at ``stop()``, and spawned
``run_process_fleet(..., device="cpu")`` workers over an overlapped pool
binding every pod exactly once, also under the lock checker; the
perfetto exporter's per-process lanes and typed wire-conflict instants,
and the trend gate on the fleet's headline."""

from __future__ import annotations

import json
import time

import pytest

from kubernetes_tpu_torch.api.types import make_pod
from kubernetes_tpu_torch.client.binarywire import BinaryWireClient
from kubernetes_tpu_torch.models.hollow import hollow_nodes
from kubernetes_tpu_torch.observability import podtrace as pt
from kubernetes_tpu_torch.server import framing
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite
from kubernetes_tpu_torch.server.asyncwire import AsyncBinaryServer
from kubernetes_tpu_torch.server.embedded import VerdictService
from kubernetes_tpu_torch.server.extender import TPUExtenderBackend
from kubernetes_tpu_torch.testing.churn import FaultyBindApi, extender_store_binder


def _pod(name: str, cpu: int = 100):
    return make_pod(name, cpu=cpu, memory=256 << 20)


def _cell(n_nodes: int = 32, with_store: bool = True):
    """One shared cell: store + fenced backend + service + binary wire."""
    api = ApiServerLite()
    nodes = hollow_nodes(n_nodes)
    binder = None
    if with_store:
        for n in nodes:
            api.create("Node", n)
        binder = extender_store_binder(FaultyBindApi(api))
    b = TPUExtenderBackend(binder=binder, coalesce_window_s=0.0005,
                           device="cpu")
    b.sync_nodes(nodes)
    b.filter(_pod("warm"), None, None)
    svc = VerdictService(b)
    srv = AsyncBinaryServer(svc)
    srv.start()
    return api, b, svc, srv


# ------------------------------------------------------------------ relist


def test_relist_framing_roundtrip():
    nodes = hollow_nodes(5)
    pods = [make_pod(f"r-{i}", cpu=100, memory=64 << 20,
                     node_name=f"hollow-node-{i}") for i in range(3)]
    blob = framing.encode_relist_result(nodes, pods)
    rn, rp = framing.decode_relist_result(blob)
    assert [n.name for n in rn] == [n.name for n in nodes]
    assert [(p.name, p.node_name) for p in rp] == \
        [(p.name, p.node_name) for p in pods]
    # empty cell round-trips too (a worker can hydrate before any bind)
    rn, rp = framing.decode_relist_result(
        framing.encode_relist_result([], []))
    assert rn == [] and rp == []


def test_relist_over_wire_returns_commit_truth():
    """A bind committed through the fence is visible to the NEXT relist
    — assumed occupancy included, not just store-confirmed pods. That
    visibility is what bounds a sibling process's staleness."""
    api, b, svc, srv = _cell()
    cli = BinaryWireClient("127.0.0.1", srv.port).connect()
    try:
        nodes, pods = cli.relist()
        assert len(nodes) == 32 and pods == []
        p = _pod("mp-a")
        api.create("Pod", p)
        fv = cli.filter_fused(p)
        host = max(fv.top_scores, key=lambda t: t[1])[0]
        r = cli.bind(p.name, p.namespace, p.uid, host,
                     snapshot_gen=fv.snapshot_gen, idem_key="mp-a:1",
                     pod=p)
        assert r.kind == "ok"
        nodes, pods = cli.relist()
        assert [(q.key(), q.node_name) for q in pods] == \
            [("default/mp-a", host)]
    finally:
        cli.close()
        srv.stop()


# ------------------------------------------------------- double-claim fence


def test_two_schedulers_race_one_pod_exactly_one_bind():
    """The double-claim fence's core claim, deterministic: two clients race the
    SAME pod to DIFFERENT nodes through fresh ledger keys (two
    independent schedulers, not a retry). Exactly one bind lands; the
    loser gets the TYPED double-claim conflict naming the owner; the
    store's event log shows exactly one bind — zero ghosts."""
    api, b, svc, srv = _cell()
    c1 = BinaryWireClient("127.0.0.1", srv.port).connect()
    c2 = BinaryWireClient("127.0.0.1", srv.port).connect()
    try:
        p = _pod("raced")
        api.create("Pod", p)
        r1 = c1.bind(p.name, p.namespace, p.uid, "hollow-node-3",
                     snapshot_gen=None, idem_key="raced:w0:0", pod=p)
        assert r1.kind == "ok"
        r2 = c2.bind(p.name, p.namespace, p.uid, "hollow-node-7",
                     snapshot_gen=None, idem_key="raced:w1:0", pod=p)
        assert r2.kind == "conflict"
        assert "double-claim" in r2.error
        assert "already claimed on hollow-node-3" in r2.error
        # typed partition: the conflict is double_claim, nothing else
        vars_ = svc.debug_snapshot()["vars"]
        assert vars_["counter.extender.bind_conflicts"] == 1
        assert vars_[
            "counter.extender.bind_conflict_reason_double_claim"] == 1
        # store truth: ONE bind event, on the winner's node
        binds = [e for e in api._log
                 if e.kind == "Pod" and e.type == "MODIFIED"
                 and e.obj.node_name]
        assert [(e.obj.name, e.obj.node_name) for e in binds] == \
            [("raced", "hollow-node-3")]
    finally:
        c1.close()
        c2.close()
        srv.stop()


def test_double_claim_probe_spares_same_node_replay():
    """A client retrying a bind that already LANDED on the same node
    (the timeout-ambiguity heal) must NOT trip the double-claim probe —
    same-node re-binds fall through to the idempotent heal path."""
    api, b, svc, srv = _cell()
    cli = BinaryWireClient("127.0.0.1", srv.port).connect()
    try:
        p = _pod("healme")
        api.create("Pod", p)
        r1 = cli.bind(p.name, p.namespace, p.uid, "hollow-node-2",
                      snapshot_gen=None, idem_key="healme:1", pod=p)
        assert r1.kind == "ok"
        # fresh key, SAME node: a second scheduler converging on the
        # same placement (or a lost-ack retry) heals, not conflicts
        r2 = cli.bind(p.name, p.namespace, p.uid, "hollow-node-2",
                      snapshot_gen=None, idem_key="healme:2", pod=p)
        assert r2.kind == "ok"
        vars_ = svc.debug_snapshot()["vars"]
        assert vars_.get("counter.extender.bind_conflicts", 0) == 0
    finally:
        cli.close()
        srv.stop()


# -------------------------------------------- typed counters on 3 transports


def test_fence_conflict_counters_partition_on_all_transports():
    """Sum of bind_conflict_reason_* == bind_conflicts, with three
    distinct reasons seeded (double_claim, liveness, capacity), and the
    snapshot byte-identical through HTTP /debug/vars, binary STATS and
    the embedded debug_snapshot."""
    from kubernetes_tpu_torch.server.extender import ExtenderHTTPServer

    api, b, svc, srv = _cell(n_nodes=16)
    http_srv = ExtenderHTTPServer(b)
    http_srv.start()
    cli = BinaryWireClient("127.0.0.1", srv.port).connect()
    try:
        p = _pod("part-a")
        api.create("Pod", p)
        assert cli.bind(p.name, p.namespace, p.uid, "hollow-node-0",
                        snapshot_gen=None, idem_key="pa:1",
                        pod=p).kind == "ok"
        # double_claim: fresh key, different node
        r = cli.bind(p.name, p.namespace, p.uid, "hollow-node-1",
                     snapshot_gen=None, idem_key="pa:2", pod=p)
        assert r.kind == "conflict" and "double-claim" in r.error
        # liveness: the target node does not exist
        q = _pod("part-b")
        r = cli.bind(q.name, q.namespace, q.uid, "ghost-node",
                     snapshot_gen=None, idem_key="pb:1", pod=q)
        assert r.kind == "conflict" and "unknown" in r.error
        # capacity: a pod no node can hold
        big = make_pod("part-c", cpu=10**9, memory=1 << 50)
        r = cli.bind(big.name, big.namespace, big.uid, "hollow-node-2",
                     snapshot_gen=None, idem_key="pc:1", pod=big)
        assert r.kind == "conflict" and "insufficient" in r.error

        import http.client
        conn = http.client.HTTPConnection("127.0.0.1", http_srv.port,
                                          timeout=15)
        try:
            conn.request("GET", "/debug/vars")
            hv = json.loads(conn.getresponse().read())
        finally:
            conn.close()
        bv = cli.stats()["vars"]
        ev = svc.debug_snapshot()["vars"]
        assert hv == bv == ev  # transport parity, byte-identical
        total = ev["counter.extender.bind_conflicts"]
        by_reason = {nm: ev.get(
            f"counter.extender.bind_conflict_reason_{nm}", 0)
            for nm in pt.REASON_NAMES}
        assert total == 3
        assert sum(by_reason.values()) == total  # exact partition
        assert by_reason["double_claim"] == 1
        assert by_reason["liveness"] == 1
        assert by_reason["capacity"] == 1
    finally:
        cli.close()
        http_srv.stop()
        srv.stop()


def test_wire_fence_conflict_lands_in_ring_as_typed_instant():
    """With the flight recorder armed, a wire fence conflict records a
    FENCE_REQUEUE with wave=-1 (no wave owns it) carrying the typed
    reason code — the hook the perfetto instants render from."""
    from kubernetes_tpu_torch.observability.recorder import RECORDER

    api, b, svc, srv = _cell(n_nodes=8)
    cli = BinaryWireClient("127.0.0.1", srv.port).connect()
    RECORDER.clear()
    RECORDER.enable()
    try:
        p = _pod("ring-a")
        api.create("Pod", p)
        assert cli.bind(p.name, p.namespace, p.uid, "hollow-node-0",
                        snapshot_gen=None, idem_key="ra:1",
                        pod=p).kind == "ok"
        r = cli.bind(p.name, p.namespace, p.uid, "hollow-node-1",
                     snapshot_gen=None, idem_key="ra:2", pod=p)
        assert r.kind == "conflict"
        evs = [e for e in RECORDER.snapshot()
               if e["kind"] == "fence_requeue" and e["wave"] < 0]
        assert len(evs) == 1
        assert evs[0]["b"] == pt.REASON_DOUBLE_CLAIM
    finally:
        RECORDER.disable()
        RECORDER.clear()
        cli.close()
        srv.stop()


def test_perfetto_renders_wire_conflicts_and_process_lanes():
    """One lane per scheduler process; fence-conflict instants typed by
    reason name on the fence lane AND the process lane, all aligned to
    the ring's time base."""
    from kubernetes_tpu_torch.observability.perfetto import (
        TID_PROC_BASE, add_process_lanes, build_chrome_trace)

    t0 = 1000.0
    ring = [
        {"kind": "dispatch", "wave": 1, "t": t0, "dur": 0.001,
         "a": 4, "b": 0},
        {"kind": "fence_requeue", "wave": -1, "t": t0 + 0.002,
         "dur": 0.0, "a": 1, "b": pt.REASON_DOUBLE_CLAIM},
        {"kind": "fence_requeue", "wave": 2, "t": t0 + 0.003,
         "dur": 0.0, "a": 2, "b": 1},
    ]
    trace = build_chrome_trace(ring)
    names = [e["name"] for e in trace["traceEvents"]]
    assert "fence-conflict:double_claim" in names  # typed wire instant
    assert "fence-requeue w2" in names  # wave-owned shape untouched
    workers = [
        {"worker": 0, "counts": {"binds": 2, "conflicts": 0},
         "events": [
             {"kind": "relist", "t": t0 + 0.001, "dur": 0.0005, "n": 0},
             {"kind": "bind", "t": t0 + 0.004, "dur": 0.001,
              "pod": "default/a", "node": "n0", "attempt": 0}]},
        {"worker": 1, "counts": {"binds": 1, "conflicts": 1},
         "events": [
             {"kind": "conflict", "t": t0 + 0.002, "dur": 0.0004,
              "pod": "default/a", "reason": "double_claim",
              "owner": "n0"}]},
    ]
    add_process_lanes(trace, workers, t_base=t0)
    evs = trace["traceEvents"]
    lane_meta = [e for e in evs if e["ph"] == "M"
                 and e.get("tid", 0) >= TID_PROC_BASE]
    assert len(lane_meta) == 2  # one lane per process
    assert "sched-proc 0" in lane_meta[0]["args"]["name"]
    w1_conflicts = [e for e in evs if e["ph"] == "i"
                    and e.get("tid") == TID_PROC_BASE + 1]
    assert w1_conflicts[0]["name"] == "fence-conflict:double_claim"
    # ring alignment: the worker instant sits at its monotonic offset
    # from the ring's t_base (2ms), comparable with the fence lane's
    assert w1_conflicts[0]["ts"] == pytest.approx(2000.0, abs=0.2)
    binds = [e for e in evs if e["ph"] == "X"
             and e.get("tid") == TID_PROC_BASE and e["name"] == "bind"]
    assert binds and binds[0]["dur"] == pytest.approx(1000.0, abs=0.2)


def test_trend_learns_multiproc_headline(tmp_path):
    """The trend gate reads the multiproc_N aggregate from r18 on:
    absent history tolerated, a past-band drop flags."""
    from kubernetes_tpu_torch.observability import trend

    assert ("multiproc_pods_s", "multiproc agg/s", "up") \
        in trend.HEADLINE_METRICS

    def w(r, **metrics):
        doc = {"n": 1, "cmd": "python bench.py", "rc": 0,
               "parsed": metrics}
        (tmp_path / f"BENCH_r{r:02d}.json").write_text(json.dumps(doc))

    w(17, value=30000.0)  # a round before r18: no multiproc key
    w(18, value=30000.0, multiproc_pods_s=50.0)
    assert trend.find_regressions(trend.load_rounds(str(tmp_path))) == []
    w(19, value=30000.0, multiproc_pods_s=20.0)  # -60%: regression
    regs = trend.find_regressions(trend.load_rounds(str(tmp_path)))
    assert [g["metric"] for g in regs] == ["multiproc_pods_s"]


# ------------------------------------------------------- reader-task leak


def test_clean_client_close_leaves_no_reader_tasks():
    """The reader-task fix: a worker process closing its connection must
    not leak the server-side reader task. shutdown() on close delivers
    EOF now; the server discards the task; teardown cancels zero."""
    api, b, svc, srv = _cell(n_nodes=8, with_store=False)
    clients = [BinaryWireClient("127.0.0.1", srv.port).connect()
               for _ in range(3)]
    for c in clients:
        c.ping()
    assert len(srv._conn_tasks) == 3
    for c in clients:
        c.close()
    deadline = time.monotonic() + 5.0
    while srv._conn_tasks and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(srv._conn_tasks) == 0  # EOF drained every reader task
    srv.stop()
    assert srv.cancelled_conn_tasks == 0  # nothing left to cancel
    assert srv._thread is None or not srv._thread.is_alive()


def test_stop_cancels_straggler_reader_tasks():
    """Connections still open at stop() are cancelled and COUNTED —
    no pending task survives the loop (the pre-fix leak shape)."""
    api, b, svc, srv = _cell(n_nodes=8, with_store=False)
    clients = [BinaryWireClient("127.0.0.1", srv.port).connect()
               for _ in range(2)]
    for c in clients:
        c.ping()
    srv.stop()  # clients deliberately left open
    assert srv.cancelled_conn_tasks == 2
    assert srv._thread is None or not srv._thread.is_alive()
    for c in clients:
        c.close()


# ------------------------------------------------------------ process fleet


def test_process_fleet_racing_overlapped_pool_exactly_once():
    """The tentpole, end to end: TWO full scheduler processes (own
    interpreter, own evaluator, own bounded-stale snapshot) race a
    fully-overlapped pending pool through one shared cell. Store-truth
    audit: every pod binds exactly once, zero duplicates; the losers'
    refusals are TYPED double-claims; the server's conflict counters
    partition exactly."""
    from kubernetes_tpu_torch.parallel.multiproc import run_process_fleet

    out = run_process_fleet(2, pods_per_worker=8, overlap=1.0,
                            n_nodes=48, relist_every=4,
                            pod_prefix="racetest", timeout_s=180.0,
                            device="cpu")
    agg = out["agg"]
    assert agg["missing_workers"] == 0, agg
    assert agg["worker_failures"] == [], agg
    assert agg["duplicate_binds"] == 0  # the hard-zero bar
    # every contested pod landed exactly once at the store
    api = out["api"]
    bound_events: dict = {}
    for e in api._log:
        if e.kind == "Pod" and e.type == "MODIFIED" and e.obj.node_name \
                and e.obj.name.startswith("racetest"):
            bound_events.setdefault(e.obj.name, []).append(
                e.obj.node_name)
    assert len(bound_events) == 8
    assert all(len(v) == 1 for v in bound_events.values()), bound_events
    # both processes converged on the same placements (store is truth)
    workers = out["workers"]
    assert len(workers) == 2
    for w in workers:
        for key, node in w["bound"].items():
            name = key.split("/", 1)[1]
            assert bound_events[name] == [node], (key, node)
    # with 8 contested pods on 48 nodes, the losing process sees typed
    # double-claims (same-node coincidences are the only escape and
    # cannot cover all 8); the partition stays exact
    assert agg["double_claim"] >= 1
    reasons = agg["server_conflict_reasons"]
    assert sum(reasons.values()) == agg["server_bind_conflicts"]


# ------------------------------------------------ tsan-lite storm leg


def test_lockcheck_leg_process_fleet_exactly_once(monkeypatch):
    """The two-process race with GRAFT_LOCKCHECK=1 end to end: spawned
    children inherit the knob through the environment, so EVERY lock on
    both sides is a checked twin. The exactly-once audit must hold
    unchanged, the parent-side checker must end silent, and a child-side
    guaranteed-self-deadlock raise would surface as a worker failure."""
    from kubernetes_tpu_torch.analysis import lockcheck
    from kubernetes_tpu_torch.parallel.multiproc import run_process_fleet

    monkeypatch.setenv("GRAFT_LOCKCHECK", "1")
    lockcheck.reset()
    out = run_process_fleet(2, pods_per_worker=6, overlap=1.0,
                            n_nodes=32, relist_every=3,
                            pod_prefix="lcfleet", timeout_s=180.0,
                            device="cpu")
    agg = out["agg"]
    assert agg["missing_workers"] == 0, agg
    assert agg["worker_failures"] == [], agg
    assert agg["duplicate_binds"] == 0
    lockcheck.assert_clean()
