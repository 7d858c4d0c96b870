"""The reference's host-level contracts of the binary frames, the
federation, the daemon's trace and lockcheck on both packages: the frame
codec (tests/test_framing.py), the federation router and its cells
(tests/test_federation_router.py), the daemon's slow-round trace, its
endpoints and lease handoff (tests/test_daemon_trace.py) and the lock
checker (tests/test_lockcheck.py). Each body is the reference's, with its
imports through the `k` fixture and every port entry point on the CPU;
where two reference files share a top-level name, the later one's carries
a prefix of its file. bench.py's A/B range helper belongs to neither
package (the port has no benchmark of its own yet), so both cases of its
test call bench.py's."""

from __future__ import annotations

import importlib
import json
import struct
import threading
import urllib.request

import numpy as np
import pytest

from tests.torch_packages import PORT, REF, Pkg, reference_test_module

MODULES = {
    "api_scheme": "api.scheme",
    "api_types": "api.types",
    "client_leaderelection": "client.leaderelection",
    "engine_gang": "engine.gang",
    "federation_aggregate": "federation.aggregate",
    "federation_cell": "federation.cell",
    "federation_router": "federation.router",
    "framing": "server.framing",
    "lockcheck": "analysis.lockcheck",
    "models_hollow": "models.hollow",
    "observability_trend": "observability.trend",
    "ops_federation": "ops.federation",
    "parallel_multiproc": "parallel.multiproc",
    "sched_mod": "engine.scheduler",
    "server_apiserver_lite": "server.apiserver_lite",
    "server_daemon": "server.daemon",
    "testing_churn": "testing.churn",
    "utils_metrics": "utils.metrics",
    "utils_trace": "utils.trace",
}


def _pkg(root):
    return Pkg(root, MODULES, extra={
        "FakeClock": reference_test_module("test_nodes", root).FakeClock,
        "_ab_ranges_overlap": importlib.import_module(
            "bench")._ab_ranges_overlap,
        "cli_dev": ["--device", "cpu"] if root == PORT else [],
        # observability.trend has a main of its own
        "main": importlib.import_module(f"{root}.server.daemon").main,
    })


PKGS = {root: _pkg(root) for root in (REF, PORT)}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


# -------------------- tests/test_framing.py


def _pod(k, name="fx", cpu=250):
    p = k.make_pod(name, cpu=cpu, memory=512 << 20)
    p.labels["app"] = "frame-test"
    return p


# ------------------------------------------------------------- round trips


def test_filter_request_roundtrip(k):
    pod = _pod(k)
    payload = k.framing.encode_filter_request(pod, top_k=32,
                                            deadline_ms=10_000)
    dec_pod, top_k, deadline_ms = k.framing.decode_filter_request(payload)
    assert (top_k, deadline_ms) == (32, 10_000)
    assert dec_pod.name == pod.name and dec_pod.labels == pod.labels
    assert dec_pod.containers[0].requests == pod.containers[0].requests


def test_bind_request_roundtrip_with_and_without_spec(k):
    pod = _pod(k, "bx")
    payload = k.framing.encode_bind_request(
        "bx", "default", "u-1", "node-7", snapshot_gen=42,
        idem_key="bx:3", deadline_ms=5000, pod=pod)
    name, ns, uid, node, gen, key, dl, spec = \
        k.framing.decode_bind_request(payload)
    assert (name, ns, uid, node) == ("bx", "default", "u-1", "node-7")
    assert (gen, key, dl) == (42, "bx:3", 5000)
    assert spec is not None and spec.name == "bx"
    # identifiers-only form: gen None rides as -1, empty key -> None
    payload = k.framing.encode_bind_request("bx", "default", "u-1", "n")
    out = k.framing.decode_bind_request(payload)
    assert out[4] is None and out[5] is None and out[7] is None


def test_verdict_and_bind_result_roundtrip(k):
    p = k.framing.encode_verdict(9, False, 3, ["a", "b", "c"], ["d"],
                               [("a", 100), ("b", -5)])
    d = k.framing.decode_verdict(p)
    assert d["gen"] == 9 and not d["all_passed"]
    assert d["passed"] == ["a", "b", "c"] and d["failed"] == ["d"]
    assert d["top"] == [("a", 100), ("b", -5)]
    # compact all-passed: names elided, count carried
    d = k.framing.decode_verdict(
        k.framing.encode_verdict(None, True, 5000, None, [], []))
    assert d["gen"] is None and d["all_passed"] and d["passed_count"] == 5000
    assert d["passed"] == [] and d["top"] == []
    for kind in k.framing.BIND_KINDS:
        r = k.framing.decode_bind_result(
            k.framing.encode_bind_result(kind, 17, "CONFLICT: x"))
        assert r == {"kind": kind, "retry_after_ms": 17,
                     "error": "CONFLICT: x"}


def test_control_frames_roundtrip(k):
    assert k.framing.decode_overloaded(k.framing.encode_overloaded(33)) == 33
    assert k.framing.decode_error(k.framing.encode_error("boom")) == "boom"
    assert k.framing.decode_synced(k.framing.encode_synced(7)) == 7
    assert k.framing.decode_metrics_text(
        k.framing.encode_metrics_text("a\nb")) == "a\nb"


def test_items_blob_roundtrip_json_fallback(k):
    nodes = [k.make_node(f"n{i}", cpu=4000, memory=8 << 30) for i in range(3)]
    blob = k.framing.encode_items_blob(nodes, "nodes")
    out = k.framing.decode_items_blob(blob, "nodes")
    assert [n.name for n in out] == ["n0", "n1", "n2"]
    assert out[0].allocatable.milli_cpu == 4000
    pods = [_pod(k, f"p{i}") for i in range(2)]
    out = k.framing.decode_items_blob(k.framing.encode_items_blob(pods, "pods"),
                                    "pods")
    assert [p.name for p in out] == ["p0", "p1"]


# ---------------------------------------------------------------- decoder


def test_decoder_reassembles_byte_by_byte(k):
    """Interleaved partial writes: three frames fed one byte at a time
    must come out whole, in order, regardless of chunk boundaries."""
    frames = [
        k.framing.encode_frame(k.framing.PING, 1),
        k.framing.encode_frame(k.framing.FILTER, 2,
                             k.framing.encode_filter_request(_pod(k), 8, 100),
                             flags=k.framing.FLAG_COMPACT),
        k.framing.encode_frame(k.framing.ERROR, 3,
                             k.framing.encode_error("x" * 300)),
    ]
    stream = b"".join(frames)
    dec = k.framing.FrameDecoder()
    got = []
    for i in range(len(stream)):
        got.extend(dec.feed(stream[i:i + 1]))
    assert [(v, r) for v, _f, r, _p in got] == [
        (k.framing.PING, 1), (k.framing.FILTER, 2), (k.framing.ERROR, 3)]
    assert got[1][1] == k.framing.FLAG_COMPACT
    assert k.framing.decode_error(got[2][3]) == "x" * 300
    assert dec.buffered == 0


def test_decoder_mixed_chunk_sizes(k):
    frames = [k.framing.encode_frame(k.framing.PING, i) for i in range(10)]
    stream = b"".join(frames)
    dec = k.framing.FrameDecoder()
    got, pos = [], 0
    for sz in (1, 3, 7, 11, 64, 1, 2, 1000):
        got.extend(dec.feed(stream[pos:pos + sz]))
        pos += sz
    got.extend(dec.feed(stream[pos:]))
    assert [r for _v, _f, r, _p in got] == list(range(10))


def test_corrupt_length_prefix_raises_typed(k):
    # length beyond max_frame: e.g. ASCII garbage read as a u32
    with pytest.raises(k.framing.FrameError, match="corrupt frame length"):
        k.framing.FrameDecoder().feed(b"GET / HTTP/1.1\r\n\r\n")
    # length below the header remainder (cannot even hold verb+id)
    bad = struct.pack("!IBBI", 2, k.framing.PING, 0, 1)
    with pytest.raises(k.framing.FrameError, match="corrupt frame length"):
        k.framing.FrameDecoder().feed(bad)


def test_oversized_frame_rejected_before_buffering(k):
    dec = k.framing.FrameDecoder(max_frame=64)
    big = k.framing.encode_frame(k.framing.ERROR, 1,
                               k.framing.encode_error("y" * 200))
    with pytest.raises(k.framing.FrameError, match="corrupt frame length"):
        dec.feed(big)


def test_truncated_frame_waits_truncated_payload_raises(k):
    # a SHORT feed is not an error — the decoder waits for the rest
    frame = k.framing.encode_frame(
        k.framing.BIND, 5, k.framing.encode_bind_request("a", "ns", "u", "n"))
    dec = k.framing.FrameDecoder()
    assert dec.feed(frame[:len(frame) - 3]) == []
    assert dec.buffered == len(frame) - 3
    # ...but a payload LYING about its contents is typed at parse time
    lying = k.framing.encode_frame(k.framing.VERDICT, 6, b"\x00\x01")
    (verb, _f, _r, payload), = k.framing.FrameDecoder().feed(lying)
    with pytest.raises(k.framing.FrameError, match="truncated"):
        k.framing.decode_verdict(payload)


def test_corrupt_string_and_list_counts_raise_typed(k):
    # string declaring more bytes than the payload holds
    p = bytes(k.framing.Writer().u32(1 << 30).buf)
    with pytest.raises(k.framing.FrameError, match="truncated string"):
        k.framing.Reader(p).str_()
    # absurd list count must be rejected before looping
    p = bytes(k.framing.Writer().u32(1 << 31).buf)
    with pytest.raises(k.framing.FrameError, match="corrupt list count"):
        k.framing.Reader(p).strs()


def test_pod_blob_typed_failures(k):
    with pytest.raises(k.framing.FrameError, match="empty pod blob"):
        k.framing.decode_pod_blob(b"")
    with pytest.raises(k.framing.FrameError, match="unknown pod codec"):
        k.framing.decode_pod_blob(b"\x77{}")
    with pytest.raises(k.framing.FrameError, match="bad JSON pod blob"):
        k.framing.decode_pod_blob(bytes([k.framing.CODEC_JSON]) + b"{nope")


def test_random_garbage_never_escapes_frame_error(k):
    """The fuzz core: random byte soup either yields frames, waits for
    more input, or raises FrameError — nothing else, ever."""
    import random as _random
    rng = _random.Random(0xF022)
    for trial in range(200):
        dec = k.framing.FrameDecoder(max_frame=1 << 16)
        blob = bytes(rng.randrange(256)
                     for _ in range(rng.randrange(1, 400)))
        try:
            frames = dec.feed(blob)
        except k.framing.FrameError:
            continue
        for verb, _f, _r, payload in frames:
            # parsing any claimed payload stays typed too
            for parse in (k.framing.decode_verdict,
                          k.framing.decode_bind_request,
                          k.framing.decode_filter_request):
                try:
                    parse(payload)
                except k.framing.FrameError:
                    pass


# -------------------- tests/test_federation_router.py


def _fed_pod(k, name, cpu=100, mem=64 << 20, **kw):
    return k.make_pod(name, cpu=cpu, memory=mem, **kw)


def _gang(k, name, members, cpu=50):
    out = []
    for m in range(members):
        p = _fed_pod(k, f"{name}-{m}", cpu=cpu, mem=32 << 20)
        p.annotations[k.GANG_NAME_ANNOTATION] = name
        p.annotations[k.GANG_MIN_AVAILABLE_ANNOTATION] = str(members)
        out.append(p)
    return out


class _Cell:
    """One in-process cell: store + engine + CellService, pumped from
    the test's own thread (deterministic — no pump thread)."""

    def __init__(self, k, name, n_nodes=16, zones=4):
        self.name = name
        self.api = k.ApiServerLite()
        for i, n in enumerate(k.hollow_nodes(n_nodes)):
            n.labels["zone"] = f"{name}-z{i % zones}"
            self.api.create("Node", n)
        self.sched = k.Scheduler(self.api, record_events=False, **k.dev)
        self.svc = k.CellService(self.api, cell=name)
        self.sched.spill_handler = self.svc.spill
        self.sched.spill_after_attempts = 2
        self.sched.start()
        self.loop = self.sched.stream(budget_s=0.05, min_quantum=8,
                                      max_quantum=128)
        self.handle = k.LocalCell(name, self.svc)

    def pump(self, steps=8):
        for _ in range(steps):
            self.loop.step(wait=0.001)

    def bound_keys(self):
        pods, _rv = self.api.list("Pod")
        return {p.key(): p.node_name for p in pods if p.node_name}

    def close(self):
        self.loop.close()


@pytest.fixture
def two_cells(k):
    cells = [_Cell(k, "alpha", n_nodes=16), _Cell(k, "beta", n_nodes=16)]
    router = k.FederationRouter([c.handle for c in cells], **k.dev)
    router.hydrate()
    yield cells, router
    for c in cells:
        c.close()


def _drain(cells, router, rounds=60):
    for _ in range(rounds):
        for c in cells:
            c.pump(4)
        router.spill_pump()
        if sum(a.pending for a in router.aggs.values()) == 0 \
                and not router.backlog:
            return
    raise AssertionError(
        f"fleet did not drain: pending="
        f"{ {n: a.pending for n, a in router.aggs.items()} } "
        f"backlog={len(router.backlog)}")


# ------------------------------------------------------------ determinism


def _frozen_router(k, use_device):
    """Router over dummy handles with a HAND-FROZEN aggregate tensor —
    route() reads only the columns, so no cell machinery is needed."""

    class _Dummy:
        def __init__(self, name):
            self.name = name

        def close(self):
            pass

    router = k.FederationRouter([_Dummy(n) for n in ("c0", "c1", "c2")],
                              use_device=use_device, **k.dev)
    shapes = {
        "c0": dict(nodes_total=10, nodes_ready=10, cpu_alloc_m=40_000,
                   mem_alloc_mib=40_960, cpu_used_m=35_000,
                   mem_used_mib=4_096, pending=0,
                   domains={"z0": 5, "z1": 5}),
        "c1": dict(nodes_total=10, nodes_ready=10, cpu_alloc_m=40_000,
                   mem_alloc_mib=40_960, cpu_used_m=8_000,
                   mem_used_mib=4_096, pending=12,
                   domains={"z1": 10}),
        "c2": dict(nodes_total=10, nodes_ready=10, cpu_alloc_m=40_000,
                   mem_alloc_mib=40_960, cpu_used_m=8_000,
                   mem_used_mib=4_096, pending=0, domains={"z2": 10}),
    }
    for name, kw in shapes.items():
        agg = k.CellAggregate(cell=name, ready=True, **kw)
        router.aggs[name] = agg
    return router


def _mixed_batch(k):
    pods = [_fed_pod(k, f"d{i}", cpu=100 + 50 * (i % 3)) for i in range(40)]
    pods += [_fed_pod(k, "z1-pin", cpu=100, node_selector={"zone": "z1"}),
             _fed_pod(k, "z2-pin", cpu=100, node_selector={"zone": "z2"})]
    pods += _gang(k, "dg", 4)
    return pods


def test_frozen_tensor_routes_bit_identical_run_to_run(k):
    a1, l1 = _frozen_router(k, False).route(_mixed_batch(k))
    a2, l2 = _frozen_router(k, False).route(_mixed_batch(k))
    as_keys = lambda a: {c: [p.key() for p in ps]  # noqa: E731
                         for c, ps in a.items()}
    assert as_keys(a1) == as_keys(a2)
    assert [p.key() for p in l1] == [p.key() for p in l2]
    # the frozen shape exercises every verdict class: the loaded c0
    # loses ties, zone pins land on their only domain, someone routes
    assert a1, "nothing routed"
    z1_cell = [c for c, ps in a1.items()
               if any(p.name == "z1-pin" for p in ps)]
    assert z1_cell and z1_cell[0] in ("c0", "c1")
    z2_cell = [c for c, ps in a1.items()
               if any(p.name == "z2-pin" for p in ps)]
    assert z2_cell == ["c2"]


def test_device_and_host_twins_route_identically(k):
    """use_device=True pads C to the bucket ladder and scores through
    the jitted kernel; the numpy twin must produce the SAME choices —
    the routing policy is latency, never semantics."""
    ah, _lh = _frozen_router(k, False).route(_mixed_batch(k))
    ad, _ld = _frozen_router(k, True).route(_mixed_batch(k))
    assert {c: [p.key() for p in ps] for c, ps in ah.items()} \
        == {c: [p.key() for p in ps] for c, ps in ad.items()}


def test_route_scores_twins_bitwise_equal(k):
    rng = np.random.RandomState(7)
    C, M = 33, 5
    args = (rng.randint(0, 2000, C).astype(np.int32),
            rng.randint(0, 2000, C).astype(np.int32),
            rng.randint(-500, 40_000, M).astype(np.int32),
            rng.randint(-500, 40_000, M).astype(np.int32),
            rng.randint(1, 80_000, M).astype(np.int32),
            rng.randint(1, 80_000, M).astype(np.int32),
            rng.uniform(0, 3, M).astype(np.float32),
            rng.rand(M) > 0.3,
            rng.rand(C, M) > 0.2)
    dev = np.asarray(k.route_scores(*args, **k.dev))
    host = k.route_scores_host(*args)
    assert np.array_equal(dev, host)


# ------------------------------------------------------------------ gangs


def test_gang_routes_whole_cell_and_binds_there(k, two_cells):
    cells, router = two_cells
    gang = _gang(k, "tg", 5)
    filler = [_fed_pod(k, f"f{i}") for i in range(10)]
    router.admit(filler + gang)
    assert router.counters_snapshot()["routed_gangs"] == 1
    _drain(cells, router)
    homes = set()
    for c in cells:
        bound = c.bound_keys()
        members = [kk for kk in bound if kk.startswith("default/tg-")]
        if members:
            homes.add(c.name)
            assert len(members) == 5, \
                f"gang split inside {c.name}: {members}"
    assert len(homes) == 1, f"gang spanned cells: {homes}"


# --------------------------------------------------- brownout exactly-once


def _bind_event_cells(cells):
    """Event-log audit surface: pod key -> set of cells whose store log
    EVER carried a bind event (Pod MODIFIED naming a node) for it."""
    seen = {}
    for c in cells:
        with c.api._lock:
            log = list(c.api._log)
        for ev in log:
            if ev.kind != "Pod" or ev.type != "MODIFIED":
                continue
            node = getattr(ev.obj, "node_name", "")
            if node:
                seen.setdefault(ev.obj.key(), set()).add(c.name)
    return seen


def test_brownout_spillover_is_exactly_once(k, two_cells):
    cells, router = two_cells
    alpha, beta = cells
    pods = [_fed_pod(k, f"b{i}") for i in range(30)]
    router.admit(pods)
    # only beta's engine runs before the fault: whatever landed on
    # alpha is still pending there when it browns out
    beta.pump(4)
    evacuated = router.brownout("alpha")
    assert not router.aggs["alpha"].ready
    _drain(cells, router)
    router.recover("alpha")
    assert router.aggs["alpha"].ready
    # store truth: every pod bound exactly once, somewhere
    all_bound = {}
    for c in cells:
        for kk, node in c.bound_keys().items():
            assert kk not in all_bound, \
                f"{kk} bound in two cells: {all_bound[kk]} and {c.name}"
            all_bound[kk] = c.name
        assert k.audit_duplicate_binds(c.api) == 0
    assert len(all_bound) == 30
    # event-log audit: one bound cell per pod EVER — an evacuated pod
    # left alpha's store before beta could bind it, so no pod key has
    # bind events in both logs
    for key, homes in _bind_event_cells(cells).items():
        assert len(homes) == 1, f"{key} has bind events in {homes}"
    if evacuated:
        assert router.counters_snapshot()["evacuated_moved"] == evacuated


def test_admit_wire_fault_replays_same_idem_key(k, two_cells):
    """An ambiguous ADMIT fault (reply lost AFTER the cell committed)
    replays the SAME idempotency key; the cell's idem cache converges
    the retry to the recorded answer — no pod double-enters."""
    cells, router = two_cells
    alpha = cells[0]
    real_admit = alpha.handle.admit
    state = {"fired": False}

    def flaky_admit(idem_key, pods):
        out = real_admit(idem_key, pods)
        if not state["fired"]:
            state["fired"] = True
            raise ConnectionError("reply lost after commit")
        return out

    alpha.handle.admit = flaky_admit
    router.admit([_fed_pod(k, f"r{i}") for i in range(8)])
    assert state["fired"]
    pods, _rv = alpha.api.list("Pod")
    beta_pods, _rv = cells[1].api.list("Pod")
    names = sorted(p.name for p in pods) + sorted(
        p.name for p in beta_pods)
    assert names == sorted(f"r{i}" for i in range(8))
    # the replay hit the idem cache, not the store
    assert alpha.svc.counters_snapshot()["admit_replays"] == 0


# ---------------------------------------------------------- oracle A/B


def test_folded_aggregate_equals_store_oracle(k, two_cells):
    cells, router = two_cells
    alpha = cells[0]
    router.admit([_fed_pod(k, f"o{i}") for i in range(20)])
    alpha.pump(6)
    cells[1].pump(6)
    d, _spilled = alpha.handle.cell_agg()
    folded = k.CellAggregate.from_dict(d)
    nodes, _rv = alpha.api.list("Node")
    pods, _rv = alpha.api.list("Pod")
    oracle = k.aggregate_from_lists(nodes, pods, cell="alpha")
    for key in ("nodes_total", "nodes_ready", "cpu_alloc_m",
                "mem_alloc_mib", "cpu_used_m", "mem_used_mib",
                "pending", "bound_total", "domains"):
        assert getattr(folded, key) == getattr(oracle, key), \
            f"fold/oracle diverge on {key}"
    # and the RELIST hydration path agrees on the capacity picture
    router.hydrate()
    hyd = router.aggs["alpha"]
    for key in ("nodes_total", "nodes_ready", "cpu_alloc_m",
                "mem_alloc_mib", "cpu_used_m", "mem_used_mib",
                "domains"):
        assert getattr(hyd, key) == getattr(oracle, key), \
            f"hydrate/oracle diverge on {key}"


def test_compacted_log_rebuild_matches_oracle(k):
    """A watch log compacted past the fold cursor forces the store-walk
    rebuild — the rebuilt column must equal the oracle too."""
    api = k.ApiServerLite(max_log=64)
    for i, n in enumerate(k.hollow_nodes(8)):
        n.labels["zone"] = f"g-z{i % 2}"
        api.create("Node", n)
    svc = k.CellService(api, cell="gamma")
    d, _sp = svc.cell_aggregate()
    assert d["nodes_total"] == 8
    # blow past the 64-event log bound so the cursor is too old
    for i in range(200):
        api.create("Pod", _fed_pod(k, f"c{i}"))
    d, _sp = svc.cell_aggregate()
    assert svc.counters_snapshot()["agg_rebuilds"] == 1
    nodes, _rv = api.list("Node")
    pods, _rv = api.list("Pod")
    oracle = k.aggregate_from_lists(nodes, pods, cell="gamma")
    assert d["pending"] == oracle.pending == 200
    assert d["cpu_used_m"] == oracle.cpu_used_m


# ------------------------------------------------------------- satellites


def test_brownout_schedule_deterministic_and_bounded(k):
    a = k.make_brownout_schedule(["c0", "c1", "c2"], 10.0, down_s=2.0,
                               count=3, seed=42)
    b = k.make_brownout_schedule(["c0", "c1", "c2"], 10.0, down_s=2.0,
                               count=3, seed=42)
    assert a == b
    assert a != k.make_brownout_schedule(["c0", "c1", "c2"], 10.0,
                                       down_s=2.0, count=3, seed=43)
    busy = {}
    for op in a:
        assert 1.0 <= op.t <= 9.0
        assert busy.get(op.cell, -1.0) < op.t, "same-cell overlap"
        busy[op.cell] = op.t + op.down_s


def test_ab_ranges_overlap_helper(k):
    from bench import _ab_ranges_overlap
    assert _ab_ranges_overlap([1.0, 3.0], [2.5, 4.0])
    assert not _ab_ranges_overlap([1.0, 2.0], [3.0, 4.0])
    assert not _ab_ranges_overlap([], [1.0])
    assert _ab_ranges_overlap([2.0], [2.0])


def test_trend_single_core_churn_regression_not_gated(k):
    """A churn_vs_quiet drop on a 1-cpu box against a round with no
    recorded cpus is annotated single_core_band — reported, never
    fatal (the r11-vs-r19 attribution: box shape, not code)."""
    rounds = [(11, {"churn_vs_quiet": 0.664}),
              (21, {"churn_vs_quiet": 0.386, "cpus": 1,
                    "churn_attribution": {"cpus": 1, "bar": 0.35}})]
    regs = k.find_regressions(rounds)
    assert len(regs) == 1
    assert "single_core_band" in regs[0]
    # WITHOUT the disclosed attribution the same drop still gates —
    # leniency must be earned by evidence in the artifact
    bare = k.find_regressions([(11, {"churn_vs_quiet": 0.664}),
                             (21, {"churn_vs_quiet": 0.386, "cpus": 1})])
    assert bare and "single_core_band" not in bare[0]
    # the main() fatal filter drops annotated regressions
    fatal = [g for g in regs
             if "box_change" not in g and "single_core_band" not in g]
    assert fatal == []
    # a genuinely same-shape 2-core drop still gates
    rounds2 = [(11, {"churn_vs_quiet": 0.664, "cpus": 2}),
               (21, {"churn_vs_quiet": 0.386, "cpus": 2})]
    regs2 = k.find_regressions(rounds2)
    assert regs2 and "single_core_band" not in regs2[0] \
        and "box_change" not in regs2[0]


def test_trend_knows_federation_headlines(k):
    keys = {kk for kk, _l, _d in k.HEADLINE_METRICS}
    assert {"federation_agg_nodes", "federation_router_p99_ms",
            "federation_spillover_bound"} <= keys


def test_unroutable_pods_backlog_then_admit_after_capacity(k):
    """A pod no ready cell fits goes to the router backlog (counted
    unroutable), and pump_backlog admits it once capacity appears."""

    class _Dummy:
        def __init__(self, name):
            self.name = name
            self.batches = []

        def admit(self, idem_key, pods):
            self.batches.append(list(pods))
            return len(pods), 0

        def close(self):
            pass

    cell = _Dummy("solo")
    router = k.FederationRouter([cell], **k.dev)
    agg = k.CellAggregate(cell="solo", ready=True, nodes_total=2,
                        nodes_ready=2, cpu_alloc_m=1000,
                        mem_alloc_mib=1024, cpu_used_m=900,
                        mem_used_mib=0)
    router.aggs["solo"] = agg
    router.admit([_fed_pod(k, "big", cpu=500, mem=64 << 20)])
    assert len(router.backlog) == 1
    assert router.counters_snapshot()["unroutable"] == 1
    assert cell.batches == []
    with router._lock:
        router.aggs["solo"].cpu_used_m = 100
    assert router.pump_backlog() == 1
    assert [p.name for b in cell.batches for p in b] == ["big"]


# -------------------- tests/test_daemon_trace.py


# -------------------------------------------------------------------- trace


def test_trace_dumps_only_when_slow(k):
    t = {"now": 0.0}
    out = []
    tr = k.Trace("Scheduling round", now=lambda: t["now"],
               sink=out.append, pods=3)
    t["now"] = 0.02
    tr.step("informer sync done")
    t["now"] = 0.05
    tr.step("batch placement computed (device)")
    assert tr.log_if_long(0.1) is False and out == []  # fast: silent
    t["now"] = 0.31
    tr.step("bindings written")
    assert tr.log_if_long(0.1) is True
    dump = out[0]
    assert 'Trace "Scheduling round" pods=3' in dump
    assert "informer sync done" in dump and "(+30.0ms)" in dump
    assert "bindings written" in dump


def test_scheduler_round_emits_trace_when_over_threshold(k, monkeypatch):
    """The wired-in trace fires for a genuinely slow round."""

    api = k.ApiServerLite()
    api.create("Node", k.make_node("n0"))
    api.create("Pod", k.make_pod("p0", cpu=100))
    sched = k.sched_mod.Scheduler(api, record_events=False, **k.dev)
    sched.start()
    dumps = []
    real_trace = k.sched_mod.Trace
    monkeypatch.setattr(
        k.sched_mod, "Trace",
        lambda name, **kw: real_trace(name, sink=dumps.append, **kw))
    # force slowness: a schedule call that "takes" 5s via a patched engine
    real_schedule = sched.engine.schedule

    def slow_schedule(*a, **kw):
        import time as _t
        r = real_schedule(*a, **kw)
        _t.sleep(0.15)  # > 0.1s-per-pod threshold for a 1-pod round
        return r

    sched.engine.schedule = slow_schedule
    sched.schedule_round()
    assert len(dumps) == 1
    assert "batch placement computed (device)" in dumps[0]


# ------------------------------------------------------------------- daemon


def test_daemon_healthz_metrics_and_leader_endpoints(k):
    api = k.ApiServerLite()
    for i in range(4):
        api.create("Node", k.make_node(f"n{i}"))
    for i in range(8):
        api.create("Pod", k.make_pod(f"p{i}", cpu=100))
    d = k.SchedulerDaemon(api, "me", k.SchedulerOptions(healthz_port=0), **k.dev)
    try:
        d.step()  # acquire + schedule
        port = d.healthz_port
        assert port

        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return r.read().decode()

        assert get("/healthz") == "ok"
        assert get("/leader") == "true"
        metrics = get("/metrics")
        assert "scheduler" in metrics  # prometheus text with histograms
        pods, _ = api.list("Pod")
        assert all(p.node_name for p in pods)
    finally:
        d.stop()


def test_daemon_policy_config_file(k, tmp_path):
    policy_file = tmp_path / "policy.json"
    policy_file.write_text(json.dumps({
        "predicates": [
            {"name": "GeneralPredicates"},
            {"name": "P", "argument": {"labelsPresence":
                                       {"labels": ["ok"], "presence": True}}},
        ],
        "priorities": [{"name": "LeastRequestedPriority", "weight": 1}],
    }))
    api = k.ApiServerLite()
    api.create("Node", k.make_node("labeled", labels={"ok": "1"}))
    api.create("Node", k.make_node("bare"))
    for i in range(4):
        api.create("Pod", k.make_pod(f"p{i}", cpu=100))
    d = k.SchedulerDaemon(
        api, "me", k.SchedulerOptions(healthz_port=None, leader_elect=False,
                                    policy_config_file=str(policy_file)), **k.dev)
    try:
        for _ in range(3):
            d.step()
        pods, _ = api.list("Pod")
        assert all(p.node_name == "labeled" for p in pods)
    finally:
        d.stop()


def test_daemon_demo_main(k, capsys):
    k.main(["--nodes", "10", "--pods", "40", *k.cli_dev])
    out = capsys.readouterr().out
    assert "bound=40/40" in out
    assert "leader=daemon-a" in out


def test_daemon_graceful_stop_releases_lease_for_immediate_handoff(k):
    """Graceful stop (release=True) zeroes the lease so the standby
    acquires WITHOUT waiting out lease_duration — contrast with the crash
    path in tests/test_chaos.py::test_daemon_failover_after_leader_crash."""

    clock = k.FakeClock()
    api = k.ApiServerLite()
    api.create("Node", k.make_node("n0"))
    opts = k.SchedulerOptions(healthz_port=None)
    a = k.SchedulerDaemon(api, "a", opts, now=clock, **k.dev)
    b = k.SchedulerDaemon(api, "b", opts, now=clock, **k.dev)
    a.step()
    b.step()
    assert a.is_leader() and not b.is_leader()
    a.stop(release=True)
    assert api.get("Lease", "kube-system", "kube-scheduler").holder == ""
    b.step()  # NO clock advance needed
    assert b.is_leader()
    b.stop()


def test_released_lease_acquirable_even_at_small_clock_values(k):
    """Regression (review): holder=="" must read as free even when
    now < lease_duration — a FakeClock at t=1 or a freshly booted
    monotonic clock must not have to wait out a phantom lease."""

    clock = k.FakeClock(t=1.0)  # below the 15s lease_duration
    api = k.ApiServerLite()
    lock = k.LeaseLock(api, "kube-scheduler")
    a = k.LeaderElector(lock, "a", now=clock)
    b = k.LeaderElector(lock, "b", now=clock)
    assert a.step() is True
    a.release()
    assert b.step() is True, "released lease must be immediately acquirable"


def test_daemon_from_component_config(k, tmp_path):
    """--config: a versioned KubeSchedulerConfiguration drives the daemon
    options (the reference's componentconfig path, types.go:158-198)."""
    import json


    cfg = k.DEFAULT_SCHEME.decode({
        "apiVersion": "componentconfig/v1alpha1",
        "kind": "KubeSchedulerConfiguration",
        "schedulerName": "tpu-sched",
        "healthzBindAddress": "127.0.0.1:0",
        "leaderElection": {"leaderElect": False,
                           "lockObjectName": "my-lock"}})
    opts = k.SchedulerOptions.from_component_config(cfg)
    assert opts.scheduler_name == "tpu-sched"
    assert opts.leader_elect is False
    assert opts.lock_object_name == "my-lock"
    assert opts.healthz_port == 0


# -------------------- tests/test_lockcheck.py


@pytest.fixture()
def armed(k, monkeypatch):
    monkeypatch.setenv("GRAFT_LOCKCHECK", "1")
    k.lockcheck.reset()
    yield
    k.lockcheck.reset()


# ------------------------------------------------------------ knob off


def test_knob_off_returns_raw_primitives(k, monkeypatch):
    monkeypatch.delenv("GRAFT_LOCKCHECK", raising=False)
    assert not k.lockcheck.enabled()
    lk = k.lockcheck.make_lock("X._lock")
    assert type(lk) is type(threading.Lock())  # raw _thread.lock, no wrapper
    rl = k.lockcheck.make_rlock("X._rlock")
    assert type(rl) is type(threading.RLock())
    cv = k.lockcheck.make_condition("X._cv")
    assert type(cv) is threading.Condition
    # assert_held is an isinstance-gated no-op on raw primitives
    k.lockcheck.assert_held(lk, "anything")
    assert k.lockcheck.violations() == []


# ----------------------------------------------------------- inversion


def test_abba_inversion_recorded_without_losing_the_race(k, armed):
    a = k.lockcheck.make_lock("Cell._a")
    b = k.lockcheck.make_lock("Cell._b")
    with a:
        with b:
            pass
    # single-threaded, never actually deadlocks — the edge table still
    # has the witness
    with b:
        with a:
            pass
    vs = k.lockcheck.violations()
    assert len(vs) == 1
    assert "lock-order inversion" in vs[0]
    assert "Cell._a" in vs[0] and "Cell._b" in vs[0]
    with pytest.raises(AssertionError, match="lock-order inversion"):
        k.lockcheck.assert_clean()
    k.lockcheck.reset()
    assert k.lockcheck.violations() == []
    k.lockcheck.assert_clean()


def test_consistent_order_is_clean(k, armed):
    a = k.lockcheck.make_lock("Cell._a")
    b = k.lockcheck.make_lock("Cell._b")
    for _ in range(3):
        with a:
            with b:
                pass
    assert k.lockcheck.violations() == []


def test_same_name_different_objects_no_edge(k, armed):
    """Two INSTANCES of one class share a lock id; no order exists
    between peers, so hand-over-hand on two instances is not an
    inversion."""
    a1 = k.lockcheck.make_lock("Peer._lock")
    a2 = k.lockcheck.make_lock("Peer._lock")
    with a1:
        with a2:
            pass
    with a2:
        with a1:
            pass
    assert k.lockcheck.violations() == []


def test_cross_thread_inversion_detected(k, armed):
    """The realistic shape: each direction on its OWN thread, never
    racing — lockdep-style, the edge table spans threads."""
    a = k.lockcheck.make_lock("Cell._a")
    b = k.lockcheck.make_lock("Cell._b")

    def fwd():
        with a:
            with b:
                pass

    def bwd():
        with b:
            with a:
                pass

    t = threading.Thread(target=fwd)
    t.start()
    t.join()
    t = threading.Thread(target=bwd)
    t.start()
    t.join()
    vs = k.lockcheck.violations()
    assert len(vs) == 1 and "inversion" in vs[0]


# ------------------------------------------------------- self-deadlock


def test_nonreentrant_reacquire_raises_instead_of_hanging(k, armed):
    lk = k.lockcheck.make_lock("C._lock")
    with lk:
        with pytest.raises(RuntimeError, match="guaranteed deadlock"):
            lk.acquire()
    # the raise happened BEFORE the raw acquire: lock is free again
    assert lk.acquire(timeout=0.5)
    lk.release()


def test_rlock_reentry_is_fine(k, armed):
    rl = k.lockcheck.make_rlock("C._rlock")
    with rl:
        with rl:
            pass
    assert k.lockcheck.violations() == []
    # fully released: another thread can take it (and give it back)
    got = []

    def taker():
        ok = rl.acquire(timeout=1)
        got.append(ok)
        if ok:
            rl.release()

    t = threading.Thread(target=taker)
    t.start()
    t.join()
    assert got == [True]


# --------------------------------------------------------- assert_held


def test_assert_held_records_unguarded_locked_call(k, armed):
    lk = k.lockcheck.make_lock("C._lock")
    with lk:
        k.lockcheck.assert_held(lk, "guarded path")
    assert k.lockcheck.violations() == []
    k.lockcheck.assert_held(lk, "bare path")
    vs = k.lockcheck.violations()
    assert len(vs) == 1
    assert "guard not held" in vs[0] and "bare path" in vs[0]


def test_assert_held_catches_real_torn_metrics_write(k, armed):
    """The r18 regression at runtime: calling Histogram._observe_locked
    without its lock is exactly what GL007 catches statically — the
    armed checker catches the same bug if it sneaks past the linter."""

    h = k.Histogram("t")  # constructed while armed -> checked lock
    h.observe(0.25)     # the public path holds the lock
    assert k.lockcheck.violations() == []
    h._observe_locked(0.5, 1)  # the bug: bare call
    vs = k.lockcheck.violations()
    assert len(vs) == 1 and "Histogram._lock" in vs[0]
    assert h.count == 2  # behaviour unchanged; only the report differs


# ----------------------------------------------------------- condition


def test_condition_wait_pops_and_restores_held_entry(k, armed):
    """wait() releases the lock for the duration, so the held entry must
    pop for the sleep and come back on wake — otherwise every lock the
    wait predicate (or the woken continuation) touches would hang a
    phantom cv-> X edge on the thread."""
    cv = k.lockcheck.make_condition("Q._lock")
    seen = []
    ready = []

    def producer():
        with cv:
            ready.append(1)
            cv.notify_all()

    with cv:
        assert cv._is_held()
        t = threading.Thread(target=producer)
        t.start()
        # the predicate runs on the waiter thread DURING the wait
        assert cv.wait_for(
            lambda: (seen.append(cv._is_held()), bool(ready))[1],
            timeout=5)
        assert cv._is_held()
    t.join()
    assert seen and not any(seen)
    assert k.lockcheck.violations() == []
