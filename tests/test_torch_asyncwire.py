"""The port's async binary fleet wire (server/asyncwire.py,
client/binarywire.py) on the CPU: the reference's contracts
(tests/test_asyncwire.py) run on the port's server over a backend with
``device="cpu"`` — scheduleOne end to end, typed fence conflicts, the
injected-fault storm exactly once, OVERLOADED past the pending bound,
deadline shedding, the frame fuzz, ``stop`` resolving queued bind
tickets, the lock checker's leg — then the cross-package interop (the
port's client against the reference's server and the other way round
give the answers of a same-package run) and the straggler contract of
``stop()``: connections still open are cancelled and counted, and the
loop thread is gone within 2 s. Exact everywhere."""

from __future__ import annotations

import random
import socket
import struct
import threading
import time

import pytest

from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.client.binarywire import (
    BinaryWireClient,
    WireDeadline,
    WireError,
    WireOverloaded,
)
from kubernetes_tpu_torch.models.hollow import hollow_nodes
from kubernetes_tpu_torch.server import framing
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite
from kubernetes_tpu_torch.server.asyncwire import AsyncBinaryServer
from kubernetes_tpu_torch.server.embedded import VerdictService
from kubernetes_tpu_torch.server.extender import TPUExtenderBackend
from kubernetes_tpu_torch.testing.churn import FaultyBindApi, extender_store_binder

N_NODES = 96


def _pod(name: str, cpu: int = 100):
    return make_pod(name, cpu=cpu, memory=256 << 20)


def _serve(nodes=None, binder=None, stale_window_s=0.02, **srv_kw):
    backend = TPUExtenderBackend(binder=binder,
                                 stale_window_s=stale_window_s,
                                 coalesce_window_s=0.0005, device="cpu")
    nodes = nodes if nodes is not None else hollow_nodes(N_NODES)
    backend.sync_nodes(nodes)
    backend.filter(_pod("warm"), None, None)
    srv = AsyncBinaryServer(VerdictService(backend), **srv_kw)
    srv.start()
    return backend, srv


def _counters(backend):
    with backend._counters_lock:
        return dict(backend._counters)


# ------------------------------------------------------------ happy path


def test_wire_scheduleone_end_to_end():
    backend, srv = _serve()
    try:
        c = BinaryWireClient("127.0.0.1", srv.port).connect()
        c.ping()
        pod = _pod("e2e")
        v = c.filter_fused(pod, top_k=8, deadline_ms=10_000)
        assert v.all_passed and v.passed_count == N_NODES
        assert v.passed is None  # compact elision over the wire
        assert v.snapshot_gen is not None and len(v.top_scores) == 8
        node = v.top_scores[0][0]
        r = c.bind("e2e", "default", pod.uid, node,
                   snapshot_gen=v.snapshot_gen, idem_key="e2e:1", pod=pod)
        assert r.ok, r
        # idempotent replay over the wire: no second assume
        pods0 = backend.cache.pod_count()
        r = c.bind("e2e", "default", pod.uid, node,
                   snapshot_gen=v.snapshot_gen, idem_key="e2e:1", pod=pod)
        assert r.ok and backend.cache.pod_count() == pods0
        # wire-level coalescing + the replay are visible in the counters
        snap = _counters(backend)
        assert snap.get("wire_batches", 0) >= 1
        assert snap.get("bind_replays", 0) == 1
        assert "tpu_extender_wire_batches_total" in c.metrics()
        c.close()
    finally:
        srv.stop()


def test_wire_sync_replaces_cluster_membership():
    backend, srv = _serve()
    try:
        c = BinaryWireClient("127.0.0.1", srv.port).connect()
        small = [make_node(f"s-{i}", cpu=4000, memory=8 << 30)
                 for i in range(4)]
        assert c.sync_nodes(small) == 4
        v = c.filter_fused(_pod("after-sync"), top_k=8)
        assert v.passed_count == 4
        assert {h for h, _s in v.top_scores} == {n.name for n in small}
        c.close()
    finally:
        srv.stop()


# ----------------------------------------------- transport equivalence


def test_wire_fence_conflict_typed_and_retryable():
    """The tight-fleet fence scenario over the binary wire (the HTTP
    twin lives in test_extender_multifrontend.py): a racing commit at
    the same generation answers a typed retryable CONFLICT frame, and
    the retry against a fresh verdict succeeds elsewhere."""
    tiny = [make_node(f"tiny-{i}", cpu=1000, memory=4 << 30, pods=110)
            for i in range(2)]
    # always-fresh verdicts, like the HTTP twin: this test pins the
    # FENCE, not the stale-window memo
    backend, srv = _serve(nodes=tiny, stale_window_s=0.0)
    try:
        c = BinaryWireClient("127.0.0.1", srv.port).connect()
        spec = make_pod("a", cpu=900, memory=256 << 20)
        v = c.filter_fused(spec, top_k=4, deadline_ms=10_000)
        assert v.passed_count == 2
        gen = v.snapshot_gen
        r = c.bind("a", "default", "u-a", "tiny-0", snapshot_gen=gen,
                   idem_key="a:1", pod=spec)
        assert r.ok
        spec_b = make_pod("b", cpu=900, memory=256 << 20)
        r = c.bind("b", "default", "u-b", "tiny-0", snapshot_gen=gen,
                   idem_key="b:1", pod=spec_b)
        assert r.kind == "conflict" and r.error.startswith("CONFLICT")
        assert r.retry_after_s > 0
        v2 = c.filter_fused(spec_b, top_k=4)
        assert [h for h, _s in v2.top_scores] == ["tiny-1"]
        r = c.bind("b", "default", "u-b", "tiny-1",
                   snapshot_gen=v2.snapshot_gen, idem_key="b:2", pod=spec_b)
        assert r.ok
        c.close()
    finally:
        srv.stop()


def test_wire_storm_exactly_once_under_faults():
    """TRANSPORT EQUIVALENCE, the headline audit: the extender's 8-client
    injected-fault storm re-run over the binary wire — failures AND
    landed timeouts injected at the store, conflicts retried, ambiguous
    attempts replayed on the same ledger key — and the store-truth audit
    still shows ONE bound node per pod, ever."""
    api = ApiServerLite(max_log=100_000)
    nodes = hollow_nodes(N_NODES)
    for n in nodes:
        api.create("Node", n)
    faulty = FaultyBindApi(api, fail_rate=0.10, timeout_rate=0.10, seed=11)
    backend, srv = _serve(nodes=nodes,
                          binder=extender_store_binder(faulty))
    n_clients, per = 8, 10
    for c_ in range(n_clients):
        for i in range(per):
            api.create("Pod", _pod(f"wstorm-{c_}-{i}"))
    errors, lock = [], threading.Lock()
    start = threading.Barrier(n_clients)

    def drive(ci):
        rng = random.Random(4200 + ci)
        cli = BinaryWireClient("127.0.0.1", srv.port, timeout=30).connect()
        try:
            start.wait(timeout=20)
            for i in range(per):
                name = f"wstorm-{ci}-{i}"
                spec = _pod(name)
                bound = False
                for attempt in range(30):
                    try:
                        v = cli.filter_fused(spec, top_k=16,
                                             deadline_ms=10_000)
                    except WireOverloaded as e:
                        time.sleep(e.retry_after_s * rng.uniform(0.5, 1.5))
                        continue
                    except WireDeadline:
                        continue
                    scores = v.top_scores or []
                    if not scores:
                        time.sleep(0.01 * rng.uniform(0.5, 1.5))
                        continue
                    best = scores[0][1]
                    top = [h for h, s in scores if s == best]
                    node = top[rng.randrange(len(top))]
                    try:
                        r = cli.bind(name, "default", spec.uid, node,
                                     snapshot_gen=v.snapshot_gen,
                                     idem_key=f"{name}:{attempt}", pod=spec)
                    except WireOverloaded as e:
                        time.sleep(e.retry_after_s * rng.uniform(0.5, 1.5))
                        continue
                    if r.ok:
                        bound = True
                        break
                    if r.retryable:
                        time.sleep(r.retry_after_s * rng.uniform(0.5, 1.5))
                        continue
                    if "already assigned" in r.error:
                        bound = True  # landed earlier; store is truth
                        break
                    if r.kind == "error":
                        # ambiguous: same key converges via the ledger
                        r2 = cli.bind(name, "default", spec.uid, node,
                                      idem_key=f"{name}:{attempt}",
                                      pod=spec)
                        if r2.ok or "already assigned" in r2.error:
                            bound = True
                            break
                    # clean failure / shed: fresh attempt, fresh key
                if not bound:
                    raise AssertionError(f"{name} never bound")
        except Exception as e:  # noqa: BLE001 — surfaced below
            with lock:
                errors.append(f"client {ci}: {type(e).__name__}: {e}")
        finally:
            cli.close()

    threads = [threading.Thread(target=drive, args=(ci,))
               for ci in range(n_clients)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        srv.stop()
    assert not errors, errors
    pods, _rv = api.list("Pod")
    storm = [p for p in pods if p.name.startswith("wstorm-")]
    assert len(storm) == n_clients * per
    assert all(p.node_name for p in storm)
    first_node = {}
    for e in api._log:
        if e.kind == "Pod" and e.type == "MODIFIED" and e.obj.node_name \
                and e.obj.name.startswith("wstorm-"):
            prev = first_node.setdefault(e.obj.name, e.obj.node_name)
            assert prev == e.obj.node_name, \
                f"duplicate bind: {e.obj.name} -> {prev} AND " \
                f"{e.obj.node_name}"
    assert faulty.injected_failures + faulty.injected_timeouts > 0
    snap = _counters(backend)
    assert snap.get("bind_errors", 0) > 0  # faults really exercised
    assert snap.get("wire_batches", 0) >= 1


# ------------------------------------------------------- backpressure


def test_wire_overloaded_frame_past_pending_bound():
    backend, srv = _serve(max_pending=1)
    entered = threading.Event()
    release = threading.Event()
    real = backend._eval_many

    def slow(pods):
        entered.set()
        release.wait(timeout=10)
        return real(pods)

    backend._eval_many = slow
    results, overloads, lock = [], [], threading.Lock()

    def drive(i):
        cli = BinaryWireClient("127.0.0.1", srv.port, timeout=30).connect()
        try:
            v = cli.filter_fused(_pod(f"ovl-{i}"), top_k=4)
            with lock:
                results.append(v.passed_count)
        except WireOverloaded as e:
            assert e.retry_after_s > 0
            with lock:
                overloads.append(e)
        finally:
            cli.close()

    try:
        # leader batch: popped off the pending list, stalls in the worker
        t1 = threading.Thread(target=drive, args=(0,))
        t1.start()
        assert entered.wait(timeout=10)
        # fills the one pending slot behind the stalled batch
        t2 = threading.Thread(target=drive, args=(1,))
        t2.start()
        deadline = time.monotonic() + 10
        while len(srv._pend) < 1:
            assert time.monotonic() < deadline, "ticket never queued"
            time.sleep(0.002)
        # ...and everything past the bound sheds with the typed frame
        for i in range(2, 6):
            drive(i)
        release.set()
        t1.join(timeout=30)
        t2.join(timeout=30)
    finally:
        backend._eval_many = real
        srv.stop()
    assert len(overloads) == 4, overloads
    assert sorted(results) == [N_NODES, N_NODES]
    assert _counters(backend).get("admission_shed", 0) == 4


def test_wire_deadline_sheds_queued_dead_work():
    backend, srv = _serve()
    entered = threading.Event()
    release = threading.Event()
    real = backend._eval_many

    def slow(pods):
        entered.set()
        release.wait(timeout=10)
        return real(pods)

    backend._eval_many = slow
    outcomes, lock = [], threading.Lock()

    def drive(i, deadline_ms):
        cli = BinaryWireClient("127.0.0.1", srv.port, timeout=30).connect()
        try:
            cli.filter_fused(_pod(f"dl-{i}"), top_k=4,
                             deadline_ms=deadline_ms)
            with lock:
                outcomes.append("served")
        except WireDeadline:
            with lock:
                outcomes.append("shed")
        finally:
            cli.close()

    try:
        t1 = threading.Thread(target=drive, args=(0, 0))
        t1.start()
        assert entered.wait(timeout=10)
        # queued behind the stalled batch with a 1ms deadline: by the
        # time the next batch forms it is queued-dead and must shed
        t2 = threading.Thread(target=drive, args=(1, 1))
        t2.start()
        deadline = time.monotonic() + 10
        while len(srv._pend) < 1:
            assert time.monotonic() < deadline, "ticket never queued"
            time.sleep(0.002)
        time.sleep(0.05)  # let the 1ms deadline expire while queued
        release.set()
        t1.join(timeout=30)
        t2.join(timeout=30)
    finally:
        backend._eval_many = real
        srv.stop()
    assert sorted(outcomes) == ["served", "shed"]
    assert _counters(backend).get("deadline_shed", 0) >= 1


# ------------------------------------------------------------ frame fuzz


def _raw(port: int) -> socket.socket:
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.settimeout(10)
    return s


def _recv_frames(sock, want: int = 1):
    dec = framing.FrameDecoder()
    frames = []
    while len(frames) < want:
        data = sock.recv(65536)
        if not data:
            break
        frames.extend(dec.feed(data))
    return frames


def test_fuzz_corrupt_length_answers_error_and_closes():
    backend, srv = _serve()
    try:
        s = _raw(srv.port)
        s.sendall(b"POST /filter HTTP/1.1\r\n\r\n")  # ASCII as u32: huge
        frames = _recv_frames(s)
        assert frames and frames[0][0] == framing.ERROR
        assert "FrameError" in framing.decode_error(frames[0][3])
        # stream desync: the server closes after the typed error
        assert s.recv(65536) == b""
        s.close()
        # the LOOP is not wedged: a fresh connection serves normally
        c = BinaryWireClient("127.0.0.1", srv.port).connect()
        assert c.filter_fused(_pod("after-fuzz"), top_k=4).passed_count \
            == N_NODES
        c.close()
        assert _counters(backend).get("wire_frame_errors", 0) >= 1
    finally:
        srv.stop()


def test_fuzz_poisoned_payload_keeps_connection():
    """A frame whose LENGTH is honest but whose payload lies (garbage pod
    blob) is a payload-scoped fault: typed ERROR, connection keeps
    serving — the head-of-line discipline of the HTTP unknown-path
    audit, on the binary wire."""
    backend, srv = _serve()
    try:
        s = _raw(srv.port)
        s.sendall(framing.encode_frame(framing.FILTER, 9, b"\xde\xad\xbe"))
        frames = _recv_frames(s)
        assert frames[0][0] == framing.ERROR and frames[0][2] == 9
        # same connection, valid request: still served
        s.sendall(framing.encode_frame(framing.PING, 10))
        frames = _recv_frames(s)
        assert frames[0][0] == framing.PONG and frames[0][2] == 10
        # unknown verb: typed too, connection still alive
        s.sendall(framing.encode_frame(0x55, 11))
        frames = _recv_frames(s)
        assert frames[0][0] == framing.ERROR
        assert "unknown verb" in framing.decode_error(frames[0][3])
        s.sendall(framing.encode_frame(framing.PING, 12))
        assert _recv_frames(s)[0][0] == framing.PONG
        s.close()
    finally:
        srv.stop()


def test_fuzz_truncated_and_interleaved_partial_writes():
    """Truncated frames (client dies mid-write) and partial writes
    dribbled byte-by-byte: the server reassembles honest streams and
    cleans up dishonest ones without wedging or leaking tickets."""
    backend, srv = _serve()
    try:
        # (a) dribble a VALID filter frame one byte at a time
        frame = framing.encode_frame(
            framing.FILTER, 21,
            framing.encode_filter_request(_pod("dribble"), 4, 10_000),
            flags=framing.FLAG_COMPACT)
        s = _raw(srv.port)
        for i in range(0, len(frame), 3):
            s.sendall(frame[i:i + 3])
            time.sleep(0.0005)
        frames = _recv_frames(s)
        assert frames[0][0] == framing.VERDICT and frames[0][2] == 21
        s.close()
        # (b) truncated mid-frame then the peer vanishes: no response
        # owed, nothing leaks
        s = _raw(srv.port)
        s.sendall(frame[:17])
        s.close()
        # (c) oversized declared length: typed error + close
        s = _raw(srv.port)
        s.sendall(struct.pack("!IBBI", framing.MAX_FRAME + 7,
                              framing.FILTER, 0, 1))
        frames = _recv_frames(s)
        assert frames and frames[0][0] == framing.ERROR
        s.close()
        # (d) random garbage soup, several connections
        rng = random.Random(0xFA22)
        for _ in range(5):
            s = _raw(srv.port)
            s.sendall(bytes(rng.randrange(256) for _ in range(257)))
            try:
                _recv_frames(s)  # error frame or straight close — either
            except OSError:
                pass
            s.close()
        # the loop survives it all and no ticket/in-flight state leaked
        c = BinaryWireClient("127.0.0.1", srv.port).connect()
        v = c.filter_fused(_pod("post-soup"), top_k=4)
        assert v.passed_count == N_NODES
        c.close()
        deadline = time.monotonic() + 5
        while (srv._pend or srv._inflight) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not srv._pend and srv._inflight == 0
    finally:
        srv.stop()


def test_client_rejects_mismatched_response_id():
    backend, srv = _serve()
    try:
        c = BinaryWireClient("127.0.0.1", srv.port).connect()
        # hand-roll a request whose id the client did not issue
        c._sock.sendall(framing.encode_frame(framing.PING, 999))
        with pytest.raises(WireError, match="response id"):
            c.ping()
        c.close()
    finally:
        srv.stop()

def test_client_surfaces_stream_level_error_message():
    """A corrupt length prefix makes the server answer ERROR with request
    id 0 (it cannot attribute an id to a desynced stream). The CLIENT
    must surface the server's message, not diagnose a bogus id
    mismatch."""
    backend, srv = _serve()
    try:
        c = BinaryWireClient("127.0.0.1", srv.port).connect()
        c._sock.sendall(b"GET / HTTP/1.1\r\n\r\n")  # ASCII as u32: huge
        with pytest.raises(WireError, match="FrameError"):
            c.ping()
        c.close()
    finally:
        srv.stop()


def test_stop_resolves_queued_bind_tickets():
    """stop() must resolve queued BIND tickets too (not only filters) and
    give the awaiting coroutines a loop cycle to write their ERROR
    responses — a blocking client must fail fast, not sit in recv()
    until its socket timeout."""
    import threading as _threading

    ev = _threading.Event()

    def slow_binder(name, ns, uid, node):
        ev.set()
        time.sleep(0.5)  # holds the dispatcher's worker round busy
        return ""

    backend, srv = _serve(binder=slow_binder, max_batch=1)
    outcomes = []

    def drive(i):
        c = BinaryWireClient("127.0.0.1", srv.port, timeout=30).connect()
        try:
            c.bind(f"stp-{i}", "default", f"u-{i}", "hollow-node-0",
                   idem_key=f"stp:{i}")
            outcomes.append("ok")
        except (WireError, OSError) as e:
            outcomes.append(str(e))
        finally:
            c.close()

    threads = [_threading.Thread(target=drive, args=(i,)) for i in range(3)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    assert ev.wait(10)  # first bind is ON the worker; others queue
    time.sleep(0.05)
    srv.stop()
    for t in threads:
        t.join(timeout=10)
    elapsed = time.perf_counter() - t0
    assert len(outcomes) == 3, outcomes
    # nobody waited out a socket timeout: the queued tickets resolved to
    # typed "server stopped" errors (or the in-flight one bound fine)
    assert elapsed < 10, elapsed
    assert all(o == "ok" or "server stopped" in o
               or "closed connection" in o for o in outcomes), outcomes


# ------------------------------------------------ tsan-lite storm leg


def test_lockcheck_leg_wire_scheduleone_bit_identical(monkeypatch):
    """scheduleOne over the binary wire with GRAFT_LOCKCHECK=1: the
    armed world (event loop, coalescer condition, fence, ledger, store
    condition — all checked twins) returns the same verdict, the same
    top scores, and a working idempotent bind, with zero recorded
    lock-discipline violations."""
    from kubernetes_tpu_torch.analysis import lockcheck

    pod = _pod("lc-wire")
    backend, srv = _serve()  # unarmed reference
    try:
        c = BinaryWireClient("127.0.0.1", srv.port).connect()
        want = c.filter_fused(pod, top_k=8, deadline_ms=10_000)
        c.close()
    finally:
        srv.stop()

    monkeypatch.setenv("GRAFT_LOCKCHECK", "1")
    lockcheck.reset()
    api = ApiServerLite()
    nodes = hollow_nodes(N_NODES)
    for n in nodes:
        api.create("Node", n)
    api.create("Pod", pod)  # the store binder binds STORE pods
    binder = extender_store_binder(FaultyBindApi(api))
    backend, srv = _serve(nodes=nodes, binder=binder)
    try:
        c = BinaryWireClient("127.0.0.1", srv.port).connect()
        v = c.filter_fused(pod, top_k=8, deadline_ms=10_000)
        assert v.passed_count == want.passed_count == N_NODES
        assert v.top_scores == want.top_scores  # bit-identical ranking
        node = v.top_scores[0][0]
        r = c.bind("lc-wire", "default", pod.uid, node,
                   snapshot_gen=v.snapshot_gen, idem_key="lc:1", pod=pod)
        assert r.ok, r
        pods0 = backend.cache.pod_count()
        r = c.bind("lc-wire", "default", pod.uid, node,
                   snapshot_gen=v.snapshot_gen, idem_key="lc:1", pod=pod)
        assert r.ok and backend.cache.pod_count() == pods0
        c.close()
    finally:
        srv.stop()
    lockcheck.assert_clean()


# ------------------------------------------------ cross-package interop


def _ref_serve(nodes):
    import kubernetes_tpu.server.asyncwire as jaw
    import kubernetes_tpu.server.embedded as jemb
    import kubernetes_tpu.server.extender as jext
    backend = jext.TPUExtenderBackend(stale_window_s=0.0,
                                      coalesce_window_s=0.0005)
    backend.sync_nodes(nodes)
    srv = jaw.AsyncBinaryServer(jemb.VerdictService(backend))
    srv.start()
    return srv


def _wire_sequence(client_cls, types, hollow, port):
    """One scripted scheduleOne session; every answer as plain data
    (retry hints are jittered per server, so only their sign is kept)."""
    small = hollow.hollow_nodes(6, seed=9)
    pods = [types.make_pod(f"io-{i}", cpu=300 * (i + 1),
                           memory=(256 << 20) * (i + 1)) for i in range(4)]
    big = types.make_pod("io-big", cpu=3900, memory=1 << 30)
    out = []

    def verdict(v):
        return (v.snapshot_gen, v.all_passed, v.passed_count, v.passed,
                v.failed, v.top_scores)

    def bound(r):
        return (r.kind, r.error, r.retry_after_s > 0)

    c = client_cls("127.0.0.1", port, timeout=30).connect()
    try:
        c.ping()
        out.append(c.sync_nodes(small))
        for p in pods:
            v = c.filter_fused(p, top_k=4, deadline_ms=10_000)
            out.append(verdict(v))
            node = v.top_scores[0][0]
            out.append(bound(c.bind(p.name, p.namespace, p.uid, node,
                                    snapshot_gen=v.snapshot_gen,
                                    idem_key=f"{p.name}:1", pod=p)))
            # the idempotent replay answers the recorded outcome
            out.append(bound(c.bind(p.name, p.namespace, p.uid, node,
                                    snapshot_gen=v.snapshot_gen,
                                    idem_key=f"{p.name}:1", pod=p)))
        v = c.filter_fused(big, top_k=6)
        out.append(verdict(v))
        # a stale-generation commit onto a node the session filled
        out.append(bound(c.bind("io-big", "default", big.uid,
                                small[0].name, snapshot_gen=0,
                                idem_key="io-big:1", pod=big)))
        nodes, bound_pods = c.relist()
        out.append(([n.name for n in nodes],
                    sorted((p.name, p.node_name) for p in bound_pods)))
    finally:
        c.close()
    return out


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "port"), ("port", "ref"), ("ref", "port")])
def test_interop_answers_equal_the_same_package_run(client_pkg, server_pkg):
    import kubernetes_tpu.api.types as jt
    import kubernetes_tpu.client.binarywire as jbw
    import kubernetes_tpu.models.hollow as jh
    import kubernetes_tpu_torch.api.types as tt
    import kubernetes_tpu_torch.client.binarywire as tbw
    import kubernetes_tpu_torch.models.hollow as th
    pkgs = {"ref": (jbw.BinaryWireClient, jt, jh),
            "port": (tbw.BinaryWireClient, tt, th)}

    def run(cp, sp):
        cls, types, hollow = pkgs[cp]
        nodes = pkgs[sp][2].hollow_nodes(N_NODES)
        if sp == "ref":
            srv = _ref_serve(nodes)
        else:
            _b, srv = _serve(nodes=nodes, stale_window_s=0.0)
        try:
            return _wire_sequence(cls, types, hollow, srv.port)
        finally:
            srv.stop()

    want = run("ref", "ref")
    got = run(client_pkg, server_pkg)
    assert got == want
    assert any(r[0] == "conflict" for r in want
               if isinstance(r, tuple) and len(r) == 3
               and isinstance(r[0], str))


# -------------------------------------------- stop() and open clients


@pytest.mark.parametrize("left_open", [0, 2])
def test_stop_cancels_and_counts_open_connections(left_open):
    """The reference's straggler contract (tests/test_multiproc.py): every
    connection still open at stop() is cancelled and counted, stop()
    returns promptly and the loop thread is gone; clean closes leave
    nothing to cancel."""
    backend, srv = _serve()
    clients = [BinaryWireClient("127.0.0.1", srv.port).connect()
               for _ in range(2)]
    for c in clients:
        c.ping()
    for c in clients[left_open:]:
        c.close()
    deadline = time.monotonic() + 5
    while len(srv._conn_tasks) > left_open and time.monotonic() < deadline:
        time.sleep(0.01)
    thread = srv._thread
    t0 = time.monotonic()
    srv.stop()
    took = time.monotonic() - t0
    try:
        assert took < 2.0, took
        assert srv.cancelled_conn_tasks == left_open
        assert not thread.is_alive()
    finally:
        for c in clients[:left_open]:
            c.close()
