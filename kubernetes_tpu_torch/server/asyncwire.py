"""Single-threaded async event loop speaking the binary fleet framing
— the transport that kills the thread-per-connection wall.

Profiled: a NO-OP ThreadingHTTPServer with 100 in-process clients
measures ~196 req/s on the 2-core box — ~200 Python threads in GIL
rotation IS the platform wall, and the fleet saturates it ~25x below the
service's measured in-process capacity. This server replaces the
thread-per-connection model with ONE asyncio event loop owning every
socket: accepts, reads, frame parsing and response writes all run on the
loop thread; the only other threads are a small bounded executor where
the service core's evaluations and commits run (they take the backend
lock and touch the device — they cannot run on the loop without wedging
it).

Group-commit batching AT the transport: concurrent FILTER frames from
different connections pile into one pending list; a single dispatcher
task drains it in batches of ``max_batch`` through
``VerdictService.eval_batch`` — ONE fused [C, N] dispatch per batch,
exactly the thread coalescer's leader/follower economics without parking
a thread per request. While a batch is on the device, new arrivals
queue and ride the next batch (a lone client never waits). BIND frames
ride the SAME pump cycle: at fleet load a per-bind executor hop costs
more event-loop/GIL churn than the ~0.2 ms fenced commit itself, so
commits batch onto the dispatcher's worker round too (measured: the
100-client fleet's p99 request latency dropped ~3x when binds joined
the pump). Pod spec blobs decode ONCE per spec on the worker — never on
the event loop — through a bounded LRU shared by both verbs and every
retry.

The robustness envelope carries over VERBATIM — it lives below the
transport (server/embedded.py docstring):

  - BACKPRESSURE: bounded pending queues (filters AND binds) + in-flight
    cap (syncs); past any, the typed OVERLOADED frame answers with
    a jittered retry-after-ms (the HTTP 429 + Retry-After twin — a fleet
    shed together must not return together).
  - DEADLINES: the frame's deadline field sheds queued-dead work at
    batch formation (DEADLINE frame, nothing evaluated) and rides into
    bind_verdict for the commit side.
  - IDEMPOTENCY: the BIND frame carries the ledger key; replay semantics
    are bind_verdict's, untouched.
  - FRAMING FAULTS: a payload-level decode error answers a typed ERROR
    frame and the connection continues; a corrupt length prefix is an
    unrecoverable stream desync — the connection closes (the client
    reconnects; every verb is idempotent or ledger-keyed). Neither path
    can wedge the loop or leak a pending ticket: every queued ticket is
    resolved by the dispatcher regardless of its connection's fate
    (tests/test_framing.py + test_asyncwire.py fuzz this).

This module is pure HOST-side plumbing: it imports no torch and fetches
no device values — all device work happens behind the service core's
seams.
"""

from __future__ import annotations

import asyncio
import random
import threading
from kubernetes_tpu_torch.analysis import lockcheck
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

from kubernetes_tpu_torch.server import framing
from kubernetes_tpu_torch.server.embedded import VerdictService


class _Ticket:
    __slots__ = ("blob", "top_k", "compact", "deadline_s", "arrival", "fut")

    def __init__(self, blob, top_k, compact, deadline_s, arrival, fut):
        self.blob = blob  # raw spec blob; decoded (cached) on the worker
        self.top_k = top_k
        self.compact = compact
        self.deadline_s = deadline_s
        self.arrival = arrival
        self.fut = fut


class _BindTicket:
    __slots__ = ("args", "deadline_s", "blob", "arrival", "fut", "tid")

    def __init__(self, args, deadline_s, blob, arrival, fut, tid=None):
        self.args = args  # (name, ns, uid, node, gen, idem_key)
        self.deadline_s = deadline_s
        self.blob = blob
        self.arrival = arrival
        self.fut = fut
        self.tid = tid  # pod-trace context, None untraced


class AsyncBinaryServer:
    """The binary fleet wire over one VerdictService.

    start() spins the event loop on a daemon thread and binds the
    listener; stop() tears both down. ``port`` is live after start()."""

    def __init__(self, service: VerdictService, host: str = "127.0.0.1",
                 port: int = 0, max_batch: int = 64,
                 max_pending: int = 512, max_inflight: int = 256,
                 workers: int = 4,
                 max_frame: int = framing.MAX_FRAME):
        self.service = service
        self.host = host
        self._want_port = port
        self.port: int = 0
        self.max_batch = max(int(max_batch), 1)
        self.max_pending = max(int(max_pending), 1)
        self.max_inflight = max(int(max_inflight), 1)
        self.max_frame = max_frame
        # loop-thread-only state: the event loop is single-threaded, so
        # none of these need locks — that absence IS the design
        self._pend: List[_Ticket] = []
        self._bind_pend: List[_BindTicket] = []
        # tickets currently ON the worker (popped from the pend lists):
        # stop() must resolve these too — once the loop halts, the pump
        # can never resume to answer them
        self._inflight_tickets: List = []
        self._inflight = 0
        self._pump_task: Optional[asyncio.Task] = None
        self._rng = random.Random(0xA51C)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._pool = ThreadPoolExecutor(
            max_workers=max(int(workers), 2),
            thread_name_prefix="asyncwire")
        # decoded-pod LRU keyed on the raw spec blob: a fleet scheduleOne
        # ships the SAME blob on /filter, /bind and every retry, so the
        # (comparatively expensive) pod decode runs once per spec, on a
        # WORKER — never on the event loop — and the shared Pod object
        # keeps its key/class-hash memos warm across verbs
        self._pod_cache: "OrderedDict[bytes, object]" = OrderedDict()
        self._pod_cache_lock = lockcheck.make_lock("AsyncBinaryServer._pod_cache_lock")
        self.pod_cache_max = 8192
        # live per-connection reader tasks (loop-thread-only, like the
        # pend lists): teardown() cancels these explicitly — loop.stop()
        # alone strands them pending forever, which leaks a task (and
        # its reader/writer transports) per worker process that ever
        # connected
        self._conn_tasks: set = set()
        # observable leak count: how many connection tasks were still
        # alive (and had to be cancelled) at teardown — tests assert 0
        # after a clean client close, and that stop() drains stragglers
        self.cancelled_conn_tasks = 0

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        ready = threading.Event()

        def run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop

            async def boot():
                self._server = await asyncio.start_server(
                    self._client, self.host, self._want_port)
                self.port = self._server.sockets[0].getsockname()[1]
                ready.set()

            loop.run_until_complete(boot())
            try:
                loop.run_forever()
            finally:
                loop.run_until_complete(loop.shutdown_asyncgens())
                loop.close()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="asyncwire-loop")
        self._thread.start()
        if not ready.wait(timeout=10):
            raise RuntimeError("asyncwire server failed to start")

    def stop(self) -> None:
        loop = self._loop
        if loop is None:
            return

        async def teardown():
            if self._server is not None:
                self._server.close()
            # resolve anything queued OR on the worker — FILTERs and
            # BINDs — so no ticket leaks into a future nobody will
            # complete (an in-flight bind may still LAND downstream:
            # that is the at-most-once ambiguity the client's ledger-key
            # replay converges, same as any ambiguous bind error)
            for t in (self._pend + self._bind_pend
                      + self._inflight_tickets):
                if not t.fut.done():
                    t.fut.set_result((framing.ERROR,
                                      framing.encode_error("server stopped")))
            self._pend.clear()
            self._bind_pend.clear()
            # the set_result wakeups are queued behind this coroutine:
            # yield so the awaiting _handle coroutines resume and write
            # their ERROR responses BEFORE the loop dies (otherwise a
            # blocking client sits in recv() for its full timeout)
            await asyncio.sleep(0)
            await asyncio.sleep(0)
            # cancel surviving connection reader tasks — without this,
            # loop.stop() leaves every still-connected client's _client
            # task pending forever (the reader-task leak): the task, its
            # transports and its buffers outlive the server object
            stragglers = [t for t in self._conn_tasks if not t.done()]
            self.cancelled_conn_tasks = len(stragglers)
            for t in stragglers:
                t.cancel()
            if stragglers:
                await asyncio.gather(*stragglers, return_exceptions=True)
            # only now: since Python 3.12 wait_closed() waits for every
            # open connection, so awaited before the cancel above it
            # blocks while a client stays connected (stop() then gives
            # up at its join with the loop thread still running)
            if self._server is not None:
                await self._server.wait_closed()
            loop.stop()

        asyncio.run_coroutine_threadsafe(teardown(), loop)
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._pool.shutdown(wait=False)
        self._loop = None

    # ------------------------------------------------------------- helpers

    def _count(self, name: str, n: int = 1) -> None:
        count = getattr(self.service.backend, "_count", None)
        if count is not None:
            count(name, n)

    def _retry_ms(self) -> int:
        # jittered so a fleet shed together does not return together
        return self._rng.randint(5, 40)

    @staticmethod
    def _trace_hop(trace_id: str, hop_verb: int) -> None:
        """Pod-trace context honor: one WIRE_HOP stamp on the
        pod's timeline — host-pure, one lock, safe on the event loop
        (the tracer off is one attribute check)."""
        from kubernetes_tpu_torch.observability import podtrace
        if podtrace.TRACER.enabled:
            podtrace.TRACER.wire_hop(trace_id, podtrace.WIRE_BINARY,
                                     hop_verb)

    def _decode_pod(self, blob: bytes):
        """Worker-side cached pod decode (constructor comment)."""
        if not blob:
            return None
        with self._pod_cache_lock:
            pod = self._pod_cache.get(blob)
            if pod is not None:
                self._pod_cache.move_to_end(blob)
                return pod
        pod = framing.decode_pod_blob(blob)
        with self._pod_cache_lock:
            self._pod_cache[blob] = pod
            while len(self._pod_cache) > self.pod_cache_max:
                self._pod_cache.popitem(last=False)
        return pod

    # ------------------------------------------------------- connection IO

    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
        dec = framing.FrameDecoder(self.max_frame)
        try:
            while True:
                data = await reader.read(65536)
                if not data:
                    break
                try:
                    frames = dec.feed(data)
                except framing.FrameError as e:
                    # stream desync (corrupt length): typed ERROR, then
                    # close — the client reconnects and replays
                    self._count("wire_frame_errors")
                    writer.write(framing.encode_frame(
                        framing.ERROR, 0,
                        framing.encode_error(f"FrameError: {e}")))
                    await writer.drain()
                    break
                for verb, flags, req_id, payload in frames:
                    await self._dispatch(verb, flags, req_id, payload,
                                         writer)
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass  # a dead peer is a fleet norm, not a server error
        except Exception:
            # an unexpected escape must never take the accept loop down
            self._count("wire_conn_errors")
        finally:
            if task is not None:
                self._conn_tasks.discard(task)
            try:
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, verb: int, flags: int, req_id: int,
                        payload: bytes,
                        writer: asyncio.StreamWriter) -> None:
        """One frame -> one response frame, errors typed in-band."""
        try:
            rverb, rpayload = await self._handle(verb, flags, payload)
        except framing.FrameError as e:
            # payload-scoped decode fault: the STREAM is intact (the
            # length prefix was valid) — answer typed, keep serving
            self._count("wire_frame_errors")
            rverb, rpayload = framing.ERROR, framing.encode_error(
                f"FrameError: {e}")
        except Exception as e:  # typed in-band, like the HTTP 500 path
            rverb, rpayload = framing.ERROR, framing.encode_error(
                f"{type(e).__name__}: {e}")
        try:
            writer.write(framing.encode_frame(rverb, req_id, rpayload))
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass  # client gave up; its ticket was already resolved

    # ---------------------------------------------------------- verb logic

    async def _handle(self, verb: int, flags: int,
                      payload: bytes) -> Tuple[int, bytes]:
        loop = self._loop
        assert loop is not None
        if verb == framing.PING:
            return framing.PONG, b""
        if verb == framing.FILTER:
            if len(self._pend) >= self.max_pending:
                self._count("admission_shed")
                return framing.OVERLOADED, framing.encode_overloaded(
                    self._retry_ms())
            tid, payload = framing.unwrap_trace(payload, flags)
            if tid is not None:
                self._trace_hop(tid, 0)
            # LAZY parse: header fields only — the pod blob decodes on
            # the worker (cached), never on the event loop
            blob, top_k, deadline_ms = \
                framing.decode_filter_request_lazy(payload)
            fut: asyncio.Future = loop.create_future()
            self._pend.append(_Ticket(
                blob, top_k, bool(flags & framing.FLAG_COMPACT),
                deadline_ms / 1e3 if deadline_ms else None,
                loop.time(), fut))
            if self._pump_task is None or self._pump_task.done():
                self._pump_task = loop.create_task(self._pump())
            return await fut
        if verb == framing.BIND:
            # binds ride the SAME pump cycle as filters: at fleet load a
            # per-bind executor hop costs more loop/GIL churn than the
            # ~0.2 ms commit itself — group-commit batching for the
            # commit side too. The queue is bounded like the filter side.
            if len(self._bind_pend) >= self.max_inflight:
                self._count("admission_shed")
                return framing.OVERLOADED, framing.encode_overloaded(
                    self._retry_ms())
            tid, payload = framing.unwrap_trace(payload, flags)
            if tid is not None:
                self._trace_hop(tid, 1)
            (name, ns, uid, node, gen, idem_key, deadline_ms,
             blob) = framing.decode_bind_request_lazy(payload)
            fut = loop.create_future()
            self._bind_pend.append(_BindTicket(
                (name, ns, uid, node, gen, idem_key),
                deadline_ms / 1e3 if deadline_ms else None,
                blob, loop.time(), fut, tid=tid))
            if self._pump_task is None or self._pump_task.done():
                self._pump_task = loop.create_task(self._pump())
            return await fut
        if verb in (framing.SYNC_NODES, framing.SYNC_PODS):
            if self._inflight >= self.max_inflight:
                self._count("admission_shed")
                return framing.OVERLOADED, framing.encode_overloaded(
                    self._retry_ms())
            kind = "nodes" if verb == framing.SYNC_NODES else "pods"
            self._inflight += 1
            try:
                n = await loop.run_in_executor(
                    self._pool, lambda: self._sync(kind, payload))
            finally:
                self._inflight -= 1
            return framing.SYNCED, framing.encode_synced(n)
        if verb == framing.METRICS:
            text = await loop.run_in_executor(self._pool,
                                              self.service.metrics_text)
            return framing.METRICS_TEXT, framing.encode_metrics_text(text)
        if verb == framing.RELIST:
            # bounded-stale snapshot pull: a freshly spawned
            # scheduler process hydrates its local cache from store
            # truth in one round trip. The backend walk takes the
            # backend lock — off the event loop like every service touch
            nodes, pods = await loop.run_in_executor(
                self._pool, self.service.relist)
            return (framing.RELIST_RESULT,
                    framing.encode_relist_result(nodes, pods))
        if verb == framing.CELL_AGG:
            # federation pull: fold-and-answer the cell's
            # routing column; drain/evacuate mutate the store — off the
            # event loop like every service touch
            fn = getattr(self.service, "cell_aggregate", None)
            if fn is None:
                return framing.ERROR, framing.encode_error(
                    "service has no federation tier")
            drain, evac = framing.decode_cell_agg_request(payload)
            agg, spilled = await loop.run_in_executor(
                self._pool,
                lambda: fn(drain_spill=drain, evacuate=evac))
            return (framing.CELL_AGG_RESULT,
                    framing.encode_cell_agg_result(agg, spilled))
        if verb == framing.ADMIT:
            fn = getattr(self.service, "admit", None)
            if fn is None:
                return framing.ERROR, framing.encode_error(
                    "service has no federation tier")
            if self._inflight >= self.max_inflight:
                self._count("admission_shed")
                return framing.OVERLOADED, framing.encode_overloaded(
                    self._retry_ms())
            self._inflight += 1
            try:
                # decode on the worker: a router batch blob must not
                # stall every connection's reads while it parses
                accepted, replayed = await loop.run_in_executor(
                    self._pool, lambda: fn(*framing.decode_admit_request(
                        payload)))
            finally:
                self._inflight -= 1
            return (framing.ADMIT_RESULT,
                    framing.encode_admit_result(accepted, replayed))
        if verb == framing.STATS:
            # live introspection: the registry snapshot takes
            # per-source locks — off the event loop like every other
            # service touch
            last = framing.decode_stats_request(payload)
            snap = await loop.run_in_executor(
                self._pool, lambda: self.service.debug_snapshot(last))
            return framing.STATS_RESULT, framing.encode_stats_result(snap)
        raise framing.FrameError(f"unknown verb 0x{verb:02x}")

    def _sync(self, kind: str, payload: bytes) -> int:
        # decode runs on the worker too: a multi-MB sync blob must not
        # stall every connection's reads while it parses
        items = framing.decode_items_blob(payload, kind)
        if kind == "nodes":
            return self.service.sync_nodes(items)
        return self.service.sync_pods(items)

    # ----------------------------------------------------- filter dispatch

    async def _pump(self) -> None:
        """The single dispatcher: drain pending FILTER and BIND tickets
        in fused batches — one executor round per cycle. One batch on
        the device at a time; arrivals during a batch ride the next one
        (group-commit on both the verdict and the commit side)."""
        loop = self._loop
        assert loop is not None
        while self._pend or self._bind_pend:
            batch = self._pend[:self.max_batch]
            del self._pend[:len(batch)]
            binds = self._bind_pend[:self.max_batch]
            del self._bind_pend[:len(binds)]
            now = loop.time()
            live = []
            for t in batch:
                if t.deadline_s is not None \
                        and now - t.arrival > t.deadline_s:
                    self._count("deadline_shed")
                    if not t.fut.done():
                        t.fut.set_result((framing.DEADLINE, b""))
                else:
                    live.append(t)
            live_b = []
            for t in binds:
                if t.deadline_s is not None \
                        and now - t.arrival > t.deadline_s:
                    # queued-dead commit: shed BEFORE the fence — nothing
                    # happened, a same-key retry starts fresh
                    self._count("deadline_shed")
                    if not t.fut.done():
                        t.fut.set_result((framing.DEADLINE, b""))
                else:
                    live_b.append(t)
            if not live and not live_b:
                continue
            if live:
                self._count("wire_batches")
                self._count("wire_requests", len(live))
            items = [(t.blob, t.top_k, t.compact) for t in live]
            bitems = [(t.args, t.deadline_s, t.blob, now - t.arrival,
                       t.tid) for t in live_b]
            self._inflight_tickets = live + live_b
            try:
                results, bresults = await loop.run_in_executor(
                    self._pool,
                    lambda: (self._eval_encode(items),
                             self._bind_encode(bitems)))
            except Exception as e:  # a dying dispatcher must resolve its
                # tickets — an unresolved future is a wedged connection
                self._count("wire_conn_errors")
                err = (framing.ERROR, framing.encode_error(
                    f"{type(e).__name__}: {e}"))
                results = [err] * len(live)
                bresults = [err] * len(live_b)
            for t, r in zip(live, results):
                if not t.fut.done():
                    t.fut.set_result(r)
            for t, r in zip(live_b, bresults):
                if not t.fut.done():
                    t.fut.set_result(r)
            self._inflight_tickets = []

    def _bind_encode(self, bitems) -> List[Tuple[int, bytes]]:
        """Worker-side bind batch: cached decode + the fenced commit per
        ticket, faults isolated per ticket. The binder write inside
        bind_verdict runs outside the backend lock but inside this
        worker round — co-located/in-process binders (the deployment
        this wire serves; a remote apiserver amortizes through
        bind_pods_bulk upstream) keep the round short."""
        from kubernetes_tpu_torch.server.embedded import VerdictService
        res: List[Tuple[int, bytes]] = []
        for (args, deadline_s, blob, waited, tid) in bitems:
            name, ns, uid, node, gen, idem_key = args
            try:
                remaining = None if deadline_s is None \
                    else max(deadline_s - waited, 0.0)
                r = self.service.bind(
                    name, ns, uid, node, snapshot_gen=gen,
                    idem_key=idem_key, deadline_s=remaining,
                    pod=self._decode_pod(blob))
                if tid and r.kind == "ok":
                    # complete the wire-path trace (embedded.py
                    # trace_bound docstring): no scheduler bind path
                    # exists here to terminate the timeline
                    VerdictService.trace_bound(tid)
                res.append((framing.BIND_RESULT, framing.encode_bind_result(
                    r.kind, max(int(r.retry_after_s * 1e3), 1)
                    if r.retry_after_s else 0, r.error)))
            except framing.FrameError as e:
                self._count("wire_frame_errors")
                res.append((framing.ERROR, framing.encode_error(
                    f"FrameError: {e}")))
            except Exception as e:  # noqa: BLE001 — ticket-isolated
                res.append((framing.ERROR, framing.encode_error(
                    f"{type(e).__name__}: {e}")))
        return res

    def _eval_encode(self, items) -> List[Tuple[int, bytes]]:
        """Worker-side batch body: cached pod decode + one fused eval +
        per-ticket response encoding, all off the event loop thread. A
        ticket whose blob will not decode gets its typed error without
        voiding the rest of the batch."""
        decoded: List = []
        outs: List = [None] * len(items)
        for idx, (blob, _k, _c) in enumerate(items):
            try:
                pod = self._decode_pod(blob)
                if pod is None:
                    raise framing.FrameError("empty pod blob")
                decoded.append((idx, pod))
            except Exception as e:  # noqa: BLE001 — per-ticket fault
                outs[idx] = e
        if decoded:
            evals = self.service.eval_batch([p for _i, p in decoded])
            for (idx, _p), v in zip(decoded, evals):
                outs[idx] = v
        res: List[Tuple[int, bytes]] = []
        for (blob, top_k, compact), v in zip(items, outs):
            if isinstance(v, Exception):
                res.append((framing.ERROR, framing.encode_error(
                    f"{type(v).__name__}: {v}")))
                continue
            try:
                fv = self.service.finish_filter(v, top_k=top_k,
                                                compact=compact)
                res.append((framing.VERDICT, framing.encode_verdict(
                    fv.snapshot_gen, fv.all_passed, fv.passed_count,
                    fv.passed, sorted(fv.failed), fv.top_scores or [])))
            except Exception as e:  # ticket-isolated: one bad verdict
                # must not void the whole batch's responses
                res.append((framing.ERROR, framing.encode_error(
                    f"{type(e).__name__}: {e}")))
        return res


__all__ = ["AsyncBinaryServer"]
