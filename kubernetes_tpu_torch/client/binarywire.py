"""Blocking binary fleet client: one frontend's connection to
the async binary wire (server/asyncwire.py), speaking server/framing.py.

One client is one scheduler's serial scheduleOne loop — request/response
on a persistent connection, like the keep-alive HTTP clients it
replaces. Typed outcomes mirror the service core's contract:

  - ``filter_fused`` returns a FilterVerdict (top scores of the same
    coalesced verdict — a fleet scheduleOne is TWO round trips);
  - ``bind`` returns a BindResult (ok/conflict/pending/shed/error with
    the server's jittered retry-after);
  - an OVERLOADED frame raises the typed ``WireOverloaded`` carrying
    retry_after_s — the caller throttles THIS step and retries, exactly
    the 429 discipline;
  - a DEADLINE frame raises ``WireDeadline`` (nothing was evaluated).

Reconnect-and-replay is the CALLER's move (bench drivers do it on socket
errors): filter is an idempotent read and bind carries its ledger key,
so a re-send of the same body is exactly the replay path the service
exists to absorb.
"""

from __future__ import annotations

import socket
from typing import List, Optional, Tuple

from kubernetes_tpu_torch.server import framing
from kubernetes_tpu_torch.server.embedded import BindResult, FilterVerdict


class WireOverloaded(Exception):
    """Typed OVERLOADED frame: retry this step after retry_after_s."""

    def __init__(self, retry_after_s: float):
        super().__init__(f"server overloaded; retry after "
                         f"{retry_after_s * 1e3:.0f}ms")
        self.retry_after_s = retry_after_s


class WireDeadline(Exception):
    """Typed DEADLINE frame: the request outlived its own deadline."""


class WireError(Exception):
    """Typed ERROR frame or protocol violation."""


class BinaryWireClient:
    """One serial connection to an AsyncBinaryServer."""

    def __init__(self, host: str, port: int, timeout: float = 60.0,
                 max_frame: int = framing.MAX_FRAME):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.max_frame = max_frame
        self._sock: Optional[socket.socket] = None
        self._dec = framing.FrameDecoder(max_frame)
        self._req_id = 0

    # ------------------------------------------------------------ plumbing

    def connect(self) -> "BinaryWireClient":
        self.close()
        s = socket.create_connection((self.host, self.port),
                                     timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        self._dec = framing.FrameDecoder(self.max_frame)
        return self

    def close(self) -> None:
        if self._sock is not None:
            try:
                # shutdown() before close() delivers EOF to the server's
                # reader NOW: without it, a worker process exiting with
                # a live connection leaves the server's per-connection
                # reader task parked in read() until teardown cancels it
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _roundtrip(self, verb: int, payload: bytes = b"",
                   flags: int = 0) -> Tuple[int, bytes]:
        if self._sock is None:
            self.connect()
        assert self._sock is not None
        self._req_id = (self._req_id + 1) & 0xFFFFFFFF
        req_id = self._req_id
        self._sock.sendall(framing.encode_frame(verb, req_id, payload,
                                                flags))
        while True:
            frames = self._dec.feed(self._recv())
            for rverb, _rflags, rid, rpayload in frames:
                if rid != req_id:
                    if rverb == framing.ERROR:
                        # stream-level fault: the server could not
                        # attribute a request id (corrupt length prefix,
                        # oversized frame) and answers with id 0 before
                        # closing — surface ITS message, not a bogus
                        # id-mismatch diagnosis
                        raise WireError(framing.decode_error(rpayload))
                    # a serial client never has two in flight: a stray id
                    # is a protocol violation, not something to skip past
                    raise WireError(f"response id {rid} != request "
                                    f"{req_id}")
                return self._typed(rverb, rpayload)

    def _recv(self) -> bytes:
        assert self._sock is not None
        data = self._sock.recv(65536)
        if not data:
            raise ConnectionError("server closed connection")
        return data

    @staticmethod
    def _typed(verb: int, payload: bytes) -> Tuple[int, bytes]:
        if verb == framing.OVERLOADED:
            raise WireOverloaded(framing.decode_overloaded(payload) / 1e3)
        if verb == framing.DEADLINE:
            raise WireDeadline("request shed past its deadline")
        if verb == framing.ERROR:
            raise WireError(framing.decode_error(payload))
        return verb, payload

    # --------------------------------------------------------------- verbs

    def ping(self) -> None:
        verb, _ = self._roundtrip(framing.PING)
        if verb != framing.PONG:
            raise WireError(f"unexpected verb 0x{verb:02x} to PING")

    def filter_fused(self, pod, top_k: int = 32, deadline_ms: int = 0,
                     compact: bool = True,
                     pod_blob: Optional[bytes] = None,
                     trace_ctx: Optional[str] = None) -> FilterVerdict:
        body = framing.encode_filter_request(pod, top_k=top_k,
                                             deadline_ms=deadline_ms,
                                             pod_blob=pod_blob)
        flags = framing.FLAG_COMPACT if compact else 0
        if trace_ctx:
            # pod-trace context: this hop joins the pod's
            # timeline server-side
            body = framing.wrap_trace(body, trace_ctx)
            flags |= framing.FLAG_TRACE
        verb, payload = self._roundtrip(framing.FILTER, body, flags=flags)
        if verb != framing.VERDICT:
            raise WireError(f"unexpected verb 0x{verb:02x} to FILTER")
        d = framing.decode_verdict(payload)
        return FilterVerdict(
            snapshot_gen=d["gen"], all_passed=d["all_passed"],
            passed_count=d["passed_count"],
            passed=None if (compact and d["all_passed"]) else d["passed"],
            failed={nm: "failed TPU predicate kernel"
                    for nm in d["failed"]},
            top_scores=d["top"])

    def bind(self, pod_name: str, namespace: str, uid: str, node: str,
             snapshot_gen: Optional[int] = None, idem_key: str = "",
             deadline_ms: int = 0, pod=None,
             pod_blob: Optional[bytes] = None,
             trace_ctx: Optional[str] = None) -> BindResult:
        body = framing.encode_bind_request(
            pod_name, namespace, uid, node, snapshot_gen=snapshot_gen,
            idem_key=idem_key, deadline_ms=deadline_ms, pod=pod,
            pod_blob=pod_blob)
        flags = 0
        if trace_ctx:
            body = framing.wrap_trace(body, trace_ctx)
            flags |= framing.FLAG_TRACE
        verb, payload = self._roundtrip(framing.BIND, body, flags=flags)
        if verb != framing.BIND_RESULT:
            raise WireError(f"unexpected verb 0x{verb:02x} to BIND")
        d = framing.decode_bind_result(payload)
        return BindResult(kind=d["kind"], error=d["error"],
                          retry_after_s=d["retry_after_ms"] / 1e3)

    def sync_nodes(self, nodes: List) -> int:
        return self._sync(framing.SYNC_NODES, nodes, "nodes")

    def sync_pods(self, pods: List) -> int:
        return self._sync(framing.SYNC_PODS, pods, "pods")

    def _sync(self, verb: int, items: List, kind: str) -> int:
        rverb, payload = self._roundtrip(
            verb, framing.encode_sync_request(items, kind))
        if rverb != framing.SYNCED:
            raise WireError(f"unexpected verb 0x{rverb:02x} to SYNC")
        return framing.decode_synced(payload)

    def relist(self) -> Tuple[List, List]:
        """Bounded-stale snapshot pull: (nodes, bound pods)
        from the shared cell's commit truth — a spawned scheduler
        process hydrates its local evaluator from this, then trues up
        with periodic re-pulls (its staleness window)."""
        verb, payload = self._roundtrip(framing.RELIST)
        if verb != framing.RELIST_RESULT:
            raise WireError(f"unexpected verb 0x{verb:02x} to RELIST")
        return framing.decode_relist_result(payload)

    def cell_agg(self, drain_spill: bool = False,
                 evacuate: bool = False) -> Tuple[dict, List]:
        """Federation pull: (aggregate dict, spilled pods) —
        the cell's routing column plus, with ``drain_spill``, the pods
        the cell gave up on (they LEFT its store with this response);
        ``evacuate`` additionally uproots every pending pod (brownout)."""
        verb, payload = self._roundtrip(
            framing.CELL_AGG,
            framing.encode_cell_agg_request(drain_spill, evacuate))
        if verb != framing.CELL_AGG_RESULT:
            raise WireError(f"unexpected verb 0x{verb:02x} to CELL_AGG")
        return framing.decode_cell_agg_result(payload)

    def admit(self, idem_key: str, pods: List) -> Tuple[int, int]:
        """Hand a batch of pending pods to this cell; (accepted,
        replayed). Replaying the SAME idem_key after an ambiguous wire
        fault converges to the recorded answer — the router's half of
        cross-cell exactly-once admission."""
        verb, payload = self._roundtrip(
            framing.ADMIT, framing.encode_admit_request(idem_key, pods))
        if verb != framing.ADMIT_RESULT:
            raise WireError(f"unexpected verb 0x{verb:02x} to ADMIT")
        return framing.decode_admit_result(payload)

    def metrics(self) -> str:
        verb, payload = self._roundtrip(framing.METRICS)
        if verb != framing.METRICS_TEXT:
            raise WireError(f"unexpected verb 0x{verb:02x} to METRICS")
        return framing.decode_metrics_text(payload)

    def stats(self, last: int = 0) -> dict:
        """Live introspection: {"vars": <registry snapshot>,
        "trace": [last N recorder events]} — the binary twin of HTTP
        /debug/vars + /debug/trace."""
        verb, payload = self._roundtrip(framing.STATS,
                                        framing.encode_stats_request(last))
        if verb != framing.STATS_RESULT:
            raise WireError(f"unexpected verb 0x{verb:02x} to STATS")
        return framing.decode_stats_result(payload)

    def __enter__(self) -> "BinaryWireClient":
        return self.connect()

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["BinaryWireClient", "WireDeadline", "WireError",
           "WireOverloaded"]
