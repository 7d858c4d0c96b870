"""The verdict API as a LIBRARY: the transport-agnostic
service core every wire shares, plus the in-process embedding mode for
co-located frontends.

PROFILE_r12's attribution made the split obvious: every correctness
semantic of the multi-frontend service — coalesced dispatch, bounded
staleness + the Omega bind fence, the BindLedger's exactly-once, typed
backpressure and deadline shedding — already lives BELOW the transport,
in TPUExtenderBackend. What the transports were missing was a shared,
typed seam:

  - ``VerdictService`` wraps a backend and answers the fleet verbs as
    plain typed objects (FilterVerdict / BindResult), raising the
    coalescer's typed Overloaded / DeadlineExceeded. The JSON HTTP
    server (server/extender.py), the async binary wire
    (server/asyncwire.py) and the embedding below are all thin adapters
    over THIS class — swapping the wire cannot move a semantic because
    no wire owns one.
  - ``EmbeddedVerdictAPI`` is the zero-wire deployment: the frontend
    links the verdict API directly (the sidecar AS a library), keeping
    the coalescer, stale window, fence and ledger intact — concurrent
    embedded frontends still micro-batch into one fused [C, N] dispatch
    and still commit through the fence. ``schedule_one`` packages the
    proven fleet scheduleOne loop (fused verdict -> top-score pick ->
    fenced bind, conflict/overload retries with jittered backoff,
    idempotency-key replay of ambiguous attempts) as one call.

The 100-frontend in-process fleet in bench.py measures this mode: on the
2-core CI box it sustains 416-687 scheduleOnes/s — the number the binary
wire is measured AGAINST (acceptance: within 2x over the wire).
"""

from __future__ import annotations

import random
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.server.extender import TPUExtenderBackend


@dataclass
class FilterVerdict:
    """One fused filter(+topk) evaluation against the shared snapshot."""

    snapshot_gen: Optional[int]
    all_passed: bool
    passed_count: int
    # None when compact elision applied (all passed, nothing to echo)
    passed: Optional[List[str]]
    failed: Dict[str, str] = field(default_factory=dict)
    # None when top_k was not requested; [] when requested and nothing fits
    top_scores: Optional[List[Tuple[str, int]]] = None


@dataclass
class BindResult:
    """Typed bind_verdict outcome — kind in ok|conflict|pending|shed|error
    (server/extender.py bind_verdict docstring has the retry contract)."""

    kind: str
    error: str = ""
    retry_after_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.kind == "ok"

    @property
    def retryable(self) -> bool:
        return self.kind in ("conflict", "pending")


class ScheduleFailed(Exception):
    """schedule_one exhausted its attempt budget without a bind."""


class VerdictService:
    """The transport-agnostic service core over one TPUExtenderBackend.

    filter()/bind() ride the backend's own coalescer and fence (what the
    HTTP handlers and the embedded mode use); eval_batch()/finish_filter()
    are the batch seam for a transport that does its OWN group-commit
    batching (the async wire's event loop collects concurrent FILTER
    frames and dispatches them as one fused batch — transport-level
    coalescing, same engine seam, same degraded fallback)."""

    def __init__(self, backend: TPUExtenderBackend):
        self.backend = backend

    # ------------------------------------------------------------ verbs

    def filter(self, pod, node_names: Optional[List[str]] = None,
               top_k: int = 0, deadline_s: Optional[float] = None,
               compact: bool = False,
               trace_ctx: Optional[str] = None) -> FilterVerdict:
        """Fused filter(+topk) through the coalescing window. Raises the
        coalescer's Overloaded / DeadlineExceeded. ``node_names``
        restricts the candidate set (the HTTP args shape); compact
        elision only applies to the whole-cluster form — a restricted
        verdict always echoes its survivors. ``trace_ctx`` stamps one
        embedded WIRE_HOP on the pod-trace timeline — the
        in-process twin of the HTTP header / binary flag."""
        if trace_ctx:
            self._trace_hop(trace_ctx, 0)
        b = self.backend
        if top_k:
            passed, failed, top, gen = b.fused_verdict(
                pod, node_names, deadline_s=deadline_s, top_k=top_k)
        else:
            passed, failed, gen = b.filter_verdict(
                pod, node_names, deadline_s=deadline_s)
            top = None
        return self._as_filter_verdict(passed, failed, top, gen,
                                       compact and node_names is None)

    @staticmethod
    def _as_filter_verdict(passed, failed, top, gen,
                           compact: bool) -> FilterVerdict:
        all_passed = not failed
        return FilterVerdict(
            snapshot_gen=gen, all_passed=all_passed,
            passed_count=len(passed),
            passed=None if (compact and all_passed) else list(passed),
            failed=dict(failed), top_scores=top)

    @staticmethod
    def _trace_hop(trace_id: str, hop_verb: int) -> None:
        from kubernetes_tpu_torch.observability import podtrace
        if podtrace.TRACER.enabled:
            podtrace.TRACER.wire_hop(trace_id, podtrace.WIRE_EMBEDDED,
                                     hop_verb)

    @staticmethod
    def trace_bound(trace_id: str) -> None:
        """Terminal BOUND for a wire-path trace: the sidecar deployment
        has no scheduler bind path to complete the timeline, so each
        transport stamps completion when ITS bind verdict lands ok —
        without this, wire timelines would pin live slots until the
        window-abandonment sweep and /debug/pods would never show a
        completed wire exemplar."""
        from kubernetes_tpu_torch.observability import podtrace
        if podtrace.TRACER.enabled:
            podtrace.TRACER.bound_batch([trace_id])

    def bind(self, pod_name: str, namespace: str, uid: str, node: str,
             snapshot_gen: Optional[int] = None,
             idem_key: Optional[str] = None,
             deadline_s: Optional[float] = None, pod=None,
             trace_ctx: Optional[str] = None) -> BindResult:
        if trace_ctx:
            self._trace_hop(trace_ctx, 1)
        err, kind, retry_s = self.backend.bind_verdict(
            pod_name, namespace, uid, node, snapshot_gen=snapshot_gen,
            idem_key=idem_key, deadline_s=deadline_s, pod_spec=pod)
        if trace_ctx and kind == "ok":
            self.trace_bound(trace_ctx)
        return BindResult(kind=kind, error=err, retry_after_s=retry_s)

    def sync_nodes(self, nodes) -> int:
        self.backend.sync_nodes(nodes)
        return len(nodes)

    def sync_pods(self, pods) -> int:
        self.backend.sync_pods(pods)
        return len(pods)

    def relist(self):
        """``(nodes, bound_pods)`` — the cell-truth snapshot a scheduler
        process pulls to refresh ITS OWN bounded-stale cache
        (extender.list_state docstring). Served identically over the
        binary RELIST verb; the level-triggered re-list half of the
        reference's watch/relist discipline."""
        return self.backend.list_state()

    def metrics_text(self) -> str:
        return self.backend.metrics_text()

    def debug_snapshot(self, last: int = 0) -> Dict:
        """Live introspection: the unified telemetry-
        registry snapshot, the flight recorder's last ``last`` events,
        the pod tracer's black box and the SLO engine's burn-rate view —
        IDENTICAL content to HTTP ``/debug/vars`` + ``/debug/trace`` +
        ``/debug/pods`` + ``/debug/slo`` and the binary wire's STATS
        verb (transport parity is test-pinned; every source snapshots
        under its own lock, so a mid-storm read never tears)."""
        dv = getattr(self.backend, "debug_vars", None)
        dt = getattr(self.backend, "debug_trace", None)
        dp = getattr(self.backend, "debug_pods", None)
        ds = getattr(self.backend, "debug_slo", None)
        return {"vars": dv() if dv is not None else {},
                "trace": dt(last) if (last and dt is not None) else [],
                "pods": dp() if dp is not None else {},
                "slo": ds() if ds is not None else {}}

    # ----------------------------------------------- batch seam (asyncwire)

    def eval_batch(self, pods) -> List:
        """Leader-side batch evaluation for a transport-level coalescer:
        one fused [C, N] dispatch for the batch, with the same degraded
        per-request fallback the thread coalescer carries (a faulting
        batch eval must not take the verb down). Returns one _Verdict OR
        one Exception per pod, in order — the caller answers exceptions
        with typed ERROR frames instead of dropping tickets."""
        b = self.backend
        b._count("coalesce_batches")
        b._count("coalesce_requests", len(pods))
        try:
            return list(b._eval_many(pods))
        except Exception:
            b._count("coalesce_faults")
            outs: List = []
            for p in pods:
                try:
                    outs.append(b._eval_one(p))
                except Exception as e:  # noqa: BLE001 — per-ticket fault
                    outs.append(e)
            return outs

    def finish_filter(self, verdict, top_k: int = 0,
                      compact: bool = False) -> FilterVerdict:
        """Build the FilterVerdict for one eval_batch() verdict — the
        split/top-k marshalling outside the backend lock. Compact fast
        path: an all-passed verdict under elision never materializes the
        N-name passed list at all (at 5k nodes and fleet request rates
        that list build is pure overhead for a response that elides it)."""
        import numpy as np
        b = self.backend
        if compact:
            n = len(verdict.names)
            if bool(np.asarray(verdict.m[:n]).all()):
                top = b._top_scores(verdict, top_k) if top_k else None
                return FilterVerdict(
                    snapshot_gen=verdict.gen, all_passed=True,
                    passed_count=n, passed=None, failed={},
                    top_scores=top)
        passed, failed = b._split_passed(verdict.m, verdict.names,
                                         verdict.idx, None)
        top = b._top_scores(verdict, top_k) if top_k else None
        return self._as_filter_verdict(passed, failed, top, verdict.gen,
                                       compact)


class EmbeddedVerdictAPI(VerdictService):
    """The in-process embedding mode: the verdict API constructed AS a
    library by a co-located frontend — no socket, no serialization, the
    full multi-frontend service semantics (the backend underneath is the
    same object the wires serve).

    Thread-safe: N frontend threads call filter/bind/schedule_one
    concurrently; evaluations micro-batch through the coalescer, commits
    serialize through the fence."""

    def __init__(self, binder=None, stale_window_s: float = 0.025,
                 coalesce_window_s: float = 0.0005,
                 coalesce_max_batch: int = 64,
                 coalesce_max_depth: int = 512):
        super().__init__(TPUExtenderBackend(
            binder=binder, stale_window_s=stale_window_s,
            coalesce_window_s=coalesce_window_s,
            coalesce_max_batch=coalesce_max_batch,
            coalesce_max_depth=coalesce_max_depth))

    def schedule_one(self, pod, top_k: int = 32, max_attempts: int = 80,
                     deadline_s: Optional[float] = None,
                     rng: Optional[random.Random] = None) -> Tuple[str, int]:
        """One frontend scheduleOne through the embedded API: fused
        verdict, pick among the max-score hosts, fenced bind with an
        idempotency key per attempt. CONFLICTs retry against a fresh
        verdict with the server-suggested jittered backoff; Overloaded
        waits out the typed retry-after; an ambiguous bind error replays
        the SAME key so the ledger converges it to exactly-once; the
        store's "already assigned" refusal heals to success (store is
        truth). Returns (node, attempts). Raises ScheduleFailed past the
        attempt budget — the caller's scheduleOne loop owns what happens
        then, exactly like a wire client."""
        from kubernetes_tpu_torch.server.coalescer import (
            DeadlineExceeded,
            Overloaded,
        )
        rng = rng or random.Random()
        # pod-trace context: a sampled pod's filter/bind hops
        # join one timeline — the embedded twin of the wire contexts
        from kubernetes_tpu_torch.observability.podtrace import TRACER
        trace_ctx = None
        if TRACER.enabled:
            key = f"{pod.namespace}/{pod.name}"
            if TRACER.sampled(key):
                TRACER.begin_forced(key)
                trace_ctx = key
        for attempt in range(max_attempts):
            try:
                v = self.filter(pod, top_k=top_k, deadline_s=deadline_s,
                                compact=True, trace_ctx=trace_ctx)
            except Overloaded as e:
                time.sleep(e.retry_after_s * rng.uniform(0.5, 1.5))
                continue
            except DeadlineExceeded:
                time.sleep(0.005 * rng.uniform(0.5, 1.5))
                continue
            scores = v.top_scores or []
            if not scores:
                # transiently full per the (possibly stale) verdict:
                # expiries/forgets free slots — retry, don't abort
                time.sleep(0.01 * rng.uniform(0.5, 1.5))
                continue
            best = scores[0][1]
            cands = [nm for nm, s in scores if s == best]
            node = cands[rng.randrange(len(cands))]
            res = self.bind(pod.name, pod.namespace, pod.uid, node,
                            snapshot_gen=v.snapshot_gen,
                            idem_key=f"{pod.namespace}/{pod.name}:{attempt}",
                            deadline_s=deadline_s, pod=pod,
                            trace_ctx=trace_ctx)
            if res.ok:
                return node, attempt + 1
            if res.kind == "conflict" and "double-claim" in res.error:
                # another scheduler process owns this pod:
                # converge on ITS placement instead of retrying into the
                # same typed refusal forever — store is truth, the same
                # discipline as the "already assigned" heal below
                m = re.search(r"already claimed on (\S+)", res.error)
                return (m.group(1) if m else node), attempt + 1
            if res.retryable:
                time.sleep(res.retry_after_s * rng.uniform(0.5, 1.5))
                continue
            if "already assigned" in res.error:
                return node, attempt + 1  # landed earlier; store is truth
            if res.kind == "error":
                # ambiguous downstream write: same key converges via the
                # ledger (replays to the recorded node)
                res2 = self.bind(
                    pod.name, pod.namespace, pod.uid, node,
                    idem_key=f"{pod.namespace}/{pod.name}:{attempt}",
                    pod=pod)
                if res2.ok or "already assigned" in res2.error:
                    return node, attempt + 1
            # shed or unresolved: fresh attempt, fresh key
        raise ScheduleFailed(
            f"{pod.namespace}/{pod.name}: no bind in {max_attempts} attempts")


__all__ = ["BindResult", "EmbeddedVerdictAPI", "FilterVerdict",
           "ScheduleFailed", "VerdictService"]
