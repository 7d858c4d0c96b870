"""Coalesced dispatch for the multi-frontend extender.

One kube-scheduler at 19 pods/s never queues two evaluations; a fleet of
100 does nothing else. This module turns concurrent /filter + /prioritize
requests into micro-batches against the backend's shared device-resident
snapshot: the first thread to arrive becomes the LEADER, drains whatever
is queued (plus an optional accumulation window when a storm is clearly
forming), and evaluates the whole batch through the engine's fused [C, N]
dispatch (scheduler_engine.evaluate_pods_batch) while followers park on
their ticket. Requests that arrive while the leader is on the device pile
up and ride the NEXT batch — natural group-commit batching, so a lone
client pays zero added latency and a storm pays ~1 dispatch per window
instead of one per request.

Robustness envelope:

  - ADMISSION CONTROL: the queue is bounded; past ``max_depth`` a submit
    raises Overloaded and the HTTP layer answers 429 + Retry-After —
    offered load beyond the dispatch budget sheds instead of queueing
    unboundedly (PAPERS.md §Sparrow: honest overload is visible overload).
  - DEADLINES: a request whose client already gave up (its DeadlineMs
    elapsed while queued) is SHED at batch formation, not evaluated into
    a response nobody is waiting for.
  - DEGRADED FALLBACK: when the batched evaluation itself faults, the
    leader falls back to per-request evaluation for the same tickets, so
    a coalescer bug degrades to one evaluation per request
    instead of an outage; the fault is counted and surfaced in /metrics.
"""

from __future__ import annotations

import random
import threading
from kubernetes_tpu_torch.analysis import lockcheck
import time
from collections import deque
from typing import Optional


class Overloaded(Exception):
    """Queue depth exceeded the admission bound — retry after a backoff."""

    def __init__(self, retry_after_s: float):
        super().__init__(f"coalescer queue full; retry after "
                         f"{retry_after_s * 1e3:.0f}ms")
        self.retry_after_s = retry_after_s


class DeadlineExceeded(Exception):
    """The request's client-supplied deadline elapsed before evaluation."""


class _Ticket:
    __slots__ = ("pod", "arrival", "deadline_s", "done", "result", "error")

    def __init__(self, pod, deadline_s: Optional[float]):
        self.pod = pod
        self.arrival = time.monotonic()
        self.deadline_s = deadline_s
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class EvalCoalescer:
    """Leader/follower micro-batch window over a TPUExtenderBackend.

    ``submit(pod, deadline_s)`` returns the backend's eval verdict for the
    pod (whatever ``backend._eval_many`` yields per pod), raising
    Overloaded / DeadlineExceeded per the envelope above. The backend's
    own lock serializes leaders against binds and syncs, so coalescing
    changes WHEN evaluations run, never what one means."""

    # follower safety net: a ticket with no deadline still must not park
    # forever if its leader dies uncleanly mid-serve
    MAX_WAIT_S = 30.0

    def __init__(self, backend, window_s: float = 0.0, max_batch: int = 64,
                 max_depth: int = 512):
        self._backend = backend
        self.window_s = window_s
        self.max_batch = max(int(max_batch), 1)
        self.max_depth = max(int(max_depth), 1)
        self._cv = lockcheck.make_condition("EvalCoalescer._cv")
        self._queue: deque = deque()
        self._leader_active = False
        self._rng = random.Random(0xC0A1)

    # ------------------------------------------------------------- submit

    def submit(self, pod, deadline_s: Optional[float] = None):
        t = _Ticket(pod, deadline_s)
        lead = False
        with self._cv:
            if len(self._queue) >= self.max_depth:
                self._backend._count("admission_shed")
                # jittered so 100 shed clients don't re-arrive in lockstep
                raise Overloaded(0.01 + self._rng.random() * 0.04)
            self._queue.append(t)
            # waiters park on the CV (not a private event) so leadership
            # can MIGRATE: a stepping-down leader wakes the room and the
            # first unserved waiter with work pending takes over — no
            # permanent dispatcher whose own caller is starved, and no
            # stranded queue when a leader exits between batches
            while not t.done.is_set():
                if not self._leader_active and self._queue:
                    self._leader_active = True
                    lead = True
                    break
                waited = time.monotonic() - t.arrival
                limit = self.MAX_WAIT_S if t.deadline_s is None \
                    else min(t.deadline_s, self.MAX_WAIT_S)
                if waited >= limit:
                    # withdraw the ticket: a ghost left queued would count
                    # against max_depth (spurious 429s) and be evaluated
                    # into a result nobody reads. Already popped into an
                    # in-flight batch -> the leader resolves it; dropping
                    # our reference is enough.
                    try:
                        self._queue.remove(t)
                    except ValueError:
                        pass
                    self._backend._count("deadline_shed")
                    raise DeadlineExceeded(
                        "queued past the request deadline")
                self._cv.wait(timeout=min(limit - waited, 0.05))
        if lead:
            self._lead(t)
        if t.error is not None:
            raise t.error
        if not t.done.is_set():  # led, stepped down with own ticket unserved
            raise DeadlineExceeded("leadership ended before service")
        return t.result

    # ------------------------------------------------------------- leader

    def _lead(self, own: _Ticket) -> None:
        try:
            while True:
                with self._cv:
                    if not self._queue or own.done.is_set():
                        # step down once our own caller is answered (or
                        # nothing is queued): the wakeup lets a parked
                        # waiter claim the role for what remains
                        self._leader_active = False
                        self._cv.notify_all()
                        return
                    if self.window_s > 0 \
                            and 1 < len(self._queue) < self.max_batch:
                        # a storm is forming (more than one waiter):
                        # optionally hold the window open for a fuller
                        # batch. A lone request never waits here.
                        self._cv.wait(timeout=self.window_s)
                    batch = []
                    while self._queue and len(batch) < self.max_batch:
                        batch.append(self._queue.popleft())
                self._serve(batch)
        except BaseException:
            # never strand the leader role on an unexpected escape —
            # _serve resolves its own tickets, so nothing else is pending
            with self._cv:
                self._leader_active = False
                self._cv.notify_all()
            raise

    def _serve(self, batch) -> None:
        backend = self._backend
        now = time.monotonic()
        live = []
        shed = 0
        for t in batch:
            if t.deadline_s is not None and now - t.arrival > t.deadline_s:
                t.error = DeadlineExceeded("deadline elapsed in queue")
                t.done.set()
                shed += 1
            else:
                live.append(t)
        if shed:
            backend._count("deadline_shed", shed)
        if not live:
            with self._cv:
                self._cv.notify_all()
            return
        backend._count("coalesce_batches")
        backend._count("coalesce_requests", len(live))
        try:
            outs = backend._eval_many([t.pod for t in live])
        except Exception:
            # DEGRADED FALLBACK: per-request evaluation, failures isolated
            # per ticket — a coalescer fault must not take the verb down
            backend._count("coalesce_faults")
            for t in live:
                try:
                    t.result = backend._eval_one(t.pod)
                except BaseException as e:  # noqa: BLE001 — ticket owns it
                    t.error = e
                t.done.set()
        else:
            for t, out in zip(live, outs):
                t.result = out
                t.done.set()
        with self._cv:
            self._cv.notify_all()  # served waiters are parked on the CV


__all__ = ["DeadlineExceeded", "EvalCoalescer", "Overloaded"]
