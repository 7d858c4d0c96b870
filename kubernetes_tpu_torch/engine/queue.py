"""Pending-pod queue with exponential backoff requeue.

Mirrors the reference's FIFO pod queue (factory.go:140 podQueue =
cache.NewFIFO) + the error-path backoff requeue (factory.go:897
MakeDefaultErrorFunc with util.PodBackoff: initial 1s, max 60s, doubling per
pod — plugin/pkg/scheduler/util/backoff_utils.go).

Batch-native twist: pop_batch drains up to max_n ready pods at once (the
snapshot-the-queue idea from SURVEY.md §2.3) instead of one blocking Pop.
"""

from __future__ import annotations

import heapq
import threading
from kubernetes_tpu_torch.analysis import lockcheck
import time
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.observability.podtrace import TRACER
from kubernetes_tpu_torch.utils import features

INITIAL_BACKOFF = 1.0
MAX_BACKOFF = 60.0


class PodBackoff:
    """Per-pod doubling backoff (backoff_utils.go:SchedulerBackoff)."""

    def __init__(self, initial: float = INITIAL_BACKOFF, max_s: float = MAX_BACKOFF,
                 now: Callable[[], float] = time.monotonic):
        self._initial = initial
        self._max = max_s
        self._now = now
        self._durations: Dict[str, float] = {}
        self._last: Dict[str, float] = {}

    def next_delay(self, key: str) -> float:
        """Current delay for the pod, then double for next time."""
        d = self._durations.get(key, self._initial)
        self._durations[key] = min(d * 2, self._max)
        self._last[key] = self._now()
        return d

    def gc(self, max_age: float = 2 * MAX_BACKOFF) -> None:
        cutoff = self._now() - max_age
        for k in [k for k, t in self._last.items() if t < cutoff]:
            self._durations.pop(k, None)
            self._last.pop(k, None)


class SchedulingQueue:
    # starvation guard: a pod that has waited this long pops
    # AHEAD of the priority order — under a sustained high-priority
    # offered stream, a preempted low-priority victim would otherwise
    # never reach the head of a priority-sorted queue (Tiresias' aging
    # discipline, PAPERS.md §Tiresias). The stamp survives backoff
    # requeues (waiting is cumulative from first admission) and clears
    # on terminal removal (bind confirmation, deletion).
    AGING_THRESHOLD_S = 30.0

    def __init__(self, now: Callable[[], float] = time.monotonic):
        self._now = now
        self._lock = lockcheck.make_condition("SchedulingQueue._lock")
        self._fifo: List[Pod] = []
        self._keys: Dict[str, Pod] = {}
        self._deferred: List = []  # heap of (ready_time, seq, pod)
        self._seq = 0
        self._queued_at: Dict[str, float] = {}  # first-admission stamp
        self.aging_threshold_s = self.AGING_THRESHOLD_S
        self.backoff = PodBackoff(now=now)
        # fast tier: pods the classifier routes latency-critical
        # pop via pop_fast() ahead of any quantum. None (default) keeps
        # the queue single-tier — BIT-identical to the pre-fast-lane
        # behavior, pinned by the A/B test. The bulk tier's r14
        # aging/starvation guard is untouched: fast pods never enter the
        # priority sort, bulk pods never wait behind the fast tier's pop
        # (the streaming loop budgets fast pops per step).
        self._fast: List[Pod] = []
        self.fast_classifier: Optional[Callable[[Pod], bool]] = None

    def add(self, pod: Pod) -> None:
        with self._lock:
            key = pod.key()
            if key in self._keys:
                return
            self._queued_at.setdefault(key, self._now())
            self._keys[key] = pod
            cls = self.fast_classifier
            if cls is not None and cls(pod):
                self._fast.append(pod)
            else:
                self._fifo.append(pod)
            self._lock.notify_all()
        if TRACER.enabled:
            # pod-level black box: the queue-admission stamp
            # — head-sampling decides here, everything later is a probe
            TRACER.begin_batch((key,))

    def add_many(self, pods: List[Pod]) -> None:
        """add() for a batch under ONE lock with ONE waiter wakeup — the
        arrival-storm admission path: at 20k+ creates/s the
        per-pod lock acquire + notify_all of add() is a measurable slice
        of the scheduler core the stream is trying to keep on waves."""
        admitted = None
        with self._lock:
            keys = self._keys
            fifo = self._fifo
            fast = self._fast
            cls = self.fast_classifier
            now = self._now()
            stamps = self._queued_at
            if TRACER.enabled:
                admitted = []
            for pod in pods:
                key = pod.key()
                if key in keys:
                    continue
                stamps.setdefault(key, now)
                keys[key] = pod
                if cls is not None and cls(pod):
                    fast.append(pod)
                else:
                    fifo.append(pod)
                if admitted is not None:
                    admitted.append(key)
            self._lock.notify_all()
        if admitted:
            TRACER.begin_batch(admitted)

    def add_bulk(self, pods: List[Pod]) -> None:
        """Admit straight to the BULK tier, bypassing the fast
        classifier — the fast lane's fallback path: a pod
        whose bounded retries ran out must ride the wave path next, not
        re-route into the fast tier forever."""
        admitted = None
        with self._lock:
            keys = self._keys
            now = self._now()
            stamps = self._queued_at
            if TRACER.enabled:
                admitted = []
            for pod in pods:
                key = pod.key()
                if key in keys:
                    continue
                stamps.setdefault(key, now)
                keys[key] = pod
                self._fifo.append(pod)
                if admitted is not None:
                    admitted.append(key)
            self._lock.notify_all()
        if admitted:
            TRACER.begin_batch(admitted)

    def add_backoff(self, pod: Pod) -> float:
        """Requeue after the pod's current backoff delay; returns the delay."""
        with self._lock:
            key = pod.key()
            if key in self._keys:
                return 0.0
            self._queued_at.setdefault(key, self._now())
            delay = self.backoff.next_delay(key)
            self._keys[key] = pod
            self._seq += 1
            heapq.heappush(self._deferred, (self._now() + delay, self._seq, pod))
            self._lock.notify_all()
        if TRACER.enabled:
            TRACER.begin_batch((key,), backoff=True)
        return delay

    def remove(self, pod_key: str) -> None:
        """Drop a pod (deleted / scheduled by someone else)."""
        with self._lock:
            self._queued_at.pop(pod_key, None)  # terminal: stamp clears
            if self._keys.pop(pod_key, None) is not None:
                self._fifo = [p for p in self._fifo if p.key() != pod_key]
                if self._fast:
                    self._fast = [p for p in self._fast
                                  if p.key() != pod_key]
                self._deferred = [(t, s, p) for (t, s, p) in self._deferred
                                  if p.key() != pod_key]
                heapq.heapify(self._deferred)

    def remove_many(self, pod_keys: List[str]) -> None:
        """remove() for a batch under one lock. The bind-confirmation storm
        calls this with keys that are almost never queued (the pods were
        popped before binding), so absence costs one set probe per key and
        the list rebuilds happen at most once per batch."""
        with self._lock:
            stamps = self._queued_at
            for k in pod_keys:
                stamps.pop(k, None)  # terminal: bind confirmed
            present = {k for k in pod_keys if k in self._keys}
            if not present:
                return
            for k in present:
                del self._keys[k]
            self._fifo = [p for p in self._fifo if p.key() not in present]
            if self._fast:
                self._fast = [p for p in self._fast
                              if p.key() not in present]
            self._deferred = [(t, s, p) for (t, s, p) in self._deferred
                              if p.key() not in present]
            heapq.heapify(self._deferred)

    def pop_batch(self, max_n: int = 0, wait: Optional[float] = None) -> List[Pod]:
        """Drain up to max_n (0 = all) ready pods; optionally block up to
        `wait` seconds for the first one."""
        deadline = None if wait is None else self._now() + wait
        with self._lock:
            while True:
                self._promote_ready_locked()
                if self._fast and not self._fifo:
                    # a fast-tier arrival must not sit out a bulk
                    # blocking wait: return empty so the streaming loop
                    # pumps the fast lane now (with no classifier set
                    # _fast is always empty — this branch never fires)
                    return []
                if self._fifo:
                    if features.enabled("PodPriority"):
                        # priority queue semantics (1.8's podqueue
                        # heap ordered by priority): higher priority
                        # pops first; stable sort keeps FIFO order
                        # within a priority band. AGED pods lead the
                        # whole order (starvation guard): a
                        # preempted victim that has waited past the
                        # aging threshold pops before fresh
                        # high-priority arrivals, so it rebinds the
                        # moment capacity frees instead of starving
                        # behind a sustained high-band stream.
                        now = self._now()
                        age = self.aging_threshold_s
                        stamps = self._queued_at
                        self._fifo.sort(
                            key=lambda p:
                            (0 if now - stamps.get(p.key(), now) >= age
                             else 1, -p.priority))
                    n = len(self._fifo) if max_n == 0 else min(max_n, len(self._fifo))
                    out = self._fifo[:n]
                    self._fifo = self._fifo[n:]
                    for p in out:
                        self._keys.pop(p.key(), None)
                    if TRACER.enabled and out:
                        # POPPED carries the realized admission size (=
                        # the quantum that popped it) and the pod's own
                        # pop round — requeue loops made visible
                        TRACER.pop_batch([p.key() for p in out])
                    return out
                if deadline is None:
                    return []
                remaining = deadline - self._now()
                if remaining <= 0:
                    return []
                timeout = remaining
                if self._deferred:
                    timeout = min(timeout, max(self._deferred[0][0] - self._now(), 0.01))
                self._lock.wait(timeout)

    def pop_fast(self, max_n: int = 0) -> List[Pod]:
        """Drain up to max_n (0 = all) fast-tier pods NOW — no blocking,
        no quantum, no priority sort (the fast tier is FIFO: every pod
        in it is equally latency-critical and k-sampling spreads the
        load server-side, Sparrow's discipline)."""
        with self._lock:
            if not self._fast:
                return []
            n = len(self._fast) if max_n == 0 else min(max_n,
                                                       len(self._fast))
            out = self._fast[:n]
            self._fast = self._fast[n:]
            for p in out:
                self._keys.pop(p.key(), None)
            if TRACER.enabled:
                TRACER.pop_batch([p.key() for p in out])
            return out

    def fast_count(self) -> int:
        with self._lock:
            return len(self._fast)

    def __len__(self) -> int:
        with self._lock:
            return len(self._keys)

    def ready_count(self) -> int:
        with self._lock:
            self._promote_ready_locked()
            return len(self._fifo) + len(self._fast)

    def _promote_ready_locked(self) -> None:
        lockcheck.assert_held(self._lock, "_promote_ready_locked")
        now = self._now()
        while self._deferred and self._deferred[0][0] <= now:
            _, _, pod = heapq.heappop(self._deferred)
            if pod.key() in self._keys:
                self._fifo.append(pod)
