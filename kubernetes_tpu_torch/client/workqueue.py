"""Rate-limited work queues — client-go util/workqueue semantics.

Reference behavior being mirrored (staging/src/k8s.io/client-go/util/workqueue):
- queue.go: the dirty/processing two-set invariant — an item added while being
  processed is re-queued exactly once when Done() is called; duplicate Adds
  between Get()s collapse.
- delaying_queue.go: AddAfter via a time-ordered heap drained by the consumer.
- default_rate_limiters.go: ItemExponentialFailureRateLimiter
  (base * 2^failures, capped), Forget() resets the failure count.
- parallelizer.go:29 Parallelize(workers, pieces, fn) — the scheduler's
  host-side fan-out primitive. Here it exists for host-side controller work
  only; the pod x node hot loop it powered in the reference is replaced by
  the fused device kernel (ops/predicates.py, ops/priorities.py).
"""

from __future__ import annotations

import heapq
import threading
from kubernetes_tpu_torch.analysis import lockcheck
import time
from typing import Any, Callable, Hashable, List, Optional


class ShutDown(Exception):
    """Raised by Get() after shut_down() drains."""


class WorkQueue:
    """Deduplicating FIFO with in-flight tracking (workqueue/queue.go)."""

    def __init__(self, now: Callable[[], float] = time.monotonic):
        self._lock = lockcheck.make_condition("WorkQueue._lock")
        self._queue: List[Hashable] = []
        self._dirty: set = set()
        self._processing: set = set()
        self._shutting_down = False
        self._now = now

    def add(self, item: Hashable) -> None:
        with self._lock:
            if self._shutting_down or item in self._dirty:
                return
            self._dirty.add(item)
            if item in self._processing:
                return  # will re-queue on Done()
            self._queue.append(item)
            self._lock.notify()

    def get(self, timeout: Optional[float] = None) -> Hashable:
        """Blocks until an item is available; raises ShutDown when the queue
        is shutting down and empty, TimeoutError on timeout."""
        deadline = None if timeout is None else self._now() + timeout
        with self._lock:
            while not self._queue:
                if self._shutting_down:
                    raise ShutDown()
                remaining = None if deadline is None else deadline - self._now()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError()
                self._lock.wait(remaining)
            item = self._queue.pop(0)
            self._processing.add(item)
            self._dirty.discard(item)
            return item

    def done(self, item: Hashable) -> None:
        with self._lock:
            self._processing.discard(item)
            if item in self._dirty:
                self._queue.append(item)
                self._lock.notify()

    def shut_down(self) -> None:
        with self._lock:
            self._shutting_down = True
            self._lock.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)


class ItemExponentialFailureRateLimiter:
    """base * 2^failures per item, capped (default_rate_limiters.go:67-102).
    Reference defaults for controllers: 5ms base, 1000s cap; the scheduler's
    pod backoff uses 1s..60s (plugin/pkg/scheduler/util/backoff_utils.go)."""

    def __init__(self, base: float = 0.005, max_delay: float = 1000.0):
        self.base = base
        self.max_delay = max_delay
        self._failures: dict = {}
        self._lock = lockcheck.make_lock("ItemExponentialFailureRateLimiter._lock")

    def when(self, item: Hashable) -> float:
        with self._lock:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
            return min(self.base * (2 ** n), self.max_delay)

    def forget(self, item: Hashable) -> None:
        with self._lock:
            self._failures.pop(item, None)

    def retries(self, item: Hashable) -> int:
        with self._lock:
            return self._failures.get(item, 0)


class RateLimitingQueue(WorkQueue):
    """WorkQueue + AddAfter heap + per-item rate limiter
    (delaying_queue.go + rate_limiting_queue.go). Delayed items become
    visible to Get() once their ready-time passes; Get() wakes itself no
    later than the earliest pending deadline."""

    def __init__(self, rate_limiter: Optional[ItemExponentialFailureRateLimiter] = None,
                 now: Callable[[], float] = time.monotonic):
        super().__init__(now=now)
        self.rate_limiter = rate_limiter or ItemExponentialFailureRateLimiter()
        self._waiting: List[tuple] = []  # (ready_time, seq, item) heap
        self._seq = 0

    def add_after(self, item: Hashable, delay: float) -> None:
        if delay <= 0:
            self.add(item)
            return
        with self._lock:
            if self._shutting_down:
                return
            self._seq += 1
            heapq.heappush(self._waiting, (self._now() + delay, self._seq, item))
            self._lock.notify()

    def add_rate_limited(self, item: Hashable) -> None:
        self.add_after(item, self.rate_limiter.when(item))

    def forget(self, item: Hashable) -> None:
        self.rate_limiter.forget(item)

    def num_requeues(self, item: Hashable) -> int:
        return self.rate_limiter.retries(item)

    def get(self, timeout: Optional[float] = None) -> Hashable:
        deadline = None if timeout is None else self._now() + timeout
        with self._lock:
            while True:
                now = self._now()
                while self._waiting and self._waiting[0][0] <= now:
                    _, _, item = heapq.heappop(self._waiting)
                    if item not in self._dirty:
                        self._dirty.add(item)
                        if item not in self._processing:
                            self._queue.append(item)
                if self._queue:
                    item = self._queue.pop(0)
                    self._processing.add(item)
                    self._dirty.discard(item)
                    return item
                if self._shutting_down:
                    raise ShutDown()
                waits = []
                if deadline is not None:
                    waits.append(deadline - now)
                if self._waiting:
                    waits.append(self._waiting[0][0] - now)
                wait_for = min(waits) if waits else None
                if wait_for is not None and wait_for <= 0:
                    if deadline is not None and now >= deadline:
                        raise TimeoutError()
                    continue
                self._lock.wait(wait_for)
                if deadline is not None and self._now() >= deadline and not self._queue:
                    now2 = self._now()
                    pending_ready = self._waiting and self._waiting[0][0] <= now2
                    if not pending_ready:
                        raise TimeoutError()


def parallelize(workers: int, pieces: int, do_work: Callable[[int], Any]) -> None:
    """workqueue.Parallelize (parallelizer.go:29): run do_work(0..pieces-1)
    across `workers` threads, joining before return."""
    if pieces <= 0:
        return
    workers = max(1, min(workers, pieces))
    if workers == 1:
        for i in range(pieces):
            do_work(i)
        return
    counter = iter(range(pieces))
    lock = lockcheck.make_lock("parallelize.lock")
    errors: List[BaseException] = []

    def run():
        while True:
            with lock:
                i = next(counter, None)
            if i is None:
                return
            try:
                do_work(i)
            except BaseException as e:  # surface first error after join
                with lock:
                    errors.append(e)
                return

    threads = [threading.Thread(target=run, daemon=True) for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
