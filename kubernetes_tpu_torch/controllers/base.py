"""Controller base: informer handlers -> rate-limited key queue -> sync(key).

The shape of every pkg/controller/* worker loop (e.g. replica_set.go:151 Run,
processNextWorkItem): Get -> sync -> Forget on success / AddRateLimited on
error -> Done. Supports both threaded run(workers) and a deterministic pump()
for tests (the reference gets determinism the same way — calling syncHandler
directly in unit tests).
"""

from __future__ import annotations

import threading
from typing import List, Optional

from kubernetes_tpu_torch.client.record import EventRecorder
from kubernetes_tpu_torch.client.workqueue import (
    ItemExponentialFailureRateLimiter,
    RateLimitingQueue,
    ShutDown,
)
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, Conflict, NotFound


class Controller:
    name = "controller"
    max_retries = 15  # replica_set.go statusUpdateRetries-ish bound for tests

    def __init__(self, api: ApiServerLite, record_events: bool = True):
        self.api = api
        self.queue = RateLimitingQueue(
            ItemExponentialFailureRateLimiter(base=0.005, max_delay=300.0))
        self.recorder: Optional[EventRecorder] = (
            EventRecorder(api, source=self.name) if record_events else None)
        self._threads: List[threading.Thread] = []
        self.sync_errors = 0

    # -------------------------------------------------------------- wiring

    def enqueue(self, key: str) -> None:
        self.queue.add(key)

    def sync(self, key: str) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def event(self, involved_kind: str, involved_key: str, etype: str,
              reason: str, message: str) -> None:
        if self.recorder is not None:
            self.recorder.event(involved_kind, involved_key, etype, reason, message)

    # ---------------------------------------------------------------- loop

    def process_one(self, timeout: float = 0.0) -> bool:
        try:
            key = self.queue.get(timeout)
        except (TimeoutError, ShutDown):
            return False
        try:
            self.sync(key)
        except (Conflict, NotFound):
            # optimistic-concurrency loss or racing delete: plain retry, the
            # informer will deliver fresher state (controller_utils.go pattern)
            self.sync_errors += 1
            if self.queue.num_requeues(key) < self.max_retries:
                self.queue.add_rate_limited(key)
            else:
                self.queue.forget(key)
        except Exception:
            self.sync_errors += 1
            if self.queue.num_requeues(key) < self.max_retries:
                self.queue.add_rate_limited(key)
            else:
                self.queue.forget(key)
        else:
            self.queue.forget(key)
        finally:
            self.queue.done(key)
        return True

    def pump(self, limit: int = 10_000) -> int:
        """Drain the queue synchronously (deterministic test mode)."""
        n = 0
        while n < limit and self.process_one():
            n += 1
        return n

    def run(self, workers: int = 1, poll: float = 0.05) -> None:
        for i in range(workers):
            t = threading.Thread(target=self._worker, args=(poll,),
                                 daemon=True, name=f"{self.name}-{i}")
            t.start()
            self._threads.append(t)

    def _worker(self, poll: float) -> None:
        while True:
            try:
                key = self.queue.get(None)
            except ShutDown:
                return
            try:
                self.sync(key)
            except Exception:
                self.sync_errors += 1
                if self.queue.num_requeues(key) < self.max_retries:
                    self.queue.add_rate_limited(key)
                else:
                    self.queue.forget(key)
            else:
                self.queue.forget(key)
            finally:
                self.queue.done(key)

    def stop(self) -> None:
        self.queue.shut_down()
        for t in self._threads:
            t.join(timeout=2.0)
