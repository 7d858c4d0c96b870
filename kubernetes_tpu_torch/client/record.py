"""Event recorder — client-go tools/record analog.

EventRecorder writes ClusterEvent objects through the apiserver so every
component's events are observable cluster state (the reference's
EventBroadcaster -> events API path; scheduler emits Scheduled /
FailedScheduling at plugin/pkg/scheduler/scheduler.go:174,248).

Correlation/dedup: repeated (object, reason, message) triples bump a count on
the stored event instead of creating new objects — the EventCorrelator /
EventAggregator behavior (client-go/tools/record/events_cache.go) that keeps
event storms from flooding storage.
"""

from __future__ import annotations

import dataclasses
import threading
from kubernetes_tpu_torch.analysis import lockcheck
import time
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, Conflict, NotFound


@dataclass
class ClusterEvent:
    """v1.Event reduced to the consumed fields."""

    name: str
    namespace: str
    involved_kind: str
    involved_key: str  # "<ns>/<name>" of the object the event is about
    reason: str
    message: str
    type: str = "Normal"  # Normal | Warning
    count: int = 1
    source: str = ""
    first_seen: float = 0.0
    last_seen: float = 0.0
    resource_version: int = 0


class EventRecorder:
    KIND = "Event"

    def __init__(self, api: ApiServerLite, source: str,
                 now: Callable[[], float] = time.time):
        self.api = api
        self.source = source
        self._now = now
        self._lock = lockcheck.make_lock("EventRecorder._lock")
        self._seq = 0
        # (involved_key, reason, message) -> stored event name, for dedup
        self._names: Dict[Tuple[str, str, str], str] = {}

    def event(self, involved_kind: str, involved_key: str, event_type: str,
              reason: str, message: str) -> None:
        ts = self._now()
        dedup_key = (involved_key, reason, message)
        namespace = involved_key.split("/", 1)[0] if "/" in involved_key else "default"
        # Reserve the dedup slot atomically so concurrent first emissions of
        # the same triple agree on one stored object.
        with self._lock:
            name = self._names.get(dedup_key)
            fresh = name is None
            if fresh:
                self._seq += 1
                name = f"{involved_key.replace('/', '.')}.{reason}.{self._seq}"
                self._names[dedup_key] = name
        if not fresh:
            for _ in range(3):  # CAS retry under concurrent bumps
                try:
                    cur: ClusterEvent = self.api.get(self.KIND, namespace, name)
                    bumped = dataclasses.replace(
                        cur, count=cur.count + 1, last_seen=ts)
                    self.api.update(self.KIND, bumped,
                                    expect_rv=cur.resource_version)
                    return
                except Conflict:
                    continue
                except NotFound:
                    break  # stored event was pruned; recreate below
        ev = ClusterEvent(
            name=name, namespace=namespace, involved_kind=involved_kind,
            involved_key=involved_key, reason=reason, message=message,
            type=event_type, source=self.source, first_seen=ts, last_seen=ts)
        try:
            self.api.create(self.KIND, ev)
        except Conflict:
            # lost the create race to a concurrent emitter of the same triple;
            # their object carries the count
            pass
