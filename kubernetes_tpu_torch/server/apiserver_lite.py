"""apiserver-lite: in-process object store with resourceVersion CAS + watch.

The benchmark-grade stand-in for kube-apiserver+etcd, mirroring what the
reference's integration tier does with its in-process master
(test/integration/scheduler_perf/util.go:47 mustSetupScheduler). Semantics
kept from the real storage stack:

- monotonically increasing resourceVersion assigned on every write
  (staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go).
- optimistic concurrency: update with expect_rv mismatching -> Conflict,
  like GuaranteedUpdate's CAS loop (etcd3/store.go:257).
- watch: every write appends to an event log; watchers consume from a cursor.
  A bounded log means a too-slow watcher gets TooOldResourceVersion and must
  relist — the etcd compaction / watch-cache-eviction behavior
  (storage/cacher.go; apimachinery watch semantics).
- the pods/<name>/binding subresource sets spec.nodeName atomically and
  refuses double-binding (pkg/registry/core/pod/storage/storage.go:128
  BindingREST -> pod strategy's "pod X is already assigned to node Y").

Thread-safe; watchers may block with a timeout (condition variable).
"""

from __future__ import annotations

import dataclasses
import threading
from kubernetes_tpu_torch.analysis import lockcheck
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Binding, Node, Pod


class Conflict(Exception):
    pass


class NotFound(Exception):
    pass


class TooOldResourceVersion(Exception):
    """Watcher fell behind the bounded event log; relist and re-watch."""


@dataclass(slots=True)
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    kind: str
    obj: Any
    rv: int


_KEY = Tuple[str, str, str]  # kind, namespace, name


def _meta(obj: Any) -> Tuple[str, str]:
    ns = getattr(obj, "namespace", "")
    return ns, obj.name


class ApiServerLite:
    def __init__(self, max_log: int = 200_000, data_dir: Optional[str] = None,
                 fsync: str = "batch", compact_every: int = 200_000):
        """data_dir=None (default) is the pure in-memory benchmark store;
        a data_dir makes every write durable through a WAL + snapshots
        (server/durable.py — the etcd role, etcd3/store.go:85) and restores
        state on construction. Watchers resuming with a pre-restart rv get
        TooOldResourceVersion and must relist, like an etcd compaction."""
        self._lock = lockcheck.make_condition("ApiServerLite._lock")
        self._objects: Dict[_KEY, Any] = {}
        self._rv = 0
        self._log: List[WatchEvent] = []
        self._log_start_rv = 0  # rv of the first retained event
        self._max_log = max_log
        self._durable = None
        if data_dir is not None:
            from kubernetes_tpu_torch.server.durable import DurableStore
            self._durable = DurableStore(data_dir, fsync=fsync,
                                         compact_every=compact_every)
            self._objects, self._rv = self._durable.restore()
            # the event log did not survive: anything before the restored rv
            # is unreachable, so resuming watchers must relist
            self._log_start_rv = self._rv + 1

    # ------------------------------------------------------------------ CRUD

    def create(self, kind: str, obj: Any) -> int:
        with self._lock:
            key = (kind, *_meta(obj))
            if key in self._objects:
                raise Conflict(f"{key} already exists")
            self._rv += 1
            obj.resource_version = self._rv
            self._objects[key] = obj
            self._append_locked(WatchEvent("ADDED", kind, obj, self._rv))
            self._persist_put_locked(key, obj)
            return self._rv

    def get(self, kind: str, namespace: str, name: str) -> Any:
        with self._lock:
            try:
                return self._objects[(kind, namespace, name)]
            except KeyError:
                raise NotFound(f"{kind} {namespace}/{name}") from None

    def list(self, kind: str) -> Tuple[List[Any], int]:
        """Returns (objects, resourceVersion-at-list-time) — the reflector's
        List+Watch handshake (client-go/tools/cache/reflector.go)."""
        with self._lock:
            objs = [o for (k, _, _), o in self._objects.items() if k == kind]
            return objs, self._rv

    def update(self, kind: str, obj: Any, expect_rv: Optional[int] = None) -> int:
        with self._lock:
            key = (kind, *_meta(obj))
            cur = self._objects.get(key)
            if cur is None:
                raise NotFound(str(key))
            if expect_rv is not None and cur.resource_version != expect_rv:
                raise Conflict(
                    f"{key}: rv {expect_rv} != current {cur.resource_version}")
            self._rv += 1
            obj.resource_version = self._rv
            self._objects[key] = obj
            self._append_locked(WatchEvent("MODIFIED", kind, obj, self._rv))
            self._persist_put_locked(key, obj)
            return self._rv

    def delete(self, kind: str, namespace: str, name: str) -> None:
        with self._lock:
            key = (kind, namespace, name)
            obj = self._objects.pop(key, None)
            if obj is None:
                raise NotFound(str(key))
            self._rv += 1
            self._append_locked(WatchEvent("DELETED", kind, obj, self._rv))
            if self._durable is not None:
                self._durable.delete(key, self._rv)
                self._durable.flush()
                self._maybe_compact_locked()

    # ------------------------------------------------------------- binding

    def bind(self, binding: Binding) -> int:
        """The /binding subresource (BindingREST, storage.go:128)."""
        with self._lock:
            return self._bind_locked(binding)

    def bind_many(self, bindings: List[Binding]) -> List[Optional[str]]:
        """Batch of /binding POSTs under one lock acquisition (the scheduler
        issues one per placement; semantics per binding are identical to
        bind()). Returns one entry per binding: None on success, else the
        error string ('conflict: ...' / 'not found: ...')."""
        return self._bind_batch((b.pod_namespace, b.pod_name, b.node_name)
                                for b in bindings)

    def bind_pods_bulk(self, pods: List[Pod]) -> List[Optional[str]]:
        """bind_many over already-placed Pod objects (pod.node_name = the
        chosen node): the columnar drain path reads the identifiers straight
        off the pods instead of minting one Binding per placement. Error
        strings and per-binding semantics identical to bind_many."""
        return self._bind_batch((p.namespace, p.name, p.node_name)
                                for p in pods)

    def _bind_batch(self, triples) -> List[Optional[str]]:
        """Shared body of bind_many/bind_pods_bulk over (namespace, name,
        node_name) triples. The happy path is inlined (no per-binding call/
        exception machinery, one notify + one log trim for the whole batch)
        — this is the 30k-pod storm's write burst, the analog of etcd3 txn
        batching."""
        out: List[Optional[str]] = []
        append = out.append
        with self._lock:
            objects = self._objects
            objects_get = objects.get
            log = self._log
            log_append = log.append
            durable = self._durable
            mk = object.__new__
            ev = WatchEvent
            rv = self._rv
            try:
                for ns, name, node_name in triples:
                    key = ("Pod", ns, name)
                    pod = objects_get(key)
                    if pod is None:
                        append(f"not found: pod {ns}/{name}")
                        continue
                    if pod.node_name:
                        append(f"conflict: pod {pod.key()} is already "
                               f"assigned to node {pod.node_name}")
                        continue
                    new = mk(Pod)
                    new.__dict__.update(pod.__dict__)
                    new.node_name = node_name
                    rv += 1
                    new.resource_version = rv
                    objects[key] = new
                    log_append(ev("MODIFIED", "Pod", new, rv))
                    if durable is not None:
                        durable.put(key, new, rv)
                    append(None)
            finally:
                # even if a durable append raises mid-batch, rv must cover
                # every binding already applied to objects/log — reissuing
                # an rv would break the log's bisect-by-rv invariant
                self._rv = rv
            if durable is not None:
                durable.flush()
                self._maybe_compact_locked()
            if len(log) > self._max_log:
                drop = len(log) - self._max_log
                self._log = log[drop:]
                self._log_start_rv = self._log[0].rv
            self._lock.notify_all()
        return out

    def preempt_pods_bulk(self, victims: List[Pod],
                          binding: Binding) -> Optional[str]:
        """Atomic preemption commit: evict every victim
        (spec.nodeName cleared — the pod re-enters the pending pool, it
        is NOT deleted) AND bind the preemptor, all-or-nothing under one
        lock. Validation runs first; any refusal aborts the whole op
        with NOTHING applied — zero partial preemptions by construction,
        which is the property the scheduler's fault handling (and the
        churn harness's injected eviction faults) leans on.

        Replay convergence (the at-most-once ambiguity): a victim
        already unbound with the same uid counts as already-evicted (the
        prior attempt's write landed; skipped, no second event), and a
        preemptor already bound to the SAME node heals to success — a
        retry of a landed-but-timed-out commit converges instead of
        erroring. A victim bound to a DIFFERENT node, or a preemptor
        bound elsewhere, aborts: the cluster moved and the plan is
        stale. Returns None on success, else the error string."""
        with self._lock:
            evict: List[Tuple[_KEY, Pod]] = []
            for vic in victims:
                key = ("Pod", vic.namespace, vic.name)
                cur = self._objects.get(key)
                if cur is None:
                    return f"preempt: victim not found: {vic.key()}"
                if vic.uid and cur.uid and cur.uid != vic.uid:
                    return f"preempt: victim uid moved: {vic.key()}"
                if not cur.node_name:
                    continue  # already evicted (landed replay): skip
                if vic.node_name and cur.node_name != vic.node_name:
                    return (f"preempt: victim {vic.key()} moved to node "
                            f"{cur.node_name}")
                evict.append((key, cur))
            bkey = ("Pod", binding.pod_namespace, binding.pod_name)
            target = self._objects.get(bkey)
            if target is None:
                return (f"preempt: preemptor not found: "
                        f"{binding.pod_namespace}/{binding.pod_name}")
            bind_needed = True
            if target.node_name:
                if target.node_name == binding.node_name:
                    bind_needed = False  # landed replay: heal to success
                else:
                    return (f"preempt: pod {target.key()} is already "
                            f"assigned to node {target.node_name}")
            # validated — apply all (no fallible step below this line)
            mk = object.__new__
            for key, cur in evict:
                new = mk(Pod)
                new.__dict__.update(cur.__dict__)
                new.node_name = ""
                self._rv += 1
                new.resource_version = self._rv
                self._objects[key] = new
                self._append_locked(WatchEvent("MODIFIED", "Pod", new, self._rv))
                self._persist_put_locked(key, new)
            if bind_needed:
                new = mk(Pod)
                new.__dict__.update(target.__dict__)
                new.node_name = binding.node_name
                self._rv += 1
                new.resource_version = self._rv
                self._objects[bkey] = new
                self._append_locked(WatchEvent("MODIFIED", "Pod", new, self._rv))
                self._persist_put_locked(bkey, new)
            self._lock.notify_all()
            return None

    def _bind_locked(self, binding: Binding) -> int:
        key = ("Pod", binding.pod_namespace, binding.pod_name)
        pod: Optional[Pod] = self._objects.get(key)
        if pod is None:
            raise NotFound(f"pod {binding.pod_namespace}/{binding.pod_name}")
        if pod.node_name:
            raise Conflict(
                f"pod {pod.key()} is already assigned to node {pod.node_name}")
        # shallow clone (same effect as dataclasses.replace, ~4x faster on
        # the 30k-binding storm path; watchers keep seeing the old object)
        new = object.__new__(Pod)
        new.__dict__.update(pod.__dict__)
        new.node_name = binding.node_name
        self._rv += 1
        new.resource_version = self._rv
        self._objects[key] = new
        self._append_locked(WatchEvent("MODIFIED", "Pod", new, self._rv))
        self._persist_put_locked(key, new)
        return self._rv

    # --------------------------------------------------------------- watch

    def watch_since(self, kinds: Tuple[str, ...], from_rv: int,
                    timeout: Optional[float] = None) -> List[WatchEvent]:
        """All events with rv > from_rv for the given kinds; blocks up to
        `timeout` when none are available (0/None = non-blocking)."""
        with self._lock:
            if from_rv < self._log_start_rv - 1 and from_rv < self._rv:
                # events the watcher needs were compacted away — either
                # trimmed from the bounded log, or lost in a restart (the
                # durable store recovers objects, not the event log)
                if not self._log or self._log[0].rv > from_rv + 1:
                    raise TooOldResourceVersion(
                        f"requested rv {from_rv}, log starts at rv "
                        f"{self._log[0].rv if self._log else self._log_start_rv}")
            evs = self._collect_locked(kinds, from_rv)
            if not evs and timeout:
                self._lock.wait(timeout)
                evs = self._collect_locked(kinds, from_rv)
            return evs

    def current_rv(self) -> int:
        with self._lock:
            return self._rv

    # --------------------------------------------------------- durability

    def _persist_put_locked(self, key: _KEY, obj: Any) -> None:
        """Called under the lock after a state mutation + event append."""
        lockcheck.assert_held(self._lock, "_persist_put_locked")
        if self._durable is not None:
            self._durable.put(key, obj, self._rv)
            self._durable.flush()
            self._maybe_compact_locked()

    def _maybe_compact_locked(self) -> None:
        lockcheck.assert_held(self._lock, "_maybe_compact_locked")
        if self._durable.should_compact():
            self._durable.compact(self._objects, self._rv)

    def compact(self) -> None:
        """Force a snapshot + WAL truncation (restore-from-backup.sh's
        backup step; etcd's periodic snapshotting)."""
        with self._lock:
            if self._durable is not None:
                self._durable.compact(self._objects, self._rv)

    def close(self) -> None:
        with self._lock:
            if self._durable is not None:
                self._durable.close()

    # ------------------------------------------------------------ internals

    def _collect_locked(self, kinds: Tuple[str, ...], from_rv: int) -> List[WatchEvent]:
        # events are appended in rv order — binary-search the start
        lockcheck.assert_held(self._lock, "_collect_locked")
        import bisect
        lo = bisect.bisect_right(self._log, from_rv, key=lambda e: e.rv)
        return [e for e in self._log[lo:] if e.kind in kinds]

    def _append_locked(self, ev: WatchEvent) -> None:
        lockcheck.assert_held(self._lock, "_append_locked")
        self._log.append(ev)
        if len(self._log) > self._max_log:
            drop = len(self._log) - self._max_log
            self._log = self._log[drop:]
            self._log_start_rv = self._log[0].rv
        self._lock.notify_all()
