"""Informers: Reflector -> Store -> SharedInformer over apiserver-lite.

Mirrors client-go tools/cache (reflector.go ListAndWatch, store.go,
shared_informer.go, thread_safe_store.go indexers):

- Reflector: List() for a consistent snapshot + resourceVersion, then a watch
  loop from that rv; TooOldResourceVersion (the etcd-compaction analog)
  triggers a full relist, exactly like reflector.go's "watch of X closed with:
  too old resource version" path.
- Store: thread-safe keyed store with named indexes (thread_safe_store.go) —
  e.g. pods-by-node for the node lifecycle controller.
- SharedInformer: one reflector fanned out to N event handlers; handlers get
  (add, update(old,new), delete) callbacks and a has_synced() barrier.
- SharedInformerFactory: one informer per kind shared by all controllers, the
  informers.SharedInformerFactory analog used by the controller manager
  (cmd/kube-controller-manager/app/controllermanager.go shared informers).

Deliberate TPU-era design departure: the reference pushes every event through
DeltaFIFO goroutines; here handlers run synchronously on the informer thread
(controllers only enqueue keys, so handler work is O(µs)) and heavy state
lives in tensors refreshed from the Store's generation counters.
"""

from __future__ import annotations

import threading
from kubernetes_tpu_torch.analysis import lockcheck
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

from kubernetes_tpu_torch.server.apiserver_lite import (
    ApiServerLite,
    TooOldResourceVersion,
)


def meta_namespace_key(obj: Any) -> str:
    """cache.MetaNamespaceKeyFunc: "<ns>/<name>" (or "<name>" cluster-scoped)."""
    ns = getattr(obj, "namespace", "")
    return f"{ns}/{obj.name}" if ns else obj.name


class Store:
    """Thread-safe keyed object store with named indexes
    (client-go tools/cache/thread_safe_store.go)."""

    def __init__(self, key_func: Callable[[Any], str] = meta_namespace_key):
        self._key = key_func
        self._lock = lockcheck.make_rlock("Store._lock")
        self._items: Dict[str, Any] = {}
        # index name -> (index_func, value -> set of keys)
        self._indexers: Dict[str, Callable[[Any], List[str]]] = {}
        self._indices: Dict[str, Dict[str, set]] = {}

    def add_index(self, name: str, index_func: Callable[[Any], List[str]]) -> None:
        with self._lock:
            self._indexers[name] = index_func
            idx: Dict[str, set] = {}
            for key, obj in self._items.items():
                for v in index_func(obj):
                    idx.setdefault(v, set()).add(key)
            self._indices[name] = idx

    def _update_index_locked(self, key: str, old: Any, new: Any) -> None:
        lockcheck.assert_held(self._lock, "_update_index_locked")
        for name, fn in self._indexers.items():
            idx = self._indices[name]
            old_vals = set(fn(old)) if old is not None else set()
            new_vals = set(fn(new)) if new is not None else set()
            for v in old_vals - new_vals:
                bucket = idx.get(v)
                if bucket is not None:
                    bucket.discard(key)
                    if not bucket:
                        del idx[v]
            for v in new_vals - old_vals:
                idx.setdefault(v, set()).add(key)

    def upsert(self, obj: Any) -> Optional[Any]:
        """Insert/replace; returns the previous object (None if new)."""
        key = self._key(obj)
        with self._lock:
            old = self._items.get(key)
            self._items[key] = obj
            self._update_index_locked(key, old, obj)
            return old

    def remove(self, obj: Any) -> Optional[Any]:
        key = self._key(obj)
        with self._lock:
            old = self._items.pop(key, None)
            if old is not None:
                self._update_index_locked(key, old, None)
            return old

    def replace(self, objs: List[Any]) -> Tuple[List[Any], List[Any], List[Tuple[Any, Any]]]:
        """Atomic resync (store.Replace): returns (added, deleted, updated
        (old,new) pairs) relative to previous contents."""
        with self._lock:
            new_items = {self._key(o): o for o in objs}
            added = [o for k, o in new_items.items() if k not in self._items]
            deleted = [o for k, o in self._items.items() if k not in new_items]
            updated = [(self._items[k], o) for k, o in new_items.items()
                       if k in self._items and self._items[k] is not o]
            for o in deleted:
                self.remove(o)
            for o in objs:
                self.upsert(o)
            return added, deleted, updated

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            return self._items.get(key)

    def list(self) -> List[Any]:
        with self._lock:
            return list(self._items.values())

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._items.keys())

    def by_index(self, name: str, value: str) -> List[Any]:
        """Indexer.ByIndex: all objects whose index_func yields `value`."""
        with self._lock:
            keys = self._indices.get(name, {}).get(value, ())
            return [self._items[k] for k in keys]

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class _Handler:
    __slots__ = ("on_add", "on_update", "on_delete")

    def __init__(self, on_add, on_update, on_delete):
        self.on_add = on_add or (lambda obj: None)
        self.on_update = on_update or (lambda old, new: None)
        self.on_delete = on_delete or (lambda obj: None)


class SharedInformer:
    """One kind's reflector + store + handler fan-out."""

    def __init__(self, api: ApiServerLite, kind: str,
                 key_func: Callable[[Any], str] = meta_namespace_key):
        self.api = api
        self.kind = kind
        self.store = Store(key_func)
        self._handlers: List[_Handler] = []
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._rv = 0
        self._lock = lockcheck.make_lock("SharedInformer._lock")

    def add_event_handler(self, on_add=None, on_update=None, on_delete=None) -> None:
        """Late handlers get synthetic ADDs for current contents, like
        sharedIndexInformer.AddEventHandler's initial delivery."""
        h = _Handler(on_add, on_update, on_delete)
        with self._lock:
            self._handlers.append(h)
            if self._synced.is_set():
                for obj in self.store.list():
                    h.on_add(obj)

    def has_synced(self) -> bool:
        return self._synced.is_set()

    # ------------------------------------------------------------ run loop

    def _relist(self) -> None:
        objs, rv = self.api.list(self.kind)
        added, deleted, updated = self.store.replace(objs)
        self._rv = rv
        with self._lock:
            handlers = list(self._handlers)
        for obj in added:
            for h in handlers:
                h.on_add(obj)
        for old, new in updated:
            for h in handlers:
                h.on_update(old, new)
        for obj in deleted:
            for h in handlers:
                h.on_delete(obj)

    def step(self, wait: float = 0.0) -> int:
        """One poll of the watch stream; usable directly in deterministic
        tests (no thread). Returns events processed."""
        if not self._synced.is_set():
            self._relist()
            self._synced.set()
            return 0
        try:
            events = self.api.watch_since((self.kind,), self._rv, timeout=wait)
        except TooOldResourceVersion:
            self._relist()
            return 0
        with self._lock:
            handlers = list(self._handlers)
        for ev in events:
            self._rv = ev.rv
            if ev.type == "DELETED":
                self.store.remove(ev.obj)
                for h in handlers:
                    h.on_delete(ev.obj)
            else:
                old = self.store.upsert(ev.obj)
                if old is None:
                    for h in handlers:
                        h.on_add(ev.obj)
                else:
                    for h in handlers:
                        h.on_update(old, ev.obj)
        return len(events)

    def run(self, poll: float = 0.05) -> None:
        self._thread = threading.Thread(
            target=self._loop, args=(poll,), daemon=True,
            name=f"informer-{self.kind}")
        self._thread.start()

    def _loop(self, poll: float) -> None:
        while not self._stop.is_set():
            self.step(wait=poll)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


class SharedInformerFactory:
    """informers.SharedInformerFactory: one shared informer per kind."""

    def __init__(self, api: ApiServerLite):
        self.api = api
        self._informers: Dict[str, SharedInformer] = {}
        self._lock = lockcheck.make_lock("SharedInformerFactory._lock")
        self._started = False
        self._poll = 0.05

    def informer(self, kind: str) -> SharedInformer:
        with self._lock:
            inf = self._informers.get(kind)
            if inf is None:
                inf = SharedInformer(self.api, kind)
                self._informers[kind] = inf
                if self._started:
                    inf.run(self._poll)
            return inf

    def start(self, poll: float = 0.05) -> None:
        with self._lock:
            self._started = True
            self._poll = poll
            for inf in self._informers.values():
                if inf._thread is None:
                    inf.run(poll)

    def step_all(self, wait: float = 0.0) -> int:
        """Deterministic single-threaded pump for tests/benchmarks."""
        with self._lock:
            infs = list(self._informers.values())
        return sum(inf.step(wait=wait) for inf in infs)

    def wait_for_cache_sync(self, timeout: float = 10.0) -> bool:
        with self._lock:
            infs = list(self._informers.values())
        end = time.monotonic() + timeout
        for inf in infs:
            while not inf.has_synced():
                if inf._thread is None:
                    inf.step()  # no thread: pump synchronously
                    continue
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return False
                inf._synced.wait(min(remaining, 0.25))
        return True

    def stop(self) -> None:
        with self._lock:
            infs = list(self._informers.values())
        for inf in infs:
            inf.stop()
