"""Watch-driven federation control plane.

The reference's federated sync controllers run on informers + workqueues
exactly like in-cluster controllers (federation/pkg/federatedtypes/ sync
controller: federated-object informer + per-cluster child informers, keys
through a rate-limited queue, cluster lifecycle triggering full
reconciliation) — they never poll. A bare federation layer exposes only
`sync_all()` called by tests/CLI; this module wires
the SAME sync bodies into the repo's informer/workqueue machinery:

- a federation-apiserver informer per federated kind enqueues object keys
  on ADD/MODIFY/DELETE;
- a Cluster informer enqueues EVERYTHING on any cluster event (join,
  unjoin, readiness flip) — the cluster-lifecycle full-reconcile of the
  reference's clusterDeliverer — and auto-starts/stops the member-cluster
  watches;
- each member cluster gets child-kind informers whose events enqueue the
  PARENT federated key, so member-side drift (a deleted or hand-scaled
  child) self-heals from the member's own watch stream;
- one deduplicating WorkQueue carries the keys; pump() drains it through
  the per-type sync bodies (per-object for the replica-planned kinds,
  per-kind for the propagation kinds whose body is whole-kind);
- start() runs the same loop on a background worker thread (the
  controller-manager's `go wait.Until(worker, ...)`) so a live deployment
  needs NO caller-side pumping: cluster-loss rebalance happens from the
  watch event alone. pump() remains the deterministic single-threaded
  test hook.

No caller ever needs sync_all(): cluster-loss rebalance happens from the
watch event alone (tests/test_federation_watch.py)."""

from __future__ import annotations

import threading
from kubernetes_tpu_torch.analysis import lockcheck
from typing import Dict, Optional, Tuple

from kubernetes_tpu_torch.client.informer import SharedInformerFactory
from kubernetes_tpu_torch.client.workqueue import WorkQueue
from kubernetes_tpu_torch.federation.controller import (
    CLUSTER_KIND,
    FEDERATED_DEPLOY_KIND,
    FEDERATED_DS_KIND,
    FEDERATED_RS_KIND,
    FederatedDaemonSetController,
    FederatedDeploymentController,
    FederatedPropagationController,
    FederatedReplicaSetController,
    FederationControlPlane,
    PROPAGATED_KINDS,
)
from kubernetes_tpu_torch.server.apiserver_lite import NotFound

# whole-kind sentinel: the propagation sync bodies reconcile a kind at a
# time, so their queue key is the kind itself
ALL = "*"

# member child kind -> (federated kind, per_object)
CHILD_TO_FED: Dict[str, Tuple[str, bool]] = {
    "ReplicaSet": (FEDERATED_RS_KIND, True),
    "Deployment": (FEDERATED_DEPLOY_KIND, True),
    "DaemonSet": (FEDERATED_DS_KIND, False),
    "ConfigMap": ("FederatedConfigMap", False),
    "Secret": ("FederatedSecret", False),
    "Namespace": ("FederatedNamespace", False),
}


class FederationSyncLoop:
    def __init__(self, plane: FederationControlPlane):
        self.plane = plane
        self.queue = WorkQueue()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._pump_lock = lockcheck.make_lock("FederationSyncLoop._pump_lock")  # worker and test-hook pump()
        # share one body; serialized so sync bodies never interleave
        self.rs_ctrl = FederatedReplicaSetController(plane)
        self.deploy_ctrl = FederatedDeploymentController(plane)
        self.ds_ctrl = FederatedDaemonSetController(plane)
        self.prop_ctrl = FederatedPropagationController(plane)
        self.syncs = 0  # diagnostics
        self._fed_factory = SharedInformerFactory(plane.api)
        self._member_factories: Dict[str, SharedInformerFactory] = {}
        # federated-object informers: every event enqueues that object
        for kind in (FEDERATED_RS_KIND, FEDERATED_DEPLOY_KIND):
            self._watch_fed_kind(kind, per_object=True)
        for kind in (FEDERATED_DS_KIND,) + tuple(
                "Federated" + k for k in PROPAGATED_KINDS):
            self._watch_fed_kind(kind, per_object=False)
        # cluster lifecycle: any event -> watch/unwatch member + requeue all
        self._fed_factory.informer(CLUSTER_KIND).add_event_handler(
            on_add=lambda c: self._on_cluster(c.name),
            on_update=lambda old, new: self._on_cluster(new.name),
            on_delete=lambda c: self._on_cluster_gone(c.name))

    # ------------------------------------------------------------ watches

    def _watch_fed_kind(self, kind: str, per_object: bool) -> None:
        def key_of(obj):
            if per_object:
                return (kind, obj.namespace, obj.name)
            return (kind, ALL, ALL)

        self._fed_factory.informer(kind).add_event_handler(
            on_add=lambda o: self.queue.add(key_of(o)),
            on_update=lambda old, new: self.queue.add(key_of(new)),
            on_delete=lambda o: self.queue.add(key_of(o)))

    def _on_cluster(self, name: str) -> None:
        if name in self.plane.members \
                and name not in self._member_factories:
            self._watch_member(name)
        self.enqueue_all()

    def _on_cluster_gone(self, name: str) -> None:
        factory = self._member_factories.pop(name, None)
        if factory is not None:
            factory.stop()  # deregister the watches — a rejoin builds a
            # fresh factory; dangling ones would buffer events forever
        self.enqueue_all()

    def _watch_member(self, name: str) -> None:
        """Child-kind informers over one member cluster: member-side drift
        enqueues the federated parent."""
        api = self.plane.members.get(name)
        if api is None:
            return
        factory = SharedInformerFactory(api)
        for child, (fed_kind, per_object) in CHILD_TO_FED.items():
            def key_of(obj, fed_kind=fed_kind, per_object=per_object):
                if per_object:
                    return (fed_kind, obj.namespace, obj.name)
                return (fed_kind, ALL, ALL)

            factory.informer(child).add_event_handler(
                on_add=lambda o, k=key_of: self.queue.add(k(o)),
                on_update=lambda old, new, k=key_of: self.queue.add(k(new)),
                on_delete=lambda o, k=key_of: self.queue.add(k(o)))
        self._member_factories[name] = factory

    def enqueue_all(self) -> None:
        """The clusterDeliverer full-reconcile: every federated object (or
        kind) back onto the queue."""
        for kind in (FEDERATED_RS_KIND, FEDERATED_DEPLOY_KIND):
            for obj in self.plane.api.list(kind)[0]:
                self.queue.add((kind, obj.namespace, obj.name))
        for kind in (FEDERATED_DS_KIND,) + tuple(
                "Federated" + k for k in PROPAGATED_KINDS):
            self.queue.add((kind, ALL, ALL))

    # --------------------------------------------------------------- pump

    def _sync_key(self, key: Tuple[str, str, str]) -> None:
        kind, ns, name = key
        if kind == FEDERATED_RS_KIND or kind == FEDERATED_DEPLOY_KIND:
            ctrl = self.rs_ctrl if kind == FEDERATED_RS_KIND \
                else self.deploy_ctrl
            try:
                frs = self.plane.api.get(kind, ns, name)
            except NotFound:
                # deletion: the propagation of absence — remove children
                self._delete_children(ctrl.CHILD_KIND, ns, name)
                return
            ctrl.sync(frs)
        elif kind == FEDERATED_DS_KIND:
            self.ds_ctrl.sync_all()
        else:
            self.prop_ctrl.sync_all()

    def _delete_children(self, child_kind: str, ns: str, name: str) -> None:
        # ALL members, not just ready ones — a child orphaned in a
        # not-ready cluster would otherwise survive forever (nothing
        # requeues a deleted federated object when the cluster comes back).
        # ONLY managed children: member watch events fire for objects
        # federation never owned (a user's local ReplicaSet, a member
        # Deployment's hash-named child RSs), and deleting those here
        # would destroy user workloads — the same ownership guard
        # propagate_kind applies (controller.py MANAGED_ANNOTATION)
        from kubernetes_tpu_torch.federation.controller import MANAGED_ANNOTATION
        for api in list(self.plane.members.values()):
            try:
                cur = api.get(child_kind, ns, name)
            except NotFound:
                continue
            if getattr(cur, "annotations", {}).get(MANAGED_ANNOTATION) \
                    != "true":
                continue
            try:
                api.delete(child_kind, ns, name)
            except NotFound:
                pass

    def pump(self, rounds: int = 1) -> int:
        """Deterministic single-threaded loop: step every informer (watch
        events fire the handlers above), then drain the queue through the
        sync bodies. Returns syncs performed. This is the TEST hook; a live
        deployment runs the same body on the start() worker thread."""
        n = 0
        with self._pump_lock:
            for _ in range(rounds):
                self._fed_factory.step_all()
                for factory in list(self._member_factories.values()):
                    factory.step_all()
                while len(self.queue):
                    try:
                        key = self.queue.get(timeout=0)
                    except Exception:
                        break
                    try:
                        self._sync_key(key)
                        self.syncs += 1
                        n += 1
                    finally:
                        self.queue.done(key)
        return n

    # -------------------------------------------------- background worker

    def start(self, interval_s: float = 0.05) -> None:
        """Run the pump on a daemon worker thread (the reference's
        controller-manager workers, federated sync controller's
        `go wait.Until`): watch events drain into syncs continuously with
        no caller-side pump(rounds) — cluster-loss rebalance, member-drift
        self-heal, and deletion propagation all happen on their own.
        Idempotent while running; a restart after stop() always yields a
        live worker, even if the previous one is still wedged in a hung
        sync body (each worker watches its OWN stop token, so the orphan
        exits when it unwedges and can never be revived; overlap is
        serialized by _pump_lock)."""
        if self._worker is not None and self._worker.is_alive() \
                and not self._stop.is_set():
            return  # already running
        stop = threading.Event()
        self._stop = stop

        def loop():
            while not stop.wait(interval_s):
                try:
                    self.pump(1)
                except Exception:  # a sync body failing on transient state
                    # (member Conflict, mid-churn NotFound) must not kill
                    # the worker — the queue re-delivers on the next event
                    # or full reconcile, like a crashing controller worker
                    # being restarted by wait.Until
                    continue

        self._worker = threading.Thread(target=loop, daemon=True,
                                        name="federation-sync-worker")
        self._worker.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=timeout)
            if self._worker.is_alive():
                # wedged in a hung sync body: keep the handle (its own stop
                # token is set, so it exits when it unwedges; start() will
                # create a fresh worker with a fresh token)
                return
            self._worker = None
