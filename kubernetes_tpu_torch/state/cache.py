"""Scheduler cache: authoritative in-memory cluster state incl. assumed pods.

TPU-native analog of schedulerCache (reference:
plugin/pkg/scheduler/schedulercache/cache.go:44-386). Semantics preserved:

- AssumePod (cache.go:109): optimistically add a just-scheduled pod to its
  chosen node *before* the bind API call returns, so the next scheduling
  decision sees it. Unblocks pipelining.
- FinishBinding (cache.go:130): start the TTL clock; if the informer never
  confirms the bind (apiserver write lost), cleanup_assumed (cache.go:355)
  expires the assumption and the pod's resources are released — the
  self-healing path.
- ForgetPod (cache.go:154): bind failed synchronously; undo immediately.
- AddPod/UpdatePod/RemovePod (cache.go:214/248/275): informer-confirmed
  transitions; a confirmed Add of an assumed pod just clears the deadline.
- Add/Update/RemoveNode (cache.go:304/316/328).
- UpdateNodeNameToInfoMap (cache.go:79): generation-diffed snapshot — here it
  feeds the tensor snapshot's delta refresh instead of cloning Go structs.

Thread-safety: a single lock, like the reference's mutex (cache.go:50). The
engine runs scheduling on one thread (matching the reference's single
scheduleOne goroutine, scheduler.go:253) with informer updates arriving from
the watch thread.
"""

from __future__ import annotations

import threading
from kubernetes_tpu_torch.analysis import lockcheck
import time
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.state.node_info import NodeInfo


class _PodState:
    __slots__ = ("pod", "assumed", "deadline", "binding_finished")

    def __init__(self, pod: Pod):
        self.pod = pod
        self.assumed = False
        self.deadline: Optional[float] = None
        self.binding_finished = False


# the aff-log delta of a pod whose node came back (see SchedulerCache)
RETURNED = 2


class SchedulerCache:
    # how many affinity-churn events the Protean patch log retains; a
    # consumer further behind than this rebuilds wholesale
    AFF_LOG_MAX = 8192

    def __init__(self, ttl_seconds: float = 30.0, now: Callable[[], float] = time.monotonic):
        self._ttl = ttl_seconds
        self._now = now
        self._lock = lockcheck.make_lock("SchedulerCache._lock")
        self._pod_states: Dict[str, _PodState] = {}
        self._nodes: Dict[str, NodeInfo] = {}
        # occupancy-churn sequence: bumped once per pod entering or leaving
        # any NodeInfo (assume, confirm-move, foreign add/remove, TTL
        # expiry, forget). The wave engine's cached AffinityData folds its
        # OWN assumes into this counter, so aff_seq != expected means a
        # FOREIGN mutation may have invalidated the static topology arrays.
        # Confirming our own assume in place mutates no NodeInfo
        # and does not bump. Widened from affinity-carrying pods to ALL
        # pods: a PLAIN pod whose labels match a pending class's
        # anti-affinity selector is a new forbidden-domain source the old
        # keying silently missed; the Protean patch log below keeps the
        # widened invalidation from degrading into wholesale rebuilds.
        self.aff_seq = 0
        # Protean patch log (PAPERS.md §Protean: key caches on
        # exactly what invalidates them): every aff_seq bump appends
        # (seq_after, pod, node_name, delta) with delta +1 for a pod
        # entering a NodeInfo and -1 for one leaving, so a consumer whose
        # expectation fell behind can PATCH the exact rows foreign churn
        # touched instead of rebuilding its topology arrays wholesale.
        # delta == 0 is the "structure moved under this pod" sentinel
        # (node removed: the pod's NodeInfo became a tombstone stub under
        # the same name — a no-op for label-derived views, since the
        # snapshot keeps the row and its label content in place).
        # delta == RETURNED marks a pod whose node came back (add_node over
        # a node-less NodeInfo): an encoding built while the node was
        # absent resolved the pod's domains to nothing.
        # Bounded ring: _aff_log_start is the lowest seq whose delta is
        # still retained; consumers behind it must rebuild.
        self._aff_log: List[tuple] = []
        self._aff_log_start = 0
        # exact count of resident pods carrying affinity/anti-affinity
        # terms: the fast lane's eligibility gate — an
        # EXISTING pod's anti-affinity can forbid a new plain pod
        # (k8s 1.8 InterPodAffinityPredicate symmetry), so the fast lane
        # only runs when this is zero. Maintained in _aff_event_locked,
        # which every pod enter/leave already routes through.
        self._aff_pods = 0

    # ---------------------------------------------------------- churn log

    def _aff_event_locked(self, pod: Pod, node_name: str, delta: int) -> None:
        """Bump aff_seq AND record what moved (caller holds the lock)."""
        lockcheck.assert_held(self._lock, "_aff_event_locked")
        self.aff_seq += 1
        if delta in (1, -1) and pod.has_pod_affinity():
            self._aff_pods += delta
        log = self._aff_log
        log.append((self.aff_seq, pod, node_name, delta))
        # amortized trim: shifting per append would be O(ring) on the
        # 20k-assumes/s path; trimming at 2x keeps memory bounded at one
        # extra ring while the shift cost amortizes to O(1) per event
        if len(log) >= 2 * self.AFF_LOG_MAX:
            del log[:len(log) - self.AFF_LOG_MAX]

    def aff_events_since(self, seq: int) -> Optional[List[tuple]]:
        """The (seq, pod, node_name, delta) events after `seq`, oldest
        first — or None when the bounded ring no longer covers the gap
        (the consumer fell too far behind and must rebuild). Sequences are
        consecutive integers, so coverage is a length check, not a scan."""
        with self._lock:
            behind = self.aff_seq - seq
            if behind <= 0:
                return []
            if behind > len(self._aff_log):
                return None
            return list(self._aff_log[len(self._aff_log) - behind:])

    # ------------------------------------------------------------------ pods

    def assume_pod(self, pod: Pod) -> None:
        key = pod.key()
        with self._lock:
            if key in self._pod_states:
                raise KeyError(f"pod {key} is already in the cache")
            self._add_pod_locked(pod)
            st = _PodState(pod)
            st.assumed = True
            self._pod_states[key] = st

    def assume_pods_bulk(self, placements, derived) -> None:
        """AssumePod for a whole batch under one lock acquisition.
        placements = [(pod, class_index)] with pod.node_name already set;
        derived = per-class [(Resource, nonzero_cpu, nonzero_mem, ports)].
        Semantics identical to assume_pod per pod, in order."""
        with self._lock:
            for pod, c in placements:
                key = pod.key()
                if key in self._pod_states:
                    raise KeyError(f"pod {key} is already in the cache")
                req, ncpu, nmem, ports = derived[c]
                info = self._nodes.get(pod.node_name)
                if info is None:
                    info = NodeInfo()
                    self._nodes[pod.node_name] = info
                info.add_pod_precomputed(pod, req, ncpu, nmem, ports)
                self._aff_event_locked(pod, pod.node_name, 1)
                st = _PodState(pod)
                st.assumed = True
                self._pod_states[key] = st

    def assume_pods_grouped(self, groups) -> Dict[str, NodeInfo]:
        """AssumePod for a whole wave under one lock, columnar: groups =
        [(node_name, pods, req, ncpu, nmem, ports)] where each entry is a
        run of spec-equal pods (pod.node_name already set) headed to ONE
        node. One scaled NodeInfo update per (node, class) group instead of
        one object walk per pod — semantics identical to assume_pod per
        pod, in group order. Returns the touched NodeInfos by name so the
        caller can sync snapshot generation bookkeeping."""
        touched: Dict[str, NodeInfo] = {}
        with self._lock:
            states = self._pod_states
            nodes_get = self._nodes.get
            mk = _PodState
            for node_name, pods, req, ncpu, nmem, ports in groups:
                info = nodes_get(node_name)
                if info is None:
                    info = NodeInfo()
                    self._nodes[node_name] = info
                info.add_pods_same_class(pods, req, ncpu, nmem, ports)
                for pod in pods:
                    self._aff_event_locked(pod, node_name, 1)
                touched[node_name] = info
                for pod in pods:
                    key = pod.key()
                    if key in states:
                        raise KeyError(f"pod {key} is already in the cache")
                    st = mk(pod)
                    st.assumed = True
                    states[key] = st
        return touched

    def add_pods_bulk(self, pods: List[Pod]) -> List[str]:
        """Informer-confirmed adds for a batch under ONE lock (the columnar
        watch drain of a bind storm). Per-pod semantics identical to
        add_pod(); returns the names of nodes whose NodeInfo was MUTATED
        (confirming our own assume on the same node mutates nothing — the
        common case — so the caller's targeted-refresh hint stays empty on
        a pure confirmation stream)."""
        touched: List[str] = []
        with self._lock:
            states = self._pod_states
            for pod in pods:
                key = pod.key()
                st = states.get(key)
                if st is not None and st.assumed:
                    if st.pod.node_name != pod.node_name:
                        self._remove_pod_locked(st.pod)
                        self._add_pod_locked(pod)
                        touched.append(st.pod.node_name)
                        touched.append(pod.node_name)
                    st.pod = pod
                    st.assumed = False
                    st.deadline = None
                elif st is None:
                    self._add_pod_locked(pod)
                    states[key] = _PodState(pod)
                    touched.append(pod.node_name)
        return touched

    def finish_binding(self, pod: Pod) -> None:
        key = pod.key()
        with self._lock:
            st = self._pod_states.get(key)
            if st is None or not st.assumed:
                return
            st.binding_finished = True
            st.deadline = self._now() + self._ttl

    def finish_bindings_bulk(self, pods: List[Pod],
                             keys: Optional[List[str]] = None) -> None:
        """FinishBinding for a batch under one lock; one clock read. `keys`
        lets the caller share already-computed pod keys."""
        deadline = self._now() + self._ttl
        if keys is None:
            keys = [pod.key() for pod in pods]
        with self._lock:
            get = self._pod_states.get
            for key in keys:
                st = get(key)
                if st is None or not st.assumed:
                    continue
                st.binding_finished = True
                st.deadline = deadline

    def forget_pod(self, pod: Pod) -> None:
        key = pod.key()
        with self._lock:
            st = self._pod_states.get(key)
            if st is None:
                return
            if st.pod.node_name != pod.node_name and st.pod.node_name != "":
                # the reference errors on node mismatch (cache.go:161); we
                # tolerate and remove by the cached location
                pass
            if st.assumed:
                self._remove_pod_locked(st.pod)
                del self._pod_states[key]

    def forget_pods_bulk(self, pods: List[Pod]) -> None:
        """ForgetPod for a whole group under ONE lock acquisition — the
        atomic-rollback half of gang scheduling: a below-quorum
        or fence-rolled-back gang releases every member's assumed capacity
        in one pass, so no reader interleaves with a half-rolled-back
        gang. Per-pod semantics identical to forget_pod, in order."""
        with self._lock:
            states = self._pod_states
            for pod in pods:
                st = states.get(pod.key())
                if st is not None and st.assumed:
                    self._remove_pod_locked(st.pod)
                    del states[pod.key()]

    def add_pod(self, pod: Pod) -> None:
        """Informer-confirmed pod add (cache.go:214)."""
        key = pod.key()
        with self._lock:
            st = self._pod_states.get(key)
            if st is not None and st.assumed:
                if st.pod.node_name != pod.node_name:
                    # scheduler decision overridden (e.g. another scheduler);
                    # move the pod (cache.go:224-232 updatePod path)
                    self._remove_pod_locked(st.pod)
                    self._add_pod_locked(pod)
                st.pod = pod
                st.assumed = False
                st.deadline = None
            elif st is None:
                self._add_pod_locked(pod)
                self._pod_states[key] = _PodState(pod)

    def update_pod(self, old: Pod, new: Pod) -> None:
        with self._lock:
            st = self._pod_states.get(old.key())
            if st is None:
                self._add_pod_locked(new)
                self._pod_states[new.key()] = _PodState(new)
                return
            self._remove_pod_locked(st.pod)
            self._add_pod_locked(new)
            st.pod = new

    def remove_pod(self, pod: Pod) -> None:
        key = pod.key()
        with self._lock:
            st = self._pod_states.pop(key, None)
            if st is not None:
                self._remove_pod_locked(st.pod)

    def is_assumed(self, pod_key: str) -> bool:
        with self._lock:
            st = self._pod_states.get(pod_key)
            return bool(st and st.assumed)

    def claimed_node(self, pod_key: str) -> Optional[str]:
        """The node this pod currently occupies in cache truth (assumed
        OR confirmed), or None — the bind fence's double-claim probe:
        with N independent schedulers racing one cell, a
        commit for a pod some other process already placed must fence
        out as a typed conflict instead of reaching the store."""
        with self._lock:
            st = self._pod_states.get(pod_key)
            if st is None:
                return None
            return st.pod.node_name or None

    def pod_count(self) -> int:
        with self._lock:
            return len(self._pod_states)

    # ----------------------------------------------------------------- nodes

    def add_node(self, node: Node) -> None:
        with self._lock:
            info = self._nodes.get(node.name)
            if info is None:
                info = NodeInfo()
                self._nodes[node.name] = info
            returned = info.node is None
            info.set_node(node)
            if returned:
                # the pods a tombstone (or an early watch event) kept
                # become topology sources again; an encoding built while
                # the node was absent must learn of them (the reference
                # logs nothing here and places an anti-affinity pod beside
                # them on the respawned node)
                for p in info.pods:
                    self._aff_event_locked(p, node.name, RETURNED)

    def update_node(self, node: Node) -> None:
        self.add_node(node)

    def remove_node(self, name: str) -> List[Pod]:
        """RemoveNode (cache.go:328) + the liveness audit: ASSUMED
        pods on the removed node are FORGOTTEN (their optimistic capacity
        claim pointed at a node that no longer exists — keeping it would
        leak phantom occupancy until TTL, and the owner must requeue them
        before their bind turns into a ghost) and returned so the owner
        can decide requeue vs orphan. Confirmed pods survive into the
        stub (the informer owns their lifecycle).

        The entry itself becomes a TOMBSTONE (node=None NodeInfo) instead
        of disappearing: the snapshot then marks the row valid=False in
        place — one static-row rewrite — rather than restructuring node
        membership, which costs a FULL re-tensorization + device upload +
        encoding/precompute rebuild per event (at 5k nodes that is
        seconds per kill; 10%/min churn would spend the whole budget
        rebuilding). A respawn under the same name rides the same
        delta path. Podless tombstones are purged in amortized batches
        (purge_tombstones) so permanent departures still reclaim rows."""
        requeue: List[Pod] = []
        with self._lock:
            info = self._nodes.get(name)
            if info is None:
                return requeue
            assumed_keys = set()
            for key, st in self._pod_states.items():
                if st.assumed and st.pod.node_name == name:
                    assumed_keys.add(key)
            for key in assumed_keys:
                st = self._pod_states.pop(key)
                requeue.append(st.pod)
                self._aff_event_locked(st.pod, name, -1)
            survivors = [p for p in info.pods
                         if p.key() not in assumed_keys]
            stub = NodeInfo()
            for p in survivors:
                stub.add_pod(p)
                # the pods' NodeInfo (and its node object) moved —
                # cached topology arrays resolved domains through it;
                # delta 0 = "structure moved", never patchable
                self._aff_event_locked(p, name, 0)
            self._nodes[name] = stub
        return requeue

    def purgeable_tombstones(self) -> int:
        with self._lock:
            return sum(1 for i in self._nodes.values()
                       if i.node is None and not i.pods)

    def purge_tombstones(self) -> int:
        """Drop podless tombstones — the amortized membership compaction.
        The caller must force a full snapshot refresh afterwards (this IS
        the membership restructuring remove_node defers)."""
        with self._lock:
            names = [nm for nm, i in self._nodes.items()
                     if i.node is None and not i.pods]
            for nm in names:
                del self._nodes[nm]
            return len(names)

    # -------------------------------------------------------------- snapshot

    def node_infos(self) -> Dict[str, NodeInfo]:
        """Live references (caller must treat as read-only, or hold no pointer
        across mutations). The tensor snapshot reads generations from these —
        the moral equivalent of UpdateNodeNameToInfoMap (cache.go:79)."""
        with self._lock:
            return dict(self._nodes)

    def node_info(self, name: str) -> Optional[NodeInfo]:
        """One live NodeInfo reference (same read-only contract as
        node_infos) — the fast-lane fence re-validates its single winner
        without copying the whole map."""
        with self._lock:
            return self._nodes.get(name)

    def affinity_pod_count(self) -> int:
        """Resident pods carrying affinity/anti-affinity terms — the
        fast lane falls back to the full wave eval whenever this is
        nonzero."""
        with self._lock:
            return self._aff_pods

    def snapshot_infos(self) -> Dict[str, NodeInfo]:
        with self._lock:
            return {k: v.clone_shallow() for k, v in self._nodes.items()}

    # -------------------------------------------------------------- expiry

    def cleanup_assumed(self) -> List[str]:
        """Expire assumed pods whose bind was never confirmed within TTL
        (cache.go:355 cleanupAssumedPods). Returns expired pod keys."""
        expired = []
        now = self._now()
        with self._lock:
            for key, st in list(self._pod_states.items()):
                if st.assumed and st.binding_finished and st.deadline is not None \
                        and now >= st.deadline:
                    self._remove_pod_locked(st.pod)
                    del self._pod_states[key]
                    expired.append(key)
        return expired

    # -------------------------------------------------------------- internal

    def _add_pod_locked(self, pod: Pod) -> None:
        lockcheck.assert_held(self._lock, "_add_pod_locked")
        info = self._nodes.get(pod.node_name)
        if info is None:
            info = NodeInfo()
            self._nodes[pod.node_name] = info
        info.add_pod(pod)
        self._aff_event_locked(pod, pod.node_name, 1)

    def _remove_pod_locked(self, pod: Pod) -> None:
        lockcheck.assert_held(self._lock, "_remove_pod_locked")
        info = self._nodes.get(pod.node_name)
        if info is not None:
            info.remove_pod(pod)
            self._aff_event_locked(pod, pod.node_name, -1)


class BindLedger:
    """Idempotency ledger for /bind over the wire: exactly-once
    replay protection for the at-most-once ambiguity of a landed bind timeout.

    A frontend whose /bind timed out cannot know whether the bind LANDED
    (response lost) or never ran (request lost). It retries with the SAME
    idempotency key; the ledger makes that retry converge instead of
    double-booking:

      - ``ok``        -> the bind completed; the retry is answered from the
        record with no second assume and no second apiserver write;
      - ``uncertain`` -> the server's own downstream write errored (which
        is itself ambiguous — a bind API timeout may have landed). The
        retry REPLAYS against the RECORDED node, never a fresh choice:
        re-binding the recorded node is idempotent at the store ("already
        assigned to <same node>" heals to success), while a fresh choice
        after a landed write would be the duplicate bind this ledger
        exists to prevent;
      - ``pending``   -> a concurrent duplicate (client retried while the
        original is still in flight): answered retryable-busy, the client
        backs off and re-asks;
      - ``conflict``  -> the fence refused the attempt; nothing landed, so
        a replayed duplicate of THAT attempt gets the same typed answer
        (the client's next attempt uses a fresh key for its fresh choice).

    Bounded LRU over COMPLETED entries (pending/uncertain entries are
    pinned — trimming an uncertain record would reopen the ambiguity
    window); own lock, so ledger reads never contend with the backend's
    evaluation lock."""

    def __init__(self, cap: int = 65536):
        from collections import OrderedDict
        self._cap = cap
        self._lock = lockcheck.make_lock("BindLedger._lock")
        self._entries: "OrderedDict[str, list]" = OrderedDict()
        # entry: [status, node, error] with status in
        # {"pending", "ok", "conflict", "uncertain"}

    def begin(self, key: str, node: str):
        """Open (or re-open) an attempt. Returns (verdict, node, error):
        verdict "fresh" -> proceed with the caller's node; "replay" ->
        proceed with the RETURNED node (a prior uncertain attempt owns the
        choice); "done" -> answer (node, error) without doing anything;
        "pending" -> a twin is in flight, answer retryable-busy."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self._entries[key] = ["pending", node, ""]
                self._trim_locked()
                return "fresh", node, ""
            status = e[0]
            if status == "pending":
                return "pending", e[1], ""
            if status in ("ok", "conflict"):
                self._entries.move_to_end(key)
                return "done", e[1], e[2]
            # uncertain: the retry re-runs the attempt against the
            # recorded node (see class docstring)
            e[0] = "pending"
            return "replay", e[1], e[2]

    def finish(self, key: str, status: str, error: str = "") -> None:
        """Record an attempt's outcome: "ok" | "conflict" | "uncertain"."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self._entries[key] = [status, "", error]
            else:
                e[0] = status
                e[2] = error
            self._trim_locked()

    def abandon(self, key: str) -> None:
        """Drop a PENDING entry whose attempt did nothing (shed before any
        side effect), so a same-key retry starts fresh instead of replaying
        a non-attempt. No-op for completed or uncertain records."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e[0] == "pending":
                del self._entries[key]

    def _trim_locked(self) -> None:
        # evict oldest COMPLETED entries only (docstring: pending and
        # uncertain records are pinned). Incremental oldest-first scan —
        # at capacity this runs per bind, and materializing a 65k-key
        # list per commit would put an O(cap) copy on the bind hot path
        lockcheck.assert_held(self._lock, "_trim_locked")
        while len(self._entries) > self._cap:
            for k in self._entries:
                if self._entries[k][0] in ("ok", "conflict"):
                    del self._entries[k]
                    break
            else:
                return  # everything live is pinned

    def stats(self):
        with self._lock:
            out = {"entries": len(self._entries)}
            for st in ("pending", "ok", "conflict", "uncertain"):
                out[st] = sum(1 for e in self._entries.values()
                              if e[0] == st)
            return out
