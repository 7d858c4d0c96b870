"""Host-side scheduling engine: snapshot -> device batch -> assume.

PyTorch port of kubernetes_tpu/engine/scheduler_engine.py, on one device
(the card unless the caller names another):

- the extender verdict: ``evaluate_pod`` (one pod, [1, N]) with the warm
  lane of an ``EvalCache`` (result memo, encoded-class LRU, vocab-growth
  isolation) and ``evaluate_pods_batch`` (a coalesced batch, one fused
  [C, N] evaluation for its unique classes); pods whose features the
  device encoding over-approximates take the exact object-level oracle
  (ops/oracle.py);
- the synchronous path, ``SchedulingEngine.schedule`` (modes ``wave`` and
  ``strict``);
- the pipelined drain, ``dispatch_waves`` / ``harvest_waves``: dispatch
  encodes a chunk (vocab_gen-keyed encoding reuse), hands the wave loop to
  the engine's worker thread WITHOUT waiting for it and returns a
  WaveHandle; harvest joins the job, re-validates the blind wave's
  placements against current occupancy (the capacity fence and its
  topology mirror, the host-check and Policy re-checks, the liveness
  fence), finishes strict-tail pods via the conflict-round loop
  (waves.tail_rounds_loop) or the per-pod scan, assumes the survivors
  columnar, places host-exact rows with the exact oracle tail and hands
  conflicts back for requeue. Quorum-ready gangs ride a wave as ordinary
  rows; the harvest's gang fence commits a gang only when at least its
  quorum survives, and otherwise drops every member before anything is
  assumed;
- wave-path preemption's device pre-filter, ``preempt_scan``: one [C, N]
  victim scan (ops/preempt.victim_scan) over the snapshot's priority-band
  columns, uploaded by ``_prio_on_device``.

With a mesh (parallel/mesh), every node-indexed tensor the engine owns —
the snapshot sync, the wave encodings' topology views, the committed-
occupancy seed — is uploaded SHARDED over the mesh's devices and stays
resident between waves (dynamic arrays re-upload only the shards owning
dirty rows), and the wave loop runs its two-stage SPMD path.

The reference overlaps device and host through JAX's asynchronous
dispatch. Here the wave loop (one host check per wave) runs on a worker
thread of the engine, on its own CUDA stream ordered after the dispatch's
uploads by an event; jobs run one at a time in dispatch order, so the
round-robin counter a job chains from is final when it reads it. The job
ends with the wave's one device->host copy, so a harvest never queues
behind the next wave's work. Every host buffer a job reads is uploaded as
a copy (convert.tensor_from_numpy), since the harvest folds commits into
them in place while a later wave may still run; the uploads go through
the sanitizer's seams (analysis/sanitize), which check that rule under
GRAFT_SANITIZE=1.
"""

from __future__ import annotations

import dataclasses as _dc
import functools
import math
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch import resolve_device
from kubernetes_tpu_torch.analysis import sanitize
from kubernetes_tpu_torch.api.types import Pod, SelectorOperator
from kubernetes_tpu_torch.convert import tensor_from_numpy
from kubernetes_tpu_torch.engine import waves
from kubernetes_tpu_torch.engine.batch import (
    U32_MASK,
    NodeState,
    gather_place_batch,
)
from kubernetes_tpu_torch.observability import podtrace
from kubernetes_tpu_torch.observability import recorder as flightrec
from kubernetes_tpu_torch.observability.podtrace import TRACER
from kubernetes_tpu_torch.observability.recorder import RECORDER
from kubernetes_tpu_torch.ops import affinity as aff_ops
from kubernetes_tpu_torch.ops import oracle
from kubernetes_tpu_torch.ops import predicates as preds
from kubernetes_tpu_torch.ops import preempt as preempt_ops
from kubernetes_tpu_torch.ops import priorities as prio
from kubernetes_tpu_torch.ops.oracle_ext import (
    AffinityMeta,
    SchedulingContext,
    _own_terms,
    term_matches_pod,
)
from kubernetes_tpu_torch.ops.predicates import bucket, int_matmul
from kubernetes_tpu_torch.parallel import mesh as mesh_mod
from kubernetes_tpu_torch.state.cache import SchedulerCache
from kubernetes_tpu_torch.state.classes import ClassBatch, pod_class_key
from kubernetes_tpu_torch.state.snapshot import (
    R_CPU,
    R_MEM,
    R_OVERLAY,
    R_SCRATCH,
    ClusterSnapshot,
)
from kubernetes_tpu_torch.state.volumes import VolumeContext
from kubernetes_tpu_torch.utils.trace import COUNTERS, timed_span

# hardPodAffinitySymmetricWeight, the reference's default
HARD_POD_AFFINITY_WEIGHT = 1
I32 = torch.int32


class PlacementResult:
    __slots__ = ("pod", "node_name", "fit_count")

    def __init__(self, pod: Pod, node_name: Optional[str], fit_count: int):
        self.pod = pod
        self.node_name = node_name
        self.fit_count = fit_count

    def __repr__(self):
        return f"Placement({self.pod.key()} -> {self.node_name})"


def _aff_mode(adata, priorities) -> Tuple[Tuple[bool, bool, bool],
                                          Tuple[int, int]]:
    w_ip = sum(w for nm, w in priorities if nm == "InterPodAffinityPriority")
    w_sp = sum(w for nm, w in priorities if nm == "SelectorSpreadPriority")
    return ((bool(adata.fits_needed), bool(w_ip) and adata.prio_needed,
             bool(w_sp) and adata.spread_needed), (w_ip, w_sp))


# ---------------------------------------------------------------------------
# the extender verdict
# ---------------------------------------------------------------------------


class EvalCache:
    """Per-request amortization for the extender's evaluate_pod hot path —
    the sidecar analog of the reference's 100-entry equivalence LRU
    (core/equivalence_cache.go:33-54) plus vocab-growth isolation:

    - pair collection (collect_pod_pairs over every NodeInfo) cached keyed
      on snapshot.version, with existing pods' topology keys interned ONCE
      per version (not per request);
    - (ClassBatch, AffinityData) LRU keyed on (snapshot.version, pod class
      key) so repeat evaluations of equivalent pods skip tensorization;
    - label-vocab isolation: a pod whose selectors/topology keys would GROW
      the shared vocab (adversarial label churn -> full snapshot rebuild
      per request) is routed to the exact object-level oracle instead, and
      its pairs are queued; the next cache sync interns the queue in one
      batch, so rebuilds are bounded at one per sync no matter the request
      pattern."""

    MAX_PENDING = 4096

    def __init__(self, lru_size: int = 100, result_size: int = 2048):
        from collections import OrderedDict
        self.lru_size = lru_size
        self.result_size = result_size
        self._lru = OrderedDict()
        self._results = OrderedDict()
        self._results_ver = None  # results are reachable only within one
        # snapshot-version window (rkey embeds the version); a version move
        # clears the memo wholesale instead of letting up to result_size
        # dead ~25KB (fits, scores) pairs rot in FIFO order
        self._pairs_version = -1
        self._pairs = None
        self._pending_pairs: set = set()
        self._pending_images: set = set()
        self._pending_conflicts: set = set()
        self._pending_pds: set = set()
        self._sync_seen = False
        self.oracle_routes = 0  # diagnostics for tests/metrics
        self.builds = 0
        self.result_hits = 0
        # affinity-relevance generation, maintained by the owner (the
        # extender backend): bumped whenever the set of cached pods that
        # carry pod (anti-)affinity may have changed. Affinity-free
        # encodings key on (vocab_gen, aff_gen) instead of the full
        # snapshot version, so a stream of plain binds (scheduleOne compat
        # mode) reuses them instead of re-tensorizing per capacity delta.
        self.aff_gen = 0
        # True when NO pod in the owner's cache carries pod (anti-)affinity
        # — lets plain-pod evaluations skip pair collection + AffinityData
        # entirely (the symmetry check has nothing to check). Owners that
        # cannot prove this leave it False; everything still works, slower.
        self.cluster_aff_free = False

    def on_sync(self) -> None:
        """Cluster state resynced (the sidecar's /cache/... endpoints) —
        queued request pairs may intern at the next evaluation."""
        self._sync_seen = True
        self.aff_gen += 1
        self._results.clear()

    def flush_pending(self, snap: ClusterSnapshot) -> None:
        """Intern the queued request vocab entries in ONE rebuild per vocab,
        only after a sync boundary — the bounded-growth half of the
        isolation story."""
        if not self._sync_seen:
            return
        if self._pending_pairs:
            for k, v in self._pending_pairs:
                snap.ensure_label_pair(k, v)
            self._pending_pairs.clear()
            snap.finalize_labels()
        if self._pending_images:
            for name in self._pending_images:
                snap.ensure_image(name)
            self._pending_images.clear()
            snap.finalize_images()
        if self._pending_conflicts or self._pending_pds:
            for key in self._pending_conflicts:
                snap.ensure_conflict_key(key)
            for kind, vid in self._pending_pds:
                snap.ensure_pd_id(kind, vid)
            self._pending_conflicts.clear()
            self._pending_pds.clear()
            snap.finalize_volumes()
        self._sync_seen = False

    # -------------------------------------------------------------- pairs

    def pairs_for(self, snap: ClusterSnapshot, infos):
        """(all_pairs, aff_pairs) for the current cluster state; interns
        existing-pod topology keys + any queued request pairs, then
        finalizes the label matrix so the version is stable afterwards."""
        if self._pairs_version == snap.version and self._pairs is not None:
            return self._pairs
        all_pairs, aff_pairs = aff_ops.collect_pod_pairs(infos)
        aff_ops.intern_topology_pairs(snap, [], aff_pairs)
        for k, v in self._pending_pairs:
            snap.ensure_label_pair(k, v)
        self._pending_pairs.clear()
        snap.finalize_labels()
        self._pairs = (all_pairs, aff_pairs)
        self._pairs_version = snap.version
        return self._pairs

    # ----------------------------------------------------- vocab isolation

    def vocab_missing(self, pod: Pod, snap: ClusterSnapshot,
                      volume_ctx=None) -> bool:
        """Would encoding this pod grow ANY snapshot vocab (label pairs,
        container images, volume conflict keys / PD ids)? If yes, queue the
        entries for the next sync and answer True (caller routes to the
        oracle). Guarding only labels would leave image/volume churn as a
        per-request rebuild vector — PodBatch interns those too
        (snapshot.py ensure_image/ensure_conflict_key/ensure_pd_id)."""
        pairs = set()
        vocab = snap.label_vocab
        grown = False
        pend = len(self._pending_images) + len(self._pending_conflicts) \
            + len(self._pending_pds)
        for c in pod.containers:
            if c.image and snap.image_vocab.get(c.image, "") < 0:
                grown = True
                if pend < self.MAX_PENDING:
                    self._pending_images.add(c.image)
        if pod.volumes:
            from kubernetes_tpu_torch.state import volumes as volmod
            for key, _ro in volmod.pod_conflict_keys(pod):
                if snap.conflict_vocab.get(key, "") < 0:
                    grown = True
                    if pend < self.MAX_PENDING:
                        self._pending_conflicts.add(key)
            if volume_ctx is not None:
                for kind, vid in volmod.pd_filter_ids(pod, volume_ctx):
                    if snap.pd_vocab.get(str(kind) + "\x00" + vid, "") < 0:
                        grown = True
                        if pend < self.MAX_PENDING:
                            self._pending_pds.add((kind, vid))
        for k, v in pod.node_selector.items():
            if vocab.get(k, v) < 0:
                pairs.add((k, v))
        a = pod.affinity
        terms = []
        if a is not None and a.node_affinity is not None:
            if a.node_affinity.required_terms:
                terms.extend(a.node_affinity.required_terms)
            terms.extend(t for _w, t in a.node_affinity.preferred_terms)
        for t in terms:
            for r in t.match_expressions:
                if SelectorOperator(r.operator) == SelectorOperator.IN:
                    for v in r.values:
                        if vocab.get(r.key, v) < 0:
                            pairs.add((r.key, v))
                else:  # Exists/NotIn/Gt/Lt expand over node-present values
                    for v in snap.node_values_for_key(r.key):
                        if vocab.get(r.key, v) < 0:
                            pairs.add((r.key, v))
        for key in aff_ops._term_topology_keys(pod):
            for v in snap.node_values_for_key(key):
                if vocab.get(key, v) < 0:
                    pairs.add((key, v))
        if pairs or grown:
            if len(self._pending_pairs) < self.MAX_PENDING:
                self._pending_pairs.update(pairs)
            self.oracle_routes += 1
            return True
        return False

    # ------------------------------------------------------------------ LRU

    @staticmethod
    def _wkey(workloads: Sequence) -> tuple:
        return tuple(sorted((w.kind, w.namespace, w.name, w.resource_version)
                            for w in workloads))

    def get_encoded(self, pod: Pod, snap: ClusterSnapshot, build,
                    workloads: Sequence = (), ckey=None, aff_free=False):
        """Encoded-class entry via the LRU; `build()` constructs on miss.

        Key: affinity-FREE classes (no pod affinity, no workloads, cluster
        proven affinity-free) key on (vocab_gen, aff_gen) — their encoding
        reads only vocabs and the node order, so capacity deltas (binds)
        don't invalidate them. Affinity-BEARING classes key on the full
        snapshot version, exactly as the reference re-derives predicate
        metadata against the live cache per pod."""
        wkey = self._wkey(workloads)
        struct = (snap.vocab_gen, self.aff_gen) if aff_free else snap.version
        key = (struct, wkey, ckey if ckey is not None else pod_class_key(pod))
        hit = self._lru.get(key)
        if hit is not None:
            self._lru.move_to_end(key)
            return hit
        val = build()
        self.builds += 1
        self._lru[key] = val
        if len(self._lru) > self.lru_size:
            self._lru.popitem(last=False)
        return val

    # ------------------------------------------------------------- results

    def _roll_results(self, version) -> None:
        if version != self._results_ver:
            self._results.clear()
            self._results_ver = version

    def get_result(self, key):
        """(fits, scores) memo for one (snapshot version, priority config,
        class) — the fused-verb cache: /prioritize after /filter for the
        same pod (or any equivalent pod at the same cluster state) returns
        without touching the device. Invalidation is structural: the
        snapshot version moving clears the whole window (old-version
        entries can never hit again — version is monotonic), on_sync
        clears outright."""
        self._roll_results(key[0])
        hit = self._results.get(key)
        if hit is not None:
            self._results.move_to_end(key)
            self.result_hits += 1
        return hit

    def put_result(self, key, value) -> None:
        self._roll_results(key[0])
        self._results[key] = value
        if len(self._results) > self.result_size:
            self._results.popitem(last=False)


def _oracle_eval(pod, infos, snap, priorities, workloads, hard_weight,
                 volume_ctx, policy_algos):
    """Exact object-level /filter + /prioritize (the reference's per-pod
    predicate/priority calls, no tensorization)."""
    ctx = SchedulingContext(infos, list(workloads),
                            hard_pod_affinity_weight=hard_weight,
                            volume_ctx=volume_ctx,
                            policy_algos=policy_algos)
    meta = AffinityMeta(pod, ctx)
    names = snap.node_names
    n_pad = snap.valid.shape[0]
    m = np.zeros(n_pad, dtype=bool)
    for i, nm in enumerate(names):
        m[i] = oracle.pod_fits(pod, infos[nm], ctx, meta)
    s = np.zeros(n_pad, dtype=np.int64)
    fit_idx = np.nonzero(m)[0]
    if len(fit_idx):
        fit_infos = [infos[names[i]] for i in fit_idx]
        per = oracle.prioritize(pod, fit_infos, priorities, ctx)
        s[fit_idx] = per
    return m, s


class _EncodedClass:
    """One LRU entry of the extender fast lane: the host encodings plus
    their DEVICE-resident uploads, so repeat evaluations of an equivalent
    pod re-launch over tensors already on the device instead of
    re-tensorizing + re-transferring per request."""

    __slots__ = ("batch", "adata", "parr", "aff")

    def __init__(self, batch, adata, parr, aff):
        self.batch = batch
        self.adata = adata
        self.parr = parr    # device pod-side tensors (shape-bucketed)
        self.aff = aff      # device affinity tensors, or None when inert


def _zero_occupancy(aff, labels):
    """The occupancy carry of an evaluation that commits nothing:
    commdom0 [C, L], comm_cnt0 [C] (int32 zeros on the labels' device)."""
    c_dim = aff["m_aff"].shape[0]
    dev = labels.device
    return (torch.zeros((c_dim, labels.shape[1]), dtype=I32, device=dev),
            torch.zeros(c_dim, dtype=I32, device=dev))


def _fused_eval(parr, narr, aff, priorities, weights, aff_mode):
    """The single-pod [1,N] evaluation: predicate chain + weighted
    priorities + (when live) the zero-occupancy affinity/spread functions,
    whose static side is one incidence product (the CUDA kernel on the
    card)."""
    fits_on, prio_on, spread_on = aff_mode
    w_ip, w_sp = weights
    m = preds.fits(parr, narr)[0]
    s = prio.score(parr, narr, priorities)[0]
    if fits_on or prio_on or spread_on:
        labels = narr["labels"]
        pre = aff_ops.precompute_static(aff, labels)
        commdom0, comm_cnt0 = _zero_occupancy(aff, labels)
        if fits_on:
            m = m & aff_ops.step_fits(aff, pre, 0, commdom0, comm_cnt0,
                                      labels)
        if prio_on:
            cnt = aff_ops.step_prio_counts(aff, pre, 0, commdom0, labels)
            s = s + w_ip * aff_ops.interpod_score(cnt, m)
        if spread_on:
            committed0 = torch.zeros((comm_cnt0.shape[0], labels.shape[0]),
                                     dtype=I32, device=labels.device)
            cnt = aff_ops.step_spread_counts(aff, 0, committed0)
            s = s + w_sp * aff_ops.spread_score(aff, aff["sp_has"][0], cnt,
                                                m)
    return m, s


def _fused_eval_batch(parr, narr, aff, priorities, weights, aff_mode):
    """The [C, N] sibling of _fused_eval: every row of a coalesced
    multi-frontend batch evaluated in one pass — predicate chain +
    weighted priorities + (when live) the zero-occupancy affinity/spread
    functions, class-vectorized via step_fits_all / step_prio_counts_all
    (row c is bit-identical to _fused_eval of class c alone, since zero
    occupancy has no cross-row carry). The static side is one stacked
    incidence product of C·(S+2) rows, and each step function one more."""
    fits_on, prio_on, spread_on = aff_mode
    w_ip, w_sp = weights
    m = preds.fits(parr, narr)                       # [C, N]
    s = prio.score(parr, narr, priorities)           # [C, N]
    if fits_on or prio_on or spread_on:
        labels = narr["labels"]
        pre = aff_ops.precompute_static(aff, labels)
        commdom0, comm_cnt0 = _zero_occupancy(aff, labels)
        if fits_on:
            m = m & aff_ops.step_fits_all(aff, pre, commdom0, comm_cnt0,
                                          labels)
        if prio_on:
            cnt = aff_ops.step_prio_counts_all(aff, pre, commdom0, labels)
            s = s + w_ip * aff_ops.interpod_score(cnt, m)
        if spread_on:
            # zero occupancy: the committed term sp_cls @ committed0 of
            # the reference is zero, so the counts are the static ones
            s = s + w_sp * aff_ops.spread_score(aff, aff["sp_has"],
                                                aff["sp_static"], m)
    return m, s


def _owned(t: torch.Tensor) -> np.ndarray:
    """The verdict's one device->host fetch, as an array that owns its
    memory: a memo entry is handed to every follower of a coalescing
    window and to later requests, so it must alias no tensor (on the CPU,
    ``Tensor.numpy()`` shares the tensor's memory)."""
    return t.cpu().numpy().copy()


def evaluate_pod(pod: Pod, infos, snap: ClusterSnapshot,
                 priorities: Tuple[Tuple[str, int], ...],
                 workloads: Sequence = (), hard_weight: int = 1,
                 volume_ctx=None, policy_algos=None, eval_cache=None,
                 device_nodes_provider=None, device=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-node (fits [N] bool, scores [N] int32) for ONE pod against the
    cluster state — the extender's /filter + /prioritize evaluation
    (core/extender.go:100 Filter, :157 Prioritize). No state is committed:
    a single pod has no in-batch carry, so the affinity/spread functions
    run with zero occupancy (the static side only — exactly what the
    reference's per-pod predicate/priority calls see through the scheduler
    cache). ``device=None`` is the card; the node tensors of
    `device_nodes_provider` must lie on the same device.

    `snap` must already be refreshed against `infos`. Routes to the exact
    host oracle when the pod's features over-approximate on device
    (needs_host_check / affinity slot overflow) or would grow a snapshot
    vocab, and always under an active `policy_algos`; the oracle route
    scores int64 over the filtered set, the device route int32 over every
    node (never differing on fit verdicts).

    The warm fast lane (eval_cache given) is layered:
      1. result memo — same class at the same snapshot version returns the
         cached (m, s) with zero device work (the fused filter+prioritize
         contract: the second verb rides the first's evaluation);
      2. encoded-class LRU — holds device-RESIDENT pod/affinity tensors;
         affinity-free classes survive capacity deltas (vocab_gen keying);
      3. one fused evaluation over the caller's device-resident node
         tensors (device_nodes_provider — CALLED only after vocab flushes,
         so a label-matrix rebuild can never race a stale upload;
         node_arrays(snap) uploads fresh when absent).
    """
    dev = resolve_device(device)
    w_ip = sum(w for nm, w in priorities if nm == "InterPodAffinityPriority")
    w_sp = sum(w for nm, w in priorities if nm == "SelectorSpreadPriority")

    if eval_cache is not None:
        # queued churn pairs intern in one batch at a sync boundary
        eval_cache.flush_pending(snap)
        # vocab isolation: a pod that would grow any snapshot vocab must
        # not touch the snapshot at all (EvalCache docstring)
        if eval_cache.vocab_missing(pod, snap, volume_ctx=volume_ctx):
            with timed_span("extender.oracle_eval"):
                return _oracle_eval(pod, infos, snap, priorities, workloads,
                                    hard_weight, volume_ctx, policy_algos)
        ckey = pod_class_key(pod)
        # priorities + hard_weight are part of BOTH cache keys: the
        # encoding's `need` gate and the scores depend on them, and nothing
        # forces a shared EvalCache to serve one fixed configuration
        cfg = (priorities, hard_weight)
        rkey = (snap.version, eval_cache._wkey(workloads), cfg, ckey)
        hit = eval_cache.get_result(rkey)
        if hit is not None:
            COUNTERS.inc("extender.result_hit")
            return hit
        # a pod with no pod (anti-)affinity in a cluster with no
        # affinity-carrying pods and no workloads has an all-zero
        # AffinityData by construction — skip pair collection and the
        # affinity build entirely, and key the encoding on the vocab
        # generation so binds don't invalidate it
        aff_free = (eval_cache.cluster_aff_free and not workloads
                    and not aff_ops._has_affinity(pod))
        if aff_free:
            def _build():
                with timed_span("extender.encode"):
                    b = ClassBatch([pod], snap)
                    return _EncodedClass(
                        b, None, preds.pod_arrays_bucketed(b.reps_batch, dev),
                        None)
        else:
            with timed_span("extender.pairs"):
                all_pairs, aff_pairs = eval_cache.pairs_for(snap, infos)

            def _build():
                with timed_span("extender.encode"):
                    COUNTERS.inc("extender.affinity_data_build")
                    b = ClassBatch([pod], snap)
                    a = aff_ops.AffinityData(b.reps, snap, all_pairs,
                                             aff_pairs, list(workloads),
                                             hard_weight)
                    need = (a.fits_needed
                            or (bool(w_ip) and a.prio_needed)
                            or (bool(w_sp) and a.spread_needed))
                    return _EncodedClass(
                        b, a, preds.pod_arrays_bucketed(b.reps_batch, dev),
                        a.device_arrays(dev) if need else None)

        enc = eval_cache.get_encoded(pod, snap, _build, workloads=workloads,
                                     ckey=(cfg, ckey), aff_free=aff_free)
        out = _eval_dispatch(pod, infos, snap, priorities, workloads,
                             hard_weight, volume_ctx, policy_algos, enc,
                             device_nodes_provider, w_ip, w_sp, dev)
        eval_cache.put_result(rkey, out)
        return out

    # uncached path (no EvalCache owner): build fresh per call, then the
    # SAME dispatch tail — args-mode and the warm lane cannot drift
    with timed_span("extender.encode"):
        all_pairs, aff_pairs = aff_ops.collect_pod_pairs(infos)
        aff_ops.intern_topology_pairs(snap, [pod], aff_pairs)
        batch = ClassBatch([pod], snap)
        adata = aff_ops.AffinityData(batch.reps, snap, all_pairs, aff_pairs,
                                     list(workloads), hard_weight)
        need = (adata.fits_needed or (bool(w_ip) and adata.prio_needed)
                or (bool(w_sp) and adata.spread_needed))
        enc = _EncodedClass(batch, adata,
                            preds.pod_arrays_bucketed(batch.reps_batch, dev),
                            adata.device_arrays(dev) if need else None)
    return _eval_dispatch(pod, infos, snap, priorities, workloads,
                          hard_weight, volume_ctx, policy_algos, enc,
                          device_nodes_provider, w_ip, w_sp, dev)


def _eval_dispatch(pod, infos, snap, priorities, workloads, hard_weight,
                   volume_ctx, policy_algos, enc: "_EncodedClass",
                   device_nodes_provider, w_ip: int, w_sp: int, dev):
    """Shared routing tail of evaluate_pod: exact-oracle gate
    (needs_host_check / slot overflow / Policy algorithms), then ONE fused
    evaluation over the caller's device-resident node tensors. Both the
    warm fast lane and the uncached args-mode path end here, so the
    dispatch contract cannot drift between them."""
    batch, adata = enc.batch, enc.adata
    if batch.reps_batch.needs_host_check[0] \
            or (adata is not None and adata.overflow[0]) \
            or (policy_algos is not None and policy_algos.active):
        # exact object-level path (same routing as SchedulingEngine.schedule;
        # Policy-configured algorithms always evaluate exactly here — one
        # pod per extender call keeps the oracle cheap)
        with timed_span("extender.oracle_eval"):
            return _oracle_eval(pod, infos, snap, priorities, workloads,
                                hard_weight, volume_ctx, policy_algos)
    plain = tuple((nm, w) for nm, w in priorities
                  if nm not in prio.AFFINITY_PRIORITIES)
    fits_on = adata is not None and adata.fits_needed
    prio_on = adata is not None and bool(w_ip) and adata.prio_needed
    spread_on = adata is not None and bool(w_sp) and adata.spread_needed
    with timed_span("extender.upload"):
        narr = device_nodes_provider() if device_nodes_provider is not None \
            else preds.node_arrays(snap, dev)
    with timed_span("extender.kernel"):
        COUNTERS.inc("extender.fused_eval")
        m, s = _fused_eval(
            enc.parr, narr,
            enc.aff if (fits_on or prio_on or spread_on) else None,
            plain, (w_ip, w_sp), (fits_on, prio_on, spread_on))
        # the extender's one result fetch: the verb returns (fits, scores)
        # to an HTTP caller, so this stall IS the response
        m = _owned(m)
        s = _owned(s)
    m[len(snap.node_names):] = False
    return m, s


def evaluate_pods_batch(pods: Sequence[Pod], infos, snap: ClusterSnapshot,
                        priorities: Tuple[Tuple[str, int], ...],
                        workloads: Sequence = (), hard_weight: int = 1,
                        volume_ctx=None, policy_algos=None, eval_cache=None,
                        device_nodes_provider=None, device=None
                        ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Coalesced multi-frontend evaluation: one (fits, scores) pair per
    pod, computed with at most ONE fused [C, N] evaluation for the batch's
    unique pod classes — the device half of the extender's micro-batch
    window. ``device=None`` is the card. Per-pod ROUTING is identical to
    evaluate_pod:

      - vocab growth       -> exact host oracle (isolation unchanged);
      - result-memo hit    -> served with zero device work;
      - one unique class   -> delegated to evaluate_pod (the single-pod
        warm lane, so its encoded-class LRU and span counters keep their
        exact contracts);
      - several classes    -> ONE ClassBatch over the class reps, class
        axis padded to the bucket ladder (pod_arrays_bucketed rows=), one
        _fused_eval_batch, rows scattered per request; host-check /
        slot-overflow / Policy classes drop to the oracle per class exactly
        as _eval_dispatch routes the single pod.

    Every class's (m, s) enters the result memo, so followers of the same
    coalescing window and later requests hit without dispatching. `snap`
    must already be refreshed; no state is committed (zero-occupancy
    evaluation, same contract as evaluate_pod)."""
    from collections import OrderedDict

    dev = resolve_device(device)
    n = len(pods)
    if eval_cache is None:
        # no cache owner: per-request evaluation is the only honest shape
        # (nothing to coalesce against between stateless snapshots)
        return [evaluate_pod(p, infos, snap, priorities, workloads,
                             hard_weight, volume_ctx, policy_algos, None,
                             device_nodes_provider, dev) for p in pods]
    results: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [None] * n
    eval_cache.flush_pending(snap)
    w_ip = sum(w for nm, w in priorities if nm == "InterPodAffinityPriority")
    w_sp = sum(w for nm, w in priorities if nm == "SelectorSpreadPriority")
    cfg = (priorities, hard_weight)
    wkey = eval_cache._wkey(workloads)

    def _oracle(pod):
        with timed_span("extender.oracle_eval"):
            return _oracle_eval(pod, infos, snap, priorities, workloads,
                                hard_weight, volume_ctx, policy_algos)

    # per-pod routing: vocab isolation + memo, then class dedup
    uniq = OrderedDict()  # ckey -> [pod indices], first-seen order
    rep_of = {}
    for i, pod in enumerate(pods):
        if eval_cache.vocab_missing(pod, snap, volume_ctx=volume_ctx):
            results[i] = _oracle(pod)
            continue
        ckey = pod_class_key(pod)
        rkey = (snap.version, wkey, cfg, ckey)
        hit = eval_cache.get_result(rkey)
        if hit is not None:
            COUNTERS.inc("extender.result_hit")
            results[i] = hit
            continue
        members = uniq.get(ckey)
        if members is None:
            uniq[ckey] = members = []
            rep_of[ckey] = pod
        members.append(i)
    # canonical class order (sorted by key repr): the encoded-batch LRU
    # entry is keyed on the class TUPLE, and the same class set arriving
    # in a different interleaving must hit the same entry — row c of the
    # encoding maps to canonical class c by construction
    order = sorted(uniq, key=repr)
    uniq = OrderedDict((ck, uniq[ck]) for ck in order)
    reps: List[Pod] = [rep_of[ck] for ck in order]
    if not uniq:
        return results  # type: ignore[return-value]
    if len(uniq) == 1 or (policy_algos is not None and policy_algos.active):
        # one class (the compat-storm common case) rides the single-pod
        # warm lane — encoded-class LRU, result memo, exact span counters;
        # Policy-configured algorithms always evaluate per pod exactly
        for ckey, members in uniq.items():
            out = evaluate_pod(pods[members[0]], infos, snap, priorities,
                               workloads, hard_weight, volume_ctx,
                               policy_algos, eval_cache,
                               device_nodes_provider, dev)
            for i in members:
                results[i] = out
        return results  # type: ignore[return-value]

    COUNTERS.inc("extender.batch_classes", len(uniq))
    aff_free = (eval_cache.cluster_aff_free and not workloads
                and not any(aff_ops._has_affinity(r) for r in reps))
    if not aff_free:
        with timed_span("extender.pairs"):
            all_pairs, aff_pairs = eval_cache.pairs_for(snap, infos)

    def _build():
        with timed_span("extender.encode"):
            b = ClassBatch(reps, snap)
            c_pad = bucket(b.num_classes, lo=4)
            parr = preds.pod_arrays_bucketed(b.reps_batch, dev, rows=c_pad)
            if aff_free:
                return _EncodedClass(b, None, parr, None)
            COUNTERS.inc("extender.affinity_data_build")
            a = aff_ops.AffinityData(b.reps, snap, all_pairs, aff_pairs,
                                     list(workloads), hard_weight,
                                     c_pad=c_pad)
            need = (a.fits_needed or (bool(w_ip) and a.prio_needed)
                    or (bool(w_sp) and a.spread_needed))
            return _EncodedClass(b, a, parr,
                                 a.device_arrays(dev) if need else None)

    enc = eval_cache.get_encoded(reps[0], snap, _build, workloads=workloads,
                                 ckey=(cfg, tuple(uniq)), aff_free=aff_free)
    batch, adata = enc.batch, enc.adata
    fits_on = adata is not None and adata.fits_needed
    prio_on = adata is not None and bool(w_ip) and adata.prio_needed
    spread_on = adata is not None and bool(w_sp) and adata.spread_needed
    plain = tuple((nm, w) for nm, w in priorities
                  if nm not in prio.AFFINITY_PRIORITIES)
    m_all = s_all = None
    nhc = batch.reps_batch.needs_host_check
    for c, (ckey, members) in enumerate(uniq.items()):
        if nhc[c] or (adata is not None and adata.overflow[c]):
            out = _oracle(reps[c])  # exact object-level route, per class
        else:
            if m_all is None:
                with timed_span("extender.upload"):
                    narr = device_nodes_provider() \
                        if device_nodes_provider is not None \
                        else preds.node_arrays(snap, dev)
                with timed_span("extender.kernel_batch"):
                    COUNTERS.inc("extender.fused_eval_batch")
                    m_d, s_d = _fused_eval_batch(
                        enc.parr, narr,
                        enc.aff if (fits_on or prio_on or spread_on)
                        else None,
                        plain, (w_ip, w_sp),
                        (fits_on, prio_on, spread_on))
                    # the batch's one result fetch: every coalesced verb
                    # returns its row to an HTTP caller, so this stall IS
                    # the response set
                    m_all = _owned(m_d)
                    s_all = _owned(s_d)
                m_all[:, len(snap.node_names):] = False
            out = (m_all[c], s_all[c])
        eval_cache.put_result((snap.version, wkey, cfg, ckey), out)
        for i in members:
            results[i] = out
    return results  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# the pipelined drain's host state
# ---------------------------------------------------------------------------


def _aff_node_views(adata, snap):
    """(key_node [C, A, N] int8, static_forbid_hit [C, N] int8): the
    per-NODE projections of the anti-term keymasks and static forbid rows.
    Wave-eligible classes have singleton domains, so "node n is in a
    forbidden domain of term (c, a)" reduces to "a matching pod sits ON n
    and n carries the term's key" — these two views are all the per-wave
    mask needs, and neither carries the label axis. Computed once per
    encoding build as dense float64 products restricted to the NONZERO rows
    (counts far below 2^53 — exact)."""
    lab_t = snap.labels.astype(np.float64).T              # [L, N]
    C, A, L = adata.anti_keymask.shape
    n = lab_t.shape[1]
    km = adata.anti_keymask.reshape(C * A, L)
    key_node = np.zeros((C * A, n), dtype=np.int8)
    rows = np.nonzero(km.any(axis=1))[0]
    if rows.size:
        key_node[rows] = (km[rows].astype(np.float64) @ lab_t) > 0
    fs = adata.forbid_static
    static_hit = np.zeros((C, n), dtype=np.int8)
    frows = np.nonzero(fs.any(axis=1))[0]
    if frows.size:
        static_hit[frows] = (fs[frows].astype(np.float64) @ lab_t) > 0
    return key_node.reshape(C, A, n), static_hit


def _aff_tail_cols(adata, prio_on: bool) -> np.ndarray:
    """Label columns the SEEDED STRICT TAIL can actually read: domains of
    the wave_strict classes' own terms (allow + anti + static rows), of
    terms TARGETING them (the symmetry sources), and — when preferred
    scoring is live — of every priority-side keymask. Everything else in
    the label axis is provably inert inside the tail's step_fits/
    step_prio_counts contractions, so the tail runs at Lp = O(referenced
    domains), not L = O(cluster)."""
    sc = adata.wave_strict
    L = adata.forbid_static.shape[1]
    use = np.zeros(L, dtype=bool)
    if sc.any():
        use |= adata.aff_keymask[sc].astype(bool).any(axis=(0, 1))
        use |= adata.aff_allow[sc].astype(bool).any(axis=(0, 1))
        use |= adata.anti_keymask[sc].astype(bool).any(axis=(0, 1))
        use |= adata.forbid_static[sc].astype(bool).any(axis=0)
        tgt = adata.m_anti[:, :, sc].astype(bool).any(axis=2)   # [C, A]
        use |= (adata.anti_keymask.astype(bool)
                & tgt[:, :, None]).any(axis=(0, 1))
    if prio_on:
        use |= adata.p_keymask.astype(bool).any(axis=(0, 1))
        use |= adata.q_keymask.astype(bool).any(axis=(0, 1))
        use |= adata.prio_static.astype(bool).any(axis=0)
    cols = np.nonzero(use)[0]
    if cols.size == 0:
        cols = np.zeros(1, dtype=np.int64)  # degenerate: keep shapes sane
    return cols


_AFF_SLICE3 = ("aff_allow", "aff_keymask", "anti_keymask", "p_keymask",
               "q_keymask")
_AFF_SLICE2 = ("forbid_static", "prio_static")


def _aff_tail_arrays(adata, snap, cols: np.ndarray, device, mesh=None):
    """AffinityData tensors with every domain axis sliced to the tail's
    column projection, plus the matching `labels_aff` [N, Lp] node
    incidence the tail contracts against (place_batch and
    tail_rounds_loop swap it in for nodes["labels"] on the affinity side
    only). Uploaded once per encoding, as copies through the frozen seam
    (nothing mutates these host arrays after the build; the sanitizer
    seals them). On a mesh the node-axis members place sharded
    (mesh.aff_spec), everything else replicated."""
    def _pl(k):
        return None if mesh is None \
            else mesh_mod.Placement(mesh, mesh_mod.aff_spec(k))
    out = {}
    for k in aff_ops.AffinityData._DEVICE_KEYS:
        a = getattr(adata, k)
        if k in _AFF_SLICE3:
            a = a[:, :, cols]
        elif k in _AFF_SLICE2:
            a = a[:, cols]
        out[k] = sanitize.upload_frozen(a, device, _pl(k))
    # advanced indexing already copies, so freezing the fresh array is free
    out["labels_aff"] = sanitize.upload_frozen(snap.labels[:, cols], device,
                                               _pl("labels_aff"))
    return out


class _WaveEncoding:
    """Device-resident class encoding reused across pipelined drain chunks.

    A 30k-pod storm arrives as a few pipelined chunks of the SAME handful
    of spec classes; this caches the padded class tensors keyed on
    snapshot.vocab_gen plus the host rows the harvest fence reads.
    Affinity chunks add the AffinityData for the class set (its STATIC
    topology arrays vs already-bound cluster pods) plus a host accumulator
    committed_nodes [C, N] of this engine's OWN fence-accepted commits
    since the build, so each dispatch seeds the wave loop with exact
    current occupancy. Validity is (vocab_gen, cache.aff_seq) plus, for
    affinity encodings, snapshot.labels_gen: the engine folds its own
    assumes into aff_seq expectations, so a mismatch means FOREIGN churn,
    which the patch paths absorb or the next dispatch rebuilds over."""

    __slots__ = ("vocab_gen", "labels_gen", "key_index", "reps", "cls_arr",
                 "num_classes",
                 "c_pad", "req_rows", "special", "derived", "ports_max",
                 "raw_rows", "delta_ok", "cls_prio", "adata", "wave_strict",
                 "fits_on", "prio_on", "aff_seq",
                 "committed_nodes", "key_node", "static_forbid_hit",
                 "tail_cols", "aff_wave_dev", "aff_tail_dev",
                 "anti_terms", "aff_terms", "foreign_forbid",
                 "foreign_forbid_dom", "aff_patch_dirty",
                 "host_exact", "host_static", "policy_on", "spread_on",
                 "wkey", "has_static_cols")

    def __init__(self, vocab_gen, key_index, reps, cls_arr, num_classes,
                 c_pad, req_rows, special, derived, ports_max,
                 adata=None, fits_on=False, prio_on=False,
                 aff_seq=0, aff_wave_dev=None,
                 aff_tail_dev=None, key_node=None, static_forbid_hit=None,
                 tail_cols=None, n_pad=0, labels_gen=0,
                 host_exact=None, host_static=None, policy_on=False,
                 spread_on=False, wkey=(), has_static_cols=False):
        self.vocab_gen = vocab_gen
        self.labels_gen = labels_gen  # snapshot.labels_gen at build: the
        # topology views (key_node/static_forbid_hit/labels_aff) bake
        # label CONTENT, which vocab_gen does not cover (delta relabel)
        self.key_index = key_index
        self.reps = reps
        self.cls_arr = cls_arr
        self.num_classes = num_classes
        self.c_pad = c_pad
        self.req_rows = req_rows      # [C, R] int64, snapshot-quantized
        self.special = special        # [C] bool: ports/volumes classes
        self.derived = derived        # per-class (Resource, ncpu, nmem, ports)
        self.ports_max = ports_max    # highest requested host port, or -1
        self.adata = adata            # AffinityData at c_pad, or None
        self.fits_on = fits_on        # required (anti-)affinity live
        self.prio_on = prio_on        # preferred-affinity scoring live
        self.wave_strict = adata.wave_strict if adata is not None \
            else np.zeros(c_pad, dtype=bool)
        # host-check / Policy absorption: host_exact classes ride the wave
        # as inactive padding-class rows and place at the harvest's exact
        # oracle tail (live-NodeInfo ports, score-affecting preference
        # overflow, Policy order-dependence, affinity slot overflow);
        # host_static classes carry a precomputed exact label-pure fit
        # column (cls_arr["host_fit"]) and place on the wave itself.
        # Neither shape flushes the pipeline.
        self.host_exact = host_exact if host_exact is not None \
            else np.zeros(c_pad, dtype=bool)
        self.host_static = host_static if host_static is not None \
            else np.zeros(c_pad, dtype=bool)
        self.policy_on = policy_on    # policy_fit/policy_score baked
        self.spread_on = spread_on    # SelectorSpread riding frozen score
        # workload-set identity at build (the scheduler replaces workload
        # objects on watch events, so `is`-comparison detects any change);
        # compared only when workloads are placement-relevant (policy or
        # spread weight) — see _wave_encoding
        self.wkey = wkey
        # host/policy static columns bake LABEL CONTENT and workload
        # state; a labels_gen move invalidates the whole encoding (no
        # patch path for these columns)
        self.has_static_cols = has_static_cols
        self.aff_seq = aff_seq        # expected cache.aff_seq (own folds in)
        # tensor bundles: the wave loop's per-node form and the strict
        # tail's projected-domain form
        self.aff_wave_dev = aff_wave_dev
        self.aff_tail_dev = aff_tail_dev
        self.key_node = key_node                    # np int8 [C, A, N]
        self.static_forbid_hit = static_forbid_hit  # np int8 [C, N]
        self.tail_cols = tail_cols                  # np int64 [Lp]
        self.committed_nodes = np.zeros((c_pad, n_pad), dtype=np.int32) \
            if fits_on else None
        # Protean overlays: FOREIGN churn patched in since the build
        # instead of rebuilt over. foreign_forbid [C, N] counts foreign
        # pods matching class c's required-anti selectors resident on node
        # n; foreign_forbid_dom is the same over the tail's projected
        # domain columns. Counts, so an unbind of a PATCHED source
        # decrements exactly.
        self.foreign_forbid = np.zeros((c_pad, n_pad), dtype=np.int32) \
            if fits_on else None
        self.foreign_forbid_dom = np.zeros(
            (c_pad, len(tail_cols)), dtype=np.int32) \
            if fits_on and tail_cols is not None else None
        self.aff_patch_dirty = False
        # per-class required term lists for foreign-event matching
        # [(class, slot, term, rep)] — empty for affinity-free encodings
        self.anti_terms: list = []
        self.aff_terms: list = []
        # raw int64 per-class delta rows (requested cpu/mem/gpu/scratch/
        # overlay + nonzero cpu/mem) for snapshot.apply_assume_delta, and
        # which classes qualify for it (no ports/volumes/extended)
        self.raw_rows = np.empty((num_classes, 7), dtype=np.int64)
        self.delta_ok = np.empty(num_classes, dtype=bool)
        for c, (req, ncpu, nmem, ports) in enumerate(derived):
            self.raw_rows[c] = (req.milli_cpu, req.memory, req.nvidia_gpu,
                                req.storage_scratch, req.storage_overlay,
                                ncpu, nmem)
            self.delta_ok[c] = not (ports or req.extended or special[c])
        # per-class PRIORITY column: rides the raw-delta fold into the
        # snapshot's band aggregates
        self.cls_prio = np.fromiter((rep.priority for rep in reps),
                                    dtype=np.int64, count=num_classes)


class WaveHandle:
    """One in-flight pipelined wave: the worker's job (the wave loop plus
    its one device->host copy) and everything the harvest fence needs.
    Holding this without calling block() is the whole point — the device
    computes while the host does the previous wave's bookkeeping."""

    __slots__ = ("pods", "pc", "enc", "job", "nodes", "blind", "pop_ts",
                 "dispatch_ts", "pad_floor", "strict_idx", "gangs",
                 "wave_id", "host_idx", "packed_h", "state_out",
                 "committed_out", "counter_out")

    def __init__(self, pods, pc, enc, job, nodes, blind, pop_ts,
                 dispatch_ts, pad_floor=0, strict_idx=None, gangs=None,
                 wave_id=-1, host_idx=None):
        self.pad_floor = pad_floor
        self.pods = pods
        self.pc = pc                  # host int32 [n] class index per pod
        self.enc = enc
        self.job = job                # Future of the worker's wave job
        self.nodes = nodes            # node tensors at dispatch time
        self.blind = blind            # node NAMES mutated since dispatch
        self.pop_ts = pop_ts
        self.dispatch_ts = dispatch_ts
        # pods routed to the seeded strict tail (wave_strict classes) —
        # inactive on the wave path, placed by harvest's tail
        self.strict_idx = strict_idx if strict_idx is not None \
            else np.empty(0, dtype=np.int64)
        # quorum-ready gangs riding this wave: [(name, member indices
        # into `pods`, quorum)] — the harvest's gang fence commits or
        # rolls back each one atomically
        self.gangs = gangs or []
        # host_exact rows (padding class on the device): placed by the
        # harvest's exact oracle tail after the fence
        self.host_idx = host_idx if host_idx is not None \
            else np.empty(0, dtype=np.int64)
        # flight-recorder wave id: joins this wave's dispatch / harvest /
        # bind-flush events; -1 when the recorder was off at dispatch
        self.wave_id = wave_id
        # filled by block(): the packed host result [3P+2] int32, the
        # final node state, the [C, N] occupancy (affinity waves) and the
        # int64 round-robin counter
        self.packed_h = None
        self.state_out = None
        self.committed_out = None
        self.counter_out = None

    def is_ready(self) -> bool:
        """Has the wave's job finished (device work and fetch included)?"""
        return self.job.done()

    def block(self) -> None:
        """Wait for the wave's job and take its results; re-raises what
        the job raised. The values are identical whenever fetched; only
        the overlap is forfeited when called right after dispatch."""
        if self.packed_h is None:
            (self.packed_h, self.state_out, self.committed_out,
             self.counter_out) = self.job.result()


class WaveHarvest:
    """Fenced result of one wave: pods to bind (node_name set, already
    assumed), fence conflicts to requeue WITHOUT backoff (a capacity race
    with the blind wave, not unschedulability), unschedulable pods, the
    rows whose target node died mid-flight (requeue WITH backoff), and
    for gang-bearing waves the gangs whose quorum committed (the caller
    marks them degraded) plus the members of gangs the fence ROLLED BACK
    atomically (requeue WITH backoff: the gang lost as a whole)."""

    __slots__ = ("bound", "conflicts", "unschedulable", "t_block",
                 "gang_committed", "gang_requeued", "liveness_requeued",
                 "conflict_reasons")

    def __init__(self, bound, conflicts, unschedulable, t_block,
                 gang_committed=None, gang_requeued=None,
                 liveness_requeued=None, conflict_reasons=None):
        self.bound = bound
        self.conflicts = conflicts
        self.unschedulable = unschedulable
        self.t_block = t_block
        self.gang_committed = gang_committed or []
        self.gang_requeued = gang_requeued or []  # [(pod, reason)]
        self.liveness_requeued = liveness_requeued or []
        # typed requeue attribution: podtrace.REASON_* code per entry of
        # `conflicts`, parallel
        self.conflict_reasons = conflict_reasons or []


class _WaveWorker:
    """The engine's one worker thread for dispatched wave jobs. Jobs run
    one at a time, in dispatch order. On a CUDA device each job runs on
    the worker's own stream, which first waits for an event recorded on
    the dispatching thread's current stream — so the job sees every
    upload the dispatch enqueued, and the dispatching thread never waits
    for the job."""

    def __init__(self, device: torch.device):
        self.device = device
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="wave-loop")
        self._stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None

    def submit(self, fn) -> Future:
        if self._stream is None:
            return self._pool.submit(fn)
        ready = torch.cuda.Event()
        ready.record()  # on the dispatching thread's current stream
        stream = self._stream
        device = self.device

        def run():
            with torch.cuda.device(device), torch.cuda.stream(stream):
                stream.wait_event(ready)
                return fn()
        return self._pool.submit(run)

    def close(self) -> None:
        self._pool.shutdown(wait=True)


def _wave_job(cls_arr, nodes, state, pc_dev, counter_src, counter0,
              priorities, extra, aff, committed_dev, act_dev, pre, p_pad,
              spmd_mesh=None):
    """The worker's body for one dispatched wave: the wave loop (the SPMD
    path on a mesh), then its one device->host copy. `counter_src` is the
    previous wave's job (its counter is final: jobs run in order) or None
    (start from counter0). The fetch is synchronous on the job's stream,
    so every output is complete by the time the harvest takes them."""
    dev = pc_dev.device
    if counter_src is not None:
        counter = counter_src.result()[3]
    else:
        counter = torch.tensor(counter0 & U32_MASK, dtype=torch.int64,
                               device=dev)
    out = waves.waves_loop(cls_arr, nodes, state, pc_dev, counter,
                           priorities, 64, extra_score=extra, aff=aff,
                           committed0=committed_dev, active0=act_dev,
                           pre=pre, spmd_mesh=spmd_mesh)
    packed, state_out = out[0], out[1]
    committed_out = out[2] if aff is not None else None
    counter_out = packed[3 * p_pad].to(torch.int64) & U32_MASK
    return packed.cpu().numpy(), state_out, committed_out, counter_out


# ---------------------------------------------------------------------------
# the batch engine
# ---------------------------------------------------------------------------


class SchedulingEngine:
    """Batch scheduling over a SchedulerCache on one device, or on the
    node-axis mesh `mesh` (parallel/mesh.Mesh)."""

    def __init__(self, cache: SchedulerCache,
                 priorities: Tuple[Tuple[str, int], ...] =
                 prio.DEFAULT_PRIORITIES, device=None,
                 workloads_provider=None, policy_algos=None, mesh=None):
        self.device = resolve_device(device) if mesh is None \
            else mesh.devices[0]
        if mesh is not None and device is not None \
                and torch.device(device).type != self.device.type:
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device {self.device}")
        # resident device mesh: every node-indexed device tensor this
        # engine owns is uploaded SHARDED across the mesh and stays
        # resident between waves; waves_loop runs its two-stage SPMD
        # path. A one-device mesh is no mesh (the unsharded engine IS the
        # one-device layout).
        self.mesh = None
        self._rmesh = None
        if mesh is not None and mesh.size > 1:
            self.mesh = mesh
            self._rmesh = mesh_mod.ResidentMesh(mesh)
        self.cache = cache
        self.priorities = priorities
        # Policy-configured parameterized algorithms (ServiceAffinity,
        # NodeLabelPresence, NodeLabel, ServiceAntiAffinity) — the
        # CreateFromConfig arguments (ops/policy_algos.py)
        self.policy_algos = policy_algos
        # the node axis pads to a multiple of BOTH the baseline alignment
        # (8) and the shard count, so the shards split it evenly on any
        # mesh size (N padded to 8 need not divide by D = 3, 5, 6, 7)
        self.snapshot = ClusterSnapshot() if self.mesh is None \
            else ClusterSnapshot(node_pad=math.lcm(8, self.mesh.size))
        # PV/PVC mirror (the pvInfo/pvcInfo listers of factory.go); the
        # owner (Scheduler) mutates it and bumps .version on watch events
        self.volume_ctx = VolumeContext()
        self.rr = oracle.RoundRobin()  # shared counter, device + oracle
        # paths (uint32 on the device)
        # Service/RC/RS/SS objects for spreading — the factory's extra
        # informers (factory.go:120-140)
        self.workloads_provider = workloads_provider or (lambda: [])
        self.hard_pod_affinity_weight = HARD_POD_AFFINITY_WEIGHT
        self._device_nodes: Dict[str, torch.Tensor] = {}
        # snapshot version the resident node tensors were last synced at
        # (the fast lane reads them only while they are current)
        self._device_version = -1
        # priority-band device bundle for the wave-path victim scan:
        # uploaded on demand, keyed on snapshot.version — preemption
        # rounds are rare next to waves, so this stays out of
        # _nodes_on_device and its upload counters entirely
        self._prio_dev: Optional[Dict[str, torch.Tensor]] = None
        self._prio_dev_version = -1
        # wave count and strict-finish count of the last wave-mode batch
        self.last_wave_stats: Dict[str, int] = {}
        # targeted-refresh bookkeeping: when the OWNER (one Scheduler that
        # routes every cache mutation through note_node_dirty/
        # note_full_refresh) sets track_dirty, _refresh() passes the dirty
        # node set as snapshot.refresh's changed_hint instead of walking
        # all N generation counters per round. Default off: a bare engine
        # whose cache is mutated behind its back cannot uphold the hint.
        self.track_dirty = False
        self._pending_dirty: set = set()
        self._need_full_refresh = True
        # liveness fence: node names the OWNER declared dying (watch event
        # observed, not yet applied) — the harvest fence requeues any
        # blind-wave row targeting one instead of binding into a ghost
        self._doomed_nodes: set = set()
        # pipelined-drain state (dispatch_waves/harvest_waves)
        self._wave_enc = None
        self._rr_chain = None  # the last dispatched job: its counter
        # chains into the next dispatch until its harvest
        # per-encoding cache of waves.precompute (the capacity-INdependent
        # [C, N] tensors), keyed on the encoding object and the IDENTITY
        # of the static node tensors (_nodes_on_device replaces a tensor
        # only when the snapshot marked it dirty)
        self._pre_cache = None
        self._blind_listeners: List[set] = []  # per-inflight-wave touch sets
        # pod-axis padding floor for dispatch_waves: the pipeline pins this
        # to its chunk size so ragged pops reuse one padded shape
        self.wave_pad_floor = 0
        # conflict-round tail: the harvest's seeded strict tail runs as
        # waves.tail_rounds_loop when the tail is big enough to pay for the
        # round body; small tails keep the per-pod scan.
        # GRAFT_TAIL_ROUNDS=0 forces the scan everywhere;
        # GRAFT_TAIL_ROUNDS_MIN moves the crossover (0 = rounds always).
        import os as _os
        self.tail_rounds = _os.environ.get("GRAFT_TAIL_ROUNDS", "1") != "0"
        self.tail_rounds_min = int(
            _os.environ.get("GRAFT_TAIL_ROUNDS_MIN", "48"))
        self._worker: Optional[_WaveWorker] = None

    def close(self) -> None:
        """Stop the engine's wave worker thread (idempotent)."""
        if self._worker is not None:
            self._worker.close()
            self._worker = None

    def schedule(self, pods: Sequence[Pod], assume: bool = True,
                 mode: str = "strict") -> List[PlacementResult]:
        """Schedule a batch. Returns one PlacementResult per pod, in input
        order. When assume=True, successful placements are assumed into
        the cache with pod.node_name set (the caller binds asynchronously).

        mode="strict" reproduces the reference's sequential scheduleOne
        (engine/batch.py); mode="wave" is the wave-parallel throughput mode
        (engine/waves.py) with identical predicate/priority integer
        semantics but batch-defined tie-spreading. Classes the device
        encoding over-approximates (needs_host_check, affinity slot
        overflow, the Policy's service-coupled classes) take the exact
        host oracle after the device placements, in FIFO order.
        """
        if mode not in ("strict", "wave"):
            raise ValueError(f"unknown mode {mode!r}")
        if not pods:
            return []
        with timed_span("engine.refresh"):
            infos = self._refresh()
        with timed_span("engine.encode"):
            all_pairs, aff_pairs = aff_ops.collect_pod_pairs(infos)
            # topology keys referenced by ANY affinity term (pending or
            # existing) must be in the label vocab before the label matrix
            # is finalized (ClassBatch next), or a key only an existing
            # pod's anti-affinity mentions has no domain columns
            aff_ops.intern_topology_pairs(self.snapshot, pods, aff_pairs)
            batch = ClassBatch(pods, self.snapshot)
            c_pad = bucket(batch.num_classes + 1)
            adata = aff_ops.AffinityData(batch.reps, self.snapshot,
                                         all_pairs, aff_pairs,
                                         self.workloads_provider(),
                                         self.hard_pod_affinity_weight,
                                         c_pad=c_pad)
            for c in np.nonzero(adata.overflow[:batch.num_classes])[0]:
                batch.mark_host_check_class(int(c))
            policy_active = self.policy_algos is not None \
                and self.policy_algos.active
            workloads_now = None
            if policy_active:
                workloads_now = self.workloads_provider()
                # service-coupled classes are order-dependent in-batch
                # (the reference's pod lister is the scheduler cache) ->
                # host path
                for c in np.nonzero(self.policy_algos.needs_host(
                        batch.reps, workloads_now))[0]:
                    batch.mark_host_check_class(int(c))
        nhc = batch.reps_batch.needs_host_check[batch.pod_class]
        if mode == "strict" and assume and nhc.any() and not nhc.all():
            # exact scheduleOne sequencing across the host/device boundary:
            # a host-path pod between two device pods must see the first's
            # commit and be seen by the second's (scheduler.go:253 is one
            # strict FIFO). Maximal same-path runs go in order, each
            # through the whole pipeline against the updated cache; flags
            # are class-deterministic, so each run is homogeneous and the
            # recursion ends after one level.
            results: List[PlacementResult] = []
            i = 0
            while i < len(pods):
                j = i + 1
                while j < len(pods) and nhc[j] == nhc[i]:
                    j += 1
                results.extend(self.schedule(list(pods[i:j]), assume=True,
                                             mode=mode))
                i = j
            return results

        policy_arrays = None
        if policy_active:
            policy_arrays = self.policy_algos.static_class_arrays(
                batch.reps, self.snapshot, workloads_now, all_pairs, c_pad,
                skip=batch.reps_batch.needs_host_check[:batch.num_classes])
        aff_mode, weights = _aff_mode(adata, self.priorities)
        dev = self.device
        with timed_span("engine.upload"):
            aff_arrays = adata.device_arrays(dev) if any(aff_mode) else None
            kernel_priorities = self.priorities if aff_arrays is not None \
                else self._kernel_priorities()
            nodes = self._nodes_on_device(
                port_words=self._port_words(batch))
        fast_idx = np.nonzero(~nhc)[0]
        slow_idx = np.nonzero(nhc)[0].tolist()
        results: List[Optional[PlacementResult]] = [None] * len(pods)

        if len(fast_idx):
            # the class axis and the pod axis pad to power-of-2 buckets;
            # padding classes are `impossible` (fit nothing, commit
            # nothing, no RR ticks) and padding pods map to the first one
            with timed_span("engine.upload"):
                cls_arr = preds.pod_arrays_padded(batch.reps_batch, c_pad,
                                                  dev)
                if policy_arrays is not None:
                    # host columns of the Policy algorithms: upload copies
                    pfit, pscore = policy_arrays
                    if pfit is not None:
                        cls_arr["policy_fit"] = tensor_from_numpy(pfit, dev)
                    if pscore is not None:
                        cls_arr["policy_score"] = tensor_from_numpy(pscore,
                                                                    dev)
            pf = len(fast_idx)
            pc_fast = np.full(bucket(pf), batch.num_classes, dtype=np.int32)
            pc_fast[:pf] = batch.pod_class[fast_idx]
            state = NodeState(nodes["requested"], nodes["nonzero"],
                              nodes["pod_count"], nodes["port_bitmap"],
                              nodes["vol_present"], nodes["vol_rw"],
                              nodes["pd_present"], nodes["pd_counts"])
            with timed_span("engine.place"):
                if mode == "wave":
                    selected, fit_counts, rr_end = self._run_wave(
                        batch, adata, cls_arr, nodes, state, pc_fast, pf,
                        aff_arrays, aff_mode, kernel_priorities, weights)
                else:
                    sel_d, fc_d, _, rr_d = gather_place_batch(
                        cls_arr, tensor_from_numpy(pc_fast, dev), nodes,
                        state,
                        torch.tensor(self.rr.counter & U32_MASK,
                                     dtype=torch.int64, device=dev),
                        kernel_priorities, aff=aff_arrays,
                        aff_mode=aff_mode)
                    # the synchronous engine's result fetch: schedule()
                    # owes its caller host placements
                    selected = sel_d.cpu().numpy()[:pf]
                    fit_counts = fc_d.cpu().numpy()[:pf]
                    rr_end = int(rr_d)
            self.rr.counter = int(rr_end)
            with timed_span("engine.assume"):
                self._fast_results(pods, batch, fast_idx, pc_fast, selected,
                                   fit_counts, assume, results)

        # exact host path for over-approximated pods, AFTER the device
        # placements so they see committed capacity (FIFO among themselves)
        if slow_idx:
            COUNTERS.inc("engine.classic_host_tail", len(slow_idx))
            with timed_span("engine.host_tail"):
                host_nodes = self._oracle_tail(pods, slow_idx, assume)
            for i, name in zip(slow_idx, host_nodes):
                results[i] = PlacementResult(pods[i], name,
                                             1 if name else 0)
        return results  # type: ignore[return-value]

    def _fast_results(self, pods, batch, fast_idx, pc_fast, selected,
                      fit_counts, assume: bool, results) -> None:
        """Fill `results` for the device-placed pods; assumes the placed
        ones into the cache (one bulk call) when `assume`."""
        names = self.snapshot.node_names
        placements = []
        # plain-int lists: numpy scalar indexing in a 30k-iteration loop
        # costs ~3x a list walk
        sel_l = np.asarray(selected).tolist()
        fc_l = np.asarray(fit_counts).tolist()
        pc_l = pc_fast.tolist()
        for j, i in enumerate(fast_idx.tolist()):
            sel = sel_l[j]
            pod = pods[i]
            if sel >= 0:
                name = names[sel]
                results[i] = PlacementResult(pod, name, fc_l[j])
                if assume:
                    pod.node_name = name
                    placements.append((pod, pc_l[j]))
            else:
                results[i] = PlacementResult(pod, None, fc_l[j])
        if placements:
            # one lock + one derived-quantity walk per PLACED class
            derived: Dict[int, tuple] = {}
            for _, c in placements:
                if c not in derived:
                    rep = batch.reps[c]
                    derived[c] = (rep.resource_request(),
                                  *rep.nonzero_request(), rep.used_ports())
            self.cache.assume_pods_bulk(placements, derived)
            self._touch(p.node_name for p, _ in placements)

    def _context(self, infos) -> SchedulingContext:
        """The exact oracle's view of `infos` under this engine's workloads,
        volumes and Policy."""
        return SchedulingContext(
            infos, self.workloads_provider(),
            hard_pod_affinity_weight=self.hard_pod_affinity_weight,
            volume_ctx=self.volume_ctx, policy_algos=self.policy_algos)

    def _oracle_tail(self, pods, idx, assume: bool = True
                     ) -> List[Optional[str]]:
        """The exact object-level scheduleOne for pods[idx], in order, each
        seeing the previous one's assume (when `assume`). Returns the node
        names, None where a pod fits nowhere."""
        infos = self.cache.node_infos()
        names = self.snapshot.node_names
        ctx = self._context(infos)
        out: List[Optional[str]] = []
        for i in idx:
            name = oracle.schedule_one(pods[i], names, infos, self.rr,
                                       self.priorities, ctx)
            out.append(name)
            if name is not None and assume:
                self._assume(pods[i], name)
                infos = self.cache.node_infos()
                ctx.infos = infos
                ctx.invalidate()
        return out

    def _run_wave(self, batch, adata, cls_arr, nodes, state, pc_fast, pf,
                  aff_arrays, aff_mode, kernel_priorities, weights):
        """Wave mode with affinity routing: classes whose REQUIRED
        (anti-)affinity makes placement order-dependent (adata.serialize)
        run through the strict scan AFTER the wave pass — seeded with the
        wave's topology occupancy so in-batch interactions stay exact —
        while everything else takes the throughput path with batch-frozen
        spread/interpod scores (waves.frozen_affinity_scores)."""
        w_ip, w_sp = weights
        fits_on, prio_on, spread_on = aff_mode
        dev = self.device
        extra = None
        if prio_on or spread_on:
            extra = waves.frozen_affinity_scores(
                cls_arr, nodes, state, aff_arrays,
                (w_ip if prio_on else 0, w_sp if spread_on else 0))
        ser = adata.serialize[pc_fast[:pf]]
        selected = np.full(pf, -1, dtype=np.int32)
        fit_counts = np.zeros(pf, dtype=np.int32)
        rr = self.rr.counter & U32_MASK
        wave_pos = np.nonzero(~ser)[0]
        strict_pos = np.nonzero(ser)[0]
        state_cur = state
        stats: Dict[str, int] = {}
        if len(wave_pos):
            wp = len(wave_pos)
            pcw = np.full(bucket(wp), batch.num_classes, dtype=np.int32)
            pcw[:wp] = pc_fast[wave_pos]
            # aff/aff_mode reach only the straggler finish inside
            # place_waves: preferred scoring stays batch-frozen (extra), so
            # prio/spread are off there to avoid counting them twice
            sel_w, fc_w, state_cur, rr = waves.place_waves(
                cls_arr, nodes, state_cur, pcw, rr, kernel_priorities,
                stats=stats, extra_score=extra, aff=aff_arrays,
                aff_mode=(fits_on, False, False))
            selected[wave_pos] = sel_w[:wp]
            fit_counts[wave_pos] = fc_w[:wp]
        if len(strict_pos):
            sp_n = len(strict_pos)
            COUNTERS.inc("engine.classic_strict_rows", sp_n)
            pcs = np.full(bucket(sp_n), batch.num_classes, dtype=np.int32)
            pcs[:sp_n] = pc_fast[strict_pos]
            aff_init = None
            if aff_arrays is not None:
                c_dim = aff_arrays["m_aff"].shape[0]
                comm_np = np.zeros((c_dim, int(nodes["alloc"].shape[0])),
                                   dtype=np.int32)
                for j in wave_pos:
                    if selected[j] >= 0:
                        comm_np[pc_fast[j], selected[j]] += 1
                committed0 = tensor_from_numpy(comm_np, dev)
                # per-domain occupancy [C, L]: the contraction runs over
                # nodes, so each sum is at most the pods the cluster holds
                # (< 2^24) and int_matmul is exact here
                commdom0 = int_matmul(committed0,
                                      mesh_mod.full(nodes["labels"]).T)
                comm_cnt0 = committed0.sum(dim=1, dtype=I32)
                aff_init = (commdom0, committed0, comm_cnt0)
            with timed_span("engine.strict_scan"):
                sel_s, fc_s, _, rr_d = gather_place_batch(
                    cls_arr, tensor_from_numpy(pcs, dev), nodes, state_cur,
                    torch.tensor(rr, dtype=torch.int64, device=dev),
                    kernel_priorities, aff=aff_arrays, aff_mode=aff_mode,
                    aff_init=aff_init)
                # strict-tail result fetch (the classic wave mode is
                # synchronous: the caller consumes placements immediately)
                selected[strict_pos] = sel_s.cpu().numpy()[:sp_n]
                fit_counts[strict_pos] = fc_s.cpu().numpy()[:sp_n]
                rr = int(rr_d)
        self.last_wave_stats = stats
        return selected, fit_counts, rr

    def _assume(self, pod: Pod, node_name: str) -> None:
        pod.node_name = node_name
        self.cache.assume_pod(pod)
        self._touch((node_name,))

    def _port_words(self, batch: ClassBatch) -> int:
        """Port-bitmap words to ship: the highest word any node uses or any
        batch pod requests, power-of-2 bucketed."""
        max_words = self.snapshot.port_words_used()
        if np.any(batch.reps_batch.ports >= 0):
            max_words = max(max_words,
                            int(batch.reps_batch.ports.max()) // 32 + 1)
        return bucket(max(max_words, 1), lo=1)

    # ------------------------------------------------- targeted refresh

    def _touch(self, node_names) -> None:
        """Record cache mutations for BOTH consumers: the targeted-refresh
        dirty set (cleared each refresh) and any in-flight wave's blind set
        (cleared at that wave's harvest — its fence must re-validate
        against exactly these nodes)."""
        if self.track_dirty or self._blind_listeners:
            names = list(node_names)
            if self.track_dirty:
                self._pending_dirty.update(names)
            for s in self._blind_listeners:
                s.update(names)

    def note_node_dirty(self, *node_names: str) -> None:
        """The owner observed a cache mutation touching these nodes (watch
        event applied, bind forgotten)."""
        self._touch(node_names)

    def note_full_refresh(self) -> None:
        """The owner cannot name what changed (node membership/spec moved,
        assumed-pod TTL expiry) — the next refresh walks everything."""
        self._need_full_refresh = True

    def note_node_doomed(self, *node_names: str) -> None:
        """The owner observed a node-dying watch event (DELETED, cordon,
        NotReady) it has NOT yet applied: any in-flight wave row targeting
        these nodes must requeue at the fence, not bind."""
        self._doomed_nodes.update(node_names)

    def clear_node_doomed(self, *node_names: str) -> None:
        """The dying event is applied — the snapshot now carries the
        verdict, so the doom mark is redundant for every later dispatch."""
        self._doomed_nodes.difference_update(node_names)

    def _refresh(self) -> Dict[str, object]:
        """Snapshot refresh with the targeted-hint fast path when the owner
        tracks dirt. Returns the infos map."""
        infos = self.cache.node_infos()
        hint = None
        if self.track_dirty and not self._need_full_refresh \
                and self.snapshot._shape_sig is not None:
            hint = sorted(self._pending_dirty)
        self.snapshot.refresh(infos, volume_ctx=self.volume_ctx,
                              changed_hint=hint)
        self._pending_dirty.clear()
        self._need_full_refresh = False
        return infos

    def _nodes_on_device(self, port_words: int = 1) -> Dict[str, torch.Tensor]:
        """Incremental host->device sync: re-upload an array only when its
        shape changed or the snapshot marked it dirty. Every upload is a
        COPY (sanitize.upload_copied, verified under GRAFT_SANITIZE=1): the
        snapshot mutates these buffers in place between batches (refresh
        deltas, apply_assume_delta) while a pipelined wave may still read
        the tensors, so a tensor must never alias one.

        With a resident mesh every array uploads SHARDED by the shared
        spec tables, and the dynamic arrays ride the ROW-DELTA path: when
        the snapshot can name the touched rows (snapshot.dirty_rows), only
        the shards owning those rows re-upload (ResidentMesh.update_rows)
        and untouched shards keep their tensors by reference
        (engine.shard_delta_rows counts the rows, engine.shard_upload_bytes
        the bytes actually shipped)."""
        snap = self.snapshot
        rmesh = self._rmesh
        rows = snap.dirty_rows if rmesh is not None else None
        uploaded = 0
        delta_used = False
        delta_bytes = 0
        for k in preds._NODE_ARRAY_KEYS:
            host = snap.port_bitmap[:, :port_words] if k == "port_bitmap" \
                else getattr(snap, k)
            cur = self._device_nodes.get(k)
            if cur is None or tuple(cur.shape) != host.shape \
                    or k in snap.dirty:
                if rmesh is not None:
                    if rows is not None and cur is not None \
                            and tuple(cur.shape) == host.shape \
                            and k in snap.DYNAMIC:
                        self._device_nodes[k] = rmesh.update_rows(cur, host,
                                                                  rows)
                        delta_used = True
                        delta_bytes += rmesh.touched_nbytes(host, rows)
                        continue
                    self._device_nodes[k] = sanitize.upload_copied(
                        host, self.device, mesh_mod.Placement(
                            self.mesh, mesh_mod.node_spec(k)))
                else:
                    self._device_nodes[k] = sanitize.upload_copied(
                        host, self.device)
                uploaded += 1
        if uploaded:
            COUNTERS.inc("engine.device_upload_arrays", uploaded)
        if delta_used:
            # DISTINCT rows this sync shipped through the per-shard delta
            # path (once, not once per dynamic array), plus the bytes moved
            # (whole touched shards, every dynamic array included)
            COUNTERS.inc("engine.shard_delta_rows", len(rows))
            COUNTERS.inc("engine.shard_upload_bytes", delta_bytes)
        snap.dirty.clear()
        if rmesh is not None:
            snap.dirty_rows = set()  # arm row tracking for the next sync
        self._device_version = snap.version
        return self._device_nodes

    # ------------------------------------------- wave-path preemption

    def _prio_on_device(self) -> Dict[str, torch.Tensor]:
        """Device bundle for the victim scan: spare capacity columns plus
        the priority-band aggregates, quantized at upload (band sums
        CEIL, need floors — the over-approximation direction
        ops/preempt.py documents). Re-uploaded whenever the snapshot
        version moved; ~[N, B] int32s, a fraction of one wave upload."""
        snap = self.snapshot
        if self._prio_dev is not None \
                and self._prio_dev_version == snap.version:
            return self._prio_dev
        shift = snap.mem_shift
        host = {
            "spare_cpu": (snap.alloc[:, R_CPU].astype(np.int64)
                          - snap.requested[:, R_CPU]).astype(np.int32),
            "spare_mem": (snap.alloc[:, R_MEM].astype(np.int64)
                          - snap.requested[:, R_MEM]).astype(np.int32),
            "pod_count": snap.pod_count,
            "allowed": snap.allowed_pods,
            "band_cpu": snap.band_cpu.astype(np.int32),
            "band_mem": (-((-snap.band_mem) >> shift)).astype(np.int32),
            "band_count": snap.band_count,
            "band_prio": np.clip(snap.band_prio_host, -(2 ** 31) + 1,
                                 2 ** 31 - 1).astype(np.int32),
        }
        # COPY, never alias: pod_count/allowed/band_* are live snapshot
        # arrays mutated in place between preemption rounds (refresh
        # deltas, apply_assume_delta band folds)
        self._prio_dev = {k: sanitize.upload_copied(v, self.device)
                          for k, v in host.items()}
        self._prio_dev_version = snap.version
        return self._prio_dev

    def preempt_scan(self, pods: Sequence[Pod]):
        """ONE [C, N] victim pre-filter for a round of preemptors:
        returns (candidate [C, N] bool, bound [C, N] int32, class_of
        [len(pods)]) as host arrays, with C the padded unique-(need,
        priority) class count — or None when the band vocab overflowed /
        priorities exceed int32, routing the caller to the exact host
        pre-filter (the reference's own semantics, counted by the caller
        as engine.preempt_scan_host_fallback)."""
        snap = self.snapshot
        if snap.prio_band_overflow or not hasattr(snap, "band_cpu") \
                or not pods:
            return None
        shift = snap.mem_shift
        uniq: Dict[tuple, int] = {}
        rows: List[tuple] = []
        class_of: List[int] = []
        for p in pods:
            if not (-(2 ** 31) < p.priority < 2 ** 31):
                return None
            req = p.resource_request()
            key = (req.milli_cpu, req.memory, p.priority)
            c = uniq.get(key)
            if c is None:
                c = len(rows)
                uniq[key] = c
                # need: cpu exact, mem FLOOR-quantized (under-estimates
                # need — the superset direction)
                rows.append((req.milli_cpu, req.memory >> shift,
                             p.priority))
            class_of.append(c)
        # pad the class axis to the bucket ladder (both packages pad it
        # identically); padding rows carry PAD_PRIO, below every band —
        # no candidates
        c_pad = bucket(len(rows), lo=4)
        need_cpu = np.zeros(c_pad, dtype=np.int32)
        need_mem = np.zeros(c_pad, dtype=np.int32)
        prio_c = np.full(c_pad, preempt_ops.PAD_PRIO, dtype=np.int32)
        for c, (cpu, mem_q, pr) in enumerate(rows):
            need_cpu[c] = min(cpu, 2 ** 31 - 1)
            need_mem[c] = min(mem_q, 2 ** 31 - 1)
            prio_c[c] = pr
        dev = self._prio_on_device()
        COUNTERS.inc("engine.preempt_scan_dispatch")
        cand_d, bound_d = preempt_ops.victim_scan(
            tensor_from_numpy(need_cpu, self.device),
            tensor_from_numpy(need_mem, self.device),
            tensor_from_numpy(prio_c, self.device),
            dev["spare_cpu"], dev["spare_mem"], dev["pod_count"],
            dev["allowed"], dev["band_cpu"], dev["band_mem"],
            dev["band_count"], dev["band_prio"])
        # the scan's one result fetch, on the calling (harvesting)
        # thread's stream: the host planner consumes the candidate rows
        # NOW — a preemption round is synchronous by contract (it runs
        # inside the harvest tail)
        cand = cand_d.cpu().numpy()
        bound = bound_d.cpu().numpy()
        return cand, bound, class_of

    # ------------------------------------------------- pipelined drain

    def _aff_placement(self, key: str):
        """The mesh placement of an affinity tensor, or None unsharded."""
        return None if self.mesh is None \
            else mesh_mod.Placement(self.mesh, mesh_mod.aff_spec(key))

    def _kernel_priorities(self) -> Tuple[Tuple[str, int], ...]:
        return tuple((nm, w) for nm, w in self.priorities
                     if nm not in prio.AFFINITY_PRIORITIES)

    _STATE_NODE_KEYS = frozenset({
        "requested", "nonzero", "pod_count", "port_bitmap",
        "vol_present", "vol_rw", "pd_present", "pd_counts",
        # node CONDITION arrays flip under churn but precompute does not
        # read them (node_condition_fit is ANDed fresh per dispatch)
        "schedulable", "valid", "mem_pressure", "disk_pressure"})

    def _tail_wave_pre(self, enc: "_WaveEncoding", nodes):
        """The drain's shared waves.precompute instance (see _pre_cache).
        precompute reads only the class encoding and STATIC node tensors,
        and skips InterPodAffinity/SelectorSpread, so one instance computed
        at the kernel priorities serves both the wave loop and the
        (possibly IP-bearing) tail priorities."""
        # the key holds the STATIC tensors THEMSELVES (not their id()s):
        # the cache keeps them alive so a recycled address can never alias
        # a fresh upload into a stale hit
        key = tuple(nodes[k] for k in sorted(nodes)
                    if k not in self._STATE_NODE_KEYS)
        hit = self._pre_cache
        if hit is not None and hit[0] is enc and len(hit[1]) == len(key) \
                and all(a is b for a, b in zip(hit[1], key)):
            return hit[2]
        COUNTERS.inc("engine.wave_pre_build")
        pre = waves.precompute(enc.cls_arr, nodes, self._kernel_priorities())
        self._pre_cache = (enc, key, pre)
        return pre

    # ---------------------------------------- Protean delta patch

    def _try_patch_foreign(self, enc: "_WaveEncoding") -> bool:
        """Absorb FOREIGN occupancy churn into the cached wave encoding by
        patching exactly the rows it touched instead of rebuilding
        AffinityData wholesale. Patchable events are plain pods entering/
        leaving known nodes: a plain pod matching an encoded class's
        required-ANTI selector adds/removes a forbidden source on exactly
        one node (and, for strict-tail classes, its projected domain
        columns); a plain pod matching nothing is a no-op. Returns False —
        rebuild — when the event log no longer covers the gap, a churned
        pod CARRIES (anti-)affinity terms, it matches an encoded class's
        own required-AFFINITY selector, or its node is unknown to the
        snapshot. Delta-0 events (tombstone moves) are no-op patches."""
        events = self.cache.aff_events_since(enc.aff_seq)
        if events is None:
            return False
        if not events:
            return True
        snap = self.snapshot
        ad = enc.adata
        patched = 0
        touched = False
        for _seq, pod, node_name, delta in events:
            if delta == 0:
                patched += 1
                continue
            if aff_ops._has_affinity(pod):
                return False  # potential symmetry source entering or
                # leaving: its own terms bake into forbid_static
            if ad is None:
                # affinity-free encoding: plain churn cannot touch it —
                # advancing the expectation IS the patch
                patched += 1
                continue
            for _c, _s, term, rep in enc.aff_terms:
                if term_matches_pod(term, rep, pod):
                    return False  # allow-set delta: must be exact both ways
            n_idx = snap.node_index.get(node_name, -1)
            if n_idx < 0:
                return False
            for c, a, term, rep in enc.anti_terms:
                if not term_matches_pod(term, rep, pod):
                    continue
                ff = enc.foreign_forbid
                if ff is not None:
                    if delta > 0:
                        ff[c, n_idx] += 1
                        touched = True
                    elif ff[c, n_idx] > 0:
                        ff[c, n_idx] -= 1
                        touched = True
                    # else: a build-time static source left — the baked
                    # 0/1 hit cannot decrement; stay forbidden (safe side)
                fd = enc.foreign_forbid_dom
                if fd is not None and enc.tail_cols is not None \
                        and enc.tail_cols.size:
                    cols_hit = (
                        (ad.anti_keymask[c, a, enc.tail_cols] > 0)
                        & (snap.labels[n_idx, enc.tail_cols] > 0))
                    if delta > 0:
                        fd[c, cols_hit] += 1
                        touched = True
                    else:
                        dec = cols_hit & (fd[c] > 0)
                        if dec.any():
                            fd[c, dec] -= 1
                            touched = True
            patched += 1
        enc.aff_seq = events[-1][0]
        if touched:
            enc.aff_patch_dirty = True
        COUNTERS.inc("engine.aff_patch_rows", patched)
        if patched and RECORDER.enabled:
            RECORDER.record(flightrec.PATCH, a=patched)
        return True

    def _try_patch_labels(self, enc: "_WaveEncoding", infos) -> bool:
        """Absorb label-CONTENT churn (relabels to already-interned
        columns) into the cached encoding by re-deriving the topology
        projections of exactly the touched node ROWS. A relabel forces a
        rebuild only when the changed columns intersect the domains a
        baked array resolved through: a changed column under a term
        keymask whose selector matches a resident pod, a resident
        pods_with_affinity whose own term topology keys cover a changed
        column, patched foreign-forbid weight riding changed columns, or a
        relabel that merges two nodes into one anti domain of a
        wave-eligible class."""
        snap = self.snapshot
        entries = snap.labels_rows_since(enc.labels_gen)
        if entries is None:
            return False
        if not entries:
            return True
        ad = enc.adata
        if ad is None:
            enc.labels_gen = snap.labels_gen
            return True
        L = ad.anti_keymask.shape[2]
        by_row: Dict[int, set] = {}
        for r, cols in entries:
            by_row.setdefault(r, set()).update(
                int(c) for c in cols if c < L)
        rows = sorted(by_row)
        names = snap.node_names
        vocab_cols = snap.label_vocab.by_key
        for r in rows:
            if r >= len(names):
                return False
            info = infos.get(names[r])
            if info is None:
                return False
            cols = np.asarray(sorted(by_row[r]), dtype=np.int64)
            if cols.size == 0:
                continue
            for c, a, term, rep in enc.anti_terms:
                if ad.anti_keymask[c, a, cols].any() and any(
                        term_matches_pod(term, rep, q) for q in info.pods):
                    return False  # a baked forbid source's domain moved
            for c, s, term, rep in enc.aff_terms:
                if ad.aff_keymask[c, s, cols].any() and any(
                        term_matches_pod(term, rep, q) for q in info.pods):
                    return False  # a baked allow source's domain moved
            colset = by_row[r]
            for q in info.pods_with_affinity:
                for key in aff_ops._term_topology_keys(q):
                    if any(k < L and k in colset
                           for k in vocab_cols.get(key, ())):
                        return False  # a symmetry source's domain moved
            if enc.foreign_forbid is not None \
                    and enc.foreign_forbid[:, r].any() and any(
                        ad.anti_keymask[c, a, cols].any()
                        for c, a, _t, _rep in enc.anti_terms):
                return False  # patched per-node weight resolved through
                # a column this relabel moved
            if enc.foreign_forbid_dom is not None \
                    and enc.tail_cols is not None and enc.tail_cols.size:
                in_tail = np.isin(enc.tail_cols, cols)
                if in_tail.any() \
                        and enc.foreign_forbid_dom[:, in_tail].any():
                    return False
        if enc.key_node is not None:
            km = ad.anti_keymask                            # [C, A, L]
            wave_cls = ~ad.wave_strict                      # [C]
            km_wave = km[wave_cls]
            all_cols = sorted(set().union(*by_row.values())) \
                if by_row else []
            if km_wave.size and all_cols:
                # singleton-domain invariant check over the wave-eligible
                # classes' anti columns this relabel touched
                cols_arr = np.asarray(all_cols, dtype=np.int64)
                active = km_wave.astype(bool).any(axis=(0, 1))[cols_arr]
                hit = cols_arr[active]
                if hit.size and np.any(
                        snap.domain_node_counts()[hit] > 1):
                    return False
            C_, A_, L_ = km.shape
            lab_t = snap.labels[rows].astype(np.float64).T  # [L, r]
            kn_rows = ((km.reshape(C_ * A_, L_).astype(np.float64) @ lab_t)
                       > 0).reshape(C_, A_, len(rows))
            # copy-on-write: earlier uploads were copies anyway, but the
            # fence reads these arrays between patches
            key_node = enc.key_node.copy()
            key_node[:, :, rows] = kn_rows.astype(np.int8)
            enc.key_node = key_node
            sfh = enc.static_forbid_hit.copy()
            sfh[:, rows] = ((ad.forbid_static.astype(np.float64) @ lab_t)
                            > 0).astype(np.int8)
            enc.static_forbid_hit = sfh
            enc.aff_patch_dirty = True
        if enc.tail_cols is not None and enc.aff_tail_dev is not None:
            enc.aff_tail_dev["labels_aff"] = sanitize.upload_frozen(
                snap.labels[:, enc.tail_cols], self.device,
                self._aff_placement("labels_aff"))
        enc.labels_gen = snap.labels_gen
        COUNTERS.inc("engine.label_patch_rows", len(rows))
        if rows and RECORDER.enabled:
            RECORDER.record(flightrec.PATCH, b=len(rows))
        return True

    def _flush_aff_patches(self, enc: "_WaveEncoding") -> None:
        """Re-upload the tensors a patch invalidated — one batched refresh
        per dispatch, however many events were absorbed. The dict entries
        are replaced, never written in place: a running wave job holds its
        own view of the dict."""
        if not enc.aff_patch_dirty:
            return
        if enc.aff_wave_dev is not None:
            merged = enc.static_forbid_hit.astype(np.int32)
            if enc.foreign_forbid is not None:
                merged = merged + enc.foreign_forbid
            enc.aff_wave_dev["static_forbid"] = sanitize.upload_frozen(
                np.minimum(merged, 127).astype(np.int8), self.device,
                self._aff_placement("static_forbid"))
            # a copy is frozen, never the live overlay: it keeps mutating
            # patch over patch (copy-on-write in _try_patch_labels)
            enc.aff_wave_dev["key_node"] = sanitize.upload_frozen(
                enc.key_node.copy(), self.device,
                self._aff_placement("key_node"))
        if enc.aff_tail_dev is not None and enc.tail_cols is not None:
            base = enc.adata.forbid_static[:, enc.tail_cols].astype(np.int32)
            if enc.foreign_forbid_dom is not None:
                base = base + enc.foreign_forbid_dom
            enc.aff_tail_dev["forbid_static"] = sanitize.upload_frozen(
                np.minimum(base, 127).astype(np.int8), self.device,
                self._aff_placement("forbid_static"))
        enc.aff_patch_dirty = False

    def _wave_encoding(self, pods: Sequence[Pod], infos):
        """(encoding, pod_class[n]) for a pipeline chunk, via the
        (vocab_gen, aff_seq, workload-identity)-keyed reuse cache. Every
        chunk shape is wave-eligible: affinity classes the topology
        counters express run per wave on the device, label-pure host-check
        classes carry an exact precomputed host_fit column, Policy classes
        carry frozen policy_fit/policy_score columns with a fence-side
        exact re-check, and everything else (live-NodeInfo ports,
        preference overflow, Policy order-dependence, affinity slot
        overflow) rides inactive and places at the harvest's exact oracle
        tail."""
        snap = self.snapshot
        enc = self._wave_enc
        policy_active = self.policy_algos is not None \
            and self.policy_algos.active
        w_ip = sum(w for nm, w in self.priorities
                   if nm == "InterPodAffinityPriority")
        w_sp = sum(w for nm, w in self.priorities
                   if nm == "SelectorSpreadPriority")
        # workloads are placement-relevant only through Policy predicates
        # or a live SelectorSpread weight; otherwise their churn can never
        # change a placement and the encoding ignores them entirely
        workloads_now = tuple(self.workloads_provider()) \
            if (policy_active or w_sp) else ()
        fresh = enc is not None and enc.vocab_gen == snap.vocab_gen
        if fresh and enc.policy_on != policy_active:
            fresh = False
        if fresh and (policy_active or w_sp):
            wk = enc.wkey
            if len(wk) != len(workloads_now) or not all(
                    a is b for a, b in zip(wk, workloads_now)):
                # workload set moved: the frozen policy/spread arrays and
                # the needs_host classification are stale — full rebuild
                fresh = False
        if fresh and enc.has_static_cols \
                and enc.labels_gen != snap.labels_gen:
            # host/policy static columns bake label content; checked
            # BEFORE the affinity label-patch path so a patched encoding
            # can never keep a stale column
            fresh = False
        if fresh and enc.adata is not None \
                and enc.labels_gen != snap.labels_gen:
            # label content moved: patch the touched rows or rebuild
            fresh = self._try_patch_labels(enc, infos)
        if fresh and enc.aff_seq != self.cache.aff_seq:
            # foreign occupancy churn: patch the touched rows or rebuild
            fresh = self._try_patch_foreign(enc)
        if fresh:
            key_index = enc.key_index
            pc = np.empty(len(pods), dtype=np.int32)
            hit = True
            for i, p in enumerate(pods):
                c = key_index.get(pod_class_key(p), -1)
                if c < 0:
                    hit = False
                    break
                pc[i] = c
            if hit:
                COUNTERS.inc("engine.wave_encode_reuse")
                return enc, pc
        # rebuild over the union with the cached reps so chunks alternating
        # between two class sets don't thrash the cache. Seeding FIRST also
        # keeps prior class indices stable, so a mid-drain rebuild leaves
        # any in-flight handle's class rows meaningful.
        seed: List[Pod] = []
        if enc is not None and enc.vocab_gen == snap.vocab_gen:
            seed = enc.reps
        aff_seq0 = self.cache.aff_seq
        chunk_aff = any(aff_ops._has_affinity(p) for p in seed) \
            or any(aff_ops._has_affinity(p) for p in pods)
        cluster_aff = any(bool(i.pods_with_affinity) for i in infos.values())
        # spread-only chunks build AffinityData too: the workload-
        # membership arrays drive the frozen SelectorSpread score
        build_adata = chunk_aff or cluster_aff \
            or (bool(w_sp) and bool(workloads_now))
        all_pairs: list = []
        aff_pairs: list = []
        if build_adata or policy_active:
            all_pairs, aff_pairs = aff_ops.collect_pod_pairs(infos)
        if build_adata:
            # topology keys referenced by ANY affinity term must be
            # interned BEFORE the label matrix finalizes
            aff_ops.intern_topology_pairs(snap, seed + list(pods), aff_pairs)
        batch = ClassBatch(seed + list(pods), snap)
        n_cls = batch.num_classes
        rb = batch.reps_batch
        c_pad = bucket(n_cls + 1)
        # host-check absorption: label-pure host classes get an exact
        # precomputed fit column and ride the wave; the rest (live-NodeInfo
        # ports, score-affecting preference overflow, shapes the column
        # cannot derive, Policy order-dependence, affinity slot overflow
        # below) ride as inactive rows and place at the harvest's exact
        # oracle tail
        host_exact = np.zeros(c_pad, dtype=bool)
        host_static = np.zeros(c_pad, dtype=bool)
        nhc = rb.needs_host_check[:n_cls]
        host_exact[:n_cls] = nhc & rb.host_check_dynamic[:n_cls]
        host_fit_rows: Dict[int, np.ndarray] = {}
        for c in np.nonzero(nhc & ~rb.host_check_dynamic[:n_cls])[0]:
            row = rb.host_static_fit(int(c), snap)
            if row is None:
                host_exact[c] = True  # not derivable from labels alone
            else:
                host_static[c] = True
                host_fit_rows[int(c)] = row
        if policy_active:
            # service-coupled classes are order-dependent in-batch (the
            # reference's pod lister is the scheduler cache) -> exact tail
            host_exact[:n_cls] |= np.asarray(
                self.policy_algos.needs_host(batch.reps, workloads_now),
                dtype=bool)[:n_cls]
        adata = None
        fits_on = prio_on = spread_on = False
        aff_wave_dev = aff_tail_dev = None
        key_node = static_forbid_hit = tail_cols = None
        if build_adata:
            COUNTERS.inc("engine.wave_aff_build")
            # every wholesale AffinityData build the patch paths could NOT
            # absorb
            COUNTERS.inc("engine.aff_full_rebuilds")
            adata = aff_ops.AffinityData(batch.reps, snap, all_pairs,
                                         aff_pairs, workloads_now,
                                         self.hard_pod_affinity_weight,
                                         c_pad=c_pad)
            host_exact[:n_cls] |= adata.overflow[:n_cls]
            fits_on = bool(adata.fits_needed)
            prio_on = bool(w_ip) and bool(adata.prio_needed)
            spread_on = bool(w_sp) and bool(adata.spread_needed)
            if fits_on:
                key_node, static_forbid_hit = _aff_node_views(adata, snap)
                # static per encoding — the frozen seam, like the tail;
                # node-axis members shard over the resident mesh
                aff_wave_dev = {
                    k: sanitize.upload_frozen(a, self.device,
                                              self._aff_placement(k))
                    for k, a in (("m_anti", adata.m_anti),
                                 ("key_node", key_node),
                                 ("static_forbid", static_forbid_hit),
                                 ("wave_gate", adata.wave_gate))}
            if fits_on or prio_on or spread_on:
                tail_cols = _aff_tail_cols(adata, prio_on)
                aff_tail_dev = _aff_tail_arrays(adata, snap, tail_cols,
                                                self.device, self.mesh)
        COUNTERS.inc("engine.wave_encode_build")
        cls_arr = preds.pod_arrays_padded(rb, c_pad, self.device)
        if host_fit_rows:
            # the host-check static column: exact label-pure fit rows for
            # host_static classes, folded into the [C, N] eval via
            # predicates.static_fits (padding rows True — the validity
            # mask already excludes them); a copy, like every upload
            hf = np.ones((c_pad, snap.valid.shape[0]), dtype=bool)
            for c, row in host_fit_rows.items():
                hf[c] = row
            cls_arr["host_fit"] = sanitize.upload_frozen(hf, self.device)
        policy_cols = False
        if policy_active:
            pfit, pscore = self.policy_algos.static_class_arrays(
                batch.reps, snap, workloads_now, all_pairs, c_pad,
                skip=host_exact[:n_cls])
            if pfit is not None:
                cls_arr["policy_fit"] = tensor_from_numpy(pfit, self.device)
                policy_cols = True
            if pscore is not None:
                cls_arr["policy_score"] = tensor_from_numpy(pscore,
                                                            self.device)
                policy_cols = True
        key_index = {pod_class_key(rep): c
                     for c, rep in enumerate(batch.reps)}
        special = ((rb.ports[:n_cls, 0] >= 0)
                   | (rb.vol_hard[:n_cls].sum(axis=1)
                      + rb.vol_ro[:n_cls].sum(axis=1)
                      + rb.pd_req[:n_cls].sum(axis=1) > 0))
        derived = [(rep.resource_request(), *rep.nonzero_request(),
                    rep.used_ports()) for rep in batch.reps]
        ports_max = int(rb.ports.max()) if np.any(rb.ports >= 0) else -1
        # clone the reps for reuse: the originals get node_name assigned at
        # assume time, which would corrupt their class key as seeds
        reps = [_dc.replace(p) for p in batch.reps]
        self._wave_enc = enc2 = _WaveEncoding(
            snap.vocab_gen, key_index, reps, cls_arr, n_cls, c_pad,
            rb.req[:n_cls].astype(np.int64), special, derived, ports_max,
            adata=adata, fits_on=fits_on, prio_on=prio_on,
            aff_seq=aff_seq0,
            aff_wave_dev=aff_wave_dev, aff_tail_dev=aff_tail_dev,
            key_node=key_node, static_forbid_hit=static_forbid_hit,
            tail_cols=tail_cols, n_pad=snap.valid.shape[0],
            labels_gen=snap.labels_gen, host_exact=host_exact,
            host_static=host_static, policy_on=policy_active,
            spread_on=spread_on, wkey=workloads_now,
            has_static_cols=bool(host_fit_rows) or policy_cols)
        if adata is not None:
            for c, rep in enumerate(reps):
                for a, term in enumerate(_own_terms(rep, anti=True)):
                    enc2.anti_terms.append((c, a, term, rep))
                for s, term in enumerate(_own_terms(rep, anti=False)):
                    enc2.aff_terms.append((c, s, term, rep))
        return enc2, batch.pod_class[len(seed):].copy()

    def dispatch_waves(self, pods: Sequence[Pod], pop_ts: float = 0.0,
                       gangs=None) -> Optional[WaveHandle]:
        """Encode a chunk and hand its wave placement to the engine's
        worker WITHOUT waiting for it — the device computes while the
        caller does the previous wave's bookkeeping. The chunk is evaluated
        against the snapshot as of NOW, which is blind to the
        still-unharvested wave's commits; harvest_waves' fence
        re-validates (capacity AND topology occupancy). Required
        (anti-)affinity chunks are wave-eligible: counter-expressible
        classes re-evaluate their masks per wave on the device,
        inexpressible ones ride as inactive rows and the harvest finishes
        them via the seeded strict tail. Host-check and Policy chunks ride
        too: label-pure host classes via the precomputed host_fit column,
        the rest as inactive rows placed at the harvest's exact oracle
        tail. Returns None only for the one disclosed corner — a gang
        whose quorum is unreachable from its wave-eligible members (it
        would roll back forever).

        `gangs` = [(name, member indices into `pods`, quorum)]: quorum-
        ready gangs riding this wave as ordinary batch rows. Dispatch
        treats them like any other pod; atomicity lives entirely in
        harvest_waves' gang fence, so the pipeline never drains for a
        gang chunk."""
        if not pods:
            return None
        _rec_t0 = time.monotonic() if RECORDER.enabled else 0.0
        with timed_span("pipeline.dispatch"):
            infos = self._refresh()
            enc, pc = self._wave_encoding(pods, infos)
            hx = enc.host_exact[pc]
            host_idx = np.nonzero(hx)[0].astype(np.int64)
            if gangs and host_idx.size:
                # the one remaining chunk-shape flush corner (disclosed):
                # a gang whose quorum is unreachable from its wave-
                # eligible members would roll back on every re-dispatch —
                # only IT flushes to the classic round
                hset = set(host_idx.tolist())
                for _gname, idxs, quorum in gangs:
                    if sum(1 for i in idxs if i not in hset) < quorum:
                        COUNTERS.inc("engine.wave_flush_gang_host")
                        return None
            if enc.adata is not None:
                # patched topology views re-upload once per dispatch,
                # however many churn events were absorbed since the last
                self._flush_aff_patches(enc)
            dev = self.device
            n = len(pods)
            p_pad = bucket(max(n, self.wave_pad_floor or 1))
            pc_pad = np.full(p_pad, enc.num_classes, dtype=np.int32)
            pc_pad[:n] = pc
            if host_idx.size:
                # host_exact rows ride as the PADDING class: impossible on
                # the device (fit nothing, no RR ticks, retire on the first
                # wave) — the harvest's exact oracle tail places them
                # against live NodeInfo truth after the fence
                pc_pad[host_idx] = enc.num_classes
                COUNTERS.inc("engine.wave_host_rows", int(host_idx.size))
            max_words = self.snapshot.port_words_used()
            if enc.ports_max >= 0:
                max_words = max(max_words, enc.ports_max // 32 + 1)
            port_words = bucket(max(max_words, 1), lo=1)
            nodes = dict(self._nodes_on_device(port_words=port_words))
            state = NodeState(nodes["requested"], nodes["nonzero"],
                              nodes["pod_count"], nodes["port_bitmap"],
                              nodes["vol_present"], nodes["vol_rw"],
                              nodes["pd_present"], nodes["pd_counts"])
            extra = None
            if enc.prio_on or enc.spread_on:
                # preferred-affinity / SelectorSpread scores, frozen
                # against the encoding's static topology view (the
                # reference's wave-mode approximation) — over the tail's
                # projected domain axis, which covers every priority-side
                # keymask column by construction
                w_ip = sum(w for nm, w in self.priorities
                           if nm == "InterPodAffinityPriority")
                w_sp = sum(w for nm, w in self.priorities
                           if nm == "SelectorSpreadPriority")
                extra = waves.frozen_affinity_scores(
                    enc.cls_arr, nodes, state, enc.aff_tail_dev,
                    (w_ip if enc.prio_on else 0,
                     w_sp if enc.spread_on else 0))
            strict_idx = np.empty(0, dtype=np.int64)
            aff = committed_dev = act_dev = None
            if enc.fits_on:
                ser = enc.wave_strict[pc] & ~hx
                strict_idx = np.nonzero(ser)[0]
                act = np.zeros(p_pad, dtype=bool)
                act[:n] = ~(ser | hx)
                act_dev = tensor_from_numpy(act, dev)
                # committed_nodes uploads as a COPY: the harvest folds
                # commits into it in place (np.add.at) while this wave's
                # job may still read the tensor
                committed_dev = sanitize.upload_copied(
                    enc.committed_nodes, dev,
                    None if self.mesh is None
                    else mesh_mod.Placement(self.mesh,
                                            mesh_mod.committed_spec()))
                # the job's own view of the dict: a later patch replaces
                # entries, never the tensors this job reads
                aff = dict(enc.aff_wave_dev)
                if strict_idx.size:
                    COUNTERS.inc("engine.affinity_strict_tail",
                                 int(strict_idx.size))
            pre = self._tail_wave_pre(enc, nodes)
            if self._worker is None:
                self._worker = _WaveWorker(dev)
            job = self._worker.submit(functools.partial(
                _wave_job, enc.cls_arr, nodes, state,
                tensor_from_numpy(pc_pad, dev), self._rr_chain,
                self.rr.counter, self._kernel_priorities(), extra, aff,
                committed_dev, act_dev, pre, p_pad, self.mesh))
            self._rr_chain = job
            blind: set = set()
            self._blind_listeners.append(blind)
            COUNTERS.inc("engine.wave_dispatch")
            # admitted-pod count per dispatch: wave_dispatch_pods /
            # wave_dispatch is the realized wave size
            COUNTERS.inc("engine.wave_dispatch_pods", n)
            if gangs:
                COUNTERS.inc("engine.gang_wave_dispatch", len(gangs))
            wave_id = -1
            if RECORDER.enabled or TRACER.enabled:
                wave_id = RECORDER.next_wave()
            if _rec_t0 and RECORDER.enabled:
                RECORDER.record(flightrec.DISPATCH, wave=wave_id,
                                t0=_rec_t0,
                                dur=time.monotonic() - _rec_t0,
                                a=n, b=len(gangs) if gangs else 0)
            if TRACER.enabled:
                TRACER.batch_event(podtrace.WAVE_DISPATCHED,
                                   [p.key() for p in pods], a=wave_id)
            return WaveHandle(list(pods), pc, enc, job, nodes, blind,
                              pop_ts, time.monotonic(), self.wave_pad_floor,
                              strict_idx=strict_idx, gangs=gangs,
                              wave_id=wave_id, host_idx=host_idx)

    def harvest_waves(self, handle: WaveHandle) -> WaveHarvest:
        """Wait for one wave's job, fence its placements against
        post-blind-window occupancy, and assume the survivors (columnar).
        The fence is exact for resources and pod count (the snapshot is
        re-refreshed here, so it reflects every commit and watch event the
        device did not see); port/volume classes requeue conservatively
        when their node was touched in the blind window. Conflicting pods
        are returned for requeue WITHOUT backoff — they lost a capacity
        race, they are not unschedulable."""
        _rec_t0 = time.monotonic() if RECORDER.enabled else 0.0
        # the fence below compares against snapshot arrays — fold in any
        # commits/events since the last dispatch (hinted: near-free when
        # nothing moved)
        self._refresh()
        enc = handle.enc
        snap = self.snapshot
        if enc is self._wave_enc and enc.adata is not None \
                and enc.aff_seq != self.cache.aff_seq:
            # foreign churn landed while this wave was in flight: patch
            # the overlays NOW so the topology fence compares against it
            # exactly; a failed patch leaves the mismatch and
            # _fence_affinity requeues every relevant row conservatively
            self._try_patch_foreign(enc)
        n = len(handle.pods)
        p_pad = bucket(max(n, handle.pad_floor or 1))
        t0 = time.perf_counter()
        with timed_span("pipeline.device_block"):
            # THE pipeline's blessed wait: harvest exists to absorb this
            # wave's device time while the NEXT wave already runs
            handle.block()
        t_block = time.perf_counter() - t0
        _rec_block_end = time.monotonic() if _rec_t0 else 0.0
        packed_h = handle.packed_h
        # the per-wave device->host payload: [3P+2] int32 regardless of N
        COUNTERS.inc("engine.host_fetch_bytes", int(packed_h.nbytes))
        if self.mesh is not None:
            # traffic of the two-stage winner reduce: each INNER wave
            # iteration's cross-shard stage moves the [D, C] tie-count
            # table plus O(P) candidate combines — scaled by waves_used
            # (packed[3P+1]), not per dispatch
            COUNTERS.inc("engine.reduce_candidate_rows",
                         self.mesh.size * enc.c_pad
                         * int(packed_h[3 * p_pad + 1]))
        sel = packed_h[:n].copy()
        fc = packed_h[p_pad:p_pad + n].copy()
        act = packed_h[2 * p_pad:2 * p_pad + n].astype(bool)
        counter_h = int(packed_h[3 * p_pad]) & U32_MASK
        tail_idx = np.nonzero(act)[0]
        if handle.host_idx.size:
            # host_exact rows retire inactive off the padding class on the
            # first wave; they never ride the device tail — the exact
            # oracle tail below places them after the fence
            tail_idx = np.setdiff1d(tail_idx, handle.host_idx)
        straggler_idx = np.empty(0, dtype=np.int64)
        if enc.adata is not None and tail_idx.size:
            # max-waves stragglers may NOT ride the seeded tail in an
            # affinity chunk: the tail's domain projection carries only
            # the wave_strict classes' columns, so a straggler's own anti
            # terms would be invisible to it. Requeue without backoff; the
            # next dispatch re-waves them against the updated occupancy.
            straggler_idx = tail_idx
            tail_idx = np.empty(0, dtype=np.int64)
            COUNTERS.inc("engine.affinity_straggler_requeues",
                         int(straggler_idx.size))
        if handle.strict_idx.size:
            # wave_strict classes never entered the waves: finish them —
            # together with any max_waves stragglers (affinity-free
            # encodings only) — via ONE seeded strict tail, in FIFO order,
            # against the wave's final state AND its final topology
            # occupancy
            tail_idx = np.unique(np.concatenate([tail_idx,
                                                 handle.strict_idx]))
        if tail_idx.size:
            # the tail's RR draws land after the next wave's (already
            # chained) counter — deterministic in both pipelined and
            # sequential modes, since dispatch k+1 always precedes
            # harvest k in either
            counter_h = self._harvest_tail(handle, tail_idx, sel, fc,
                                           counter_h)
        if self._rr_chain is handle.job:
            self._rr_chain = None
        self.rr.counter = counter_h
        self._blind_listeners.remove(handle.blind)

        pods = handle.pods
        strag = set(straggler_idx.tolist())
        placed_idx = np.nonzero(sel >= 0)[0]
        acc_idx = np.empty(0, dtype=np.int64)
        acc_node = np.empty(0, dtype=np.int64)
        acc_cls = np.empty(0, dtype=np.int32)
        conflict_idx: List[int] = []
        conflict_codes: List[int] = []
        liveness_idx: List[int] = []
        if placed_idx.size:
            with timed_span("pipeline.fence"):
                (acc_idx, acc_node, acc_cls, conflict_idx, liveness_idx,
                 conflict_codes) = self._fence(handle, sel, placed_idx)
        # the GANG FENCE: all-or-nothing atomicity for gangs that rode
        # this wave as ordinary batches. A gang COMMITS when >= quorum
        # members survived placement AND the capacity/topology fence;
        # below quorum, every member — placed, fenced, or unschedulable —
        # is dropped from the accepted set BEFORE anything is assumed
        # (atomic rollback with zero partial residue, by construction:
        # nothing of a losing gang ever reaches the cache) and requeues
        # WITH backoff, exactly the classic round's below-quorum semantics
        gang_committed: List[str] = []
        gang_requeued: List[Tuple[Pod, str]] = []
        drop = None
        if handle.gangs:
            acc_mask = np.zeros(n, dtype=bool)
            acc_mask[acc_idx] = True
            drop = np.zeros(n, dtype=bool)
            for gname, idxs, quorum in handle.gangs:
                ia = np.asarray(idxs, dtype=np.int64)
                ok_n = int(acc_mask[ia].sum())
                if ok_n >= quorum:
                    gang_committed.append(gname)
                    continue
                COUNTERS.inc("engine.gang_fence_rollbacks")
                COUNTERS.inc("engine.fence_reason_gang", len(ia))
                drop[ia] = True
                reason = (f"gang {gname}: only {ok_n}/{len(ia)} members "
                          f"placeable past the wave fence (quorum {quorum})")
                gang_requeued.extend((pods[int(i)], reason) for i in ia)
            if drop.any():
                keep = ~drop[acc_idx]
                acc_idx = acc_idx[keep]
                acc_node = acc_node[keep]
                acc_cls = acc_cls[keep]
            else:
                drop = None
        host_rows = set(handle.host_idx.tolist())
        unschedulable = [(pods[i], int(fc[i]))
                         for i in np.nonzero(sel < 0)[0].tolist()
                         if i not in strag and i not in host_rows
                         and (drop is None or not drop[i])]
        bound: List[Pod] = []
        # conflicts + their typed reason codes, parallel: max-waves
        # stragglers are an affinity-routing verdict
        conflicts: List[Pod] = []
        conflict_reasons: List[int] = []
        for i in straggler_idx.tolist():
            if drop is None or not drop[i]:
                conflicts.append(pods[i])
                conflict_reasons.append(podtrace.REASON_AFFINITY)
        for i, code in zip(conflict_idx, conflict_codes):
            if drop is None or not drop[i]:
                conflicts.append(pods[i])
                conflict_reasons.append(code)
        # liveness rejects: the target node died / was cordoned
        # mid-flight — requeue WITH backoff (the caller's contract)
        liveness = [pods[i] for i in liveness_idx
                    if drop is None or not drop[i]]
        if acc_idx.size:
            names = snap.node_names
            groups = []
            acc_l = acc_idx.tolist()
            node_l = acc_node.tolist()
            cls_l = acc_cls.tolist()
            change = np.nonzero((acc_node[1:] != acc_node[:-1])
                                | (acc_cls[1:] != acc_cls[:-1]))[0] + 1
            bounds = [0] + change.tolist() + [len(acc_l)]
            with timed_span("pipeline.assume"):
                for b0, b1 in zip(bounds[:-1], bounds[1:]):
                    name = names[node_l[b0]]
                    run = [pods[i] for i in acc_l[b0:b1]]
                    for p in run:
                        p.node_name = name
                    groups.append((name, run) + enc.derived[cls_l[b0]])
                infos_touched = self.cache.assume_pods_grouped(groups)
                # fold the assumes into the snapshot WITHOUT a node walk:
                # classes with pure base-resource footprints go through
                # the exact raw-delta path; the rest take the normal
                # dirty-note rewrite
                dok = enc.delta_ok[acc_cls]
                dirty_names = {names[i] for i in
                               set(acc_node[~dok].tolist())}
                if dok.any():
                    snap.apply_assume_delta(
                        acc_node[dok], enc.raw_rows[acc_cls[dok]],
                        [(nm, info) for nm, info in
                         infos_touched.items()
                         if nm not in dirty_names],
                        prio_rows=enc.cls_prio[acc_cls[dok]])
                if dirty_names:
                    self._touch(dirty_names)
                blind_names = [nm for nm in infos_touched
                               if nm not in dirty_names]
                for s in self._blind_listeners:
                    s.update(blind_names)
            if enc is self._wave_enc:
                # fold fence-accepted commits into the encoding's
                # cumulative per-node topology occupancy (the host mirror
                # the next dispatch seeds the wave loop from) and into its
                # aff_seq expectation (assume_pods_grouped just bumped
                # cache.aff_seq once per assumed pod). A stale enc skips
                # both: its aff_seq mismatch routes the next dispatch
                # through the patch/rebuild gate.
                if enc.committed_nodes is not None:
                    np.add.at(enc.committed_nodes, (acc_cls, acc_node),
                              1)
                enc.aff_seq += len(acc_l)
            bound = [pods[i] for i in sorted(acc_l)]
        # the exact oracle tail: host_exact rows place AFTER the wave
        # rows' assume, against live NodeInfo truth — the classic round's
        # slow_idx FIFO loop, so each host pod sees every commit this
        # harvest just made (and each other's). Rolled-back gangs'
        # members are excluded (their gang fence already requeued them
        # WITH backoff — zero partial residue holds).
        h_rows = [i for i in sorted(host_rows)
                  if drop is None or not drop[i]]
        if h_rows:
            COUNTERS.inc("engine.wave_host_tail", len(h_rows))
            with timed_span("pipeline.host_tail"):
                host_nodes = self._oracle_tail(pods, h_rows)
            for i, name in zip(h_rows, host_nodes):
                if name is not None:
                    bound.append(pods[i])
                else:
                    unschedulable.append((pods[i], 0))
        if _rec_t0 and RECORDER.enabled:
            RECORDER.record(flightrec.HARVEST, wave=handle.wave_id,
                            t0=_rec_block_end - t_block, dur=t_block,
                            a=len(bound),
                            b=len(conflicts) + len(liveness))
            if conflicts or liveness:
                RECORDER.record(flightrec.FENCE_REQUEUE,
                                wave=handle.wave_id,
                                a=len(conflicts), b=len(liveness))
        if TRACER.enabled:
            t_h = time.monotonic()
            if bound:
                TRACER.batch_event(podtrace.HARVESTED,
                                   [p.key() for p in bound],
                                   a=handle.wave_id, t0=t_h)
            for p, code in zip(conflicts, conflict_reasons):
                TRACER.event(p.key(), podtrace.FENCE_REQUEUED, a=code,
                             b=handle.wave_id, t0=t_h)
            for p in liveness:
                TRACER.event(p.key(), podtrace.FENCE_REQUEUED,
                             a=podtrace.REASON_LIVENESS,
                             b=handle.wave_id, t0=t_h)
            for p, _why in gang_requeued:
                TRACER.event(p.key(), podtrace.FENCE_REQUEUED,
                             a=podtrace.REASON_GANG,
                             b=handle.wave_id, t0=t_h)
        return WaveHarvest(bound, conflicts, unschedulable, t_block,
                           gang_committed=gang_committed,
                           gang_requeued=gang_requeued,
                           liveness_requeued=liveness,
                           conflict_reasons=conflict_reasons)

    def _harvest_tail(self, handle: WaveHandle, tail_idx: np.ndarray,
                      sel: np.ndarray, fc: np.ndarray, counter_h: int
                      ) -> int:
        """Place the harvest's seeded strict tail (rows `tail_idx`) into
        `sel`/`fc` in place: the conflict-round loop for big tails, the
        per-pod scan for small ones (and with tail_rounds off). Returns
        the round-robin counter after the tail."""
        enc = handle.enc
        dev = self.device
        n_tail = len(tail_idx)
        pcs = np.full(bucket(n_tail), enc.num_classes, dtype=np.int32)
        pcs[:n_tail] = handle.pc[tail_idx]
        aff_arrays = None
        aff_init = None
        aff_mode = (False, False, False)
        tail_prios = self._kernel_priorities()
        if enc.adata is not None and (enc.fits_on or enc.prio_on):
            aff_arrays = enc.aff_tail_dev
            # under a mesh the tail runs on the assembled node axis
            # (tail_rounds_loop / gather_place_batch docstrings), so its
            # seed is assembled too
            committed0 = mesh_mod.full(handle.committed_out).to(I32) \
                if handle.committed_out is not None else torch.zeros(
                    (enc.c_pad, int(handle.nodes["alloc"].shape[0])),
                    dtype=I32, device=dev)
            # project the wave's per-node occupancy onto the tail's domain
            # columns: commdom[c, j] = committed @ labels_aff[:, j].
            # int_matmul is exact: each sum counts class-c pods in one
            # domain, at most the pods the cluster holds (nodes x allowed
            # pods: 550,000 at 5,000 x 110) < 2^24
            commdom0 = int_matmul(committed0,
                                  mesh_mod.full(aff_arrays["labels_aff"]).T)
            aff_init = (commdom0, committed0,
                        committed0.sum(dim=1, dtype=I32))
            aff_mode = (enc.fits_on, enc.prio_on, False)
            if enc.prio_on:
                tail_prios = tuple(
                    (nm, w) for nm, w in self.priorities
                    if nm != "SelectorSpreadPriority")
        COUNTERS.inc("engine.wave_tail_dispatch")
        pcs_dev = tensor_from_numpy(pcs, dev)
        ctr = torch.tensor(counter_h, dtype=torch.int64, device=dev)
        if self.tail_rounds and n_tail >= self.tail_rounds_min:
            # conflict-round tail: sequential depth is the round count;
            # required semantics exact at every commit, tie-breaks
            # wave-style (waves.tail_rounds_loop docstring)
            COUNTERS.inc("engine.tail_round_dispatch")
            with timed_span("pipeline.tail"):
                packed_t, _st = waves.tail_rounds_loop(
                    enc.cls_arr, handle.nodes, handle.state_out, pcs_dev,
                    ctr, tail_prios, aff=aff_arrays, aff_mode=aff_mode,
                    aff_init=aff_init,
                    pre=self._tail_wave_pre(enc, handle.nodes))
                packed_th = packed_t.cpu().numpy()
            p_t = len(pcs)
            sel[tail_idx] = packed_th[:n_tail]
            fc[tail_idx] = packed_th[p_t:p_t + n_tail]
            COUNTERS.inc("engine.tail_rounds", int(packed_th[2 * p_t + 1]))
            return int(packed_th[2 * p_t]) & U32_MASK
        # per-pod scan (small tails, and GRAFT_TAIL_ROUNDS=0): classic
        # sequential semantics
        with timed_span("pipeline.tail"):
            sel_s, fc_s, _st, rr_d = gather_place_batch(
                enc.cls_arr, pcs_dev, handle.nodes, handle.state_out, ctr,
                tail_prios, aff=aff_arrays, aff_mode=aff_mode,
                aff_init=aff_init)
            sel[tail_idx] = sel_s.cpu().numpy()[:n_tail]
            fc[tail_idx] = fc_s.cpu().numpy()[:n_tail]
            return int(rr_d)

    def _fence(self, handle: WaveHandle, sel: np.ndarray,
               placed_idx: np.ndarray):
        """Vectorized re-validation of a blind wave's placements against
        current occupancy: exact prefix-capacity + pod-count math, plus the
        TOPOLOGY mirror — required (anti-)affinity placements made against
        the pre-k occupancy re-check against the engine's post-k occupancy
        and requeue conservatively instead of colliding. Returns (accepted
        original indices grouped by (node, class) with FIFO order inside
        each node, their node indices, their class indices, conflict
        original indices in FIFO order, liveness original indices, typed
        podtrace.REASON_* codes parallel to the conflict list)."""
        snap = self.snapshot
        enc = handle.enc
        node_of = sel[placed_idx]
        order = np.argsort(node_of, kind="stable")
        gidx = placed_idx[order]
        gnode = node_of[order]
        m = len(gidx)
        seg_start = np.empty(m, dtype=bool)
        seg_start[0] = True
        seg_start[1:] = gnode[1:] != gnode[:-1]
        starts = np.nonzero(seg_start)[0]
        grp = np.cumsum(seg_start) - 1
        rank = np.arange(m) - starts[grp]
        cls_rows = handle.pc[gidx]
        req = enc.req_rows[cls_rows]                      # [m, R] int64
        csum = np.cumsum(req, axis=0)
        prefix = csum - (csum[starts] - req[starts])[grp]  # incl., per node
        # slice snapshot columns to the ENCODING's resource width: vocab
        # growth between dispatch and harvest appends columns these classes
        # cannot request, so ignoring the suffix is exact
        ncols = enc.req_rows.shape[1]
        alloc = snap.alloc[gnode][:, :ncols].astype(np.int64)
        used = snap.requested[gnode][:, :ncols].astype(np.int64)
        avail = alloc - used
        plain = [c for c in range(ncols) if c not in (R_SCRATCH, R_OVERLAY)]
        ok = (prefix[:, plain] <= avail[:, plain]).all(axis=1)
        # storage fallback (predicates.go:590-604): overlay-less nodes charge
        # overlay requests against scratch
        no_ov = alloc[:, R_OVERLAY] == 0
        scr_pref = prefix[:, R_SCRATCH] + np.where(no_ov,
                                                   prefix[:, R_OVERLAY], 0)
        scr_avail = avail[:, R_SCRATCH] - np.where(no_ov,
                                                   used[:, R_OVERLAY], 0)
        ok &= scr_pref <= scr_avail
        ok &= no_ov | (prefix[:, R_OVERLAY] <= avail[:, R_OVERLAY])
        ok &= (snap.pod_count[gnode].astype(np.int64) + rank + 1
               <= snap.allowed_pods[gnode])
        spc = enc.special[cls_rows]
        if spc.any() and handle.blind:
            # ports/volume predicates are per-object host state: a touched
            # node in the blind window requeues these classes
            # conservatively
            bl = np.zeros(snap.valid.shape[0], dtype=bool)
            idx_map = snap.node_index
            for nm in handle.blind:
                i = idx_map.get(nm, -1)
                if i >= 0:
                    bl[i] = True
            ok &= ~(spc & bl[gnode])
        # typed requeue attribution: one reason code per rejected row,
        # first-cause ordering (capacity first, affinity only re-colors
        # rows capacity passed)
        reason = np.full(m, -1, dtype=np.int8)
        reason[~ok] = podtrace.REASON_CAPACITY
        if enc.fits_on and enc.adata is not None:
            aff_out = self._fence_affinity(enc, cls_rows, gnode)
            if aff_out is not None:
                aff_bad, aff_stale = aff_out
                n_rej = int((aff_bad & ok).sum())
                if n_rej:
                    COUNTERS.inc("engine.affinity_fence_requeues", n_rej)
                reason[aff_bad & (reason < 0)] = \
                    podtrace.REASON_STALE if aff_stale \
                    else podtrace.REASON_AFFINITY
                ok &= ~aff_bad
        # host-check re-validation: the host_fit column baked label
        # CONTENT at build; a relabel landing while this wave was in
        # flight makes the column stale — conservative requeue of every
        # host_static row (the re-dispatch rebuilds the encoding against
        # fresh truth: the has_static_cols invalidation guarantees it)
        hs_bad = enc.host_static[cls_rows]
        if hs_bad.any() and snap.labels_gen != enc.labels_gen:
            n_h = int((hs_bad & ok).sum())
            if n_h:
                COUNTERS.inc("engine.hostcheck_fence_requeues", n_h)
            reason[hs_bad & (reason < 0)] = podtrace.REASON_HOSTCHECK
            ok &= ~hs_bad
        if enc.policy_on and self.policy_algos is not None \
                and self.policy_algos.active:
            # Policy re-validation: the frozen policy_fit column was exact
            # against the build-time workload set and pod locations;
            # re-check the EXACT oracle predicate against live truth for
            # every surviving row, in order — ServiceAffinity moves with
            # every commit, and this fence is what lets Policy chunks ride
            # blind without ghost-binding on stale state
            cand = np.nonzero(ok)[0]
            if cand.size:
                infos_f = self.cache.node_infos()
                ctx = self._context(infos_f)
                names_f = snap.node_names
                p_bad = np.zeros(m, dtype=bool)
                for r in cand.tolist():
                    info = infos_f.get(names_f[int(gnode[r])])
                    node = info.node if info is not None else None
                    if node is None or not self.policy_algos.oracle_fit(
                            handle.pods[int(gidx[r])], node, ctx):
                        p_bad[r] = True
                if p_bad.any():
                    COUNTERS.inc("engine.policy_fence_requeues",
                                 int(p_bad.sum()))
                    reason[p_bad & (reason < 0)] = podtrace.REASON_POLICY
                    ok &= ~p_bad
        # liveness re-validation: a row targeting a node the owner
        # declared dying (the doomed set) or one the refreshed snapshot
        # already rules out must not bind into a ghost; these rows requeue
        # WITH backoff, separately from capacity conflicts
        live_bad = ~(snap.schedulable[gnode] & snap.valid[gnode])
        if self._doomed_nodes:
            idx_map = snap.node_index
            dm = [idx_map[nm] for nm in self._doomed_nodes if nm in idx_map]
            if dm:
                live_bad |= np.isin(gnode, np.asarray(dm))
        if live_bad.any():
            COUNTERS.inc("engine.liveness_fence_requeues",
                         int(live_bad.sum()))
            COUNTERS.inc("engine.fence_reason_liveness",
                         int(live_bad.sum()))
            ok &= ~live_bad
        conflict_mask = ~ok & ~live_bad
        for code in (podtrace.REASON_CAPACITY, podtrace.REASON_AFFINITY,
                     podtrace.REASON_STALE, podtrace.REASON_HOSTCHECK,
                     podtrace.REASON_POLICY):
            n_r = int(((reason == code) & conflict_mask).sum())
            if n_r:
                COUNTERS.inc("engine.fence_reason_"
                             + podtrace.REASON_NAMES[code], n_r)
        conf_pairs = sorted(zip(gidx[conflict_mask].tolist(),
                                reason[conflict_mask].tolist()))
        return (gidx[ok], gnode[ok], cls_rows[ok],
                [i for i, _r in conf_pairs],
                sorted(gidx[live_bad].tolist()),
                [int(r) for _i, r in conf_pairs])

    def _fence_affinity(self, enc: "_WaveEncoding", cls_rows: np.ndarray,
                        gnode: np.ndarray) -> Optional[tuple]:
        """Topology half of the fence: re-evaluate required (anti-)affinity
        for the wave's placements against the engine's CURRENT cumulative
        occupancy (every prior harvest folded). Mirrors the wave mask
        (waves._wave_aff_mask) plus the allow side for strict-tail classes;
        in-harvest interactions need no re-check — they ran inside one
        wave loop against a shared carry. Returns a (bool [m] "must
        requeue" mask, stale flag) pair, or None when no placement is
        affinity-relevant. A STALE encoding (foreign affinity churn since
        dispatch) conservatively requeues every relevant placement."""
        ad = enc.adata
        rel = ad.wave_relevant[cls_rows]
        if not rel.any():
            return None
        if enc is not self._wave_enc or enc.aff_seq != self.cache.aff_seq \
                or enc.labels_gen != self.snapshot.labels_gen:
            return rel.copy(), True
        snap = self.snapshot
        cn = enc.committed_nodes.astype(np.float64)           # [C, N]
        C_, A_ = ad.m_anti.shape[:2]
        m2 = ad.m_anti.reshape(C_ * A_, C_).astype(np.float64)
        kn = enc.key_node.reshape(C_ * A_, -1)                # [C*A, N]
        # anti side, per-node form (float64 products — exact for these
        # counts)
        occ = (m2 @ cn).reshape(C_, A_, -1)
        own_forb = (occ * enc.key_node).sum(axis=1)           # [C, N]
        sym = (m2.T @ (kn * np.repeat(cn, A_, axis=0)))       # [C, N]
        forb = own_forb + sym + enc.static_forbid_hit
        if enc.foreign_forbid is not None:
            forb = forb + enc.foreign_forbid
        aff_bad = forb[cls_rows, gnode] > 0
        cols = enc.tail_cols
        lab_p = cd = None
        if cols is not None and cols.size:
            lab_p = snap.labels[:, cols].astype(np.float64)   # [N, Lp]
            cd = cn @ lab_p                                   # [C, Lp]
            # anti + symmetry over the PROJECTED DOMAIN columns: a
            # strict-tail class's zone-scoped term forbids the whole
            # DOMAIN, and a blind placement can land on a DIFFERENT node
            # of a domain another chunk's harvest just occupied
            m3 = ad.m_anti.astype(np.float64)
            kp = ad.anti_keymask[:, :, cols].astype(np.float64)
            occ_dom = np.einsum("cad,dl->cal", m3, cd)
            own_dom = (occ_dom * kp).sum(axis=1)              # [C, Lp]
            sym_dom = np.einsum("dac,dal->cl", m3,
                                kp * cd[:, None, :])          # [C, Lp]
            dom = own_dom + sym_dom
            if enc.foreign_forbid_dom is not None:
                dom = dom + enc.foreign_forbid_dom
            aff_bad |= np.einsum("ml,ml->m", dom[cls_rows],
                                 lab_p[gnode]) > 0
        own = ad.aff_active.any(axis=1)
        own_rows = np.nonzero(own[cls_rows])[0]
        if own_rows.size and lab_p is not None:
            # allow side (strict-tail classes only), over the projected
            # domain columns: the one true hazard is two chunks
            # bootstrapping the same group into different domains
            c_r = cls_rows[own_rows]
            lab_r = lab_p[gnode[own_rows]]
            m_aff = ad.m_aff.astype(np.float64)
            occp = (np.einsum("csd,dl->csl", m_aff, cd)
                    * ad.aff_keymask[:, :, cols])
            dyn = np.einsum("msl,ml->ms", occp[c_r], lab_r) > 0
            stat = np.einsum(
                "msl,ml->ms",
                ad.aff_allow[c_r][:, :, cols].astype(np.float64), lab_r) > 0
            dyn_total = np.einsum("csd,d->cs", m_aff, cn.sum(axis=1))
            boot = ad.aff_self & ~ad.aff_has_static & (dyn_total == 0)
            ok_terms = (~ad.aff_active[c_r]) | stat | dyn | boot[c_r]
            aff_bad[own_rows] |= ~ok_terms.all(axis=1)
        return aff_bad & rel, False
