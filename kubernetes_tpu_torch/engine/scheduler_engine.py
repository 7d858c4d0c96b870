"""Host-side scheduling engine: snapshot -> device batch -> assume.

PyTorch port of kubernetes_tpu/engine/scheduler_engine.py, on one device
(the card unless the caller names another):

- the synchronous path, ``SchedulingEngine.schedule`` (modes ``wave`` and
  ``strict``), and the extender verdict ``evaluate_pod`` on its uncached
  path;
- the pipelined drain, ``dispatch_waves`` / ``harvest_waves``: dispatch
  encodes a chunk (vocab_gen-keyed encoding reuse), hands the wave loop to
  the engine's worker thread WITHOUT waiting for it and returns a
  WaveHandle; harvest joins the job, re-validates the blind wave's
  placements against current occupancy (the capacity fence and its
  topology mirror, the liveness fence), finishes strict-tail pods via the
  conflict-round loop (waves.tail_rounds_loop) or the per-pod scan,
  assumes the survivors columnar and hands conflicts back for requeue.

The reference overlaps device and host through JAX's asynchronous
dispatch. Here the wave loop (one host check per wave) runs on a worker
thread of the engine, on its own CUDA stream ordered after the dispatch's
uploads by an event; jobs run one at a time in dispatch order, so the
round-robin counter a job chains from is final when it reads it. The job
ends with the wave's one device->host copy, so a harvest never queues
behind the next wave's work. Every host buffer a job reads is uploaded as
a copy (convert.tensor_from_numpy), since the harvest folds commits into
them in place while a later wave may still run.

What later slices of the port bring raises NotImplementedError naming the
slice, so nothing is ever scheduled silently by a path that is not there:
classes routed to the exact host oracle (needs_host_check, affinity slot
overflow; ROADMAP §1.2), gangs on the wave path (§1.4), and live
inter-pod affinity on the synchronous ``schedule`` path (§1.2, the
reference's ``_run_wave``).
"""

from __future__ import annotations

import dataclasses as _dc
import functools
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch import resolve_device
from kubernetes_tpu_torch.api.types import Pod
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
from kubernetes_tpu_torch.ops import predicates as preds
from kubernetes_tpu_torch.ops import priorities as prio
from kubernetes_tpu_torch.ops.oracle_ext import _own_terms, term_matches_pod
from kubernetes_tpu_torch.ops.predicates import bucket, int_matmul
from kubernetes_tpu_torch.state.cache import SchedulerCache
from kubernetes_tpu_torch.state.classes import ClassBatch, pod_class_key
from kubernetes_tpu_torch.state.snapshot import (
    R_OVERLAY,
    R_SCRATCH,
    ClusterSnapshot,
)
from kubernetes_tpu_torch.state.volumes import VolumeContext
from kubernetes_tpu_torch.utils.trace import COUNTERS, timed_span

HOST_ORACLE_SLICE = ("the host-oracle routes (ops/oracle*, policy_algos), "
                     "ROADMAP §1.2 of the port")
SYNC_AFFINITY_SLICE = ("inter-pod affinity and selector spreading on the "
                       "synchronous schedule() path (the reference's "
                       "_run_wave), ROADMAP §1.2 of the port; the pipelined "
                       "drain (dispatch_waves) takes them")
GANG_SLICE = ("gangs on the wave path (engine/gang.py through "
              "dispatch_waves), ROADMAP §1.4 of the port")
# hardPodAffinitySymmetricWeight, the reference's default
HARD_POD_AFFINITY_WEIGHT = 1
I32 = torch.int32


class RoundRobin:
    """selectHost's lastNodeIndex counter (generic_scheduler.go:144-160),
    as the reference's ops/oracle.RoundRobin: ties among max-score nodes
    are broken round-robin in ascending node-index order."""

    def __init__(self):
        self.counter = 0


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
        dev = labels.device
        pre = aff_ops.precompute_static(aff, labels)
        c_dim = aff["m_aff"].shape[0]
        commdom0 = torch.zeros((c_dim, labels.shape[1]), dtype=torch.int32,
                               device=dev)
        committed0 = torch.zeros((c_dim, labels.shape[0]),
                                 dtype=torch.int32, device=dev)
        comm_cnt0 = torch.zeros(c_dim, dtype=torch.int32, device=dev)
        if fits_on:
            m = m & aff_ops.step_fits(aff, pre, 0, commdom0, comm_cnt0,
                                      labels)
        if prio_on:
            cnt = aff_ops.step_prio_counts(aff, pre, 0, commdom0, labels)
            s = s + w_ip * aff_ops.interpod_score(cnt, m)
        if spread_on:
            cnt = aff_ops.step_spread_counts(aff, 0, committed0)
            s = s + w_sp * aff_ops.spread_score(aff, aff["sp_has"][0], cnt,
                                                m)
    return m, s


def evaluate_pod(pod: Pod, infos, snap: ClusterSnapshot,
                 priorities: Tuple[Tuple[str, int], ...],
                 workloads: Sequence = (),
                 device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Per-node (fits [N] bool, scores [N] int32) for ONE pod against the
    cluster state — the extender's /filter + /prioritize evaluation
    (core/extender.go:100 Filter, :157 Prioritize). No state is committed:
    the affinity/spread functions run with zero occupancy. `snap` must
    already be refreshed against `infos`. ``device=None`` is the card.
    Pods that need the exact host oracle raise NotImplementedError (a
    later slice)."""
    dev = resolve_device(device)
    with timed_span("extender.encode"):
        all_pairs, aff_pairs = aff_ops.collect_pod_pairs(infos)
        aff_ops.intern_topology_pairs(snap, [pod], aff_pairs)
        batch = ClassBatch([pod], snap)
        adata = aff_ops.AffinityData(batch.reps, snap, all_pairs, aff_pairs,
                                     list(workloads),
                                     HARD_POD_AFFINITY_WEIGHT)
    if batch.reps_batch.needs_host_check[0] or adata.overflow[0]:
        raise NotImplementedError(
            f"this pod needs the exact host oracle: {HOST_ORACLE_SLICE}")
    aff_mode, weights = _aff_mode(adata, priorities)
    plain = tuple((nm, w) for nm, w in priorities
                  if nm not in prio.AFFINITY_PRIORITIES)
    with timed_span("extender.upload"):
        parr = preds.pod_arrays_bucketed(batch.reps_batch, dev)
        narr = preds.node_arrays(snap, dev)
        aff = adata.device_arrays(dev) if any(aff_mode) else None
    with timed_span("extender.kernel"):
        m, s = _fused_eval(parr, narr, aff, plain, weights, aff_mode)
        m = m.cpu().numpy()
        s = s.cpu().numpy()
    m[len(snap.node_names):] = False
    return m, s


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


def _aff_tail_arrays(adata, snap, cols: np.ndarray, device):
    """AffinityData tensors with every domain axis sliced to the tail's
    column projection, plus the matching `labels_aff` [N, Lp] node
    incidence the tail contracts against (place_batch and
    tail_rounds_loop swap it in for nodes["labels"] on the affinity side
    only). Uploaded once per encoding, as copies."""
    out = {}
    for k in aff_ops.AffinityData._DEVICE_KEYS:
        a = getattr(adata, k)
        if k in _AFF_SLICE3:
            a = a[:, :, cols]
        elif k in _AFF_SLICE2:
            a = a[:, cols]
        out[k] = tensor_from_numpy(a, device)
    out["labels_aff"] = tensor_from_numpy(snap.labels[:, cols], device)
    return out


class _WaveEncoding:
    """Device-resident class encoding reused across pipelined drain chunks
    (a copy of the reference's, minus the host-check and Policy columns,
    which the port refuses).

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
                 "host_exact", "spread_on", "wkey")

    def __init__(self, vocab_gen, key_index, reps, cls_arr, num_classes,
                 c_pad, req_rows, special, derived, ports_max,
                 adata=None, fits_on=False, prio_on=False,
                 aff_seq=0, aff_wave_dev=None,
                 aff_tail_dev=None, key_node=None, static_forbid_hit=None,
                 tail_cols=None, n_pad=0, labels_gen=0,
                 host_exact=None, spread_on=False, wkey=()):
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
        # classes for the exact host oracle (needs_host_check, affinity
        # slot overflow): dispatch refuses a chunk carrying one
        self.host_exact = host_exact if host_exact is not None \
            else np.zeros(c_pad, dtype=bool)
        self.spread_on = spread_on    # SelectorSpread riding frozen score
        # workload-set identity at build (the scheduler replaces workload
        # objects on watch events, so `is`-comparison detects any change)
        self.wkey = wkey
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
                 "dispatch_ts", "pad_floor", "strict_idx", "wave_id",
                 "packed_h", "state_out", "committed_out", "counter_out")

    def __init__(self, pods, pc, enc, job, nodes, blind, pop_ts,
                 dispatch_ts, pad_floor=0, strict_idx=None, wave_id=-1):
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
        # flight-recorder wave id: joins this wave's dispatch / harvest /
        # bind-flush events; -1 when the recorder was off at dispatch
        self.wave_id = wave_id
        # filled by block(): the packed host result [3P+2] int32, the
        # final node state, the [C, N] occupancy (affinity waves) and the
        # int64 round-robin counter, all from the job
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
    with the blind wave, not unschedulability), unschedulable pods, and
    the rows whose target node died mid-flight (requeue WITH backoff)."""

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
              priorities, extra, aff, committed_dev, act_dev, pre, p_pad):
    """The worker's body for one dispatched wave: the wave loop, then its
    one device->host copy. `counter_src` is the previous wave's job (its
    counter is final: jobs run in order) or None (start from counter0)."""
    dev = pc_dev.device
    if counter_src is not None:
        counter = counter_src.result()[3]
    else:
        counter = torch.tensor(counter0 & U32_MASK, dtype=torch.int64,
                               device=dev)
    out = waves.waves_loop(cls_arr, nodes, state, pc_dev, counter,
                           priorities, 64, extra_score=extra, aff=aff,
                           committed0=committed_dev, active0=act_dev,
                           pre=pre)
    packed, state_out = out[0], out[1]
    committed_out = out[2] if aff is not None else None
    counter_out = packed[3 * p_pad].to(torch.int64) & U32_MASK
    return packed.cpu().numpy(), state_out, committed_out, counter_out


# ---------------------------------------------------------------------------
# the batch engine
# ---------------------------------------------------------------------------


class SchedulingEngine:
    """Batch scheduling over a SchedulerCache on one device."""

    def __init__(self, cache: SchedulerCache,
                 priorities: Tuple[Tuple[str, int], ...] =
                 prio.DEFAULT_PRIORITIES, device=None,
                 workloads_provider=None):
        self.device = resolve_device(device)
        self.cache = cache
        self.priorities = priorities
        self.snapshot = ClusterSnapshot()
        # PV/PVC mirror (the pvInfo/pvcInfo listers of factory.go); the
        # owner (Scheduler) mutates it and bumps .version on watch events
        self.volume_ctx = VolumeContext()
        self.rr = RoundRobin()  # shared counter (uint32 on the device)
        # Service/RC/RS/SS objects for spreading — the factory's extra
        # informers (factory.go:120-140)
        self.workloads_provider = workloads_provider or (lambda: [])
        self.hard_pod_affinity_weight = HARD_POD_AFFINITY_WEIGHT
        self._device_nodes: Dict[str, torch.Tensor] = {}
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
        the cache with pod.node_name set.

        mode="strict" reproduces the reference's sequential scheduleOne;
        mode="wave" is the wave-parallel throughput mode (engine/waves.py).
        """
        if mode not in ("strict", "wave"):
            raise ValueError(f"unknown mode {mode!r}")
        if not pods:
            return []
        with timed_span("engine.refresh"):
            infos = self._refresh()
        with timed_span("engine.encode"):
            batch, c_pad = self._encode(pods, infos)
        kernel_priorities = self._kernel_priorities()
        with timed_span("engine.upload"):
            nodes = self._nodes_on_device(port_words=self._port_words(batch))
            cls_arr = preds.pod_arrays_padded(batch.reps_batch, c_pad,
                                              self.device)
        pf = len(pods)
        pc_fast = np.full(bucket(pf), batch.num_classes, dtype=np.int32)
        pc_fast[:pf] = batch.pod_class
        state = NodeState(nodes["requested"], nodes["nonzero"],
                          nodes["pod_count"], nodes["port_bitmap"],
                          nodes["vol_present"], nodes["vol_rw"],
                          nodes["pd_present"], nodes["pd_counts"])
        with timed_span("engine.place"):
            if mode == "wave":
                stats: Dict[str, int] = {}
                selected, fit_counts, _, rr_end = waves.place_waves(
                    cls_arr, nodes, state, pc_fast, self.rr.counter,
                    kernel_priorities, stats=stats)
                self.last_wave_stats = stats
            else:
                sel_d, fc_d, _, rr_d = gather_place_batch(
                    cls_arr, torch.from_numpy(pc_fast).to(self.device),
                    nodes, state,
                    torch.tensor(self.rr.counter & U32_MASK,
                                 dtype=torch.int64, device=self.device),
                    kernel_priorities)
                selected = sel_d.cpu().numpy()
                fit_counts = fc_d.cpu().numpy()
                rr_end = int(rr_d)
        self.rr.counter = int(rr_end)
        with timed_span("engine.assume"):
            return self._results(pods, batch, pc_fast, selected, fit_counts,
                                 assume)

    def _encode(self, pods: Sequence[Pod], infos) -> Tuple[ClassBatch, int]:
        """Equivalence classes of the batch (class axis padded to c_pad),
        refusing what later slices bring."""
        all_pairs, aff_pairs = aff_ops.collect_pod_pairs(infos)
        # topology keys referenced by ANY affinity term must be in the label
        # vocab before the label matrix is finalized (ClassBatch next)
        aff_ops.intern_topology_pairs(self.snapshot, pods, aff_pairs)
        batch = ClassBatch(pods, self.snapshot)
        c_pad = bucket(batch.num_classes + 1)
        adata = aff_ops.AffinityData(batch.reps, self.snapshot, all_pairs,
                                     aff_pairs, self.workloads_provider(),
                                     self.hard_pod_affinity_weight,
                                     c_pad=c_pad)
        nc = batch.num_classes
        if batch.reps_batch.needs_host_check[:nc].any() \
                or adata.overflow[:nc].any():
            raise NotImplementedError(
                f"batch has classes for the exact host oracle: "
                f"{HOST_ORACLE_SLICE}")
        aff_mode, _ = _aff_mode(adata, self.priorities)
        if any(aff_mode) or adata.serialize[:nc].any():
            raise NotImplementedError(f"batch needs {SYNC_AFFINITY_SLICE}")
        return batch, c_pad

    def _port_words(self, batch: ClassBatch) -> int:
        """Port-bitmap words to ship: the highest word any node uses or any
        batch pod requests, power-of-2 bucketed."""
        max_words = self.snapshot.port_words_used()
        if np.any(batch.reps_batch.ports >= 0):
            max_words = max(max_words,
                            int(batch.reps_batch.ports.max()) // 32 + 1)
        return bucket(max(max_words, 1), lo=1)

    def _results(self, pods, batch, pc_fast, selected, fit_counts,
                 assume: bool) -> List[PlacementResult]:
        """Placement results in input order; assumes the placed pods into
        the cache (one bulk call) when `assume`."""
        names = self.snapshot.node_names
        results: List[PlacementResult] = []
        placements = []
        pf = len(pods)
        sel_l = selected[:pf].tolist()
        fc_l = fit_counts[:pf].tolist()
        pc_l = pc_fast.tolist()
        for i, pod in enumerate(pods):
            sel = sel_l[i]
            if sel >= 0:
                name = names[sel]
                results.append(PlacementResult(pod, name, fc_l[i]))
                if assume:
                    pod.node_name = name
                    placements.append((pod, pc_l[i]))
            else:
                results.append(PlacementResult(pod, None, fc_l[i]))
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
        return results

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
        COPY (tensor_from_numpy): the snapshot mutates these buffers in
        place between batches (refresh deltas, apply_assume_delta) while a
        pipelined wave may still read the tensors, so a tensor must never
        alias one."""
        snap = self.snapshot
        uploaded = 0
        for k in preds._NODE_ARRAY_KEYS:
            host = snap.port_bitmap[:, :port_words] if k == "port_bitmap" \
                else getattr(snap, k)
            cur = self._device_nodes.get(k)
            if cur is None or tuple(cur.shape) != host.shape \
                    or k in snap.dirty:
                self._device_nodes[k] = tensor_from_numpy(host, self.device)
                uploaded += 1
        if uploaded:
            COUNTERS.inc("engine.device_upload_arrays", uploaded)
        snap.dirty.clear()
        return self._device_nodes

    # ------------------------------------------------- pipelined drain

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
            enc.aff_tail_dev["labels_aff"] = tensor_from_numpy(
                snap.labels[:, enc.tail_cols], self.device)
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
            enc.aff_wave_dev["static_forbid"] = tensor_from_numpy(
                np.minimum(merged, 127).astype(np.int8), self.device)
            enc.aff_wave_dev["key_node"] = tensor_from_numpy(
                enc.key_node, self.device)
        if enc.aff_tail_dev is not None and enc.tail_cols is not None:
            base = enc.adata.forbid_static[:, enc.tail_cols].astype(np.int32)
            if enc.foreign_forbid_dom is not None:
                base = base + enc.foreign_forbid_dom
            enc.aff_tail_dev["forbid_static"] = tensor_from_numpy(
                np.minimum(base, 127).astype(np.int8), self.device)
        enc.aff_patch_dirty = False

    def _wave_encoding(self, pods: Sequence[Pod], infos):
        """(encoding, pod_class[n]) for a pipeline chunk, via the
        (vocab_gen, aff_seq, workload-identity)-keyed reuse cache.
        Affinity classes the topology counters express run per wave on
        the device; the rest of the required-affinity shapes ride as
        inactive rows and place at the harvest's strict tail. Classes for
        the exact host oracle are marked host_exact (dispatch refuses
        them)."""
        snap = self.snapshot
        enc = self._wave_enc
        w_ip = sum(w for nm, w in self.priorities
                   if nm == "InterPodAffinityPriority")
        w_sp = sum(w for nm, w in self.priorities
                   if nm == "SelectorSpreadPriority")
        # workloads are placement-relevant only through a live
        # SelectorSpread weight; otherwise their churn can never change a
        # placement and the encoding ignores them entirely
        workloads_now = tuple(self.workloads_provider()) if w_sp else ()
        fresh = enc is not None and enc.vocab_gen == snap.vocab_gen
        if fresh and w_sp:
            wk = enc.wkey
            if len(wk) != len(workloads_now) or not all(
                    a is b for a, b in zip(wk, workloads_now)):
                # workload set moved: the frozen spread arrays are stale
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
        if build_adata:
            all_pairs, aff_pairs = aff_ops.collect_pod_pairs(infos)
            # topology keys referenced by ANY affinity term must be
            # interned BEFORE the label matrix finalizes
            aff_ops.intern_topology_pairs(snap, seed + list(pods), aff_pairs)
        batch = ClassBatch(seed + list(pods), snap)
        n_cls = batch.num_classes
        rb = batch.reps_batch
        c_pad = bucket(n_cls + 1)
        host_exact = np.zeros(c_pad, dtype=bool)
        host_exact[:n_cls] = rb.needs_host_check[:n_cls]
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
                aff_wave_dev = {
                    "m_anti": tensor_from_numpy(adata.m_anti, self.device),
                    "key_node": tensor_from_numpy(key_node, self.device),
                    "static_forbid": tensor_from_numpy(static_forbid_hit,
                                                       self.device),
                    "wave_gate": tensor_from_numpy(adata.wave_gate,
                                                   self.device),
                }
            if fits_on or prio_on or spread_on:
                tail_cols = _aff_tail_cols(adata, prio_on)
                aff_tail_dev = _aff_tail_arrays(adata, snap, tail_cols,
                                                self.device)
        COUNTERS.inc("engine.wave_encode_build")
        cls_arr = preds.pod_arrays_padded(rb, c_pad, self.device)
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
            spread_on=spread_on, wkey=workloads_now)
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
        them via the seeded strict tail. Chunks with classes for the exact
        host oracle, and gangs, raise NotImplementedError (later slices
        of the port)."""
        if gangs:
            raise NotImplementedError(GANG_SLICE)
        if not pods:
            return None
        _rec_t0 = time.monotonic() if RECORDER.enabled else 0.0
        with timed_span("pipeline.dispatch"):
            infos = self._refresh()
            enc, pc = self._wave_encoding(pods, infos)
            if enc.host_exact[pc].any():
                raise NotImplementedError(
                    f"chunk has classes for the exact host oracle: "
                    f"{HOST_ORACLE_SLICE}")
            if enc.adata is not None:
                # patched topology views re-upload once per dispatch,
                # however many churn events were absorbed since the last
                self._flush_aff_patches(enc)
            dev = self.device
            n = len(pods)
            p_pad = bucket(max(n, self.wave_pad_floor or 1))
            pc_pad = np.full(p_pad, enc.num_classes, dtype=np.int32)
            pc_pad[:n] = pc
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
                ser = enc.wave_strict[pc]
                strict_idx = np.nonzero(ser)[0]
                act = np.zeros(p_pad, dtype=bool)
                act[:n] = ~ser
                act_dev = tensor_from_numpy(act, dev)
                # committed_nodes uploads as a COPY: the harvest folds
                # commits into it in place (np.add.at) while this wave's
                # job may still read the tensor
                committed_dev = tensor_from_numpy(enc.committed_nodes, dev)
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
                committed_dev, act_dev, pre, p_pad))
            self._rr_chain = job
            blind: set = set()
            self._blind_listeners.append(blind)
            COUNTERS.inc("engine.wave_dispatch")
            # admitted-pod count per dispatch: wave_dispatch_pods /
            # wave_dispatch is the realized wave size
            COUNTERS.inc("engine.wave_dispatch_pods", n)
            wave_id = -1
            if RECORDER.enabled or TRACER.enabled:
                wave_id = RECORDER.next_wave()
            if _rec_t0 and RECORDER.enabled:
                RECORDER.record(flightrec.DISPATCH, wave=wave_id,
                                t0=_rec_t0,
                                dur=time.monotonic() - _rec_t0, a=n, b=0)
            if TRACER.enabled:
                TRACER.batch_event(podtrace.WAVE_DISPATCHED,
                                   [p.key() for p in pods], a=wave_id)
            return WaveHandle(list(pods), pc, enc, job, nodes, blind,
                              pop_ts, time.monotonic(), self.wave_pad_floor,
                              strict_idx=strict_idx, wave_id=wave_id)

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
        sel = packed_h[:n].copy()
        fc = packed_h[p_pad:p_pad + n].copy()
        act = packed_h[2 * p_pad:2 * p_pad + n].astype(bool)
        counter_h = int(packed_h[3 * p_pad]) & U32_MASK
        tail_idx = np.nonzero(act)[0]
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
        unschedulable = [(pods[i], int(fc[i]))
                         for i in np.nonzero(sel < 0)[0].tolist()
                         if i not in strag]
        bound: List[Pod] = []
        # conflicts + their typed reason codes, parallel: max-waves
        # stragglers are an affinity-routing verdict
        conflicts: List[Pod] = []
        conflict_reasons: List[int] = []
        for i in straggler_idx.tolist():
            conflicts.append(pods[i])
            conflict_reasons.append(podtrace.REASON_AFFINITY)
        for i, code in zip(conflict_idx, conflict_codes):
            conflicts.append(pods[i])
            conflict_reasons.append(code)
        # liveness rejects: the target node died / was cordoned
        # mid-flight — requeue WITH backoff (the caller's contract)
        liveness = [pods[i] for i in liveness_idx]
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
        return WaveHarvest(bound, conflicts, unschedulable, t_block,
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
            committed0 = handle.committed_out.to(I32) \
                if handle.committed_out is not None else torch.zeros(
                    (enc.c_pad, int(handle.nodes["alloc"].shape[0])),
                    dtype=I32, device=dev)
            # project the wave's per-node occupancy onto the tail's domain
            # columns: commdom[c, j] = committed @ labels_aff[:, j].
            # int_matmul is exact: each sum counts class-c pods in one
            # domain, at most the pods the cluster holds (nodes x allowed
            # pods: 550,000 at 5,000 x 110) < 2^24
            commdom0 = int_matmul(committed0, aff_arrays["labels_aff"].T)
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
                     podtrace.REASON_STALE):
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
