"""Host-side scheduling engine: snapshot -> device batch -> assume.

PyTorch port of the synchronous half of
kubernetes_tpu/engine/scheduler_engine.py: ``SchedulingEngine.schedule``
(modes ``wave`` and ``strict``) and the extender verdict ``evaluate_pod``
on its uncached path. Both run on the card unless the caller names another
device.

  1. delta-refresh the tensor snapshot from the SchedulerCache;
  2. encode pending pods into equivalence classes and upload only the node
     arrays the snapshot marked dirty (always as copies);
  3. place the batch on the device (engine/waves.place_waves or the strict
     loop engine/batch.gather_place_batch) and assume every placement into
     the cache.

What later slices of the port bring raises NotImplementedError naming the
slice, so nothing is ever scheduled silently by a path that is not there:
classes routed to the exact host oracle (needs_host_check, affinity slot
overflow) and classes with live inter-pod affinity or selector spreading
on the engine path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch import resolve_device
from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.convert import tensor_from_numpy
from kubernetes_tpu_torch.engine import waves
from kubernetes_tpu_torch.engine.batch import NodeState, gather_place_batch
from kubernetes_tpu_torch.ops import affinity as aff_ops
from kubernetes_tpu_torch.ops import predicates as preds
from kubernetes_tpu_torch.ops import priorities as prio
from kubernetes_tpu_torch.ops.predicates import bucket
from kubernetes_tpu_torch.state.cache import SchedulerCache
from kubernetes_tpu_torch.state.classes import ClassBatch
from kubernetes_tpu_torch.state.snapshot import ClusterSnapshot
from kubernetes_tpu_torch.utils.trace import COUNTERS, timed_span

HOST_ORACLE_SLICE = ("the host-oracle routes (ops/oracle*, policy_algos), "
                     "a later slice of the port")
# hardPodAffinitySymmetricWeight, the reference's default (the engine of
# this slice refuses live affinity, so no caller needs another value yet)
HARD_POD_AFFINITY_WEIGHT = 1
AFFINITY_SLICE = ("inter-pod affinity and selector spreading on the engine "
                  "path (the pipelined-drain slice of the port)")


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
# the batch engine
# ---------------------------------------------------------------------------


class SchedulingEngine:
    """Batch scheduling over a SchedulerCache on one device."""

    def __init__(self, cache: SchedulerCache,
                 priorities: Tuple[Tuple[str, int], ...] =
                 prio.DEFAULT_PRIORITIES, device=None):
        self.device = resolve_device(device)
        self.cache = cache
        self.priorities = priorities
        self.snapshot = ClusterSnapshot()
        self.rr = RoundRobin()  # shared counter (uint32 on the device)
        self._device_nodes: Dict[str, torch.Tensor] = {}
        # wave count and strict-finish count of the last wave-mode batch
        self.last_wave_stats: Dict[str, int] = {}

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
        kernel_priorities = tuple((nm, w) for nm, w in self.priorities
                                  if nm not in prio.AFFINITY_PRIORITIES)
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
                    torch.tensor(self.rr.counter & 0xFFFFFFFF,
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
                                     aff_pairs, (), HARD_POD_AFFINITY_WEIGHT,
                                     c_pad=c_pad)
        nc = batch.num_classes
        if batch.reps_batch.needs_host_check[:nc].any() \
                or adata.overflow[:nc].any():
            raise NotImplementedError(
                f"batch has classes for the exact host oracle: "
                f"{HOST_ORACLE_SLICE}")
        aff_mode, _ = _aff_mode(adata, self.priorities)
        if any(aff_mode) or adata.serialize[:nc].any():
            raise NotImplementedError(f"batch needs {AFFINITY_SLICE}")
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
        return results

    # ------------------------------------------------------------- internals

    def _refresh(self) -> Dict[str, object]:
        """Full snapshot refresh against the cache. Returns the infos."""
        infos = self.cache.node_infos()
        self.snapshot.refresh(infos)
        return infos

    def _nodes_on_device(self, port_words: int = 1) -> Dict[str, torch.Tensor]:
        """Incremental host->device sync: re-upload an array only when its
        shape changed or the snapshot marked it dirty. Every upload is a
        COPY (tensor_from_numpy): the snapshot mutates these buffers in
        place between batches, so a tensor must never alias one."""
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
