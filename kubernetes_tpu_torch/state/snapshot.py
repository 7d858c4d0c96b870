"""Tensorization: NodeInfo cache -> dense device arrays; pending pods -> batch tensors.

This is the layer that makes the scheduler TPU-native. The reference evaluates
predicates/priorities object-by-object with a 16-worker fan-out
(plugin/pkg/scheduler/core/generic_scheduler.go:204,352); here the entire
cluster becomes a handful of dense arrays so the whole pending queue is one
fused pod x node kernel (kubernetes_tpu_torch/ops/).

Encoding strategy ("everything is a masked matmul"):

- Label (key,value) pairs, taints, extended-resource names are interned into
  host-side vocabularies with stable indices; nodes/pods carry multi-hot rows
  over the vocab axis. Because the vocabularies are built from the actual
  cluster objects, the encoding is EXACT — set operations (selector matching,
  toleration coverage) lower to int8 matmuls + integer compares with no false
  positives/negatives (vs. the hashing scheme sketched in SURVEY.md §7(e);
  exact host-side verification is therefore only needed for features the
  kernels don't model yet, flagged via PodBatch.needs_host_check).

- Resource quantities are int32. CPU stays millicores; memory/storage are
  quantized to KiB (allocatable rounded DOWN, requests rounded UP — so
  quantization can only make placement more conservative, never overcommit).
  Score arithmetic needs (capacity * 10) to fit in int31 -> supports nodes up
  to ~200 GiB memory at KiB granularity; raise mem_shift for bigger nodes.
  All reference test fixtures use Mi-multiples, where KiB is lossless.

- Host ports become a packed 65536-bit bitmap per node (uint32 x 2048 words);
  pod wanted-ports are index lists with -1 sentinel. Conflict check is a
  gather, not a matmul — exact over the full port space.

- Incremental refresh mirrors the generation-counter diffing of
  UpdateNodeNameToInfoMap (reference: schedulercache/cache.go:79): each node
  row is rewritten only when its NodeInfo.generation moved; vocab growth or
  node-set membership change triggers a (rare) full rebuild + recompile-safe
  padded widening.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api.types import (
    MAX_PRIORITY,
    Affinity,
    ConditionStatus,
    Node,
    NodeSelectorTerm,
    Pod,
    SelectorOperator,
    SelectorRequirement,
    Taint,
    TaintEffect,
    Toleration,
)
from kubernetes_tpu_torch.state.node_info import NodeInfo
from kubernetes_tpu_torch.state import volumes as volmod

# Base resource columns (extended resources follow, via vocab)
R_CPU, R_MEM, R_GPU, R_SCRATCH, R_OVERLAY = 0, 1, 2, 3, 4
NUM_BASE_RESOURCES = 5

PORT_SPACE = 65536
PORT_WORDS = PORT_SPACE // 32


def _pad(n: int, to: int = 8) -> int:
    """Pad a vocab axis so occasional growth doesn't force a recompile."""
    return max(to, ((n + to - 1) // to) * to)


from kubernetes_tpu_torch.api.annotations import (  # shared with ops.oracle_ext
    AVOID_PODS_ANNOTATION,
    parse_avoid_annotation as _parse_avoid_annotation,
)


class Vocab:
    """Interning table with stable indices and a by-key reverse map for
    expanding Exists/DoesNotExist/Gt/Lt requirements into pair sets."""

    def __init__(self):
        self._index: Dict[Tuple[str, str], int] = {}
        self._items: List[Tuple[str, str]] = []
        self.by_key: Dict[str, List[int]] = {}

    def add(self, key: str, value: str = "") -> int:
        item = (key, value)
        idx = self._index.get(item)
        if idx is None:
            idx = len(self._items)
            self._index[item] = idx
            self._items.append(item)
            self.by_key.setdefault(key, []).append(idx)
        return idx

    def get(self, key: str, value: str = "") -> int:
        return self._index.get((key, value), -1)

    def __len__(self) -> int:
        return len(self._items)

    def items(self) -> List[Tuple[str, str]]:
        return self._items


class ClusterSnapshot:
    """Dense mirror of the SchedulerCache's node map.

    Arrays (N = padded node count):
      alloc        int32 [N, R]   allocatable (R = 5 base + extended vocab)
      requested    int32 [N, R]   sum of bound+assumed pod requests
      nonzero      int32 [N, 2]   nonzero-request cpu/mem sums (priorities)
      pod_count    int32 [N]
      allowed_pods int32 [N]
      schedulable  bool  [N]      CheckNodeConditionPredicate verdict
      mem_pressure bool  [N]
      disk_pressure bool [N]
      labels       int8  [N, L]   multi-hot over label-pair vocab
      taints_sched int8  [N, T]   NoSchedule|NoExecute taints, taint vocab
      taints_pref  int8  [N, T]   PreferNoSchedule taints (priority only)
      port_bitmap  uint32 [N, 2048]
      valid        bool  [N]      real node (False for padding rows)

    The label-pair vocabulary is DEMAND-driven: only pairs some pod selector
    references get columns (interned via ensure_* during PodBatch compile).
    Node-unique labels like kubernetes.io/hostname therefore cost nothing
    unless selected on — without this, L scales with cluster size and the
    selector tensors dominate host->HBM transfer. Exactness is preserved:
    a pair no selector mentions can never affect a match verdict.

    `dirty` names the arrays whose host copy changed since the consumer
    (engine) last uploaded — pod add/remove touches only requested/nonzero/
    pod_count (+port_bitmap when the pod has host ports), so steady-state
    rounds re-upload ~KBs, not the full snapshot.
    """

    DYNAMIC = ("requested", "nonzero", "pod_count")
    # priority-band axis width: distinct pod PRIORITY values
    # intern into band columns first-seen; a cluster with more distinct
    # priorities than this sets prio_band_overflow and the wave-path
    # victim scan falls back to the host pre-filter (the same
    # over-width -> exact-path routing every other vocab uses)
    PRIO_BANDS = 16
    BAND_UNUSED_PRIO = 2 ** 62
    STATIC = ("alloc", "allowed_pods", "schedulable", "mem_pressure",
              "disk_pressure", "labels", "taints_sched", "taints_pref", "valid",
              "avoid", "image_sizes", "has_zone")

    def __init__(self, mem_shift: int = 10, node_pad: int = 8):
        self.mem_shift = mem_shift
        self.node_pad = node_pad
        self.label_vocab = Vocab()
        self.taint_vocab = Vocab()  # key=(taint key) value=(value|effect)
        self.ext_vocab = Vocab()  # extended resource names
        self.node_names: List[str] = []
        self.node_index: Dict[str, int] = {}
        self._generations: Dict[str, Tuple[int, int, int]] = {}
        self._shape_sig: Optional[Tuple[int, ...]] = None
        self.version = 0  # bumped on any array change (device cache key)
        # encoding generation: bumped only when something that affects POD
        # ENCODING changes — vocab widths/content (finalize_*) or node
        # membership/order (_allocate; PodFitsHost rows store node indices).
        # Capacity deltas (a bind) bump `version` but NOT `vocab_gen`, so
        # the extender's per-class encodings (PodBatch arrays) stay valid
        # across a scheduleOne stream of binds.
        self.vocab_gen = 0
        # label-CONTENT generation: bumped whenever any node's label ROW
        # changes value (relabel to already-interned columns rides the
        # delta refresh without touching vocab_gen, but anything that
        # materialized label content — the wave encoding's key_node /
        # static_forbid / labels_aff topology views — is stale then)
        self.labels_gen = 0
        # Protean patch log for label-row churn: every
        # labels_gen bump appends (gen_after, row), so a consumer whose
        # baked topology views fell one relabel behind can re-derive the
        # touched ROWS instead of rebuilding wholesale. Bounded ring;
        # a consumer further behind than the ring rebuilds.
        self._labels_log: List[Tuple[int, int]] = []
        # the label matrix's nonzeros, kept equal to `labels` by every
        # writer of it: (row, col) int64 pairs in row-major order and the
        # nodes on each column. With one column per hostname the matrix
        # is N x N at about two nonzeros a row, so readers that want only
        # the incidence (the wave encoding's topology views,
        # domain_node_counts) walk these instead of the dense cells.
        self._label_nz_rows = np.zeros(0, dtype=np.int64)
        self._label_nz_cols = np.zeros(0, dtype=np.int64)
        self._label_col_nodes = np.zeros(0, dtype=np.int64)
        self.dirty: set = set()
        # ROW-granular dirt for the DYNAMIC arrays (requested/nonzero/
        # pod_count), consumed by the sharded device sync: a
        # mesh-resident engine re-uploads only the SHARDS owning touched
        # rows instead of the whole [N, R] array per wave. None = unknown
        # (full upload required); the consumer arms tracking by assigning
        # a fresh set after each full sync. Writers that know their rows
        # call _note_rows; writers that rewrite wholesale call
        # _note_rows(None).
        self.dirty_rows = None
        # priority-band vocab: pod priority value -> band
        # column. Band growth never bumps vocab_gen — the bands are
        # preemption-only state no pod encoding reads — and the band
        # arrays live beside the dynamic rows (maintained by the same
        # writers, folded by apply_assume_delta), so the victim scan
        # reads per-node evictable aggregates without any pod walk.
        self.prio_bands: Dict[int, int] = {}
        self.band_prio_host = np.full(self.PRIO_BANDS,
                                      self.BAND_UNUSED_PRIO, dtype=np.int64)
        self.prio_band_overflow = False
        self._label_index: Dict[str, set] = {}  # key -> values across nodes
        self._row_labels: List[Dict[str, str]] = []  # per-row node label maps
        self._labels_width = _pad(0)
        self._vocab_dirty = False
        # NodePreferAvoidPods: vocab of avoided (kind, uid) controller sigs
        self.avoid_vocab = Vocab()
        # ImageLocality: demand-driven vocab of image names pods reference;
        # node rows rebuilt on growth like the label matrix
        self.image_vocab = Vocab()
        self._row_images: List[list] = []
        self._images_width = _pad(0, 4)
        self._image_vocab_dirty = False
        # Volume predicates: demand-driven vocabs of conflict keys
        # (NoDiskConflict) and PD ids (MaxPDVolumeCount). Presence matrices
        # rebuilt on vocab growth like images; pd_counts (unique filtered
        # volumes per node per kind) is vocab-independent host math.
        self.conflict_vocab = Vocab()
        self.pd_vocab = Vocab()  # key = "<kind_idx>\x00<id>"
        self.pd_max = np.array(volmod.max_pd_volumes(), dtype=np.int32)
        self.volume_ctx: volmod.VolumeContext = volmod.EMPTY_VOLUME_CONTEXT
        self._vol_ctx_ver = -1
        self._row_vol_conflicts: List[list] = []  # [(key, read_only)]
        self._row_vol_pds: List[list] = []  # [(kind_idx, id)]
        self._conflict_width = _pad(0, 4)
        self._pd_width = _pad(0, 4)
        self._vol_vocab_dirty = False
        # fast-lane headroom view cache: (weights, ok) derived
        # from the resident arrays, keyed on `version` — a fast pop with
        # no intervening snapshot change reuses it for free
        self._headroom = None
        self._headroom_version = -1
        # arrays created on first refresh
        self.alloc: np.ndarray
        self.requested: np.ndarray
        self.nonzero: np.ndarray
        self.pod_count: np.ndarray
        self.allowed_pods: np.ndarray
        self.schedulable: np.ndarray
        self.mem_pressure: np.ndarray
        self.disk_pressure: np.ndarray
        self.labels: np.ndarray
        self.taints_sched: np.ndarray
        self.taints_pref: np.ndarray
        self.port_bitmap: np.ndarray

    # ------------------------------------------------------------------ api

    @property
    def num_resources(self) -> int:
        return NUM_BASE_RESOURCES + _pad(len(self.ext_vocab), 4)

    def quant_mem(self, v: int, up: bool) -> int:
        if up:
            return -((-v) >> self.mem_shift)
        return v >> self.mem_shift

    def resource_row(self, *, milli_cpu: int, memory: int, gpu: int, scratch: int,
                     overlay: int, extended: Dict[str, int], up: bool,
                     width: int, unknown: Optional[List[str]] = None) -> np.ndarray:
        """Encode one resource vector. The ext vocab is CLOSED here — refresh()
        interns every name visible in node allocatable/requested before the
        arrays are shaped. A name still unknown (only possible for a pending
        pod requesting a resource no node advertises) is appended to `unknown`
        so the caller can mark the pod impossible-to-place instead of
        overflowing the padded width."""
        row = np.zeros(width, dtype=np.int32)
        row[R_CPU] = milli_cpu
        row[R_MEM] = self.quant_mem(memory, up)
        row[R_GPU] = gpu
        row[R_SCRATCH] = self.quant_mem(scratch, up)
        row[R_OVERLAY] = self.quant_mem(overlay, up)
        for name, q in extended.items():
            idx = self.ext_vocab.get(name, "")
            if idx < 0:
                if unknown is None:
                    raise KeyError(
                        f"extended resource {name!r} missing from vocab — "
                        "refresh() must intern node-side names first")
                unknown.append(name)
                continue
            row[NUM_BASE_RESOURCES + idx] = q
        return row

    def headroom_view(self):
        """(weights float64 [N], ok bool [N]) for the fast lane's
        weighted power-of-k sampling: weight = spare CPU + 1
        on rows that could plausibly take a pod (live + schedulable +
        pod-count headroom), 0 elsewhere. Derived from the RESIDENT host
        arrays only — no refresh, no device read — and cached on
        `version` so back-to-back fast pops between snapshot changes pay
        one subtract. Approximate by design: the sampled eval re-checks
        everything exactly, the fence re-validates against live truth."""
        if self._headroom_version == self.version and \
                self._headroom is not None:
            return self._headroom
        spare = np.clip(self.alloc[:, R_CPU] - self.requested[:, R_CPU],
                        0, None).astype(np.float64)
        ok = (self.schedulable & self.valid
              & (self.pod_count < self.allowed_pods))
        weights = np.where(ok, spare + 1.0, 0.0)
        self._headroom = (weights, ok)
        self._headroom_version = self.version
        return self._headroom

    def ensure_label_pair(self, key: str, value: str) -> int:
        """Intern a selector-referenced pair; marks the label matrix stale
        when the vocab grows."""
        before = len(self.label_vocab)
        idx = self.label_vocab.add(key, value)
        if len(self.label_vocab) != before:
            self._vocab_dirty = True
        return idx

    def node_values_for_key(self, key: str):
        """Values present for `key` across current nodes (for Exists/Gt/Lt/
        DoesNotExist expansion)."""
        return self._label_index.get(key, ())

    def ensure_image(self, name: str) -> int:
        before = len(self.image_vocab)
        idx = self.image_vocab.add(name, "")
        if len(self.image_vocab) != before:
            self._image_vocab_dirty = True
        return idx

    def finalize_images(self) -> int:
        """Rebuild [N, I] image-size matrix (KiB, clamped to int32) if the
        image vocab grew. Mirrors finalize_labels."""
        want = _pad(len(self.image_vocab), 4)
        if self._image_vocab_dirty or want != self._images_width:
            self._images_width = want
            n = self.alloc.shape[0] if self._shape_sig else 0
            self.image_sizes = np.zeros((n, want), dtype=np.int32)
            for i, images in enumerate(self._row_images):
                self._write_image_row(i, images)
            self._image_vocab_dirty = False
            self.dirty.add("image_sizes")
            self.version += 1
            self.vocab_gen += 1
        return self._images_width

    def ensure_conflict_key(self, key: str) -> int:
        before = len(self.conflict_vocab)
        idx = self.conflict_vocab.add(key, "")
        if len(self.conflict_vocab) != before:
            self._vol_vocab_dirty = True
        return idx

    def ensure_pd_id(self, kind_idx: int, vid: str) -> int:
        before = len(self.pd_vocab)
        idx = self.pd_vocab.add(str(kind_idx) + "\x00" + vid, "")
        if len(self.pd_vocab) != before:
            self._vol_vocab_dirty = True
        return idx

    def finalize_volumes(self) -> Tuple[int, int]:
        """Rebuild the node-side volume presence matrices if either volume
        vocab grew (PodBatch compile interns pending pods' keys). Returns
        (conflict_width, pd_width)."""
        want_c = _pad(len(self.conflict_vocab), 4)
        want_p = _pad(len(self.pd_vocab), 4)
        if (self._vol_vocab_dirty or want_c != self._conflict_width
                or want_p != self._pd_width):
            self._conflict_width = want_c
            self._pd_width = want_p
            n = self.alloc.shape[0] if self._shape_sig else 0
            self.vol_present = np.zeros((n, want_c), dtype=np.int8)
            self.vol_rw = np.zeros((n, want_c), dtype=np.int8)
            self.pd_present = np.zeros((n, want_p), dtype=np.int8)
            for i in range(len(self.node_names)):
                self._write_volume_presence_row(i)
            # [3, Vpd] kind mask over pd vocab columns
            self.pd_kind = np.zeros((3, want_p), dtype=np.int8)
            for col, (key, _) in enumerate(self.pd_vocab.items()):
                self.pd_kind[int(key.split("\x00", 1)[0]), col] = 1
            self._vol_vocab_dirty = False
            self.dirty.update(("vol_present", "vol_rw", "pd_present",
                               "pd_kind"))
            self.version += 1
            self.vocab_gen += 1
        return self._conflict_width, self._pd_width

    def finalize_labels(self) -> int:
        """Rebuild the [N, L] label matrix if the vocab grew (called by
        PodBatch after selector compilation). Returns the padded width L."""
        want = _pad(len(self.label_vocab))
        if self._vocab_dirty or want != self._labels_width:
            self._labels_width = want
            n = self.alloc.shape[0] if self._shape_sig else 0
            self.labels = np.zeros((n, want), dtype=np.int8)
            # batch scatter through the native encoder (C++ hostops with
            # numpy fallback) instead of a per-row rewrite loop — this is
            # the full-matrix rebuild every vocab growth pays
            self._scatter_labels(len(self._row_labels))
            self._vocab_dirty = False
            self.dirty.add("labels")
            self.version += 1
            self.vocab_gen += 1
            if self._shape_sig is not None:
                # keep the shape signature in sync so the next refresh()
                # doesn't mistake the widened label axis for a rebuild
                sig = list(self._shape_sig)
                sig[1] = want
                self._shape_sig = tuple(sig)
        return self._labels_width

    def refresh(self, infos: Dict[str, NodeInfo],
                volume_ctx: Optional[volmod.VolumeContext] = None,
                changed_hint: Optional[Sequence[str]] = None) -> bool:
        """Sync arrays with the cache. Returns True on full rebuild (shape or
        membership change), False for in-place delta. A PV/PVC change
        (volume_ctx.version moved) re-resolves every node's PD rows — the
        ecache-style invalidation of factory.go:261-601 for PV/PVC events.

        changed_hint: the caller ASSERTS node membership is unchanged and
        only the named nodes may have moved (the extender's per-bind path,
        where walking all N generation counters per request would dominate
        a warm [1,N] evaluation). Verification is PARTIAL: spec/ports/
        identity changes and unseen extended resources on the HINTED nodes,
        plus a size change of the node set, fall back to the full scan —
        but changes to non-hinted nodes (including an equal-size node swap)
        are trusted, not checked; a caller that cannot uphold the assertion
        must not pass a hint. TPUExtenderBackend upholds it by owning its
        cache exclusively and escalating every sync to a full refresh."""
        if volume_ctx is not None:
            self.volume_ctx = volume_ctx
        vol_ctx_moved = self._vol_ctx_ver != self.volume_ctx.version
        self._vol_ctx_ver = self.volume_ctx.version
        from kubernetes_tpu_torch.utils.trace import COUNTERS
        if changed_hint is not None and not vol_ctx_moved \
                and self._shape_sig is not None \
                and len(infos) == len(self.node_names) \
                and self._refresh_hinted(infos, changed_hint):
            COUNTERS.inc("snapshot.refresh_hinted")
            return False
        # node-driven vocabs (taints, extended resources, avoid signatures) —
        # interned before shaping, re-scanned only for changed node specs.
        # The skip-cache keys on (spec_generation, node object identity): a
        # node deleted and re-added under the same name restarts its counters,
        # so generation equality alone would skip interning its new spec.
        if not hasattr(self, "_interned_spec"):
            self._interned_spec = {}
        for nm in list(self._interned_spec):
            if nm not in infos:
                del self._interned_spec[nm]
        for nm, info in infos.items():
            node = info.node
            seen = self._interned_spec.get(nm)
            if node is not None and (seen is None or seen[0] != info.spec_generation
                                     or seen[1] is not node):
                self._interned_spec[nm] = (info.spec_generation, node)
                for t in node.taints:
                    eff = t.effect.value if isinstance(t.effect, TaintEffect) else t.effect
                    self.taint_vocab.add(t.key, t.value + "\x00" + str(eff))
                for name in node.allocatable.extended:
                    self.ext_vocab.add(name, "")
                for kind, uid in _parse_avoid_annotation(node.annotations):
                    self.avoid_vocab.add(kind, uid)
            if info.requested.extended:
                # bound/assumed pods may request ext resources their node
                # doesn't advertise; intern so _write_dynamic_row can't overflow
                for name in info.requested.extended:
                    self.ext_vocab.add(name, "")

        names = sorted(infos.keys())
        n_pad = _pad(len(names), self.node_pad)
        sig = (n_pad, self._labels_width, _pad(len(self.taint_vocab)),
               self.num_resources, _pad(len(self.avoid_vocab), 4))
        rebuild = sig != self._shape_sig or names != self.node_names
        COUNTERS.inc("snapshot.refresh_rebuild" if rebuild
                     else "snapshot.refresh_scan")
        if rebuild:
            self._allocate(names, sig)
            self._label_index = {}
            self._row_labels = [{} for _ in range(n_pad)]
            changed = names
        else:
            # a NodeInfo replaced under the same name (node removed+re-added)
            # restarts its counters — identity is part of the staleness key
            changed = []
            for nm in names:
                prev = self._generations.get(nm)
                info = infos[nm]
                if (prev is None or prev[0] != info.generation
                        or prev[3] is not info or vol_ctx_moved):
                    changed.append(nm)
        label_index_stale = rebuild
        if rebuild:
            # full build: one vectorized pass over every node instead of
            # 3 per-row writers x N (the dominant host cost of a cold
            # 5k-node snapshot)
            self._write_rows_bulk(names, infos)
        else:
            dyn_only = []
            for nm in changed:
                i = self.node_index[nm]
                info = infos[nm]
                prev = self._generations.get(nm, (-1, -1, -1, None))
                fresh = prev[3] is not info
                if not fresh and info.spec_generation == prev[1] \
                        and info.ports_generation == prev[2]:
                    # pure capacity delta: vectorized batch write below
                    dyn_only.append((i, nm, info))
                    continue
                self._write_dynamic_row(i, info)
                if fresh or info.spec_generation != prev[1]:
                    self._write_static_row(i, info)
                    label_index_stale = True
                if fresh or info.ports_generation != prev[2]:
                    self._write_ports_row(i, info)
                self._generations[nm] = (info.generation,
                                         info.spec_generation,
                                         info.ports_generation, info)
            if dyn_only:
                self._write_dynamic_rows_bulk(dyn_only)
        if label_index_stale:
            self._rebuild_label_index(infos, names)
        if changed or rebuild:
            self.version += 1
        return rebuild

    def _refresh_hinted(self, infos: Dict[str, NodeInfo],
                        changed_hint: Sequence[str]) -> bool:
        """Targeted dynamic-row delta for `changed_hint`. Returns True when
        the hint fully covered the update (pure capacity deltas on known
        nodes); False to make the caller run the full generation scan."""
        updates = []
        gens = self._generations
        index = self.node_index
        for nm in changed_hint:
            info = infos.get(nm)
            i = index.get(nm, -1)
            if info is None or i < 0:
                return False  # membership drift — full scan
            prev = gens.get(nm)
            if prev is None or prev[3] is not info \
                    or prev[1] != info.spec_generation \
                    or prev[2] != info.ports_generation:
                return False  # spec/ports/identity moved — needs interning
            if info.requested.extended \
                    and any(self.ext_vocab.get(name, "") < 0
                            for name in info.requested.extended):
                return False  # unseen extended resource — needs interning
            if prev[0] != info.generation:
                updates.append((i, nm, info))
        if updates:
            self._write_dynamic_rows_bulk(updates)
            self.version += 1
        return True

    # ------------------------------------------------- priority bands

    def band_of(self, prio: int, intern: bool = True) -> int:
        """Band column of a pod priority value; interns on first sight.
        Returns -1 (and sets prio_band_overflow when interning) once the
        band axis is full — the caller's cue to take the exact host
        pre-filter instead of the device victim scan."""
        b = self.prio_bands.get(prio)
        if b is not None:
            return b
        if not intern:
            return -1
        if len(self.prio_bands) >= self.PRIO_BANDS:
            self.prio_band_overflow = True
            return -1
        b = len(self.prio_bands)
        self.prio_bands[prio] = b
        self.band_prio_host[b] = prio
        return b

    def _write_band_row(self, i: int, info: NodeInfo) -> None:
        """Recompute one node's band columns from the NodeInfo's
        incremental per-priority aggregate (O(distinct priorities on the
        node), no pod walk)."""
        self.band_cpu[i] = 0
        self.band_mem[i] = 0
        self.band_count[i] = 0
        for prio, u in info.prio_usage.items():
            b = self.band_of(prio)
            if b < 0:
                continue  # overflow: the scan is gated off; best-effort
            self.band_cpu[i, b] = u[0]
            self.band_mem[i, b] = u[1]
            self.band_count[i, b] = u[2]

    def band_bound_counts(self) -> Dict[int, int]:
        """Cluster-wide pod count per priority value (assumed included) —
        the disruption budget's per-band floor reads this."""
        return {prio: int(self.band_count[:, b].sum())
                for prio, b in self.prio_bands.items()}

    def apply_assume_delta(self, rows: np.ndarray, delta: np.ndarray,
                           gen_items, prio_rows=None) -> None:
        """Fold a wave of assumes into the dynamic arrays WITHOUT touching
        the NodeInfos: the caller (the pipelined harvest) knows the exact
        per-placement raw delta (class request + nonzero rows), so the
        mirror applies it to the raw int64 accumulators and re-quantizes
        the touched rows — bit-identical to a full row rewrite from the
        cache, at numpy speed. gen_items = [(name, info)] syncs the
        generation bookkeeping so the next refresh() does not re-walk
        these nodes for a change the mirror already has.

        rows may repeat (one entry per placement); delta is int64 [k, 7]:
        requested cpu/mem/gpu/scratch/overlay, nonzero cpu/mem. Callers
        must route placements with ports/volumes/extended resources through
        the normal dirty-note path instead — those touch more than the
        seven raw columns."""
        from kubernetes_tpu_torch.utils.trace import COUNTERS
        # one count per folded placement: the streaming loop's delta-only
        # invariant reads this against the bound total to PROVE assumes
        # rode the raw-delta path, never a node walk
        COUNTERS.inc("snapshot.assume_delta_rows", len(rows))
        np.add.at(self._raw_dyn, rows, delta)
        np.add.at(self.pod_count, rows, 1)
        if prio_rows is not None and len(rows):
            # fold the placements into the priority-band aggregates too:
            # per-row band index from the vocab, interning
            # unseen priorities (band growth invalidates nothing)
            bands = np.fromiter((self.band_of(int(p)) for p in prio_rows),
                                dtype=np.int64, count=len(rows))
            okb = bands >= 0  # overflow rows: scan is gated off anyway
            if okb.any():
                rb, bb = rows[okb], bands[okb]
                np.add.at(self.band_cpu, (rb, bb), delta[okb, 0])
                np.add.at(self.band_mem, (rb, bb), delta[okb, 1])
                np.add.at(self.band_count, (rb, bb), 1)
        touched = np.unique(rows)
        raw = self._raw_dyn[touched]
        shift = self.mem_shift
        requested = self.requested
        requested[touched, R_CPU] = self._i32(raw[:, 0])
        requested[touched, R_MEM] = self._i32(-((-raw[:, 1]) >> shift))
        requested[touched, R_GPU] = self._i32(raw[:, 2])
        requested[touched, R_SCRATCH] = self._i32(-((-raw[:, 3]) >> shift))
        requested[touched, R_OVERLAY] = self._i32(-((-raw[:, 4]) >> shift))
        self.nonzero[touched, 0] = self._i32(raw[:, 5])
        self.nonzero[touched, 1] = self._i32(-((-raw[:, 6]) >> shift))
        gens = self._generations
        for nm, info in gen_items:
            prev = gens.get(nm)
            if prev is not None:  # unseen node: next refresh rewrites it
                gens[nm] = (info.generation, prev[1], prev[2], info)
        self.dirty.update(self.DYNAMIC)
        self._note_rows(touched)
        self.version += 1

    def _write_dynamic_rows_bulk(self, updates) -> None:
        """The work of _write_dynamic_row over a BATCH of (row, name, info)
        triples in vectorized column math — the pipelined drain rewrites
        every assumed-onto node once per wave, so the per-row Python writer
        (resource_row + per-column quantization calls) would dominate the
        round. Rows with extended resources or volume-bearing pods take the
        exact per-row writer; generations update for all."""
        slow = []
        fast = []
        for item in updates:
            info = item[2]
            if info.requested.extended or info.vol_count \
                    or self._row_vol_conflicts[item[0]] \
                    or self._row_vol_pds[item[0]]:
                slow.append(item)
            else:
                fast.append(item)
        if fast:
            n = len(fast)
            idx = np.empty(n, dtype=np.intp)
            base = np.empty((n, 5), dtype=np.int64)
            nz = np.empty((n, 2), dtype=np.int64)
            cnt = np.empty(n, dtype=np.int32)
            for j, (i, _nm, info) in enumerate(fast):
                idx[j] = i
                req = info.requested
                base[j] = (req.milli_cpu, req.memory, req.nvidia_gpu,
                           req.storage_scratch, req.storage_overlay)
                nz[j] = (info.nonzero_cpu, info.nonzero_mem)
                cnt[j] = len(info.pods)
                self._write_band_row(i, info)
            shift = self.mem_shift
            requested = self.requested
            requested[idx, R_CPU] = self._i32(base[:, 0])
            requested[idx, R_MEM] = self._i32(-((-base[:, 1]) >> shift))
            requested[idx, R_GPU] = self._i32(base[:, 2])
            requested[idx, R_SCRATCH] = self._i32(-((-base[:, 3]) >> shift))
            requested[idx, R_OVERLAY] = self._i32(-((-base[:, 4]) >> shift))
            if requested.shape[1] > NUM_BASE_RESOURCES:
                # a node whose last extended-resource pod just left arrives
                # via `slow` (extended keeps zeroed keys); rows here never
                # carry extended requests — clear any stale columns
                requested[idx[:, None],
                          np.arange(NUM_BASE_RESOURCES,
                                    requested.shape[1])] = 0
            self.nonzero[idx, 0] = self._i32(nz[:, 0])
            self.nonzero[idx, 1] = self._i32(-((-nz[:, 1]) >> shift))
            self._raw_dyn[idx, :5] = base
            self._raw_dyn[idx, 5:7] = nz
            self.pod_count[idx] = cnt
            self.dirty.update(self.DYNAMIC)
            self._note_rows(idx)
        for i, _nm, info in slow:
            self._write_dynamic_row(i, info)
        for i, nm, info in updates:
            self._generations[nm] = (info.generation, info.spec_generation,
                                     info.ports_generation, info)

    # ------------------------------------------------------------- internals

    def _allocate(self, names: List[str], sig: Tuple[int, ...]) -> None:
        n, l, t, r = sig[:4]
        self._shape_sig = sig
        # membership/order changed: PodBatch encodings store node indices
        # (PodFitsHost) — every cached encoding keyed on vocab_gen is stale
        self.vocab_gen += 1
        self.node_names = names
        self.node_index = {nm: i for i, nm in enumerate(names)}
        self._generations = {}
        self.alloc = np.zeros((n, r), dtype=np.int32)
        self.requested = np.zeros((n, r), dtype=np.int32)
        self.nonzero = np.zeros((n, 2), dtype=np.int32)
        # raw (unquantized) mirror of the dynamic columns: requested
        # cpu/mem/gpu/scratch/overlay + nonzero cpu/mem — the substrate
        # apply_assume_delta accumulates into so incremental quantization
        # stays bit-identical to a full rewrite (ceil of the TOTAL, not a
        # sum of per-pod ceils)
        self._raw_dyn = np.zeros((n, 7), dtype=np.int64)
        # priority-band aggregates: raw int64 per (node, band)
        # sums — quantization happens at upload, so incremental folds and
        # full row rewrites agree bit-exactly
        self.band_cpu = np.zeros((n, self.PRIO_BANDS), dtype=np.int64)
        self.band_mem = np.zeros((n, self.PRIO_BANDS), dtype=np.int64)
        self.band_count = np.zeros((n, self.PRIO_BANDS), dtype=np.int32)
        self.pod_count = np.zeros(n, dtype=np.int32)
        self.allowed_pods = np.zeros(n, dtype=np.int32)
        self.schedulable = np.zeros(n, dtype=bool)
        self.mem_pressure = np.zeros(n, dtype=bool)
        self.disk_pressure = np.zeros(n, dtype=bool)
        self.labels = np.zeros((n, l), dtype=np.int8)
        self._index_labels(np.zeros((0, 2), dtype=np.int64))
        self.taints_sched = np.zeros((n, t), dtype=np.int8)
        self.taints_pref = np.zeros((n, t), dtype=np.int8)
        self.port_bitmap = np.zeros((n, PORT_WORDS), dtype=np.uint32)
        self._port_words_used = None
        self.valid = np.zeros(n, dtype=bool)
        self.valid[: len(names)] = True
        self.avoid = np.zeros((n, _pad(len(self.avoid_vocab), 4)), dtype=np.int8)
        self.image_sizes = np.zeros((n, self._images_width), dtype=np.int32)
        self._row_images = [[] for _ in range(n)]
        self.has_zone = np.zeros(n, dtype=bool)
        self.vol_present = np.zeros((n, self._conflict_width), dtype=np.int8)
        self.vol_rw = np.zeros((n, self._conflict_width), dtype=np.int8)
        self.pd_present = np.zeros((n, self._pd_width), dtype=np.int8)
        self.pd_counts = np.zeros((n, 3), dtype=np.int32)
        if not hasattr(self, "pd_kind") or self.pd_kind.shape[1] != self._pd_width:
            self.pd_kind = np.zeros((3, self._pd_width), dtype=np.int8)
            for col, (key, _) in enumerate(self.pd_vocab.items()):
                self.pd_kind[int(key.split("\x00", 1)[0]), col] = 1
        self._row_vol_conflicts = [[] for _ in range(n)]
        self._row_vol_pds = [[] for _ in range(n)]
        self.dirty = {"requested", "nonzero", "pod_count", "port_bitmap",
                      "vol_present", "vol_rw", "pd_present", "pd_counts",
                      "pd_kind", *self.STATIC}
        self._note_rows(None)  # fresh arrays: shape moved, full sync

    def _write_rows_bulk(self, names: List[str],
                         infos: Dict[str, NodeInfo]) -> None:
        """Full-rebuild body: the work of _write_dynamic_row +
        _write_static_row + _write_ports_row for every node in one pass —
        scalar columns packed into numpy arrays with vectorized memory
        quantization, sparse features (taints, avoid, images, volumes,
        ports, extended resources) written per row only when present.
        Equivalent to the per-row writers (pinned by test_snapshot's
        bulk-vs-incremental parity test)."""
        n = len(names)
        base = np.zeros((n, 2, 5), dtype=np.int64)  # [node, alloc|req, col]
        nonzero = np.zeros((n, 2), dtype=np.int64)
        for i, nm in enumerate(names):
            info = infos[nm]
            req = info.requested
            base[i, 1] = (req.milli_cpu, req.memory, req.nvidia_gpu,
                          req.storage_scratch, req.storage_overlay)
            nonzero[i] = (info.nonzero_cpu, info.nonzero_mem)
            self.pod_count[i] = len(info.pods)
            self._write_band_row(i, info)
            node = info.node
            if node is None:
                self.schedulable[i] = False
                self.valid[i] = False
            else:
                a = node.allocatable
                base[i, 0] = (a.milli_cpu, a.memory, a.nvidia_gpu,
                              a.storage_scratch, a.storage_overlay)
                self.allowed_pods[i] = node.allowed_pod_number
                self.schedulable[i] = node.is_ready()
                self.mem_pressure[i] = \
                    node.condition("MemoryPressure") == ConditionStatus.TRUE
                self.disk_pressure[i] = \
                    node.condition("DiskPressure") == ConditionStatus.TRUE
                self.valid[i] = True
                self._row_labels[i] = node.labels
                self.has_zone[i] = (volmod.ZONE_LABEL in node.labels
                                    or volmod.REGION_LABEL in node.labels)
                if a.extended:
                    for name, q in a.extended.items():
                        idx = self.ext_vocab.get(name, "")
                        if idx < 0:  # refresh() interns node names first
                            raise KeyError(
                                f"extended resource {name!r} missing from "
                                "vocab — refresh() must intern node-side "
                                "names first")
                        self.alloc[i, NUM_BASE_RESOURCES + idx] = q
                if node.taints:
                    self._write_taint_row(i, node)
                if node.annotations:
                    av = _parse_avoid_annotation(node.annotations)
                    for kind, uid in av:
                        idx = self.avoid_vocab.get(kind, uid)
                        if idx >= 0:
                            self.avoid[i, idx] = 1
                if node.images:
                    self._row_images[i] = node.images
                    self._write_image_row(i, node.images)
            if req.extended:
                for name, q in req.extended.items():
                    idx = self.ext_vocab.get(name, "")
                    if idx < 0:
                        raise KeyError(
                            f"extended resource {name!r} missing from "
                            "vocab — refresh() must intern node-side "
                            "names first")
                    self.requested[i, NUM_BASE_RESOURCES + idx] = q
            if info.used_ports:
                self._write_ports_row(i, info)
            # volume aggregates (same content as _write_dynamic_row)
            if any(p.volumes for p in info.pods):
                conflicts, pd_ids = [], []
                for p in info.pods:
                    if p.volumes:
                        conflicts.extend(volmod.pod_conflict_keys(p))
                        pd_ids.extend(volmod.pd_filter_ids(p, self.volume_ctx))
                self._row_vol_conflicts[i] = conflicts
                self._row_vol_pds[i] = pd_ids
                counts = [set(), set(), set()]
                for k, vid in pd_ids:
                    counts[k].add(vid)
                self.pd_counts[i] = [len(s) for s in counts]
                self._write_volume_presence_row(i)
            self._generations[nm] = (info.generation, info.spec_generation,
                                     info.ports_generation, info)
        # vectorized base columns: alloc rounds DOWN, requested rounds UP
        shift = self.mem_shift
        self.alloc[:n, R_CPU] = self._i32(base[:, 0, 0])
        self.alloc[:n, R_MEM] = self._i32(base[:, 0, 1] >> shift)
        self.alloc[:n, R_GPU] = self._i32(base[:, 0, 2])
        self.alloc[:n, R_SCRATCH] = self._i32(base[:, 0, 3] >> shift)
        self.alloc[:n, R_OVERLAY] = self._i32(base[:, 0, 4] >> shift)
        self.requested[:n, R_CPU] = self._i32(base[:, 1, 0])
        self.requested[:n, R_MEM] = self._i32(-((-base[:, 1, 1]) >> shift))
        self.requested[:n, R_GPU] = self._i32(base[:, 1, 2])
        self.requested[:n, R_SCRATCH] = self._i32(-((-base[:, 1, 3]) >> shift))
        self.requested[:n, R_OVERLAY] = self._i32(-((-base[:, 1, 4]) >> shift))
        self.nonzero[:n, 0] = self._i32(nonzero[:, 0])
        self.nonzero[:n, 1] = self._i32(-((-nonzero[:, 1]) >> shift))
        self._raw_dyn[:n, :5] = base[:, 1]
        self._raw_dyn[:n, 5:7] = nonzero
        self._scatter_labels(n)
        self.dirty.update(self.DYNAMIC)
        self.dirty.update(self.STATIC)
        self._note_rows(None)  # wholesale rewrite — row dirt meaningless

    def _note_rows(self, rows) -> None:
        """Record dynamic-row dirt for the sharded delta sync. rows=None
        means "cannot name the rows" — the next sync uploads wholesale."""
        if rows is None:
            self.dirty_rows = None
        elif self.dirty_rows is not None:
            self.dirty_rows.update(int(r) for r in rows)

    @staticmethod
    def _i32(col: np.ndarray) -> np.ndarray:
        """Checked int64 -> int32 downcast: numpy array assignment WRAPS
        silently where per-row Python-int assignment raised — preserve the
        per-row writers' overflow diagnostic (raise mem_shift)."""
        if col.size and (int(col.max()) > 2 ** 31 - 1
                         or int(col.min()) < -(2 ** 31)):
            raise OverflowError(
                "resource quantity exceeds int32 after quantization — "
                "raise ClusterSnapshot mem_shift")
        return col

    def _scatter_labels(self, n_rows: int) -> None:
        """Label incidence matrix in one batch scatter (native hostops with
        numpy fallback) — shared by finalize_labels and the bulk rebuild."""
        from kubernetes_tpu_torch import native as hostops
        pairs = [(i, idx)
                 for i, lbls in enumerate(self._row_labels[:n_rows])
                 for idx in (self.label_vocab.get(k, v)
                             for k, v in lbls.items())
                 if idx >= 0]
        pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        if pairs.size:
            hostops.fill_multi_hot(pairs, self.labels)
        self._index_labels(pairs)

    def _index_labels(self, pairs: np.ndarray) -> None:
        """Set the nonzero index to the (row, col) `pairs` [K, 2] just
        written into an all-zero label matrix, less what fill_multi_hot
        drops: columns past a width that has not caught up with the
        vocab yet."""
        n, w = self.labels.shape
        r, c = pairs[:, 0], pairs[:, 1]
        ok = (r < n) & (c < w)
        lin = np.unique(r[ok] * w + c[ok])          # sorted: row-major
        self._label_nz_rows, self._label_nz_cols = np.divmod(lin, w)
        self._label_col_nodes = np.bincount(self._label_nz_cols,
                                            minlength=w).astype(np.int64)

    def _write_taint_row(self, i: int, node) -> None:
        for t in node.taints:
            eff = t.effect.value if isinstance(t.effect, TaintEffect) \
                else t.effect
            idx = self.taint_vocab.get(t.key, t.value + "\x00" + str(eff))
            if eff in (TaintEffect.NO_SCHEDULE.value,
                       TaintEffect.NO_EXECUTE.value):
                self.taints_sched[i, idx] = 1
            elif eff == TaintEffect.PREFER_NO_SCHEDULE.value:
                self.taints_pref[i, idx] = 1

    def _write_dynamic_row(self, i: int, info: NodeInfo) -> None:
        self._note_rows((i,))
        r = self.num_resources
        req_ = info.requested
        self._raw_dyn[i] = (req_.milli_cpu, req_.memory, req_.nvidia_gpu,
                            req_.storage_scratch, req_.storage_overlay,
                            info.nonzero_cpu, info.nonzero_mem)
        self.requested[i] = self.resource_row(
            milli_cpu=info.requested.milli_cpu, memory=info.requested.memory,
            gpu=info.requested.nvidia_gpu, scratch=info.requested.storage_scratch,
            overlay=info.requested.storage_overlay,
            extended=info.requested.extended, up=True, width=r)
        self.nonzero[i, 0] = info.nonzero_cpu
        self.nonzero[i, 1] = self.quant_mem(info.nonzero_mem, up=True)
        self.pod_count[i] = len(info.pods)
        self._write_band_row(i, info)
        # volume aggregates over the node's (bound+assumed) pods; volume
        # arrays are dirtied only when the node's volume set actually moved,
        # so volume-less churn keeps steady-state uploads tiny
        conflicts: List[Tuple[str, bool]] = []
        pd_ids: List[Tuple[int, str]] = []
        if any(p.volumes for p in info.pods):
            for p in info.pods:
                if p.volumes:
                    conflicts.extend(volmod.pod_conflict_keys(p))
                    pd_ids.extend(volmod.pd_filter_ids(p, self.volume_ctx))
        vol_changed = (conflicts != self._row_vol_conflicts[i]
                       or pd_ids != self._row_vol_pds[i])
        self._row_vol_conflicts[i] = conflicts
        self._row_vol_pds[i] = pd_ids
        if vol_changed:
            counts = [set(), set(), set()]
            for k, vid in pd_ids:
                counts[k].add(vid)
            self.pd_counts[i] = [len(s) for s in counts]
            self._write_volume_presence_row(i)
            self.dirty.update(("vol_present", "vol_rw", "pd_present",
                               "pd_counts"))
        self.dirty.update(self.DYNAMIC)

    def _assign_row(self, name: str, i: int, value) -> None:
        """Row write with CHANGE DETECTION: dirty only what actually moved.
        Under churn most static-row rewrites carry identical
        values (a flap touches only conditions; a respawn restores the
        same spec) — marking every static array dirty per event re-uploads
        megabytes and invalidates the cached wave precompute once per
        fault, which measured as the churn throughput collapse."""
        arr = getattr(self, name)
        if np.array_equal(arr[i], value):
            return
        arr[i] = value
        self.dirty.add(name)

    def _write_static_row(self, i: int, info: NodeInfo) -> None:
        node = info.node
        r = self.num_resources
        if node is None:
            # tombstone (cache.remove_node): the row stays allocated, only
            # the liveness verdicts flip — membership never restructures
            # per churn event
            self._assign_row("schedulable", i, False)
            self._assign_row("valid", i, False)
            return
        self._assign_row("alloc", i, self.resource_row(
            milli_cpu=node.allocatable.milli_cpu, memory=node.allocatable.memory,
            gpu=node.allocatable.nvidia_gpu, scratch=node.allocatable.storage_scratch,
            overlay=node.allocatable.storage_overlay,
            extended=node.allocatable.extended, up=False, width=r))
        self._assign_row("allowed_pods", i, node.allowed_pod_number)
        self._assign_row("schedulable", i, node.is_ready())
        self._assign_row("mem_pressure", i,
                         node.condition("MemoryPressure") == ConditionStatus.TRUE)
        self._assign_row("disk_pressure", i,
                         node.condition("DiskPressure") == ConditionStatus.TRUE)
        self._assign_row("valid", i, True)
        self._row_labels[i] = node.labels
        gen0 = self.labels_gen
        self._write_label_row(i, node.labels)  # content-compared inside
        if self.labels_gen != gen0:
            self.dirty.add("labels")

        old_ts = self.taints_sched[i].copy()
        old_tp = self.taints_pref[i].copy()
        self.taints_sched[i] = 0
        self.taints_pref[i] = 0
        self._write_taint_row(i, node)
        if not np.array_equal(old_ts, self.taints_sched[i]):
            self.dirty.add("taints_sched")
        if not np.array_equal(old_tp, self.taints_pref[i]):
            self.dirty.add("taints_pref")

        av = np.zeros(self.avoid.shape[1], dtype=np.int8)
        for kind, uid in _parse_avoid_annotation(node.annotations):
            idx = self.avoid_vocab.get(kind, uid)
            if idx >= 0:
                av[idx] = 1
        self._assign_row("avoid", i, av)

        self._row_images[i] = node.images
        old_img = self.image_sizes[i].copy() \
            if getattr(self, "image_sizes", None) is not None \
            and self.image_sizes.shape[1] == self._images_width else None
        self._write_image_row(i, node.images)
        if old_img is not None \
                and not np.array_equal(old_img, self.image_sizes[i]):
            self.dirty.add("image_sizes")
        self._assign_row("has_zone", i,
                         any(k in (volmod.ZONE_LABEL, volmod.REGION_LABEL)
                             for k in node.labels))

    # graftlint: gen-ok — per-row helper; every caller (_write_dynamic_row,
    # finalize_images' rebuild loop) owns the dirty note for the batch
    def _write_image_row(self, i: int, images) -> None:
        row = np.zeros(self._images_width, dtype=np.int32)
        for img in images:
            size_kib = min(img.size_bytes >> 10, 2 ** 31 - 1)
            for name in img.names:
                idx = self.image_vocab.get(name, "")
                if idx >= 0:
                    row[idx] = size_kib
        if getattr(self, "image_sizes", None) is not None \
                and self.image_sizes.shape[1] == self._images_width:
            self.image_sizes[i] = row

    # graftlint: gen-ok — per-row helper; callers (_write_dynamic_row,
    # finalize_volumes' rebuild loop) own the dirty note for the batch
    def _write_volume_presence_row(self, i: int) -> None:
        """Multi-hot conflict/PD presence over the demand-driven vocabs; a
        key no pending pod references has no column (and cannot conflict)."""
        if (getattr(self, "vol_present", None) is None
                or self.vol_present.shape[1] != self._conflict_width
                or self.pd_present.shape[1] != self._pd_width
                or i >= len(self._row_vol_conflicts)):
            return
        vc = np.zeros(self._conflict_width, dtype=np.int8)
        vr = np.zeros(self._conflict_width, dtype=np.int8)
        for key, ro in self._row_vol_conflicts[i]:
            idx = self.conflict_vocab.get(key, "")
            if idx >= 0:
                vc[idx] = 1
                if not ro:
                    vr[idx] = 1
        self.vol_present[i] = vc
        self.vol_rw[i] = vr
        pdrow = np.zeros(self._pd_width, dtype=np.int8)
        for k, vid in self._row_vol_pds[i]:
            idx = self.pd_vocab.get(str(k) + "\x00" + vid, "")
            if idx >= 0:
                pdrow[idx] = 1
        self.pd_present[i] = pdrow

    LABELS_LOG_MAX = 1024

    def _write_label_row(self, i: int, labels: Dict[str, str]) -> None:
        lbl = np.zeros(self.labels.shape[1], dtype=np.int8)
        for k, v in labels.items():
            idx = self.label_vocab.get(k, v)
            if idx >= 0:
                lbl[idx] = 1
        if not np.array_equal(self.labels[i], lbl):
            changed = np.nonzero(self.labels[i] != lbl)[0]
            self.labels_gen += 1
            self._labels_log.append((self.labels_gen, i, changed))
            if len(self._labels_log) >= 2 * self.LABELS_LOG_MAX:
                del self._labels_log[:len(self._labels_log)
                                     - self.LABELS_LOG_MAX]
            # splice row i's entries of the index, O(nnz)
            self._label_col_nodes[changed] += \
                lbl[changed].astype(np.int64) - self.labels[i, changed]
            new = np.nonzero(lbl)[0]
            rows, cols = self._label_nz_rows, self._label_nz_cols
            lo, hi = np.searchsorted(rows, (i, i + 1))
            self._label_nz_rows = np.concatenate(
                (rows[:lo], np.full(new.size, i, dtype=np.int64), rows[hi:]))
            self._label_nz_cols = np.concatenate((cols[:lo], new, cols[hi:]))
        self.labels[i] = lbl

    def label_nonzeros(self) -> Tuple[np.ndarray, np.ndarray]:
        """The label matrix's nonzeros as (row, col) int64 arrays in
        row-major order: np.nonzero(labels), read off the kept index."""
        return self._label_nz_rows, self._label_nz_cols

    def labels_rows_since(self, gen: int) -> Optional[List[tuple]]:
        """(row, changed_columns) entries after `gen` (rows may repeat),
        or None when the bounded ring no longer covers the gap (the
        consumer must rebuild its label-derived views). The changed-column
        sets let a consumer decide PER TERM whether a relabel touched the
        columns its baked domains resolve through — a zone flip must not
        rebuild views whose terms key on hostname columns.
        Generations are consecutive integers, so coverage is a length
        check."""
        behind = self.labels_gen - gen
        if behind <= 0:
            return []
        if behind > len(self._labels_log):
            return None
        return [(i, cols) for _g, i, cols in
                self._labels_log[len(self._labels_log) - behind:]]

    def _write_ports_row(self, i: int, info: NodeInfo) -> None:
        if info.used_ports:
            bm = np.zeros(PORT_WORDS, dtype=np.uint32)
            for port in info.used_ports:
                if 0 < port < PORT_SPACE:
                    bm[port // 32] |= np.uint32(1 << (port % 32))
            self.port_bitmap[i] = bm
        else:
            # port-less node (the common case at scale): one memset instead
            # of allocating + copying an 8KB row per node
            self.port_bitmap[i].fill(0)
        self.dirty.add("port_bitmap")
        self._port_words_used = None

    def port_words_used(self) -> int:
        """Highest port-bitmap word in use across all nodes, plus one — the
        engine uploads only [:, :W] of the (otherwise 8KB/node, mostly-zero)
        bitmap. Recomputed lazily when any ports row changed."""
        cached = getattr(self, "_port_words_used", None)
        if cached is None:
            if getattr(self, "port_bitmap", None) is None \
                    or not self.port_bitmap.any():
                cached = 0
            else:
                cached = int(np.nonzero(self.port_bitmap.any(axis=0))[0][-1]) + 1
            self._port_words_used = cached
        return cached

    def domain_node_counts(self) -> np.ndarray:
        """Nodes per interned topology DOMAIN (label-pair column): int64 [L]
        over the current label matrix. The wave engine's affinity
        classification (ops/affinity.py) keys on this: a column on
        at most ONE node (the hostname shape) makes per-node conflict
        resolution exactly domain-granular, so required-anti classes over
        singleton-domain keys ride the per-wave mask instead of the strict
        tail. Column indices are PREFIX-STABLE across vocab growth (Vocab
        appends, finalize_labels rebuilds content but never reorders), which
        is also what lets the harvest fence slice live arrays down to an
        older encoding's width. Read off the kept index: O(L), not a sum
        over the N x L cells."""
        if getattr(self, "labels", None) is None:
            return np.zeros(0, dtype=np.int64)
        return self._label_col_nodes.copy()

    def _rebuild_label_index(self, infos: Dict[str, NodeInfo],
                             names: List[str]) -> None:
        idx: Dict[str, set] = {}
        for nm in names:
            node = infos[nm].node
            if node is None:
                continue
            for k, v in node.labels.items():
                idx.setdefault(k, set()).add(v)
        self._label_index = idx


# ---------------------------------------------------------------------------
# Pod batch tensorization
# ---------------------------------------------------------------------------

MAX_PORTS_PER_POD = 8


def compile_requirements(match_expressions, snap: ClusterSnapshot):
    """Compile a list of ANDed SelectorRequirements against the snapshot's
    demand-driven label vocab -> (req_all, any_groups, forbid, unsat).
    Semantics per NodeSelectorRequirementsAsSelector + labels.Selector.Matches
    (predicates.go:625-647): In -> pair membership, Exists/Gt/Lt -> expansion
    over the values present on nodes, NotIn/DoesNotExist -> forbidden pairs
    (absent key matches)."""
    req_all: List[int] = []
    any_groups: List[List[int]] = []
    forbid: List[int] = []
    unsat = not match_expressions
    for r in match_expressions:
        op = SelectorOperator(r.operator)
        if op == SelectorOperator.IN:
            # intern every referenced pair; a pair no node carries is an
            # all-zero column, so matching fails naturally
            idxs = [snap.ensure_label_pair(r.key, v) for v in r.values]
            if not idxs:
                unsat = True
            elif len(idxs) == 1:
                req_all.append(idxs[0])
            else:
                any_groups.append(idxs)
        elif op == SelectorOperator.EXISTS:
            vals = snap.node_values_for_key(r.key)
            if not vals:
                unsat = True  # no node has the key at snapshot time
            else:
                any_groups.append(
                    [snap.ensure_label_pair(r.key, v) for v in vals])
        elif op == SelectorOperator.DOES_NOT_EXIST:
            forbid.extend(snap.ensure_label_pair(r.key, v)
                          for v in snap.node_values_for_key(r.key))
        elif op == SelectorOperator.NOT_IN:
            vals = set(snap.node_values_for_key(r.key))
            forbid.extend(snap.ensure_label_pair(r.key, v)
                          for v in r.values if v in vals)
        elif op in (SelectorOperator.GT, SelectorOperator.LT):
            try:
                rhs = int(r.values[0]) if r.values else None
            except ValueError:
                rhs = None
            if rhs is None:
                unsat = True
            else:
                idxs = []
                for val in snap.node_values_for_key(r.key):
                    try:
                        lhs = int(val)
                    except ValueError:
                        continue
                    if (lhs > rhs) if op == SelectorOperator.GT else (lhs < rhs):
                        idxs.append(snap.ensure_label_pair(r.key, val))
                if not idxs:
                    unsat = True
                else:
                    any_groups.append(idxs)
    return (req_all, any_groups, forbid, unsat)


class PodBatch:
    """Dense encoding of a list of pending pods against a snapshot's vocabs.

    Selector compilation (node_selector + required node affinity): each pod
    gets up to T disjuncts (OR of ANDed terms — predicates.go:625
    nodeMatchesNodeSelectorTerms). Each disjunct is compiled to:
      req_all  [T, L]  pairs that must ALL be present (match_labels / In-1)
      req_any  [T, A, L]  groups where >=1 pair must be present
                          (In-many / Exists / Gt / Lt via vocab expansion)
      forbid   [T, L]  pairs that must NOT be present (NotIn / DoesNotExist)
      term_valid [T]   real term (False rows auto-fail so OR ignores them)
    An UNSATISFIABLE requirement (e.g. In with values absent from the vocab)
    makes the term auto-fail via a sentinel in req_any counts.

    Pods whose node_selector/affinity is empty get sel_any_term=False and
    match all nodes, matching podMatchesNodeLabels (predicates.go:640-647).
    """

    def __init__(self, pods: Sequence[Pod], snap: ClusterSnapshot,
                 max_terms: int = 4, max_any: int = 2, max_pref: int = 8):
        self.pods = list(pods)
        P = len(self.pods)
        if snap._shape_sig is None:
            raise RuntimeError("ClusterSnapshot.refresh() must run before PodBatch")
        T = snap.taints_sched.shape[1]
        Rr = snap.num_resources
        self.req = np.zeros((P, Rr), dtype=np.int32)
        self.nonzero = np.zeros((P, 2), dtype=np.int32)
        self.zero_req = np.zeros(P, dtype=bool)
        # pod requests an extended resource NO node advertises -> can never
        # fit anywhere (alloc 0 < request on every node)
        self.impossible = np.zeros(P, dtype=bool)
        self.best_effort = np.zeros(P, dtype=bool)
        self.ports = np.full((P, MAX_PORTS_PER_POD), -1, dtype=np.int32)
        self.intolerated = np.ones((P, T), dtype=np.int8)  # sched-taints NOT tolerated
        self.intolerated_pref = np.ones((P, T), dtype=np.int8)
        self.host_required = np.full(P, -1, dtype=np.int32)  # PodFitsHost node idx
        self.has_host = np.zeros(P, dtype=bool)
        self.needs_host_check = np.zeros(P, dtype=bool)
        # which host-check causes are NOT derivable from node labels alone
        # (live-NodeInfo ports, score-affecting preference overflow) — the
        # wave path can absorb the label-pure remainder as a static fit
        # column (host_static_fit) but these must stay on the exact oracle
        self.host_check_dynamic = np.zeros(P, dtype=bool)

        # selector structures — sized by actual usage, min 1 term. Compiling
        # interns referenced label pairs into the snapshot's demand-driven
        # vocab, so the label matrix is finalized only afterwards.
        n_terms = 1
        n_any = 1
        n_pref = 1
        compiled = []
        pref_compiled = []
        for pod in self.pods:
            terms = self._compile_selector(pod, snap)
            compiled.append(terms)
            n_terms = max(n_terms, len(terms))
            for t in terms:
                n_any = max(n_any, len(t[1]))
            prefs = self._compile_preferred(pod, snap)
            pref_compiled.append(prefs)
            n_pref = max(n_pref, len(prefs))
            for _, comp in prefs:
                if comp is not None:
                    n_any = max(n_any, len(comp[1]))
            for c in pod.containers:
                if c.image:
                    snap.ensure_image(c.image)
        # volume compilation: interns conflict/PD keys and (for VolumeZone)
        # zone label pairs / (for VolumeNode) PV-affinity pairs into the
        # demand-driven vocabs BEFORE the matrices are finalized
        from kubernetes_tpu_torch.utils import features as featmod
        vol_node_on = featmod.enabled("PersistentLocalVolumes")
        vol_compiled = []
        for p, pod in enumerate(self.pods):
            if not pod.volumes:
                vol_compiled.append(None)
                continue
            entry = {"err": False, "zone_err": False, "conf": [], "pd": [],
                     "zone": [], "pvaff": None}
            for key, ro in volmod.pod_conflict_keys(pod):
                entry["conf"].append((snap.ensure_conflict_key(key), ro))
            for k, vid in volmod.pd_filter_ids(pod, snap.volume_ctx):
                entry["pd"].append((k, snap.ensure_pd_id(k, vid)))
            try:
                for zk, zv in volmod.zone_constraints(pod, snap.volume_ctx):
                    if zv == "":
                        # node missing the key passes in the reference
                        # ("" == ""); exact host path handles this rarity
                        self.needs_host_check[p] = True
                        continue
                    entry["zone"].append(snap.ensure_label_pair(zk, zv))
            except volmod.UnresolvedVolume:
                # VolumeZone errors AFTER its no-zone-labels fast-path
                # (predicates.go:425-430): fails zone-labeled nodes only
                entry["zone_err"] = True
            if vol_node_on:
                try:
                    reqs = volmod.pv_affinity_requirements(pod, snap.volume_ctx)
                    if reqs:
                        comp = compile_requirements(reqs, snap)
                        entry["pvaff"] = comp
                        n_any = max(n_any, len(comp[1]))
                except volmod.UnresolvedVolume:
                    # VolumeNode errors unconditionally -> schedule fails
                    entry["err"] = True
            vol_compiled.append(entry)
        n_terms = min(n_terms, max_terms)
        n_any = min(n_any, max_any)
        n_pref = min(n_pref, max_pref)
        L = snap.finalize_labels()
        I = snap.finalize_images()
        Vc, Vpd = snap.finalize_volumes()
        self.sel_req_all = np.zeros((P, n_terms, L), dtype=np.int8)
        self.sel_req_any = np.zeros((P, n_terms, n_any, L), dtype=np.int8)
        self.sel_forbid = np.zeros((P, n_terms, L), dtype=np.int8)
        self.sel_term_valid = np.zeros((P, n_terms), dtype=bool)
        self.sel_any_used = np.zeros((P, n_terms, n_any), dtype=bool)
        self.sel_unsat = np.zeros((P, n_terms), dtype=bool)
        self.has_selector = np.zeros(P, dtype=bool)
        # preferred node-affinity terms (NodeAffinityPriority,
        # node_affinity.go:36-77): weight + compiled selector per term; a term
        # with no expressions matches ALL nodes (pref_empty)
        self.pref_req_all = np.zeros((P, n_pref, L), dtype=np.int8)
        self.pref_req_any = np.zeros((P, n_pref, n_any, L), dtype=np.int8)
        self.pref_forbid = np.zeros((P, n_pref, L), dtype=np.int8)
        self.pref_any_used = np.zeros((P, n_pref, n_any), dtype=bool)
        self.pref_valid = np.zeros((P, n_pref), dtype=bool)
        self.pref_unsat = np.zeros((P, n_pref), dtype=bool)
        self.pref_empty = np.zeros((P, n_pref), dtype=bool)
        self.pref_weight = np.zeros((P, n_pref), dtype=np.int32)
        # NodePreferAvoidPods: index into the avoid vocab, -1 = not RC/RS-owned
        self.avoid_idx = np.full(P, -1, dtype=np.int32)
        # ImageLocality: per-image container counts
        self.img_count = np.zeros((P, I), dtype=np.int32)
        # volume predicates: NoDiskConflict hard (conflicts with any
        # presence) / ro (conflicts with read-write presence) key rows,
        # MaxPDVolumeCount id rows + per-kind distinct counts, VolumeZone
        # required label pairs, VolumeNode compiled PV affinity (one conjunct
        # — PV terms are ANDed, util.go:202)
        self.vol_hard = np.zeros((P, Vc), dtype=np.int8)
        self.vol_ro = np.zeros((P, Vc), dtype=np.int8)
        self.pd_req = np.zeros((P, Vpd), dtype=np.int8)
        self.pd_req_count = np.zeros((P, 3), dtype=np.int32)
        self.vz_req = np.zeros((P, L), dtype=np.int8)
        self.vz_err = np.zeros(P, dtype=bool)
        self.pvaff_req_all = np.zeros((P, L), dtype=np.int8)
        self.pvaff_req_any = np.zeros((P, n_any, L), dtype=np.int8)
        self.pvaff_forbid = np.zeros((P, L), dtype=np.int8)
        self.pvaff_any_used = np.zeros((P, n_any), dtype=bool)
        self.pvaff_unsat = np.zeros(P, dtype=bool)
        self.pvaff_has = np.zeros(P, dtype=bool)

        for p, pod in enumerate(self.pods):
            self._encode_pod(p, pod, snap, compiled[p], n_terms, n_any)
            self._encode_pref(p, pod, snap, pref_compiled[p], n_pref, n_any)
            if pod.owner_kind in ("ReplicationController", "ReplicaSet"):
                self.avoid_idx[p] = snap.avoid_vocab.get(pod.owner_kind,
                                                         pod.owner_uid)
            for c in pod.containers:
                if c.image:
                    idx = snap.image_vocab.get(c.image, "")
                    if idx >= 0:
                        self.img_count[p, idx] += 1
            self._encode_volumes(p, vol_compiled[p], n_any)

    # -------------------------------------------------------------- helpers

    def _compile_selector(self, pod: Pod, snap: ClusterSnapshot):
        """-> list of (req_all_idx, [any_idx_groups], forbid_idx, unsat)."""
        terms: List[NodeSelectorTerm] = []
        simple: List[SelectorRequirement] = [
            SelectorRequirement(k, SelectorOperator.IN, [v])
            for k, v in sorted(pod.node_selector.items())
        ]
        na = pod.affinity.node_affinity if pod.affinity else None
        if na is not None and na.required_terms is not None:
            # affinity terms are ORed with each other but ANDed with the
            # plain node_selector (predicates.go:640 "requirements in both")
            for t in na.required_terms:
                terms.append(NodeSelectorTerm(simple + list(t.match_expressions)))
            if not na.required_terms:
                # empty term list matches no nodes (predicates.go:646 case 2-3)
                terms = [NodeSelectorTerm([SelectorRequirement(
                    "\x00unsat", SelectorOperator.IN, [])])]
        elif simple:
            terms = [NodeSelectorTerm(simple)]
        return [compile_requirements(term.match_expressions, snap)
                for term in terms]

    def _compile_preferred(self, pod: Pod, snap: ClusterSnapshot):
        """-> [(weight, compiled-or-None)] for preferred node-affinity terms;
        None = empty term (matches every node, node_affinity.go:51)."""
        na = pod.affinity.node_affinity if pod.affinity else None
        out = []
        for weight, term in (na.preferred_terms if na else []):
            if weight == 0:
                continue  # node_affinity.go:57
            if not term.match_expressions:
                out.append((weight, None))
            else:
                out.append((weight,
                            compile_requirements(term.match_expressions, snap)))
        return out

    def _encode_pod(self, p: int, pod: Pod, snap: ClusterSnapshot, terms,
                    n_terms: int, n_any: int) -> None:
        req = pod.resource_request()
        unknown: List[str] = []
        self.req[p] = snap.resource_row(
            milli_cpu=req.milli_cpu, memory=req.memory, gpu=req.nvidia_gpu,
            scratch=req.storage_scratch, overlay=req.storage_overlay,
            extended=req.extended, up=True, width=snap.num_resources,
            unknown=unknown)
        if unknown:
            self.impossible[p] = True
        ncpu, nmem = pod.nonzero_request()
        self.nonzero[p, 0] = ncpu
        self.nonzero[p, 1] = snap.quant_mem(nmem, up=True)
        # PodFitsResources early-exit: all-zero request only checks pod count
        # (predicates.go:576-578)
        self.zero_req[p] = (
            req.milli_cpu == 0 and req.memory == 0 and req.nvidia_gpu == 0
            and req.storage_scratch == 0 and req.storage_overlay == 0
            and not req.extended)
        self.best_effort[p] = pod.is_best_effort()

        for j, port in enumerate(pod.used_ports()[:MAX_PORTS_PER_POD]):
            self.ports[p, j] = port
        if len(pod.used_ports()) > MAX_PORTS_PER_POD:
            self.needs_host_check[p] = True
            self.host_check_dynamic[p] = True  # HostPorts needs live pods

        if pod.node_name:
            self.has_host[p] = True
            self.host_required[p] = snap.node_index.get(pod.node_name, -1)

        # inter-pod affinity no longer forces the host path: the topology-
        # incidence kernel (ops/affinity.py) evaluates it in the placement
        # scan; only term-slot overflow routes to the oracle (the engine
        # marks those classes from AffinityData.overflow)

        # tolerations -> which vocab taints remain INtolerated
        for t_idx, (tkey, tpack) in enumerate(snap.taint_vocab.items()):
            tval, _, teff = tpack.partition("\x00")
            taint = Taint(tkey, tval, TaintEffect(teff))
            tolerated = any(tol.tolerates(taint) for tol in pod.tolerations)
            if tolerated:
                self.intolerated[p, t_idx] = 0
                self.intolerated_pref[p, t_idx] = 0
        # PodToleratesNodeTaints only filters NoSchedule|NoExecute
        # (predicates.go:1241-1246); PreferNoSchedule feeds the
        # TaintToleration priority instead (taint_toleration.go).

        if len(terms) > n_terms:
            # too many OR terms for the static shape — over-approximate
            # (pass-all) and verify exactly host-side
            self.needs_host_check[p] = True
            terms = []
        for t, (req_all, any_groups, forbid, unsat) in enumerate(terms):
            self.sel_term_valid[p, t] = True
            self.has_selector[p] = True
            if len(any_groups) > n_any:
                self.needs_host_check[p] = True
                any_groups = []
            if unsat:
                self.sel_unsat[p, t] = True
            for i in req_all:
                self.sel_req_all[p, t, i] = 1
            for i in forbid:
                self.sel_forbid[p, t, i] = 1
            for a, group in enumerate(any_groups):
                self.sel_any_used[p, t, a] = True
                for i in group:
                    self.sel_req_any[p, t, a, i] = 1

    def _encode_volumes(self, p: int, entry, n_any: int) -> None:
        if entry is None:
            return
        if entry["err"]:
            # UnresolvedVolume from VolumeNode: predicate error fails the
            # whole schedule attempt for this pod -> unplaceable this round
            self.impossible[p] = True
            return
        if entry["zone_err"]:
            self.vz_err[p] = True
        for idx, ro in entry["conf"]:
            if ro:
                self.vol_ro[p, idx] = 1
            else:
                self.vol_hard[p, idx] = 1
        seen = [set(), set(), set()]
        for k, idx in entry["pd"]:
            self.pd_req[p, idx] = 1
            seen[k].add(idx)
        self.pd_req_count[p] = [len(s) for s in seen]
        for idx in entry["zone"]:
            self.vz_req[p, idx] = 1
        comp = entry["pvaff"]
        if comp is not None:
            req_all, any_groups, forbid, unsat = comp
            self.pvaff_has[p] = True
            if len(any_groups) > n_any:
                self.needs_host_check[p] = True
                any_groups = []
            if unsat:
                self.pvaff_unsat[p] = True
            for i in req_all:
                self.pvaff_req_all[p, i] = 1
            for i in forbid:
                self.pvaff_forbid[p, i] = 1
            for a, group in enumerate(any_groups):
                self.pvaff_any_used[p, a] = True
                for i in group:
                    self.pvaff_req_any[p, a, i] = 1

    def _encode_pref(self, p: int, pod: Pod, snap: ClusterSnapshot, prefs,
                     n_pref: int, n_any: int) -> None:
        if len(prefs) > n_pref:
            # too many preferred terms for static shape: host-exact path
            self.needs_host_check[p] = True
            # score-affecting — a fit column can't express the missing
            # preference weights, so no static-column absorption
            self.host_check_dynamic[p] = True
            prefs = prefs[:0]
        for t, (weight, comp) in enumerate(prefs):
            self.pref_valid[p, t] = True
            self.pref_weight[p, t] = weight
            if comp is None:
                self.pref_empty[p, t] = True
                continue
            req_all, any_groups, forbid, unsat = comp
            if len(any_groups) > n_any:
                self.needs_host_check[p] = True
                self.host_check_dynamic[p] = True  # score-affecting
                any_groups = []
            if unsat:
                self.pref_unsat[p, t] = True
            for i in req_all:
                self.pref_req_all[p, t, i] = 1
            for i in forbid:
                self.pref_forbid[p, t, i] = 1
            for a, group in enumerate(any_groups):
                self.pref_any_used[p, t, a] = True
                for i in group:
                    self.pref_req_any[p, t, a, i] = 1

    def host_static_fit(self, p: int, snap: ClusterSnapshot):
        """Exact label-pure host-fit row [n_pad] for pod p over the
        snapshot's raw per-node label maps — the static
        column a host-check class rides the wave with instead of
        flushing the pipeline. Evaluates the FULL predicates the fused
        eval over-approximated (selector shape overflow, VolumeZone
        ""-valued constraints, PV-affinity any-group overflow) straight
        from the reference semantics (oracle.pod_matches_node_selector,
        volumes.node_zone_check, NoVolumeNodeConflict), so ANDing it
        with the device's superset column yields the exact predicate.

        Returns None when the pod's host requirement is NOT derivable
        from labels alone (live-NodeInfo ports, score-affecting pref
        overflow, unresolvable PVs) — the caller must keep that class
        on the exact harvest-tail path. Padding rows are left True;
        the validity mask excludes them downstream.
        """
        if self.host_check_dynamic[p]:
            return None
        from kubernetes_tpu_torch.utils import features as featmod
        pod = self.pods[p]
        zcons = None
        pv_reqs = ()
        if pod.volumes:
            try:
                zcons = volmod.zone_constraints(pod, snap.volume_ctx)
            except volmod.UnresolvedVolume:
                zcons = None  # vz_err: the device column handles it exactly
            if featmod.enabled("PersistentLocalVolumes"):
                try:
                    pv_reqs = volmod.pv_affinity_requirements(
                        pod, snap.volume_ctx)
                except volmod.UnresolvedVolume:
                    return None  # reference fails the attempt: exact path
        na = pod.affinity.node_affinity if pod.affinity else None
        fit = np.ones(snap.valid.shape[0], dtype=bool)
        for i in range(len(snap.node_names)):
            labels = snap._row_labels[i]
            ok = True
            for k, v in pod.node_selector.items():
                if labels.get(k) != v:
                    ok = False
                    break
            if ok and na is not None and na.required_terms is not None:
                # ORed terms; empty list matches nothing
                ok = any(t.matches_labels(labels)
                         for t in na.required_terms)
            if ok and zcons:
                node_zone = {k: v for k, v in labels.items()
                             if k in (volmod.ZONE_LABEL,
                                      volmod.REGION_LABEL)}
                for k, v in (node_zone and zcons or ()):
                    if node_zone.get(k, "") != v:
                        ok = False
                        break
            if ok and pv_reqs:
                ok = all(r.matches_labels(labels) for r in pv_reqs)
            fit[i] = ok
        return fit

    def __len__(self) -> int:
        return len(self.pods)
