"""Inter-pod affinity + selector spreading as device tensor ops (PyTorch
port of kubernetes_tpu/ops/affinity.py).

The two reference algorithms the round-1 build left on the host path
re-designed as topology-incidence tensor ops:

  InterPodAffinityMatches   predicates.go:982-1146 (+ symmetry check
                            satisfiesExistingPodsAntiAffinity :1146,
                            self-match bootstrap :1210-1230)
  CalculateInterPodAffinityPriority  interpod_affinity.go:119-240
  CalculateSpreadPriority   selector_spreading.go:98-185 (2/3 zone blend)

Design (SURVEY.md §7 step 2): a topology DOMAIN is a (label-key, label-value)
pair — exactly the snapshot's label-pair vocabulary — so "node n is in
domain d" is the existing multi-hot labels[N, L] matrix, and "pod x shares a
topology with pod y under key k" becomes vector algebra over L:

  - static side (existing cluster pods): each pending CLASS gets per-term
    ALLOWED-domain vectors (required affinity), a FORBIDDEN-domain vector
    (own required anti-affinity + the symmetry check against existing pods'
    required anti-affinity terms), and a signed WEIGHT-per-domain vector
    (the priority). All are [·, L]; hitting them against labels[N, L] is one
    incidence product for the whole batch (the CUDA kernel
    ops/kernels.incidence_matmul on the card).

  - dynamic side (pods committed earlier in the SAME batch — the reference
    sees these because scheduleOne is sequential): the placement scan
    carries per-class domain occupancy commdom[C, L] (how many committed
    class-d pods sit in domain l) plus committed[C, N] / comm_cnt[C].
    Class-to-class term matching m_aff/m_anti/mp/mq is precomputed host-side
    (class keys cover namespace+labels, so class-level matching is exact),
    and each scan step contracts occupancy with the key-masked match
    matrices to reproduce, bit-for-bit, what the sequential reference would
    have seen.

Integer semantics: priority counts are integer sums (term weights are ints),
so the 0..10 normalization int(MAX*(c-min)/(max-min)) is computed in exact
integer floor division — equal to the reference's float64 truncation for
every reachable input (quotients are rationals with denominator >= 1e-9
away from integers unless exact). SelectorSpread's zone blend is defined
here as the EXACT rational floor((10(M-c)/M + 2*10(Mz-zc)/Mz) / 3) over
int32 — a deliberate, documented deviation from the reference's float64
arithmetic on its rounding crumbs (see spread_score), which frees the
whole engine from jax.enable_x64.

Slot limits: classes with more required/preferred terms than the static slot
shapes fall back to the exact host path (PodBatch.needs_host_check), like
every other over-approximation in the snapshot layer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.api.types import MAX_PRIORITY, Node, Pod
from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.ops.predicates import int_matmul
from kubernetes_tpu_torch.ops.oracle_ext import (
    ZONE_LABEL,
    ZONE_REGION_LABEL,
    _own_terms,
    term_matches_pod,
)

Arrays = Dict[str, torch.Tensor]

# static slot shapes (power-of-2-ish; overflow -> host path)
S_REQ_AFF = 4   # own required affinity terms
S_REQ_ANTI = 4  # own required anti-affinity terms
S_PREF = 8      # own preferred (anti-)affinity terms
S_OUT = 8       # outgoing terms of a class (hard-aff + preferred) that
                # score against OTHER pending classes once committed


def _pref_terms(pod: Pod) -> List[Tuple[int, object, bool]]:
    """(weight, term, is_anti) for the pod's preferred terms."""
    out = []
    if pod.affinity is not None:
        if pod.affinity.pod_affinity is not None:
            for w, t in pod.affinity.pod_affinity.preferred_terms:
                out.append((w, t, False))
        if pod.affinity.pod_anti_affinity is not None:
            for w, t in pod.affinity.pod_anti_affinity.preferred_terms:
                out.append((w, t, True))
    return out


def _out_terms(pod: Pod, hard_weight: int) -> List[Tuple[int, object]]:
    """Signed (weight, term) list of a pod's terms that contribute score to
    OTHER pods once this pod is placed (interpod_affinity.go:161-205: the
    existing pod's required affinity at hardPodAffinityWeight, preferred
    affinity at +w, preferred anti-affinity at -w)."""
    out = []
    if pod.affinity is not None:
        pa = pod.affinity.pod_affinity
        if pa is not None:
            if hard_weight > 0:
                for t in pa.required_terms:
                    out.append((hard_weight, t))
            for w, t in pa.preferred_terms:
                out.append((w, t))
        paa = pod.affinity.pod_anti_affinity
        if paa is not None:
            for w, t in paa.preferred_terms:
                out.append((-w, t))
    return out


def _has_affinity(pod: Pod) -> bool:
    return pod.has_pod_affinity()


def spec_overflow(pod: Pod, hard_weight: int) -> bool:
    """True iff this pod's term counts exceed the static slot shapes — the
    spec-only precondition of ``AffinityData.overflow`` (domain-independent:
    no cluster state consulted). Callers use it to bail to the classic path
    BEFORE paying collect_pod_pairs/intern/ClassBatch/AffinityData for a
    chunk whose verdict is already known to be overflow."""
    return (len(_own_terms(pod, anti=False)) > S_REQ_AFF
            or len(_own_terms(pod, anti=True)) > S_REQ_ANTI
            or len(_pref_terms(pod)) > S_PREF
            or len(_out_terms(pod, hard_weight)) > S_OUT)


def _term_topology_keys(pod: Pod) -> List[str]:
    """Every topology key any (anti-)affinity term of `pod` references."""
    keys = []
    a = pod.affinity
    if a is None:
        return keys
    for pa in (a.pod_affinity, a.pod_anti_affinity):
        if pa is None:
            continue
        for t in pa.required_terms:
            if t.topology_key:
                keys.append(t.topology_key)
        for _w, t in pa.preferred_terms:
            if t.topology_key:
                keys.append(t.topology_key)
    return keys


def collect_pod_pairs(infos) -> Tuple[list, list]:
    """(all_pairs, aff_pairs): every bound pod with its node, and the
    pods-with-affinity subset (node_info.go PodsWithAffinity). The single
    source for both the engine's and the extender's AffinityData inputs."""
    all_pairs, aff_pairs = [], []
    for info in infos.values():
        for q in info.pods:
            all_pairs.append((q, info.node))
        for q in info.pods_with_affinity:
            aff_pairs.append((q, info.node))
    return all_pairs, aff_pairs


def intern_topology_pairs(snap, pending_pods: Sequence[Pod],
                          aff_pods) -> None:
    """Intern every (topology_key, node_value) pair reachable from ANY
    affinity term — the pending pods' own terms AND the existing
    pods_with_affinity terms (the symmetry + priority side).

    The snapshot's label vocab is demand-driven by pod SELECTORS
    (snapshot.py compile_requirements); a topology key referenced only by an
    affinity term would otherwise have no domain columns, making
    AffinityData.domain_id silently return -1 and the constraint evaporate —
    a symmetry-violation bug (ref semantics: predicates.go:1146
    satisfiesExistingPodsAntiAffinity must hold for every placement).
    Must run after ClusterSnapshot.refresh() (needs the node label index)
    and before PodBatch/ClassBatch construction (which finalizes the label
    matrix)."""
    keys = set()
    for pod in pending_pods:
        keys.update(_term_topology_keys(pod))
    for pod, _node in aff_pods:
        keys.update(_term_topology_keys(pod))
    for key in keys:
        for v in snap.node_values_for_key(key):
            snap.ensure_label_pair(key, v)


class AffinityData:
    """Host-side builder of the class-level device arrays.

    reps        class representative pods (real classes, unpadded)
    snap        ClusterSnapshot (label vocab + node order must be current)
    all_pods    [(pod, node)] every bound pod with its node
    aff_pods    subset carrying pod (anti-)affinity (PodsWithAffinity list)
    workloads   Service/RC/RS/StatefulSet selector objects
    c_pad       padded class-axis size (engine's bucketed class count)
    """

    def __init__(self, reps: Sequence[Pod], snap, all_pods, aff_pods,
                 workloads: Sequence = (), hard_weight: int = 1,
                 c_pad: Optional[int] = None):
        C0 = len(reps)
        C = c_pad if c_pad is not None else C0
        assert C >= C0
        L = snap.labels.shape[1]
        N = snap.labels.shape[0]
        vocab = snap.label_vocab
        self.num_classes = C0

        self.fail_all = np.zeros(C, dtype=bool)
        self.overflow = np.zeros(C, dtype=bool)
        self.forbid_static = np.zeros((C, L), dtype=np.int8)
        self.aff_active = np.zeros((C, S_REQ_AFF), dtype=bool)
        self.aff_allow = np.zeros((C, S_REQ_AFF, L), dtype=np.int8)
        self.aff_has_static = np.zeros((C, S_REQ_AFF), dtype=bool)
        self.aff_self = np.zeros((C, S_REQ_AFF), dtype=bool)
        self.aff_keymask = np.zeros((C, S_REQ_AFF, L), dtype=np.int8)
        self.anti_active = np.zeros((C, S_REQ_ANTI), dtype=bool)
        self.anti_keymask = np.zeros((C, S_REQ_ANTI, L), dtype=np.int8)
        self.m_aff = np.zeros((C, S_REQ_AFF, C), dtype=np.int8)
        self.m_anti = np.zeros((C, S_REQ_ANTI, C), dtype=np.int8)

        self.prio_static = np.zeros((C, L), dtype=np.int32)
        self.p_w = np.zeros((C, S_PREF), dtype=np.int32)
        self.p_keymask = np.zeros((C, S_PREF, L), dtype=np.int8)
        self.mp = np.zeros((C, S_PREF, C), dtype=np.int8)
        self.q_w = np.zeros((C, S_OUT), dtype=np.int32)
        self.q_keymask = np.zeros((C, S_OUT, L), dtype=np.int8)
        self.mq = np.zeros((C, S_OUT, C), dtype=np.int8)

        self.sp_static = np.zeros((C, N), dtype=np.int32)
        self.sp_cls = np.zeros((C, C), dtype=np.int8)
        self.sp_has = np.zeros(C, dtype=bool)

        def keymask(key: str) -> np.ndarray:
            m = np.zeros(L, dtype=np.int8)
            for idx in vocab.by_key.get(key, []):
                if idx < L:
                    m[idx] = 1
            return m

        def domain_id(node: Optional[Node], key: str) -> int:
            if node is None or not key:
                return -1
            val = node.labels.get(key)
            if val is None:
                return -1
            return vocab.get(key, val)

        # ---------------- fits side -------------------------------------
        any_required = False
        for c, rep in enumerate(reps):
            own_aff = _own_terms(rep, anti=False)
            own_anti = _own_terms(rep, anti=True)
            if len(own_aff) > S_REQ_AFF or len(own_anti) > S_REQ_ANTI:
                self.overflow[c] = True
                continue
            if own_aff or own_anti:
                any_required = True
            for s, term in enumerate(own_aff):
                if not term.topology_key:
                    self.fail_all[c] = True  # predicates.go:1015
                    continue
                self.aff_active[c, s] = True
                self.aff_keymask[c, s] = keymask(term.topology_key)
                self.aff_self[c, s] = term_matches_pod(term, rep, rep)
                for existing, enode in all_pods:
                    if term_matches_pod(term, rep, existing):
                        self.aff_has_static[c, s] = True
                        d = domain_id(enode, term.topology_key)
                        if d >= 0:
                            self.aff_allow[c, s, d] = 1
                for d2, rep2 in enumerate(reps):
                    if term_matches_pod(term, rep, rep2):
                        self.m_aff[c, s, d2] = 1
            for a, term in enumerate(own_anti):
                if not term.topology_key:
                    self.fail_all[c] = True
                    continue
                self.anti_active[c, a] = True
                self.anti_keymask[c, a] = keymask(term.topology_key)
                for existing, enode in all_pods:
                    if term_matches_pod(term, rep, existing):
                        d = domain_id(enode, term.topology_key)
                        if d >= 0:
                            self.forbid_static[c, d] = 1
                for d2, rep2 in enumerate(reps):
                    if term_matches_pod(term, rep, rep2):
                        self.m_anti[c, a, d2] = 1
            # symmetry: existing pods' required anti-affinity matching c
            # (metadata.go matchingAntiAffinityTerms)
            for existing, enode in aff_pods:
                for term in _own_terms(existing, anti=True):
                    if term_matches_pod(term, existing, rep):
                        any_required = True
                        if not term.topology_key:
                            self.fail_all[c] = True  # oracle: empty key fails
                            continue
                        d = domain_id(enode, term.topology_key)
                        if d >= 0:
                            self.forbid_static[c, d] = 1

        # ---------------- priority side ---------------------------------
        any_prio = False
        for c, rep in enumerate(reps):
            prefs = _pref_terms(rep)
            if len(prefs) > S_PREF:
                self.overflow[c] = True
                continue
            if prefs:
                any_prio = True
            for t, (w, term, is_anti) in enumerate(prefs):
                sw = -w if is_anti else w
                if w == 0:
                    continue
                self.p_w[c, t] = sw
                self.p_keymask[c, t] = keymask(term.topology_key)
                for existing, enode in all_pods:
                    if term_matches_pod(term, rep, existing):
                        d = domain_id(enode, term.topology_key)
                        if d >= 0:
                            self.prio_static[c, d] += sw
                for d2, rep2 in enumerate(reps):
                    if term_matches_pod(term, rep, rep2):
                        self.mp[c, t, d2] = 1
            # existing pods' terms scoring THIS class (static part)
            for existing, enode in aff_pods:
                for sw, term in _out_terms(existing, hard_weight):
                    if sw != 0 and term_matches_pod(term, existing, rep):
                        d = domain_id(enode, term.topology_key)
                        if d >= 0:
                            self.prio_static[c, d] += sw
        # committed classes' outgoing terms scoring pending classes
        for d2, rep2 in enumerate(reps):
            outs = _out_terms(rep2, hard_weight)
            if len(outs) > S_OUT:
                self.overflow[d2] = True
                continue
            for u, (sw, term) in enumerate(outs):
                if sw == 0:
                    continue
                self.q_w[d2, u] = sw
                self.q_keymask[d2, u] = keymask(term.topology_key)
                for c, rep in enumerate(reps):
                    if term_matches_pod(term, rep2, rep):
                        self.mq[d2, u, c] = 1

        # ---------------- selector spreading ----------------------------
        for c, rep in enumerate(reps):
            selectors = [w for w in workloads if w.selects(rep)]
            if not selectors:
                continue
            self.sp_has[c] = True
            name_to_col = snap.node_index
            for existing, enode in all_pods:
                if existing.namespace != rep.namespace or existing.deleted:
                    continue
                if any(w.selects(existing) for w in selectors):
                    col = name_to_col.get(enode.name if enode else "", -1)
                    if col >= 0:
                        self.sp_static[c, col] += 1
            for d2, rep2 in enumerate(reps):
                if rep2.namespace == rep.namespace \
                        and any(w.selects(rep2) for w in selectors):
                    self.sp_cls[c, d2] = 1

        # ---------------- zones (for the spread blend) ------------------
        zone_keys: Dict[str, int] = {}
        zone_id = np.full(N, -1, dtype=np.int32)
        for col, lbls in enumerate(snap._row_labels):
            region = lbls.get(ZONE_REGION_LABEL, "")
            zone = lbls.get(ZONE_LABEL, "")
            if not region and not zone:
                continue
            zk = region + ":\x00:" + zone
            zone_id[col] = zone_keys.setdefault(zk, len(zone_keys))
        ZN = max(1, len(zone_keys))
        Z = np.zeros((N, ZN), dtype=np.int8)
        for col in range(N):
            if zone_id[col] >= 0:
                Z[col, zone_id[col]] = 1
        self.Z = Z
        self.node_has_zone = zone_id >= 0

        self.fits_needed = any_required or self.fail_all.any()
        # prio_needed gates on NONZERO contributions, not mere presence of
        # affinity-carrying pods: a cluster of required-anti-only pods (no
        # preferred terms, no outgoing score terms) produces identically
        # zero InterPodAffinity counts, and tracing the whole priority side
        # through the scan for a guaranteed zero is pure per-step cost.
        # Exactness: counts can only come from prio_static (static matches),
        # p_w x own-preferred occupancy, or q_w x incoming occupancy — all
        # three all-zero forces counts == 0 and interpod_score(0) == 0.
        self.prio_needed = any_prio or bool(
            self.prio_static.any() or self.p_w.any() or self.q_w.any())
        self.spread_needed = bool(self.sp_has.any())
        # required (anti-)affinity classes must schedule sequentially (their
        # fits depend on every prior in-batch commit) -> wave mode routes
        # them to the strict scan. Classes with a nonzero STATIC forbid row
        # (an existing pod's required anti-affinity matches them — symmetry,
        # predicates.go:1146) also serialize: the wave fits path doesn't
        # evaluate affinity masks, and a plain pod forbidden from a topology
        # by a bound guard pod must not slip through the throughput path.
        self.serialize = (self.aff_active.any(axis=1)
                          | self.anti_active.any(axis=1) | self.fail_all
                          | self.forbid_static.any(axis=1))

        # ---------------- wave-path classification --------------
        # The pipelined wave engine re-evaluates required-anti constraints
        # per WAVE from [C, L] topology-occupancy counters (waves.py). That
        # is exact for a class iff:
        #   - forbidden domains only GROW as pods commit (anti occupancy and
        #     the symmetry row are monotone), so a wave-start mask is valid
        #     for every pod placed under it and "fits nowhere" is final —
        #     the same monotonicity that makes capacity verdicts exact;
        #   - within one wave, per-node conflict resolution commits a single
        #     class per node, so cross-class anti violations inside a wave
        #     need two nodes SHARING a topology domain — excluded by
        #     requiring every key on the class's required-anti surface (own
        #     terms AND incoming terms that target it) to have SINGLETON
        #     domains (each (key, value) label column on at most one node:
        #     the hostname shape);
        #   - a self-anti class additionally commits at most one pod per
        #     node per wave (wave_gate -> the `special` discipline), so its
        #     own same-node FIFO run cannot collide with itself.
        # Own required AFFINITY is never wave-safe (a bootstrapping group
        # evaluated against one frozen mask would scatter instead of
        # co-locating), nor is fail_all/overflow. Those classes keep the
        # strict scan — but as a SEEDED TAIL after the wave pass (engine
        # harvest), never silently through the throughput path.
        anti_target = self.m_anti.any(axis=(0, 1))        # [C] targeted by
        # some pending class's required anti term (symmetry side)
        relevant = (self.aff_active.any(axis=1) | self.anti_active.any(axis=1)
                    | anti_target | self.forbid_static.any(axis=1)
                    | self.fail_all)
        strict = (self.overflow | self.fail_all
                  | self.aff_active.any(axis=1))
        # singleton-domain test per label column over the CURRENT node set
        multi_col = snap.domain_node_counts() > 1                   # [L]
        term_multi = (self.anti_keymask.astype(bool)
                      & multi_col[None, None, :]).any(axis=2)       # [C, A]
        own_multi = (term_multi & self.anti_active).any(axis=1)
        in_multi = (self.m_anti.astype(bool)
                    & term_multi[:, :, None]).any(axis=(0, 1))      # [C]
        # (forbid_static needs no width gate: it is CONSTANT inside the
        # wave mask, so it is exact at any domain width — only domains that
        # GROW from in-batch commits carry the within-wave hazard)
        strict |= relevant & (own_multi | in_multi)
        self.wave_strict = relevant & strict
        iota_c = np.arange(C)
        self_anti = self.m_anti[iota_c, :, iota_c].any(axis=1)
        self.wave_gate = relevant & ~strict & self_anti
        self.wave_relevant = relevant

    _DEVICE_KEYS = ("fail_all", "forbid_static", "aff_active", "aff_allow",
                    "aff_has_static", "aff_self", "aff_keymask",
                    "anti_active", "anti_keymask", "m_aff", "m_anti",
                    "prio_static", "p_w", "p_keymask", "mp", "q_w",
                    "q_keymask", "mq", "sp_static", "sp_cls", "sp_has", "Z",
                    "node_has_zone", "wave_gate")

    def device_arrays(self, device) -> Arrays:
        """The static class arrays the device functions read, as tensors
        on ``device``: copies, through the sanitizer's frozen seam —
        nothing mutates them after __init__, and GRAFT_SANITIZE=1 seals
        the host sources to make that claim crash-enforced."""
        from kubernetes_tpu_torch.analysis.sanitize import upload_frozen
        return {k: upload_frozen(getattr(self, k), device)
                for k in self._DEVICE_KEYS}


# ---------------------------------------------------------------------------
# device functions
# ---------------------------------------------------------------------------

I32 = torch.int32


def stack_static(aff: Arrays) -> torch.Tensor:
    """The one A [C*(S+2), L] int32 of the static precompute: the allow
    terms [C*S], then the static forbids [C], then the preferred weights
    [C] (the stacking of the reference's precompute_static_fast)."""
    c, s, l = aff["aff_allow"].shape
    return torch.cat([aff["aff_allow"].reshape(c * s, l).to(I32),
                      aff["forbid_static"].to(I32),
                      aff["prio_static"].to(I32)], dim=0).contiguous()


def precompute_static(aff: Arrays, labels: torch.Tensor) -> Arrays:
    """Batch-wide static products against the node-domain incidence
    (labels int8 [N, L]) as ONE incidence product of stack_static(aff) —
    ops/kernels.incidence_matmul, the CUDA kernel on a CUDA tensor."""
    c, s, _ = aff["aff_allow"].shape
    n = labels.shape[0]
    hits = kernels.incidence_matmul(stack_static(aff),
                                    labels.to(torch.int8).contiguous())
    return {"allow_hit": hits[:c * s].reshape(c, s, n) > 0,
            "forbid_hit": hits[c * s:c * s + c] > 0,
            "prio_counts": hits[c * s + c:]}


def _occupancy(m: torch.Tensor, keymask: torch.Tensor,
               commdom: torch.Tensor) -> torch.Tensor:
    """[T, C] match rows x committed domain occupancy [C, L], masked to
    each term's topology key -> int32 [T, L]. int_matmul is exact here:
    m is 0/1, so each sum is at most the pods committed in one domain,
    which is at most the pods the cluster holds (nodes x allowed pods:
    550,000 at 5,000 x 110) < 2^24."""
    return int_matmul(m.to(I32), commdom.T) * keymask.to(I32)


def domain_hits(rows: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """int32 domain rows [M, L] x the node-domain incidence labels [N, L]
    -> int32 [M, N]: one incidence product (ops/kernels.incidence_matmul,
    the CUDA kernel on the card), exact for any int32 rows — the rows here
    carry occupancy counts and priority weights whose sums float32 would
    not hold exactly, so they never go through int_matmul."""
    return kernels.incidence_matmul(rows.to(I32).contiguous(),
                                    labels.to(torch.int8).contiguous())


def step_fits(aff: Arrays, pre: Arrays, c: int, commdom: torch.Tensor,
              comm_cnt: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """InterPodAffinity predicate for pod class c against the occupancy
    carry. [N] bool. Mirrors inter_pod_affinity_fits of the oracle. The
    three domain products (allow occupancy, own anti, symmetry) are one
    stacked incidence product."""
    active = aff["aff_active"][c]                              # [S]
    s_dim = active.shape[0]
    occ = _occupancy(aff["m_aff"][c], aff["aff_keymask"][c], commdom)
    # own anti (dynamic part; static folded into forbid_static)
    occa = _occupancy(aff["m_anti"][c], aff["anti_keymask"][c], commdom)
    # symmetry vs committed pods' required anti terms matching c:
    # sym_occ[l] = sum_{d,a} m_anti[d,a,c] * anti_keymask[d,a,l] * commdom[d,l]
    m_in = aff["m_anti"][:, :, c].to(I32)                      # [C,A]
    sym_occ = (m_in[:, :, None] * aff["anti_keymask"].to(I32)
               * commdom[:, None, :]).sum(dim=(0, 1), dtype=I32)  # [L]
    a_dim = occa.shape[0]
    hits = domain_hits(torch.cat([occ, occa, sym_occ[None]]), labels) > 0
    dyn_hit = hits[:s_dim]                                     # [S,N]
    anti_dyn = hits[s_dim:s_dim + a_dim] \
        & aff["anti_active"][c][:, None]                       # [A,N]
    sym_hit = hits[s_dim + a_dim]                              # [N]
    dyn_total = (aff["m_aff"][c].to(I32) * comm_cnt[None, :]).sum(
        dim=1, dtype=I32)                                      # [S]
    static_hit = pre["allow_hit"][c]
    has_static = aff["aff_has_static"][c]
    bootstrap = aff["aff_self"][c] & ~has_static & (dyn_total == 0)
    ok = ((~active[:, None]) | static_hit | dyn_hit
          | bootstrap[:, None]).all(dim=0)                     # [N]
    forbidden = pre["forbid_hit"][c] | anti_dyn.any(dim=0) | sym_hit
    return ok & ~forbidden & ~aff["fail_all"][c]


def step_prio_counts(aff: Arrays, pre: Arrays, c: int,
                     commdom: torch.Tensor, labels: torch.Tensor
                     ) -> torch.Tensor:
    """InterPodAffinity weighted counts for class c, [N] int32 (before the
    0..10 normalization). Own preferred terms and the committed classes'
    outgoing terms are one stacked incidence product."""
    counts = pre["prio_counts"][c]
    occp = _occupancy(aff["mp"][c], aff["p_keymask"][c], commdom)
    # committed classes' outgoing terms scoring c:
    # occq[l] = sum_{d,u} q_w[d,u] * mq[d,u,c] * q_keymask[d,u,l] * commdom[d,l]
    wq = aff["q_w"] * aff["mq"][:, :, c].to(I32)               # [C,U]
    occq = (wq[:, :, None] * aff["q_keymask"].to(I32)
            * commdom[:, None, :]).sum(dim=(0, 1), dtype=I32)  # [L]
    hits = domain_hits(torch.cat([occp, occq[None]]), labels)
    per_t = hits[:-1]                                          # [T,N]
    counts = counts + (aff["p_w"][c][:, None] * per_t).sum(dim=0, dtype=I32)
    return counts + hits[-1]


def step_fits_all(aff: Arrays, pre: Arrays, commdom: torch.Tensor,
                  comm_cnt: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Class-vectorized ``step_fits``: the required (anti-)affinity mask
    for EVERY class against one occupancy carry, [C, N] bool — row c is
    bit-identical to ``step_fits(aff, pre, c, ...)``. The conflict-round
    tail evaluates all of a round's classes in one shot; the three domain
    products are one stacked incidence product [C*S + C*A + C, L]."""
    c_dim, s_dim, l_dim = aff["aff_keymask"].shape
    a_dim = aff["anti_keymask"].shape[1]
    occ = _occupancy(aff["m_aff"].reshape(c_dim * s_dim, c_dim),
                     aff["aff_keymask"].reshape(c_dim * s_dim, l_dim),
                     commdom)                                  # [C*S, L]
    occa = _occupancy(aff["m_anti"].reshape(c_dim * a_dim, c_dim),
                      aff["anti_keymask"].reshape(c_dim * a_dim, l_dim),
                      commdom)                                 # [C*A, L]
    # sym_occ[c, l] = sum_{d,a} m_anti[d,a,c] * anti_keymask[d,a,l]
    #               * commdom[d,l] — the same sums as ``_occupancy`` (at
    # most the pods the cluster holds, < 2^24), so int_matmul is exact
    kc = (aff["anti_keymask"].to(I32) * commdom[:, None, :]).reshape(
        c_dim * a_dim, l_dim)
    sym_occ = int_matmul(aff["m_anti"].reshape(c_dim * a_dim, c_dim)
                         .to(I32).T, kc.T)                     # [C, L]
    hits = domain_hits(torch.cat([occ, occa, sym_occ]), labels) > 0
    n_dim = labels.shape[0]
    cs, ca = c_dim * s_dim, c_dim * a_dim
    dyn_hit = hits[:cs].reshape(c_dim, s_dim, n_dim)
    anti_dyn = hits[cs:cs + ca].reshape(c_dim, a_dim, n_dim) \
        & aff["anti_active"][:, :, None]
    sym_hit = hits[cs + ca:]                                   # [C, N]
    dyn_total = (aff["m_aff"].to(I32) * comm_cnt[None, None, :]).sum(
        dim=2, dtype=I32)                                      # [C, S]
    bootstrap = (aff["aff_self"] & ~aff["aff_has_static"]
                 & (dyn_total == 0))                           # [C, S]
    ok = ((~aff["aff_active"][:, :, None]) | pre["allow_hit"] | dyn_hit
          | bootstrap[:, :, None]).all(dim=1)                  # [C, N]
    forbidden = pre["forbid_hit"] | anti_dyn.any(dim=1) | sym_hit
    return ok & ~forbidden & ~aff["fail_all"][:, None]


def step_prio_counts_all(aff: Arrays, pre: Arrays, commdom: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Class-vectorized ``step_prio_counts``: InterPodAffinity weighted
    counts for every class, [C, N] int32, row-identical to the per-class
    form. One stacked incidence product [C*T + C, L]."""
    c_dim, t_dim, l_dim = aff["p_keymask"].shape
    occp = _occupancy(aff["mp"].reshape(c_dim * t_dim, c_dim),
                      aff["p_keymask"].reshape(c_dim * t_dim, l_dim),
                      commdom)                                 # [C*T, L]
    # occq[r, l] = sum_{d,u} q_w[d,u] * mq[d,u,r] * q_keymask[d,u,l]
    #            * commdom[d,l] — weighted sums, exact in int32 (no float)
    wq = aff["q_w"][:, :, None] * aff["mq"].to(I32)            # [D,U,R]
    kc = aff["q_keymask"].to(I32) * commdom[:, None, :]        # [D,U,L]
    occq = (wq[:, :, :, None] * kc[:, :, None, :]).sum(dim=(0, 1),
                                                       dtype=I32)  # [R,L]
    hits = domain_hits(torch.cat([occp, occq]), labels)
    per_t = hits[:c_dim * t_dim].reshape(c_dim, t_dim, -1)     # [C,T,N]
    counts = pre["prio_counts"] \
        + (aff["p_w"][:, :, None] * per_t).sum(dim=1, dtype=I32)
    return counts + hits[c_dim * t_dim:]


def _across(col, how: str, x: torch.Tensor) -> torch.Tensor:
    """`x` combined across a mesh's shards by `how` ("psum", "pmax",
    "pmin") when `col` is a shard's column vtable (engine/waves._ShardCol);
    `x` itself on one device (col None)."""
    return x if col is None else getattr(col, how)(x)


def interpod_score(counts: torch.Tensor, fits: torch.Tensor,
                   col=None) -> torch.Tensor:
    """0..10 normalization over the filtered set (interpod_affinity.go:224-
    239): max clamped >= 0, min clamped <= 0, integer floor division.
    Shape-generic: [..., N] with the node axis last. With `col` (a shard's
    column vtable, engine/waves._ShardCol) the node axis is one shard's
    and the extremes combine across the shards."""
    masked_max = torch.where(fits, counts, -(2 ** 31 - 1)).amax(
        dim=-1, keepdim=True)
    masked_min = torch.where(fits, counts, 2 ** 31 - 1).amin(
        dim=-1, keepdim=True)
    masked_max = _across(col, "pmax", masked_max)
    masked_min = _across(col, "pmin", masked_min)
    mx = masked_max.clamp(min=0)
    mn = masked_min.clamp(max=0)
    rng = mx - mn
    return torch.where(rng > 0,
                       (MAX_PRIORITY * (counts - mn)) // rng.clamp(min=1),
                       0).to(I32)


def step_spread_counts(aff: Arrays, c: int, committed: torch.Tensor
                       ) -> torch.Tensor:
    """Matching-pod counts per node for class c: static existing pods plus
    committed in-batch pods of selector-matching classes. [N] int32."""
    dyn = (aff["sp_cls"][c].to(I32)[:, None] * committed).sum(dim=0,
                                                               dtype=I32)
    return aff["sp_static"][c] + dyn


# Saturation caps keeping the exact-rational blend inside int32 (the
# reference's caps; see spread_score there).
SPREAD_NODE_COUNT_CAP = (1 << 11) - 1
SPREAD_ZONE_COUNT_CAP = (1 << 15) - 1


def spread_score(aff: Arrays, has_sel: torch.Tensor, counts: torch.Tensor,
                 fits: torch.Tensor, col=None) -> torch.Tensor:
    """selector_spreading.go:134-185 with the zone blend as the reference
    package defines it — the exact rational floor

        (10(M-c)*Mz + 20(Mz-zc)*M) // (3*M*Mz)

    in pure int32. Shape-generic: counts/fits [..., N], has_sel [...].
    With `col` (a shard's column vtable) the node axis is one shard's: the
    node maximum and the per-zone sums over nodes combine across the
    shards."""
    counts = torch.where(fits, counts, 0).clamp(max=SPREAD_NODE_COUNT_CAP)
    max_node = _across(col, "pmax", counts.amax(dim=-1, keepdim=True))
    zmat = aff["Z"].to(I32)                                    # [N, ZN]
    zc = _across(col, "psum", int_matmul(counts, zmat.T)).clamp(
        max=SPREAD_ZONE_COUNT_CAP)
    node_zone = aff["node_has_zone"]                           # [N]
    has_sel = has_sel[..., None]
    have_zones = (_across(col, "pmax", (fits & node_zone).any(
        dim=-1, keepdim=True).to(I32)) > 0) & has_sel
    zone_seen = _across(col, "psum", int_matmul(
        (fits & node_zone).to(I32), zmat.T)) > 0
    max_zone = torch.where(zone_seen, zc, 0).amax(dim=-1, keepdim=True)
    node_zc = int_matmul(zc, zmat)                             # own-zone sum
    ten = MAX_PRIORITY
    node_scored = (max_node > 0) & has_sel
    r1n = torch.where(node_scored, ten * (max_node - counts), ten)
    r1d = torch.where(node_scored, max_node.clamp(min=1), 1)
    fscore = r1n // r1d
    zone_scored = max_zone > 0
    zn = torch.where(zone_scored, ten * (max_zone - node_zc), 0)
    zd = torch.where(zone_scored, max_zone.clamp(min=1), 1)
    blended = (r1n * zd + 2 * zn * r1d) // (3 * r1d * zd)
    use_blend = have_zones & node_zone
    return torch.where(use_blend, blended, fscore).to(I32)
