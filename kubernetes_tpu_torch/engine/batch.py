"""Strict batch placement: the reference's one-pod-at-a-time loop on device.

PyTorch port of kubernetes_tpu/engine/batch.py (NodeState, _batch_pre,
place_batch / gather_place_batch, check_affinity_priorities). The reference
runs the loop as a lax.scan; here it is a Python loop over the pods whose
carry (the mutable node state and the round-robin counter) stays on the
device, so a step costs no host sync. Each step re-evaluates the
capacity-dependent predicates and priorities against the carry, then
commits the chosen node (the on-device AssumePod).

selectHost parity (generic_scheduler.go:88-160):
  - 0 fitting nodes  -> selected = -1, counter unchanged
  - 1 fitting node   -> that node, counter NOT incremented
  - >1 fitting nodes -> max-score tie set, index = counter % ties
                        (counter++), tie order = ascending node index.

The reference's counter is uint32; the port carries it as an int64 tensor
holding the same value (0 <= counter < 2^32) and wraps it explicitly.
With ``aff`` the loop also carries the inter-pod affinity occupancy
(commdom [C, L], committed [C, N], comm_cnt [C]) that the reference's
sequential loop sees through the scheduler cache.

Node-axis mesh: every cross-node-axis operation of the strict tails (this
scan and waves.tail_rounds_loop) and of the wave loop goes through a
column vtable. _GlobalCol is the whole-axis form; _ShardCol is one
shard's form inside an SPMD program (parallel/mesh.run_spmd): local work
over the shard's N/D rows, then a small combine over the shards. On a
mesh the scan runs once per shard (_place_batch_spmd): a step's node-axis
statistics meet in one combine, its max-score tie counts in a second,
and, with affinity on, the committed node's domain row in a third; the
commit lands on the shard owning the node only.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from kubernetes_tpu_torch.api.types import MAX_PRIORITY
from kubernetes_tpu_torch.ops import affinity as aff_ops
from kubernetes_tpu_torch.ops import predicates as preds
from kubernetes_tpu_torch.ops import priorities as prio
from kubernetes_tpu_torch.ops.predicates import int_matmul
from kubernetes_tpu_torch.parallel import mesh as mesh_mod

Arrays = Dict[str, torch.Tensor]

I32 = torch.int32
U32_MASK = 0xFFFFFFFF
_BIG = 2 ** 31 - 1


class NodeState(NamedTuple):
    """The mutable (carry) slice of node state."""

    requested: torch.Tensor    # int32 [N,R]
    nonzero: torch.Tensor      # int32 [N,2]
    pod_count: torch.Tensor    # int32 [N]
    port_bitmap: torch.Tensor  # int32 [N,W] (the reference's uint32 bits)
    vol_present: torch.Tensor  # int8 [N,Vc]
    vol_rw: torch.Tensor       # int8 [N,Vc]
    pd_present: torch.Tensor   # int8 [N,Vpd]
    pd_counts: torch.Tensor    # int32 [N,3]


def node_state(nodes: Arrays) -> NodeState:
    return NodeState(nodes["requested"], nodes["nonzero"], nodes["pod_count"],
                     nodes["port_bitmap"], nodes["vol_present"],
                     nodes["vol_rw"], nodes["pd_present"], nodes["pd_counts"])


def counter_as_i32(counter: torch.Tensor) -> torch.Tensor:
    """The reference's ``counter.astype(int32)`` of a uint32: the same 32
    bits read as two's complement."""
    return torch.where(counter >= 2 ** 31, counter - 2 ** 32,
                       counter).to(I32)


_REDUCE = {"sum": lambda x: x.sum(dim=0, dtype=I32),
           "max": lambda x: x.amax(dim=0),
           "min": lambda x: x.amin(dim=0)}


class _GlobalCol:
    """Whole-node-axis column ops — exactly the unsharded bodies' ops (the
    bit-identity anchor of the sharded path)."""

    d = 0
    off = 0

    def __init__(self, n_global: int):
        self.n_global = n_global   # GLOBAL node-id sentinel bound
        self.n_local = n_global    # scatter width (== global here)

    def psum(self, x):
        return x

    def pmax(self, x):
        return x

    def combine(self, parts):
        """[(how, local int32 tensor)] -> the combined tensors."""
        return [t for _, t in parts]

    def row_sum(self, x):
        return x.sum(dim=1, dtype=I32)

    def row_max(self, x, keepdim=False):
        return x.amax(dim=1, keepdim=keepdim)

    def first_fit(self, fits):
        """Index of each class's first fitting node."""
        return fits.to(torch.uint8).argmax(dim=1).to(I32)

    def scan_first_fit(self, fits):
        """The scan step's first fitting node of [N] `fits` (any value when
        none fits), as a ("min", ...) part of the step's combine."""
        return fits.to(torch.uint8).argmax().to(I32)

    def scan_ties(self, masked):
        """The scan step's max-score tie set over [N] `masked`: (local tie
        mask, global tie count int64, this shard's exclusive prefix)."""
        ties = masked == masked.amax()
        return ties, ties.sum(dtype=torch.int64), 0

    def tie_select(self, ties, pod_class, kz):
        """Node index of the kz-th tie (ascending node order) of each pod's
        class — the RR fan-out lookup."""
        c, n = ties.shape
        idx_n = torch.arange(n, dtype=I32, device=ties.device)
        rank = torch.cumsum(ties.to(I32), dim=1, dtype=I32) - 1
        cols = torch.where(ties, rank, n).long()
        tiemat = torch.zeros((c, n + 1), dtype=I32, device=ties.device)
        tiemat.scatter_(1, cols, idx_n.expand(c, n).contiguous())
        return tiemat[pod_class, kz.long()]

    def take_rows(self, arr, idx):
        """arr[idx] for node-axis-0 tensors, idx = global node ids >= 0."""
        return arr[idx]

    def take2(self, arr, rows, cols):
        """arr[rows, cols] for [C, N] tensors, cols = global node ids."""
        return arr[rows, cols]

    def to_local(self, ids):
        """Scatter ids: global node id, or -1 -> the drop sentinel."""
        return torch.where(ids < 0, self.n_global, ids)


class _ShardCol:
    """Per-shard column ops, legal only inside mesh.run_spmd: shard d owns
    global rows [d*Nl, (d+1)*Nl). Reductions are local, then a combine
    over the shards; the tie lookup resolves ownership from a gathered
    [D, C] tie-count table; gathers/scatters translate global ids to local
    rows and drop the rest, so each commit row is written by exactly ONE
    shard. Integer combines wrap in int32 like the reference's psum."""

    def __init__(self, group, d: int, n_global: int, n_local: int):
        self.group = group
        self.d = d
        self.n_global = n_global
        self.n_local = n_local
        self.off = d * n_local

    def _combine(self, x, how):
        return self.group.exchange(self.d, x, mesh_mod.COMBINES[how])

    def psum(self, x):
        return self._combine(x, "sum")

    def pmax(self, x):
        return self._combine(x, "max")

    def pmin(self, x):
        return self._combine(x, "min")

    def combine(self, parts):
        """Every (how, int32 tensor) part combined by its `how` ("sum",
        "max", "min") in ONE exchange: the parts travel as one stacked
        vector, and each shard reduces the [D, k] table it gets back."""
        flat = torch.cat([t.reshape(-1).to(I32) for _, t in parts])
        table = self._combine(flat, "stack")                # [D, k]
        out, o = [], 0
        for how, t in parts:
            k = t.numel()
            out.append(_REDUCE[how](table[:, o:o + k]).reshape(t.shape))
            o += k
        return out

    def row_sum(self, x):
        return self.psum(x.sum(dim=1, dtype=I32))

    def row_max(self, x, keepdim=False):
        m = self.pmax(x.amax(dim=1))
        return m[:, None] if keepdim else m

    def first_fit(self, fits):
        first = self.off + fits.to(torch.uint8).argmax(dim=1).to(I32)
        return self.pmin(torch.where(fits.any(dim=1), first, _BIG))

    def scan_first_fit(self, fits):
        first = self.off + fits.to(torch.uint8).argmax().to(I32)
        return torch.where(fits.any(), first, _BIG)

    def scan_ties(self, masked):
        # each shard's local maximum and its multiplicity, in one exchange:
        # the global maximum is the largest, and the global ties are the
        # local ones of the shards whose maximum it is
        lmax = masked.amax()
        lcnt = (masked == lmax).sum(dtype=I32)
        table = self._combine(torch.stack([lmax.to(I32), lcnt]), "stack")
        best = table[:, 0].amax()
        cnt = torch.where(table[:, 0] == best, table[:, 1],
                          0).to(torch.int64)                # [D]
        prefix = torch.cumsum(cnt, 0) - cnt                 # exclusive
        return masked == best, cnt.sum(), prefix[self.d]

    def tie_select(self, ties, pod_class, kz):
        c, nl = ties.shape
        pcl = pod_class.long()
        m_l = ties.sum(dim=1, dtype=I32)                    # [C] local
        m_all = self._combine(m_l, "stack")                 # [D, C]
        prefix = torch.cumsum(m_all, dim=0, dtype=I32) - m_all  # exclusive
        my_prefix = prefix[self.d]                          # [C]
        rank = torch.cumsum(ties.to(I32), dim=1, dtype=I32) - 1
        cols = torch.where(ties, rank, nl).long()
        idx_n = self.off + torch.arange(nl, dtype=I32, device=ties.device)
        tiemat = torch.zeros((c, nl + 1), dtype=I32, device=ties.device)
        tiemat.scatter_(1, cols, idx_n.expand(c, nl).contiguous())
        lr = kz - my_prefix[pcl]                            # local rank
        owned = (lr >= 0) & (lr < m_l[pcl])
        cand = torch.where(owned, tiemat[pcl, lr.clamp(0, nl - 1).long()],
                           0)
        return self.psum(cand)                              # [P] combine

    def take_rows(self, arr, idx):
        nl = arr.shape[0]
        loc = idx - self.off
        ok = (loc >= 0) & (loc < nl)
        vals = arr[loc.clamp(0, nl - 1)]
        mask = ok.reshape(ok.shape + (1,) * (arr.dim() - 1))
        return self.psum(torch.where(mask, vals, 0))

    def take2(self, arr, rows, cols):
        nl = arr.shape[1]
        loc = cols - self.off
        ok = (loc >= 0) & (loc < nl)
        vals = arr[rows, loc.clamp(0, nl - 1)]
        return self.psum(torch.where(ok, vals, 0))

    def to_local(self, ids):
        loc = ids - self.off
        return torch.where((ids >= 0) & (loc >= 0) & (loc < self.n_local),
                           loc, self.n_local)


def seed_occupancy(aff_init, labels: torch.Tensor, col):
    """The affinity carry (commdom [C, L], committed [C, N], comm_cnt [C])
    from `aff_init`. A None commdom / comm_cnt is derived from `committed`
    (the per-node occupancy of pods committed before the tail): the
    contraction over nodes runs on each shard's rows and the int32
    partials combine in one exchange. int_matmul is exact: each sum counts
    class-c pods in one domain, at most the pods the cluster holds (nodes
    x allowed pods: 550,000 at 5,000 x 110) < 2^24, and so is every
    partial."""
    commdom, committed, comm_cnt = aff_init
    committed = committed.to(I32)
    if commdom is None:
        commdom, comm_cnt = col.combine([
            ("sum", int_matmul(committed, labels.T)),
            ("sum", committed.sum(dim=1, dtype=I32))])
    return commdom.to(I32).clone(), committed.clone(), comm_cnt.to(I32).clone()


_STATIC_PRIORITIES = ("NodePreferAvoidPodsPriority", "ImageLocalityPriority",
                      "EqualPriority")
_MAX_NORMALIZED = ("TaintTolerationPriority", "NodeAffinityPriority")


def _step_score_parts(fits: torch.Tensor, tt_cnt: torch.Tensor,
                      na_cnt: torch.Tensor, priorities):
    """The node-axis maxima the reduce priorities normalize by, as
    ("max", ...) parts of the step's combine (one per such priority)."""
    cnt = {"TaintTolerationPriority": tt_cnt, "NodeAffinityPriority": na_cnt}
    return [("max", torch.where(fits, cnt[name], 0).amax())
            for name, _ in priorities if name in _MAX_NORMALIZED]


def _step_scores(pod_nonzero: torch.Tensor, state: NodeState,
                 alloc: torch.Tensor, tt_cnt: torch.Tensor,
                 na_cnt: torch.Tensor, static_score: torch.Tensor,
                 maxima, priorities) -> torch.Tensor:
    """Per-pod priority sum against the evolving carry. [N] int32.
    `maxima` holds the combined _step_score_parts, in their order."""
    pz = pod_nonzero[None, :]
    total = static_score
    maxima = iter(maxima)
    for name, weight in priorities:
        if name == "LeastRequestedPriority":
            s = prio.least_requested(pz, state.nonzero, alloc)[0]
        elif name == "MostRequestedPriority":
            s = prio.most_requested(pz, state.nonzero, alloc)[0]
        elif name == "BalancedResourceAllocation":
            s = prio.balanced_allocation(pz, state.nonzero, alloc)[0]
        elif name == "TaintTolerationPriority":
            mx = next(maxima)
            s = torch.where(mx == 0, MAX_PRIORITY,
                            (MAX_PRIORITY * (mx - tt_cnt)) // mx.clamp(min=1))
        elif name == "NodeAffinityPriority":
            mx = next(maxima)
            s = torch.where(mx > 0, (MAX_PRIORITY * na_cnt) // mx.clamp(min=1),
                            0)
        elif name in _STATIC_PRIORITIES:
            continue  # folded into static_score
        elif name in prio.AFFINITY_PRIORITIES:
            continue  # computed by the caller from the affinity carry
        else:
            raise KeyError(name)
        total = total + s * weight
    return total


def _commit(state: NodeState, sel: torch.Tensor, ok: torch.Tensor,
            pod_req, pod_nonzero, pod_ports, pod_vol_hard, pod_vol_ro,
            pod_pd_req, pd_new_sel) -> NodeState:
    """Decrement capacity at the selected node (the on-device AssumePod).
    The carry is updated in place: callers hand place_batch fresh state."""
    safe = torch.where(ok, sel, 0).long()
    gain = ok.to(I32)
    state.requested[safe] += pod_req * gain
    state.nonzero[safe] += pod_nonzero * gain
    state.pod_count[safe] += gain
    # host ports are deduped host-side, so adding distinct bits into one
    # word is an OR; a bit 31 wraps to the sign bit exactly as uint32 adds
    want = (pod_ports >= 0) & ok
    wsafe = pod_ports.clamp(min=0)
    bits = torch.where(want, torch.ones_like(wsafe) << (wsafe % 32), 0)
    row = state.port_bitmap[safe].clone()
    row.index_add_(0, (wsafe // 32).long(), bits)
    state.port_bitmap[safe] = row
    zero8 = torch.zeros_like(pod_vol_hard)
    state.vol_present[safe] = torch.maximum(
        state.vol_present[safe],
        torch.where(ok, pod_vol_hard | pod_vol_ro, zero8))
    state.vol_rw[safe] = torch.maximum(
        state.vol_rw[safe], torch.where(ok, pod_vol_hard, zero8))
    state.pd_present[safe] = torch.maximum(
        state.pd_present[safe],
        torch.where(ok, pod_pd_req, torch.zeros_like(pod_pd_req)))
    state.pd_counts[safe] += pd_new_sel * gain
    return state


def _batch_pre(pods: Arrays, nodes: Arrays, priorities
               ) -> Tuple[torch.Tensor, ...]:
    """The [*, N] capacity-independent tensors of the loop: static
    predicate mask, reduce-priority counts and static priority score."""
    static_fit = preds.static_fits(pods, nodes) \
        & preds.node_condition_fit(pods, nodes)
    tt_cnt = int_matmul(pods["intolerated_pref"], nodes["taints_pref"])
    na_cnt = prio.node_affinity_counts(pods, nodes["labels"]) \
        if any(nm == "NodeAffinityPriority" for nm, _ in priorities) \
        else torch.zeros(static_fit.shape, dtype=I32,
                         device=static_fit.device)
    static_score = torch.zeros(static_fit.shape, dtype=I32,
                               device=static_fit.device)
    for name, weight in priorities:
        if name in _STATIC_PRIORITIES:
            static_score = static_score + \
                prio.PRIORITY_REGISTRY[name](pods, nodes, None) * weight
    if "policy_score" in pods:
        # Policy-configured NodeLabel / ServiceAntiAffinity priorities
        # (weights pre-folded; ops/policy_algos.py)
        static_score = static_score + pods["policy_score"]
    return static_fit, tt_cnt, na_cnt, static_score


def check_affinity_priorities(priorities, aff, extra_score) -> None:
    """Affinity-priority guard shared by every batch-placement entry point
    (place_batch, waves.tail_rounds_loop): SelectorSpread/InterPodAffinity
    in the priority set without class data or a frozen extra_score would
    contribute silent zeros — a parity bug, never a fallback."""
    for nm, _w in priorities:
        if nm in prio.AFFINITY_PRIORITIES and aff is None \
                and extra_score is None:
            raise ValueError(
                f"{nm} in the priority set requires affinity/spread class "
                "data (pass aff= from ops.affinity.AffinityData, or a "
                "frozen extra_score) — silent zero contributions are a "
                "parity bug, not a fallback")


def copy_state(state: NodeState) -> NodeState:
    return NodeState(*(t.clone() for t in state))


def gather_place_batch(cls_arr: Arrays, pc: torch.Tensor, nodes: Arrays,
                       state: NodeState, rr: torch.Tensor, priorities,
                       aff: Arrays = None,
                       aff_mode: Tuple[bool, bool, bool] = (False, False,
                                                            False),
                       aff_init=None, extra_score: torch.Tensor = None):
    """place_batch over per-pod rows gathered from class rows (pc = class
    index per pod). The capacity-independent [C, N] tensors are computed
    once at class level and gathered; `aff` stays class-level (the loop
    indexes it by class) and `extra_score` is class-level [C, N]. Every
    row of `pc` is stepped: callers pass the live pods only.

    Mesh-placed inputs run once per shard, as in place_batch; the gather
    and the class-level precompute run on each shard's node columns."""
    return _place(cls_arr, nodes, state, rr, priorities, aff, pc, aff_mode,
                  aff_init, extra_score, None, gather=True)


def place_batch(pods: Arrays, nodes: Arrays, state: NodeState,
                rr_counter: torch.Tensor, priorities, aff: Arrays = None,
                pc: torch.Tensor = None,
                aff_mode: Tuple[bool, bool, bool] = (False, False, False),
                aff_init=None, extra_score: torch.Tensor = None,
                pre: Tuple[torch.Tensor, ...] = None):
    """Place every pod of the batch in order. ``state`` is not modified
    (the loop works on a copy); rr_counter is an int64 scalar tensor.

    `aff`/`pc`/`aff_mode` switch on the inter-pod affinity + selector-spread
    machinery (ops/affinity.py): aff holds the CLASS-level static arrays,
    pc [P] maps each pod to its class, and aff_mode = (fits_on, prio_on,
    spread_on) gates which parts run. `aff_init` = (commdom, committed,
    comm_cnt) seeds the occupancy carry with pods committed before this
    batch (the wave pass of the same chunk); commdom and comm_cnt may be
    None, and are then derived from committed (seed_occupancy).

    Mesh-placed inputs (parallel/mesh) run the loop once per shard
    (_place_batch_spmd), as the reference's sharded scan does: the node
    axis stays on its shard from the seed to the final state, which comes
    back sharded on axis 0. Placements, fit counts and the counter equal
    the unsharded run's.

    Returns (selected [P] int32 node index or -1, fit_count [P] int32,
             final NodeState, final rr_counter)."""
    return _place(pods, nodes, state, rr_counter, priorities, aff, pc,
                  aff_mode, aff_init, extra_score, pre, gather=False)


def _rows(pods, pc, nodes, extra_score, pre, priorities, gather: bool):
    """The per-pod rows the loop steps over, on one device or one shard:
    the class rows gathered by `pc` (gather_place_batch), or `pods`
    itself."""
    if not gather:
        if pre is None:
            pre = _batch_pre(pods, nodes, priorities)
        return pods, extra_score, pre
    pcl = pc.long()
    parr = {k: v[pcl] for k, v in pods.items()}
    ex = extra_score[pcl] if extra_score is not None else None
    pre = tuple(a[pcl] for a in _batch_pre(pods, nodes, priorities))
    return parr, ex, pre


def _place(pods, nodes, state, counter, priorities, aff, pc, aff_mode,
           aff_init, extra_score, pre, gather: bool):
    check_affinity_priorities(priorities, aff, extra_score)
    mesh = mesh_mod.mesh_of(pods, pc, nodes, state, aff, aff_init,
                            extra_score, pre)
    if mesh is not None:
        return _place_batch_spmd(pods, nodes, state, counter, priorities,
                                 aff, pc, aff_mode, aff_init, extra_score,
                                 pre, gather, mesh)
    rows, ex, pre = _rows(pods, pc, nodes, extra_score, pre, priorities,
                          gather)
    return _place_batch_inner(rows, nodes, state, counter, priorities, aff,
                              pc, aff_mode, aff_init, ex, pre,
                              _GlobalCol(nodes["alloc"].shape[0]))


def _place_batch_spmd(pods, nodes, state, counter, priorities, aff, pc,
                      aff_mode, aff_init, extra_score, pre, gather, mesh):
    """place_batch on a mesh: node-axis operands enter placed by the
    shared spec tables (a plain tensor is split here), pod-side operands
    replicated, and _place_batch_inner runs once per shard with _ShardCol
    supplying the cross-shard steps. Returns shard 0's placements, fit
    counts and counter (every shard's are the same: they are built from
    combined values only) and the state sharded on axis 0."""
    n_global = int(nodes["alloc"].shape[0])
    n_local = n_global // mesh.size
    pods = mesh_mod.shard_classes(pods, mesh)
    nodes = mesh_mod.shard_nodes(nodes, mesh)
    state = mesh_mod.place_tree(state, mesh, 0)
    if pre is not None:
        pre = mesh_mod.place_tree(pre, mesh, 1)
    if extra_score is not None:
        extra_score = mesh_mod.place(extra_score, mesh, 1)
    if aff is not None:
        aff = mesh_mod.shard_affinity(aff, mesh)
    if aff_init is not None:
        commdom, committed, comm_cnt = aff_init
        aff_init = (commdom, mesh_mod.place(committed, mesh,
                                            mesh_mod.committed_spec()),
                    comm_cnt)

    def shard(d, group):
        def loc(t):
            return mesh_mod.local_tree(t, d, mesh)
        nodes_d = loc(nodes)
        rows, ex, pre_d = _rows(
            mesh_mod.local_classes(pods, d, mesh, n_local), loc(pc), nodes_d,
            loc(extra_score), loc(pre), priorities, gather)
        return _place_batch_inner(
            rows, nodes_d, loc(state), loc(counter), priorities, loc(aff),
            loc(pc), aff_mode, loc(aff_init), ex, pre_d,
            _ShardCol(group, d, n_global, n_local))

    outs = mesh_mod.run_spmd(mesh, shard)
    state = NodeState(*(mesh_mod.ShardedTensor(mesh, [o[2][i] for o in outs],
                                               0)
                        for i in range(len(NodeState._fields))))
    sel, fcs, _st, ctr = outs[0]
    return sel, fcs, state, ctr


def _place_batch_inner(pods, nodes, state, rr_counter, priorities, aff, pc,
                       aff_mode, aff_init, extra_score, pre, col):
    """The scan proper, shared by the single-device path and every shard
    of the SPMD path (the `col` vtable is the only difference). A step's
    node-axis statistics (fit count, first fit, the reduce priorities' and
    the affinity scores' extremes and zone sums) travel in one combine;
    the tie set's maximum and per-shard counts in a second (scan_ties);
    the committed node's domain row, with affinity on, in a third. Each
    shard records the node it owns, and one combine at the end gives every
    shard the placements."""
    fits_on, prio_on, spread_on = aff_mode
    any_aff = aff is not None and (fits_on or prio_on or spread_on)
    w_ip = sum(w for nm, w in priorities
               if nm == "InterPodAffinityPriority") if prio_on else 0
    w_sp = sum(w for nm, w in priorities
               if nm == "SelectorSpreadPriority") if spread_on else 0
    static_fit, tt_cnt, na_cnt, static_score = pre
    alloc = nodes["alloc"]
    allowed = nodes["allowed_pods"]
    pd_kind = nodes["pd_kind"]
    pd_max = nodes["pd_max"]
    n = alloc.shape[0]          # this shard's nodes (all of them unsharded)
    dev = alloc.device
    p_count = pods["req"].shape[0]
    idx_n = torch.arange(n, dtype=I32, device=dev)
    state = copy_state(state)
    counter = rr_counter.to(torch.int64).clone()
    selected = torch.empty(p_count, dtype=I32, device=dev)
    fit_counts = torch.empty(p_count, dtype=I32, device=dev)
    if any_aff:
        c_dim = aff["m_aff"].shape[0]
        # labels_aff (when present) is the PROJECTED domain incidence the
        # aff arrays' domain axes are sliced to (the pipelined tail's
        # column projection); the predicate/priority arrays keep the full
        # label matrix
        labels = aff["labels_aff"] if "labels_aff" in aff \
            else nodes["labels"]
        pre_aff = aff_ops.precompute_static(aff, labels)
        if aff_init is not None:
            commdom, committed, comm_cnt = seed_occupancy(aff_init, labels,
                                                          col)
        else:
            commdom = torch.zeros((c_dim, labels.shape[1]), dtype=I32,
                                  device=dev)
            committed = torch.zeros((c_dim, n), dtype=I32, device=dev)
            comm_cnt = torch.zeros(c_dim, dtype=I32, device=dev)
        # the class of every pod on the host, once: the loop indexes the
        # class-level affinity arrays with it
        pc_h = (pc.tolist() if pc is not None else [0] * p_count)
    for i in range(p_count):
        p_req = pods["req"][i]
        p_vol_hard, p_vol_ro = pods["vol_hard"][i], pods["vol_ro"][i]
        p_pd_req, p_pd_count = pods["pd_req"][i], pods["pd_req_count"][i]
        # NoDiskConflict against the evolving presence
        hard_hit = (state.vol_present.to(I32)
                    * p_vol_hard.to(I32)[None]).sum(dim=1, dtype=I32)
        ro_hit = (state.vol_rw.to(I32)
                  * p_vol_ro.to(I32)[None]).sum(dim=1, dtype=I32)
        disk_ok = (hard_hit == 0) & (ro_hit == 0)
        # MaxPDVolumeCount per filter kind against evolving counts
        pd_ok = torch.ones_like(disk_ok)
        pd_new = []
        for k in range(3):
            req_k = (p_pd_req * pd_kind[k]).to(I32)
            overlap = (state.pd_present.to(I32) * req_k[None]).sum(
                dim=1, dtype=I32)
            new_k = p_pd_count[k] - overlap
            pd_new.append(new_k)
            pd_ok = pd_ok & ((p_pd_count[k] == 0)
                             | (state.pd_counts[:, k] + new_k <= pd_max[k]))
        dyn = (preds.resources_fit(p_req[None], pods["zero_req"][i][None],
                                   alloc, state.requested)[0]
               & preds.pod_count_fit(state.pod_count, allowed)
               & preds.ports_fit(pods["ports"][i][None], state.port_bitmap)[0]
               & disk_ok & pd_ok)
        fits = static_fit[i] & dyn
        if fits_on:
            fits = fits & aff_ops.step_fits(aff, pre_aff, pc_h[i], commdom,
                                            comm_cnt, labels)
        # ---- the step's node-axis statistics, one combine ---------------
        score_parts = _step_score_parts(fits, tt_cnt[i], na_cnt[i],
                                        priorities)
        n_max = len(score_parts)
        parts = [("sum", fits.sum(dtype=I32)),
                 ("min", col.scan_first_fit(fits))] + score_parts
        if prio_on:
            cnt_ip = aff_ops.step_prio_counts(aff, pre_aff, pc_h[i], commdom,
                                              labels)
            parts += aff_ops.interpod_parts(cnt_ip, fits)
        if spread_on:
            cnt_sp, sp_parts = aff_ops.spread_parts(
                aff, aff_ops.step_spread_counts(aff, pc_h[i], committed),
                fits)
            parts += sp_parts
        stats = col.combine(parts)
        fit_count, one_sel = stats[0], stats[1]
        scores = _step_scores(pods["nonzero"][i], state, alloc, tt_cnt[i],
                              na_cnt[i], static_score[i], stats[2:2 + n_max],
                              priorities)
        if extra_score is not None:
            scores = scores + extra_score[i]
        rest = stats[2 + n_max:]
        if prio_on:
            scores = scores + w_ip * aff_ops.interpod_from(cnt_ip, rest[:2])
            rest = rest[2:]
        if spread_on:
            scores = scores + w_sp * aff_ops.spread_from(
                aff, aff["sp_has"][pc_h[i]], cnt_sp, rest)
        # ---- max-score ties, round robin (scan_ties: a second combine) --
        masked = torch.where(fits, scores, -1)
        ties, num_ties, prefix = col.scan_ties(masked)
        kk = torch.where(num_ties > 0, counter % num_ties.clamp(min=1), 0)
        rank = torch.cumsum(ties.to(torch.int64), 0) - 1
        rr_loc = torch.where(ties & (rank == kk - prefix), idx_n, n).amin()
        one_loc = one_sel - col.off
        ok = fit_count > 0
        multi = fit_count > 1
        # the shard owning the chosen node commits it; unsharded, that is
        # every fitting step
        own = ok & torch.where(multi, rr_loc < n,
                               (one_loc >= 0) & (one_loc < n))
        loc_sel = torch.where(multi, rr_loc, one_loc)
        counter = (counter + multi.to(torch.int64)) & U32_MASK
        safe_sel = torch.where(own, loc_sel, 0).long()
        pd_new_sel = torch.stack([v[safe_sel] for v in pd_new])
        state = _commit(state, loc_sel, own, p_req, pods["nonzero"][i],
                        pods["ports"][i], p_vol_hard, p_vol_ro, p_pd_req,
                        pd_new_sel)
        if any_aff:
            # affinity/spread carry: the committed pod's node-domain row
            # joins its class's occupancy (the on-device AssumePod for
            # topology state); the owning shard supplies the row
            gain = own.to(I32)
            c = pc_h[i]
            commdom[c] += col.psum(labels[safe_sel].to(I32) * gain)
            committed[c, safe_sel] += gain
            comm_cnt[c] += ok.to(I32)
        selected[i] = torch.where(own, loc_sel + col.off, -1)
        fit_counts[i] = fit_count
    return col.pmax(selected), fit_counts, state, counter
