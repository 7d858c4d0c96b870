"""Node-axis mesh: the scheduler's node tensors sharded across devices.

PyTorch port of kubernetes_tpu/parallel/mesh.py. The scale axis of the
scheduler is cluster size x pending-queue depth; the mesh splits the NODE
axis: every node-indexed tensor (labels, taints, alloc, requested, port
bitmaps...) is sharded along its node axis over a 1-D list of devices,
and pod-side tensors are replicated. Shard d owns the global rows
[d*N/D, (d+1)*N/D), each a contiguous tensor of its own on its device
(``ShardedTensor``); the node axis is padded to a multiple of D
(``ClusterSnapshot(node_pad=lcm(8, D))``).

The reference lets XLA's partitioner insert the collectives and runs the
wave loop under shard_map. Here an SPMD program is one Python thread per
shard (``run_spmd``), each running the same function on its own shard;
the cross-shard steps (sums, maxima, minima, gathers) meet in a
``ShardGroup``: every shard deposits its small tensor, one combine runs in
shard order 0..D-1 on the mesh's first device, and each shard receives
the result on its own device. A shard that raises aborts the group, so
the others fail at once, and every wait has a timeout, so a lost shard
cannot hang the program.

Streams: each shard runs on the stream the calling thread had current on
the shard's device. Shards that share a device (a mesh of D shards on one
card) therefore share that stream, ordered by the rendezvous; shards on
distinct devices synchronise through events at every combine and at the
end of the program.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from kubernetes_tpu_torch import resolve_device
from kubernetes_tpu_torch.convert import tensor_from_numpy

NODE_AXIS = "nodes"

# node-side arrays sharded along the node axis; everything else replicated
_NODE_SHARDED_KEYS = frozenset({
    "alloc", "requested", "nonzero", "pod_count", "allowed_pods",
    "schedulable", "mem_pressure", "disk_pressure", "labels", "taints_sched",
    "taints_pref", "port_bitmap", "valid", "avoid", "image_sizes",
    "has_zone", "vol_present", "vol_rw", "pd_present", "pd_counts",
})

# AffinityData tensors (ops/affinity.py) and the wave-path bundles
# (engine/scheduler_engine _aff_node_views / _aff_tail_arrays) that carry
# a node axis, by axis: sp_static [C, N] axis 1, Z [N, ZN] axis 0,
# node_has_zone [N] axis 0, key_node [C, A, N] axis 2, static_forbid
# [C, N] axis 1, and the tail's projected node incidence labels_aff
# [N, Lp] axis 0 (Lp, the small projected domain axis, stays replicated as
# a contraction axis, like L). Everything else is class/slot/label-indexed
# and replicated.
_AFF_NODE_AXIS = {"sp_static": 1, "Z": 0, "node_has_zone": 0,
                  "key_node": 2, "static_forbid": 1, "labels_aff": 0}

# class-level tensors with a node axis (the host-check and Policy columns
# of ops/predicates.static_fits and the wave's static score), by axis;
# every other class tensor is replicated
_CLS_NODE_AXIS = {"host_fit": 1, "policy_fit": 1, "policy_score": 1}

# class tensors holding GLOBAL node ids (PodFitsHost's required node): a
# shard compares them with its LOCAL row index, so its view of them is
# shifted by the shard's first row (local_classes)
_CLS_NODE_IDS = ("host_required",)

# the longest one shard waits at a rendezvous for the others
SPMD_TIMEOUT_S = 300.0


class Mesh:
    """A 1-D device mesh whose one axis is the node axis."""

    axis_names = (NODE_AXIS,)

    def __init__(self, devices: Sequence):
        self.devices = [_indexed(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def _indexed(dev: torch.device) -> torch.device:
    """cuda -> cuda:<current>: tensors report indexed devices, so mesh
    devices compare equal to them."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of `n_devices` shards (default: one per device). `device`
    None means the machine's cards (resolve_device: raises without one),
    taken round-robin, so a machine with fewer cards than shards repeats
    them; a named device (``"cpu"``, ``"cuda:0"``) is repeated
    `n_devices` times."""
    dev = resolve_device(device)
    if device is None and dev.type == "cuda":
        avail = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        avail = [dev]
    n = n_devices or len(avail)
    return Mesh([avail[i % len(avail)] for i in range(n)])


class Placement(NamedTuple):
    """Where a tensor lives on a mesh: sharded along `axis`, or
    replicated on every device (`axis` None)."""

    mesh: Mesh
    axis: Optional[int]


class Shard(NamedTuple):
    device: torch.device
    data: torch.Tensor


class ShardedTensor:
    """A mesh-placed tensor: its D per-shard tensors. With `axis` set,
    shard d holds the global index range [d*n/D, (d+1)*n/D) of that axis
    as a contiguous tensor on mesh.devices[d]; with `axis` None every
    shard holds the whole tensor. Read-only by convention: the engine
    replaces mesh tensors, never writes them."""

    __slots__ = ("mesh", "shards", "axis", "shape")

    def __init__(self, mesh: Mesh, shards: List[torch.Tensor],
                 axis: Optional[int]):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{mesh.size}")
        self.mesh = mesh
        self.shards = list(shards)
        self.axis = axis
        shape = list(shards[0].shape)
        if axis is not None:
            shape[axis] = sum(int(s.shape[axis]) for s in shards)
        self.shape = torch.Size(shape)

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]

    @property
    def addressable_shards(self) -> List[Shard]:
        return [Shard(d, s) for d, s in zip(self.mesh.devices, self.shards)]

    def full(self) -> torch.Tensor:
        """The whole tensor on the mesh's first device (a new tensor for a
        sharded one; shard 0 itself for a replicated one)."""
        if self.axis is None:
            return self.shards[0]
        dev = self.device
        return torch.cat([s.to(dev) for s in self.shards], dim=self.axis)

    def index_select(self, dim: int, index: torch.Tensor) -> torch.Tensor:
        """``full().index_select(dim, index)`` without assembling: each
        shard gathers the rows it owns, combined on the first device."""
        if self.axis is None:
            return self.shards[0].index_select(dim, index)
        if dim != self.axis:
            return self.full().index_select(dim, index)
        dev = self.device
        out = None
        off = 0
        for s in self.shards:
            nl = int(s.shape[dim])
            loc = index.to(s.device) - off
            ok = (loc >= 0) & (loc < nl)
            vals = s.index_select(dim, loc.clamp(0, max(nl - 1, 0)))
            shape = [1] * vals.ndim
            shape[dim] = -1
            vals = torch.where(ok.reshape(shape), vals,
                               torch.zeros((), dtype=vals.dtype,
                                           device=vals.device)).to(dev)
            if out is None:
                out = vals
            elif vals.dtype == torch.bool:
                out = out | vals
            else:
                out = out + vals
            off += nl
        return out

    def __array__(self, dtype=None, copy=None):
        a = self.full().cpu().numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, axis={self.axis}, "
                f"mesh={self.mesh})")


# ------------------------------------------------------------ placement


def _leaves(tree):
    if isinstance(tree, ShardedTensor) or isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def mesh_of(*trees) -> Optional[Mesh]:
    """The mesh of the first ShardedTensor in `trees` (dicts, tuples,
    NodeStates), or None when every tensor is a plain one."""
    for t in trees:
        for leaf in _leaves(t):
            if isinstance(leaf, ShardedTensor):
                return leaf.mesh
    return None


def _map_tree(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, (ShardedTensor, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return tree


def full(x):
    """A plain tensor: a ShardedTensor assembled on its mesh's first
    device, anything else as given."""
    return x.full() if isinstance(x, ShardedTensor) else x


def full_tree(tree):
    """`full` over a dict / tuple / NodeState of tensors."""
    return _map_tree(full, tree)


def _fresh(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A new contiguous tensor on `device` holding `t` (never a view)."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def place(x, mesh: Mesh, axis: Optional[int]) -> ShardedTensor:
    """`x` placed on `mesh`, sharded along `axis` or replicated (None): a
    ShardedTensor already so placed is returned as is; a plain tensor is
    split into fresh contiguous per-shard tensors (replicated: moved to
    each device, shared where devices repeat)."""
    if isinstance(x, ShardedTensor):
        if x.mesh is mesh and x.axis == axis:
            return x
        x = x.full()
    if axis is None:
        per = {}
        shards = []
        for dev in mesh.devices:
            if dev not in per:
                per[dev] = x if x.device == dev else x.to(dev)
            shards.append(per[dev])
        return ShardedTensor(mesh, shards, None)
    n = int(x.shape[axis])
    if n % mesh.size:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split "
                         f"into {mesh.size} shards (pad the node axis to a "
                         "multiple of the mesh size)")
    nl = n // mesh.size
    return ShardedTensor(mesh, [_fresh(x.narrow(axis, d * nl, nl), dev)
                                for d, dev in enumerate(mesh.devices)], axis)


def place_host(host: np.ndarray, placement: Placement,
               ctor=tensor_from_numpy) -> ShardedTensor:
    """A host array uploaded onto a mesh by `ctor(array, device)` (a
    copying constructor): one upload per shard of the rows it owns, or,
    replicated, one upload moved to each further device."""
    mesh, axis = placement
    host = np.asarray(host)
    if axis is None:
        first = ctor(host, mesh.devices[0])
        return place(first, mesh, None)
    n = host.shape[axis]
    if n % mesh.size:
        raise ValueError(f"axis {axis} of {host.shape} does not split into "
                         f"{mesh.size} shards")
    nl = n // mesh.size
    idx = [slice(None)] * host.ndim
    shards = []
    for d, dev in enumerate(mesh.devices):
        idx[axis] = slice(d * nl, (d + 1) * nl)
        shards.append(ctor(host[tuple(idx)], dev))
    return ShardedTensor(mesh, shards, axis)


def place_tree(tree, mesh: Mesh, axis: Optional[int]):
    """`place` over a dict / tuple / NodeState (every tensor on `axis`)."""
    return _map_tree(lambda t: place(t, mesh, axis), tree)


def local_tree(tree, d: int, mesh: Mesh):
    """Shard d's view of a dict / tuple / NodeState: its shard of each
    ShardedTensor, and each plain tensor moved to mesh.devices[d]
    (replicated)."""
    dev = mesh.devices[d]

    def one(x):
        if isinstance(x, ShardedTensor):
            return x.shards[d]
        return x if x.device == dev else x.to(dev)
    return _map_tree(one, tree)


def local_classes(cls: Dict, d: int, mesh: Mesh, n_local: int) -> Dict:
    """Shard d's view of a class-tensor dict (shard_classes-placed or
    plain): local_tree, with the global node ids of _CLS_NODE_IDS made
    local to the shard (ids it does not own fall outside [0, n_local) and
    match none of its rows)."""
    out = local_tree(cls, d, mesh)
    for k in _CLS_NODE_IDS:
        if k in out:
            out[k] = out[k] - d * n_local
    return out


def node_spec(key: str) -> Optional[int]:
    """The sharded axis of a snapshot/node-state tensor by key: node-axis
    tensors shard axis 0, everything else (pd_kind [3,V], pd_max [3])
    replicates (None)."""
    return 0 if key in _NODE_SHARDED_KEYS else None


def aff_spec(key: str) -> Optional[int]:
    """The sharded axis of an AffinityData / wave-bundle tensor by key."""
    return _AFF_NODE_AXIS.get(key)


def committed_spec() -> int:
    """The wave loop's [C, N] topology-occupancy carry: node axis 1."""
    return 1


def shard_nodes(nodes: Dict, mesh: Mesh) -> Dict:
    """Node-side tensors sharded along axis 0 of the mesh (the rest
    replicated)."""
    return {k: place(v, mesh, node_spec(k)) for k, v in nodes.items()}


def replicate(pods: Dict, mesh: Mesh) -> Dict:
    return {k: place(v, mesh, None) for k, v in pods.items()}


def shard_affinity(aff: Dict, mesh: Mesh) -> Dict:
    """Affinity tensors: node-axis members sharded along the mesh (by
    _AFF_NODE_AXIS), everything else replicated."""
    return {k: place(v, mesh, aff_spec(k)) for k, v in aff.items()}


def shard_classes(cls: Dict, mesh: Mesh) -> Dict:
    """Class tensors: the node-axis columns (_CLS_NODE_AXIS) sharded,
    everything else replicated."""
    return {k: place(v, mesh, _CLS_NODE_AXIS.get(k)) for k, v in cls.items()}


def map_shards(mesh: Mesh, fn, axis: Optional[int]):
    """Run `fn(d)` for each shard d in turn, on the calling thread with
    the shard's device current, and collect the results (a tensor or a
    dict of tensors) as ShardedTensors along `axis`. For work that is
    elementwise over the node axis: no shard needs another's data."""
    outs = []
    for d, dev in enumerate(mesh.devices):
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                outs.append(fn(d))
        else:
            outs.append(fn(d))
    if isinstance(outs[0], dict):
        return {k: ShardedTensor(mesh, [o[k] for o in outs], axis)
                for k in outs[0]}
    return ShardedTensor(mesh, outs, axis)


# ------------------------------------------------------------ entry points
# How an op entry meets mesh-placed operands is decided here alone; the op
# bodies stay single-device.


def per_shard(axis: int):
    """Decorator for an entry ``fn(cls, nodes, *rest)`` that is
    elementwise over the node axis. Plain operands call `fn` as is;
    mesh-placed ones run it once per shard (map_shards) on that shard's
    class and node tensors, and its result comes back sharded on
    `axis`."""
    def deco(fn):
        @functools.wraps(fn)
        def entry(cls, nodes, *rest, **kw):
            mesh = mesh_of(cls, nodes)
            if mesh is None:
                return fn(cls, nodes, *rest, **kw)
            cls = shard_classes(cls, mesh)
            nodes = shard_nodes(nodes, mesh)
            n_local = int(nodes["alloc"].shape[0]) // mesh.size
            return map_shards(mesh, lambda d: fn(
                local_classes(cls, d, mesh, n_local),
                local_tree(nodes, d, mesh), *rest, **kw), axis)
        return entry
    return deco


def on_first_device(state_at: int):
    """Decorator for an entry that takes mesh-placed operands UNSHARDED on
    the mesh's first device: a layout departure from the reference, which
    runs it on the sharded operands (ROADMAP §1, "Shard the strict
    tails"). Every operand is assembled there (full_tree), `fn` runs as on
    one device, and the NodeState at ``result[state_at]`` is sharded again
    on axis 0; the placements are the same. Plain operands call `fn` as
    is."""
    def deco(fn):
        @functools.wraps(fn)
        def entry(*args, **kw):
            mesh = mesh_of(args, kw)
            if mesh is None:
                return fn(*args, **kw)
            out = list(fn(*full_tree(args), **full_tree(kw)))
            out[state_at] = place_tree(out[state_at], mesh, 0)
            return tuple(out)
        return entry
    return deco


# ------------------------------------------------------------------- SPMD


class ShardAborted(RuntimeError):
    """Another shard of the same SPMD program failed (or timed out)."""


class ShardGroup:
    """The in-process rendezvous of one SPMD program's shards: every
    cross-shard step calls ``exchange`` once per shard, in the same order
    on every shard."""

    def __init__(self, mesh: Mesh, streams, timeout: float):
        self.mesh = mesh
        self.streams = streams
        self.timeout = timeout
        self._cv = threading.Condition()
        self._slots: List = [None] * mesh.size
        self._arrived = 0
        self._gen = 0
        self._result = None
        self._error: Optional[BaseException] = None

    def abort(self, exc: BaseException) -> None:
        with self._cv:
            if self._error is None:
                self._error = exc
            self._cv.notify_all()

    def exchange(self, d: int, x: torch.Tensor, combine) -> torch.Tensor:
        """Deposit shard d's `x`; returns `combine([x_0, ..., x_{D-1}])`
        (shard order, all on the mesh's first device) on shard d's
        device."""
        s = self.streams[d]
        ev = None
        if s is not None and s != self.streams[0]:
            ev = torch.cuda.Event()
            ev.record(s)
        with self._cv:
            if self._error is not None:
                raise ShardAborted("another shard failed") from self._error
            gen = self._gen
            self._slots[d] = (x, ev)
            self._arrived += 1
            if self._arrived == self.mesh.size:
                try:
                    self._result = self._combine(combine)
                except BaseException as e:
                    self._error = e
                    self._cv.notify_all()
                    raise
                self._slots = [None] * self.mesh.size
                self._arrived = 0
                self._gen += 1
                self._cv.notify_all()
            else:
                deadline = time.monotonic() + self.timeout
                while self._gen == gen and self._error is None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        self._error = TimeoutError(
                            f"shard {d} waited {self.timeout:.0f} s at a "
                            "rendezvous")
                        self._cv.notify_all()
                        raise self._error
                    self._cv.wait(left)
                if self._gen == gen:
                    raise ShardAborted("another shard failed") \
                        from self._error
            r, ev_r = self._result
        return self._deliver(d, r, ev_r)

    def _combine(self, combine):
        dev0 = self.mesh.devices[0]
        s0 = self.streams[0]
        xs = []
        for d, (x, ev) in enumerate(self._slots):
            if ev is not None:
                s0.wait_event(ev)
            if x.device != dev0:
                with torch.cuda.stream(self.streams[d]), \
                        torch.cuda.stream(s0):
                    x.record_stream(s0)
                    x = x.to(dev0)
            xs.append(x)
        if s0 is None:
            return combine(xs), None
        with torch.cuda.device(dev0), torch.cuda.stream(s0):
            r = combine(xs)
            ev_r = None
            if any(s != s0 for s in self.streams):
                ev_r = torch.cuda.Event()
                ev_r.record(s0)
        return r, ev_r

    def _deliver(self, d: int, r: torch.Tensor, ev_r) -> torch.Tensor:
        dev = self.mesh.devices[d]
        if dev == r.device:
            return r  # shared, read-only; same device means same stream
        s = self.streams[d]
        s.wait_event(ev_r)
        r.record_stream(s)
        with torch.cuda.stream(s):
            return r.to(dev)


def _sum(xs):
    return functools.reduce(torch.add, xs)


def _max(xs):
    return functools.reduce(torch.maximum, xs)


def _min(xs):
    return functools.reduce(torch.minimum, xs)


COMBINES = {"sum": _sum, "max": _max, "min": _min, "stack": torch.stack}


def run_spmd(mesh: Mesh, fn) -> list:
    """Run ``fn(d, group)`` once per shard d, each in its own thread with
    the shard's device and stream current, and return the D results in
    shard order. The first failure (by shard order) is re-raised after
    every shard has stopped; the others stop at their next rendezvous."""
    cuda = mesh.devices[0].type == "cuda"
    streams = [torch.cuda.current_stream(dev) if cuda else None
               for dev in mesh.devices]
    group = ShardGroup(mesh, streams, SPMD_TIMEOUT_S)
    out: list = [None] * mesh.size
    err: list = [None] * mesh.size

    def body(d):
        try:
            if cuda:
                with torch.cuda.device(mesh.devices[d]), \
                        torch.cuda.stream(streams[d]):
                    out[d] = fn(d, group)
            else:
                out[d] = fn(d, group)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            err[d] = e
            group.abort(e)

    threads = [threading.Thread(target=body, args=(d,), daemon=True,
                                name=f"spmd-shard-{d}")
               for d in range(mesh.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = next((e for e in err if e is not None
                  and not isinstance(e, ShardAborted)), None) \
        or next((e for e in err if e is not None), None)
    if first is not None:
        raise first
    if cuda:
        # the caller's stream on the first device waits for the shards
        # that ran on other devices' streams
        for s in {s for s in streams if s != streams[0]}:
            ev = torch.cuda.Event()
            ev.record(s)
            streams[0].wait_event(ev)
    return out


# ---------------------------------------------------------------- residency
# The node axis as a RESIDENT scaling dimension: spec tables shared by
# every consumer (engine uploads, the SPMD wave loop), and a per-shard ROW
# update that rebuilds a sharded dynamic tensor touching ONLY the shards
# whose rows moved — the delta path's host->device traffic is then
# O(touched_shards x N/D) rows, and untouched shards keep their existing
# device tensors by reference.


class ResidentMesh:
    """One engine's mesh and the per-shard row update of its resident
    node-axis tensors."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n_devices = mesh.size
        self.devices = list(mesh.devices)

    def _touched(self, host: np.ndarray, rows) -> set:
        nl = host.shape[0] // self.n_devices
        return {min(int(r) // nl, self.n_devices - 1) for r in rows}

    def update_rows(self, dev: ShardedTensor, host: np.ndarray,
                    rows: Sequence[int]) -> ShardedTensor:
        """Rebuild an axis-0-sharded tensor from `host`, re-uploading ONLY
        the shards owning `rows`; every other shard keeps its existing
        tensor. The caller guarantees `host` equals the device content
        outside the touched rows (the engine's dirty-row contract). Returns
        a new ShardedTensor and never mutates `dev` — in-flight waves keep
        their operand. Each touched shard is a COPY of its host rows
        (sanitize.upload_copied: verified under GRAFT_SANITIZE=1), never a
        view of the live snapshot array."""
        from kubernetes_tpu_torch.analysis import sanitize
        nl = host.shape[0] // self.n_devices
        touched = self._touched(host, rows)
        shards = [sanitize.upload_copied(host[d * nl:(d + 1) * nl], device)
                  if d in touched else dev.shards[d]
                  for d, device in enumerate(self.devices)]
        return ShardedTensor(self.mesh, shards, 0)

    def touched_nbytes(self, host: np.ndarray, rows: Sequence[int]) -> int:
        """Host->device bytes update_rows ships for `rows`: whole shards,
        not rows — len(touched_shards) x N/D x row bytes."""
        n = host.shape[0]
        nl = n // self.n_devices
        return len(self._touched(host, rows)) * nl \
            * (host.nbytes // max(n, 1))
