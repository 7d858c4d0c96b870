"""The port's node-axis mesh (kubernetes_tpu_torch/parallel/mesh.py) against
the reference's, on the CPU: every test of tests/test_mesh.py, mirrored.
The reference runs under its 8-virtual-device mesh (tests/conftest.py);
the port under an 8-shard mesh of the CPU (make_mesh(8, device="cpu")),
whose SPMD programs run one thread per shard. The same inputs (the
reference's numpy arrays, carried over by convert.arrays_from_numpy, or
the same seeded world through each package's own Scheduler) go through
both, and the results must be EQUAL — placements, fit counts, round-robin
counters and final node state — to the reference's sharded run and to
the port's unsharded one. Also: a mesh of 3 shards (the lcm(8, 3) node
padding), a shard that raises mid-loop (fails fast, never hangs), a
shard that never arrives (the rendezvous times out), the fast lane's
reads of mesh-resident nodes, and a relist that keeps the mesh."""

import contextlib
import functools
import math
import random
import threading
import time
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.engine import batch as jbatch
from kubernetes_tpu.engine import waves as jwaves
from kubernetes_tpu.ops import predicates as jpreds
from kubernetes_tpu.ops import priorities as jprio
from kubernetes_tpu.parallel import mesh as jmesh
from kubernetes_tpu.state.classes import ClassBatch
from kubernetes_tpu.state.node_info import node_info_map
from kubernetes_tpu.state.snapshot import ClusterSnapshot, PodBatch
from kubernetes_tpu_torch.convert import arrays_from_numpy
from kubernetes_tpu_torch.engine import batch as tbatch
from kubernetes_tpu_torch.engine import waves as twaves
from kubernetes_tpu_torch.ops import predicates as tpreds
from kubernetes_tpu_torch.parallel import mesh as tmesh
from tests.helpers import random_nodes, random_pod

N_DEV = 8

PRIO = (("LeastRequestedPriority", 1), ("BalancedResourceAllocation", 1),
        ("TaintTolerationPriority", 1))


def _t(d):
    return arrays_from_numpy({k: np.asarray(v) for k, v in d.items()}, "cpu")


def _eq(got, want, msg=""):
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    np.testing.assert_array_equal(np.asarray(got), want, err_msg=msg)


def _eq_state(port_state, ref_state):
    for name, got, want in zip(ref_state._fields, port_state, ref_state):
        _eq(got, want, name)


def _tmesh(n=N_DEV):
    return tmesh.make_mesh(n, device="cpu")


def _ctr(v=0):
    return torch.tensor(v, dtype=torch.int64)


def _cluster(seed, n_nodes=24, n_pods=48):
    rng = random.Random(seed)
    nodes = random_nodes(rng, n_nodes)
    names = [n.name for n in nodes]
    pods = [random_pod(rng, i, names) for i in range(n_pods)]
    snap = ClusterSnapshot(node_pad=N_DEV)
    snap.refresh(node_info_map(nodes, []))
    return snap, pods


def test_make_mesh_and_shard_layout():
    mesh = _tmesh()
    assert len(mesh.devices) == N_DEV
    assert mesh.axis_names == (tmesh.NODE_AXIS,)
    snap, _ = _cluster(0)
    nodes = _t(jpreds.node_arrays(snap))
    sharded = tmesh.shard_nodes(nodes, mesh)
    n = int(nodes["alloc"].shape[0])
    assert n % N_DEV == 0
    # node-sharded tensors: each shard holds exactly N/8 rows, a
    # contiguous tensor of its own (never a view of the global one)
    shards = sharded["alloc"].addressable_shards
    assert len(shards) == N_DEV
    base = nodes["alloc"].untyped_storage().data_ptr()
    for s in shards:
        assert s.data.shape[0] == n // N_DEV and s.data.is_contiguous()
        assert s.data.untyped_storage().data_ptr() != base
    np.testing.assert_array_equal(np.asarray(sharded["alloc"]),
                                  nodes["alloc"].numpy())
    # the reference's shards hold the same rows
    jm = jmesh.make_mesh(N_DEV)
    jsh = jmesh.shard_nodes(jpreds.node_arrays(snap), jm)["alloc"]
    jshards = sorted(jsh.addressable_shards, key=lambda s: s.index[0].start)
    for js, ts in zip(jshards, shards):
        np.testing.assert_array_equal(np.asarray(js.data), ts.data.numpy())
    # replicated tensors: every shard holds the whole tensor
    rep = tmesh.replicate({"x": torch.arange(16)}, mesh)["x"]
    assert all(s.data.shape[0] == 16 for s in rep.addressable_shards)
    assert sharded["pd_kind"].axis is None


@pytest.mark.parametrize("seed", [0, 2])
def test_fits_kernel_parity_under_mesh(seed):
    """The static predicate matrix: sharded == the reference's sharded ==
    unsharded."""
    snap, pods = _cluster(seed)
    batch = PodBatch(pods, snap)
    parr = jpreds.pod_arrays(batch)
    narr = jpreds.node_arrays(snap)
    base = np.asarray(jpreds.fits(parr, narr))
    jm = jmesh.make_mesh(N_DEV)
    with jm:
        ref = jpreds.fits(jmesh.replicate(parr, jm),
                          jmesh.shard_nodes(narr, jm))
    mesh = _tmesh()
    got = tpreds.fits(tmesh.replicate(_t(parr), mesh),
                      tmesh.shard_nodes(_t(narr), mesh))
    # output inherits the node sharding on its node axis (axis 1)
    assert isinstance(got, tmesh.ShardedTensor) and got.axis == 1
    assert len(got.addressable_shards) == N_DEV
    _eq(got, ref)
    _eq(got, base)
    _eq(tpreds.fits(_t(parr), _t(narr)), base)


@pytest.mark.parametrize("seed", [0, 1, 4])
def test_strict_engine_parity_under_mesh(seed):
    """place_batch (the sequential scan) on mesh-placed inputs reproduces
    the reference's sharded placement sequence exactly."""
    snap, pods = _cluster(seed)
    batch = PodBatch(pods, snap)
    parr = jpreds.pod_arrays(batch)
    narr = jpreds.node_arrays(snap)
    jm = jmesh.make_mesh(N_DEV)
    with jm:
        nsh = jmesh.shard_nodes(narr, jm)
        sel, fc, st, rr = jbatch.place_batch(
            jmesh.replicate(parr, jm), nsh, jbatch.node_state(nsh),
            jnp.uint32(0), PRIO)
    mesh = _tmesh()
    tn = tmesh.shard_nodes(_t(narr), mesh)
    tsel, tfc, tst, trr = tbatch.place_batch(
        tmesh.replicate(_t(parr), mesh), tn, tbatch.node_state(tn), _ctr(),
        PRIO)
    _eq(tsel, sel)
    _eq(tfc, fc)
    assert int(trr) == int(rr)
    _eq_state(tst, st)
    assert all(isinstance(t, tmesh.ShardedTensor) and t.axis == 0
               for t in tst)
    fsel, _fc, fst, _rr = tbatch.place_batch(
        _t(parr), _t(narr), tbatch.node_state(_t(narr)), _ctr(), PRIO)
    _eq(tsel, fsel)
    _eq(tst.requested, fst.requested)


@pytest.mark.parametrize("seed", [0, 3])
def test_wave_engine_parity_under_mesh(seed):
    """place_waves on mesh-placed inputs (the SPMD wave loop): the
    reference's sharded placements and final capacity state."""
    snap, pods = _cluster(seed, n_pods=64)
    cbatch = ClassBatch(pods, snap)
    cls = jpreds.pod_arrays(cbatch.reps_batch)
    narr = jpreds.node_arrays(snap)
    pc = cbatch.pod_class
    jm = jmesh.make_mesh(N_DEV)
    with jm:
        nsh = jmesh.shard_nodes(narr, jm)
        sel, fc, st, rr = jwaves.place_waves(
            jmesh.replicate(cls, jm), nsh, jbatch.node_state(nsh), pc, 0,
            PRIO)
    mesh = _tmesh()
    tn = tmesh.shard_nodes(_t(narr), mesh)
    tsel, tfc, tst, trr = twaves.place_waves(
        tmesh.replicate(_t(cls), mesh), tn, tbatch.node_state(tn), pc, 0,
        PRIO)
    np.testing.assert_array_equal(tsel, sel)
    np.testing.assert_array_equal(tfc, fc)
    assert trr == rr
    _eq(tst.pod_count, st.pod_count)
    _eq(tst.requested, st.requested)
    fsel, _fc, fst, frr = twaves.place_waves(
        _t(cls), _t(narr), tbatch.node_state(_t(narr)), pc, 0, PRIO)
    np.testing.assert_array_equal(tsel, fsel)
    assert trr == frr


def _dryrun_world(types, n_nodes, n_pending):
    """__graft_entry__._dryrun_multichip_impl's cluster: zones, racks,
    guard pods with required anti-affinity, a Service, and pending pods
    mixing spread targets, a zone co-location group, the guards' victims
    and preferred zone anti-affinity."""
    Gi = 1 << 30
    nodes = [types.make_node(f"node-{i:04d}", cpu=16000, memory=64 * Gi,
                             pods=110,
                             labels={"zone": f"z{i % 8}", "rack": f"r{i % 32}",
                                     "host": f"h{i}"})
             for i in range(n_nodes)]

    def term(app, key):
        return types.PodAffinityTerm(
            label_selector=types.LabelSelector(match_labels={"app": app}),
            namespaces=[], topology_key=key)
    existing = []
    for i in range(16):
        g = types.make_pod(f"guard-{i}", cpu=100, labels={"app": "guard"})
        g.affinity = types.Affinity(pod_anti_affinity=types.PodAffinity(
            required_terms=[term("victim", "rack")]))
        g.node_name = f"node-{i * (n_nodes // 16):04d}"
        existing.append(g)
    workloads = [types.WorkloadObject("Service", "svc-web", "default",
                                      match_labels={"app": "web"})]
    pending = []
    for i in range(n_pending):
        kind = i % 4
        app = ("web", "colo", "victim", "soft")[kind]
        p = types.make_pod(f"{app}-{i:03d}", cpu=200, memory=256 << 20,
                           labels={"app": app})
        if kind == 1:
            p.affinity = types.Affinity(pod_affinity=types.PodAffinity(
                required_terms=[term("colo", "zone")]))
        elif kind == 3:
            p.affinity = types.Affinity(pod_anti_affinity=types.PodAffinity(
                preferred_terms=[(50, term("soft", "zone"))]))
        pending.append(p)
    return nodes, existing, workloads, pending


def _affinity_inputs(nodes, existing, workloads, pending, node_pad=N_DEV):
    """SchedulingEngine.schedule's array construction, on the reference:
    (class arrays, pod classes, node arrays, AffinityData)."""
    from kubernetes_tpu.ops.affinity import (
        AffinityData,
        collect_pod_pairs,
        intern_topology_pairs,
    )
    infos = node_info_map(nodes, existing)
    snap = ClusterSnapshot(node_pad=node_pad)
    snap.refresh(infos)
    all_pairs, aff_pairs = collect_pod_pairs(infos)
    intern_topology_pairs(snap, pending, aff_pairs)
    cbatch = ClassBatch(pending, snap)
    c_pad = jpreds.bucket(cbatch.num_classes + 1)
    adata = AffinityData(cbatch.reps, snap, all_pairs, aff_pairs, workloads,
                         1, c_pad=c_pad)
    cls_arr = jpreds.pod_arrays_padded(cbatch.reps_batch, c_pad)
    pc = np.full(jpreds.bucket(len(pending)), cbatch.num_classes,
                 dtype=np.int32)
    pc[:len(pending)] = cbatch.pod_class
    return cls_arr, pc, jpreds.node_arrays(snap), adata


def _gather_both(cls_arr, pc, narr, aff, mode, priorities):
    """gather_place_batch on the reference's 8-device mesh, the port's
    8-shard mesh and the port unsharded."""
    jm = jmesh.make_mesh(N_DEV)
    with jm:
        nsh = jmesh.shard_nodes(narr, jm)
        ref = jbatch.gather_place_batch(
            jmesh.replicate(cls_arr, jm),
            jmesh.replicate({"pc": jnp.asarray(pc)}, jm)["pc"], nsh,
            jbatch.node_state(nsh), jnp.uint32(0), priorities,
            aff=jmesh.shard_affinity(aff, jm), aff_mode=mode)
    mesh = _tmesh()
    tn = tmesh.shard_nodes(_t(narr), mesh)
    got = tbatch.gather_place_batch(
        tmesh.replicate(_t(cls_arr), mesh),
        tmesh.place(torch.from_numpy(pc), mesh, None), tn,
        tbatch.node_state(tn), _ctr(), priorities,
        aff=tmesh.shard_affinity(_t(aff), mesh), aff_mode=mode)
    flat = tbatch.gather_place_batch(
        _t(cls_arr), torch.from_numpy(pc), _t(narr),
        tbatch.node_state(_t(narr)), _ctr(), priorities, aff=_t(aff),
        aff_mode=mode)
    return ref, got, flat


def _assert_gather_equal(ref, got, flat):
    _eq(got[0], ref[0])
    _eq(got[1], ref[1])
    assert int(got[3]) == int(ref[3])
    _eq_state(got[2], ref[2])
    _eq(got[0], flat[0])
    _eq(got[2].pod_count, flat[2].pod_count)


def test_dryrun_multichip_shape_runs_sharded():
    """The dryrun's own world at its test shape (512 nodes x 288 pending
    pods, every affinity feature on): the strict scan on mesh-placed
    operands equals the reference's sharded run and the unsharded port,
    every pod placed, spread over many nodes, the co-location group in
    one zone."""
    import kubernetes_tpu.api.types as jt
    nodes, existing, workloads, pending = _dryrun_world(jt, 512, 288)
    cls_arr, pc, narr, adata = _affinity_inputs(nodes, existing, workloads,
                                                pending)
    assert adata.fits_needed and adata.prio_needed and adata.spread_needed
    ref, got, flat = _gather_both(cls_arr, pc, narr, adata.device_arrays(),
                                  (True, True, True),
                                  jprio.DEFAULT_PRIORITIES)
    _assert_gather_equal(ref, got, flat)
    sel = np.asarray(got[0])[:len(pending)]
    assert (sel >= 0).all() and len(set(sel.tolist())) > 16
    colo_zones = {int(sel[i]) % 8 for i in range(len(pending)) if i % 4 == 1}
    assert len(colo_zones) == 1


def _affinity_cluster(seed, n_nodes=24, n_existing=12, n_pending=32):
    from tests.test_affinity_fuzz import _build_cluster, _pending
    rng = random.Random(seed)
    nodes, existing, workloads = _build_cluster(rng, n_nodes=n_nodes,
                                                n_existing=n_existing)
    return nodes, existing, workloads, _pending(rng, n_pending)


@pytest.mark.parametrize("seed", [0, 5])
def test_strict_engine_affinity_parity_under_mesh(seed):
    """The full strict scan WITH the inter-pod affinity + spread
    machinery on, sharded == the reference's sharded == unsharded."""
    cls_arr, pc, narr, adata = _affinity_inputs(*_affinity_cluster(seed))
    assert adata.fits_needed, "generator must exercise required affinity"
    assert adata.spread_needed or adata.prio_needed
    mode = (adata.fits_needed, adata.prio_needed, adata.spread_needed)
    ref, got, flat = _gather_both(cls_arr, pc, narr, adata.device_arrays(),
                                  mode, jprio.DEFAULT_PRIORITIES)
    assert (np.asarray(ref[0])[:32] >= 0).any()
    _assert_gather_equal(ref, got, flat)


@pytest.mark.parametrize("seed", [1])
def test_frozen_affinity_scores_parity_under_mesh(seed):
    """Wave mode's batch-frozen spread/interpod score matrix [C, N], one
    SPMD program per shard: equal to the reference's, sharded and not."""
    cls_arr, _pc, narr, adata = _affinity_inputs(*_affinity_cluster(seed))
    aff = adata.device_arrays()
    base = np.asarray(jwaves.frozen_affinity_scores(
        cls_arr, narr, jbatch.node_state(narr), aff, (2, 1)))
    jm = jmesh.make_mesh(N_DEV)
    with jm:
        nsh = jmesh.shard_nodes(narr, jm)
        ref = jwaves.frozen_affinity_scores(
            jmesh.replicate(cls_arr, jm), nsh, jbatch.node_state(nsh),
            jmesh.shard_affinity(aff, jm), (2, 1))
    mesh = _tmesh()
    tn = tmesh.shard_nodes(_t(narr), mesh)
    got = twaves.frozen_affinity_scores(
        tmesh.replicate(_t(cls_arr), mesh), tn, tbatch.node_state(tn),
        tmesh.shard_affinity(_t(aff), mesh), (2, 1))
    assert isinstance(got, tmesh.ShardedTensor) and got.axis == 1
    _eq(got, ref)
    _eq(got, base)
    assert base.any()


def test_two_stage_tie_select_matches_global():
    """_ShardCol's two-stage tie selection (local rank + gathered [D, C]
    prefix + ownership-masked sum) equals _GlobalCol's whole-axis lookup,
    the reference's included — empty tie sets and ties on shard edges
    too."""
    rng = np.random.default_rng(7)
    C, N, P_ = 5, 64, 40
    ties = rng.random((C, N)) < 0.2
    ties[3] = False                      # empty tie set
    ties[4, N - 1] = True                # tie on the last shard edge
    pod_class = rng.integers(0, C, P_).astype(np.int32)
    m = ties.sum(axis=1).astype(np.int32)
    draw = rng.integers(0, 1000, P_).astype(np.int32)
    kz = (draw % np.maximum(m[pod_class], 1)).astype(np.int32)
    ref = np.asarray(jwaves._GlobalCol(N).tie_select(
        jnp.asarray(ties), jnp.asarray(pod_class), jnp.asarray(kz)))
    t_ties = torch.from_numpy(ties)
    t_pc, t_kz = torch.from_numpy(pod_class), torch.from_numpy(kz)
    base = twaves._GlobalCol(N).tie_select(t_ties, t_pc, t_kz)
    np.testing.assert_array_equal(base.numpy(), ref)
    mesh = _tmesh()
    sh = tmesh.place(t_ties, mesh, 1)
    outs = tmesh.run_spmd(mesh, lambda d, g: twaves._ShardCol(
        g, d, N, N // N_DEV).tie_select(sh.shards[d], t_pc, t_kz))
    for got in outs:
        np.testing.assert_array_equal(got.numpy(), ref)


def test_spmd_waves_loop_matches_global():
    """waves_loop(spmd_mesh=...) — the whole wave loop once per shard with
    the two-stage reduce — gives the identical packed result and final
    NodeState as the single-device run and the reference's SPMD run."""
    snap, pods = _cluster(3, n_nodes=24, n_pods=48)
    cbatch = ClassBatch(pods, snap)
    cls = jpreds.pod_arrays(cbatch.reps_batch)
    narr = jpreds.node_arrays(snap)
    pc = cbatch.pod_class
    jpacked, jst = jwaves.waves_loop(
        cls, narr, jbatch.node_state(narr), jnp.asarray(pc), jnp.uint32(0),
        PRIO, 32, spmd_mesh=jmesh.make_mesh(N_DEV))
    tn = _t(narr)
    packed0, st0 = twaves.waves_loop(
        _t(cls), tn, tbatch.node_state(tn), torch.from_numpy(pc), _ctr(),
        PRIO, 32)
    packed1, st1 = twaves.waves_loop(
        _t(cls), tn, tbatch.node_state(tn), torch.from_numpy(pc), _ctr(),
        PRIO, 32, spmd_mesh=_tmesh())
    np.testing.assert_array_equal(packed1.numpy(), packed0.numpy())
    _eq(packed1, jpacked)
    _eq_state(st1, jst)
    _eq(st1.requested, st0.requested)
    _eq(st1.pod_count, st0.pod_count)


# ------------------------------------------------------------- residency


def _mesh_sched(side, n_nodes, mesh):
    if side == "port":
        from kubernetes_tpu_torch.engine.scheduler import Scheduler
        from kubernetes_tpu_torch.models.hollow import (hollow_nodes,
                                                         load_cluster)
        from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite
        kw = {"device": "cpu"}
    else:
        from kubernetes_tpu.engine.scheduler import Scheduler
        from kubernetes_tpu.models.hollow import hollow_nodes, load_cluster
        from kubernetes_tpu.server.apiserver_lite import ApiServerLite
        kw = {}
    api = ApiServerLite()
    load_cluster(api, hollow_nodes(n_nodes), [])
    s = Scheduler(api, record_events=False, mesh=mesh, **kw)
    s.start()
    return api, s


def _profiles(side):
    if side == "port":
        from kubernetes_tpu_torch.models.hollow import PROFILES
    else:
        from kubernetes_tpu.models.hollow import PROFILES
    return PROFILES


def _drain(side, mesh, n_nodes=64, n_pods=200, profile="density"):
    api, s = _mesh_sched(side, n_nodes, mesh)
    for p in _profiles(side)[profile](n_pods):
        api.create("Pod", p)
    s.run_until_drained(max_batch=64)
    if side == "port":
        s.engine.close()
    return {p.name: p.node_name for p in api.list("Pod")[0]}, s


def test_resident_engine_partition_specs_and_identity():
    """A tiny drain on the resident-mesh engine pins (a) the layout —
    node-axis tensors sharded over all 8 shards, pod-side replicated —
    and (b) placements equal to the unsharded engine and to the
    reference's 8-device mesh."""
    p0, _ = _drain("port", None)
    p1, s1 = _drain("port", _tmesh())
    pr, _ = _drain("ref", jmesh.make_mesh(N_DEV))
    assert p0 == p1 == pr and all(p0.values())
    dev = s1.engine._device_nodes
    for k in ("alloc", "requested", "labels", "pod_count"):
        t = dev[k]
        assert isinstance(t, tmesh.ShardedTensor) and t.axis == 0, k
        n = t.shape[0]
        assert len(t.addressable_shards) == N_DEV, k
        assert all(s.data.shape[0] == n // N_DEV
                   for s in t.addressable_shards), k
    assert dev["pd_kind"].axis is None
    assert all(s.data.shape == dev["pd_kind"].shape
               for s in dev["pd_kind"].addressable_shards)
    # the sharded sync armed row tracking on the snapshot
    assert s1.engine.snapshot.dirty_rows is not None


def _stream(side, mesh):
    api, s = _mesh_sched(side, 48, mesh)
    if side == "port":
        from kubernetes_tpu_torch.utils.trace import COUNTERS
    else:
        from kubernetes_tpu.utils.trace import COUNTERS
    profiles = _profiles(side)
    trace = (37, 96, 5, 64)
    quantum = 128
    loop = s.stream(budget_s=30.0, min_quantum=quantum, max_quantum=quantum)
    for p in profiles["density"](quantum):
        p.name = "warm-" + p.name
        api.create("Pod", p)
    loop.step()
    loop.drain()
    snap0 = COUNTERS.snapshot()
    for gi, group in enumerate(trace):
        for p in profiles["density"](group):
            p.name = f"g{gi}-{p.name}"
            api.create("Pod", p)
        loop.step()
    loop.drain()
    loop.close()
    if side == "port":
        s.engine.close()
    snap1 = COUNTERS.snapshot()

    def delta(name):
        return snap1.get(name, (0, 0))[0] - snap0.get(name, (0, 0))[0]
    return ({p.name: p.node_name for p in api.list("Pod")[0]},
            {k: delta(k) for k in ("engine.wave_encode_build",
                                   "engine.shard_delta_rows",
                                   "snapshot.assume_delta_rows")},
            sum(trace))


def test_stream_sharded_equals_unsharded_frozen_trace():
    """The streaming micro-wave path on a mesh-resident scheduler: the same
    frozen arrival trace binds every pod to the same node as the unsharded
    port and the reference's mesh, with zero encode rebuilds after warmup
    and the assume folds riding the per-shard row path."""
    pa, _, _ = _stream("port", None)
    pb, counters, total = _stream("port", _tmesh())
    pr, _, _ = _stream("ref", jmesh.make_mesh(N_DEV))
    assert pa == pb == pr, {k: (pa[k], pb[k]) for k in pa if pa[k] != pb[k]}
    assert all(v for v in pa.values())
    assert counters["engine.wave_encode_build"] == 0
    assert counters["engine.shard_delta_rows"] > 0
    assert counters["snapshot.assume_delta_rows"] >= total


def test_three_shards_pad_the_node_axis_to_lcm():
    """D = 3 does not divide the baseline 8-row padding: the snapshot pads
    the node axis to lcm(8, 3) = 24, the shards are equal, and the drain
    equals the unsharded one and the reference's 3-device mesh."""
    p0, _ = _drain("port", None, n_nodes=20, n_pods=150)
    p3, s3 = _drain("port", _tmesh(3), n_nodes=20, n_pods=150)
    pr, _ = _drain("ref", jmesh.make_mesh(3), n_nodes=20, n_pods=150)
    assert p0 == p3 == pr and all(p0.values())
    alloc = s3.engine._device_nodes["alloc"]
    assert alloc.shape[0] == 24 and [s.shape[0] for s in alloc.shards] \
        == [8, 8, 8]


def test_a_shard_that_raises_fails_the_loop_fast(monkeypatch):
    """A shard raising mid-loop aborts the rendezvous: waves_loop re-raises
    its error within seconds (the rendezvous timeout is minutes) and no
    shard thread is left behind."""
    snap, pods = _cluster(3)
    cbatch = ClassBatch(pods, snap)
    cls = _t(jpreds.pod_arrays(cbatch.reps_batch))
    tn = _t(jpreds.node_arrays(snap))
    real = twaves._ShardCol.take2
    calls = {}

    def take2(self, arr, rows, cols):
        n = calls[self.d] = calls.get(self.d, 0) + 1
        if self.d == 5 and n == 3:
            raise RuntimeError("boom on shard 5")
        return real(self, arr, rows, cols)
    monkeypatch.setattr(twaves._ShardCol, "take2", take2)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="boom on shard 5"):
        twaves.waves_loop(cls, tn, tbatch.node_state(tn),
                          torch.from_numpy(cbatch.pod_class), _ctr(), PRIO,
                          32, spmd_mesh=_tmesh())
    assert time.monotonic() - t0 < 30
    assert not [t for t in threading.enumerate()
                if t.name.startswith("spmd-shard-")]


def test_a_missing_shard_times_out_the_rendezvous(monkeypatch):
    """Every wait has a timeout: a shard that never reaches a combine the
    others wait at fails the program instead of hanging it."""
    def body(d, group):
        if d == 1:
            return None
        return group.exchange(d, torch.ones(2), tmesh.COMBINES["sum"])
    monkeypatch.setattr(tmesh, "SPMD_TIMEOUT_S", 0.5)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        tmesh.run_spmd(_tmesh(4), body)
    assert time.monotonic() - t0 < 10


def test_fast_lane_reads_mesh_resident_nodes():
    """The fast lane's device route reads the engine's resident node
    tensors, sharded under a mesh: ShardedTensor.index_select gathers the
    sampled rows from the shards owning them, so sample_eval gives the
    same [winner, fit count, score] as on the whole tensors."""
    from kubernetes_tpu_torch.ops import fastlane as fast_ops
    snap, _ = _cluster(2, n_nodes=40)
    nodes = _t({k: v for k, v in jpreds.node_arrays(snap).items()
                if k in fast_ops.FAST_NODE_KEYS})
    sharded = tmesh.shard_nodes(nodes, _tmesh())
    rng = np.random.default_rng(5)
    n = int(nodes["alloc"].shape[0])
    for _ in range(20):
        idx = rng.integers(0, n, 16)
        req = np.asarray(nodes["alloc"][int(idx[0])].numpy() // 8,
                         dtype=np.int32)
        for be in (False, True):
            want = fast_ops.sample_eval(idx, req, False, be, nodes)
            got = fast_ops.sample_eval(idx, req, False, be, sharded)
            np.testing.assert_array_equal(np.asarray(got),
                                          np.asarray(want))


def test_relist_keeps_the_mesh():
    """A relist (the watch fell behind) builds a fresh engine; the port
    hands it the scheduler's mesh, so residency survives (the reference's
    _relist drops it: a deliberate departure, ROADMAP §3), and the drain
    after it still equals the unsharded one."""
    mesh = _tmesh(4)
    api, s = _mesh_sched("port", 32, mesh)
    s._relist()
    assert s.engine.mesh is mesh
    for p in _profiles("port")["density"](100):
        api.create("Pod", p)
    s.run_until_drained(max_batch=64)
    s.engine.close()
    assert isinstance(s.engine._device_nodes["alloc"], tmesh.ShardedTensor)
    got = {p.name: p.node_name for p in api.list("Pod")[0]}
    want, _ = _drain("port", None, n_nodes=32, n_pods=100)
    assert got == want and all(got.values())


@pytest.mark.parametrize("d", [2, 4])
def test_combine_locked_keeps_placements(d, monkeypatch):
    """ShardGroup's combine step is `_combine_locked`, the name graftlint
    reads as "the caller holds the lock" (GL007): every call runs under
    the group's condition, and a drain on D CPU shards gives the
    unsharded drain's placements and the reference's D-device mesh's."""
    assert not hasattr(tmesh.ShardGroup, "_combine")
    real = tmesh.ShardGroup._combine_locked
    held = []

    def combine_locked(self, combine):
        held.append(self._cv._is_owned())
        return real(self, combine)

    monkeypatch.setattr(tmesh.ShardGroup, "_combine_locked", combine_locked)
    p0, _ = _drain("port", None)
    pd, _ = _drain("port", _tmesh(d))
    pr, _ = _drain("ref", jmesh.make_mesh(d))
    assert p0 == pd == pr and all(p0.values())
    assert held and all(held)


# ------------------------------------------- the strict tails, per shard

TAIL_D = [2, 3, 4, 8]
TAIL_PAD = 24            # lcm(8, 3): every TAIL_D splits the node axis


@contextlib.contextmanager
def _tails_on_shards(widths):
    """Armed around a strict tail: any assembly of a sharded node axis
    (ShardedTensor.full, under __array__, an off-axis index_select and a
    re-placement alike) raises, and the node width of every capacity and
    incidence kernel call is appended to `widths`."""
    from kubernetes_tpu_torch.ops import kernels

    def gather(self):
        raise AssertionError("a strict tail gathered the node axis")

    def spy(name, width_of):
        real = getattr(kernels, name)

        def call(*a, **kw):
            widths.append((name, int(width_of(*a))))
            return real(*a, **kw)
        return call
    with mock.patch.object(tmesh.ShardedTensor, "full", gather), \
            mock.patch.object(kernels, "capacity_fit", spy(
                "capacity_fit", lambda req, alloc, *r: alloc.shape[0])), \
            mock.patch.object(kernels, "capacity_headroom", spy(
                "capacity_headroom", lambda req, z, alloc, *r:
                alloc.shape[0])), \
            mock.patch.object(kernels, "incidence_matmul", spy(
                "incidence_matmul", lambda a, b_t: b_t.shape[0])):
        yield


def _per_shard_widths(widths, n_local, need=("capacity_fit",)):
    assert widths, "the tail launched no kernel"
    assert {w for _, w in widths} == {n_local}, sorted(set(widths))
    for name in need:
        assert any(k == name for k, _ in widths), (name, widths[:4])


def _sharded_state(st, d, axis=0):
    for t in st:
        assert isinstance(t, tmesh.ShardedTensor) and t.axis == axis
        assert len(t.shards) == d


@functools.lru_cache(maxsize=None)
def _scan_world(seed):
    """(pod arrays, node arrays) of a random cluster padded to TAIL_PAD,
    the reference's sharded scan on its 8-device mesh, and the port's
    unsharded scan."""
    rng = random.Random(seed)
    nodes = random_nodes(rng, 40)
    names = [n.name for n in nodes]
    pods = [random_pod(rng, i, names) for i in range(40)]
    snap = ClusterSnapshot(node_pad=TAIL_PAD)
    snap.refresh(node_info_map(nodes, []))
    parr = jpreds.pod_arrays(PodBatch(pods, snap))
    narr = jpreds.node_arrays(snap)
    jm = jmesh.make_mesh(N_DEV)
    with jm:
        nsh = jmesh.shard_nodes(narr, jm)
        ref = jbatch.place_batch(jmesh.replicate(parr, jm), nsh,
                                 jbatch.node_state(nsh), jnp.uint32(7), PRIO)
    flat = tbatch.place_batch(_t(parr), _t(narr),
                              tbatch.node_state(_t(narr)), _ctr(7), PRIO)
    return parr, narr, ref, flat


@pytest.mark.parametrize("d", TAIL_D)
def test_place_batch_runs_per_shard(d):
    """The seeded strict scan on a D-shard mesh: no step assembles the
    node axis, every capacity launch is at N/D, and placements, fit
    counts, the counter and the final state equal the reference's sharded
    scan and the port's unsharded one; the state comes back sharded on
    axis 0."""
    parr, narr, ref, flat = _scan_world(0)
    n = narr["alloc"].shape[0]
    tn = tmesh.shard_nodes(_t(narr), _tmesh(d))
    widths = []
    with _tails_on_shards(widths):
        sel, fc, st, rr = tbatch.place_batch(
            _t(parr), tn, tbatch.node_state(tn), _ctr(7), PRIO)
    _per_shard_widths(widths, n // d)
    _eq(sel, ref[0])
    _eq(fc, ref[1])
    assert int(rr) == int(ref[3]) == int(flat[3])
    _eq_state(st, ref[2])
    _eq(sel, flat[0])
    _sharded_state(st, d)
    assert (np.asarray(sel) >= 0).sum() > 20


@functools.lru_cache(maxsize=None)
def _gather_world(seed):
    """An affinity world padded to TAIL_PAD with a nonzero occupancy seed:
    (inputs, the seed's committed [C, N], the reference's scan on its
    8-device mesh with the seed as (commdom, committed, comm_cnt), the
    port's unsharded scan deriving commdom and comm_cnt from committed)."""
    cls_arr, pc, narr, adata = _affinity_inputs(*_affinity_cluster(seed),
                                                node_pad=TAIL_PAD)
    aff = adata.device_arrays()
    n = narr["alloc"].shape[0]
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, 2, (cls_arr["req"].shape[0], n)).astype(np.int32)
    comm[int(pc.max()):] = 0
    comm[:, ~np.asarray(narr["valid"], bool)] = 0
    commdom = (comm.astype(np.int64) @ narr["labels"].astype(np.int64)
               ).astype(np.int32)
    cnt = comm.sum(axis=1).astype(np.int32)
    mode = (True, True, True)
    jm = jmesh.make_mesh(N_DEV)
    with jm:
        nsh = jmesh.shard_nodes(narr, jm)
        ref = jbatch.gather_place_batch(
            jmesh.replicate(cls_arr, jm), jnp.asarray(pc), nsh,
            jbatch.node_state(nsh), jnp.uint32(5), jprio.DEFAULT_PRIORITIES,
            aff=jmesh.shard_affinity(aff, jm), aff_mode=mode,
            aff_init=tuple(jnp.asarray(a) for a in (commdom, comm, cnt)))
    flat = tbatch.gather_place_batch(
        _t(cls_arr), torch.from_numpy(pc), _t(narr),
        tbatch.node_state(_t(narr)), _ctr(5), jprio.DEFAULT_PRIORITIES,
        aff=_t(aff), aff_mode=mode,
        aff_init=(None, torch.from_numpy(comm), None))
    return (cls_arr, pc, narr, aff), comm, ref, flat


@pytest.mark.parametrize("d", TAIL_D)
def test_gather_place_batch_with_affinity_runs_per_shard(d):
    """gather_place_batch with fits, interpod and spread on and an
    occupancy seed: the class precompute, the step statistics, the tie
    ranks and the seed's contraction over nodes all run per shard (every
    capacity and incidence launch at N/D, nothing assembled), equal to the
    reference's sharded scan and the port's unsharded one."""
    (cls_arr, pc, narr, aff), comm, ref, flat = _gather_world(0)
    n = narr["alloc"].shape[0]
    mesh = _tmesh(d)
    tn = tmesh.shard_nodes(_t(narr), mesh)
    widths = []
    with _tails_on_shards(widths):
        got = tbatch.gather_place_batch(
            _t(cls_arr), torch.from_numpy(pc), tn, tbatch.node_state(tn),
            _ctr(5), jprio.DEFAULT_PRIORITIES,
            aff=tmesh.shard_affinity(_t(aff), mesh), aff_mode=(True,) * 3,
            aff_init=(None, tmesh.place(torch.from_numpy(comm), mesh,
                                        tmesh.committed_spec()), None))
    _per_shard_widths(widths, n // d, ("capacity_fit", "incidence_matmul"))
    _assert_gather_equal(ref, got, flat)
    assert int(got[3]) == int(flat[3])
    _eq_state(got[2], flat[2])
    _sharded_state(got[2], d)
    assert (np.asarray(got[0])[:24] >= 0).sum() > 12


@functools.lru_cache(maxsize=None)
def _rounds_world(seed):
    """The conflict-round tail's inputs over the same affinity world, the
    reference's tail on its 8-device mesh and the port's unsharded one."""
    (cls_arr, pc, narr, aff), comm, _r, _f = _gather_world(seed)
    mode = (True, True, False)
    prios = tuple(p for p in jprio.DEFAULT_PRIORITIES
                  if p[0] != "SelectorSpreadPriority")
    commdom = (comm.astype(np.int64) @ narr["labels"].astype(np.int64)
               ).astype(np.int32)
    cnt = comm.sum(axis=1).astype(np.int32)
    jm = jmesh.make_mesh(N_DEV)
    with jm:
        nsh = jmesh.shard_nodes(narr, jm)
        ref = jwaves.tail_rounds_loop(
            jmesh.replicate(cls_arr, jm), nsh, jbatch.node_state(nsh),
            jnp.asarray(pc), jnp.uint32(9), prios,
            aff=jmesh.shard_affinity(aff, jm), aff_mode=mode,
            aff_init=tuple(jnp.asarray(a) for a in (commdom, comm, cnt)))
    flat = twaves.tail_rounds_loop(
        _t(cls_arr), _t(narr), tbatch.node_state(_t(narr)),
        torch.from_numpy(pc), _ctr(9), prios, aff=_t(aff), aff_mode=mode,
        aff_init=(None, torch.from_numpy(comm), None))
    return (cls_arr, pc, narr, aff), comm, prios, ref, flat


@pytest.mark.parametrize("d", TAIL_D)
def test_tail_rounds_loop_with_affinity_runs_per_shard(d):
    """The conflict-round tail with the required mask and interpod scoring
    on: every round's capacity step and incidence product run per shard,
    the commits land on the owning shards, and the packed result (every
    placement, fit count, the counter, the round count) and the final
    state equal the reference's sharded tail and the port's unsharded
    one."""
    (cls_arr, pc, narr, aff), comm, prios, ref, flat = _rounds_world(0)
    n = narr["alloc"].shape[0]
    mesh = _tmesh(d)
    tn = tmesh.shard_nodes(_t(narr), mesh)
    widths = []
    with _tails_on_shards(widths):
        packed, st = twaves.tail_rounds_loop(
            _t(cls_arr), tn, tbatch.node_state(tn), torch.from_numpy(pc),
            _ctr(9), prios, aff=tmesh.shard_affinity(_t(aff), mesh),
            aff_mode=(True, True, False),
            aff_init=(None, tmesh.place(torch.from_numpy(comm), mesh,
                                        tmesh.committed_spec()), None))
    _per_shard_widths(widths, n // d,
                      ("capacity_headroom", "incidence_matmul"))
    _eq(packed, ref[0])
    _eq_state(st, ref[1])
    np.testing.assert_array_equal(packed.numpy(), flat[0].numpy())
    _eq_state(st, flat[1])
    _sharded_state(st, d)
    assert int(packed[-1]) > 1


def _hollow(side):
    if side == "port":
        from kubernetes_tpu_torch.engine import scheduler_engine as eng
        from kubernetes_tpu_torch.models import hollow
        from kubernetes_tpu_torch.state.cache import SchedulerCache
        from kubernetes_tpu_torch.utils.trace import COUNTERS
    else:
        from kubernetes_tpu.engine import scheduler_engine as eng
        from kubernetes_tpu.models import hollow
        from kubernetes_tpu.state.cache import SchedulerCache
        from kubernetes_tpu.utils.trace import COUNTERS
    return eng, hollow, SchedulerCache, COUNTERS


def _classic_round(side, mesh):
    """One classic wave-mode round of a mixed_affinity batch at 48 nodes
    with 60 pods already bound: (placements, fit counts, counter, strict
    rows counted)."""
    eng_mod, hollow, SchedulerCache, COUNTERS = _hollow(side)
    cache = SchedulerCache()
    nodes = hollow.hollow_nodes(48)
    for nd in nodes:
        cache.add_node(nd)
    pods = hollow.mixed_affinity_pods(260)
    for i, p in enumerate(pods[:60]):
        p.node_name = nodes[(5 * i) % 48].name
        cache.add_pod(p)
    kw = {"device": "cpu"} if side == "port" else {}
    eng = eng_mod.SchedulingEngine(cache, mesh=mesh, **kw)
    COUNTERS.reset()
    res = eng.schedule(pods[60:], mode="wave")
    strict = COUNTERS.snapshot().get("engine.classic_strict_rows", (0,))[0]
    return ([r.node_name for r in res], [r.fit_count for r in res],
            eng.rr.counter, strict)


@functools.lru_cache(maxsize=None)
def _classic_ref():
    return (_classic_round("ref", jmesh.make_mesh(N_DEV)),
            _classic_round("port", None))


@pytest.mark.parametrize("d", TAIL_D)
def test_classic_round_strict_rows_run_per_shard(d):
    """SchedulingEngine.schedule in wave mode on a D-shard mesh: the
    classic round's strict rows (the pack-into-one-zone classes) take the
    seeded scan per shard — the seed built from the wave's sharded
    per-node occupancy — with nothing assembled and every launch at N/D,
    and the round equals the reference's on its 8-device mesh and the
    port's unsharded round."""
    from kubernetes_tpu_torch.engine import scheduler_engine as teng
    from kubernetes_tpu_torch.engine import waves as tw
    ref, flat = _classic_ref()
    widths = []
    seeds = []
    real = teng.gather_place_batch

    def strict_scan(*a, **kw):
        seeds.append(kw.get("aff_init"))
        with _tails_on_shards(widths):
            return real(*a, **kw)
    with mock.patch.object(teng, "gather_place_batch", strict_scan), \
            mock.patch.object(tw, "gather_place_batch", strict_scan):
        got = _classic_round("port", _tmesh(d))
    assert got[3] > 0 and seeds, "no strict row ran"
    n = 48 + (-48) % math.lcm(8, d)
    _per_shard_widths(widths, n // d)
    committed = [s[1] for s in seeds if s is not None]
    assert committed and all(isinstance(c, tmesh.ShardedTensor)
                             and c.axis == 1 for c in committed)
    assert got[:3] == ref[:3]
    assert got == flat


def _pipelined(side, mesh, tail_rounds):
    """A pipelined mixed_affinity drain at 48 nodes x 400 pods in chunks
    of 128 whose harvests run a strict tail: the conflict rounds
    (tail_rounds_min 1) or the per-pod scan. Returns (placements, tail
    dispatches, round dispatches)."""
    eng_mod, hollow, _c, COUNTERS = _hollow(side)
    api, s = _mesh_sched(side, 48, mesh)
    s.engine.tail_rounds = tail_rounds
    s.engine.tail_rounds_min = 1
    for p in hollow.mixed_affinity_pods(400):
        api.create("Pod", p)
    COUNTERS.reset()
    s.run_until_drained(max_batch=128)
    snap = COUNTERS.snapshot()
    if side == "port":
        s.engine.close()
    return ({p.name: p.node_name for p in api.list("Pod")[0]},
            snap.get("engine.wave_tail_dispatch", (0,))[0],
            snap.get("engine.tail_round_dispatch", (0,))[0])


@functools.lru_cache(maxsize=None)
def _pipelined_ref(tail_rounds):
    return (_pipelined("ref", jmesh.make_mesh(N_DEV), tail_rounds),
            _pipelined("port", None, tail_rounds))


@pytest.mark.parametrize("route", ["rounds", "scan"])
@pytest.mark.parametrize("d", TAIL_D)
def test_pipelined_strict_tail_runs_per_shard(d, route):
    """A pipelined drain on a D-shard mesh whose harvests finish a strict
    tail, through the conflict rounds and through the per-pod scan
    (engine.tail_rounds False, set by _pipelined): the tail's seed is the
    wave's sharded per-node occupancy, nothing is assembled, every launch
    is at N/D, and the placements equal the reference's drain on its
    8-device mesh and the port's unsharded drain."""
    from kubernetes_tpu_torch.engine import scheduler_engine as teng
    ref, flat = _pipelined_ref(route == "rounds")
    widths = []
    seeds = []
    real = teng.SchedulingEngine._harvest_tail

    def harvest_tail(self, handle, *a, **kw):
        seeds.append(handle.committed_out)
        with _tails_on_shards(widths):
            return real(self, handle, *a, **kw)
    with mock.patch.object(teng.SchedulingEngine, "_harvest_tail",
                           harvest_tail):
        got = _pipelined("port", _tmesh(d), route == "rounds")
    assert got[1] > 0, "no harvest ran a strict tail"
    assert (got[2] > 0) == (route == "rounds")
    n = 48 + (-48) % math.lcm(8, d)
    _per_shard_widths(widths, n // d, ("capacity_fit", "incidence_matmul")
                      if route == "scan" else
                      ("capacity_headroom", "incidence_matmul"))
    assert all(isinstance(c, tmesh.ShardedTensor) and c.axis == 1
               for c in seeds if c is not None)
    assert got[0] == ref[0] == flat[0]
    assert got[1:] == ref[1:] == flat[1:]
    assert all(got[0].values())


def _strict_round(side, mesh):
    """SchedulingEngine.schedule in strict mode (every pod through the
    scan) of 40 mixed_affinity pods at 48 nodes: (placements, fit counts,
    counter)."""
    eng_mod, hollow, SchedulerCache, _C = _hollow(side)
    cache = SchedulerCache()
    for nd in hollow.hollow_nodes(48):
        cache.add_node(nd)
    kw = {"device": "cpu"} if side == "port" else {}
    eng = eng_mod.SchedulingEngine(cache, mesh=mesh, **kw)
    res = eng.schedule(hollow.mixed_affinity_pods(40), mode="strict")
    return ([r.node_name for r in res], [r.fit_count for r in res],
            eng.rr.counter)


def _stragglers(side, mesh):
    """waves.place_waves cut at one wave, so the strict scan finishes the
    stragglers: (placements, fit counts, counter)."""
    snap, pods = _cluster(6, n_nodes=20, n_pods=90)
    cbatch = ClassBatch(pods, snap)
    cls = jpreds.pod_arrays_padded(cbatch.reps_batch,
                                   jpreds.bucket(cbatch.num_classes + 1))
    narr = jpreds.node_arrays(snap)
    stats = {}
    if side == "ref" and mesh is None:
        out = jwaves.place_waves(cls, narr, jbatch.node_state(narr),
                                 cbatch.pod_class, 3, PRIO, 1)
    elif side == "ref":
        with mesh:
            nsh = jmesh.shard_nodes(narr, mesh)
            out = jwaves.place_waves(jmesh.replicate(cls, mesh), nsh,
                                     jbatch.node_state(nsh),
                                     cbatch.pod_class, 3, PRIO, 1)
    else:
        tn = _t(narr) if mesh is None else tmesh.shard_nodes(_t(narr), mesh)
        out = twaves.place_waves(_t(cls), tn, tbatch.node_state(tn),
                                 cbatch.pod_class, 3, PRIO, 1, stats=stats)
        assert stats["stragglers"] > 0
    return (np.asarray(out[0]).tolist(), np.asarray(out[1]).tolist(),
            int(out[3]))


_CALLERS = {
    "classic-strict": lambda side, mesh: _strict_round(side, mesh),
    "classic-strict-rows": lambda side, mesh: _classic_round(side, mesh)[:3],
    "pipelined-scan-tail": lambda side, mesh: _pipelined(side, mesh, False),
    "stragglers": _stragglers,
}


@pytest.mark.parametrize("sharded", [False, True], ids=["flat", "mesh8"])
@pytest.mark.parametrize("caller", sorted(_CALLERS))
def test_scan_steps_only_live_rows(caller, sharded, monkeypatch):
    """Each of the scan's four callers (the classic round in strict mode,
    its wave-mode strict rows, the pipelined drain's per-pod tail, with
    engine.tail_rounds False, and the wave loop's stragglers) hands it the
    live pods only — no row of the inert sink class — and its result
    equals the reference's, whose scan steps the padded rows, unsharded
    and on an 8-shard mesh."""
    from kubernetes_tpu_torch.engine import scheduler_engine as teng
    from kubernetes_tpu_torch.engine import waves as tw
    stepped = []
    real = tbatch.gather_place_batch

    def scan(cls_arr, pc, *a, **kw):
        pcs = np.asarray(pc)
        stepped.append(len(pcs))
        # the inert class is the last class row; a live row never uses it
        assert (pcs < cls_arr["req"].shape[0] - 1).all(), pcs
        return real(cls_arr, pc, *a, **kw)
    monkeypatch.setattr(teng, "gather_place_batch", scan)
    monkeypatch.setattr(tw, "gather_place_batch", scan)
    fn = _CALLERS[caller]
    got = fn("port", _tmesh(N_DEV) if sharded else None)
    want = fn("ref", jmesh.make_mesh(N_DEV) if sharded else None)
    assert stepped and all(stepped), "the scan did not run"
    assert got == want


def test_shards_take_turns_under_a_short_switch_interval():
    """Stress of ShardGroup's turns: 16 shard threads (more than the
    cores) under a shortened switch interval, 200 exchanges each. Between
    two exchanges exactly one shard runs, in shard order, so the log of
    (round, shard) entries is strictly ordered, and every combine is the
    exact sum; a lost turn or a lost deposit breaks one or the other."""
    import sys
    d_count, rounds = 16, 200
    log = []

    def body(d, group):
        total = 0
        for r in range(rounds):
            log.append((r, d))
            s = group.exchange(d, torch.tensor([d + r]), tmesh.COMBINES["sum"])
            total += int(s)
        return total
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t0 = time.monotonic()
        out = tmesh.run_spmd(_tmesh(d_count), body)
        assert time.monotonic() - t0 < 60
    finally:
        sys.setswitchinterval(old)
    want = sum(sum(d + r for d in range(d_count)) for r in range(rounds))
    assert out == [want] * d_count
    assert log == [(r, d) for r in range(rounds) for d in range(d_count)]
    assert not [t for t in threading.enumerate()
                if t.name.startswith("spmd-shard-")]
