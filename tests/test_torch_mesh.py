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

import random
import threading
import time

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


def _affinity_inputs(nodes, existing, workloads, pending):
    """SchedulingEngine.schedule's array construction, on the reference:
    (class arrays, pod classes, node arrays, AffinityData)."""
    from kubernetes_tpu.ops.affinity import (
        AffinityData,
        collect_pod_pairs,
        intern_topology_pairs,
    )
    infos = node_info_map(nodes, existing)
    snap = ClusterSnapshot(node_pad=N_DEV)
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
