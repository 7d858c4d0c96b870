"""The port's affinity half of the wave engine on the CPU against the
reference package, exactly: the per-wave anti-affinity mask, the frozen
interpod/spread scores (with a Service in the workload set), the wave loop
with the occupancy carry, the conflict-round tail and the strict loop with
the affinity carry. Every input is built once by the reference engine's own
encoder (a mixed-affinity chunk over a cluster with bound affinity pods),
carried across as the same numpy arrays, and every output is compared with
assert_array_equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api.types import WorkloadObject
from kubernetes_tpu.engine import batch as jbatch
from kubernetes_tpu.engine import waves as jwaves
from kubernetes_tpu.engine.scheduler_engine import \
    SchedulingEngine as JEngine
from kubernetes_tpu.models import hollow as jh
from kubernetes_tpu.ops import affinity as jaff
from kubernetes_tpu.state.cache import SchedulerCache as JCache
from kubernetes_tpu_torch.convert import arrays_from_numpy
from kubernetes_tpu_torch.engine import batch as tbatch
from kubernetes_tpu_torch.engine import waves as twaves
from kubernetes_tpu_torch.ops import affinity as taff

PRIORITIES = (("LeastRequestedPriority", 1),
              ("BalancedResourceAllocation", 1),
              ("NodePreferAvoidPodsPriority", 10000),
              ("NodeAffinityPriority", 1),
              ("TaintTolerationPriority", 1),
              ("InterPodAffinityPriority", 1),
              ("SelectorSpreadPriority", 1))
KERNEL = tuple(p for p in PRIORITIES
               if p[0] not in ("InterPodAffinityPriority",
                               "SelectorSpreadPriority"))
NO_SPREAD = tuple(p for p in PRIORITIES if p[0] != "SelectorSpreadPriority")


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


class _World:
    """A mixed-affinity chunk encoded by the reference engine, with the
    same arrays as numpy (for the reference) and tensors (for the port)."""

    def __init__(self):
        cache = JCache()
        for nd in jh.hollow_nodes(40, seed=3):
            cache.add_node(nd)
        names = sorted(cache.node_infos())
        pods = jh.mixed_affinity_pods(260)
        # bound pods (affinity ones among them) make the static forbid,
        # allow and priority rows non-trivial
        for i, p in enumerate(pods[:100]):
            p.node_name = names[(7 * i) % len(names)]
            cache.add_pod(p)
        svc = WorkloadObject("Service", "web", namespace="bench",
                             match_labels={"app": "web-1"})
        eng = JEngine(cache, priorities=PRIORITIES,
                      workloads_provider=lambda: [svc])
        infos = eng._refresh()
        enc, pc = eng._wave_encoding(pods[100:], infos)
        assert enc.fits_on and enc.prio_on and enc.spread_on
        assert enc.wave_strict.any() and enc.adata.wave_gate.any()
        self.enc = enc
        self.pc = pc
        self.c_pad = enc.c_pad
        self.cls = _np(enc.cls_arr)
        self.nodes = _np(eng._nodes_on_device())
        self.n = self.nodes["alloc"].shape[0]
        self.aff_wave = _np(enc.aff_wave_dev)
        self.aff_tail = _np(enc.aff_tail_dev)
        self.aff_full = _np(enc.adata.device_arrays())
        self.t_cls = arrays_from_numpy(self.cls, "cpu")
        self.t_nodes = arrays_from_numpy(self.nodes, "cpu")

    def committed(self, seed, hi=3):
        rng = np.random.default_rng(seed)
        c = rng.integers(0, hi, (self.c_pad, self.n)).astype(np.int32)
        c[self.enc.num_classes:] = 0
        return c

    def pod_class(self, n=None):
        n = len(self.pc) if n is None else n
        out = np.full(jh_bucket(n), self.enc.num_classes, np.int32)
        out[:n] = self.pc[:n]
        return out


def jh_bucket(n, lo=16):
    p = lo
    while p < n:
        p *= 2
    return p


@pytest.fixture(scope="module")
def world():
    return _World()


def _t(d):
    return arrays_from_numpy(d, "cpu")


def _states(w):
    j = jbatch.node_state({k: jnp.asarray(v) for k, v in w.nodes.items()})
    t = tbatch.node_state(w.t_nodes)
    return j, t


def _eq_state(js, ts):
    for name, a, b in zip(js._fields, js, ts):
        got = b.numpy()
        want = np.asarray(a)
        if want.dtype == np.uint32:
            want = want.view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_wave_aff_mask_matches_reference(world, seed):
    comm = world.committed(seed)
    want = np.asarray(jwaves._wave_aff_mask(
        {k: jnp.asarray(v) for k, v in world.aff_wave.items()},
        jnp.asarray(comm)))
    got = twaves._wave_aff_mask(_t(world.aff_wave), torch.from_numpy(comm))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("weights", [(1, 0), (0, 1), (2, 3)],
                         ids=["interpod", "spread", "both"])
@pytest.mark.parametrize("view", ["tail", "full"])
def test_frozen_affinity_scores_match_reference(world, weights, view):
    aff = world.aff_tail if view == "tail" else world.aff_full
    js, ts = _states(world)
    want = np.asarray(jwaves.frozen_affinity_scores(
        {k: jnp.asarray(v) for k, v in world.cls.items()},
        {k: jnp.asarray(v) for k, v in world.nodes.items()}, js,
        {k: jnp.asarray(v) for k, v in aff.items()}, weights))
    got = twaves.frozen_affinity_scores(world.t_cls, world.t_nodes, ts,
                                        _t(aff), weights)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


def test_waves_loop_with_occupancy_carry_matches_reference(world):
    """The wave loop with the anti mask, the wave gate, the frozen extra
    score, the strict-tail rows inactive and a seeded occupancy."""
    pc = world.pod_class()
    act = np.zeros(len(pc), bool)
    act[:len(world.pc)] = ~world.enc.wave_strict[world.pc]
    comm = world.committed(5, hi=2)
    js, ts = _states(world)
    jcls = {k: jnp.asarray(v) for k, v in world.cls.items()}
    jnodes = {k: jnp.asarray(v) for k, v in world.nodes.items()}
    jextra = jwaves.frozen_affinity_scores(
        jcls, jnodes, js,
        {k: jnp.asarray(v) for k, v in world.aff_tail.items()}, (1, 1))
    jp, jst, jcm = jwaves.waves_loop(
        jcls, jnodes, js, jnp.asarray(pc), jnp.uint32(2 ** 32 - 3), KERNEL,
        64, extra_score=jextra,
        aff={k: jnp.asarray(v) for k, v in world.aff_wave.items()},
        committed0=jnp.asarray(comm), active0=jnp.asarray(act))
    textra = twaves.frozen_affinity_scores(world.t_cls, world.t_nodes, ts,
                                           _t(world.aff_tail), (1, 1))
    tp, tst, tcm = twaves.waves_loop(
        world.t_cls, world.t_nodes, ts, torch.from_numpy(pc),
        torch.tensor(2 ** 32 - 3, dtype=torch.int64), KERNEL, 64,
        extra_score=textra, aff=_t(world.aff_wave),
        committed0=torch.from_numpy(comm), active0=torch.from_numpy(act))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
    _eq_state(jst, tst)
    assert (tp.numpy()[:len(world.pc)] >= 0).sum() > 100


def _aff_init(world, seed, jnp_side, view="tail"):
    comm = world.committed(seed, hi=2)
    lab = (world.aff_tail["labels_aff"] if view == "tail"
           else world.nodes["labels"]).astype(np.int64)
    commdom = (comm.astype(np.int64) @ lab).astype(np.int32)
    cnt = comm.sum(axis=1).astype(np.int32)
    if jnp_side:
        return tuple(jnp.asarray(a) for a in (commdom, comm, cnt))
    return tuple(torch.from_numpy(a) for a in (commdom, comm, cnt))


@pytest.mark.parametrize("seeded", [False, True], ids=["cold", "seeded"])
@pytest.mark.parametrize("mode", [(True, True, False), (True, False, False)],
                         ids=["fits+prio", "fits"])
def test_tail_rounds_loop_matches_reference(world, seeded, mode):
    strict = np.nonzero(world.enc.wave_strict[world.pc])[0]
    others = np.nonzero(~world.enc.wave_strict[world.pc])[0][:40]
    rows = np.sort(np.concatenate([strict, others]))
    pc = np.full(jh_bucket(len(rows)), world.enc.num_classes, np.int32)
    pc[:len(rows)] = world.pc[rows]
    prios = NO_SPREAD if mode[1] else KERNEL
    js, ts = _states(world)
    jp, jst = jwaves.tail_rounds_loop(
        {k: jnp.asarray(v) for k, v in world.cls.items()},
        {k: jnp.asarray(v) for k, v in world.nodes.items()}, js,
        jnp.asarray(pc), jnp.uint32(11), prios,
        aff={k: jnp.asarray(v) for k, v in world.aff_tail.items()},
        aff_mode=mode,
        aff_init=_aff_init(world, 9, True) if seeded else None)
    tp, tst = twaves.tail_rounds_loop(
        world.t_cls, world.t_nodes, ts, torch.from_numpy(pc),
        torch.tensor(11, dtype=torch.int64), prios,
        aff=_t(world.aff_tail), aff_mode=mode,
        aff_init=_aff_init(world, 9, False) if seeded else None)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    _eq_state(jst, tst)
    assert int(tp[-1]) > 1                     # more than one round ran


@pytest.mark.parametrize("view,mode", [
    ("tail", (True, True, False)),
    ("full", (True, True, True)),
], ids=["tail-seeded", "full-spread"])
def test_place_batch_with_affinity_matches_reference(world, view, mode):
    rows = np.arange(0, len(world.pc), 5)[:24]
    pc = np.full(32, world.enc.num_classes, np.int32)
    pc[:len(rows)] = world.pc[rows]
    aff = world.aff_tail if view == "tail" else world.aff_full
    prios = PRIORITIES if mode[2] else NO_SPREAD
    seeded = view == "tail"
    js, ts = _states(world)
    jsel, jfc, jst, jctr = jbatch.gather_place_batch(
        {k: jnp.asarray(v) for k, v in world.cls.items()}, jnp.asarray(pc),
        {k: jnp.asarray(v) for k, v in world.nodes.items()}, js,
        jnp.uint32(3), prios,
        aff={k: jnp.asarray(v) for k, v in aff.items()}, aff_mode=mode,
        aff_init=_aff_init(world, 4, True) if seeded else None)
    tsel, tfc, tst, tctr = tbatch.gather_place_batch(
        world.t_cls, torch.from_numpy(pc), world.t_nodes, ts,
        torch.tensor(3, dtype=torch.int64), prios, aff=_t(aff),
        aff_mode=mode,
        aff_init=_aff_init(world, 4, False) if seeded else None)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(tfc.numpy(), np.asarray(jfc))
    assert int(tctr) == int(jctr)
    _eq_state(jst, tst)
    assert (tsel.numpy()[:len(rows)] >= 0).all()


def test_class_vectorized_steps_match_reference_and_per_class(world):
    """step_fits_all / step_prio_counts_all equal the reference's, and each
    row equals the per-class step_fits / step_prio_counts (over the full
    label axis, where the hostname anti terms live)."""
    aff_j = {k: jnp.asarray(v) for k, v in world.aff_full.items()}
    aff_t = _t(world.aff_full)
    commdom_j, _, cnt_j = _aff_init(world, 6, True, view="full")
    commdom_t, _, cnt_t = _aff_init(world, 6, False, view="full")
    lab_j = jnp.asarray(world.nodes["labels"])
    lab_t = world.t_nodes["labels"]
    pre_j = jaff.precompute_static(aff_j, lab_j)
    pre_t = taff.precompute_static(aff_t, lab_t)
    fits = taff.step_fits_all(aff_t, pre_t, commdom_t, cnt_t, lab_t)
    cnts = taff.step_prio_counts_all(aff_t, pre_t, commdom_t, lab_t)
    np.testing.assert_array_equal(fits.numpy(), np.asarray(
        jaff.step_fits_all(aff_j, pre_j, commdom_j, cnt_j, lab_j)))
    np.testing.assert_array_equal(cnts.numpy(), np.asarray(
        jaff.step_prio_counts_all(aff_j, pre_j, commdom_j, lab_j)))
    for c in range(world.enc.num_classes):
        np.testing.assert_array_equal(
            fits[c].numpy(),
            taff.step_fits(aff_t, pre_t, c, commdom_t, cnt_t, lab_t).numpy())
        np.testing.assert_array_equal(
            cnts[c].numpy(),
            taff.step_prio_counts(aff_t, pre_t, c, commdom_t,
                                  lab_t).numpy())
    assert fits.any() and not fits.all() and cnts.any()
