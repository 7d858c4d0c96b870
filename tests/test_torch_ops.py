"""The port's host encoding and device ops on the CPU against the reference
package, exactly.

- the port's ClusterSnapshot / ClassBatch arrays equal the reference's for
  the same hollow cluster and pods, key by key;
- fits, static_fits and score of the port equal the reference's on the same
  arrays (carried across with convert.arrays_from_numpy) for the binpack,
  hetero (taints, GPUs) and affinity (node selectors) profiles.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.models import hollow as jh
from kubernetes_tpu.ops import predicates as jpreds
from kubernetes_tpu.ops import priorities as jprio
from kubernetes_tpu.state.cache import SchedulerCache as JCache
from kubernetes_tpu.state.classes import ClassBatch as JClassBatch
from kubernetes_tpu.state.snapshot import ClusterSnapshot as JSnapshot
from kubernetes_tpu_torch.convert import arrays_from_numpy
from kubernetes_tpu_torch.models import hollow as th
from kubernetes_tpu_torch.ops import predicates as tpreds
from kubernetes_tpu_torch.ops import priorities as tprio
from kubernetes_tpu_torch.state.cache import SchedulerCache as TCache
from kubernetes_tpu_torch.state.classes import ClassBatch as TClassBatch
from kubernetes_tpu_torch.state.snapshot import ClusterSnapshot as TSnapshot

PROFILES = {
    "binpack": (dict(), "binpack_pods"),
    "hetero": (dict(heterogeneous=True, gpu_fraction=0.3,
                    taint_fraction=0.3), "hetero_gpu_pods"),
    "affinity": (dict(), "affinity_pods"),
}

# every pod x node priority of the registry, weighted
ALL_PRIORITIES = (("LeastRequestedPriority", 1),
                  ("MostRequestedPriority", 2),
                  ("BalancedResourceAllocation", 1),
                  ("TaintTolerationPriority", 3),
                  ("NodeAffinityPriority", 1),
                  ("NodePreferAvoidPodsPriority", 10000),
                  ("ImageLocalityPriority", 1),
                  ("EqualPriority", 1))


def _world(hollow, Cache, Snapshot, ClassBatch, profile, n_nodes=48,
           n_pods=120):
    node_kw, gen = PROFILES[profile]
    cache = Cache()
    for nd in hollow.hollow_nodes(n_nodes, seed=5, **node_kw):
        cache.add_node(nd)
    # some bound pods so requested/nonzero/pod_count are not all zero
    nodes = sorted(cache.node_infos())
    for i, p in enumerate(getattr(hollow, gen)(40, seed=9, namespace="b")):
        p.node_name = nodes[(3 * i) % len(nodes)]
        cache.add_pod(p)
    snap = Snapshot()
    snap.refresh(cache.node_infos())
    batch = ClassBatch(getattr(hollow, gen)(n_pods, seed=1), snap)
    return snap, batch


@pytest.fixture(scope="module", params=sorted(PROFILES))
def worlds(request):
    j = _world(jh, JCache, JSnapshot, JClassBatch, request.param)
    t = _world(th, TCache, TSnapshot, TClassBatch, request.param)
    return request.param, j, t


def test_snapshot_node_arrays_equal(worlds):
    _, (jsnap, _), (tsnap, _) = worlds
    assert jsnap.node_names == tsnap.node_names
    for k in jpreds._NODE_ARRAY_KEYS:
        a, b = getattr(jsnap, k), getattr(tsnap, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_class_pod_arrays_equal(worlds):
    _, (_, jb), (_, tb) = worlds
    np.testing.assert_array_equal(jb.pod_class, tb.pod_class)
    jarr = jpreds._pod_arrays_np(jb.reps_batch)
    tarr = tpreds._pod_arrays_np(tb.reps_batch)
    assert sorted(jarr) == sorted(tarr)
    for k in jarr:
        assert jarr[k].dtype == tarr[k].dtype, k
        np.testing.assert_array_equal(jarr[k], tarr[k], err_msg=k)
    np.testing.assert_array_equal(jb.reps_batch.needs_host_check,
                                  tb.reps_batch.needs_host_check)


def _same_inputs(jsnap, jb):
    """The reference's host arrays as numpy, and the port's tensors made
    from exactly those arrays."""
    nodes_np = {k: np.asarray(getattr(jsnap, k))
                for k in jpreds._NODE_ARRAY_KEYS}
    pods_np = {k: np.asarray(v)
               for k, v in jpreds._pod_arrays_np(jb.reps_batch).items()}
    return (nodes_np, pods_np, arrays_from_numpy(nodes_np, "cpu"),
            arrays_from_numpy(pods_np, "cpu"))


def test_fits_static_fits_and_score_equal(worlds):
    profile, (jsnap, jb), _ = worlds
    nodes_np, pods_np, tn, tp = _same_inputs(jsnap, jb)
    jn = jpreds.node_arrays(jsnap)
    jp = jpreds.pod_arrays(jb.reps_batch)
    np.testing.assert_array_equal(tpreds.static_fits(tp, tn).numpy(),
                                  np.asarray(jpreds.static_fits(jp, jn)))
    jf = np.asarray(jpreds.fits(jp, jn))
    tf = tpreds.fits(tp, tn)
    np.testing.assert_array_equal(tf.numpy(), jf)
    assert jf.any() and not jf.all(), profile   # a real mask either way
    for fits in (None, "fits"):
        js = jprio.score(jp, jn, ALL_PRIORITIES,
                         None if fits is None else jf)
        ts = tprio.score(tp, tn, ALL_PRIORITIES,
                         None if fits is None else tf)
        assert ts.dtype == torch.int32
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_port_bitmap_bits_carry_over():
    """uint32 words become int32 tensors holding the same bits, and the
    ports predicate reads bit 31 like the reference."""
    bm = np.zeros((3, 2), np.uint32)
    bm[0, 0] = 1 << 31
    bm[1, 1] = (1 << 31) | 1
    ports = np.array([[31, -1, -1, -1, -1, -1, -1, -1],
                      [32, 63, -1, -1, -1, -1, -1, -1],
                      [5, 200, -1, -1, -1, -1, -1, -1]], np.int32)
    t = arrays_from_numpy({"bm": bm, "ports": ports}, "cpu")
    assert t["bm"].dtype == torch.int32
    np.testing.assert_array_equal(t["bm"].numpy().view(np.uint32), bm)
    np.testing.assert_array_equal(
        tpreds.ports_fit(t["ports"], t["bm"]).numpy(),
        np.asarray(jpreds.ports_fit(ports, bm)))
