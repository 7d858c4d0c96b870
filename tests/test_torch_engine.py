"""The port's batch engine on the CPU against the reference engine, exactly:
placements, fit counts, the RR counter and the cache's totals after
successive wave-mode batches on one cache; the forced straggler finish of
place_waves; strict mode; and the explicit refusals of what later slices
bring."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.engine import waves as jwaves
from kubernetes_tpu.engine.batch import node_state as j_node_state
from kubernetes_tpu.engine.scheduler_engine import \
    SchedulingEngine as JEngine
from kubernetes_tpu.models import hollow as jh
from kubernetes_tpu.ops import predicates as jpreds
from kubernetes_tpu.state.cache import SchedulerCache as JCache
from kubernetes_tpu.state.classes import ClassBatch as JClassBatch
from kubernetes_tpu.state.snapshot import ClusterSnapshot as JSnapshot
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.convert import arrays_from_numpy
from kubernetes_tpu_torch.engine import waves as twaves
from kubernetes_tpu_torch.engine import scheduler as tsched
from kubernetes_tpu_torch.engine import scheduler_engine as tse
from kubernetes_tpu_torch.engine.batch import node_state as t_node_state
from kubernetes_tpu_torch.engine.scheduler_engine import \
    SchedulingEngine as TEngine
from kubernetes_tpu_torch.models import hollow as th
from kubernetes_tpu_torch.server import apiserver_lite as tapi
from kubernetes_tpu_torch.state.cache import SchedulerCache as TCache

KERNEL_PRIORITIES = (("LeastRequestedPriority", 1),
                     ("BalancedResourceAllocation", 1),
                     ("NodePreferAvoidPodsPriority", 10000),
                     ("NodeAffinityPriority", 1),
                     ("TaintTolerationPriority", 1))


def _ported_pods(hollow, types, n, seed, namespace):
    """density pods plus a share of host-port pods (the wave's
    one-per-node-per-wave specials)."""
    pods = hollow.density_pods(n, seed=seed, namespace=namespace)
    for i in range(0, n, 10):
        pods[i] = types.make_pod(f"port-{seed}-{i}", namespace=namespace,
                                 cpu=200, memory=256 << 20,
                                 ports=[8080, 9000 + seed])
    return pods


PROFILES = {
    "density": (dict(), lambda h, ty, n, s, ns: h.density_pods(
        n, seed=s, namespace=ns)),
    "binpack": (dict(), lambda h, ty, n, s, ns: h.binpack_pods(
        n, seed=s, namespace=ns)),
    "hetero": (dict(heterogeneous=True, gpu_fraction=0.3,
                    taint_fraction=0.3),
               lambda h, ty, n, s, ns: h.hetero_gpu_pods(
                   n, seed=s, namespace=ns)),
    "ports": (dict(), _ported_pods),
}


def _cache(hollow, Cache, n_nodes, **node_kw):
    cache = Cache()
    for nd in hollow.hollow_nodes(n_nodes, seed=2, **node_kw):
        cache.add_node(nd)
    return cache


def _totals(cache):
    return {name: (info.requested.milli_cpu, info.requested.memory,
                   info.requested.nvidia_gpu, len(info.pods),
                   sorted(info.used_ports))
            for name, info in cache.node_infos().items()}


def _run(hollow, types, Cache, Engine, profile, mode, n_nodes, n_pods,
         rounds, **eng_kw):
    node_kw, gen = PROFILES[profile]
    cache = _cache(hollow, Cache, n_nodes, **node_kw)
    eng = Engine(cache, **eng_kw)
    out = []
    for k in range(rounds):
        res = eng.schedule(gen(hollow, types, n_pods, k, f"ns{k}"),
                           mode=mode)
        out.append(([r.node_name for r in res], [r.fit_count for r in res],
                     eng.rr.counter))
    return out, _totals(cache)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_wave_schedule_matches_reference(profile):
    jout, jtot = _run(jh, jt, JCache, JEngine, profile, "wave", 128, 600, 3)
    tout, ttot = _run(th, tt, TCache, TEngine, profile, "wave", 128, 600, 3,
                      device="cpu")
    for (jn, jf, jc), (tn, tf, tc) in zip(jout, tout):
        assert tn == jn
        assert tf == jf
        assert tc == jc
    assert ttot == jtot
    placed = sum(n is not None for n in jout[-1][0])
    assert placed > 0


def test_strict_schedule_matches_reference():
    jout, jtot = _run(jh, jt, JCache, JEngine, "binpack", "strict", 32, 64,
                      2)
    tout, ttot = _run(th, tt, TCache, TEngine, "binpack", "strict", 32, 64,
                      2, device="cpu")
    assert tout == jout
    assert ttot == jtot


def test_forced_straggler_finish_matches_reference():
    """max_waves=1 leaves most pods active; both packages finish them with
    the strict loop from the same arrays."""
    cache = _cache(jh, JCache, 64)
    snap = JSnapshot()
    snap.refresh(cache.node_infos())
    batch = JClassBatch(jh.binpack_pods(500, seed=4), snap)
    c_pad = jpreds.bucket(batch.num_classes + 1)
    cls_j = jpreds.pod_arrays_padded(batch.reps_batch, c_pad)
    nodes_j = jpreds.node_arrays(snap)
    pc = np.full(jpreds.bucket(len(batch.pod_class)), batch.num_classes,
                 np.int32)
    pc[:len(batch.pod_class)] = batch.pod_class
    cls_t = arrays_from_numpy({k: np.asarray(v) for k, v in cls_j.items()},
                              "cpu")
    nodes_t = arrays_from_numpy(
        {k: np.asarray(v) for k, v in nodes_j.items()}, "cpu")
    sel_j, fc_j, _, ctr_j = jwaves.place_waves(
        cls_j, nodes_j, j_node_state(nodes_j), pc, 5, KERNEL_PRIORITIES,
        max_waves=1)
    stats = {}
    sel_t, fc_t, _, ctr_t = twaves.place_waves(
        cls_t, nodes_t, t_node_state(nodes_t), pc, 5, KERNEL_PRIORITIES,
        max_waves=1, stats=stats)
    assert stats["stragglers"] > 0
    np.testing.assert_array_equal(sel_t, sel_j)
    np.testing.assert_array_equal(fc_t, fc_j)
    assert ctr_t == ctr_j


def test_batches_for_later_slices_raise():
    cache = _cache(th, TCache, 16)
    eng = TEngine(cache, device="cpu")
    with pytest.raises(NotImplementedError, match="affinity"):
        eng.schedule(th.mixed_affinity_pods(100), mode="wave")
    with pytest.raises(NotImplementedError, match="host oracle"):
        eng.schedule([tt.make_pod("many-ports", cpu=100,
                                  ports=list(range(7000, 7009)))],
                      mode="wave")
    # nothing was assumed by the refused batches
    assert all(not info.pods for info in cache.node_infos().values())



def test_node_uploads_are_copies(monkeypatch):
    """The snapshot mutates its arrays in place between batches; a tensor
    of the engine must never alias one. Likewise the pipelined drain's
    committed-occupancy upload: the harvest folds commits into the
    encoding's committed_nodes in place while the next wave's job may
    still read its tensor."""
    eng = TEngine(_cache(th, TCache, 8), device="cpu")
    eng.schedule(th.density_pods(4), mode="wave")
    nodes = eng._device_nodes
    before = nodes["requested"].clone()
    eng.snapshot.requested[:] += 7
    assert not any(np.shares_memory(t.numpy(), getattr(eng.snapshot, k))
                   for k, t in nodes.items() if k != "port_bitmap")
    assert torch.equal(nodes["requested"], before)

    seen = []
    real = tse._wave_job

    def spy(*args):
        seen.append(args[9])          # the committed-occupancy tensor
        return real(*args)

    monkeypatch.setattr(tse, "_wave_job", spy)
    api = tapi.ApiServerLite()
    th.load_cluster(api, th.hollow_nodes(32),
                    th.PROFILES["mixed_affinity"](300))
    s = tsched.Scheduler(api, record_events=False, device="cpu")
    s.start()
    pipe = s.pipeline(chunk=64)
    pipe.step()
    enc = pipe.inflight.enc
    host, dev = enc.committed_nodes, seen[-1]
    assert not np.shares_memory(dev.numpy(), host)
    before = dev.clone()
    host += 5
    assert torch.equal(dev, before)
    host -= 5
    pipe.step()                       # harvests the first wave: the fold
    pipe.close()
    s.engine.close()
    assert int(enc.committed_nodes.sum()) > 0
    assert len(seen) == 2 and seen[1] is not seen[0]
