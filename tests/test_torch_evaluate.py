"""The port's extender verdict (evaluate_pod, uncached path) on the CPU
against the reference's (eval_cache=None), exactly: fits and scores for
probes against a 64-node cluster that holds bound pods with inter-pod
(anti-)affinity and one Service, with the affinity fits, the
InterPodAffinity priority and the selector spreading each live for some
probe."""

import numpy as np
import pytest

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.engine.scheduler_engine import evaluate_pod as j_eval
from kubernetes_tpu.models import hollow as jh
from kubernetes_tpu.ops.priorities import DEFAULT_PRIORITIES
from kubernetes_tpu.state.cache import SchedulerCache as JCache
from kubernetes_tpu.state.snapshot import ClusterSnapshot as JSnapshot
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.engine import scheduler_engine as tse
from kubernetes_tpu_torch.models import hollow as th
from kubernetes_tpu_torch.ops import affinity as taff
from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.state.cache import SchedulerCache as TCache
from kubernetes_tpu_torch.state.classes import ClassBatch as TClassBatch
from kubernetes_tpu_torch.state.snapshot import ClusterSnapshot as TSnapshot

N_NODES = 64


def _world(hollow, types, Cache, Snapshot):
    cache = Cache()
    nodes = hollow.hollow_nodes(N_NODES)
    for nd in nodes:
        cache.add_node(nd)
    for i, p in enumerate(hollow.mixed_affinity_pods(400, seed=2)):
        p.node_name = nodes[(7 * i) % N_NODES].name
        cache.add_pod(p)
    snap = Snapshot()
    snap.refresh(cache.node_infos())
    workloads = [types.WorkloadObject("Service", "web", "bench",
                                      match_labels={"app": "web-4"})]
    probes = (hollow.mixed_affinity_pods(60, seed=3)[::4]
              + hollow.affinity_pods(6, seed=4))
    return cache, snap, workloads, probes


@pytest.fixture(scope="module")
def worlds():
    return (_world(jh, jt, JCache, JSnapshot),
            _world(th, tt, TCache, TSnapshot))


def _modes(cache, snap, workloads, pod):
    all_pairs, aff_pairs = taff.collect_pod_pairs(cache.node_infos())
    taff.intern_topology_pairs(snap, [pod], aff_pairs)
    batch = TClassBatch([pod], snap)
    adata = taff.AffinityData(batch.reps, snap, all_pairs, aff_pairs,
                              workloads, 1)
    return tse._aff_mode(adata, DEFAULT_PRIORITIES)[0]


def test_evaluate_pod_matches_reference(worlds):
    (jc, js, jw, jprobes), (tc, ts, tw, tprobes) = worlds
    seen = np.zeros(3, dtype=bool)
    kernels.reset_launch_counts()
    for jp, tp in zip(jprobes, tprobes):
        jm, jsc = j_eval(jp, jc.node_infos(), js, DEFAULT_PRIORITIES, jw,
                         eval_cache=None)
        tm, tsc = tse.evaluate_pod(tp, tc.node_infos(), ts,
                                   DEFAULT_PRIORITIES, tw, device="cpu")
        np.testing.assert_array_equal(tm, jm, err_msg=tp.name)
        np.testing.assert_array_equal(tsc, np.asarray(jsc), err_msg=tp.name)
        seen |= np.array(_modes(tc, ts, tw, tp))
    assert seen.tolist() == [True, True, True]   # fits_on, prio_on, spread_on
    assert kernels.LAUNCHES["incidence_matmul"] == 0   # CPU: plain version


def test_evaluate_pod_host_oracle_route_raises(worlds):
    _, (tc, ts, tw, _) = worlds
    pod = tt.make_pod("many-ports", namespace="bench", cpu=100,
                      ports=list(range(7000, 7009)))
    with pytest.raises(NotImplementedError, match="host oracle"):
        tse.evaluate_pod(pod, tc.node_infos(), ts, DEFAULT_PRIORITIES, tw,
                         device="cpu")
