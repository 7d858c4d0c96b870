"""The port's extender verdict engine on the CPU against the reference
package's, exactly: ``evaluate_pod`` with an ``EvalCache`` (the warm lane:
result memo, encoded-class LRU, vocab isolation, the affinity-free lane),
``evaluate_pods_batch`` (one fused [C, N] evaluation for a coalesced
batch) and the exact host-oracle route, on a 64-node cluster holding
bound pods with inter-pod (anti-)affinity and one Service."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import policy as jpolicy
from kubernetes_tpu.api import types as jt
from kubernetes_tpu.engine import scheduler_engine as jse
from kubernetes_tpu.models import hollow as jh
from kubernetes_tpu.ops import policy_algos as jpalgos
from kubernetes_tpu.ops.priorities import DEFAULT_PRIORITIES as JPRIO
from kubernetes_tpu.state.cache import SchedulerCache as JCache
from kubernetes_tpu.state.snapshot import ClusterSnapshot as JSnapshot
from kubernetes_tpu.utils import trace as jtrace
from kubernetes_tpu_torch.api import policy as tpolicy
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.engine import scheduler_engine as tse
from kubernetes_tpu_torch.models import hollow as th
from kubernetes_tpu_torch.ops import affinity as taff
from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.ops import policy_algos as tpalgos
from kubernetes_tpu_torch.ops import predicates as tpreds
from kubernetes_tpu_torch.ops import priorities as tprio
from kubernetes_tpu_torch.ops.priorities import DEFAULT_PRIORITIES as TPRIO
from kubernetes_tpu_torch.state.cache import SchedulerCache as TCache
from kubernetes_tpu_torch.state.classes import ClassBatch as TClassBatch
from kubernetes_tpu_torch.state.snapshot import ClusterSnapshot as TSnapshot
from kubernetes_tpu_torch.utils.trace import COUNTERS

N_NODES = 64
ZONE = "failure-domain.beta.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
REF = (jt, jh, JCache, JSnapshot, jse, JPRIO)
PORT = (tt, th, TCache, TSnapshot, tse, TPRIO)


def _oracle_probes(t):
    """Pods whose features outgrow the device encoding: more host ports
    than it holds, too many ORed selector terms, too many preferred
    terms, too many required anti-affinity terms — and one whose selector
    would grow the label vocab."""
    zones = ["zone-a", "zone-b", "zone-c"]

    def term(v):
        return t.NodeSelectorTerm([t.SelectorRequirement(
            ZONE, t.SelectorOperator.IN, [v])])
    anti = [t.PodAffinityTerm(t.LabelSelector(match_labels={"app": f"web-{i}"}),
                              [], HOST) for i in range(5)]
    return [
        t.make_pod("o-ports", namespace="bench", cpu=100, memory=256 << 20,
                   ports=list(range(7000, 7009))),
        t.make_pod("o-terms", namespace="bench", cpu=100, affinity=t.Affinity(
            node_affinity=t.NodeAffinity(
                required_terms=[term(zones[i % 3]) for i in range(5)]))),
        t.make_pod("o-pref", namespace="bench", cpu=100, affinity=t.Affinity(
            node_affinity=t.NodeAffinity(preferred_terms=[
                (i + 1, term(zones[i % 3])) for i in range(9)]))),
        t.make_pod("o-anti", namespace="bench", cpu=100, labels={"app": "x"},
                   affinity=t.Affinity(pod_anti_affinity=t.PodAffinity(
                       required_terms=anti))),
        t.make_pod("o-vocab", namespace="bench", cpu=100,
                   node_selector={"disk": "ssd"}),
    ]


def _world(mods, aff_pods=True):
    t, h, Cache, Snapshot = mods[:4]
    cache = Cache()
    nodes = h.hollow_nodes(N_NODES)
    for nd in nodes:
        cache.add_node(nd)
    bound = h.mixed_affinity_pods(400, seed=2) if aff_pods \
        else h.density_pods(400, seed=2)
    for i, p in enumerate(bound):
        p.node_name = nodes[(7 * i) % N_NODES].name
        cache.add_pod(p)
    snap = Snapshot()
    snap.refresh(cache.node_infos())
    workloads = [t.WorkloadObject("Service", "web", "bench",
                                  match_labels={"app": "web-4"})] \
        if aff_pods else []
    return cache, snap, workloads


def _probes(mods):
    t, h = mods[:2]
    return (h.mixed_affinity_pods(60, seed=3)[::4]
            + h.affinity_pods(6, seed=4)
            + [t.make_pod(f"plain-{i}", namespace="bench", cpu=100 * (i + 1),
                          memory=256 << 20) for i in range(3)]
            + _oracle_probes(t))


def _eq(got, want, tag=""):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]), err_msg=tag)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]), err_msg=tag)


def _modes(cache, snap, workloads, pod):
    all_pairs, aff_pairs = taff.collect_pod_pairs(cache.node_infos())
    taff.intern_topology_pairs(snap, [pod], aff_pairs)
    batch = TClassBatch([pod], snap)
    adata = taff.AffinityData(batch.reps, snap, all_pairs, aff_pairs,
                              workloads, 1)
    return tse._aff_mode(adata, TPRIO)[0]


def test_cached_evaluate_pod_matches_reference():
    """Two rounds over the probes through each package's EvalCache: every
    (fits, scores) equal, and the caches route, hit and build alike (the
    second round is memo hits; vocab growth routes to the oracle)."""
    (jc, js, jw), (tc, ts, tw) = _world(REF), _world(PORT)
    jec, tec = jse.EvalCache(), tse.EvalCache()
    seen = np.zeros(3, dtype=bool)
    for rnd in range(2):
        for jp, tp in zip(_probes(REF), _probes(PORT)):
            want = jse.evaluate_pod(jp, jc.node_infos(), js, JPRIO, jw,
                                    eval_cache=jec)
            got = tse.evaluate_pod(tp, tc.node_infos(), ts, TPRIO, tw,
                                   eval_cache=tec, device="cpu")
            _eq(got, want, f"round {rnd} {tp.name}")
            assert got[1].dtype == np.asarray(want[1]).dtype
    # which affinity functions the probes make live, on a world of its
    # own (the encoding interns topology pairs into the snapshot)
    mc, ms, mw = _world(PORT)
    for tp in _probes(PORT)[:-5]:
        seen |= np.array(_modes(mc, ms, mw, tp))
    assert seen.tolist() == [True, True, True]  # fits, prio, spread live
    assert (tec.oracle_routes, tec.result_hits, tec.builds) == \
        (jec.oracle_routes, jec.result_hits, jec.builds)
    assert tec.oracle_routes > 0 and tec.result_hits > 0


def test_vocab_growth_interns_at_the_next_sync_like_reference():
    """A pod whose selector pair the vocab lacks takes the oracle and
    leaves the snapshot version alone; after a sync boundary the pair
    interns in one rebuild and the pod takes the device path — with the
    reference's answers at each step."""
    (jc, js, jw), (tc, ts, tw) = _world(REF), _world(PORT)
    jec, tec = jse.EvalCache(), tse.EvalCache()
    jp, tp = _oracle_probes(jt)[-1], _oracle_probes(tt)[-1]
    v0 = ts.version
    _eq(tse.evaluate_pod(tp, tc.node_infos(), ts, TPRIO, tw, eval_cache=tec,
                         device="cpu"),
        jse.evaluate_pod(jp, jc.node_infos(), js, JPRIO, jw, eval_cache=jec))
    assert ts.version == v0 and tec._pending_pairs
    jec.on_sync()
    tec.on_sync()
    routes = tec.oracle_routes
    evals = COUNTERS.count("extender.fused_eval")
    _eq(tse.evaluate_pod(tp, tc.node_infos(), ts, TPRIO, tw, eval_cache=tec,
                         device="cpu"),
        jse.evaluate_pod(jp, jc.node_infos(), js, JPRIO, jw, eval_cache=jec))
    assert tec.oracle_routes == routes and not tec._pending_pairs
    assert COUNTERS.count("extender.fused_eval") == evals + 1


def test_aff_free_lane_matches_reference():
    """A cluster proven free of pod affinity: plain pods skip pair
    collection and AffinityData, their encodings key on the vocab
    generation — and the answers equal the reference's."""
    (jc, js, jw), (tc, ts, tw) = _world(REF, False), _world(PORT, False)
    jec, tec = jse.EvalCache(), tse.EvalCache()
    jec.cluster_aff_free = tec.cluster_aff_free = True
    pods = [(jt.make_pod(f"free-{i}", cpu=100 * (1 + i % 3),
                         memory=256 << 20),
             tt.make_pod(f"free-{i}", cpu=100 * (1 + i % 3),
                         memory=256 << 20)) for i in range(6)]
    builds0 = COUNTERS.count("extender.affinity_data_build")
    for jp, tp in pods:
        _eq(tse.evaluate_pod(tp, tc.node_infos(), ts, TPRIO, tw,
                             eval_cache=tec, device="cpu"),
            jse.evaluate_pod(jp, jc.node_infos(), js, JPRIO, jw,
                             eval_cache=jec), tp.name)
    assert COUNTERS.count("extender.affinity_data_build") == builds0
    assert (tec.builds, tec.result_hits) == (jec.builds, jec.result_hits) \
        == (3, 3)


@pytest.mark.parametrize("which", range(5),
                         ids=["ports", "terms", "pref", "anti", "vocab"])
def test_oracle_route_matches_reference(which):
    """The exact host oracle (uncached evaluate_pod): int64 scores over
    the filtered set, equal to the reference's."""
    (jc, js, jw), (tc, ts, tw) = _world(REF), _world(PORT)
    jp, tp = _oracle_probes(jt)[which], _oracle_probes(tt)[which]
    oracle0 = COUNTERS.count("extender.oracle_eval")
    got = tse.evaluate_pod(tp, tc.node_infos(), ts, TPRIO, tw, device="cpu")
    want = jse.evaluate_pod(jp, jc.node_infos(), js, JPRIO, jw)
    _eq(got, want, tp.name)
    if which < 4:   # the uncached path interns the vocab probe's pair
        assert got[1].dtype == np.int64
        assert COUNTERS.count("extender.oracle_eval") == oracle0 + 1


def test_evaluate_pods_batch_matches_reference():
    """A coalesced batch of twelve classes (affinity, plain and host-oracle
    ones, two pods of one class) costs one fused [C, N] evaluation and
    equals the reference's batch row for row; a second batch routes,
    hits and evaluates exactly as the reference's does."""
    (jc, js, jw), (tc, ts, tw) = _world(REF), _world(PORT)
    jec, tec = jse.EvalCache(), tse.EvalCache()
    jpods = _probes(REF) + _probes(REF)[:1]
    tpods = _probes(PORT) + _probes(PORT)[:1]
    keys = ("extender.fused_eval_batch", "extender.fused_eval",
            "extender.result_hit", "extender.oracle_eval",
            "extender.batch_classes")
    for rnd in range(2):
        j0 = [jtrace.COUNTERS.count(k) for k in keys]
        t0 = [COUNTERS.count(k) for k in keys]
        want = jse.evaluate_pods_batch(jpods, jc.node_infos(), js, JPRIO, jw,
                                       eval_cache=jec)
        got = tse.evaluate_pods_batch(tpods, tc.node_infos(), ts, TPRIO, tw,
                                      eval_cache=tec, device="cpu")
        assert len(got) == len(tpods) >= 12
        for g, w, p in zip(got, want, tpods):
            _eq(g, w, f"round {rnd} {p.name}")
        _eq(got[-1], got[0])   # two pods of one class
        dj = [jtrace.COUNTERS.count(k) - v for k, v in zip(keys, j0)]
        dt = [COUNTERS.count(k) - v for k, v in zip(keys, t0)]
        assert dt == dj, (rnd, dict(zip(keys, dt)), dict(zip(keys, dj)))
        if rnd == 0:
            assert dt[0] == 1 and dt[4] >= 8   # one [C, N] pass, >= 8 classes
    assert tec.result_hits == jec.result_hits > 0


def test_evaluate_pods_batch_matches_per_request():
    """The fused [C, N] batch and the single-pod warm lane agree on every
    verdict and every integer score (the same package, two caches) for
    plain pods on an affinity-free cluster, as the reference pins it.
    (With live affinity the batch's affinity-function gate is the whole
    batch's, so the integer scores of a class may differ by a constant
    from its single-pod evaluation; the fits never do. The reference
    behaves the same: see the batch parity test above.)"""
    tc, ts, tw = _world(PORT, False)
    pods = [tt.make_pod(f"mc-{i}", cpu=100 * (1 + i % 3), memory=256 << 20)
            for i in range(9)]
    batch = tse.evaluate_pods_batch(pods, tc.node_infos(), ts, TPRIO, tw,
                                    eval_cache=tse.EvalCache(), device="cpu")
    per = tse.EvalCache()
    for p, got in zip(pods, batch):
        _eq(got, tse.evaluate_pod(p, tc.node_infos(), ts, TPRIO, tw,
                                  eval_cache=per, device="cpu"), p.name)


def test_uncached_batch_is_per_request():
    (jc, js, jw), (tc, ts, tw) = _world(REF), _world(PORT)
    want = jse.evaluate_pods_batch(_probes(REF)[:5], jc.node_infos(), js,
                                   JPRIO, jw)
    got = tse.evaluate_pods_batch(_probes(PORT)[:5], tc.node_infos(), ts,
                                  TPRIO, tw, device="cpu")
    for g, w in zip(got, want):
        _eq(g, w)


def test_memo_entries_own_their_memory(monkeypatch):
    """A memo entry is handed to every later request: its arrays own their
    memory (no tensor, node array or encoded-class array aliases them),
    and neither a write into a returned array's padding nor later
    evaluations of other classes change the next memo hit."""
    tc, ts, tw = _world(PORT)
    probes = _probes(PORT)
    for p in probes[:8]:   # intern every pair first: a stable version
        tse.evaluate_pod(p, tc.node_infos(), ts, TPRIO, tw,
                         eval_cache=tse.EvalCache(), device="cpu")
    ec = tse.EvalCache()
    tensors = []
    real = tse._fused_eval

    def spy(parr, narr, aff, *a):
        tensors.extend(list(parr.values()) + list(narr.values())
                       + list((aff or {}).values()))
        out = real(parr, narr, aff, *a)
        tensors.extend(out)
        return out

    monkeypatch.setattr(tse, "_fused_eval", spy)
    m, s = tse.evaluate_pod(probes[0], tc.node_infos(), ts, TPRIO, tw,
                            eval_cache=ec, device="cpu")
    assert m.flags.owndata and m.flags.writeable and s.flags.owndata
    for t in tensors:
        assert not np.shares_memory(m, t.numpy())
        assert not np.shares_memory(s, t.numpy())
    for k in tpreds._NODE_ARRAY_KEYS:
        a = getattr(ts, k)
        assert not np.shares_memory(m, a) and not np.shares_memory(s, a)
    keep = (m.copy(), s.copy())
    n = len(ts.node_names)
    m[n:] = False   # the write evaluate_pod makes into its own result
    for p in probes[1:8]:
        tse.evaluate_pod(p, tc.node_infos(), ts, TPRIO, tw, eval_cache=ec,
                         device="cpu")
    hit = tse.evaluate_pod(probes[0], tc.node_infos(), ts, TPRIO, tw,
                           eval_cache=ec, device="cpu")
    assert hit[0] is m
    _eq(hit, keep)
    # batch rows are views of one owned [C, N] fetch, never of a tensor
    rows = tse.evaluate_pods_batch(probes[8:14], tc.node_infos(), ts, TPRIO,
                                   tw, eval_cache=tse.EvalCache(),
                                   device="cpu")
    for bm, bs in rows:
        for arr in (bm, bs):
            assert (arr if arr.base is None else arr.base).flags.owndata


def test_fused_eval_batch_rows_equal_single_class_eval():
    """Row c of the class-vectorized [C, N] evaluation is bit-identical to
    the single-pod evaluation of class c (zero occupancy has no cross-row
    carry) — the device half the card runs, here on the CPU tensors."""
    tc, ts, tw = _world(PORT)
    infos = tc.node_infos()
    reps = _probes(PORT)[:8]
    all_pairs, aff_pairs = taff.collect_pod_pairs(infos)
    taff.intern_topology_pairs(ts, reps, aff_pairs)
    b = TClassBatch(reps, ts)
    c_pad = tpreds.bucket(b.num_classes, lo=4)
    a = taff.AffinityData(b.reps, ts, all_pairs, aff_pairs, tw, 1,
                          c_pad=c_pad)
    mode, weights = tse._aff_mode(a, TPRIO)
    assert all(mode)
    plain = tuple((nm, w) for nm, w in TPRIO
                  if nm not in tprio.AFFINITY_PRIORITIES)
    narr = tpreds.node_arrays(ts, "cpu")
    m_all, s_all = tse._fused_eval_batch(
        tpreds.pod_arrays_bucketed(b.reps_batch, "cpu", rows=c_pad), narr,
        a.device_arrays("cpu"), plain, weights, mode)
    assert tuple(m_all.shape) == (c_pad, ts.valid.shape[0])
    for c, rep in enumerate(b.reps):
        one = TClassBatch([rep], ts)
        a1 = taff.AffinityData(one.reps, ts, all_pairs, aff_pairs, tw, 1)
        m1, s1 = tse._fused_eval(
            tpreds.pod_arrays_bucketed(one.reps_batch, "cpu"), narr,
            a1.device_arrays("cpu"), plain, weights, mode)
        assert torch.equal(m_all[c], m1), rep.name
        assert torch.equal(s_all[c], s1), rep.name
    assert kernels.LAUNCHES["incidence_matmul"] == 0  # CPU: plain version


def _policy_algos(mods):
    parse = jpolicy.parse_policy if mods is REF else tpolicy.parse_policy
    algos = jpalgos if mods is REF else tpalgos
    return algos.algorithms_from_policy(parse("""{
      "predicates": [{"name": "P", "argument": {"labelsPresence":
        {"labels": ["failure-domain.beta.kubernetes.io/zone"],
         "presence": true}}}],
      "priorities": [{"name": "L", "weight": 4, "argument":
        {"labelPreference": {"label": "kubernetes.io/hostname",
                             "presence": true}}}]}"""))[1]


def test_active_policy_algos_raises():
    """An active Policy no longer raises: the verdict routes every pod to
    the exact host oracle, single and batched, with the reference's fits
    and scores."""
    (jc, js, jw), (tc, ts, tw) = _world(REF), _world(PORT)
    ja, ta = _policy_algos(REF), _policy_algos(PORT)
    jps, tps = _probes(REF)[:6], _probes(PORT)[:6]
    for jp, tp in zip(jps, tps):
        want = jse.evaluate_pod(jp, jc.node_infos(), js, JPRIO, jw,
                                policy_algos=ja)
        got = tse.evaluate_pod(tp, tc.node_infos(), ts, TPRIO, tw,
                               policy_algos=ta, device="cpu")
        _eq(got, want, tp.name)
    want = jse.evaluate_pods_batch(jps, jc.node_infos(), js, JPRIO, jw,
                                   policy_algos=ja,
                                   eval_cache=jse.EvalCache())
    got = tse.evaluate_pods_batch(tps, tc.node_infos(), ts, TPRIO, tw,
                                  policy_algos=ta,
                                  eval_cache=tse.EvalCache(), device="cpu")
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _eq(g, w)
