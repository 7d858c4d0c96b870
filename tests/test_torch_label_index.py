"""The snapshot's label nonzero index and its readers, held byte for byte
to the dense matrix they replace: the wave encoding's per-node topology
views (key_node, static_forbid_hit) against the float64 product over the
whole [N, L] label matrix, domain_node_counts against the column sum, and
AffinityData's wave classification against the one the column sum gives.
The index itself is checked against np.nonzero(labels) after seeded runs
of node adds, relabels, removals, vocab growth and bulk rebuilds, and a
relabel patch of a warm encoding against a fresh derivation of its views.
engine.aff_view_nnz counts the index entries the views walk."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.engine.scheduler import Scheduler
from kubernetes_tpu_torch.engine.scheduler_engine import _aff_node_views
from kubernetes_tpu_torch.ops import affinity as aff_ops
from kubernetes_tpu_torch.ops.predicates import bucket
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite
from kubernetes_tpu_torch.state.cache import SchedulerCache
from kubernetes_tpu_torch.state.classes import ClassBatch
from kubernetes_tpu_torch.state.snapshot import ClusterSnapshot
from kubernetes_tpu_torch.utils.trace import COUNTERS

HOST = "kubernetes.io/hostname"
ZONE = "failure-domain.beta.kubernetes.io/zone"
SEEDS = [3, 17, 2024, 90210, 2 ** 31 + 11]


def dense_views(adata, labels):
    """The plain reference: the views as float64 products over the whole
    [L, N] label matrix, restricted to the nonzero term rows."""
    lab_t = labels.astype(np.float64).T
    C, A, L = adata.anti_keymask.shape
    n = lab_t.shape[1]
    km = adata.anti_keymask.reshape(C * A, L)
    key_node = np.zeros((C * A, n), dtype=np.int8)
    rows = np.nonzero(km.any(axis=1))[0]
    if rows.size:
        key_node[rows] = (km[rows].astype(np.float64) @ lab_t) > 0
    fs = adata.forbid_static
    static_hit = np.zeros((C, n), dtype=np.int8)
    frows = np.nonzero(fs.any(axis=1))[0]
    if frows.size:
        static_hit[frows] = (fs[frows].astype(np.float64) @ lab_t) > 0
    return key_node.reshape(C, A, n), static_hit


def _anti(app, key):
    return tt.Affinity(pod_anti_affinity=tt.PodAffinity(
        required_terms=[tt.PodAffinityTerm(
            label_selector=tt.LabelSelector(match_labels={"app": app}),
            namespaces=[], topology_key=key)]))


def _node(i, rng):
    labels = {HOST: f"n{i:03d}", "rack": f"r{rng.integers(12)}",
              "disk": ("ssd", "hdd")[rng.integers(2)]}
    if rng.random() < 0.9:
        labels[ZONE] = f"z{rng.integers(4)}"
    return tt.make_node(f"n{i:03d}", labels=labels)


def _world(seed):
    """A seeded cluster (64-512 nodes, never a multiple of the row pad)
    with bound pods that make forbid_static non-zero, and a pending mix:
    self-anti on hostname (gated), self-anti on zone (strict), anti on
    rack against the zone class, a node-selector class that interns an
    arbitrary key, and plain pods whose term rows are all zero."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(64, 505)) | 1
    cache = SchedulerCache()
    nodes = [_node(i, rng) for i in range(n)]
    for nd in nodes:
        cache.add_node(nd)
    for j in range(int(rng.integers(3, 12))):
        where = nodes[int(rng.integers(n))].name
        cache.add_pod(tt.make_pod(f"bound-h-{j}", cpu=100, labels={"app": "h"},
                                  node_name=where))
    guard = tt.make_pod("guard", cpu=100, labels={"app": "g"},
                        affinity=_anti("p", ZONE),
                        node_name=nodes[int(rng.integers(n))].name)
    cache.add_pod(guard)
    pending = []
    for j in range(int(rng.integers(4, 9))):
        pending.append(tt.make_pod(f"h-{j}", cpu=100, labels={"app": "h"},
                                   affinity=_anti("h", HOST)))
        pending.append(tt.make_pod(f"z-{j}", cpu=100, labels={"app": "z"},
                                   affinity=_anti("z", ZONE)))
        pending.append(tt.make_pod(f"r-{j}", cpu=100, labels={"app": "r"},
                                   affinity=_anti("z", "rack")))
        pending.append(tt.make_pod(f"p-{j}", cpu=100, labels={"app": "p"}))
        pending.append(tt.make_pod(f"s-{j}", cpu=100,
                                   node_selector={"disk": "ssd"}))
    infos = cache.node_infos()
    snap = ClusterSnapshot()
    snap.refresh(infos)
    all_pairs, aff_pairs = aff_ops.collect_pod_pairs(infos)
    aff_ops.intern_topology_pairs(snap, pending, aff_pairs)
    batch = ClassBatch(pending, snap)
    c_pad = bucket(batch.num_classes + 1)

    def build():
        return aff_ops.AffinityData(batch.reps, snap, all_pairs, aff_pairs,
                                    c_pad=c_pad)
    return snap, build


@pytest.mark.parametrize("seed", SEEDS)
def test_views_equal_the_dense_product(seed):
    snap, build = _world(seed)
    adata = build()
    assert snap.labels.shape[0] % 8 == 0
    assert not snap.valid.all()                     # padding rows
    C, A, _ = adata.anti_keymask.shape
    assert C * A > 1
    assert not adata.anti_keymask.reshape(C * A, -1).any(axis=1).all()
    assert adata.forbid_static.any()
    got = _aff_node_views(adata, *snap.label_nonzeros(),
                          snap.labels.shape[0])
    want = dense_views(adata, snap.labels)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int8 and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert got[0].any() and got[1].any()


@pytest.mark.parametrize("seed", SEEDS)
def test_domain_counts_and_classification_equal_the_dense_sum(seed,
                                                              monkeypatch):
    snap, build = _world(seed)
    counts = snap.domain_node_counts()
    dense = snap.labels.sum(axis=0, dtype=np.int64)
    assert counts.dtype == dense.dtype and counts.tobytes() == dense.tobytes()
    adata = build()
    monkeypatch.setattr(snap, "domain_node_counts",
                        lambda: snap.labels.sum(axis=0, dtype=np.int64))
    ref = build()
    assert adata.wave_strict.any() and adata.wave_gate.any()
    for k in ("wave_strict", "wave_gate", "wave_relevant"):
        assert getattr(adata, k).tobytes() == getattr(ref, k).tobytes(), k


def _check_index(snap):
    rows, cols = snap.label_nonzeros()
    er, ec = np.nonzero(snap.labels)
    np.testing.assert_array_equal(rows, er)
    np.testing.assert_array_equal(cols, ec)
    np.testing.assert_array_equal(snap.domain_node_counts(),
                                  snap.labels.sum(axis=0, dtype=np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_index_tracks_every_writer_of_the_label_matrix(seed):
    rng = np.random.default_rng(seed)
    cache = SchedulerCache()
    snap = ClusterSnapshot()
    names = []

    def add(k):
        for _ in range(k):
            nd = _node(len(names), rng)
            names.append(nd.name)
            cache.add_node(nd)

    def intern(k):
        for _ in range(k):
            info = cache.node_infos().get(
                names[int(rng.integers(len(names)))])
            if info is None or info.node is None:
                continue
            key = ("rack", ZONE, HOST, "disk")[int(rng.integers(4))]
            if key in info.node.labels:
                snap.ensure_label_pair(key, info.node.labels[key])
        snap.finalize_labels()

    add(int(rng.integers(20, 60)))
    snap.refresh(cache.node_infos())
    for nm in names:
        snap.ensure_label_pair(HOST, nm)
    intern(10)                                      # vocab growth
    _check_index(snap)
    ops = ("add", "relabel", "relabel_new", "remove", "intern", "drop")
    for _step in range(40):
        op = ops[int(rng.integers(len(ops)))]
        infos = cache.node_infos()
        live = [nm for nm in names if nm in infos
                and infos[nm].node is not None]
        if op == "add":
            add(int(rng.integers(1, 4)))            # bulk rebuild
        elif op in ("relabel", "relabel_new", "drop") and live:
            nm = live[int(rng.integers(len(live)))]
            node = infos[nm].node
            lbls = dict(node.labels)
            if op == "relabel":                     # to interned columns
                lbls["rack"] = f"r{rng.integers(12)}"
                lbls[ZONE] = f"z{rng.integers(4)}"
            elif op == "relabel_new":               # to a value not interned
                lbls["rack"] = f"new-{rng.integers(1000)}"
            else:
                lbls.pop(ZONE, None)
                lbls.pop(HOST, None)
            cache.update_node(dataclasses.replace(node, labels=lbls))
        elif op == "remove" and live:
            nm = live[int(rng.integers(len(live)))]
            cache.remove_node(nm)
            if rng.random() < 0.5:
                cache.purge_tombstones()
        elif op == "intern":
            intern(int(rng.integers(1, 6)))
        snap.refresh(cache.node_infos())
        _check_index(snap)
        if op == "relabel_new" and rng.random() < 0.5:
            intern(3)                               # the new value's column
            _check_index(snap)


# ------------------------------------------------- the engine's readers


def _iso(name, app="iso"):
    return tt.make_pod(name, cpu=100, memory=128 << 20, labels={"app": app},
                       affinity=_anti(app, HOST))


def _settle(s, loop):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        loop.step()
        if loop.settled():
            return
        s.sync(wait=0.02)
    raise AssertionError("drain did not settle")


def _sched(n):
    api = ApiServerLite()
    for i in range(n):
        api.create("Node", tt.make_node(
            f"n{i:02d}", memory=16 << 30,
            labels={HOST: f"n{i:02d}", ZONE: f"z{i % 2}"}))
    s = Scheduler(api, record_events=False, device="cpu")
    s.start()
    return api, s


def test_relabel_patch_leaves_the_views_of_a_fresh_build():
    """A node dropping its hostname label rides the relabel patch
    (label_patch_rows, no rebuild); the patched views equal the dense
    reference over the relabeled matrix."""
    api, s = _sched(10)
    loop = s.pipeline(chunk=64)
    try:
        for i in range(3):
            api.create("Pod", _iso(f"warm-{i}"))
        _settle(s, loop)
        used = {p.node_name for p in api.list("Pod")[0]}
        empty = sorted(f"n{i:02d}" for i in range(10)
                       if f"n{i:02d}" not in used)
        assert empty
        enc = s.engine._wave_enc
        before = enc.key_node.copy()
        c0 = COUNTERS.snapshot()
        nd = api.get("Node", "", empty[0])
        api.update("Node", dataclasses.replace(
            nd, labels={k: v for k, v in nd.labels.items() if k != HOST}))
        api.create("Pod", _iso("after"))
        _settle(s, loop)
        c1 = COUNTERS.snapshot()

        def delta(name):
            return c1.get(name, (0, 0.0))[0] - c0.get(name, (0, 0.0))[0]
        assert delta("engine.label_patch_rows") >= 1
        assert delta("engine.aff_full_rebuilds") == 0
        enc = s.engine._wave_enc
        snap = s.engine.snapshot
        kn, sfh = dense_views(enc.adata, snap.labels)
        assert enc.key_node.tobytes() == kn.tobytes()
        assert enc.static_forbid_hit.tobytes() == sfh.tobytes()
        assert not np.array_equal(before, enc.key_node)  # the row moved
        assert api.get("Pod", "default", "after").node_name not in used
    finally:
        loop.close()
        s.engine.close()


def test_view_counter_counts_the_index_entries_a_build_walks():
    api, s = _sched(24)
    try:
        c0 = COUNTERS.snapshot()
        for i in range(12):
            api.create("Pod", _iso(f"g-{i}"))
        s.sync()
        tot = s.run_until_drained(max_batch=64)
        c1 = COUNTERS.snapshot()
        assert tot["bound"] == 12
        builds = c1["engine.wave_aff_build"][0] \
            - c0.get("engine.wave_aff_build", (0, 0.0))[0]
        nnz = s.engine.snapshot.label_nonzeros()[1].size
        assert builds >= 1 and nnz >= 24
        walked = c1["engine.aff_view_nnz"][0] \
            - c0.get("engine.aff_view_nnz", (0, 0.0))[0]
        assert walked == builds * nnz
    finally:
        s.engine.close()
