"""The port's interned class keys (state/classes.py): equal specs resolve
to one shared key object, the per-pod memo (`_class_key`, `_class_node`)
holds a reference instead of a tuple of its own, a node_name change or a
copy never carries a stale key, the intern table clears at its bound, and
its two counters count the builds. Grouping and placements are the ones a
fresh key per pod gives, and the reference's on the same hollow cluster."""

from __future__ import annotations

import copy
import gc
import os
import random
import sys
import threading

import numpy as np
import pytest

from kubernetes_tpu_torch.api.types import Pod, make_pod
from kubernetes_tpu_torch.engine.scheduler import Scheduler, _queue_copy
from kubernetes_tpu_torch.models import hollow
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite
from kubernetes_tpu_torch.state import classes
from kubernetes_tpu_torch.state.cache import SchedulerCache
from kubernetes_tpu_torch.state.classes import (ClassBatch, _pod_class_key,
                                                pod_class_key)
from kubernetes_tpu_torch.state.snapshot import ClusterSnapshot
from kubernetes_tpu_torch.utils.trace import COUNTERS, freeze_long_lived
from tests import test_torch_pipeline as pipeline
from tests.torch_packages import PORT, helpers

Mi = 1 << 20
HIT, MISS = "classes.key_intern_hit", "classes.key_intern_miss"


def _counts():
    snap = COUNTERS.snapshot()
    return snap.get(HIT, (0, 0.0))[0], snap.get(MISS, (0, 0.0))[0]


@pytest.fixture
def fresh_table(monkeypatch):
    """An empty intern table of this test's own."""
    monkeypatch.setattr(classes, "_INTERN", {})
    return classes._INTERN


@pytest.mark.parametrize("profile", ["density", "binpack", "affinity",
                                     "mixed_affinity", "churn"])
def test_equal_specs_share_one_key_object(profile):
    pods = hollow.PROFILES[profile](200)
    by_value = {}
    for p in pods:
        k = pod_class_key(p)
        first = by_value.setdefault(k, k)
        assert k is first
        assert k == _pod_class_key(p)
        assert p.__dict__["_class_key"] is k


def test_two_fresh_pods_share_the_key_and_their_memos_hold_no_tuple():
    a = make_pod("a", cpu=100, memory=Mi, labels={"app": "x"})
    b = make_pod("b", cpu=100, memory=Mi, labels={"app": "x"})
    ka, kb = pod_class_key(a), pod_class_key(b)
    assert ka is kb
    # the memo is the shared key and the node_name it was built under
    assert a.__dict__["_class_key"] is b.__dict__["_class_key"] is ka
    assert a.__dict__["_class_node"] is a.node_name


def test_node_name_change_rebuilds_the_key():
    p = make_pod("p", cpu=100, memory=Mi)
    before = pod_class_key(p)
    assert before[4] == ""
    p.node_name = "n1"
    after = pod_class_key(p)
    assert after is not before
    assert after[4] == "n1"
    assert after == _pod_class_key(p)
    assert p.__dict__["_class_node"] is p.node_name
    # and back: the key built pending is the shared one again
    p.node_name = ""
    assert pod_class_key(p) is before


def test_memo_without_its_key_entry_is_a_miss():
    """A copier that pops only `_class_key` (as one written against the
    one-entry memo does) leaves `_class_node` behind: that alone is no
    memo."""
    p = make_pod("p", cpu=100, memory=Mi, labels={"app": "a"})
    pod_class_key(p)
    c = copy.copy(p)
    c.labels = {"app": "b"}
    c.__dict__.pop("_class_key")
    assert "_class_node" in c.__dict__
    assert pod_class_key(c) == _pod_class_key(c) != pod_class_key(p)


@pytest.mark.parametrize("node", ["", "n7"])
def test_queue_copy_carries_no_memo(node):
    p = make_pod("p", cpu=100, memory=Mi, labels={"app": "a"})
    p.node_name = node
    pod_class_key(p)
    c = _queue_copy(p)
    assert "_class_key" not in c.__dict__
    assert "_class_node" not in c.__dict__
    # a mutation of the copy shows in its key, never in the original's
    c.labels = {"app": "b"}
    assert pod_class_key(c) == _pod_class_key(c)
    assert pod_class_key(c) != pod_class_key(p)
    c2 = _queue_copy(p)
    assert pod_class_key(c2) is pod_class_key(p)


def test_hollow_copies_carry_no_memo_of_their_template():
    template = make_pod("t", cpu=100, memory=Mi, labels={"app": "t"})
    pod_class_key(template)
    labels = [{"app": f"a{i % 3}"} for i in range(9)]
    pods = hollow._materialize_pods(template, [f"p{i}" for i in range(9)],
                                    "bench", labels)
    for p, lab in zip(pods, labels):
        assert "_class_key" not in p.__dict__
        assert "_class_node" not in p.__dict__
        assert dict(pod_class_key(p)[1]) == lab
    assert len({id(pod_class_key(p)) for p in pods}) == 3


def test_table_clears_at_its_bound(fresh_table, monkeypatch):
    monkeypatch.setattr(classes, "_INTERN_MAX", 4)
    pods = [make_pod(f"p{i}", cpu=100 * (i + 1), memory=Mi)
            for i in range(9)]
    sizes = []
    for p in pods:
        pod_class_key(p)
        sizes.append(len(fresh_table))
    assert sizes == [1, 2, 3, 4, 1, 2, 3, 4, 1]
    assert max(sizes) <= classes._INTERN_MAX
    # a key from before a clear still equals the one built after it
    again = make_pod("again", cpu=100, memory=Mi)
    assert pod_class_key(again) == pod_class_key(pods[0])


def test_counters_count_misses_and_intern_hits(fresh_table):
    h0, m0 = _counts()
    a = make_pod("a", cpu=100, memory=Mi)
    b = make_pod("b", cpu=100, memory=Mi)
    c = make_pod("c", cpu=200, memory=Mi)
    pod_class_key(a)
    assert _counts() == (h0, m0 + 1)
    pod_class_key(b)
    assert _counts() == (h0 + 1, m0 + 1)
    pod_class_key(c)
    assert _counts() == (h0 + 1, m0 + 2)
    # memo hits count nothing
    for p in (a, b, c, a, b, c):
        pod_class_key(p)
    assert _counts() == (h0 + 1, m0 + 2)
    # a node_name change is a build: a miss for a spec not seen bound
    a.node_name = "n1"
    pod_class_key(a)
    assert _counts() == (h0 + 1, m0 + 3)
    b.node_name = "n1"
    pod_class_key(b)
    assert _counts() == (h0 + 2, m0 + 3)


def test_threads_keying_at_once_get_equal_keys_and_exact_counts(
        fresh_table, monkeypatch):
    """More threads than cores key pods of five specs through a table that
    clears every few builds, under a short switch interval: every key
    equals a fresh build, the table stays near its bound, and each build
    is counted once."""
    monkeypatch.setattr(classes, "_INTERN_MAX", 3)
    n_threads = 2 * (os.cpu_count() or 4)
    per = 400
    pods = [[make_pod(f"t{t}-{i}", cpu=100 * (1 + i % 5), memory=Mi)
             for i in range(per)] for t in range(n_threads)]
    bad, sizes = [], []

    def work(mine):
        for p in mine:
            if pod_class_key(p) != _pod_class_key(p):
                bad.append(p.name)
            sizes.append(len(fresh_table))

    h0, m0 = _counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(mine,))
                   for mine in pods]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    assert max(sizes) <= classes._INTERN_MAX + n_threads
    h1, m1 = _counts()
    assert (h1 - h0) + (m1 - m0) == n_threads * per


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_class_batch_groups_as_fresh_keys_do(seed):
    h = helpers(PORT)
    rng = random.Random(seed)
    cache = SchedulerCache()
    nodes = h.random_nodes(rng, 8)
    for n in nodes:
        cache.add_node(n)
    snap = ClusterSnapshot()
    snap.refresh(cache.node_infos())
    names = [n.name for n in nodes]
    pods = [h.random_pod(rng, i, names) for i in range(60)]
    # repeat specs, so that classes hold several pods
    pods += [copy.deepcopy(p) for p in pods[:30]]
    index, want = {}, []
    for p in pods:
        want.append(index.setdefault(_pod_class_key(p), len(index)))
    batch = ClassBatch(pods, snap)
    np.testing.assert_array_equal(batch.pod_class,
                                  np.asarray(want, dtype=np.int32))
    assert batch.num_classes == len(index)


@pytest.mark.parametrize("profile", ["density", "mixed_affinity"])
def test_drain_places_as_the_reference(profile):
    build = pipeline._profile(profile, 64, 600)
    COUNTERS.reset()
    port = pipeline._drain(pipeline.PORT, build, 128, 128)
    hits, _ = _counts()
    ref = pipeline._drain(pipeline.REF, build, 128, 128)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    pipeline._live_rows(port, ref)
    assert hits >= 500


def test_drain_keeps_one_class_key_per_class_alive():
    # gc.get_objects() leaves out what the first start froze: make that
    # freeze happen before this test's pods exist, so all of them are seen
    freeze_long_lived()
    api = ApiServerLite()
    hollow.load_cluster(api, hollow.hollow_nodes(64, seed=7),
                        hollow.density_pods(2000))
    s = Scheduler(api, record_events=False, device="cpu")
    s.start()
    tot = s.run_until_drained()
    s.sync()
    assert tot["bound"] == 2000
    gc.collect()
    live = [o for o in gc.get_objects() if type(o) is Pod]
    memos = {id(o.__dict__["_class_key"]) for o in live
             if "_class_key" in o.__dict__}
    values = {o.__dict__["_class_key"] for o in live
              if "_class_key" in o.__dict__}
    s.engine.close()
    assert sum(1 for o in live if "_class_key" in o.__dict__) >= 2000
    # one container per class (spec and node_name), not one per pod
    assert len(memos) == len(values) <= 64 + 1
