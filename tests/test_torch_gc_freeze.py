"""The scheduler's first start freezes the process's long-lived heap
(utils.trace.freeze_long_lived): one full collection, so that only what is
still reachable is kept, then gc.freeze(), once per process. Later starts
neither collect nor freeze; a cycle made after the freeze is still
reclaimed; placements do not depend on it. Each case runs in a fresh
interpreter, so that the heap under test is its own and not this suite's."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PRELUDE = '''
import gc, json, weakref
from kubernetes_tpu_torch.engine import scheduler
from kubernetes_tpu_torch.models import hollow
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite
from kubernetes_tpu_torch.utils import trace
from kubernetes_tpu_torch.utils.trace import COUNTERS


def cluster(seed=7):
    api = ApiServerLite()
    hollow.load_cluster(api, hollow.hollow_nodes(32, seed=seed),
                        hollow.mixed_affinity_pods(300, seed=seed))
    return api


def started(api):
    """A scheduler on `api`, started; and the full passes in start()."""
    s = scheduler.Scheduler(api, record_events=False, device="cpu")
    full = []

    def watch(phase, info):
        if phase == "stop" and info["generation"] == 2:
            full.append(1)
    gc.callbacks.append(watch)
    try:
        s.start()
    finally:
        gc.callbacks.remove(watch)
    return s, len(full)


def drain(api, s):
    """Bound count and every pod's (key, node) once `s` has drained."""
    tot = s.run_until_drained()
    s.sync()
    s.engine.close()
    return tot["bound"], sorted([p.key(), p.node_name]
                                for p in api.list("Pod")[0])


def counters():
    return [COUNTERS.count("runtime.gc_freeze"),
            COUNTERS.count("runtime.gc_frozen_objects")]


def tracked(obj):
    """True while the collector's passes walk `obj` (not frozen)."""
    return any(o is obj for o in gc.get_objects())


def out(**kw):
    print(json.dumps(kw))
'''


def _run(body: str) -> dict:
    """Run PRELUDE + `body` in a fresh interpreter; its last line of
    output, as JSON."""
    r = subprocess.run(
        [sys.executable, "-c", PRELUDE + textwrap.dedent(body)], cwd=ROOT,
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONHASHSEED": "0"})
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_the_first_start_freezes():
    r = _run('''
        api = cluster()
        before = gc.get_freeze_count()
        was_tracked = tracked(api)
        c0 = counters()
        s, full = started(api)
        out(before=before, after=gc.get_freeze_count(), c0=c0,
            c1=counters(), full=full, recorded=trace.freeze_long_lived(),
            was_tracked=was_tracked, tracked=tracked(api),
            tracked_cache=tracked(s.cache))
    ''')
    assert r["c0"] == [0, 0]
    assert r["after"] > r["before"]
    assert r["c1"] == [1, r["recorded"]]
    assert r["recorded"] >= r["after"] > 0
    assert r["full"] == 1                 # the freeze's own collection
    # the cluster and the cache are out of the passes from here on
    assert r["was_tracked"] and not r["tracked"]
    assert not r["tracked_cache"]


def test_a_second_start_neither_collects_nor_freezes():
    r = _run('''
        first, full1 = started(cluster())
        c1, f1 = counters(), gc.get_freeze_count()
        api = cluster(seed=8)
        second, full2 = started(api)
        out(full1=full1, full2=full2, c1=c1, c2=counters(), f1=f1,
            f2=gc.get_freeze_count(), recorded=trace.freeze_long_lived(),
            c3=counters(), tracked=tracked(api))
    ''')
    assert r["full1"] == 1 and r["full2"] == 0
    assert r["c1"] == r["c2"] == r["c3"] == [1, r["recorded"]]
    assert r["f2"] <= r["f1"]
    assert r["tracked"]                   # made after the freeze


def test_a_cycle_made_after_the_start_is_reclaimed():
    r = _run('''
        class Box:
            pass

        def cycle():
            b = Box()
            b.me = b
            return weakref.ref(b)

        api = cluster()
        gc.disable()            # no automatic pass before the freeze's own
        early = cycle()         # garbage at the freeze: collected, not kept
        first, _ = started(api)
        gc.enable()
        late = cycle()
        api = cluster(seed=8)
        s, _ = started(api)
        bound, _ = drain(api, s)
        later_sched = weakref.ref(s)
        del s, api
        gc.collect()
        out(early=early() is None, late=late() is None,
            sched=later_sched() is None, bound=bound)
    ''')
    assert r["early"] and r["late"]
    assert r["sched"]                    # a later scheduler, drained
    assert r["bound"] == 300


def test_a_drain_places_alike_with_and_without_a_prior_freeze():
    plain = _run('''
        scheduler.freeze_long_lived = lambda: 0
        before = gc.get_freeze_count()
        api = cluster()
        s, _ = started(api)
        bound, placed = drain(api, s)
        out(bound=bound, placed=placed, c=counters(),
            froze=gc.get_freeze_count() - before)
    ''')
    frozen = _run('''
        started(cluster(seed=8))
        api = cluster()
        s, _ = started(api)
        bound, placed = drain(api, s)
        out(bound=bound, placed=placed, c=counters())
    ''')
    assert plain["c"] == [0, 0] and plain["froze"] == 0
    assert frozen["c"][0] == 1
    assert plain["bound"] == frozen["bound"] == 300
    assert plain["placed"] == frozen["placed"]
    assert all(node for _, node in plain["placed"])


def test_ten_starts_freeze_once_and_retain_a_bounded_heap():
    r = _run('''
        counts, frozen, live = [], [], []
        for i in range(10):
            api = cluster(seed=7 + i)
            s, full = started(api)
            frozen.append(gc.get_freeze_count())
            counts.append(counters())
            bound, _ = drain(api, s)
            assert bound == 300, bound
            del s, api
            gc.collect()
            live.append(len(gc.get_objects()))
        out(counts=counts, frozen=frozen, live=live,
            recorded=trace.freeze_long_lived())
    ''')
    assert r["counts"] == [[1, r["recorded"]]] * 10
    # no later start froze anything: the frozen count never rises
    assert all(b <= a for a, b in zip(r["frozen"], r["frozen"][1:]))
    assert r["frozen"][-1] <= r["recorded"]
    # each cycle's scheduler and cluster are reclaimed: the heap the
    # passes walk does not grow with the starts
    assert r["live"][-1] <= r["live"][0]
