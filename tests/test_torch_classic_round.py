"""The port's classic synchronous round on the CPU against the reference
package's, exactly: SchedulingEngine.schedule in wave and strict mode with
live inter-pod affinity and selector spreading (the wave pass with
batch-frozen scores, the seeded strict scan for `serialize` classes), a
strict batch that interleaves host-oracle and device pods (the same-path
runs in FIFO order), the Scheduler's run_until_drained(pipeline=False)
through the store, and the full-surface fuzz generator in strict mode.
Placements, fit counts and the round-robin counter must be equal."""

import copy
import dataclasses
import enum
import random
import sys

import pytest

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api import workloads as jw
from kubernetes_tpu.engine import scheduler as jsched
from kubernetes_tpu.engine.scheduler_engine import \
    SchedulingEngine as JEngine
from kubernetes_tpu.models import hollow as jh
from kubernetes_tpu.server import apiserver_lite as japi
from kubernetes_tpu.state.cache import SchedulerCache as JCache
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api import workloads as tw
from kubernetes_tpu_torch.engine import scheduler as tsched
from kubernetes_tpu_torch.engine.scheduler_engine import \
    SchedulingEngine as TEngine
from kubernetes_tpu_torch.models import hollow as th
from kubernetes_tpu_torch.server import apiserver_lite as tapi
from kubernetes_tpu_torch.state.cache import SchedulerCache as TCache
from kubernetes_tpu_torch.utils import trace as ttrace
from tests.test_full_fuzz import (
    PRIORITY_SETS,
    _existing,
    full_random_nodes,
    full_random_pod,
)

REF = dict(types=jt, wl=jw, hollow=jh, Cache=JCache, Engine=JEngine,
           api=japi, sched=jsched, kw={})
PORT = dict(types=tt, wl=tw, hollow=th, Cache=TCache, Engine=TEngine,
            api=tapi, sched=tsched, kw={"device": "cpu"})


def to_port(obj):
    """A reference API object (dataclass tree) -> the port's class of the
    same name, field by field."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = sys.modules[type(obj).__module__.replace(
            "kubernetes_tpu.", "kubernetes_tpu_torch.", 1)]
        cls = getattr(mod, type(obj).__name__)
        return cls(**{f.name: to_port(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, enum.Enum):
        mod = sys.modules[type(obj).__module__.replace(
            "kubernetes_tpu.", "kubernetes_tpu_torch.", 1)]
        return getattr(mod, type(obj).__name__)(obj.value)
    if isinstance(obj, list):
        return [to_port(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(to_port(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    return obj


def _services(types, namespace):
    """Services over two of mixed_affinity's apps: SelectorSpread live."""
    return [types.WorkloadObject("Service", f"svc-{app}", namespace,
                                 match_labels={"app": app})
            for app in ("iso-0", "web-1")]


def _totals(cache):
    return {name: (info.requested.milli_cpu, info.requested.memory,
                   len(info.pods), sorted(info.used_ports))
            for name, info in cache.node_infos().items()}


def _mixed_rounds(side, mode, n_nodes=64, n_pods=200, rounds=2):
    ttrace.COUNTERS.reset()
    cache = side["Cache"]()
    for nd in side["hollow"].hollow_nodes(n_nodes, seed=2):
        cache.add_node(nd)
    wl = []
    eng = side["Engine"](cache, workloads_provider=lambda: wl, **side["kw"])
    out = []
    for k in range(rounds):
        ns = f"ns{k}"
        wl.extend(_services(side["types"], ns))
        res = eng.schedule(side["hollow"].mixed_affinity_pods(
            n_pods, seed=k, namespace=ns), mode=mode)
        out.append(([r.node_name for r in res], [r.fit_count for r in res],
                     eng.rr.counter))
    return out, _totals(cache)


@pytest.mark.parametrize("mode", ["wave", "strict"])
def test_mixed_affinity_schedule_matches_reference(mode):
    jout, jtot = _mixed_rounds(REF, mode)
    tout, ttot = _mixed_rounds(PORT, mode)
    for (jn, jf, jc), (tn, tf, tc) in zip(jout, tout):
        assert tn == jn
        assert tf == jf
        assert tc == jc
    assert ttot == jtot
    assert sum(n is not None for n in tout[-1][0]) > 0
    if mode == "wave":
        # the pack-into-one-zone classes took the seeded strict scan
        rows = ttrace.COUNTERS.snapshot()["engine.classic_strict_rows"][0]
        assert rows > 0


def _interleaved(types, n, k):
    """ABAB...: a 9-host-port pod (past the encoding's 8 ports: the exact
    host oracle) between plain pods of one class."""
    pods = []
    for i in range(n):
        if i % 2:
            pods.append(types.make_pod(f"host-{k}-{i}", cpu=300,
                                       memory=256 << 20,
                                       ports=list(range(7000 + i,
                                                        7009 + i))))
        else:
            pods.append(types.make_pod(f"dev-{k}-{i}", cpu=300,
                                       memory=256 << 20))
    return pods


@pytest.mark.parametrize("mode", ["strict", "wave"])
def test_interleaved_host_and_device_batch_matches_reference(mode):
    """strict mode splits the batch into same-path runs, each refreshing
    the snapshot; wave mode places the device pods first, then the host
    pods in FIFO order. Both must give the reference's placements, fit
    counts and counter."""
    def run(side):
        cache = side["Cache"]()
        for nd in side["hollow"].hollow_nodes(16, seed=2):
            cache.add_node(nd)
        eng = side["Engine"](cache, **side["kw"])
        out = []
        for k in range(2):
            res = eng.schedule(_interleaved(side["types"], 40, k),
                               mode=mode)
            out.append(([r.node_name for r in res],
                        [r.fit_count for r in res], eng.rr.counter))
        return out, _totals(cache)

    jout, jtot = run(REF)
    tout, ttot = run(PORT)
    assert tout == jout
    assert ttot == jtot
    names = [n for n in tout[0][0] if n is not None]
    assert len(names) == 40


def _drain(side, batch_mode):
    api = side["api"].ApiServerLite()
    h = side["hollow"]
    h.load_cluster(api, h.hollow_nodes(48),
                   h.PROFILES["mixed_affinity"](240))
    for app in ("iso-0", "web-1"):
        api.create("Service", side["wl"].Service(
            f"svc-{app}", "bench", selector={"app": app}))
    s = side["sched"].Scheduler(api, record_events=False,
                                batch_mode=batch_mode, **side["kw"])
    s.start()
    tot = s.run_until_drained(pipeline=False)
    placed = {p.name: p.node_name for p in api.list("Pod")[0]}
    return tot, placed, s.engine.rr.counter


@pytest.mark.parametrize("batch_mode", ["wave", "strict"])
def test_classic_drain_through_the_store_matches_reference(batch_mode):
    jtot, jplaced, jrr = _drain(REF, batch_mode)
    ttot, tplaced, trr = _drain(PORT, batch_mode)
    assert tplaced == jplaced
    assert ttot == jtot
    assert trr == jrr
    assert ttot["bound"] == 240


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_full_surface_strict_matches_reference(seed):
    """The full-surface fuzz generator (volumes, storage, extended
    resources, images, prefer-avoid, preferred node affinity, ports,
    taints) in strict mode: same objects, same node choices."""
    rng = random.Random(1000 + seed)
    nodes = full_random_nodes(rng, rng.choice([8, 16]))
    existing = _existing(rng, nodes, rng.randint(4, 12))
    names = [n.name for n in nodes]
    pending = [full_random_pod(rng, i, names)
               for i in range(rng.choice([16, 24]))]
    pset = PRIORITY_SETS[seed % len(PRIORITY_SETS)]

    def run(side, conv):
        cache = side["Cache"]()
        for n in nodes:
            cache.add_node(conv(copy.deepcopy(n)))
        for p in existing:
            cache.add_pod(conv(copy.deepcopy(p)))
        eng = side["Engine"](cache, priorities=pset, **side["kw"])
        res = eng.schedule([conv(copy.deepcopy(p)) for p in pending],
                           mode="strict")
        return ([r.node_name for r in res], [r.fit_count for r in res],
                eng.rr.counter, _totals(cache))

    want = run(REF, lambda o: o)
    got = run(PORT, to_port)
    assert got == want
    assert any(n is not None for n in got[0])
