"""The port's federation tier on the CPU, held against the reference.

- ``ops/federation.route_scores(device="cpu")`` equals the reference's
  jitted ``route_scores`` and both packages' ``route_scores_host``
  bitwise, on seeded and seed-drawn [C, M] shapes that include
  int32 differences that wrap, ties, not-ready cells, zero capacities
  and negative headroom (int32 outputs compared exactly);
- ``FederationRouter.route()`` gives the reference's assignment on the
  same frozen aggregate columns, with ``use_device`` True, False and
  auto (a batch past ``DEVICE_MIN_BATCH`` takes the device route);
- the aggregate folds equal the store oracle and the reference's, the
  compacted-log rebuild matches, gangs route whole-cell, brownout
  spillover is exactly once, an ADMIT wire fault replays the same idem
  key, unroutable pods backlog and are admitted later — on ``LocalCell``s
  over the port's ``CellService`` with ``Scheduler(device="cpu")`` —
  and the same tier over the binary wire (``CellAgent`` + ``WireCell``)
  drains a mixed stream exactly once.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

import kubernetes_tpu.api.types as jt
import kubernetes_tpu.federation.aggregate as jagg
import kubernetes_tpu.federation.router as jrouter
import kubernetes_tpu.models.hollow as jh
import kubernetes_tpu.ops.federation as jfed
import kubernetes_tpu.server.apiserver_lite as japi
import kubernetes_tpu.testing.churn as jchurn
import kubernetes_tpu_torch.api.types as tt
import kubernetes_tpu_torch.federation.aggregate as tagg
import kubernetes_tpu_torch.federation.router as trouter
import kubernetes_tpu_torch.models.hollow as th
import kubernetes_tpu_torch.ops.federation as tfed
import kubernetes_tpu_torch.server.apiserver_lite as tapi
import kubernetes_tpu_torch.testing.churn as tchurn
from kubernetes_tpu_torch.engine.gang import (
    GANG_MIN_AVAILABLE_ANNOTATION,
    GANG_NAME_ANNOTATION,
)
from kubernetes_tpu_torch.engine.scheduler import Scheduler
from kubernetes_tpu_torch.federation.aggregate import (
    CellAggregate,
    aggregate_from_lists,
)
from kubernetes_tpu_torch.federation.cell import CellAgent, CellService
from kubernetes_tpu_torch.federation.router import (
    DEVICE_MIN_BATCH,
    FederationRouter,
    LocalCell,
    WireCell,
)
from kubernetes_tpu_torch.parallel.multiproc import audit_duplicate_binds
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


# ------------------------------------------------------------ route_scores


def _operands(rng, c, m, regime):
    """Nine route_scores operands of one regime (numpy, the router's
    dtypes)."""
    dem_cpu = rng.integers(0, 2000, c).astype(np.int32)
    dem_mem = rng.integers(0, 2000, c).astype(np.int32)
    cpu_free = rng.integers(-500, 40_000, m).astype(np.int32)
    mem_free = rng.integers(-500, 40_000, m).astype(np.int32)
    cpu_cap = rng.integers(1, 80_000, m).astype(np.int32)
    mem_cap = rng.integers(1, 80_000, m).astype(np.int32)
    pressure = rng.uniform(0, 3, m).astype(np.float32)
    ready = rng.random(m) > 0.3
    dom_ok = rng.random((c, m)) > 0.2
    if regime == "wrap":
        # free near INT32_MIN minus a positive demand wraps positive,
        # free near INT32_MAX minus a negative demand wraps negative
        cpu_free[::2] = I32_MIN + rng.integers(0, 1000, cpu_free[::2].size)
        mem_free[1::2] = I32_MAX - rng.integers(0, 1000, mem_free[1::2].size)
        dem_cpu[::3] = rng.integers(1000, 2 ** 30, dem_cpu[::3].size)
        dem_mem[1::3] = -rng.integers(1000, 2 ** 30, dem_mem[1::3].size)
        cpu_cap[:] = rng.integers(I32_MAX // 2, I32_MAX, m)
    elif regime == "ties":
        # every cell the same column: all scores tie, the first wins
        for a in (cpu_free, mem_free, cpu_cap, mem_cap, pressure):
            a[:] = a[0]
        ready[:] = True
        dom_ok[:] = True
    elif regime == "zero_cap":
        cpu_cap[::2] = 0
        mem_cap[1::2] = 0
        cpu_free[:] = rng.integers(0, 3, m)
    elif regime == "not_ready":
        ready[:] = False
        ready[m // 2] = True
    elif regime == "negative":
        cpu_free[:] = -rng.integers(1, 1000, m)
    return (dem_cpu, dem_mem, cpu_free, mem_free, cpu_cap, mem_cap,
            pressure, ready, dom_ok)


def _all_routes(args):
    """The verdict of every implementation, as numpy."""
    return {
        "port": tfed.route_scores(*args, device="cpu"),
        "port_host": tfed.route_scores_host(*args),
        "ref": np.asarray(jfed.route_scores(*args)),
        "ref_host": jfed.route_scores_host(*args),
    }


def _assert_all_equal(outs, c):
    want = outs["ref"]
    assert want.dtype == np.int32 and want.shape == (2, c)
    # the device routes return int32; the numpy twins keep numpy's sum
    # promotion (int64 counts) in both packages
    assert outs["port"].dtype == np.int32
    assert outs["port_host"].dtype == outs["ref_host"].dtype
    for name, got in outs.items():
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("regime", ["random", "wrap", "ties", "zero_cap",
                                    "not_ready", "negative"])
@pytest.mark.parametrize("c,m", [(1, 1), (1, 4), (33, 5), (256, 4),
                                 (300, 16)])
def test_route_scores_bitwise_equal_to_the_reference(regime, c, m):
    rng = np.random.default_rng([c, m, len(regime)])
    args = _operands(rng, c, m, regime)
    outs = _all_routes(args)
    _assert_all_equal(outs, c)
    if regime == "ties":
        fit = outs["port"][1] > 0
        assert fit.any() and (outs["port"][0][fit] == 0).all()
    if regime == "wrap":
        # the operands really hold int32 differences that wrap
        spare = args[2][None, :].astype(np.int64) - args[0][:, None]
        wrapped = (spare < I32_MIN) | (spare > I32_MAX)
        assert wrapped.any()


def test_route_scores_device_on_torch_tensors():
    """route_scores_device is the device function itself: on CPU tensors
    it returns the int32 [2, C] verdict unfetched."""
    import torch
    rng = np.random.default_rng(5)
    args = _operands(rng, 40, 6, "random")
    out = tfed.route_scores_device(*[torch.from_numpy(np.array(a))
                                     for a in args])
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 40)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jfed.route_scores(*args)))


@pytest.mark.parametrize("seed", range(40))
def test_route_scores_drawn_shapes(seed):
    """Shapes and operands drawn from the seed; every other draw takes
    its int32 operands from the whole int32 range."""
    c, m = 1 + seed * 37 % 64, 1 + seed % 8
    extremes = seed % 2 == 1
    rng = np.random.default_rng(seed)
    lo, hi = (I32_MIN, I32_MAX) if extremes else (-5000, 50_000)
    args = (rng.integers(lo, hi, c, endpoint=True).astype(np.int32),
            rng.integers(lo, hi, c, endpoint=True).astype(np.int32),
            rng.integers(lo, hi, m, endpoint=True).astype(np.int32),
            rng.integers(lo, hi, m, endpoint=True).astype(np.int32),
            rng.integers(lo, hi, m, endpoint=True).astype(np.int32),
            rng.integers(lo, hi, m, endpoint=True).astype(np.int32),
            rng.uniform(0, 4, m).astype(np.float32),
            rng.random(m) > 0.25,
            rng.random((c, m)) > 0.25)
    _assert_all_equal(_all_routes(args), c)


def test_route_scores_device_none_is_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    args = _operands(np.random.default_rng(0), 4, 2, "random")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfed.route_scores(*args)
    with pytest.raises(RuntimeError, match="CUDA"):
        FederationRouter([LocalCell("c0", None)])


# ------------------------------------------------- frozen-column routing


class _Dummy:
    def __init__(self, name):
        self.name = name

    def close(self):
        pass


FROZEN = {
    "c0": dict(nodes_total=10, nodes_ready=10, cpu_alloc_m=40_000,
               mem_alloc_mib=40_960, cpu_used_m=35_000, mem_used_mib=4_096,
               pending=0, domains={"z0": 5, "z1": 5}),
    "c1": dict(nodes_total=10, nodes_ready=10, cpu_alloc_m=40_000,
               mem_alloc_mib=40_960, cpu_used_m=8_000, mem_used_mib=4_096,
               pending=12, domains={"z1": 10}),
    "c2": dict(nodes_total=10, nodes_ready=10, cpu_alloc_m=40_000,
               mem_alloc_mib=40_960, cpu_used_m=8_000, mem_used_mib=4_096,
               pending=0, domains={"z2": 10}),
    "c3": dict(nodes_total=10, nodes_ready=10, cpu_alloc_m=40_000,
               mem_alloc_mib=40_960, cpu_used_m=8_000, mem_used_mib=4_096,
               pending=0, domains={"z2": 4, "z3": 6}),
}


def _frozen_router(router_mod, agg_mod, use_device, ready_c3=True, **kw):
    """Router over dummy handles with hand-frozen aggregate columns —
    route() reads only the columns."""
    router = router_mod.FederationRouter(
        [_Dummy(n) for n in FROZEN], use_device=use_device, **kw)
    for name, shape in FROZEN.items():
        router.aggs[name] = agg_mod.CellAggregate(
            cell=name, ready=ready_c3 or name != "c3", **shape)
    return router


def _mixed_batch(types, n_plain):
    """Plain pods of three sizes, zone pins, two gangs and one pod no
    cell fits."""
    def pod(name, cpu=100, **kw):
        return types.make_pod(name, cpu=cpu, memory=64 << 20, **kw)

    pods = [pod(f"d{i}", cpu=100 + 50 * (i % 3)) for i in range(n_plain)]
    pods += [pod("z1-pin", node_selector={"zone": "z1"}),
             pod("z2-pin", node_selector={"zone": "z2"}),
             pod("z3-pin", node_selector={"zone": "z3"}),
             pod("z9-pin", node_selector={"zone": "z9"}),
             pod("huge", cpu=10 ** 6)]
    for g, members in (("dg", 4), ("eg", 7)):
        for m in range(members):
            p = pod(f"{g}-{m}", cpu=50)
            p.annotations[GANG_NAME_ANNOTATION] = g
            p.annotations[GANG_MIN_AVAILABLE_ANNOTATION] = str(members)
            pods.append(p)
    return pods


def _keys(assigned, leftover):
    return ({c: [p.key() for p in ps] for c, ps in assigned.items()},
            [p.key() for p in leftover])


@pytest.mark.parametrize("use_device", [False, True, None])
@pytest.mark.parametrize("n_plain", [40, DEVICE_MIN_BATCH + 17])
@pytest.mark.parametrize("ready_c3", [True, False])
def test_route_equals_the_reference_on_frozen_columns(use_device, n_plain,
                                                      ready_c3):
    exclude = {f"default/d{i}": "c1" for i in range(0, n_plain, 5)}
    tr = _frozen_router(trouter, tagg, use_device, ready_c3, device="cpu")
    jr = _frozen_router(jrouter, jagg, use_device, ready_c3)
    got = _keys(*tr.route(_mixed_batch(tt, n_plain), exclude=exclude))
    want = _keys(*jr.route(_mixed_batch(jt, n_plain), exclude=exclude))
    assert got == want
    assert "default/huge" in got[1] and "default/z9-pin" in got[1]
    # excluded pods never return to the cell they spilled from
    assert not set(exclude) & set(got[0].get("c1", []))
    tc, jc = tr.counters_snapshot(), jr.counters_snapshot()
    assert tc == jc
    on_device = use_device or (use_device is None
                               and n_plain + 16 >= DEVICE_MIN_BATCH)
    assert tc["device_batches"] == (1 if on_device else 0)
    assert tc["host_batches"] == (0 if on_device else 1)
    # the optimistic pending charge moved the same way
    assert {n: a.pending for n, a in tr.aggs.items()} \
        == {n: a.pending for n, a in jr.aggs.items()}


def test_frozen_tensor_routes_bit_identical_run_to_run():
    a1 = _keys(*_frozen_router(trouter, tagg, False, device="cpu").route(
        _mixed_batch(tt, 40)))
    a2 = _keys(*_frozen_router(trouter, tagg, True, device="cpu").route(
        _mixed_batch(tt, 40)))
    assert a1 == a2
    z2 = [c for c, ks in a1[0].items() if "default/z2-pin" in ks]
    assert z2 and z2[0] in ("c2", "c3")


# --------------------------------------------------------- aggregates


def _world(types, hollow, api_mod):
    api = api_mod.ApiServerLite()
    nodes = hollow.hollow_nodes(24, seed=4)
    for i, n in enumerate(nodes):
        n.labels["zone"] = f"w-z{i % 3}"
        if i % 7 == 3:
            n.unschedulable = True
        api.create("Node", n)
    pods = hollow.mixed_affinity_pods(60, seed=6)
    for i, p in enumerate(pods):
        if i % 3:
            p.node_name = nodes[i % 24].name
        api.create("Pod", p)
    return api


def test_aggregate_from_lists_equals_the_reference():
    tapi_ = _world(tt, th, tapi)
    japi_ = _world(jt, jh, japi)
    tn, _ = tapi_.list("Node")
    tp, _ = tapi_.list("Pod")
    jn, _ = japi_.list("Node")
    jp, _ = japi_.list("Pod")
    got = tagg.aggregate_from_lists(tn, tp, cell="w").to_dict()
    want = jagg.aggregate_from_lists(jn, jp, cell="w").to_dict()
    assert got == want
    assert got["nodes_ready"] < got["nodes_total"] and got["pending"] > 0


def test_fold_log_equals_the_reference():
    """Folding the same store event log delta by delta gives the same
    column in both packages, and the oracle's capacity picture."""
    out = {}
    for name, types, hollow, api_mod, agg_mod in (
            ("port", tt, th, tapi, tagg), ("ref", jt, jh, japi, jagg)):
        api = _world(types, hollow, api_mod)
        pods, _ = api.list("Pod")
        for p in pods[:10]:
            if p.node_name:
                api.delete("Pod", p.namespace, p.name)
        agg = agg_mod.CellAggregate(cell="w")
        evs = api.watch_since(("Node", "Pod"), 0, timeout=0)
        cursor = agg_mod.fold_log(agg, evs, 0)
        out[name] = (agg.to_dict(), cursor)
    assert out["port"] == out["ref"]


def test_brownout_schedule_equals_the_reference():
    names = ["c0", "c1", "c2"]
    for seed in (0, 42, 43):
        got = tchurn.make_brownout_schedule(names, 10.0, down_s=2.0,
                                            count=3, seed=seed)
        want = jchurn.make_brownout_schedule(names, 10.0, down_s=2.0,
                                             count=3, seed=seed)
        assert [(o.t, o.cell, o.down_s) for o in got] \
            == [(o.t, o.cell, o.down_s) for o in want]


# ------------------------------------------------ cells on the CPU


def _pod(name, cpu=100, mem=64 << 20, **kw):
    return tt.make_pod(name, cpu=cpu, memory=mem, **kw)


def _gang(name, members, cpu=50):
    out = []
    for m in range(members):
        p = _pod(f"{name}-{m}", cpu=cpu, mem=32 << 20)
        p.annotations[GANG_NAME_ANNOTATION] = name
        p.annotations[GANG_MIN_AVAILABLE_ANNOTATION] = str(members)
        out.append(p)
    return out


class _Cell:
    """One in-process cell: store + engine on the CPU + CellService,
    pumped from the test's own thread (no pump thread)."""

    def __init__(self, name, n_nodes=16, zones=4):
        self.name = name
        self.api = ApiServerLite()
        for i, n in enumerate(th.hollow_nodes(n_nodes)):
            n.labels["zone"] = f"{name}-z{i % zones}"
            self.api.create("Node", n)
        self.sched = Scheduler(self.api, record_events=False, device="cpu")
        self.svc = CellService(self.api, cell=name)
        self.sched.spill_handler = self.svc.spill
        self.sched.spill_after_attempts = 2
        self.sched.start()
        self.loop = self.sched.stream(budget_s=0.05, min_quantum=8,
                                      max_quantum=128)
        self.handle = LocalCell(name, self.svc)

    def pump(self, steps=8):
        for _ in range(steps):
            self.loop.step(wait=0.001)

    def bound_keys(self):
        pods, _rv = self.api.list("Pod")
        return {p.key(): p.node_name for p in pods if p.node_name}

    def close(self):
        self.loop.close()
        self.sched.engine.close()


@pytest.fixture
def two_cells():
    cells = [_Cell("alpha"), _Cell("beta")]
    router = FederationRouter([c.handle for c in cells], device="cpu")
    router.hydrate()
    yield cells, router
    for c in cells:
        c.close()


def _drain(cells, router, rounds=60):
    for _ in range(rounds):
        for c in cells:
            c.pump(4)
        router.spill_pump()
        if sum(a.pending for a in router.aggs.values()) == 0 \
                and not router.backlog:
            return
    raise AssertionError(
        f"fleet did not drain: pending="
        f"{ {n: a.pending for n, a in router.aggs.items()} } "
        f"backlog={len(router.backlog)}")


def test_gang_routes_whole_cell_and_binds_there(two_cells):
    cells, router = two_cells
    router.admit([_pod(f"f{i}") for i in range(10)] + _gang("tg", 5))
    assert router.counters_snapshot()["routed_gangs"] == 1
    _drain(cells, router)
    homes = set()
    for c in cells:
        members = [k for k in c.bound_keys() if k.startswith("default/tg-")]
        if members:
            homes.add(c.name)
            assert len(members) == 5, f"gang split inside {c.name}"
    assert len(homes) == 1, f"gang spanned cells: {homes}"


def _bind_event_cells(cells):
    """pod key -> the cells whose store log EVER bound it."""
    seen = {}
    for c in cells:
        with c.api._lock:
            log = list(c.api._log)
        for ev in log:
            if ev.kind == "Pod" and ev.type == "MODIFIED" \
                    and getattr(ev.obj, "node_name", ""):
                seen.setdefault(ev.obj.key(), set()).add(c.name)
    return seen


def test_brownout_spillover_is_exactly_once(two_cells):
    cells, router = two_cells
    alpha, beta = cells
    router.admit([_pod(f"b{i}") for i in range(30)])
    beta.pump(4)   # alpha's share is still pending when it browns out
    evacuated = router.brownout("alpha")
    assert not router.aggs["alpha"].ready and evacuated > 0
    _drain(cells, router)
    router.recover("alpha")
    assert router.aggs["alpha"].ready
    owner = {}
    for c in cells:
        for k in c.bound_keys():
            assert k not in owner, f"{k} bound in {owner[k]} and {c.name}"
            owner[k] = c.name
        assert audit_duplicate_binds(c.api) == 0
    assert len(owner) == 30
    for key, homes in _bind_event_cells(cells).items():
        assert len(homes) == 1, f"{key} has bind events in {homes}"
    assert router.counters_snapshot()["evacuated_moved"] == evacuated


def test_admit_wire_fault_replays_same_idem_key(two_cells):
    cells, router = two_cells
    alpha = cells[0]
    real_admit = alpha.handle.admit
    state = {"fired": False}

    def flaky_admit(idem_key, pods):
        out = real_admit(idem_key, pods)
        if not state["fired"]:
            state["fired"] = True
            raise ConnectionError("reply lost after commit")
        return out

    alpha.handle.admit = flaky_admit
    router.admit([_pod(f"r{i}") for i in range(8)])
    assert state["fired"]
    names = sorted(p.name for c in cells for p in c.api.list("Pod")[0])
    assert names == sorted(f"r{i}" for i in range(8))
    # the replay hit the idem cache, not the store
    assert alpha.svc.counters_snapshot()["admit_replays"] == 0


def test_folded_aggregate_equals_store_oracle(two_cells):
    cells, router = two_cells
    alpha = cells[0]
    router.admit([_pod(f"o{i}") for i in range(20)])
    alpha.pump(6)
    cells[1].pump(6)
    d, _spilled = alpha.handle.cell_agg()
    folded = CellAggregate.from_dict(d)
    nodes, _rv = alpha.api.list("Node")
    pods, _rv = alpha.api.list("Pod")
    oracle = aggregate_from_lists(nodes, pods, cell="alpha")
    fields = ("nodes_total", "nodes_ready", "cpu_alloc_m", "mem_alloc_mib",
              "cpu_used_m", "mem_used_mib", "domains")
    for key in fields + ("pending", "bound_total"):
        assert getattr(folded, key) == getattr(oracle, key), key
    assert oracle.bound_total > 0
    router.hydrate()
    for key in fields:
        assert getattr(router.aggs["alpha"], key) == getattr(oracle, key), key


def test_compacted_log_rebuild_matches_oracle():
    api = ApiServerLite(max_log=64)
    for i, n in enumerate(th.hollow_nodes(8)):
        n.labels["zone"] = f"g-z{i % 2}"
        api.create("Node", n)
    svc = CellService(api, cell="gamma")
    d, _sp = svc.cell_aggregate()
    assert d["nodes_total"] == 8
    for i in range(200):   # past the 64-event log: the cursor is too old
        api.create("Pod", _pod(f"c{i}"))
    d, _sp = svc.cell_aggregate()
    assert svc.counters_snapshot()["agg_rebuilds"] == 1
    nodes, _rv = api.list("Node")
    pods, _rv = api.list("Pod")
    oracle = aggregate_from_lists(nodes, pods, cell="gamma")
    assert d["pending"] == oracle.pending == 200
    assert d["cpu_used_m"] == oracle.cpu_used_m


def test_first_admission_equals_the_reference():
    """The same two-cell world in both packages, hydrated from store
    truth: the first admission puts the same pods in the same cells."""
    import kubernetes_tpu.engine.gang as jgang
    import kubernetes_tpu.federation.cell as jcell
    import kubernetes_tpu_torch.federation.cell as tcell

    def stores(types, hollow, api_mod, cell_mod, router_mod, gang, **kw):
        cells = []
        for name in ("alpha", "beta"):
            api = api_mod.ApiServerLite()
            for i, n in enumerate(hollow.hollow_nodes(12 if name == "alpha"
                                                      else 20)):
                n.labels["zone"] = f"{name}-z{i % 3}"
                api.create("Node", n)
            cells.append(router_mod.LocalCell(
                name, cell_mod.CellService(api, cell=name)))
        router = router_mod.FederationRouter(cells, **kw)
        router.hydrate()
        pods = [types.make_pod(f"a{i}", cpu=200 * (1 + i % 4),
                               memory=64 << 20) for i in range(50)]
        pods.append(types.make_pod("pin", cpu=100, memory=64 << 20,
                                   node_selector={"zone": "alpha-z2"}))
        for m in range(6):
            p = types.make_pod(f"g-{m}", cpu=50, memory=32 << 20)
            p.annotations[gang.GANG_NAME_ANNOTATION] = "g"
            pods.append(p)
        out = router.admit(pods)
        return out, {c.name: sorted(p.name for p in
                                    c._svc.api.list("Pod")[0])
                     for c in cells}

    import kubernetes_tpu_torch.engine.gang as tgang
    got = stores(tt, th, tapi, tcell, trouter, tgang, device="cpu")
    want = stores(jt, jh, japi, jcell, jrouter, jgang)
    assert got == want
    assert "pin" in got[1]["alpha"]


def test_unroutable_pods_backlog_then_admit_after_capacity():
    class _Solo(_Dummy):
        def __init__(self, name):
            super().__init__(name)
            self.batches = []

        def admit(self, idem_key, pods):
            self.batches.append(list(pods))
            return len(pods), 0

    cell = _Solo("solo")
    router = FederationRouter([cell], device="cpu")
    router.aggs["solo"] = CellAggregate(
        cell="solo", ready=True, nodes_total=2, nodes_ready=2,
        cpu_alloc_m=1000, mem_alloc_mib=1024, cpu_used_m=900,
        mem_used_mib=0)
    router.admit([_pod("big", cpu=500)])
    assert len(router.backlog) == 1
    assert router.counters_snapshot()["unroutable"] == 1
    assert cell.batches == []
    with router._lock:
        router.aggs["solo"].cpu_used_m = 100
    assert router.pump_backlog() == 1
    assert [p.name for b in cell.batches for p in b] == ["big"]


# ------------------------------------------------ cells over the wire


def test_wire_cells_drain_a_mixed_stream_exactly_once():
    """Two CellAgents (engine on the CPU, pump thread, AsyncBinaryServer)
    behind WireCells: a stream of plain, zone-pinned and gang pods with
    a brownout mid-way drains to zero, each pod bound once in one cell,
    and a batch past DEVICE_MIN_BATCH takes the device route."""
    agents = []
    for name in ("c0", "c1"):
        nodes = th.hollow_nodes(16, seed=len(agents))
        for i, n in enumerate(nodes):
            n.labels["zone"] = f"{name}-z{i % 4}"
        agents.append(CellAgent(name, nodes, min_quantum=8,
                                max_quantum=256, device="cpu"))
    for a in agents:
        a.start()
    router = FederationRouter(
        [WireCell(a.name, "127.0.0.1", a.port) for a in agents],
        device="cpu")
    try:
        router.hydrate()
        pods = [_pod(f"w{i}", node_selector={"zone": f"c{i % 2}-z1"}
                     if i % 8 == 5 else None) for i in range(60)]
        for g in range(2):
            pods += _gang(f"wg{g}", 4)
        for i in range(0, len(pods), 16):
            router.admit(pods[i:i + 16])
            if i == 32:
                router.brownout("c1")
        router.recover("c1")
        burst = [_pod(f"burst{i}", cpu=10) for i in range(DEVICE_MIN_BATCH)]
        router.admit(burst)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            router.spill_pump()
            if sum(a.pending for a in router.aggs.values()) == 0 \
                    and not router.backlog:
                break
            time.sleep(0.05)
        assert sum(a.pending for a in router.aggs.values()) == 0
        assert not router.backlog
        counters = router.counters_snapshot()
        assert counters["device_batches"] >= 1
        assert counters["brownouts"] == 1
    finally:
        router.close()
        stats = [a.stop() for a in agents]
    owner = {}
    for a in agents:
        assert audit_duplicate_binds(a.api) == 0
        for p in a.api.list("Pod")[0]:
            assert p.node_name, p.key()
            assert p.key() not in owner
            owner[p.key()] = a.name
    assert len(owner) == len(pods) + len(burst)
    assert all(isinstance(s, dict) for s in stats)
