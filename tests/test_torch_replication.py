"""The port's WAL shipping (server/replication.py) and chaos rig
(testing/chaosmonkey.py): the five tests of tests/test_replication.py on
the port's modules, the failover storm with the port's scheduler on the
CPU; then the storm behind the full apiserver at 200 nodes x 2,000 pods
through both packages, whose promoted stores must hold the same
placements, bind for bind."""

from __future__ import annotations

import os
import struct
import zlib

from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.engine.scheduler import Scheduler
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite
from kubernetes_tpu_torch.server.durable import DurableStore
from kubernetes_tpu_torch.server.replication import (
    WalShippingStandby,
    _complete_frame_prefix,
)
from kubernetes_tpu_torch.testing.chaosmonkey import Chaosmonkey, Test

Gi = 1 << 30


def test_ship_replicates_incrementally(tmp_path):
    p, s = str(tmp_path / "p"), str(tmp_path / "s")
    api = ApiServerLite(data_dir=p)
    standby = WalShippingStandby(p, s)
    api.create("Node", make_node("n1"))
    standby.ship()
    assert standby.standby_rv() == 1
    api.create("Node", make_node("n2"))
    api.create("Pod", make_pod("a", cpu=10))
    standby.ship()
    assert standby.standby_rv() == 3
    assert standby.ship() == 0


def test_ship_survives_primary_compaction(tmp_path):
    p, s = str(tmp_path / "p"), str(tmp_path / "s")
    api = ApiServerLite(data_dir=p, compact_every=5)
    standby = WalShippingStandby(p, s)
    for i in range(23):
        api.create("Pod", make_pod(f"p{i}", cpu=10))
        if i % 3 == 0:
            standby.ship()
    standby.ship()
    assert standby.standby_rv() == 23
    assert len(standby.promote().list("Pod")[0]) == 23


def test_ship_is_frame_aligned(tmp_path):
    p, s = str(tmp_path / "p"), str(tmp_path / "s")
    api = ApiServerLite(data_dir=p)
    api.create("Node", make_node("n1"))
    standby = WalShippingStandby(p, s)
    standby.ship()
    wal = os.path.join(p, DurableStore.WAL)
    full = open(wal, "rb").read()
    with open(wal, "ab") as f:
        f.write(full[: max(5, len(full) // 4)])
    before = standby._wal_offset
    standby.ship()
    assert standby._wal_offset == before
    assert standby.standby_rv() == 1
    api2 = ApiServerLite(data_dir=p)
    api2.create("Node", make_node("n2"))
    standby.ship()
    assert standby.standby_rv() >= 2


def test_complete_frame_prefix():
    hdr = struct.Struct("<II")
    rec = b"payload-bytes"
    frame = hdr.pack(len(rec), zlib.crc32(rec)) + rec
    assert _complete_frame_prefix(frame) == len(frame)
    assert _complete_frame_prefix(frame + frame[:4]) == len(frame)
    assert _complete_frame_prefix(frame[:7]) == 0
    assert _complete_frame_prefix(b"") == 0


def test_store_failover_midstorm_1k_nodes(tmp_path):
    """tests/test_replication.py's storm with the port's scheduler on the
    CPU: the primary dies after 4,000 + 2,000 binds (the first 4,000
    shipped), the standby promotes, a fresh scheduler converges."""
    p, s = str(tmp_path / "p"), str(tmp_path / "s")
    api = ApiServerLite(data_dir=p, max_log=100_000)
    for i in range(1000):
        api.create("Node", make_node(f"node-{i:04d}", cpu=4000,
                                     memory=16 * Gi))
    for i in range(10_000):
        api.create("Pod", make_pod(f"pod-{i:05d}", cpu=100))
    standby = WalShippingStandby(p, s)
    standby.ship()
    sched = Scheduler(api, record_events=False, device="cpu")
    sched.start()
    sched.schedule_round(max_batch=4000)
    standby.ship()
    sched.schedule_round(max_batch=2000)
    sched.engine.close()
    bound_primary = sum(1 for pd in api.list("Pod")[0] if pd.node_name)
    assert bound_primary >= 6000

    state = {}

    def primary_dies_standby_promotes():
        state["api"] = standby.promote(max_log=100_000)

    cm = Chaosmonkey(primary_dies_standby_promotes)

    def converge():
        api2 = state["api"]
        pods = api2.list("Pod")[0]
        assert len(pods) == 10_000
        restored_bound = sum(1 for pd in pods if pd.node_name)
        assert 4000 <= restored_bound <= bound_primary
        sched2 = Scheduler(api2, record_events=False, device="cpu")
        sched2.start()
        totals = sched2.run_until_drained()
        sched2.engine.close()
        assert totals["bind_errors"] == 0

    cm.register(Test(test=converge, name="store-failover"))
    cm.do()
    unbound = [pd.name for pd in state["api"].list("Pod")[0]
               if not pd.node_name]
    assert not unbound, f"{len(unbound)} pods never bound"


def test_chaosmonkey_runs_setup_disruption_test_teardown_in_order():
    seen = []
    cm = Chaosmonkey(lambda: seen.append("disrupt"))
    cm.register(Test(setup=lambda: seen.append("setup-a"),
                     test=lambda: seen.append("test-a"),
                     teardown=lambda: seen.append("down-a"), name="a"))
    cm.register_interface(setup=lambda: seen.append("setup-b"),
                          test=lambda: seen.append("test-b"),
                          teardown=lambda: seen.append("down-b"), name="b")
    cm.do()
    assert seen == ["setup-a", "setup-b", "disrupt", "test-a", "test-b",
                    "down-b", "down-a"]


# ------------------------------------------------ the port == the reference


def _failover(root, tmp, n_nodes, n_pods):
    """The storm behind ApiServer over a durable primary: ship, a round
    of 40% of the pods, ship, a round of 20%, promote, a fresh scheduler
    behind ApiServer(store=promoted) drains. Returns the promoted store's
    placements and the checkpoints."""
    import importlib
    m = lambda n: importlib.import_module(f"{root}.{n}")
    types, workloads = m("api.types"), m("api.workloads")
    apiserver, lite = m("server.apiserver"), m("server.apiserver_lite")
    replication, chaos = m("server.replication"), m("testing.chaosmonkey")
    Sched = m("engine.scheduler").Scheduler
    kw = {"device": "cpu"} if root == "kubernetes_tpu_torch" else {}
    p, s = os.path.join(tmp, root, "p"), os.path.join(tmp, root, "s")
    api = apiserver.ApiServer(store=lite.ApiServerLite(data_dir=p))
    api.create("Namespace", workloads.Namespace(name="default"))
    for i in range(n_nodes):
        api.create("Node", types.make_node(f"node-{i:04d}", cpu=4000,
                                           memory=16 * Gi))
    for i in range(n_pods):
        api.create("Pod", types.make_pod(f"pod-{i:05d}",
                                         cpu=100 + 50 * (i % 3)))
    standby = replication.WalShippingStandby(p, s)
    standby.ship()
    sched = Sched(api, record_events=False, **kw)
    sched.start()
    sched.schedule_round(max_batch=n_pods * 2 // 5)
    shipped = sum(1 for pd in api.store.list("Pod")[0] if pd.node_name)
    standby.ship()
    sched.schedule_round(max_batch=n_pods // 5)
    if hasattr(sched.engine, "close"):
        sched.engine.close()
    bound_primary = sum(1 for pd in api.store.list("Pod")[0] if pd.node_name)
    standby_rv = standby.standby_rv()
    state = {}

    def promote():
        state["store"] = standby.promote()

    def converge():
        store = state["store"]
        state["restored"] = sorted(
            (pd.name, pd.node_name) for pd in store.list("Pod")[0]
            if pd.node_name)
        sched2 = Sched(apiserver.ApiServer(store=store),
                       record_events=False, **kw)
        sched2.start()
        state["totals"] = sched2.run_until_drained()
        if hasattr(sched2.engine, "close"):
            sched2.engine.close()

    cm = chaos.Chaosmonkey(promote)
    cm.register(chaos.Test(test=converge, name="store-failover"))
    cm.do()
    placements = sorted((pd.name, pd.node_name)
                        for pd in state["store"].list("Pod")[0])
    binds = {}
    for e in state["store"]._log:
        if e.kind == "Pod" and e.type == "MODIFIED" and e.obj.node_name:
            binds.setdefault(e.obj.name, set()).add(e.obj.node_name)
    return {"placements": placements, "restored": state["restored"],
            "totals": state["totals"], "shipped": shipped,
            "bound_primary": bound_primary, "binds": binds,
            "standby_rv": standby_rv}


def test_failover_behind_the_apiserver_matches_reference(tmp_path):
    ref = _failover("kubernetes_tpu", str(tmp_path), 200, 2000)
    port = _failover("kubernetes_tpu_torch", str(tmp_path), 200, 2000)
    # the shipped byte counts differ by construction: the WAL pickles
    # each object with its package's module path
    for key in ("placements", "restored", "shipped", "bound_primary",
                "standby_rv"):
        assert port[key] == ref[key], key
    assert port["totals"]["bind_errors"] == 0
    assert {k: v for k, v in port["totals"].items() if k in ref["totals"]} \
        == ref["totals"]
    assert all(node for _, node in port["placements"])
    assert len(port["placements"]) == 2000
    assert port["shipped"] <= len(port["restored"]) <= port["bound_primary"]
    restored = dict(port["restored"])
    assert all(len(v) == 1 and restored.get(k, next(iter(v))) in v
               for k, v in port["binds"].items())
