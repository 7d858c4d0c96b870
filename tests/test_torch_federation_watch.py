"""The port's watch-driven federation control plane
(federation/{controller,sync_loop,planner,service_dns}.py over
client/{informer,workqueue}.py) on the CPU: the reference's
tests/test_federation_watch.py contracts run on the port — cluster-loss
rebalance from a WATCH EVENT with no manual sync_all(), member-drift
self-heal from the member's own watch stream, auto-watch on join,
deletion propagation, the managed-ownership guard, the background
worker, propagated kinds — and each deterministic planner output and
member layout equals the reference's. Exact everywhere."""

import json
import random

import pytest

import kubernetes_tpu.api.workloads as jw
import kubernetes_tpu.federation.controller as jctl
import kubernetes_tpu.federation.planner as jplan
import kubernetes_tpu.federation.sync_loop as jsync
import kubernetes_tpu.server.apiserver_lite as japi
import kubernetes_tpu_torch.api.workloads as tw
import kubernetes_tpu_torch.federation.controller as tctl
import kubernetes_tpu_torch.federation.planner as tplan
import kubernetes_tpu_torch.federation.sync_loop as tsync
import kubernetes_tpu_torch.server.apiserver_lite as tapi
from kubernetes_tpu_torch.api.cluster import ConfigMap
from kubernetes_tpu_torch.api.workloads import ReplicaSet
from kubernetes_tpu_torch.federation.controller import (
    FEDERATED_RS_KIND,
    FederatedReplicaSet,
    FederationControlPlane,
    MANAGED_ANNOTATION,
)
from kubernetes_tpu_torch.federation.sync_loop import FederationSyncLoop
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, NotFound


def mk_plane(*names):
    plane = FederationControlPlane()
    members = {}
    for n in names:
        api = ApiServerLite()
        members[n] = api
        plane.join(n, api)
    return plane, members


def mk_frs(replicas=10, name="web"):
    return FederatedReplicaSet(
        name=name, replicas=replicas,
        template=ReplicaSet(name=name))


def test_create_event_drives_children():
    plane, members = mk_plane("alpha", "beta")
    loop = FederationSyncLoop(plane)
    loop.pump()  # cluster ADDs start the member watches
    plane.api.create(FEDERATED_RS_KIND, mk_frs(10))
    loop.pump(rounds=2)
    a = members["alpha"].get("ReplicaSet", "default", "web")
    b = members["beta"].get("ReplicaSet", "default", "web")
    assert a.replicas + b.replicas == 10
    assert loop.syncs > 0


def test_cluster_loss_rebalances_from_watch_event():
    """The core criterion: no sync_all anywhere — readiness flips on the
    federation apiserver, the Cluster informer fires, the queue drains,
    replicas move."""
    plane, members = mk_plane("alpha", "beta")
    loop = FederationSyncLoop(plane)
    loop.pump()
    plane.api.create(FEDERATED_RS_KIND, mk_frs(10))
    loop.pump(rounds=2)
    before = members["alpha"].get("ReplicaSet", "default", "web").replicas
    assert 0 < before < 10
    # beta dies: ONLY the API write happens; the loop must react on its own
    plane.mark_ready("beta", False)
    loop.pump(rounds=2)
    assert members["alpha"].get(
        "ReplicaSet", "default", "web").replicas == 10
    try:
        beta_rs = members["beta"].get("ReplicaSet", "default", "web")
        assert beta_rs is None or beta_rs.replicas == 0
    except NotFound:
        pass  # removed from the lost cluster's plan entirely


def test_member_drift_self_heals_from_member_watch():
    """Someone hand-deletes the child in a member cluster: the MEMBER's
    watch stream enqueues the federated parent; no federation-side event
    needed."""
    plane, members = mk_plane("alpha", "beta")
    loop = FederationSyncLoop(plane)
    loop.pump()
    plane.api.create(FEDERATED_RS_KIND, mk_frs(10))
    loop.pump(rounds=2)
    members["alpha"].delete("ReplicaSet", "default", "web")
    loop.pump(rounds=2)
    assert members["alpha"].get("ReplicaSet", "default", "web") is not None


def test_late_join_auto_watched_and_rebalanced():
    import json

    from kubernetes_tpu_torch.federation.planner import PREFERENCES_ANNOTATION
    plane, members = mk_plane("alpha")
    loop = FederationSyncLoop(plane)
    loop.pump()
    frs = mk_frs(10)
    # rebalance=true: without it the planner is deliberately sticky and a
    # late joiner gets nothing (reference planner semantics)
    frs.annotations[PREFERENCES_ANNOTATION] = json.dumps(
        {"rebalance": True, "clusters": {"*": {"weight": 1}}})
    plane.api.create(FEDERATED_RS_KIND, frs)
    loop.pump(rounds=2)
    assert members["alpha"].get(
        "ReplicaSet", "default", "web").replicas == 10
    # a new cluster joins: the Cluster ADD event triggers the rebalance
    gamma = ApiServerLite()
    plane.join("gamma", gamma)
    loop.pump(rounds=2)
    a = members["alpha"].get("ReplicaSet", "default", "web").replicas
    g = gamma.get("ReplicaSet", "default", "web").replicas
    assert a + g == 10 and g > 0
    # and gamma's own drift now self-heals (its watch is live)
    gamma.delete("ReplicaSet", "default", "web")
    loop.pump(rounds=2)
    assert gamma.get("ReplicaSet", "default", "web") is not None


def test_deletion_propagates_absence():
    plane, members = mk_plane("alpha", "beta")
    loop = FederationSyncLoop(plane)
    loop.pump()
    plane.api.create(FEDERATED_RS_KIND, mk_frs(6))
    loop.pump(rounds=2)
    plane.api.delete(FEDERATED_RS_KIND, "default", "web")
    loop.pump(rounds=2)
    for api in members.values():
        try:
            assert api.get("ReplicaSet", "default", "web") is None
        except NotFound:
            pass


def test_loop_never_deletes_unmanaged_member_objects():
    """A user's plain ReplicaSet created directly in a member cluster has
    no federated parent: its watch event enqueues a federated key that
    resolves NotFound — and the loop must LEAVE IT ALONE (the managed
    ownership guard), not delete it from every cluster."""
    plane, members = mk_plane("alpha", "beta")
    loop = FederationSyncLoop(plane)
    loop.pump()
    members["alpha"].create("ReplicaSet",
                            ReplicaSet(name="local-web", replicas=3))
    loop.pump(rounds=3)
    survivor = members["alpha"].get("ReplicaSet", "default", "local-web")
    assert survivor is not None and survivor.replicas == 3
    # while MANAGED children of a real deleted federated object DO go
    plane.api.create(FEDERATED_RS_KIND, mk_frs(4, name="owned"))
    loop.pump(rounds=2)
    assert members["alpha"].get("ReplicaSet", "default", "owned") \
        .annotations[MANAGED_ANNOTATION] == "true"
    plane.api.delete(FEDERATED_RS_KIND, "default", "owned")
    loop.pump(rounds=2)
    try:
        gone = members["alpha"].get("ReplicaSet", "default", "owned")
        assert gone is None
    except NotFound:
        pass


def _wait_until(fn, timeout=10.0, interval=0.02):
    import time
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if fn():
                return True
        except NotFound:
            pass
        time.sleep(interval)
    return False


def test_background_worker_rebalances_without_pump():
    """The sync loop runs on its OWN worker
    thread — create a federated RS, kill a cluster, and replicas move with
    NO test-side pump(rounds) anywhere. pump() stays available as the
    deterministic hook (every other test here), but a live deployment only
    calls start()."""
    plane, members = mk_plane("alpha", "beta")
    loop = FederationSyncLoop(plane)
    loop.start(interval_s=0.01)
    try:
        plane.api.create(FEDERATED_RS_KIND, mk_frs(10))
        assert _wait_until(
            lambda: members["alpha"].get("ReplicaSet", "default",
                                         "web").replicas
            + members["beta"].get("ReplicaSet", "default", "web").replicas
            == 10), "worker never reconciled the federated RS"
        # beta dies: only the API write happens; the worker must react
        plane.mark_ready("beta", False)
        assert _wait_until(
            lambda: members["alpha"].get("ReplicaSet", "default",
                                         "web").replicas == 10), \
            "worker never rebalanced after cluster loss"
    finally:
        loop.stop()
    assert loop.syncs > 0


def test_propagated_kinds_flow_through_the_loop():
    plane, members = mk_plane("alpha", "beta")
    loop = FederationSyncLoop(plane)
    loop.pump()
    plane.api.create("FederatedConfigMap",
                     ConfigMap(name="settings", data={"k": "v"}))
    loop.pump(rounds=2)
    for api in members.values():
        cm = api.get("ConfigMap", "default", "settings")
        assert cm.data == {"k": "v"}
        assert cm.annotations[MANAGED_ANNOTATION] == "true"
    plane.api.delete("FederatedConfigMap", "default", "settings")
    loop.pump(rounds=2)
    for api in members.values():
        try:
            assert api.get("ConfigMap", "default", "settings") is None
        except NotFound:
            pass


def test_federated_namespace_propagates():
    from kubernetes_tpu_torch.api.workloads import Namespace
    plane, members = mk_plane("alpha", "beta")
    loop = FederationSyncLoop(plane)
    loop.pump()
    plane.api.create("FederatedNamespace",
                     Namespace(name="team-a", labels={"team": "a"}))
    loop.pump(rounds=2)
    for api in members.values():
        ns = api.get("Namespace", "", "team-a")
        assert ns.labels == {"team": "a"}
        assert ns.annotations[MANAGED_ANNOTATION] == "true"
    plane.api.delete("FederatedNamespace", "", "team-a")
    loop.pump(rounds=2)
    for api in members.values():
        try:
            assert api.get("Namespace", "", "team-a") is None
        except NotFound:
            pass


# ------------------------------------------------ held against the reference


def _random_prefs(rng, names):
    clusters = {}
    for n in rng.sample(names + ["*"], rng.randint(1, len(names) + 1)):
        p = {"weight": rng.randint(0, 4)}
        if rng.random() < 0.4:
            p["minReplicas"] = rng.randint(0, 5)
        if rng.random() < 0.4:
            p["maxReplicas"] = rng.randint(0, 12)
        clusters[n] = p
    return json.dumps({"rebalance": rng.random() < 0.5,
                       "clusters": clusters})


@pytest.mark.parametrize("seed", range(24))
def test_planner_equals_the_reference(seed):
    rng = random.Random(seed)
    names = [f"c{i}" for i in range(rng.randint(1, 6))]
    text = _random_prefs(rng, names)
    replicas = rng.randint(0, 40)
    current = {n: rng.randint(0, 10) for n in names if rng.random() < 0.5}
    capacity = {n: rng.randint(0, 12) for n in names if rng.random() < 0.3}
    key = f"ns-{seed}/web"
    got = tplan.Planner(tplan.ReplicaAllocationPreferences.parse(text)).plan(
        replicas, names, current=current, capacity=capacity, key=key)
    want = jplan.Planner(jplan.ReplicaAllocationPreferences.parse(text)).plan(
        replicas, names, current=current, capacity=capacity, key=key)
    assert got == want


def _layout_run(api_mod, ctl, sync, workloads):
    """create -> cluster loss -> late join -> drift, pumped: the member
    replica counts after each step."""
    plane = ctl.FederationControlPlane()
    members = {}
    for n in ("alpha", "beta"):
        members[n] = api_mod.ApiServerLite()
        plane.join(n, members[n])
    loop = sync.FederationSyncLoop(plane)
    loop.pump()
    frs = ctl.FederatedReplicaSet(name="web", replicas=11,
                                  template=workloads.ReplicaSet(name="web"))
    frs.annotations[jplan.PREFERENCES_ANNOTATION] = json.dumps(
        {"rebalance": True, "clusters": {"*": {"weight": 1},
                                         "beta": {"weight": 2}}})
    plane.api.create(ctl.FEDERATED_RS_KIND, frs)
    out = []

    def snap():
        row = {}
        for n, api in members.items():
            try:
                rs = api.get("ReplicaSet", "default", "web")
                row[n] = None if rs is None else rs.replicas
            except api_mod.NotFound:
                row[n] = "absent"
        out.append(row)

    loop.pump(rounds=2)
    snap()
    plane.mark_ready("beta", False)
    loop.pump(rounds=2)
    snap()
    members["gamma"] = api_mod.ApiServerLite()
    plane.join("gamma", members["gamma"])
    loop.pump(rounds=2)
    snap()
    plane.mark_ready("beta", True)
    loop.pump(rounds=2)
    snap()
    return out


def test_member_layouts_equal_the_reference():
    got = _layout_run(tapi, tctl, tsync, tw)
    want = _layout_run(japi, jctl, jsync, jw)
    assert got == want
    assert got[0]["alpha"] + got[0]["beta"] == 11
