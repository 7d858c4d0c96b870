"""The port's node agents (nodes/, utils/probe.py) against the
reference's. The bodies of tests/test_nodes.py, tests/test_kubelet_depth.py,
tests/test_probe.py and the two cases of tests/test_kubelet_server.py that
need no ktctl run on both packages (the `k` fixture, one FakeClock per
case, every Scheduler and SchedulerDaemon of the port on the CPU): the
hollow kubelet's pod lifecycle, admission, heartbeats, probes, pressure
eviction, pod workers and static pods, kube-proxy's round-robin, the
node lifecycle controller's grace, zone states and rate-limited
eviction, the kubelet's HTTP API and the HTTP, TCP and exec probers.

Last, one scripted world in both packages, held exact: 64 hollow
kubelets on a FakeClock behind the scheduler, bound pods, a StatefulSet
of 6 rolled out ordinal by ordinal, a ReplicaSet with 8 of its nodes'
kubelets killed (the node lifecycle controller evicts, the ReplicaSet
replaces, the scheduler places on live nodes) and one node under memory
pressure. The two stores must hold equal objects in wire JSON, and every
kubelet's CRI op counts and restart counters must be equal."""

from __future__ import annotations

import dataclasses
import json
import socket
import urllib.error
import urllib.request

import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "api_types": "api.types",
    "api_workloads": "api.workloads",
    "client_informer": "client.informer",
    "controllers_endpoint": "controllers.endpoint",
    "controllers_nodelifecycle": "controllers.nodelifecycle",
    "controllers_replicaset": "controllers.replicaset",
    "controllers_statefulset": "controllers.statefulset",
    "engine_scheduler": "engine.scheduler",
    "features": "utils.features",
    "hollow": "models.hollow",
    "nodes": "nodes",
    "nodes_kubelet": "nodes.kubelet",
    "nodes_kubelet_server": "nodes.kubelet_server",
    "nodes_proxy": "nodes.proxy",
    "server_apiserver": "server.apiserver",
    "server_apiserver_lite": "server.apiserver_lite",
    "server_daemon": "server.daemon",
    "server_rest_http": "server.rest_http",
    "utils_probe": "utils.probe",
    "wire": "api.wire",
}

PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}
DEVICE = {REF: {}, PORT: {"device": "cpu"}}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def mk_fleet(k, n_nodes=2, clock=None, **kw):
    clock = clock or FakeClock()
    api = k.ApiServerLite()
    factory = k.SharedInformerFactory(api)
    fleet = k.HollowFleet(api, factory, now=clock, **kw)
    for i in range(n_nodes):
        fleet.add_node(k.make_node(f"n{i}", cpu=1000, memory=1 << 30, pods=4))
    factory.step_all()
    return api, factory, fleet, clock


# ------------------------------------------------------------------ kubelet


def test_kubelet_runs_bound_pod(k):
    api, factory, fleet, clock = mk_fleet(k)
    api.create("Pod", k.make_pod("p", cpu=100, node_name="n0"))
    factory.step_all()
    fleet.step()
    assert api.get("Pod", "default", "p").phase == "Running"


def test_kubelet_startup_latency_and_completion(k):
    api, factory, fleet, clock = mk_fleet(k, startup_latency=3.0)
    pod = k.make_pod("job-pod", cpu=100, node_name="n0")
    pod.annotations["bench/run-seconds"] = "10"
    api.create("Pod", pod)
    factory.step_all()
    fleet.step()
    assert api.get("Pod", "default", "job-pod").phase == "Pending"  # starting
    clock.t += 3.0
    fleet.step()
    assert api.get("Pod", "default", "job-pod").phase == "Running"
    clock.t += 10.0
    fleet.step()
    assert api.get("Pod", "default", "job-pod").phase == "Succeeded"


def test_kubelet_admission_rejects_over_capacity(k):
    api, factory, fleet, clock = mk_fleet(k)  # nodes: 1000m cpu
    api.create("Pod", k.make_pod("big1", cpu=800, node_name="n0"))
    factory.step_all()
    fleet.step()
    # second pod over cpu capacity on the same node
    api.create("Pod", k.make_pod("big2", cpu=800, node_name="n0"))
    factory.step_all()
    fleet.step()
    p2 = api.get("Pod", "default", "big2")
    assert p2.phase == "Failed"
    assert p2.annotations["kubernetes.io/failure-reason"] == "OutOfcpu"
    # but it fits on the other node
    api.create("Pod", k.make_pod("big3", cpu=800, node_name="n1"))
    factory.step_all()
    fleet.step()
    assert api.get("Pod", "default", "big3").phase == "Running"


def test_kubelet_heartbeat_updates_node(k):
    api, factory, fleet, clock = mk_fleet(k)
    clock.t += 100.0
    fleet.heartbeat_all()
    node = api.get("Node", "", "n0")
    assert node.heartbeat == clock.t
    assert node.condition("Ready") == k.ConditionStatus.TRUE


def test_kubelet_forgets_deleted_pod_freeing_capacity(k):
    api, factory, fleet, clock = mk_fleet(k)
    api.create("Pod", k.make_pod("a", cpu=800, node_name="n0"))
    factory.step_all()
    fleet.step()
    api.delete("Pod", "default", "a")
    factory.step_all()
    api.create("Pod", k.make_pod("b", cpu=800, node_name="n0"))
    factory.step_all()
    fleet.step()
    assert api.get("Pod", "default", "b").phase == "Running"


# -------------------------------------------------------------------- proxy


def test_proxy_routes_round_robin_and_resyncs(k):
    api = k.ApiServerLite()
    factory = k.SharedInformerFactory(api)
    epc = k.EndpointController(api, factory, record_events=False)
    proxy = k.HollowProxy(factory)
    api.create("Service", k.Service(name="web", selector={"app": "web"},
                                    ports=[k.ServicePort(port=80, target_port=8080)]))
    for i in range(3):
        api.create("Pod", dataclasses.replace(
            k.make_pod(f"w{i}", labels={"app": "web"}, node_name=f"n{i}"),
            phase="Running"))
    factory.step_all()
    epc.pump()
    factory.step_all()
    backends = proxy.backends("default/web", 80)
    assert len(backends) == 3
    assert all(port == 8080 for _, port, _ in backends)
    picked = {proxy.route("default/web", 80)[2] for _ in range(3)}
    assert picked == {"n0", "n1", "n2"}  # round robin covers all
    # endpoint removal propagates
    api.delete("Pod", "default", "w0")
    factory.step_all()
    epc.pump()
    factory.step_all()
    assert len(proxy.backends("default/web", 80)) == 2
    assert proxy.route("default/unknown", 80) is None


# ----------------------------------------------------------- node lifecycle


def mk_lifecycle(k, n_nodes=4, zones=1, clock=None, **kw):
    clock = clock or FakeClock()
    api = k.ApiServerLite()
    factory = k.SharedInformerFactory(api)
    for i in range(n_nodes):
        node = k.make_node(f"n{i}", labels={k.ZONE_LABEL: f"z{i % zones}"})
        node.heartbeat = clock.t
        api.create("Node", node)
    nlc = k.NodeLifecycleController(
        api, factory, grace_period=40.0, eviction_timeout=300.0,
        record_events=False, now=clock, **kw)
    factory.step_all()
    return api, factory, nlc, clock


def test_dead_node_marked_unknown_then_pods_evicted(k):
    api, factory, nlc, clock = mk_lifecycle(k)
    api.create("Pod", k.make_pod("victim", node_name="n0"))
    api.create("Pod", k.make_pod("safe", node_name="n1"))
    factory.step_all()
    # n0's kubelet dies; others keep heartbeating
    for tick in range(8):
        clock.t += 60.0
        for i in (1, 2, 3):
            n = api.get("Node", "", f"n{i}")
            api.update("Node", dataclasses.replace(n, heartbeat=clock.t))
        factory.step_all()
        nlc.monitor_tick()
        factory.step_all()
    assert api.get("Node", "", "n0").condition("Ready") == k.ConditionStatus.UNKNOWN
    names = {p.name for p in api.list("Pod")[0]}
    assert "victim" not in names and "safe" in names


def test_static_node_gets_grace_from_first_observation(k):
    """A Node that never heartbeat (heartbeat=0.0: decoded/static objects)
    must get the grace period from first observation, not be drained on the
    first tick."""
    clock = FakeClock(t=50_000.0)  # monotonic clock far from 0
    api = k.ApiServerLite()
    factory = k.SharedInformerFactory(api)
    api.create("Node", k.make_node("static"))  # heartbeat defaults to 0.0
    api.create("Node", k.make_node("live"))
    api.create("Pod", k.make_pod("p", node_name="static"))
    nlc = k.NodeLifecycleController(api, factory, grace_period=40.0,
                                    eviction_timeout=60.0, record_events=False,
                                    now=clock)
    factory.step_all()

    def tick(dt):
        clock.t += dt
        n = api.get("Node", "", "live")
        api.update("Node", dataclasses.replace(n, heartbeat=clock.t))
        factory.step_all()
        nlc.monitor_tick()
        factory.step_all()

    tick(0.0)
    assert api.get("Node", "", "static").condition("Ready") == k.ConditionStatus.TRUE
    assert len(api.list("Pod")[0]) == 1  # not drained on first observation
    # but with nobody ever heartbeating it, it IS eventually drained
    for _ in range(8):
        tick(30.0)
    assert api.get("Node", "", "static").condition("Ready") == k.ConditionStatus.UNKNOWN
    assert api.list("Pod")[0] == []


def test_full_zone_disruption_stops_evictions(k):
    api, factory, nlc, clock = mk_lifecycle(k, n_nodes=4, zones=2)
    api.create("Pod", k.make_pod("p0", node_name="n0"))
    factory.step_all()
    # zone z0 = {n0, n2}: kill both kubelets; z1 stays healthy
    for tick in range(8):
        clock.t += 60.0
        for i in (1, 3):
            n = api.get("Node", "", f"n{i}")
            api.update("Node", dataclasses.replace(n, heartbeat=clock.t))
        factory.step_all()
        nlc.monitor_tick()
        factory.step_all()
    assert nlc.zone_states["z0"] == "FullDisruption"
    # pods NOT evicted despite timeout: master assumes its own partition
    assert any(p.name == "p0" for p in api.list("Pod")[0])


def test_taint_based_eviction_spares_tolerating_pods(k):
    k.features.DEFAULT_FEATURE_GATE.set("TaintBasedEvictions", True)
    try:
        api, factory, nlc, clock = mk_lifecycle(k)
        tol = k.Toleration(key=k.TAINT_UNREACHABLE,
                           operator=k.TolerationOperator.EXISTS,
                           effect=k.TaintEffect.NO_EXECUTE)
        api.create("Pod", k.make_pod("tolerant", node_name="n0",
                                     tolerations=[tol]))
        api.create("Pod", k.make_pod("intolerant", node_name="n0"))
        factory.step_all()
        for tick in range(10):
            clock.t += 60.0
            for i in (1, 2, 3):
                n = api.get("Node", "", f"n{i}")
                api.update("Node", dataclasses.replace(n, heartbeat=clock.t))
            factory.step_all()
            nlc.monitor_tick()
            factory.step_all()
        node = api.get("Node", "", "n0")
        assert any(t.key == k.TAINT_UNREACHABLE for t in node.taints)
        names = {p.name for p in api.list("Pod")[0]}
        assert names == {"tolerant"}
        # node recovers: taint removed
        api.update("Node", dataclasses.replace(node, heartbeat=clock.t))
        factory.step_all()
        nlc.monitor_tick()
        factory.step_all()
        assert api.get("Node", "", "n0").taints == []
    finally:
        k.features.DEFAULT_FEATURE_GATE.reset()


def test_eviction_rate_limited_across_nodes_in_zone(k):
    api, factory, nlc, clock = mk_lifecycle(k, n_nodes=10)
    for i in range(5):  # 5 dead nodes with a pod each
        api.create("Pod", k.make_pod(f"p{i}", node_name=f"n{i}"))
    factory.step_all()

    def tick(dt):
        clock.t += dt
        for i in range(5, 10):  # n5..n9 keep heartbeating
            n = api.get("Node", "", f"n{i}")
            api.update("Node", dataclasses.replace(n, heartbeat=clock.t))
        factory.step_all()
        nlc.monitor_tick()
        factory.step_all()
        return len(api.list("Pod")[0])

    counts = [tick(60.0) for _ in range(12)]
    # evictions begin once unhealthy-duration crosses 300s, then proceed at
    # most one node-drain per tick (rate 0.1/s, burst 1, 60s ticks)
    assert counts[0] == 5  # within timeout: nothing evicted
    assert counts[-1] == 0  # eventually all drained
    drops = [a - b for a, b in zip(counts, counts[1:])]
    assert max(drops) == 1, f"rate limit breached: {counts}"




# ------------------------------------------------------------ kubelet depth


Mi = 1 << 20
Gi = 1 << 30


def _probe_pod(k, name, node, *, ready_after=None, liveness_fail_at=None,
               restart_policy="Always", cpu=100, labels=None):
    pod = k.make_pod(name, cpu=cpu, node_name=node, labels=labels or {})
    c = pod.containers[0]
    if ready_after is not None:
        c.readiness_probe = k.Probe(kind="httpGet", period_s=1.0,
                                    failure_threshold=1)
        pod.annotations[k.READY_AFTER_ANNOTATION] = str(ready_after)
    if liveness_fail_at is not None:
        c.liveness_probe = k.Probe(kind="httpGet", period_s=1.0,
                                   failure_threshold=3)
        pod.annotations[k.LIVENESS_FAIL_AT_ANNOTATION] = str(liveness_fail_at)
    pod.restart_policy = restart_policy
    return pod


# ------------------------------------------------------------------- probes


def test_readiness_probe_gates_ready_then_flips(k):
    api, factory, fleet, clock = mk_fleet(k)
    api.create("Pod", _probe_pod(k, "web", "n0", ready_after=5.0))
    factory.step_all()
    fleet.step()
    p = api.get("Pod", "default", "web")
    assert p.phase == "Running" and p.ready is False  # probe not passed yet
    clock.t += 6.0
    fleet.step()
    assert api.get("Pod", "default", "web").ready is True


def test_liveness_failure_restarts_container(k):
    api, factory, fleet, clock = mk_fleet(k)
    api.create("Pod", _probe_pod(k, "flaky", "n0", liveness_fail_at=10.0))
    factory.step_all()
    fleet.step()
    assert api.get("Pod", "default", "flaky").restart_count == 0
    clock.t += 11.0
    # failure_threshold=3 consecutive failed probes (one per period_s=1.0;
    # extra steps within a period do NOT re-probe) before restart
    fleet.step(); fleet.step()
    assert api.get("Pod", "default", "flaky").restart_count == 0
    clock.t += 1.0
    fleet.step()
    assert api.get("Pod", "default", "flaky").restart_count == 0
    clock.t += 1.0
    fleet.step()
    p = api.get("Pod", "default", "flaky")
    assert p.restart_count == 1
    assert p.ready is False  # unready during restart
    assert p.phase == "Running"  # restartPolicy Always: still running
    fleet.step()  # container back up (startup_latency 0)
    # it will fail again at +10s relative to the restart; before that it's
    # running with the restart recorded
    assert api.get("Pod", "default", "flaky").restart_count >= 1


def test_liveness_failure_with_restart_policy_never_fails_pod(k):
    api, factory, fleet, clock = mk_fleet(k)
    api.create("Pod", _probe_pod(k, "oneshot", "n0", liveness_fail_at=1.0,
                                 restart_policy="Never"))
    factory.step_all()
    fleet.step()
    clock.t += 2.0
    for _ in range(3):  # three probe periods of failures
        fleet.step()
        clock.t += 1.0
    fleet.step()
    p = api.get("Pod", "default", "oneshot")
    assert p.phase == "Failed"
    assert p.annotations["kubernetes.io/failure-reason"] == "Unhealthy"


def test_readiness_gates_endpoints_membership(k):
    """The full loop: probe -> pod Ready condition -> endpoints controller
    includes/excludes the address (endpoints_controller.go)."""
    api, factory, fleet, clock = mk_fleet(k)
    api.create("Service", k.Service("svc", "default",
                                    selector={"app": "web"},
                                    ports=[k.ServicePort(port=80)]))
    api.create("Pod", _probe_pod(k, "w0", "n0", ready_after=5.0,
                                 labels={"app": "web"}))
    api.create("Pod", k.make_pod("w1", cpu=100, node_name="n1",
                                 labels={"app": "web"}))  # no probe: ready
    epc = k.EndpointController(api, factory, record_events=False)
    factory.step_all()
    fleet.step()
    factory.step_all()
    epc.pump()
    eps = api.get("Endpoints", "default", "svc")
    assert [a.pod_key for a in eps.addresses] == ["default/w1"]
    clock.t += 6.0
    fleet.step()  # probe passes -> w0 ready
    factory.step_all()
    epc.pump()
    eps = api.get("Endpoints", "default", "svc")
    assert [a.pod_key for a in eps.addresses] == ["default/w0", "default/w1"]


# ----------------------------------------------------------------- eviction


def test_memory_pressure_sets_condition_and_evicts_besteffort_first(k):
    api, factory, fleet, clock = mk_fleet(k, n_nodes=1)  # 1Gi allocatable
    # guaranteed-ish pod: requests==limits, modest usage
    g = k.make_pod("guaranteed", cpu=100, memory=256 * Mi, node_name="n0")
    g.containers[0].limits = dict(g.containers[0].requests)
    g.annotations[k.ACTUAL_MEM_ANNOTATION] = str(256 * Mi)
    # best-effort pod ballooning way past any request
    be = k.make_pod("balloon", node_name="n0")
    be.annotations[k.ACTUAL_MEM_ANNOTATION] = str(800 * Mi)
    api.create("Pod", g)
    api.create("Pod", be)
    factory.step_all()
    # one step: pods start AND the eviction pass sees usage 1056Mi > 95%
    # of the 1Gi allocatable
    fleet.step()
    balloon = api.get("Pod", "default", "balloon")
    assert balloon.phase == "Failed"
    assert balloon.annotations["kubernetes.io/failure-reason"] == "Evicted"
    assert api.get("Pod", "default", "guaranteed").phase == "Running"
    # pressure condition reaches the Node on the next heartbeat
    fleet.heartbeat_all()
    node = api.get("Node", "", "n0")
    assert node.condition("MemoryPressure") == k.ConditionStatus.TRUE
    # and clears once usage is back under the threshold
    fleet.step()
    fleet.heartbeat_all()
    assert api.get("Node", "", "n0").condition("MemoryPressure") \
        == k.ConditionStatus.FALSE


def test_scheduler_refuses_besteffort_on_memory_pressure_node(k):
    """Pressure condition -> CheckNodeMemoryPressure scheduler-side."""

    api, factory, fleet, clock = mk_fleet(k, n_nodes=2)
    be = k.make_pod("hog", node_name="n0")
    be.annotations[k.ACTUAL_MEM_ANNOTATION] = str(2 * Gi)
    api.create("Pod", be)
    factory.step_all()
    fleet.step()
    fleet.step()
    fleet.heartbeat_all()
    sched = k.Scheduler(api, record_events=False, **DEVICE[k.root])
    sched.start()
    api.create("Pod", k.make_pod("new-be"))  # best-effort pending pod
    sched.run_until_drained()
    placed = api.get("Pod", "default", "new-be")
    assert placed.node_name == "n1", \
        "best-effort pod must avoid the MemoryPressure node"


# -------------------------------------------------------------- pod workers


def test_pod_workers_coalesce_updates(k):
    seen = []
    w = k.PodWorkers(lambda pod, op: seen.append((pod.name, op)))
    p = k.make_pod("x", node_name="n0")
    for _ in range(5):
        w.update_pod(p, "sync")
    w.update_pod(p, "remove")
    w.drain()
    assert seen == [("x", "remove")]  # latest wins, one sync
    assert w.coalesced == 5


def test_pod_workers_serialize_per_pod(k):
    order = []
    w = k.PodWorkers(lambda pod, op: order.append(pod.name))
    a, b = k.make_pod("a", node_name="n0"), k.make_pod("b", node_name="n0")
    w.update_pod(a, "sync")
    w.update_pod(b, "sync")
    assert w.drain() == 2
    assert sorted(order) == ["a", "b"]


# -------------------------------------------------------------- static pods


def test_static_pod_creates_mirror_and_survives_mirror_delete(k, tmp_path):
    api, factory, fleet, clock = mk_fleet(k)
    kl = fleet.kubelets["n0"]
    manifest = {
        "metadata": {"name": "static-web", "namespace": "default"},
        "spec": {"containers": [{"name": "c0", "resources":
                                 {"requests": {"cpu": "100m"}}}]},
    }
    (tmp_path / "pod.json").write_text(json.dumps(manifest))
    assert kl.load_static_dir(str(tmp_path)) == 1
    fleet.step()
    mirror = api.get("Pod", "default", "static-web")
    assert mirror.node_name == "n0"
    assert mirror.annotations.get(k.MIRROR_ANNOTATION) == "true"
    assert api.get("Pod", "default", "static-web").phase in ("Pending",
                                                             "Running")
    # deleting the mirror does not stop the static pod: it comes back
    api.delete("Pod", "default", "static-web")
    fleet.step()
    assert api.get("Pod", "default", "static-web").node_name == "n0"


# ------------------------------------------------------------------- scale


def test_fleet_probes_and_eviction_at_scale(k):
    """5k-node hollow fleet with probes + eviction active end-to-end:
    nodelifecycle-grade heartbeats carry pressure conditions, endpoints
    track readiness, one overloaded node evicts: the hollow fleet runs
    probes and eviction at 5k-node scale."""

    clock = FakeClock()
    api = k.ApiServerLite(max_log=800_000)
    factory = k.SharedInformerFactory(api)
    fleet = k.HollowFleet(api, factory, now=clock)
    n_nodes = 5000
    for i in range(n_nodes):
        fleet.add_node(k.make_node(f"node-{i:04d}", cpu=4000, memory=1 * Gi,
                                   pods=110), register=True)
    api.create("Service", k.Service("svc", "default",
                                    selector={"app": "web"},
                                    ports=[k.ServicePort(port=80)]))
    # 200 probed service pods across the fleet + one ballooning best-effort
    for i in range(200):
        api.create("Pod", _probe_pod(k, f"w{i:03d}", f"node-{i:04d}",
                                     ready_after=5.0, labels={"app": "web"}))
    hog = k.make_pod("hog", node_name="node-0000")
    hog.annotations[k.ACTUAL_MEM_ANNOTATION] = str(2 * Gi)
    api.create("Pod", hog)
    epc = k.EndpointController(api, factory, record_events=False)
    nlc = k.NodeLifecycleController(api, factory, now=clock,
                                    record_events=False)
    factory.step_all()
    fleet.step()   # starts all pods; probes not yet passed
    fleet.step()   # eviction pass
    factory.step_all()
    epc.pump()
    nlc.pump()
    assert api.get("Pod", "default", "hog").phase == "Failed"
    eps = api.get("Endpoints", "default", "svc")
    assert eps.addresses == []  # nothing ready yet
    clock.t += 6.0
    fleet.step()
    factory.step_all()
    epc.pump()
    eps = api.get("Endpoints", "default", "svc")
    assert len(eps.addresses) == 200  # all probes passed
    fleet.heartbeat_all()
    factory.step_all()
    nlc.pump()
    # every node heartbeated: none evicted/tainted by nodelifecycle, and
    # the hog's node reported (then cleared) its pressure condition
    ready = [n for n in api.list("Node")[0]
             if n.condition("Ready") == k.ConditionStatus.TRUE]
    assert len(ready) == n_nodes


def test_scheduler_spreads_with_real_apiserver_service(k):
    """Regression: a Service stored as an apiserver object (api/workloads
    Service, not the scheduler-internal WorkloadObject) must flow through
    the spread path via to_workload_object — found by driving the full
    stack, previously crashed with AttributeError: no .selects."""

    api = k.ApiServerLite()
    for i in range(4):
        api.create("Node", k.make_node(f"n{i}", cpu=4000, memory=8 * Gi))
    api.create("Service", k.Service("svc", "default", selector={"app": "w"},
                                    ports=[k.ServicePort(port=80)]))
    for i in range(8):
        api.create("Pod", k.make_pod(f"w{i}", cpu=100, labels={"app": "w"}))
    sched = k.Scheduler(api, record_events=False, **DEVICE[k.root])
    sched.start()
    totals = sched.run_until_drained()
    assert totals["bound"] == 8
    used = {p.node_name for p in api.list("Pod")[0]}
    assert len(used) == 4, "SelectorSpread must fan service pods out"


def test_disk_pressure_evicts_by_disk_usage_not_memory_request(k):
    """Disk eviction must rank by disk usage over the
    DISK request — a pod with a big memory request but small disk use must
    not shield the actual disk hog."""

    node = k.make_node("n0", cpu=4000, memory=8 * Gi)
    node.allocatable.storage_scratch = 10 * Gi
    em = k.EvictionManager(node)
    # burstable A: huge memory request, tiny disk use
    a = k.make_pod("a", cpu=100, memory=4 * Gi, node_name="n0")
    a.annotations[k.ACTUAL_DISK_ANNOTATION] = str(1 * Gi)
    # burstable B: small memory request, the actual disk hog
    b = k.make_pod("b", cpu=100, memory=64 * Mi, node_name="n0")
    b.annotations[k.ACTUAL_DISK_ANNOTATION] = str(9 * Gi)
    evict = em.synchronize({"default/a": a, "default/b": b})
    assert em.disk_pressure
    assert evict[0] == "default/b", f"disk hog must rank first, got {evict}"




# ----------------------------------------------------------- kubelet server


def rig(k):
    api = k.ApiServerLite()
    node = k.make_node("n1", cpu=4000, memory=8 * Gi)
    api.create("Node", node)
    kubelet = k.HollowKubelet(api, node)
    pod = k.make_pod("web", cpu=50, memory=Mi)
    pod.node_name = "n1"
    pod.annotations["bench/log-lines"] = "line1\nline2\nline3"
    pod.annotations["bench/exec-cat /etc/hostname"] = "web-host"
    api.create("Pod", pod)
    kubelet.handle_pod(pod)
    kubelet.workers.drain()
    assert pod.key() in kubelet._admitted
    return api, kubelet, pod


def test_kubelet_server_endpoints(k):
    api, kubelet, pod = rig(k)
    srv = k.KubeletServer(kubelet)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        with urllib.request.urlopen(base + "/healthz") as r:
            assert r.read() == b"ok"
        with urllib.request.urlopen(base + "/pods") as r:
            items = json.loads(r.read())["items"]
            assert [(i["name"], i["namespace"]) for i in items] \
                == [("web", "default")]
        with urllib.request.urlopen(base + "/stats/summary") as r:
            stats = json.loads(r.read())
            assert stats["node"]["cpu"]["usageMilli"] == 50
            assert stats["pods"] == 1
        with urllib.request.urlopen(
                base + "/containerLogs/default/web") as r:
            assert r.read().decode() == "line1\nline2\nline3"
        with urllib.request.urlopen(
                base + "/containerLogs/default/web?tailLines=1") as r:
            assert r.read().decode() == "line3"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/containerLogs/default/ghost")
        assert ei.value.code == 404
        req = urllib.request.Request(
            base + "/exec/default/web?command=cat%20/etc/hostname",
            data=b"", method="POST")
        with urllib.request.urlopen(req) as r:
            assert r.read().decode() == "web-host"
        req = urllib.request.Request(
            base + "/exec/default/web?command=rm%20-rf",
            data=b"", method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 501
    finally:
        srv.stop()


def test_concurrent_pods_requests_during_churn(k):
    """/pods iterates a snapshot, never the live dict — concurrent reads
    during admit/evict churn must not 500."""
    import threading

    api, kubelet, pod = rig(k)
    srv = k.KubeletServer(kubelet)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    errors = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                with urllib.request.urlopen(base + "/pods", timeout=5) as r:
                    json.loads(r.read())
                with urllib.request.urlopen(base + "/stats/summary",
                                            timeout=5) as r:
                    json.loads(r.read())
            except Exception as e:  # any failure is a real defect
                errors.append(e)
                return

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for i in range(60):
            p = k.make_pod(f"churn-{i}", cpu=1, memory=Mi)
            p.node_name = "n1"
            api.create("Pod", p)
            kubelet.handle_pod(p)
            kubelet.workers.drain()
            kubelet.forget_pod(p)
            kubelet.workers.drain()
    finally:
        stop.set()
        for t in threads:
            t.join()
        srv.stop()
    assert not errors, errors[:1]




# ------------------------------------------------------------------ probes


def test_http_probe_against_live_surfaces(k):
    api = k.ApiServer()
    api.store.create("Namespace", k.Namespace("default"))
    rest = k.RestServer(api)
    rest.start()
    lite = k.ApiServerLite()
    node = k.make_node("n1", cpu=1000, memory=1 << 31)
    lite.create("Node", node)
    ks = k.KubeletServer(k.HollowKubelet(lite, node))
    ks.start()
    try:
        for port, path in ((rest.port, "/healthz"), (ks.port, "/healthz")):
            result, msg = k.probe_http(f"http://127.0.0.1:{port}{path}")
            assert result == k.SUCCESS, msg
        # 404 is a FAILED probe, not an error
        result, msg = k.probe_http(f"http://127.0.0.1:{ks.port}/nope")
        assert result == k.FAILURE and "404" in msg
        # TCP connect succeeds on a live listener
        assert k.probe_tcp("127.0.0.1", rest.port)[0] == k.SUCCESS
    finally:
        rest.stop()
        ks.stop()


def test_probe_failures_on_dead_endpoints(k):
    # grab a port nobody is listening on
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    result, msg = k.probe_http(f"http://127.0.0.1:{port}/healthz",
                               timeout=0.3)
    assert result == k.FAILURE  # refused connection = failed probe
    assert k.probe_tcp("127.0.0.1", port, timeout=0.3)[0] == k.FAILURE


def test_exec_probe_result_mapping(k):
    assert k.probe_exec(lambda: (0, "ok")) == (k.SUCCESS, "ok")
    assert k.probe_exec(lambda: (2, "bad")) == (k.FAILURE, "bad")
    # infrastructure error -> Unknown, like exec.go
    def boom():
        raise RuntimeError("runtime unavailable")
    result, msg = k.probe_exec(boom)
    assert result == k.UNKNOWN and "unavailable" in msg


def test_probe_daemon_healthz_lifecycle(k):
    """The prober against the scheduler daemon's healthz — alive while
    running, FAILED after stop (the liveness signal an operator's probe
    would consume, server.go's healthz story)."""

    api = k.ApiServerLite()
    api.create("Node", k.make_node("n1", cpu=4000, memory=1 << 33))
    api.create("Pod", k.make_pod("p", cpu=100))
    d = k.SchedulerDaemon(api, "probe-d",
                          k.SchedulerOptions(leader_elect=False),
                          **DEVICE[k.root])
    d.step()
    url = f"http://127.0.0.1:{d.healthz_port}/healthz"
    result, msg = k.probe_http(url)
    assert result == k.SUCCESS, msg
    d.stop()
    assert k.probe_http(url, timeout=0.3)[0] == k.FAILURE




# ------------------------------------------ the two packages, one world

WORLD_NODES, WORLD_PODS, WORLD_SS, WORLD_RS, WORLD_DEAD = 64, 160, 6, 24, 8


def _node_world(k):
    """64 hollow kubelets behind the scheduler on one FakeClock: bound
    mixed_affinity pods and one pod whose liveness probe fails; a
    StatefulSet rolled out ordinal by ordinal; a ReplicaSet, then 8 of
    its nodes' kubelets killed until the lifecycle controller has
    evicted them and the ReplicaSet's replacements run on live nodes;
    one node's pods past the eviction threshold, then BestEffort pods
    placed after its heartbeat. Returns the store and the fleet."""
    clock = FakeClock()
    api = k.ApiServerLite()
    factory = k.SharedInformerFactory(api)
    fleet = k.HollowFleet(api, factory, now=clock)
    for node in k.hollow_nodes(WORLD_NODES):
        fleet.add_node(node)
    nlc = k.NodeLifecycleController(api, factory, eviction_timeout=60.0,
                                    record_events=False, now=clock)
    rsc = k.ReplicaSetController(api, factory, record_events=False)
    ssc = k.StatefulSetController(api, factory, record_events=False)
    epc = k.EndpointController(api, factory, record_events=False)
    proxy = k.HollowProxy(factory)
    sched = k.Scheduler(api, record_events=False, now=clock,
                        **DEVICE[k.root])
    sched.start()
    api.create("Service", k.Service("web", "default",
                                    selector={"app": "web"},
                                    ports=[k.ServicePort(port=80)]))

    def settle():
        factory.step_all()
        fleet.step()
        factory.step_all()

    def tick(dt=10.0):
        clock.t += dt
        fleet.heartbeat_all()
        factory.step_all()
        nlc.monitor_tick()
        factory.step_all()
        rsc.pump()
        ssc.pump()
        epc.pump()
        sched.run_until_drained()
        settle()

    for p in k.mixed_affinity_pods(WORLD_PODS, namespace="default"):
        api.create("Pod", p)
    api.create("Pod", _probe_pod(k, "flaky", "hollow-node-3",
                                 liveness_fail_at=5.0))
    sched.run_until_drained()
    settle()
    api.create("StatefulSet", k.StatefulSet(
        name="db", replicas=WORLD_SS,
        selector=k.LabelSelector(match_labels={"app": "db"}),
        template=k.make_pod("", labels={"app": "db"}, cpu=100,
                            memory=128 << 20)))
    for _ in range(2 * WORLD_SS):
        tick(1.0)
    api.create("ReplicaSet", k.ReplicaSet(
        name="web", replicas=WORLD_RS,
        selector=k.LabelSelector(match_labels={"app": "web"}),
        template=k.make_pod("", labels={"app": "web"}, cpu=100,
                            memory=128 << 20)))
    tick(1.0)
    tick(1.0)
    web_nodes = sorted({p.node_name for p in api.list("Pod")[0]
                        if p.owner_name == "web"})
    for name in web_nodes[:WORLD_DEAD]:
        del fleet.kubelets[name]
    for _ in range(20):
        tick()
    hot = "hollow-node-5"
    hog = k.make_pod("hog", cpu=100, memory=128 << 20, node_name=hot)
    hog.annotations[k.ACTUAL_MEM_ANNOTATION] = str(31 << 30)
    api.create("Pod", hog)
    api.create("Pod", k.make_pod("be", node_name=hot))
    settle()
    fleet.heartbeat_all()
    for i in range(8):
        api.create("Pod", k.make_pod(f"late-{i}"))
    factory.step_all()
    sched.run_until_drained()
    settle()
    close = getattr(sched.engine, "close", None)
    if close is not None:
        close()
    return api, fleet, proxy, web_nodes[:WORLD_DEAD], hot


def _wire_dump(k, api):
    out = {}
    for kind in sorted(k.KIND_REGISTRY):
        objs = api.list(kind)[0]
        if objs:
            out[kind] = sorted(json.dumps(k.wire.encode(o, kind=kind),
                                          sort_keys=True) for o in objs)
    return out


@pytest.fixture(scope="module")
def worlds():
    return {root: _node_world(PKGS[root]) for root in (REF, PORT)}


def test_node_world_is_equal_in_wire_json(worlds):
    ref, port = (_wire_dump(PKGS[r], worlds[r][0]) for r in (REF, PORT))
    assert sorted(port) == sorted(ref)
    for kind in ref:
        assert port[kind] == ref[kind], kind


def test_node_world_cri_ops_and_restarts_are_equal(worlds):
    got = {}
    for root, (api, fleet, proxy, dead, hot) in worlds.items():
        got[root] = {name: (dict(kl.runtime.ops), dict(kl._restarts))
                     for name, kl in sorted(fleet.kubelets.items())}
    assert got[PORT] == got[REF]
    assert any(r for _, r in got[PORT].values())  # the flaky pod restarted


def test_node_world_holds_what_it_was_scripted_to(worlds):
    api, fleet, proxy, dead, hot = worlds[PORT]
    pods = api.list("Pod")[0]
    nodes = {n.name: n for n in api.list("Node")[0]}
    by_name = {p.name: p for p in pods}
    # every StatefulSet ordinal and every ReplicaSet pod Running on a live
    # node, nothing left on the dead ones
    ss = [p for p in pods if p.owner_kind == "StatefulSet"]
    web = [p for p in pods if p.owner_name == "web"]
    assert len(ss) == WORLD_SS and len(web) == WORLD_RS
    for p in ss + web:
        assert p.phase == "Running" and p.node_name not in dead, p.key()
    assert not [p for p in pods if p.node_name in dead]
    for name in dead:
        assert nodes[name].condition("Ready") == \
            PKGS[PORT].ConditionStatus.UNKNOWN
    # the endpoints and the proxy follow the live ReplicaSet
    assert len(proxy.backends("default/web", 80)) == WORLD_RS
    # memory pressure: reported, both evicted, no late pod on the node
    assert nodes[hot].condition("MemoryPressure") == \
        PKGS[PORT].ConditionStatus.TRUE
    for name in ("hog", "be"):
        assert by_name[name].annotations[
            "kubernetes.io/failure-reason"] == "Evicted"
    late = [by_name[f"late-{i}"] for i in range(8)]
    assert all(p.node_name and p.node_name != hot for p in late)
    # no pod refused by kubelet admission
    assert not [p for p in pods if p.annotations.get(
        "kubernetes.io/failure-reason", "").startswith("Out")]
