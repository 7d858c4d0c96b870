"""The port's node agents under chaos and under threads, against the
reference. The bodies of tests/test_chaos.py and
tests/test_concurrency_stress.py run on both packages (the `k` fixture,
every Scheduler and SchedulerDaemon of the port on the CPU): a scheduler
killed mid-storm and replaced, a leading daemon crashing on its lease,
hollow kubelets dying mid-storm (the node lifecycle controller evicts,
the ReplicaSet replaces, the scheduler places on the survivors), a watch
compacted under the scheduler, the streaming loop crashing with a wave
in flight, injected bind faults, an apiserver restarting from its WAL;
then the cache, the queue and the store hammered from threads, a
scheduler draining under concurrent creates, and kube-proxy's healthcheck
server."""

from __future__ import annotations

import json
import threading
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
    "engine_queue": "engine.queue",
    "engine_scheduler": "engine.scheduler",
    "nodes_kubelet": "nodes.kubelet",
    "nodes_proxy": "nodes.proxy",
    "server_apiserver_lite": "server.apiserver_lite",
    "server_daemon": "server.daemon",
    "state_cache": "state.cache",
    "testing_chaosmonkey": "testing.chaosmonkey",
    "testing_churn": "testing.churn",
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


Gi = 1 << 30


def _cluster(k, api, n_nodes=30, n_pods=300, cpu=4000):
    for i in range(n_nodes):
        api.create("Node", k.make_node(f"node-{i:03d}", cpu=cpu,
                                       memory=8 * Gi))
    for i in range(n_pods):
        api.create("Pod", k.make_pod(f"pod-{i:04d}", cpu=100))


def _assert_converged(api, n_pods, runnable=None):
    pods, _ = api.list("Pod")
    assert len(pods) == n_pods
    unbound = [p.name for p in pods if not p.node_name]
    assert not unbound, f"{len(unbound)} pods never bound: {unbound[:5]}"
    if runnable is not None:
        for p in pods:
            assert p.node_name in runnable, \
                f"{p.name} on dead node {p.node_name}"


def test_scheduler_killed_midstorm_replacement_converges(k):
    api = k.ApiServerLite()
    _cluster(k, api, n_pods=300)
    sched = k.Scheduler(api, record_events=False, **DEVICE[k.root])
    sched.start()
    # schedule part of the storm, then the scheduler "dies"
    sched.schedule_round(max_batch=120)
    bound_before = sum(1 for p in api.list("Pod")[0] if p.node_name)
    assert 0 < bound_before < 300
    del sched

    def disruption():
        pass  # the kill already happened; monkey verifies recovery

    cm = k.Chaosmonkey(disruption)
    outcome = {}

    def run_replacement():
        sched2 = k.Scheduler(api, record_events=False, **DEVICE[k.root])
        sched2.start()  # fresh relist: sees bound pods + the rest pending
        outcome.update(sched2.run_until_drained())

    cm.register(k.Test(test=run_replacement, name="replacement-scheduler"))
    cm.do()
    assert outcome["bind_errors"] == 0  # no double binds attempted
    _assert_converged(api, 300)


def test_daemon_failover_after_leader_crash(k):
    """Two daemon instances; the leader crashes WITHOUT releasing its
    lease mid-storm. The standby must wait out lease_duration, acquire,
    relist, and finish the drain."""
    clock = FakeClock()
    api = k.ApiServerLite()
    _cluster(k, api, n_pods=0)  # nodes only; the storm lands mid-flight
    opts = k.SchedulerOptions(healthz_port=None)
    a = k.SchedulerDaemon(api, "daemon-a", opts, now=clock,
                          **DEVICE[k.root])
    b = k.SchedulerDaemon(api, "daemon-b", opts, now=clock,
                          **DEVICE[k.root])
    a.step()  # a acquires
    b.step()
    assert a.is_leader() and not b.is_leader()
    for i in range(240):
        api.create("Pod", k.make_pod(f"pod-{i:04d}", cpu=100))
    a.scheduler.schedule_round(max_batch=100)
    bound_mid = sum(1 for p in api.list("Pod")[0] if p.node_name)
    assert 0 < bound_mid < 240

    def crash_leader():
        a.stop(release=False)  # hard kill: lease NOT released

    cm = k.Chaosmonkey(crash_leader)

    def standby_takes_over():
        # within the lease the standby must NOT lead
        b.step()
        assert not b.is_leader()
        clock.t += 16.0  # > lease_duration 15s
        for _ in range(50):
            stats = b.step()
            if b.is_leader() and stats["popped"] == 0 \
                    and b.scheduler.queue.ready_count() == 0:
                break
        assert b.is_leader()

    cm.register(k.Test(test=standby_takes_over, name="standby-failover"))
    cm.do()
    _assert_converged(api, 240)
    lease = api.get("Lease", "kube-system", "kube-scheduler")
    assert lease.holder == "daemon-b"
    assert lease.leader_transitions == 1
    b.stop()


def test_kubelet_deaths_midstorm_reschedule_elsewhere(k):
    """Kill a third of the kubelets mid-storm: nodelifecycle marks them
    NotReady after the grace period and evicts their pods; the scheduler
    reschedules onto survivors (network_partition.go's node-death story)."""


    clock = FakeClock()
    api = k.ApiServerLite()
    factory = k.SharedInformerFactory(api)
    fleet = k.HollowFleet(api, factory, now=clock)
    n_nodes, n_pods = 12, 120
    for i in range(n_nodes):
        fleet.add_node(k.make_node(f"node-{i:03d}", cpu=32_000, memory=64 * Gi))
    # the storm is an RC-managed workload, so evicted pods are REPLACED and
    # rescheduled (the reference's node-death story needs the controller)
    api.create("ReplicaSet", k.ReplicaSet(
        "web", replicas=n_pods,
        selector=k.LabelSelector(match_labels={"app": "web"}),
        template=k.make_pod("", cpu=100, labels={"app": "web"})))
    nlc = k.NodeLifecycleController(api, factory, now=clock,
                                    eviction_timeout=60.0,  # shorten the 5min
                                  # default so the sim converges in few ticks
                                    record_events=False)
    rsc = k.ReplicaSetController(api, factory, record_events=False)
    sched = k.Scheduler(api, record_events=False, **DEVICE[k.root], now=clock)
    sched.start()
    factory.step_all()
    rsc.pump()
    sched.run_until_drained()
    factory.step_all()
    fleet.step()  # pods running

    dead = [f"node-{i:03d}" for i in range(0, n_nodes, 3)]

    def kill_kubelets():
        for name in dead:
            del fleet.kubelets[name]  # process gone: no more heartbeats

    cm = k.Chaosmonkey(kill_kubelets)

    def cluster_heals():
        # heartbeats for survivors only; grace period passes for the dead,
        # then the rate-limited eviction drains them over several ticks
        for _ in range(30):
            clock.t += 10.0
            fleet.heartbeat_all()
            factory.step_all()
            nlc.monitor_tick()
            nlc.pump()
            rsc.pump()
            sched.sync()
            sched.schedule_round()
            factory.step_all()
            fleet.step()
        ready = {n.name for n in api.list("Node")[0]
                 if n.condition("Ready") == k.ConditionStatus.TRUE}
        for name in dead:
            assert name not in ready, f"dead {name} still Ready"

    cm.register(k.Test(test=cluster_heals, name="node-death-heal"))
    cm.do()
    # convergence: the RS is back to full strength, every replacement
    # runs on a surviving node, nothing Running remains on a dead one
    pods = [p for p in api.list("Pod")[0] if not p.deleted]
    running = [p for p in pods if p.phase == "Running"]
    assert len(running) >= n_pods
    for p in running:
        assert p.node_name not in dead


def test_watch_compaction_forces_relist_and_converges(k):
    """A tiny event log + a flood of writes while the scheduler lags ->
    TooOldResourceVersion on its next sync -> full relist -> drain."""
    api = k.ApiServerLite(max_log=50)
    _cluster(k, api, n_nodes=10, n_pods=60)
    sched = k.Scheduler(api, record_events=False, **DEVICE[k.root])
    sched.start()
    sched.schedule_round(max_batch=20)

    def flood():
        # unrelated churn blows the 50-event log out from under the cursor
        for i in range(200):
            api.create("Pod", k.make_pod(f"noise-{i:03d}", cpu=1,
                                         node_name="node-000"))

    cm = k.Chaosmonkey(flood)
    cm.register(k.Test(
        test=lambda: sched.run_until_drained(), name="relist-converge"))
    cm.do()
    pods, _ = api.list("Pod")
    storm = [p for p in pods if p.name.startswith("pod-")]
    assert all(p.node_name for p in storm)
    assert len(storm) == 60


def _bind_transitions(api):
    """Per-pod distinct bound nodes across the event log — the store-level
    exactly-once audit: a pod bound twice (to anywhere) would show two
    distinct transitions; the store refuses them, so >1 here is a real
    double bind."""
    nodes_by_pod = {}
    for ev in api._log:
        if ev.kind == "Pod" and ev.type == "MODIFIED" and ev.obj.node_name:
            nodes_by_pod.setdefault(ev.obj.key(), set()).add(
                ev.obj.node_name)
    return nodes_by_pod


def _drain_stream(sched, loop, deadline_s=60):
    import time as _time
    deadline = _time.monotonic() + deadline_s
    total = {}
    while _time.monotonic() < deadline:
        stats = loop.step()
        for k, v in stats.items():
            total[k] = total.get(k, 0) + v
        if loop.settled():
            return total
        sched.sync(wait=0.02)
    raise AssertionError("stream drain did not settle")


def test_streaming_loop_crash_midoffer_exactly_once(k):
    """The streaming mirror of the scheduler-killed storm: the
    ALWAYS-ON loop dies mid-offer with a wave in flight (popped pods
    never harvested — exactly the state a process crash leaves). A
    replacement scheduler + loop relists and converges: every pod bound
    exactly once, zero double binds, zero bind errors, zero lost pods."""
    api = k.ApiServerLite()
    _cluster(k, api, n_pods=300)
    sched = k.Scheduler(api, record_events=False, **DEVICE[k.root])
    sched.start()
    loop = sched.stream(budget_s=30.0, min_quantum=64, max_quantum=64)
    loop.step()   # wave 1 dispatched, in flight
    loop.step()   # wave 1 harvested+bound, wave 2 in flight
    assert loop.inflight is not None
    bound_before = sum(1 for p in api.list("Pod")[0] if p.node_name)
    assert 0 < bound_before < 300
    del loop, sched  # CRASH: no close(), no flush — the in-flight wave
    # and every queue-resident pod die with the process

    cm = k.Chaosmonkey(lambda: None)
    outcome = {}

    def replacement():
        s2 = k.Scheduler(api, record_events=False, **DEVICE[k.root])
        s2.start()  # relist: bound pods into cache, the rest pend
        l2 = s2.stream(budget_s=30.0, min_quantum=64, max_quantum=64)
        outcome.update(_drain_stream(s2, l2))
        outcome.update(l2.close())

    cm.register(k.Test(test=replacement, name="streaming-replacement"))
    cm.do()
    assert outcome["bind_errors"] == 0, outcome
    _assert_converged(api, 300)
    assert all(len(v) == 1 for v in _bind_transitions(api).values())


def test_streaming_injected_bind_faults_exactly_once(k):
    """Injected bind failures AND landed-but-timed-out binds on the
    STREAMING path: the backoff requeue heals both end to end — all
    pods bound, bind_errors counted (the faults really fired), and the
    store-level audit shows every pod bound exactly once (the timeout
    retries were refused, never double-applied)."""

    api = k.ApiServerLite()
    _cluster(k, api, n_pods=0)
    faulty = k.FaultyBindApi(api, fail_rate=0.05, timeout_rate=0.03, seed=7)
    sched = k.Scheduler(faulty, record_events=False, **DEVICE[k.root])
    sched.start()
    loop = sched.stream(budget_s=30.0, min_quantum=64, max_quantum=64)
    for i in range(300):
        api.create("Pod", k.make_pod(f"pod-{i:04d}", cpu=100))
    total = _drain_stream(sched, loop)
    total.update(loop.close())
    assert faulty.injected_failures > 0 and faulty.injected_timeouts > 0
    assert total["bind_errors"] >= (faulty.injected_failures
                                    + faulty.injected_timeouts), total
    _assert_converged(api, 300)
    assert all(len(v) == 1 for v in _bind_transitions(api).values())


def test_apiserver_crash_restart_midstorm(k, tmp_path):
    """Durable apiserver dies mid-storm (nothing flushed beyond the WAL);
    a new process restores and a new scheduler converges — the
    restore-from-backup.sh + relist story, from the chaos angle."""
    d = str(tmp_path / "data")
    api = k.ApiServerLite(data_dir=d)
    _cluster(k, api, n_pods=200)
    sched = k.Scheduler(api, record_events=False, **DEVICE[k.root])
    sched.start()
    sched.schedule_round(max_batch=80)

    state = {}

    def crash_and_restore():
        # drop both objects without close(): batch-flushed WAL survives
        state["api"] = k.ApiServerLite(data_dir=d)

    cm = k.Chaosmonkey(crash_and_restore)

    def converge():
        api2 = state["api"]
        pods, _ = api2.list("Pod")
        assert len(pods) == 200
        assert sum(1 for p in pods if p.node_name) >= 80
        sched2 = k.Scheduler(api2, record_events=False, **DEVICE[k.root])
        sched2.start()
        totals = sched2.run_until_drained()
        assert totals["bind_errors"] == 0

    cm.register(k.Test(test=converge, name="apiserver-restart"))
    cm.do()
    _assert_converged(state["api"], 200)


# ------------------------------------------------------ concurrency stress


def _run_threads(fns):
    errors = []

    def wrap(fn):
        def go():
            try:
                fn()
            except Exception as e:  # pragma: no cover - failure path
                errors.append(e)
        return go

    threads = [threading.Thread(target=wrap(fn)) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "stress thread wedged"
    assert not errors, errors


def test_cache_concurrent_assume_confirm_forget_balances(k):
    cache = k.SchedulerCache(ttl_seconds=1000.0)
    cache.add_node(k.make_node("n0", cpu=10_000_000, memory=1000 * Gi))
    base = cache.node_infos()["n0"].requested.milli_cpu
    n_per = 300

    def assume_then_forget(tag):
        def go():
            for i in range(n_per):
                p = k.make_pod(f"{tag}-{i}", cpu=7, node_name="n0")
                cache.assume_pod(p)
                cache.finish_binding(p)
                if i % 2:
                    cache.forget_pod(p)
                else:
                    cache.add_pod(p)   # informer confirm
                    cache.remove_pod(p)  # and deletion
        return go

    _run_threads([assume_then_forget(f"t{k}") for k in range(4)])
    info = cache.node_infos()["n0"]
    assert info.requested.milli_cpu == base
    assert not info.pods
    assert cache.pod_count() == 0


def test_queue_concurrent_producers_consumers_exactly_once(k):
    q = k.SchedulingQueue()
    n_producers, n_per = 4, 250
    total = n_producers * n_per
    popped = []
    popped_lock = threading.Lock()
    done = threading.Event()

    def producer(tag):
        def go():
            for i in range(n_per):
                q.add(k.make_pod(f"{tag}-{i}"))
        return go

    def consumer():
        while not done.is_set() or len(q):
            batch = q.pop_batch(max_n=16, wait=0.01)
            if batch:
                with popped_lock:
                    popped.extend(p.key() for p in batch)
            with popped_lock:
                if len(popped) >= total:
                    return

    producers = [producer(f"p{k}") for k in range(n_producers)]
    consumers = [consumer, consumer]

    def run_producers():
        _run_threads(producers)
        done.set()

    prod_thread = threading.Thread(target=run_producers)
    prod_thread.start()
    _run_threads(consumers)
    prod_thread.join(timeout=60)
    assert len(popped) == total
    assert len(set(popped)) == total, "a pod was popped twice"


def test_apiserver_racing_binders_bind_exactly_once(k):
    api = k.ApiServerLite()
    api.create("Node", k.make_node("n0"))
    n_pods = 400
    for i in range(n_pods):
        api.create("Pod", k.make_pod(f"p{i:03d}", cpu=10))
    conflicts = []
    lock = threading.Lock()

    def binder(offset):
        def go():
            errs = 0
            # every binder tries EVERY pod: exactly one thread can win each
            for i in range(n_pods):
                j = (i + offset) % n_pods
                out = api.bind_many([k.Binding(f"p{j:03d}", "default", "",
                                             "n0")])
                if out[0] is not None:
                    errs += 1
            with lock:
                conflicts.append(errs)
        return go

    _run_threads([binder(k * 100) for k in range(4)])
    pods, _ = api.list("Pod")
    assert all(p.node_name == "n0" for p in pods)
    # 4 attempts per pod, exactly 1 success: 3 conflicts each
    assert sum(conflicts) == 3 * n_pods


def test_watcher_sees_monotonic_rv_stream_under_writes(k):
    api = k.ApiServerLite(max_log=100_000)
    stop = threading.Event()
    seen = []

    def writer():
        for i in range(500):
            api.create("Pod", k.make_pod(f"w-{i:03d}"))
        stop.set()

    def watcher():
        rv = 0
        while True:
            evs = api.watch_since(("Pod",), rv, timeout=0.05)
            for ev in evs:
                assert ev.rv > rv, "rv went backwards"
                rv = ev.rv
                seen.append(ev.rv)
            if stop.is_set() and not evs:
                return

    _run_threads([writer, watcher])
    assert len(seen) == 500
    assert seen == sorted(seen)


def test_scheduler_drains_under_concurrent_churn(k):
    api = k.ApiServerLite()
    for i in range(20):
        api.create("Node", k.make_node(f"n{i:02d}", cpu=64_000,
                                       memory=256 * Gi))
    sched = k.Scheduler(api, record_events=False, **DEVICE[k.root])
    sched.start()
    n_pods = 600
    created = threading.Event()

    def churn():
        for i in range(n_pods):
            api.create("Pod", k.make_pod(f"c-{i:03d}", cpu=50))
        created.set()

    totals = {"bound": 0, "bind_errors": 0}

    def drain():
        while not created.is_set() or any(
                not p.node_name for p in api.list("Pod")[0]):
            stats = sched.schedule_round(wait=0.01)
            totals["bound"] += stats["bound"]
            totals["bind_errors"] += stats["bind_errors"]

    _run_threads([churn, drain])
    assert totals["bound"] == n_pods
    assert totals["bind_errors"] == 0
    pods, _ = api.list("Pod")
    assert all(p.node_name for p in pods)


# --------------------------------------------------------- proxy healthz


def test_proxy_healthcheck_server_reports_local_endpoints(k):
    api = k.ApiServerLite()
    factory = k.SharedInformerFactory(api)
    api.create("Service", k.Service("svc", "default", selector={"app": "w"},
                                    ports=[k.ServicePort(port=80)]))
    p0 = k.make_pod("w0", cpu=10, labels={"app": "w"}, node_name="n0")
    p0.phase = "Running"
    api.create("Pod", p0)
    epc = k.EndpointController(api, factory, record_events=False)
    proxy = k.HollowProxy(factory)
    factory.step_all()
    epc.pump()
    factory.step_all()
    hs0 = k.ProxyHealthServer(proxy, "n0")
    hs1 = k.ProxyHealthServer(proxy, "n1")
    hs0.start()
    hs1.start()
    try:
        def probe(port):
            url = f"http://127.0.0.1:{port}/healthz/default/svc"
            try:
                with urllib.request.urlopen(url, timeout=10) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        code0, body0 = probe(hs0.port)
        assert code0 == 200 and body0["localEndpoints"] == 1
        code1, body1 = probe(hs1.port)  # n1 has no local endpoint
        assert code1 == 503 and body1["localEndpoints"] == 0
    finally:
        hs0.stop()
        hs1.stop()
