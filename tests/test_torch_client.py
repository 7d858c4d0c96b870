"""The reference's client-library contracts (tests/test_client.py) on both
packages: the work queues and rate limiters, parallelize, the informer
store and its watch, relist after compaction, shared informers, leader
election and the event recorder. Each body runs through the `k`
fixture."""

from __future__ import annotations

import threading

import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "api_types": "api.types",
    "client_informer": "client.informer",
    "client_leaderelection": "client.leaderelection",
    "client_record": "client.record",
    "client_workqueue": "client.workqueue",
    "server_apiserver_lite": "server.apiserver_lite",
}
PKGS = {root: Pkg(root, MODULES) for root in (REF, PORT)}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------- workqueue


def test_workqueue_dedupes_adds(k):
    q = k.WorkQueue()
    q.add("a")
    q.add("a")
    q.add("b")
    assert len(q) == 2
    assert q.get(0) == "a"
    q.done("a")
    assert q.get(0) == "b"


def test_workqueue_requeues_item_added_while_processing(k):
    q = k.WorkQueue()
    q.add("a")
    item = q.get(0)
    q.add("a")  # re-add while in flight
    assert len(q) == 0  # parked in dirty, not queued
    q.done(item)
    assert q.get(0) == "a"  # exactly one requeue


def test_workqueue_shutdown_raises(k):
    q = k.WorkQueue()
    q.shut_down()
    with pytest.raises(k.ShutDown):
        q.get(0)


def test_rate_limiter_exponential_and_forget(k):
    rl = k.ItemExponentialFailureRateLimiter(base=1.0, max_delay=8.0)
    assert [rl.when("x") for _ in range(5)] == [1.0, 2.0, 4.0, 8.0, 8.0]
    rl.forget("x")
    assert rl.when("x") == 1.0


def test_rate_limiting_queue_add_after(k):
    clock = FakeClock()
    q = k.RateLimitingQueue(now=clock)
    q.add_after("later", 5.0)
    q.add("now")
    assert q.get(0) == "now"
    q.done("now")
    with pytest.raises(TimeoutError):
        q.get(0)
    clock.t = 5.0
    assert q.get(0) == "later"


def test_parallelize_covers_all_pieces(k):
    seen = set()
    lock = threading.Lock()

    def work(i):
        with lock:
            seen.add(i)

    k.parallelize(4, 100, work)
    assert seen == set(range(100))


# ----------------------------------------------------------------- store


def test_store_index_by_node(k):
    s = k.Store()
    s.add_index("node", lambda p: [p.node_name] if p.node_name else [])
    p1 = k.make_pod("a", node_name="n1")
    p2 = k.make_pod("b", node_name="n1")
    p3 = k.make_pod("c", node_name="n2")
    for p in (p1, p2, p3):
        s.upsert(p)
    assert {p.name for p in s.by_index("node", "n1")} == {"a", "b"}
    # move b to n2
    import dataclasses
    s.upsert(dataclasses.replace(p2, node_name="n2"))
    assert {p.name for p in s.by_index("node", "n1")} == {"a"}
    assert {p.name for p in s.by_index("node", "n2")} == {"b", "c"}
    s.remove(p3)
    assert {p.name for p in s.by_index("node", "n2")} == {"b"}


# --------------------------------------------------------------- informer


def test_informer_sync_then_watch_events(k):
    api = k.ApiServerLite()
    api.create("Node", k.make_node("n1"))
    inf = k.SharedInformer(api, "Node")
    adds, updates, deletes = [], [], []
    inf.add_event_handler(
        on_add=lambda o: adds.append(o.name),
        on_update=lambda old, new: updates.append(new.name),
        on_delete=lambda o: deletes.append(o.name),
    )
    inf.step()  # initial list
    assert inf.has_synced() and adds == ["n1"]
    api.create("Node", k.make_node("n2"))
    n1 = api.get("Node", "", "n1")
    import dataclasses
    api.update("Node", dataclasses.replace(n1, unschedulable=True))
    api.delete("Node", "", "n2")
    inf.step()
    assert adds == ["n1", "n2"]
    assert updates == ["n1"]
    assert deletes == ["n2"]
    assert inf.store.get("n1").unschedulable


def test_informer_relist_after_compaction(k):
    api = k.ApiServerLite(max_log=4)
    inf = k.SharedInformer(api, "Pod")
    inf.step()
    for i in range(20):  # blow past the bounded log
        api.create("Pod", k.make_pod(f"p{i}"))
    inf.step()  # TooOld -> relist
    inf.step()
    assert len(inf.store) == 20


def test_late_handler_gets_synthetic_adds(k):
    api = k.ApiServerLite()
    api.create("Node", k.make_node("n1"))
    inf = k.SharedInformer(api, "Node")
    inf.step()
    got = []
    inf.add_event_handler(on_add=lambda o: got.append(o.name))
    assert got == ["n1"]


def test_factory_shares_informers(k):
    api = k.ApiServerLite()
    f = k.SharedInformerFactory(api)
    assert f.informer("Pod") is f.informer("Pod")
    api.create("Pod", k.make_pod("p"))
    f.step_all()
    assert f.informer("Pod").store.get("default/p") is not None


# --------------------------------------------------------- leader election


def test_leader_election_acquire_steal_and_renew(k):
    api = k.ApiServerLite()
    clock = FakeClock()
    events = []
    a = k.LeaderElector(k.LeaseLock(api, "sched"), "A", lease_duration=15.0,
                      on_started_leading=lambda: events.append("A-start"),
                      on_stopped_leading=lambda: events.append("A-stop"),
                      now=clock)
    b = k.LeaderElector(k.LeaseLock(api, "sched"), "B", lease_duration=15.0,
                      on_started_leading=lambda: events.append("B-start"),
                      now=clock)
    assert a.step() and a.is_leader()
    assert not b.step()  # A's lease is live
    clock.t = 10.0
    assert a.step()  # renew
    clock.t = 20.0
    assert not b.step()  # renewed at t=10, expires t=25
    clock.t = 26.0
    assert b.step() and b.is_leader()  # steal expired lease
    assert not a.step()  # A deposed
    assert not a.is_leader()
    assert events == ["A-start", "B-start", "A-stop"]
    lease = api.get("Lease", "kube-system", "sched")
    assert lease.holder == "B" and lease.leader_transitions == 1


def test_leader_tolerates_transient_renew_failure_within_deadline(k):
    api = k.ApiServerLite()
    clock = FakeClock()
    stops = []
    a = k.LeaderElector(k.LeaseLock(api, "cm"), "A", lease_duration=15.0,
                      renew_deadline=10.0,
                      on_stopped_leading=lambda: stops.append("A"), now=clock)
    assert a.step()
    # interleaved write bumps the lease rv so A's next CAS fails transiently
    lease = api.get("Lease", "kube-system", "cm")
    import dataclasses
    api.update("Lease", dataclasses.replace(lease))
    clock.t = 5.0

    orig_update = a.lock.update
    calls = {"n": 0}

    def flaky_update(lease, expect_rv):
        calls["n"] += 1
        if calls["n"] == 1:
            raise k.Conflict("transient")
        return orig_update(lease, expect_rv)

    a.lock.update = flaky_update
    assert not a.step()  # renew failed...
    assert a.is_leader() and stops == []  # ...but within the deadline window
    clock.t = 6.0
    assert a.step() and a.is_leader()  # recovered


# ------------------------------------------------------------------ events


def test_event_recorder_dedups_into_count(k):
    api = k.ApiServerLite()
    rec = k.EventRecorder(api, source="scheduler")
    for _ in range(3):
        rec.event("Pod", "default/p", "Warning", "FailedScheduling", "no fit")
    rec.event("Pod", "default/p", "Normal", "Scheduled", "bound to n1")
    evs, _ = api.list("Event")
    assert len(evs) == 2
    by_reason = {e.reason: e for e in evs}
    assert by_reason["FailedScheduling"].count == 3
    assert by_reason["Scheduled"].count == 1
