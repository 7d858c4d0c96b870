"""The port's scheduler daemon on the CPU against the reference package's:
a --policy-config-file, a --config through the scheme, the healthz /
metrics / leader endpoints, the demo main(), and leader failover after a
crash — with equal store placements where both packages schedule."""

from __future__ import annotations

import json
import urllib.request

from kubernetes_tpu.api import scheme as jscheme
from kubernetes_tpu.api import types as jt
from kubernetes_tpu.server import apiserver_lite as japi
from kubernetes_tpu.server import daemon as jdaemon
from kubernetes_tpu_torch.api import scheme as tscheme
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.server import apiserver_lite as tapi
from kubernetes_tpu_torch.server import daemon as tdaemon

Gi = 1 << 30
REF = dict(t=jt, api=japi, d=jdaemon, scheme=jscheme, kw={})
PORT = dict(t=tt, api=tapi, d=tdaemon, scheme=tscheme, kw={"device": "cpu"})


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _placements(api):
    return {p.name: p.node_name for p in api.list("Pod")[0]}


def test_daemon_policy_config_file(tmp_path):
    policy_file = tmp_path / "policy.json"
    policy_file.write_text(json.dumps({
        "predicates": [
            {"name": "GeneralPredicates"},
            {"name": "P", "argument": {"labelsPresence":
                                       {"labels": ["ok"], "presence": True}}},
        ],
        "priorities": [{"name": "LeastRequestedPriority", "weight": 1}],
    }))

    def run(side):
        t = side["t"]
        api = side["api"].ApiServerLite()
        api.create("Node", t.make_node("labeled", labels={"ok": "1"}))
        api.create("Node", t.make_node("bare"))
        for i in range(4):
            api.create("Pod", t.make_pod(f"p{i}", cpu=100))
        d = side["d"].SchedulerDaemon(
            api, "me", side["d"].SchedulerOptions(
                healthz_port=None, leader_elect=False,
                policy_config_file=str(policy_file)), **side["kw"])
        try:
            for _ in range(3):
                d.step()
        finally:
            d.stop()
        return _placements(api)

    ref, port = run(REF), run(PORT)
    assert port == ref
    assert set(port.values()) == {"labeled"}


def test_daemon_from_component_config():
    """--config: a versioned KubeSchedulerConfiguration decoded through
    DEFAULT_SCHEME drives the daemon options, as in the reference."""
    def run(side):
        cfg = side["scheme"].DEFAULT_SCHEME.decode({
            "apiVersion": "componentconfig/v1alpha1",
            "kind": "KubeSchedulerConfiguration",
            "schedulerName": "tpu-sched",
            "healthzBindAddress": "127.0.0.1:0",
            "leaderElection": {"leaderElect": False,
                               "lockObjectName": "my-lock"}})
        return side["d"].SchedulerOptions.from_component_config(cfg)

    ref, port = run(REF), run(PORT)
    assert (port.scheduler_name, port.leader_elect, port.lock_object_name,
            port.healthz_port, port.healthz_host) == \
        (ref.scheduler_name, ref.leader_elect, ref.lock_object_name,
         ref.healthz_port, ref.healthz_host) == \
        ("tpu-sched", False, "my-lock", 0, "127.0.0.1")


def test_daemon_healthz_metrics_and_leader_endpoints():
    api = tapi.ApiServerLite()
    for i in range(4):
        api.create("Node", tt.make_node(f"n{i}"))
    for i in range(8):
        api.create("Pod", tt.make_pod(f"p{i}", cpu=100))
    d = tdaemon.SchedulerDaemon(api, "me",
                                tdaemon.SchedulerOptions(healthz_port=0),
                                device="cpu")
    try:
        d.step()  # acquire + schedule
        port = d.healthz_port
        assert port

        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return r.read().decode()

        assert get("/healthz") == "ok"
        assert get("/leader") == "true"
        assert "scheduler" in get("/metrics")
        assert all(p.node_name for p in api.list("Pod")[0])
    finally:
        d.stop()


def test_daemon_main_runs_on_the_named_device(tmp_path, capsys):
    """The demo: two competing daemons in one process; `--device cpu`
    here, the card by default. With a Policy file and a --config."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "apiVersion": "componentconfig/v1alpha1",
        "kind": "KubeSchedulerConfiguration",
        "schedulerName": "default-scheduler"}))
    pol = tmp_path / "policy.json"
    pol.write_text(json.dumps({
        "priorities": [{"name": "LeastRequestedPriority", "weight": 1}]}))
    tdaemon.main(["--nodes", "10", "--pods", "40", "--device", "cpu"])
    tdaemon.main(["--nodes", "10", "--pods", "40", "--device", "cpu",
                  "--config", str(cfg), "--policy-config-file", str(pol)])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2
    for line in out:
        assert "bound=40/40" in line and "leader=daemon-a" in line


def _failover(side):
    """The leader crashes WITHOUT releasing its lease mid-storm; the
    standby waits out the lease, acquires, relists and finishes."""
    t, d = side["t"], side["d"]
    clock = FakeClock()
    api = side["api"].ApiServerLite()
    for i in range(30):
        api.create("Node", t.make_node(f"node-{i:03d}", cpu=4000,
                                       memory=8 * Gi))
    opts = d.SchedulerOptions(healthz_port=None)
    a = d.SchedulerDaemon(api, "daemon-a", opts, now=clock, **side["kw"])
    b = d.SchedulerDaemon(api, "daemon-b", opts, now=clock, **side["kw"])
    a.step()
    b.step()
    assert a.is_leader() and not b.is_leader()
    for i in range(240):
        api.create("Pod", t.make_pod(f"pod-{i:04d}", cpu=100))
    a.scheduler.schedule_round(max_batch=100)
    mid = _placements(api)
    a.stop(release=False)            # hard kill: the lease stays held
    b.step()
    assert not b.is_leader()         # within the lease
    clock.t += 16.0                  # past lease_duration (15 s)
    for _ in range(50):
        stats = b.step()
        if b.is_leader() and stats["popped"] == 0 \
                and b.scheduler.queue.ready_count() == 0:
            break
    lease = api.get("Lease", "kube-system", "kube-scheduler")
    out = (mid, _placements(api), lease.holder, lease.leader_transitions,
           b.scheduler.engine.rr.counter)
    b.stop()
    return out


def test_daemon_failover_after_leader_crash_matches_reference():
    ref, port = _failover(REF), _failover(PORT)
    assert port == ref
    mid, final, holder, transitions, _ = port
    assert 0 < sum(1 for v in mid.values() if v) < 240
    assert all(final.values()) and len(final) == 240
    assert (holder, transitions) == ("daemon-b", 1)


def test_daemon_graceful_stop_releases_lease_for_immediate_handoff():
    """stop(release=True) zeroes the lease: the standby acquires without
    waiting out lease_duration, in both packages."""
    def run(side):
        t, d = side["t"], side["d"]
        clock = FakeClock()
        api = side["api"].ApiServerLite()
        api.create("Node", t.make_node("n0"))
        opts = d.SchedulerOptions(healthz_port=None)
        a = d.SchedulerDaemon(api, "a", opts, now=clock, **side["kw"])
        b = d.SchedulerDaemon(api, "b", opts, now=clock, **side["kw"])
        a.step()
        b.step()
        first = (a.is_leader(), b.is_leader())
        a.stop(release=True)
        holder = api.get("Lease", "kube-system", "kube-scheduler").holder
        b.step()  # no clock advance
        out = (first, holder, b.is_leader())
        b.stop()
        return out

    ref, port = run(REF), run(PORT)
    assert port == ref == ((True, False), "", True)
