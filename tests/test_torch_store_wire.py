"""The reference's store and wire contracts on both packages: the durable
store (tests/test_persistence.py: WAL framing, torn and corrupt tails,
restore, compaction and the kill -9 storm, through each package's own
storm child), the versioned scheme (tests/test_conversion.py), the
protobuf fast path (tests/test_protowire.py, its generators built on the
package under test) and the JSON codecs with the Policy parser
(tests/test_serde_policy.py). Each body is the reference's, with its
imports through the `k` fixture and every port entry point on the CPU."""

from __future__ import annotations

import importlib
import json
import os
import random
import signal
import subprocess
import sys
import urllib.request

import pytest

from tests.torch_packages import PORT, REF, Pkg, reference_test_module

MODULES = {
    "api_policy": "api.policy",
    "api_scheme": "api.scheme",
    "api_types": "api.types",
    "api_wire": "api.wire",
    "engine_scheduler": "engine.scheduler",
    "protowire": "api.protowire",
    "serde": "api.serde",
    "server_apiserver_lite": "server.apiserver_lite",
    "server_durable": "server.durable",
    "server_extender": "server.extender",
}
STORM_CHILD = {REF: "_persistence_storm.py",
               PORT: "_torch_persistence_storm.py"}


def _pkg(root):
    fuzz = reference_test_module("test_full_fuzz", root)
    return Pkg(root, MODULES, extra={
        "_existing": fuzz._existing,
        "full_random_nodes": fuzz.full_random_nodes,
        "full_random_pod": fuzz.full_random_pod,
        "STORM_CHILD": STORM_CHILD[root],
        "_seconds": importlib.import_module(f"{root}.api.scheme")._seconds,
    })


PKGS = {root: _pkg(root) for root in (REF, PORT)}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


needs_protowire = pytest.mark.skipif(
    not all(p.protowire.available() for p in PKGS.values()),
    reason="protoc/protobuf unavailable")


# -------------------- tests/test_persistence.py


# ------------------------------------------------------------------ WAL unit


def test_wal_roundtrip(k, tmp_path):
    path = str(tmp_path / "wal.log")
    w = k.WriteAheadLog(path)
    recs = [b"alpha", b"x" * 10_000, b""]
    for r in recs:
        w.append(r)
    w.flush()
    w.close()
    assert list(k.WriteAheadLog.replay(path)) == recs


def test_wal_torn_tail_stops_cleanly(k, tmp_path):
    path = str(tmp_path / "wal.log")
    w = k.WriteAheadLog(path)
    w.append(b"first")
    w.append(b"second-record-payload")
    w.flush()
    w.close()
    size = os.path.getsize(path)
    with open(path, "r+b") as f:  # tear the last record mid-payload
        f.truncate(size - 7)
    assert list(k.WriteAheadLog.replay(path)) == [b"first"]


def test_wal_corrupt_crc_stops(k, tmp_path):
    path = str(tmp_path / "wal.log")
    w = k.WriteAheadLog(path)
    w.append(b"good")
    w.append(b"evil")
    w.flush()
    w.close()
    with open(path, "r+b") as f:  # flip a payload byte of the last record
        f.seek(-1, os.SEEK_END)
        f.write(b"\xff")
    assert list(k.WriteAheadLog.replay(path)) == [b"good"]


def test_wal_torn_tail_repaired_on_restore(k, tmp_path):
    """Restoring over a torn tail must TRUNCATE it: appending after the tear
    would bury every post-restart record behind an unreadable frame, so the
    next restore would silently lose acknowledged writes."""
    d = str(tmp_path / "data")
    api = k.ApiServerLite(data_dir=d)
    api.create("Pod", k.make_pod("p1"))
    api.create("Pod", k.make_pod("p2"))
    api.close()
    wal = os.path.join(d, k.DurableStore.WAL)
    with open(wal, "r+b") as f:  # tear the last record
        f.truncate(os.path.getsize(wal) - 3)

    api2 = k.ApiServerLite(data_dir=d)  # p2's record torn away
    pods, _ = api2.list("Pod")
    assert [p.name for p in pods] == ["p1"]
    api2.create("Pod", k.make_pod("p3"))  # appended after the repaired tail
    api2.close()

    api3 = k.ApiServerLite(data_dir=d)  # p3 must survive the next replay
    pods, _ = api3.list("Pod")
    assert sorted(p.name for p in pods) == ["p1", "p3"]


# ------------------------------------------------------- store level restore


def test_restore_objects_and_rv(k, tmp_path):
    d = str(tmp_path / "data")
    api = k.ApiServerLite(data_dir=d)
    api.create("Node", k.make_node("n1"))
    api.create("Pod", k.make_pod("p1", cpu=100))
    api.create("Pod", k.make_pod("p2", cpu=100))
    api.bind(k.Binding("p1", "default", "", "n1"))
    api.delete("Pod", "default", "p2")
    rv = api.current_rv()
    api.close()

    api2 = k.ApiServerLite(data_dir=d)
    assert api2.current_rv() == rv
    assert api2.get("Pod", "default", "p1").node_name == "n1"
    with pytest.raises(Exception):
        api2.get("Pod", "default", "p2")
    nodes, _ = api2.list("Node")
    assert [n.name for n in nodes] == ["n1"]
    # rv continuity: the next write must move past the restored rv
    api2.create("Pod", k.make_pod("p3"))
    assert api2.current_rv() == rv + 1


def test_watch_resume_after_restart_requires_relist(k, tmp_path):
    d = str(tmp_path / "data")
    api = k.ApiServerLite(data_dir=d)
    api.create("Node", k.make_node("n1"))
    pre_crash_rv = api.current_rv()
    api.create("Pod", k.make_pod("p1"))
    api.close()

    api2 = k.ApiServerLite(data_dir=d)
    # a watcher resuming from a pre-restart cursor must be told to relist
    with pytest.raises(k.TooOldResourceVersion):
        api2.watch_since(("Pod", "Node"), pre_crash_rv)
    # the relist handshake works and yields a valid new cursor
    pods, rv = api2.list("Pod")
    assert [p.name for p in pods] == ["p1"]
    assert api2.watch_since(("Pod",), rv) == []  # current cursor: no events
    api2.create("Pod", k.make_pod("p2"))
    evs = api2.watch_since(("Pod",), rv)
    assert [e.obj.name for e in evs] == ["p2"]


def test_compaction_truncates_wal_and_survives(k, tmp_path):
    d = str(tmp_path / "data")
    api = k.ApiServerLite(data_dir=d, compact_every=50)
    for i in range(120):  # crosses the threshold twice
        api.create("Pod", k.make_pod(f"p{i}"))
    assert os.path.exists(os.path.join(d, k.DurableStore.SNAPSHOT))
    # WAL holds only records since the last snapshot, not all 120
    assert api._durable._records_since_snapshot == 120 % 50
    remaining = sum(1 for _ in k.WriteAheadLog.replay(
        os.path.join(d, k.DurableStore.WAL)))
    assert remaining == 120 % 50
    api.close()
    api2 = k.ApiServerLite(data_dir=d)
    pods, _ = api2.list("Pod")
    assert len(pods) == 120


def test_in_memory_mode_unchanged(k, tmp_path):
    api = k.ApiServerLite()
    api.create("Pod", k.make_pod("p1"))
    assert api._durable is None


# --------------------------------------------------- kill -9 mid-storm (e2e)


def test_kill9_midstorm_recovery_and_drain(k, tmp_path):
    """The VERDICT-specified story: kill the process mid-storm, restart,
    every pod reaches bound exactly once, watches resume from a valid rv."""
    d = str(tmp_path / "data")
    n_nodes, n_pods = 20, 200
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(os.path.dirname(__file__),
                                      k.STORM_CHILD),
         d, str(n_nodes), str(n_pods)],
        stdout=subprocess.PIPE, text=True, env=env)
    # watchdog: a silently-stalled child must fail the test, not hang the
    # blocking stdout read forever
    import threading
    watchdog = threading.Timer(60, proc.kill)
    watchdog.start()
    try:
        # wait until the storm is genuinely mid-flight, then SIGKILL
        bound = 0
        for line in proc.stdout:
            if line.startswith("BOUND"):
                bound = int(line.split()[1])
                if bound >= 50:
                    break
        assert bound >= 50, "storm subprocess made no progress before 60s"
        proc.kill()  # SIGKILL — no atexit, no flush, no close
        proc.wait(timeout=30)
        assert proc.returncode == -signal.SIGKILL
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()

    # ---- restart: restore every flushed write --------------------------
    api = k.ApiServerLite(data_dir=d)
    pods, rv = api.list("Pod")
    nodes, _ = api.list("Node")
    assert len(nodes) == n_nodes
    assert len(pods) == n_pods, "creates were flushed before the storm"
    already = [p for p in pods if p.node_name]
    # every BOUND report the parent saw was flushed batch-wise; the tail
    # batch may or may not have made it — at-least-reported durability
    assert len(already) >= min(50, n_pods)
    assert rv == api.current_rv() > 0

    # ---- a real scheduler drains the rest; no pod is bound twice -------
    sched = k.Scheduler(api, record_events=False, **k.dev)
    sched.start()
    totals = sched.run_until_drained()
    assert totals["bind_errors"] == 0
    pods, _ = api.list("Pod")
    assert all(p.node_name for p in pods)
    # exactly once: rebinding a bound pod must be refused by the store
    errs = api.bind_many([k.Binding(pods[0].name, "default", "", "node-0000")])
    assert errs[0] is not None and "conflict" in errs[0]
    api.close()

    # ---- and the restored store is itself durable ----------------------
    api2 = k.ApiServerLite(data_dir=d)
    pods2, _ = api2.list("Pod")
    assert sorted((p.name, p.node_name) for p in pods2) \
        == sorted((p.name, p.node_name) for p in pods)


# -------------------- tests/test_conversion.py


# --------------------------------------------------------------- defaults


def test_pod_decode_applies_defaults_once(k):
    data = {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "p"},
            "spec": {"containers": [{"name": "c"}]}}
    pod = k.DEFAULT_SCHEME.decode(data)
    assert pod.scheduler_name == "default-scheduler"  # defaulted
    assert pod.restart_policy == "Always"  # defaulted
    assert pod.namespace == "default"  # defaulted
    # encode makes the defaults explicit; a second decode is idempotent
    wire = k.DEFAULT_SCHEME.encode(pod, "v1", "Pod")
    assert wire["spec"]["schedulerName"] == "default-scheduler"
    assert wire["spec"]["restartPolicy"] == "Always"
    assert k.DEFAULT_SCHEME.decode(wire) == pod


def test_unknown_core_version_fails_loudly(k):
    with pytest.raises(k.SchemeError):
        k.DEFAULT_SCHEME.decode({"apiVersion": "v9", "kind": "Pod",
                               "metadata": {"name": "p"}})


# ---------------------------------------------------------- field renames


def test_pod_v2_round_trip_renames_fields(k):
    v1 = {"apiVersion": "v1", "kind": "Pod",
          "metadata": {"name": "p", "namespace": "ns"},
          "spec": {"containers": [{"name": "c"}],
                   "nodeName": "n1", "schedulerName": "custom"}}
    pod = k.DEFAULT_SCHEME.decode(v1)
    v2 = k.DEFAULT_SCHEME.encode(pod, "v2", "Pod")
    assert v2["spec"]["boundNode"] == "n1"  # renamed
    assert v2["spec"]["scheduler"] == "custom"  # renamed
    assert "nodeName" not in v2["spec"]
    assert "schedulerName" not in v2["spec"]
    # v2 decodes to the SAME internal object (two-hop conversion)
    assert k.DEFAULT_SCHEME.decode(v2) == pod
    # and scheme.convert round-trips versioned->versioned
    v1_again = k.DEFAULT_SCHEME.convert(v2, "v1")
    assert v1_again["spec"]["nodeName"] == "n1"
    assert k.DEFAULT_SCHEME.decode(v1_again) == pod


def test_node_v2_round_trip_renames_unschedulable(k):
    v1 = {"apiVersion": "v1", "kind": "Node",
          "metadata": {"name": "n1", "labels": {"zone": "a"}},
          "spec": {"unschedulable": True, "taints": []},
          "status": {"allocatable": {"cpu": "4000m", "memory": "1048576",
                                     "pods": "110"},
                     "conditions": [{"type": "Ready", "status": "True"}]}}
    node = k.DEFAULT_SCHEME.decode(v1)
    assert node.unschedulable is True
    v2 = k.DEFAULT_SCHEME.encode(node, "v2", "Node")
    assert v2["spec"]["schedulingDisabled"] is True
    assert "unschedulable" not in v2["spec"]
    assert k.DEFAULT_SCHEME.decode(v2) == node


def test_service_v1_codec(k):
    data = {"apiVersion": "v1", "kind": "Service",
            "name": "svc", "namespace": "default",
            "selector": {"app": "web"}}
    svc = k.DEFAULT_SCHEME.decode(data)
    assert svc.name == "svc" and svc.selector == {"app": "web"}
    wire = k.DEFAULT_SCHEME.encode(svc, "v1", "Service")
    assert k.DEFAULT_SCHEME.decode(wire) == svc
    # the kubectl metadata/spec manifest shape decodes to the same object
    manifest = {"apiVersion": "v1", "kind": "Service",
                "metadata": {"name": "svc", "namespace": "default"},
                "spec": {"selector": {"app": "web"}}}
    assert k.DEFAULT_SCHEME.decode(manifest) == svc


def test_node_annotations_round_trip(k):
    v1 = {"apiVersion": "v1", "kind": "Node",
          "metadata": {"name": "n1", "annotations": {"k": "v"}},
          "spec": {}, "status": {"allocatable": {"cpu": "1000m",
                                                 "memory": "1048576",
                                                 "pods": "10"}}}
    node = k.DEFAULT_SCHEME.decode(v1)
    assert node.annotations == {"k": "v"}
    assert k.DEFAULT_SCHEME.decode(
        k.DEFAULT_SCHEME.encode(node, "v2", "Node")) == node


def test_empty_affinity_stanzas_round_trip(k):
    """decode({'nodeAffinity': {}}) and decode({'podAffinity': {}}) are
    real states (match-everything / empty) and must survive encode."""
    data = {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "p"},
            "spec": {"containers": [{"name": "c"}],
                     "affinity": {"nodeAffinity": {},
                                  "podAffinity": {}}}}
    pod = k.DEFAULT_SCHEME.decode(data)
    assert pod.affinity is not None
    assert pod.affinity.node_affinity is not None
    assert pod.affinity.pod_affinity is not None
    assert k.DEFAULT_SCHEME.decode(
        k.DEFAULT_SCHEME.encode(pod, "v1", "Pod")) == pod


# -------------------------------------------------------- round-trip fuzz


def _random_manifest(rng: random.Random) -> dict:
    Mi = 1 << 20
    containers = []
    for i in range(rng.randint(1, 3)):
        c = {"name": f"c{i}",
             "image": rng.choice(["", "app:v1", "registry/x:2"]),
             "resources": {"requests": {
                 "cpu": f"{rng.randint(1, 4000)}m",
                 "memory": str(rng.randint(1, 64) * Mi)}}}
        if rng.random() < 0.3:
            c["resources"]["limits"] = {
                "cpu": f"{rng.randint(1000, 8000)}m"}
        if rng.random() < 0.3:
            c["ports"] = [{"hostPort": rng.randint(0, 1),
                           "containerPort": rng.randint(1, 9999),
                           "protocol": "TCP"}]
        if rng.random() < 0.3:
            c["livenessProbe"] = {
                "exec": {}, "initialDelaySeconds": float(rng.randint(0, 9)),
                "periodSeconds": 10.0, "failureThreshold": 3,
                "successThreshold": 1}
        containers.append(c)
    spec = {"containers": containers,
            "nodeName": rng.choice(["", "n1"]),
            "schedulerName": rng.choice(["default-scheduler", "custom"]),
            "restartPolicy": rng.choice(["Always", "OnFailure", "Never"])}
    if rng.random() < 0.4:
        spec["tolerations"] = [{
            "key": "dedicated", "operator": "Equal", "value": "gpu",
            "effect": "NoSchedule"}]
    if rng.random() < 0.4:
        spec["affinity"] = {
            "nodeAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": {
                    "nodeSelectorTerms": [{"matchExpressions": [{
                        "key": "zone", "operator": "In",
                        "values": ["a", "b"]}]}]}},
            "podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "topologyKey": "kubernetes.io/hostname",
                    "labelSelector": {"matchLabels": {"app": "web"}}}],
                "preferredDuringSchedulingIgnoredDuringExecution": [{
                    "weight": 7, "podAffinityTerm": {
                        "topologyKey": "zone",
                        "labelSelector": {"matchExpressions": [{
                            "key": "tier", "operator": "NotIn",
                            "values": ["db"]}]}}}]}}
    if rng.random() < 0.3:
        spec["priority"] = rng.randint(1, 1000)
    if rng.random() < 0.2:
        spec["hostNetwork"] = True
    meta = {"name": f"p{rng.randint(0, 999)}",
            "namespace": rng.choice(["default", "kube-system"]),
            "labels": {"app": rng.choice(["web", "db"])}}
    if rng.random() < 0.4:
        meta["annotations"] = {"a": "1", "b": "two"}
    if rng.random() < 0.3:
        meta["ownerReferences"] = [{"kind": "ReplicaSet", "name": "rs-1",
                                    "uid": "u1", "controller": True}]
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": meta, "spec": spec}


def test_round_trip_fuzz_v1_and_v2(k):
    rng = random.Random(7)
    for i in range(200):
        data = _random_manifest(rng)
        pod = k.DEFAULT_SCHEME.decode(data)
        assert isinstance(pod, k.Pod)
        # v1 round trip
        assert k.DEFAULT_SCHEME.decode(
            k.DEFAULT_SCHEME.encode(pod, "v1", "Pod")) == pod, i
        # v2 round trip (rename hop both ways through internal)
        assert k.DEFAULT_SCHEME.decode(
            k.DEFAULT_SCHEME.encode(pod, "v2", "Pod")) == pod, i
        # versioned->versioned conversion is stable after the first hop
        v2 = k.DEFAULT_SCHEME.convert(data, "v2")
        v1b = k.DEFAULT_SCHEME.convert(v2, "v1")
        assert k.DEFAULT_SCHEME.convert(v1b, "v2") == v2, i


def test_generic_v1_codecs_cover_every_wire_kind(k):
    """The scheme serves a v1 codec for EVERY reflective wire kind, in
    both accepted manifest shapes, round-tripping losslessly."""
    for kind in k.KIND_REGISTRY:
        assert ("v1", kind) in k.DEFAULT_SCHEME.versions(), kind
    # flat native shape
    dep = k.DEFAULT_SCHEME.decode({
        "apiVersion": "v1", "kind": "Deployment",
        "name": "web", "replicas": 3})
    assert dep.name == "web" and dep.replicas == 3
    assert k.DEFAULT_SCHEME.decode(
        k.DEFAULT_SCHEME.encode(dep, "v1", "Deployment")) == dep
    # kubectl metadata/spec shape
    dep2 = k.DEFAULT_SCHEME.decode({
        "apiVersion": "v1", "kind": "Deployment",
        "metadata": {"name": "web", "namespace": "prod",
                     "labels": {"a": "b"}},
        "spec": {"replicas": 5}})
    assert dep2.namespace == "prod" and dep2.replicas == 5
    assert dep2.labels == {"a": "b"}


def test_node_capacity_reservation_round_trip(k):
    """A node publishing capacity != allocatable (node-allocatable
    reservation) keeps both through the codec."""
    node = k.make_node("n1", cpu=3500, memory=7 << 30)
    node.capacity = k.Resource(milli_cpu=4000, memory=8 << 30)
    enc = k.serde.encode_node(node)
    assert enc["status"]["capacity"]["cpu"] == "4000m"
    back = k.serde.decode_node(enc)
    assert back.allocatable.milli_cpu == 3500
    assert back.capacity.milli_cpu == 4000


# -------------------- tests/test_protowire.py


def _rand_cluster(k, seed=5, n_nodes=24, n_pods=40):
    rng = random.Random(seed)
    nodes = k.full_random_nodes(rng, n_nodes)
    pods = [k.full_random_pod(rng, i, [n.name for n in nodes])
            for i in range(n_pods)] + k._existing(rng, nodes, 10)
    return nodes, pods


@needs_protowire
def test_nodes_roundtrip_bitexact(k):
    nodes, _ = _rand_cluster(k)
    out = k.protowire.decode_nodes(k.protowire.encode_nodes(nodes))
    assert len(out) == len(nodes)
    for a, b in zip(nodes, out):
        assert a == b, f"node {a.name} diverged over the wire"


@needs_protowire
def test_pods_roundtrip_bitexact_scheduling_fields(k):
    _, pods = _rand_cluster(k)
    out = k.protowire.decode_pods(k.protowire.encode_pods(pods))
    assert len(out) == len(pods)
    for a, b in zip(pods, out):
        # scheduling-read surface must survive exactly (probes/status-only
        # fields are JSON-path; zero them for the comparison)
        import dataclasses
        strip = dict(resource_version=0, ready=True, restart_count=0,
                     restart_policy="Always", host_network=False,
                     security_context=None)
        ca = dataclasses.replace(a, **strip)
        cb = dataclasses.replace(b, **strip)
        for c in ca.containers + cb.containers:
            c.liveness_probe = c.readiness_probe = None
            c.security_context = None
        assert ca == cb, f"pod {a.key()} diverged over the wire"


@needs_protowire
def test_binary_payload_is_smaller_than_json(k):
    nodes, _ = _rand_cluster(k, n_nodes=200)
    binary = k.protowire.encode_nodes(nodes)
    as_json = json.dumps({"items": [k.serde.encode_node(n)
                                    for n in nodes]}).encode()
    assert len(binary) < len(as_json), (len(binary), len(as_json))


@needs_protowire
def test_extender_binary_sync_scheduling_equivalence(k):
    """Same cluster synced via JSON vs protobuf -> identical /filter and
    /prioritize answers for the same pod."""
    nodes, pods = _rand_cluster(k, seed=9, n_nodes=16, n_pods=0)
    bound = [p for p in pods if p.node_name]

    def serve(backend):
        srv = k.ExtenderHTTPServer(backend)
        srv.start()
        return srv

    # JSON path
    b_json = k.TPUExtenderBackend(**k.dev)
    srv_json = serve(b_json)
    # protobuf path
    b_pb = k.TPUExtenderBackend(**k.dev)
    srv_pb = serve(b_pb)
    try:
        url_json = f"http://127.0.0.1:{srv_json.port}"
        url_pb = f"http://127.0.0.1:{srv_pb.port}"
        body = json.dumps({"items": [k.serde.encode_node(n)
                                     for n in nodes]}).encode()
        req = urllib.request.Request(
            url_json + "/cache/nodes", data=body,
            headers={"Content-Type": "application/json"})
        assert json.loads(urllib.request.urlopen(req, timeout=30).read())[
            "synced"] == len(nodes)
        req = urllib.request.Request(
            url_pb + "/cache/nodes", data=k.protowire.encode_nodes(nodes),
            headers={"Content-Type": k.protowire.CONTENT_TYPE})
        assert json.loads(urllib.request.urlopen(req, timeout=30).read())[
            "synced"] == len(nodes)

        pod = k.make_pod("probe", cpu=100, node_selector={"disk": "ssd"})
        args = json.dumps({"Pod": k.serde.encode_pod(pod),
                           "NodeNames": [n.name for n in nodes]}).encode()

        def post(url, verb):
            r = urllib.request.Request(
                url + verb, data=args,
                headers={"Content-Type": "application/json"})
            return json.loads(urllib.request.urlopen(r, timeout=120).read())

        f_json = post(url_json, "/filter")
        f_pb = post(url_pb, "/filter")
        assert f_json["NodeNames"] == f_pb["NodeNames"]
        assert sorted(f_json["FailedNodes"]) == sorted(f_pb["FailedNodes"])
        p_json = post(url_json, "/prioritize")
        p_pb = post(url_pb, "/prioritize")
        assert p_json == p_pb
    finally:
        srv_json.stop()
        srv_pb.stop()


# -------------------- tests/test_serde_policy.py


def test_quantity_parsing(k):
    assert k.serde.quantity_milli("100m") == 100
    assert k.serde.quantity_milli("2") == 2000
    assert k.serde.quantity_milli("0.5") == 500
    assert k.serde.quantity_milli("2500m") == 2500
    assert k.serde.quantity_value("128Mi") == 128 * 1024 * 1024
    assert k.serde.quantity_value("1Gi") == 1024 ** 3
    assert k.serde.quantity_value("1G") == 10 ** 9
    assert k.serde.quantity_value("500k") == 500_000
    assert k.serde.quantity_value("1.5Gi") == 3 * 1024 ** 3 // 2
    assert k.serde.quantity_value("7") == 7
    # milli rounding is ceil (quantity.go ScaledValue rounds up)
    assert k.serde.quantity_milli("1m") == 1
    assert k.serde.quantity_value("100m") == 1


def test_decode_pod_full(k):
    pod = k.serde.decode_pod({
        "metadata": {"name": "web-1", "namespace": "prod", "uid": "u-1",
                     "labels": {"app": "web"},
                     "ownerReferences": [{"kind": "ReplicaSet", "name": "web",
                                          "controller": True}]},
        "spec": {
            "schedulerName": "default-scheduler",
            "nodeSelector": {"disk": "ssd"},
            "containers": [{
                "name": "c", "image": "nginx:1.13",
                "resources": {"requests": {"cpu": "250m", "memory": "64Mi",
                                           "nvidia.com/gpu": "1"}},
                "ports": [{"hostPort": 8080, "containerPort": 80}],
            }],
            "tolerations": [{"key": "dedicated", "operator": "Equal",
                             "value": "gpu", "effect": "NoSchedule"}],
            "affinity": {"nodeAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": {
                    "nodeSelectorTerms": [{"matchExpressions": [
                        {"key": "zone", "operator": "In", "values": ["a", "b"]}]}]},
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": 5, "preference": {"matchExpressions": [
                        {"key": "disk", "operator": "Exists"}]}}]}},
        },
    })
    assert pod.key() == "prod/web-1"
    req = pod.resource_request()
    assert req.milli_cpu == 250
    assert req.memory == 64 * 1024 * 1024
    assert req.nvidia_gpu == 1
    assert pod.used_ports() == [8080]
    assert pod.owner_kind == "ReplicaSet"
    assert pod.tolerations[0].effect == k.TaintEffect.NO_SCHEDULE
    na = pod.affinity.node_affinity
    assert na.required_terms[0].match_expressions[0].operator == k.SelectorOperator.IN
    assert na.preferred_terms[0][0] == 5


def test_decode_node_full(k):
    node = k.serde.decode_node({
        "metadata": {"name": "n1", "labels": {"zone": "a"}},
        "spec": {"unschedulable": False,
                 "taints": [{"key": "flaky", "value": "", "effect": "NoExecute"}]},
        "status": {
            "allocatable": {"cpu": "4", "memory": "32Gi", "pods": "110",
                            "nvidia.com/gpu": "2", "example.com/foo": "5"},
            "conditions": [{"type": "Ready", "status": "True"},
                           {"type": "MemoryPressure", "status": "False"}],
        },
    })
    assert node.allocatable.milli_cpu == 4000
    assert node.allocatable.memory == 32 * 1024 ** 3
    assert node.allocatable.nvidia_gpu == 2
    assert node.allocatable.extended == {"example.com/foo": 5}
    assert node.allowed_pod_number == 110
    assert node.taints[0].effect == k.TaintEffect.NO_EXECUTE
    assert node.is_ready()


def test_encode_decode_roundtrip(k):
    pod = k.make_pod("p", cpu=100, memory=1024 ** 3, ports=[80])
    pod2 = k.serde.decode_pod(k.serde.encode_pod(pod))
    assert pod2.resource_request().milli_cpu == 100
    assert pod2.used_ports() == [80]
    node = k.make_node("n", cpu=4000, gpu=2)
    node2 = k.serde.decode_node(k.serde.encode_node(node))
    assert node2.allocatable.milli_cpu == 4000
    assert node2.allocatable.nvidia_gpu == 2
    assert node2.is_ready()


POLICY_JSON = """{
  "kind": "Policy", "apiVersion": "v1",
  "predicates": [
    {"name": "PodFitsResources"},
    {"name": "TestLabelsPresence",
     "argument": {"labelsPresence": {"labels": ["foo"], "presence": true}}},
    {"name": "TestServiceAffinity",
     "argument": {"serviceAffinity": {"labels": ["region"]}}}
  ],
  "priorities": [
    {"name": "LeastRequestedPriority", "weight": 1},
    {"name": "TestServiceAntiAffinity", "weight": 3,
     "argument": {"serviceAntiAffinity": {"label": "zone"}}}
  ],
  "extenders": [
    {"urlPrefix": "http://127.0.0.1:9998/scheduler",
     "filterVerb": "filter", "prioritizeVerb": "prioritize",
     "weight": 5, "nodeCacheCapable": true, "enableHttps": false}
  ]
}"""


def test_policy_parse_reference_format(k):
    # shape mirrors the 1.7 Policy files in compatibility_test.go
    pol = k.parse_policy(POLICY_JSON)
    assert [p.name for p in pol.predicates] == [
        "PodFitsResources", "TestLabelsPresence", "TestServiceAffinity"]
    assert pol.predicates[1].labels_presence.labels == ["foo"]
    assert pol.predicates[2].service_affinity.labels == ["region"]
    assert pol.priorities[0].weight == 1
    assert pol.priorities[1].service_antiaffinity_label == "zone"
    ext = pol.extenders[0]
    assert ext.url_prefix.endswith("/scheduler")
    assert ext.filter_verb == "filter"
    assert ext.weight == 5
    assert ext.node_cache_capable
    assert ext.http_timeout_s == 5.0


def test_policy_empty_sections_distinguish_nil(k):
    # nil predicates -> provider defaults; empty list -> no predicates
    assert k.parse_policy("{}").predicates is None
    assert k.parse_policy('{"predicates": []}').predicates == []


def test_providers(k):
    dp = k.PROVIDERS["DefaultProvider"]["priorities"]
    ca = k.PROVIDERS["ClusterAutoscalerProvider"]["priorities"]
    assert ("LeastRequestedPriority", 1) in dp
    assert ("MostRequestedPriority", 1) in ca
    assert ("LeastRequestedPriority", 1) not in ca
    assert ("NodePreferAvoidPodsPriority", 10000) in dp


def test_decode_pod_owner_uid(k):
    # regression: uid drop silently disabled NodePreferAvoidPods matching
    pod = k.serde.decode_pod({
        "metadata": {"name": "p", "ownerReferences": [
            {"kind": "ReplicaSet", "name": "rs", "uid": "u-42",
             "controller": True}]},
        "spec": {"containers": []}})
    assert pod.owner_uid == "u-42"
    assert pod.owner_kind == "ReplicaSet"


# ------------------------------------------------ scheme (runtime.Scheme)


def test_scheme_scheduler_config_roundtrip_and_defaults(k):

    # defaults applied at decode (v1alpha1 defaults.go)
    cfg = k.DEFAULT_SCHEME.decode({
        "apiVersion": "componentconfig/v1alpha1",
        "kind": "KubeSchedulerConfiguration"})
    assert cfg.scheduler_name == "default-scheduler"
    assert cfg.leader_election.leader_elect is True
    assert cfg.leader_election.lease_duration_s == 15.0
    assert cfg.hard_pod_affinity_symmetric_weight == 1
    # explicit fields survive a versioned round-trip
    cfg2 = k.DEFAULT_SCHEME.decode({
        "apiVersion": "componentconfig/v1alpha1",
        "kind": "KubeSchedulerConfiguration",
        "schedulerName": "tpu-scheduler",
        "policyConfigFile": "/etc/policy.json",
        "featureGates": "PodPriority=true,AllAlpha=false",
        "leaderElection": {"leaseDuration": "1m30s",
                           "leaderElect": False}})
    assert cfg2.leader_election.lease_duration_s == 90.0
    assert cfg2.feature_gates == {"PodPriority": True, "AllAlpha": False}
    wire = k.DEFAULT_SCHEME.encode(cfg2, "componentconfig/v1alpha1",
                                 "KubeSchedulerConfiguration")
    assert wire["apiVersion"] == "componentconfig/v1alpha1"
    again = k.DEFAULT_SCHEME.decode(wire)
    assert again == cfg2
    # unknown version fails loudly
    import pytest as _pytest
    with _pytest.raises(k.SchemeError):
        k.DEFAULT_SCHEME.decode({"apiVersion": "componentconfig/v9",
                               "kind": "KubeSchedulerConfiguration"})
    # validation: the weight range check
    with _pytest.raises(k.SchemeError):
        k.DEFAULT_SCHEME.decode({
            "apiVersion": "componentconfig/v1alpha1",
            "kind": "KubeSchedulerConfiguration",
            "hardPodAffinitySymmetricWeight": 1000})


def test_scheme_duration_parsing(k):

    assert k._seconds("15s") == 15.0
    assert k._seconds("1m30s") == 90.0
    assert k._seconds("2h") == 7200.0
    assert k._seconds("250ms") == 0.25
    assert k._seconds(7) == 7.0
    import pytest as _pytest
    for bad in ("15", "s", "1x"):
        with _pytest.raises(k.SchemeError):
            k._seconds(bad)


def test_scheme_policy_v1_decodes_through_parser(k):

    pol = k.DEFAULT_SCHEME.decode({
        "apiVersion": "v1", "kind": "Policy",
        "predicates": [{"name": "PodFitsResources"}],
        "priorities": [{"name": "LeastRequestedPriority", "weight": 1}]})
    assert [p.name for p in pol.predicates] == ["PodFitsResources"]
    # the unversioned legacy shape (--use-legacy-policy-config) decodes too
    pol2 = k.DEFAULT_SCHEME.decode({
        "apiVersion": "", "kind": "Policy",
        "predicates": [{"name": "PodFitsHostPorts"}]})
    assert [p.name for p in pol2.predicates] == ["PodFitsHostPorts"]


# -------------------------------------------------------------- the harness


def _modules_of(obj, seen, memo):
    """The modules of the classes of `obj` and of everything it holds."""
    if id(obj) in memo or isinstance(obj, (str, bytes, int, float, bool,
                                           type(None))):
        return
    memo.add(id(obj))
    seen.add(type(obj).__module__)
    if isinstance(obj, dict):
        items = [v for kv in obj.items() for v in kv]
    elif isinstance(obj, (list, tuple, set, frozenset)):
        items = list(obj)
    else:
        items = list(getattr(obj, "__dict__", {}).values())
    for v in items:
        _modules_of(v, seen, memo)


def test_protowire_generators_build_the_ports_objects():
    """tests/test_protowire.py built on the port by the harness: the
    generators it imports from tests/test_full_fuzz.py are built on the
    port as well, so they make no object of the reference (the port's
    encoder checks its own enums), the module knows its own file, and
    its round trips hold on the port."""
    mod = reference_test_module("test_protowire", PORT)
    assert mod.__file__ == os.path.join(os.path.dirname(__file__),
                                        "test_protowire.py")
    nodes, pods = mod._rand_cluster()
    seen = set()
    _modules_of((nodes, pods), seen, set())
    assert not [m for m in seen if m.split(".")[0] == REF], sorted(seen)
    assert f"{PORT}.api.types" in seen, sorted(seen)
    mod.test_nodes_roundtrip_bitexact()
    mod.test_pods_roundtrip_bitexact_scheduling_fields()
