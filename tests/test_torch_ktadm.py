"""The port's bootstrap tool (cli/ktadm.py) against the reference's, and
the cluster in a box on the port. The bodies of tests/test_ktadm.py run on
both packages (the `k` fixture): init's phases and artifacts, preflight,
the bootstrap-token join (CSR, approval, signed identity), token expiry,
the static manifests, the kubeconfig, and ktctl's custom columns,
jsonpath and sort-by. tests/test_e2e_cluster.py's scenario (ktadm init,
two joins, the Deployment and ReplicaSet controllers, the scheduler, the
hollow kubelets, then ktctl apply, get, logs, scale and delete) runs once
in each package, its reference assertions inline, with the port's
Scheduler on the CPU; the two outcomes (pods, nodes and phases, ktctl's
printed text, the pods left after the scale) must be equal."""

import io
import os

import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "api_types": "api.types",
    "api_workloads": "api.workloads",
    "auth_authn": "auth.authn",
    "auth_authz": "auth.authz",
    "cli_ktadm": "cli.ktadm",
    "cli_ktctl": "cli.ktctl",
    "cli_rest_client": "cli.rest_client",
    "client_informer": "client.informer",
    "controllers_deployment": "controllers.deployment",
    "controllers_replicaset": "controllers.replicaset",
    "engine_scheduler": "engine.scheduler",
    "nodes_kubelet": "nodes.kubelet",
    "server_apiserver": "server.apiserver",
    "server_apiserver_lite": "server.apiserver_lite",
    "server_rest_http": "server.rest_http",
    "utils_metrics": "utils.metrics",
}

PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}
DEVICE = {REF: {}, PORT: {"device": "cpu"}}

Mi = 1 << 20
Gi = 1 << 30


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


def init_cluster(k, tmp_path, now=None):
    out = io.StringIO()
    adm = k.KtAdm(out=out, **({"now": now} if now else {}))
    res = adm.init(str(tmp_path / "kt"))
    return adm, res, out


def test_init_phases_and_artifacts(k, tmp_path):
    adm, res, out = init_cluster(k, tmp_path)
    wd = res.workdir
    assert os.path.exists(os.path.join(wd, "pki", "ca.key"))
    for comp in ("admin", "controller-manager", "scheduler"):
        assert os.path.exists(os.path.join(wd, comp + ".conf"))
    manifests = sorted(os.listdir(os.path.join(wd, "manifests")))
    assert manifests == ["kube-apiserver.json",
                        "kube-controller-manager.json",
                        "kube-scheduler.json"]
    assert "initialized successfully" in out.getvalue()
    # the admin credential really is cluster-admin through the chain
    res.api.create("Namespace", k.Namespace("prod"), cred=res.admin_cred)
    # an anonymous request is rejected
    with pytest.raises(k.Unauthenticated):
        res.api.list("Pod", cred=None)


def test_preflight_rejects_second_init(k, tmp_path):
    adm, res, _ = init_cluster(k, tmp_path)
    adm2 = k.KtAdm(out=io.StringIO())
    with pytest.raises(SystemExit):
        adm2.init(res.workdir)
    # reset clears the artifacts; init works again
    adm2.reset(res.workdir)
    adm2.init(res.workdir)


def test_token_join_flow(k, tmp_path):
    adm, res, _ = init_cluster(k, tmp_path)
    node_cred = adm.join(res, "worker-1", res.token,
                         ca_cert_hash=k.ca_hash(res.ca_key))
    node = res.api.get("Node", "", "worker-1", cred=res.admin_cred)
    assert node.name == "worker-1"
    # the issued identity is the node's own (system:node:worker-1) —
    # NodeRestriction-scoped, not admin: it cannot delete other nodes
    res.api.list("Node", cred=node_cred)
    with pytest.raises(k.Forbidden):
        res.api.create("Namespace", k.Namespace("x"), cred=node_cred)


def test_join_stops_its_informers(tmp_path):
    """The port's join stops the CSR informers it started; the
    reference's leaves one polling thread behind per join (a departure
    of the port, result-equal: the join's outcome is the case above)."""
    import threading

    def csr_informers():
        return sum(t.name == "informer-CertificateSigningRequest"
                   for t in threading.enumerate())

    for root, leaked in ((PORT, 0), (REF, 2)):
        k = PKGS[root]
        before = csr_informers()
        (tmp_path / root).mkdir()
        adm, res, _ = init_cluster(k, tmp_path / root)
        for i in range(2):
            adm.join(res, f"worker-{i}", res.token,
                     ca_cert_hash=k.ca_hash(res.ca_key))
        assert csr_informers() - before == leaked, root


def test_join_rejects_bad_token_and_bad_ca_hash(k, tmp_path):
    adm, res, _ = init_cluster(k, tmp_path)
    with pytest.raises(k.Unauthenticated):
        adm.join(res, "w", "aaaaaa.bbbbbbbbbbbbbbbb")
    with pytest.raises(SystemExit, match="MITM"):
        adm.join(res, "w", res.token, ca_cert_hash="sha256:deadbeef")


def test_token_expiry_and_lifecycle(k, tmp_path):
    t = [2_000_000_000.0]
    adm, res, out = init_cluster(k, tmp_path, now=lambda: t[0])
    assert adm.token_list(res)  # the init token
    tok2 = adm.token_create(res, ttl=60.0)
    assert len(adm.token_list(res)) == 2
    # expiry: advance past ttl; the token no longer authenticates
    t[0] += 3600.0
    with pytest.raises(k.Unauthenticated):
        adm.join(res, "w", tok2)
    # delete the init token
    tid = res.token.split(".")[0]
    adm.token_delete(res, tid)
    with pytest.raises(SystemExit):
        adm.token_delete(res, tid)


def test_static_manifests_feed_kubelet_file_source(k, tmp_path):

    adm, res, _ = init_cluster(k, tmp_path)
    api = k.ApiServerLite()
    node = k.make_node("cp-1", cpu=8000, memory=1 << 34)
    api.create("Node", node)
    kubelet = k.HollowKubelet(api, node)
    n = kubelet.load_static_dir(os.path.join(res.workdir, "manifests"))
    assert n == 3
    kubelet.workers.drain()
    # mirror pods surfaced on the apiserver
    mirrors = [p for p in api.list("Pod")[0]
               if p.namespace == "kube-system"]
    assert {p.name for p in mirrors} == {
        "kube-apiserver", "kube-controller-manager", "kube-scheduler"}


def test_generate_token_format(k):
    tok = k.generate_token()
    tid, _, sec = tok.partition(".")
    assert len(tid) == 6 and len(sec) == 16
    assert tok == tok.lower()


# ------------------------------------------------- printers (pkg/printers)


def _cli_with_nodes(k):
    import io

    api = k.ApiServer()
    api.store.create("Namespace", k.Namespace("default"))
    for name, cpu in (("n-b", 2000), ("n-a", 4000), ("n-c", 1000)):
        api.store.create("Node", k.make_node(name, cpu=cpu, memory=1 << 31))
    out = io.StringIO()
    return k.Ktctl(api, out=out), out


def test_custom_columns_output(k):
    kt, out = _cli_with_nodes(k)
    assert kt.run(["get", "nodes", "-o",
                   "custom-columns=NAME:.name,CPU:.allocatable.milli_cpu"
                   ]) == 0
    text = out.getvalue()
    lines = text.strip().splitlines()
    assert lines[0].split() == ["NAME", "CPU"]
    assert any(ln.split() == ["n-a", "4000"] for ln in lines)


def test_jsonpath_output(k):
    kt, out = _cli_with_nodes(k)
    assert kt.run(["get", "nodes", "-o",
                   "jsonpath={.items[*].name}"]) == 0
    assert set(out.getvalue().split()) == {"n-a", "n-b", "n-c"}
    out.truncate(0), out.seek(0)
    assert kt.run(["get", "nodes", "-o",
                   "jsonpath={.items[0].allocatable.milli_cpu}"]) == 0
    assert out.getvalue().strip() in {"1000", "2000", "4000"}


def test_sort_by_orders_rows(k):
    kt, out = _cli_with_nodes(k)
    assert kt.run(["get", "nodes", "--sort-by",
                   "{.allocatable.milli_cpu}", "-o",
                   "custom-columns=NAME:.name"]) == 0
    names = [ln.strip() for ln in out.getvalue().strip().splitlines()[1:]]
    assert names == ["n-c", "n-b", "n-a"]


def test_ktctl_with_admin_kubeconfig_against_secure_cluster(k, tmp_path):

    adm, res, _ = init_cluster(k, tmp_path)
    adm.join(res, "worker-1", res.token)
    out = io.StringIO()
    # kubeconfig written by phase_kubeconfig carries the admin identity
    kt = k.Ktctl(res.api, out=out,
                 kubeconfig=os.path.join(res.workdir, "admin.conf"))
    assert kt.run(["get", "nodes"]) == 0
    assert "worker-1" in out.getvalue()
    # a credential-less ktctl against the same secure cluster fails closed
    kt_anon = k.Ktctl(res.api, out=io.StringIO())
    with pytest.raises(k.Unauthenticated):
        kt_anon.run(["get", "nodes"])


def test_sort_by_numeric_not_lexicographic(k):
    import io

    api = k.ApiServer()
    api.store.create("Namespace", k.Namespace("default"))
    # 900 vs 1000: lexicographic would put "1000" first
    for name, cpu in (("big", 1000), ("small", 900)):
        api.store.create("Node", k.make_node(name, cpu=cpu, memory=1 << 31))
    out = io.StringIO()
    kt = k.Ktctl(api, out=out)
    assert kt.run(["get", "nodes", "--sort-by",
                   "{.allocatable.milli_cpu}", "-o",
                   "custom-columns=NAME:.name"]) == 0
    names = [ln.strip() for ln in out.getvalue().strip().splitlines()[1:]]
    assert names == ["small", "big"]


def test_unsupported_jsonpath_fails_cleanly(k):
    kt, out = _cli_with_nodes(k)
    # filter expressions are outside the subset: clean error, rc=1
    assert kt.run(["get", "nodes", "-o",
                   "jsonpath={.items[?(@.ready)].name}"]) == 1
    assert "unsupported jsonpath" in out.getvalue()


def test_kubeconfig_with_rest_client_does_not_crash(k, tmp_path):

    adm, res, _ = init_cluster(k, tmp_path)
    # RestClient authenticates at the transport; the kubeconfig cred must
    # NOT be partial-applied onto its verbs (they take no cred kwarg)
    srv = k.RestServer(res.api)
    srv.start()
    try:
        client = k.RestClient(f"http://127.0.0.1:{srv.port}")
        kt = k.Ktctl(client, out=io.StringIO(),
                     kubeconfig=os.path.join(res.workdir, "admin.conf"))
        # auth=True without a transport token -> the 401 surfaces as a
        # clean CLI error (rc=1), never a TypeError from cred kwargs
        out = io.StringIO()
        kt.out = out
        assert kt.run(["get", "nodes"]) == 1
        assert "401" in out.getvalue()
    finally:
        srv.stop()


# ============================================================
# the cluster in a box


def _cluster_in_a_box(k, tmp_path):
    """tests/test_e2e_cluster.py's scenario with its assertions; returns
    what the two packages must agree on."""
    seen = {}
    # ---- control plane bootstrap (ktadm init) --------------------------
    adm = k.KtAdm(out=io.StringIO())
    cluster = adm.init(str(tmp_path / "cluster"))
    api = cluster.api

    # ---- two workers join over the bootstrap-token flow ----------------
    kubelets = {}
    for i in range(2):
        name = f"worker-{i}"
        cred = adm.join(cluster, name, cluster.token,
                        ca_cert_hash=k.ca_hash(cluster.ca_key))
        node = api.get("Node", "", name, cred=cluster.admin_cred)
        kubelets[name] = k.HollowKubelet(api.store, node)

    # ---- controllers + scheduler against the same store ----------------
    factory = k.SharedInformerFactory(api.store)
    dep_ctrl = k.DeploymentController(api.store, factory,
                                      record_events=False)
    rs_ctrl = k.ReplicaSetController(api.store, factory,
                                     record_events=False)
    # the informers are stepped by hand before every pump (no
    # factory.start()): their threads would race the pumps, and which pods
    # a ReplicaSet stamps would then depend on the host's load
    sched = k.Scheduler(api.store, **DEVICE[k.root])
    sched.start()

    # warm the placement kernels at every batch-size bucket the
    # deployment's rounds can hit (1..4 pods round up to buckets 1/2/4),
    # then reset the metrics: the SLO below is measured the way the
    # reference measures it — dedicated latency pods against a RUNNING
    # cluster (metrics_util.go:389-396), never the first-ever compile
    # warmup pods carry the SAME label pair the measured deployment's pods
    # will (app=web): a fresh pair would grow the snapshot label vocab at
    # measure time and trigger a recompile inside the SLO window
    for burst in (1, 2, 4):
        for i in range(burst):
            # both label pairs the test will use later stay in-vocab
            app = "web" if i % 2 == 0 else "latency"
            api.store.create("Pod", k.make_pod(f"warmup-{burst}-{i}", cpu=1,
                                               labels={"app": app}))
        sched.run_until_drained()
        for i in range(burst):
            api.store.delete("Pod", "default", f"warmup-{burst}-{i}")
    sched.run_until_drained()  # drain the deletion events
    sched.metrics = k.SchedulerMetrics()

    # ---- user: apply a Deployment manifest through ktctl ---------------
    out = io.StringIO()
    kt = k.Ktctl(api, out=out, cred=cluster.admin_cred, kubelets=kubelets)
    manifest = tmp_path / "web.yaml"
    manifest.write_text("""
kind: Deployment
name: web
namespace: default
replicas: 4
selector:
  match_labels: {app: web}
template:
  name: ""
  namespace: default
  labels: {app: web}
  containers:
  - name: app
    requests: {cpu: 100, memory: 1048576}
  annotations:
    bench/log-lines: "booting\\nserving"
""")
    assert kt.run(["apply", "-f", str(manifest)]) == 0

    # ---- converge: controllers stamp pods, scheduler binds, kubelets run
    for _ in range(10):
        factory.step_all()
        dep_ctrl.pump()
        rs_ctrl.pump()
        sched.run_until_drained()
        for name, kl in kubelets.items():
            for p in api.store.list("Pod")[0]:
                if p.node_name == name:
                    kl.handle_pod(p)
            kl.workers.drain()
            kl.step()
        pods = [p for p in api.store.list("Pod")[0]
                if p.labels.get("app") == "web"]
        if len(pods) == 4 and all(p.node_name for p in pods):
            break
    pods = [p for p in api.store.list("Pod")[0]
            if p.labels.get("app") == "web"]
    assert len(pods) == 4
    assert all(p.node_name in kubelets for p in pods)
    # spread across both workers (SelectorSpread at work)
    assert len({p.node_name for p in pods}) == 2
    seen["web"] = sorted(
        (p.name, p.node_name, api.store.get("Pod", p.namespace, p.name).phase)
        for p in pods)

    # ---- pod-startup SLO (e2e framework metrics_util.go:46,389-396:
    # p99 pod startup <= 5s), measured the way the reference measures it:
    # DEDICATED latency pods against the now-fully-RUNNING cluster (the
    # first deployment warmed every shape, including the RS-workload-
    # dependent spread arrays the scheduler first saw with it — a compile
    # inside the SLO window would measure the compiler, not the cluster)
    assert all(api.store.get("Pod", p.namespace, p.name).phase == "Running"
               for p in pods)
    sched.metrics = k.SchedulerMetrics()
    manifest2 = tmp_path / "latency.yaml"
    manifest2.write_text("""
kind: Deployment
name: latency
namespace: default
replicas: 4
selector:
  match_labels: {app: latency}
template:
  name: ""
  namespace: default
  labels: {app: latency}
  containers:
  - name: app
    requests: {cpu: 100, memory: 1048576}
""")
    assert kt.run(["apply", "-f", str(manifest2)]) == 0
    for _ in range(10):
        factory.step_all()
        dep_ctrl.pump()
        rs_ctrl.pump()
        sched.run_until_drained()
        if sched.metrics.create_to_bound.count >= 4:
            break
    c2b = sched.metrics.create_to_bound
    assert c2b.count >= 4
    assert c2b.percentile(99) <= 5.0
    assert kt.run(["delete", "deploy", "latency"]) == 0
    for _ in range(10):
        factory.step_all()
        dep_ctrl.pump()
        rs_ctrl.pump()
        if not [p for p in api.store.list("Pod")[0]
                if p.owner_name.startswith("latency") and not p.deleted]:
            break

    # ---- user: get with selectors, logs via the kubelet API ------------
    out.truncate(0), out.seek(0)
    assert kt.run(["get", "pods", "-l", "app=web", "-o", "name"]) == 0
    assert len(out.getvalue().split()) == 4
    seen["get"] = out.getvalue()
    out.truncate(0), out.seek(0)
    assert kt.run(["logs", pods[0].name, "--tail", "1"]) == 0
    assert out.getvalue().strip() == "serving"
    seen["logs"] = out.getvalue()

    # ---- user: scale down; the stack converges again -------------------
    assert kt.run(["scale", "deploy", "web", "--replicas", "1"]) == 0
    for _ in range(10):
        factory.step_all()
        dep_ctrl.pump()
        rs_ctrl.pump()
        sched.run_until_drained()
        alive = [p for p in api.store.list("Pod")[0]
                 if p.labels.get("app") == "web" and not p.deleted]
        if len(alive) == 1:
            break
    assert len([p for p in api.store.list("Pod")[0]
                if p.labels.get("app") == "web" and not p.deleted]) == 1
    seen["scaled"] = sorted((p.name, p.node_name)
                            for p in api.store.list("Pod")[0]
                            if p.labels.get("app") == "web"
                            and not p.deleted)

    # ---- teardown: delete through the CLI; everything drains -----------
    assert kt.run(["delete", "deploy", "web"]) == 0
    for _ in range(10):
        factory.step_all()
        dep_ctrl.pump()
        rs_ctrl.pump()
        if not [p for p in api.store.list("Pod")[0]
                if p.labels.get("app") == "web" and not p.deleted]:
            break
    # the audit trail saw the whole session under real identities
    assert any(e.user == "kubernetes-admin" for e in api.audit_log)
    seen["left"] = sorted(p.name for p in api.store.list("Pod")[0]
                          if p.labels.get("app") == "web"
                          and not p.deleted)
    seen["deployments"] = sorted(d.name for d in
                                 api.store.list("Deployment")[0])
    return seen


@pytest.fixture(scope="module")
def boxes(tmp_path_factory):
    """The scenario once in each package."""
    return {root: _cluster_in_a_box(PKGS[root],
                                    tmp_path_factory.mktemp(root))
            for root in (REF, PORT)}


def test_cluster_in_a_box(k, boxes):
    seen = boxes[k.root]
    assert len(seen["web"]) == 4
    assert {phase for _, _, phase in seen["web"]} == {"Running"}
    assert seen["logs"].strip() == "serving"
    assert len(seen["scaled"]) == 1
    assert seen["deployments"] == []


def test_cluster_in_a_box_equal_in_both_packages(boxes):
    assert boxes[PORT] == boxes[REF]
