"""The port's controller manager (controllers/) against the reference's.
The bodies of tests/test_controllers.py and tests/test_controllers_extra.py
run on both packages (the `k` fixture, deterministic pump mode): the
ReplicaSet, Deployment, Job, DaemonSet, StatefulSet, Endpoints, GC,
PodGC and Namespace controllers, the threaded manager, then quota,
service accounts, TTL, bootstrap tokens, HPA, PDB, CronJob, the
cloud-facing controllers and CSR signing. Last, one scripted world
(Deployments, a ReplicaSet, a DaemonSet, a Job, a Namespace, PVs and
claims) pumped to stability in both packages must leave the two stores
holding equal objects, compared as wire JSON (api/wire), exactly."""

from __future__ import annotations

import dataclasses
import json

import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "api_cluster": "api.cluster",
    "api_types": "api.types",
    "api_workloads": "api.workloads",
    "auth_authn": "auth.authn",
    "cloud": "cloud",
    "controllers_autoscale": "controllers.autoscale",
    "controllers_manager": "controllers.manager",
    "controllers_namespace": "controllers.namespace",
    "server_apiserver_lite": "server.apiserver_lite",
    "wire": "api.wire",
    "hollow": "models.hollow",
}

PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}

Mi = 1024 * 1024


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


def mk_template(k, labels):
    return dataclasses.replace(k.make_pod("", labels=dict(labels), cpu=100), name="")


def mk_manager(k, **kw):
    api = k.ApiServerLite()
    cm = k.ControllerManager(api, record_events=False, **kw)
    return api, cm


def pods_of(api, ns="default"):
    return [p for p in api.list("Pod")[0] if p.namespace == ns]


def set_phase(api, pod, phase, node="n1"):
    fresh = api.get("Pod", pod.namespace, pod.name)
    api.update("Pod", dataclasses.replace(fresh, phase=phase,
                                          node_name=fresh.node_name or node))


def test_replicaset_scales_up_and_down(k):
    api, cm = mk_manager(k)
    rs = k.ReplicaSet(name="web", replicas=3,
                    selector=k.LabelSelector(match_labels={"app": "web"}),
                    template=mk_template(k, {"app": "web"}))
    api.create("ReplicaSet", rs)
    cm.pump_until_stable()
    assert len(pods_of(api)) == 3
    got = api.get("ReplicaSet", "default", "web")
    assert got.observed_replicas == 3
    # scale down to 1
    api.update("ReplicaSet", dataclasses.replace(got, replicas=1))
    cm.pump_until_stable()
    assert len(pods_of(api)) == 1


def test_replicaset_replaces_failed_pod_and_reports_ready(k):
    api, cm = mk_manager(k)
    rs = k.ReplicaSet(name="web", replicas=2,
                    selector=k.LabelSelector(match_labels={"app": "web"}),
                    template=mk_template(k, {"app": "web"}))
    api.create("ReplicaSet", rs)
    cm.pump_until_stable()
    p0, p1 = pods_of(api)
    set_phase(api, p0, "Running")
    set_phase(api, p1, "Failed")
    cm.pump_until_stable()
    live = [p for p in pods_of(api) if p.phase != "Failed"]
    assert len(live) == 2  # failed pod replaced
    assert api.get("ReplicaSet", "default", "web").ready_replicas == 1


def test_replicaset_adopts_matching_orphan(k):
    api, cm = mk_manager(k)
    api.create("Pod", k.make_pod("orphan", labels={"app": "web"}))
    rs = k.ReplicaSet(name="web", replicas=1,
                    selector=k.LabelSelector(match_labels={"app": "web"}),
                    template=mk_template(k, {"app": "web"}))
    api.create("ReplicaSet", rs)
    cm.pump_until_stable()
    pods = pods_of(api)
    assert len(pods) == 1 and pods[0].name == "orphan"
    assert pods[0].owner_kind == "ReplicaSet"


def test_deployment_creates_rs_and_rolls_template(k):
    api, cm = mk_manager(k)
    dep = k.Deployment(name="api", replicas=3,
                     selector=k.LabelSelector(match_labels={"app": "api"}),
                     template=mk_template(k, {"app": "api"}),
                     max_surge=1, max_unavailable=1)
    api.create("Deployment", dep)
    cm.pump_until_stable()
    rses = api.list("ReplicaSet")[0]
    assert len(rses) == 1 and rses[0].replicas == 3
    assert rses[0].owner_kind == "Deployment"
    # pods ready
    for p in pods_of(api):
        set_phase(api, p, "Running")
    cm.pump_until_stable()
    assert api.get("Deployment", "default", "api").ready_replicas == 3

    # roll: change the template (new image -> new hash)
    fresh = api.get("Deployment", "default", "api")
    new_tpl = dataclasses.replace(fresh.template)
    new_tpl.containers = [dataclasses.replace(new_tpl.containers[0], image="v2")] \
        if new_tpl.containers else []
    new_tpl = dataclasses.replace(new_tpl, annotations={"rev": "2"})
    api.update("Deployment", dataclasses.replace(fresh, template=new_tpl))
    for _ in range(10):  # drive the rollout, marking new pods ready as they come
        cm.pump_until_stable()
        for p in pods_of(api):
            if p.phase != "Running":
                set_phase(api, p, "Running")
    cm.pump_until_stable()
    rses = api.list("ReplicaSet")[0]
    by_replicas = sorted(rses, key=lambda r: r.replicas)
    assert len(rses) == 2
    assert by_replicas[0].replicas == 0  # old RS fully drained
    assert by_replicas[1].replicas == 3  # new RS at target
    dep_now = api.get("Deployment", "default", "api")
    assert dep_now.revision == 2 and dep_now.updated_replicas == 3


def test_deployment_scale_down_shrinks_new_rs(k):
    api, cm = mk_manager(k)
    dep = k.Deployment(name="api", replicas=5,
                     selector=k.LabelSelector(match_labels={"app": "api"}),
                     template=mk_template(k, {"app": "api"}))
    api.create("Deployment", dep)
    cm.pump_until_stable()
    assert len(pods_of(api)) == 5
    fresh = api.get("Deployment", "default", "api")
    api.update("Deployment", dataclasses.replace(fresh, replicas=3))
    cm.pump_until_stable()
    assert len(pods_of(api)) == 3
    assert api.list("ReplicaSet")[0][0].replicas == 3


def test_replicaset_selector_template_mismatch_stops_not_loops(k):
    api, cm = mk_manager(k)
    rs = k.ReplicaSet(name="bad", replicas=3,
                    selector=k.LabelSelector(match_labels={"app": "web"}),
                    template=mk_template(k, {"app": "api"}))  # mismatched
    api.create("ReplicaSet", rs)
    cm.pump_until_stable()
    assert pods_of(api) == []  # no unbounded creation


def test_endpoints_drop_pod_relabeled_out_of_selector(k):
    api, cm = mk_manager(k)
    api.create("Service", k.Service(name="svc", selector={"app": "web"}))
    api.create("Pod", dataclasses.replace(
        k.make_pod("w1", labels={"app": "web"}, node_name="n1"), phase="Running"))
    cm.pump_until_stable()
    assert [a.pod_key for a in api.get("Endpoints", "default", "svc").addresses] \
        == ["default/w1"]
    p = api.get("Pod", "default", "w1")
    api.update("Pod", dataclasses.replace(p, labels={"app": "db"}))
    cm.pump_until_stable()
    assert api.get("Endpoints", "default", "svc").addresses == []


def test_job_runs_to_completion(k):
    api, cm = mk_manager(k)
    job = k.Job(name="calc", completions=3, parallelism=2,
              template=dataclasses.replace(mk_template(k, {"job": "calc"}),
                                           restart_policy="Never"))
    api.create("Job", job)
    cm.pump_until_stable()
    assert len(pods_of(api)) == 2  # parallelism cap
    for p in pods_of(api):
        set_phase(api, p, "Succeeded")
    cm.pump_until_stable()
    # 2 done, 1 to go -> one more pod
    active = [p for p in pods_of(api) if p.phase == "Pending"]
    assert len(active) == 1
    set_phase(api, active[0], "Succeeded")
    cm.pump_until_stable()
    got = api.get("Job", "default", "calc")
    assert got.complete and got.succeeded == 3 and got.active == 0


def test_daemonset_one_pod_per_eligible_node(k):
    api, cm = mk_manager(k)
    for i in range(3):
        api.create("Node", k.make_node(f"n{i}"))
    api.create("Node", k.make_node("cordoned", ready=False))
    ds = k.DaemonSet(name="agent",
                   selector=k.LabelSelector(match_labels={"ds": "agent"}),
                   template=mk_template(k, {"ds": "agent"}))
    api.create("DaemonSet", ds)
    cm.pump_until_stable()
    pods = pods_of(api)
    assert {p.node_name for p in pods} == {"n0", "n1", "n2"}  # direct binding
    got = api.get("DaemonSet", "default", "agent")
    assert got.desired_scheduled == 3 and got.current_scheduled == 3
    # node joins -> pod appears
    api.create("Node", k.make_node("n3"))
    cm.pump_until_stable()
    assert {p.node_name for p in pods_of(api)} == {"n0", "n1", "n2", "n3"}


def test_statefulset_ordered_creation_and_reverse_scale_down(k):
    api, cm = mk_manager(k)
    ss = k.StatefulSet(name="db", replicas=3,
                     selector=k.LabelSelector(match_labels={"ss": "db"}),
                     template=mk_template(k, {"ss": "db"}))
    api.create("StatefulSet", ss)
    cm.pump_until_stable()
    assert [p.name for p in pods_of(api)] == ["db-0"]  # strict ordering
    set_phase(api, pods_of(api)[0], "Running")
    cm.pump_until_stable()
    names = sorted(p.name for p in pods_of(api))
    assert names == ["db-0", "db-1"]
    for p in pods_of(api):
        if p.phase != "Running":
            set_phase(api, p, "Running")
    cm.pump_until_stable()
    assert sorted(p.name for p in pods_of(api)) == ["db-0", "db-1", "db-2"]
    # scale to 1: highest ordinals go first
    fresh = api.get("StatefulSet", "default", "db")
    api.update("StatefulSet", dataclasses.replace(fresh, replicas=1))
    cm.pump_until_stable()
    assert sorted(p.name for p in pods_of(api)) == ["db-0"]


def test_endpoints_track_ready_pods(k):
    api, cm = mk_manager(k)
    api.create("Service", k.Service(name="svc", selector={"app": "web"}))
    api.create("Pod", k.make_pod("w1", labels={"app": "web"}, node_name="n1"))
    api.create("Pod", k.make_pod("w2", labels={"app": "web"}, node_name="n2"))
    api.create("Pod", k.make_pod("other", labels={"app": "db"}, node_name="n1"))
    cm.pump_until_stable()
    eps = api.get("Endpoints", "default", "svc")
    assert eps.addresses == []  # none Running yet
    for name in ("w1", "w2"):
        p = api.get("Pod", "default", name)
        api.update("Pod", dataclasses.replace(p, phase="Running"))
    cm.pump_until_stable()
    eps = api.get("Endpoints", "default", "svc")
    assert sorted(a.pod_key for a in eps.addresses) == ["default/w1", "default/w2"]
    # pod dies -> address removed
    api.delete("Pod", "default", "w1")
    cm.pump_until_stable()
    eps = api.get("Endpoints", "default", "svc")
    assert [a.pod_key for a in eps.addresses] == ["default/w2"]


def test_gc_cascade_on_owner_delete(k):
    api, cm = mk_manager(k)
    dep = k.Deployment(name="api", replicas=2,
                     selector=k.LabelSelector(match_labels={"app": "api"}),
                     template=mk_template(k, {"app": "api"}))
    api.create("Deployment", dep)
    cm.pump_until_stable()
    assert len(pods_of(api)) == 2
    api.delete("Deployment", "default", "api")
    cm.pump_until_stable()
    assert api.list("ReplicaSet")[0] == []  # RS collected
    assert pods_of(api) == []  # pods collected transitively


def test_podgc_reaps_pods_on_vanished_nodes_and_terminated_excess(k):
    api, cm = mk_manager(k)
    cm.controllers["podgc"].terminated_threshold = 1
    api.create("Node", k.make_node("n1"))
    api.create("Pod", k.make_pod("on-gone-node", node_name="ghost"))
    api.create("Pod", dataclasses.replace(k.make_pod("done1"), phase="Succeeded"))
    api.create("Pod", dataclasses.replace(k.make_pod("done2"), phase="Succeeded"))
    cm.pump_until_stable()
    cm.controllers["podgc"].resync()
    cm.pump_until_stable()
    names = {p.name for p in pods_of(api)}
    assert "on-gone-node" not in names
    assert names == {"done2"}  # oldest terminated reaped down to threshold


def test_namespace_lifecycle_deletes_contents(k):
    api, cm = mk_manager(k)
    api.create("Namespace", k.Namespace(name="team-a"))
    api.create("Pod", k.make_pod("p1", namespace="team-a"))
    api.create("Service", k.Service(name="s1", namespace="team-a"))
    api.create("Pod", k.make_pod("keep", namespace="default"))
    cm.pump_until_stable()
    k.delete_namespace(api, "team-a")
    cm.pump_until_stable()
    assert all(p.namespace != "team-a" for p in api.list("Pod")[0])
    assert api.list("Service")[0] == []
    assert [p.name for p in api.list("Pod")[0]] == ["keep"]
    import pytest
    with pytest.raises(k.NotFound):
        api.get("Namespace", "", "team-a")


def test_controller_manager_threaded_converges(k):
    api = k.ApiServerLite()
    cm = k.ControllerManager(api, record_events=False)
    rs = k.ReplicaSet(name="web", replicas=5,
                    selector=k.LabelSelector(match_labels={"app": "web"}),
                    template=mk_template(k, {"app": "web"}))
    api.create("ReplicaSet", rs)
    cm.start(workers=2, poll=0.005)
    import time
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if len(pods_of(api)) == 5:
            break
        time.sleep(0.02)
    cm.stop()
    assert len(pods_of(api)) == 5


def test_resource_quota_recomputed_from_live_objects(k):
    api, cm = mk_manager(k)
    api.create("ResourceQuota", k.ResourceQuota(
        "q", "default", hard={"pods": 10, "requests.cpu": 10_000}))
    api.create("Pod", k.make_pod("a", cpu=300, memory=Mi))
    api.create("Pod", k.make_pod("b", cpu=200, memory=Mi))
    cm.pump_until_stable()
    q = api.get("ResourceQuota", "default", "q")
    assert q.used == {"pods": 2, "requests.cpu": 500}
    api.delete("Pod", "default", "a")
    cm.pump_until_stable()
    q = api.get("ResourceQuota", "default", "q")
    assert q.used == {"pods": 1, "requests.cpu": 200}


def test_default_service_account_and_token_created(k):
    api, cm = mk_manager(k)
    api.create("Namespace", k.Namespace("team-a"))
    cm.pump_until_stable()
    sa = api.get("ServiceAccount", "team-a", "default")
    assert "default-token" in sa.secrets
    secret = api.get("Secret", "team-a", "default-token")
    assert secret.type == "kubernetes.io/service-account-token"
    assert secret.data["token"]


def test_ttl_annotation_follows_cluster_size(k):
    api, cm = mk_manager(k)
    for i in range(3):
        api.create("Node", k.make_node(f"n{i}"))
    cm.pump_until_stable()
    n = api.get("Node", "", "n0")
    assert n.annotations["node.alpha.kubernetes.io/ttl"] == "0"
    ttl = cm.controllers["ttl"]
    assert ttl.desired_ttl(400) == 15
    assert ttl.desired_ttl(1500) == 60
    assert ttl.desired_ttl(9999) == 300


def test_bootstrap_signer_and_token_cleaner(k):
    clock = [100.0]
    api = k.ApiServerLite()
    cm = k.ControllerManager(api, record_events=False)
    cm.controllers["tokencleaner"]._now = lambda: clock[0]

    api.create("ConfigMap", k.ConfigMap("cluster-info", namespace="kube-public",
                                      data={"kubeconfig": "clusters: []"}))
    api.create("Secret", k.Secret(
        "bootstrap-token-abc123", namespace="kube-system",
        type="bootstrap.kubernetes.io/token",
        data={"token-id": "abc123", "token-secret": "s3cret",
              "expiration": "200"}))
    cm.pump_until_stable()
    cm.controllers["bootstrapsigner"].enqueue("sign")
    cm.pump_until_stable()
    cmap = api.get("ConfigMap", "kube-public", "cluster-info")
    assert "jws-kubeconfig-abc123" in cmap.data
    # expiry passes -> token cleaned
    clock[0] = 300.0
    cm.controllers["tokencleaner"].enqueue("kube-system/bootstrap-token-abc123")
    cm.pump_until_stable()
    assert all(s.name != "bootstrap-token-abc123"
               for s in api.list("Secret")[0])


def test_hpa_scales_on_cpu_utilization(k):
    api, cm = mk_manager(k)
    metrics = k.StaticMetricsClient()
    cm.controllers["horizontalpodautoscaling"].metrics = metrics
    api.create("ReplicaSet", k.ReplicaSet(
        "web", replicas=2, selector=k.LabelSelector(match_labels={"app": "w"}),
        template=mk_template(k, {"app": "w"})))
    cm.pump_until_stable()
    metrics.default = 200  # 200m used vs 100m requested = 200%
    api.create("HorizontalPodAutoscaler", k.HorizontalPodAutoscaler(
        "web-hpa", target_kind="ReplicaSet", target_name="web",
        min_replicas=1, max_replicas=10, target_cpu_utilization=100))
    cm.pump_until_stable()
    # scaled 2 -> 4 once; the upscale-forbidden window (horizontal.go)
    # prevents re-scaling against not-yet-converged metrics
    assert api.get("ReplicaSet", "default", "web").replicas == 4
    hpa = api.get("HorizontalPodAutoscaler", "default", "web-hpa")
    assert hpa.current_cpu_utilization == 200
    # inside tolerance after the window -> no change either
    hpa_ctrl = cm.controllers["horizontalpodautoscaling"]
    hpa_ctrl._last_scale.clear()  # simulate the window elapsing
    metrics.default = 105
    hpa_ctrl.resync_all()
    cm.pump_until_stable()
    assert api.get("ReplicaSet", "default", "web").replicas == 4


def test_disruption_controller_maintains_pdb_status(k):
    api, cm = mk_manager(k)
    for i in range(3):
        p = k.make_pod(f"w{i}", labels={"app": "w"}, node_name="n1")
        p.phase = "Running"
        api.create("Pod", p)
    api.create("PodDisruptionBudget", k.PodDisruptionBudget(
        "pdb", min_available=2,
        selector=k.LabelSelector(match_labels={"app": "w"})))
    cm.pump_until_stable()
    pdb = api.get("PodDisruptionBudget", "default", "pdb")
    assert pdb.current_healthy == 3 and pdb.disruptions_allowed == 1
    api.delete("Pod", "default", "w0")
    cm.pump_until_stable()
    pdb = api.get("PodDisruptionBudget", "default", "pdb")
    assert pdb.current_healthy == 2 and pdb.disruptions_allowed == 0


def test_parse_schedule_forms(k):
    assert k.parse_schedule("@every 90s") == 90
    assert k.parse_schedule("@every 5m") == 300
    assert k.parse_schedule("*/10 * * * *") == 600
    assert k.parse_schedule("0 3 * * *") == 86400


def test_cronjob_spawns_and_respects_forbid(k):
    clock = [1000.0]
    api = k.ApiServerLite()
    cm = k.ControllerManager(api, record_events=False)
    cj_ctrl = cm.controllers["cronjob"]
    cj_ctrl._now = lambda: clock[0]
    api.create("CronJob", k.CronJob(
        "tick", schedule="@every 60s", concurrency_policy="Forbid",
        job_template=k.Job(name="", template=mk_template(k, {"cron": "tick"}))))
    cj_ctrl.tick()
    cm.pump_until_stable()
    jobs = [j for j in api.list("Job")[0]]
    assert len(jobs) == 1
    # next window with the first job still active + Forbid -> no new job
    clock[0] += 61
    cj_ctrl.tick()
    cm.pump_until_stable()
    assert len(api.list("Job")[0]) == 1
    # job completes -> next window fires
    j = api.list("Job")[0][0]
    j.complete = True
    api.update("Job", j)
    clock[0] += 61
    cj_ctrl.tick()
    cm.pump_until_stable()
    assert len(api.list("Job")[0]) == 2


def test_service_lb_lifecycle_and_providers(k):
    api, cm = mk_manager(k)
    cloud = cm.cloud
    api.create("Node", k.make_node("n1"))
    api.create("Service", k.Service("web", type="LoadBalancer",
                                  selector={"app": "w"}))
    cm.pump_until_stable()
    svc = api.get("Service", "default", "web")
    assert svc.load_balancer_ip.startswith("172.24.")
    assert cloud.balancer_nodes["default/web"] == ["n1"]
    api.delete("Service", "default", "web")
    cm.pump_until_stable()
    assert "default/web" not in cloud.balancers
    # provider registry + provider-specific surface
    assert isinstance(k.get_provider("gce-like"), k.GCELikeCloud)
    aws = k.AWSLikeCloud()
    st = aws.ensure_load_balancer("default/x", ["n1"])
    assert "elb" in st.ingress_ip


def test_route_controller_syncs_pod_cidrs(k):
    api, cm = mk_manager(k)
    n = k.make_node("n1")
    n.pod_cidr = "10.244.1.0/24"
    api.create("Node", n)
    cm.pump_until_stable()
    routes = cm.cloud.list_routes()
    assert len(routes) == 1 and routes[0].destination_cidr == "10.244.1.0/24"
    api.delete("Node", "", "n1")
    cm.pump_until_stable()
    assert cm.cloud.list_routes() == []


def test_pv_binder_picks_smallest_fitting_volume(k):
    api, cm = mk_manager(k)
    api.create("PersistentVolume", k.PersistentVolume("big", capacity=100 * Mi))
    api.create("PersistentVolume", k.PersistentVolume("small", capacity=10 * Mi))
    api.create("PersistentVolumeClaim", k.PersistentVolumeClaim(
        "claim", capacity=5 * Mi))
    cm.pump_until_stable()
    pvc = api.get("PersistentVolumeClaim", "default", "claim")
    assert pvc.volume_name == "small"
    # second claim too big for the remaining small slots -> big
    api.create("PersistentVolumeClaim", k.PersistentVolumeClaim(
        "claim2", capacity=50 * Mi))
    cm.pump_until_stable()
    assert api.get("PersistentVolumeClaim", "default",
                   "claim2").volume_name == "big"


def test_attach_detach_records_attachable_volumes(k):
    api, cm = mk_manager(k)
    api.create("Node", k.make_node("n1"))
    pod = k.make_pod("db", node_name="n1", volumes=[
        k.Volume(name="data", kind=k.VolumeKind.AWS_EBS, volume_id="vol-1")])
    api.create("Pod", pod)
    cm.pump_until_stable()
    node = api.get("Node", "", "n1")
    att = node.annotations["volumes.kubernetes.io/attached"]
    assert "vol-1" in att
    api.delete("Pod", "default", "db")
    cm.pump_until_stable()
    node = api.get("Node", "", "n1")
    assert node.annotations["volumes.kubernetes.io/attached"] == ""


def test_csr_auto_approved_and_signed_for_kubelet_bootstrap(k):
    ca = k.CertAuthenticator(b"test-ca")
    api = k.ApiServerLite()
    cm = k.ControllerManager(api, record_events=False, ca=ca)
    api.create("CertificateSigningRequest", k.CertificateSigningRequest(
        "node-csr-1", requestor="system:bootstrap:abc123",
        groups=["system:bootstrappers"], cn="system:node:n1",
        orgs=["system:nodes"]))
    cm.pump_until_stable()
    csr = api.get("CertificateSigningRequest", "", "node-csr-1")
    assert csr.approved and csr.certificate is not None
    # the issued record authenticates as the node identity
    user = ca.authenticate(k.Credential(cert=csr.certificate))
    assert user.name == "system:node:n1" and "system:nodes" in user.groups
    # a CSR for someone else's identity is NOT auto-approved
    api.create("CertificateSigningRequest", k.CertificateSigningRequest(
        "evil", requestor="system:bootstrap:abc123",
        groups=["system:bootstrappers"], cn="system:admin",
        orgs=["system:masters"]))
    cm.pump_until_stable()
    assert not api.get("CertificateSigningRequest", "", "evil").approved


# ------------------------------------------ the two packages, one world


def _scripted_world(k):
    """Deployments with mixed_affinity templates, a bare ReplicaSet, a
    DaemonSet, a Job, a Namespace holding a Deployment, and PVs with
    claims; pumped to stability, a Deployment scaled, pumped again."""
    api = k.ApiServerLite()
    for node in k.hollow_nodes(24):
        api.create("Node", node)
    api.create("Node", k.make_node("not-ready", ready=False))
    cm = k.ControllerManager(api, record_events=False)
    api.create("Namespace", k.Namespace("team"))
    for i in range(6):
        api.create("PersistentVolume", k.PersistentVolume(
            f"pv-{i}", capacity=(i + 1) << 30,
            access_modes=["ReadWriteOnce"],
            source=k.Volume(name=f"pv-{i}", kind=k.VolumeKind.GCE_PD,
                            volume_id=f"pd-{i}")))
    for i in range(5):
        api.create("PersistentVolumeClaim", k.PersistentVolumeClaim(
            f"claim-{i}", "default", capacity=(5 - i) << 29,
            access_modes=["ReadWriteOnce"]))
    for i, tpl in enumerate(k.mixed_affinity_pods(22, namespace="default")):
        if i % 4:
            continue
        labels = dict(tpl.labels, deploy=f"d{i}")
        api.create("Deployment", k.Deployment(
            name=f"d{i}", replicas=3 + i % 3,
            selector=k.LabelSelector(match_labels={"deploy": f"d{i}"}),
            template=dataclasses.replace(tpl, name="", labels=labels)))
    api.create("Deployment", k.Deployment(
        name="api", namespace="team", replicas=2,
        selector=k.LabelSelector(match_labels={"app": "api"}),
        template=dataclasses.replace(mk_template(k, {"app": "api"}),
                                     namespace="team")))
    api.create("ReplicaSet", k.ReplicaSet(
        name="bare", replicas=4,
        selector=k.LabelSelector(match_labels={"app": "bare"}),
        template=mk_template(k, {"app": "bare"})))
    api.create("DaemonSet", k.DaemonSet(
        name="agent", selector=k.LabelSelector(match_labels={"ds": "agent"}),
        template=mk_template(k, {"ds": "agent"})))
    api.create("Job", k.Job(
        name="calc", completions=6, parallelism=4,
        template=dataclasses.replace(mk_template(k, {"job": "calc"}),
                                     restart_policy="Never")))
    rounds = [cm.pump_until_stable()]
    fresh = api.get("Deployment", "default", "d4")
    api.update("Deployment", dataclasses.replace(fresh, replicas=9))
    rounds.append(cm.pump_until_stable())
    return api, rounds


def _wire_dump(k, api):
    out = {}
    for kind in sorted(k.KIND_REGISTRY):
        objs = api.list(kind)[0]
        if objs:
            out[kind] = sorted(json.dumps(k.wire.encode(o, kind=kind),
                                          sort_keys=True) for o in objs)
    return out


def test_pumped_world_is_equal_in_wire_json():
    """Exact: every object of every registered kind, in wire JSON, and
    the pump's round counts."""
    dumps, rounds = {}, {}
    for root in (REF, PORT):
        k = PKGS[root]
        api, rounds[root] = _scripted_world(k)
        dumps[root] = _wire_dump(k, api)
    ref, port = dumps[REF], dumps[PORT]
    assert rounds[PORT] == rounds[REF]
    assert sorted(port) == sorted(ref)
    for kind in ref:
        assert port[kind] == ref[kind], kind
    # the world did what it was scripted to do
    k = PKGS[PORT]
    pods = [json.loads(s) for s in port["Pod"]]
    owners = {}
    for p in pods:
        owners[p["owner_kind"]] = owners.get(p["owner_kind"], 0) + 1
    # d0..d20 at 3 + i % 3 replicas with d4 scaled to 9, api's 2, bare's 4
    assert owners == {"ReplicaSet": 3 + 9 + 5 + 3 + 4 + 5 + 2 + 4,
                      "DaemonSet": 24, "Job": 4}, owners
    rses = [json.loads(s) for s in port["ReplicaSet"]]
    assert len(rses) == 8  # one per Deployment and the bare one
    assert {r["owner_name"] for r in rses if r["owner_kind"]} == {
        "d0", "d4", "d8", "d12", "d16", "d20", "api"}
    claims = [json.loads(s) for s in port["PersistentVolumeClaim"]]
    assert all(c["volume_name"] for c in claims)
    assert len({c["volume_name"] for c in claims}) == len(claims)
    assert "Namespace" in port and "ServiceAccount" in port
