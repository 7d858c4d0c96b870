"""The port's command line against the reference's: cli/strategicpatch,
cli/ktctl and the hyperkube dispatcher (__main__.py). The bodies of
tests/test_strategicpatch.py, tests/test_cli_verbs.py,
tests/test_rest_and_cli.py, tests/test_round5_integration.py and
tests/test_federation.py run on both packages (the `k` fixture; every
Scheduler of the port on the CPU). Then the parity cases of the port's one
departure in cli/ktctl.py, the PyYAML import moved into the three places
that use it: with `yaml` blocked the port's ktctl imports and runs the
verbs that read no YAML, and where PyYAML is installed `-o yaml`,
`create -f` and `apply -f` give equal text and objects in both
packages."""

from __future__ import annotations

import io
import json
import pathlib
import socket
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import yaml

from tests.torch_packages import PORT, REF, Pkg

_REPO = pathlib.Path(__file__).resolve().parents[1]

MODULES = {
    "hyperkube": "__main__",
    "admission_chain": "admission.chain",
    "admission_webhook": "admission.webhook",
    "api_cluster": "api.cluster",
    "api_extensions": "api.extensions",
    "api_rbac": "api.rbac",
    "api_types": "api.types",
    "api_workloads": "api.workloads",
    "cli_ktctl": "cli.ktctl",
    "cli_rest_client": "cli.rest_client",
    "cli_strategicpatch": "cli.strategicpatch",
    "client_informer": "client.informer",
    "client_record": "client.record",
    "controllers_deployment": "controllers.deployment",
    "controllers_replicaset": "controllers.replicaset",
    "engine_scheduler": "engine.scheduler",
    "federation_controller": "federation.controller",
    "federation_planner": "federation.planner",
    "federation_service_dns": "federation.service_dns",
    "nodes_kubelet": "nodes.kubelet",
    "nodes_kubelet_server": "nodes.kubelet_server",
    "server_apiserver": "server.apiserver",
    "server_apiserver_lite": "server.apiserver_lite",
    "server_rest_http": "server.rest_http",
}

PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}
DEVICE = {REF: {}, PORT: {"device": "cpu"}}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


# ============================================================
# strategicpatch


CASES = [
    # (name, current, patch, expected)
    ("scalar update", {"replicas": 3}, {"replicas": 5}, {"replicas": 5}),
    ("null deletes key",
     {"labels": {"a": "1", "b": "2"}},
     {"labels": {"a": None}},
     {"labels": {"b": "2"}}),
    ("nested map merge",
     {"selector": {"match_labels": {"app": "web"}}, "replicas": 1},
     {"selector": {"match_labels": {"tier": "fe"}}},
     {"selector": {"match_labels": {"app": "web", "tier": "fe"}},
      "replicas": 1}),
    ("merge-key list item update in place",
     {"containers": [{"name": "a", "image": "v1"},
                     {"name": "b", "image": "v1"}]},
     {"containers": [{"name": "b", "image": "v2"}]},
     {"containers": [{"name": "a", "image": "v1"},
                     {"name": "b", "image": "v2"}]}),
    ("merge-key list append",
     {"containers": [{"name": "a"}]},
     {"containers": [{"name": "c", "image": "new"}]},
     {"containers": [{"name": "a"}, {"name": "c", "image": "new"}]}),
    ("$patch delete removes keyed item",
     {"containers": [{"name": "a"}, {"name": "b"}]},
     {"containers": [{"name": "a", "$patch": "delete"}]},
     {"containers": [{"name": "b"}]}),
    ("un-keyed list replaces atomically",
     {"access_modes": ["RWO", "RWX"]},
     {"access_modes": ["ROX"]},
     {"access_modes": ["ROX"]}),
    ("$patch replace swaps the whole map",
     {"labels": {"a": "1", "b": "2"}},
     {"labels": {"$patch": "replace", "c": "3"}},
     {"labels": {"c": "3"}}),
]


@pytest.mark.parametrize("name,current,patch,expected",
                         CASES, ids=[c[0] for c in CASES])
def test_strategic_merge_patch(k, name, current, patch, expected):
    assert k.strategic_merge_patch(current, patch) == expected


# ------------------------------------------------------ three-way (apply)


def test_three_way_prunes_manifest_removed_list_item(k):
    """THE case 2-way apply silently loses (r4 VERDICT weak #7): a
    container removed from the manifest must be pruned server-side."""
    original = {"containers": [{"name": "app"}, {"name": "sidecar"}]}
    modified = {"containers": [{"name": "app"}]}
    live = {"containers": [{"name": "app"}, {"name": "sidecar"}],
            "node_name": "n1"}
    merged = k.three_way_merge(original, modified, live)
    assert [c["name"] for c in merged["containers"]] == ["app"]
    assert merged["node_name"] == "n1"  # server-set field survives


def test_three_way_preserves_controller_owned_fields(k):
    """An HPA moved live replicas to 5; the manifest does NOT manage
    replicas — apply must not stomp it (the defining 3-way property:
    manifest-UNSPECIFIED fields are controller-owned)."""
    original = {"labels": {"app": "web"}}
    modified = {"labels": {"app": "web", "v": "2"}}
    live = {"replicas": 5, "labels": {"app": "web"}, "status": "ok"}
    merged = k.three_way_merge(original, modified, live)
    assert merged["replicas"] == 5  # HPA's write survives
    assert merged["labels"] == {"app": "web", "v": "2"}
    assert merged["status"] == "ok"


def test_three_way_reverts_live_drift_on_manifest_specified_fields(k):
    """CreateThreeWayMergePatch's SECOND diff (patch.go:1958: diff
    (current, modified) with IgnoreDeletions): a field the manifest DOES
    manage is driven back to the manifest's value even when last-applied
    already matches the manifest — kubectl apply reverts manual/live
    drift (this is also why kubectl docs warn against pinning replicas
    under an HPA). ADVICE r5 medium: the previous 2-diff-only merge left
    the drift in place."""
    original = {"replicas": 2, "image": "app:v1"}
    modified = {"replicas": 2, "image": "app:v1"}
    live = {"replicas": 2, "image": "app:drifted", "status": "ok"}
    merged = k.three_way_merge(original, modified, live)
    assert merged["image"] == "app:v1"  # drift reverted
    assert merged["status"] == "ok"     # unmanaged field untouched


def test_three_way_reverts_drift_inside_merge_keyed_list_item(k):
    original = {"containers": [{"name": "app", "image": "v1"}]}
    modified = {"containers": [{"name": "app", "image": "v1"}]}
    live = {"containers": [{"name": "app", "image": "hand-edited",
                            "requests": {"cpu": 100}}]}
    merged = k.three_way_merge(original, modified, live)
    c = merged["containers"][0]
    assert c["image"] == "v1"           # drift reverted
    assert c["requests"] == {"cpu": 100}  # live-only field kept


def test_three_way_readds_manifest_field_controller_removed(k):
    """A manifest-managed key removed from live comes back (the delta
    half sees an addition)."""
    original = {"labels": {"app": "web"}}
    modified = {"labels": {"app": "web"}}
    live = {"labels": {}}
    merged = k.three_way_merge(original, modified, live)
    assert merged["labels"] == {"app": "web"}


def test_three_way_deletes_map_key_removed_from_manifest(k):
    original = {"labels": {"app": "web", "tier": "fe"}}
    modified = {"labels": {"app": "web"}}
    live = {"labels": {"app": "web", "tier": "fe", "ctrl": "x"}}
    merged = k.three_way_merge(original, modified, live)
    assert merged["labels"] == {"app": "web", "ctrl": "x"}


def test_three_way_reorder_only_is_a_noop_on_live_state(k):
    """1.7 strategic merge has no $setElementOrder: a pure reorder diffs
    to nothing and live order stands."""
    original = {"containers": [{"name": "a"}, {"name": "b"}]}
    modified = {"containers": [{"name": "b"}, {"name": "a"}]}
    live = {"containers": [{"name": "a"}, {"name": "b"}]}
    assert k.three_way_merge(original, modified, live) == live


def test_three_way_merge_key_item_field_update(k):
    original = {"containers": [{"name": "app", "image": "v1"}]}
    modified = {"containers": [{"name": "app", "image": "v2"}]}
    live = {"containers": [{"name": "app", "image": "v1",
                            "requests": {"cpu": 100}}]}
    merged = k.three_way_merge(original, modified, live)
    c = merged["containers"][0]
    assert c["image"] == "v2"
    assert c["requests"] == {"cpu": 100}  # live-only field kept


# --------------------------------------------------------- through ktctl


def mk_cli(k):
    api = k.ApiServer()
    api.store.create("Namespace", k.Namespace("default"))
    out = io.StringIO()
    return api, k.Ktctl(api, out=out), out


DEPLOY_V1 = """
kind: Deployment
name: web
namespace: default
replicas: 2
selector:
  match_labels: {app: web}
template:
  name: ""
  namespace: default
  labels: {app: web}
  containers:
  - name: app
    requests: {cpu: 100}
  - name: sidecar
    requests: {cpu: 50}
"""

DEPLOY_V2 = """
kind: Deployment
name: web
namespace: default
replicas: 2
selector:
  match_labels: {app: web}
template:
  name: ""
  namespace: default
  labels: {app: web}
  containers:
  - name: app
    requests: {cpu: 100}
"""


def test_apply_three_way_through_ktctl(k, tmp_path):
    api, kt, out = mk_cli(k)
    m = tmp_path / "d.yaml"
    m.write_text(DEPLOY_V1)
    assert kt.run(["apply", "-f", str(m)]) == 0
    dep = api.get("Deployment", "default", "web")
    assert len(dep.template.containers) == 2
    # a controller (HPA) scales live replicas to 5
    api.scale("Deployment", "default", "web", replicas=5)
    # manifest drops the sidecar but still says replicas: 2 — reference
    # semantics (CreateThreeWayMergePatch second diff): the manifest
    # MANAGES replicas, so apply drives it back to 2, reverting the
    # HPA's live write (the documented kubectl-vs-HPA conflict; drop
    # replicas from the manifest to hand it to the controller)
    m.write_text(DEPLOY_V2)
    assert kt.run(["apply", "-f", str(m)]) == 0
    dep = api.get("Deployment", "default", "web")
    # removed list item pruned; manifest-pinned replicas enforced
    assert [c.name for c in dep.template.containers] == ["app"]
    assert dep.replicas == 2
    # server-owned counters the manifest never wrote stay server-owned
    assert dep.resource_version > 0
    # idempotent re-apply reports unchanged
    out.truncate(0), out.seek(0)
    assert kt.run(["apply", "-f", str(m)]) == 0
    assert "unchanged" in out.getvalue()


POD_MANIFEST_V1 = """
apiVersion: v1
kind: Pod
metadata:
  name: web
  namespace: default
  labels: {app: web}
spec:
  containers:
  - name: app
    image: "app:v1"
    resources: {requests: {cpu: 100m}}
"""


def test_apply_kubectl_shaped_pod_manifest(k, tmp_path):
    """Pod manifests use the metadata/spec shape; apply must merge in that
    shape — updating the image really updates it, and the scheduler-set
    nodeName binding plus pod status survive."""
    api, kt, out = mk_cli(k)
    m = tmp_path / "p.yaml"
    m.write_text(POD_MANIFEST_V1)
    assert kt.run(["apply", "-f", str(m)]) == 0
    # the scheduler binds it and the kubelet runs it
    live = api.get("Pod", "default", "web")
    live.node_name = "n1"
    live.phase = "Running"
    api.update("Pod", live)
    # user bumps the image
    m.write_text(POD_MANIFEST_V1.replace("app:v1", "app:v2"))
    assert kt.run(["apply", "-f", str(m)]) == 0
    p = api.get("Pod", "default", "web")
    assert p.containers[0].image == "app:v2"  # change really applied
    assert p.node_name == "n1"  # binding survives
    assert p.phase == "Running"  # status survives


def test_patch_kubectl_shaped_pod(k, tmp_path):
    api, kt, out = mk_cli(k)
    m = tmp_path / "p.yaml"
    m.write_text(POD_MANIFEST_V1)
    assert kt.run(["apply", "-f", str(m)]) == 0
    patch = json.dumps({"spec": {"priority": 10},
                        "metadata": {"labels": {"tier": "fe"}}})
    assert kt.run(["patch", "pod", "web", "-p", patch]) == 0
    p = api.get("Pod", "default", "web")
    assert p.priority == 10
    assert p.labels == {"app": "web", "tier": "fe"}
    assert p.containers[0].image == "app:v1"  # untouched


def test_patch_verb(k, tmp_path):
    api, kt, out = mk_cli(k)
    m = tmp_path / "d.yaml"
    m.write_text(DEPLOY_V1)
    assert kt.run(["apply", "-f", str(m)]) == 0
    patch = json.dumps({"replicas": 7,
                        "template": {"containers": [
                            {"name": "sidecar", "$patch": "delete"}]}})
    assert kt.run(["patch", "deploy", "web", "-p", patch]) == 0
    dep = api.get("Deployment", "default", "web")
    assert dep.replicas == 7
    assert [c.name for c in dep.template.containers] == ["app"]
    assert "patched" in out.getvalue()


def test_edit_verb(k, tmp_path, monkeypatch):
    api, kt, out = mk_cli(k)
    m = tmp_path / "d.yaml"
    m.write_text(DEPLOY_V1)
    assert kt.run(["apply", "-f", str(m)]) == 0
    # an "editor" that bumps replicas in place
    editor = tmp_path / "ed.sh"
    editor.write_text("#!/bin/sh\nsed -i 's/replicas: 2/replicas: 9/' $1\n")
    editor.chmod(0o755)
    monkeypatch.setenv("KTCTL_EDITOR", str(editor))
    assert kt.run(["edit", "deploy", "web"]) == 0
    assert api.get("Deployment", "default", "web").replicas == 9


def test_diff_previews_apply_without_writing(k, tmp_path):
    """kubectl diff semantics: exit 1 + unified diff when apply would
    change something, exit 0 clean, and the live object is untouched."""
    api, kt, out = mk_cli(k)
    m = tmp_path / "d.yaml"
    m.write_text(DEPLOY_V1)
    # would-create
    assert kt.run(["diff", "-f", str(m)]) == 1
    assert "would be created" in out.getvalue()
    assert kt.run(["apply", "-f", str(m)]) == 0
    # clean: nothing to change
    out.truncate(0), out.seek(0)
    assert kt.run(["diff", "-f", str(m)]) == 0
    assert out.getvalue() == ""
    # manifest drops the sidecar: diff previews the removal, no write
    m.write_text(DEPLOY_V2)
    out.truncate(0), out.seek(0)
    assert kt.run(["diff", "-f", str(m)]) == 1
    assert "sidecar" in out.getvalue()
    dep = api.get("Deployment", "default", "web")
    assert len(dep.template.containers) == 2  # live object untouched


NODE_MANIFEST = """
apiVersion: v1
kind: Node
metadata:
  name: n1
  labels: {pool: web}
  annotations:
    owner: team-a
"""


def test_apply_node_annotation_change_sticks(k, tmp_path):
    """ADVICE r5 low (ktctl.py _decode_canon): user-requested Node
    annotation changes must survive apply — the old code wholesale-restored
    the live annotation map after the merge, silently discarding them.
    Server-owned keys (TTL controller, attach-detach) still survive."""
    api, kt, out = mk_cli(k)
    m = tmp_path / "n.yaml"
    m.write_text(NODE_MANIFEST)
    assert kt.run(["apply", "-f", str(m)]) == 0
    # controllers write their own keys on the live object
    live = api.get("Node", "", "n1")
    live.annotations["node.alpha.kubernetes.io/ttl"] = "30"
    live.annotations["volumes.kubernetes.io/attached"] = "vol-1"
    api.update("Node", live)
    # user changes one annotation and adds another
    m.write_text(NODE_MANIFEST.replace("owner: team-a",
                                       "owner: team-b\n    rack: r7"))
    assert kt.run(["apply", "-f", str(m)]) == 0
    n = api.get("Node", "", "n1")
    assert n.annotations["owner"] == "team-b"      # change applied
    assert n.annotations["rack"] == "r7"           # addition applied
    assert n.annotations["node.alpha.kubernetes.io/ttl"] == "30"
    assert n.annotations["volumes.kubernetes.io/attached"] == "vol-1"


def test_apply_node_annotation_removal_prunes(k, tmp_path):
    """Dropping a previously-applied annotation from the manifest deletes
    it (3-way deletions half), without touching controller-owned keys."""
    api, kt, out = mk_cli(k)
    m = tmp_path / "n.yaml"
    m.write_text(NODE_MANIFEST)
    assert kt.run(["apply", "-f", str(m)]) == 0
    live = api.get("Node", "", "n1")
    live.annotations["node.alpha.kubernetes.io/ttl"] = "15"
    api.update("Node", live)
    m.write_text(NODE_MANIFEST.replace("\n  annotations:\n    owner: team-a",
                                       ""))
    assert kt.run(["apply", "-f", str(m)]) == 0
    n = api.get("Node", "", "n1")
    assert "owner" not in n.annotations            # pruned
    assert n.annotations["node.alpha.kubernetes.io/ttl"] == "15"


POD_MANIFEST_FLAT = """
kind: Pod
name: flatp
namespace: default
labels: {app: flat}
containers:
- name: app
  image: app:v1
  requests: {cpu: 100}
"""


def test_apply_flat_shape_pod_manifest_updates_apply(k, tmp_path):
    """decode_any accepts the flat native shape too; the delta projection
    must tolerate the raw manifest not nesting metadata/spec the way the
    canonical encoding does — a flat manifest's image bump must really
    apply (regression: empty projection silently dropped every update
    while still printing 'configured')."""
    api, kt, out = mk_cli(k)
    m = tmp_path / "p.yaml"
    m.write_text(POD_MANIFEST_FLAT)
    assert kt.run(["apply", "-f", str(m)]) == 0
    assert api.get("Pod", "default", "flatp").containers[0].image == "app:v1"
    m.write_text(POD_MANIFEST_FLAT.replace("app:v1", "app:v2"))
    assert kt.run(["apply", "-f", str(m)]) == 0
    p = api.get("Pod", "default", "flatp")
    assert p.containers[0].image == "app:v2"
    # and drift on a flat-manifest-specified field reverts
    p.labels["app"] = "drifted"
    api.update("Pod", p)
    assert kt.run(["apply", "-f", str(m)]) == 0
    assert api.get("Pod", "default", "flatp").labels["app"] == "flat"


# ============================================================
# cli_verbs


def mk_cluster(k):
    api = k.ApiServer()
    api.store.create("Namespace", k.Namespace("default"))
    factory = k.SharedInformerFactory(api.store)
    fleet = k.HollowFleet(api.store, factory)
    fleet.add_node(k.make_node("n0"))
    factory.step_all()
    out = io.StringIO()
    kt = k.Ktctl(api, out=out, kubelets=dict(fleet.kubelets))
    return api, factory, fleet, kt, out


def run_pod(k, api, factory, fleet, name="web", annotations=None):
    pod = k.make_pod(name, cpu=100, node_name="n0")
    pod.annotations.update(annotations or {})
    api.store.create("Pod", pod)
    factory.step_all()
    fleet.step()
    assert api.store.get("Pod", "default", name).phase == "Running"
    return pod


def test_attach_streams_running_container(k):
    api, factory, fleet, kt, out = mk_cluster(k)
    run_pod(k, api, factory, fleet,
            annotations={"bench/log-lines": "line1\nline2"})
    assert kt.run(["attach", "web"]) == 0
    assert out.getvalue().strip().endswith("line2")
    # attaching to a pod that is not running errors (unlike logs)
    assert kt.run(["attach", "ghost"]) != 0


def test_attach_over_http_kubelet(k):
    api, factory, fleet, kt, out = mk_cluster(k)
    run_pod(k, api, factory, fleet,
            annotations={"bench/log-lines": "hello"})
    srv = k.KubeletServer(fleet.kubelets["n0"])
    srv.start()
    try:
        kt.kubelets = {"n0": f"http://127.0.0.1:{srv.port}"}
        assert kt.run(["attach", "web"]) == 0
        assert "hello" in out.getvalue()
    finally:
        srv.stop()


def test_port_forward_round_trip(k):
    api, factory, fleet, kt, out = mk_cluster(k)
    run_pod(k, api, factory, fleet,
            annotations={"bench/port-80": "HTTP/1.0 200 OK\r\n\r\nhome"})
    assert kt.run(["port-forward", "web", "0:80"]) == 0
    fwd = kt.port_forwards[-1]
    try:
        assert f"127.0.0.1:{fwd.local_port}" in out.getvalue()
        # a REAL tcp connection to the forwarded port gets the pod's bytes
        with socket.create_connection(("127.0.0.1", fwd.local_port),
                                      timeout=5) as conn:
            data = b""
            while True:
                chunk = conn.recv(4096)
                if not chunk:
                    break
                data += chunk
        assert data.endswith(b"home")
    finally:
        fwd.stop()


def test_port_forward_rejects_unserved_port(k):
    api, factory, fleet, kt, out = mk_cluster(k)
    run_pod(k, api, factory, fleet)
    assert kt.run(["port-forward", "web", "0:9999"]) != 0
    assert "9999" in out.getvalue()


def test_rollout_restart_stamps_template(k):
    api, factory, fleet, kt, out = mk_cluster(k)
    api.store.create("Deployment", k.Deployment(
        name="app", replicas=1,
        selector=k.LabelSelector(match_labels={"app": "app"}),
        template=k.Pod(name="", labels={"app": "app"})))
    assert kt.run(["rollout", "restart", "deploy", "app"]) == 0
    dep = api.store.get("Deployment", "default", "app")
    assert "kubectl.kubernetes.io/restartedAt" in dep.template.annotations
    assert "restarted" in out.getvalue()
    # a second restart moves the stamp (a fresh rollout each time)
    first = dep.template.annotations["kubectl.kubernetes.io/restartedAt"]
    import time
    time.sleep(0.01)
    assert kt.run(["rollout", "restart", "deploy", "app"]) == 0
    second = api.store.get("Deployment", "default", "app") \
        .template.annotations["kubectl.kubernetes.io/restartedAt"]
    assert second != first


def test_explain_reads_live_openapi(k):
    api, factory, fleet, kt, out = mk_cluster(k)
    assert kt.run(["explain", "pod"]) == 0
    text = out.getvalue()
    assert "KIND:     Pod" in text
    assert "containers" in text
    out.truncate(0), out.seek(0)
    assert kt.run(["explain", "pod.containers"]) == 0
    assert "image" in out.getvalue()
    assert kt.run(["explain", "pod.nosuchfield"]) != 0


def test_run_creates_pod_or_deployment(k):
    api, factory, fleet, kt, out = mk_cluster(k)
    assert kt.run(["run", "one", "--image", "app:v1"]) == 0
    assert api.store.get("Pod", "default", "one") \
        .containers[0].image == "app:v1"
    assert kt.run(["run", "many", "--image", "app:v1",
                   "--replicas", "3"]) == 0
    dep = api.store.get("Deployment", "default", "many")
    assert dep.replicas == 3
    assert dep.template.containers[0].image == "app:v1"


def test_autoscale_creates_hpa(k):
    api, factory, fleet, kt, out = mk_cluster(k)
    api.store.create("Deployment", k.Deployment(
        name="web", replicas=2,
        selector=k.LabelSelector(match_labels={"app": "web"}),
        template=k.Pod(name="", labels={"app": "web"})))
    assert kt.run(["autoscale", "deploy", "web", "--min", "2",
                   "--max", "8", "--cpu-percent", "70"]) == 0
    hpa = api.store.get("HorizontalPodAutoscaler", "default", "web")
    assert hpa.min_replicas == 2 and hpa.max_replicas == 8
    assert hpa.target_cpu_utilization == 70
    assert hpa.target_kind == "Deployment"
    # target must exist, like kubectl
    assert kt.run(["autoscale", "deploy", "ghost", "--max", "4"]) != 0


def test_explain_against_remote_backend_sees_crds(k):
    """explain over a RestClient backend must read the server-published
    /openapi/v2, so Established CRDs are explainable remotely."""
    api = k.ApiServer()
    api.store.create("Namespace", k.Namespace("default"))
    # through the apiserver verb so the CRD is named + Established (the
    # establishing controller work runs at admission; a bare store write
    # would never surface in discovery)
    api.create("CustomResourceDefinition", k.CustomResourceDefinition(
        name="widgets.example.com", group="example.com", version="v1",
        names=k.CRDNames(plural="widgets", kind="Widget",
                         singular="widget")))
    srv = k.RestServer(api)
    srv.start()
    try:
        out = io.StringIO()
        kt = k.Ktctl(k.RestClient(f"http://127.0.0.1:{srv.port}"), out=out)
        assert kt.run(["explain", "widgets"]) == 0
        assert "KIND:     Widget" in out.getvalue()
    finally:
        srv.stop()


def test_autoscale_rejects_min_above_max(k):
    api, factory, fleet, kt, out = mk_cluster(k)
    api.store.create("Deployment", k.Deployment(
        name="web", replicas=2,
        selector=k.LabelSelector(match_labels={"app": "web"}),
        template=k.Pod(name="", labels={"app": "web"})))
    assert kt.run(["autoscale", "deploy", "web", "--min", "9",
                   "--max", "4"]) != 0
    assert "must be at least 1" in out.getvalue()


# ============================================================
# rest_and_cli


@pytest.fixture()
def rest(k):
    api = k.ApiServer()
    api.store.create("Namespace", k.Namespace("default"))
    srv = k.RestServer(api)
    srv.start()
    yield api, k.RestClient(f"http://127.0.0.1:{srv.port}")
    srv.stop()


def test_rest_crud_roundtrip(k, rest):
    api, client = rest
    client.create("Node", k.make_node("n1", cpu=2000))
    client.create("Pod", k.make_pod("p1", cpu=100, memory=1 << 20))
    node = client.get("Node", "", "n1")
    assert node.allocatable.milli_cpu == 2000
    pods, rv = client.list("Pod")
    assert [p.name for p in pods] == ["p1"] and rv > 0
    p = pods[0]
    p.labels["x"] = "y"
    client.update("Pod", p)
    assert client.get("Pod", "default", "p1").labels["x"] == "y"
    client.delete("Pod", "default", "p1")
    with pytest.raises(k.NotFound):
        client.get("Pod", "default", "p1")


def test_rest_binding_and_watch(k, rest):
    api, client = rest
    client.create("Node", k.make_node("n1"))
    rv0 = client.list("Pod")[1]
    client.create("Pod", k.make_pod("w"))
    client.bind(k.Binding("w", "default", "default/w", "n1"))
    assert client.get("Pod", "default", "w").node_name == "n1"
    evs = client.watch_since(("Pod",), rv0)
    assert [e.type for e in evs] == ["ADDED", "MODIFIED"]
    assert evs[-1].obj.node_name == "n1"


def test_rest_scale_and_healthz(k, rest):
    api, client = rest
    api.store.create("ReplicaSet", k.ReplicaSet(
        "rs", "default", replicas=2,
        selector=k.LabelSelector(match_labels={"a": "b"})))
    assert client.scale("ReplicaSet", "default", "rs") == 2
    client.scale("ReplicaSet", "default", "rs", replicas=7)
    assert api.store.get("ReplicaSet", "default", "rs").replicas == 7
    assert client.healthz() == {"status": "ok"}
    assert client.version()["gitVersion"].startswith("v1.7")


def make_cli(k):
    api = k.ApiServer()
    api.store.create("Namespace", k.Namespace("default"))
    out = io.StringIO()
    return api, k.Ktctl(api, out=out), out


def test_ktctl_get_table_and_json(k):
    api, cli, out = make_cli(k)
    api.create("Node", k.make_node("n1"))
    api.create("Pod", k.make_pod("a", cpu=100, memory=1 << 20))
    api.create("Pod", k.make_pod("b", cpu=100, memory=1 << 20))
    assert cli.run(["get", "pods"]) == 0
    text = out.getvalue()
    assert "NAME" in text and "a" in text and "b" in text
    out.truncate(0), out.seek(0)
    cli.run(["get", "po", "a", "-o", "json"])
    data = json.loads(out.getvalue())
    assert data[0]["name"] == "a"
    out.truncate(0), out.seek(0)
    cli.run(["get", "nodes", "-o", "name"])
    assert out.getvalue().strip() == "nodes/n1"


def test_ktctl_create_apply_delete(k, tmp_path):
    api, cli, out = make_cli(k)
    manifest = tmp_path / "rs.yaml"
    manifest.write_text(yaml.safe_dump({
        "kind": "ReplicaSet", "name": "web", "namespace": "default",
        "replicas": 3,
        "selector": {"match_labels": {"app": "web"}},
    }))
    assert cli.run(["create", "-f", str(manifest)]) == 0
    assert api.store.get("ReplicaSet", "default", "web").replicas == 3
    # apply: unchanged -> "unchanged"; edited -> "configured"
    cli.run(["apply", "-f", str(manifest)])
    assert "configured" in out.getvalue() or "unchanged" in out.getvalue()
    manifest.write_text(yaml.safe_dump({
        "kind": "ReplicaSet", "name": "web", "namespace": "default",
        "replicas": 5,
        "selector": {"match_labels": {"app": "web"}},
    }))
    cli.run(["apply", "-f", str(manifest)])
    assert api.store.get("ReplicaSet", "default", "web").replicas == 5
    cli.run(["delete", "rs", "web"])
    with pytest.raises(k.NotFound):
        api.store.get("ReplicaSet", "default", "web")


def test_ktctl_accepts_k8s_pod_manifest(k, tmp_path):
    api, cli, out = make_cli(k)
    manifest = tmp_path / "pod.yaml"
    manifest.write_text(yaml.safe_dump({
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": "nginx", "namespace": "default",
                     "labels": {"app": "nginx"}},
        "spec": {"containers": [{
            "name": "c", "image": "nginx:1.13",
            "resources": {"requests": {"cpu": "250m", "memory": "64Mi"}}}]},
    }))
    assert cli.run(["create", "-f", str(manifest)]) == 0
    pod = api.store.get("Pod", "default", "nginx")
    assert pod.containers[0].requests["cpu"] == 250
    assert pod.containers[0].requests["memory"] == 64 << 20


def test_ktctl_label_taint_cordon_drain(k):
    api, cli, out = make_cli(k)
    api.create("Node", k.make_node("n1"))
    api.create("Pod", k.make_pod("p", node_name=""))
    api.store.bind(k.Binding("p", "default", "default/p", "n1"))
    cli.run(["label", "nodes", "n1", "zone=a"])
    assert api.store.get("Node", "", "n1").labels["zone"] == "a"
    cli.run(["taint", "nodes", "n1", "dedicated=gpu:NoSchedule"])
    assert api.store.get("Node", "", "n1").taints[0].key == "dedicated"
    cli.run(["taint", "nodes", "n1", "dedicated-"])
    assert api.store.get("Node", "", "n1").taints == []
    cli.run(["cordon", "n1"])
    assert api.store.get("Node", "", "n1").unschedulable
    cli.run(["drain", "n1"])
    assert [p for p in api.store.list("Pod")[0]] == []
    cli.run(["uncordon", "n1"])
    assert not api.store.get("Node", "", "n1").unschedulable


def test_ktctl_scale_top_api_resources(k):
    api, cli, out = make_cli(k)
    api.store.create("ReplicaSet", k.ReplicaSet(
        "rs", "default", replicas=1,
        selector=k.LabelSelector(match_labels={"a": "b"})))
    cli.run(["scale", "rs", "rs", "--replicas", "4"])
    assert api.store.get("ReplicaSet", "default", "rs").replicas == 4
    api.create("Node", k.make_node("n1"))
    cli.run(["top", "nodes"])
    assert "n1" in out.getvalue()
    out.truncate(0), out.seek(0)
    cli.run(["api-resources"])
    assert "pods" in out.getvalue() and "nodes" in out.getvalue()


def test_rest_subresource_wrong_method_does_not_fall_through(k, rest):
    api, client = rest
    client.create("Pod", k.make_pod("guarded", labels={"app": "g"}))
    api.store.create("PodDisruptionBudget", k.PodDisruptionBudget(
        "pdb", "default", min_available=1,
        selector=k.LabelSelector(match_labels={"app": "g"}),
        disruptions_allowed=0))
    import urllib.request
    req = urllib.request.Request(
        client.base + "/api/v1/namespaces/default/pods/guarded/eviction",
        method="DELETE")
    import urllib.error
    try:
        urllib.request.urlopen(req)
        raise AssertionError("DELETE on eviction subresource succeeded")
    except urllib.error.HTTPError as e:
        assert e.code == 404
    assert api.store.get("Pod", "default", "guarded")  # still there


def test_rest_update_cas_precondition(k, rest):
    api, client = rest
    client.create("Pod", k.make_pod("p", labels={"v": "1"}))
    cur = client.get("Pod", "default", "p")
    stale_rv = cur.resource_version
    cur.labels["v"] = "2"
    client.update("Pod", cur)  # bumps rv server-side
    cur.labels["v"] = "3"
    import pytest as _pytest
    with _pytest.raises(k.Conflict):
        client.update("Pod", cur, expect_rv=stale_rv)


def test_ktctl_bool_flag_then_output_flag(k):
    api, cli, out = make_cli(k)
    api.create("Pod", k.make_pod("a", cpu=10, memory=1 << 20))
    assert cli.run(["get", "pods", "--all-namespaces", "-o", "json"]) == 0
    data = json.loads(out.getvalue())
    assert data[0]["name"] == "a"


def test_ktctl_auth_can_i(k):
    """auth can-i through the full apiserver's authorizer chain."""
    import io

    srv = k.ApiServer(auth=False)
    srv.store.create("Role", k.Role(
        "pod-reader", "default",
        rules=[k.PolicyRule(verbs=["get", "list"], resources=["pods"])]))
    srv.store.create("RoleBinding", k.RoleBinding(
        "rb", "default",
        subjects=[k.Subject(kind="User", name="alice")],
        role_ref=k.RoleRef(kind="Role", name="pod-reader")))
    out = io.StringIO()
    kt = k.Ktctl(srv, out=out)
    assert kt.run(["auth", "can-i", "get", "pods", "--as", "alice"]) == 0
    assert kt.run(["auth", "can-i", "delete", "pods", "--as", "alice"]) == 0
    text = out.getvalue().splitlines()
    assert text == ["yes", "no"]


def test_ktctl_expose_and_set_image(k):
    import io

    api = k.ApiServerLite()
    api.create("Namespace", k.Namespace("default"))
    tmpl = k.make_pod("", labels={"app": "web"})
    tmpl.containers[0].image = "nginx:1.12"
    api.create("ReplicaSet", k.ReplicaSet(
        "web", replicas=3,
        selector=k.LabelSelector(match_labels={"app": "web"}),
        template=tmpl))
    out = io.StringIO()
    kt = k.Ktctl(api, out=out)
    assert kt.run(["expose", "rs", "web", "--port", "80",
                   "--target-port", "8080"]) == 0
    svc = api.get("Service", "default", "web")
    assert svc.selector == {"app": "web"}
    assert svc.ports[0].port == 80 and svc.ports[0].target_port == 8080
    assert kt.run(["set", "image", "rs", "web", "c0=nginx:1.13"]) == 0
    rs = api.get("ReplicaSet", "default", "web")
    assert rs.template.containers[0].image == "nginx:1.13"


def test_ktctl_get_watch_streams_changes(k):
    """kubectl get --watch: after the initial table, subsequent writes
    stream as ADDED/MODIFIED/DELETED rows until --watch-timeout."""
    import threading
    import time as _time

    api, kt, out = make_cli(k)
    api.store.create("Pod", k.make_pod("p0", cpu=10, memory=1 << 20))

    def mutate():
        _time.sleep(0.15)
        api.store.create("Pod", k.make_pod("p1", cpu=10, memory=1 << 20))
        _time.sleep(0.1)
        api.store.delete("Pod", "default", "p0")

    t = threading.Thread(target=mutate)
    t.start()
    rc = kt.run(["get", "pods", "--watch", "--watch-timeout", "1"])
    t.join()
    assert rc == 0
    text = out.getvalue()
    assert "ADDED" in text and "p1" in text
    assert "DELETED" in text
    # bad timeout: clean error
    assert kt.run(["get", "pods", "--watch", "--watch-timeout", "x"]) == 1


def test_hyperkube_dispatcher(k, tmp_path, capsys):
    """cmd/hyperkube analog: one entrypoint, component picked by the
    first argument."""

    assert k.hyperkube.main(["version"]) == 0
    assert "v1.7.0-tpu" in capsys.readouterr().out
    assert k.hyperkube.main([]) == 0  # usage
    assert k.hyperkube.main(["no-such-thing"]) == 1
    assert k.hyperkube.main(["apiserver", "--nodes", "3", "--once"]) == 0
    out = capsys.readouterr().out
    assert "listening on http://127.0.0.1:" in out
    workdir = str(tmp_path / "c")
    assert k.hyperkube.main(["ktadm", "preflight", "--workdir",
                             workdir]) == 0
    assert k.hyperkube.main(["ktadm", "init", "--workdir", workdir]) == 0
    assert k.hyperkube.main(["ktadm", "reset", "--workdir", workdir]) == 0


def test_rollout_pause_resume_freezes_controller(k):
    """kubectl rollout pause/resume: a paused deployment's rollout
    freezes (the controller skips it) and resumes where it left off."""

    api, kt, out = make_cli(k)
    factory = k.SharedInformerFactory(api.store)
    ctrl = k.DeploymentController(api.store, factory, record_events=False)
    factory.start()
    dep = k.Deployment("web", replicas=3,
                       selector=k.LabelSelector(match_labels={"app": "web"}),
                       template=k.make_pod("", labels={"app": "web"}, cpu=10))
    api.store.create("Deployment", dep)
    assert kt.run(["rollout", "pause", "deploy", "web"]) == 0
    assert "paused" in out.getvalue()
    factory.step_all()
    ctrl.pump()
    # controller skipped the paused deployment: no child RS created
    assert api.store.list("ReplicaSet")[0] == []
    # pausing twice is an error, like kubectl
    assert kt.run(["rollout", "pause", "deploy", "web"]) == 1
    assert kt.run(["rollout", "resume", "deploy", "web"]) == 0
    factory.step_all()
    ctrl.pump()
    rs = api.store.list("ReplicaSet")[0]
    assert len(rs) == 1 and rs[0].replicas == 3
    # unknown subcommand errors cleanly (restart is a real verb now)
    assert kt.run(["rollout", "bogus", "deploy", "web"]) == 1


def test_describe_shows_events_section(k):
    """kubectl describe ends with the object's events
    (describe.go DescribeEvents) — recorder events for the object key
    render as an Events: section; objects without events get none."""

    api, kt, out = make_cli(k)
    api.store.create("Pod", k.make_pod("web", cpu=10, memory=1 << 20))
    rec = k.EventRecorder(api.store, source="scheduler")
    rec.event("Pod", "default/web", "Warning", "FailedScheduling",
              "0/0 nodes available")
    rec.event("Pod", "default/web", "Warning", "FailedScheduling",
              "0/0 nodes available")  # dedup -> count 2
    assert kt.run(["describe", "pod", "web"]) == 0
    text = out.getvalue()
    assert "Events:" in text and "FailedScheduling" in text
    assert "\t2\t" in text  # correlated count
    out.truncate(0), out.seek(0)
    api.store.create("Pod", k.make_pod("quiet", cpu=10, memory=1 << 20))
    assert kt.run(["describe", "pod", "quiet"]) == 0
    assert "Events:" not in out.getvalue()


def test_describe_node_shows_cluster_scoped_events(k):
    """Cluster-scoped objects (Node) key their events by bare name —
    describe must match that convention, not '/name'."""

    api, kt, out = make_cli(k)
    api.store.create("Node", k.make_node("n1", cpu=1000, memory=1 << 31))
    rec = k.EventRecorder(api.store, source="nodelifecycle")
    rec.event("Node", "n1", "Warning", "NodeNotReady",
              "Node n1 status is now NotReady")
    assert kt.run(["describe", "node", "n1"]) == 0
    text = out.getvalue()
    assert "Events:" in text and "NodeNotReady" in text


def test_top_pods(k):
    api, kt, out = make_cli(k)
    p = k.make_pod("web", cpu=150, memory=1 << 20)
    p.node_name = "n1"
    p.annotations["bench/actual-mem"] = str(64 << 20)
    api.store.create("Pod", p)
    api.store.create("Pod", k.make_pod("pending", cpu=10, memory=1 << 20))
    assert kt.run(["top", "pods"]) == 0
    text = out.getvalue()
    assert "web  150m" in text and str(64 << 20) in text
    assert "pending" not in text  # no metrics for unscheduled pods
    assert kt.run(["top", "bogus"]) == 1


# ============================================================
# round5


class StampingWebhook:
    """Mutating backend: every pod gets an injected audit label."""

    def __init__(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                review = json.loads(self.rfile.read(length))
                obj = dict(review["request"]["object"])
                obj["metadata"] = dict(obj["metadata"])
                labels = dict(obj["metadata"].get("labels") or {})
                labels["audit/stamped"] = "true"
                obj["metadata"]["labels"] = labels
                body = json.dumps({"response": {
                    "allowed": True, "patchedObject": obj}}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._srv.server_address[1]}/admit"
        threading.Thread(target=self._srv.serve_forever,
                         daemon=True).start()

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()


def test_webhook_scheduler_cri_cli_together(k, tmp_path):
    backend = StampingWebhook()
    try:
        api = k.ApiServer()
        api.admission = k.AdmissionChain(
            k.default_plugins() + [k.GenericAdmissionWebhook([k.WebhookHook(
                name="stamper", url=backend.url, mutating=True,
                rules=[k.Rule(operations=["CREATE"], kinds=["Pod"])])])],
            store=api.store)
        api.store.create("Namespace", k.Namespace("default"))

        # a reserved node: capacity 2000m, 300m held back
        kubelet = k.HollowKubelet(
            api.store, k.make_node("n0", cpu=2000, memory=4 << 30),
            reserved=k.Resource(milli_cpu=300))
        kubelet.register()
        assert api.store.get("Node", "", "n0") \
            .allocatable.milli_cpu == 1700

        sched = k.Scheduler(api.store, record_events=False,
                            **DEVICE[k.root])
        sched.start()

        # create THROUGH the chain: the webhook stamps, scheduler binds,
        # the CRI kubelet runs it
        api.create("Pod", k.make_pod("web", cpu=200, memory=256 << 20))
        sched.run_until_drained()
        pod = api.store.get("Pod", "default", "web")
        assert pod.labels.get("audit/stamped") == "true"  # webhook ran
        assert pod.node_name == "n0"  # scheduler bound
        kubelet.handle_pod(pod)
        kubelet.step()
        assert api.store.get("Pod", "default", "web").phase == "Running"
        assert kubelet.runtime.ops.get("RunPodSandbox") == 1  # CRI ran it

        # the CLI previews then patches the running pod
        out = io.StringIO()
        kt = k.Ktctl(api, out=out)
        patch = json.dumps({"metadata": {"labels": {"tier": "fe"}}})
        assert kt.run(["patch", "pod", "web", "-p", patch]) == 0
        p = api.store.get("Pod", "default", "web")
        assert p.labels.get("tier") == "fe"
        assert p.labels.get("audit/stamped") == "true"  # stamp survives
        assert p.phase == "Running"  # patch preserved status
        assert p.node_name == "n0"  # and the binding
    finally:
        backend.stop()


# ============================================================
# federation


Gi = 1 << 30


# ------------------------------------------------------------------ planner


def _prefs(k, rebalance=False, **clusters):
    return k.ReplicaAllocationPreferences(
        rebalance=rebalance,
        clusters={name: v for name, v in clusters.items()})


def test_planner_even_split(k):
    plan, overflow = k.Planner(_prefs(k,
        **{"*": k.ClusterPreferences(weight=1)})).plan(
            10, ["a", "b"], key="default/web")
    assert plan == {"a": 5, "b": 5}
    assert overflow == {}


def test_planner_weighted(k):
    plan, _ = k.Planner(_prefs(k,
        a=k.ClusterPreferences(weight=3),
        b=k.ClusterPreferences(weight=1))).plan(8, ["a", "b"])
    assert plan == {"a": 6, "b": 2}


def test_planner_min_replicas_take_priority(k):
    plan, _ = k.Planner(_prefs(k,
        a=k.ClusterPreferences(min_replicas=4, weight=0),
        b=k.ClusterPreferences(weight=1))).plan(6, ["a", "b"])
    assert plan == {"a": 4, "b": 2}


def test_planner_max_replicas_cap(k):
    plan, _ = k.Planner(_prefs(k,
        a=k.ClusterPreferences(weight=1, max_replicas=2),
        b=k.ClusterPreferences(weight=1))).plan(10, ["a", "b"])
    assert plan == {"a": 2, "b": 8}


def test_planner_capacity_overflow(k):
    plan, overflow = k.Planner(_prefs(k,
        rebalance=True, **{"*": k.ClusterPreferences(weight=1)})).plan(
            10, ["a", "b"], capacity={"a": 2})
    assert plan == {"a": 2, "b": 8}
    assert overflow.get("a", 0) >= 1  # a wanted more than its capacity


def test_planner_no_rebalance_keeps_current_layout(k):
    """rebalance=false: cluster b keeps its 7 even though an even split
    would say 5/5 (the anti-thrash preallocation, planner.go:116-140)."""
    plan, _ = k.Planner(_prefs(k,
        **{"*": k.ClusterPreferences(weight=1)})).plan(
            10, ["a", "b"], current={"b": 7})
    assert plan == {"a": 3, "b": 7}


def test_planner_unlisted_cluster_without_wildcard_gets_zero(k):
    plan, _ = k.Planner(_prefs(k, a=k.ClusterPreferences(weight=1))).plan(
        5, ["a", "b"])
    assert plan == {"a": 5, "b": 0}


def test_planner_preferences_json_wire_format(k):
    p = k.ReplicaAllocationPreferences.parse(json.dumps({
        "rebalance": True,
        "clusters": {"*": {"weight": 2, "minReplicas": 1,
                           "maxReplicas": 9}}}))
    assert p.rebalance is True
    assert p.clusters["*"] == k.ClusterPreferences(1, 9, 2)


# --------------------------------------------------------- two-cluster rig


class _MemberCluster:
    """A real member: apiserver + RS controller + scheduler."""

    def __init__(self, k, name: str, n_nodes: int = 4):
        self.name = name
        self.api = k.ApiServerLite()
        for i in range(n_nodes):
            self.api.create("Node", k.make_node(f"{name}-node-{i}",
                                                cpu=8000, memory=16 * Gi))
        self.factory = k.SharedInformerFactory(self.api)
        self.rsc = k.ReplicaSetController(self.api, self.factory,
                                          record_events=False)
        self.sched = k.Scheduler(self.api, record_events=False,
                                 **DEVICE[k.root])
        self.sched.start()

    def reconcile(self):
        self.factory.step_all()
        self.rsc.pump()
        self.sched.run_until_drained()

    def bound_pods(self):
        return [p for p in self.api.list("Pod")[0]
                if p.node_name and not p.deleted]


def _federated_rig(k):
    plane = k.FederationControlPlane()
    a, b = _MemberCluster(k, "alpha"), _MemberCluster(k, "beta")
    plane.join("alpha", a.api)
    plane.join("beta", b.api)
    ctrl = k.FederatedReplicaSetController(plane)
    return plane, ctrl, a, b


def _mk_frs(k, replicas=10, prefs=None):
    tmpl = k.ReplicaSet(
        name="web", selector=k.LabelSelector(match_labels={"app": "web"}),
        template=k.make_pod("", cpu=100, labels={"app": "web"}))
    frs = k.FederatedReplicaSet(name="web", replicas=replicas, template=tmpl)
    if prefs:
        frs.annotations[k.PREFERENCES_ANNOTATION] = prefs
    return frs


def test_federated_rs_spreads_5_5_and_runs_in_both_clusters(k):
    plane, ctrl, a, b = _federated_rig(k)
    plane.api.create(k.FEDERATED_RS_KIND, _mk_frs(k, 10))
    ctrl.sync_all()
    assert a.api.get("ReplicaSet", "default", "web").replicas == 5
    assert b.api.get("ReplicaSet", "default", "web").replicas == 5
    a.reconcile()
    b.reconcile()
    assert len(a.bound_pods()) == 5
    assert len(b.bound_pods()) == 5
    # status aggregation on the next sync
    a.factory.step_all(); a.rsc.pump()
    b.factory.step_all(); b.rsc.pump()
    ctrl.sync_all()
    frs = plane.api.get(k.FEDERATED_RS_KIND, "default", "web")
    assert frs.ready_replicas == 0  # pods Pending (no kubelet in this rig)


def test_rebalance_on_cluster_loss(k):
    """beta dies -> next sync moves all 10 replicas to alpha (done
    condition of VERDICT r3 #8)."""
    plane, ctrl, a, b = _federated_rig(k)
    plane.api.create(k.FEDERATED_RS_KIND, _mk_frs(k,
        10, prefs=json.dumps({"rebalance": True,
                              "clusters": {"*": {"weight": 1}}})))
    ctrl.sync_all()
    assert a.api.get("ReplicaSet", "default", "web").replicas == 5
    plane.mark_ready("beta", False)  # cluster controller saw it die
    ctrl.sync_all()
    assert a.api.get("ReplicaSet", "default", "web").replicas == 10
    a.reconcile()
    assert len(a.bound_pods()) == 10
    # recovery: beta comes back, replicas spread again
    plane.mark_ready("beta", True)
    ctrl.sync_all()
    assert a.api.get("ReplicaSet", "default", "web").replicas == 5
    assert b.api.get("ReplicaSet", "default", "web").replicas == 5


def test_unjoin_deregisters_and_replicas_move(k):
    plane, ctrl, a, b = _federated_rig(k)
    plane.api.create(k.FEDERATED_RS_KIND, _mk_frs(k,
        10, prefs=json.dumps({"rebalance": True,
                              "clusters": {"*": {"weight": 1}}})))
    ctrl.sync_all()
    plane.unjoin("beta")
    ctrl.sync_all()
    assert a.api.get("ReplicaSet", "default", "web").replicas == 10
    # beta keeps nothing federated-owned after unjoin sync? the reference
    # leaves unjoined clusters' objects alone (unjoin is deregistration) —
    # the child RS simply stops being reconciled
    assert "beta" not in plane.members


# ---------------------------------------------------------------- kubefed


def test_ktctl_federate_verbs_end_to_end(k):
    plane = k.FederationControlPlane()
    a, b = _MemberCluster(k, "alpha"), _MemberCluster(k, "beta")
    out = io.StringIO()
    kt = k.Ktctl(plane.api, out=out, federation=plane,
                 federation_contexts={"alpha": a.api, "beta": b.api})
    assert kt.run(["federate", "join", "alpha"]) == 0
    assert kt.run(["federate", "join", "beta"]) == 0
    assert kt.run(["federate", "create", "rs", "web",
                   "--replicas", "10"]) == 0
    assert kt.run(["federate", "sync"]) == 0
    assert a.api.get("ReplicaSet", "default", "web").replicas == 5
    assert b.api.get("ReplicaSet", "default", "web").replicas == 5
    assert kt.run(["federate", "scale", "rs", "web",
                   "--replicas", "16"]) == 0
    assert kt.run(["federate", "sync"]) == 0
    assert a.api.get("ReplicaSet", "default", "web").replicas \
        + b.api.get("ReplicaSet", "default", "web").replicas == 16
    assert kt.run(["federate", "clusters"]) == 0
    assert kt.run(["federate", "get"]) == 0
    text = out.getvalue()
    assert "alpha\tReady" in text and "beta\tReady" in text
    assert "default/web" in text
    assert kt.run(["federate", "unjoin", "beta"]) == 0
    assert kt.run(["federate", "sync"]) == 0
    assert a.api.get("ReplicaSet", "default", "web").replicas == 16


# ----------------------------------------- federated Deployment + Service DNS


def test_federated_deployment_spreads_and_rescales(k):

    plane = k.FederationControlPlane()
    east, west = k.ApiServerLite(), k.ApiServerLite()
    plane.join("east", east, zone="us-east1-a", region="us-east1")
    plane.join("west", west, zone="us-west1-b", region="us-west1")
    tmpl = k.Deployment(name="web", namespace="default",
                        selector=k.LabelSelector(match_labels={"app": "web"}),
                        template=k.make_pod("", labels={"app": "web"}, cpu=50))
    plane.api.create(k.FEDERATED_DEPLOY_KIND, k.FederatedDeployment(
        name="web", replicas=6, template=tmpl))
    ctrl = k.FederatedDeploymentController(plane)
    ctrl.sync_all()
    assert east.get("Deployment", "default", "web").replicas == 3
    assert west.get("Deployment", "default", "web").replicas == 3
    # cluster loss: all replicas move to the survivor
    plane.mark_ready("west", False)
    ctrl.sync_all()
    assert east.get("Deployment", "default", "web").replicas == 6
    import pytest as _pytest
    with _pytest.raises(k.NotFound):
        west.get("Deployment", "default", "web")


def _dns_rig(k):

    plane = k.FederationControlPlane()
    east, west = k.ApiServerLite(), k.ApiServerLite()
    plane.join("east", east, zone="us-east1-a", region="us-east1")
    plane.join("west", west, zone="us-west1-b", region="us-west1")
    dns = k.InMemoryDNSProvider()
    ctrl = k.FederatedServiceController(plane, dns=dns, federation="fed",
                                        domain="example.com")
    fsvc = k.FederatedService(name="api", template=k.Service(
        name="api", selector={"app": "api"},
        ports=[k.ServicePort(port=80)]))
    plane.api.create(k.FEDERATED_SERVICE_KIND, fsvc)
    return plane, east, west, dns, ctrl, fsvc


def test_federated_service_materializes_and_writes_dns(k):

    plane, east, west, dns, ctrl, fsvc = _dns_rig(k)
    ctrl.sync_all()
    # services exist in both member clusters
    assert east.get("Service", "default", "api").name == "api"
    assert west.get("Service", "default", "api").name == "api"
    # no endpoints anywhere yet: zone records CNAME up the chain, and the
    # chain dead-ends (no global A record)
    zname = "api.default.fed.svc.us-east1-a.us-east1.example.com"
    assert dns.lookup(zname).rtype == "CNAME"
    assert dns.resolve(zname) == []
    # east gains healthy endpoints + an LB ingress IP
    svc = east.get("Service", "default", "api")
    svc.load_balancer_ip = "34.1.1.1"
    east.update("Service", svc)
    east.create("Endpoints", k.Endpoints("api", "default", addresses=[
        k.EndpointAddress(pod_key="default/p1", node_name="n1")]))
    ctrl.sync_all()
    # east zone resolves locally; west zone CNAMEs to region then global,
    # landing on east's ingress
    assert dns.resolve(zname) == ["34.1.1.1"]
    wz = "api.default.fed.svc.us-west1-b.us-west1.example.com"
    assert dns.lookup(wz).rtype == "CNAME"
    assert dns.resolve(wz) == ["34.1.1.1"]
    fed = plane.api.get("FederatedService", "default", "api")
    assert fed.serving_clusters == ["east"]


def test_federated_service_dns_failover_on_cluster_loss(k):

    plane, east, west, dns, ctrl, fsvc = _dns_rig(k)
    for member, ip in ((east, "34.1.1.1"), (west, "35.2.2.2")):
        ctrl.sync_all()
        svc = member.get("Service", "default", "api")
        svc.load_balancer_ip = ip
        member.update("Service", svc)
        member.create("Endpoints", k.Endpoints("api", "default", addresses=[
            k.EndpointAddress(pod_key="default/p", node_name="n")]))
    ctrl.sync_all()
    gname = "api.default.fed.svc.example.com"
    assert dns.resolve(gname) == ["34.1.1.1", "35.2.2.2"]
    # west cluster dies: its zone record fails over through the chain
    plane.mark_ready("west", False)
    ctrl.sync_all()
    wz = "api.default.fed.svc.us-west1-b.us-west1.example.com"
    assert dns.resolve(wz) == ["34.1.1.1"]
    assert dns.resolve(gname) == ["34.1.1.1"]


def test_federate_cli_dns_persists_and_get_lists_all_kinds(k):

    plane = k.FederationControlPlane()
    east, west = k.ApiServerLite(), k.ApiServerLite()
    api = k.ApiServer()
    api.store.create("Namespace", k.Namespace("default"))
    out = io.StringIO()
    kt = k.Ktctl(api, out=out, federation=plane,
                 federation_contexts={"east": east, "west": west})
    assert kt.run(["federate", "join", "east"]) == 0
    assert kt.run(["federate", "join", "west"]) == 0
    assert kt.run(["federate", "create", "deploy", "web",
                   "--replicas", "4"]) == 0
    assert kt.run(["federate", "create", "service", "api"]) == 0
    assert kt.run(["federate", "sync"]) == 0
    # endpoints appear in east; a SECOND sync (fresh controller instance)
    # must see the same DNS zone — records persist on the plane
    svc = east.get("Service", "default", "api")
    svc.load_balancer_ip = "34.9.9.9"
    east.update("Service", svc)
    east.create("Endpoints", k.Endpoints("api", "default", addresses=[
        k.EndpointAddress(pod_key="default/p", node_name="n")]))
    assert kt.run(["federate", "sync"]) == 0
    out.truncate(0), out.seek(0)
    assert kt.run(["federate", "dns", "api"]) == 0
    assert "34.9.9.9" in out.getvalue()
    out.truncate(0), out.seek(0)
    assert kt.run(["federate", "get"]) == 0
    text = out.getvalue()
    assert "federateddeployment/default/web" in text
    assert "federatedservice/default/api" in text
    assert "serving=east" in text


def test_federated_configmap_secret_propagation(k):
    """federatedtypes/{configmap,secret}.go: federated config objects are
    copied into every ready member, drift is overwritten, deletion
    removes managed member copies, and a cluster joining late converges."""

    plane = k.FederationControlPlane()
    east, west = k.ApiServerLite(), k.ApiServerLite()
    plane.join("east", east)
    ctrl = k.FederatedPropagationController(plane)
    plane.api.create("FederatedConfigMap",
                     k.ConfigMap("settings", "default", data={"mode": "on"}))
    plane.api.create("FederatedSecret",
                     k.Secret("creds", "default", data={"t": "c2VjcmV0"}))
    ctrl.sync_all()
    cm = east.get("ConfigMap", "default", "settings")
    # payload copied VERBATIM (no marker key injected into data)
    assert cm.data == {"mode": "on"}
    assert cm.annotations["federation.kubernetes.io/managed"] == "true"
    assert east.get("Secret", "default", "creds").data == {"t": "c2VjcmV0"}
    # drift in a member is overwritten on the next sync
    drifted = east.get("ConfigMap", "default", "settings")
    drifted.data = {"mode": "tampered"}
    east.update("ConfigMap", drifted)
    ctrl.sync_all()
    assert east.get("ConfigMap", "default", "settings").data["mode"] == "on"
    # late joiner converges
    plane.join("west", west)
    ctrl.sync_all()
    assert west.get("ConfigMap", "default", "settings").data["mode"] == "on"
    # a member-local object colliding with a federated one is NEVER
    # adopted: it survives untouched and surfaces as a conflict
    west.create("ConfigMap", k.ConfigMap("collide", "default",
                                         data={"local": "data"}))
    plane.api.create("FederatedConfigMap",
                     k.ConfigMap("collide", "default", data={"fed": "x"}))
    ctrl.sync_all()
    assert west.get("ConfigMap", "default", "collide").data \
        == {"local": "data"}
    assert any("west/ConfigMap/default/collide" == c
               for c in ctrl.conflicts)
    # an unmanaged member-local configmap survives; the managed copy goes
    # when the federated parent is deleted
    east.create("ConfigMap", k.ConfigMap("local-only", "default",
                                         data={"k": "v"}))
    plane.api.delete("FederatedConfigMap", "default", "settings")
    ctrl.sync_all()
    import pytest as _pytest

    with _pytest.raises(k.NotFound):
        east.get("ConfigMap", "default", "settings")
    assert east.get("ConfigMap", "default", "local-only").data["k"] == "v"


def test_federated_daemonset_everywhere(k):
    """federatedtypes/daemonset.go: no replica planning — the DaemonSet
    lands in every ready cluster, drift reconciles, managed copies go
    with the parent."""

    plane = k.FederationControlPlane()
    east, west = k.ApiServerLite(), k.ApiServerLite()
    plane.join("east", east)
    plane.join("west", west)
    ds = k.DaemonSet("logger", "default",
                     template=k.make_pod("", labels={"app": "log"}, cpu=10))
    plane.api.create(k.FEDERATED_DS_KIND, ds)
    ctrl = k.FederatedDaemonSetController(plane)
    ctrl.sync_all()
    for member in (east, west):
        got = member.get("DaemonSet", "default", "logger")
        assert got.annotations["federation.kubernetes.io/managed"] == "true"
    # member status fields do NOT count as drift
    cur = east.get("DaemonSet", "default", "logger")
    cur.desired_scheduled = 5
    east.update("DaemonSet", cur)
    rv_before = east.get("DaemonSet", "default", "logger").resource_version
    ctrl.sync_all()
    assert east.get("DaemonSet", "default",
                    "logger").resource_version == rv_before
    # parent deletion removes managed copies
    plane.api.delete(k.FEDERATED_DS_KIND, "default", "logger")
    ctrl.sync_all()
    import pytest as _pytest

    with _pytest.raises(k.NotFound):
        east.get("DaemonSet", "default", "logger")


def test_federated_daemonset_never_adopts_local(k):
    """The shared propagation body's conflict guard applies to DaemonSets
    too: a member-local DaemonSet colliding with a federated one is
    neither overwritten nor later deleted."""

    plane = k.FederationControlPlane()
    east = k.ApiServerLite()
    plane.join("east", east)
    east.create("DaemonSet", k.DaemonSet(
        "logger", "default",
        template=k.make_pod("", labels={"local": "yes"}, cpu=5)))
    plane.api.create(k.FEDERATED_DS_KIND, k.DaemonSet(
        "logger", "default",
        template=k.make_pod("", labels={"fed": "yes"}, cpu=10)))
    ctrl = k.FederatedDaemonSetController(plane)
    ctrl.sync_all()
    local = east.get("DaemonSet", "default", "logger")
    assert local.template.labels == {"local": "yes"}  # untouched
    assert "east/DaemonSet/default/logger" in ctrl.conflicts
    plane.api.delete(k.FEDERATED_DS_KIND, "default", "logger")
    ctrl.sync_all()
    # local object survives the parent deletion
    assert east.get("DaemonSet", "default", "logger").template.labels \
        == {"local": "yes"}



# ============================================================
# the port's departure in cli/ktctl.py: PyYAML imported where it is used

_NO_YAML = '''
import io, json, sys
sys.modules["yaml"] = None
sys.modules["jax"] = None
sys.modules["kubernetes_tpu"] = None
from kubernetes_tpu_torch.api.types import make_node
from kubernetes_tpu_torch.api.workloads import Namespace
from kubernetes_tpu_torch.cli.ktctl import Ktctl
from kubernetes_tpu_torch.client.informer import SharedInformerFactory
from kubernetes_tpu_torch.controllers.deployment import DeploymentController
from kubernetes_tpu_torch.controllers.replicaset import ReplicaSetController
from kubernetes_tpu_torch.engine.scheduler import Scheduler
from kubernetes_tpu_torch.nodes import HollowFleet
from kubernetes_tpu_torch.server.apiserver import ApiServer

api = ApiServer()
store = api.store
store.create("Namespace", Namespace("default"))
factory = SharedInformerFactory(store)
fleet = HollowFleet(store, factory)
for i in range(3):
    fleet.add_node(make_node(f"n{i}", cpu=4000, memory=8 << 30))
dep = DeploymentController(store, factory, record_events=False)
rs = ReplicaSetController(store, factory, record_events=False)
sched = Scheduler(store, record_events=False, device="cpu")
sched.start()
out = io.StringIO()
kt = Ktctl(api, out=out, kubelets=fleet.kubelets)


def run(*argv):
    out.truncate(0)
    out.seek(0)
    assert kt.run(list(argv)) == 0, (argv, out.getvalue())
    return out.getvalue()


def converge():
    for _ in range(4):
        while factory.step_all() + dep.pump() + rs.pump():
            pass
        sched.run_until_drained()
        factory.step_all()
        fleet.step()
        factory.step_all()


got = {}
run("run", "web", "--image=nginx:1.13", "--replicas=2")
converge()
run("patch", "deployment", "web", "-p", json.dumps({"template": {
    "annotations": {"bench/log-lines": "one\\ntwo",
                    "bench/exec-id": "uid=0"}}}))
converge()
got["rollout"] = run("rollout", "status", "deployment", "web").strip()
got["json"] = [d["replicas"] for d in json.loads(
    run("get", "deployments", "-o", "json"))]
run("scale", "deployment", "web", "--replicas=3")
converge()
pods = sorted(p.name for p in store.list("Pod")[0]
              if p.phase == "Running" and not p.deleted)
got["running"] = len(pods)
got["wide"] = len(run("get", "pods", "-o", "wide").splitlines())
got["name"] = len(run("get", "pods", "-o", "name").split())
got["logs"] = run("logs", pods[0], "--tail", "1").strip()
got["exec"] = run("exec", pods[0], "--", "id").strip()
got["top"] = "n0" in run("top", "nodes")
node = store.get("Pod", "default", pods[0]).node_name
run("cordon", node)
got["drain"] = run("drain", node).count("evicted")
converge()
got["after_drain"] = sorted(
    p.node_name == node for p in store.list("Pod")[0]
    if p.phase == "Running" and not p.deleted)
try:
    kt.run(["get", "pods", "-o", "yaml"])
    got["yaml"] = "printed"
except ImportError:
    got["yaml"] = "ImportError"
got["leaked"] = sorted(m for m in sys.modules
                       if m.split(".")[0] in ("yaml", "jax", "kubernetes_tpu")
                       and sys.modules[m] is not None)
print(json.dumps(got))
'''


def test_ktctl_runs_yaml_free_verbs_with_yaml_blocked():
    """With PyYAML (and jax and the reference) blocked, the port's ktctl
    imports and runs run, patch -p, rollout status, get -o json / wide /
    name, scale, logs, exec, top, cordon and drain; only -o yaml needs
    PyYAML, and says so with an ImportError."""
    done = subprocess.run([sys.executable, "-c", _NO_YAML], cwd=_REPO,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert got == {
        "rollout": 'deployments "web" successfully rolled out',
        "json": [2], "running": 3, "wide": 4, "name": 3,
        "logs": "two", "exec": "uid=0", "top": True, "drain": 1,
        "after_drain": [False, False, False], "yaml": "ImportError",
        "leaked": []}


_MANIFEST_RS = {
    "kind": "ReplicaSet", "name": "web", "namespace": "default",
    "replicas": 3, "labels": {"app": "web"},
    "selector": {"match_labels": {"app": "web"}},
}
_MANIFEST_POD = {
    "apiVersion": "v1", "kind": "Pod",
    "metadata": {"name": "nginx", "namespace": "default",
                 "labels": {"app": "nginx"}},
    "spec": {"containers": [{
        "name": "c", "image": "nginx:1.13",
        "resources": {"requests": {"cpu": "250m", "memory": "64Mi"}}}]},
}


def _yaml_session(k, tmp_path):
    """create -f of two documents, apply -f of an edited one, then -o yaml
    of each kind; returns the printed text and the stored objects in wire
    JSON."""
    api, kt, out = make_cli(k)
    docs = tmp_path / f"{k.root}.yaml"
    docs.write_text(yaml.safe_dump_all([_MANIFEST_RS, _MANIFEST_POD]))
    texts = []

    def run(*argv):
        out.truncate(0)
        out.seek(0)
        assert kt.run(list(argv)) == 0, out.getvalue()
        texts.append(out.getvalue())

    run("create", "-f", str(docs))
    edited = dict(_MANIFEST_RS, replicas=5,
                  labels={"app": "web", "tier": "fe"})
    docs.write_text(yaml.safe_dump(edited))
    run("apply", "-f", str(docs))
    run("get", "rs", "web", "-o", "yaml")
    run("get", "pods", "-o", "yaml")
    stored = {kind: [json.dumps(k.cli_ktctl.wire.encode(o, kind=kind),
                                sort_keys=True)
                     for o in api.store.list(kind)[0]]
              for kind in ("ReplicaSet", "Pod")}
    return texts, stored


def test_yaml_verbs_equal_in_both_packages(tmp_path):
    """Where PyYAML is installed, create -f, apply -f and -o yaml print
    the same text and store the same objects in both packages."""
    ref = _yaml_session(PKGS[REF], tmp_path)
    port = _yaml_session(PKGS[PORT], tmp_path)
    assert port == ref
    texts, stored = port
    assert "replicas: 5" in texts[2] and "tier: fe" in texts[2]
    assert len(stored["Pod"]) == 1 and len(stored["ReplicaSet"]) == 1
