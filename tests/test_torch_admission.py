"""The port's admission chain (admission/, quota/, security/) against the
reference's. The bodies of tests/test_admission_sweep.py,
tests/test_admission_webhook.py and tests/test_security.py run on both
packages (the `k` fixture); then every default plugin, PodPreset, PSP and
PersistentVolumeLabel (on each package's FakeCloud) get the same
requests in both packages and must give the same admitted object (wire
JSON bytes) or the same Rejected message; rollback restores quota usage
in both; a webhook backend receives byte-equal AdmissionReviews from
both."""

from __future__ import annotations

import importlib
import json
import random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "chain": "admission.chain", "plugins": "admission.plugins",
    "webhook": "admission.webhook", "rbac": "api.rbac",
    "types": "api.types", "workloads": "api.workloads",
    "cluster": "api.cluster", "serde": "api.serde", "wire": "api.wire",
    "oracle_ext": "ops.oracle_ext", "apiserver": "server.apiserver",
    "lite": "server.apiserver_lite", "sc": "security.securitycontext",
    "psp": "security.psp", "quota": "quota", "features": "utils.features",
    "cloud": "cloud",
}

PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


class WebhookBackend:
    """Scriptable admission backend. `decide(review) -> response dict`."""

    def __init__(self, decide):
        self.decide = decide
        self.reviews = []
        self.raw = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                outer.raw.append(raw)
                review = json.loads(raw)
                outer.reviews.append(review)
                body = json.dumps(outer.decide(review)).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}/admit"

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()


def mk_server(k, *plugins):
    api = k.ApiServer()
    api.admission = k.AdmissionChain(list(plugins), store=api.store)
    return api


# ------------------------------------------ tests/test_admission_sweep.py


def test_podpreset_injects_into_matching_pods(k):
    api = mk_server(k, k.PodPresetPlugin())
    api.store.create("PodPreset", k.PodPreset(
        name="env", selector={"app": "web"},
        annotations={"preset/DB_HOST": "db.local"},
        volumes=[k.Volume(name="cache")]))
    pod = k.make_pod("p", cpu=10, labels={"app": "web"})
    api.create("Pod", pod)
    stored = api.store.get("Pod", "default", "p")
    assert stored.annotations["preset/DB_HOST"] == "db.local"
    assert any(v.name == "cache" for v in stored.volumes)
    assert stored.annotations[
        "podpreset.admission.kubernetes.io/podpreset-env"] != ""
    other = k.make_pod("q", cpu=10, labels={"app": "api"})
    api.create("Pod", other)
    assert "preset/DB_HOST" not in \
        api.store.get("Pod", "default", "q").annotations


def test_podpreset_conflict_skips_all_presets_without_rejecting(k):
    api = mk_server(k, k.PodPresetPlugin())
    api.store.create("PodPreset", k.PodPreset(
        name="a", selector={"app": "web"},
        annotations={"preset/KEY": "from-a"}))
    api.store.create("PodPreset", k.PodPreset(
        name="b", selector={"app": "web"},
        annotations={"preset/KEY": "from-b"}))
    api.create("Pod", k.make_pod("p", cpu=10, labels={"app": "web"}))
    stored = api.store.get("Pod", "default", "p")
    assert "preset/KEY" not in stored.annotations
    assert not any(a.startswith("podpreset.admission")
                   for a in stored.annotations)


def test_hard_antiaffinity_topology_limited_to_hostname(k):
    api = mk_server(k, k.LimitPodHardAntiAffinityTopology())
    ok = k.make_pod("ok", cpu=10)
    ok.affinity = k.Affinity(pod_anti_affinity=k.PodAffinity(
        required_terms=[k.PodAffinityTerm(
            topology_key="kubernetes.io/hostname")]))
    api.create("Pod", ok)
    bad = k.make_pod("bad", cpu=10)
    bad.affinity = k.Affinity(pod_anti_affinity=k.PodAffinity(
        required_terms=[k.PodAffinityTerm(
            topology_key="failure-domain.beta.kubernetes.io/zone")]))
    with pytest.raises(k.Rejected) as e:
        api.create("Pod", bad)
    assert "topologyKey" in str(e.value)


def test_deny_escalating_exec(k):
    chain = k.AdmissionChain([k.DenyEscalatingExec()])
    priv = k.make_pod("priv", cpu=10)
    priv.containers[0].security_context = k.SecurityContext(privileged=True)
    with pytest.raises(k.Rejected):
        chain.admit(k.AdmissionRequest(k.CONNECT, "Pod", "default", "priv",
                                       obj=priv, subresource="exec"))
    hostnet = k.make_pod("hn", cpu=10)
    hostnet.host_network = True
    with pytest.raises(k.Rejected):
        chain.admit(k.AdmissionRequest(k.CONNECT, "Pod", "default", "hn",
                                       obj=hostnet, subresource="attach"))
    chain.admit(k.AdmissionRequest(k.CONNECT, "Pod", "default", "ok",
                                   obj=k.make_pod("ok", cpu=10),
                                   subresource="exec"))
    chain.admit(k.AdmissionRequest(k.CONNECT, "Pod", "default", "priv",
                                   obj=priv, subresource="portforward"))


def test_owner_references_need_delete_permission(k):
    def authorize(user, verb, kind, namespace):
        return user is not None and user.name == "controller"

    chain = k.AdmissionChain(
        [k.OwnerReferencesPermissionEnforcement(authorize)])
    owned = k.make_pod("p", cpu=10, owner=("ReplicaSet", "rs-1"))
    with pytest.raises(k.Rejected):
        chain.admit(k.AdmissionRequest(
            "CREATE", "Pod", "default", "p", obj=owned,
            user=k.UserInfo("mallory")))
    chain.admit(k.AdmissionRequest(
        "CREATE", "Pod", "default", "p", obj=owned,
        user=k.UserInfo("controller")))
    old = k.make_pod("q", cpu=10, owner=("ReplicaSet", "rs-1"))
    new = k.make_pod("q", cpu=10, owner=("ReplicaSet", "rs-1"))
    new.labels["x"] = "y"
    chain.admit(k.AdmissionRequest(
        "UPDATE", "Pod", "default", "q", obj=new, old_obj=old,
        user=k.UserInfo("mallory")))
    stolen = k.make_pod("q", cpu=10, owner=("ReplicaSet", "rs-2"))
    with pytest.raises(k.Rejected):
        chain.admit(k.AdmissionRequest(
            "UPDATE", "Pod", "default", "q", obj=stolen, old_obj=old,
            user=k.UserInfo("mallory")))


def test_persistent_volume_label_stamps_cloud_zone(k):
    cloud = k.FakeCloud()
    cloud.create_disk("disk-1", zone="zone-b", region="region-2")
    api = mk_server(k, k.PersistentVolumeLabel(cloud))
    pv = k.PersistentVolume(
        name="pv-1", source=k.Volume(kind=k.VolumeKind.GCE_PD,
                                     volume_id="disk-1"),
        labels={k.ZONE_LABEL: "client-lie"})
    api.create("PersistentVolume", pv)
    stored = api.store.get("PersistentVolume", "", "pv-1")
    assert stored.labels[k.ZONE_LABEL] == "zone-b"
    assert stored.labels[k.ZONE_REGION_LABEL] == "region-2"
    nfs = k.PersistentVolume(name="pv-2",
                             source=k.Volume(kind=k.VolumeKind.OTHER,
                                             volume_id="srv:/export"))
    api.create("PersistentVolume", nfs)
    assert k.ZONE_LABEL not in api.store.get(
        "PersistentVolume", "", "pv-2").labels
    ghost = k.PersistentVolume(name="pv-3",
                               source=k.Volume(kind=k.VolumeKind.GCE_PD,
                                               volume_id="no-such-disk"))
    with pytest.raises(k.Rejected):
        api.create("PersistentVolume", ghost)


# ---------------------------------------- tests/test_admission_webhook.py


def test_validating_webhook_denies_through_the_chain(k):
    backend = WebhookBackend(lambda review: {
        "response": {"allowed":
                     "forbidden" not in review["request"]["name"],
                     "status": {"message": "name is forbidden"}}})
    try:
        hook = k.WebhookHook(name="name-police", url=backend.url,
                             rules=[k.webhook.Rule(operations=["CREATE"],
                                                   kinds=["Pod"])])
        api = mk_server(k, k.GenericAdmissionWebhook([hook]))
        api.create("Pod", k.make_pod("ok-pod", cpu=10))
        with pytest.raises(k.Rejected) as e:
            api.create("Pod", k.make_pod("forbidden-pod", cpu=10))
        assert "name-police" in str(e.value)
        assert "name is forbidden" in str(e.value)
        assert [p.name for p in api.store.list("Pod")[0]] == ["ok-pod"]
        assert backend.reviews[0]["request"]["object"]["metadata"][
            "name"] == "ok-pod"
    finally:
        backend.stop()


def test_mutating_webhook_patches_the_object(k):
    def decide(review):
        obj = dict(review["request"]["object"])
        obj["metadata"].setdefault("labels", {})["injected"] = "true"
        return {"response": {"allowed": True, "patchedObject": obj}}

    backend = WebhookBackend(decide)
    try:
        hook = k.WebhookHook(name="injector", url=backend.url, mutating=True,
                             rules=[k.webhook.Rule(operations=["CREATE"],
                                                   kinds=["Pod"])])
        api = mk_server(k, k.GenericAdmissionWebhook([hook]))
        api.create("Pod", k.make_pod("p", cpu=10))
        assert api.store.get("Pod", "default", "p").labels.get(
            "injected") == "true"
    finally:
        backend.stop()


def test_mutating_webhook_cannot_steal_identity_or_wipe_fields(k):
    def decide(review):
        obj = dict(review["request"]["object"])
        obj["metadata"] = dict(obj["metadata"])
        obj["metadata"]["name"] = "evil"
        obj["metadata"]["namespace"] = "kube-system"
        obj["metadata"].setdefault("labels", {})["injected"] = "true"
        return {"response": {"allowed": True, "patchedObject": obj}}

    backend = WebhookBackend(decide)
    try:
        hook = k.WebhookHook(name="thief", url=backend.url, mutating=True,
                             rules=[k.webhook.Rule(operations=["CREATE"],
                                                   kinds=["Pod"])])
        api = mk_server(k, k.GenericAdmissionWebhook([hook]))
        pod = k.make_pod("p", cpu=10)
        pod.annotations["keep"] = "me"
        api.create("Pod", pod)
        stored = api.store.get("Pod", "default", "p")
        assert stored.labels.get("injected") == "true"
        assert stored.annotations.get("keep") == "me"
        with pytest.raises(Exception):
            api.store.get("Pod", "kube-system", "evil")
    finally:
        backend.stop()


def test_failure_policy_ignore_vs_fail(k):
    dead_url = "http://127.0.0.1:1/admit"
    rules = [k.webhook.Rule(operations=["CREATE"], kinds=["Pod"])]
    api = mk_server(k, k.GenericAdmissionWebhook(
        [k.WebhookHook(name="down", url=dead_url, rules=rules,
                       failure_policy="Ignore", timeout_s=0.5)]))
    api.create("Pod", k.make_pod("p1", cpu=10))
    api2 = mk_server(k, k.GenericAdmissionWebhook(
        [k.WebhookHook(name="down", url=dead_url, rules=rules,
                       failure_policy="Fail", timeout_s=0.5)]))
    with pytest.raises(k.Rejected) as e:
        api2.create("Pod", k.make_pod("p2", cpu=10))
    assert "down" in str(e.value)


def test_hook_configs_load_from_the_api(k):
    backend = WebhookBackend(lambda review: {
        "response": {"allowed": False, "status": {"message": "nope"}}})
    try:
        api = mk_server(k, k.GenericAdmissionWebhook())
        api.create("Pod", k.make_pod("before", cpu=10))
        api.store.create(
            "AdmissionHookConfiguration",
            k.AdmissionHookConfiguration(
                name="deny-all",
                hooks=[k.WebhookHook(
                    name="deny", url=backend.url,
                    rules=[k.webhook.Rule(operations=["CREATE"],
                                          kinds=["Pod"])])]))
        with pytest.raises(k.Rejected):
            api.create("Pod", k.make_pod("after", cpu=10))
        api.store.delete("AdmissionHookConfiguration", "", "deny-all")
        api.create("Pod", k.make_pod("after2", cpu=10))
    finally:
        backend.stop()


def test_image_policy_webhook_denies_by_image(k):
    backend = WebhookBackend(lambda review: {
        "status": {"allowed": not any(
            "evil" in c["image"]
            for c in review["spec"]["containers"]),
            "reason": "image on deny list"}})
    try:
        api = mk_server(k, k.ImagePolicyWebhook(backend.url))
        ok = k.make_pod("ok", cpu=10)
        ok.containers[0].image = "registry/app:v1"
        api.create("Pod", ok)
        bad = k.make_pod("bad", cpu=10)
        bad.containers[0].image = "registry/evil:v1"
        with pytest.raises(k.Rejected) as e:
            api.create("Pod", bad)
        assert "deny list" in str(e.value)
    finally:
        backend.stop()


def test_image_policy_default_allow_on_backend_error(k):
    dead = "http://127.0.0.1:1/review"
    api = mk_server(k, k.ImagePolicyWebhook(dead, default_allow=True,
                                            timeout_s=0.5))
    api.create("Pod", k.make_pod("p", cpu=10))
    api2 = mk_server(k, k.ImagePolicyWebhook(dead, default_allow=False,
                                             timeout_s=0.5))
    with pytest.raises(k.Rejected):
        api2.create("Pod", k.make_pod("p2", cpu=10))


def test_initializers_stamp_hide_and_release(k):
    api = mk_server(k, k.Initializers())
    api.store.create(
        "InitializerConfiguration",
        k.InitializerConfiguration(name="pod-init",
                                   initializers=["podimage.example.com"],
                                   kinds=["Pod"]))
    api.create("Pod", k.make_pod("p", cpu=10))
    stored = api.store.get("Pod", "default", "p")
    assert stored.annotations[k.PENDING_INITIALIZERS_ANNOTATION] \
        == "podimage.example.com"
    assert k.is_uninitialized(stored)
    assert api.list("Pod")[0] == []
    assert [p.name for p in
            api.list("Pod", include_uninitialized=True)[0]] == ["p"]
    k.remove_initializer(api.store, "Pod", stored, "podimage.example.com")
    visible = api.list("Pod")[0]
    assert [p.name for p in visible] == ["p"]
    assert not k.is_uninitialized(visible[0])


def test_initializers_only_touch_matching_kinds(k):
    api = mk_server(k, k.Initializers([k.InitializerConfiguration(
        name="svc-only", initializers=["x.example.com"],
        kinds=["Service"])]))
    api.create("Pod", k.make_pod("p", cpu=10))
    assert k.PENDING_INITIALIZERS_ANNOTATION not in \
        api.store.get("Pod", "default", "p").annotations


# ------------------------------------------------- tests/test_security.py


def test_container_overrides_pod_security_context(k):
    pod = k.make_pod("p")
    pod.security_context = k.PodSecurityContext(run_as_user=1000,
                                                run_as_non_root=True)
    c = pod.containers[0]
    assert k.sc.effective_run_as_user(pod, c) == 1000
    assert k.sc.effective_run_as_non_root(pod, c) is True
    c.security_context = k.SecurityContext(run_as_user=0,
                                           run_as_non_root=False)
    assert k.sc.effective_run_as_user(pod, c) == 0
    assert k.sc.effective_run_as_non_root(pod, c) is False


def test_privileged_gate(k):
    pod = k.make_pod("p")
    pod.containers[0].security_context = k.SecurityContext(privileged=True)
    assert k.Provider(k.PodSecurityPolicy("restricted")).validate(pod)
    assert not k.Provider(
        k.PodSecurityPolicy("priv", privileged=True)).validate(pod)


def test_host_network_gate(k):
    pod = k.make_pod("p")
    pod.host_network = True
    assert k.Provider(k.PodSecurityPolicy("restricted")).validate(pod)
    assert not k.Provider(
        k.PodSecurityPolicy("hostnet", host_network=True)).validate(pod)


def test_host_port_ranges(k):
    pod = k.make_pod("p", ports=[8080])
    assert k.Provider(k.PodSecurityPolicy("none")).validate(pod)
    assert k.Provider(k.PodSecurityPolicy(
        "low", host_ports=[(1, 1024)])).validate(pod)
    assert not k.Provider(k.PodSecurityPolicy(
        "web", host_ports=[(8000, 9000)])).validate(pod)


def test_volume_fstypes(k):
    pod = k.make_pod("p", volumes=[
        k.Volume(name="v", kind=k.VolumeKind.GCE_PD, volume_id="d1")])
    assert not k.Provider(k.PodSecurityPolicy("any")).validate(pod)
    assert not k.Provider(k.PodSecurityPolicy(
        "pd-only", volumes=["GCEPersistentDisk"])).validate(pod)
    errs = k.Provider(k.PodSecurityPolicy(
        "none", volumes=["Other"])).validate(pod)
    assert errs and "GCEPersistentDisk" in errs[0]


def test_must_run_as_non_root(k):
    psp = k.PodSecurityPolicy("nonroot",
                              run_as_user_rule=k.MUST_RUN_AS_NON_ROOT)
    root = k.make_pod("root")
    root.containers[0].security_context = k.SecurityContext(run_as_user=0)
    assert k.Provider(psp).validate(root)
    assert k.Provider(psp).validate(k.make_pod("unset"))
    marked = k.make_pod("marked")
    marked.security_context = k.PodSecurityContext(run_as_non_root=True)
    assert not k.Provider(psp).validate(marked)
    uid = k.make_pod("uid")
    uid.containers[0].security_context = k.SecurityContext(run_as_user=100)
    assert not k.Provider(psp).validate(uid)


def test_must_run_as_defaults_and_validates_range(k):
    psp = k.PodSecurityPolicy("ranged", run_as_user_rule=k.MUST_RUN_AS,
                              run_as_user_ranges=[(1000, 2000)])
    pod = k.make_pod("p")
    out = k.Provider(psp).apply_defaults(pod)
    assert pod.security_context is None
    assert out.security_context.run_as_user == 1000
    assert not k.Provider(psp).validate(out)
    bad = k.make_pod("bad")
    bad.security_context = k.PodSecurityContext(run_as_user=5)
    assert k.Provider(psp).validate(k.Provider(psp).apply_defaults(bad))


def test_read_only_root_filesystem_required(k):
    psp = k.PodSecurityPolicy("ro", read_only_root_filesystem=True)
    pod = k.make_pod("p")
    assert k.Provider(psp).validate(pod)
    pod.containers[0].security_context = k.SecurityContext(
        read_only_root_filesystem=True)
    assert not k.Provider(psp).validate(pod)


def _store(k):
    store = k.ApiServerLite()
    store.create("Namespace", k.Namespace("default"))
    return store


def _chain_with_psp(k, store):
    return k.AdmissionChain(
        k.default_plugins() + [k.PodSecurityPolicyPlugin()], store=store)


def _admit_pod(k, chain, pod):
    chain.admit(k.AdmissionRequest(operation=k.CREATE, kind="Pod",
                                   namespace=pod.namespace, name=pod.name,
                                   obj=pod))
    return pod


def test_admission_first_policy_by_name_wins_and_annotates(k):
    store = _store(k)
    store.create(k.PSP_KIND, k.PodSecurityPolicy(
        "a-ranged", run_as_user_rule=k.MUST_RUN_AS,
        run_as_user_ranges=[(1000, 2000)]))
    store.create(k.PSP_KIND, k.PodSecurityPolicy("b-anything",
                                                 privileged=True))
    pod = _admit_pod(k, _chain_with_psp(k, store), k.make_pod("p"))
    assert pod.annotations[k.PSP_ANNOTATION] == "a-ranged"
    assert pod.security_context.run_as_user == 1000


def test_admission_falls_through_to_permissive_policy(k):
    store = _store(k)
    store.create(k.PSP_KIND, k.PodSecurityPolicy("a-restricted"))
    store.create(k.PSP_KIND, k.PodSecurityPolicy("b-priv", privileged=True))
    pod = k.make_pod("p")
    pod.containers[0].security_context = k.SecurityContext(privileged=True)
    _admit_pod(k, _chain_with_psp(k, store), pod)
    assert pod.annotations[k.PSP_ANNOTATION] == "b-priv"


def test_admission_rejects_when_nothing_validates(k):
    store = _store(k)
    store.create(k.PSP_KIND, k.PodSecurityPolicy("restricted"))
    pod = k.make_pod("p")
    pod.host_network = True
    with pytest.raises(k.Rejected, match="hostNetwork"):
        _admit_pod(k, _chain_with_psp(k, store), pod)


def test_admission_rejects_with_no_policies(k):
    with pytest.raises(k.Rejected, match="no policies defined"):
        _admit_pod(k, _chain_with_psp(k, _store(k)), k.make_pod("p"))


def test_default_chain_without_psp_plugin_still_admits(k):
    chain = k.AdmissionChain(k.default_plugins(), store=_store(k))
    pod = k.make_pod("p")
    pod.host_network = True
    _admit_pod(k, chain, pod)


def test_full_apiserver_with_psp_end_to_end(k):
    srv = k.ApiServer(auth=False)
    srv.store.create("Namespace", k.Namespace("default"))
    srv.admission.plugins.append(k.PodSecurityPolicyPlugin())
    for plug in srv.admission.plugins:
        if hasattr(plug, "set_store"):
            plug.set_store(srv.store)
    srv.create(k.PSP_KIND, k.PodSecurityPolicy(
        "default", host_ports=[(8000, 9000)]))
    srv.create("Pod", k.make_pod("web", ports=[8080]))
    stored = srv.get("Pod", "default", "web")
    assert stored.annotations[k.PSP_ANNOTATION] == "default"
    with pytest.raises(k.Rejected):
        srv.create("Pod", k.make_pod("bad", ports=[22]))


def test_manifest_wire_format_carries_security_fields(k):
    manifest = {
        "metadata": {"name": "p", "namespace": "default"},
        "spec": {
            "hostNetwork": True,
            "securityContext": {"runAsUser": 1000, "runAsNonRoot": True},
            "containers": [{
                "name": "c0",
                "securityContext": {"privileged": True, "runAsUser": 0,
                                    "readOnlyRootFilesystem": True},
            }],
        },
    }
    pod = k.serde.decode_pod(manifest)
    assert pod.host_network is True
    assert pod.security_context.run_as_user == 1000
    assert pod.security_context.run_as_non_root is True
    csc = pod.containers[0].security_context
    assert csc.privileged is True and csc.run_as_user == 0
    assert csc.read_only_root_filesystem is True
    assert k.Provider(k.PodSecurityPolicy("restricted")).validate(pod)
    again = k.serde.decode_pod(k.serde.encode_pod(pod))
    assert again.host_network is True
    assert again.containers[0].security_context.privileged is True
    assert again.security_context.run_as_user == 1000


def test_psp_kind_decodes_over_the_wire(k):
    obj = k.wire.decode_any(
        {"name": "restricted", "privileged": False,
         "host_ports": [[8000, 9000]],
         "run_as_user_rule": "MustRunAsNonRoot"},
        kind=k.PSP_KIND)
    assert isinstance(obj, k.PodSecurityPolicy)
    assert obj.run_as_user_rule == "MustRunAsNonRoot"


# ------------------------------------------------ the port == the reference


def _bytes(k, kind, obj):
    return json.dumps(k.wire.encode(obj, kind=kind), sort_keys=True)


def _outcome(k, chain, op, kind, ns, obj, user=None, old=None):
    """('admitted', wire JSON bytes) or ('rejected', message)."""
    req = k.AdmissionRequest(op, kind, ns, getattr(obj, "name", ""),
                             obj=obj, old_obj=old, user=user)
    try:
        chain.admit(req)
    except k.Rejected as e:
        return ("rejected", str(e))
    return ("admitted", _bytes(k, kind, obj))


def _default_world(k):
    """A store that makes every default plugin act: namespaces with a
    node selector, default tolerations and a whitelist, one terminating;
    a LimitRange with defaults and bounds; a service account; priority
    classes; a default StorageClass; pod and cpu quotas."""
    store = k.ApiServerLite()
    store.create("Namespace", k.Namespace("default"))
    store.create("Namespace", k.Namespace("gone", phase="Terminating"))
    store.create("Namespace", k.Namespace("team", annotations={
        k.PodNodeSelector.ANNOTATION: "tier=web,region=r1",
        k.PodTolerationRestriction.DEFAULT_KEY: "dedicated=team",
        k.PodTolerationRestriction.WHITELIST_KEY:
            "dedicated=team;gpu=yes"}))
    store.create("LimitRange", k.LimitRange(
        name="lr", namespace="default", limits=[k.LimitRangeItem(
            type="Container", min={"cpu": 5}, max={"cpu": 2000},
            default={"memory": 512 << 20},
            default_request={"cpu": 100, "memory": 128 << 20})]))
    store.create("ServiceAccount", k.ServiceAccount(
        name="deployer", namespace="default"))
    store.create("PriorityClass", k.PriorityClass(name="high", value=1000))
    store.create("PriorityClass", k.PriorityClass(name="low", value=10))
    store.create("StorageClass", k.StorageClass(name="fast",
                                                is_default=True))
    store.create("ResourceQuota", k.ResourceQuota(
        name="pods", namespace="default", hard={"pods": 14}))
    store.create("ResourceQuota", k.ResourceQuota(
        name="cpu", namespace="default", hard={"cpu": 4000}))
    return store


def _default_requests(k, rng, n):
    """n seeded pod-create (and a few other) requests that reach every
    default plugin's admit and reject branches."""
    out = []
    for i in range(n):
        r = rng.randrange(14)
        ns = "default"
        pod = k.make_pod(f"p{i}", cpu=rng.choice([None, 1, 50, 300, 2500]),
                         memory=rng.choice([None, 64 << 20]),
                         labels={"app": f"a{rng.randrange(3)}"})
        user = None
        if r == 0:
            ns = "missing"
        elif r == 1:
            ns = "gone"
        elif r == 2:
            ns = "team"
        elif r == 3:
            ns = "team"
            pod.node_selector = {"tier": rng.choice(["web", "db"])}
        elif r == 4:
            ns = "team"
            pod.tolerations = [k.Toleration(
                key=rng.choice(["gpu", "spot"]), value="yes")]
        elif r == 5:
            pod.annotations[k.ServiceAccountPlugin.KEY] = rng.choice(
                ["deployer", "ghost"])
        elif r == 6:
            pod.priority_class = rng.choice(["high", "low", "nope"])
        elif r == 7:
            pod.tolerations = [k.Toleration(
                key=k.NOT_READY_TAINT, operator=k.TolerationOperator.EXISTS,
                effect=k.TaintEffect.NO_EXECUTE, toleration_seconds=60)]
        elif r == 8:
            pod.node_name = rng.choice(["n1", "n2"])
            user = k.UserInfo("system:node:n1", groups=["system:nodes"])
        elif r == 9:
            pvc = k.PersistentVolumeClaim(name=f"c{i}", namespace=ns)
            out.append(("CREATE", "PersistentVolumeClaim", ns, pvc, None))
            continue
        pod.namespace = ns
        out.append(("CREATE", "Pod", ns, pod, user))
    return out


def test_every_default_plugin_admits_and_rejects_alike():
    """The default chain over one seeded request stream: each request
    gives the same admitted object (wire JSON bytes) or the same Rejected
    message in both packages, and the stores' quotas end equal."""
    features = {root: PKGS[root].features for root in (REF, PORT)}
    for f in features.values():
        f.DEFAULT_FEATURE_GATE.set("PodPriority", True)
    try:
        results, quotas = {}, {}
        for root in (REF, PORT):
            k = PKGS[root]
            store = _default_world(k)
            chain = k.AdmissionChain(k.default_plugins(), store=store)
            got = []
            for op, kind, ns, obj, user in _default_requests(
                    k, random.Random(11), 160):
                out = _outcome(k, chain, op, kind, ns, obj, user=user)
                if out[0] == "admitted":
                    store.create(kind, obj)
                got.append(out)
            results[root] = got
            quotas[root] = sorted(
                (q.name, sorted(q.used.items()))
                for q in store.list("ResourceQuota")[0])
    finally:
        for f in features.values():
            f.DEFAULT_FEATURE_GATE.set("PodPriority", False)
    assert results[REF] == results[PORT]
    assert quotas[REF] == quotas[PORT]
    kinds = {o[0] for o in results[PORT]}
    assert kinds == {"admitted", "rejected"}
    messages = {o[1].split(" ")[0] for o in results[PORT]
                if o[0] == "rejected"}
    # namespace, node selector, whitelist, service account, priority,
    # node restriction, limit range and quota refusals all occurred
    assert len(messages) >= 6, messages


def test_rollback_restores_quota_usage_in_both():
    for root in (REF, PORT):
        k = PKGS[root]
        store = _default_world(k)
        chain = k.AdmissionChain(k.default_plugins(), store=store)
        req = k.AdmissionRequest("CREATE", "Pod", "default", "p",
                                 obj=k.make_pod("p", cpu=300))
        chain.admit(req)
        used = {q.name: dict(q.used)
                for q in store.list("ResourceQuota")[0]}
        assert used == {"pods": {"pods": 1}, "cpu": {"cpu": 300}}
        chain.rollback(req)
        after = {q.name: dict(q.used)
                 for q in store.list("ResourceQuota")[0]}
        assert after == {"pods": {"pods": 0}, "cpu": {"cpu": 0}}, root


def _optin_world(k, cloud):
    store = k.ApiServerLite()
    store.create("Namespace", k.Namespace("default"))
    store.create("PodPreset", k.PodPreset(
        name="env", selector={"app": "a0"},
        annotations={"preset/DB": "db"}, volumes=[k.Volume(name="cache")]))
    store.create("PodPreset", k.PodPreset(
        name="x1", selector={"app": "a1"}, annotations={"preset/K": "1"}))
    store.create("PodPreset", k.PodPreset(
        name="x2", selector={"app": "a1"}, annotations={"preset/K": "2"}))
    store.create(k.PSP_KIND, k.PodSecurityPolicy(
        "a-ranged", run_as_user_rule=k.MUST_RUN_AS,
        run_as_user_ranges=[(1000, 2000)]))
    store.create(k.PSP_KIND, k.PodSecurityPolicy(
        "b-ports", host_ports=[(8000, 9000)], privileged=True))
    return k.AdmissionChain(
        [k.PodPresetPlugin(), k.AlwaysPullImages(),
         k.LimitPodHardAntiAffinityTopology(), k.PodSecurityPolicyPlugin(),
         k.PersistentVolumeLabel(cloud)], store=store)


def test_opt_in_plugins_admit_and_reject_alike():
    """PodPreset, AlwaysPullImages, the hard anti-affinity limit, PSP and
    PersistentVolumeLabel (each package's FakeCloud, holding the same
    disks) on seeded requests: the same admitted objects and refusals."""
    results = {}
    for root in (REF, PORT):
        k = PKGS[root]
        cloud = k.FakeCloud()
        for i in range(4):
            cloud.create_disk(f"disk-{i}", zone=f"zone-{i % 2}",
                              region=f"region-{i % 3}")
        chain = _optin_world(k, cloud)
        rng = random.Random(5)
        got = []
        for i in range(80):
            r = rng.randrange(6)
            if r == 5:
                pv = k.PersistentVolume(
                    name=f"pv{i}", source=k.Volume(
                        kind=rng.choice([k.VolumeKind.GCE_PD,
                                         k.VolumeKind.OTHER]),
                        volume_id=f"disk-{rng.randrange(6)}"),
                    labels={k.ZONE_LABEL: "client"})
                got.append(_outcome(k, chain, "CREATE", "PersistentVolume",
                                    "", pv))
                continue
            pod = k.make_pod(f"p{i}", cpu=10,
                             labels={"app": f"a{rng.randrange(3)}"},
                             ports=rng.choice([None, [8080], [22]]))
            if r == 1:
                pod.containers[0].security_context = k.SecurityContext(
                    privileged=True)
            elif r == 2:
                pod.affinity = k.Affinity(pod_anti_affinity=k.PodAffinity(
                    required_terms=[k.PodAffinityTerm(topology_key=rng.choice(
                        ["kubernetes.io/hostname",
                         "failure-domain.beta.kubernetes.io/zone"]))]))
            elif r == 3:
                pod.security_context = k.PodSecurityContext(
                    run_as_user=rng.choice([5, 1500]))
            got.append(_outcome(k, chain, "CREATE", "Pod", "default", pod))
        results[root] = got
    assert results[REF] == results[PORT]
    assert {o[0] for o in results[PORT]} == {"admitted", "rejected"}


def test_webhook_reviews_and_patches_are_byte_equal():
    """One mutating backend serves both packages' GenericAdmissionWebhook:
    the AdmissionReviews it receives are byte-equal, and so are the
    admitted objects after the patch; a denial reads the same."""
    def decide(review):
        obj = dict(review["request"]["object"])
        obj["metadata"] = dict(obj["metadata"])
        labels = dict(obj["metadata"].get("labels") or {})
        labels["stamped"] = "true"
        obj["metadata"]["labels"] = labels
        allowed = not review["request"]["name"].endswith("3")
        return {"response": {"allowed": allowed, "patchedObject": obj,
                             "status": {"message": "ends in 3"}}}

    backend = WebhookBackend(decide)
    try:
        results, raws = {}, {}
        for root in (REF, PORT):
            k = PKGS[root]
            start = len(backend.raw)
            api = mk_server(k, k.GenericAdmissionWebhook([k.WebhookHook(
                name="stamper", url=backend.url, mutating=True,
                rules=[k.webhook.Rule(operations=["CREATE"],
                                      kinds=["Pod"])])]))
            got = []
            for pod in _hollow(root)(12):
                try:
                    api.create("Pod", pod)
                    got.append(_bytes(k, "Pod", api.store.get(
                        "Pod", pod.namespace, pod.name)))
                except k.Rejected as e:
                    got.append(str(e))
            results[root] = got
            raws[root] = backend.raw[start:]
    finally:
        backend.stop()
    assert raws[REF] == raws[PORT]
    assert results[REF] == results[PORT]
    assert sum(1 for r in results[PORT] if "ends in 3" in r) == 1


def _hollow(root):
    hollow = importlib.import_module(f"{root}.models.hollow")
    return lambda n: hollow.mixed_affinity_pods(n, seed=2,
                                                namespace="default")
