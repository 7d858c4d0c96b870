"""The port's REST front (server/rest_http.py, cli/rest_client.py,
server/openapi.py, server/extensions.py, api/fields.py) against the
reference's. The bodies of tests/test_apiextensions.py,
tests/test_field_selectors.py and tests/test_openapi.py run on both
packages (the `k` fixture), the cases that drive cli/ktctl included.
Then one request sequence, the same bytes, goes over HTTP to both
packages' RestServers on equal worlds: every status code and every JSON
body must be equal (CRDs, discovery, /openapi/v2, /version, field
selectors, watch, subresources), and each typed error reaches its own
status code (400, 401, 403 for Forbidden and Rejected, 404, 409, 422,
429)."""

from __future__ import annotations

import http.client
import json

import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "extensions_api": "api.extensions", "rbac": "api.rbac",
    "types": "api.types", "workloads": "api.workloads",
    "cluster": "api.cluster", "wire": "api.wire", "fields": "api.fields",
    "authn": "auth.authn", "authz": "auth.authz",
    "apiserver": "server.apiserver", "lite": "server.apiserver_lite",
    "extensions": "server.extensions", "openapi": "server.openapi",
    "rest_http": "server.rest_http", "rest_client": "cli.rest_client",
    "ktctl": "cli.ktctl",
}

Mi = 1 << 20


PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


def make_crd(k, **over):
    kw = dict(
        name="tputopologies.sched.example.io",
        group="sched.example.io",
        version="v1",
        names=k.CRDNames(plural="tputopologies", kind="TpuTopology"),
        validation={
            "required": ["chips"],
            "chips": {"type": "integer", "minimum": 1, "maximum": 4096},
            "generation": {"type": "string",
                           "enum": ["v4", "v5e", "v5p"]},
        },
    )
    kw.update(over)
    return k.CustomResourceDefinition(**kw)


def make_server(k):
    api = k.ApiServer()
    api.store.create("Namespace", k.Namespace("default"))
    return api


# ------------------------------------------- tests/test_apiextensions.py


def test_crd_create_establishes_and_serves(k):
    api = make_server(k)
    api.create("CustomResourceDefinition", make_crd(k))
    crd = api.get("CustomResourceDefinition", "",
                  "tputopologies.sched.example.io")
    assert crd.names_accepted and crd.established
    api.create("TpuTopology", k.CustomResource(
        "TpuTopology", "pod-a", namespace="default",
        spec={"chips": 256, "generation": "v5e"}))
    assert api.get("TpuTopology", "default", "pod-a").spec["chips"] == 256
    objs, _ = api.list("TpuTopology")
    assert [o.name for o in objs] == ["pod-a"]


def test_crd_name_must_be_plural_dot_group(k):
    api = make_server(k)
    with pytest.raises(k.Invalid):
        api.create("CustomResourceDefinition",
                   make_crd(k, name="topologies.sched.example.io"))
    with pytest.raises(k.Invalid):
        api.create("CustomResourceDefinition",
                   make_crd(k, name="tputopologies.sched", group="sched"))


def test_unknown_kind_404s_everywhere(k):
    api = make_server(k)
    with pytest.raises(k.NotFound):
        api.create("TpuTopology", k.CustomResource(
            "TpuTopology", "x", namespace="default", spec={"chips": 1}))
    with pytest.raises(k.NotFound):
        api.list("TpuTopology")
    with pytest.raises(k.NotFound):
        api.get("TpuTopology", "default", "x")
    with pytest.raises(k.NotFound):
        api.delete("TpuTopology", "default", "x")


def test_name_conflict_with_builtin_not_accepted_and_not_served(k):
    api = make_server(k)
    api.create("CustomResourceDefinition", k.CustomResourceDefinition(
        name="pods.fake.example.io", group="fake.example.io", version="v1",
        names=k.CRDNames(plural="pods", kind="Pod")))
    stored = api.get("CustomResourceDefinition", "", "pods.fake.example.io")
    assert not stored.names_accepted and not stored.established
    assert "already in use" in stored.condition("NamesAccepted").message


def test_name_conflict_between_crds(k):
    api = make_server(k)
    api.create("CustomResourceDefinition", make_crd(k))
    api.create("CustomResourceDefinition", k.CustomResourceDefinition(
        name="tputopologies.other.example.io", group="other.example.io",
        version="v1",
        names=k.CRDNames(plural="tputopologies", kind="TpuTopology2")))
    assert not api.get("CustomResourceDefinition", "",
                       "tputopologies.other.example.io").names_accepted


def test_crd_delete_cascades_instances(k):
    api = make_server(k)
    api.create("CustomResourceDefinition", make_crd(k))
    for i in range(3):
        api.create("TpuTopology", k.CustomResource(
            "TpuTopology", f"t{i}", namespace="default", spec={"chips": 8}))
    api.delete("CustomResourceDefinition", "",
               "tputopologies.sched.example.io")
    with pytest.raises(k.NotFound):
        api.get("CustomResourceDefinition", "",
                "tputopologies.sched.example.io")
    with pytest.raises(k.NotFound):
        api.list("TpuTopology")
    assert api.store.list("TpuTopology")[0] == []


def test_schema_validation_rejects(k):
    api = make_server(k)
    api.create("CustomResourceDefinition", make_crd(k))

    def cr(spec):
        return k.CustomResource("TpuTopology", "bad", namespace="default",
                                spec=spec)

    for spec in ({}, {"chips": "many"}, {"chips": 0}, {"chips": 8192},
                 {"chips": 8, "generation": "v3"}, {"chips": True}):
        with pytest.raises(k.Invalid):
            api.create("TpuTopology", cr(spec))
    api.create("TpuTopology", cr({"chips": 8}))
    with pytest.raises(k.Invalid):
        api.update("TpuTopology", k.CustomResource(
            "TpuTopology", "bad", namespace="default", spec={"chips": -1}))


def test_scope_enforced(k):
    api = make_server(k)
    api.create("CustomResourceDefinition", make_crd(k))
    with pytest.raises(k.Invalid):
        api.create("TpuTopology",
                   k.CustomResource("TpuTopology", "x", spec={"chips": 1}))
    api.create("CustomResourceDefinition", k.CustomResourceDefinition(
        name="meshes.sched.example.io", group="sched.example.io",
        version="v1", names=k.CRDNames(plural="meshes", kind="Mesh"),
        scope="Cluster"))
    with pytest.raises(k.Invalid):
        api.create("Mesh", k.CustomResource("Mesh", "m",
                                            namespace="default"))
    api.create("Mesh", k.CustomResource("Mesh", "m"))
    assert api.get("Mesh", "", "m").name == "m"


def test_rbac_over_custom_resources(k):
    authn = k.UnionAuthenticator([k.TokenAuthenticator({
        "admin": k.UserInfo("root", groups=["system:masters"]),
        "dev": k.UserInfo("dev-user")})])
    api = k.ApiServer(auth=True, authenticator=authn)
    api.store.create("Namespace", k.Namespace("default"))
    api.bootstrap_rbac()
    admin, dev = k.Credential(token="admin"), k.Credential(token="dev")
    api.create("CustomResourceDefinition", make_crd(k), cred=admin)
    api.store.create("Role", k.Role("topo-reader", "default", rules=[
        k.PolicyRule(verbs=["get", "list"], resources=["tputopologies"])]))
    api.store.create("RoleBinding", k.RoleBinding(
        "read-topos", "default", subjects=[k.Subject("User", "dev-user")],
        role_ref=k.RoleRef("Role", "topo-reader")))
    api.create("TpuTopology", k.CustomResource(
        "TpuTopology", "t", namespace="default", spec={"chips": 4}),
        cred=admin)
    assert api.get("TpuTopology", "default", "t",
                   cred=dev).spec["chips"] == 4
    with pytest.raises(k.Forbidden):
        api.create("TpuTopology", k.CustomResource(
            "TpuTopology", "t2", namespace="default", spec={"chips": 4}),
            cred=dev)


def test_discovery_lists_builtins_and_crds(k):
    api = make_server(k)
    names = {(r["kind"], r["name"]) for r in api.discovery()["resources"]}
    assert ("Pod", "pods") in names and ("Node", "nodes") in names
    assert not any(kind == "TpuTopology" for kind, _ in names)
    api.create("CustomResourceDefinition", make_crd(k))
    custom = [r for r in api.discovery()["resources"]
              if r["kind"] == "TpuTopology"]
    assert custom and custom[0]["group"] == "sched.example.io"
    assert custom[0]["namespaced"]


def make_backend(k):
    backend = k.ApiServer()
    backend.store.create("Namespace", k.Namespace("default"))
    backend.create("CustomResourceDefinition", k.CustomResourceDefinition(
        name="nodemetrics.metrics.example.io", group="metrics.example.io",
        version="v1",
        names=k.CRDNames(plural="nodemetrics", kind="NodeMetrics"),
        scope="Cluster"))
    backend.create("NodeMetrics",
                   k.CustomResource("NodeMetrics", "n1", spec={"cpu": 2}))
    return backend


def test_aggregator_routes_remote_group(k):
    primary = make_server(k)
    agg = k.Aggregator(primary)
    agg.register_backend(k.APIService(
        name="v1.metrics.example.io", group="metrics.example.io",
        version="v1", service=k.ServiceReference("kube-system", "metrics")),
        backend=make_backend(k))
    objs, _ = agg.handle("metrics.example.io", "v1", "list", "NodeMetrics")
    assert [o.name for o in objs] == ["n1"]
    primary.store.create("Namespace", k.Namespace("kube-system"))
    objs, _ = agg.handle("", "v1", "list", "Namespace")
    assert {o.name for o in objs} == {"default", "kube-system"}


def test_aggregator_unavailable_backend_503s(k):
    primary = make_server(k)
    agg = k.Aggregator(primary, probe_interval=0.0)
    backend = make_backend(k)
    agg.register_backend(k.APIService(
        name="v1.metrics.example.io", group="metrics.example.io",
        version="v1", service=k.ServiceReference("kube-system", "metrics")),
        backend=backend)
    assert primary.store.get("APIService", "",
                             "v1.metrics.example.io").available
    backend.healthz = lambda: {"status": "failed"}
    with pytest.raises(k.Unavailable):
        agg.handle("metrics.example.io", "v1", "list", "NodeMetrics")
    assert not primary.store.get("APIService", "",
                                 "v1.metrics.example.io").available
    backend.healthz = lambda: {"status": "ok"}
    objs, _ = agg.handle("metrics.example.io", "v1", "list", "NodeMetrics")
    assert len(objs) == 1


def test_aggregator_local_apiservice_and_discovery(k):
    primary = make_server(k)
    agg = k.Aggregator(primary)
    agg.register_backend(k.APIService(
        name="v1.sched.example.io", group="sched.example.io", version="v1"))
    primary.create("CustomResourceDefinition", make_crd(k))
    primary.create("TpuTopology", k.CustomResource(
        "TpuTopology", "t", namespace="default", spec={"chips": 2}))
    objs, _ = agg.handle("sched.example.io", "v1", "list", "TpuTopology")
    assert [o.name for o in objs] == ["t"]
    groups = {(g["group"], g["local"], g["available"])
              for g in agg.discovery()["aggregatedGroups"]}
    assert ("sched.example.io", True, True) in groups


def test_crd_over_rest_group_path(k):
    api = make_server(k)
    srv = k.RestServer(api)
    srv.start()
    try:
        client = k.RestClient(f"http://127.0.0.1:{srv.port}")
        client.create("CustomResourceDefinition", make_crd(k))
        assert any(r["kind"] == "TpuTopology"
                   and r["group"] == "sched.example.io"
                   for r in client.discovery()["resources"])
        client.create("TpuTopology", k.CustomResource(
            "TpuTopology", "ring0", namespace="default",
            spec={"chips": 64, "generation": "v5p"}))
        got = client.get("TpuTopology", "default", "ring0")
        assert got.spec == {"chips": 64, "generation": "v5p"}
        objs, _ = client.list("TpuTopology")
        assert [o.name for o in objs] == ["ring0"]
        client.delete("TpuTopology", "default", "ring0")
        with pytest.raises(k.NotFound):
            client.get("TpuTopology", "default", "ring0")
        with pytest.raises(k.HttpError):
            client.create("TpuTopology", k.CustomResource(
                "TpuTopology", "bad", namespace="default",
                spec={"chips": 0}))
    finally:
        srv.stop()


def test_bounded_field_with_nonnumeric_value_422s_not_500s(k):
    api = make_server(k)
    api.create("CustomResourceDefinition", k.CustomResourceDefinition(
        name="widgets.w.example.io", group="w.example.io", version="v1",
        names=k.CRDNames(plural="widgets", kind="Widget"),
        validation={"replicas": {"minimum": 0}}))
    with pytest.raises(k.Invalid):
        api.create("Widget", k.CustomResource(
            "Widget", "w", namespace="default", spec={"replicas": "three"}))


def test_crd_update_revalidates_names(k):
    api = make_server(k)
    api.create("CustomResourceDefinition", make_crd(k))
    crd = api.get("CustomResourceDefinition", "",
                  "tputopologies.sched.example.io")
    crd.names.kind = "Pod"
    api.update("CustomResourceDefinition", crd)
    stored = api.get("CustomResourceDefinition", "",
                     "tputopologies.sched.example.io")
    assert not stored.names_accepted and not stored.established
    with pytest.raises(k.NotFound):
        api.create("TpuTopology", k.CustomResource(
            "TpuTopology", "x", namespace="default", spec={"chips": 1}))


def test_delete_missing_crd_raises_not_found(k):
    with pytest.raises(k.NotFound):
        make_server(k).delete("CustomResourceDefinition", "",
                              "nope.example.io")


def test_crd_watch_over_rest(k):
    api = make_server(k)
    srv = k.RestServer(api)
    srv.start()
    try:
        client = k.RestClient(f"http://127.0.0.1:{srv.port}")
        client.create("CustomResourceDefinition", make_crd(k))
        rv = client.list("TpuTopology")[1]
        api.create("TpuTopology", k.CustomResource(
            "TpuTopology", "ring1", namespace="default",
            spec={"chips": 16}))
        api.store.create("Node", k.make_node("noise", cpu=1,
                                             memory=1 << 20))
        evs = client.watch_since(("TpuTopology",), rv, timeout=1)
        assert [e.obj.name for e in evs] == ["ring1"]
        assert all(e.kind == "TpuTopology" for e in evs)
        with pytest.raises(k.NotFound):
            client.watch_since(("NoSuchKind",), rv, timeout=0.1)
    finally:
        srv.stop()


def test_ktctl_crd_workflow(k, tmp_path):
    import io

    api = make_server(k)
    out = io.StringIO()
    kt = k.Ktctl(api, out=out)
    # apply an upstream-shaped CRD manifest (apiextensions.k8s.io v1.7 era)
    manifest = tmp_path / "crd.yaml"
    manifest.write_text("""
apiVersion: apiextensions.k8s.io/v1beta1
kind: CustomResourceDefinition
metadata:
  name: tputopologies.sched.example.io
spec:
  group: sched.example.io
  version: v1
  scope: Namespaced
  names:
    plural: tputopologies
    kind: TpuTopology
    shortNames: [tt]
  validation:
    openAPIV3Schema:
      properties:
        spec:
          required: [chips]
          properties:
            chips: {type: integer, minimum: 1}
---
apiVersion: sched.example.io/v1
kind: TpuTopology
metadata:
  name: ring0
  namespace: default
spec:
  chips: 128
""")
    assert kt.run(["create", "-f", str(manifest)]) == 0
    assert kt.run(["get", "tputopologies", "-n", "default"]) == 0
    assert "ring0" in out.getvalue()
    # short-name resolution via discovery
    assert kt.run(["get", "tt", "ring0", "-n", "default",
                   "-o", "json"]) == 0
    assert '"chips": 128' in out.getvalue()
    # api-resources lists the custom group
    assert kt.run(["api-resources"]) == 0
    assert "sched.example.io" in out.getvalue()
    # delete through the CLI
    assert kt.run(["delete", "tputopologies", "ring0", "-n", "default"]) == 0
    assert kt.run(["get", "tputopologies", "-n", "default"]) == 0


def test_ktctl_prints_real_plural_for_custom_kinds(k):
    import io

    api = make_server(k)
    api.create("CustomResourceDefinition", make_crd(k))
    api.create("TpuTopology", k.CustomResource(
        "TpuTopology", "ring0", namespace="default", spec={"chips": 8}))
    out = io.StringIO()
    kt = k.Ktctl(api, out=out)
    assert kt.run(["get", "tputopologies", "-n", "default",
                   "-o", "name"]) == 0
    assert "tputopologies/ring0" in out.getvalue()
    assert "tputopologys" not in out.getvalue()


# ----------------------------------------- tests/test_field_selectors.py


def test_parse_forms_and_errors(k):
    sel = k.parse_field_selector("spec.nodeName=n1,status.phase!=Failed")
    assert sel.requirements == (("spec.nodeName", "=", "n1"),
                                ("status.phase", "!=", "Failed"))
    assert k.parse_field_selector("a==b").requirements == (("a", "=", "b"),)
    assert k.parse_field_selector("").empty
    for bad in ("nodeName", "=v", ",,=,"):
        with pytest.raises(k.FieldSelectorError):
            k.parse_field_selector(bad)


def fs_server(k):
    api = k.ApiServer()
    api.store.create("Namespace", k.Namespace("default"))
    for i, phase in enumerate(("Running", "Pending", "Running")):
        p = k.make_pod(f"p{i}", cpu=10, memory=Mi)
        p.node_name = f"n{i % 2}"
        p.phase = phase
        api.store.create("Pod", p)
    api.store.create("Node", k.make_node("n0", cpu=1000, memory=1 << 31))
    n1 = k.make_node("n1", cpu=1000, memory=1 << 31)
    n1.unschedulable = True
    api.store.create("Node", n1)
    return api


def test_list_with_field_selector(k):
    api = fs_server(k)
    for sel, want in (
            ("spec.nodeName=n0", ["p0", "p2"]),
            ("spec.nodeName=n0,status.phase!=Pending", ["p0", "p2"]),
            ("status.phase=Pending", ["p1"]),
            ("metadata.name=p1", ["p1"])):
        objs, _ = api.list("Pod", field_selector=sel)
        assert sorted(o.name for o in objs) == want
    objs, _ = api.list("Node", field_selector="spec.unschedulable=true")
    assert [o.name for o in objs] == ["n1"]


def test_unsupported_field_label_is_invalid(k):
    with pytest.raises(k.Invalid, match="field label not supported"):
        fs_server(k).list("Pod", field_selector="spec.bogus=x")


def test_generic_kind_supports_metadata_only(k):
    api = fs_server(k)
    objs, _ = api.list("Namespace", field_selector="metadata.name=default")
    assert [o.name for o in objs] == ["default"]
    with pytest.raises(k.Invalid):
        api.list("Namespace", field_selector="spec.finalizers=x")


def test_field_selector_over_rest(k):
    """The reference's test_field_selector_over_rest_and_cli: the REST
    half, then the CLI half through ktctl."""
    import io

    api = fs_server(k)
    srv = k.RestServer(api)
    srv.start()
    try:
        client = k.RestClient(f"http://127.0.0.1:{srv.port}")
        objs, _ = client.list("Pod", field_selector="spec.nodeName=n1")
        assert [o.name for o in objs] == ["p1"]
        with pytest.raises(k.HttpError):
            client.list("Pod", field_selector="nope=1")
    finally:
        srv.stop()
    out = io.StringIO()
    kt = k.Ktctl(api, out=out)
    assert kt.run(["get", "pods", "--field-selector",
                   "status.phase=Running", "-o", "name"]) == 0
    assert sorted(out.getvalue().split()) == ["pods/p0", "pods/p2"]
    # bad selector: clean CLI error
    assert kt.run(["get", "pods", "--field-selector", "bogus"]) == 1


def test_named_get_with_selector_is_rejected(k):
    import io

    api = fs_server(k)
    out = io.StringIO()
    kt = k.Ktctl(api, out=out)
    assert kt.run(["get", "pods", "p0", "--field-selector",
                   "spec.nodeName=n1"]) == 1
    assert "cannot be combined" in out.getvalue()


def test_filter_objects_direct(k):
    pods = []
    for i in range(4):
        p = k.make_pod(f"p{i}", cpu=1, memory=Mi)
        p.node_name = "nA" if i % 2 == 0 else "nB"
        pods.append(p)
    sel = k.parse_field_selector("spec.nodeName=nA")
    assert [p.name for p in k.filter_objects("Pod", pods, sel)] \
        == ["p0", "p2"]


def test_invalid_selector_rejected_even_on_empty_cluster(k):
    api = k.ApiServer()
    api.store.create("Namespace", k.Namespace("default"))
    with pytest.raises(k.Invalid, match="field label not supported"):
        api.list("Pod", field_selector="spec.bogus=x")
    with pytest.raises(k.Invalid):
        fs_server(k).list("Pod",
                          field_selector="status.phase=NoSuch,spec.bogus=x")


# ------------------------------------------------- tests/test_openapi.py


def test_spec_covers_every_served_kind(k):
    spec = k.build_spec(k.ApiServer().store)
    assert spec["swagger"] == "2.0"
    for kind, (plural, cluster_scoped) in k.KIND_INFO.items():
        assert kind in spec["definitions"], kind
        base = f"/api/v1/{plural}" if cluster_scoped \
            else f"/api/v1/namespaces/{{namespace}}/{plural}"
        assert base in spec["paths"], kind
        assert base + "/{name}" in spec["paths"], kind
        assert "get" in spec["paths"][base]
        assert "delete" in spec["paths"][base + "/{name}"]
    pod = spec["definitions"]["Pod"]
    assert pod["properties"]["name"]["type"] == "string"
    assert pod["properties"]["containers"]["type"] == "array"
    assert pod["properties"]["priority"]["type"] == "integer"


def test_spec_includes_established_crds(k):
    api = k.ApiServer()
    api.store.create("CustomResourceDefinition", k.CustomResourceDefinition(
        name="widgets.example.com", group="example.com", version="v1",
        names=k.CRDNames(plural="widgets", kind="Widget",
                         singular="widget")))
    spec = k.build_spec(api.store)
    assert "Widget" in spec["definitions"]
    assert ("/apis/example.com/v1/namespaces/{namespace}/widgets"
            in spec["paths"])


def test_spec_served_over_http_at_both_paths(k):
    srv = k.RestServer(k.ApiServer())
    srv.start()
    try:
        for path in ("/openapi/v2", "/swagger.json"):
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=5)
            conn.request("GET", path)
            resp = conn.getresponse()
            assert resp.status == 200
            spec = json.loads(resp.read())
            assert spec["swagger"] == "2.0"
            assert "Pod" in spec["definitions"]
            conn.close()
    finally:
        srv.stop()


# ------------------------------------------------ the port == the reference


TOKENS = ("admin", "dev", "bad", "")


def _world(k):
    """A secure ApiServer behind RestServer: bootstrap RBAC, a dev user
    with a pod Role in `team`, a Terminating namespace, pods bound to
    two nodes, a PodDisruptionBudget, a ReplicaSet and a CRD."""
    api = k.ApiServer(auth=True, authenticator=k.UnionAuthenticator([
        k.TokenAuthenticator({
            "admin": k.UserInfo("root", groups=["system:masters"]),
            "dev": k.UserInfo("dev-user")})]))
    api.bootstrap_rbac()
    store = api.store
    store.create("Namespace", k.Namespace("default"))
    store.create("Namespace", k.Namespace("team"))
    store.create("Namespace", k.Namespace("closing", phase="Terminating"))
    store.create("Role", k.Role("pods", "team", rules=[k.PolicyRule(
        verbs=["get", "list", "create", "delete"], resources=["pods"])]))
    store.create("RoleBinding", k.RoleBinding(
        "pods", "team", subjects=[k.Subject("User", "dev-user")],
        role_ref=k.RoleRef("Role", "pods")))
    for n in ("n0", "n1"):
        store.create("Node", k.make_node(n, cpu=4000, memory=8 << 30))
    for i in range(6):
        p = k.make_pod(f"p{i}", namespace=("default", "team")[i % 2],
                       cpu=100, memory=64 * Mi,
                       labels={"app": ("web", "db")[i % 2]})
        p.node_name = f"n{i % 2}"
        p.phase = ("Running", "Pending")[i % 3 == 2]
        store.create("Pod", p)
    store.create("PodDisruptionBudget", k.PodDisruptionBudget(
        "web", "default", selector=k.LabelSelector(
            match_labels={"app": "web"}), disruptions_allowed=1))
    store.create("ReplicaSet", k.ReplicaSet(
        "rs", "default", replicas=3,
        selector=k.LabelSelector(match_labels={"app": "web"})))
    api.create("CustomResourceDefinition", make_crd(k),
               cred=k.Credential(token="admin"))
    srv = k.RestServer(api)
    srv.start()
    return api, srv


def _requests():
    """(method, path, token, body) — bodies are the reference's wire
    encoding, sent as the same bytes to both servers."""
    ref = PKGS[REF]

    def enc(obj, kind):
        return json.dumps(ref.wire.encode(obj, kind=kind))

    new = enc(ref.make_pod("new", namespace="team", cpu=50), "Pod")
    dup = enc(ref.make_pod("p1", namespace="team", cpu=50), "Pod")
    closing = enc(ref.make_pod("c", namespace="closing", cpu=50), "Pod")
    topo = enc(ref.CustomResource("TpuTopology", "ring", namespace="team",
                                  spec={"chips": 64}), "TpuTopology")
    bad_topo = enc(ref.CustomResource("TpuTopology", "bad",
                                      namespace="team", spec={"chips": 0}),
                   "TpuTopology")
    ns = "/api/v1/namespaces"
    topos = "/apis/sched.example.io/v1/namespaces/team/tputopologies"
    return [
        ("GET", "/version", "", None),
        ("GET", "/healthz", "", None),
        ("GET", "/api", "", None),
        ("GET", "/api/v1", "", None),
        ("GET", "/apis", "admin", None),
        ("GET", "/openapi/v2", "admin", None),
        ("GET", "/swagger.json", "", None),
        ("GET", "/configz", "", None),
        ("GET", f"{ns}/team/pods", "dev", None),
        ("GET", f"{ns}/team/pods", "bad", None),            # 401
        ("GET", "/api/v1/pods", "dev", None),                # 403
        ("GET", "/api/v1/pods", "admin", None),
        ("GET", "/api/v1/pods?fieldSelector=spec.nodeName%3Dn1", "admin",
         None),
        ("GET", "/api/v1/pods?fieldSelector=spec.nodeName%3Dn0%2C"
                "status.phase%21%3DPending", "admin", None),
        ("GET", "/api/v1/pods?fieldSelector=spec.bogus%3Dx", "admin",
         None),                                              # 422
        ("GET", "/api/v1/nodes?fieldSelector=metadata.name%3Dn1", "admin",
         None),
        ("GET", f"{ns}/default/pods?labelSelector=app%3Dweb", "admin",
         None),
        ("GET", f"{ns}/team/pods/p1", "dev", None),
        ("GET", f"{ns}/team/pods/nope", "dev", None),        # 404
        ("POST", f"{ns}/team/pods", "dev", new),
        ("POST", f"{ns}/team/pods", "dev", dup),             # 409
        ("POST", f"{ns}/default/pods", "dev", new),          # 403
        ("POST", f"{ns}/closing/pods", "admin", closing),    # 403 admission
        ("POST", f"{ns}/team/pods", "admin", "{not json"),   # 400
        ("POST", f"{ns}/team/pods/new/binding", "admin",
         json.dumps({"node_name": "n0"})),
        ("POST", f"{ns}/default/pods/p0/eviction", "admin", "{}"),
        ("POST", f"{ns}/default/pods/p2/eviction", "admin", "{}"),  # 429
        ("GET", f"{ns}/default/replicasets/rs/scale", "admin", None),
        ("PUT", f"{ns}/default/replicasets/rs/scale", "admin",
         json.dumps({"replicas": 5})),
        ("PUT", f"{ns}/default/replicasets/rs/scale", "admin",
         json.dumps({"replicas": "five"})),                  # 400
        ("DELETE", f"{ns}/default/pods/p0/eviction", "admin", None),  # 404
        ("POST", topos, "admin", topo),
        ("POST", topos, "admin", bad_topo),                  # 422
        ("GET", topos, "admin", None),
        ("GET", f"{topos}/ring", "admin", None),
        ("GET", "/api/v1/watch?resourceVersion=0&resource=pods", "admin",
         None),
        ("GET", "/api/v1/watch?resourceVersion=3&resource=tputopologies",
         "admin", None),
        ("DELETE", f"{ns}/team/pods/new", "dev", None),
        ("DELETE", f"{ns}/team/pods/new", "dev", None),      # 404
        ("GET", "/nowhere", "admin", None),                  # 404
    ]


def _send(port, method, path, token, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = "Bearer " + token
    data = body.encode() if body is not None else None
    conn.request(method, path, body=data, headers=headers)
    resp = conn.getresponse()
    out = (resp.status, resp.read())
    conn.close()
    return out


def test_same_requests_give_equal_status_and_bodies():
    answers = {}
    for root in (REF, PORT):
        api, srv = _world(PKGS[root])
        try:
            answers[root] = [_send(srv.port, *r) for r in _requests()]
        finally:
            srv.stop()
    for req, a, b in zip(_requests(), answers[REF], answers[PORT]):
        assert b == a, req[:2]
    codes = [s for s, _ in answers[PORT]]
    assert {200, 201, 400, 401, 403, 404, 409, 422, 429} <= set(codes)


@pytest.mark.parametrize("code,case", [
    (401, "unauthenticated"), (403, "forbidden"), (403, "rejected"),
    (404, "not_found"), (409, "conflict"), (422, "invalid"),
    (429, "too_many_requests"), (400, "bad_value")])
def test_each_typed_error_reaches_its_status_code(code, case):
    """Each of the port's typed errors maps to its code over HTTP (the
    port's classes, not the reference's), with the reference's body."""
    which = {"unauthenticated": 9, "forbidden": 10, "rejected": 22,
             "not_found": 18, "conflict": 20, "invalid": 14,
             "too_many_requests": 26, "bad_value": 23}[case]
    got = {}
    for root in (REF, PORT):
        api, srv = _world(PKGS[root])
        try:
            reqs = _requests()
            for r in reqs[:which]:
                _send(srv.port, *r)
            got[root] = _send(srv.port, *reqs[which])
        finally:
            srv.stop()
    assert got[PORT][0] == code
    assert got[PORT] == got[REF]
    assert json.loads(got[PORT][1])["code"] == code
