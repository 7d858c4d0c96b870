"""The port's full apiserver (server/apiserver.py with auth/, admission/
and server/extensions.py behind it) against the reference's. The bodies
of tests/test_apiserver_chain.py run on both packages (the `k` fixture),
the two that drive cli/ktctl's --as included. Then one scripted
request sequence goes through both with a fixed clock: every result or
typed error and every audit entry (all fields, the timestamp too) must
be equal, under an audit policy, with impersonation, bindings and
watches; evictions against PodDisruptionBudgets give the same outcomes;
KIND_INFO is the same table. Last, the slice whole: the port's
Scheduler(ApiServer(), device="cpu") against the reference's
Scheduler(ApiServer()) behind the default admission chain (a
LimitRange, two PriorityClasses, a pod quota, mixed_affinity pods): the
same placements, drain totals, refused creates, quota status and audit
entries."""

from __future__ import annotations

import copy
import dataclasses
import importlib
import random

import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "chain": "admission.chain", "cluster": "api.cluster",
    "rbac": "api.rbac", "types": "api.types", "workloads": "api.workloads",
    "authn": "auth.authn", "authz": "auth.authz",
    "apiserver": "server.apiserver", "lite": "server.apiserver_lite",
    "features": "utils.features", "hollow": "models.hollow",
    "ktctl": "cli.ktctl",
}

Mi = 1024 * 1024


PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


def make_server(k, auth=False, tokens=None, now=None):
    authn = k.UnionAuthenticator([
        k.TokenAuthenticator(tokens or {}),
        k.ServiceAccountTokenAuthenticator(b"sa-signing-key"),
        k.CertAuthenticator(b"ca-key"),
    ])
    kw = {} if now is None else {"now": now}
    api = k.ApiServer(auth=auth, authenticator=authn, **kw)
    api.store.create("Namespace", k.Namespace("default"))
    api.bootstrap_rbac()
    return api


# ------------------------------------- tests/test_apiserver_chain.py: authn


def test_union_authenticator_and_token_auth(k):
    api = make_server(k, auth=True, tokens={
        "secret-token": k.UserInfo("alice", groups=["system:masters"])})
    cred = k.Credential(token="secret-token")
    api.create("Pod", k.make_pod("p1"), cred=cred)
    assert api.get("Pod", "default", "p1", cred=cred).name == "p1"
    with pytest.raises(k.Unauthenticated):
        api.create("Pod", k.make_pod("p2"), cred=k.Credential(token="wrong"))


def test_service_account_jwt_roundtrip(k):
    sa = k.ServiceAccountTokenAuthenticator(b"key")
    tok = sa.issue("kube-system", "deployer", uid="u1")
    user = sa.authenticate(k.Credential(token=tok))
    assert user.name == "system:serviceaccount:kube-system:deployer"
    assert "system:serviceaccounts" in user.groups
    assert sa.authenticate(k.Credential(token=tok[:-2] + "xx")) is None


def test_bootstrap_token_expiry_and_revoke(k):
    clock = [0.0]
    bt = k.BootstrapTokenAuthenticator(now=lambda: clock[0])
    bt.add_token("abc123", "s3cret", ttl=10)
    u = bt.authenticate(k.Credential(token="abc123.s3cret"))
    assert u.name == "system:bootstrap:abc123"
    clock[0] = 11
    assert bt.authenticate(k.Credential(token="abc123.s3cret")) is None
    assert bt.expired_ids() == ["abc123"]


def test_cert_authenticator_rejects_forged_groups(k):
    ca = k.CertAuthenticator(b"ca")
    cert = ca.sign("bob", ["dev"])
    assert ca.authenticate(k.Credential(cert=cert)).name == "bob"
    cert["orgs"] = ["system:masters"]
    assert ca.authenticate(k.Credential(cert=cert)) is None


# ---------------------------------------------------------------- authz


def test_rbac_namespaced_role_binding(k):
    api = make_server(k, auth=True, tokens={
        "admin": k.UserInfo("root", groups=["system:masters"]),
        "dev": k.UserInfo("dev-user")})
    admin, dev = k.Credential(token="admin"), k.Credential(token="dev")
    api.store.create("Role", k.Role("pod-reader", "default", rules=[
        k.PolicyRule(verbs=["get", "list"], resources=["pods"])]))
    api.store.create("RoleBinding", k.RoleBinding(
        "read-pods", "default", subjects=[k.Subject("User", "dev-user")],
        role_ref=k.RoleRef("Role", "pod-reader")))
    api.create("Pod", k.make_pod("p1"), cred=admin)
    assert api.get("Pod", "default", "p1", cred=dev).name == "p1"
    with pytest.raises(k.Forbidden):
        api.create("Pod", k.make_pod("p2"), cred=dev)
    with pytest.raises(k.Forbidden):
        api.delete("Pod", "default", "p1", cred=dev)


def test_scheduler_bootstrap_role_allows_binding(k):
    api = make_server(k, auth=True, tokens={
        "sched": k.UserInfo("system:kube-scheduler"),
        "admin": k.UserInfo("root", groups=["system:masters"])})
    api.create("Pod", k.make_pod("w"), cred=k.Credential(token="admin"))
    api.create("Node", k.make_node("n1"), cred=k.Credential(token="admin"))
    api.list("Node", cred=k.Credential(token="sched"))
    api.bind(k.Binding("w", "default", "default/w", "n1"),
             cred=k.Credential(token="sched"))
    with pytest.raises(k.Forbidden):
        api.delete("Pod", "default", "w", cred=k.Credential(token="sched"))


def test_node_authorizer_scopes_to_own_node(k):
    api = make_server(k, auth=True)
    ca = k.CertAuthenticator(b"ca-key")
    kubelet = k.Credential(cert=ca.sign("system:node:n1", ["system:nodes"]))
    api.store.create("Node", k.make_node("n1"))
    api.store.create("Node", k.make_node("n2"))
    n1 = api.get("Node", "", "n1", cred=kubelet)
    api.update("Node", n1, cred=kubelet)
    with pytest.raises(k.Rejected):
        api.update("Node", api.store.get("Node", "", "n2"), cred=kubelet)
    api.store.create("Pod", k.make_pod("mine", node_name="n1"))
    api.store.create("Pod", k.make_pod("theirs", node_name="n2"))
    p = api.get("Pod", "default", "mine", cred=kubelet)
    api.update_status("Pod", p, cred=kubelet)
    with pytest.raises(k.Rejected):
        q = api.store.get("Pod", "default", "theirs")
        api.update_status("Pod", q, cred=kubelet)


# ------------------------------------------------------------ admission


def test_namespace_lifecycle_blocks_creates(k):
    api = make_server(k)
    with pytest.raises(k.Rejected):
        api.create("Pod", k.make_pod("p", namespace="nope"))
    api.store.create("Namespace", k.Namespace("closing", phase="Terminating"))
    with pytest.raises(k.Rejected):
        api.create("Pod", k.make_pod("p", namespace="closing"))
    with pytest.raises(k.Rejected):
        api.delete("Namespace", "", "default")


def test_limit_ranger_defaults_and_bounds(k):
    api = make_server(k)
    api.store.create("LimitRange", k.LimitRange("lims", "default", limits=[
        k.LimitRangeItem(type="Container",
                         default_request={"cpu": 100, "memory": 64 * Mi},
                         max={"cpu": 2000})]))
    pod = k.make_pod("defaulted")
    pod.containers[0].requests.clear()
    api.create("Pod", pod)
    got = api.get("Pod", "default", "defaulted")
    assert got.containers[0].requests == {"cpu": 100, "memory": 64 * Mi}
    with pytest.raises(k.Rejected):
        api.create("Pod", k.make_pod("too-big", cpu=4000))


def test_default_toleration_seconds_added(k):
    api = make_server(k)
    api.create("Pod", k.make_pod("p"))
    got = api.get("Pod", "default", "p")
    keys = {t.key for t in got.tolerations}
    assert "node.alpha.kubernetes.io/notReady" in keys
    assert "node.alpha.kubernetes.io/unreachable" in keys
    assert all(t.toleration_seconds == 300 for t in got.tolerations)


def test_resource_quota_enforced_and_usage_tracked(k):
    api = make_server(k)
    api.store.create("ResourceQuota", k.ResourceQuota(
        "quota", "default", hard={"pods": 2, "requests.cpu": 1000}))
    api.create("Pod", k.make_pod("a", cpu=400, memory=Mi))
    api.create("Pod", k.make_pod("b", cpu=400, memory=Mi))
    with pytest.raises(k.Rejected):
        api.create("Pod", k.make_pod("c", cpu=100, memory=Mi))
    q = api.store.get("ResourceQuota", "default", "quota")
    assert q.used["pods"] == 2 and q.used["requests.cpu"] == 800
    api.store.create("Namespace", k.Namespace("other"))
    api.create("Pod", k.make_pod("c", namespace="other", cpu=100, memory=Mi))


def test_quota_cpu_exceeded(k):
    api = make_server(k)
    api.store.create("ResourceQuota", k.ResourceQuota(
        "cpuq", "default", hard={"requests.cpu": 500}))
    api.create("Pod", k.make_pod("a", cpu=400, memory=Mi))
    with pytest.raises(k.Rejected):
        api.create("Pod", k.make_pod("b", cpu=200, memory=Mi))


def test_pod_node_selector_merged_from_namespace(k):
    api = make_server(k)
    api.store.create("Namespace", k.Namespace(
        "tenant", annotations={
            "scheduler.alpha.kubernetes.io/node-selector": "team=infra"}))
    api.create("Pod", k.make_pod("p", namespace="tenant"))
    assert api.get("Pod", "tenant", "p").node_selector == {"team": "infra"}


def test_node_restriction_admission(k):
    api = make_server(k, auth=True)
    ca = k.CertAuthenticator(b"ca-key")
    kubelet = k.Credential(cert=ca.sign("system:node:n1", ["system:nodes"]))
    api.store.create("Node", k.make_node("n1"))
    api.store.create("Pod", k.make_pod("other", node_name="n2"))
    with pytest.raises((k.Rejected, k.Forbidden)):
        api.delete("Pod", "default", "other", cred=kubelet)


# --------------------------------------------------------- subresources


def test_eviction_respects_pdb(k):
    api = make_server(k)
    for i in range(3):
        api.create("Pod", k.make_pod(f"w{i}", labels={"app": "web"}))
    api.store.create("PodDisruptionBudget", k.PodDisruptionBudget(
        "web-pdb", "default", min_available=2,
        selector=k.LabelSelector(match_labels={"app": "web"}),
        disruptions_allowed=1))
    api.evict(k.Eviction("w0", "default"))
    with pytest.raises(k.TooManyRequests):
        api.evict(k.Eviction("w1", "default"))
    assert len(api.store.list("Pod")[0]) == 2


def test_scale_subresource(k):
    api = make_server(k)
    api.store.create("ReplicaSet", k.ReplicaSet(
        "rs", "default", replicas=3,
        selector=k.LabelSelector(match_labels={"a": "b"})))
    assert api.scale("ReplicaSet", "default", "rs") == 3
    api.scale("ReplicaSet", "default", "rs", replicas=5)
    assert api.store.get("ReplicaSet", "default", "rs").replicas == 5
    with pytest.raises(k.Invalid):
        api.scale("ReplicaSet", "default", "rs", replicas=-1)


def test_namespace_two_phase_delete(k):
    api = make_server(k)
    api.store.create("Namespace", k.Namespace("doomed"))
    api.delete("Namespace", "", "doomed")
    assert api.store.get("Namespace", "", "doomed").phase == "Terminating"
    api.finalize_namespace("doomed")
    with pytest.raises(Exception):
        api.store.get("Namespace", "", "doomed")


def test_strategy_validation(k):
    api = make_server(k)
    api.create("Pod", k.make_pod("ok"))
    api.store.create("Pod", k.make_pod("bound", node_name="n1"))
    with pytest.raises(k.Invalid):
        api.update("Pod", k.make_pod("bound", node_name="n2"))
    bad = k.make_pod("bad", cpu=100)
    bad.containers[0].limits["cpu"] = 50
    with pytest.raises(k.Invalid):
        api.create("Pod", bad)


def test_audit_log_records_denials(k):
    api = make_server(k, auth=True, tokens={"t": k.UserInfo("nobody")})
    with pytest.raises(k.Forbidden):
        api.create("Pod", k.make_pod("p"), cred=k.Credential(token="t"))
    ev = api.audit_log[-1]
    assert ev.user == "nobody" and ev.verb == "create" and ev.code == 403
    assert api.healthz() == {"status": "ok"}
    assert "admission" in api.configz()


def test_namespaced_list_with_namespaced_rbac(k):
    api = make_server(k, auth=True, tokens={
        "dev": k.UserInfo("dev-user"),
        "admin": k.UserInfo("root", groups=["system:masters"])})
    api.store.create("Namespace", k.Namespace("team-a"))
    api.store.create("Role", k.Role("reader", "team-a", rules=[
        k.PolicyRule(verbs=["list", "get"], resources=["pods"])]))
    api.store.create("RoleBinding", k.RoleBinding(
        "readers", "team-a", subjects=[k.Subject("User", "dev-user")],
        role_ref=k.RoleRef("Role", "reader")))
    api.create("Pod", k.make_pod("p1", namespace="team-a"),
               cred=k.Credential(token="admin"))
    api.create("Pod", k.make_pod("p2"), cred=k.Credential(token="admin"))
    objs, _ = api.list("Pod", cred=k.Credential(token="dev"),
                       namespace="team-a")
    assert [p.name for p in objs] == ["p1"]
    with pytest.raises(k.Forbidden):
        api.list("Pod", cred=k.Credential(token="dev"))


def test_admission_defaults_are_validated(k):
    api = make_server(k)
    api.store.create("LimitRange", k.LimitRange("lims", "default", limits=[
        k.LimitRangeItem(type="Container", default_request={"cpu": 500})]))
    bad = k.make_pod("defaulted-over-limit")
    bad.containers[0].requests.clear()
    bad.containers[0].limits["cpu"] = 100
    with pytest.raises(k.Invalid):
        api.create("Pod", bad)


def test_node_authorizer_secret_reachability(k):
    api = make_server(k, auth=True)
    ca = k.CertAuthenticator(b"ca-key")
    kubelet = k.Credential(cert=ca.sign("system:node:n1", ["system:nodes"]))
    api.store.create("Node", k.make_node("n1"))
    api.store.create("Secret", k.Secret("mine"))
    api.store.create("Secret", k.Secret("not-mine"))
    api.store.create("Pod", k.make_pod(
        "p", node_name="n1", volumes=[k.Volume(
            name="v", kind=k.VolumeKind.SECRET, volume_id="mine")]))
    assert api.get("Secret", "default", "mine", cred=kubelet).name == "mine"
    with pytest.raises(k.Forbidden):
        api.get("Secret", "default", "not-mine", cred=kubelet)
    with pytest.raises(k.Forbidden):
        api.list("Secret", cred=kubelet)


def test_csr_requestor_stamped_from_authenticated_user(k):
    api = make_server(k, auth=True,
                      tokens={"evil": k.UserInfo("mallory", groups=["devs"])})
    api.store.create("Role", k.Role(
        "csr-creator", "", rules=[k.PolicyRule(
            verbs=["create"], api_groups=["*"],
            resources=["certificatesigningrequests"])]))
    api.store.create("ClusterRole", k.ClusterRole(
        "csr-creator", rules=[k.PolicyRule(
            verbs=["create"], api_groups=["*"],
            resources=["certificatesigningrequests"])]))
    api.store.create("ClusterRoleBinding", k.ClusterRoleBinding(
        "mallory-csr", subjects=[k.Subject("User", "mallory")],
        role_ref=k.RoleRef("ClusterRole", "csr-creator")))
    api.create("CertificateSigningRequest", k.CertificateSigningRequest(
        "sneaky", requestor="system:bootstrap:abc",
        groups=["system:bootstrappers"], cn="system:node:n1",
        orgs=["system:nodes"]), cred=k.Credential(token="evil"))
    csr = api.store.get("CertificateSigningRequest", "", "sneaky")
    assert csr.requestor == "mallory"
    assert "devs" in csr.groups
    assert "system:bootstrappers" not in csr.groups


def test_quota_usage_rolled_back_on_failed_create(k):
    api = make_server(k)
    api.store.create("ResourceQuota", k.ResourceQuota(
        "q", "default", hard={"pods": 5}))
    api.create("Pod", k.make_pod("dup"))
    q1 = api.store.get("ResourceQuota", "default", "q")
    assert q1.used["pods"] == 1
    rv1 = q1.resource_version
    with pytest.raises(Exception):
        api.create("Pod", k.make_pod("dup"))
    q2 = api.store.get("ResourceQuota", "default", "q")
    assert q2.used["pods"] == 1
    assert q2.resource_version > rv1


def test_eviction_rejects_multiple_pdbs(k):
    api = make_server(k)
    api.store.create("Pod", k.make_pod("web", labels={"app": "web"}))
    for i in range(2):
        api.store.create("PodDisruptionBudget", k.PodDisruptionBudget(
            f"pdb{i}", "default",
            selector=k.LabelSelector(match_labels={"app": "web"}),
            disruptions_allowed=1))
    with pytest.raises(k.Invalid):
        api.evict(k.Eviction("web", "default"))


def test_node_cannot_self_grant_secret_via_pod_create(k):
    api = make_server(k, auth=True)
    ca = k.CertAuthenticator(b"ca-key")
    kubelet = k.Credential(cert=ca.sign("system:node:n1", ["system:nodes"]))
    api.store.create("Node", k.make_node("n1"))
    api.store.create("Secret", k.Secret("loot"))
    with pytest.raises(k.Rejected):
        api.create("Pod", k.make_pod(
            "steal", node_name="n1",
            volumes=[k.Volume("v", k.VolumeKind.SECRET, "loot")]),
            cred=kubelet)
    with pytest.raises(k.Rejected):
        api.create("Pod", k.make_pod("other", node_name="n2"), cred=kubelet)
    api.create("Pod", k.make_pod("static", node_name="n1"), cred=kubelet)


def test_csr_identity_immutable_after_create(k):
    api = make_server(k, auth=True,
                      tokens={"u": k.UserInfo("mallory", groups=["devs"])})
    api.store.create("ClusterRole", k.ClusterRole(
        "csr-rw", rules=[k.PolicyRule(
            verbs=["create", "update", "get"], api_groups=["*"],
            resources=["certificatesigningrequests"])]))
    api.store.create("ClusterRoleBinding", k.ClusterRoleBinding(
        "b", subjects=[k.Subject("User", "mallory")],
        role_ref=k.RoleRef("ClusterRole", "csr-rw")))
    cred = k.Credential(token="u")
    api.create("CertificateSigningRequest", k.CertificateSigningRequest(
        "c1", cn="system:node:nX", orgs=["system:nodes"]), cred=cred)
    csr = api.store.get("CertificateSigningRequest", "", "c1")
    evil = copy.deepcopy(csr)
    evil.groups = ["system:bootstrappers"]
    with pytest.raises(k.Invalid):
        api.update("CertificateSigningRequest", evil, cred=cred)
    flip = copy.deepcopy(csr)
    flip.approved = True
    with pytest.raises(k.Forbidden):
        api.update("CertificateSigningRequest", flip, cred=cred)


def test_audit_policy_levels_and_suppression(k):
    policy = k.AuditPolicy(rules=[
        k.AuditRule(level="None", users=["system:kube-proxy"],
                    verbs=["list", "get"]),
        k.AuditRule(level="Request", resources=["secrets"]),
        k.AuditRule(level="Metadata", verbs=["list"]),
    ], default_level="Metadata")
    api = k.ApiServer(audit_policy=policy)
    api.store.create("Namespace", k.Namespace("default"))
    api.create("Secret", k.Secret("s1", "default", data={}))
    api.list("Pod")
    entries = {(e.resource, e.verb): e.level for e in api.audit_log}
    assert entries[("secrets", "create")] == "Request"
    assert entries[("pods", "list")] == "Metadata"
    before = len(api.audit_log)
    api._audit(k.UserInfo("system:kube-proxy"), "list", "Endpoints", "", "",
               200)
    assert len(api.audit_log) == before
    api._audit(k.UserInfo("system:kube-proxy"), "update", "Endpoints", "",
               "", 200)
    assert api.audit_log[-1].level == "Metadata"


def test_impersonation_filter(k):
    api = make_server(k, auth=True, tokens={
        "admin": k.UserInfo("root", groups=["system:masters"]),
        "ci": k.UserInfo("ci-bot"),
        "dev": k.UserInfo("dev-user")})
    api.store.create("ClusterRole", k.ClusterRole("impersonator", rules=[
        k.PolicyRule(verbs=["impersonate"], resources=["users"])]))
    api.store.create("ClusterRoleBinding", k.ClusterRoleBinding(
        "ci-impersonates", subjects=[k.Subject("User", "ci-bot")],
        role_ref=k.RoleRef("ClusterRole", "impersonator")))
    api.store.create("Role", k.Role("pod-reader", "default", rules=[
        k.PolicyRule(verbs=["get", "list"], resources=["pods"])]))
    api.store.create("RoleBinding", k.RoleBinding(
        "read-pods", "default", subjects=[k.Subject("User", "dev-user")],
        role_ref=k.RoleRef("Role", "pod-reader")))
    api.create("Pod", k.make_pod("p"), cred=k.Credential(token="admin"))
    as_dev = k.Credential(token="ci", impersonate_user="dev-user")
    objs, _ = api.list("Pod", cred=as_dev, namespace="default")
    assert [p.name for p in objs] == ["p"]
    with pytest.raises(k.Forbidden):
        api.create("Pod", k.make_pod("p2"), cred=as_dev)
    assert any(e.user == "dev-user" for e in api.audit_log)
    with pytest.raises(k.Forbidden, match="cannot impersonate"):
        api.list("Pod",
                 cred=k.Credential(token="dev", impersonate_user="root"))
    with pytest.raises(k.Forbidden, match="cannot impersonate group"):
        api.list("Pod", cred=k.Credential(
            token="ci", impersonate_user="dev-user",
            impersonate_groups=("system:masters",)))


def test_ktctl_as_flag_impersonates(k):
    import io

    api = make_server(k, auth=True, tokens={
        "admin": k.UserInfo("root", groups=["system:masters"]),
        "ci": k.UserInfo("ci-bot")})
    api.store.create("ClusterRole", k.ClusterRole("impersonator", rules=[
        k.PolicyRule(verbs=["impersonate"], resources=["users"])]))
    api.store.create("ClusterRoleBinding", k.ClusterRoleBinding(
        "ci-imp", subjects=[k.Subject("User", "ci-bot")],
        role_ref=k.RoleRef("ClusterRole", "impersonator")))
    api.store.create("Role", k.Role("pod-reader", "default", rules=[
        k.PolicyRule(verbs=["get", "list"], resources=["pods"])]))
    api.store.create("RoleBinding", k.RoleBinding(
        "read-pods", "default", subjects=[k.Subject("User", "dev-user")],
        role_ref=k.RoleRef("Role", "pod-reader")))
    api.create("Pod", k.make_pod("p"), cred=k.Credential(token="admin"))
    out = io.StringIO()
    kt = k.Ktctl(api, out=out, cred=k.Credential(token="ci"))
    # ci-bot alone cannot list pods...
    with pytest.raises(k.Forbidden):
        kt.run(["get", "pods"])
    # ...but --as dev-user can (and only for this invocation)
    assert kt.run(["get", "pods", "--as", "dev-user"]) == 0
    assert "p" in out.getvalue()
    with pytest.raises(k.Forbidden):
        kt.run(["get", "pods"])


def test_denied_impersonation_is_audited(k):
    """The reference's
    test_denied_impersonation_is_audited_and_equals_form_caught: a 403
    impersonation attempt lands in the audit log attributed to the REAL
    user, and ktctl's --as=value equals form cannot slip past as an
    ordinary flag."""
    import io

    api = make_server(k, auth=True, tokens={
        "admin": k.UserInfo("root", groups=["system:masters"]),
        "dev": k.UserInfo("dev-user")})
    with pytest.raises(k.Forbidden):
        api.list("Pod", cred=k.Credential(token="dev",
                                          impersonate_user="root"))
    denied = [e for e in api.audit_log if e.code == 403]
    assert denied and denied[-1].user == "dev-user"
    # equals form: same Forbidden as the space form, never full privilege
    out = io.StringIO()
    kt = k.Ktctl(api, out=out, cred=k.Credential(token="dev"))
    with pytest.raises(k.Forbidden):
        kt.run(["get", "pods", "--as=root"])


def test_denied_impersonation_audited_on_watch_and_bind_many(k):
    api = make_server(k, auth=True, tokens={"dev": k.UserInfo("dev-user")})
    for call in (
        lambda: api.watch_since(("Pod",), 0, timeout=0.01,
                                cred=k.Credential(token="dev",
                                                  impersonate_user="root")),
        lambda: api.bind_many(
            [k.Binding("p", "default", "default/p", "n1")],
            cred=k.Credential(token="dev", impersonate_user="root")),
    ):
        before = len(api.audit_log)
        with pytest.raises(k.Forbidden):
            call()
        assert len(api.audit_log) == before + 1
        assert api.audit_log[-1].code == 403
        assert api.audit_log[-1].user == "dev-user"


def test_denied_watch_is_audited(k):
    api = make_server(k, auth=True, tokens={"dev": k.UserInfo("dev-user")})
    before = len(api.audit_log)
    with pytest.raises(k.Forbidden):
        api.watch_since(("Node",), 0, timeout=0.01,
                        cred=k.Credential(token="dev"))
    assert len(api.audit_log) == before + 1
    assert api.audit_log[-1].code == 403
    assert api.audit_log[-1].verb == "watch"


def test_allowed_watch_and_default_storageclass_field(k):
    api = make_server(k, auth=True, tokens={
        "admin": k.UserInfo("root", groups=["system:masters"])})
    api.watch_since(("Pod",), 0, timeout=0.01,
                    cred=k.Credential(token="admin"))
    assert any(e.verb == "watch" and e.code == 200 for e in api.audit_log)
    sc = k.StorageClass("fast", provisioner="gce-pd", is_default=True)
    api.create("StorageClass", sc, cred=k.Credential(token="admin"))
    got = api.get("StorageClass", "", "fast",
                  cred=k.Credential(token="admin"))
    assert got.is_default is True


# ------------------------------------------------ the port == the reference


def test_kind_info_is_the_same_table():
    assert PKGS[REF].apiserver.KIND_INFO == PKGS[PORT].apiserver.KIND_INFO


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _audit(api):
    return [dataclasses.astuple(e) for e in api.audit_log]


def _call(k, fn):
    """A verb's result as plain data, or its typed error."""
    try:
        out = fn()
    except Exception as e:  # compared across packages by name and text
        return ("error", type(e).__name__, str(e))
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[0], list):
        return ("list", sorted(o.name for o in out[0]))
    if hasattr(out, "name"):
        return ("obj", out.name)
    return ("ok", out if isinstance(out, (int, str, type(None))) else
            repr(type(out).__name__))


def _scripted(k, seed):
    """A seeded request mix through a secure ApiServer with an audit
    policy and a fixed clock: creates, gets, lists (namespaced and not),
    deletes, bindings, bind_many, evictions, watches and impersonation
    by users with and without grants."""
    clock = Clock()
    policy = k.AuditPolicy(rules=[
        k.AuditRule(level="None", users=["watcher"], verbs=["watch"]),
        k.AuditRule(level="Request", resources=["secrets"]),
    ])
    api = make_server(k, auth=True, now=clock, tokens={
        "admin": k.UserInfo("root", groups=["system:masters"]),
        "dev": k.UserInfo("dev-user"),
        "ci": k.UserInfo("ci-bot"),
        "sched": k.UserInfo("system:kube-scheduler"),
        "watch": k.UserInfo("watcher", groups=["system:masters"])})
    api.audit_policy = policy
    admin = k.Credential(token="admin")
    api.create("Namespace", k.Namespace("team"), cred=admin)
    api.create("Role", k.Role("rw", "team", rules=[k.PolicyRule(
        verbs=["get", "list", "create", "delete"], resources=["pods"])]),
        cred=admin)
    api.create("RoleBinding", k.RoleBinding(
        "rw", "team", subjects=[k.Subject("User", "dev-user")],
        role_ref=k.RoleRef("Role", "rw")), cred=admin)
    api.create("ClusterRole", k.ClusterRole("imp", rules=[k.PolicyRule(
        verbs=["impersonate"], resources=["users"])]), cred=admin)
    api.create("ClusterRoleBinding", k.ClusterRoleBinding(
        "imp", subjects=[k.Subject("User", "ci-bot")],
        role_ref=k.RoleRef("ClusterRole", "imp")), cred=admin)
    for i in range(4):
        api.create("Node", k.make_node(f"n{i}"), cred=admin)
    api.create("PodDisruptionBudget", k.PodDisruptionBudget(
        "web", "team", selector=k.LabelSelector(match_labels={"app": "web"}),
        disruptions_allowed=2), cred=admin)
    creds = {"admin": admin, "dev": k.Credential(token="dev"),
             "as-dev": k.Credential(token="ci", impersonate_user="dev-user"),
             "as-root": k.Credential(token="dev", impersonate_user="root"),
             "bad": k.Credential(token="nope"),
             "sched": k.Credential(token="sched"),
             "watch": k.Credential(token="watch")}
    rng = random.Random(seed)
    results = []
    for i in range(120):
        who = creds[rng.choice(list(creds))]
        ns = rng.choice(["team", "default", "missing"])
        name = f"p{rng.randrange(12)}"
        verb = rng.randrange(9)
        if verb == 0:
            fn = lambda: api.create("Pod", k.make_pod(
                name, namespace=ns, cpu=rng.choice([10, 100]),
                labels={"app": rng.choice(["web", "db"])}), cred=who)
        elif verb == 1:
            fn = lambda: api.get("Pod", ns, name, cred=who)
        elif verb == 2:
            fn = lambda: api.list("Pod", cred=who,
                                  namespace=rng.choice(["", ns]))
        elif verb == 3:
            fn = lambda: api.delete("Pod", ns, name, cred=who)
        elif verb == 4:
            fn = lambda: api.bind(k.Binding(
                name, ns, f"{ns}/{name}", f"n{rng.randrange(5)}"), cred=who)
        elif verb == 5:
            fn = lambda: api.bind_many([k.Binding(
                f"p{j}", ns, f"{ns}/p{j}", f"n{j % 4}")
                for j in range(rng.randrange(1, 4))], cred=who)
        elif verb == 6:
            fn = lambda: api.evict(k.Eviction(name, ns), cred=who)
        elif verb == 7:
            fn = lambda: len(api.watch_since(("Pod",), 0, timeout=0.001,
                                             cred=who))
        else:
            fn = lambda: api.create("Secret", k.Secret(
                f"s{i}", ns, data={}), cred=who)
        out = _call(k, fn)
        if out[0] == "ok" and isinstance(out[1], list):
            out = ("ok", [None if e is None else str(e) for e in out[1]])
        results.append(out)
    return results, _audit(api), sorted(
        (p.namespace, p.name, p.node_name)
        for p in api.store.list("Pod")[0])


def test_scripted_requests_and_audit_entries_are_equal():
    ref = _scripted(PKGS[REF], 3)
    port = _scripted(PKGS[PORT], 3)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    codes = {e[5] for e in port[1]}
    # allowed, forbidden, missing, conflict and over-budget all occurred
    assert {200, 403, 404}.issubset(codes), codes
    assert any(r[0] == "error" and r[1] == "Unauthenticated"
               for r in port[0])


def test_eviction_outcomes_against_budgets_are_equal():
    """Seeded evictions over pods under one, two or no PDBs: the same
    typed outcomes (200, 429, 422, 404) and surviving pods."""
    def run(k):
        api = make_server(k, now=Clock())
        for i in range(12):
            api.create("Pod", k.make_pod(
                f"w{i}", labels={"app": ["web", "db", "batch"][i % 3]}))
        api.store.create("PodDisruptionBudget", k.PodDisruptionBudget(
            "web", "default",
            selector=k.LabelSelector(match_labels={"app": "web"}),
            disruptions_allowed=2))
        for j in range(2):
            api.store.create("PodDisruptionBudget", k.PodDisruptionBudget(
                f"db{j}", "default",
                selector=k.LabelSelector(match_labels={"app": "db"}),
                disruptions_allowed=5))
        rng = random.Random(8)
        out = [_call(k, lambda: api.evict(k.Eviction(
            f"w{rng.randrange(14)}", "default"))) for _ in range(20)]
        left = sorted(p.name for p in api.store.list("Pod")[0])
        budgets = sorted((b.name, b.disruptions_allowed) for b in
                         api.store.list("PodDisruptionBudget")[0])
        return out, left, budgets, _audit(api)

    ref, port = run(PKGS[REF]), run(PKGS[PORT])
    assert port == ref
    assert {e[1] for e in port[0] if e[0] == "error"} == {
        "TooManyRequests", "Invalid", "NotFound"}


# ------------------------------------------------------- the slice whole

REQUESTS = {"cpu": 150, "memory": 300 << 20}
CLASSES = {"bench-high": 1000, "bench-low": 10}


def _front_door_drain(k, n_nodes, n_admit, over):
    """The scheduler behind ApiServer() with the default chain: the bench
    Namespace, a LimitRange with default container requests, two
    PriorityClasses (PodPriority on), a quota of n_admit pods, then
    n_admit + over mixed_affinity pods created through the chain (one in
    five stripped of requests, one in ten bench-high), drained."""
    api = k.ApiServer(now=Clock())
    api.create("Namespace", k.Namespace(name="bench"))
    api.create("LimitRange", k.LimitRange(
        name="bench-defaults", namespace="bench",
        limits=[k.LimitRangeItem(type="Container",
                                 default_request=dict(REQUESTS))]))
    for name, value in CLASSES.items():
        api.create("PriorityClass", k.PriorityClass(name=name, value=value))
    api.create("ResourceQuota", k.ResourceQuota(
        name="bench-pods", namespace="bench", hard={"pods": n_admit}))
    for node in k.hollow.hollow_nodes(n_nodes):
        api.create("Node", node)
    sched_mod = importlib.import_module(f"{k.root}.engine.scheduler")
    kw = {"device": "cpu"} if k.root == PORT else {}
    sched = sched_mod.Scheduler(api, record_events=False, **kw)
    sched.start()
    pods = k.hollow.mixed_affinity_pods(n_admit + over)
    refused = []
    for i, p in enumerate(pods):
        if i % 5 == 1:
            p.containers = [dataclasses.replace(c, requests={})
                            for c in p.containers]
        p.priority_class = "bench-high" if i % 10 == 3 else "bench-low"
        try:
            api.create("Pod", p)
        except k.Rejected as e:
            refused.append((p.name, str(e)))
    tot = sched.run_until_drained()
    if hasattr(sched.engine, "close"):
        sched.engine.close()
    stored = sorted(api.store.list("Pod")[0], key=lambda p: p.name)
    quota = api.store.get("ResourceQuota", "bench", "bench-pods")
    return {
        "placements": [(p.name, p.node_name) for p in stored],
        "requests": [(p.name, [c.requests for c in p.containers])
                     for p in stored],
        "priorities": [(p.name, p.priority) for p in stored],
        "totals": tot, "refused": refused,
        "quota": (dict(quota.hard), dict(quota.used)),
        "audit": _audit(api)}


def test_scheduler_behind_the_front_door_matches_reference():
    """The port's Scheduler(ApiServer(), device="cpu") against the
    reference's Scheduler(ApiServer()) (JAX on the CPU) at 64 nodes x 400
    mixed_affinity pods (+16 past the quota)."""
    gates = [PKGS[r].features.DEFAULT_FEATURE_GATE for r in (REF, PORT)]
    for g in gates:
        g.set("PodPriority", True)
    try:
        ref = _front_door_drain(PKGS[REF], 64, 400, 16)
        port = _front_door_drain(PKGS[PORT], 64, 400, 16)
    finally:
        for g in gates:
            g.set("PodPriority", False)
    for key in ("placements", "requests", "priorities", "totals",
                "refused", "quota", "audit"):
        assert port[key] == ref[key], key
    assert port["totals"]["bound"] == 400
    assert port["totals"]["bind_errors"] == 0
    assert len(port["refused"]) == 16
    assert port["quota"] == ({"pods": 400}, {"pods": 400})
    assert sum(1 for _, r in port["requests"] if r == [REQUESTS]) == 80
    assert any(name.startswith("<batch of") and code == 200
               for _u, _v, _r, _n, name, code, _t, _l in port["audit"])
