"""ktadm: the kubeadm-equivalent cluster bootstrap tool.

Mirrors cmd/kubeadm/app's phase architecture (cmd/kubeadm/app/phases/):

  ktadm init            preflight -> certs -> kubeconfig -> control-plane
                        (static manifests) -> bootstrap-token -> RBAC
  ktadm join            bootstrap-token auth -> CSR -> auto-approve/sign
                        -> node registration with the signed identity
                        (app/discovery + app/node: the TLS bootstrap flow)
  ktadm token           create | list | delete
  ktadm preflight       run the checks alone

Differences from the reference are deliberate and TPU-framework-shaped:
"certs" are the HMAC identity records CertAuthenticator verifies (the
x509 stand-in used across this framework), the control-plane manifests
are static-pod JSON the hollow kubelet's file source loads
(nodes/kubelet.py load_static_dir, mirroring kubeadm writing
/etc/kubernetes/manifests for the real kubelet), and init wires an
in-process ApiServer instead of systemd units.
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets as pysecrets
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api.cluster import CertificateSigningRequest, Secret
from kubernetes_tpu_torch.api.rbac import UserInfo
from kubernetes_tpu_torch.api.types import make_node
from kubernetes_tpu_torch.api.workloads import Namespace
from kubernetes_tpu_torch.auth.authn import (
    BootstrapTokenAuthenticator,
    CertAuthenticator,
    Credential,
    ServiceAccountTokenAuthenticator,
    TokenAuthenticator,
    UnionAuthenticator,
)
from kubernetes_tpu_torch.server.apiserver import ApiServer
from kubernetes_tpu_torch.server.apiserver_lite import Conflict, NotFound

CONTROL_PLANE_COMPONENTS = ("kube-apiserver", "kube-controller-manager",
                            "kube-scheduler")


def generate_token() -> str:
    """kubeadm token format: <6 lowercase alnum>.<16 lowercase alnum>
    (cmd/kubeadm/app/util/token/tokens.go)."""
    alphabet = "abcdefghijklmnopqrstuvwxyz0123456789"
    tid = "".join(pysecrets.choice(alphabet) for _ in range(6))
    sec = "".join(pysecrets.choice(alphabet) for _ in range(16))
    return f"{tid}.{sec}"


def ca_hash(ca_key: bytes) -> str:
    """The --discovery-token-ca-cert-hash pin (app/discovery/token):
    joiners verify they reached the intended cluster."""
    return "sha256:" + hashlib.sha256(ca_key).hexdigest()


@dataclass
class InitResult:
    api: ApiServer
    ca: CertAuthenticator
    ca_key: bytes
    bootstrap: BootstrapTokenAuthenticator
    token: str
    admin_cred: Credential
    workdir: str
    kubeconfigs: Dict[str, dict] = field(default_factory=dict)

    def join_command(self) -> str:
        return (f"ktadm join --token {self.token} "
                f"--discovery-token-ca-cert-hash {ca_hash(self.ca_key)}")


class KtAdm:
    """Phase runner. Each phase_* is independently invocable (the kubeadm
    `alpha phase` palette); `init` composes them in reference order."""

    def __init__(self, out=None, now=time.time):
        self.out = out if out is not None else sys.stdout
        self._now = now

    def _print(self, s: str) -> None:
        self.out.write(s + "\n")

    # ------------------------------------------------------------ preflight

    def preflight(self, workdir: str) -> List[str]:
        """app/preflight/checks.go, the in-process subset: workdir state,
        clock sanity, prior-init detection. Returns failed checks."""
        errors: List[str] = []
        parent = os.path.dirname(os.path.abspath(workdir)) or "."
        if not os.path.isdir(parent):
            errors.append(f"workdir parent {parent!r} does not exist")
        elif not os.access(parent, os.W_OK):
            errors.append(f"workdir parent {parent!r} is not writable")
        if os.path.exists(os.path.join(workdir, "pki", "ca.key")):
            errors.append(
                f"{workdir}/pki/ca.key already exists — cluster already "
                f"initialized (run `ktadm reset` first)")
        manifests = os.path.join(workdir, "manifests")
        if os.path.isdir(manifests) and os.listdir(manifests):
            errors.append(f"{manifests} is not empty")
        if self._now() < 1_000_000_000:  # clock sanity (NTP check analog)
            errors.append("system clock is before 2001 — fix time sync")
        for e in errors:
            self._print(f"[preflight] FAIL: {e}")
        if not errors:
            self._print("[preflight] all checks passed")
        return errors

    # ---------------------------------------------------------------- certs

    def phase_certs(self, workdir: str) -> Tuple[CertAuthenticator, bytes]:
        """app/phases/certs: mint the CA and the component identities
        signed by it."""
        pki = os.path.join(workdir, "pki")
        os.makedirs(pki, exist_ok=True)
        ca_key = pysecrets.token_bytes(32)
        with open(os.path.join(pki, "ca.key"), "wb") as f:
            f.write(ca_key)
        ca = CertAuthenticator(ca_key)
        identities = {
            "admin": ("kubernetes-admin", ["system:masters"]),
            "controller-manager": ("system:kube-controller-manager", []),
            "scheduler": ("system:kube-scheduler", []),
            "apiserver": ("kube-apiserver", []),
        }
        for fname, (cn, orgs) in identities.items():
            cert = ca.sign(cn, orgs)
            with open(os.path.join(pki, fname + ".cert.json"), "w") as f:
                json.dump(cert, f)
        self._print(f"[certs] CA + {len(identities)} component "
                    f"identities written to {pki}")
        return ca, ca_key

    # ----------------------------------------------------------- kubeconfig

    def phase_kubeconfig(self, workdir: str, server: str) -> Dict[str, dict]:
        """app/phases/kubeconfig: one context file per component."""
        pki = os.path.join(workdir, "pki")
        out: Dict[str, dict] = {}
        for comp in ("admin", "controller-manager", "scheduler"):
            with open(os.path.join(pki, comp + ".cert.json")) as f:
                cert = json.load(f)
            cfg = {"server": server, "user": cert["cn"], "cert": cert}
            path = os.path.join(workdir, comp + ".conf")
            with open(path, "w") as f:
                json.dump(cfg, f)
            out[comp] = cfg
        self._print(f"[kubeconfig] wrote {len(out)} kubeconfig files")
        return out

    # -------------------------------------------------------- control plane

    def phase_control_plane(self, workdir: str) -> List[str]:
        """app/phases/controlplane: static-pod manifests the kubelet file
        source runs (nodes/kubelet.py load_static_dir reads this dir)."""
        manifests = os.path.join(workdir, "manifests")
        os.makedirs(manifests, exist_ok=True)
        written = []
        for comp in CONTROL_PLANE_COMPONENTS:
            manifest = {
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": comp, "namespace": "kube-system",
                             "labels": {"component": comp,
                                        "tier": "control-plane"}},
                "spec": {"containers": [{
                    "name": comp,
                    "image": f"ktpu/{comp}:v1.7-tpu",
                    "resources": {"requests": {"cpu": "250m",
                                               "memory": "128Mi"}},
                }], "hostNetwork": True},
            }
            path = os.path.join(manifests, comp + ".json")
            with open(path, "w") as f:
                json.dump(manifest, f, indent=1)
            written.append(path)
        self._print(f"[control-plane] wrote {len(written)} static-pod "
                    f"manifests to {manifests}")
        return written

    # ------------------------------------------------------ bootstrap token

    def phase_bootstrap_token(self, api: ApiServer,
                              bootstrap: BootstrapTokenAuthenticator,
                              token: Optional[str] = None,
                              ttl: float = 86400.0) -> str:
        """app/phases/token: register the token with the authenticator and
        persist it as a kube-system Secret (bootstrap.kubernetes.io/token),
        which is what `ktadm token list` reads back."""
        token = token or generate_token()
        tid, _, sec = token.partition(".")
        bootstrap.add_token(tid, sec, ttl=ttl)
        api.store.create("Secret", Secret(
            f"bootstrap-token-{tid}", "kube-system",
            data={"token-id": tid, "token-secret": sec,
                  "expiration": str(self._now() + ttl),
                  "usage-bootstrap-authentication": "true"}))
        self._print(f"[bootstrap-token] created token {tid}.<redacted>")
        return token

    # ------------------------------------------------------- bootstrap RBAC

    def phase_bootstrap_rbac(self, api: ApiServer) -> None:
        """app/phases/bootstraptoken/node: let the system:bootstrappers
        group post CSRs (the kubeadm:kubelet-bootstrap binding to
        system:node-bootstrapper)."""
        from kubernetes_tpu_torch.api.rbac import (
            ClusterRole,
            ClusterRoleBinding,
            PolicyRule,
            RoleRef,
            Subject,
        )
        api.store.create("ClusterRole", ClusterRole(
            "system:node-bootstrapper", rules=[
                PolicyRule(verbs=["create", "get", "list", "watch"],
                           resources=["certificatesigningrequests"])]))
        api.store.create("ClusterRoleBinding", ClusterRoleBinding(
            "kubeadm:kubelet-bootstrap",
            subjects=[Subject("Group", "system:bootstrappers")],
            role_ref=RoleRef("ClusterRole", "system:node-bootstrapper")))
        self._print("[bootstrap-rbac] kubelet-bootstrap binding installed")

    # ------------------------------------------------------------------ init

    def init(self, workdir: str, server: str = "in-process",
             token: Optional[str] = None) -> InitResult:
        errors = self.preflight(workdir)
        if errors:
            raise SystemExit("error: preflight checks failed")
        ca, ca_key = self.phase_certs(workdir)
        kubeconfigs = self.phase_kubeconfig(workdir, server)
        self.phase_control_plane(workdir)

        bootstrap = BootstrapTokenAuthenticator(now=self._now)
        authn = UnionAuthenticator([
            TokenAuthenticator({}),
            bootstrap,
            ServiceAccountTokenAuthenticator(ca_key),
            CertAuthenticator(ca_key),
        ])
        api = ApiServer(auth=True, authenticator=authn)
        for ns in ("default", "kube-system", "kube-public"):
            api.store.create("Namespace", Namespace(ns))
        api.bootstrap_rbac()
        self.phase_bootstrap_rbac(api)
        tok = self.phase_bootstrap_token(api, bootstrap, token=token)
        admin_cred = Credential(cert=kubeconfigs["admin"]["cert"])
        res = InitResult(api=api, ca=ca, ca_key=ca_key, bootstrap=bootstrap,
                         token=tok, admin_cred=admin_cred, workdir=workdir,
                         kubeconfigs=kubeconfigs)
        self._print("Your control plane has initialized successfully!")
        self._print("Join nodes with:\n  " + res.join_command())
        return res

    # ------------------------------------------------------------------ join

    def join(self, cluster: InitResult, node_name: str,
             token: str, ca_cert_hash: str = "",
             cpu: int = 4000, memory: int = 32 << 30) -> Credential:
        """The TLS-bootstrap join flow (app/discovery + kubelet
        bootstrap): authenticate with the bootstrap token, pin the CA,
        post a CSR, let csrapproving/csrsigning issue the node identity,
        then register the Node using it."""
        if ca_cert_hash and ca_cert_hash != ca_hash(cluster.ca_key):
            raise SystemExit(
                "error: cluster CA does not match "
                "--discovery-token-ca-cert-hash (possible MITM)")
        cred = Credential(token=token)
        api = cluster.api
        csr = CertificateSigningRequest(
            name=f"node-csr-{node_name}",
            cn=f"system:node:{node_name}", orgs=["system:nodes"])
        # create through the chain: the registry stamps requestor/groups
        # from the authenticated bootstrap identity
        api.create("CertificateSigningRequest", csr, cred=cred)

        # the controller pair: auto-approve (bootstrap requestor + node
        # shape) then sign with the cluster CA
        from kubernetes_tpu_torch.client.informer import SharedInformerFactory
        from kubernetes_tpu_torch.controllers.certificates import (
            CSRApprovingController,
            CSRSigningController,
        )
        factory = SharedInformerFactory(api.store)
        approving = CSRApprovingController(api.store, factory,
                                           record_events=False)
        signing = CSRSigningController(api.store, factory, cluster.ca,
                                       record_events=False)
        factory.start()
        factory.step_all()
        approving.sync(csr.name)
        signing.sync(csr.name)
        issued = api.store.get("CertificateSigningRequest", "", csr.name)
        if issued.certificate is None:
            raise SystemExit(
                f"error: CSR {csr.name} was not issued "
                f"(approved={issued.approved}, denied={issued.denied})")
        node_cred = Credential(cert=issued.certificate)
        node = make_node(node_name, cpu=cpu, memory=memory)
        try:
            api.create("Node", node, cred=node_cred)
        except Conflict:
            pass
        self._print(f"[join] node {node_name} joined the cluster")
        return node_cred

    # ----------------------------------------------------------------- token

    def token_list(self, cluster: InitResult) -> List[str]:
        rows = []
        for s in cluster.api.store.list("Secret")[0]:
            if s.namespace == "kube-system" \
                    and s.name.startswith("bootstrap-token-"):
                tid = s.data.get("token-id", "")
                exp = float(s.data.get("expiration", "0"))
                ttl = max(0, int(exp - self._now()))
                rows.append(f"{tid}.<redacted>  ttl={ttl}s")
        for r in rows:
            self._print(r)
        if not rows:
            self._print("no bootstrap tokens")
        return rows

    def token_create(self, cluster: InitResult,
                     ttl: float = 86400.0) -> str:
        tok = self.phase_bootstrap_token(cluster.api, cluster.bootstrap,
                                         ttl=ttl)
        self._print(tok)
        return tok

    def token_delete(self, cluster: InitResult, token_id: str) -> None:
        cluster.bootstrap.revoke(token_id)
        try:
            cluster.api.store.delete("Secret", "kube-system",
                                     f"bootstrap-token-{token_id}")
        except NotFound:
            raise SystemExit(f"error: token {token_id!r} not found")
        self._print(f"bootstrap token {token_id!r} deleted")

    # ----------------------------------------------------------------- reset

    def reset(self, workdir: str) -> None:
        """kubeadm reset: tear the on-disk phase artifacts down."""
        import shutil
        for sub in ("pki", "manifests"):
            shutil.rmtree(os.path.join(workdir, sub), ignore_errors=True)
        for comp in ("admin", "controller-manager", "scheduler"):
            try:
                os.unlink(os.path.join(workdir, comp + ".conf"))
            except FileNotFoundError:
                pass
        self._print(f"[reset] cleaned {workdir}")
