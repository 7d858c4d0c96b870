"""CSR approving + signing controllers.

References: pkg/controller/certificates/{certificate_controller.go,
approver/sarapprove.go (1.7: cmd/gke-certificates-controller approval
logic), signer}. Approval policy mirrors the kubelet bootstrap flow: a CSR
for cn system:node:<name> with org system:nodes, requested by a bootstrap
identity (group system:bootstrappers) or by the node itself (renewal), is
auto-approved; everything else waits for manual approval. Signing issues
the HMAC identity record the CertAuthenticator trusts."""

from __future__ import annotations

from kubernetes_tpu_torch.auth.authn import CertAuthenticator
from kubernetes_tpu_torch.client.informer import SharedInformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, NotFound

NODES_GROUP = "system:nodes"
BOOTSTRAP_GROUP = "system:bootstrappers"


class CSRApprovingController(Controller):
    name = "csrapproving"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 record_events: bool = True):
        super().__init__(api, record_events=record_events)
        factory.informer("CertificateSigningRequest").add_event_handler(
            on_add=lambda o: self.enqueue(o.name),
            on_update=lambda o, n: self.enqueue(n.name))

    def sync(self, key: str) -> None:
        try:
            csr = self.api.get("CertificateSigningRequest", "", key)
        except NotFound:
            return
        if csr.approved or csr.denied:
            return
        is_node_cert = (csr.cn.startswith("system:node:")
                        and csr.orgs == [NODES_GROUP])
        requestor_ok = (BOOTSTRAP_GROUP in csr.groups
                        or csr.requestor == csr.cn)
        if is_node_cert and requestor_ok:
            csr.approved = True
            self.api.update("CertificateSigningRequest", csr,
                            expect_rv=csr.resource_version)
            self.event("CertificateSigningRequest", key, "Normal",
                       "Approved", "auto-approved kubelet certificate")


class CSRSigningController(Controller):
    name = "csrsigning"

    def __init__(self, api: ApiServerLite, factory: SharedInformerFactory,
                 ca: CertAuthenticator, record_events: bool = True):
        super().__init__(api, record_events=record_events)
        self.ca = ca
        factory.informer("CertificateSigningRequest").add_event_handler(
            on_add=lambda o: self.enqueue(o.name),
            on_update=lambda o, n: self.enqueue(n.name))

    def sync(self, key: str) -> None:
        try:
            csr = self.api.get("CertificateSigningRequest", "", key)
        except NotFound:
            return
        if not csr.approved or csr.certificate is not None:
            return
        csr.certificate = self.ca.sign(csr.cn, csr.orgs)
        self.api.update("CertificateSigningRequest", csr,
                        expect_rv=csr.resource_version)
