"""Admission control: mutate-then-validate interceptors ahead of storage.

Mirror of staging/src/k8s.io/apiserver/pkg/admission/chain.go (chainAdmissionHandler
runs every plugin's Admit in order; any error rejects the request) and the
reference's plugin set under plugin/pkg/admission/. The recommended 1.7
plugin order (kube-apiserver docs / pkg/kubeapiserver/options):
NamespaceLifecycle, LimitRanger, ServiceAccount, DefaultTolerationSeconds,
ResourceQuota last.

Each plugin: handles(request) by operation/kind, then admit(request) which
may mutate request.obj or raise Rejected (HTTP 403-equivalent).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from kubernetes_tpu_torch.api.rbac import UserInfo

CREATE, UPDATE, DELETE, CONNECT = "CREATE", "UPDATE", "DELETE", "CONNECT"


class Rejected(Exception):
    """admission denied the request."""


@dataclass
class AdmissionRequest:
    operation: str
    kind: str
    namespace: str
    name: str
    obj: object = None
    old_obj: object = None
    user: Optional[UserInfo] = None
    subresource: str = ""
    # side effects plugins committed during admit (e.g. quota usage CAS) as
    # undo callables, run by rollback() if the request fails downstream
    undo: List = field(default_factory=list)


class AdmissionChain:
    def __init__(self, plugins: List, store=None):
        self.plugins = list(plugins)
        for p in self.plugins:
            if hasattr(p, "set_store"):
                p.set_store(store)

    def admit(self, req: AdmissionRequest) -> None:
        for p in self.plugins:
            if p.handles(req):
                try:
                    p.admit(req)
                except Exception:
                    self.rollback(req)
                    raise

    def rollback(self, req: AdmissionRequest) -> None:
        """Undo plugin side effects after a downstream failure (registry
        validation / storage), newest first."""
        while req.undo:
            req.undo.pop()()


def default_plugins():
    """The reference's recommended plugin set for 1.7 in order
    (pkg/kubeapiserver/options/plugins.go)."""
    from kubernetes_tpu_torch.admission import plugins as m

    return [
        m.NamespaceLifecycle(),
        m.AlwaysPullImages(enabled=False),
        m.LimitRanger(),
        m.ServiceAccountPlugin(),
        m.PodNodeSelector(),
        m.PodTolerationRestriction(),
        m.DefaultTolerationSeconds(),
        m.NodeRestriction(),
        m.PriorityPlugin(),
        m.StorageClassDefault(),
        m.ResourceQuotaPlugin(),  # last, like the reference's ordering
    ]
