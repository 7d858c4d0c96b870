"""PodSecurityPolicy: the policy object + the validate/mutate provider.

Mirror of the reference's PSP surface (pkg/apis/extensions/types.go:875-1030
PodSecurityPolicySpec; provider pkg/security/podsecuritypolicy/provider.go;
strategies under pkg/security/podsecuritypolicy/{user,capabilities,...}):

- boolean gates: privileged, hostNetwork
- hostPorts: list of allowed [min, max] ranges
- volumes: allowed FSTypes ("*" = everything); our Volume model collapses
  scheduling-inert sources to OTHER, so FSTypes here are the VolumeKind
  values plus "*"
- runAsUser: RunAsAny | MustRunAsNonRoot | MustRunAs{ranges} — MustRunAs
  DEFAULTS an unset pod-level runAsUser to the first range's min (the
  generating half of the strategy, user/mustrunas.go Generate) and
  validates explicit values against the ranges
- readOnlyRootFilesystem: required when true

The provider is pure: validate(pod) -> [errors]; apply_defaults(pod) -> a
mutated COPY (the admission plugin commits it only if validation passes,
like provider.DefaultPodSecurityContext + ValidatePod in admission.go:177).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from kubernetes_tpu_torch.api.types import (
    Pod,
    PodSecurityContext,
    VolumeKind,
)
from kubernetes_tpu_torch.security import securitycontext as sc

PSP_KIND = "PodSecurityPolicy"
PSP_ANNOTATION = "kubernetes.io/psp"  # admission.go:41 pspAnnotation

RUN_AS_ANY = "RunAsAny"
MUST_RUN_AS = "MustRunAs"
MUST_RUN_AS_NON_ROOT = "MustRunAsNonRoot"


@dataclass
class PodSecurityPolicy:
    """extensions/v1beta1 PodSecurityPolicy reduced to the enforced slice."""

    name: str
    privileged: bool = False
    host_network: bool = False
    host_ports: List[Tuple[int, int]] = field(default_factory=list)
    volumes: List[str] = field(default_factory=lambda: ["*"])
    run_as_user_rule: str = RUN_AS_ANY
    run_as_user_ranges: List[Tuple[int, int]] = field(default_factory=list)
    read_only_root_filesystem: bool = False
    labels: dict = field(default_factory=dict)
    annotations: dict = field(default_factory=dict)
    resource_version: int = 0


class Provider:
    """provider.go: one PSP's validate + default logic."""

    def __init__(self, psp: PodSecurityPolicy):
        self.psp = psp

    # ------------------------------------------------------------- defaults

    def apply_defaults(self, pod: Pod) -> Pod:
        """The generating half (DefaultPodSecurityContext): MustRunAs with
        no explicit runAsUser anywhere assigns the first range's min at the
        pod level. Copies lazily — a policy with nothing to default returns
        the input unchanged (the admission loop tries every policy, so the
        common RunAsAny case must not pay a deepcopy per policy)."""
        if self.psp.run_as_user_rule == MUST_RUN_AS \
                and self.psp.run_as_user_ranges \
                and not any(sc.effective_run_as_user(pod, c) is not None
                            for c in pod.containers):
            out = copy.deepcopy(pod)
            base = out.security_context or PodSecurityContext()
            out.security_context = dataclasses.replace(
                base, run_as_user=self.psp.run_as_user_ranges[0][0])
            return out
        return pod

    # ------------------------------------------------------------- validate

    def validate(self, pod: Pod) -> List[str]:
        errs: List[str] = []
        psp = self.psp
        if pod.host_network and not psp.host_network:
            errs.append("hostNetwork is not allowed to be used")
        allowed_vols = set(psp.volumes)
        if "*" not in allowed_vols:
            for v in pod.volumes:
                kind = VolumeKind(v.kind).value
                if kind not in allowed_vols:
                    errs.append(f"volume kind {kind} is not allowed")
        for c in pod.containers:
            if sc.is_privileged(c) and not psp.privileged:
                errs.append(
                    f"container {c.name}: privileged is not allowed")
            for p in c.ports:
                if p.host_port and not self._host_port_ok(p.host_port):
                    errs.append(f"container {c.name}: host port "
                                f"{p.host_port} is not allowed")
            errs.extend(self._validate_run_as_user(pod, c))
            if psp.read_only_root_filesystem \
                    and sc.read_only_root(c) is not True:
                errs.append(f"container {c.name}: root filesystem must be "
                            "read-only")
        return errs

    def _host_port_ok(self, port: int) -> bool:
        if not self.psp.host_ports:
            return False  # no ranges = no host ports (types.go:904-906)
        return any(lo <= port <= hi for lo, hi in self.psp.host_ports)

    def _validate_run_as_user(self, pod: Pod, c) -> List[str]:
        rule = self.psp.run_as_user_rule
        uid = sc.effective_run_as_user(pod, c)
        if rule == RUN_AS_ANY:
            return []
        if rule == MUST_RUN_AS_NON_ROOT:
            # user/nonroot.go: uid 0 is invalid; unset uid needs
            # runAsNonRoot=true so the runtime can verify
            if uid == 0:
                return [f"container {c.name}: running as root is not "
                        "allowed (MustRunAsNonRoot)"]
            if uid is None and sc.effective_run_as_non_root(pod, c) \
                    is not True:
                return [f"container {c.name}: runAsNonRoot must be true "
                        "or runAsUser set (MustRunAsNonRoot)"]
            return []
        if rule == MUST_RUN_AS:
            if uid is None:
                return [f"container {c.name}: runAsUser must be set "
                        "(MustRunAs)"]
            if not any(lo <= uid <= hi
                       for lo, hi in self.psp.run_as_user_ranges):
                return [f"container {c.name}: runAsUser {uid} outside "
                        "allowed ranges (MustRunAs)"]
            return []
        return [f"unknown runAsUser rule {rule!r}"]
