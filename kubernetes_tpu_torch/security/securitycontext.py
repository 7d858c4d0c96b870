"""Effective security-context resolution (pkg/securitycontext/util.go):
container-level values override pod-level defaults; absent values stay None
so callers can distinguish unset from explicit."""

from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.api.types import (
    Container,
    Pod,
    PodSecurityContext,
    SecurityContext,
)


def effective_run_as_user(pod: Pod, c: Container) -> Optional[int]:
    if c.security_context is not None \
            and c.security_context.run_as_user is not None:
        return c.security_context.run_as_user
    if pod.security_context is not None:
        return pod.security_context.run_as_user
    return None


def effective_run_as_non_root(pod: Pod, c: Container) -> Optional[bool]:
    if c.security_context is not None \
            and c.security_context.run_as_non_root is not None:
        return c.security_context.run_as_non_root
    if pod.security_context is not None:
        return pod.security_context.run_as_non_root
    return None


def is_privileged(c: Container) -> bool:
    return bool(c.security_context is not None
                and c.security_context.privileged)


def read_only_root(c: Container) -> Optional[bool]:
    if c.security_context is None:
        return None
    return c.security_context.read_only_root_filesystem
