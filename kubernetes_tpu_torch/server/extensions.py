"""Server-side API extension machinery: CRD lifecycle + the aggregator.

Two reference components re-built for the in-process control plane:

- **CRD serving** (apiextensions-apiserver): `crd_on_create` is the
  naming+establishing controller pair collapsed into admission-time work
  (pkg/controller/{naming,establish} in the staging repo run async; with
  an in-process store the check-and-flip is atomic here instead).
  `resolve_kind` is the dynamic discovery the customresource_handler
  does per-request: a kind is served iff built-in or backed by an
  Established CRD. `crd_delete_cascade` is the
  customresourcecleanup finalizer: purge instances, then the definition.
- **Aggregation** (kube-aggregator): `Aggregator` proxies per
  group/version to registered extension apiservers, with an
  availability probe gating traffic like available_controller.go; local
  APIServices fall through to the primary server.
"""

from __future__ import annotations

import threading
from kubernetes_tpu_torch.analysis import lockcheck
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.extensions import (
    APIService,
    CustomResource,
    CustomResourceDefinition,
    SchemaError,
    validate_custom,
)


class Unavailable(Exception):
    """503 — aggregated backend is not available."""


# ---------------------------------------------------------------------- CRDs


def crd_on_create(store, crd: CustomResourceDefinition,
                  builtin_kinds: Dict[str, Tuple[str, bool]]) -> None:
    """Validate structure, accept/reject names, establish.

    Mirrors apiextensions validation (name == "<plural>.<group>") and the
    NamesAccepted check against every other served resource; a CRD whose
    kind or plural collides is stored with NamesAccepted=False and never
    established (so its kind is NOT served), exactly the reference's
    behavior rather than a hard create-failure.
    """
    expect = f"{crd.names.plural}.{crd.group}"
    if crd.name != expect:
        from kubernetes_tpu_torch.server.apiserver import Invalid
        raise Invalid(
            f"CustomResourceDefinition name must be {expect!r} "
            f"(plural.group), got {crd.name!r}")
    if not crd.group or "." not in crd.group:
        from kubernetes_tpu_torch.server.apiserver import Invalid
        raise Invalid("CRD group must be a DNS-style name with a dot")

    taken_kinds = set(builtin_kinds)
    taken_plurals = {plural for plural, _ in builtin_kinds.values()}
    for other in store.list("CustomResourceDefinition")[0]:
        if other.name == crd.name:
            continue
        taken_kinds.add(other.names.kind)
        taken_plurals.add(other.names.plural)

    if crd.names.kind in taken_kinds or crd.names.plural in taken_plurals:
        crd.set_condition(
            "NamesAccepted", "False", reason="Conflict",
            message=f"kind {crd.names.kind!r} or plural "
                    f"{crd.names.plural!r} is already in use")
        crd.set_condition("Established", "False", reason="NotAccepted")
    else:
        crd.set_condition("NamesAccepted", "True", reason="NoConflicts")
        crd.set_condition("Established", "True", reason="InitialNamesAccepted")


def resolve_crd(store, kind: str,
                for_write: bool = False) -> Optional[CustomResourceDefinition]:
    """Return the Established CRD serving `kind`, if any. A Terminating
    CRD still serves reads (instances drain through the finalizer) but
    refuses writes — the reference's terminating-CRD behavior."""
    for crd in store.list("CustomResourceDefinition")[0]:
        if crd.names.kind == kind and crd.established:
            if for_write and crd.terminating:
                return None
            return crd
    return None


def validate_custom_create(crd: CustomResourceDefinition,
                           obj: Any) -> None:
    """Scope + schema checks for a custom object write (the dynamic
    registry strategy)."""
    from kubernetes_tpu_torch.server.apiserver import Invalid
    ns = getattr(obj, "namespace", "")
    if crd.scope == "Namespaced" and not ns:
        raise Invalid(
            f"{crd.names.kind} is namespaced: metadata.namespace required")
    if crd.scope == "Cluster" and ns:
        raise Invalid(
            f"{crd.names.kind} is cluster-scoped: metadata.namespace "
            f"must be empty")
    if isinstance(obj, CustomResource) or hasattr(obj, "spec"):
        try:
            validate_custom(crd, obj)
        except SchemaError as e:
            raise Invalid(str(e)) from e


def crd_delete_cascade(store, crd: CustomResourceDefinition) -> None:
    """The customresourcecleanup finalizer: mark Terminating (new writes
    of the kind are refused via resolve_crd), purge every instance, then
    drop the definition row."""
    crd.terminating = True
    crd.set_condition("Terminating", "True", reason="InstanceDeletionInProgress")
    store.update("CustomResourceDefinition", crd)
    objs, _ = store.list(crd.names.kind)
    for o in objs:
        store.delete(crd.names.kind, getattr(o, "namespace", ""), o.name)
    store.delete("CustomResourceDefinition", "", crd.name)


# ----------------------------------------------------------------- discovery


def discovery_doc(store, builtin_kinds: Dict[str, Tuple[str, bool]],
                  apiservices: Optional[List[APIService]] = None
                  ) -> Dict[str, Any]:
    """The /apis discovery document: group/version/resource triples for
    built-ins, established CRDs, and aggregated groups — what client-go's
    discovery client consumes to map kinds to endpoints."""
    resources = [
        {"kind": kind, "name": plural, "namespaced": not cluster_scoped,
         "group": "", "version": "v1"}
        for kind, (plural, cluster_scoped) in sorted(builtin_kinds.items())
    ]
    for crd in store.list("CustomResourceDefinition")[0]:
        if not crd.established:
            continue
        resources.append({
            "kind": crd.names.kind, "name": crd.names.plural,
            "namespaced": crd.scope == "Namespaced",
            "group": crd.group, "version": crd.version,
            "shortNames": list(crd.names.short_names)})
    groups: List[Dict[str, Any]] = []
    for svc in (apiservices or []):
        groups.append({"group": svc.group, "version": svc.version,
                       "available": svc.available,
                       "local": svc.local})
    return {"resources": resources, "aggregatedGroups": groups}


# ---------------------------------------------------------------- aggregator


class Aggregator:
    """kube-aggregator: one front door over the primary apiserver plus any
    registered extension apiservers, routed by APIService group/version.

    `register_backend` pairs an APIService object with an in-process
    backend (anything exposing create/get/list/update/delete + healthz —
    i.e. another ApiServer, the sample-apiserver shape). The availability
    probe (`check_availability`) flips APIService.available off a failed
    healthz, and requests to an unavailable backend fail with 503 the way
    the real proxy does after available_controller marks it down.
    """

    def __init__(self, primary, probe_interval: float = 30.0):
        self.primary = primary
        self._backends: Dict[Tuple[str, str], Any] = {}
        self._lock = lockcheck.make_lock("Aggregator._lock")
        self.probe_interval = probe_interval
        self._last_probe = 0.0

    # -- registration ------------------------------------------------------

    def register_backend(self, apiservice: APIService, backend=None) -> None:
        """Create/refresh the APIService row; backend=None means a Local
        APIService (served by the primary)."""
        if backend is not None and apiservice.service is None:
            raise ValueError("remote APIService needs a ServiceReference")
        with self._lock:
            key = (apiservice.group, apiservice.version)
            if backend is not None:
                self._backends[key] = backend
        store = self.primary.store
        existing = [s for s in store.list("APIService")[0]
                    if s.name == apiservice.name]
        if existing:
            apiservice.resource_version = existing[0].resource_version
            store.update("APIService", apiservice)
        else:
            store.create("APIService", apiservice)
        self.check_availability(force=True)

    def remove_backend(self, name: str) -> None:
        store = self.primary.store
        for s in store.list("APIService")[0]:
            if s.name == name:
                with self._lock:
                    self._backends.pop((s.group, s.version), None)
                store.delete("APIService", "", name)
                return

    # -- availability ------------------------------------------------------

    def check_availability(self, force: bool = False) -> None:
        """The available_controller pass: probe each remote backend's
        healthz and persist the condition on its APIService row."""
        now = time.time()
        if not force and now - self._last_probe < self.probe_interval:
            return
        self._last_probe = now
        store = self.primary.store
        for svc in store.list("APIService")[0]:
            if svc.local:
                ok, msg = True, "Local APIServices are always available"
            else:
                with self._lock:
                    backend = self._backends.get((svc.group, svc.version))
                if backend is None:
                    ok, msg = False, "no backend registered"
                else:
                    try:
                        ok = backend.healthz().get("status") == "ok"
                        msg = "all checks passed" if ok \
                            else "healthz reported failure"
                    except Exception as e:  # probe must never throw
                        ok, msg = False, f"healthz probe failed: {e}"
            if svc.available != ok or svc.available_message != msg:
                svc.available = ok
                svc.available_message = msg
                store.update("APIService", svc)

    # -- routing -----------------------------------------------------------

    def _route(self, group: str, version: str):
        """Pick the serving backend for a group/version, honoring
        availability. Unknown group/versions 404 via the primary path."""
        if not group:  # core group is always local
            return self.primary
        store = self.primary.store
        match: Optional[APIService] = None
        for svc in store.list("APIService")[0]:
            if svc.group == group and svc.version == version:
                match = svc
                break
        if match is None or match.local:
            return self.primary
        self.check_availability()
        # re-read: check_availability may have flipped the row
        cur = next((s for s in store.list("APIService")[0]
                    if s.name == match.name), match)
        if not cur.available:
            raise Unavailable(
                f"the server is currently unable to handle the request "
                f"(APIService {cur.name}: {cur.available_message})")
        with self._lock:
            backend = self._backends.get((group, version))
        if backend is None:
            raise Unavailable(f"no backend for APIService {match.name}")
        return backend

    def handle(self, group: str, version: str, verb: str, *args, **kwargs):
        """Generic dispatch: handle("metrics.example.io", "v1", "list",
        "NodeMetrics") → backend.list("NodeMetrics")."""
        backend = self._route(group, version)
        return getattr(backend, verb)(*args, **kwargs)

    def discovery(self) -> Dict[str, Any]:
        self.check_availability()
        apiservices = self.primary.store.list("APIService")[0]
        from kubernetes_tpu_torch.server.apiserver import KIND_INFO
        return discovery_doc(self.primary.store, KIND_INFO, apiservices)
