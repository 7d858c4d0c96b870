"""Dynamic (out-of-process) admission: webhooks + initializers.

Three reference components, all of which move the admission decision OUT of
the apiserver binary — the extensibility story that static plugins can't
give:

- GenericAdmissionWebhook (plugin/pkg/admission/webhook/admission.go): load
  hook configurations from the API (admissionregistration
  ExternalAdmissionHookConfiguration), match rules against the request,
  POST an AdmissionReview to each matching hook, enforce the verdict;
  transport failure falls to the per-hook FailurePolicy (Ignore = allow,
  Fail = reject). The reference's 1.7 webhook is validate-only; this one
  also applies a returned patchedObject when the hook is marked mutating
  (the 1.9 MutatingAdmissionWebhook behavior, asked for by the blueprint).
- ImagePolicyWebhook (plugin/pkg/admission/imagepolicy/admission.go:249
  Admit): for pod writes, POST an ImageReview carrying the pod's images;
  a disallowed verdict rejects with the backend's reason; a backend error
  falls to defaultAllow.
- Initializers (plugin/pkg/admission/initialization/): matching CREATEs get
  the configured pending-initializer list stamped on; the object stays
  invisible to normal LISTs until an initializer controller clears the
  list (the apiserver's uninitialized-object filtering lives in
  server/apiserver.py list()).

The wire POST reuses the repo's one HTTP idiom (http.client against an
in-process ThreadingHTTPServer, the extender seam's shape) so webhook tests
mirror tests/test_extender_http.py.
"""

from __future__ import annotations

import http.client
import json
import urllib.parse
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubernetes_tpu_torch.admission.chain import (
    AdmissionRequest,
    CREATE,
    Rejected,
    UPDATE,
)
from kubernetes_tpu_torch.api import serde
from kubernetes_tpu_torch.api.types import Pod

FAIL = "Fail"
IGNORE = "Ignore"

# comma-joined pending initializer names (metadata.initializers.pending in
# the reference; an annotation here — Pod carries no initializers field)
PENDING_INITIALIZERS_ANNOTATION = "metadata.initializers.pending"


@dataclass
class Rule:
    """admissionregistration RuleWithOperations, reduced: which operations
    on which kinds a hook intercepts ("*" wildcards both)."""

    operations: List[str] = field(default_factory=lambda: ["*"])
    kinds: List[str] = field(default_factory=lambda: ["*"])

    def matches(self, operation: str, kind: str) -> bool:
        ops_ok = "*" in self.operations or operation in self.operations
        kinds_ok = "*" in self.kinds or kind in self.kinds
        return ops_ok and kinds_ok


@dataclass
class WebhookHook:
    """One hook inside a configuration (ExternalAdmissionHook)."""

    name: str = ""
    url: str = ""  # http://host:port/path (clientConfig collapsed to a URL)
    rules: List[Rule] = field(default_factory=list)
    failure_policy: str = IGNORE  # the reference's default (admission.go)
    timeout_s: float = 5.0
    mutating: bool = False  # apply response.patchedObject to the request


@dataclass
class AdmissionHookConfiguration:
    """The API object the plugin watches (cluster-scoped;
    admissionregistration/v1alpha1 ExternalAdmissionHookConfiguration)."""

    name: str
    hooks: List[WebhookHook] = field(default_factory=list)
    namespace: str = ""
    resource_version: int = 0
    deleted: bool = False


@dataclass
class InitializerConfiguration:
    """admissionregistration InitializerConfiguration: names stamped onto
    matching CREATEs, in order."""

    name: str
    initializers: List[str] = field(default_factory=list)
    kinds: List[str] = field(default_factory=lambda: ["*"])
    namespace: str = ""
    resource_version: int = 0
    deleted: bool = False


def _post_json(url: str, payload: dict, timeout_s: float) -> dict:
    """POST JSON, return decoded JSON response; raises on transport errors
    (connection refused, timeout, non-200, bad JSON)."""
    parts = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                      timeout=timeout_s)
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    try:
        body = json.dumps(payload)
        conn.request("POST", path, body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise ConnectionError(f"webhook returned HTTP {resp.status}")
        return json.loads(data)
    finally:
        conn.close()


def _encode_obj(kind: str, obj) -> Optional[dict]:
    if kind == "Pod" and isinstance(obj, Pod):
        return serde.encode_pod(obj)
    if obj is None:
        return None
    # generic fallback: ship the JSON-safe surface of the dataclass so
    # validating hooks can see any kind (mutation stays Pod-only)
    import dataclasses as dc
    if dc.is_dataclass(obj):
        try:
            return json.loads(json.dumps(dc.asdict(obj), default=str))
        except Exception:
            return {"name": getattr(obj, "name", "")}
    return {"name": getattr(obj, "name", "")}


class GenericAdmissionWebhook:
    """The webhook admission plugin (webhook/admission.go
    GenericAdmissionWebhook.Admit): hooks come from constructor config
    and/or AdmissionHookConfiguration objects in the store."""

    def __init__(self, hooks: Optional[List[WebhookHook]] = None):
        self._static_hooks = list(hooks or [])
        self.store = None
        self.calls = 0  # diagnostics

    def set_store(self, store) -> None:
        self.store = store

    def _hooks(self) -> List[WebhookHook]:
        hooks = list(self._static_hooks)
        if self.store is not None:
            try:
                configs, _ = self.store.list("AdmissionHookConfiguration")
            except Exception:
                configs = []
            for cfg in configs:
                hooks.extend(cfg.hooks)
        return hooks

    def handles(self, req: AdmissionRequest) -> bool:
        # matching needs the live hook-config list; doing it here AND in
        # admit() would scan the config registry twice per request —
        # admit() does the single scan and early-returns on no match
        return True

    def admit(self, req: AdmissionRequest) -> None:
        for hook in self._hooks():
            if not any(r.matches(req.operation, req.kind)
                       for r in hook.rules):
                continue
            review = {
                "kind": "AdmissionReview",
                "request": {
                    "operation": req.operation,
                    "kind": req.kind,
                    "namespace": req.namespace,
                    "name": req.name,
                    "object": _encode_obj(req.kind, req.obj),
                    "userInfo": {"username": req.user.name
                                 if req.user else ""},
                },
            }
            try:
                resp = _post_json(hook.url, review, hook.timeout_s)
                self.calls += 1
            except Exception as e:
                if hook.failure_policy == FAIL:
                    raise Rejected(
                        f"admission webhook {hook.name!r} failed: {e}"
                    ) from None
                continue  # Ignore: fail-open (admission.go default)
            result = resp.get("response", resp)
            if not result.get("allowed", False):
                status = result.get("status", {}) or {}
                msg = status.get("message", "") or "denied"
                raise Rejected(
                    f'admission webhook {hook.name!r} denied the request: '
                    f"{msg}")
            patched = result.get("patchedObject")
            if hook.mutating and patched is not None:
                if req.kind == "Pod":
                    self._apply_pod_patch(req.obj, patched)
                # non-Pod mutation unsupported (validate-only, like 1.7)

    # the ONLY fields a mutating hook may change: the mutable spec surface
    # the wire encoding round-trips. Identity (name/namespace/uid) was
    # already authorized + audited and stays the server's; status and
    # fields the encoding doesn't carry (annotations, tolerations,
    # affinity, ownerRef, phase) must not be wiped by the round-trip.
    _POD_MUTABLE = ("labels", "containers", "volumes", "node_selector",
                    "scheduler_name")

    def _apply_pod_patch(self, obj: Pod, patched: dict) -> None:
        orig = serde.encode_pod(obj)
        if patched == orig:
            return
        new = serde.decode_pod(patched)
        for f in self._POD_MUTABLE:
            setattr(obj, f, getattr(new, f))


class ImagePolicyWebhook:
    """plugin/pkg/admission/imagepolicy/admission.go: Admit (:249) builds
    an ImageReview from the pod's containers and asks the backend; a
    disallowed verdict rejects; backend failure falls to default_allow
    (the config's defaultAllow knob)."""

    def __init__(self, url: str, default_allow: bool = True,
                 timeout_s: float = 5.0):
        self.url = url
        self.default_allow = default_allow
        self.timeout_s = timeout_s

    def set_store(self, store) -> None:
        pass

    def handles(self, req: AdmissionRequest) -> bool:
        return req.kind == "Pod" and req.operation in (CREATE, UPDATE)

    def admit(self, req: AdmissionRequest) -> None:
        pod = req.obj
        review = {
            "kind": "ImageReview",
            "spec": {
                "containers": [{"image": c.image}
                               for c in getattr(pod, "containers", [])],
                "namespace": req.namespace,
                "annotations": dict(getattr(pod, "annotations", {})),
            },
        }
        try:
            resp = _post_json(self.url, review, self.timeout_s)
        except Exception as e:
            if not self.default_allow:
                raise Rejected(
                    f"image policy webhook backend failed: {e}") from None
            return
        status = resp.get("status", {})
        if not status.get("allowed", False):
            reason = status.get("reason", "") or "image policy denied"
            raise Rejected(f"pod rejected by image policy: {reason}")


class Initializers:
    """plugin/pkg/admission/initialization: stamp the configured pending
    initializers onto matching CREATEs. The object then stays hidden from
    LISTs (server/apiserver.py) until a controller clears the list via
    remove_initializer()."""

    def __init__(self, configs: Optional[List[InitializerConfiguration]]
                 = None):
        self._static = list(configs or [])
        self.store = None

    def set_store(self, store) -> None:
        self.store = store

    def _configs(self) -> List[InitializerConfiguration]:
        out = list(self._static)
        if self.store is not None:
            try:
                objs, _ = self.store.list("InitializerConfiguration")
            except Exception:
                objs = []
            out.extend(objs)
        return out

    def handles(self, req: AdmissionRequest) -> bool:
        # single config scan lives in admit() (see GenericAdmissionWebhook)
        return req.operation == CREATE

    def admit(self, req: AdmissionRequest) -> None:
        names: List[str] = []
        for c in self._configs():
            if "*" in c.kinds or req.kind in c.kinds:
                names.extend(n for n in c.initializers if n not in names)
        if not names:
            return
        ann = getattr(req.obj, "annotations", None)
        if ann is None:
            return
        ann[PENDING_INITIALIZERS_ANNOTATION] = ",".join(names)


def is_uninitialized(obj) -> bool:
    ann = getattr(obj, "annotations", None)
    return bool(ann) and bool(ann.get(PENDING_INITIALIZERS_ANNOTATION))


def remove_initializer(store, kind: str, obj, initializer: str) -> None:
    """An initializer controller's completion write: drop `initializer`
    from the pending list (first-in-order semantics; the object becomes
    visible when the list empties). CAS through the store like any
    controller write."""
    import dataclasses
    ann = dict(obj.annotations)
    pending = [n for n in
               ann.get(PENDING_INITIALIZERS_ANNOTATION, "").split(",")
               if n and n != initializer]
    if pending:
        ann[PENDING_INITIALIZERS_ANNOTATION] = ",".join(pending)
    else:
        ann.pop(PENDING_INITIALIZERS_ANNOTATION, None)
    store.update(kind, dataclasses.replace(obj, annotations=ann),
                 expect_rv=obj.resource_version)
