"""HTTP client with the ApiServer method surface — what client-go's
RESTClient is to the reference (staging/src/k8s.io/client-go/rest): verbs
over the REST layout served by server/rest_http.py, so Ktctl and the
controllers can run out-of-process."""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Optional, Tuple

from kubernetes_tpu_torch.api import wire
from kubernetes_tpu_torch.api.cluster import Eviction
from kubernetes_tpu_torch.api.types import Binding
from kubernetes_tpu_torch.server.apiserver import KIND_INFO
from kubernetes_tpu_torch.server.apiserver_lite import Conflict, NotFound, WatchEvent


class HttpError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code


class RestClient:
    def __init__(self, base: str, token: str = ""):
        self.base = base.rstrip("/")
        self.token = token
        self._discovery_cache = None

    # ------------------------------------------------------------ plumbing

    def discovery(self) -> dict:
        """GET /apis — the discovery document (built-ins + CRDs +
        aggregated groups); cached per client like client-go's
        CachedDiscoveryClient."""
        if self._discovery_cache is None:
            self._discovery_cache = self._do("GET", self.base + "/apis")
        return self._discovery_cache

    def openapi(self) -> dict:
        """GET /openapi/v2 — the server-published OpenAPI document
        (ktctl explain's remote source)."""
        return self._do("GET", self.base + "/openapi/v2")

    def _url(self, kind: str, namespace: str, name: str = "",
             sub: str = "") -> str:
        if kind in KIND_INFO:
            resource, cluster = KIND_INFO[kind]
            path = "/api/v1"
        else:
            # CRD-defined kind: route through the group path
            # /apis/{group}/{version}/... per the discovery doc
            row = next((r for r in self.discovery()["resources"]
                        if r["kind"] == kind and r.get("group")), None)
            if row is None:
                raise NotFound(f"unknown kind {kind!r}")
            resource, cluster = row["name"], not row["namespaced"]
            path = f"/apis/{row['group']}/{row['version']}"
        if namespace and not cluster:
            path += f"/namespaces/{namespace}"
        path += f"/{resource}"
        if name:
            path += f"/{name}"
        if sub:
            path += f"/{sub}"
        return self.base + path

    def _do(self, method: str, url: str, body: Optional[dict] = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        if self.token:
            req.add_header("Authorization", "Bearer " + self.token)
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            payload = json.loads(e.read() or b"{}")
            msg = payload.get("message", str(e))
            if e.code == 404:
                raise NotFound(msg) from None
            if e.code == 409:
                raise Conflict(msg) from None
            raise HttpError(e.code, msg) from None

    # --------------------------------------------------------------- verbs

    def get(self, kind: str, namespace: str, name: str) -> Any:
        return wire.decode_any(
            self._do("GET", self._url(kind, namespace, name)), kind=kind)

    def list(self, kind: str, field_selector: str = "",
             namespace: str = "") -> Tuple[list, int]:
        url = self._url(kind, namespace)
        if field_selector:
            from urllib.parse import quote
            url += "?fieldSelector=" + quote(field_selector)
        out = self._do("GET", url)
        objs = [wire.decode_any(item, kind=kind) for item in out["items"]]
        return objs, out.get("resourceVersion", 0)

    def create(self, kind: str, obj: Any) -> int:
        ns = getattr(obj, "namespace", "")
        out = self._do("POST", self._url(kind, ns),
                       wire.encode(obj, kind=kind))
        if kind == "CustomResourceDefinition":
            # the served-resource set changed; re-discover on next use
            self._discovery_cache = None
        return out.get("resourceVersion", 0)

    def update(self, kind: str, obj: Any,
               expect_rv: Optional[int] = None) -> int:
        ns = getattr(obj, "namespace", "")
        url = self._url(kind, ns, obj.name)
        if expect_rv is not None:
            url += f"?resourceVersion={expect_rv}"  # CAS precondition
        out = self._do("PUT", url, wire.encode(obj, kind=kind))
        if kind == "CustomResourceDefinition":
            self._discovery_cache = None
        return out.get("resourceVersion", 0)

    def update_status(self, kind: str, obj: Any) -> int:
        ns = getattr(obj, "namespace", "")
        out = self._do("PUT", self._url(kind, ns, obj.name, sub="status"),
                       wire.encode(obj, kind=kind))
        return out.get("resourceVersion", 0)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._do("DELETE", self._url(kind, namespace, name))
        if kind == "CustomResourceDefinition":
            self._discovery_cache = None

    def bind(self, binding: Binding) -> int:
        out = self._do("POST",
                       self._url("Pod", binding.pod_namespace,
                                 binding.pod_name, sub="binding"),
                       {"pod_name": binding.pod_name,
                        "pod_uid": binding.pod_uid,
                        "node_name": binding.node_name})
        return out.get("resourceVersion", 0)

    def evict(self, ev: Eviction) -> None:
        self._do("POST", self._url("Pod", ev.namespace, ev.pod_name,
                                   sub="eviction"), {})

    def scale(self, kind: str, namespace: str, name: str,
              replicas: Optional[int] = None) -> int:
        url = self._url(kind, namespace, name, sub="scale")
        if replicas is None:
            return self._do("GET", url)["replicas"]
        return self._do("PUT", url, {"replicas": replicas})["replicas"]

    def watch_since(self, kinds, from_rv: int, timeout=None):
        res = []
        for k in kinds:
            if k in KIND_INFO:
                res.append(KIND_INFO[k][0])
                continue
            # CRD-defined kind: resolve through discovery; dropping it
            # silently would make the server fall back to ALL kinds
            row = next((r for r in self.discovery()["resources"]
                        if r["kind"] == k), None)
            if row is None:
                raise NotFound(f"unknown kind {k!r}")
            res.append(row["name"])
        q = "&".join(["resourceVersion=" + str(from_rv)]
                     + [f"resource={r}" for r in res]
                     + ([f"timeout={timeout}"] if timeout else []))
        out = self._do("GET", self.base + "/api/v1/watch?" + q)
        return [WatchEvent(e["type"], e["kind"],
                           wire.decode_any(e["object"], kind=e["kind"]),
                           e["rv"]) for e in out]

    def healthz(self) -> dict:
        return self._do("GET", self.base + "/healthz")

    def version(self) -> dict:
        return self._do("GET", self.base + "/version")
