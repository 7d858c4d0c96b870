"""REST facade: the apiserver handler chain over HTTP.

Maps the reference's REST layout (staging/src/k8s.io/apiserver/pkg/endpoints
installer) onto the in-process ApiServer:

  GET    /healthz /configz /metrics /api /apis /version
  GET    /api/v1/{resource}                       (cluster list)
  GET    /api/v1/namespaces/{ns}/{resource}       (namespaced list)
  GET    /api/v1/namespaces/{ns}/{resource}/{name}
  POST   /api/v1/namespaces/{ns}/{resource}       (create; body = JSON obj)
  PUT    /api/v1/namespaces/{ns}/{resource}/{name}
  DELETE /api/v1/namespaces/{ns}/{resource}/{name}
  POST   .../pods/{name}/binding | /eviction
  PUT    .../pods/{name}/status
  GET/PUT .../{resource}/{name}/scale
  GET    /api/v1/watch?resourceVersion=N[&timeout=s]   (JSON-lines batch)

Bearer tokens ride the Authorization header; the native wire codec
(api/wire.py) carries objects, and `kind` is inferred from the resource
path. Long-running watch streams use chunked JSON lines like the reference's
watch framing (apimachinery/pkg/watch + streaming serializer)."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from kubernetes_tpu_torch.api import wire
from kubernetes_tpu_torch.api.cluster import Eviction
from kubernetes_tpu_torch.api.types import Binding
from kubernetes_tpu_torch.auth.authn import Credential, Unauthenticated
from kubernetes_tpu_torch.auth.authz import Forbidden
from kubernetes_tpu_torch.admission import Rejected
from kubernetes_tpu_torch.server.apiserver import (
    ApiServer,
    Invalid,
    KIND_INFO,
    TooManyRequests,
)
from kubernetes_tpu_torch.server.apiserver_lite import Conflict, NotFound

RESOURCE_TO_KIND = {res: kind for kind, (res, _) in KIND_INFO.items()}
VERSION = {"major": "1", "minor": "7+tpu", "gitVersion": "v1.7.0-tpu.0"}


class RestServer:
    def __init__(self, api: ApiServer, host: str = "127.0.0.1",
                 port: int = 0, metrics_text=None):
        self.api = api
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _cred(self) -> Optional[Credential]:
                auth = self.headers.get("Authorization", "")
                if auth.startswith("Bearer "):
                    return Credential(token=auth[len("Bearer "):])
                return None

            def _send(self, code: int, payload) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self):
                n = int(self.headers.get("Content-Length", 0) or 0)
                return json.loads(self.rfile.read(n) or b"{}")

            def _dispatch(self, method: str) -> None:
                try:
                    self._route(method)
                except NotFound as e:
                    self._send(404, {"kind": "Status", "code": 404,
                                     "message": str(e)})
                except Conflict as e:
                    self._send(409, {"kind": "Status", "code": 409,
                                     "message": str(e)})
                except (Forbidden, Rejected) as e:
                    self._send(403, {"kind": "Status", "code": 403,
                                     "message": str(e)})
                except Unauthenticated as e:
                    self._send(401, {"kind": "Status", "code": 401,
                                     "message": str(e)})
                except TooManyRequests as e:
                    self._send(429, {"kind": "Status", "code": 429,
                                     "message": str(e)})
                except Invalid as e:
                    self._send(422, {"kind": "Status", "code": 422,
                                     "message": str(e)})
                except ValueError as e:
                    self._send(400, {"kind": "Status", "code": 400,
                                     "message": str(e)})
                except Exception as e:  # panic recovery filter
                    self._send(500, {"kind": "Status", "code": 500,
                                     "message": f"{type(e).__name__}: {e}"})

            # --------------------------------------------------- routing

            def _route(self, method: str) -> None:
                url = urlparse(self.path)
                q = parse_qs(url.query)
                parts = [p for p in url.path.split("/") if p]
                cred = self._cred()
                api = outer.api
                if url.path == "/healthz":
                    return self._send(200, api.healthz())
                if url.path == "/configz":
                    return self._send(200, api.configz())
                if url.path == "/version":
                    return self._send(200, VERSION)
                if url.path in ("/openapi/v2", "/swagger.json"):
                    # routes/openapi.go: the generated spec, served at
                    # both the modern and the 1.7 swagger paths
                    from kubernetes_tpu_torch.server.openapi import build_spec
                    return self._send(200, build_spec(api.store))
                if url.path == "/metrics":
                    text = outer.metrics_text() if outer.metrics_text else ""
                    body = text.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if url.path == "/api":
                    return self._send(200, {"versions": ["v1"]})
                if url.path == "/apis":
                    # discovery document: built-ins + Established CRDs +
                    # aggregated groups (kube-aggregator /apis root)
                    return self._send(200, api.discovery())
                if url.path == "/api/v1" and method == "GET":
                    return self._send(200, {
                        "resources": sorted(RESOURCE_TO_KIND)})
                if parts[:2] == ["api", "v1"] and len(parts) >= 3 \
                        and parts[2] == "watch":
                    from_rv = int(q.get("resourceVersion", ["0"])[0])
                    timeout = float(q.get("timeout", ["0"])[0])
                    def _watch_kind(res):
                        if res in RESOURCE_TO_KIND:
                            return RESOURCE_TO_KIND[res]
                        for crd in api.store.list(
                                "CustomResourceDefinition")[0]:
                            if crd.names.plural == res and crd.established:
                                return crd.names.kind
                        return None
                    kinds = tuple(
                        k for k in (_watch_kind(r)
                                    for r in q.get("resource", []))
                        if k is not None) \
                        or tuple(RESOURCE_TO_KIND.values())
                    evs = api.watch_since(kinds, from_rv, timeout=timeout,
                                          cred=cred)
                    return self._send(200, [
                        {"type": e.type, "kind": e.kind, "rv": e.rv,
                         "object": wire.encode(e.obj, kind=e.kind)}
                        for e in evs])
                if parts[:2] == ["api", "v1"]:
                    rest = parts[2:]
                    resolve = RESOURCE_TO_KIND.get
                elif parts[0] == "apis" and len(parts) >= 4:
                    # /apis/{group}/{version}/[namespaces/{ns}/]{plural}/...
                    # — the CRD serving path (apiextensions
                    # customresource_handler.go route shape)
                    group, version = parts[1], parts[2]
                    rest = parts[3:]

                    def resolve(res, _g=group, _v=version):
                        for crd in api.store.list(
                                "CustomResourceDefinition")[0]:
                            if crd.names.plural == res and crd.group == _g \
                                    and crd.version == _v \
                                    and crd.established:
                                return crd.names.kind
                        return None
                else:
                    raise NotFound(self.path)
                ns = ""
                if rest and rest[0] == "namespaces" and len(rest) >= 3:
                    # /namespaces/{ns}/{resource}/...; a bare
                    # /namespaces/{name} falls through and addresses the
                    # Namespace object itself
                    ns, rest = rest[1], rest[2:]
                if not rest:
                    raise NotFound(self.path)
                resource = rest[0]
                kind = resolve(resource)
                if kind is None:
                    raise NotFound(f"unknown resource {resource!r}")
                name = rest[1] if len(rest) > 1 else ""
                sub = rest[2] if len(rest) > 2 else ""

                if sub == "binding" and method == "POST":
                    b = self._body()
                    rv = api.bind(Binding(
                        b.get("pod_name", name), ns or "default",
                        b.get("pod_uid", ""), b["node_name"]), cred=cred)
                    return self._send(201, {"resourceVersion": rv})
                if sub == "eviction" and method == "POST":
                    api.evict(Eviction(name, ns or "default"), cred=cred)
                    return self._send(201, {"status": "evicted"})
                if sub == "status" and method == "PUT":
                    obj = wire.decode_any(self._body(), kind=kind)
                    rv = api.update_status(kind, obj, cred=cred)
                    return self._send(200, {"resourceVersion": rv})
                if sub == "scale":
                    if method == "GET":
                        return self._send(200, {
                            "replicas": api.scale(kind, ns, name, cred=cred)})
                    if method == "PUT":
                        reps = int(self._body().get("replicas", 0))
                        api.scale(kind, ns, name, replicas=reps, cred=cred)
                        return self._send(200, {"replicas": reps})
                if sub:
                    # unknown subresource, or a known one with the wrong
                    # method — never fall through to the plain-object verbs
                    # (DELETE .../eviction must not bypass PDB enforcement)
                    raise NotFound(f"{method} {self.path}")
                if method == "GET" and name:
                    obj = api.get(kind, ns, name, cred=cred)
                    return self._send(200, wire.encode(obj, kind=kind))
                if method == "GET":
                    objs, rv = api.list(
                        kind, cred=cred, namespace=ns,
                        field_selector=q.get("fieldSelector", [""])[0])
                    sel = q.get("labelSelector", [""])[0]
                    if sel:
                        want = dict(kv.split("=", 1)
                                    for kv in sel.split(",") if "=" in kv)
                        objs = [o for o in objs
                                if all(getattr(o, "labels", {}).get(k) == v
                                       for k, v in want.items())]
                    return self._send(200, {
                        "kind": kind + "List", "resourceVersion": rv,
                        "items": [wire.encode(o, kind=kind) for o in objs]})
                if method == "POST":
                    obj = wire.decode_any(self._body(), kind=kind)
                    if ns and hasattr(obj, "namespace"):
                        obj.namespace = ns
                    rv = api.create(kind, obj, cred=cred)
                    return self._send(201, {"resourceVersion": rv})
                if method == "PUT" and name:
                    obj = wire.decode_any(self._body(), kind=kind)
                    expect = q.get("resourceVersion", [None])[0]
                    rv = api.update(kind, obj, cred=cred,
                                    expect_rv=int(expect) if expect else None)
                    return self._send(200, {"resourceVersion": rv})
                if method == "DELETE" and name:
                    api.delete(kind, ns, name, cred=cred)
                    return self._send(200, {"status": "deleted"})
                raise NotFound(self.path)

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_DELETE(self):
                self._dispatch("DELETE")

        self.metrics_text = metrics_text
        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
