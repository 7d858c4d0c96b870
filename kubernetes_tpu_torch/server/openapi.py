"""OpenAPI (swagger) spec serving.

The reference apiserver serves a generated OpenAPI v2 document at
/swagger.json and /openapi/v2
(staging/src/k8s.io/apiserver/pkg/server/routes/openapi.go, spec built by
the openapi-gen toolchain from type comments). Here the spec is derived
REFLECTIVELY from the same registries the serving path uses — KIND_INFO
(kind -> plural/scope) and the wire dataclass registry — so the document
can never drift from what the server actually serves: every definition's
properties come from the live dataclass fields, every path from the live
routing table, and Established CRDs appear the moment they serve.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict

VERSION_INFO = {"title": "kubernetes-tpu", "version": "v1.7-tpu"}


def _schema_for_type(tp: Any, depth: int = 0) -> Dict[str, Any]:
    origin = typing.get_origin(tp)
    if origin in (list, typing.List, tuple, typing.Tuple):
        args = typing.get_args(tp)
        item = _schema_for_type(args[0], depth) if args \
            else {"type": "object"}
        return {"type": "array", "items": item}
    if origin in (dict, typing.Dict):
        return {"type": "object", "additionalProperties": True}
    if origin is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return _schema_for_type(args[0], depth) if args \
            else {"type": "object"}
    if tp is int:
        return {"type": "integer", "format": "int64"}
    if tp is float:
        return {"type": "number", "format": "double"}
    if tp is bool:
        return {"type": "boolean"}
    if tp is str:
        return {"type": "string"}
    if isinstance(tp, type) and dataclasses.is_dataclass(tp):
        # nested dataclasses inline their fields (no $ref plumbing at
        # this scale; the reference $refs via gen) — depth-capped so a
        # future recursive type cannot blow the document up
        if depth >= 4:
            return {"type": "object"}
        return _definition_for(tp, depth + 1)
    if isinstance(tp, type) and issubclass(tp, str):  # str enums
        return {"type": "string"}
    return {"type": "object"}


def _definition_for(cls: type, depth: int = 0) -> Dict[str, Any]:
    props: Dict[str, Any] = {}
    try:
        hints = typing.get_type_hints(cls)
    except Exception:
        hints = {f.name: f.type for f in dataclasses.fields(cls)}
    for f in dataclasses.fields(cls):
        props[f.name] = _schema_for_type(hints.get(f.name, str), depth)
    return {"type": "object", "properties": props}


def _paths_for(kind: str, plural: str, cluster_scoped: bool,
               definition_ref: str) -> Dict[str, Any]:
    base = f"/api/v1/{plural}" if cluster_scoped \
        else f"/api/v1/namespaces/{{namespace}}/{plural}"
    ref = {"$ref": definition_ref}
    ok = {"200": {"description": "OK", "schema": ref}}
    list_ok = {"200": {"description": "OK",
                       "schema": {"type": "array", "items": ref}}}
    return {
        base: {
            "get": {"operationId": f"list{kind}", "responses": list_ok},
            "post": {"operationId": f"create{kind}", "responses": ok},
        },
        base + "/{name}": {
            "get": {"operationId": f"read{kind}", "responses": ok},
            "put": {"operationId": f"replace{kind}", "responses": ok},
            "delete": {"operationId": f"delete{kind}",
                       "responses": {"200": {"description": "OK"}}},
        },
    }


def build_spec(store=None) -> Dict[str, Any]:
    """The OpenAPI v2 document for everything currently served: built-in
    kinds from KIND_INFO/wire registry, plus Established CRDs when a
    store is given (the apiextensions openapi contribution)."""
    from kubernetes_tpu_torch.api.wire import KIND_REGISTRY
    from kubernetes_tpu_torch.server.apiserver import KIND_INFO

    definitions: Dict[str, Any] = {}
    paths: Dict[str, Any] = {}
    for kind, (plural, cluster_scoped) in sorted(KIND_INFO.items()):
        cls = KIND_REGISTRY.get(kind)
        definitions[kind] = _definition_for(cls) if cls is not None \
            and dataclasses.is_dataclass(cls) else {"type": "object"}
        paths.update(_paths_for(kind, plural, cluster_scoped,
                                f"#/definitions/{kind}"))
    if store is not None:
        try:
            crds, _ = store.list("CustomResourceDefinition")
        except Exception:
            crds = []
        for crd in crds:
            kind = crd.names.kind
            if not kind or kind in definitions:
                continue
            definitions[kind] = {"type": "object", "properties": {
                "spec": {"type": "object",
                         "properties": dict(crd.validation or {})}}}
            plural = crd.names.plural
            group, version = crd.group, crd.version
            base = (f"/apis/{group}/{version}/namespaces/{{namespace}}/"
                    f"{plural}") if crd.scope == "Namespaced" \
                else f"/apis/{group}/{version}/{plural}"
            ref = {"$ref": f"#/definitions/{kind}"}
            ok = {"200": {"description": "OK", "schema": ref}}
            paths[base] = {
                "get": {"operationId": f"list{kind}", "responses": ok},
                "post": {"operationId": f"create{kind}", "responses": ok}}
            paths[base + "/{name}"] = {
                "get": {"operationId": f"read{kind}", "responses": ok},
                "put": {"operationId": f"replace{kind}", "responses": ok},
                "delete": {"operationId": f"delete{kind}",
                           "responses": {"200": {"description": "OK"}}}}
    return {
        "swagger": "2.0",
        "info": dict(VERSION_INFO),
        "paths": paths,
        "definitions": definitions,
    }
