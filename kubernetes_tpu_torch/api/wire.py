"""Generic wire codec: any API dataclass <-> JSON-able dict with a `kind`.

The reference's wire format is the versioned k8s API (JSON/protobuf via
runtime.Scheme + generated conversions — staging/src/k8s.io/apimachinery/pkg/
runtime). Here the object model is plain dataclasses, so the scheme is
reflection: dataclass fields encode under their own names, nested dataclasses
/ enums / lists / dicts recurse, and a `kind` discriminator selects the
constructor on decode. Pod/Node additionally accept the upstream k8s
manifest shape (metadata/spec/status) through api/serde.py — `decode_any`
sniffs which of the two encodings it was handed, so `ktctl create -f` takes
real kubectl manifests for the core kinds.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Dict, Optional, Type

from kubernetes_tpu_torch.api import cluster as cluster_mod
from kubernetes_tpu_torch.api import rbac as rbac_mod
from kubernetes_tpu_torch.api import types as core
from kubernetes_tpu_torch.api import workloads as wl
from kubernetes_tpu_torch.api.serde import decode_node, decode_pod

KIND_REGISTRY: Dict[str, Type] = {
    "Pod": core.Pod,
    "Node": core.Node,
    "PersistentVolume": core.PersistentVolume,
    "PersistentVolumeClaim": core.PersistentVolumeClaim,
    "Binding": core.Binding,
    "Event": core.Event,
    "ReplicaSet": wl.ReplicaSet,
    "ReplicationController": wl.ReplicationController,
    "Deployment": wl.Deployment,
    "Job": wl.Job,
    "CronJob": getattr(wl, "CronJob", None),
    "DaemonSet": wl.DaemonSet,
    "StatefulSet": wl.StatefulSet,
    "Namespace": wl.Namespace,
    "Service": wl.Service,
    "Endpoints": wl.Endpoints,
    "PriorityClass": wl.PriorityClass,
    "ResourceQuota": cluster_mod.ResourceQuota,
    "LimitRange": cluster_mod.LimitRange,
    "ServiceAccount": cluster_mod.ServiceAccount,
    "Secret": cluster_mod.Secret,
    "ConfigMap": cluster_mod.ConfigMap,
    "PodDisruptionBudget": cluster_mod.PodDisruptionBudget,
    "CertificateSigningRequest": cluster_mod.CertificateSigningRequest,
    "StorageClass": cluster_mod.StorageClass,
    "HorizontalPodAutoscaler": wl.HorizontalPodAutoscaler,
    "Role": rbac_mod.Role,
    "ClusterRole": rbac_mod.ClusterRole,
    "RoleBinding": rbac_mod.RoleBinding,
    "ClusterRoleBinding": rbac_mod.ClusterRoleBinding,
}


def _psp_type():
    from kubernetes_tpu_torch.security.psp import PodSecurityPolicy
    return PodSecurityPolicy


def _ext_types():
    from kubernetes_tpu_torch.api import extensions as ext
    return ext


KIND_REGISTRY["PodSecurityPolicy"] = _psp_type()
KIND_REGISTRY["CustomResourceDefinition"] = \
    _ext_types().CustomResourceDefinition
KIND_REGISTRY["APIService"] = _ext_types().APIService
KIND_REGISTRY = {k: v for k, v in KIND_REGISTRY.items() if v is not None}


def register_kind(kind: str, cls: Type) -> None:
    """Extension point (the CRD path registers decoded shapes here)."""
    KIND_REGISTRY[kind] = cls


def encode(obj: Any, kind: Optional[str] = None) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {f.name: encode(getattr(obj, f.name))
               for f in dataclasses.fields(obj)}
        if kind:
            out["kind"] = kind
        return out
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode(v) for v in obj]
    return obj


def _decode_value(val: Any, tp: Any) -> Any:
    origin = getattr(tp, "__origin__", None)
    if val is None:
        return None
    if origin is list:
        (item_tp,) = tp.__args__
        return [_decode_value(v, item_tp) for v in val]
    if origin is tuple:
        args = tp.__args__
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_decode_value(v, args[0]) for v in val)
        return tuple(_decode_value(v, t) for v, t in zip(val, args))
    if origin is dict:
        _, v_tp = tp.__args__
        return {k: _decode_value(v, v_tp) for k, v in val.items()}
    if origin is not None and str(origin) in ("typing.Union",) or \
            str(tp).startswith("typing.Optional"):
        for arg in tp.__args__:
            if arg is type(None):
                continue
            try:
                return _decode_value(val, arg)
            except (TypeError, ValueError, KeyError):
                continue
        return val
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return tp(val)
    if dataclasses.is_dataclass(tp):
        return decode_dataclass(val, tp)
    return val


def _resolve_hints(cls: Type) -> Dict[str, Any]:
    import typing

    mod = vars(__import__(cls.__module__, fromlist=["_"]))
    return typing.get_type_hints(cls, globalns=mod)


def decode_dataclass(data: Dict[str, Any], cls: Type) -> Any:
    hints = _resolve_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _decode_value(data[f.name], hints.get(f.name))
    return cls(**kwargs)


def decode_any(data: Dict[str, Any], kind: Optional[str] = None) -> Any:
    """Decode a wire dict. Accepts both the native encoding and (for
    Pod/Node) upstream k8s manifests — sniffed by the metadata/spec shape."""
    kind = kind or data.get("kind", "")
    if not kind:
        raise ValueError("object has no kind")
    if "metadata" in data and kind == "Pod":
        return decode_pod(data)
    if "metadata" in data and kind == "Node":
        return decode_node(data)
    if "metadata" in data and kind == "CustomResourceDefinition":
        return decode_crd_manifest(data)
    cls = KIND_REGISTRY.get(kind)
    if cls is None:
        # custom (CRD-defined) kind: decode into the schemaless
        # CustomResource shape — both the native flat encoding and the
        # upstream metadata/spec manifest shape are accepted
        from kubernetes_tpu_torch.api.extensions import CustomResource
        if "metadata" in data:
            meta = data.get("metadata", {})
            return CustomResource(
                kind=kind, name=meta.get("name", ""),
                namespace=meta.get("namespace", ""),
                api_version=data.get("apiVersion", ""),
                labels=dict(meta.get("labels", {})),
                spec=dict(data.get("spec", {})),
                status=dict(data.get("status", {})))
        body = {k: v for k, v in data.items()
                if k not in ("kind", "apiVersion")}
        return decode_dataclass({"kind": kind, **body}, CustomResource)
    data = {k: v for k, v in data.items() if k not in ("kind", "apiVersion")}
    return decode_dataclass(data, cls)


def decode_crd_manifest(data: Dict[str, Any]) -> Any:
    """Decode an upstream apiextensions.k8s.io CRD manifest
    (metadata/spec shape, incl. the v1.7-era
    spec.validation.openAPIV3Schema) into the native
    CustomResourceDefinition."""
    from kubernetes_tpu_torch.api.extensions import CRDNames, \
        CustomResourceDefinition
    meta, spec = data.get("metadata", {}), data.get("spec", {})
    names = spec.get("names", {})
    validation: Dict[str, Any] = {}
    schema = (spec.get("validation", {}) or {}).get("openAPIV3Schema", {})
    spec_schema = (schema.get("properties", {}) or {}).get("spec", {})
    if spec_schema:
        validation = dict(spec_schema.get("properties", {}) or {})
        if spec_schema.get("required"):
            validation["required"] = list(spec_schema["required"])
    return CustomResourceDefinition(
        name=meta.get("name", ""),
        group=spec.get("group", ""),
        version=spec.get("version", ""),
        names=CRDNames(
            plural=names.get("plural", ""),
            kind=names.get("kind", ""),
            singular=names.get("singular", ""),
            short_names=list(names.get("shortNames", []))),
        scope=spec.get("scope", "Namespaced"),
        validation=validation)


def dumps(obj: Any, kind: str) -> str:
    return json.dumps(encode(obj, kind=kind))


def loads(text: str) -> Any:
    return decode_any(json.loads(text))
