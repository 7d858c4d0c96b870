"""Field selectors — apimachinery/pkg/fields.

The reference's second selection axis next to labels: `kubectl get pods
--field-selector spec.nodeName=n1,status.phase!=Running` and the
kubelet's pod source LIST (spec.nodeName=<node>, pkg/kubelet/config/
apiserver.go NewSourceApiserver). Selection strings parse to =/==/!=
requirements ANDed together (fields/selector.go ParseSelector); each
kind exposes its selectable field set through a conversion much like
the registry strategies' GetAttrs (pkg/registry/core/pod/strategy.go
PodToSelectableFields: metadata.name, metadata.namespace, spec.nodeName,
spec.schedulerName, spec.restartPolicy, status.phase).

Unknown field keys are an error, like the reference's
field-label conversion failing on unsupported selectors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple


class FieldSelectorError(Exception):
    pass


@dataclass(frozen=True)
class FieldSelector:
    # (key, op, value) with op in {"=", "!="}
    requirements: Tuple[Tuple[str, str, str], ...] = ()

    def matches(self, fields: Dict[str, str]) -> bool:
        for key, op, value in self.requirements:
            if key not in fields:
                raise FieldSelectorError(
                    f'field label not supported: "{key}"')
            if op == "=" and fields[key] != value:
                return False
            if op == "!=" and fields[key] == value:
                return False
        return True

    @property
    def empty(self) -> bool:
        return not self.requirements


EVERYTHING = FieldSelector()


def parse_field_selector(text: str) -> FieldSelector:
    """fields/selector.go ParseSelector: comma-separated k=v / k==v /
    k!=v terms; empty string selects everything."""
    reqs: List[Tuple[str, str, str]] = []
    for raw in filter(None, (t.strip() for t in (text or "").split(","))):
        if "!=" in raw:
            key, _, value = raw.partition("!=")
            op = "!="
        elif "==" in raw:
            key, _, value = raw.partition("==")
            op = "="
        elif "=" in raw:
            key, _, value = raw.partition("=")
            op = "="
        else:
            raise FieldSelectorError(
                f"invalid field selector term {raw!r}")
        key, value = key.strip(), value.strip()
        if not key:
            raise FieldSelectorError(
                f"invalid field selector term {raw!r}")
        reqs.append((key, op, value))
    return FieldSelector(tuple(reqs))


# -------------------------------------------------- per-kind field sets


def _meta_fields(obj: Any) -> Dict[str, str]:
    return {"metadata.name": getattr(obj, "name", ""),
            "metadata.namespace": getattr(obj, "namespace", "")}


def pod_fields(pod: Any) -> Dict[str, str]:
    """pod/strategy.go PodToSelectableFields."""
    out = _meta_fields(pod)
    out["spec.nodeName"] = pod.node_name or ""
    out["spec.schedulerName"] = getattr(pod, "scheduler_name", "") or ""
    out["spec.restartPolicy"] = getattr(pod, "restart_policy", "") or ""
    out["status.phase"] = getattr(pod, "phase", "") or ""
    return out


def node_fields(node: Any) -> Dict[str, str]:
    """node/strategy.go NodeToSelectableFields (+ spec.unschedulable)."""
    out = _meta_fields(node)
    out["spec.unschedulable"] = \
        "true" if getattr(node, "unschedulable", False) else "false"
    return out


def event_fields(ev: Any) -> Dict[str, str]:
    """event strategy GetAttrs: involvedObject + reason + type."""
    out = _meta_fields(ev)
    out["involvedObject.name"] = getattr(ev, "object_key", "") or ""
    out["reason"] = getattr(ev, "reason", "") or ""
    out["type"] = getattr(ev, "type", "") or ""
    return out


_FIELD_FUNCS = {
    "Pod": pod_fields,
    "Node": node_fields,
    "Event": event_fields,
}

_META_KEYS = frozenset({"metadata.name", "metadata.namespace"})


class _AnyStub:
    """Answers "" for every attribute — lets the selectable key sets be
    DERIVED from the field functions themselves (run each fn once against
    a stub and record the keys it emits), so a new field added to
    pod_fields is immediately selectable with no parallel set or
    per-kind stub object to keep in sync."""

    def __getattr__(self, name):
        return ""


SELECTABLE_KEYS = {kind: frozenset(fn(_AnyStub()).keys())
                   for kind, fn in _FIELD_FUNCS.items()}


def selectable_fields(kind: str, obj: Any) -> Dict[str, str]:
    """GetAttrs per kind; every kind supports the metadata pair."""
    fn = _FIELD_FUNCS.get(kind)
    return fn(obj) if fn is not None else _meta_fields(obj)


def validate_selector(kind: str, selector: FieldSelector) -> None:
    """Reject unsupported field labels up front, independent of cluster
    contents — the reference fails the field-label conversion at request
    time, not per matched object (an empty cluster must NOT make an
    invalid selector succeed)."""
    allowed = SELECTABLE_KEYS.get(kind, _META_KEYS)
    for key, _op, _v in selector.requirements:
        if key not in allowed:
            raise FieldSelectorError(
                f'field label not supported: "{key}"')


def filter_objects(kind: str, objs: List[Any],
                   selector: FieldSelector) -> List[Any]:
    if selector.empty:
        return objs
    validate_selector(kind, selector)
    return [o for o in objs
            if selector.matches(selectable_fields(kind, o))]
