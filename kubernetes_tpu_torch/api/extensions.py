"""API-extension object model: CustomResourceDefinitions + APIServices.

TPU-native analog of the two "extension" staging servers in the reference:

- apiextensions-apiserver (staging/src/k8s.io/apiextensions-apiserver/):
  CustomResourceDefinition lets a user add a new served resource at
  runtime.  The reference validates the CRD (names must be
  ``<plural>.<group>``), accepts or rejects the names against other
  served resources (NamesAccepted condition), then marks the CRD
  Established, at which point a dynamic registry serves CRUD for the
  new kind (apiextensions-apiserver/pkg/apiserver/customresource_handler.go).
- kube-aggregator (staging/src/k8s.io/kube-aggregator/): APIService
  objects map a group/version onto either the local server or a remote
  extension apiserver, with an availability controller probing the
  backend and gating traffic (kube-aggregator/pkg/controllers/status/
  available_controller.go).

The schema subset here mirrors the v1.7-era CRD validation precursor:
per-field type / required / minimum / maximum / enum checks over spec,
enough to exercise the reject-on-invalid path the reference's
apiextensions validation provides.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class CRDNames:
    """CustomResourceDefinitionNames (apiextensions types.go)."""

    plural: str
    kind: str
    singular: str = ""
    short_names: List[str] = field(default_factory=list)
    list_kind: str = ""

    def __post_init__(self) -> None:
        if not self.singular:
            self.singular = self.kind.lower()
        if not self.list_kind:
            self.list_kind = self.kind + "List"


@dataclass
class CRDCondition:
    """Established / NamesAccepted / Terminating condition."""

    type: str
    status: str  # "True" | "False"
    reason: str = ""
    message: str = ""


@dataclass
class CustomResourceDefinition:
    """apiextensions-apiserver CustomResourceDefinition (cluster-scoped).

    ``name`` must equal ``<names.plural>.<group>`` — the same structural
    rule the reference enforces in validation
    (apiextensions-apiserver/pkg/apis/apiextensions/validation/validation.go).
    ``validation`` is a flat field-schema map over ``spec``:
    ``{"replicas": {"type": "integer", "minimum": 0}, ...}`` plus an
    optional ``"required": [...]`` list.
    """

    name: str
    group: str
    version: str
    names: CRDNames
    scope: str = "Namespaced"  # or "Cluster"
    validation: Dict[str, Any] = field(default_factory=dict)
    conditions: List[CRDCondition] = field(default_factory=list)
    # finalizer analog: customresourcecleanup.apiextensions.k8s.io —
    # instances are purged before the definition row disappears
    finalizers: List[str] = field(
        default_factory=lambda: ["customresourcecleanup"])
    terminating: bool = False
    resource_version: int = 0
    namespace: str = ""  # cluster-scoped; kept for store uniformity

    def condition(self, ctype: str) -> Optional[CRDCondition]:
        for c in self.conditions:
            if c.type == ctype:
                return c
        return None

    def set_condition(self, ctype: str, status: str, reason: str = "",
                      message: str = "") -> None:
        c = self.condition(ctype)
        if c is None:
            self.conditions.append(
                CRDCondition(ctype, status, reason, message))
        else:
            c.status, c.reason, c.message = status, reason, message

    @property
    def established(self) -> bool:
        c = self.condition("Established")
        return c is not None and c.status == "True"

    @property
    def names_accepted(self) -> bool:
        c = self.condition("NamesAccepted")
        return c is not None and c.status == "True"


@dataclass
class CustomResource:
    """An instance of a CRD-defined kind — schemaless bag with the same
    metadata shape as every built-in object, so the generic store, watch
    log, and WAL handle it unmodified (the dynamic-registry property of
    customresource_handler.go)."""

    kind: str
    name: str
    namespace: str = ""
    api_version: str = ""  # "<group>/<version>"
    labels: Dict[str, str] = field(default_factory=dict)
    spec: Dict[str, Any] = field(default_factory=dict)
    status: Dict[str, Any] = field(default_factory=dict)
    resource_version: int = 0


@dataclass
class ServiceReference:
    """Backend of an aggregated API (kube-aggregator types.go)."""

    namespace: str
    name: str


@dataclass
class APIService:
    """kube-aggregator APIService: routes <version>.<group> either to the
    local server (service=None) or to an extension apiserver."""

    name: str  # "<version>.<group>"
    group: str
    version: str
    service: Optional[ServiceReference] = None
    group_priority_minimum: int = 1000
    version_priority: int = 100
    available: bool = False
    available_message: str = ""
    resource_version: int = 0
    namespace: str = ""

    @property
    def local(self) -> bool:
        return self.service is None


class SchemaError(Exception):
    """Custom object rejected by the CRD's validation schema."""


def validate_custom(crd: CustomResourceDefinition, obj: CustomResource) -> None:
    """Enforce the CRD's flat spec schema. Mirrors what apiextensions
    validation rejects: wrong primitive type, out-of-range numerics,
    values outside an enum, and missing required fields."""
    schema = crd.validation or {}
    required = schema.get("required", [])
    for req in required:
        if req not in obj.spec:
            raise SchemaError(f"spec.{req} is required")
    _TYPES = {
        "integer": (int,),
        "number": (int, float),
        "string": (str,),
        "boolean": (bool,),
        "array": (list,),
        "object": (dict,),
    }
    for fname, fschema in schema.items():
        if fname == "required" or fname not in obj.spec:
            continue
        val = obj.spec[fname]
        want = fschema.get("type")
        if want is not None:
            pytypes = _TYPES.get(want)
            if pytypes is None:
                raise SchemaError(f"unknown schema type {want!r}")
            # bool is an int subclass in Python; keep integer strict
            if want in ("integer", "number") and isinstance(val, bool):
                raise SchemaError(
                    f"spec.{fname}: expected {want}, got boolean")
            if not isinstance(val, pytypes):
                raise SchemaError(
                    f"spec.{fname}: expected {want}, "
                    f"got {type(val).__name__}")
        if ("minimum" in fschema or "maximum" in fschema) and (
                isinstance(val, bool) or not isinstance(val, (int, float))):
            # bounds imply a numeric field even when "type" was omitted;
            # a non-numeric value must 422, not TypeError into a 500
            raise SchemaError(
                f"spec.{fname}: expected a number for a bounded field, "
                f"got {type(val).__name__}")
        if "minimum" in fschema and val < fschema["minimum"]:
            raise SchemaError(
                f"spec.{fname}: {val} is less than minimum "
                f"{fschema['minimum']}")
        if "maximum" in fschema and val > fschema["maximum"]:
            raise SchemaError(
                f"spec.{fname}: {val} is greater than maximum "
                f"{fschema['maximum']}")
        if "enum" in fschema and val not in fschema["enum"]:
            raise SchemaError(
                f"spec.{fname}: {val!r} not in enum {fschema['enum']}")
