"""runtime.Scheme analog: versioned <-> internal conversion + defaulting.

The reference's API machinery keeps two type families per group —
versioned external types (staging/src/k8s.io/api/...) and internal hub
types (pkg/apis/...) — with generated conversion + defaulting walked
through runtime.Scheme (staging/src/k8s.io/apimachinery/pkg/runtime/
scheme.go: AddKnownTypes, AddConversionFuncs, Default, Convert). Wire
payloads always carry a versioned shape + apiVersion; everything above
the codec layer speaks internal.

This module is that machinery at the scale this framework needs:
a Scheme with per-(group/version, kind) codecs, each owning decode
(versioned JSON dict -> internal dataclass, defaults applied) and
encode (internal -> versioned dict). Implemented groups:

- componentconfig/v1alpha1 KubeSchedulerConfiguration
  (pkg/apis/componentconfig/types.go:158-198 + v1alpha1 defaults in
  pkg/apis/componentconfig/v1alpha1/defaults.go: scheduler name,
  hard-pod-affinity weight, leader-election timings).
- scheduler Policy v1 (plugin/pkg/scheduler/api/v1/types.go — the
  versioned mirror of api/types.go, decoded through api/policy.py).

The invariant tests pin: decode(encode(x)) == x (round-trip through the
versioned form), unknown apiVersion/kind fail loudly, and defaulting
happens exactly once, at decode (scheme.Default semantics).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

# ------------------------------------------------------- internal types


@dataclass
class LeaderElectionConfiguration:
    """componentconfig.LeaderElectionConfiguration (types.go:76-105)."""

    leader_elect: bool = True
    lease_duration_s: float = 15.0
    renew_deadline_s: float = 10.0
    retry_period_s: float = 2.0
    lock_object_namespace: str = "kube-system"
    lock_object_name: str = "kube-scheduler"


@dataclass
class KubeSchedulerConfiguration:
    """Internal componentconfig.KubeSchedulerConfiguration
    (pkg/apis/componentconfig/types.go:158-198), the subset this
    framework's daemon consumes."""

    scheduler_name: str = "default-scheduler"
    algorithm_provider: str = "DefaultProvider"
    policy_config_file: str = ""
    policy_configmap: str = ""
    policy_configmap_namespace: str = "kube-system"
    use_legacy_policy_config: bool = False
    healthz_bind_address: str = "0.0.0.0:10251"
    enable_profiling: bool = True
    enable_contention_profiling: bool = False
    hard_pod_affinity_symmetric_weight: int = 1
    failure_domains: str = \
        "kubernetes.io/hostname,failure-domain.beta.kubernetes.io/zone," \
        "failure-domain.beta.kubernetes.io/region"
    leader_election: LeaderElectionConfiguration = field(
        default_factory=LeaderElectionConfiguration)
    feature_gates: Dict[str, bool] = field(default_factory=dict)


# ---------------------------------------------------------------- scheme


class SchemeError(Exception):
    pass


class Scheme:
    """AddKnownTypes + Convert, dict-backed: (apiVersion, kind) -> codec."""

    def __init__(self):
        self._codecs: Dict[Tuple[str, str], Tuple[
            Callable[[Dict[str, Any]], Any],
            Callable[[Any], Dict[str, Any]]]] = {}

    def register(self, api_version: str, kind: str,
                 decode: Callable[[Dict[str, Any]], Any],
                 encode: Callable[[Any], Dict[str, Any]]) -> None:
        self._codecs[(api_version, kind)] = (decode, encode)

    def versions(self) -> Tuple[Tuple[str, str], ...]:
        return tuple(sorted(self._codecs))

    def decode(self, data: Dict[str, Any]) -> Any:
        """Versioned wire dict -> internal object, defaults applied —
        the codec DecoderToVersion path."""
        gv = data.get("apiVersion", "")
        kind = data.get("kind", "")
        codec = self._codecs.get((gv, kind))
        if codec is None:
            raise SchemeError(
                f"no kind {kind!r} registered for version {gv!r}")
        return codec[0](data)

    def encode(self, obj: Any, api_version: str,
               kind: str) -> Dict[str, Any]:
        codec = self._codecs.get((api_version, kind))
        if codec is None:
            raise SchemeError(
                f"no kind {kind!r} registered for version {api_version!r}")
        out = codec[1](obj)
        out["apiVersion"] = api_version
        out["kind"] = kind
        return out

    def convert(self, data: Dict[str, Any], to_version: str) -> \
            Dict[str, Any]:
        """Versioned -> versioned through the internal hub (the two-hop
        conversion runtime.Scheme always performs)."""
        obj = self.decode(data)
        return self.encode(obj, to_version, data.get("kind", ""))


# ------------------------------- componentconfig/v1alpha1 codec functions


_SCHED_GV = "componentconfig/v1alpha1"
_SCHED_KIND = "KubeSchedulerConfiguration"


def _decode_scheduler_config(data: Dict[str, Any]) -> \
        KubeSchedulerConfiguration:
    """v1alpha1 camelCase wire -> internal, with the defaults of
    pkg/apis/componentconfig/v1alpha1/defaults.go applied for absent
    fields (SetDefaults_KubeSchedulerConfiguration)."""
    le_raw = data.get("leaderElection", {}) or {}
    le = LeaderElectionConfiguration(
        leader_elect=le_raw.get("leaderElect", True),
        lease_duration_s=_seconds(le_raw.get("leaseDuration", "15s")),
        renew_deadline_s=_seconds(le_raw.get("renewDeadline", "10s")),
        retry_period_s=_seconds(le_raw.get("retryPeriod", "2s")),
        lock_object_namespace=le_raw.get("lockObjectNamespace",
                                         "kube-system"),
        lock_object_name=le_raw.get("lockObjectName", "kube-scheduler"))
    weight = data.get("hardPodAffinitySymmetricWeight", 1)
    if not 0 <= weight <= 100:
        raise SchemeError(
            f"hardPodAffinitySymmetricWeight must be in [0, 100], "
            f"got {weight}")  # validation.go ValidateKubeSchedulerConfiguration
    gates = {}
    for part in filter(None, str(data.get("featureGates", "")).split(",")):
        k, _, v = part.partition("=")
        gates[k.strip()] = v.strip().lower() == "true"
    return KubeSchedulerConfiguration(
        scheduler_name=data.get("schedulerName", "default-scheduler"),
        algorithm_provider=data.get("algorithmProvider", "DefaultProvider"),
        policy_config_file=data.get("policyConfigFile", ""),
        policy_configmap=data.get("policyConfigMapName", ""),
        policy_configmap_namespace=data.get("policyConfigMapNamespace",
                                            "kube-system"),
        use_legacy_policy_config=data.get("useLegacyPolicyConfig", False),
        healthz_bind_address=data.get("healthzBindAddress", "0.0.0.0:10251"),
        enable_profiling=data.get("enableProfiling", True),
        enable_contention_profiling=data.get("enableContentionProfiling",
                                             False),
        hard_pod_affinity_symmetric_weight=weight,
        failure_domains=data.get(
            "failureDomains",
            KubeSchedulerConfiguration.failure_domains),
        leader_election=le,
        feature_gates=gates)


def _encode_scheduler_config(cfg: KubeSchedulerConfiguration) -> \
        Dict[str, Any]:
    return {
        "schedulerName": cfg.scheduler_name,
        "algorithmProvider": cfg.algorithm_provider,
        "policyConfigFile": cfg.policy_config_file,
        "policyConfigMapName": cfg.policy_configmap,
        "policyConfigMapNamespace": cfg.policy_configmap_namespace,
        "useLegacyPolicyConfig": cfg.use_legacy_policy_config,
        "healthzBindAddress": cfg.healthz_bind_address,
        "enableProfiling": cfg.enable_profiling,
        "enableContentionProfiling": cfg.enable_contention_profiling,
        "hardPodAffinitySymmetricWeight":
            cfg.hard_pod_affinity_symmetric_weight,
        "failureDomains": cfg.failure_domains,
        "leaderElection": {
            "leaderElect": cfg.leader_election.leader_elect,
            "leaseDuration": f"{cfg.leader_election.lease_duration_s:g}s",
            "renewDeadline": f"{cfg.leader_election.renew_deadline_s:g}s",
            "retryPeriod": f"{cfg.leader_election.retry_period_s:g}s",
            "lockObjectNamespace":
                cfg.leader_election.lock_object_namespace,
            "lockObjectName": cfg.leader_election.lock_object_name,
        },
        "featureGates": ",".join(
            f"{k}={'true' if v else 'false'}"
            for k, v in sorted(cfg.feature_gates.items())),
    }


def _seconds(s: Any) -> float:
    """metav1.Duration strings ("15s", "1m30s") or bare numbers."""
    if isinstance(s, (int, float)):
        return float(s)
    total = 0.0
    num = ""
    units = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 0.001}
    i = 0
    text = str(s)
    while i < len(text):
        ch = text[i]
        if ch.isdigit() or ch == ".":
            num += ch
            i += 1
            continue
        unit = ch
        if text[i:i + 2] == "ms":
            unit = "ms"
            i += 1
        if unit not in units or not num:
            raise SchemeError(f"invalid duration {s!r}")
        try:
            value = float(num)
        except ValueError:
            raise SchemeError(f"invalid duration {s!r}") from None
        total += value * units[unit]
        num = ""
        i += 1
    if num:
        raise SchemeError(f"invalid duration {s!r} (missing unit)")
    return total


# --------------------------------------------------- scheduler Policy v1


def _decode_policy_v1(data: Dict[str, Any]):
    """Policy v1 (plugin/pkg/scheduler/api/v1/types.go) decoded through
    the existing parser — same wire shape, the version label is what the
    scheme dispatches on (v1 and internal are field-identical in 1.7)."""
    import json as _json

    from kubernetes_tpu_torch.api.policy import parse_policy
    return parse_policy(_json.dumps(data))


def _encode_policy_v1(policy) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if policy.predicates is not None:
        out["predicates"] = [
            {"name": p.name, **({"argument": p.argument_raw}
                                if getattr(p, "argument_raw", None) else {})}
            for p in policy.predicates]
    if policy.priorities is not None:
        out["priorities"] = [
            {"name": p.name, "weight": p.weight,
             **({"argument": p.argument_raw}
                if getattr(p, "argument_raw", None) else {})}
            for p in policy.priorities]
    if policy.extenders:
        out["extenders"] = [
            {"urlPrefix": e.url_prefix, "filterVerb": e.filter_verb,
             "prioritizeVerb": e.prioritize_verb, "bindVerb": e.bind_verb,
             "weight": e.weight, "nodeCacheCapable": e.node_cache_capable}
            for e in policy.extenders]
    return out


# ------------------------------------------------- core group (Pod/Node)
#
# The defining apimachinery axis (pkg/api/v1/conversion.go + runtime.Scheme
# Convert): versioned external shapes <-> the internal dataclasses, with
# defaulting applied exactly once at decode. v1 is the serde wire shape
# (metadata/spec, camelCase). "v2" is a hypothetical next version proving
# the conversion machinery handles FIELD RENAMES through the internal hub:
#   spec.nodeName      -> spec.boundNode
#   spec.schedulerName -> spec.scheduler
#   (Node) spec.unschedulable -> spec.schedulingDisabled
# Converting v1<->v2 is always two hops through internal, never
# field-by-field between versions — exactly runtime.Scheme's shape.


def _decode_pod_v1(data: Dict[str, Any]):
    from kubernetes_tpu_torch.api import serde
    return serde.decode_pod(data)


def _encode_pod_v1(pod) -> Dict[str, Any]:
    from kubernetes_tpu_torch.api import serde
    return serde.encode_pod(pod)


def _decode_pod_v2(data: Dict[str, Any]):
    from kubernetes_tpu_torch.api import serde
    spec = dict(data.get("spec") or {})
    if "boundNode" in spec:
        spec["nodeName"] = spec.pop("boundNode")
    if "scheduler" in spec:
        spec["schedulerName"] = spec.pop("scheduler")
    return serde.decode_pod({**data, "spec": spec})


def _encode_pod_v2(pod) -> Dict[str, Any]:
    from kubernetes_tpu_torch.api import serde
    out = serde.encode_pod(pod)
    spec = out["spec"]
    spec["boundNode"] = spec.pop("nodeName")
    spec["scheduler"] = spec.pop("schedulerName")
    return out


def _decode_node_v1(data: Dict[str, Any]):
    from kubernetes_tpu_torch.api import serde
    return serde.decode_node(data)


def _encode_node_v1(node) -> Dict[str, Any]:
    from kubernetes_tpu_torch.api import serde
    return serde.encode_node(node)


def _decode_node_v2(data: Dict[str, Any]):
    spec = dict(data.get("spec") or {})
    if "schedulingDisabled" in spec:
        spec["unschedulable"] = spec.pop("schedulingDisabled")
    return _decode_node_v1({**data, "spec": spec})


def _encode_node_v2(node) -> Dict[str, Any]:
    out = _encode_node_v1(node)
    spec = out["spec"]
    spec["schedulingDisabled"] = spec.pop("unschedulable")
    return out


def _decode_service_v1(data: Dict[str, Any]):
    from kubernetes_tpu_torch.api import wire
    if "metadata" in data:
        # the kubectl manifest shape: flatten metadata + spec into the
        # native field namespace before the reflective decode
        meta = data.get("metadata") or {}
        spec = data.get("spec") or {}
        body = {**spec,
                "name": meta.get("name", ""),
                "namespace": meta.get("namespace", "default"),
                "labels": dict(meta.get("labels") or {}),
                "annotations": dict(meta.get("annotations") or {})}
    else:
        body = {k: v for k, v in data.items()
                if k not in ("apiVersion",)}
    return wire.decode_any(body, "Service")


def _encode_service_v1(svc) -> Dict[str, Any]:
    from kubernetes_tpu_torch.api import wire
    return wire.encode(svc, "Service")


def _generic_codec(kind: str):
    """v1 codec for a reflective wire kind: accepts both the flat native
    encoding and the kubectl metadata/spec manifest shape (flattened the
    way _decode_service_v1 does), encodes flat."""
    # kinds wire.decode_any sniffs the metadata/spec shape for itself —
    # flattening first would bypass their dedicated manifest decoders
    # (e.g. decode_crd_manifest's shortNames + openAPIV3Schema handling)
    _SNIFFED = ("Pod", "Node", "CustomResourceDefinition")

    def decode(data: Dict[str, Any]):
        from kubernetes_tpu_torch.api import wire
        if "metadata" in data and kind not in _SNIFFED:
            meta = data.get("metadata") or {}
            spec = data.get("spec") or {}
            body = {**spec,
                    "name": meta.get("name", ""),
                    "namespace": meta.get("namespace", "default"),
                    "labels": dict(meta.get("labels") or {}),
                    "annotations": dict(meta.get("annotations") or {})}
        else:
            body = {k: v for k, v in data.items() if k != "apiVersion"}
        return wire.decode_any(body, kind)

    def encode(obj) -> Dict[str, Any]:
        from kubernetes_tpu_torch.api import wire
        return wire.encode(obj, kind)

    return decode, encode


def default_scheme() -> Scheme:
    from kubernetes_tpu_torch.api.wire import KIND_REGISTRY
    s = Scheme()
    s.register(_SCHED_GV, _SCHED_KIND,
               _decode_scheduler_config, _encode_scheduler_config)
    s.register("v1", "Policy", _decode_policy_v1, _encode_policy_v1)
    # the unversioned legacy Policy files (--use-legacy-policy-config)
    # decode through the same codec
    s.register("", "Policy", _decode_policy_v1, _encode_policy_v1)
    # every reflective wire kind gets a generic v1 codec, so the scheme
    # covers the full served surface (the reference registers every group
    # in its Scheme); the hand-written core codecs below override the
    # kinds with richer semantics
    for kind in KIND_REGISTRY:
        dec, enc = _generic_codec(kind)
        s.register("v1", kind, dec, enc)
    # core group: two served versions over one internal hub
    s.register("v1", "Pod", _decode_pod_v1, _encode_pod_v1)
    s.register("v2", "Pod", _decode_pod_v2, _encode_pod_v2)
    s.register("v1", "Node", _decode_node_v1, _encode_node_v1)
    s.register("v2", "Node", _decode_node_v2, _encode_node_v2)
    s.register("v1", "Service", _decode_service_v1, _encode_service_v1)
    return s


DEFAULT_SCHEME = default_scheme()
