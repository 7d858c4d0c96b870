"""Scheduler Policy API: declarative predicate/priority/extender config.

Mirror of the reference's Policy types (plugin/pkg/scheduler/api/types.go:38-155
and the v1 JSON mirror api/v1/types.go) parsed from the same JSON format the
reference accepts via --policy-config-file / --policy-configmap
(factory.go:619 CreateFromConfig). Backward compatibility of this format
matters (compatibility_test.go guards it upstream; tests/test_policy.py here).

Also hosts the algorithm-provider registry: the named default
predicate/priority sets (algorithmprovider/defaults/defaults.go:118,191 —
DefaultProvider; :65 ClusterAutoscalerProvider swaps LeastRequested for
MostRequested).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import MAX_PRIORITY

MAX_WEIGHT = MAX_PRIORITY * 100  # validation.go: weight must be < MaxWeight


@dataclass
class LabelsPresence:
    labels: List[str] = field(default_factory=list)
    presence: bool = True


@dataclass
class ServiceAffinityArgs:
    labels: List[str] = field(default_factory=list)


@dataclass
class PredicatePolicy:
    name: str
    # argument (api/types.go:67-77): only one of these set
    service_affinity: Optional[ServiceAffinityArgs] = None
    labels_presence: Optional[LabelsPresence] = None


@dataclass
class PriorityPolicy:
    name: str
    weight: int = 1
    # arguments (api/types.go:95-123)
    service_antiaffinity_label: Optional[str] = None
    label_preference: Optional[Dict] = None


@dataclass
class ExtenderConfig:
    """api/types.go:129-155."""

    url_prefix: str
    filter_verb: str = ""
    prioritize_verb: str = ""
    bind_verb: str = ""
    weight: int = 1
    enable_https: bool = False
    http_timeout_s: float = 5.0  # DefaultExtenderTimeout (extender.go:36)
    node_cache_capable: bool = False


@dataclass
class Policy:
    predicates: Optional[List[PredicatePolicy]] = None
    priorities: Optional[List[PriorityPolicy]] = None
    extenders: List[ExtenderConfig] = field(default_factory=list)


def parse_policy(text: str) -> Policy:
    """Parse the reference's Policy JSON (same field names; apiVersion/kind
    tolerated and ignored, like the lenient codec the reference uses)."""
    obj = json.loads(text)
    predicates = None
    if "predicates" in obj and obj["predicates"] is not None:
        predicates = []
        for p in obj["predicates"]:
            arg = p.get("argument") or {}
            sa = arg.get("serviceAffinity")
            lp = arg.get("labelsPresence")
            predicates.append(PredicatePolicy(
                name=p["name"],
                service_affinity=ServiceAffinityArgs(sa.get("labels") or [])
                if sa else None,
                labels_presence=LabelsPresence(lp.get("labels") or [],
                                               bool(lp.get("presence", True)))
                if lp else None,
            ))
    priorities = None
    if "priorities" in obj and obj["priorities"] is not None:
        priorities = []
        for p in obj["priorities"]:
            arg = p.get("argument") or {}
            saa = arg.get("serviceAntiAffinity")
            priorities.append(PriorityPolicy(
                name=p["name"],
                weight=int(p.get("weight", 1)),
                service_antiaffinity_label=(saa or {}).get("label"),
                label_preference=arg.get("labelPreference"),
            ))
    extenders = []
    for e in obj.get("extenders") or []:
        timeout = e.get("httpTimeout")
        if isinstance(timeout, (int, float)):
            timeout = timeout / 1e9  # Go time.Duration marshals as int ns
        extenders.append(ExtenderConfig(
            url_prefix=e.get("urlPrefix", ""),
            filter_verb=e.get("filterVerb", ""),
            prioritize_verb=e.get("prioritizeVerb", ""),
            bind_verb=e.get("bindVerb", ""),
            weight=int(e.get("weight", 1)),
            enable_https=bool(e.get("enableHttps", False)),
            http_timeout_s=float(timeout) if timeout else 5.0,
            node_cache_capable=bool(e.get("nodeCacheCapable", False)),
        ))
    return Policy(predicates=predicates, priorities=priorities,
                  extenders=extenders)


# ---------------------------------------------------------------------------
# algorithm providers (defaults.go)
# ---------------------------------------------------------------------------

# defaults.go:118 defaultPredicates — names kept verbatim so policy files and
# provider selection stay drop-in compatible. Kernel coverage status lives in
# the engine's predicate registry; unimplemented ones map to the host oracle
# or are pending (volumes).
DEFAULT_PREDICATES = [
    "NoVolumeZoneConflict", "MaxEBSVolumeCount", "MaxGCEPDVolumeCount",
    "MaxAzureDiskVolumeCount", "MatchInterPodAffinity", "NoDiskConflict",
    "GeneralPredicates", "PodToleratesNodeTaints", "CheckNodeMemoryPressure",
    "CheckNodeDiskPressure", "CheckNodeCondition", "NoVolumeNodeConflict",
]

# defaults.go:191 defaultPriorities with weights
DEFAULT_PRIORITIES_POLICY: List[Tuple[str, int]] = [
    ("SelectorSpreadPriority", 1),
    ("InterPodAffinityPriority", 1),
    ("LeastRequestedPriority", 1),
    ("BalancedResourceAllocation", 1),
    ("NodePreferAvoidPodsPriority", 10000),
    ("NodeAffinityPriority", 1),
    ("TaintTolerationPriority", 1),
]

PROVIDERS: Dict[str, Dict] = {
    "DefaultProvider": {
        "predicates": list(DEFAULT_PREDICATES),
        "priorities": list(DEFAULT_PRIORITIES_POLICY),
    },
    "ClusterAutoscalerProvider": {
        "predicates": list(DEFAULT_PREDICATES),
        "priorities": [("MostRequestedPriority", 1) if n == "LeastRequestedPriority"
                       else (n, w) for n, w in DEFAULT_PRIORITIES_POLICY],
    },
}


def provider_priorities(name: str = "DefaultProvider",
                        implemented: Optional[List[str]] = None
                        ) -> Tuple[Tuple[str, int], ...]:
    """Priority tuple for an algorithm provider, filtered to kernels that
    exist when `implemented` is given."""
    pairs = PROVIDERS[name]["priorities"]
    if implemented is not None:
        pairs = [(n, w) for n, w in pairs if n in implemented]
    return tuple(pairs)
