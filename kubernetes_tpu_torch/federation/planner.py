"""Federated replica planner: distribute N replicas across member clusters.

Reimplementation of the reference's planner semantics
(federation/pkg/federation-controller/util/planner/planner.go:67 Plan):

  1. clusters take their MinReplicas first (capacity-capped), in
     decreasing-weight order with an FNV-1 hash of (cluster, rs key) as the
     tiebreak — so single-replica sets don't always land on the
     alphabetically smallest cluster;
  2. with rebalance=false, clusters keep what they already run (up to
     max/capacity) before anything moves — the anti-thrash preallocation;
  3. remaining replicas spread proportionally to Weight, fractions rounded
     up, iterating until nothing moves (max/capacity caps drop clusters
     from later rounds; capacity overshoot is returned as `overflow`).

Preferences wire format is the reference's replica-set-preferences
annotation (federation/pkg/federatedtypes/replicaset.go:35
`federation.kubernetes.io/replica-set-preferences`), JSON like
{"rebalance": true, "clusters": {"*": {"weight": 1}}}.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

PREFERENCES_ANNOTATION = "federation.kubernetes.io/replica-set-preferences"


@dataclass
class ClusterPreferences:
    """fedapi.ClusterPreferences (federation/apis/federation/types.go:153)."""

    min_replicas: int = 0
    max_replicas: Optional[int] = None
    weight: int = 0


@dataclass
class ReplicaAllocationPreferences:
    """fedapi.ReplicaAllocationPreferences (types.go:138): rebalance +
    per-cluster (or "*" wildcard) preferences."""

    rebalance: bool = False
    clusters: Dict[str, ClusterPreferences] = field(default_factory=dict)

    @classmethod
    def parse(cls, text: str) -> "ReplicaAllocationPreferences":
        obj = json.loads(text)
        clusters = {}
        for name, p in (obj.get("clusters") or {}).items():
            mx = p.get("maxReplicas")
            clusters[name] = ClusterPreferences(
                min_replicas=int(p.get("minReplicas", 0)),
                max_replicas=int(mx) if mx is not None else None,
                weight=int(p.get("weight", 0)))
        return cls(rebalance=bool(obj.get("rebalance", False)),
                   clusters=clusters)


DEFAULT_PREFERENCES = ReplicaAllocationPreferences(
    clusters={"*": ClusterPreferences(weight=1)})


def _fnv1_32(data: bytes) -> int:
    """FNV-1 32-bit (Go hash/fnv New32) — the planner's tie hash."""
    h = 0x811C9DC5
    for b in data:
        h = (h * 0x01000193) & 0xFFFFFFFF
        h ^= b
    return h


class Planner:
    def __init__(self, preferences: ReplicaAllocationPreferences):
        self.preferences = preferences

    def plan(self, replicas: int, clusters: List[str],
             current: Optional[Dict[str, int]] = None,
             capacity: Optional[Dict[str, int]] = None,
             key: str = "") -> Tuple[Dict[str, int], Dict[str, int]]:
        """(plan, overflow) — planner.go:67-220, integer-exact."""
        current = current or {}
        capacity = capacity or {}
        prefs: List[Tuple[str, int, ClusterPreferences]] = []
        plan: Dict[str, int] = {}
        overflow: Dict[str, int] = {}
        for name in clusters:
            p = self.preferences.clusters.get(name) \
                or self.preferences.clusters.get("*")
            if p is None:
                plan[name] = 0
            else:
                h = _fnv1_32(name.encode() + key.encode())
                prefs.append((name, h, p))
        # decreasing weight, then increasing hash (byWeight planner.go:38-46)
        prefs.sort(key=lambda t: (-t[2].weight, t[1]))

        remaining = replicas
        for name, _h, p in prefs:
            mn = min(p.min_replicas, remaining)
            if name in capacity:
                mn = min(mn, capacity[name])
            remaining -= mn
            plan[name] = mn

        preallocated: Dict[str, int] = {}
        if not self.preferences.rebalance:
            for name, _h, p in prefs:
                planned = plan[name]
                count = current.get(name)
                if count is not None and count > planned:
                    target = count
                    if p.max_replicas is not None:
                        target = min(p.max_replicas, target)
                    if name in capacity:
                        target = min(capacity[name], target)
                    extra = min(target - planned, remaining)
                    if extra < 0:
                        extra = 0
                    remaining -= extra
                    preallocated[name] = extra
                    plan[name] = extra + planned

        modified = True
        while modified and remaining > 0:
            modified = False
            weight_sum = sum(p.weight for _n, _h, p in prefs)
            if weight_sum <= 0:
                break
            next_prefs = []
            distribute = remaining
            for name, h, p in prefs:
                start = plan[name]
                # fractions rounded up (planner.go:169)
                extra = (distribute * p.weight + weight_sum - 1) // weight_sum
                extra = min(extra, remaining)
                prealloc = preallocated.get(name, 0)
                used_prealloc = min(extra, prealloc)
                preallocated[name] = prealloc - used_prealloc
                extra -= used_prealloc
                if used_prealloc > 0:
                    modified = True
                total = start + extra
                full = False
                if p.max_replicas is not None and total > p.max_replicas:
                    total = p.max_replicas
                    full = True
                if name in capacity and total > capacity[name]:
                    overflow[name] = total - capacity[name]
                    total = capacity[name]
                    full = True
                if not full:
                    next_prefs.append((name, h, p))
                remaining -= total - start
                plan[name] = total
                if total > start:
                    modified = True
            prefs = next_prefs

        return plan, overflow
