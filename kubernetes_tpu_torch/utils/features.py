"""Feature gates: --feature-gates=K=V registry.

Mirror of pkg/features/kube_features.go:33-135 (the scheduling-relevant
subset) + the generic map-flag parser in
staging/src/k8s.io/apiserver/pkg/util/feature/feature_gate.go. Defaults match
the reference at v1.7: alpha features off, beta features on.
"""

from __future__ import annotations

import threading
from kubernetes_tpu_torch.analysis import lockcheck
from typing import Dict

# name -> default enabled (kube_features.go:137-150 defaultKubernetesFeatureGates)
_DEFAULTS: Dict[str, bool] = {
    "AppArmor": True,  # beta (kube_features.go:42)
    "DynamicKubeletConfig": False,  # alpha (:48)
    "DynamicVolumeProvisioning": True,  # alpha->on by default (:54)
    "ExperimentalHostUserNamespaceDefaulting": False,  # beta-off (:60)
    "ExperimentalCriticalPodAnnotation": False,  # alpha (:68)
    "Accelerators": False,  # alpha (:76)
    "TaintBasedEvictions": False,  # alpha (:83)
    "RotateKubeletServerCertificate": False,  # alpha (:90)
    "RotateKubeletClientCertificate": False,  # alpha (:97)
    "PersistentLocalVolumes": False,  # alpha (:104) — gates NoVolumeNodeConflict
    "LocalStorageCapacityIsolation": False,  # alpha (:110)
    "PodPriority": False,  # alpha (:122) — gates preemption
    "EnableEquivalenceClassCache": False,  # alpha (:128)
    "AllAlpha": False,
}

_ALPHA = {
    "DynamicKubeletConfig", "ExperimentalCriticalPodAnnotation",
    "Accelerators", "TaintBasedEvictions", "RotateKubeletServerCertificate",
    "RotateKubeletClientCertificate", "PersistentLocalVolumes",
    "LocalStorageCapacityIsolation", "PodPriority",
    "EnableEquivalenceClassCache",
}


class FeatureGate:
    """Thread-safe gate map; AllAlpha=true flips every alpha gate unless it
    was explicitly set (feature_gate.go Set)."""

    def __init__(self):
        self._lock = lockcheck.make_lock("FeatureGate._lock")
        self._enabled = dict(_DEFAULTS)
        self._explicit: set = set()

    def enabled(self, name: str) -> bool:
        with self._lock:
            if name not in self._enabled:
                raise KeyError(f"unknown feature gate {name!r}")
            return self._enabled[name]

    def set(self, name: str, value: bool) -> None:
        with self._lock:
            if name not in self._enabled:
                raise KeyError(f"unknown feature gate {name!r}")
            self._enabled[name] = value
            self._explicit.add(name)
            if name == "AllAlpha":
                for k in _ALPHA:
                    if k not in self._explicit:
                        self._enabled[k] = value

    def parse(self, spec: str) -> None:
        """--feature-gates=K=V,K=V (feature_gate.go:Set)."""
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            self.set(k.strip(), v.strip().lower() == "true")

    def reset(self) -> None:
        with self._lock:
            self._enabled = dict(_DEFAULTS)
            self._explicit = set()


DEFAULT_FEATURE_GATE = FeatureGate()


def enabled(name: str) -> bool:
    return DEFAULT_FEATURE_GATE.enabled(name)
