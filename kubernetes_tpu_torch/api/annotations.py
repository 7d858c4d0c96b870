"""Scheduler-read annotation parsers shared by the tensorization and oracle
paths (one implementation so kernel and host semantics cannot diverge)."""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

# reference: v1.PreferAvoidPodsAnnotationKey, read by
# pkg/api/v1/helper GetAvoidPodsFromNodeAnnotations
# (node_prefer_avoid_pods.go:48-58)
AVOID_PODS_ANNOTATION = "scheduler.alpha.kubernetes.io/preferAvoidPods"


def parse_avoid_annotation(annotations: Dict[str, str]) -> List[Tuple[str, str]]:
    """-> [(controller kind, controller uid)] from the preferAvoidPods node
    annotation. The Go reference unmarshals into a typed struct, so any
    shape mismatch (non-object JSON, non-object list entries) degrades to
    'no avoidance' rather than erroring — mirrored here."""
    raw = annotations.get(AVOID_PODS_ANNOTATION)
    if not raw:
        return []
    try:
        avoids = json.loads(raw)
    except ValueError:
        return []
    if not isinstance(avoids, dict):
        return []
    entries = avoids.get("preferAvoidPods")
    if not isinstance(entries, list):
        return []
    out: List[Tuple[str, str]] = []
    for avoid in entries:
        if not isinstance(avoid, dict):
            continue
        sig = avoid.get("podSignature")
        ctrl = sig.get("podController") if isinstance(sig, dict) else None
        if isinstance(ctrl, dict) and ctrl.get("kind") and ctrl.get("uid"):
            out.append((str(ctrl["kind"]), str(ctrl["uid"])))
    return out
