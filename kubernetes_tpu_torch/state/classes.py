"""Equivalence classes over pending pods: tensorize unique specs once.

The reference de-duplicates predicate work with the equivalence cache
(plugin/pkg/scheduler/core/equivalence_cache.go:54 — per-node LRU keyed by
the equivalence hash of the pod's owning controller, :183 getEquivalenceHash).
The tensor analog is stronger and simpler: pods are grouped by a canonical
hash of every spec field the kernels read, the PodBatch encoding runs once
per CLASS instead of once per pod, and per-pod rows are recovered on device
with a single gather (`arrays[class_of]`). A 30k-pod deployment storm of one
template costs one row of host-side encoding instead of 30k.

Unlike the reference's controller-ref hash (which assumes pods of one
ReplicaSet are interchangeable), the class key here is exact: two pods share
a class only if every feature that can influence predicates, priorities, or
host-path routing (labels/namespace for affinity symmetry and spreading)
is identical, so dedup can never change a scheduling outcome.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.state.snapshot import ClusterSnapshot, PodBatch
from kubernetes_tpu_torch.utils.trace import COUNTERS


def _canon_reqs(reqs) -> tuple:
    return tuple((r.key, str(r.operator), tuple(r.values)) for r in reqs)


def _canon_nsterms(terms) -> Optional[tuple]:
    if terms is None:
        return None
    return tuple(_canon_reqs(t.match_expressions) for t in terms)


def _canon_label_selector(ls) -> Optional[tuple]:
    if ls is None:
        return None
    return (tuple(sorted(ls.match_labels.items())),
            _canon_reqs(ls.match_expressions))


def _canon_pod_term(t) -> tuple:
    return (_canon_label_selector(t.label_selector), tuple(t.namespaces),
            t.topology_key)


def _canon_pod_affinity(pa) -> Optional[tuple]:
    if pa is None:
        return None
    return (tuple(_canon_pod_term(t) for t in pa.required_terms),
            tuple((w, _canon_pod_term(t)) for w, t in pa.preferred_terms))


def _canon_node_affinity(na) -> Optional[tuple]:
    if na is None:
        return None
    return (_canon_nsterms(na.required_terms),
            tuple((w, _canon_reqs(t.match_expressions))
                  for w, t in na.preferred_terms))


def _canon_affinity(a) -> Optional[tuple]:
    if a is None:
        return None
    return (_canon_node_affinity(a.node_affinity),
            _canon_pod_affinity(a.pod_affinity),
            _canon_pod_affinity(a.pod_anti_affinity))


def _canon_volume(v) -> tuple:
    return (v.name, str(v.kind), v.volume_id, v.read_only,
            tuple(v.monitors), v.pool, v.image)


def _canon_container(c) -> tuple:
    # limits matter: is_best_effort() reads them (types.py) and best_effort
    # drives the CheckNodeMemoryPressure predicate. Empty/singleton dicts
    # skip the sort — a one-element items() tuple IS its sorted form, and
    # this runs 30k times per drain round.
    req = c.requests
    lim = c.limits
    return (c.image,
            tuple(req.items()) if len(req) < 2 else tuple(sorted(req.items())),
            tuple(lim.items()) if len(lim) < 2 else tuple(sorted(lim.items())),
            tuple((p.host_port, p.protocol) for p in c.ports) if c.ports
            else ())


# Canonical keys by value: equal specs resolve to one shared tuple, so a
# pod's memo holds a reference instead of a nested tuple of its own.
# Cleared when full, so all-distinct specs never grow it past the bound.
# Threads racing on it can cost sharing, never correctness: the key a
# pod gets always equals the one built for it.
_INTERN_MAX = 4096
_INTERN: Dict[tuple, tuple] = {}
_UNSET = object()


def pod_class_key(pod: Pod) -> tuple:
    """Canonical spec tuple covering every field read by tensorization
    (snapshot.PodBatch), the kernels, and host-path routing. Name/uid/rv are
    deliberately excluded — identity never affects placement.

    Interned: equal keys are one tuple object (`_INTERN`, at most
    `_INTERN_MAX` keys, cleared when full), so the fresh tuples of a pod
    whose spec was seen before die in this call instead of living as long
    as the pod. Each build counts `classes.key_intern_hit` or
    `classes.key_intern_miss`; a memo hit counts nothing.

    Memoized per pod object in two entries of its __dict__: `_class_key`,
    the interned key, and `_class_node`, the node_name it was built under.
    Building the nested tuple costs ~6us and the drain keys 30k pods per
    round. The only spec field the scheduler mutates IN PLACE after keying
    is node_name (engine assume), so the memo is guarded on its identity;
    every other mutation path in the control plane goes through
    dataclasses.replace / fresh decode — and the shallow-copy hops
    (scheduler._queue_copy, models/hollow's template copies) DROP the memo
    explicitly. `_class_key` carries it: without that entry the memo is a
    miss whatever `_class_node` holds, so a stale class key never crosses
    an object boundary."""
    d = pod.__dict__
    key = d.get("_class_key")
    if key is not None and d.get("_class_node", _UNSET) is pod.node_name:
        return key
    key = _pod_class_key(pod)
    if len(_INTERN) >= _INTERN_MAX:
        _INTERN.clear()
    canon = _INTERN.setdefault(key, key)
    COUNTERS.inc("classes.key_intern_miss" if canon is key
                 else "classes.key_intern_hit")
    d["_class_node"] = pod.node_name
    d["_class_key"] = canon
    return canon


def _pod_class_key(pod: Pod) -> tuple:
    labels = pod.labels
    sel = pod.node_selector
    return (
        pod.namespace,
        tuple(labels.items()) if len(labels) < 2
        else tuple(sorted(labels.items())),
        tuple(_canon_container(c) for c in pod.containers),
        tuple(_canon_volume(v) for v in pod.volumes) if pod.volumes else (),
        pod.node_name,
        tuple(sel.items()) if len(sel) < 2 else tuple(sorted(sel.items())),
        _canon_affinity(pod.affinity),
        tuple(pod.tolerations) if pod.tolerations else (),
        pod.priority,
        pod.owner_kind,
        pod.owner_uid,
        pod.deleted,
    )


class ClassBatch:
    """Pending pods grouped into spec-equivalence classes.

    reps_batch  PodBatch over one representative pod per class (C rows)
    pod_class   int32 [P] — class index of each input pod
    pods        the original pod list (order preserved)
    """

    def __init__(self, pods: Sequence[Pod], snap: ClusterSnapshot, **kw):
        self.pods: List[Pod] = list(pods)
        index: Dict[tuple, int] = {}
        reps: List[Pod] = []
        pod_class = np.empty(len(self.pods), dtype=np.int32)
        for i, p in enumerate(self.pods):
            k = pod_class_key(p)
            c = index.get(k)
            if c is None:
                c = len(reps)
                index[k] = c
                reps.append(p)
            pod_class[i] = c
        self.reps: List[Pod] = reps
        self.pod_class = pod_class
        self.reps_batch = PodBatch(reps, snap, **kw)

    @property
    def num_classes(self) -> int:
        return len(self.reps)

    def mark_host_check_class(self, c: int) -> None:
        self.reps_batch.needs_host_check[c] = True

    def __len__(self) -> int:
        return len(self.pods)
