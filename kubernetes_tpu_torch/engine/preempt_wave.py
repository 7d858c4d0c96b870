"""Wave-path preemption: planning + disruption budgeting.

The classic host round (`Scheduler._preempt_round` over
engine/preemption.py) flushes the pipeline, builds O(total pods) arrays
per round, deletes victims best-effort, and leaves the preemptor to
reschedule whenever the DELETED events drain — the flush-everything
escape hatch. This module is the always-on form:

- ``plan_wave_preemptions`` narrows candidate nodes with ONE fused
  device dispatch over the snapshot's priority-band tensors
  (``SchedulingEngine.preempt_scan`` -> ops/preempt.victim_scan),
  then verifies candidates EXACTLY with the classic reprieve loop
  (``preemption._select_victims``) against a copy-on-write overlay of
  the live NodeInfos — multi-preemptor rounds reserve holes the way the
  classic round does, without cloning the whole cluster. Because the
  device mask is a proved superset of the classic pre-filter and the
  exact verification + node-choice ordering are shared code, plans are
  identical to the classic round's whenever the candidate set fits the
  exact-verification budget (the fuzz A/B in tests/test_preempt_wave.py
  pins it). PAST ``MAX_VERIFIED_CANDIDATES`` both paths truncate their
  exact phase — classic by exact ``tight_bounds`` over its narrower
  mask, the wave path by the device ``bound`` over its superset — and
  the truncated sets can differ: the same approximation class the
  reference's percentageOfNodesToScore accepts, traded deliberately
  (an exact bound would need the O(total pods) host build the device
  scan exists to kill).

- ``DisruptionBudget`` rate-limits the commits PodDisruptionBudget-
  style: a global max-evictions-per-minute sliding window plus optional
  per-band floors (a priority band must keep at least ``floor`` pods
  bound cluster-wide). Tiresias' lesson (PAPERS.md §Tiresias):
  preemption pays off only when its victim churn is bounded and
  measured — denied plans count ``engine.preempt_budget_deferred`` and
  the preemptor simply waits out its backoff.

The COMMIT itself lives in ``Scheduler._preempt_wave``: every plan goes
through the store's atomic evict+bind op, so partial preemptions are
impossible by construction (see apiserver_lite.preempt_pods_bulk).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.engine.preemption import (
    MAX_VERIFIED_CANDIDATES,
    PreemptionState,
    _select_victims,
)
from kubernetes_tpu_torch.observability import podtrace
from kubernetes_tpu_torch.observability.podtrace import TRACER


@dataclass
class WavePreemption:
    """One planned displacement: evict ``victims`` (lowest priority
    first) from ``node_name`` and bind ``pod`` there — committed
    atomically or not at all."""

    pod: Pod
    node_name: str
    victims: List[Pod] = field(default_factory=list)


def plan_wave_preemptions(engine, preemptors: List[Pod], *,
                          evictable: Optional[Callable[[Pod], bool]] = None,
                          workloads=(),
                          max_per_round: int = 128
                          ) -> List[WavePreemption]:
    """Plan displacements for a round of unschedulable preemptors.

    Highest priority first (ties keep input order, like the classic
    round's sort). Candidate nodes come from the device victim scan —
    or, when the band vocab overflowed, from the classic host pre-filter
    — and every candidate is verified exactly against the round's
    copy-on-write overlay, so plan k+1 sees plan k's reservations.
    The engine's snapshot must be refreshed (the harvest that produced
    the preemptors already did)."""
    from kubernetes_tpu_torch.ops.oracle_ext import SchedulingContext
    from kubernetes_tpu_torch.utils.trace import COUNTERS

    cands = [p for p in preemptors if p.priority > 0]
    if not cands:
        return []
    order = sorted(range(len(cands)), key=lambda i: -cands[i].priority)
    cands = [cands[i] for i in order][:max_per_round]
    snap = engine.snapshot
    names = snap.node_names
    if not names:
        return []
    # copy-on-write overlay over the LIVE infos: reads are free, a
    # chosen node is cloned once — never the O(total pods) wholesale
    # clone the classic round pays
    view: Dict[str, object] = dict(engine.cache.node_infos())
    ctx = SchedulingContext(
        view, list(workloads),
        hard_pod_affinity_weight=engine.hard_pod_affinity_weight,
        volume_ctx=engine.volume_ctx,
        policy_algos=engine.policy_algos)
    scan = engine.preempt_scan(cands)
    host_state = None
    if scan is None:
        # band-vocab overflow / bands unavailable: the exact host
        # pre-filter (one O(total pods) build per round, classic shape)
        host_state = PreemptionState(view)
        COUNTERS.inc("engine.preempt_scan_host_fallback")
    n_real = len(names)
    name_index = snap.node_index
    touched: set = set()
    plans: List[WavePreemption] = []
    # per-class verification memo: a burst of same-class preemptors (the
    # overcommit storm shape — hundreds of one band) re-verifies only
    # the nodes this round's plans TOUCHED; untouched nodes' victim sets
    # are state-deterministic and reused. Exact only when nothing
    # couples nodes (pod affinity makes node j's feasibility depend on
    # node i's residents; workloads/Policy algos likewise) — gated off
    # wholesale then, falling back to the classic per-candidate cost.
    from kubernetes_tpu_torch.ops.affinity import _has_affinity
    from kubernetes_tpu_torch.state.classes import pod_class_key
    memo_ok = (not workloads
               and (engine.policy_algos is None
                    or not engine.policy_algos.active)
               and not any(getattr(i, "pods_with_affinity", None)
                           for i in view.values()))
    vmemo: Dict[tuple, Dict[int, Optional[tuple]]] = {}
    for k, pod in enumerate(cands):
        if scan is not None:
            cand_np, bound_np, class_of = scan
            row = cand_np[class_of[k]][:n_real]
            cand_idx = np.flatnonzero(row)
            bounds = bound_np[class_of[k]]
        else:
            mask = host_state.candidate_mask(pod)
            cand_idx = np.flatnonzero(mask[:n_real])
            bounds = None
        if len(cand_idx) > MAX_VERIFIED_CANDIDATES:
            if bounds is None:
                bounds = host_state.tight_bounds(pod)
            rk = np.argsort(bounds[cand_idx], kind="stable")
            cand_idx = cand_idx[rk][:MAX_VERIFIED_CANDIDATES]
        # node choice == classic pickOneNodeForPreemption: the classic
        # round verifies every candidate and keeps the first strictly-
        # smaller key, i.e. min over ((key), node index). Verifying in
        # device-BOUND-ascending order lets us stop early: bound[n] is a
        # LOWER bound on node n's achievable max-victim-priority (the
        # over-approximated freeable can only flatter it), so once every
        # remaining candidate's bound exceeds the best key's first
        # component, none can win — candidates tied on that component
        # all have bound <= it and were already verified, so the choice
        # is exactly the classic one.
        best = None  # ((key, node index), victims)
        node_memo = None
        if memo_ok and not _has_affinity(pod):
            node_memo = vmemo.setdefault(pod_class_key(pod), {})

        def _verify(i: int) -> None:
            nonlocal best
            res = node_memo.get(i, False) if node_memo is not None \
                else False
            if res is False:
                info = view.get(names[i])
                if info is None:
                    res = None
                else:
                    victims = _select_victims(pod, info, ctx=ctx,
                                              evictable=evictable)
                    res = None if not victims else (
                        (max(v.priority for v in victims),
                         sum(v.priority for v in victims),
                         len(victims)), victims)
                if node_memo is not None:
                    node_memo[i] = res
            if res is None:
                return
            key = (res[0], i)
            if best is None or key < best[0]:
                best = (key, res[1])

        # touched nodes first: their device rows predate this round's
        # reservations, so they are verified unconditionally against the
        # overlay (they are few — one per plan this round)
        for i in sorted(touched):
            if i < n_real:
                _verify(i)
        if scan is not None:
            order = cand_idx[np.argsort(bounds[cand_idx], kind="stable")]
            for i in order:
                i = int(i)
                if i in touched:
                    continue
                if best is not None and int(bounds[i]) > best[0][0][0]:
                    break
                _verify(i)
        else:
            for i in sorted(set(int(x) for x in cand_idx) - touched):
                _verify(i)
        if best is None:
            continue
        (_key, i), victims = best
        name = names[i]
        # reserve in the overlay: victims out, preemptor's request in —
        # the classic round's infos bookkeeping, copy-on-write
        clone = view[name].clone_shallow()
        for vic in victims:
            clone.remove_pod(vic)
        clone.add_pod(pod)
        view[name] = clone
        touched.add(int(name_index.get(name, i)))
        for nc in vmemo.values():  # node i moved: memoized victim sets
            nc.pop(i, None)        # for it are stale for every class
        if memo_ok and _has_affinity(pod):
            # an affinity-CARRYING preemptor just entered the overlay:
            # it couples nodes (its anti terms forbid OTHER nodes'
            # domains), so every memoized row is suspect from here on
            memo_ok = False
            vmemo.clear()
        ctx.infos = view
        ctx.invalidate()
        if host_state is not None:
            from kubernetes_tpu_torch.engine.preemption import PreemptionPlan
            host_state.apply_plan(
                PreemptionPlan(node_name=name, victims=victims), pod)
        plans.append(WavePreemption(pod=pod, node_name=name,
                                    victims=victims))
        if TRACER.enabled and victims:
            # pod-level black box: a planned victim visible
            # mid-requeue gets its PREEMPT_VICTIM stamp (host ints only;
            # the node row is the snapshot index already in hand)
            TRACER.batch_event(podtrace.PREEMPT_VICTIM,
                               [vic.key() for vic in victims],
                               a=name_index.get(name, -1))
    return plans


class DisruptionBudget:
    """PodDisruptionBudget-shaped rate limit on preemption evictions.

    ``max_evictions_per_min``: sliding 60 s window over COMMIT ATTEMPTS
    (an attempt whose evictions may have landed must consume budget even
    if the scheduler later treats it as rolled back — the at-most-once
    ambiguity cuts toward consuming). ``band_floor`` maps a priority
    value to the minimum number of pods of that band that must remain
    bound cluster-wide; a plan whose victims would breach any floor is
    denied whole (no partial trimming — the victim set is minimal for
    its node, trimming it would break the fit)."""

    WINDOW_S = 60.0

    def __init__(self, max_evictions_per_min: Optional[int] = 600,
                 band_floor: Optional[Dict[int, int]] = None,
                 now: Callable[[], float] = time.monotonic):
        self.max_evictions_per_min = max_evictions_per_min
        self.band_floor = dict(band_floor or {})
        self._now = now
        self._events: deque = deque()  # eviction instants in the window

    def _prune(self, now: float) -> None:
        cutoff = now - self.WINDOW_S
        ev = self._events
        while ev and ev[0] <= cutoff:
            ev.popleft()

    def window_evictions(self) -> int:
        """Evictions consumed inside the current sliding window."""
        self._prune(self._now())
        return len(self._events)

    def admit(self, victims: List[Pod],
              band_counts: Optional[Dict[int, int]] = None) -> bool:
        """Admit-and-consume for one plan's victim set; False = deferred
        (nothing consumed)."""
        now = self._now()
        self._prune(now)
        if self.max_evictions_per_min is not None \
                and len(self._events) + len(victims) \
                > self.max_evictions_per_min:
            return False
        if self.band_floor and band_counts is not None:
            per: Dict[int, int] = {}
            for v in victims:
                per[v.priority] = per.get(v.priority, 0) + 1
            for prio, n in per.items():
                floor = self.band_floor.get(prio)
                if floor is not None \
                        and band_counts.get(prio, 0) - n < floor:
                    return False
        self._events.extend([now] * len(victims))
        return True


__all__ = ["DisruptionBudget", "WavePreemption", "plan_wave_preemptions"]
