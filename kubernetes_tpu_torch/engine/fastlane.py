"""Sparrow fast lane: a sub-10 ms admission tier beside the bulk waves.

The streaming engine's 250 ms budget is a THROUGHPUT budget: a pod waits
for a micro-wave quantum to fill, rides a [C, N] fused eval, and binds in
a bulk flush. A latency-critical pod (serving sidecar, scale-up replica
mid-spike) needs none of that machinery and can't afford any of it. This
module is the Sparrow answer (PAPERS.md §Sparrow — batch sampling + late
binding) grafted onto the resident state the wave engine already keeps:

- **power-of-k-choices sampling**: draw k (~16) node rows weighted toward
  CPU headroom from the snapshot's cached ``headroom_view`` — O(k) host
  work against arrays that already exist;
- **one tiny eval**: score exactly those k rows with
  ``ops.fastlane.sample_eval`` — a [1, k] gather-eval against the
  RESIDENT device snapshot (no encoding build, no vocab work, compiled
  once per shape) — or its bit-equal numpy twin when a bulk wave owns
  the device (the CPU backend runs device programs FIFO, so a dispatch
  behind an in-flight wave would inherit the wave's whole latency);
- **late binding through the fence**: the sampled score is advisory; the
  winner is re-validated against LIVE cache truth (doomed notes first,
  then liveness/capacity/ports — the same checks the wave harvest and
  the extender's _bind_fence apply) and assumed through the cache's
  double-claim guard, so wave-path correctness and the exactly-once
  ledger are untouched. A fence loss resamples with jitter (the rng
  advances, so retries draw different nodes); after bounded retries the
  pod falls back to the wave path and is never lost.

Eligibility is deliberately narrow (``eligible``): latency-critical AND
"simple" — no affinity, no selector, no tolerations, no host ports, no
volumes, no gang, no extended resources, not pre-bound. Everything the
[1, k] kernel doesn't model is excluded by construction, and one
cluster-wide gate handles the k8s-1.8 symmetry trap: an EXISTING pod's
anti-affinity can forbid a new plain pod, so the fast lane only runs
while ``cache.affinity_pod_count() == 0`` — otherwise pods take the wave
path, which models affinity exactly.

Outcome accounting partitions every fast pod exactly once:
``fastlane.bound`` + ``fastlane.fell_back`` + ``fastlane.bind_error`` +
``fastlane.superseded`` == fast pods popped; ``fastlane.resampled``
counts fence/no-fit retries within attempts (not pods).
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Optional, Tuple

import numpy as np

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.engine import gang as gangmod
from kubernetes_tpu_torch.observability import recorder as flightrec
from kubernetes_tpu_torch.observability.podtrace import (
    FAST_DISPATCHED,
    TRACER,
)
from kubernetes_tpu_torch.observability.recorder import RECORDER
from kubernetes_tpu_torch.observability.slo import SLO_FAST
from kubernetes_tpu_torch.ops import oracle
from kubernetes_tpu_torch.ops.fastlane import (
    FAST_NODE_KEYS,
    sample_eval,
    sample_eval_host,
)
from kubernetes_tpu_torch.utils.trace import COUNTERS

# the annotation contract: "scheduling.k8s.io/latency-critical" = "true"
# routes a pod to the fast tier; alternatively any priority at or above
# the band floor (GRAFT_FASTLANE_PRIO) qualifies — both knobs documented
# in README "Latency tiers"
FASTLANE_ANNOTATION = "scheduling.k8s.io/latency-critical"

DEFAULT_K = int(os.environ.get("GRAFT_FASTLANE_K", 16))
DEFAULT_RETRIES = int(os.environ.get("GRAFT_FASTLANE_RETRIES", 3))
FAST_PRIO = int(os.environ.get("GRAFT_FASTLANE_PRIO", 2_000_000_000))


def is_latency_critical(pod: Pod) -> bool:
    """The tier contract: explicit annotation, or priority at/above the
    fast band floor."""
    v = pod.annotations.get(FASTLANE_ANNOTATION, "")
    if v in ("true", "1"):
        return True
    return pod.priority >= FAST_PRIO


def eligible(pod: Pod) -> bool:
    """Latency-critical AND simple enough for the [1, k] kernel. Anything
    here that returns False takes the bulk wave path, which models the
    full predicate set exactly — the fast lane never approximates, it
    declines."""
    if not is_latency_critical(pod):
        return False
    if pod.node_name:  # pre-bound / PodFitsHost constrained
        return False
    if pod.affinity is not None or pod.node_selector:
        return False
    if pod.tolerations:  # kernel assumes toleration-free (any-taint fails)
        return False
    if pod.volumes:
        return False
    if gangmod.gang_name(pod) is not None:
        return False
    if pod.used_ports():
        return False
    for c in pod.containers:
        for k in c.requests:
            if k not in ("cpu", "memory", "nvidia.com/gpu",
                         "storage.kubernetes.io/scratch",
                         "storage.kubernetes.io/overlay"):
                return False  # extended resource: vocab-dependent row
    return True


class FastLane:
    """Per-scheduler fast-lane executor. Owned and driven by the
    streaming loop between micro-waves; everything it touches is either
    resident host state or the one sampled eval."""

    # a fast pod seen within this window keeps the harvest-overlap poll
    # alive (ScheduleLoop polls for fast arrivals while blocked on a
    # wave); outside it the loop reverts to the exact r18 step shape
    HOT_WINDOW_S = 1.0

    def __init__(self, scheduler, k: int = 0, retries: int = -1,
                 seed: int = 0x5bdd):
        self.s = scheduler
        self.engine = scheduler.engine
        self.cache = scheduler.cache
        self.queue = scheduler.queue
        self.k = k or DEFAULT_K
        self.retries = retries if retries >= 0 else DEFAULT_RETRIES
        # seeded: resample jitter comes from the rng ADVANCING between
        # attempts, reproducibly — frozen-trace A/Bs stay deterministic
        self._rng = random.Random(seed)
        self._cum = None  # cached cumsum of headroom weights
        self._cum_version = -1
        self._seen = 0
        self._last_seen = 0.0

    # ------------------------------------------------------------ admission

    def classify(self, pod: Pod) -> bool:
        """The queue's fast_classifier: route + note activity (the
        streaming loop's poll gate keys on it)."""
        if not eligible(pod):
            return False
        self._seen += 1
        self._last_seen = time.monotonic()
        return True

    def hot(self) -> bool:
        """A fast pod was routed recently — worth polling for more while
        a wave blocks. False forever if none ever arrives, so the A/B
        with zero latency-critical pods never takes a single extra
        branch of work."""
        return self._seen > 0 and \
            time.monotonic() - self._last_seen < self.HOT_WINDOW_S

    # ------------------------------------------------------------- sampling

    def _sample(self, snap) -> Optional[np.ndarray]:
        """k weighted draws (with replacement) from the headroom view —
        power-of-k-choices. Fixed k keeps the jitted eval at ONE compiled
        shape; duplicates are harmless (argmax picks one)."""
        weights, _ok = snap.headroom_view()
        if self._cum_version != snap.version or self._cum is None:
            self._cum = np.cumsum(weights)
            self._cum_version = snap.version
        cum = self._cum
        if cum.shape[0] == 0 or cum[-1] <= 0.0:
            return None  # no plausible row anywhere
        rng = self._rng
        total = float(cum[-1])
        draws = np.asarray([rng.random() for _ in range(self.k)]) * total
        idx = np.searchsorted(cum, draws, side="right")
        return np.minimum(idx, cum.shape[0] - 1).astype(np.int32)

    # ----------------------------------------------------------------- eval

    def _eval(self, idx: np.ndarray, req: np.ndarray, zero_req: bool,
              best_effort: bool, snap, device_ok: bool
              ) -> Tuple[np.ndarray, bool]:
        """Route the sampled eval: the resident DEVICE arrays when the
        device is idle and current, else the numpy twin (same verdicts,
        test-pinned). Never uploads, never refreshes — staleness is the
        fence's job."""
        dev = self.engine._device_nodes
        if device_ok and dev is not None \
                and self.engine._device_version == snap.version \
                and all(k in dev for k in FAST_NODE_KEYS):
            nodes = {k: dev[k] for k in FAST_NODE_KEYS}
            out = sample_eval(idx, req, zero_req, best_effort, nodes)
            res = np.asarray(out)  # graftlint: sync-ok
            COUNTERS.inc("fastlane.dispatch_device")
            return res, True
        nodes = {k: getattr(snap, k) for k in FAST_NODE_KEYS}
        COUNTERS.inc("fastlane.dispatch_host")
        return sample_eval_host(idx, req, zero_req, best_effort,
                                nodes), False

    # ---------------------------------------------------------------- fence

    def _fence(self, pod: Pod, node_name: str) -> Tuple[bool, str]:
        """Late-bind re-validation against LIVE truth — the wave
        harvest's fence discipline on a single node. Order matters:
        DOOMED notes first (a dying watch event not yet applied — the
        liveness fence extended to this path), then the
        _bind_fence liveness ladder, then exact capacity/ports, then the
        cluster-wide affinity gate (an existing pod's anti-affinity can
        forbid a plain pod — k8s 1.8 symmetry)."""
        if node_name in self.engine._doomed_nodes:
            return False, "doomed"
        info = self.cache.node_info(node_name)
        if info is None or info.node is None:
            return False, "gone"
        node = info.node
        if node.unschedulable:
            return False, "cordoned"
        if not oracle.check_node_condition(node):
            return False, "not_ready"
        fits, _fails = oracle.pod_fits_resources(pod, info)
        if not fits:
            return False, "capacity"
        if not oracle.pod_fits_host_ports(pod, info):
            return False, "ports"
        if self.cache.affinity_pod_count() > 0:
            return False, "affinity"
        return True, ""

    # --------------------------------------------------------------- commit

    def _commit(self, placed: Pod, pop_ts: float, t0: float,
                attempt: int, used_device: bool) -> bool:
        """Assume + bind + bookkeeping — the _complete_wave bind tail for
        one pod. Returns False only on the double-claim race (another
        path owns the key; the watch confirmation supersedes us)."""
        s = self.s
        try:
            self.cache.assume_pod(placed)
        except KeyError:
            # double-claim guard fired: a racing bind (wave row, foreign
            # scheduler) already owns this key — converge on the owner's
            # placement, exactly like the multiproc fence losers
            COUNTERS.inc("fastlane.superseded")
            return False
        self.engine.note_node_dirty(placed.node_name)
        tb0 = time.monotonic()
        errs = s._bind_bulk([placed])
        t_bind = time.monotonic() - tb0
        bound_pods, n_errors = s._finish_binds([placed], errs)
        if n_errors:
            # _finish_binds already forgot the assume + requeued with
            # backoff — the pod is safe on the wave path
            COUNTERS.inc("fastlane.bind_error")
            return True
        bind_done = time.monotonic()
        key = placed.key()
        s.cache.finish_bindings_bulk(bound_pods, keys=[key])
        s.metrics.scheduled.inc(1)
        s.metrics.binding_latency.observe_many(t_bind, 1)
        s.metrics.e2e_latency.observe_many(bind_done - pop_ts, 1)
        lat = bind_done - s._first_queued.pop(key, pop_ts)
        s.metrics.create_to_bound.observe_batch([lat])
        if SLO_FAST.enabled:
            # the fast tier burns against ITS OWN 10 ms objective — a
            # fast bind never lands in the bulk SLO windows (and vice
            # versa), so neither tier's backlog can hide the other's
            # regression
            SLO_FAST.observe_batch([lat], t=bind_done)
        if TRACER.enabled:
            TRACER.bound_batch([key], t0=bind_done)
        if RECORDER.enabled:
            RECORDER.record(flightrec.FASTLANE, t0=t0, dur=bind_done - t0,
                            a=attempt + 1, b=1 if used_device else 0)
        if s.wave_observer is not None:
            s.wave_observer(bind_done, [key])
        COUNTERS.inc("fastlane.bound")
        return True

    # ------------------------------------------------------------- schedule

    def schedule(self, pod: Pod, pop_ts: float, device_ok: bool = False
                 ) -> None:
        """One fast pod, pop to outcome: sample -> eval -> fence ->
        bind, resampling on fence loss, falling back to the wave path
        after bounded retries. Every path lands the pod somewhere — a
        fast pod is never dropped."""
        snap = self.engine.snapshot
        if snap._shape_sig is None:
            # cold start: no wave has primed the snapshot yet (a wave in
            # flight implies a refresh already ran, so this can't race
            # one). Prime it ONCE through the engine's own refresh; every
            # later fast pod reuses the resident arrays delta-free. A
            # stale snapshot between waves is fine — the fence re-checks
            # live truth, and persistent staleness self-heals because
            # fence losses fall back to the wave path, which refreshes.
            self.engine._refresh()
        if not snap.node_names or self.cache.affinity_pod_count() > 0:
            self._fallback(pod)
            return
        rr = pod.resource_request()
        req = snap.resource_row(
            milli_cpu=rr.milli_cpu, memory=rr.memory, gpu=rr.nvidia_gpu,
            scratch=rr.storage_scratch, overlay=rr.storage_overlay,
            extended={}, up=True, width=snap.num_resources)
        zero_req = (rr.milli_cpu == 0 and rr.memory == 0
                    and rr.nvidia_gpu == 0 and rr.storage_scratch == 0
                    and rr.storage_overlay == 0)
        best_effort = pod.is_best_effort()
        t0 = time.monotonic()
        key = pod.key()
        for attempt in range(self.retries + 1):
            idx = self._sample(snap)
            if idx is None:
                break
            res, used_device = self._eval(idx, req, zero_req, best_effort,
                                          snap, device_ok)
            if TRACER.enabled:
                TRACER.event(key, FAST_DISPATCHED,
                             a=0 if used_device else 1, b=attempt)
            fit_count = int(res[1])
            if fit_count == 0:
                COUNTERS.inc("fastlane.resampled")
                continue  # sampled set had no fit: jittered resample
            node_name = snap.node_names[int(idx[int(res[0])])]
            ok, reason = self._fence(pod, node_name)
            if not ok:
                COUNTERS.inc("fastlane.fence_" + reason)
                COUNTERS.inc("fastlane.resampled")
                continue
            placed = dataclasses.replace(pod, node_name=node_name)
            if self._commit(placed, pop_ts, t0, attempt, used_device):
                return
            return  # superseded: the racing owner's bind stands
        self._fallback(pod)

    def _fallback(self, pod: Pod) -> None:
        """Retries exhausted (or the lane can't serve this state): hand
        the pod to the wave path WITHOUT re-classification — add_bulk
        bypasses the fast classifier, so a fell-back pod cannot loop."""
        COUNTERS.inc("fastlane.fell_back")
        self.queue.add_bulk([pod])


__all__ = ["DEFAULT_K", "DEFAULT_RETRIES", "FASTLANE_ANNOTATION",
           "FAST_PRIO", "FastLane", "eligible", "is_latency_critical"]
