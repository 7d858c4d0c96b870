"""SLO burn-rate monitor: the engine notices its own p99
drifting before a human reads a PROFILE_r*.md.

Borg's SLO-driven operation is the model: an always-on service is
operated against an explicit objective, and the thing that pages is the
rate at which the ERROR BUDGET burns — not a raw threshold that flaps on
every slow minute. The objective here is the latency SLO the streaming
engine has carried since r10: a fraction ``target`` (default 99%) of
pods bind within ``budget_s`` (default the 250 ms micro-wave budget) of
first admission.

Mechanics (the multiwindow burn-rate discipline, SRE workbook ch.5):

- every bound pod's create->bound span is one observation — a span over
  budget consumes error budget, one under it does not. observe_batch
  rides the scheduler's existing per-wave latency list, so the SLO sees
  ALL pods, not the tracer's sampled subset;
- observations land in a preallocated ring of per-second buckets
  (good/bad counters + a bounded latency histogram per bucket), so
  memory is O(slow_window / bucket) regardless of offered rate and a
  scrape never walks samples;
- ``burn_fast`` / ``burn_slow`` = (bad fraction over the window) /
  (1 - target): burn 1.0 means exactly on budget, N means the budget
  burns N times too fast. The alert condition requires BOTH windows hot
  (fast >= alert_burn AND slow >= 1.0) — a single slow wave cannot
  page, a sustained regression cannot hide;
- alert state FLIPS are recorded on the flight-recorder ring
  (SLO_ALERT events) so the page lands on the same timeline as the
  waves that caused it, and counted in the span registry;
- ``p99_ms`` is the rolling fast-window p99 from the bucketed
  histograms (value resolution = the bucket ladder, ~sqrt(2) steps —
  an SLO gauge, not a bench number; the bench keeps its exact
  creator-stamped percentiles).

Served identically by HTTP ``/debug/slo``, the binary STATS verb and
``VerdictService.debug_snapshot`` (transport parity test-pinned), and
folded into every TelemetryRegistry snapshot as ``slo.*`` gauges.

Host-pure: observations are floats the scheduler already computed;
nothing here touches a device value (graftlint-pinned beside the
tracer).
"""

from __future__ import annotations

import os
import threading
from kubernetes_tpu_torch.analysis import lockcheck
import time
from typing import Dict, List, Optional

import numpy as np

from kubernetes_tpu_torch.observability import recorder as flightrec
from kubernetes_tpu_torch.observability.recorder import RECORDER


def _latency_edges() -> np.ndarray:
    # 1 ms .. ~23 s in sqrt(2) steps: fine enough that a p99 gauge moves
    # when the tail moves, coarse enough that a bucket row is 30 floats
    out = [0.001 * (2 ** (i / 2.0)) for i in range(30)]
    return np.asarray(out)


class SLOMonitor:
    """Rolling multiwindow latency-SLO engine over per-second buckets."""

    def __init__(self, budget_s: float = 0.0, target: float = 0.0,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 300.0, bucket_s: float = 1.0,
                 alert_burn: float = 10.0, now=time.monotonic,
                 recorder=RECORDER):
        if budget_s <= 0:
            budget_s = float(os.environ.get("GRAFT_SLO_BUDGET_MS",
                                            250.0)) / 1e3
        if target <= 0:
            target = float(os.environ.get("GRAFT_SLO_TARGET", 0.99))
        self.budget_s = float(budget_s)
        self.target = min(max(float(target), 0.5), 0.9999)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = max(float(slow_window_s), self.fast_window_s)
        self.bucket_s = max(float(bucket_s), 1e-3)
        self.alert_burn = float(alert_burn)
        self.enabled = False
        self._now = now
        self._recorder = recorder
        self._edges = _latency_edges()
        n = int(self.slow_window_s / self.bucket_s) + 2
        self._n = n
        self._good = np.zeros(n, dtype=np.int64)
        self._bad = np.zeros(n, dtype=np.int64)
        self._hist = np.zeros((n, len(self._edges) + 1), dtype=np.int64)
        self._epoch = np.full(n, -1, dtype=np.int64)  # bucket epoch held
        self._lock = lockcheck.make_lock("SLOMonitor._lock")
        self.alert = False
        self.alerts_total = 0

    # ------------------------------------------------------------ control

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._good[:] = 0
            self._bad[:] = 0
            self._hist[:] = 0
            self._epoch[:] = -1
            self.alert = False
            self.alerts_total = 0

    # ------------------------------------------------------------ observe

    def observe_batch(self, values: List[float],
                      t: Optional[float] = None) -> None:
        """One wave's worth of create->bound spans (seconds). Vectorized:
        one searchsorted + one slot update per call, at wave cadence."""
        if not values:
            return
        now = self._now() if t is None else t
        arr = np.asarray(values, dtype=np.float64)
        idx = np.searchsorted(self._edges, arr, side="left")
        binned = np.bincount(idx, minlength=len(self._edges) + 1)
        bad = int((arr > self.budget_s).sum())
        epoch = int(now / self.bucket_s)
        slot = epoch % self._n
        with self._lock:
            if self._epoch[slot] != epoch:
                self._good[slot] = 0
                self._bad[slot] = 0
                self._hist[slot] = 0
                self._epoch[slot] = epoch
            self._good[slot] += len(values) - bad
            self._bad[slot] += bad
            self._hist[slot] += binned
            self._update_alert_locked(epoch)

    # --------------------------------------------------------------- math

    def _window_mask_locked(self, epoch: int, window_s: float):
        w = max(int(window_s / self.bucket_s), 1)
        return (self._epoch > epoch - w) & (self._epoch <= epoch)

    def _burn_locked(self, epoch: int, window_s: float) -> float:
        m = self._window_mask_locked(epoch, window_s)
        good = int(self._good[m].sum())
        bad = int(self._bad[m].sum())
        total = good + bad
        if total == 0:
            return 0.0
        return (bad / total) / (1.0 - self.target)

    def _p99_locked(self, epoch: int, window_s: float) -> float:
        m = self._window_mask_locked(epoch, window_s)
        hist = self._hist[m].sum(axis=0)
        total = int(hist.sum())
        if total == 0:
            return 0.0
        cum = np.cumsum(hist)
        i = int(np.searchsorted(cum, max(int(0.99 * total), 1)))
        i = min(i, len(self._edges) - 1)
        return float(self._edges[i])

    def _update_alert_locked(self, epoch: int) -> None:
        fast = self._burn_locked(epoch, self.fast_window_s)
        slow = self._burn_locked(epoch, self.slow_window_s)
        hot = fast >= self.alert_burn and slow >= 1.0
        if hot == self.alert:
            return
        self.alert = hot
        if hot:
            self.alerts_total += 1
        from kubernetes_tpu_torch.utils.trace import COUNTERS
        COUNTERS.inc("slo.alert_enter" if hot else "slo.alert_exit")
        if self._recorder.enabled:
            self._recorder.record(flightrec.SLO_ALERT,
                                  a=1 if hot else 0,
                                  b=int(min(fast, 1e6) * 100))

    # ------------------------------------------------------------ reading

    def snapshot(self) -> Dict[str, float]:
        """The /debug/slo payload — identical on every transport, and
        the slo.* gauge fold of every TelemetryRegistry snapshot."""
        epoch = int(self._now() / self.bucket_s)
        with self._lock:
            mf = self._window_mask_locked(epoch, self.fast_window_s)
            ms = self._window_mask_locked(epoch, self.slow_window_s)
            return {
                "enabled": int(self.enabled),
                "budget_ms": round(self.budget_s * 1e3, 3),
                "target": self.target,
                "alert_burn": self.alert_burn,
                "p99_ms": round(self._p99_locked(
                    epoch, self.fast_window_s) * 1e3, 3),
                "burn_fast": round(self._burn_locked(
                    epoch, self.fast_window_s), 4),
                "burn_slow": round(self._burn_locked(
                    epoch, self.slow_window_s), 4),
                "fast_good": int(self._good[mf].sum()),
                "fast_bad": int(self._bad[mf].sum()),
                "slow_good": int(self._good[ms].sum()),
                "slow_bad": int(self._bad[ms].sum()),
                "alert": int(self.alert),
                "alerts_total": self.alerts_total,
            }


# process-wide monitor, disabled unless armed (the scheduler's bound
# paths guard on SLO.enabled — exact no-op off). GRAFT_SLO=1 arms at
# import; bench.py arms it with the tracer for the podtrace A/B arm.
SLO = SLOMonitor()

# the fast tier's own objective: latency-critical pods are
# operated against a 10 ms budget, not the bulk 250 ms — per-tier burn
# rates so a bulk backlog can't hide a fast-lane regression (and vice
# versa). Armed by the same GRAFT_SLO knob; folded as slo.fast.* and
# served under "fast" in every /debug/slo payload.
SLO_FAST = SLOMonitor(
    budget_s=float(os.environ.get("GRAFT_SLO_FAST_BUDGET_MS", 10.0)) / 1e3,
    target=float(os.environ.get("GRAFT_SLO_FAST_TARGET", 0.99)))

if os.environ.get("GRAFT_SLO", "0") == "1":
    SLO.enable()
    SLO_FAST.enable()


__all__ = ["SLO", "SLO_FAST", "SLOMonitor"]
