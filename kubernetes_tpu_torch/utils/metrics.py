"""Scheduler metrics: histograms with the reference's bucket layout.

Mirrors plugin/pkg/scheduler/metrics/metrics.go:31-55 — three latency
histograms (e2e scheduling, algorithm, binding) with exponential buckets
1ms..~16s (ExponentialBuckets(1000, 2, 15) microseconds), exported in
Prometheus text format via render() (scrape endpoint wired in server/).
"""

from __future__ import annotations

import bisect
import threading
from kubernetes_tpu_torch.analysis import lockcheck
from typing import Dict, List


def exponential_buckets(start: float, factor: float, count: int) -> List[float]:
    out = []
    v = start
    for _ in range(count):
        out.append(v)
        v *= factor
    return out


# seconds; matches 1000us * 2^k for k in 0..14 (metrics.go:38,46,54)
DEFAULT_BUCKETS = exponential_buckets(0.001, 2, 15)


class Histogram:
    # bound on retained sample-store entries (weighted tuples + chunk
    # elements + compacted reservoir points). The r10 always-on loop made
    # unbounded growth a real leak: create_to_bound appends one chunk per
    # WAVE forever — at 20k pods/s that is ~7 GB/hour of float64 samples.
    # Past the bound the store compacts to a weighted quantile reservoir
    # (RESERVOIR_MAX // 4 points at equal-mass ranks), bounding memory at
    # O(RESERVOIR_MAX) while percentile() stays exact below the bound and
    # rank-accurate to ~total/k above it (test-pinned on a known
    # distribution in tests/test_observability.py).
    RESERVOIR_MAX = 65536

    def __init__(self, name: str, help_text: str = "",
                 buckets: List[float] = None,
                 reservoir_max: int = 0):
        self.name = name
        self.help = help_text
        self.buckets = list(buckets or DEFAULT_BUCKETS)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        # (value, multiplicity) samples for percentiles in benches —
        # weighted so a 30k-pod batch round is one entry, not 30k appends.
        # observe_batch keeps its per-pod arrays as raw numpy chunks
        # instead (zero per-value Python objects on the drain hot path —
        # the r5 version built 30k (float, 1) tuples per round, a measured
        # slice of the 0.559->0.898s headline regression); percentile()
        # merges both stores plus the compacted reservoir.
        self._values: List[tuple] = []
        self._chunks: List = []
        self._res_vals = None   # compacted reservoir: sorted values
        self._res_wts = None    # ... and their (float) multiplicities
        self._points = 0        # retained entries across all three stores
        self._compactions = 0
        self.reservoir_max = int(reservoir_max) or self.RESERVOIR_MAX
        self._lock = lockcheck.make_lock("Histogram._lock")

    def observe(self, v: float) -> None:
        self.observe_many(v, 1)

    def _observe_locked(self, v: float, n: int) -> None:
        lockcheck.assert_held(self._lock, "_observe_locked")
        i = bisect.bisect_left(self.buckets, v)
        self._counts[i] += n
        self._sum += v * n
        self._count += n
        self._values.append((v, n))
        self._points += 1
        if self._points > self.reservoir_max:
            self._compact_locked()

    def observe_many(self, v: float, n: int) -> None:
        """Record n observations of the same value (one lock, one append) —
        the batch rounds observe whole-round spans per pod."""
        if n <= 0:
            return
        with self._lock:
            self._observe_locked(v, n)

    def observe_batch(self, values: List[float]) -> None:
        """Record a round's worth of DISTINCT per-pod values under one lock,
        vectorized — 30k individual observe() calls would pay 30k lock
        round-trips and bisects on the hot drain path."""
        if not values:
            return
        import numpy as np
        arr = np.asarray(values, dtype=np.float64)
        # bisect_left semantics == searchsorted 'left'
        idx = np.searchsorted(np.asarray(self.buckets), arr, side="left")
        binned = np.bincount(idx, minlength=len(self.buckets) + 1)
        with self._lock:
            for i, c in enumerate(binned):
                self._counts[i] += int(c)
            self._sum += float(arr.sum())
            self._count += len(values)
            self._chunks.append(arr)
            self._points += len(arr)
            if self._points > self.reservoir_max:
                self._compact_locked()

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def totals(self):
        """(count, sum) read under the lock — the telemetry registry's
        torn-read-free accessor (count and sum advance together under
        observe; reading the properties separately could tear)."""
        with self._lock:
            return self._count, self._sum

    @property
    def stored_points(self) -> int:
        """Retained sample-store entries — what the bounded-growth test
        pins (memory is O(stored_points), never O(count))."""
        with self._lock:
            return self._points

    def _merged_locked(self):
        """All three stores as (sorted values, aligned weights), or None
        when empty. Read-time cost only — never on the observe path."""
        import numpy as np
        vparts, wparts = [], []
        if self._res_vals is not None:
            vparts.append(self._res_vals)
            wparts.append(self._res_wts)
        if self._values:
            vparts.append(np.array([v for v, _ in self._values],
                                   dtype=np.float64))
            wparts.append(np.array([n for _, n in self._values],
                                   dtype=np.float64))
        for c in self._chunks:
            vparts.append(c)
            wparts.append(np.ones(len(c)))
        if not vparts:
            return None
        v = np.concatenate(vparts)
        w = np.concatenate(wparts)
        order = np.argsort(v, kind="stable")
        return v[order], w[order]

    def _compact_locked(self) -> None:
        """Fold every retained sample into a bounded weighted reservoir:
        k points at equal-mass ranks (stratum centers), stratum masses as
        weights — total mass preserved exactly, rank error per later
        percentile() bounded by ~total/k per compaction."""
        lockcheck.assert_held(self._lock, "_compact_locked")
        import numpy as np
        merged = self._merged_locked()
        self._values = []
        self._chunks = []
        if merged is None:
            self._res_vals = self._res_wts = None
            self._points = 0
            return
        v, w = merged
        k = max(self.reservoir_max // 4, 16)
        if len(v) <= k:
            self._res_vals, self._res_wts = v, w
            self._points = len(v)
            return
        cum = np.cumsum(w)
        total = cum[-1]
        centers = (np.arange(k) + 0.5) * (total / k)
        idx = np.minimum(np.searchsorted(cum, centers, side="right"),
                         len(v) - 1)
        edges = np.arange(1, k) * (total / k)
        self._res_vals = v[idx]
        self._res_wts = np.diff(np.concatenate([[0.0], edges, [total]]))
        self._points = k
        self._compactions += 1

    def percentile(self, p: float) -> float:
        """Percentile over the merged stores: exact while the sample
        store is under the reservoir bound (rank semantics identical to
        the pre-r15 two-pointer walk), rank-accurate to ~total/k once
        compaction has folded history into the weighted reservoir."""
        import numpy as np
        with self._lock:
            merged = self._merged_locked()
            if merged is None:
                return 0.0
            v, w = merged
            cum = np.cumsum(w)
            total = cum[-1]
            if total <= 0:
                return 0.0
            target = min(int(p / 100.0 * total), total - 1)
            i = int(np.searchsorted(cum, target, side="right"))
            return float(v[min(i, len(v) - 1)])

    def render(self) -> str:
        with self._lock:
            lines = [f"# HELP {self.name} {self.help}",
                     f"# TYPE {self.name} histogram"]
            cum = 0
            for b, c in zip(self.buckets, self._counts):
                cum += c
                lines.append(f'{self.name}_bucket{{le="{b}"}} {cum}')
            lines.append(f'{self.name}_bucket{{le="+Inf"}} {self._count}')
            lines.append(f"{self.name}_sum {self._sum}")
            lines.append(f"{self.name}_count {self._count}")
            return "\n".join(lines)


class Counter:
    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._v = 0
        self._lock = lockcheck.make_lock("Counter._lock")

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._v

    def render(self) -> str:
        with self._lock:
            return (f"# HELP {self.name} {self.help}\n"
                    f"# TYPE {self.name} counter\n{self.name} {self._v}")


class SchedulerMetrics:
    """The scheduler's metric set (metrics.go:31-66)."""

    def __init__(self):
        self.e2e_latency = Histogram(
            "scheduler_e2e_scheduling_latency_seconds",
            "E2e scheduling latency (scheduling algorithm + binding)")
        self.algorithm_latency = Histogram(
            "scheduler_scheduling_algorithm_latency_seconds",
            "Scheduling algorithm latency")
        self.binding_latency = Histogram(
            "scheduler_binding_latency_seconds", "Binding latency")
        # NOT in the reference's metric set: per-pod first-queued ->
        # bind-complete, queue wait included. The batch engine amortizes
        # compute across a round, so the three span histograms above are
        # round-constant within a round; this one is the honest per-pod
        # distribution the pod-startup SLO reads (e2e framework
        # metrics_util.go:46 5s p99 pod startup, minus the kubelet leg)
        self.create_to_bound = Histogram(
            "scheduler_pod_create_to_bound_seconds",
            "Pod first seen unscheduled to bind-complete, per pod")
        self.scheduled = Counter("scheduler_pods_scheduled_total",
                                 "Pods successfully bound")
        self.failed = Counter("scheduler_pods_failed_total",
                              "Pods that failed scheduling")

    def render(self) -> str:
        return "\n".join(m.render() for m in (
            self.e2e_latency, self.algorithm_latency, self.binding_latency,
            self.create_to_bound, self.scheduled, self.failed))
