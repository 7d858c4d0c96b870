"""FlightRecorder: a bounded, preallocated ring of typed per-wave events.

Every PROFILE_r*.md since r06 has been hand-built attribution — the r13
churn dip needed a same-box HEAD-vs-PR A/B to blame box contention, the
r14 8-device p99 swing shipped as an "honesty data point" because
nothing recorded where a wave's milliseconds went. Borg's operability
rests on every task self-publishing health for introspection; Sparrow's
evaluation hinges on per-task latency decomposition (PAPERS.md). The
always-on engine gets both built in: the hot paths emit one typed event
per WAVE (never per pod) into a preallocated ring, and the exporter in
``perfetto.py`` renders the ring as a loadable timeline.

Cost model — the reason this can stay armed in production:

- OFF (the default): emit sites guard on ``RECORDER.enabled`` — one
  attribute load and a branch; ``record()`` is never called, no clock
  is read, nothing allocates. Exact no-op.
- ON: one uncontended lock acquire + six scalar writes into
  preallocated numpy arrays per event, at wave cadence (tens of events
  per second at the 20k pods/s headline). bench.py measures this as a
  recorder-on/off A/B on the arrival headline (telemetry_overhead_pct
  in the BENCH artifact) instead of asserting it.

The recorder is HOST-side pure: events carry monotonic timestamps and
host ints already in hand — it never touches a device value (fetching
one to "log" it would be exactly the GL002 hidden-sync hazard; the
graftlint fixture pins that the shipped shape stays silent and a
fetching variant fires).

Event kinds (the per-wave vocabulary of the pipelined engine):

    DISPATCH    one wave admitted + its fused eval launched async.
                wave=id, a=pods admitted, b=gangs riding; dur=dispatch
                host span (encode reuse, patch flush, upload).
    HARVEST     one wave's device→host sync + fence + assume. wave=id,
                a=pods bound, b=pods fenced (capacity+liveness);
                t stamps the device-block START, dur=the residual
                device block (pipeline.device_block) — so t+dur is the
                device-eval lane's right edge.
    FENCE_REQUEUE  the fence threw rows back. a=capacity conflicts,
                b=liveness requeues.
    PATCH       Protean delta invalidation absorbed churn into the
                cached encoding. a=foreign rows patched, b=label rows.
    BIND_FLUSH  one bulk bind write. wave=id (-1 on the classic
                round), a=pods bound, b=bind errors; dur=write span.
    DEGRADED    streaming loop mode transition. a=1 enter / 0 exit,
                b=breach streak at the flip.
    CHURN_OP    one injected churn op applied (testing/churn.py).
                a=op-kind code (CHURN_OP_CODES), b=1.
    PREEMPT_PROPOSE  one wave-path preemption round planned.
                wave=the harvested wave that surfaced the preemptors,
                a=preemptors considered, b=plans produced; dur=the
                planning span (device victim scan + exact verify).
    PREEMPT_COMMIT   one plan committed atomically at the store.
                wave=id, a=victims evicted, b=node row of the bind;
                dur=propose -> commit-complete (the preemption latency
                sample the bench percentiles).
    PREEMPT_ROLLBACK one plan refused/errored — nothing of it binds.
                wave=id, a=victims planned, b=1 when the error was the
                landed-timeout ambiguity's injected shape (0 plain).
    VICTIM_REQUEUE   a commit's victims re-entered the pending pool.
                wave=id, a=victim count, b=lowest victim priority.
    SLO_ALERT   the SLO engine's multiwindow burn-rate alert flipped
                a=1 enter / 0 exit, b=fast-window burn rate
                x100 at the flip — the page lands on the same timeline
                as the waves that caused it.
    FASTLANE    one fast-lane pod bound through the sampled-eval path
                wave=-1 (the fast lane rides between
                waves), a=attempts used (1 = first sample won the
                fence), b=1 device eval / 0 host twin; dur=pop ->
                bind-complete — the sub-10 ms span itself.
"""

from __future__ import annotations

import os
import threading
from kubernetes_tpu_torch.analysis import lockcheck
import time
from typing import Dict, List

import numpy as np

# ------------------------------------------------------------ event kinds

DISPATCH = 0
HARVEST = 1
FENCE_REQUEUE = 2
PATCH = 3
BIND_FLUSH = 4
DEGRADED = 5
CHURN_OP = 6
PREEMPT_PROPOSE = 7
PREEMPT_COMMIT = 8
PREEMPT_ROLLBACK = 9
VICTIM_REQUEUE = 10
SLO_ALERT = 11
FASTLANE = 12

KIND_NAMES = ("dispatch", "harvest", "fence_requeue", "patch",
              "bind_flush", "degraded", "churn_op", "preempt_propose",
              "preempt_commit", "preempt_rollback", "victim_requeue",
              "slo_alert", "fastlane")

# churn-op kind -> small int for the CHURN_OP event's `a` field
CHURN_OP_CODES = {"kill": 0, "respawn": 1, "flap_down": 2, "flap_up": 3,
                  "cordon": 4, "uncordon": 5, "relabel": 6, "evict": 7}
CHURN_OP_NAMES = {v: k for k, v in CHURN_OP_CODES.items()}


class FlightRecorder:
    """Bounded ring of typed per-wave events, preallocated up front.

    Storage is six parallel numpy arrays (kind/wave/t0/dur/a/b) written
    under one lock — no allocation, no dict, no string per event. The
    ring overwrites oldest-first past ``capacity``; ``dropped`` counts
    what the window lost (never silent truncation)."""

    __slots__ = ("capacity", "enabled", "_lock", "_kind", "_wave", "_t0",
                 "_dur", "_a", "_b", "_total", "_wave_seq")

    def __init__(self, capacity: int = 0):
        if capacity <= 0:
            capacity = int(os.environ.get("GRAFT_FLIGHT_CAPACITY", 65536))
        self.capacity = max(int(capacity), 8)
        self.enabled = False
        self._lock = lockcheck.make_lock("FlightRecorder._lock")
        self._kind = np.zeros(self.capacity, dtype=np.int8)
        self._wave = np.zeros(self.capacity, dtype=np.int64)
        self._t0 = np.zeros(self.capacity, dtype=np.float64)
        self._dur = np.zeros(self.capacity, dtype=np.float64)
        self._a = np.zeros(self.capacity, dtype=np.int64)
        self._b = np.zeros(self.capacity, dtype=np.int64)
        self._total = 0
        self._wave_seq = 0

    # ------------------------------------------------------------ control

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._total = 0
            self._wave_seq = 0

    # ------------------------------------------------------------- record

    def next_wave(self) -> int:
        """Allocate a monotonically increasing wave id (dispatch calls
        this once per wave; harvest/bind-flush reference it)."""
        with self._lock:
            self._wave_seq += 1
            return self._wave_seq

    def record(self, kind: int, wave: int = -1, t0: float = 0.0,
               dur: float = 0.0, a: int = 0, b: int = 0) -> None:
        """Append one event. Callers pass timestamps they already hold
        (``time.monotonic`` is the ring's one timebase); when ``t0`` is
        0.0 the record instant is stamped here."""
        if t0 == 0.0:
            t0 = time.monotonic()
        with self._lock:
            i = self._total % self.capacity
            self._kind[i] = kind
            self._wave[i] = wave
            self._t0[i] = t0
            self._dur[i] = dur
            self._a[i] = a
            self._b[i] = b
            self._total += 1

    # ------------------------------------------------------------ reading

    def snapshot(self, last: int = 0) -> List[Dict]:
        """The ring's events as dicts, oldest→newest; ``last`` bounds the
        tail (0 = everything retained)."""
        with self._lock:
            n = min(self._total, self.capacity)
            start = self._total - n
            if last and last < n:
                start = self._total - last
                n = last
            idx = np.arange(start, start + n) % self.capacity
            kinds = self._kind[idx]
            waves = self._wave[idx]
            t0s = self._t0[idx]
            durs = self._dur[idx]
            a_s = self._a[idx]
            b_s = self._b[idx]
        return [{"kind": KIND_NAMES[int(k)], "wave": int(w),
                 "t": float(t), "dur": float(d), "a": int(a), "b": int(b)}
                for k, w, t, d, a, b in zip(kinds, waves, t0s, durs,
                                            a_s, b_s)]

    def stats(self) -> Dict[str, int]:
        """Ring health for the telemetry registry: totals, window loss,
        and the wave-id high-water mark."""
        with self._lock:
            return {"events": self._total,
                    "dropped": max(self._total - self.capacity, 0),
                    "capacity": self.capacity,
                    "enabled": int(self.enabled),
                    "wave_seq": self._wave_seq}


# process-wide ring, disabled unless armed: the emit sites in the
# engine/streaming/bind paths all guard on RECORDER.enabled.
# GRAFT_FLIGHT_RECORDER=1 arms it at import (the CLI and ad-hoc
# debugging knob; bench.py flips it programmatically for the A/B).
RECORDER = FlightRecorder()
if os.environ.get("GRAFT_FLIGHT_RECORDER", "0") == "1":
    RECORDER.enable()


__all__ = ["BIND_FLUSH", "CHURN_OP", "CHURN_OP_CODES", "CHURN_OP_NAMES",
           "DEGRADED", "DISPATCH", "FASTLANE", "FENCE_REQUEUE",
           "FlightRecorder",
           "HARVEST", "KIND_NAMES", "PATCH", "PREEMPT_COMMIT",
           "PREEMPT_PROPOSE", "PREEMPT_ROLLBACK", "RECORDER",
           "SLO_ALERT", "VICTIM_REQUEUE"]
