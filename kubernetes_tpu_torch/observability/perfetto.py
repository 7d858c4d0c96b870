"""Chrome trace-event (Perfetto) exporter for the flight recorder ring.

Renders the recorder's per-wave events as a timeline with three lanes —
the attribution profile_bench.py approximates with wrapped functions
becomes a picture you load in chrome://tracing or ui.perfetto.dev:

- **host** lane: per-wave dispatch spans (encode reuse, patch flush,
  upload) and bind-flush spans (the bulk write + result tail) — the
  host tail wave k+1's device time is supposed to hide.
- **device** lane: per-wave device-eval windows, reconstructed from the
  recorder's own stamps as [dispatch end → harvest block end]: the
  wave's asynchronous window, from the DISPATCH record's end (the
  engine's dispatch_waves) to the end of the HARVEST record's block
  (harvest_waves waiting on the wave worker). It bounds the card's busy
  time for the wave from above; it is not that busy time, which only a
  device profiler sees. With the pipeline two deep, wave k+1's device
  span visibly overlaps wave k's bind-flush on the host lane; in
  `overlap=False` debug mode the lanes serialize.
- **fence** lane: instant markers for fence requeues, Protean patches,
  degraded-mode transitions, churn ops and SLO-alert flips — the churn
  story lands on the same time axis as the waves it perturbed.

Flow arrows: every wave's dispatch → device-eval →
bind-flush chain carries Chrome flow events (``ph`` s/t/f with the wave
id), so following one wave across the host and device lanes is a click,
not a visual scan; the span events carry ``span_ms`` args alongside
their pod counts.

Pod lanes: ``add_pod_lanes`` renders the tracer's slowest-K
tail exemplars as one lane per pod — each consecutive-event delta drawn
as a phase span (the SAME labels as podtrace.decompose, so the picture
and the window aggregate can never disagree), wire hops and fence
requeues as instants.

Format: the Chrome trace-event JSON object form ({"traceEvents": [...]})
with "X" complete events for spans, "i" instants for markers, and "M"
metadata naming the process/threads. Timestamps are microseconds
relative to the first event (monotonic origin is arbitrary anyway).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from kubernetes_tpu_torch.observability import recorder as rec

PID = 1
TID_HOST = 1
TID_DEVICE = 2
TID_FENCE = 3
TID_PREEMPT = 4
TID_FASTLANE = 5

_THREADS = ((TID_HOST, "host"), (TID_DEVICE, "device"),
            (TID_FENCE, "fence"), (TID_PREEMPT, "preempt"),
            (TID_FASTLANE, "fastlane"))


def build_chrome_trace(events: List[Dict]) -> Dict:
    """Recorder snapshot (``RECORDER.snapshot()``) → Chrome trace dict."""
    out: List[Dict] = [
        {"ph": "M", "pid": PID, "name": "process_name",
         "args": {"name": "tpu-sched engine"}},
    ]
    for tid, name in _THREADS:
        out.append({"ph": "M", "pid": PID, "tid": tid,
                    "name": "thread_name", "args": {"name": name}})
    if not events:
        return {"traceEvents": out, "displayTimeUnit": "ms"}
    t_base = min(e["t"] for e in events)

    def us(t: float) -> float:
        return round((t - t_base) * 1e6, 1)

    # device lane windows need the dispatch/harvest pair per wave id;
    # the flow arrows (dispatch → device-eval → bind-flush of one wave)
    # need an anchor instant inside each span
    dispatch_end: Dict[int, float] = {}
    flow_anchor: Dict[int, List] = {}  # wave -> [(tid, ts_us), ...]
    for e in events:
        kind = e["kind"]
        if kind == "dispatch":
            dispatch_end[e["wave"]] = e["t"] + e["dur"]
            out.append({"ph": "X", "pid": PID, "tid": TID_HOST,
                        "name": f"dispatch w{e['wave']}",
                        "ts": us(e["t"]), "dur": round(e["dur"] * 1e6, 1),
                        "args": {"pods": e["a"], "gangs": e["b"],
                                 "span_ms": round(e["dur"] * 1e3, 3)}})
            flow_anchor.setdefault(e["wave"], []).append(
                (TID_HOST, us(e["t"])))
        elif kind == "harvest":
            block_end = e["t"] + e["dur"]
            start = dispatch_end.get(e["wave"], e["t"])
            out.append({"ph": "X", "pid": PID, "tid": TID_DEVICE,
                        "name": f"device-eval w{e['wave']}",
                        "ts": us(start),
                        "dur": max(round((block_end - start) * 1e6, 1),
                                   0.1),
                        "args": {"bound": e["a"], "fenced": e["b"],
                                 "span_ms": round((block_end - start)
                                                  * 1e3, 3),
                                 "residual_block_ms":
                                     round(e["dur"] * 1e3, 3)}})
            flow_anchor.setdefault(e["wave"], []).append(
                (TID_DEVICE, us(start)))
        elif kind == "bind_flush":
            out.append({"ph": "X", "pid": PID, "tid": TID_HOST,
                        "name": f"bind-flush w{e['wave']}"
                        if e["wave"] >= 0 else "bind-flush (classic)",
                        "ts": us(e["t"]), "dur": round(e["dur"] * 1e6, 1),
                        "args": {"bound": e["a"], "bind_errors": e["b"],
                                 "span_ms": round(e["dur"] * 1e3, 3)}})
            if e["wave"] >= 0:
                flow_anchor.setdefault(e["wave"], []).append(
                    (TID_HOST, us(e["t"])))
        elif kind == "fence_requeue":
            if e["wave"] < 0:
                # wire fence conflict: no wave owns it — a
                # remote scheduler process raced the bind fence and
                # lost; b carries the typed reason code
                from kubernetes_tpu_torch.observability import podtrace as pt
                rn = pt.REASON_NAMES[e["b"]] \
                    if 0 <= e["b"] < len(pt.REASON_NAMES) else str(e["b"])
                out.append({"ph": "i", "pid": PID, "tid": TID_FENCE,
                            "s": "t", "name": f"fence-conflict:{rn}",
                            "ts": us(e["t"]),
                            "args": {"conflicts": e["a"],
                                     "reason": rn}})
            else:
                out.append({"ph": "i", "pid": PID, "tid": TID_FENCE,
                            "s": "t",
                            "name": f"fence-requeue w{e['wave']}",
                            "ts": us(e["t"]),
                            "args": {"conflicts": e["a"],
                                     "liveness": e["b"]}})
        elif kind == "patch":
            out.append({"ph": "i", "pid": PID, "tid": TID_FENCE, "s": "t",
                        "name": "patch", "ts": us(e["t"]),
                        "args": {"foreign_rows": e["a"],
                                 "label_rows": e["b"]}})
        elif kind == "degraded":
            out.append({"ph": "i", "pid": PID, "tid": TID_FENCE, "s": "p",
                        "name": "degraded-enter" if e["a"]
                        else "degraded-exit",
                        "ts": us(e["t"]),
                        "args": {"breach_streak": e["b"]}})
        elif kind == "churn_op":
            out.append({"ph": "i", "pid": PID, "tid": TID_FENCE, "s": "t",
                        "name": "churn:" + rec.CHURN_OP_NAMES.get(
                            e["a"], str(e["a"])),
                        "ts": us(e["t"]), "args": {}})
        elif kind == "preempt_propose":
            # victim selection as a SPAN on its own lane: the
            # device scan + exact verify shows on the timeline next to
            # the harvest that surfaced the preemptors
            out.append({"ph": "X", "pid": PID, "tid": TID_PREEMPT,
                        "name": f"victim-select w{e['wave']}",
                        "ts": us(e["t"]), "dur": round(e["dur"] * 1e6, 1),
                        "args": {"preemptors": e["a"], "plans": e["b"]}})
        elif kind == "preempt_commit":
            out.append({"ph": "X", "pid": PID, "tid": TID_PREEMPT,
                        "name": f"preempt-commit w{e['wave']}",
                        "ts": us(e["t"]), "dur": round(e["dur"] * 1e6, 1),
                        "args": {"victims": e["a"], "node_row": e["b"]}})
        elif kind == "preempt_rollback":
            out.append({"ph": "i", "pid": PID, "tid": TID_PREEMPT,
                        "s": "t", "name": f"preempt-rollback w{e['wave']}",
                        "ts": us(e["t"]),
                        "args": {"victims_planned": e["a"],
                                 "landed_timeout": e["b"]}})
        elif kind == "victim_requeue":
            out.append({"ph": "i", "pid": PID, "tid": TID_PREEMPT,
                        "s": "t", "name": f"victim-requeue w{e['wave']}",
                        "ts": us(e["t"]),
                        "args": {"victims": e["a"],
                                 "lowest_priority": e["b"]}})
        elif kind == "fastlane":
            # one span per fast-lane pod, pop → bind-complete:
            # the sub-10ms tier gets its own lane so its spans read
            # against the micro-waves they threaded between; a is the
            # attempts consumed, b the eval route (1 device, 0 host twin)
            out.append({"ph": "X", "pid": PID, "tid": TID_FASTLANE,
                        "name": "fast-bind",
                        "ts": us(e["t"]), "dur": round(e["dur"] * 1e6, 1),
                        "args": {"attempts": e["a"],
                                 "eval": "device" if e["b"] else "host",
                                 "span_ms": round(e["dur"] * 1e3, 3)}})
        elif kind == "slo_alert":
            out.append({"ph": "i", "pid": PID, "tid": TID_FENCE, "s": "p",
                        "name": "slo-alert-enter" if e["a"]
                        else "slo-alert-exit",
                        "ts": us(e["t"]),
                        "args": {"burn_fast_x100": e["b"]}})
    # flow arrows: one chain per wave through its recorded stages, in
    # stage order (dispatch → device-eval → bind-flush). Chrome binds a
    # flow event to the slice enclosing (tid, ts), so each anchor is the
    # span's own start instant.
    for wave, anchors in sorted(flow_anchor.items()):
        if len(anchors) < 2:
            continue
        for i, (tid, ts) in enumerate(anchors):
            ph = "s" if i == 0 else ("f" if i == len(anchors) - 1
                                     else "t")
            ev = {"ph": ph, "pid": PID, "tid": tid, "cat": "wave",
                  "id": wave, "name": f"wave w{wave}", "ts": ts}
            if ph == "f":
                ev["bp"] = "e"
            out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


# pod-exemplar lane tids start far above the fixed lanes
TID_POD_BASE = 16

# scheduler-process lane tids: above the pod lanes (a trace with both
# keeps 240 pod exemplars before the ranges could meet)
TID_PROC_BASE = 256


def add_process_lanes(trace: Dict, workers: List[Dict],
                      base_tid: int = TID_PROC_BASE,
                      t_base: Optional[float] = None) -> Dict:
    """Append one lane per scheduler PROCESS to a built
    trace: a ``run_process_fleet`` worker result renders its binds and
    relists as spans and its fence conflicts as instant markers.

    ``t_base`` is the server RING's time origin (min event t of the
    main lanes): worker event stamps are CLOCK_MONOTONIC, which is
    system-wide on Linux, so with the ring's t_base each process lane
    aligns with the fence-conflict instants the shared cell recorded
    for it. Without it the lanes align against the earliest worker
    event (self-consistent across processes, but not ring-aligned).
    Returns the trace for chaining."""
    out = trace["traceEvents"]
    if t_base is None:
        t_base = min((ev["t"] for w in workers
                      for ev in w.get("events", ())), default=0.0)
    for lane, w in enumerate(workers):
        tid = base_tid + lane
        wid = w.get("worker", lane)
        c = w.get("counts", {})
        out.append({"ph": "M", "pid": PID, "tid": tid,
                    "name": "thread_name",
                    "args": {"name": f"sched-proc {wid} "
                                     f"({c.get('binds', 0)} binds, "
                                     f"{c.get('conflicts', 0)} "
                                     f"conflicts)"}})
        for ev in w.get("events", ()):
            ts = round((ev["t"] - t_base) * 1e6, 1)
            if ev["kind"] == "conflict":
                out.append({"ph": "i", "pid": PID, "tid": tid, "s": "t",
                            "name": "fence-conflict:"
                                    + ev.get("reason", "?"),
                            "ts": ts,
                            "args": {k: v for k, v in ev.items()
                                     if k not in ("kind", "t", "dur")}})
            else:  # bind / relist: work spans on the process timeline
                out.append({"ph": "X", "pid": PID, "tid": tid,
                            "name": ev["kind"], "ts": ts,
                            "dur": max(round(ev.get("dur", 0.0) * 1e6,
                                             1), 0.1),
                            "args": {k: v for k, v in ev.items()
                                     if k not in ("kind", "t", "dur")}})
    return trace


def add_pod_lanes(trace: Dict, exemplars: List[Dict],
                  base_tid: int = TID_POD_BASE,
                  t_base: Optional[float] = None) -> Dict:
    """Append one lane per tail-exemplar pod (podtrace snapshot
    ``exemplars`` entries) to a built trace: consecutive-event deltas as
    phase spans labeled EXACTLY like podtrace.decompose, instants for
    the zero-width stamps. ``t_base`` is the RING's time origin (the
    min event t the main lanes were rendered against) so a pod's lane
    aligns with the waves it actually crossed; without it the lanes
    align against the earliest exemplar instead (self-consistent, but
    not wave-aligned). Returns the trace for chaining."""
    from kubernetes_tpu_torch.observability import podtrace as pt
    kind_code = {nm: i for i, nm in enumerate(pt.KIND_NAMES)}
    out = trace["traceEvents"]
    if t_base is None:
        t_base = min((ex.get("t0", 0.0) for ex in exemplars),
                     default=0.0)
    for lane, ex in enumerate(exemplars):
        tid = base_tid + lane
        off_us = round((ex.get("t0", t_base) - t_base) * 1e6, 1)
        out.append({"ph": "M", "pid": PID, "tid": tid,
                    "name": "thread_name",
                    "args": {"name": f"pod {ex['key']} "
                                     f"({ex['span_ms']:.1f}ms)"}})
        evs = ex["events"]
        requeued = False
        for i in range(1, len(evs)):
            prev, cur = evs[i - 1], evs[i]
            pk = kind_code.get(prev["kind"], -1)
            ck = kind_code.get(cur["kind"], -1)
            ph = pt.phase_of(pk, ck, requeued)
            if ck == pt.FENCE_REQUEUED:
                requeued = True
            out.append({"ph": "X", "pid": PID, "tid": tid, "name": ph,
                        "ts": round(off_us + prev["t_ms"] * 1e3, 1),
                        "dur": max(round((cur["t_ms"] - prev["t_ms"])
                                         * 1e3, 1), 0.1),
                        "args": {"to": cur["kind"], "a": cur["a"],
                                 "b": cur["b"]}})
        for ev in evs:
            out.append({"ph": "i", "pid": PID, "tid": tid, "s": "t",
                        "name": ev["kind"],
                        "ts": round(off_us + ev["t_ms"] * 1e3, 1),
                        "args": {"a": ev["a"], "b": ev["b"]}})
    return trace


def export_chrome_trace(events: List[Dict], path: str) -> Dict:
    """Write the Chrome trace JSON for a recorder snapshot; returns the
    trace dict (tests assert on lanes/overlap without re-reading)."""
    trace = build_chrome_trace(events)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
        f.write("\n")
    return trace


def overlap_seconds(events: List[Dict]) -> float:
    """Total host-work seconds hidden under device-eval windows — the
    quantitative half of the overlap picture (the overlap attribution as a
    number): sum over host spans of their intersection with device-eval
    windows of OTHER waves. O(n log n): host spans intersect the merged
    union of device windows, minus the same wave's own window (one batch
    owns the device at a time, so a wave's window overlapping another
    wave's is negligible — and a full-ring export must not pay an
    all-pairs Python loop over tens of thousands of spans)."""
    import bisect

    device: List = []
    host: List = []
    dispatch_end: Dict[int, float] = {}
    dev_by_wave: Dict[int, tuple] = {}
    for e in events:
        if e["kind"] == "dispatch":
            dispatch_end[e["wave"]] = e["t"] + e["dur"]
            host.append((e["t"], e["t"] + e["dur"], e["wave"]))
        elif e["kind"] == "harvest":
            start = dispatch_end.get(e["wave"], e["t"])
            device.append((start, e["t"] + e["dur"]))
            dev_by_wave[e["wave"]] = (start, e["t"] + e["dur"])
        elif e["kind"] == "bind_flush":
            host.append((e["t"], e["t"] + e["dur"], e["wave"]))
    if not device or not host:
        return 0.0
    # merged union of device windows + prefix lengths for O(log n) probes
    device.sort()
    merged = [list(device[0])]
    for d0, d1 in device[1:]:
        if d0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], d1)
        else:
            merged.append([d0, d1])
    starts = [m[0] for m in merged]
    prefix = [0.0]
    for m0, m1 in merged:
        prefix.append(prefix[-1] + (m1 - m0))

    def measure_upto(x: float) -> float:
        """Union length of the merged device windows within (-inf, x]."""
        k = bisect.bisect_right(starts, x) - 1
        if k < 0:
            return 0.0
        m0, m1 = merged[k]
        return prefix[k] + min(max(x - m0, 0.0), m1 - m0)

    total = 0.0
    for h0, h1, hw in host:
        covered = measure_upto(h1) - measure_upto(h0)
        own = dev_by_wave.get(hw)
        if own is not None:
            covered -= max(min(h1, own[1]) - max(h0, own[0]), 0.0)
        total += min(max(covered, 0.0), h1 - h0)
    return total


__all__ = ["add_pod_lanes", "add_process_lanes", "build_chrome_trace",
           "export_chrome_trace", "overlap_seconds"]
