"""CLI: record a drain under the flight recorder and export a timeline.

    python -m kubernetes_tpu_torch.observability --trace out.json
    python -m kubernetes_tpu_torch.observability --trace out.json \\
        --nodes 5000 --pods 30000 --profile density
    python -m kubernetes_tpu_torch.observability --events raw.json --last 200
    python -m kubernetes_tpu_torch.observability --vars
    python -m kubernetes_tpu_torch.observability --trend [--band 0.30]

--trace runs the pipelined drain on the card, and refuses to run
without one unless ``--device cpu`` asks for the CPU (warmup pass first
so kernel builds never pollute the window), records every wave, and
writes the Chrome
trace-event JSON — load it in chrome://tracing or ui.perfetto.dev to
see the host-tail / device-eval overlap as lanes; with GRAFT_PODTRACE=1
the tracer's tail-exemplar pods render as additional per-pod phase
lanes. --events dumps the raw recorder ring instead; --vars prints a
telemetry-registry snapshot of the recorded run. --trend renders the
BENCH_r*.json headline trajectory and exits nonzero on a regression
past the box-noise band (observability/trend.py — the CI contract;
pure stdlib, needs no card). Exit 0 on success, 1 on a trend
regression, 2 on usage errors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _record_drain(n_nodes: int, n_pods: int, profile: str, chunk: int,
                  overlap: bool, warm: bool, device=None):
    """One pipelined drain with the recorder armed; returns
    (events, elapsed_s, totals, scheduler). ``device`` is the
    scheduler's: None is the card (RuntimeError without one)."""
    from kubernetes_tpu_torch.engine.scheduler import Scheduler
    from kubernetes_tpu_torch.models.hollow import (
        PROFILES,
        hollow_nodes,
        load_cluster,
    )
    from kubernetes_tpu_torch.observability.recorder import RECORDER
    from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite

    def build():
        api = ApiServerLite(max_log=max(200_000, 3 * (n_nodes + n_pods)))
        load_cluster(api, hollow_nodes(n_nodes), PROFILES[profile](n_pods))
        sched = Scheduler(api, record_events=False, device=device)
        sched.start()
        return sched

    if warm:
        build().run_until_drained(max_batch=chunk, overlap=overlap)
    sched = build()
    RECORDER.clear()
    RECORDER.enable()
    try:
        t0 = time.monotonic()
        totals = sched.run_until_drained(max_batch=chunk, overlap=overlap)
        elapsed = time.monotonic() - t0
    finally:
        RECORDER.disable()
    return RECORDER.snapshot(), elapsed, totals, sched


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.observability",
        description="flight-recorder CLI: record a pipelined drain and "
                    "export a Perfetto/chrome://tracing timeline")
    ap.add_argument("--trace", metavar="OUT.json",
                    help="write the Chrome trace-event timeline here")
    ap.add_argument("--events", metavar="OUT.json",
                    help="dump the raw recorder ring here instead")
    ap.add_argument("--vars", action="store_true",
                    help="print a telemetry-registry snapshot of the run")
    ap.add_argument("--last", type=int, default=0,
                    help="bound the exported event tail (0 = all)")
    ap.add_argument("--nodes", type=int,
                    default=int(os.environ.get("BENCH_NODES", 5000)))
    ap.add_argument("--pods", type=int,
                    default=int(os.environ.get("BENCH_PODS", 30000)))
    ap.add_argument("--profile",
                    default=os.environ.get("BENCH_PROFILE", "density"))
    ap.add_argument("--chunk", type=int, default=0,
                    help="fixed wave size (0 = auto)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="sequential debug mode (the lanes serialize)")
    ap.add_argument("--device", default=None,
                    help="torch device to schedule on (default: the card; "
                         "--trend needs none)")
    ap.add_argument("--no-warm", action="store_true",
                    help="skip the warmup drain (compiles land in the "
                         "recorded window)")
    ap.add_argument("--trend", action="store_true",
                    help="render the BENCH_r*.json headline trend and "
                         "exit nonzero on a regression (no card, "
                         "no drain)")
    ap.add_argument("--root", default=None,
                    help="trend: directory holding the artifacts")
    ap.add_argument("--band", type=float, default=None,
                    help="trend: relative noise band (default 0.30)")
    args = ap.parse_args(argv)
    if args.trend:
        from kubernetes_tpu_torch.observability import trend
        targv = []
        if args.root:
            targv += ["--root", args.root]
        if args.band is not None:
            targv += ["--band", str(args.band)]
        return trend.main(targv)
    if not (args.trace or args.events or args.vars):
        ap.print_usage(sys.stderr)
        print("nothing to do: pass --trace, --events and/or --vars, "
              "or --trend", file=sys.stderr)
        return 2

    events, elapsed, totals, sched = _record_drain(
        args.nodes, args.pods, args.profile, args.chunk,
        overlap=not args.no_overlap, warm=not args.no_warm,
        device=args.device)
    if args.last:
        events = events[-args.last:]
    print(f"recorded {len(events)} events over {elapsed:.3f}s "
          f"(bound={totals['bound']}, "
          f"fence_requeued={totals.get('fence_requeued', 0)})",
          file=sys.stderr)
    if args.trace:
        from kubernetes_tpu_torch.observability.perfetto import (
            add_pod_lanes,
            build_chrome_trace,
            overlap_seconds,
        )
        from kubernetes_tpu_torch.observability.podtrace import TRACER
        trace = build_chrome_trace(events)
        n_pods = 0
        if TRACER.enabled:
            # tail-exemplar pod lanes: the slowest sampled
            # pods of the recorded drain, phase-decomposed, aligned to
            # the ring's time base so each pod overlays the waves it
            # actually crossed
            exemplars = TRACER.snapshot()["exemplars"]
            t_base = min((e["t"] for e in events), default=None)
            add_pod_lanes(trace, exemplars, t_base=t_base)
            n_pods = len(exemplars)
        with open(args.trace, "w", encoding="utf-8") as f:
            json.dump(trace, f)
            f.write("\n")
        hidden = overlap_seconds(events)
        print(f"wrote {args.trace}: {len(trace['traceEvents'])} trace "
              f"events ({n_pods} exemplar pod lanes), "
              f"{hidden * 1e3:.1f}ms of host work hidden under "
              f"device-eval windows", file=sys.stderr)
    if args.events:
        with open(args.events, "w", encoding="utf-8") as f:
            json.dump(events, f, indent=1)
            f.write("\n")
        print(f"wrote {args.events}", file=sys.stderr)
    if args.vars:
        # the scheduler's own registry: histograms + spans + any stream
        # gauges a loop registered during the run
        print(json.dumps(sched.telemetry.snapshot(), indent=1,
                         sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
