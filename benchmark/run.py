"""Run one cell of the benchmark of kubernetes_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration and its metrics are read from BENCHMARK.json at
the root of the checkout, and everything they name is found by name: the
configuration's file, the traffic mix's data file benchmark/traffic/<mix>.json,
the loop it names in benchmark/loops/<loop>.py, the pod generator in
benchmark/gen/mix/<generator>.py, and each metric's reader in
benchmark/metrics/<metric>.py. With --trace 0 the last line of standard
output carries the cell's end-to-end metrics, with --trace 1 its per-layer
metrics. The run needs a CUDA device: without one it exits 2 and prints no
result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "kubernetes_tpu")


def forbidden_modules(modules=None):
    """Top-level names of `modules` (default sys.modules), compared whole,
    that are in FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_cell(spec: dict, name: str) -> SimpleNamespace:
    """The cell `name` of BENCHMARK.json with everything it names."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(ROOT / config["file"]) as f:
        conf = json.load(f)
    with open(BENCH / "traffic" / f"{cell['traffic']}.json") as f:
        params = json.load(f)

    def mine(m):
        return name in m.get("workloads", [name])
    return SimpleNamespace(
        name=name, cell=cell, conf=conf, params=params,
        end_to_end=[m for m in spec["end_to_end"] if mine(m)],
        per_layer=[m for m in spec["per_layer"] if mine(m)])


def _load(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module; a name may hold dots."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind} file for {name!r}: {path}")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}._{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """benchmark/metrics/<metric>.py's read(run)."""
    return _load("metrics", metric).read


def loop(name: str):
    """benchmark/loops/<name>.py: its setup(w, span) and window(w, seconds,
    span)."""
    return _load("loops", name)


def _read(metrics, run) -> dict:
    out = {}
    for m in metrics:
        v = reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", tweak=None, params=None) -> dict:
    """Set up the cell, run its window, judge it; returns the result line
    as a dict (its "checks" entry last). Tests run it on the CPU at tiny
    sizes: `params` overrides the mix's numbers, and `tweak(world)`, when
    given, is called once the scheduler has started, to plant a fault
    (lib/faults.py)."""
    from benchmark.lib.devtrace import DeviceTrace, KernelCalls, Spans
    from benchmark.lib.world import World, log
    from benchmark.reference import check as ref
    import torch
    from kubernetes_tpu_torch.utils.trace import COUNTERS

    c = load_cell(spec, name)
    c.params.update(params or {})
    lp = loop(c.params["loop"])
    on_card = device != "cpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    spans = Spans() if trace else None
    span = spans.span if trace else (lambda *a: None)
    w = World(c.conf, c.params, seed, device)
    if tweak is not None:
        tweak(w)
    lp.setup(w, span)
    w.sync_device()
    setup_s = time.perf_counter() - T_START
    log(f"setup_s {setup_s:.3f}")
    calls = None
    if trace:
        spans.wrap(w.sched.engine, "dispatch_waves", "engine.dispatch_waves")
        spans.wrap(w.sched.engine, "harvest_waves", "engine.harvest_waves")
        calls = KernelCalls(spans)
    c0 = COUNTERS.snapshot()
    dtrace = DeviceTrace(device) if (trace and on_card) else None
    try:
        with dtrace if dtrace is not None else contextlib.nullcontext():
            res = lp.window(w, seconds, span)
    finally:
        if spans is not None:
            spans.restore()
    if dtrace is not None and w.timed:
        dtrace.measure(w.timed)
    c1 = COUNTERS.snapshot()
    counters = {k: (v[0] - c0.get(k, (0, 0.0))[0],
                    v[1] - c0.get(k, (0, 0.0))[1]) for k, v in c1.items()}
    w.sync_device()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    least = calls.least_s() if calls is not None else {}
    w.close()
    # the reference, once the window has closed: every episode judged
    values = ref.aggregate([ref.check(w.cluster, podset, out)
                            for podset, out in w.judged])
    bad = ref.failing(values)
    result = {"correct": not bad, "attempted": int(res["attempted"]),
              "failed": int(res["attempted"] - res["bound"])}
    run = SimpleNamespace(cell=name, params=c.params, res=res,
                          counters=counters, trace=dtrace, least_s=least,
                          seconds=seconds, setup_s=setup_s)
    result["metrics"] = _read(c.per_layer if trace else c.end_to_end, run)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result["device"] = dev
    if dtrace is not None:
        dev["busy_s"] = dtrace.busy_s
        dev["window_s"] = dtrace.window_s
        result["breakdown"] = dtrace.breakdown(spans)
    result["checks"] = {k: {"value": values[k], "limit": ref.LIMITS[k]}
                        for k in ref.CHECKS}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    # every build and kernel cache of the run inside the checkout
    cache = ROOT / ".torch_kernels"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    import torch
    with open(ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}.get(
        a.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no CUDA device for {a.workload} (needs {chips}): "
              f"nothing measured", file=sys.stderr)
        return 2
    result = run_cell(spec, a.workload, a.seed, a.seconds, bool(a.trace))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: no result",
              file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result: dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
