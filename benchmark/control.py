"""The control of the comparison that decides `correct`: a cell run as the
benchmark runs it, at its own size, with a fault planted under the timed
path (lib/faults.py); every seed must read as not correct. Sound runs
(no `--fault`) print the same numbers, for the limits' lower readings.
One process runs every seed, each on a fresh cluster and scheduler.

    python3 benchmark/control.py --workload podaffinity-5k.backlog-10k \
        --seeds 11,12,13 --fault first_fit --seconds 3
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import os
    cache = ROOT / ".torch_kernels"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    import torch
    from benchmark import run
    from benchmark.lib import faults
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3)
    ap.add_argument("--fault", default="", choices=("",) + faults.FAULTS)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    with open(ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    ok = True
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        tweak = faults.tweak(a.fault) if a.fault else None
        try:
            res = run.run_cell(spec, a.workload, seed, a.seconds, False,
                               device=a.device, tweak=tweak)
        finally:
            faults.undo()
        ok &= res["correct"] != bool(a.fault)
        print(json.dumps({"workload": a.workload, "fault": a.fault,
                          "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "checks": {k: v["value"]
                                     for k, v in res["checks"].items()},
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
