#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's incidence kernel of one source tree, so
that two trees can be compared on one card in turns.

    python3 kernel_ab.py [--tree DIR] [--label NAME]

DIR (default: this checkout) is the root of a tree that holds
kubernetes_tpu_torch/; its ops/kernels.py builds its own csrc/ into its
own .torch_kernels/. To compare the parent commit with this one, unpack
the parent into a directory that .gitignore lists and run both in turns
in one shell on one card:

    git archive <parent> | tar -x -C .scratch/parent
    for t in .scratch/parent . . .scratch/parent; do
        python3 kernel_ab.py --tree $t; done

Operands are made from fixed seeds, the same in every run: the one-pod
verdict shape (A [6, 5008], four 0/1 rows and a preferred-weight row up
to 300,000, against B_t [5000, 5008] with 5% ones) and the stacked shapes
of chip_smoke.py (M = 640 and 2,560, L = 2,048 and 4,096, plus the
wide-weight stack). Each result is checked against the plain version
first. Prints one JSON line per shape (in ms, as chip_smoke.py times
them: back-to-back calls through the wrapper, device time warm, and
device time with L2 cleanly flushed), the card line, and the card's
clocks. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs               # the timers, from this checkout
    sys.path.insert(0, os.path.abspath(args.tree))
    for name in [m for m in sys.modules if m.startswith("kubernetes_tpu_")]:
        del sys.modules[name]
    from kubernetes_tpu_torch.ops import kernels
    label = args.label or os.path.relpath(os.path.abspath(args.tree), here)
    kernels.build(("incidence_matmul",))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    a = (rng.random((6, 5008)) < 0.002).astype(np.int32)
    a[5] *= rng.integers(0, 300_000, size=5008).astype(np.int32)
    b = (rng.random((5000, 5008)) < 0.05).astype(np.int8)
    shapes = [("verdict", torch.from_numpy(a).to(dev),
               torch.from_numpy(b).to(dev))]
    for m in (640, 2560):
        for l in (2048, 4096):
            shapes.append((f"M={m} L={l}",
                           *cs.stacked_operands(rng, m, l, dev)))
    shapes.append(("stack C=256 S=8 L=4096 wide weights",
                   *cs.stacked_operands(rng, 2560, 4096, dev, wide=True)))
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    cs.log_clocks(f"before {label}")
    for tag, x, y in shapes:
        if not torch.equal(kernels.incidence_matmul(x, y),
                           kernels.incidence_matmul_plain(x, y)):
            cs.fail(f"{label}: incidence_matmul != plain at {tag}")
        def call(x=x, y=y):
            return kernels.incidence_matmul(x, y)
        print(json.dumps({
            "tree": label, "shape": tag,
            "ms": cs.time_ms(call),
            "device_ms": cs.time_device_ms(call),
            "cold_clean_ms": cs.time_cold_ms(call, flush, clean=True)}),
            flush=True)
    cs.log_clocks(f"after {label}")
    print(cs.card_facts())
    return 0


if __name__ == "__main__":
    sys.exit(main())
