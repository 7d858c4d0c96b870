#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's kernels of one source tree, so that two
trees can be compared on one card in turns.

    python3 kernel_ab.py [--tree DIR] [--label NAME] [--mode MODE]
                         [--repeats K]

DIR (default: this checkout) is the root of a tree that holds
kubernetes_tpu_torch/; its ops/kernels.py builds its own csrc/ into its
own .torch_kernels/. To compare the parent commit with this one, unpack
the parent into a directory that .gitignore lists and run both in turns
in one shell on one card:

    git archive <parent> | tar -x -C .scratch/parent
    for t in .scratch/parent . . .scratch/parent; do
        python3 kernel_ab.py --tree $t --mode capacity; done

--mode incidence (the default): operands from fixed seeds, the same in
every run: the one-pod verdict shape (A [6, 5008], four 0/1 rows and a
preferred-weight row up to 300,000, against B_t [5000, 5008] with 5%
ones) and the stacked shapes of chip_smoke.py (M = 640 and 2,560,
L = 2,048 and 4,096, plus the wide-weight stack). Each result is checked
against the plain version first. One JSON line per shape (in ms, as
chip_smoke.py times them: back-to-back calls through the wrapper, device
time warm, and device time with L2 cleanly flushed).

--mode capacity: capacity_fit at [16 x 5000], R = 5 (chip_smoke.py's
operands: `ms`, `device_ms`, the profiler's kernel time, and `ms` again
after the profiler's session), and the wave's capacity step on a real
mid-drain state (5,000 hollow nodes after a 15,000-pod binpack drain, 16
class rows of fresh binpack pods): on a tree with
kernels.capacity_headroom that is waves._class_capacity (one launch), on
an older tree what its _wave_once ran for the same step,
predicates.resources_fit plus waves._class_capacity. The mask (and the
headroom, where the tree has the fused call) is held against the plain
versions first. Times the step (`wave_ms`, `wave_device_ms`) and counts,
with torch.profiler, the device operations of the step and of one whole
_wave_once.

--mode drain: chip_smoke.py's binpack drain (30,000 binpack pods on
5,000 hollow nodes, a fresh cache each time, through
SchedulingEngine.schedule(mode="wave")) K times after one small warm-up
drain; one JSON line per drain with its wall time, waves and the
engine's spans.

Prints the card line and the card's clocks too. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def incidence(cs, kernels, label, dev):
    import numpy as np
    import torch
    kernels.build(("incidence_matmul",))
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


def wave_state(dev):
    """A mid-drain wave state of the tree: 5,000 hollow nodes after a
    15,000-pod binpack drain on the card; 16 class rows of 64 fresh
    binpack pods; the wave's pod-class vector and kernel priorities."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.engine.batch import node_state
    from kubernetes_tpu_torch.engine.scheduler_engine import SchedulingEngine
    from kubernetes_tpu_torch.models import hollow
    from kubernetes_tpu_torch.ops import predicates as preds
    from kubernetes_tpu_torch.ops import priorities as prio
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.state.classes import ClassBatch
    cache = SchedulerCache()
    for nd in hollow.hollow_nodes(5000):
        cache.add_node(nd)
    eng = SchedulingEngine(cache, device=dev)
    eng.schedule(hollow.binpack_pods(15000, seed=3), mode="wave")
    eng._refresh()
    nodes = eng._nodes_on_device()
    pods = hollow.binpack_pods(64, seed=1, namespace="ab")
    batch = ClassBatch(pods, eng.snapshot)
    cls = preds.pod_arrays_padded(batch.reps_batch, 16, dev)
    pc = np.full(preds.bucket(len(pods)), batch.num_classes, dtype=np.int32)
    pc[:len(pods)] = batch.pod_class
    prios = tuple((nm, w) for nm, w in prio.DEFAULT_PRIORITIES
                  if nm not in prio.AFFINITY_PRIORITIES)
    return cls, nodes, node_state(nodes), torch.from_numpy(pc).to(dev), prios


def device_ops(fn):
    """Device operations (kernels, copies, sets) one call of fn runs, by
    name, from torch.profiler; None where the trace holds none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0) + 1
    return names or None


def progress(label, what):
    print(f"kernel_ab {label}: {what} ({time.strftime('%H:%M:%S')})",
          file=sys.stderr, flush=True)


def capacity(cs, kernels, label, dev):
    import numpy as np
    import torch
    from kubernetes_tpu_torch.engine import waves
    from kubernetes_tpu_torch.ops import predicates as preds
    kernels.build(("capacity_fit",))
    rng = np.random.default_rng(0)
    req, alloc, requested = cs.capacity_operands(rng, 16, 5000, 5, dev)

    def cap_call():
        return kernels.capacity_fit(req, alloc, requested)

    if not torch.equal(cap_call(), kernels.capacity_fit_plain(
            req, alloc, requested)):
        cs.fail(f"{label}: capacity_fit != plain")
    progress(label, "capacity_fit timings")
    row = {"tree": label, "shape": "P=16 N=5000 R=5",
           "ms": cs.time_ms(cap_call),
           "device_ms": cs.time_device_ms(cap_call)}
    prof = cs.profile_kernels(cap_call)
    row["profiler_ms"] = None if prof is None else sum(
        v for k, v in prof.items() if "capacity" in k)
    # the same timing once more after the profiler's session
    row["ms_after_profiler"] = cs.time_ms(cap_call)

    progress(label, "wave state")
    cls, nodes, state, pc, prios = wave_state(dev)
    progress(label, "wave step")
    fused = hasattr(kernels, "capacity_headroom")

    def step():
        if fused:
            return waves._class_capacity(cls, nodes, state)
        return (preds.resources_fit(cls["req"], cls["zero_req"],
                                    nodes["alloc"], state.requested),
                waves._class_capacity(cls, nodes, state))

    fit, cap = step()
    want_fit = kernels.capacity_fit_plain(
        cls["req"], nodes["alloc"], state.requested) | cls["zero_req"][:, None]
    if not torch.equal(fit, want_fit):
        cs.fail(f"{label}: the wave step's mask != plain")
    if fused and not torch.equal(cap, kernels.class_capacity_plain(
            cls["req"], cls["zero_req"], nodes["alloc"], state.requested,
            state.pod_count, nodes["allowed_pods"])):
        cs.fail(f"{label}: the wave step's headroom != plain")
    pre = waves.precompute(cls, nodes, prios)
    active = torch.ones(pc.shape[0], dtype=torch.bool, device=dev)
    counter = torch.zeros((), dtype=torch.int64, device=dev)
    progress(label, "device operations")
    step_ops = device_ops(step)
    wave_ops = device_ops(lambda: waves._wave_once(
        cls, nodes, state, pre, pc, active, counter, prios))
    progress(label, "wave step timings")
    row.update({
        # 5 calls a round: the eager step of an older tree is 80 device
        # operations a call, and 20 calls would overrun the launch queue
        # behind the spin
        "wave_ms": cs.time_ms(step, reps=5),
        "wave_device_ms": cs.time_device_ms(step, reps=5),
        "wave_step_device_ops": None if step_ops is None
        else sum(step_ops.values()),
        "wave_once_device_ops": None if wave_ops is None
        else sum(wave_ops.values()),
        "classes": int(cls["req"].shape[0]),
    })
    print(json.dumps(row), flush=True)


def drain(cs, kernels, label, repeats):
    import torch
    from kubernetes_tpu_torch.engine.scheduler_engine import SchedulingEngine
    from kubernetes_tpu_torch.models import hollow
    from kubernetes_tpu_torch.utils.trace import COUNTERS
    kernels.build()
    SchedulingEngine(cs.build_cache(hollow.hollow_nodes(512))).schedule(
        hollow.binpack_pods(3000), mode="wave")
    for i in range(repeats):
        eng = SchedulingEngine(cs.build_cache(hollow.hollow_nodes(cs.N_NODES)))
        pods = hollow.binpack_pods(cs.N_PODS)
        torch.cuda.synchronize()
        COUNTERS.reset()
        t0 = time.perf_counter()
        eng.schedule(pods, mode="wave")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps({"tree": label, "drain": i, "wall_s": wall,
                          "waves": eng.last_wave_stats["waves"],
                          "spans_ms": cs.spans("engine.")}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--label", default="")
    ap.add_argument("--mode", choices=("incidence", "capacity", "drain"),
                    default="incidence")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
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
    # int_matmul needs full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.log_clocks(f"before {label}")
    if args.mode == "incidence":
        incidence(cs, kernels, label, dev)
    elif args.mode == "capacity":
        capacity(cs, kernels, label, dev)
    else:
        drain(cs, kernels, label, args.repeats)
    cs.log_clocks(f"after {label}")
    print(cs.card_facts())
    return 0


if __name__ == "__main__":
    sys.exit(main())
