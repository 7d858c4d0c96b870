#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kubernetes_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (CUDA_HOME, default /usr/local/cuda). It
exits non-zero, without a result line, when either is missing or any
phase fails. Phases:

  1. build both CUDA kernels from csrc/ and print the card and its power
     limit;
  2. hold each kernel against its plain PyTorch version on the card
     (exact equality) at the main path's shapes and at ragged ones: for
     the capacity kernel both outputs (the mask without and with the
     zero-request override, and the wave call's mask and headroom), also
     with over-committed nodes, pod counts past their ceiling, int32
     extremes that wrap and R = 12 and 40 (past the kernel's register
     window), and refused arguments; for the incidence kernel also
     wide-weight rows (entries up to +-2^22), int32 extremes whose sums
     still fit int32, L % 16 == 8, the wrapper's padding of L and of
     misaligned operands, and a refused launch plan. Time kernel, plain
     version, library yardstick and bound: `ms` is the time of
     back-to-back calls through the wrapper (the kernels line's figure);
     beside it `device_ms`, device time with the host's enqueue hidden,
     and (incidence) `cold_ms`, device time of one call with L2 flushed
     (dirty, and clean after a read-back); the pre-pass's share
     (profiler) and the launch plan per shape; capacity_fit's device-only
     time from the profiler, and the wave call (capacity_headroom) the
     same ways under `wave_*` keys;
  3. run the wave engine at 512 nodes x 3,000 binpack pods on the card and
     on the CPU: every placement, fit count and the RR counter agree;
  4. the main path: drain 30,000 density pods, then 30,000 binpack pods
     (fresh cache), on 5,000 hollow nodes through
     SchedulingEngine.schedule(mode="wave"), and audit the placements from
     the cache (capacity, pod caps, unplaced pods fit nowhere); the
     capacity kernel ran once per wave (plus once per pod of a strict-loop
     finish), and both its outputs equal their plain versions on each
     drain's end state;
  5. the extender verdict: evaluate_pod for affinity probes against a
     5,000-node cluster holding 3,000 bound mixed-affinity pods, on the
     card and on the CPU: fits and scores agree;
  6. the pipelined drain, as bench.py run_once runs it: ApiServerLite ->
     load_cluster -> Scheduler.start() -> Scheduler.run_until_drained()
     on the card for the density, binpack and mixed_affinity profiles at
     5,000 nodes x 30,000 pods, each on a fresh store. Every run is
     audited from the store (every pod bound or provably unschedulable,
     no node over its CPU, memory or pod count, no pod bound twice; for
     mixed_affinity also one iso-* pod of an app per host, the symmetry
     direction, and every pack-* group in one zone). Each kernel's
     operands at every shape this path launched it with are held against
     its plain version; then the mixed_affinity drain at 512 x 3,000 runs
     on the card with overlap on and off and on the CPU: the placements
     agree;
  7. the scheduler-extender service, as bench.py _build_extender starts
     it: TPUExtenderBackend (binding into an ApiServerLite) behind
     ExtenderHTTPServer, 5,000 hollow nodes and 3,000 bound
     mixed_affinity pods synced over /cache/nodes and /cache/pods. The
     phase-5 probes and two host-oracle probes go over HTTP as /filter +
     /prioritize to the card's sidecar and to a CPU sidecar given the
     same syncs (equal response bodies), then one coalesced batch of ten
     classes through _eval_many on both (equal rows); the counters show
     the fused [C, N] batch, /prioritize riding /filter's memo and the
     oracle route. Then the HTTP verdict round (bench.py
     measure_extender_latency) and a fleet of 8 concurrent compat
     scheduleOne frontends binding 1,000 density pods with SnapshotGen and
     IdempotencyKey, 409s retried, any other error failing; the store is
     audited. Each kernel's operands at every launch shape of the phase
     are held against its plain version, and the batch's stacked
     incidence product is timed;
  8. the scheduler daemon with a Policy (the v1.7 knob set of Kubernetes'
     compatibility_test.go, no extender) from a --policy-config-file, on
     5,000 hollow nodes labeled region / zone / foo (90%) / bar (half)
     and 30,000 pending pods: mixed_affinity plus 1% host-static pods
     (five ORed node-selector terms) and 1/300 host-exact pods (nine host
     ports; two Services coupled by ServiceAffinity on region).
     8a (depth cut to 10,000 pods): two SchedulerDaemons on one fake
     clock; A leads, runs one classic round over half the queue and
     crashes holding its lease; B waits it out, relists and finishes with
     step(). 8b: the pipelined drain of the same store contents, Scheduler(policy=...)
     .run_until_drained(): no pipeline flush, the host-exact rows ride
     to the oracle tail. 8c: the strict classic round, mixed_affinity at
     5,000 x 2,000. Each run is audited from the store (phase 6's audit,
     every pod bound, every pod on a foo node, each coupled Service in
     one region, each host-static pod in its zone, no host-port clash),
     and each kernel's operands at every launch shape are held against
     its plain version; both kernels must launch in each. 8d: the three
     runs at 512 x 3,000 (strict: 256 x 600) on the card and on the CPU
     give equal placements and RR counters;
  9. gangs, PodPriority preemption and the Sparrow fast lane, each
     through its own entry point. 9a: bench.py measure_gang_mix's drain,
     gang_mix at 5,000 x 30,000 in chunks of 1,024 with gangs riding the
     waves, then the flush baseline (every gang chunk to the classic
     round) at bench's 1,000 x 6,000; zero partially bound gangs, phase
     6's store audit. 9b: bench.py measure_priority_churn through
     Scheduler.stream() with PodPriority on behind FaultyBindApi's
     eviction faults, at bench's 240 nodes and then at 5,000 nodes
     pre-filled 19 pods a node with 10,000 more streamed; no duplicate
     bind, no double eviction or ghost victim, no 60 s window past the
     disruption budget, the victim scan on the card every round. 9c: a
     SchedulerDaemon whose componentconfig turns PodPriority on, over
     5,000 full nodes and 1,000 pending prod/system pods, stepped until
     nothing placeable is left (classic preemption audited). 9d: bench.py
     measure_fastlane_mixed's three windows at 5,000 nodes; the outcome
     counters partition the fast pods and the probe window's evals run on
     the card. 9e: card == CPU for gang_mix at 512 x 3,000 (pipelined,
     overlap off, flush), for preempt_scan, the wave plans and the classic
     round's plans on a full 512-node store, and for sample_eval on 1,000
     index sets; then the two PyTorch device functions (victim_scan,
     sample_eval) are timed at their main-path shapes beside their
     bounds. Each kernel's operands at every launch shape of 9a-9d are
     held against its plain version;
 10. the process fleet and the federation, each through its own entry
     point. 10a: bench.py measure_multiproc's sweep, run_process_fleet
     over one shared cell of 5,000 hollow nodes (W = 1 and 2 on disjoint
     pools, W = 2 at overlap 0.5, 100 pods a worker (depth cut from
     500), relist every 16), every worker a spawned process whose
     evaluator runs on the card; no duplicate bind, no worker failure,
     every pod bound, the conflict reasons partitioning the fence's
     count. 10b: bench.py
     measure_federation's stream over four spawned cell processes (each
     a CellAgent on the card at 5,000 nodes behind AsyncBinaryServer) and
     one FederationRouter on the card over WireCells: 1,600 pods (one in
     8 pinned to a zone), 4 gangs of 6, batches of 64, one brownout of
     1.5 s, then one burst admission of 2,048 pods (route_scores on the
     card); audited from every cell's store (no duplicate bind, no pod
     bound in two cells, every gang in one cell, nothing pending, every
     offered pod bound). Then one in-process CellAgent at 5,000 nodes
     behind a LocalCell. Each child spies its kernel launches, holds the
     kernels against their plain versions on its own operands and sends
     its launch counts back; the capacity kernel must launch in every
     cell and worker, and is held against its plain version at every
     child's launch shape here too. 10c: route_scores on the card ==
     the CPU == the host twin at C in (1, 33, 256, 2,048, 8,192) x M in
     (4, 16) with wrapping int32 differences, ties, zero capacities,
     not-ready cells and negative headroom; a frozen-column route() of
     a 2,048-pod mixed batch agrees on the card, the CPU and the host
     twin; route_scores timed at C = 2,048, M = 4 beside its bound;
 11. the node-axis mesh and the upload sanitizer, D shards of one card
     (parallel/mesh.make_mesh(D) repeats the one device). 11a:
     Scheduler(mesh=make_mesh(4)).run_until_drained() at 5,000 x 30,000,
     density and mixed_affinity: placements equal phase 6's unsharded
     drains, phase 6's store audit, both kernels launched on every shard
     at the per-shard width 1,250 and held against their plain versions
     at every launch shape, the two-stage reduce and the per-shard row
     delta counted (engine.reduce_candidate_rows, shard_delta_rows) and
     host_fetch_bytes per wave printed. 11b: bench.py _scale_drain_impl's
     engine-level drain (density, 5,000 x 30,000, chunks of 4,096) at
     D = 1, 2 and 4: the same placement sha256 at every D, capacity
     launched on every shard at width 5,000 / D and held against its
     plain version at every launch shape, walls printed.
     11c: mixed_affinity at 512 x 3,000 with D = 8, on the card and on the
     CPU, equal to phase 6's unsharded CPU run. 11d: GRAFT_SANITIZE=1: the
     512 x 3,000 mixed_affinity drain on the card and on a D = 4 mesh,
     equal to the unsanitized run, with the seams' alias checks and seals
     counted; an aliasing upload constructor on a CPU tensor raises;
 12. print the per-kernel summary line, then the result line.

Launch counts are zeroed just before each main-path run (phases 4, 5, 6,
7, 8a-8c, 9a-9d, 10a-10b, 11a and 11b; in 10a and 10b each child process
counts its own) and read just after it; launches made by the comparisons
do not count.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate for their type
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12      # float32 outside the tensor cores
INT8_TENSOR_OPS_PER_S = 1979e12  # int8 tensor cores

N_NODES = 5000
N_PODS = 30000
# 8a's depth: cut from 30,000 to 10,000 pods so that the whole run,
# phase 9 included, stays near 8 minutes; 8b keeps the full 30,000
P8A_PODS = 10000
I32_MAX = 2 ** 31 - 1
FLUSH_BYTES = 256 << 20     # written between cold launches; L2 is 50 MB


def log(*a) -> None:
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_facts(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    return out[0] if out else ""


def log_clocks(when: str) -> None:
    log(f"card {when}: sm clock, max sm clock, power draw, limit, "
        f"temperature: " + card_facts(
            "clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"))


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Wrapper time: median over `rounds` of (CUDA-event time of `reps`
    back-to-back calls) / reps, after a warm-up. Where the host's path
    through a call is longer than its device work, this is the host's."""
    import torch
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


_SPIN_CYCLES_PER_MS = []


def _spin(ms: float) -> None:
    """Keep the stream busy for about `ms` (a spin kernel), so that what
    the host enqueues meanwhile runs back to back after it."""
    import torch
    if not _SPIN_CYCLES_PER_MS:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        a.record()
        torch.cuda._sleep(10_000_000)
        b.record()
        b.synchronize()
        _SPIN_CYCLES_PER_MS.append(10_000_000 / a.elapsed_time(b))
    torch.cuda._sleep(int(ms * _SPIN_CYCLES_PER_MS[0]))


def time_device_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time: as time_ms, but the calls are enqueued behind a spin
    kernel, so the events bracket device work only (back to back, operands
    warm in L2). The spin is doubled until the enqueue fits inside it."""
    import torch
    fn()
    torch.cuda.synchronize()
    spin_ms, per = 2.0, []
    while len(per) < rounds:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        _spin(spin_ms)
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        b.synchronize()
        if host_ms > 0.8 * spin_ms:
            if spin_ms >= 1000:
                fail(f"time_device_ms: {reps} calls take {host_ms:.1f} ms "
                     f"to enqueue behind a {spin_ms:.0f} ms spin (the call "
                     f"waits for the device)")
            spin_ms *= 2
            continue
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


def time_cold_ms(fn, flush, clean: bool = False, reps: int = 15) -> float:
    """Device time of one call with L2 cold: before each call, write the
    `flush` buffer (larger than the 50 MB L2), then enqueue the call behind
    a spin kernel and time it alone with its own events. Median. The
    written lines sit dirty in L2, so the call also pays their write-back;
    with clean=True the buffer is read back after it is written, which
    leaves L2 holding clean lines of it and nothing of the operands."""
    import torch
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        flush.fill_(1)
        if clean:
            flush.max()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        _spin(1.0)
        a.record()
        fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b))
    return statistics.median(per)


def profile_kernels(fn, reps: int = 20):
    """Mean device time per call (ms) of each CUDA kernel `fn` launches,
    from torch.profiler; None where this torch has no device tracing
    (built without Kineto) or the trace holds no device time. Any other
    error of the profiler fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.autograd.kineto_available():
        log("torch.profiler: no Kineto in this torch, device time not "
            "measured")
        return None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None)
        if total is None:
            total = getattr(e, "cuda_time_total", 0)
        if total > 0:
            out[e.key] = total / 1e3 / reps
    if not out:
        log("torch.profiler: the trace holds no device time")
    return out or None


# ---------------------------------------------------------------- phase 2


def abs_err(got, want) -> int:
    """max |kernel - plain| over the cells (synchronises the device)."""
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def capacity_operands(rng, p, n, r, dev):
    """Requests, allocatable and requested columns with nodes with and
    without overlay capacity and requests sitting exactly on the limit."""
    import numpy as np
    import torch
    alloc = rng.integers(0, 5000, size=(n, r)).astype(np.int32)
    alloc[rng.random(n) < 0.5, 4] = 0                  # no overlay
    requested = (alloc * rng.random((n, r))).astype(np.int32)
    req = rng.integers(0, 2500, size=(p, r)).astype(np.int32)
    req[rng.random(p) < 0.2] = 0                       # zero requests
    if p and n:
        # some (pod, node) pairs land exactly on the limit
        k = min(p, n)
        req[:k] = alloc[:k] - requested[:k]
    t = [torch.from_numpy(x).to(dev) for x in (req, alloc, requested)]
    return t


def headroom_operands(rng, req, alloc, requested, extremes=False):
    """The wave call's operands around capacity_operands' (req, alloc,
    requested): zero-request flags (the all-zero rows), pod counts with
    nodes below, at and past their ceiling, over-committed nodes
    (requested > alloc in some columns); with extremes=True int32 extremes
    in every operand, whose sums and differences wrap. Returns (req, zero,
    alloc, requested, pod_count, allowed_pods) on req's device."""
    import numpy as np
    import torch
    dev = req.device
    req, alloc, requested = (x.cpu().numpy().astype(np.int64)
                             for x in (req, alloc, requested))
    c, n = req.shape[0], alloc.shape[0]
    over = rng.random(requested.shape) < 0.1
    requested[over] = alloc[over] + rng.integers(1, 500, size=over.sum())
    allowed = rng.integers(0, 120, size=n)
    pod_count = np.maximum(allowed - rng.integers(1, 60, size=n), 0)
    full = rng.random(n) < 0.2
    pod_count[full] = allowed[full] + rng.integers(0, 3, size=full.sum())
    if extremes:
        ext = np.array([-2 ** 31, -2 ** 31 + 1, -1, 1, I32_MAX - 1, I32_MAX])
        for a in (req, alloc, requested, allowed, pod_count):
            hit = rng.random(a.shape) < 0.15
            a[hit] = rng.choice(ext, size=hit.sum())
    zero = ~req.any(axis=1)
    zero[rng.random(c) < 0.1] = True                   # forced zero rows
    req[zero] = 0
    return tuple(torch.from_numpy(x.astype(np.int32) if x.dtype != bool
                                  else x).to(dev)
                 for x in (req, zero, alloc, requested, pod_count, allowed))


def check_capacity_outputs(kernels, ops, tag):
    """Both outputs of the capacity kernel against their plain versions on
    the card, exactly: the mask without and with the override (one launch
    each) and the wave call's mask and headroom (one launch). Returns the
    max |kernel - plain|."""
    import torch
    req, zero, alloc, requested, pod_count, allowed = ops
    pairs = [
        ("mask", kernels.capacity_fit(req, alloc, requested),
         kernels.capacity_fit_plain(req, alloc, requested)),
        ("mask with override",
         kernels.capacity_fit(req, alloc, requested, zero),
         kernels.capacity_fit_plain(req, alloc, requested, zero))]
    fit, cap = kernels.capacity_headroom(*ops)
    pairs += [("wave mask", fit,
               kernels.capacity_fit_plain(req, alloc, requested, zero)),
              ("headroom", cap, kernels.class_capacity_plain(*ops))]
    err = 0
    for what, got, want in pairs:
        if got.dtype != want.dtype or got.shape != want.shape:
            fail(f"capacity {what} at {tag}: {got.dtype} {tuple(got.shape)}"
                 f" against plain {want.dtype} {tuple(want.shape)}")
        err = max(err, abs_err(got, want))
        if not torch.equal(got, want):
            fail(f"capacity {what} != plain at {tag}: "
                 f"{int((got != want).sum())} cells differ")
    return err


def incidence_check_operands(gen, m, n, l, dev):
    """A [m, l] int32 and B_t [n, l] int8 for the exactness checks: 0/1
    incidence rows, then (from m // 3) weight rows with entries up to
    +-2^22, and int32 extremes whose sums still fit int32. The last row
    holds -2^31 + 1 and 2^31 - 1; the one before it (the only row when
    m = 1) holds 2^31 - 2, 1 and -1 against B_t columns that make its top
    digit plane carry the kernel's recombination across the int32
    boundary. Columns 0..4 of B_t follow fixed patterns, the rest are
    random with 1% ones."""
    import torch
    a = (torch.rand((m, l), generator=gen, device=dev) < 0.3).to(torch.int32)
    w0 = m // 3
    a[w0:] *= torch.randint(-2 ** 22, 2 ** 22 + 1, (m - w0, l),
                            generator=gen, device=dev, dtype=torch.int32)
    extreme = [-I32_MAX, I32_MAX, 0, 0, 0]
    carry = [0, 0, I32_MAX - 1, 1, -1]
    for r, vals in ([(m - 1, extreme), (m - 2, carry)] if m > 1
                    else [(0, carry)]):
        a[r] = 0
        a[r, :5] = torch.tensor(vals, dtype=torch.int32)
    b = (torch.rand((n, l), generator=gen, device=dev) < 0.01).to(torch.int8)
    i = torch.arange(n, device=dev)
    b[:, 0] = (i % 2).to(torch.int8)
    b[:, 1] = ((i // 2) % 2).to(torch.int8)
    b[:, 2] = 1
    b[:, 3] = (i % 3 == 0).to(torch.int8)
    b[:, 4] = (i % 5 == 0).to(torch.int8)
    return a, b


def stacked_operands(rng, m, l, dev, wide=False):
    """A stacked [m, l] A against B_t [5120, l]: 2% ones; the upper half
    of the rows weighted by [-100, 100] (the earlier timing operands), or with
    wide=True laid out as stack_static lays out C = m / 10 classes of
    S = 8 terms: allow and forbid rows 0/1, the last C rows preferred
    weights up to 300,000 (three digit planes)."""
    import numpy as np
    import torch
    a = (rng.random((m, l)) < 0.02).astype(np.int32)
    if wide:
        c = m // 10
        a[m - c:] *= rng.integers(-300_000, 300_001, size=(c, l)) \
            .astype(np.int32)
    else:
        a[m // 2:] *= rng.integers(-100, 101, size=(m - m // 2, l)) \
            .astype(np.int32)
    b = (rng.random((5120, l)) < 0.01).astype(np.int8)
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


def check_incidence(kernels, extender_ops, dev):
    """Exactness of the incidence kernel and its pre-pass on the card;
    returns the max |kernel - plain| (0, or the smoke fails)."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    err, checks = 0, 0
    cases = []
    for m in (1, 6, 16, 17, 130):
        for n in (1, 255, N_NODES):
            for l in (4104, 5000, 5008):
                cases.append((f"M={m} N={n} L={l}",
                              *incidence_check_operands(gen, m, n, l, dev)))
    # L % 8 != 0 (the wrapper pads L), and operands whose base addresses
    # are not 16-byte aligned (the wrapper copies them)
    cases.append(("L=4100",
                  *incidence_check_operands(gen, 6, 255, 4100, dev)))
    a, b = incidence_check_operands(gen, 6, 255, 4104, dev)
    a_odd = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)
    b_odd = torch.empty(b.numel() + 1, dtype=b.dtype, device=dev)
    a_odd[1:] = a.flatten()
    b_odd[1:] = b.flatten()
    cases.append(("odd addresses", a_odd[1:].view(a.shape),
                  b_odd[1:].view(b.shape)))
    cases.append(("evaluate_pod",) + tuple(extender_ops))
    for tag, a, b in cases:
        want64 = a.double() @ b.double().T
        if want64.abs().max() > I32_MAX:
            fail(f"incidence check operands at {tag} overflow int32")
        got = kernels.incidence_matmul(a, b)
        want = kernels.incidence_matmul_plain(a, b)
        err = max(err, abs_err(got, want))
        if not torch.equal(got, want):
            fail(f"incidence_matmul != plain at {tag}: "
                 f"{int((got != want).sum())} cells differ")
        checks += 1
    log(f"incidence_matmul == plain at {checks} shapes (exact; M in "
        f"1/6/16/17/130 x N in 1/255/{N_NODES} x L in 4104/5000/5008 with "
        f"+-2^22 weights and int32 extremes; L = 4100, padded by the "
        f"wrapper; operands at odd addresses; the verdict's operands)")
    # the C side refuses a plan it cannot run (tile_m = 32 does not exist)
    code = kernels._lib("incidence_matmul")(
        None, None, None, None, None, 6, N_NODES, 5008, 32, 1, 40, 5120,
        None)
    if code != kernels.BAD_PLAN:
        fail(f"incidence_matmul_launch took a bad plan (returned {code})")
    log("incidence launch refuses a bad plan (returns BAD_PLAN)")
    return err


def time_incidence(kernels, tag, a, b, flush):
    import torch
    m, l = a.shape
    n = b.shape[0]
    af, bf = a.float(), b.float()
    plan = kernels.incidence_plan(m, n, l)
    by = (4 * m * l + n * l + 4 * m * n) / HBM_BYTES_PER_S
    op = 2 * m * n * l / INT8_TENSOR_OPS_PER_S
    row = {
        "ms": time_ms(lambda: kernels.incidence_matmul(a, b)),
        "device_ms": time_device_ms(lambda: kernels.incidence_matmul(a, b)),
        "cold_ms": time_cold_ms(lambda: kernels.incidence_matmul(a, b),
                                flush),
        "cold_clean_ms": time_cold_ms(
            lambda: kernels.incidence_matmul(a, b), flush, clean=True),
        "plain_ms": time_ms(lambda: kernels.incidence_matmul_plain(a, b)),
        "plain_device_ms": time_device_ms(
            lambda: kernels.incidence_matmul_plain(a, b)),
        "library_ms": time_ms(lambda: torch.matmul(af, bf.T)),
        "library_device_ms": time_device_ms(lambda: torch.matmul(af, bf.T)),
        "library_cold_ms": time_cold_ms(lambda: torch.matmul(af, bf.T),
                                        flush),
        "library_cold_clean_ms": time_cold_ms(
            lambda: torch.matmul(af, bf.T), flush, clean=True),
        "bound_ms": 1e3 * max(by, op),
        "bound_by": "bytes" if by >= op else "operations",
        "shape": f"M={m} N={n} L={l}",
        "plan": {k: plan[k] for k in ("tile_m", "block_k", "split",
                                      "grid")},
    }
    # the two kernels' device times from the profiler: the pre-pass's share
    prof = profile_kernels(lambda: kernels.incidence_matmul(a, b)) or {}
    pre = sum(v for k, v in prof.items() if "incidence_prepass" in k)
    main = sum(v for k, v in prof.items() if "incidence_mma" in k)
    row["prepass_ms"] = pre if prof else "not measured"
    row["main_ms"] = main if prof else "not measured"
    row["prepass_share"] = pre / (pre + main) if prof else "not measured"
    row["tera_ops_per_s"] = \
        2 * m * n * l / (row["device_ms"] * 1e-3) / 1e12
    log(f"incidence_matmul {tag}: " + json.dumps(row))
    return row


def check_kernels(kernels, extender_ops):
    import numpy as np
    import torch
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    max_err = {"capacity_fit": 0, "incidence_matmul": 0}
    checks = 0
    shapes = [(16, N_NODES, 5), (16, N_NODES, 7)]
    shapes += [(p, n, r) for p in (1, 7, 130) for n in (1, 255, 257, N_NODES)
               for r in (5, 7)]
    # extended-resource columns: R > 8 runs the kernel's loop past its
    # register window
    shapes += [(p, n, r) for p, n in ((16, N_NODES), (7, 257), (130, 255))
               for r in (12, 40)]
    for p, n, r in shapes:
        for extremes in (False, True):
            ops = headroom_operands(
                rng, *capacity_operands(rng, p, n, r, dev), extremes)
            tag = f"P={p} N={n} R={r}{' extremes' if extremes else ''}"
            max_err["capacity_fit"] = max(
                max_err["capacity_fit"],
                check_capacity_outputs(kernels, ops, tag))
            checks += 1
    log(f"capacity kernel == plain at {checks} cases (exact; mask, mask "
        f"with override, wave mask + headroom; P in 1/7/16/130 x N in "
        f"1/255/257/{N_NODES} x R in 5/7, and R in 12/40 at three shapes; "
        f"zero-request classes, nodes without overlay, over-committed "
        f"nodes, pod counts at and past the ceiling, and int32 extremes "
        f"that wrap)")
    # the C side refuses arguments it cannot run (it returns before any
    # pointer is read: 1 stands for a device pointer)
    ptrs = (1,) * 8
    no_counts = (1, 1, 1, 1, None, None, 1, 1)
    for what, args in (("R = 4", ptrs + (16, N_NODES, 4)),
                       ("R = 41", ptrs + (16, N_NODES, 41)),
                       ("65,536 node blocks", ptrs + (16, 65536 * 128, 5)),
                       ("headroom without pod counts",
                        no_counts + (16, N_NODES, 5))):
        code = kernels._lib("capacity_fit")(*args, None)
        if code != kernels.BAD_PLAN:
            fail(f"capacity_fit_launch took {what} (returned {code})")
    log("capacity launch refuses R out of range, a grid past 65,535 node "
        "blocks and a headroom without counts")

    max_err["incidence_matmul"] = check_incidence(kernels, extender_ops, dev)
    inc_shapes = [("evaluate_pod",) + tuple(extender_ops)]
    for m in (640, 2560):
        for l in (2048, 4096):
            inc_shapes.append((f"M={m} L={l}",
                               *stacked_operands(rng, m, l, dev)))
    inc_shapes.append(("stack C=256 S=8 L=4096 wide weights",
                       *stacked_operands(rng, 2560, 4096, dev, wide=True)))
    for tag, a, b in inc_shapes[1:]:
        got = kernels.incidence_matmul(a, b)
        want = kernels.incidence_matmul_plain(a, b)
        max_err["incidence_matmul"] = max(max_err["incidence_matmul"],
                                          abs_err(got, want))
        if not torch.equal(got, want):
            fail(f"incidence_matmul != plain at {tag}")
        log(f"incidence_matmul == plain at {tag} {tuple(a.shape)} x "
            f"{tuple(b.shape)} (exact)")

    # timings at the main path's shapes, plus the larger incidence shapes
    req, alloc, requested = capacity_operands(rng, 16, N_NODES, 5, dev)
    p, r = req.shape
    n = alloc.shape[0]

    def cap_call():
        return kernels.capacity_fit(req, alloc, requested)

    prof = profile_kernels(cap_call)
    cap = {
        "ms": time_ms(cap_call),
        "device_ms": time_device_ms(cap_call),
        "profiler_ms": None if prof is None else {
            k: v for k, v in prof.items() if "capacity" in k},
        "plain_ms": time_ms(
            lambda: kernels.capacity_fit_plain(req, alloc, requested)),
        "plain_device_ms": time_device_ms(
            lambda: kernels.capacity_fit_plain(req, alloc, requested)),
        "library_ms": None,
        "bound_ms": 1e3 * max((4 * r * (p + 2 * n) + p * n) / HBM_BYTES_PER_S,
                              p * n * (2 * r + 1) / CUDA_CORE_OPS_PER_S),
        "bound_by": "bytes", "shape": f"P={p} N={n} R={r}",
    }
    # the wave's call: mask with the override and headroom in one launch
    ops = headroom_operands(rng, req, alloc, requested)

    def wave_call():
        return kernels.capacity_headroom(*ops)

    def wave_plain():
        return (kernels.capacity_fit_plain(ops[0], ops[2], ops[3], ops[1]),
                kernels.class_capacity_plain(*ops))

    cap.update({
        "wave_ms": time_ms(wave_call),
        "wave_device_ms": time_device_ms(wave_call),
        # the plain versions run ~70 ops a call: 5 calls a round keep them
        # inside the launch queue behind the spin
        "wave_plain_ms": time_ms(wave_plain, reps=5),
        "wave_plain_device_ms": time_device_ms(wave_plain, reps=5),
        # read [C,R] + 2 x [N,R] int32, zero_req [C], pod_count and
        # allowed_pods [N] int32; write [C,N] bool + [C,N] int32
        "wave_bound_ms": 1e3 * (4 * r * (p + 2 * n) + p + 8 * n
                                + 5 * p * n) / HBM_BYTES_PER_S,
    })
    prof = profile_kernels(wave_call)
    cap["wave_profiler_ms"] = None if prof is None else {
        k: v for k, v in prof.items() if "capacity" in k}
    log("capacity_fit: " + json.dumps(cap))

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    log_clocks("before the incidence timings")
    inc = {}
    for tag, a, b in inc_shapes:
        inc.setdefault("main", time_incidence(kernels, tag, a, b, flush))
    log_clocks("after them")
    del flush
    return {"capacity_fit": cap, "incidence_matmul": inc["main"]}, max_err


# ---------------------------------------------------------------- phases 3-4


def build_cache(nodes):
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    cache = SchedulerCache()
    for nd in nodes:
        cache.add_node(nd)
    return cache


def card_vs_cpu(hollow, SchedulingEngine):
    results = []
    for dev in ("cuda", "cpu"):
        eng = SchedulingEngine(build_cache(hollow.hollow_nodes(512)),
                               device=dev)
        r = eng.schedule(hollow.binpack_pods(3000, seed=7), mode="wave")
        results.append(([x.node_name for x in r], [x.fit_count for x in r],
                        eng.rr.counter))
    (s_g, f_g, c_g), (s_c, f_c, c_c) = results
    if s_g != s_c or f_g != f_c or c_g != c_c:
        diff = sum(a != b for a, b in zip(s_g, s_c))
        fail(f"card and CPU runs differ: {diff} placements, "
             f"RR {c_g} vs {c_c}")
    log(f"card == CPU: 512 nodes x 3000 binpack pods, "
        f"{sum(x is not None for x in s_g)} placed, RR counter {c_g}")


def audit(cache, results, n_pods, require_all):
    placed = sum(r.node_name is not None for r in results)
    if require_all and placed != n_pods:
        fail(f"{n_pods - placed} of {n_pods} pods unplaced")
    for r in results:
        if r.node_name is None and r.fit_count != 0:
            fail(f"unplaced pod {r.pod.name} reports fit_count "
                 f"{r.fit_count}")
    for name, info in cache.node_infos().items():
        node = info.node
        cpu = sum(p.resource_request().milli_cpu for p in info.pods)
        mem = sum(p.resource_request().memory for p in info.pods)
        if cpu > node.allocatable.milli_cpu \
                or mem > node.allocatable.memory \
                or len(info.pods) > node.allowed_pod_number:
            fail(f"node {name} over capacity: cpu {cpu}, mem {mem}, "
                 f"pods {len(info.pods)}")
    return placed


def spans(prefix: str, per: int = 1) -> dict:
    """Wall ms of the engine's timed spans under `prefix` since the last
    COUNTERS.reset(), divided by `per`."""
    from kubernetes_tpu_torch.utils.trace import COUNTERS
    snap = sorted(COUNTERS.snapshot().items())
    return {k: 1e3 * t / per for k, (_, t) in snap
            if k.startswith(prefix) and t > 0}


def drain(hollow, kernels, SchedulingEngine, profile, card):
    import torch
    from kubernetes_tpu_torch.utils.trace import COUNTERS
    nodes = hollow.hollow_nodes(N_NODES)
    cache = build_cache(nodes)
    eng = SchedulingEngine(cache)   # device=None: the card
    pods = getattr(hollow, f"{profile}_pods")(N_PODS)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    COUNTERS.reset()
    t0 = time.perf_counter()
    results = eng.schedule(pods, mode="wave")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    placed = audit(cache, results, N_PODS, require_all=profile == "density")
    log(f"drain {profile}: {N_NODES} nodes x {N_PODS} pods, placed "
        f"{placed}, waves {eng.last_wave_stats}, wall {wall:.3f} s, "
        f"{N_PODS / wall:.0f} pods/s, launches {launches} [{card}]")
    log(f"drain {profile} spans (ms): " + json.dumps(spans("engine.")))
    # one capacity launch per wave, plus one per pod of a strict-loop
    # finish (padded to its bucket)
    from kubernetes_tpu_torch.ops import predicates as preds
    stats = eng.last_wave_stats
    want = stats["waves"] + (preds.bucket(stats["stragglers"])
                             if stats["stragglers"] else 0)
    if launches["capacity_fit"] != want:
        fail(f"drain {profile}: {launches['capacity_fit']} capacity "
             f"launches for {stats}")
    # both outputs of the capacity kernel against their plain versions on
    # the node state this drain left behind and on the profile's class rows
    from kubernetes_tpu_torch.state.classes import ClassBatch
    eng._refresh()
    nd = eng._nodes_on_device()
    fresh = getattr(hollow, f"{profile}_pods")(64, seed=1, namespace="chk")
    cls = preds.pod_arrays_padded(ClassBatch(fresh, eng.snapshot).reps_batch,
                                  16, torch.device("cuda"))
    check_capacity_outputs(
        kernels, (cls["req"], cls["zero_req"], nd["alloc"], nd["requested"],
                  nd["pod_count"], nd["allowed_pods"]),
        f"the {profile} drain's end state")
    return launches, wall


# ---------------------------------------------------------------- phase 5


def extender_cluster(hollow, types):
    from kubernetes_tpu_torch.state.snapshot import ClusterSnapshot
    nodes = hollow.hollow_nodes(N_NODES)
    cache = build_cache(nodes)
    for i, p in enumerate(hollow.mixed_affinity_pods(3000, seed=11)):
        p.node_name = nodes[i % N_NODES].name
        cache.add_pod(p)
    snap = ClusterSnapshot()
    snap.refresh(cache.node_infos())
    wl = [types.WorkloadObject("Service", "web", "bench",
                               match_labels={"app": "web-2"})]
    probes = (hollow.mixed_affinity_pods(40, seed=12)[::2]
              + hollow.affinity_pods(8, seed=13))
    return cache, snap, wl, probes


def incidence_operands(cache, snap, wl, probe, affinity, ClassBatch):
    """The stacked A and the labels that evaluate_pod hands the incidence
    kernel for `probe` (same host steps as evaluate_pod)."""
    import torch
    dev = torch.device("cuda")
    infos = cache.node_infos()
    all_pairs, aff_pairs = affinity.collect_pod_pairs(infos)
    affinity.intern_topology_pairs(snap, [probe], aff_pairs)
    batch = ClassBatch([probe], snap)
    adata = affinity.AffinityData(batch.reps, snap, all_pairs, aff_pairs,
                                  wl, 1)
    a = affinity.stack_static(adata.device_arrays(dev))
    b = torch.from_numpy(snap.labels.copy()).to(dev)
    return a, b


def verdicts(cache, snap, wl, probes, kernels, evaluate_pod, priorities,
             card):
    import numpy as np
    import torch
    from kubernetes_tpu_torch.utils.trace import COUNTERS
    infos = cache.node_infos()
    for p in probes:  # warm-up, and vocab growth lands before counting
        evaluate_pod(p, infos, snap, priorities, wl)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    COUNTERS.reset()
    card_out, lat = [], []
    for p in probes:
        t0 = time.perf_counter()
        m, s = evaluate_pod(p, infos, snap, priorities, wl)
        lat.append(time.perf_counter() - t0)
        card_out.append((m, s))
    launches = dict(kernels.LAUNCHES)
    per_call = spans("extender.", len(probes))
    for p, (m, s) in zip(probes, card_out):
        mc, sc = evaluate_pod(p, infos, snap, priorities, wl, device="cpu")
        if not (np.array_equal(m, mc) and np.array_equal(s, sc)):
            fail(f"evaluate_pod card != CPU for {p.name}")
    log(f"evaluate_pod: {len(probes)} probes, card == CPU (fits and "
        f"scores), verdict latency median {1e3 * statistics.median(lat):.2f}"
        f" ms (min {1e3 * min(lat):.2f}), launches {launches} [{card}]")
    log("evaluate_pod spans (mean ms per call): " + json.dumps(per_call))
    return launches


# ---------------------------------------------------------------- phase 6

PIPE_COUNTERS = ("engine.wave_dispatch", "engine.wave_dispatch_pods",
                 "engine.affinity_strict_tail", "engine.tail_rounds",
                 "engine.tail_round_dispatch", "engine.wave_tail_dispatch",
                 "engine.affinity_fence_requeues",
                 "engine.fence_reason_capacity", "engine.host_fetch_bytes")
# the mesh's own counters (phase 11)
MESH_COUNTERS = ("engine.reduce_candidate_rows", "engine.shard_delta_rows",
                 "engine.shard_upload_bytes", "engine.device_upload_arrays")


class OperandSpy:
    """Wraps the two kernel wrappers during a main-path run and keeps a
    copy of the operands of the first launch at each distinct shape, so
    that the kernels can be held against their plain versions afterwards
    on exactly what the path gave them. The wrapped functions are the
    module attributes every caller looks up at call time."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.cap = {}
        self.inc = {}
        # (kernel, thread name) -> calls on the card: a mesh's SPMD
        # shards run in threads named spmd-shard-<d>
        self.by_thread = {}
        self._real = (kernels.capacity_fit, kernels.capacity_headroom,
                      kernels.incidence_matmul)

    def _note(self, name, t):
        if t.is_cuda:
            import threading
            key = (name, threading.current_thread().name)
            self.by_thread[key] = self.by_thread.get(key, 0) + 1

    def __enter__(self):
        k = self.kernels
        fit, head, inc = self._real

        def capacity_fit(pod_req, alloc, requested, zero_req=None):
            self._note("capacity_fit", pod_req)
            key = ("mask", tuple(pod_req.shape), tuple(alloc.shape),
                   zero_req is not None)
            if pod_req.is_cuda and key not in self.cap:
                self.cap[key] = tuple(
                    None if t is None else t.clone()
                    for t in (pod_req, zero_req, alloc, requested))
            return fit(pod_req, alloc, requested, zero_req)

        def capacity_headroom(*ops):
            self._note("capacity_fit", ops[0])
            key = ("wave", tuple(ops[0].shape), tuple(ops[2].shape), True)
            if ops[0].is_cuda and key not in self.cap:
                self.cap[key] = tuple(t.clone() for t in ops)
            return head(*ops)

        def incidence_matmul(a, b_t):
            self._note("incidence_matmul", a)
            key = (tuple(a.shape), tuple(b_t.shape))
            if a.is_cuda and key not in self.inc:
                self.inc[key] = (a.clone(), b_t.clone())
            return inc(a, b_t)

        k.capacity_fit = capacity_fit
        k.capacity_headroom = capacity_headroom
        k.incidence_matmul = incidence_matmul
        return self

    def __exit__(self, *exc):
        k = self.kernels
        k.capacity_fit, k.capacity_headroom, k.incidence_matmul = self._real
        return False

    def shard_calls(self, name):
        """Calls of kernel `name` per SPMD shard thread, by shard index."""
        pre = "spmd-shard-"
        return {int(t[len(pre):]): n for (k, t), n in self.by_thread.items()
                if k == name and t.startswith(pre)}

    def shapes(self):
        """The distinct launch shapes seen: capacity (C, N, R), incidence
        (M, N, L) with L as the caller gave it (the wrapper pads L to a
        multiple of 8)."""
        cap = sorted({(k[1][0], k[2][0], k[1][1]) for k in self.cap})
        inc = sorted({(a[0], b[0], a[1]) for a, b in self.inc})
        return cap, inc

    def check(self, tag):
        """Kernel == plain on every captured operand set; returns the
        largest absolute difference per kernel (0 when exact)."""
        import torch
        k = self.kernels
        err = {"capacity_fit": 0, "incidence_matmul": 0}
        for key, ops in sorted(self.cap.items(), key=str):
            if key[0] == "wave":
                err["capacity_fit"] = max(err["capacity_fit"],
                                          check_capacity_outputs(
                                              k, ops, f"{tag} {key}"))
                continue
            pod_req, zero_req, alloc, requested = ops
            got = k.capacity_fit(pod_req, alloc, requested, zero_req)
            want = k.capacity_fit_plain(pod_req, alloc, requested,
                                        zero_req)
            err["capacity_fit"] = max(err["capacity_fit"],
                                      abs_err(got, want))
            if not torch.equal(got, want):
                fail(f"{tag}: capacity mask != plain at {key}")
        for key, (a, b) in sorted(self.inc.items()):
            got = k.incidence_matmul(a, b)
            want = k.incidence_matmul_plain(a, b)
            err["incidence_matmul"] = max(err["incidence_matmul"],
                                          abs_err(got, want))
            if not torch.equal(got, want):
                fail(f"{tag}: incidence_matmul != plain at {key}")
        log(f"{tag}: kernel == plain at every launch shape of the run "
            f"(capacity {sorted(self.cap, key=str)}; incidence "
            f"{sorted(self.inc)})")
        return err


def pipelined(mods, profile, n_nodes, n_pods, device=None, overlap=True,
              max_batch=0, spy=None, mesh=None):
    """One drain of `profile` through Scheduler.run_until_drained on a
    fresh store, as bench.py run_once runs it (on `mesh` when given).
    Returns (api, totals, counters, spans, wall, launches)."""
    import torch
    hollow, api_mod, Scheduler, kernels, COUNTERS = mods
    api = api_mod.ApiServerLite(max_log=max(200_000,
                                            3 * (n_nodes + n_pods)))
    hollow.load_cluster(api, hollow.hollow_nodes(n_nodes),
                        hollow.PROFILES[profile](n_pods))
    sched = Scheduler(api, record_events=False, device=device, mesh=mesh)
    sched.start()
    # whether each dispatch returned while its wave job was still running
    # (the overlap the pipeline exists for)
    busy = []
    dispatch = sched.engine.dispatch_waves

    def dispatch_and_note(*args, **kw):
        handle = dispatch(*args, **kw)
        if handle is not None:
            busy.append(not handle.is_ready())
        return handle

    sched.engine.dispatch_waves = dispatch_and_note
    # the harvest's whole wall time (its device wait, tail, fence and
    # assume are the engine's own pipeline.* spans)
    harvest_s = []
    harvest = sched.engine.harvest_waves

    def timed_harvest(handle):
        t = time.perf_counter()
        out = harvest(handle)
        harvest_s.append(time.perf_counter() - t)
        return out

    sched.engine.harvest_waves = timed_harvest
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    COUNTERS.reset()
    t0 = time.perf_counter()
    if spy is not None:
        with spy:
            tot = sched.run_until_drained(max_batch=max_batch,
                                          overlap=overlap)
    else:
        tot = sched.run_until_drained(max_batch=max_batch, overlap=overlap)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    snap = COUNTERS.snapshot()
    counters = {k: snap.get(k, (0, 0.0))[0] for k in PIPE_COUNTERS}
    if mesh is not None or os.environ.get("GRAFT_SANITIZE") == "1":
        counters.update({k: snap.get(k, (0, 0.0))[0]
                         for k in MESH_COUNTERS})
    counters["dispatches_returned_busy"] = sum(busy)
    span_ms = {k: 1e3 * t for k, (_, t) in sorted(snap.items())
               if k.startswith("pipeline.") and t > 0}
    span_ms["harvest_waves"] = 1e3 * sum(harvest_s)
    sched.engine.close()
    return api, tot, counters, span_ms, wall, launches


def audit_store(api, profile, n_pods, exempt=frozenset()):
    """Audit a drain from the store: every pod bound or provably
    unschedulable (fits no node of the final state; pods in `exempt`, the
    members of gangs left wholly pending, are not checked alone), no node
    over its CPU, memory or pod count, no pod bound twice; for
    mixed_affinity and gang_mix the required (anti-)affinity of the
    mixed_affinity pods. Returns (bound, unbound)."""
    import numpy as np
    from kubernetes_tpu_torch.models.hollow import HOSTNAME_KEY, ZONE_KEY
    pods, _ = api.list("Pod")
    nodes = {n.name: n for n in api.list("Node")[0]}
    if len(pods) != n_pods:
        fail(f"{profile}: {len(pods)} pods in the store, {n_pods} created")
    used = {name: [0, 0, 0] for name in nodes}
    for p in pods:
        if p.node_name:
            r = p.resource_request()
            u = used[p.node_name]
            u[0] += r.milli_cpu
            u[1] += r.memory
            u[2] += 1
    names = sorted(nodes)
    alloc_cpu = np.array([nodes[n].allocatable.milli_cpu for n in names])
    alloc_mem = np.array([nodes[n].allocatable.memory for n in names])
    allowed = np.array([nodes[n].allowed_pod_number for n in names])
    u = np.array([used[n] for n in names], dtype=np.int64)
    over = (u[:, 0] > alloc_cpu) | (u[:, 1] > alloc_mem) | (u[:, 2] > allowed)
    if over.any():
        i = int(np.nonzero(over)[0][0])
        fail(f"{profile}: node {names[i]} over allocatable: {u[i]}")
    binds = {}
    for e in api._log:
        if e.kind == "Pod" and e.type == "MODIFIED" and e.obj.node_name:
            binds.setdefault(e.obj.key(), []).append(e.obj.node_name)
    dups = sum(1 for v in binds.values() if len(v) > 1)
    if dups:
        fail(f"{profile}: {dups} pods bound more than once")
    unbound = [p for p in pods if not p.node_name]
    free_cpu = alloc_cpu - u[:, 0]
    free_mem = alloc_mem - u[:, 1]
    room = u[:, 2] < allowed
    for shape in {(p.resource_request().milli_cpu,
                   p.resource_request().memory) for p in unbound
                  if p.key() not in exempt}:
        if ((free_cpu >= shape[0]) & (free_mem >= shape[1]) & room).any():
            fail(f"{profile}: an unbound pod of {shape} fits a node")
    if profile in ("mixed_affinity", "gang_mix"):
        zone_of = {n: nodes[n].labels.get(ZONE_KEY) for n in names}
        host_of = {n: nodes[n].labels.get(HOSTNAME_KEY) for n in names}
        anti, labeled, group_zones = {}, {}, {}
        for p in pods:
            if not p.node_name:
                continue
            app = p.labels.get("app", "")
            key = (host_of[p.node_name], app)
            labeled[key] = labeled.get(key, 0) + 1
            aff = p.affinity
            if aff is not None and aff.pod_anti_affinity is not None:
                anti[key] = anti.get(key, 0) + 1
            if aff is not None and aff.pod_affinity is not None:
                group_zones.setdefault(app, set()).add(zone_of[p.node_name])
        # one iso-* pod of an app per host, and no other pod labeled with
        # that app beside it (the symmetry direction)
        bad = [k for k, c in anti.items() if c > 1 or labeled[k] > 1]
        if bad:
            fail(f"{profile}: anti-affinity broken on {len(bad)} "
                 f"(host, app) pairs, e.g. {bad[0]}")
        split = {a: z for a, z in group_zones.items() if len(z) > 1}
        if split or not group_zones:
            fail(f"{profile}: affinity groups across zones: {split}")
        log(f"{profile}: affinity audit clean ({sum(anti.values())} "
            f"anti-affinity pods on distinct hosts, "
            f"{len(group_zones)} groups each in one zone)")
    return len(pods) - len(unbound), len(unbound)


def placements(api):
    return {p.key(): p.node_name for p in api.list("Pod")[0]}


def pipelined_drains(mods, card):
    """Phase 6. Returns (launches summed over the three drains, max
    abs err per kernel on this path, the density and mixed_affinity
    placements at 5,000 x 30,000 and the CPU's at 512 x 3,000 (phase 11
    holds the mesh's runs against them))."""
    kernels = mods[3]
    total = {k: 0 for k in kernels.LAUNCHES}
    err = {k: 0 for k in kernels.LAUNCHES}
    flat = {}
    for profile in ("density", "binpack", "mixed_affinity"):
        spy = OperandSpy(kernels)
        api, tot, cnt, span_ms, wall, launches = pipelined(
            mods, profile, N_NODES, N_PODS, spy=spy)
        cap_shapes, inc_shapes = spy.shapes()
        bound, unbound = audit_store(api, profile, N_PODS)
        if profile != "binpack" and unbound:
            fail(f"pipelined {profile}: {unbound} pods unbound")
        if profile != "binpack":
            flat[profile] = placements(api)
        log(f"pipelined drain {profile}: {N_NODES} nodes x {N_PODS} pods "
            f"through Scheduler.run_until_drained, bound {bound}, "
            f"unschedulable {unbound}, wall {wall:.3f} s, "
            f"{N_PODS / wall:.0f} pods/s, totals {json.dumps(tot)} "
            f"[{card}]")
        log(f"pipelined drain {profile} spans (ms): " + json.dumps(span_ms))
        log(f"pipelined drain {profile} counters: " + json.dumps(cnt))
        log(f"pipelined drain {profile} launches {launches}, shapes "
            f"(capacity (C, N, R)) {cap_shapes}, "
            f"(incidence (M, N, L), L before the wrapper's padding to 8) "
            f"{inc_shapes}")
        if launches["capacity_fit"] == 0:
            fail(f"pipelined {profile}: no capacity launch")
        if profile == "mixed_affinity":
            if tot["bound"] != N_PODS:
                fail(f"pipelined mixed_affinity bound {tot['bound']}")
            if launches["incidence_matmul"] == 0:
                fail("pipelined mixed_affinity: no incidence launch")
        for k, v in spy.check(f"pipelined {profile}").items():
            err[k] = max(err[k], v)
        for k, v in launches.items():
            total[k] += v
    # card == CPU, and overlap on == off, at 512 x 3,000 mixed_affinity
    runs = {}
    for tag, dev, overlap in (("card", None, True),
                              ("card, overlap off", None, False),
                              ("CPU", "cpu", True)):
        api, tot, cnt, span_ms, wall, _l = pipelined(
            mods, "mixed_affinity", 512, 3000, device=dev,
            overlap=overlap, max_batch=512)
        log(f"pipelined mixed_affinity 512 x 3000 ({tag}): wall "
            f"{wall:.3f} s, spans (ms) {json.dumps(span_ms)}")
        runs[tag] = (placements(api), tot, cnt)
    ref = runs["CPU"]
    for tag in ("card", "card, overlap off"):
        got = runs[tag]
        diff = sum(got[0][k] != v for k, v in ref[0].items())
        if diff or got[1] != ref[1]:
            fail(f"pipelined mixed_affinity 512 x 3000: {tag} != CPU "
                 f"({diff} placements; {got[1]} vs {ref[1]})")
    log(f"pipelined mixed_affinity 512 x 3000 (chunks of 512): card == "
        f"card with overlap off == CPU, {ref[1]['bound']} bound, "
        f"counters {json.dumps(ref[2])}")
    flat["check"] = ref[:2]
    return total, err, flat


# ---------------------------------------------------------------- phase 7

EXT_FLEET_PODS = 1000
EXT_FRONTENDS = 8
EXT_LATENCY_ROUNDS = 20
EXT_COUNTERS = ("extender.fused_eval", "extender.fused_eval_batch",
                "extender.batch_classes", "extender.result_hit",
                "extender.oracle_eval", "extender.refresh_full",
                "extender.refresh_hint", "extender.affinity_data_build")


class Wire:
    """One keep-alive HTTP connection to a sidecar; each call returns
    (status, raw body)."""

    def __init__(self, port: int):
        import http.client
        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=120)

    def post(self, path: str, body) -> tuple:
        raw = body if isinstance(body, (str, bytes)) \
            else json.dumps(body, separators=(",", ":"))
        self.conn.request("POST", "/scheduler/" + path, raw,
                          {"Content-Type": "application/json"})
        resp = self.conn.getresponse()
        return resp.status, resp.read()

    def close(self) -> None:
        self.conn.close()


def ext_counters() -> dict:
    from kubernetes_tpu_torch.utils.trace import COUNTERS
    snap = COUNTERS.snapshot()
    return {k: snap.get(k, (0, 0.0))[0] for k in EXT_COUNTERS}


def ext_oracle_probes(hollow, types):
    """Two pods for the exact host oracle: nine host ports (the encoding
    holds eight), and five ORed node-selector terms (it holds four) over
    zone values already in the label vocab (the zone-affinity pods intern
    them), so the pod reaches the encoding and not vocab isolation."""
    zones = hollow.ZONES
    terms = [types.NodeSelectorTerm([types.SelectorRequirement(
        hollow.ZONE_KEY, types.SelectorOperator.IN, [zones[i % len(zones)]])])
        for i in range(5)]
    return [types.make_pod("oracle-ports", namespace="bench", cpu=100,
                           memory=256 << 20, ports=list(range(7000, 7009))),
            types.make_pod("oracle-terms", namespace="bench", cpu=100,
                           memory=256 << 20, affinity=types.Affinity(
                               node_affinity=types.NodeAffinity(
                                   required_terms=terms)))]


def ext_batch_pods(hollow, types):
    """Ten distinct classes for one coalesced batch: the mixed-affinity
    shapes (hostname anti-affinity, zone affinity, anti-affinity targets,
    plain) and plain pods, each at a CPU request no earlier probe used,
    so none is a memo hit."""
    src = hollow.mixed_affinity_pods(100, seed=31)
    pods = [types.make_pod(f"batch-{k}", namespace="bench", cpu=111 + k,
                           memory=256 << 20, labels=dict(src[i].labels),
                           affinity=src[i].affinity)
            for k, i in enumerate((0, 1, 2, 15, 16, 17, 18, 22))]
    pods += [types.make_pod(f"batch-plain-{k}", namespace="bench",
                            cpu=131 + k, memory=256 << 20) for k in range(2)]
    return pods


def batch_rows(backend, n_classes):
    """M of the coalesced batch's stacked static incidence product,
    C_pad * (S + 2), read off its encoded entry in the backend's LRU."""
    for enc in backend.eval_cache._lru.values():
        if enc.aff is not None and enc.batch.num_classes == n_classes:
            c, s, _ = enc.aff["aff_allow"].shape
            return c * (s + 2)
    fail(f"extender: no encoded entry of {n_classes} classes with live "
         f"affinity in the backend's LRU")


def sidecar(ext, backend):
    srv = ext.ExtenderHTTPServer(backend, prefix="/scheduler")
    srv.start()
    return srv


def serial_probes(wire, serde, probes):
    """/filter then /prioritize for every probe over the whole cluster
    (NodeNames null); the (status, body) pairs in order."""
    out = []
    for p in probes:
        enc = serde.encode_pod(p)
        for verb in ("filter", "prioritize"):
            out.append(wire.post(verb, {"Pod": enc, "NodeNames": None,
                                        "Nodes": None}))
    return out


def extender_latency(port, serde, types, rounds=EXT_LATENCY_ROUNDS):
    """One /filter + /prioritize round over real HTTP, as bench.py
    measure_extender_latency defines it: a fresh connection per verb,
    NodeNames null, the first three rounds not counted. Returns the
    sorted round times (s)."""
    import http.client
    lat = []
    for i in range(rounds + 3):
        pod = types.make_pod(f"ext-{i}", cpu=100, memory=256 << 20)
        body = json.dumps({"Pod": serde.encode_pod(pod), "NodeNames": None,
                           "Nodes": None})
        t0 = time.perf_counter()
        for verb in ("filter", "prioritize"):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("POST", f"/scheduler/{verb}", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            conn.close()
            if resp.status != 200:
                fail(f"extender latency: HTTP {resp.status} on /{verb}")
        if i >= 3:
            lat.append(time.perf_counter() - t0)
    return sorted(lat)


def fleet(port, serde, pods, node_names, frontends=EXT_FRONTENDS):
    """Concurrent compat scheduleOne frontends over real HTTP, no sleeps
    (bench.py measure_compat_scheduleone): each frontend runs /filter with
    the whole candidate list, /prioritize over the survivors, picks the top
    score and /binds with the verdict's SnapshotGen, an IdempotencyKey and
    the pod's spec. A 409 is retried with a fresh verdict; any other
    non-200 fails. Returns (wall s, the tally of bound, unschedulable and
    409s, the sorted times of the rounds that bound)."""
    import threading
    names_json = json.dumps(node_names, separators=(",", ":"))
    per = (len(pods) + frontends - 1) // frontends
    lock = threading.Lock()
    errors, rounds = [], []
    tally = {"bound": 0, "unschedulable": 0, "conflicts": 0}

    def drive(d):
        wire = Wire(port)
        try:
            for pod in pods[d * per:(d + 1) * per]:
                enc = json.dumps(serde.encode_pod(pod),
                                 separators=(",", ":"))
                for attempt in range(50):
                    t0 = time.perf_counter()
                    status, body = wire.post(
                        "filter", '{"Pod":' + enc + ',"NodeNames":'
                        + names_json + ',"Nodes":null}')
                    if status != 200:
                        raise RuntimeError(f"/filter HTTP {status}: "
                                           f"{body[:200]!r}")
                    verdict = json.loads(body)
                    passed = verdict["NodeNames"] or []
                    if not passed:
                        with lock:
                            tally["unschedulable"] += 1
                        break
                    passed_json = names_json \
                        if len(passed) == len(node_names) \
                        else json.dumps(passed, separators=(",", ":"))
                    status, body = wire.post(
                        "prioritize", '{"Pod":' + enc + ',"NodeNames":'
                        + passed_json + ',"Nodes":null}')
                    if status != 200:
                        raise RuntimeError(f"/prioritize HTTP {status}: "
                                           f"{body[:200]!r}")
                    host = max(json.loads(body),
                               key=lambda e: e["Score"])["Host"]
                    status, body = wire.post("bind", {
                        "PodName": pod.name, "PodNamespace": pod.namespace,
                        "PodUID": pod.uid, "Node": host,
                        "SnapshotGen": verdict["SnapshotGen"],
                        "IdempotencyKey": f"{pod.key()}:{attempt}",
                        "Pod": json.loads(enc)})
                    dt = time.perf_counter() - t0
                    out = json.loads(body)
                    if status == 409:
                        with lock:
                            tally["conflicts"] += 1
                        continue
                    if status != 200 or out.get("Error"):
                        raise RuntimeError(f"/bind HTTP {status}: {out}")
                    with lock:
                        tally["bound"] += 1
                        rounds.append(dt)
                    break
                else:
                    raise RuntimeError(f"{pod.key()}: 50 fence conflicts")
        except Exception as e:  # noqa: BLE001 — fails the phase below
            with lock:
                errors.append(f"frontend {d}: {type(e).__name__}: {e}")
        finally:
            wire.close()

    threads = [threading.Thread(target=drive, args=(d,))
               for d in range(frontends)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        fail("extender fleet: a frontend did not finish in 600 s")
    if errors:
        fail(f"extender fleet: {errors[:3]}")
    return wall, tally, sorted(rounds)


def extender_service(mods, card, timing):
    """Phase 7: the scheduler-extender sidecar at 5,000 hollow nodes, on
    the card and, for the serial probes and one coalesced batch, on the
    CPU. Returns (launches, max abs err per kernel on this path)."""
    import numpy as np
    import torch
    (hollow, types, kernels, serde, ext, api_mod, churn, COUNTERS) = mods
    t_phase = time.perf_counter()
    nodes = hollow.hollow_nodes(N_NODES)
    for i, n in enumerate(nodes):
        n.labels["zone"] = f"z{i % 16}"
    bound = hollow.mixed_affinity_pods(3000, seed=11)
    for i, p in enumerate(bound):
        p.node_name = nodes[i % N_NODES].name
    api = api_mod.ApiServerLite(max_log=200_000)
    for n in nodes:
        api.create("Node", n)
    for p in bound:
        api.create("Pod", p)
    fleet_pods = hollow.density_pods(EXT_FLEET_PODS, seed=41)
    for p in fleet_pods:
        api.create("Pod", p)
    nodes_body = json.dumps({"items": [serde.encode_node(n) for n in nodes]},
                            separators=(",", ":"))
    pods_body = json.dumps({"items": [serde.encode_pod(p) for p in bound]},
                           separators=(",", ":"))
    backends = {
        "card": ext.TPUExtenderBackend(
            binder=churn.extender_store_binder(api)),
        "CPU": ext.TPUExtenderBackend(device="cpu")}
    servers = {tag: sidecar(ext, b) for tag, b in backends.items()}
    try:
        for tag, b in backends.items():
            wire = Wire(servers[tag].port)
            for path, body in (("cache/nodes", nodes_body),
                               ("cache/pods", pods_body)):
                status, out = wire.post(path, body)
                if status != 200:
                    fail(f"extender {tag}: {path} HTTP {status}: {out!r}")
            wire.close()
            # warm as bench.py _build_extender does
            b.filter(types.make_pod("warm", cpu=100, memory=256 << 20),
                     None, None)
            b.prioritize(types.make_pod("warm2", cpu=100, memory=256 << 20),
                         None, None)
        log(f"extender: {N_NODES} nodes (zone labels z0..z15) and "
            f"{len(bound)} bound mixed_affinity pods synced over "
            f"/cache/nodes and /cache/pods into the card and CPU sidecars "
            f"in {time.perf_counter() - t_phase:.1f} s")
        probes = (hollow.mixed_affinity_pods(40, seed=12)[::2]
                  + hollow.affinity_pods(8, seed=13)
                  + ext_oracle_probes(hollow, types))
        batch_pods = ext_batch_pods(hollow, types)
        spy = OperandSpy(kernels)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        COUNTERS.reset()
        # card, serially: the probes over HTTP, then one coalesced batch
        wire = Wire(servers["card"].port)
        t0 = time.perf_counter()
        with spy:
            card_bodies = serial_probes(wire, serde, probes)
            t_serial = time.perf_counter() - t0
            card_batch = backends["card"]._eval_many(batch_pods)
        wire.close()
        stacked_m = batch_rows(backends["card"], len(batch_pods))
        counters = ext_counters()
        cpu_t0 = time.perf_counter()
        wire = Wire(servers["CPU"].port)
        cpu_bodies = serial_probes(wire, serde, probes)
        wire.close()
        cpu_batch = backends["CPU"]._eval_many(batch_pods)
        cpu_s = time.perf_counter() - cpu_t0
        bad = [i for i, (a, c) in enumerate(zip(card_bodies, cpu_bodies))
               if a != c]
        if bad or any(s != 200 for s, _ in card_bodies):
            i = bad[0] if bad else 0
            fail(f"extender: card != CPU on {len(bad)} of "
                 f"{len(card_bodies)} responses (first: {probes[i // 2].name}"
                 f" {card_bodies[i][1][:160]!r} vs {cpu_bodies[i][1][:160]!r})")
        for p, a, c in zip(batch_pods, card_batch, cpu_batch):
            if not (np.array_equal(a.m, c.m) and np.array_equal(a.s, c.s)
                    and a.s.dtype == c.s.dtype):
                fail(f"extender coalesced batch: card != CPU for {p.name}")
        n_pass = [len(json.loads(b)["NodeNames"])
                  for b in (body for _s, body in card_bodies[::2])]
        log(f"extender serial probes: {len(probes)} pods x /filter + "
            f"/prioritize over HTTP, card == CPU on all "
            f"{len(card_bodies)} response bodies (nodes passed per probe "
            f"{min(n_pass)}..{max(n_pass)}); card {t_serial:.3f} s, CPU "
            f"(with the batch) {cpu_s:.3f} s; coalesced batch of "
            f"{len(batch_pods)} classes through _eval_many: card == CPU "
            f"(fits and scores) [{card}]")
        log("extender counters (card, probes + batch): "
            + json.dumps(counters))
        if counters["extender.fused_eval_batch"] < 1:
            fail("extender: the coalesced batch never ran _fused_eval_batch")
        if counters["extender.batch_classes"] < 8:
            fail(f"extender: the batch held "
                 f"{counters['extender.batch_classes']} classes, not >= 8")
        if counters["extender.result_hit"] < 1:
            fail("extender: /prioritize never rode /filter's evaluation")
        if counters["extender.oracle_eval"] < 2:
            fail("extender: the host-oracle probes never took the oracle")
        # the HTTP verdict round, then the fleet (card only)
        lat = extender_latency(servers["card"].port, serde, types)
        p50 = 1e3 * lat[len(lat) // 2]
        p99 = 1e3 * lat[min(int(len(lat) * 0.99), len(lat) - 1)]
        log(f"extender verdict round (/filter + /prioritize over HTTP, "
            f"bench.py measure_extender_latency): p50 {p50:.2f} ms, p99 "
            f"{p99:.2f} ms over {len(lat)} rounds [{card}]")
        COUNTERS.reset()
        svc0 = backends["card"]._counters_snapshot()
        with spy:
            wall, tally, rounds = fleet(
                servers["card"].port, serde, fleet_pods,
                list(backends["card"].engine.snapshot.node_names))
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        fleet_counters = ext_counters()
        svc = {k: v - svc0.get(k, 0)
               for k, v in backends["card"]._counters_snapshot().items()}
    finally:
        for srv in servers.values():
            srv.stop()
        for b in backends.values():
            b.engine.close()
    # the store after the fleet: every pod bound or fitting no node, no
    # node over CPU, memory or pods, no pod bound twice
    n_bound, n_unbound = audit_store(api, "extender fleet",
                                     len(bound) + len(fleet_pods))
    if n_unbound or tally["bound"] != len(fleet_pods):
        fail(f"extender fleet: {n_unbound} pods unbound, "
             f"{tally['bound']} of {len(fleet_pods)} bound by the frontends")
    reasons = {k[len("bind_conflict_reason_"):]: v for k, v in svc.items()
               if k.startswith("bind_conflict_reason_")}
    if sum(reasons.values()) != tally["conflicts"] \
            or svc.get("bind_conflicts", 0) != tally["conflicts"]:
        fail(f"extender fleet: 409s seen {tally['conflicts']}, fence "
             f"conflicts {svc.get('bind_conflicts', 0)} by reason {reasons}")
    batches = fleet_counters["extender.fused_eval_batch"]
    n_coal = svc.get("coalesce_batches", 0)
    n_req = svc.get("coalesce_requests", 0)
    p50_round = 1e3 * rounds[len(rounds) // 2]
    p99_round = 1e3 * rounds[min(int(len(rounds) * 0.99), len(rounds) - 1)]
    log(f"extender fleet: {EXT_FRONTENDS} compat scheduleOne frontends over "
        f"HTTP, {len(fleet_pods)} density pods bound in {wall:.3f} s = "
        f"{len(fleet_pods) / wall:.1f} scheduleOnes/s; scheduleOne round "
        f"p50 {p50_round:.2f} ms p99 {p99_round:.2f} ms; coalesced batches "
        f"{n_coal} for {n_req} requests ({n_req / max(n_coal, 1):.2f} a "
        f"batch), of which {batches} held several classes (fused [C, N], "
        f"{fleet_counters['extender.batch_classes']} classes) and the rest "
        f"at most one (single-pod evaluations "
        f"{fleet_counters['extender.fused_eval']}, memo hits "
        f"{fleet_counters['extender.result_hit']}); fence conflicts "
        f"{tally['conflicts']} by reason {reasons}, fence skipped "
        f"{svc.get('bind_fence_skipped', 0)}; store audit clean ({n_bound} "
        f"bound, 0 duplicate binds) [{card}]")
    log("extender fleet counters: " + json.dumps(
        {**fleet_counters, **{k: v for k, v in sorted(svc.items())}}))
    cap_shapes, inc_shapes = spy.shapes()
    log(f"extender launches {launches}, shapes (capacity (C, N, R)) "
        f"{cap_shapes}, (incidence (M, N, L)) {inc_shapes}")
    for k in ("capacity_fit", "incidence_matmul"):
        if launches[k] == 0:
            fail(f"extender: no {k} launch on this path")
    err = spy.check("extender")
    # the batch's stacked static product, A [C_pad * (S + 2), L]
    stacked = [k for k in spy.inc if k[0][0] == stacked_m]
    if not stacked:
        fail(f"extender: no incidence launch at the batch's stacked "
             f"M = {stacked_m} (shapes {inc_shapes})")
    stacked = stacked[0]
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                        device=torch.device("cuda"))
    a, b = spy.inc[stacked]
    timing["incidence_matmul"]["extender_batch"] = time_incidence(
        kernels, "extender batch (stacked)", a, b, flush)
    del flush
    log(f"phase 7 took {time.perf_counter() - t_phase:.1f} s")
    return launches, err


# ---------------------------------------------------------------- phase 8

# Kubernetes v1.7's compatibility_test.go knob set (the reference's
# tests/test_policy_compat.py V17_POLICY_JSON) without its extender
PHASE8_POLICY = {
    "kind": "Policy", "apiVersion": "v1",
    "predicates": [
        {"name": n} for n in (
            "MatchNodeSelector", "PodFitsResources", "PodFitsHostPorts",
            "HostName", "NoDiskConflict", "NoVolumeZoneConflict",
            "MaxEBSVolumeCount", "MaxGCEPDVolumeCount",
            "MaxAzureDiskVolumeCount", "MatchInterPodAffinity",
            "GeneralPredicates", "PodToleratesNodeTaints",
            "CheckNodeMemoryPressure", "CheckNodeDiskPressure",
            "CheckNodeCondition", "NoVolumeNodeConflict")] + [
        {"name": "CustomServiceAffinity",
         "argument": {"serviceAffinity": {"labels": ["region"]}}},
        {"name": "CustomLabelsPresence",
         "argument": {"labelsPresence": {"labels": ["foo"],
                                         "presence": True}}}],
    "priorities": [
        {"name": "LeastRequestedPriority", "weight": 1},
        {"name": "BalancedResourceAllocation", "weight": 1},
        {"name": "SelectorSpreadPriority", "weight": 1},
        {"name": "InterPodAffinityPriority", "weight": 1},
        {"name": "NodePreferAvoidPodsPriority", "weight": 10000},
        {"name": "NodeAffinityPriority", "weight": 1},
        {"name": "TaintTolerationPriority", "weight": 1},
        {"name": "CustomServiceAntiAffinity", "weight": 3,
         "argument": {"serviceAntiAffinity": {"label": "zone"}}},
        {"name": "CustomLabelPreference", "weight": 4,
         "argument": {"labelPreference": {"label": "bar",
                                          "presence": True}}}]}
P8_COUNTERS = ("stream.chunk_flush", "engine.wave_dispatch",
               "engine.wave_host_rows", "engine.wave_host_tail",
               "engine.classic_host_tail", "engine.classic_strict_rows",
               "engine.affinity_strict_tail", "engine.tail_rounds",
               "engine.hostcheck_fence_requeues",
               "engine.policy_fence_requeues",
               "engine.affinity_fence_requeues",
               "engine.fence_reason_capacity",
               "engine.fence_reason_host_check",
               "engine.fence_reason_policy")
P8_PORTS = list(range(7000, 7009))  # nine: past the encoding's eight


class FakeClock:
    """One clock for both daemons' leases, TTLs and backoff."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def policy_world(mods, n_nodes, n_pods, pin_services):
    """Phase 8's cluster: hollow nodes labeled region r0..r3, zone
    z0..z15, foo on 90% and bar on half; pending pods: mixed_affinity,
    1% host-static (five ORed node-selector terms on `zone`, one of them
    real) and 1/300 host-exact (half with nine host ports, half in two
    Services that the Policy's ServiceAffinity on region couples), the
    extra pods spread evenly through the queue. With pin_services the
    coupled pods name their region in a node selector: an unpinned one
    makes the exact oracle scan every pod of the cluster for every node
    (the reference's ServiceAffinity backfill, policy_algos
    ._service_affinity_labels), which the 5,000 x 30,000 runs cannot
    afford; the 512-node runs keep them unpinned. Returns (nodes, pods,
    services)."""
    hollow, types, workloads = mods
    nodes = hollow.hollow_nodes(n_nodes)
    for i, n in enumerate(nodes):
        n.labels["region"] = f"r{i % 4}"
        n.labels["zone"] = f"z{i % 16}"
        if i % 10:
            n.labels["foo"] = "x"
        if i % 2:
            n.labels["bar"] = "y"
    n_static, n_exact = n_pods // 100, n_pods // 300
    n_ports = n_exact // 2
    extra = []
    for i in range(n_static):
        terms = [types.NodeSelectorTerm([types.SelectorRequirement(
            "zone", types.SelectorOperator.IN, [z])])
            for z in [f"z{i % 16}"] + [f"bogus-{k}" for k in range(4)]]
        extra.append(types.make_pod(
            f"hstatic-{i}", namespace="bench", cpu=100, memory=256 << 20,
            labels={"app": f"hstatic-{i % 8}"},
            affinity=types.Affinity(
                node_affinity=types.NodeAffinity(required_terms=terms))))
    for i in range(n_ports):
        extra.append(types.make_pod(
            f"hports-{i}", namespace="bench", cpu=100, memory=256 << 20,
            labels={"app": "hports"}, ports=P8_PORTS))
    for i in range(n_exact - n_ports):
        svc = i % 2
        extra.append(types.make_pod(
            f"hsvc-{i}", namespace="bench", cpu=100, memory=256 << 20,
            labels={"app": f"svc-{svc}"},
            node_selector={"region": f"r{svc + 1}"} if pin_services
            else None))
    mixed = hollow.mixed_affinity_pods(n_pods - len(extra), seed=21)
    step = len(mixed) // len(extra) + 1
    pods = []
    for i, p in enumerate(mixed):
        if i % step == 0 and extra:
            pods.append(extra.pop(0))
        pods.append(p)
    pods.extend(extra)
    services = [workloads.Service(f"svc-{s}", "bench",
                                  selector={"app": f"svc-{s}"})
                for s in range(2)]
    return nodes, pods, services


def audit_policy(api, tag, n_pods):
    """audit_store's checks plus phase 8's own: every pod bound, every
    bound pod on a node carrying foo, each coupled Service in one region,
    each host-static pod in its zone, no two host-port pods on one
    node."""
    bound, unbound = audit_store(api, "mixed_affinity", n_pods)
    if unbound:
        fail(f"{tag}: {unbound} pods unbound")
    nodes = {n.name: n for n in api.list("Node")[0]}
    regions, port_nodes = {}, []
    for p in api.list("Pod")[0]:
        labels = nodes[p.node_name].labels
        if "foo" not in labels:
            fail(f"{tag}: {p.name} on {p.node_name}, which lacks foo")
        app = p.labels.get("app", "")
        if app.startswith("svc-"):
            regions.setdefault(app, set()).add(labels["region"])
        elif p.name.startswith("hstatic-"):
            want = f"z{int(p.name.split('-')[1]) % 16}"
            if labels["zone"] != want:
                fail(f"{tag}: {p.name} on zone {labels['zone']}, not {want}")
        elif app == "hports":
            port_nodes.append(p.node_name)
    if any(len(r) != 1 for r in regions.values()) or len(regions) != 2:
        fail(f"{tag}: coupled Services across regions: {regions}")
    if len(set(port_nodes)) != len(port_nodes):
        fail(f"{tag}: two host-port pods share a node")
    where = sorted((a, sorted(r)) for a, r in regions.items())
    log(f"{tag}: policy audit clean ({bound} bound, all on foo nodes; "
        f"Services in regions {where}; {len(port_nodes)} host-port pods "
        f"on distinct nodes)")


def _p8_counts(COUNTERS):
    snap = COUNTERS.snapshot()
    cnt = {k: snap.get(k, (0, 0.0))[0] for k in P8_COUNTERS}
    spans = {k: round(1e3 * t, 1) for k, (_, t) in sorted(snap.items())
             if k.startswith(("engine.", "pipeline.")) and t > 0}
    return cnt, spans


def daemon_failover(mods, world, policy_path, device=None, spy=None):
    """8a: two SchedulerDaemons with one fake clock over one store. A
    leads and runs one classic round over half the queue, then crashes
    without releasing its lease; once the clock passes the lease B
    acquires, relists and finishes the drain with step(). Returns (api,
    report)."""
    import contextlib
    import torch
    (hollow, api_mod, daemon, kernels, COUNTERS) = mods
    nodes, pods, services = world
    api = api_mod.ApiServerLite(max_log=max(200_000,
                                            4 * (len(nodes) + len(pods))))
    for svc in services:
        api.create("Service", svc)
    for n in nodes:
        api.create("Node", n)
    clock = FakeClock()
    opts = daemon.SchedulerOptions(healthz_port=None,
                                   policy_config_file=policy_path)
    a = daemon.SchedulerDaemon(api, "daemon-a", opts, now=clock,
                               device=device)
    b = daemon.SchedulerDaemon(api, "daemon-b", opts, now=clock,
                               device=device)
    a.step()
    b.step()
    if not a.is_leader() or b.is_leader():
        fail("8a: daemon-a did not take the lease first")
    for p in pods:
        api.create("Pod", p)
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    COUNTERS.reset()
    with spy if spy is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        stats_a = a.scheduler.schedule_round(max_batch=len(pods) // 2)
        if on_card:
            torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        a.stop(release=False)       # the crash: the lease stays held
        b.step()
        if b.is_leader():
            fail("8a: daemon-b led inside the crashed leader's lease")
        clock.t += 16.0             # past lease_duration (15 s)
        t1 = time.perf_counter()
        rounds = []
        for _ in range(20):
            stats = b.step()
            rounds.append(stats)
            if b.is_leader() and stats["popped"] == 0 \
                    and b.scheduler.queue.ready_count() == 0:
                break
        if on_card:
            torch.cuda.synchronize()
        wall_b = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)
    cnt, spans = _p8_counts(COUNTERS)
    lease = api.get("Lease", "kube-system", "kube-scheduler")
    report = {"round_a": stats_a, "rounds_b": rounds, "wall_a": wall_a,
              "wall_b": wall_b, "counters": cnt, "spans": spans,
              "launches": launches, "holder": lease.holder,
              "transitions": lease.leader_transitions,
              "rr": b.scheduler.engine.rr.counter}
    b.stop()
    return api, report


def policy_drain(mods, world, policy, device=None, spy=None,
                 batch_mode="wave"):
    """8b / 8c: Scheduler(policy=...).run_until_drained() on a fresh store
    holding `world`. Returns (api, totals, report)."""
    import contextlib
    import torch
    (hollow, api_mod, Scheduler, kernels, COUNTERS) = mods
    nodes, pods, services = world
    api = api_mod.ApiServerLite(max_log=max(200_000,
                                            3 * (len(nodes) + len(pods))))
    for svc in services:
        api.create("Service", svc)
    hollow.load_cluster(api, nodes, pods)
    sched = Scheduler(api, record_events=False, policy=policy,
                      batch_mode=batch_mode, device=device)
    sched.start()
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    COUNTERS.reset()
    with spy if spy is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        tot = sched.run_until_drained()
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    cnt, spans = _p8_counts(COUNTERS)
    rr = sched.engine.rr.counter
    sched.engine.close()
    return api, tot, {"wall": wall, "counters": cnt, "spans": spans,
                      "launches": launches, "rr": rr}


def _placed(api):
    return {p.key(): p.node_name for p in api.list("Pod")[0]}


def daemon_and_policy(mods, card, device=None):
    """Phase 8 on `device` (None: the card), 8d against the CPU. Returns
    (launches summed over 8a-8c, max abs err per kernel on this path)."""
    import tempfile
    (hollow, types, workloads, api_mod, daemon, Scheduler, policy_mod,
     kernels, COUNTERS) = mods
    t_phase = time.perf_counter()
    total = {k: 0 for k in kernels.LAUNCHES}
    err = {k: 0 for k in kernels.LAUNCHES}
    wmods = (hollow, types, workloads)
    dmods = (hollow, api_mod, daemon, kernels, COUNTERS)
    smods = (hollow, api_mod, Scheduler, kernels, COUNTERS)
    policy = policy_mod.parse_policy(json.dumps(PHASE8_POLICY))

    def take(tag, launches, spy):
        cap_shapes, inc_shapes = spy.shapes()
        log(f"{tag} launches {launches}, shapes (capacity (C, N, R)) "
            f"{cap_shapes}, (incidence (M, N, L)) {inc_shapes}")
        for k in ("capacity_fit", "incidence_matmul"):
            if launches[k] == 0:
                fail(f"{tag}: no {k} launch")
        for k, v in spy.check(tag).items():
            err[k] = max(err[k], v)
        for k, v in launches.items():
            total[k] += v

    with tempfile.TemporaryDirectory() as tmp:
        policy_path = os.path.join(tmp, "policy.json")
        with open(policy_path, "w") as f:
            json.dump(PHASE8_POLICY, f)
        # 8a: the daemon at full width, failover included
        spy = OperandSpy(kernels)
        api, rep = daemon_failover(
            dmods, policy_world(wmods, N_NODES, P8A_PODS, True),
            policy_path, device=device, spy=spy)
        audit_policy(api, "8a daemon", P8A_PODS)
        del api
        if (rep["holder"], rep["transitions"]) != ("daemon-b", 1):
            fail(f"8a: lease {rep['holder']} / {rep['transitions']}")
        log(f"8a daemon {N_NODES} x {P8A_PODS}: A's round "
            f"{json.dumps(rep['round_a'])} in {rep['wall_a']:.3f} s; B "
            f"(after the crash and the lease) {len(rep['rounds_b'])} "
            f"steps in {rep['wall_b']:.3f} s, first "
            f"{json.dumps(rep['rounds_b'][0])}; lease holder "
            f"{rep['holder']}, transitions {rep['transitions']} [{card}]")
        log(f"8a counters {json.dumps(rep['counters'])}")
        log(f"8a spans (ms) {json.dumps(rep['spans'])}")
        take("8a daemon", rep["launches"], spy)
        # 8b: the pipelined drain of the same store contents
        spy = OperandSpy(kernels)
        api, tot, rep = policy_drain(
            smods, policy_world(wmods, N_NODES, N_PODS, True), policy,
            device=device, spy=spy)
        audit_policy(api, "8b pipelined", N_PODS)
        del api
        cnt = rep["counters"]
        if cnt["stream.chunk_flush"] != 0:
            fail(f"8b: {cnt['stream.chunk_flush']} pipeline flushes")
        n_exact = N_PODS // 300
        if cnt["engine.wave_host_rows"] < n_exact \
                or cnt["engine.wave_host_tail"] < n_exact:
            fail(f"8b: host rows {cnt['engine.wave_host_rows']}, tail "
                 f"{cnt['engine.wave_host_tail']} (want >= {n_exact})")
        log(f"8b pipelined {N_NODES} x {N_PODS} with the Policy: wall "
            f"{rep['wall']:.3f} s, totals {json.dumps(tot)} [{card}]")
        log(f"8b counters {json.dumps(cnt)} (Policy fence requeues "
            f"{cnt['engine.policy_fence_requeues']}, host-check fence "
            f"requeues {cnt['engine.hostcheck_fence_requeues']})")
        log(f"8b spans (ms) {json.dumps(rep['spans'])}")
        take("8b pipelined", rep["launches"], spy)
        # 8c: the strict classic round (depth cut: two incidence launches
        # per pod in the per-pod scan)
        n_strict = 2000
        spy = OperandSpy(kernels)
        api, tot, rep = policy_drain(
            smods, (hollow.hollow_nodes(N_NODES),
                    hollow.mixed_affinity_pods(n_strict, seed=22), []),
            None, device=device, spy=spy, batch_mode="strict")
        bound, unbound = audit_store(api, "mixed_affinity", n_strict)
        if unbound:
            fail(f"8c: {unbound} pods unbound")
        del api
        log(f"8c strict {N_NODES} x {n_strict}: wall {rep['wall']:.3f} s "
            f"({1e3 * rep['wall'] / n_strict:.2f} ms a pod), totals "
            f"{json.dumps(tot)}, spans (ms) {json.dumps(rep['spans'])} "
            f"[{card}]")
        take("8c strict", rep["launches"], spy)
        # 8d: card == CPU at reduced sizes (coupled pods unpinned)
        runs = {}
        for dev in (device, "cpu"):
            api, rep = daemon_failover(
                dmods, policy_world(wmods, 512, 3000, False), policy_path,
                device=dev)
            runs[("classic", dev)] = (_placed(api), rep["rr"])
            api, tot, rep = policy_drain(
                smods, policy_world(wmods, 512, 3000, False), policy,
                device=dev)
            runs[("pipelined", dev)] = (_placed(api), rep["rr"], tot)
            api, tot, rep = policy_drain(
                smods, (hollow.hollow_nodes(256),
                        hollow.mixed_affinity_pods(600, seed=23), []),
                None, device=dev, batch_mode="strict")
            runs[("strict", dev)] = (_placed(api), rep["rr"], tot)
        for path in ("classic", "pipelined", "strict"):
            got, want = runs[(path, device)], runs[(path, "cpu")]
            diff = sum(got[0][k] != v for k, v in want[0].items())
            if diff or got[1:] != want[1:]:
                fail(f"8d {path}: card != CPU ({diff} placements; "
                     f"{got[1:]} vs {want[1:]})")
            log(f"8d {path}: card == CPU ({len(want[0])} pods, "
                f"{sum(1 for v in want[0].values() if v)} bound, RR "
                f"counter {want[1]})")
    log(f"phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return total, err


# ---------------------------------------------------------------- phase 9

GANG_CHUNK = 1024                 # bench.py's BENCH_GANG_CHUNK default
GANG_FLUSH_SHAPE = (1000, 6000)   # measure_gang_mix's own default shape
CHECK_SHAPE = (512, 3000)         # 9e's card == CPU drains
P9_GANG_COUNTERS = ("engine.gang_wave_dispatch",
                    "engine.gang_fence_rollbacks",
                    "engine.fence_reason_gang",
                    "engine.wave_flush_gang_host", "engine.wave_dispatch",
                    "stream.chunk_flush")
P9_PREEMPT_COUNTERS = ("engine.preempt_scan_dispatch",
                       "engine.preempt_scan_host_fallback",
                       "engine.preempt_commits", "engine.preempt_rollbacks",
                       "engine.victims_evicted",
                       "engine.preempt_budget_deferred",
                       "engine.wave_dispatch", "stream.chunk_flush")
# bench.py measure_priority_churn's scenario as bench runs it
CHURN = {"rate": 2000.0, "duration_s": 4.0, "drain_s": 6.0,
         "budget_ms": 250.0, "evict_fail_rate": 0.02,
         "evict_timeout_rate": 0.01, "max_evictions_per_min": 6000}
CHURN_NODES = 240
PRIO_FILL_PER_NODE = 19           # 19 x 200m: 95% of a hollow node's 4,000m
PRIO_STREAM = 10_000              # 5 s at 2,000/s
PRIO_DAEMON_PODS = 1000
# bench.py measure_fastlane_mixed's defaults, n_nodes at the headline size
FASTLANE = {"n_nodes": 5000, "rate": 2000.0, "fast_rate": 100.0,
            "duration_s": 3.0, "budget_ms": 250.0, "probe_pods": 64}
SAMPLE_SETS = 1000
SAMPLE_K = 16                     # engine/fastlane.py DEFAULT_K


def p9_counts(COUNTERS, keys):
    snap = COUNTERS.snapshot()
    return {k: snap.get(k, (0, 0.0))[0] for k in keys}


def p9_spans(COUNTERS):
    """Host-clock span totals (ms) of the engine and the pipeline."""
    return {k: round(1e3 * t, 1) for k, (_, t) in
            sorted(COUNTERS.snapshot().items())
            if k.startswith(("engine.", "pipeline.")) and t > 0}


def paced_create(api, pods, rate, t0, made, stamp=None):
    """bench.py's creator thread: create `pods` at `rate` a second from
    t0, in bursts of at most about 4 ms of the rate; made[0] counts the
    pods created, stamp(burst, t) notes each burst's creation instant."""
    burst = max(4, int(rate * 0.004))
    while made[0] < len(pods):
        due = min(len(pods), int(rate * (time.monotonic() - t0)),
                  made[0] + burst)
        if due > made[0]:
            for p in pods[made[0]:due]:
                api.create("Pod", p)
            if stamp is not None:
                stamp(pods[made[0]:due], time.monotonic())
            made[0] = due
        delay = t0 + (made[0] + 1) / rate - time.monotonic()
        if delay > 0:
            time.sleep(min(delay, 0.002))


def gang_drain(mods, n_nodes, n_pods, gang_pipeline=True, device=None,
               overlap=True, chunk=GANG_CHUNK, spy=None):
    """One gang_mix drain through Scheduler.run_until_drained, as bench.py
    measure_gang_mix runs it. Returns (api, totals, counters, wall,
    launches, RR counter)."""
    import contextlib
    import torch
    hollow, api_mod, Scheduler, kernels, COUNTERS = mods
    api = api_mod.ApiServerLite(max_log=max(200_000,
                                            3 * (n_nodes + n_pods)))
    hollow.load_cluster(api, hollow.hollow_nodes(n_nodes),
                        hollow.PROFILES["gang_mix"](n_pods))
    sched = Scheduler(api, record_events=False, device=device)
    sched.gang_pipeline = gang_pipeline
    sched.start()
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    COUNTERS.reset()
    with spy if spy is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        tot = sched.run_until_drained(max_batch=chunk, overlap=overlap)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    cnt = p9_counts(COUNTERS, P9_GANG_COUNTERS)
    cnt["spans_ms"] = p9_spans(COUNTERS)
    rr = sched.engine.rr.counter
    sched.engine.close()
    return api, tot, cnt, wall, launches, rr


def audit_gangs(api, tag, gang_key):
    """bench.py measure_gang_mix's audit: zero partially bound gangs —
    every gang wholly bound or wholly pending. Returns (gangs, gangs
    bound, keys of the members of wholly pending gangs)."""
    by_gang = {}
    for p in api.list("Pod")[0]:
        g = p.annotations.get(gang_key)
        if g is not None:
            by_gang.setdefault(g, []).append(p)
    partial = [g for g, ps in by_gang.items()
               if len({bool(p.node_name) for p in ps}) != 1]
    if partial:
        fail(f"{tag}: {len(partial)} partially bound gangs, e.g. "
             f"{partial[0]}")
    if not by_gang:
        fail(f"{tag}: no gang in the store")
    pending = {p.key() for ps in by_gang.values() if not ps[0].node_name
               for p in ps}
    return (len(by_gang), sum(1 for ps in by_gang.values()
                              if ps[0].node_name), pending)


def gangs_on_the_card(mods, card, gang_key):
    """9a: gang_mix through both drain paths. Returns (launches summed,
    max abs err per kernel)."""
    kernels = mods[3]
    total = {k: 0 for k in kernels.LAUNCHES}
    err = {k: 0 for k in kernels.LAUNCHES}
    for mode, (n_nodes, n_pods) in (("pipelined", (N_NODES, N_PODS)),
                                    ("flush", GANG_FLUSH_SHAPE)):
        spy = OperandSpy(kernels)
        api, tot, cnt, wall, launches, _rr = gang_drain(
            mods, n_nodes, n_pods, gang_pipeline=mode == "pipelined",
            spy=spy)
        n_g, n_bound_g, pending = audit_gangs(api, f"9a {mode}", gang_key)
        bound, unbound = audit_store(api, "gang_mix", n_pods,
                                     exempt=pending)
        log(f"9a gang_mix {mode} {n_nodes} x {n_pods} (chunks of "
            f"{GANG_CHUNK}): bound {bound}, unbound {unbound}, gangs "
            f"{n_g} ({n_bound_g} wholly bound, {n_g - n_bound_g} wholly "
            f"pending, 0 partial), wall {wall:.3f} s, "
            f"gangmix_pods_s {tot['bound'] / wall:.1f} [{card}]")
        log(f"9a {mode} totals {json.dumps(tot)} counters "
            f"{json.dumps(cnt)}")
        if mode == "pipelined":
            if cnt["engine.gang_wave_dispatch"] <= 0:
                fail("9a pipelined: no gang rode a wave")
        elif cnt["engine.gang_wave_dispatch"] != 0:
            fail("9a flush: a gang rode a wave in flush mode")
        cap_shapes, inc_shapes = spy.shapes()
        log(f"9a {mode} launches {launches}, shapes (capacity (C, N, R)) "
            f"{cap_shapes}, (incidence (M, N, L)) {inc_shapes}")
        for k in ("capacity_fit", "incidence_matmul"):
            if launches[k] == 0:
                fail(f"9a {mode}: no {k} launch")
        for k, v in spy.check(f"9a {mode}").items():
            err[k] = max(err[k], v)
        for k, v in launches.items():
            total[k] += v
        del api
    return total, err


def priority_world(hollow, n_nodes, per_node, n_more):
    """Hollow nodes pre-filled with the first n_nodes * per_node pods of
    the priority_churn profile, bound round-robin per_node to a node, and
    the profile's next n_more pods (unbound)."""
    nodes = hollow.hollow_nodes(n_nodes)
    pool = hollow.PROFILES["priority_churn"](n_nodes * per_node + n_more)
    fill = pool[:n_nodes * per_node]
    for j, p in enumerate(fill):
        p.node_name = nodes[j % n_nodes].name
    return nodes, fill, pool[n_nodes * per_node:]


def priority_stream(mods, n_nodes, per_node, total, rate, duration_s,
                    drain_s, budget_ms, evict_fail_rate, evict_timeout_rate,
                    max_evictions_per_min, spy=None):
    """bench.py measure_priority_churn on the card: an overcommitted
    mixed-band arrival stream through Scheduler.stream() behind
    FaultyBindApi's eviction faults, with the PodPriority gate on, on a
    cluster pre-filled per_node pods a node. Returns a report; fails on a
    duplicate bind, a double eviction or ghost victim, or a 60 s window
    past the budget."""
    import contextlib
    import threading
    import numpy as np
    import torch
    (hollow, api_mod, Scheduler, kernels, COUNTERS, churn, preempt_wave,
     features) = mods
    features.DEFAULT_FEATURE_GATE.set("PodPriority", True)
    try:
        nodes, fill, pods = priority_world(hollow, n_nodes, per_node, total)
        base = api_mod.ApiServerLite(max_log=max(
            400_000, 6 * (n_nodes + total) + 2 * len(fill)))
        hollow.load_cluster(base, nodes, fill)
        api = churn.FaultyBindApi(base, seed=7,
                                  evict_fail_rate=evict_fail_rate,
                                  evict_timeout_rate=evict_timeout_rate)
        sched = Scheduler(api, record_events=False)
        sched.disruption_budget = preempt_wave.DisruptionBudget(
            max_evictions_per_min=max_evictions_per_min)
        sched.start()
        loop = sched.stream(budget_s=budget_ms / 1e3, min_quantum=256,
                            max_quantum=2048)
        created, bind_events, plog = [0], [], []
        agg = {"degraded_steps": 0, "preemptions": 0,
               "preempt_rollbacks": 0, "victims_evicted": 0,
               "budget_deferred": 0}
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        COUNTERS.reset()
        t0 = time.monotonic()
        sched.wave_observer = lambda ts, keys: bind_events.append(
            (ts - t0, keys))
        sched.preempt_observer = lambda ts, lat, nv: plog.append(
            (ts - t0, lat, nv))

        def note(stats, _loop):
            for k in agg:
                agg[k] += stats.get(k, 0)

        t_stop = t0 + duration_s + drain_s

        def done(stats, _loop):
            return created[0] >= total and time.monotonic() >= t_stop

        th = threading.Thread(target=paced_create,
                              args=(api, pods, rate, t0, created),
                              daemon=True)
        th.start()
        with spy if spy is not None else contextlib.nullcontext():
            try:
                loop.run(done, on_step=note)
            finally:
                loop.close()
            th.join(timeout=10)
            sched.sync()
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        sched.wave_observer = None
        sched.preempt_observer = None
        launches = dict(kernels.LAUNCHES)
        cnt = p9_counts(COUNTERS, P9_PREEMPT_COUNTERS)
        spans = p9_spans(COUNTERS)
        trans = churn.audit_store_transitions(base)
        observed = {}
        for _ts, keys in bind_events:
            for k in keys:
                observed[k] = observed.get(k, 0) + 1
        dup = sum(max(0, c - trans["binds"].get(k, 0))
                  for k, c in observed.items())
        over_evicted = [k for k, c in trans["evicts"].items()
                        if c > trans["binds"].get(k, 0)]
        ghosts = churn.audit_cache_vs_store(sched, base)
        window = preempt_wave.DisruptionBudget.WINDOW_S
        evict_ts = sorted(t for t, _lat, nv in plog for _ in range(nv))
        peak, j = 0, 0
        for i, t in enumerate(evict_ts):
            while evict_ts[j] <= t - window:
                j += 1
            peak = max(peak, i - j + 1)
        store = base.list("Pod")[0]
        if dup or over_evicted or ghosts or peak > max_evictions_per_min:
            fail(f"priority stream {n_nodes} nodes: duplicate binds {dup}, "
                 f"double evictions {len(over_evicted)}, ghosts "
                 f"{ghosts[:5]}, budget window peak {peak}/"
                 f"{max_evictions_per_min}")
        bound_keys = {p.key() for p in store if p.node_name}
        band_of = {v: k for k, v in hollow.PRIORITY_BANDS.items()}
        band_tot, band_bnd = {}, {}
        for p in pods:
            b = band_of.get(p.priority, "other")
            band_tot[b] = band_tot.get(b, 0) + 1
            band_bnd[b] = band_bnd.get(b, 0) + (p.key() in bound_keys)
        lats = np.array([lat for _t, lat, _nv in plog])
        vics = np.array([nv for _t, _lat, nv in plog])
        rep = {
            "nodes": n_nodes, "prefilled": len(fill), "offered": total,
            "wall_s": round(wall, 3), "stats": agg, "counters": cnt,
            "launches": launches, "spans_ms": spans,
            "band_bound_fraction": {b: round(band_bnd[b] / band_tot[b], 3)
                                    for b in sorted(band_tot)},
            "commits": len(plog),
            "victims_per_preemption": round(float(vics.mean()), 3)
            if len(plog) else None,
            "preempt_latency_p50_ms": round(float(
                np.percentile(lats, 50)) * 1e3, 3) if len(plog) else None,
            "preempt_latency_p99_ms": round(float(
                np.percentile(lats, 99)) * 1e3, 3) if len(plog) else None,
            "budget_window_peak": peak,
            "injected_evict_failures": api.injected_evict_failures,
            "injected_evict_timeouts": api.injected_evict_timeouts,
            "duplicate_binds": dup, "double_evictions": len(over_evicted),
            "ghosts": len(ghosts)}
        prio_dev = sched.engine._prio_dev
        sched.engine.close()
        return rep, prio_dev
    finally:
        features.DEFAULT_FEATURE_GATE.reset()


def preemption_on_the_card(mods, card):
    """9b: the priority stream at bench's 240 nodes, then at 5,000 nodes
    pre-filled to 95%. Returns (launches summed, max abs err per kernel,
    the 5,000-node engine's band tensors, the need rows of the profile's
    bands)."""
    kernels = mods[3]
    total = {k: 0 for k in kernels.LAUNCHES}
    err = {k: 0 for k in kernels.LAUNCHES}
    prio_dev = None
    for n_nodes, per_node, offered in (
            (CHURN_NODES, 0, int(CHURN["rate"] * CHURN["duration_s"])),
            (N_NODES, PRIO_FILL_PER_NODE, PRIO_STREAM)):
        duration = offered / CHURN["rate"]
        spy = OperandSpy(kernels)
        rep, prio_dev = priority_stream(
            mods, n_nodes, per_node, offered, CHURN["rate"], duration,
            CHURN["drain_s"], CHURN["budget_ms"], CHURN["evict_fail_rate"],
            CHURN["evict_timeout_rate"], CHURN["max_evictions_per_min"],
            spy=spy)
        tag = f"9b priority stream {n_nodes} nodes"
        cnt = rep["counters"]
        log(f"{tag}: {json.dumps(rep)} [{card}]")
        if cnt["engine.preempt_scan_dispatch"] <= 0:
            fail(f"{tag}: the victim scan never ran on the card")
        if cnt["engine.preempt_scan_host_fallback"] != 0:
            fail(f"{tag}: {cnt['engine.preempt_scan_host_fallback']} "
                 f"rounds took the host pre-filter")
        if rep["commits"] <= 0:
            fail(f"{tag}: no preemption committed")
        if rep["launches"]["capacity_fit"] == 0:
            fail(f"{tag}: no capacity launch")
        log(f"{tag}: preempt_scan_dispatch "
            f"{cnt['engine.preempt_scan_dispatch']}, host fallback 0, "
            f"commits {cnt['engine.preempt_commits']}, rollbacks "
            f"{cnt['engine.preempt_rollbacks']}, deferrals "
            f"{cnt['engine.preempt_budget_deferred']}, victims per "
            f"preemption {rep['victims_per_preemption']}, latency p50 / "
            f"p99 {rep['preempt_latency_p50_ms']} / "
            f"{rep['preempt_latency_p99_ms']} ms, bands bound "
            f"{rep['band_bound_fraction']}; audits clean")
        for k, v in spy.check(tag).items():
            err[k] = max(err[k], v)
        for k, v in rep["launches"].items():
            total[k] += v
    return total, err, prio_dev


def daemon_preemption(mods, n_nodes, n_pods, device=None, spy=None):
    """9c: a SchedulerDaemon whose componentconfig turns PodPriority on,
    over 5,000 hollow nodes filled with 20 priority_churn pods each (9b's
    pre-fill plus one pod a node, so nothing fits) and n_pods pending pods
    of the profile's prod and system bands; steps until a round binds and
    preempts nothing. Returns (api, plans, report)."""
    import contextlib
    import torch
    (hollow, api_mod, daemon, scheme, kernels, COUNTERS, features,
     preemption) = mods
    nodes, fill, rest = priority_world(hollow, n_nodes, 20, 10 * n_pods)
    pending = [p for p in rest if p.priority >= 1000][:n_pods]
    api = api_mod.ApiServerLite(max_log=max(200_000, 4 * len(fill)))
    hollow.load_cluster(api, nodes, fill + pending)
    cfg = scheme.DEFAULT_SCHEME.decode({
        "apiVersion": "componentconfig/v1alpha1",
        "kind": "KubeSchedulerConfiguration",
        "featureGates": "PodPriority=true",
        "leaderElection": {"leaderElect": False}})
    for gate, val in cfg.feature_gates.items():
        features.DEFAULT_FEATURE_GATE.set(gate, val)
    opts = daemon.SchedulerOptions.from_component_config(cfg)
    opts.healthz_port = None
    clock = FakeClock()
    plans = []
    real_pick = preemption.pick_preemption

    def pick(pod, infos, **kw):
        plan = real_pick(pod, infos, **kw)
        if plan is not None:
            plans.append((pod.key(), pod.priority, plan.node_name,
                          [(v.key(), v.priority) for v in plan.victims]))
        return plan

    preemption.pick_preemption = pick
    d = None
    try:
        d = daemon.SchedulerDaemon(api, "daemon-p", opts, now=clock,
                                   device=device)
        on_card = device != "cpu"
        if on_card:
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        COUNTERS.reset()
        steps = []
        with spy if spy is not None else contextlib.nullcontext():
            t0 = time.perf_counter()
            for _ in range(12):
                st = d.step()
                steps.append(st)
                clock.t += 61.0     # past every backoff (max 60 s)
                if len(steps) > 1 and st["bound"] == 0 \
                        and st.get("preemptions", 0) == 0:
                    break
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rep = {"steps": steps, "wall": wall,
               "launches": dict(kernels.LAUNCHES),
               "spans_ms": p9_spans(COUNTERS),
               "rr": d.scheduler.engine.rr.counter}
    finally:
        preemption.pick_preemption = real_pick
        if d is not None:
            d.stop()
        features.DEFAULT_FEATURE_GATE.reset()
    return api, plans, [p.key() for p in pending], rep


def audit_daemon_preemption(api, plans, preemptors, tag):
    """9c's audits: no victim at or above its preemptor's priority, no
    victim in two plans, every victim gone from the store, every
    preemptor bound or fitting nowhere even with every lower-priority pod
    gone, no node over capacity, no pod bound twice."""
    import numpy as np
    seen = set()
    for key, prio, _node, vics in plans:
        for vk, vp in vics:
            if vp >= prio:
                fail(f"{tag}: victim {vk} ({vp}) of {key} ({prio})")
            if vk in seen:
                fail(f"{tag}: {vk} evicted by two plans")
            seen.add(vk)
    pods = api.list("Pod")[0]
    by_key = {p.key(): p for p in pods}
    if seen & set(by_key):
        fail(f"{tag}: a victim is still in the store")
    nodes = {n.name: n for n in api.list("Node")[0]}
    names = sorted(nodes)
    idx = {n: i for i, n in enumerate(names)}
    alloc = np.array([[nodes[n].allocatable.milli_cpu,
                       nodes[n].allocatable.memory,
                       nodes[n].allowed_pod_number] for n in names],
                     dtype=np.int64)
    bound = [p for p in pods if p.node_name]
    prios = sorted({p.priority for p in pods})
    # used[k]: per node usage by bound pods of priority >= prios[k]
    used = {}
    for k, pr in enumerate(prios):
        u = np.zeros((len(names), 3), dtype=np.int64)
        for p in bound:
            if p.priority >= pr:
                r = p.resource_request()
                u[idx[p.node_name]] += (r.milli_cpu, r.memory, 1)
        used[pr] = u
    if (used[prios[0]] > alloc).any():
        fail(f"{tag}: a node is over capacity")
    n_bound = n_fit_nowhere = 0
    for key in preemptors:
        p = by_key[key]
        if p.node_name:
            n_bound += 1
            continue
        r = p.resource_request()
        free = alloc - used[p.priority]
        if ((free[:, 0] >= r.milli_cpu) & (free[:, 1] >= r.memory)
                & (free[:, 2] >= 1)).any():
            fail(f"{tag}: {key} is pending but fits with every "
                 f"lower-priority pod gone")
        n_fit_nowhere += 1
    binds = {}
    for e in api._log:
        if e.kind == "Pod" and e.type == "MODIFIED" and e.obj.node_name:
            binds[e.obj.key()] = binds.get(e.obj.key(), 0) + 1
    if any(c > 1 for c in binds.values()):
        fail(f"{tag}: a pod bound twice")
    return n_bound, n_fit_nowhere, len(seen)


def resident_equals_host(fast_ops, snap, dev_nodes, n_sets, seed):
    """The card's sample_eval over the resident node tensors == the host
    twin over the snapshot arrays, on n_sets seeded index sets of
    SAMPLE_K rows. Returns n_sets."""
    import numpy as np
    rng = np.random.default_rng(seed)
    nodes = {k: dev_nodes[k] for k in fast_ops.FAST_NODE_KEYS}
    host = {k: np.asarray(getattr(snap, k)) for k in fast_ops.FAST_NODE_KEYS}
    req = snap.resource_row(milli_cpu=100, memory=128 << 20, gpu=0,
                            scratch=0, overlay=0, extended={}, up=True,
                            width=snap.num_resources)
    n = host["alloc"].shape[0]
    for i in range(n_sets):
        idx = rng.integers(0, n, size=SAMPLE_K).astype(np.int32)
        got = fast_ops.sample_eval(idx, req, False, False, nodes).numpy()
        want = fast_ops.sample_eval_host(idx, req, False, False, host)
        if not np.array_equal(got, want):
            fail(f"resident sample_eval set {i}: card {got}, host {want}")
    return n_sets


def fastlane_mixed(mods, card, n_nodes, rate, fast_rate, duration_s,
                   budget_ms, probe_pods, spy=None):
    """9d: bench.py measure_fastlane_mixed on the card — one always-on
    loop with the fast lane armed, three windows (solo bulk, mixed bulk +
    fast, fast-only probe). Before the probe the resident node tensors
    are re-synced to the snapshot (as a fresh dispatch would), so the
    probe's fast pods find the device current and idle; right then, just
    after the mixed window's last harvest, the card's sample_eval over the
    resident tensors must equal the host twin over the snapshot (the
    upload and the gather are ordered on one stream). Returns (report,
    launches, the scheduler for 9e)."""
    import contextlib
    import gc
    import threading
    import numpy as np
    import torch
    (hollow, api_mod, Scheduler, kernels, COUNTERS, types, fl_mod,
     fast_ops) = mods
    budget_s = budget_ms / 1e3
    total_bulk = int(rate * duration_s)
    n_fast = int(fast_rate * duration_s)
    need = 2 * total_bulk + n_fast + probe_pods + 64
    n_nodes = max(n_nodes, -(-need // 36))
    interval_s = min(1.0, max(0.25, round(duration_s / 4.0, 2)))
    all_bulk = hollow.PROFILES["density"](2 * total_bulk)
    solo_pods, mixed_pods = all_bulk[:total_bulk], all_bulk[total_bulk:]

    def fast_pod(i):
        p = types.make_pod(f"fastbench-{i}", cpu=100, memory=128 << 20)
        p.annotations[fl_mod.FASTLANE_ANNOTATION] = "true"
        return p

    api = api_mod.ApiServerLite(max_log=max(200_000,
                                            6 * (n_nodes + total_bulk)))
    hollow.load_cluster(api, hollow.hollow_nodes(n_nodes), [])
    sched = Scheduler(api, record_events=False)
    sched.start()
    loop = sched.stream(budget_s=budget_s, min_quantum=64, max_quantum=128,
                        fastlane=True)
    for q in (64, 128):
        for p in hollow.PROFILES["density"](q):
            p.name = f"prime{q}-" + p.name
            api.create("Pod", p)
        sched.sync()
        loop.quantum = q
        loop.step()
    loop.quantum = 64
    loop.drain()
    bind_events, create_ts, fast_keys = [], {}, set()
    sched.wave_observer = lambda ts, keys: bind_events.append((ts, keys))

    def stamp(burst, ts):
        for p in burst:
            create_ts[p.key()] = ts

    def offer_window(bulk, fasts):
        t0 = time.monotonic()
        threads = [threading.Thread(target=paced_create,
                                    args=(api, pods_, rate_, t0, [0], stamp),
                                    daemon=True)
                   for pods_, rate_ in ((bulk, rate), (fasts, fast_rate))
                   if pods_]
        expect = len(create_ts) + len(bulk) + len(fasts)
        for t in threads:
            t.start()
        deadline = t0 + max(60.0, duration_s * 20)

        def done(stats, lp):
            if len(create_ts) >= expect and stats["popped"] == 0 \
                    and lp.settled():
                return True
            if time.monotonic() > deadline:
                fail("9d: a fast-lane window did not settle")
            return False

        loop.run(done)
        for t in threads:
            t.join(timeout=10)
        return t0, max((create_ts[p.key()] for p in bulk + fasts),
                       default=t0)

    def bulk_sustained(t0, offer_end):
        n_b = int((offer_end - t0) / interval_s) + 1
        iv = [0] * n_b
        for ts, keys in bind_events:
            if t0 <= ts <= offer_end:
                b = min(int((ts - t0) / interval_s), n_b - 1)
                iv[b] += sum(1 for k in keys if k not in fast_keys
                             and k in create_ts)
        k_end = int((offer_end - t0) / interval_s)
        steady = iv[1:k_end] if k_end > 1 else iv[:max(k_end, 1)]
        return sorted(steady)[len(steady) // 2] / interval_s \
            if steady else 0.0

    def fl_counts():
        return {k: v[0] for k, v in COUNTERS.snapshot().items()
                if k.startswith("fastlane.")}

    windows = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    COUNTERS.reset()
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        with spy if spy is not None else contextlib.nullcontext():
            t0, end = offer_window(solo_pods, [])
            solo_rate = bulk_sustained(t0, end)
            windows["solo"] = fl_counts()
            fasts = [fast_pod(i) for i in range(n_fast)]
            fast_keys.update(p.key() for p in fasts)
            t0, end = offer_window(mixed_pods, fasts)
            mixed_rate = bulk_sustained(t0, end)
            windows["mixed"] = fl_counts()
            sched.engine._refresh()
            dev_nodes = sched.engine._nodes_on_device()
            n_checked = resident_equals_host(fast_ops, sched.engine.snapshot,
                                             dev_nodes, 64, seed=37)
            c0 = {k: v[0] for k, v in COUNTERS.snapshot().items()}
            probes = [fast_pod(n_fast + i) for i in range(probe_pods)]
            fast_keys.update(p.key() for p in probes)
            offer_window([], probes)
            c1 = {k: v[0] for k, v in COUNTERS.snapshot().items()}
    finally:
        gc.enable()
        gc.unfreeze()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    sched.wave_observer = None
    loop.close()

    def delta(name):
        return int(c1.get(name, 0) - c0.get(name, 0))

    fast_lat, dup, seen = [], 0, set()
    for ts, keys in bind_events:
        for k in keys:
            if k in seen:
                dup += 1
                continue
            seen.add(k)
            if k in fast_keys and k in create_ts:
                fast_lat.append(ts - create_ts[k])
    lat = np.asarray(fast_lat)
    unplaced = sum(1 for p in api.list("Pod")[0] if not p.node_name)
    fl = fl_counts()
    outcomes = sum(fl.get(k, 0) for k in (
        "fastlane.bound", "fastlane.fell_back", "fastlane.bind_error",
        "fastlane.superseded"))
    rep = {
        "nodes": n_nodes, "fast_pods": len(fast_keys),
        "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3)
        if lat.size else None,
        "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3)
        if lat.size else None,
        "solo_bulk_sustained_pods_s": round(solo_rate, 1),
        "mixed_bulk_sustained_pods_s": round(mixed_rate, 1),
        "mixed_bulk_sustained": round(mixed_rate / solo_rate, 3)
        if solo_rate else None,
        "counters": fl,
        "dispatch_by_window": {
            "solo": {k: windows["solo"].get(k, 0) for k in (
                "fastlane.dispatch_device", "fastlane.dispatch_host")},
            "mixed": {k: windows["mixed"].get(k, 0) - windows["solo"].get(
                k, 0) for k in ("fastlane.dispatch_device",
                                "fastlane.dispatch_host")},
            "probe": {k: delta(k) for k in ("fastlane.dispatch_device",
                                            "fastlane.dispatch_host")}},
        "probe_deltas": {k: delta(k) for k in (
            "engine.wave_encode_build", "snapshot.refresh_rebuild",
            "snapshot.refresh_scan", "engine.wave_dispatch")},
        "outcomes": outcomes, "duplicate_binds": dup, "unplaced": unplaced,
        "spans_ms": p9_spans(COUNTERS)}
    if dup or unplaced:
        fail(f"9d: {dup} duplicate binds, {unplaced} pods unplaced")
    if outcomes != len(fast_keys):
        fail(f"9d: outcome counters {outcomes} != {len(fast_keys)} fast "
             f"pods")
    if rep["dispatch_by_window"]["probe"]["fastlane.dispatch_device"] <= 0:
        fail("9d: no fast-lane eval ran on the card in the probe window")
    if any(rep["probe_deltas"][k] for k in ("engine.wave_encode_build",
                                            "snapshot.refresh_rebuild",
                                            "snapshot.refresh_scan")):
        fail(f"9d: the probe window was not delta-free "
             f"{rep['probe_deltas']}")
    log(f"9d fast lane {n_nodes} nodes: {json.dumps(rep)} [{card}]")
    log(f"9d: right after the mixed window's last harvest, the card's "
        f"sample_eval over the re-synced resident tensors == the host twin "
        f"over the snapshot on {n_checked} index sets")
    return rep, launches, sched


def gang_card_vs_cpu(mods):
    """9e: gang_mix at 512 x 3,000 in chunks of 512, pipelined with
    overlap on and off and in flush mode, on the card and on the CPU:
    placements and RR counters agree."""
    n_nodes, n_pods = CHECK_SHAPE
    runs = {}
    for mode, overlap in (("pipelined", True), ("overlap off", False),
                          ("flush", True)):
        for dev in (None, "cpu"):
            api, tot, cnt, wall, _l, rr = gang_drain(
                mods, n_nodes, n_pods, gang_pipeline=mode != "flush",
                device=dev, overlap=overlap, chunk=512)
            runs[(mode, dev)] = (_placed(api), rr, tot["bound"])
        got, want = runs[(mode, None)], runs[(mode, "cpu")]
        diff = sum(got[0][k] != v for k, v in want[0].items())
        if diff or got[1:] != want[1:]:
            fail(f"9e gang_mix {mode}: card != CPU ({diff} placements; "
                 f"{got[1:]} vs {want[1:]})")
        log(f"9e gang_mix {n_nodes} x {n_pods} {mode}: card == CPU "
            f"({want[2]} bound, RR counter {want[1]})")


def preempt_card_vs_cpu(mods, dmods):
    """9e: on a 512-node store filled with 20 priority_churn pods a node,
    preempt_scan's candidate and bound and plan_wave_preemptions' plans
    agree between a card engine and a CPU engine on the same snapshot,
    and so do the classic _preempt_round's plans and placements through
    the daemon."""
    import numpy as np
    (hollow, cache_mod, SchedulingEngine, preempt_wave) = mods
    nodes, fill, rest = priority_world(hollow, 512, 20, 2000)
    cache = cache_mod.SchedulerCache()
    for n in nodes:
        cache.add_node(n)
    for p in fill:
        cache.add_pod(p)
    preemptors = [p for p in rest if p.priority > 0][:96]
    out = {}
    for dev in (None, "cpu"):
        eng = SchedulingEngine(cache, device=dev)
        eng._refresh()
        cand, bound, class_of = eng.preempt_scan(preemptors)
        plans = [(pl.pod.key(), pl.node_name,
                  sorted(v.key() for v in pl.victims))
                 for pl in preempt_wave.plan_wave_preemptions(
                     eng, preemptors)]
        out[dev] = (cand, bound, class_of, plans)
        eng.close()
    (c1, b1, k1, p1), (c2, b2, k2, p2) = out[None], out["cpu"]
    if not (np.array_equal(c1, c2) and np.array_equal(b1, b2)
            and k1 == k2 and p1 == p2):
        fail("9e preempt_scan / plan_wave_preemptions: card != CPU")
    if not p1 or not c1.any():
        fail("9e preempt_scan: no candidate, no plan")
    log(f"9e preempt_scan 512 nodes x {len(fill)} bound, "
        f"{len(preemptors)} preemptors: card == CPU (candidate "
        f"{tuple(c1.shape)}, {int(c1.sum())} set; {len(p1)} wave plans, "
        f"{sum(len(v) for _k, _n, v in p1)} victims)")
    runs = {}
    for dev in (None, "cpu"):
        api, plans, pre, rep = daemon_preemption(dmods, 512, 64,
                                                 device=dev)
        audit_daemon_preemption(api, plans, pre, f"9e daemon ({dev})")
        runs[dev] = (plans, _placed(api), rep["rr"])
    if runs[None] != runs["cpu"]:
        fail("9e classic _preempt_round: card != CPU")
    log(f"9e classic _preempt_round 512 nodes, 64 preemptors: card == CPU "
        f"({len(runs['cpu'][0])} plans, "
        f"{sum(len(v) for *_x, v in runs['cpu'][0])} victims)")


def sample_eval_card_vs_cpu(fast_ops, sched):
    """9e: sample_eval on the card == the CPU torch version == the host
    twin over the 5,000-node resident tensors of 9d, for SAMPLE_SETS
    seeded index sets: duplicates (ties), requests that fit nowhere, zero
    requests and best-effort pods, on the live rows and on a copy with
    pressured, tainted and cordoned rows."""
    import numpy as np
    import torch
    eng = sched.engine
    snap = eng.snapshot
    eng._refresh()
    dev = eng._nodes_on_device()
    live = {k: dev[k] for k in fast_ops.FAST_NODE_KEYS}
    host_live = {k: np.array(getattr(snap, k)) for k in
                 fast_ops.FAST_NODE_KEYS}
    rng = np.random.default_rng(29)
    n = host_live["alloc"].shape[0]
    host_p = {k: v.copy() for k, v in host_live.items()}
    host_p["mem_pressure"] |= rng.random(n) < 0.2
    host_p["disk_pressure"] |= rng.random(n) < 0.1
    host_p["schedulable"] &= rng.random(n) > 0.05
    t = host_p["taints_sched"]
    if t.shape[1]:
        t[rng.random(n) < 0.1, 0] = True
    pressured = {k: torch.from_numpy(v.copy()).to(live["alloc"].device)
                 for k, v in host_p.items()}
    reqs = []
    for cpu, mem in ((100, 128 << 20), (5000, 1 << 30), (0, 0),
                     (2000, 1 << 30)):
        reqs.append(snap.resource_row(
            milli_cpu=cpu, memory=mem, gpu=0, scratch=0, overlay=0,
            extended={}, up=True, width=snap.num_resources))
    n_fit = n_unfit = 0
    for i in range(SAMPLE_SETS):
        if i % 3 == 2:
            nodes_d, nodes_h = pressured, host_p
        else:
            nodes_d, nodes_h = live, host_live
        k = SAMPLE_K if i % 5 else 4
        idx = rng.integers(0, n, size=k).astype(np.int32)
        if i % 7 == 0:
            idx[1::2] = idx[0]           # ties
        req = reqs[i % len(reqs)]
        zero = i % len(reqs) == 2
        be = i % 2 == 0
        card_out = fast_ops.sample_eval(idx, req, zero, be, nodes_d).numpy()
        cpu_out = fast_ops.sample_eval(
            idx, req, zero, be,
            {k: v.cpu() for k, v in nodes_d.items()}).numpy()
        host_out = fast_ops.sample_eval_host(idx, req, zero, be, nodes_h)
        if not (np.array_equal(card_out, cpu_out)
                and np.array_equal(card_out, host_out)):
            fail(f"9e sample_eval set {i}: card {card_out}, CPU {cpu_out}, "
                 f"host {host_out}")
        if card_out[1] > 0:
            n_fit += 1
        else:
            n_unfit += 1
    if not n_fit or not n_unfit:
        fail(f"9e sample_eval: {n_fit} sets with a fit, {n_unfit} without")
    log(f"9e sample_eval: card == CPU == host twin on {SAMPLE_SETS} index "
        f"sets over {n} resident rows ({n_fit} with a fit, {n_unfit} all "
        f"unfit)")
    return live, reqs[0]


def time_device_functions(preempt_ops, fast_ops, prio_dev, nodes, req):
    """Card times of the two PyTorch device functions at their main-path
    shapes, beside their bounds: victim_scan at 9b's 5,000-node band
    tensors with the profile's four band classes padded to C = 4, and
    sample_eval at k = 16 over 9d's resident tensors."""
    import numpy as np
    import torch
    d = prio_dev
    n_nodes, b = d["band_cpu"].shape
    dev = d["band_cpu"].device
    need = torch.full((4,), 200, dtype=torch.int32, device=dev)
    need_mem = torch.full((4,), (256 << 20) >> 10, dtype=torch.int32,
                          device=dev)
    prio = torch.tensor([0, 100, 1000, 10000], dtype=torch.int32,
                        device=dev)
    args = (need, need_mem, prio, d["spare_cpu"], d["spare_mem"],
            d["pod_count"], d["allowed"], d["band_cpu"], d["band_mem"],
            d["band_count"], d["band_prio"])
    c = 4
    vs_bytes = 3 * c * 4 + 4 * n_nodes * 4 + 3 * n_nodes * b * 4 + b * 4 \
        + c * n_nodes * (1 + 4)
    vs_ops = 3 * 2 * n_nodes * b * b + 12 * c * n_nodes * b
    vs_bound = max(vs_bytes / HBM_BYTES_PER_S,
                   vs_ops / CUDA_CORE_OPS_PER_S) * 1e3
    vs = {"shape": [c, n_nodes, b],
          "ms": time_ms(lambda: preempt_ops.victim_scan(*args)),
          "device_ms": time_device_ms(
              lambda: preempt_ops.victim_scan(*args), reps=10),
          "bound_ms": vs_bound,
          "bound_by": "bytes" if vs_bytes / HBM_BYTES_PER_S
          >= vs_ops / CUDA_CORE_OPS_PER_S else "operations"}
    cpu_args = tuple(a.cpu() for a in args)
    t0 = time.perf_counter()
    for _ in range(5):
        preempt_ops.victim_scan(*cpu_args)
    vs["cpu_ms"] = 1e3 * (time.perf_counter() - t0) / 5
    rng = np.random.default_rng(31)
    idx = rng.integers(0, nodes["alloc"].shape[0],
                       size=SAMPLE_K).astype(np.int32)
    k, r = SAMPLE_K, int(nodes["alloc"].shape[1])
    t_w = int(nodes["taints_sched"].shape[1])
    se_bytes = k * 8 + r * 4 + k * (2 * r * 4 + 2 * 4 + 4 + t_w) + 3 * 4
    idx_d = torch.from_numpy(idx.astype(np.int64)).to(dev)
    req_d = torch.from_numpy(np.asarray(req, dtype=np.int32)).to(dev)
    se = {"k": k, "n": int(nodes["alloc"].shape[0]),
          "ms": time_ms(lambda: fast_ops.sample_eval(idx, req, False, False,
                                                     nodes)),
          "device_ms": time_device_ms(lambda: fast_ops.sample_eval_device(
              idx_d, req_d, False, False, nodes), reps=10),
          "bound_ms": se_bytes / HBM_BYTES_PER_S * 1e3,
          "bound_by": "bytes"}
    host_nodes = {kk: v.cpu().numpy() for kk, v in nodes.items()}
    t0 = time.perf_counter()
    for _ in range(200):
        fast_ops.sample_eval_host(idx, req, False, False, host_nodes)
    se["host_twin_ms"] = 1e3 * (time.perf_counter() - t0) / 200
    log("device functions: " + json.dumps({"victim_scan": vs,
                                           "sample_eval": se}))
    return vs, se


def the_slice(mods, card):
    """Phase 9: gangs, PodPriority preemption and the fast lane on the
    card. Returns (launches summed over 9a-9d, max abs err per kernel)."""
    t_phase = time.perf_counter()
    (hollow, types, api_mod, Scheduler, daemon, scheme, kernels, COUNTERS,
     churn, preempt_wave, preemption, features, gang, fl_mod, fast_ops,
     preempt_ops, cache_mod, SchedulingEngine) = mods
    smods = (hollow, api_mod, Scheduler, kernels, COUNTERS)
    total = {k: 0 for k in kernels.LAUNCHES}
    err = {k: 0 for k in kernels.LAUNCHES}

    def add(launches, errs):
        for k, v in launches.items():
            total[k] += v
        for k, v in errs.items():
            err[k] = max(err[k], v)

    t = time.perf_counter()
    add(*gangs_on_the_card(smods, card, gang.GANG_NAME_ANNOTATION))
    log(f"9a took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches, errs, prio_dev = preemption_on_the_card(
        (hollow, api_mod, Scheduler, kernels, COUNTERS, churn,
         preempt_wave, features), card)
    add(launches, errs)
    log(f"9b took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    dmods = (hollow, api_mod, daemon, scheme, kernels, COUNTERS, features,
             preemption)
    spy = OperandSpy(kernels)
    api, plans, pre, rep = daemon_preemption(dmods, N_NODES,
                                             PRIO_DAEMON_PODS, spy=spy)
    n_bound, n_nowhere, n_vics = audit_daemon_preemption(api, plans, pre,
                                                         "9c daemon")
    del api
    log(f"9c daemon, PodPriority on, {N_NODES} full nodes + "
        f"{PRIO_DAEMON_PODS} prod/system pods: {len(rep['steps'])} steps "
        f"{json.dumps(rep['steps'])} in {rep['wall']:.3f} s; {len(plans)} "
        f"plans, {n_vics} victims, preemptors bound {n_bound}, fitting "
        f"nowhere {n_nowhere}; audits clean [{card}]; spans (ms) "
        f"{json.dumps(rep['spans_ms'])}")
    if not plans or not n_bound:
        fail("9c: the classic round preempted or bound nothing")
    if rep["launches"]["capacity_fit"] == 0:
        fail("9c: no capacity launch")
    add(rep["launches"], spy.check("9c daemon"))
    log(f"9c launches {rep['launches']}; 9c took "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    spy = OperandSpy(kernels)
    frep, launches, fsched = fastlane_mixed(
        (hollow, api_mod, Scheduler, kernels, COUNTERS, types, fl_mod,
         fast_ops), card, spy=spy, **FASTLANE)
    if launches["capacity_fit"] == 0:
        fail("9d: no capacity launch")
    add(launches, spy.check("9d fast lane"))
    log(f"9d launches {launches}; 9d took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    gang_card_vs_cpu(smods)
    preempt_card_vs_cpu((hollow, cache_mod, SchedulingEngine, preempt_wave),
                        dmods)
    nodes, req = sample_eval_card_vs_cpu(fast_ops, fsched)
    log(f"9e took {time.perf_counter() - t:.1f} s")
    vs, se = time_device_functions(preempt_ops, fast_ops, prio_dev, nodes,
                                   req)
    fsched.engine.close()
    log(f"phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return total, err, {"victim_scan": vs, "sample_eval": se}


# ---------------------------------------------------------------- phase 10

# 10a: bench.py measure_multiproc's sweep (its default: 64 nodes, 96 pods
# a worker) over one shared cell of 5,000 hollow nodes: (workers,
# overlap) runs, relist every 16 as bench does; depth cut from
# 500 pods a worker to 100 so that phase 10 stays near 90 s and the run
# near 8 minutes (at 500 the three runs took 89 s alone; at 200, 77.5 s
# in a whole run of 492.0 s)
FLEET = {"n_nodes": 5000, "pods_per_worker": 100, "relist_every": 16,
         "runs": ((1, 0.0), (2, 0.0), (2, 0.5))}
# 10b: bench.py measure_federation's stream at 5,000 nodes a cell (the
# v1.7 cluster limit; bench's default 50,000), then one burst admission
FED = {"cells": 4, "nodes_per_cell": 5000, "zones": 8, "pods": 1600,
       "gangs": 4, "gang_size": 6, "batch": 64, "brownout_down_s": 1.5,
       "burst": 2048, "warm": 8}
# 10b's in-process cell, where the operand spy sees the launches
LOCAL_CELL = {"n_nodes": 5000, "pods": 1024, "gangs": 2, "gang_size": 6}
# 10c: route_scores card == CPU == host twin at these [C, M]
ROUTE_C = (1, 33, 256, 2048, 8192)
ROUTE_M = (4, 16)
ROUTE_REGIMES = ("random", "wrap", "ties", "zero_cap", "not_ready",
                 "negative")
ROUTE_TIMED = (2048, 4)


class ReportingQueue:
    """A spawned child's view of its result queue: the message that ends
    the child's run (a worker's result, a cell's final report) also
    carries the child's kernel launch counts, the launch shapes its
    OperandSpy saw, and the spy's kernel == plain check on those
    operands (its launches are read before the check makes more)."""

    def __init__(self, q, kernels, spy, tag):
        self.q, self.kernels, self.spy, self.tag = q, kernels, spy, tag
        # a cell child's agent, its pump thread's exception and its
        # loop's closing stats (cell_probe fills them)
        self.agent = self.pump_error = self.loop_stats = None

    def put(self, msg):
        if msg.get("final") or "worker" in msg:
            msg = dict(msg)
            if self.agent is not None:
                stuck = [p for p in self.agent.api.list("Pod")[0]
                         if not p.node_name]
                msg["pending_pods"] = [
                    (p.key(), sorted((p.annotations or {}).items()))
                    for p in stuck[:20]]
                msg["pump_alive"] = self.agent._thread.is_alive()
                msg["pump_error"] = self.pump_error
                msg["loop_stats"] = self.loop_stats
            msg["launches"] = dict(self.kernels.LAUNCHES)
            cap, inc = self.spy.shapes()
            msg["shapes"] = {"capacity": cap, "incidence": inc}
            try:
                msg["max_err"] = self.spy.check(self.tag)
            except SystemExit as e:
                msg["ok"] = False
                msg["error"] = str(e)
        self.q.put(msg)


def cell_probe(cell_mod, q):
    """In a cell child: keep the CellAgent, its pump thread's exception
    (the thread would die silently) and its loop's closing stats on the
    ReportingQueue, for the final report."""
    import traceback
    agent_cls = cell_mod.CellAgent
    real_init, real_pump, real_stop = (agent_cls.__init__, agent_cls._pump,
                                       agent_cls.stop)

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        q.agent = self

    def pump(self):
        try:
            real_pump(self)
        except BaseException:
            q.pump_error = traceback.format_exc()
            raise

    def stop(self):
        q.loop_stats = real_stop(self)
        return q.loop_stats

    agent_cls.__init__, agent_cls._pump, agent_cls.stop = init, pump, stop


def p10_child(kind, cfg, out_q, ctrl_q=None):
    """Spawn target of phase 10's children (module level, so a spawned
    process can import it): a fleet worker (``_worker_main``) or a cell
    process (``run_cell_process``) of the port, with the kernel wrappers
    spied and the launch counts sent back on the result queue."""
    from kubernetes_tpu_torch.ops import kernels
    spy = OperandSpy(kernels)
    name = cfg.get("cell", cfg.get("worker_id"))
    q = ReportingQueue(out_q, kernels, spy, f"10 {kind} {name}")
    with spy:
        if kind == "cell":
            from kubernetes_tpu_torch.federation import cell as cell_mod
            cell_probe(cell_mod, q)
            cell_mod.run_cell_process(cfg, q, ctrl_q)
        else:
            from kubernetes_tpu_torch.parallel.multiproc import _worker_main
            _worker_main(cfg, q)


def _add_child(total, err, shapes, msg, tag):
    """Fold one child's report into the phase's sums; fail if it did
    not run, did not launch the capacity kernel or disagreed."""
    if not msg.get("ok"):
        fail(f"{tag}: {msg.get('error')}")
    if "launches" not in msg:
        fail(f"{tag}: no launch report")
    if msg["launches"]["capacity_fit"] == 0:
        fail(f"{tag}: no capacity launch")
    for k, v in msg["launches"].items():
        total[k] += v
    for k, v in msg["max_err"].items():
        err[k] = max(err[k], v)
    shapes.update(tuple(s) for s in msg["shapes"]["capacity"])


def process_fleet(mods, card, total, err, shapes):
    """10a: run_process_fleet on the card as bench.py measure_multiproc
    runs it, each worker a spawned p10_child; logs bench's slim report
    of each run."""
    import functools
    from kubernetes_tpu_torch.parallel import multiproc
    kernels = mods[0]
    real = multiproc._worker_main
    multiproc._worker_main = functools.partial(p10_child, "worker")
    try:
        for w, ov in FLEET["runs"]:
            prefix = f"p10w{w}o{int(ov * 100)}"
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            r = multiproc.run_process_fleet(
                w, pods_per_worker=FLEET["pods_per_worker"], overlap=ov,
                n_nodes=FLEET["n_nodes"],
                relist_every=FLEET["relist_every"], pod_prefix=prefix,
                timeout_s=300.0, device=None)
            wall = time.perf_counter() - t0
            parent = dict(kernels.LAUNCHES)
            agg = r["agg"]
            tag = f"10a W={w} overlap {ov}"
            if agg["missing_workers"] or agg["worker_failures"]:
                fail(f"{tag}: {agg['missing_workers']} missing workers, "
                     f"failures {agg['worker_failures']}")
            if agg["duplicate_binds"]:
                fail(f"{tag}: {agg['duplicate_binds']} duplicate binds")
            if sum(agg["server_conflict_reasons"].values()) \
                    != agg["server_bind_conflicts"]:
                fail(f"{tag}: conflict reasons do not partition")
            pods = [p for p in r["api"].list("Pod")[0]
                    if p.name.startswith(prefix)]
            unbound = [p.key() for p in pods if not p.node_name]
            if unbound or agg["gave_up"]:
                fail(f"{tag}: {len(unbound)} pods unbound, "
                     f"{agg['gave_up']} given up")
            child = {k: 0 for k in kernels.LAUNCHES}
            for wr in r["workers"]:
                _add_child(child, err, shapes, wr, f"{tag} worker "
                           f"{wr.get('worker')}")
            for k in total:
                total[k] += child[k] + parent[k]
            slim = {k: agg[k] for k in (
                "workers", "pods_per_worker", "overlap", "binds",
                "conflicts", "double_claim", "stale_snapshot", "relists",
                "gave_up", "server_bind_conflicts",
                "server_conflict_reasons", "duplicate_binds",
                "missing_workers")}
            slim.update(pods_s=agg["scheduled_pods_s"], wall_s=agg["wall_s"],
                        conflict_rate=agg["conflict_rate"],
                        worker_failures=len(agg["worker_failures"]),
                        call_wall_s=wall, pods=len(pods),
                        launches_workers=child, launches_parent=parent)
            log(f"{tag}, {FLEET['n_nodes']} nodes, "
                f"{FLEET['pods_per_worker']} pods a worker: "
                f"{json.dumps(slim)} [{card}]")
            del r, pods
    finally:
        multiproc._worker_main = real


def _fed_pods(types, gang, names):
    """bench.py measure_federation's offered stream: plain pods, one in
    8 pinned to a zone of one cell, and whole-cell gangs."""
    pods = []
    for i in range(FED["pods"]):
        sel = None
        if i % 8 == 5:
            cell = names[(i // 8) % len(names)]
            sel = {"zone": f"{cell}-z{i % FED['zones']}"}
        pods.append(types.make_pod(f"fedp-{i}", cpu=100,
                                   memory=64 * 1024 ** 2, node_selector=sel))
    for g in range(FED["gangs"]):
        for m in range(FED["gang_size"]):
            p = types.make_pod(f"fedgang{g}-{m}", cpu=50,
                               memory=32 * 1024 ** 2)
            p.annotations[gang.GANG_NAME_ANNOTATION] = f"fedgang{g}"
            p.annotations[gang.GANG_MIN_AVAILABLE_ANNOTATION] = str(
                FED["gang_size"])
            pods.append(p)
    return pods


def _drain_router(router, driver, t_start, timeout_s):
    """Spill pumps until every column is empty, the backlog too, and the
    brownout schedule has played out. Returns the wall, or None when
    that did not happen within timeout_s."""
    td = time.monotonic()
    while time.monotonic() - td < timeout_s:
        if driver is not None:
            driver.apply_until(time.monotonic() - t_start)
        router.spill_pump()
        pending = sum(a.pending for a in router.aggs.values())
        if pending == 0 and not router.backlog \
                and (driver is None or driver.done()):
            return time.monotonic() - td
        time.sleep(0.1)
    log(f"10b: the federation did not drain in {timeout_s} s (pending "
        f"{ {n: a.pending for n, a in router.aggs.items()} }, backlog "
        f"{len(router.backlog)})")
    return None


def _p99(spans):
    if not spans:
        return 0.0
    spans = sorted(spans)
    return spans[min(len(spans) - 1, int(round(0.99 * (len(spans) - 1))))]


def federation(mods, card, total, err, shapes):
    """10b: bench.py measure_federation's path on the card: FED["cells"]
    cell processes (each a p10_child running run_cell_process: a
    CellAgent with its Scheduler on the card behind AsyncBinaryServer),
    one FederationRouter(device=None) over WireCells, the offered stream
    with a brownout, then one burst admission. Audited from each cell's
    store; returns route_scores' launches (the router's device
    batches)."""
    import multiprocessing
    (types, gang, router_mod, churn, kernels) = mods
    names = [f"cell{i}" for i in range(FED["cells"])]
    ctx = multiprocessing.get_context("spawn")
    procs = []
    router = None
    try:
        t0 = time.monotonic()
        for i, name in enumerate(names):
            out_q, ctrl_q = ctx.Queue(), ctx.Queue()
            cfg = {"cell": name, "n_nodes": FED["nodes_per_cell"],
                   "seed": i, "zones": FED["zones"],
                   "spill_after_attempts": 2, "device": None}
            p = ctx.Process(target=p10_child,
                            args=("cell", cfg, out_q, ctrl_q),
                            name=f"fed-{name}", daemon=True)
            p.start()
            procs.append({"name": name, "proc": p, "out": out_q,
                          "ctrl": ctrl_q})
        for rec in procs:
            msg = rec["out"].get(timeout=max(300 - (time.monotonic() - t0),
                                             1.0))
            if not msg.get("ok"):
                fail(f"10b cell {rec['name']} failed to boot: "
                     f"{msg.get('error')}")
            rec["port"] = msg["port"]
        boot_s = time.monotonic() - t0
        kernels.reset_launch_counts()
        router = router_mod.FederationRouter(
            [router_mod.WireCell(r["name"], "127.0.0.1", r["port"])
             for r in procs], device=None)
        th = time.monotonic()
        router.hydrate()
        hydrate_s = time.monotonic() - th
        agg_nodes = sum(a.nodes_total for a in router.aggs.values())
        warm = [types.make_pod(f"fedwarm-{i}", cpu=100,
                               memory=64 * 1024 ** 2)
                for i in range(FED["warm"])]
        router.admit(warm)
        router.admit_spans.clear()
        pods = _fed_pods(types, gang, names)
        rate = 250.0 * (os.cpu_count() or 1)
        batch = FED["batch"]
        schedule = churn.make_brownout_schedule(
            names, duration_s=max(len(pods) / rate,
                                  FED["brownout_down_s"] * 2 + 1.0),
            down_s=FED["brownout_down_s"], count=1, seed=0)
        driver = churn.BrownoutDriver(router, schedule)
        t_start = time.monotonic()
        sent = 0
        gang_of = [(p.annotations or {}).get(gang.GANG_NAME_ANNOTATION)
                   for p in pods]
        while sent < len(pods):
            now = time.monotonic() - t_start
            driver.apply_until(now)
            due = min(len(pods), int(now * rate) + batch)
            # unlike bench.py's loop, never cut a gang between two
            # admits: the router keeps a gang whole only within one
            # admit, and a split gang never reaches quorum in either cell
            while 0 < due < len(pods) and gang_of[due] is not None \
                    and gang_of[due] == gang_of[due - 1]:
                due += 1
            if due > sent:
                router.admit(pods[sent:due])
                sent = due
                if (sent // batch) % 4 == 0:
                    router.refresh()
            else:
                time.sleep(min(batch / rate, 0.05))
        offer_s = time.monotonic() - t_start
        drain_s = _drain_router(router, driver, t_start, 120.0)
        stream_spans = [d for _t, d, _n in router.admit_spans]
        steady = [d for _t, d, n in router.admit_spans if n <= batch]
        stream_counters = router.counters_snapshot()
        # the burst: one admit of FED["burst"] plain pods, past
        # DEVICE_MIN_BATCH, so route_scores runs on the card
        burst = [types.make_pod(f"fedburst-{i}", cpu=100,
                                memory=64 * 1024 ** 2)
                 for i in range(FED["burst"])]
        tb = time.monotonic()
        burst_admit_s = burst_drain_s = None
        if drain_s is not None:
            router.admit(burst)
            burst_admit_s = time.monotonic() - tb
            burst_drain_s = _drain_router(router, None, t_start, 120.0)
        counters = router.counters_snapshot()
        router_launches = dict(kernels.LAUNCHES)
        router.close()
        router = None
        for rec in procs:
            rec["ctrl"].put("stop")
        finals = {}
        for rec in procs:
            msg = rec["out"].get(timeout=120.0)
            while not msg.get("final"):
                msg = rec["out"].get(timeout=120.0)
            finals[rec["name"]] = msg
            rec["proc"].join(timeout=60.0)
    finally:
        if router is not None:
            router.close()
        for rec in procs:
            if rec["proc"].is_alive():
                rec["ctrl"].put("stop")
        for rec in procs:
            rec["proc"].join(timeout=30.0)
            if rec["proc"].is_alive():
                rec["proc"].terminate()
                rec["proc"].join(timeout=10.0)
    # ---- the audits: store truth from every cell
    if drain_s is None or burst_drain_s is None:
        for name, f in finals.items():
            log(f"10b {name} at the stop: " + json.dumps(
                {k: f.get(k) for k in ("ok", "error", "pending",
                                       "pending_pods", "pump_alive",
                                       "pump_error", "loop_stats",
                                       "counters")}, default=str))
        fail("10b: the federation did not drain")
    owner, cross, dup = {}, 0, {}
    child = {k: 0 for k in kernels.LAUNCHES}
    for name, f in finals.items():
        _add_child(child, err, shapes, f, f"10b {name}")
        dup[name] = f["duplicate_binds"]
        for key in f["bound"]:
            if key in owner and owner[key] != name:
                cross += 1
            owner[key] = name
    if cross or any(dup.values()):
        fail(f"10b: cross-cell double binds {cross}, per-cell duplicate "
             f"binds {dup}")
    offered = {p.key() for p in warm + pods + burst}
    pending = sum(f["pending"] for f in finals.values())
    if pending or set(owner) != offered:
        fail(f"10b: {pending} pods pending, {len(offered - set(owner))} "
             f"offered pods not bound, {len(set(owner) - offered)} bound "
             f"pods not offered")
    for g in range(FED["gangs"]):
        homes = {owner[f"default/fedgang{g}-{m}"]
                 for m in range(FED["gang_size"])}
        if len(homes) != 1:
            fail(f"10b: gang fedgang{g} spans cells {homes}")
    if counters["device_batches"] < 1:
        fail("10b: route_scores never ran on the card")
    for k in total:
        total[k] += child[k] + router_launches[k]
    rep = {
        "cells": FED["cells"], "nodes_per_cell": FED["nodes_per_cell"],
        "agg_nodes": agg_nodes, "boot_s": boot_s, "hydrate_s": hydrate_s,
        "offered_rate_pods_s": rate, "offered_pods": len(pods),
        "offer_s": offer_s, "drain_s": drain_s,
        "stream_pods_s": len(pods) / (offer_s + drain_s),
        "admission_p50_ms": 1e3 * statistics.median(stream_spans),
        "admission_p99_ms": 1e3 * _p99(stream_spans),
        "steady_batch_p99_ms": 1e3 * _p99(steady),
        "admission_batches": len(stream_spans),
        "brownout": {"cell": schedule[0].cell, "t": schedule[0].t,
                     "down_s": schedule[0].down_s},
        "burst_pods": len(burst), "burst_admit_ms": 1e3 * burst_admit_s,
        "burst_drain_s": burst_drain_s,
        "burst_pods_s": len(burst) / (burst_admit_s + burst_drain_s),
        "stream_device_batches": stream_counters["device_batches"],
        "stream_host_batches": stream_counters["host_batches"],
        "device_batches": counters["device_batches"],
        "host_batches": counters["host_batches"],
        "spill_moved": counters["spill_moved"],
        "evacuated_moved": counters["evacuated_moved"],
        "bound": len(owner), "duplicate_binds_per_cell": dup,
        "cross_cell_double_binds": cross,
        "per_cell_bound": {n: len(f["bound"]) for n, f in finals.items()},
        "launches_cells": child, "launches_router": router_launches,
    }
    log(f"10b federation, {FED['cells']} cells x {FED['nodes_per_cell']} "
        f"nodes: {json.dumps(rep)} [{card}]")
    return counters["device_batches"]


def local_cell(mods, card, total, err):
    """10b, in process: one CellAgent on the card at 5,000 nodes behind a
    FederationRouter over a LocalCell, where the operand spy sees every
    launch; a plain stream with two gangs drains, audited from the
    store, and each launch shape is held against the plain version."""
    (hollow, types, gang, cell_mod, router_mod, multiproc, kernels) = mods
    nodes = hollow.hollow_nodes(LOCAL_CELL["n_nodes"], seed=9)
    for i, n in enumerate(nodes):
        n.labels["zone"] = f"local-z{i % FED['zones']}"
    pods = [types.make_pod(f"loc-{i}", cpu=100 * (1 + i % 3),
                           memory=64 * 1024 ** 2)
            for i in range(LOCAL_CELL["pods"])]
    for g in range(LOCAL_CELL["gangs"]):
        for m in range(LOCAL_CELL["gang_size"]):
            p = types.make_pod(f"locgang{g}-{m}", cpu=50,
                               memory=32 * 1024 ** 2)
            p.annotations[gang.GANG_NAME_ANNOTATION] = f"locgang{g}"
            p.annotations[gang.GANG_MIN_AVAILABLE_ANNOTATION] = str(
                LOCAL_CELL["gang_size"])
            pods.append(p)
    spy = OperandSpy(kernels)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with spy:
        agent = cell_mod.CellAgent("local", nodes, device=None)
        try:
            agent.start()
            router = router_mod.FederationRouter(
                [router_mod.LocalCell("local", agent.service)],
                device=None)
            router.hydrate()
            router.admit(pods)
            if _drain_router(router, None, 0.0, 120.0) is None:
                fail("10b in-process cell: the cell did not drain")
        finally:
            agent.stop()
            agent.sched.engine.close()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if launches["capacity_fit"] == 0:
        fail("10b in-process cell: no capacity launch")
    placed = agent.api.list("Pod")[0]
    if any(not p.node_name for p in placed) or len(placed) != len(pods):
        fail("10b in-process cell: not every pod bound")
    if multiproc.audit_duplicate_binds(agent.api):
        fail("10b in-process cell: duplicate binds")
    for k, v in spy.check("10b in-process cell").items():
        err[k] = max(err[k], v)
    for k, v in launches.items():
        total[k] += v
    cap, _inc = spy.shapes()
    log(f"10b in-process cell, {LOCAL_CELL['n_nodes']} nodes, "
        f"{len(pods)} pods: all bound in {wall:.3f} s, launches "
        f"{launches}, capacity shapes (C, N, R) {cap} [{card}]")
    return cap


def route_operands(rng, c, m, regime):
    """route_scores' nine host operands in one regime (the tests'
    regimes: random, int32 differences that wrap, ties, zero
    capacities, one ready cell, negative headroom)."""
    import numpy as np
    i32min, i32max = -2 ** 31, I32_MAX
    dem_cpu = rng.integers(0, 2000, c).astype(np.int32)
    dem_mem = rng.integers(0, 2000, c).astype(np.int32)
    cpu_free = rng.integers(-500, 40_000, m).astype(np.int32)
    mem_free = rng.integers(-500, 40_000, m).astype(np.int32)
    cpu_cap = rng.integers(1, 80_000, m).astype(np.int32)
    mem_cap = rng.integers(1, 80_000, m).astype(np.int32)
    pressure = rng.uniform(0, 3, m).astype(np.float32)
    ready = rng.random(m) > 0.3
    dom_ok = rng.random((c, m)) > 0.2
    if regime == "wrap":
        cpu_free[::2] = i32min + rng.integers(0, 1000, cpu_free[::2].size)
        mem_free[1::2] = i32max - rng.integers(0, 1000, mem_free[1::2].size)
        dem_cpu[::3] = rng.integers(1000, 2 ** 30, dem_cpu[::3].size)
        dem_mem[1::3] = -rng.integers(1000, 2 ** 30, dem_mem[1::3].size)
        cpu_cap[:] = rng.integers(i32max // 2, i32max, m)
    elif regime == "ties":
        for a in (cpu_free, mem_free, cpu_cap, mem_cap, pressure):
            a[:] = a[0]
        ready[:] = True
        dom_ok[:] = True
    elif regime == "zero_cap":
        cpu_cap[::2] = 0
        mem_cap[1::2] = 0
        cpu_free[:] = rng.integers(0, 3, m)
    elif regime == "not_ready":
        ready[:] = False
        ready[m // 2] = True
    elif regime == "negative":
        cpu_free[:] = -rng.integers(1, 1000, m)
    return (dem_cpu, dem_mem, cpu_free, mem_free, cpu_cap, mem_cap,
            pressure, ready, dom_ok)


# four frozen columns: c0 nearly full, c1 drowning in pending pods, c2
# short of cpu and c3 short of memory at about the same headroom, so the
# batch's three pod sizes split between c2 and c3 by their demand
FROZEN_CELLS = {
    "c0": dict(nodes_total=10, nodes_ready=10, cpu_alloc_m=400_000,
               mem_alloc_mib=409_600, cpu_used_m=350_000,
               mem_used_mib=40_960, pending=0,
               domains={"z0": 5, "z1": 5}),
    "c1": dict(nodes_total=10, nodes_ready=10, cpu_alloc_m=400_000,
               mem_alloc_mib=409_600, cpu_used_m=80_000,
               mem_used_mib=40_960, pending=120, domains={"z1": 10}),
    "c2": dict(nodes_total=10, nodes_ready=10, cpu_alloc_m=400_000,
               mem_alloc_mib=409_600, cpu_used_m=200_000,
               mem_used_mib=40_960, pending=0, domains={"z2": 10}),
    "c3": dict(nodes_total=10, nodes_ready=10, cpu_alloc_m=400_000,
               mem_alloc_mib=409_600, cpu_used_m=80_000,
               mem_used_mib=204_859, pending=0,
               domains={"z2": 4, "z3": 6}),
}


class _FrozenHandle:
    def __init__(self, name):
        self.name = name

    def close(self):
        pass


def frozen_route(mods, device, use_device):
    """One route() of a 2,048-pod mixed batch (three sizes, zone pins,
    two gangs, one pod no cell fits, an exclude map) over FROZEN_CELLS."""
    types, gang, agg_mod, router_mod = mods
    router = router_mod.FederationRouter(
        [_FrozenHandle(n) for n in FROZEN_CELLS], use_device=use_device,
        device=device)
    for name, shape in FROZEN_CELLS.items():
        router.aggs[name] = agg_mod.CellAggregate(cell=name, ready=True,
                                                  **shape)
    pods = [types.make_pod(f"fr-{i}", cpu=100 + 50 * (i % 3),
                           memory=64 << 20) for i in range(2020)]
    for z in ("z1", "z2", "z3", "z9"):
        pods.append(types.make_pod(f"fr-pin-{z}", cpu=100, memory=64 << 20,
                                   node_selector={"zone": z}))
    pods.append(types.make_pod("fr-huge", cpu=10 ** 7, memory=64 << 20))
    for g, size in (("frg0", 8), ("frg1", 15)):
        for m in range(size):
            p = types.make_pod(f"{g}-{m}", cpu=50, memory=32 << 20)
            p.annotations[gang.GANG_NAME_ANNOTATION] = g
            pods.append(p)
    exclude = {f"default/fr-{i}": "c1" for i in range(0, 2020, 7)}
    assigned, leftover = router.route(pods, exclude=exclude)
    return ({c: [p.key() for p in ps] for c, ps in assigned.items()},
            [p.key() for p in leftover], router.counters_snapshot(),
            len(pods))


def route_card_vs_cpu(mods, card):
    """10c: route_scores on the card == the port's CPU route == the host
    twin at every [C, M] of ROUTE_C x ROUTE_M in every regime; a frozen
    router's route() of a 2,048-pod mixed batch is the same on the card,
    on the CPU and through the host twin; route_scores timed at
    ROUTE_TIMED beside its bound and its host twin."""
    import numpy as np
    import torch
    (types, gang, agg_mod, router_mod, fed) = mods
    n = 0
    for c in ROUTE_C:
        for m in ROUTE_M:
            for regime in ROUTE_REGIMES:
                rng = np.random.default_rng([c, m, len(regime)])
                args = route_operands(rng, c, m, regime)
                got = fed.route_scores(*args, device=None)
                cpu = fed.route_scores(*args, device="cpu")
                host = fed.route_scores_host(*args)
                if got.dtype != np.int32 or got.shape != (2, c) \
                        or not np.array_equal(got, cpu) \
                        or not np.array_equal(got, host):
                    fail(f"10c route_scores C={c} M={m} {regime}: card "
                         f"!= CPU or host twin")
                n += 1
    log(f"10c route_scores: card == CPU == host twin in {n} cases (C in "
        f"{list(ROUTE_C)}, M in {list(ROUTE_M)}, {len(ROUTE_REGIMES)} "
        f"regimes)")
    fmods = (types, gang, agg_mod, router_mod)
    card_r = frozen_route(fmods, None, True)
    cpu_r = frozen_route(fmods, "cpu", True)
    host_r = frozen_route(fmods, "cpu", False)
    if card_r[:2] != cpu_r[:2] or card_r[:2] != host_r[:2]:
        fail("10c frozen route(): card != CPU or host twin")
    if card_r[2]["device_batches"] != 1 or host_r[2]["host_batches"] != 1:
        fail(f"10c frozen route(): routes not taken as asked "
             f"({card_r[2]}, {host_r[2]})")
    log(f"10c frozen route() of {card_r[3]} pods over 4 cells: card == "
        f"CPU == host twin ({ {c: len(k) for c, k in card_r[0].items()} }"
        f", {len(card_r[1])} left over)")
    # ---- timing at the burst's shape
    c, m = ROUTE_TIMED
    args = route_operands(np.random.default_rng(77), c, m, "random")
    dev = torch.device("cuda")
    dargs = [torch.from_numpy(np.array(a)).to(dev) for a in args]
    nbytes = sum(a.nbytes for a in args) + 2 * c * 4
    ops = 16 * c * m
    b_bytes, b_ops = nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S
    rs = {"shape": [c, m],
          "ms": time_ms(lambda: fed.route_scores(*args, device=None)),
          "device_ms": time_device_ms(
              lambda: fed.route_scores_device(*dargs), reps=10),
          "bound_ms": max(b_bytes, b_ops) * 1e3,
          "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
    t0 = time.perf_counter()
    for _ in range(200):
        fed.route_scores_host(*args)
    rs["host_twin_ms"] = 1e3 * (time.perf_counter() - t0) / 200
    log("10c route_scores timing: " + json.dumps(rs))
    return rs


def federation_and_fleet(mods, card):
    """Phase 10: the process fleet (10a), the federation (10b) and card
    == CPU for the routing (10c). Returns (launches summed over 10a and
    10b, max abs err per kernel, {"route_scores": timing})."""
    t_phase = time.perf_counter()
    (hollow, types, gang, churn, kernels, fed, agg_mod, router_mod,
     cell_mod, multiproc) = mods
    total = {k: 0 for k in kernels.LAUNCHES}
    err = {k: 0 for k in kernels.LAUNCHES}
    shapes = set()
    t = time.perf_counter()
    process_fleet((kernels,), card, total, err, shapes)
    log(f"10a took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    device_batches = federation(
        (types, gang, router_mod, churn, kernels), card, total, err, shapes)
    local_shapes = local_cell((hollow, types, gang, cell_mod, router_mod,
                               multiproc, kernels), card, total, err)
    log(f"10b took {time.perf_counter() - t:.1f} s")
    # the children's capacity launch shapes, held against the plain
    # version in this process too (operands drawn at each shape)
    import numpy as np
    rng = np.random.default_rng(10)
    dev = "cuda"
    for c, n, r in sorted(shapes | set(local_shapes)):
        ops = headroom_operands(rng, *capacity_operands(rng, c, n, r, dev))
        err["capacity_fit"] = max(err["capacity_fit"],
                                  check_capacity_outputs(
                                      kernels, ops, f"10 ({c}, {n}, {r})"))
    log(f"10: capacity kernel == plain at the children's launch shapes "
        f"(C, N, R) {sorted(shapes)}")
    t = time.perf_counter()
    rs = route_card_vs_cpu((types, gang, agg_mod, router_mod, fed), card)
    rs["launches"] = device_batches
    log(f"10c took {time.perf_counter() - t:.1f} s")
    log(f"phase 10 launches {total}; phase 10 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total, err, {"route_scores": rs}


# ---------------------------------------------------------------- phase 11

MESH_D = 4               # 11a, 11d: the shards of one card
SWEEP_D = (1, 2, 4)      # 11b: bench.py measure_scale_sweep's device counts
SCALE_CHUNK = 4096       # bench.py _scale_drain_impl's chunk
CPU_MESH_D = 8           # 11c: the reference's tier-1 mesh size


def mesh_drains(mods, card, flat):
    """11a: Scheduler(mesh=make_mesh(4)).run_until_drained() at 5,000 x
    30,000, density and mixed_affinity, against phase 6's unsharded runs.
    Returns (launches, max abs err per kernel)."""
    hollow, api_mod, Scheduler, kernels, COUNTERS, mesh_mod = mods
    total = {k: 0 for k in kernels.LAUNCHES}
    err = {k: 0 for k in kernels.LAUNCHES}
    n_local = N_NODES // MESH_D
    delta_rows = 0
    for profile in ("density", "mixed_affinity"):
        spy = OperandSpy(kernels)
        api, tot, cnt, span_ms, wall, launches = pipelined(
            mods[:5], profile, N_NODES, N_PODS, spy=spy,
            mesh=mesh_mod.make_mesh(MESH_D))
        got = placements(api)
        want = flat[profile]
        diff = sum(got.get(k) != v for k, v in want.items())
        if diff or len(got) != len(want):
            fail(f"mesh {profile}: {diff} placements differ from the "
                 f"unsharded drain")
        bound, unbound = audit_store(api, profile, N_PODS)
        if unbound:
            fail(f"mesh {profile}: {unbound} pods unbound")
        cap_sh, inc_sh = spy.shapes()
        log(f"mesh drain {profile}: D = {MESH_D} on one card, {N_NODES} "
            f"nodes x {N_PODS} pods, placements == the unsharded drain, "
            f"bound {bound}, wall {wall:.3f} s, {N_PODS / wall:.0f} pods/s "
            f"[{card}]")
        log(f"mesh drain {profile} spans (ms): " + json.dumps(span_ms))
        waves = max(cnt["engine.wave_dispatch"], 1)
        log(f"mesh drain {profile} counters: " + json.dumps(cnt)
            + f"; host_fetch_bytes per wave "
              f"{cnt['engine.host_fetch_bytes'] / waves:.0f}, "
              f"reduce_candidate_rows per dispatch "
              f"{cnt['engine.reduce_candidate_rows'] / waves:.1f}")
        per_shard = {k: spy.shard_calls(k) for k in kernels.LAUNCHES}
        log(f"mesh drain {profile} launches {launches}, shapes "
            f"(capacity (C, N, R)) {cap_sh}, (incidence (M, N, L)) "
            f"{inc_sh}, per shard {json.dumps(per_shard)}")
        if cnt["engine.reduce_candidate_rows"] == 0:
            fail(f"mesh {profile}: no two-stage reduce counted")
        # a drain of two dispatches syncs before its first harvest folds
        # anything (no row delta yet); the three of mixed_affinity do not
        delta_rows += cnt["engine.shard_delta_rows"]
        need = ["capacity_fit"] + (["incidence_matmul"]
                                   if profile == "mixed_affinity" else [])
        for name in need:
            per = spy.shard_calls(name)
            if sorted(per) != list(range(MESH_D)) or launches[name] == 0:
                fail(f"mesh {profile}: {name} did not launch on every "
                     f"shard ({per})")
            shapes = cap_sh if name == "capacity_fit" else inc_sh
            if not any(sh[1] == n_local for sh in shapes):
                fail(f"mesh {profile}: no {name} launch at the per-shard "
                     f"width {n_local}")
        for k, v in spy.check(f"mesh {profile}").items():
            err[k] = max(err[k], v)
        for k, v in launches.items():
            total[k] += v
    if delta_rows == 0:
        fail("mesh drains: no dynamic row rode the per-shard delta path")
    return total, err


def scale_drain(mods, n_devices, spy):
    """11b: bench.py _scale_drain_impl's engine-level drain (dispatch /
    harvest two deep, no apiserver) of density at 5,000 x 30,000 in
    chunks of 4,096 on a mesh of `n_devices` (1: no mesh), with `spy`
    capturing every launch shape. No warm-up drain: there is nothing to
    compile, the kernels were built in phase 1. Returns (result dict,
    launches)."""
    import hashlib

    import torch
    hollow, cache_mod, SchedulingEngine, COUNTERS, kernels, mesh_mod = mods
    cache = cache_mod.SchedulerCache()
    for nd in hollow.hollow_nodes(N_NODES):
        cache.add_node(nd)
    engine = SchedulingEngine(
        cache, mesh=mesh_mod.make_mesh(n_devices) if n_devices > 1
        else None)
    engine.track_dirty = True
    engine.wave_pad_floor = SCALE_CHUNK
    pending = hollow.PROFILES["density"](N_PODS)
    bound, unsched, blocks, prev = {}, 0, [], None
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    COUNTERS.reset()
    t0 = time.perf_counter()
    with spy:
        while pending or prev is not None:
            chunk = pending[:SCALE_CHUNK]
            del pending[:SCALE_CHUNK]
            handle = engine.dispatch_waves(chunk) if chunk else None
            if handle is None and chunk:
                fail("scale drain fell off the wave path")
            if prev is not None:
                h = engine.harvest_waves(prev)
                for p in h.bound:
                    bound[p.name] = p.node_name
                unsched += len(h.unschedulable)
                pending.extend(h.conflicts)
                blocks.append(h.t_block)
            prev = handle
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    snap = COUNTERS.snapshot()
    engine.close()

    def cnt(name):
        return int(snap.get(name, (0, 0.0))[0])
    digest = hashlib.sha256()
    for k in sorted(bound):
        digest.update(f"{k}:{bound[k]}\n".encode())
    waves = max(len(blocks), 1)
    return {"n_devices": n_devices, "bound": len(bound),
            "unschedulable": unsched, "wall_s": round(wall, 3),
            "pods_per_s": round(len(bound) / wall, 1), "waves": len(blocks),
            "wave_block_p50_ms": round(
                1e3 * sorted(blocks)[len(blocks) // 2], 2),
            "host_fetch_bytes_per_wave": round(
                cnt("engine.host_fetch_bytes") / waves),
            "reduce_candidate_rows_per_dispatch": round(
                cnt("engine.reduce_candidate_rows")
                / max(cnt("engine.wave_dispatch"), 1), 1),
            "shard_delta_rows": cnt("engine.shard_delta_rows"),
            "shard_upload_bytes": cnt("engine.shard_upload_bytes"),
            "device_upload_arrays": cnt("engine.device_upload_arrays"),
            "placements_sha256": digest.hexdigest()}, launches


def the_mesh(mods, card, flat):
    """Phase 11: the node-axis mesh and the upload sanitizer on the card.
    Returns (launches of 11a and 11b, max abs err per kernel)."""
    import numpy as np
    import torch
    (hollow, api_mod, Scheduler, kernels, COUNTERS, mesh_mod, cache_mod,
     SchedulingEngine, sanitize) = mods
    t_phase = time.perf_counter()
    pipe = (hollow, api_mod, Scheduler, kernels, COUNTERS, mesh_mod)
    # 11a
    total, err = mesh_drains(pipe, card, flat)
    # 11b
    sweep = []
    for d in SWEEP_D:
        spy = OperandSpy(kernels)
        res, launches = scale_drain((hollow, cache_mod, SchedulingEngine,
                                     COUNTERS, kernels, mesh_mod), d, spy)
        cap_sh, _inc_sh = spy.shapes()
        per = spy.shard_calls("capacity_fit")
        log(f"scale drain D = {d}: " + json.dumps(res) + f" [{card}]")
        log(f"scale drain D = {d} launches {launches}, capacity shapes "
            f"(C, N, R) {cap_sh}, per shard {json.dumps(per)}")
        if res["bound"] != N_PODS:
            fail(f"scale drain D = {d}: bound {res['bound']}")
        if launches["capacity_fit"] == 0:
            fail(f"scale drain D = {d}: no capacity launch")
        if d > 1 and res["shard_delta_rows"] == 0:
            fail(f"scale drain D = {d}: no per-shard row delta")
        # D = 1 is the unsharded engine: its launches run on the engine's
        # own threads, not in shard threads
        if d > 1 and sorted(per) != list(range(d)):
            fail(f"scale drain D = {d}: capacity_fit did not launch on "
                 f"every shard ({per})")
        if not any(sh[1] == N_NODES // d for sh in cap_sh):
            fail(f"scale drain D = {d}: no capacity launch at the "
                 f"per-shard width {N_NODES // d}")
        for k, v in spy.check(f"scale drain D = {d}").items():
            err[k] = max(err[k], v)
        for k, v in launches.items():
            total[k] += v
        sweep.append(res)
    shas = {r["placements_sha256"] for r in sweep}
    if len(shas) != 1:
        fail(f"scale drain: placements differ across D {SWEEP_D}")
    log(f"scale drain: the same placements sha256 at D = {SWEEP_D} "
        f"({shas.pop()[:16]}...); wall "
        + ", ".join(f"D = {r['n_devices']} {r['wall_s']} s" for r in sweep)
        + f" [{card}]; D shards share ONE card: this measures the sharded "
          "path, not multi-card scaling")
    # 11c: card == CPU at 512 x 3,000, D = 8
    want_pl, want_tot = flat["check"]
    for tag, dev, mesh in (
            ("card", None, mesh_mod.make_mesh(CPU_MESH_D)),
            ("CPU", "cpu", mesh_mod.make_mesh(CPU_MESH_D, device="cpu"))):
        api, tot, cnt, _sp, wall, _l = pipelined(
            pipe[:5], "mixed_affinity", 512, 3000, device=dev, mesh=mesh,
            max_batch=512)
        got = placements(api)
        diff = sum(got[k] != v for k, v in want_pl.items())
        if diff or tot != want_tot:
            fail(f"mesh D = {CPU_MESH_D} 512 x 3000 on the {tag}: {diff} "
                 f"placements differ from the unsharded CPU run")
        log(f"mesh D = {CPU_MESH_D} mixed_affinity 512 x 3000 on the {tag}: "
            f"== the unsharded CPU run, wall {wall:.3f} s")
    # 11d: GRAFT_SANITIZE=1
    old = os.environ.get("GRAFT_SANITIZE")
    os.environ["GRAFT_SANITIZE"] = "1"
    # count the checks as the seams make them: alias checks (copies) and
    # seals (frozen sources)
    seen = {"alias": 0, "freeze": 0}
    real_alias, real_freeze = sanitize._assert_no_alias, sanitize.freeze

    def alias(dev, host):
        seen["alias"] += 1
        return real_alias(dev, host)

    def freeze(host):
        seen["freeze"] += 1
        return real_freeze(host)
    sanitize._assert_no_alias, sanitize.freeze = alias, freeze
    try:
        for tag, mesh in (("one card", None),
                          (f"mesh of {MESH_D}", mesh_mod.make_mesh(MESH_D))):
            seen.update(alias=0, freeze=0)
            api, tot, cnt, _sp, wall, _l = pipelined(
                pipe[:5], "mixed_affinity", 512, 3000, mesh=mesh,
                max_batch=512)
            got = placements(api)
            diff = sum(got[k] != v for k, v in want_pl.items())
            if diff or tot != want_tot:
                fail(f"sanitized drain ({tag}): {diff} placements differ "
                     f"from the unsanitized run")
            if seen["alias"] == 0 or seen["freeze"] == 0:
                fail(f"sanitized drain ({tag}): the seams did not check "
                     f"({seen})")
            log(f"GRAFT_SANITIZE=1 mixed_affinity 512 x 3000 ({tag}): == "
                f"the unsanitized run, {seen['alias']} alias checks and "
                f"{seen['freeze']} seals at the seams over "
                f"{cnt['engine.wave_dispatch']} harvests, wall {wall:.3f} s")
        buf = np.arange(512, dtype=np.int32).reshape(64, 8)
        real = sanitize._copy_ctor
        sanitize._copy_ctor = lambda host, device: torch.from_numpy(host)
        try:
            sanitize.upload_copied(buf, "cpu")
            fail("an aliasing upload constructor went uncaught")
        except sanitize.AliasingViolation as e:
            log(f"deliberate aliasing regression caught: {e}")
        finally:
            sanitize._copy_ctor = real
    finally:
        sanitize._assert_no_alias, sanitize.freeze = real_alias, real_freeze
        if old is None:
            os.environ.pop("GRAFT_SANITIZE", None)
        else:
            os.environ["GRAFT_SANITIZE"] = old
    log(f"phase 11 launches {total}; phase 11 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total, err


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from kubernetes_tpu_torch.analysis import sanitize
        from kubernetes_tpu_torch.api import policy as policy_mod
        from kubernetes_tpu_torch.api import scheme, serde, types, workloads
        from kubernetes_tpu_torch.engine import fastlane as fl_mod
        from kubernetes_tpu_torch.engine import (gang, preempt_wave,
                                                 preemption)
        from kubernetes_tpu_torch.engine.scheduler import Scheduler
        from kubernetes_tpu_torch.engine.scheduler_engine import (
            SchedulingEngine, evaluate_pod)
        from kubernetes_tpu_torch.federation import aggregate as agg_mod
        from kubernetes_tpu_torch.federation import cell as cell_mod
        from kubernetes_tpu_torch.federation import router as router_mod
        from kubernetes_tpu_torch.models import hollow
        from kubernetes_tpu_torch.ops import affinity, kernels
        from kubernetes_tpu_torch.ops import fastlane as fast_ops
        from kubernetes_tpu_torch.ops import federation as fed_ops
        from kubernetes_tpu_torch.ops import preempt as preempt_ops
        from kubernetes_tpu_torch.ops.priorities import DEFAULT_PRIORITIES
        from kubernetes_tpu_torch.parallel import mesh as mesh_mod
        from kubernetes_tpu_torch.parallel import multiproc
        from kubernetes_tpu_torch.server import (apiserver_lite, daemon,
                                                 extender)
        from kubernetes_tpu_torch.state import cache as cache_mod
        from kubernetes_tpu_torch.state.classes import ClassBatch
        from kubernetes_tpu_torch.testing import churn
        from kubernetes_tpu_torch.utils import features
        from kubernetes_tpu_torch.utils.trace import COUNTERS
    except ImportError as e:
        print(f"chip_smoke: the kubernetes_tpu_torch package is missing "
              f"({e})", file=sys.stderr)
        return 3
    # int_matmul needs full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off (torch.backends.cuda.matmul.allow_tf32 = False)")

    # 1. build + card facts
    t0 = time.perf_counter()
    reports = kernels.build()
    for name, rep in reports.items():
        log(f"built {name}:")
        for line in rep.splitlines():
            if "ptxas info" in line or "spill" in line:
                log("  " + line.strip())
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    card = card_facts()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")

    # 2. kernels vs plain versions (operands of the extender cluster first)
    cache5, snap5, wl5, probes = extender_cluster(hollow, types)
    ops = incidence_operands(cache5, snap5, wl5, probes[0], affinity,
                             ClassBatch)
    timing, max_err = check_kernels(kernels, ops)

    # 3. card vs CPU
    card_vs_cpu(hollow, SchedulingEngine)

    # 4. the drains
    launches_drain = {k: 0 for k in kernels.LAUNCHES}
    walls = {}
    for profile in ("density", "binpack"):
        got, walls[profile] = drain(hollow, kernels, SchedulingEngine,
                                    profile, card)
        for k, v in got.items():
            launches_drain[k] += v
    if launches_drain["capacity_fit"] == 0:
        fail("the drains never launched the capacity kernel")

    # 5. the extender verdict
    launches_eval = verdicts(cache5, snap5, wl5, probes, kernels,
                             evaluate_pod, DEFAULT_PRIORITIES, card)
    if launches_eval["incidence_matmul"] == 0:
        fail("evaluate_pod never launched the incidence kernel")

    # 6. the pipelined drains
    launches_pipe, err_pipe, flat_pipe = pipelined_drains(
        (hollow, apiserver_lite, Scheduler, kernels, COUNTERS), card)
    for k, v in err_pipe.items():
        max_err[k] = max(max_err[k], v)

    # 7. the scheduler-extender service
    launches_ext, err_ext = extender_service(
        (hollow, types, kernels, serde, extender, apiserver_lite, churn,
         COUNTERS), card, timing)
    for k, v in err_ext.items():
        max_err[k] = max(max_err[k], v)

    # 8. the daemon and the Policy
    launches_p8, err_p8 = daemon_and_policy(
        (hollow, types, workloads, apiserver_lite, daemon, Scheduler,
         policy_mod, kernels, COUNTERS), card)
    for k, v in err_p8.items():
        max_err[k] = max(max_err[k], v)

    # 9. gangs, PodPriority preemption and the fast lane
    launches_p9, err_p9, dev_fns = the_slice(
        (hollow, types, apiserver_lite, Scheduler, daemon, scheme, kernels,
         COUNTERS, churn, preempt_wave, preemption, features, gang, fl_mod,
         fast_ops, preempt_ops, cache_mod, SchedulingEngine), card)
    for k, v in err_p9.items():
        max_err[k] = max(max_err[k], v)

    # 10. the process fleet and the federation
    launches_p10, err_p10, dev_fns_p10 = federation_and_fleet(
        (hollow, types, gang, churn, kernels, fed_ops, agg_mod, router_mod,
         cell_mod, multiproc), card)
    for k, v in err_p10.items():
        max_err[k] = max(max_err[k], v)
    dev_fns.update(dev_fns_p10)

    # 11. the node-axis mesh and the upload sanitizer
    launches_p11, err_p11 = the_mesh(
        (hollow, apiserver_lite, Scheduler, kernels, COUNTERS, mesh_mod,
         cache_mod, SchedulingEngine, sanitize), card, flat_pipe)
    for k, v in err_p11.items():
        max_err[k] = max(max_err[k], v)

    # 12. summary
    replaces = {"capacity_fit": "kubernetes_tpu/ops/pallas_kernels.py:90",
                "incidence_matmul": "kubernetes_tpu/ops/pallas_kernels.py:144"}
    rows = []
    for name in ("capacity_fit", "incidence_matmul"):
        t = timing[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"kubernetes_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": (launches_drain[name] + launches_eval[name]
                         + launches_pipe[name] + launches_ext[name]
                         + launches_p8[name] + launches_p9[name]
                         + launches_p10[name] + launches_p11[name]),
            "max_abs_err": max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"], "cold_ms": t.get("cold_ms"),
            **{k: v for k, v in t.items() if k.startswith("wave_")
               and "profiler" not in k},
            **{f"extender_batch_{k}": v
               for k, v in t.get("extender_batch", {}).items()
               if k in ("ms", "device_ms", "cold_ms", "plain_ms",
                        "library_ms", "bound_ms", "shape")}})
    log(f"launches: drains {launches_drain}, verdicts {launches_eval}, "
        f"pipelined drains {launches_pipe}, extender {launches_ext}, "
        f"daemon and Policy {launches_p8}, gangs, preemption and the fast "
        f"lane {launches_p9}, process fleet and federation {launches_p10}, "
        f"mesh {launches_p11}")
    log("device functions (PyTorch ops, not kernels): "
        + json.dumps(dev_fns))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
