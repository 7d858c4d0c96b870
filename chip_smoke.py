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
     capacity kernel ran once per wave (plus once per straggler of the
     strict-loop finish, which steps the live rows only), and both its outputs equal their plain versions on each
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
     scheduleOne frontends binding 400 density pods (cut from 1,000)
     with SnapshotGen and IdempotencyKey, 409s retried, any other error
     failing; the store is
     audited. Each kernel's operands at every launch shape of the phase
     are held against its plain version, and the batch's stacked
     incidence product is timed;
  8. the scheduler daemon with a Policy (the v1.7 knob set of Kubernetes'
     compatibility_test.go, no extender) from a --policy-config-file, on
     5,000 hollow nodes labeled region / zone / foo (90%) / bar (half)
     and pending pods: mixed_affinity plus 1% host-static pods
     (five ORed node-selector terms) and 1/300 host-exact pods (nine host
     ports; two Services coupled by ServiceAffinity on region).
     8a (depth cut to 5,000 pods): two SchedulerDaemons on one fake
     clock; A leads, runs one classic round over half the queue and
     crashes holding its lease; B waits it out, relists and finishes with
     step(). 8b (depth cut to 15,000 pods): the pipelined drain of the
     same kind of store, Scheduler(policy=...)
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
     5,000 full nodes and 250 pending prod/system pods (cut from 1,000),
     stepped until nothing placeable is left (classic preemption
     audited). 9d: bench.py
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
     drains, phase 6's store audit, both kernels launched on every shard,
     EVERY launch (the strict tails' included: the scan, the conflict
     rounds and their occupancy seeds run per shard) at the per-shard
     width 1,250, and each held against its plain version at every
     launch shape; mixed_affinity ran a strict tail
     (engine.wave_tail_dispatch, tail_round_dispatch); the two-stage
     reduce and the per-shard row delta counted
     (engine.reduce_candidate_rows, shard_delta_rows), host_fetch_bytes
     per wave printed, and each wall beside phase 6's and the D = 4
     walls of the gathered tails (GATHERED_TAILS_WALL). 11b: bench.py
     _scale_drain_impl's engine-level drain (density, 5,000 x 30,000, chunks of 4,096) at
     D = 1, 2 and 4: the same placement sha256 at every D, capacity
     launched on every shard at width 5,000 / D and held against its
     plain version at every launch shape, walls printed.
     11c: mixed_affinity at 512 x 3,000 with D = 8, on the card and on the
     CPU, equal to phase 6's unsharded CPU run; then a classic round,
     SchedulingEngine.schedule(mode="wave") of a mixed_affinity batch
     with strict rows (engine.classic_strict_rows > 0) at 512 x 709 (128
     strict rows, cut from 3,000 pods and 510 rows) on D = 8, on the card
     and on the CPU, each equal to the unsharded CPU round, every card
     launch at the per-shard width 64. 11d: GRAFT_SANITIZE=1: the
     512 x 3,000 mixed_affinity drain on the card and on a D = 4 mesh,
     equal to the unsanitized run, with the seams' alias checks and seals
     counted; an aliasing upload constructor on a CPU tensor raises;
 12. the full apiserver in front of the card's scheduler. 12a: the
     in-process ApiServer() with the default admission chain; the bench
     Namespace, a LimitRange with default container requests, two
     PriorityClasses (PodPriority on) and a ResourceQuota of exactly the
     pods meant to be admitted; 5,000 hollow nodes created through
     api.create, Scheduler(api) started on the card, then mixed_affinity
     pods created through the chain (5,000 admitted, cut from 30,000
     for the chain's O(objects) lists per create; 20% with their
     requests stripped, 10% bench-high) plus 64 past the quota, and
     run_until_drained(); phase 6's store audit, exactly the 64 refused
     by ResourceQuota and the quota's used pods equal to the admitted
     count, every stripped pod defaulted and every pod given its class's
     priority, no bind error, the batched binding audit entries (code
     200) covering every bound pod, both kernels launched and held
     against their plain versions at every launch shape. 12b: a secure
     ApiServer on the same store (token authn, the bootstrap RBAC, a
     RoleBinding giving one user edit in the rest Namespace, a mutating
     webhook on localhost) behind RestServer: the bound user creates 256
     pods over HTTP with RestClient, an unbound user's create is 403 and
     audited 403, 12a's scheduler binds the 256, each stamped by the
     webhook; field-selector lists over HTTP equal the store's filter on
     8 nodes; /openapi/v2 and /version answer. 12c: tests/
     test_replication.py's failover storm at 5,000 nodes x 10,000 pods
     behind ApiServer over a durable store in a temporary directory: WAL
     shipped, classic rounds of 4,000 and 2,000 on the card with a ship
     between, the standby promoted, a fresh Scheduler(ApiServer(store=
     promoted)) drains; every pod shipped and bound, the restored bound
     count between the shipped prefix and the primary's, no bind error,
     no pod bound to two nodes. 12d: 12a's path at 512 x 3,000 on the
     card and on the CPU: equal placements, totals, refusals, create and
     refusal audit entries (in order) and pods over the binding entries;
 13. the controller manager, the cloud provider and volumes in front of
     the card's scheduler, and the flight recorder's trace. 13a:
     ApiServerLite with 5,000 hollow nodes (zone and region labels),
     the ControllerManager over it on a FakeCloud, the card's Scheduler
     watching the same store; 1,000 GCE PDs created in the cloud across
     the zones, their PersistentVolumes created through ApiServer (the
     default chain plus PersistentVolumeLabel, which stamps each PV with
     its disk's zone), 1,000 claims bound by the PV binder; then 100
     Deployments x 100 replicas (templates: mixed_affinity's first
     hundred pods, so hostname anti-affinity, zone packing and their
     targets are among them), one DaemonSet (one pod per node, bound by
     the controller), one Job of 200 and 1,000 bare pods each mounting a
     claim; pump_until_stable(), run_until_drained() (pipelined), pump
     (the attach/detach controller attaches every disk in the cloud);
     half the Deployments scaled up by half, pump, drain, pump. Phase
     6's store audit with the DaemonSet's pods counted, every pod bound,
     one ReplicaSet per Deployment of its size, one DaemonSet pod per
     node, each claim bound and its pod in its PV's zone, no node past
     16 PDs, each disk attached to exactly its pod's node; both kernels
     launched and held against their plain versions at every launch
     shape. 13b: `python -m kubernetes_tpu_torch.observability --trace`'s
     main() at 5,000 x 30,000 mixed_affinity on the card: one dispatch,
     device-eval and bind-flush span per wave engine.wave_dispatch
     counted, every span longer than 0, the device-window share; then a
     second recorded drain of the same build under torch.profiler: the
     card's busy share (kernels and copies over the drain's wall) and
     its idle share. 13c: 13a at 512 nodes x 10 Deployments + 64 PD pods
     on the card and on the CPU: equal placements, ReplicaSets, PV
     bindings and attachments;
 14. the node agents behind the card's scheduler, in one world: an
     ApiServerLite with a HollowFleet of 5,000 hollow kubelets (each
     registers its own Node), one SharedInformerFactory behind the
     fleet, the NodeLifecycleController, the ReplicaSet, StatefulSet and
     Endpoint controllers and a HollowProxy, the card's Scheduler, and
     one FakeClock for the kubelets, the lifecycle controller and the
     scheduler (latencies are host clock). 14a kubemark density: 15,000
     mixed_affinity pods created bare, run_until_drained(), the fleet
     steps them to Running; burst create -> Running p50/p90/p99 (all
     pods created before one drain, to the first write setting Running;
     not density.go's protocol of latency pods after saturation, so not
     held against its SLO), pods/s, heartbeat_all's wall and what the
     next device sync uploads; phase 6's store audit (a bind is a write
     putting a pod on a node it was not on, per pod life), every pod
     Running on its node, one kubelet's
     /healthz and /pods probed with utils/probe. 14b: 4 StatefulSets of
     16, rounds of controller pump, drain, fleet step; each ordinal
     created only after the one before it ran (from the store's log).
     14c: a ReplicaSet of 1,000 Running, then 150 kubelets (50 a zone,
     one of each zone's holding a StatefulSet ordinal) stopped; 10 s
     ticks of the FakeClock, heartbeats every 3 ticks, the lifecycle
     controller's pass every tick (grace 40 s, eviction timeout cut to
     60 s, 0.1 nodes/s a zone), the controllers and the scheduler every
     5 ticks, until nothing stands on a dead node, the ReplicaSet is
     back at 1,000 Running and every ordinal runs; each evicted
     ReplicaSet pod replaced once on a live node, each evicted ordinal
     recreated under its name on one; the host time of these passes is
     logged (the FakeClock's pacing is not in it). 14d: 50 kubelets'
     pods past the eviction threshold, a heartbeat, 200 BestEffort
     pods: exactly those kubelets report MemoryPressure, no BestEffort
     pod lands on them, and each evicts its BestEffort pod before the
     hog. No pod is refused by kubelet admission (OutOfcpu,
     OutOfmemory, OutOfPods), no pod is bound twice in one life, no
     bind errs. Each kernel's operands at every launch shape of 14a-14d
     are held against its plain version; both kernels must launch.
     14e: 14a-14d at 512 kubelets on the card and on the CPU: equal
     pods (wire JSON: node, phase, everything), StatefulSet creation
     orders, evicted pods and replacement placements;
 15. the command line and the hyperkube entry point in front of the
     card's scheduler. 15a: `python -m kubernetes_tpu_torch version`,
     `apiserver --once --nodes 16` and `scheduler --nodes 5000 --pods
     5000` with no --device (the card is the daemon's default; without
     one it raises) as three child processes of this interpreter started
     together, the repository on PYTHONPATH, the kernels phase 1 built
     found in .torch_kernels/: each exits 0 and the scheduler prints
     bound=5000/5000; each child's wall is logged. 15b: the cluster in a
     box of tests/test_e2e_cluster.py at 5,000 nodes: KtAdm.init into a
     temporary directory, 8 workers joining over the bootstrap-token flow
     (CSR, approval, signed identity; the admin labels each with its
     hostname and zone), the admin registering 4,992 hollow nodes through
     the apiserver, a HollowFleet of 5,000 kubelets, the Deployment and
     ReplicaSet controllers and the card's Scheduler over the one store;
     then the user acts only through Ktctl(cluster.api, cred=admin,
     kubelets=...): `run web --replicas=3000`, rounds of controller
     pump, drain and fleet step until all run; `patch deployment web -p`
     (strategic merge: requests, tier=web-v2, a hollow log and exec
     handler, a required pod anti-affinity on the hostname and a
     preferred one on the zone over tier=web-v2, a 25% surge and
     unavailability budget) and `rollout status` each round until the
     new ReplicaSet holds 3,000 Running pods and the old ones none;
     `scale --replicas=4500`; `drain` the node of the first web pod by
     name; `logs --tail 1` and `exec -- hostname` on one pod through the
     kubelet routing table; then one `get pods -o json` through
     kubernetes_tpu_torch.__main__.main(["ktctl", "--server", URL, ...])
     against a RestServer on the same store. Gates: phase 6's store audit
     (one bind per pod life), no two tier=web-v2 pods on one node, the
     drained node cordoned with no pod placed on it after the drain and
     its pod replaced once on another node, 4,500 Running, no pod refused
     by kubelet admission, no bind error, the canned log and exec
     output, the Running count over HTTP equal to the in-process one,
     both kernels launched and held against their plain versions at
     every launch shape. The wall of each ktctl step, its rounds, its
     drains and their pipeline spans are logged. 15c: 15b at 512 nodes
     with 300 replicas scaled to 450 (no HTTP leg) on the card and on the
     CPU: equal placements pod by pod, rollout rounds and status lines,
     and equal `get pods -o wide` text;
 16. the always-on arrival stream, bench.py run_arrival's contract on the
     port (`arrival`, its own harness: pods created at an offered rate by
     a creator thread in bursts of about 4 ms of the rate while
     Scheduler.stream()'s ScheduleLoop runs on the card; 64 prime pods
     bound first and excluded from every number; the gc frozen and off
     for the window; create->bound joined from the creator's stamps and
     Scheduler.wave_observer's bind instants; sustained pods/s the median
     per-interval bind rate over the full buckets inside the offer
     window, the first dropped as ramp; no shape ladder, as eager torch
     compiles nothing). 16a: bench.py's headline, 20,000 density pods/s
     into 5,000 nodes for 3 s, budget 250 ms, quanta 256-16,384; offered
     and sustained pods/s, create->bound p50 and p99, the backlog at
     offer end, the quantum's peak, the creator's lag p99 and jitter_ok;
     then a 1 s window at the same rate with the flight recorder and
     podtrace armed: every tail exemplar's phases telescope to its span.
     16b: bench.py measure_churn, 5,000 churn-profile pods/s into 5,000
     nodes for 4 s (cut from bench's 8 s), a quiet leg and a leg under
     ChurnInjector's seeded schedule (seed 11, 10% of the nodes killed a
     minute, flaps, cordons, relabels, evictions) behind FaultyBindApi
     (0.2% bind failures, 0.1% landed timeouts); the churn_* fields
     (churned over quiet sustained, the churned p99, ops applied,
     liveness and fence requeues, degraded steps, enters and exits, the
     Protean patch rows, encoding rebuilds and label patch rows). 16c:
     bench.py measure_rolling_update's defaults, 400 replicas replaced by
     RollingUpdateDriver under surge 40 and unavailability 40 on a
     diurnal background of 1,500 pods/s (amplitude 0.5, period 3 s) at
     514 nodes; completion time, replacement create->bound p50 and p99,
     the surge and unavailability extremes. Gates of every leg: no
     duplicate bind (observer and store), audit_store_transitions and
     audit_cache_vs_store clean, every pod in the store bound once the
     loop settles, no node over its CPU, memory or pods, the churn
     profile's anti-affinity held; 16c's bounds respected and each
     replacement bound once; the churn leg's encoding rebuilds within
     the quiet leg's plus each fault at what 16d's CPU run paid for one
     of its kind. 16d: tests/test_churn.py's frozen churn trace scaled to
     512 nodes (P16D_TRACE: groups of about 500 churn-profile pods, one
     fault a step: kill, respawn, cordon, uncordon, NotReady flap,
     relabel, the eviction of an anti-affinity pod and of a plain target,
     a landed bind timeout; two nodes, one holding an anti-affinity pod
     and one a target, return after an encoding was built while they
     were dead) on a FakeClock, through the stream and the fixed-chunk
     pipeline on the card and through the stream on the CPU: equal
     placements, and at every device sync the resident arrays equal a
     fresh upload of the snapshot and the affinity tensors their fresh
     views. Each capacity operand set of 16a-16c at every launch
     shape is held against the plain version; the incidence kernel is
     not on this path (the churn profile's anti-affinity is on the
     hostname, answered per node);
 17. the reference's oracle tables on the card: every body of
     tests/test_torch_kernel_tables.py (the reference's
     test_predicates_kernel, test_priorities_kernel, test_priorities_ext
     and test_volumes, at their own seeds and sizes: tiny, ragged node
     counts with zero requests, GPUs, host ports, taints, volumes and
     inter-pod terms) runs through the port on the card with the port's
     table helpers (tests/torch_tables.py). Each (pod, node) verdict and
     score must equal the object oracle (the bodies' own asserts) and the
     port's CPU route, cell by cell; the inter-pod tables also go through
     the fused verdict (evaluate_pod), so the incidence kernel runs at
     their shapes. Every launch of both kernels is held against its plain
     version, and the phase fails if either kernel never launched;
 18. print the per-kernel summary line, then the result line.

Phase 1 also logs whether kubernetes_tpu_torch.native loaded
native/libhostops.so or fell back to numpy (the snapshot's label
scatter), and whether PyYAML is importable (ktctl needs it only for -o
yaml, create -f, apply -f and edit; phase 15 uses none of them). Launch
counts are zeroed just before each main-path run (phases 4, 5, 6, 7,
8a-8c, 9a-9d, 10a-10b, 11a, 11b, 12a-12c, 13a, 13b, 14a-14d as one run,
15b from `ktctl run` to the last ktctl step, each stream of 16a-16c
from its scheduler's start, and 17's table bodies as one run; in 10a and
10b each child process counts its
own, and 15a's scheduler child is not counted)
and read just after it; launches made by the comparisons do not count.
"""

from __future__ import annotations

import contextlib
import gc
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
# phase 8's depth, cut for the whole run's time: 8a from 30,000 pods to
# 10,000 (phase 9) and to 5,000 (phase 13), 8b from 30,000 to 15,000
# (phase 13)
P8A_PODS = 5000
P8B_PODS = 15000
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
    # one capacity launch per wave, plus one per straggler of the
    # strict-loop finish (the scan steps the live rows only)
    from kubernetes_tpu_torch.ops import predicates as preds
    stats = eng.last_wave_stats
    want = stats["waves"] + stats["stragglers"]
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

    def __init__(self, kernels, every=False):
        self.kernels = kernels
        # every=True keeps the operands of every launch, not only the
        # first at each shape
        self.every = every
        self.cap = {}
        self.inc = {}
        # (kernel, thread name) -> calls on the card: a mesh's SPMD
        # shards run in threads named spmd-shard-<d>
        self.by_thread = {}
        # capture key -> calls on the card
        self.by_shape = {}
        self._real = (kernels.capacity_fit, kernels.capacity_headroom,
                      kernels.incidence_matmul)

    def _note(self, name, t, shape_key):
        if t.is_cuda:
            import threading
            key = (name, threading.current_thread().name)
            self.by_thread[key] = self.by_thread.get(key, 0) + 1
            self.by_shape[shape_key] = self.by_shape.get(shape_key, 0) + 1

    def __enter__(self):
        k = self.kernels
        fit, head, inc = self._real

        def capacity_fit(pod_req, alloc, requested, zero_req=None):
            key = ("mask", tuple(pod_req.shape), tuple(alloc.shape),
                   zero_req is not None)
            self._note("capacity_fit", pod_req, key)
            if self.every:
                key += (len(self.cap),)
            if pod_req.is_cuda and key not in self.cap:
                self.cap[key] = tuple(
                    None if t is None else t.clone()
                    for t in (pod_req, zero_req, alloc, requested))
            return fit(pod_req, alloc, requested, zero_req)

        def capacity_headroom(*ops):
            key = ("wave", tuple(ops[0].shape), tuple(ops[2].shape), True)
            self._note("capacity_fit", ops[0], key)
            if self.every:
                key += (len(self.cap),)
            if ops[0].is_cuda and key not in self.cap:
                self.cap[key] = tuple(t.clone() for t in ops)
            return head(*ops)

        def incidence_matmul(a, b_t):
            key = (tuple(a.shape), tuple(b_t.shape))
            self._note("incidence_matmul", a, key)
            if self.every:
                key += (len(self.inc),)
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

    def launches_by_shape(self):
        """Calls on the card per launch: capacity ("mask" or "wave", C, N,
        R), incidence ("incidence", M, N, L)."""
        out = {}
        for key, n in self.by_shape.items():
            if key[0] in ("mask", "wave"):
                k = (key[0], key[1][0], key[2][0], key[1][1])
            else:
                k = ("incidence", key[0][0], key[1][0], key[0][1])
            out[k] = out.get(k, 0) + n
        return sorted(out.items())

    def shapes(self):
        """The distinct launch shapes seen: capacity (C, N, R), incidence
        (M, N, L) with L as the caller gave it (the wrapper pads L to a
        multiple of 8)."""
        cap = sorted({(k[1][0], k[2][0], k[1][1]) for k in self.cap})
        inc = sorted({(a[0], b[0], a[1]) for a, b, *_ in self.inc})
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
        if self.every:
            log(f"{tag}: kernel == plain at every launch of the run "
                f"({len(self.cap)} capacity, {len(self.inc)} incidence)")
        else:
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


def store_binds(api):
    """The binds in the store's event log, per pod life: {(pod key, life):
    [node, ...]}, one entry for each write that puts the pod on a node it
    was not on. A key's life n ends at its n-th DELETED event, so a
    StatefulSet ordinal recreated under its name after an eviction is life
    1 of that key. Status writes on a bound pod (the kubelet's) are not
    binds."""
    life, last, binds = {}, {}, {}
    for e in api._log:
        if e.kind != "Pod":
            continue
        key = e.obj.key()
        if e.type == "DELETED":
            life[key] = life.get(key, 0) + 1
            last.pop(key, None)
            continue
        node = e.obj.node_name
        if node and node != last.get(key):
            binds.setdefault((key, life.get(key, 0)), []).append(node)
        last[key] = node
    return binds


def audit_store(api, profile, n_pods, exempt=frozenset()):
    """Audit a drain from the store: every pod bound or provably
    unschedulable (fits no node of the final state; pods in `exempt`, the
    members of gangs left wholly pending, are not checked alone), no node
    over its CPU, memory or pod count, no pod bound twice in one life
    (`store_binds`); for mixed_affinity and gang_mix the required
    (anti-)affinity of the mixed_affinity pods. Returns (bound, unbound)."""
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
    dups = sum(1 for v in store_binds(api).values() if len(v) > 1)
    if dups:
        fail(f"{profile}: {dups} pods bound more than once in one life")
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
            flat[("wall", profile)] = wall
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

# the fleet's depth: cut from 1,000 pods to 400 so that the whole run,
# phase 12 included, stays under 10 minutes on a slow host (the fleet runs
# at about 12 scheduleOnes/s, host-bound)
EXT_FLEET_PODS = 400
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
            smods, policy_world(wmods, N_NODES, P8B_PODS, True), policy,
            device=device, spy=spy)
        audit_policy(api, "8b pipelined", P8B_PODS)
        del api
        cnt = rep["counters"]
        if cnt["stream.chunk_flush"] != 0:
            fail(f"8b: {cnt['stream.chunk_flush']} pipeline flushes")
        n_exact = P8B_PODS // 300
        if cnt["engine.wave_host_rows"] < n_exact \
                or cnt["engine.wave_host_tail"] < n_exact:
            fail(f"8b: host rows {cnt['engine.wave_host_rows']}, tail "
                 f"{cnt['engine.wave_host_tail']} (want >= {n_exact})")
        log(f"8b pipelined {N_NODES} x {P8B_PODS} with the Policy: wall "
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
PRIO_DAEMON_PODS = 250          # cut from 1,000 for the run's time (phases 12, 13)
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
    if any(len(v) > 1 for v in store_binds(api).values()):
        fail(f"{tag}: a pod bound twice in one life")
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
# 11a's D = 4 walls when the strict tails still ran on the node axis
# assembled on the first device (a run of this script on NVIDIA H100 80GB
# HBM3, 700.00 W)
GATHERED_TAILS_WALL = {"density": 1.885, "mixed_affinity": 3.861}
SWEEP_D = (1, 2, 4)      # 11b: bench.py measure_scale_sweep's device counts
SCALE_CHUNK = 4096       # bench.py _scale_drain_impl's chunk
CPU_MESH_D = 8           # 11c: the reference's tier-1 mesh size
# 11c's classic round: 709 mixed_affinity pods at 512 nodes give 128 strict
# rows, cut from 3,000 pods and 510 strict rows for the run's time (the
# round at D = 8 took 30.2-33.4 s on the card and 18.8-24.4 s on the CPU,
# NVIDIA H100 80GB HBM3, 700.00 W)
P11C_ROUND = (512, 709)


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
        # every launch of the drain, the strict tails included, runs on
        # one shard's nodes: no step assembles the node axis
        wide = [sh for sh in cap_sh + inc_sh if sh[1] != n_local]
        if wide:
            fail(f"mesh {profile}: launches at node widths other than the "
                 f"per-shard {n_local}: {wide}")
        tails = (cnt["engine.wave_tail_dispatch"],
                 cnt["engine.tail_round_dispatch"])
        log(f"mesh drain {profile}: every launch at the per-shard width "
            f"{n_local}; strict tails {tails[0]} (as conflict rounds "
            f"{tails[1]}, {cnt['engine.tail_rounds']} rounds; "
            f"{cnt['engine.affinity_strict_tail']} tail rows); wall "
            f"{wall:.3f} s beside the unsharded drain's "
            f"{flat[('wall', profile)]:.3f} s (phase 6) and the gathered "
            f"tails' D = 4 wall {GATHERED_TAILS_WALL[profile]} s [{card}]")
        if profile == "mixed_affinity" and not all(tails):
            fail(f"mesh {profile}: no strict tail ran ({tails})")
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


def classic_round(mods, n_nodes, n_pods, device=None, mesh=None,
                  spy=None):
    """One classic round, SchedulingEngine.schedule(mode="wave") of a
    mixed_affinity batch on a fresh cache (on `mesh` when given): the
    round the daemon runs, whose strict rows (the pack-into-one-zone
    classes) take the seeded scan. Returns (placements, RR counter,
    strict rows, wall, launches)."""
    import torch
    (hollow, _api, _S, kernels, COUNTERS, _m, cache_mod,
     SchedulingEngine, _san) = mods
    cache = cache_mod.SchedulerCache()
    for nd in hollow.hollow_nodes(n_nodes):
        cache.add_node(nd)
    eng = SchedulingEngine(cache, device=device, mesh=mesh)
    pods = hollow.mixed_affinity_pods(n_pods, seed=14)
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    COUNTERS.reset()
    t0 = time.perf_counter()
    with spy if spy is not None else contextlib.nullcontext():
        res = eng.schedule(pods, mode="wave")
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    strict = int(COUNTERS.snapshot().get("engine.classic_strict_rows",
                                         (0, 0.0))[0])
    return ({r.pod.name: r.node_name for r in res}, eng.rr.counter, strict,
            wall, dict(kernels.LAUNCHES))


def mesh_round_check(mods, card):
    """11c's classic round: SchedulingEngine.schedule with strict rows on
    a D = 8 mesh at P11C_ROUND (512 x 709, 128 strict rows), on the card
    and on the CPU, each equal to the unsharded CPU round; on the card
    every launch at the per-shard width 64."""
    kernels, mesh_mod = mods[3], mods[5]
    n_nodes, n_pods = P11C_ROUND
    want = classic_round(mods, n_nodes, n_pods, device="cpu")
    n_local = n_nodes // CPU_MESH_D
    for tag, dev, mesh in (
            ("card", None, mesh_mod.make_mesh(CPU_MESH_D)),
            ("CPU", "cpu", mesh_mod.make_mesh(CPU_MESH_D, device="cpu"))):
        spy = OperandSpy(kernels) if dev is None else None
        got = classic_round(mods, n_nodes, n_pods, device=dev, mesh=mesh,
                            spy=spy)
        diff = sum(got[0][k] != v for k, v in want[0].items())
        if diff or got[1:3] != want[1:3]:
            fail(f"classic round D = {CPU_MESH_D} on the {tag}: {diff} "
                 f"placements differ from the unsharded CPU round (RR, "
                 f"strict rows {got[1:3]} vs {want[1:3]})")
        if got[2] == 0:
            fail("classic round: no strict row ran")
        line = (f"classic round D = {CPU_MESH_D} mixed_affinity {n_nodes} x "
                f"{n_pods} on the {tag}: == the unsharded CPU round, "
                f"{got[2]} strict rows, RR counter {got[1]}, wall "
                f"{got[3]:.3f} s (unsharded CPU {want[3]:.3f} s)")
        if spy is not None:
            cap_sh, inc_sh = spy.shapes()
            wide = [sh for sh in cap_sh + inc_sh if sh[1] != n_local]
            if wide or not cap_sh or not inc_sh:
                fail(f"classic round D = {CPU_MESH_D} on the card: launch "
                     f"shapes {cap_sh} / {inc_sh}, want every node width "
                     f"{n_local}")
            spy.check(f"classic round D = {CPU_MESH_D}")
            line += (f", launches {got[4]}, every one at the per-shard "
                     f"width {n_local} [{card}]")
        log(line)


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
    # 11c: the classic round's strict rows per shard, card == CPU, D = 8
    mesh_round_check(mods, card)
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


# ---------------------------------------------------------------- phase 12

# 12a's depth: 5,000 admitted pods, cut from 30,000. Every create runs
# the admission chain, whose LimitRanger and ResourceQuota each list
# their kind over the whole store (O(objects) a create, the reference's
# own cost), so creates slow down as the store fills; and the classic
# round's strict scan steps once per padded affinity row
P12_NODES = 5000
P12_ADMIT = 5000
P12_OVER = 64                  # creates past the quota, all refused
P12_CHECK = (512, 3000)        # 12d's card == CPU
P12_REST_PODS = 256            # 12b's creates over HTTP
P12_FIELD_NODES = 8            # 12b's field-selector lists
P12_FAILOVER = (5000, 10000)   # 12c: the reference's storm, 5x its nodes
P12_REQUESTS = {"cpu": 150, "memory": 300 << 20}  # the LimitRange default
P12_CLASSES = {"bench-high": 1000, "bench-low": 10}
P12_QUOTA_MSG = "exceeded quota: bench-pods, requested: pods=1"
STAMP_LABEL = "audit/stamped"


class StampingWebhook:
    """A mutating admission backend on localhost: every object it reviews
    comes back with STAMP_LABEL set (the AdmissionReview round trip of
    admission/webhook.py)."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                review = json.loads(self.rfile.read(n))
                obj = dict(review["request"]["object"])
                obj["metadata"] = dict(obj["metadata"])
                labels = dict(obj["metadata"].get("labels") or {})
                labels[STAMP_LABEL] = "true"
                obj["metadata"]["labels"] = labels
                body = json.dumps({"response": {
                    "allowed": True, "patchedObject": obj}}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._srv.server_address[1]}/admit"
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=10)


def audit_row(a):
    return (a.user, a.verb, a.resource, a.namespace, a.name, a.code,
            a.level)


def batch_size(a):
    """Pods in one bind_many audit entry ("<batch of N bindings>"), else
    None."""
    if a.resource == "pods" and a.name.startswith("<batch of "):
        return int(a.name.split()[2])
    return None


def front_door_pods(hollow, n):
    """mixed_affinity pods for 12a: every fifth (from the second) with its
    container requests stripped, so that LimitRanger defaults them; one
    in ten carries bench-high, the rest bench-low. Stripped pods get
    containers of their own: the profile's pods share their template's."""
    import dataclasses
    pods = hollow.mixed_affinity_pods(n)
    stripped, high = set(), set()
    for i, p in enumerate(pods):
        if i % 5 == 1:
            p.containers = [dataclasses.replace(c, requests={})
                            for c in p.containers]
            stripped.add(p.name)
        p.priority_class = "bench-high" if i % 10 == 3 else "bench-low"
        if i % 10 == 3:
            high.add(p.name)
    return pods, stripped, high


def front_door_run(mods, n_nodes, n_admit, device=None, spy=None):
    """12a's path: the in-process ApiServer() with the default admission
    chain; the bench Namespace, a LimitRange with default container
    requests, two PriorityClasses and a ResourceQuota of n_admit pods;
    n_nodes hollow nodes created through api.create; the Scheduler
    started; n_admit + P12_OVER pods created through the chain; then
    run_until_drained() with PodPriority on (the classic rounds). The
    caller turns the gate on. Returns a dict of what the checks read;
    the scheduler is left open for 12b."""
    import contextlib
    import torch
    (hollow, workloads, cluster, apiserver, Scheduler, kernels,
     Rejected) = mods
    api = apiserver.ApiServer()
    api.create("Namespace", workloads.Namespace(name="bench"))
    api.create("LimitRange", cluster.LimitRange(
        name="bench-defaults", namespace="bench",
        limits=[cluster.LimitRangeItem(
            type="Container", default_request=dict(P12_REQUESTS))]))
    for name, value in P12_CLASSES.items():
        api.create("PriorityClass",
                   workloads.PriorityClass(name=name, value=value))
    api.create("ResourceQuota", cluster.ResourceQuota(
        name="bench-pods", namespace="bench", hard={"pods": n_admit}))
    t0 = time.perf_counter()
    for node in hollow.hollow_nodes(n_nodes):
        api.create("Node", node)
    node_s = time.perf_counter() - t0
    sched = Scheduler(api, record_events=False, device=device)
    sched.start()
    pods, stripped, high = front_door_pods(hollow, n_admit + P12_OVER)
    # the scheduler binds through bind_many (ApiServer has no
    # bind_pods_bulk); note when each batch returns
    bind_at = []
    real_bind_many = api.bind_many

    def bind_many(bindings, cred=None):
        out = real_bind_many(bindings, cred)
        bind_at.append(time.perf_counter())
        return out

    api.bind_many = bind_many
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    refused = []
    t_first = time.perf_counter()
    for p in pods:
        try:
            api.create("Pod", p)
        except Rejected as e:
            refused.append((p.name, str(e)))
    t_created = time.perf_counter()
    with spy if spy is not None else contextlib.nullcontext():
        tot = sched.run_until_drained()
    if on_card:
        torch.cuda.synchronize()
    t_drained = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    return {
        "api": api, "sched": sched, "pods": pods, "stripped": stripped,
        "high": high, "refused": refused, "tot": tot,
        "launches": launches, "node_creates_per_s": n_nodes / node_s,
        "creates_per_s": len(pods) / (t_created - t_first),
        "drain_s": t_drained - t_created,
        "first_create_to_last_bind_s": (max(bind_at) - t_first
                                        if bind_at else None)}


def check_front_door(run, n_admit, tag):
    """12a's checks on a front_door_run result (also 12d's runs)."""
    store = run["api"].store
    tot = run["tot"]
    pods = run["pods"]
    want_refused = [p.name for p in pods[n_admit:]]
    if [n for n, _ in run["refused"]] != want_refused:
        fail(f"{tag}: refused {len(run['refused'])} creates, want the last "
             f"{P12_OVER}")
    bad = [m for _, m in run["refused"] if not m.startswith(P12_QUOTA_MSG)]
    if bad:
        fail(f"{tag}: a refusal not by ResourceQuota: {bad[0]}")
    quota = store.get("ResourceQuota", "bench", "bench-pods")
    if quota.used.get("pods") != n_admit:
        fail(f"{tag}: quota used {quota.used}, admitted {n_admit}")
    refused = {n for n, _ in run["refused"]}
    for p in pods:
        if p.name in refused:
            continue
        got = store.get("Pod", "bench", p.name)
        if p.name in run["stripped"] and any(
                c.requests != P12_REQUESTS for c in got.containers):
            fail(f"{tag}: {p.name} was not defaulted by LimitRanger: "
                 f"{[c.requests for c in got.containers]}")
        want = P12_CLASSES["bench-high" if p.name in run["high"]
                           else "bench-low"]
        if got.priority != want:
            fail(f"{tag}: {p.name} priority {got.priority}, want {want}")
    if tot["bind_errors"]:
        fail(f"{tag}: bind_errors {tot['bind_errors']}")
    batches = [a for a in run["api"].audit_log
               if batch_size(a) is not None]
    if not batches or any(a.code != 200 for a in batches):
        fail(f"{tag}: binding audit entries {len(batches)}, codes "
             f"{sorted({a.code for a in batches})}")
    if sum(batch_size(a) for a in batches) != tot["bound"]:
        fail(f"{tag}: the binding entries hold "
             f"{sum(batch_size(a) for a in batches)} pods, bound "
             f"{tot['bound']}")
    return len(batches)


def rest_front_door(mods, run, card):
    """12b: a secure ApiServer on 12a's store (token authn, the bootstrap
    RBAC, a RoleBinding giving one user edit in `rest`, a mutating
    webhook), RestServer over it; 256 pods created over HTTP by the bound
    user, one refused for an unbound one; 12a's scheduler on the card
    binds the 256. Returns the launches of that drain."""
    import torch
    (hollow, kernels, apiserver, rest_http, rest_client, admission,
     webhook, authn, rbac, workloads, api_types) = mods
    store = run["api"].store
    tokens = {"edit-token": rbac.UserInfo("rest-editor"),
              "admin-token": rbac.UserInfo(
                  "rest-admin", groups=[rbac.SYSTEM_MASTERS]),
              "stranger-token": rbac.UserInfo("stranger")}
    backend = StampingWebhook()
    secure = apiserver.ApiServer(
        store=store, auth=True,
        authenticator=authn.UnionAuthenticator(
            [authn.TokenAuthenticator(tokens)]))
    secure.admission = admission.AdmissionChain(
        admission.default_plugins() + [webhook.GenericAdmissionWebhook([
            webhook.WebhookHook(
                name="stamper", url=backend.url, mutating=True,
                rules=[webhook.Rule(operations=["CREATE"],
                                    kinds=["Pod"])])])],
        store=store)
    secure.bootstrap_rbac()
    admin = authn.Credential(token="admin-token")
    secure.create("Namespace", workloads.Namespace(name="rest"), cred=admin)
    secure.create("RoleBinding", rbac.RoleBinding(
        name="rest-editor", namespace="rest",
        subjects=[rbac.Subject("User", "rest-editor")],
        role_ref=rbac.RoleRef("ClusterRole", "edit")), cred=admin)
    srv = rest_http.RestServer(secure)
    srv.start()
    sched = run["sched"]
    try:
        base = f"http://127.0.0.1:{srv.port}"
        editor = rest_client.RestClient(base, token="edit-token")
        pods = hollow.density_pods(P12_REST_PODS, namespace="rest")
        t0 = time.perf_counter()
        for p in pods:
            editor.create("Pod", p)
        create_s = time.perf_counter() - t0
        stranger = rest_client.RestClient(base, token="stranger-token")
        try:
            stranger.create("Pod", api_types.make_pod(
                "stranger-0", namespace="rest", cpu=100))
            fail("12b: an unbound user's create was admitted")
        except rest_client.HttpError as e:
            if e.code != 403:
                fail(f"12b: an unbound user's create returned {e.code}")
        denied = [a for a in secure.audit_log if a.user == "stranger"]
        if [(a.verb, a.resource, a.namespace, a.name, a.code)
                for a in denied] != [("create", "pods", "rest",
                                      "stranger-0", 403)]:
            fail(f"12b: the refusal's audit entries: "
                 f"{[audit_row(a) for a in denied]}")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        tot = sched.run_until_drained()
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t1
        launches = dict(kernels.LAUNCHES)
        if tot["bound"] != P12_REST_PODS or tot["bind_errors"]:
            fail(f"12b: the card's scheduler bound {tot}")
        got = [store.get("Pod", "rest", p.name) for p in pods]
        unbound = sum(1 for p in got if not p.node_name)
        unstamped = sum(1 for p in got
                        if p.labels.get(STAMP_LABEL) != "true")
        if unbound or unstamped:
            fail(f"12b: {unbound} rest pods unbound, {unstamped} without "
                 f"the webhook's stamp")
        if secure.admission.plugins[-1].calls != P12_REST_PODS:
            fail(f"12b: the webhook was called "
                 f"{secure.admission.plugins[-1].calls} times")
        admin_client = rest_client.RestClient(base, token="admin-token")
        nodes = sorted({p.node_name for p in got})[:P12_FIELD_NODES]
        for n in nodes:
            listed, _rv = admin_client.list(
                "Pod", field_selector=f"spec.nodeName={n}")
            want = sorted(p.key() for p in store.list("Pod")[0]
                          if p.node_name == n)
            if sorted(p.key() for p in listed) != want or not want:
                fail(f"12b: field-selector list on {n}: "
                     f"{len(listed)} pods, the store holds {len(want)}")
        spec = admin_client.openapi()
        version = admin_client.version()
        if not spec.get("paths") or version.get("major") != "1":
            fail("12b: /openapi/v2 or /version did not answer")
    finally:
        srv.stop()
        backend.stop()
    log(f"12b REST front door: {P12_REST_PODS} pods created over HTTP by "
        f"the bound user in {create_s:.3f} s "
        f"({P12_REST_PODS / create_s:.0f} creates/s, token authn, RBAC, "
        f"the default chain and the stamping webhook), the unbound user's "
        f"create 403 and audited 403; the card's scheduler bound all "
        f"{P12_REST_PODS} in {drain_s:.3f} s, every one stamped; "
        f"field-selector lists equal the store on {len(nodes)} nodes; "
        f"/openapi/v2 ({len(spec['paths'])} paths) and /version answer; "
        f"launches {launches} [{card}]")
    return launches


def wal_failover(mods, card, spy):
    """12c: tests/test_replication.py's failover storm behind the front
    door at P12_FAILOVER on the card. Returns the launches of the
    primary's rounds and the promoted scheduler's drain."""
    import tempfile
    import torch
    (kernels, apiserver, apiserver_lite, replication, chaosmonkey,
     api_types, workloads, Scheduler) = mods
    n_nodes, n_pods = P12_FAILOVER
    max_log = 4 * (n_nodes + n_pods)
    launches = {k: 0 for k in kernels.LAUNCHES}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wal_") as tmp:
        p_dir, s_dir = os.path.join(tmp, "p"), os.path.join(tmp, "s")
        api = apiserver.ApiServer(store=apiserver_lite.ApiServerLite(
            data_dir=p_dir, max_log=max_log))
        api.create("Namespace", workloads.Namespace(name="default"))
        t0 = time.perf_counter()
        for i in range(n_nodes):
            api.create("Node", api_types.make_node(
                f"node-{i:04d}", cpu=4000, memory=16 << 30))
        for i in range(n_pods):
            api.create("Pod", api_types.make_pod(f"pod-{i:05d}", cpu=100))
        create_s = time.perf_counter() - t0
        standby = replication.WalShippingStandby(p_dir, s_dir)
        standby.ship()
        sched = Scheduler(api, record_events=False)
        sched.start()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with spy:
            sched.schedule_round(max_batch=4000)
            torch.cuda.synchronize()
            for k, v in kernels.LAUNCHES.items():
                launches[k] += v
            shipped_bound = sum(1 for p in api.store.list("Pod")[0]
                                if p.node_name)
            standby.ship()
            kernels.reset_launch_counts()
            sched.schedule_round(max_batch=2000)
            torch.cuda.synchronize()
            for k, v in kernels.LAUNCHES.items():
                launches[k] += v
        sched.engine.close()
        bound_primary = sum(1 for p in api.store.list("Pod")[0]
                            if p.node_name)
        if shipped_bound < 4000 or bound_primary < shipped_bound + 2000:
            fail(f"12c: the primary bound {shipped_bound} then "
                 f"{bound_primary}")
        state = {}

        def primary_dies_standby_promotes():
            state["store"] = standby.promote(max_log=max_log)

        def converge():
            store = state["store"]
            pods = store.list("Pod")[0]
            if len(pods) != n_pods:
                fail(f"12c: {len(pods)} pods restored, {n_pods} shipped")
            restored = {p.key(): p.node_name for p in pods if p.node_name}
            if not shipped_bound <= len(restored) <= bound_primary:
                fail(f"12c: {len(restored)} bound after promotion, not in "
                     f"[{shipped_bound}, {bound_primary}]")
            sched2 = Scheduler(apiserver.ApiServer(store=store),
                               record_events=False)
            sched2.start()
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t1 = time.perf_counter()
            with spy:
                tot = sched2.run_until_drained()
            torch.cuda.synchronize()
            state["converge_s"] = time.perf_counter() - t1
            for k, v in kernels.LAUNCHES.items():
                launches[k] += v
            sched2.engine.close()
            if tot["bind_errors"]:
                fail(f"12c: bind_errors {tot['bind_errors']}")
            state.update(restored=len(restored), tot=tot)
            binds = {}
            for e in store._log:
                if e.kind == "Pod" and e.type == "MODIFIED" \
                        and e.obj.node_name:
                    binds.setdefault(e.obj.key(), set()).add(
                        e.obj.node_name)
            twice = [k for k, v in binds.items()
                     if len(v) > 1 or (k in restored
                                       and v != {restored[k]})]
            if twice:
                fail(f"12c: {len(twice)} pods bound to two nodes, e.g. "
                     f"{twice[0]}")

        cm = chaosmonkey.Chaosmonkey(primary_dies_standby_promotes)
        cm.register(chaosmonkey.Test(test=converge, name="store-failover"))
        cm.do()
        unbound = [p.name for p in state["store"].list("Pod")[0]
                   if not p.node_name]
        if unbound:
            fail(f"12c: {len(unbound)} pods never bound")
    log(f"12c WAL-shipping failover, {n_nodes} nodes x {n_pods} pods behind "
        f"ApiServer over a durable store: creates {create_s:.3f} s "
        f"({(n_nodes + n_pods) / create_s:.0f}/s), shipped "
        f"{standby.bytes_shipped} bytes in {standby.ships} passes with "
        f"{shipped_bound} pods bound, the primary reached {bound_primary}, "
        f"{state['restored']} bound after promotion; the promoted "
        f"store's fresh scheduler converged in {state['converge_s']:.3f} s "
        f"(totals {json.dumps(state['tot'])}), no pod bound twice; "
        f"launches {launches} [{card}]")
    return launches


def front_door(mods, card):
    """Phase 12: the port's scheduler on the card behind the full
    apiserver. Returns (launches of 12a-12c, max abs err per kernel)."""
    (hollow, kernels, features, workloads, cluster, apiserver,
     apiserver_lite, rest_http, rest_client, admission, webhook, authn,
     rbac, api_types, replication, chaosmonkey, Scheduler) = mods
    t_phase = time.perf_counter()
    run_mods = (hollow, workloads, cluster, apiserver, Scheduler, kernels,
                admission.Rejected)
    total = {k: 0 for k in kernels.LAUNCHES}
    err = {k: 0 for k in kernels.LAUNCHES}
    gate = features.DEFAULT_FEATURE_GATE.enabled("PodPriority")
    features.DEFAULT_FEATURE_GATE.set("PodPriority", True)
    try:
        # 12a
        spy = OperandSpy(kernels)
        run = front_door_run(run_mods, P12_NODES, P12_ADMIT, spy=spy)
        _, unbound = audit_store(run["api"].store, "mixed_affinity",
                                 P12_ADMIT)
        n_batches = check_front_door(run, P12_ADMIT, "12a")
        if unbound or run["tot"]["bound"] != P12_ADMIT:
            fail(f"12a: {unbound} pods unbound, totals {run['tot']}")
        launches = run["launches"]
        if launches["capacity_fit"] == 0 or \
                launches["incidence_matmul"] == 0:
            fail(f"12a: a kernel never launched behind the front door "
                 f"({launches})")
        cap_shapes, inc_shapes = spy.shapes()
        for k, v in spy.check("12a front door").items():
            err[k] = max(err[k], v)
        for k, v in launches.items():
            total[k] += v
        log(f"12a front door: {P12_NODES} nodes ("
            f"{run['node_creates_per_s']:.0f} node creates/s) x "
            f"{P12_ADMIT + P12_OVER} pod creates through ApiServer's "
            f"default admission chain at {run['creates_per_s']:.0f} "
            f"creates/s, {len(run['refused'])} refused by ResourceQuota; "
            f"drain wall {run['drain_s']:.3f} s (PodPriority on: classic "
            f"rounds), first create to last bind "
            f"{run['first_create_to_last_bind_s']:.3f} s; totals "
            f"{json.dumps(run['tot'])}; {len(run['stripped'])} stripped "
            f"pods defaulted, {len(run['high'])} high; {n_batches} "
            f"binding audit entries (code 200), audit ring "
            f"{len(run['api'].audit_log)}; launches {launches}, shapes "
            f"(capacity (C, N, R)) {cap_shapes}, (incidence (M, N, L)) "
            f"{inc_shapes} [{card}]")
        # 12b
        try:
            got = rest_front_door(
                (hollow, kernels, apiserver, rest_http, rest_client,
                 admission, webhook, authn, rbac, workloads, api_types),
                run, card)
        finally:
            run["sched"].engine.close()
        for k, v in got.items():
            total[k] += v
        # 12d: card == CPU at 512 x 3,000
        runs = {}
        n_nodes, n_admit = P12_CHECK
        for tag, dev in (("card", None), ("CPU", "cpu")):
            r = front_door_run(run_mods, n_nodes, n_admit, device=dev)
            r["sched"].engine.close()
            check_front_door(r, n_admit, f"12d {tag}")
            log(f"12d front door {n_nodes} x {n_admit} on the {tag}: "
                f"{r['creates_per_s']:.0f} creates/s, drain wall "
                f"{r['drain_s']:.3f} s, totals {json.dumps(r['tot'])}")
            runs[tag] = (
                placements(r["api"].store), r["tot"], r["refused"],
                [audit_row(a) for a in r["api"].audit_log
                 if a.verb == "create" and batch_size(a) is None],
                sum(batch_size(a) or 0 for a in r["api"].audit_log))
        names = ("placements", "totals", "refused creates",
                 "create and refusal audit entries",
                 "pods over the binding entries")
        for name, a, b in zip(names, runs["card"], runs["CPU"]):
            if a != b:
                fail(f"12d: card != CPU in {name}")
        log(f"12d front door {n_nodes} x {n_admit}: card == CPU in "
            f"placements, totals, {len(runs['CPU'][2])} refusals, "
            f"{len(runs['CPU'][3])} create audit entries and "
            f"{runs['CPU'][4]} pods over the binding entries")
    finally:
        features.DEFAULT_FEATURE_GATE.set("PodPriority", gate)
    # 12c (PodPriority back as it was: the promoted store drains through
    # the pipeline)
    spy = OperandSpy(kernels)
    got = wal_failover((kernels, apiserver, apiserver_lite, replication,
                        chaosmonkey, api_types, workloads, Scheduler),
                       card, spy)
    if got["capacity_fit"] == 0:
        fail("12c: no capacity launch")
    for k, v in spy.check("12c failover").items():
        err[k] = max(err[k], v)
    for k, v in got.items():
        total[k] += v
    log(f"phase 12 launches {total}; phase 12 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total, err


# ---------------------------------------------------------------- phase 13


P13_NODES = 5000
P13_TEMPLATES = tuple(range(100))  # mixed_affinity's first hundred pods
P13_REPLICAS = 100
P13_PDS = 1000
P13_JOB = 200
P13_CHECK = (512, (0, 1, 15, 17, *range(22, 28)), 64)  # 13c
P13_TRACE = (5000, 30000)           # 13b: bench.py run_once's shape
P13_MAX_ROUNDS = 60                 # pump_until_stable's own cap
REGION = "region-1"
REGION_LABEL = "failure-domain.beta.kubernetes.io/region"
ZONE_LABEL = "failure-domain.beta.kubernetes.io/zone"


def controller_world(mods, n_nodes, templates, n_pd, device=None, spy=None):
    """13a's path (13c's at 512 nodes): ApiServerLite with n_nodes hollow
    nodes (zone and region labels); the ControllerManager over it on a
    FakeCloud; n_pd GCE PDs created in the cloud across the zones, their
    PersistentVolumes created through ApiServer over the same store (the
    default chain plus PersistentVolumeLabel on the cloud), claims bound
    by the PV binder; the card's Scheduler started; then one Deployment
    of P13_REPLICAS per template (the mixed_affinity pods at `templates`),
    one DaemonSet, one Job of P13_JOB and n_pd bare pods each mounting
    one claim; pump, drain, pump (the attach); half the Deployments
    scaled up by half; pump, drain, pump. Returns a dict of what the
    checks and the log read."""
    import contextlib
    import dataclasses
    import torch
    (hollow, types, workloads, admission, adm_plugins, apiserver,
     apiserver_lite, cloud_mod, controllers, Scheduler, COUNTERS,
     kernels) = mods
    Mi, Gi = 1 << 20, 1 << 30
    api = apiserver_lite.ApiServerLite(max_log=1_000_000)
    for node in hollow.hollow_nodes(n_nodes):
        node.labels[REGION_LABEL] = REGION
        api.create("Node", node)
    cloud = cloud_mod.FakeCloud()
    cm = controllers.ControllerManager(api, record_events=False,
                                       cloud=cloud)
    plugins = admission.default_plugins()
    plugins.insert(-1, adm_plugins.PersistentVolumeLabel(cloud))
    front = apiserver.ApiServer(
        store=api, admission=admission.AdmissionChain(plugins, store=api))
    t0 = time.perf_counter()
    for i in range(n_pd):
        cloud.create_disk(f"pd-{i:04d}", size_gb=10,
                          zone=hollow.ZONES[i % len(hollow.ZONES)],
                          region=REGION)
        front.create("PersistentVolume", types.PersistentVolume(
            f"pv-{i:04d}", capacity=10 * Gi, access_modes=["ReadWriteOnce"],
            source=types.Volume(name=f"pd-{i:04d}",
                                kind=types.VolumeKind.GCE_PD,
                                volume_id=f"pd-{i:04d}")))
        api.create("PersistentVolumeClaim", types.PersistentVolumeClaim(
            f"claim-{i:04d}", "default", capacity=10 * Gi,
            access_modes=["ReadWriteOnce"]))
    rounds = {"claims": cm.pump_until_stable()}
    walls = {"pv_and_claims": time.perf_counter() - t0}
    sched = Scheduler(api, record_events=False, device=device)
    sched.start()
    # the pipelined drain binds through bind_pods_bulk; note when each
    # batch returns
    bind_at = []
    bulk = api.bind_pods_bulk

    def bind_pods_bulk(*a, **kw):
        out = bulk(*a, **kw)
        bind_at.append(time.perf_counter())
        return out

    api.bind_pods_bulk = bind_pods_bulk
    profile = hollow.mixed_affinity_pods(100, namespace="default")
    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    drain = (spy if spy is not None else contextlib.nullcontext())
    sync()
    kernels.reset_launch_counts()
    t_first = time.perf_counter()
    for i, t in enumerate(templates):
        tpl = profile[t]
        name = f"d{i:03d}"
        api.create("Deployment", workloads.Deployment(
            name=name, replicas=P13_REPLICAS,
            template=dataclasses.replace(
                tpl, name="", uid="", labels=dict(tpl.labels, deploy=name)),
            selector=types.LabelSelector(match_labels={"deploy": name})))
    api.create("DaemonSet", workloads.DaemonSet(
        name="node-agent",
        selector=types.LabelSelector(match_labels={"ds": "node-agent"}),
        template=types.make_pod("", labels={"ds": "node-agent"}, cpu=100,
                                memory=64 * Mi)))
    api.create("Job", workloads.Job(
        name="batch", completions=P13_JOB, parallelism=P13_JOB,
        template=dataclasses.replace(
            types.make_pod("", labels={"job": "batch"}, cpu=100,
                           memory=128 * Mi), restart_policy="Never")))
    for i in range(n_pd):
        pod = types.make_pod(f"db-{i:04d}", cpu=100, memory=256 * Mi,
                             labels={"app": "db"})
        pod.volumes = [types.Volume(name="data", kind=types.VolumeKind.PVC,
                                    volume_id=f"claim-{i:04d}")]
        api.create("Pod", pod)
    tot, created, drain_spans = [], [], []
    for step in ("first", "scaled"):
        if step == "scaled":
            for i in range(0, len(templates), 2):
                dep = api.get("Deployment", "default", f"d{i:03d}")
                api.update("Deployment", dataclasses.replace(
                    dep, replicas=dep.replicas + dep.replicas // 2))
        n_before = len(api.list("Pod")[0])
        t = time.perf_counter()
        rounds[f"{step}_pump"] = cm.pump_until_stable()
        walls[f"{step}_pump"] = time.perf_counter() - t
        created.append(len(api.list("Pod")[0]) - n_before)
        COUNTERS.reset()
        t = time.perf_counter()
        with drain:
            tot.append(sched.run_until_drained())
        sync()
        walls[f"{step}_drain"] = time.perf_counter() - t
        snap = COUNTERS.snapshot()
        drain_spans.append({
            **{k: round(1e3 * v, 1) for k, (_, v) in sorted(snap.items())
               if k.startswith("pipeline.") and v > 0},
            **{k: snap.get(k, (0, 0.0))[0] for k in PIPE_COUNTERS}})
        if step == "first":
            walls["first_create_to_last_bind"] = max(bind_at) - t_first
        t = time.perf_counter()
        rounds[f"{step}_attach"] = cm.pump_until_stable()
        walls[f"{step}_attach"] = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    sched.engine.close()
    return {"api": api, "cloud": cloud, "rounds": rounds, "walls": walls,
            "tot": tot, "created": created, "launches": launches,
            "drain_spans": drain_spans,
            "templates": templates, "n_pd": n_pd}


def check_controller_world(run, tag):
    """13a's audits (also 13c's): phase 6's store audit with the
    DaemonSet's pods counted, every pod bound and no bind error, each
    Deployment owning one ReplicaSet of its size with every pod bound, one
    DaemonSet pod per node, the Job's pods, each claim bound and its pod
    in its PV's zone, no node past MaxPDVolumeCount or the cloud's disk
    limit, and each disk attached to exactly the node of its pod. Returns
    the number of pods."""
    api, cloud = run["api"], run["cloud"]
    pods = api.list("Pod")[0]
    nodes = {n.name: n for n in api.list("Node")[0]}
    if max(run["rounds"].values()) >= P13_MAX_ROUNDS:
        fail(f"{tag}: a pump stopped at its cap: {run['rounds']}")
    _, unbound = audit_store(api, "mixed_affinity", len(pods))
    if unbound or any(t["bind_errors"] for t in run["tot"]):
        fail(f"{tag}: {unbound} pods unbound, totals {run['tot']}")
    ds = [p for p in pods if p.owner_kind == "DaemonSet"]
    if sum(t["bound"] for t in run["tot"]) != len(pods) - len(ds):
        fail(f"{tag}: bound {[t['bound'] for t in run['tot']]} of "
             f"{len(pods) - len(ds)} pods the scheduler placed")
    n_dep = len(run["templates"])
    want = {f"d{i:03d}": P13_REPLICAS + (P13_REPLICAS // 2
                                         if i % 2 == 0 else 0)
            for i in range(n_dep)}
    rses = api.list("ReplicaSet")[0]
    if sorted(rs.owner_name for rs in rses) != sorted(want):
        fail(f"{tag}: ReplicaSets {sorted(rs.name for rs in rses)[:4]}..., "
             f"want one per Deployment")
    owned = {}
    for p in pods:
        if p.owner_kind == "ReplicaSet":
            owned[p.owner_name] = owned.get(p.owner_name, 0) + 1
    for rs in rses:
        if rs.replicas != want[rs.owner_name] or \
                owned.get(rs.name, 0) != rs.replicas:
            fail(f"{tag}: {rs.name} replicas {rs.replicas}, owns "
                 f"{owned.get(rs.name, 0)} pods, want {want[rs.owner_name]}")
    if sorted(p.node_name for p in ds) != sorted(nodes):
        fail(f"{tag}: {len(ds)} DaemonSet pods on "
             f"{len({p.node_name for p in ds})} of {len(nodes)} nodes")
    if sum(1 for p in pods if p.owner_kind == "Job") != P13_JOB:
        fail(f"{tag}: the Job has not {P13_JOB} pods")
    pvs = {pv.name: pv for pv in api.list("PersistentVolume")[0]}
    claims = {c.name: c for c in api.list("PersistentVolumeClaim")[0]}
    if len(claims) != run["n_pd"] or not all(
            c.volume_name for c in claims.values()) or len(
            {c.volume_name for c in claims.values()}) != len(claims):
        fail(f"{tag}: claims not each bound to a PV of their own")
    want_attach, per_node = {}, {}
    for p in pods:
        if not p.volumes:
            continue
        pv = pvs[claims[p.volumes[0].volume_id].volume_name]
        zone = nodes[p.node_name].labels.get(ZONE_LABEL)
        if pv.labels.get(ZONE_LABEL) != zone or not zone:
            fail(f"{tag}: {p.name} on {p.node_name} ({zone}), its PV "
                 f"{pv.name} in {pv.labels.get(ZONE_LABEL)}")
        want_attach[pv.source.volume_id] = p.node_name
        per_node[p.node_name] = per_node.get(p.node_name, 0) + 1
    if cloud.max_disks_per_node != 16 or \
            max(per_node.values()) > cloud.max_disks_per_node:
        fail(f"{tag}: {max(per_node.values())} PDs on one node, limit "
             f"{cloud.max_disks_per_node}")
    if cloud.attachments != want_attach:
        bad = sorted(set(cloud.attachments.items())
                     ^ set(want_attach.items()))[:3]
        fail(f"{tag}: attachments != the PD pods' nodes ({len(bad)}+ "
             f"differ: {bad})")
    return len(pods)


def controller_outcome(run):
    """What 13c holds the card against the CPU in."""
    api = run["api"]
    return (placements(api),
            sorted((rs.name, rs.owner_name, rs.replicas)
                   for rs in api.list("ReplicaSet")[0]),
            sorted((c.name, c.volume_name)
                   for c in api.list("PersistentVolumeClaim")[0]),
            sorted(run["cloud"].attachments.items()))


def interval_union(spans):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_window_share(trace):
    """The union of the trace's device-eval windows over the recorded
    wall (first event to last end), both from the trace itself."""
    evs = [e for e in trace["traceEvents"] if e.get("ph") in ("X", "i")]
    t0 = min(e["ts"] for e in evs)
    t1 = max(e["ts"] + e.get("dur", 0.0) for e in evs)
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in evs
           if e.get("ph") == "X" and e["name"].startswith("device-eval w")]
    return interval_union(dev) / (t1 - t0), (t1 - t0) / 1e6


def flight_recorder_trace(mods, card, tmp):
    """13b: the CLI's recorded drain on the card, then a second recorded
    drain of the same build under torch.profiler. The dispatch, device-eval
    and bind-flush lanes are drawn from the span ring (COUNTERS.spans()).
    Returns (launches, max abs err per kernel, the shares)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    (cli, rec_mod, perfetto, hollow, apiserver_lite, Scheduler, kernels,
     COUNTERS) = mods
    n_nodes, n_pods = P13_TRACE
    out = os.path.join(tmp, "trace.json")
    raw = os.path.join(tmp, "events.json")
    at_enable = []

    class Recorder:
        """The ring the CLI arms, noting engine.wave_dispatch when it
        does (the warm drain before it is not the recorded one)."""

        def __init__(self, real):
            self.real = real

        def __getattr__(self, name):
            return getattr(self.real, name)

        def enable(self):
            at_enable.append(COUNTERS.snapshot().get(
                "engine.wave_dispatch", (0, 0))[0])
            self.real.enable()

    real = rec_mod.RECORDER
    rec_mod.RECORDER = Recorder(real)
    spy = OperandSpy(kernels)
    t = time.perf_counter()  # the span ring's clock
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with spy:
            rc = cli.main(["--trace", out, "--events", raw,
                           "--nodes", str(n_nodes), "--pods", str(n_pods),
                           "--profile", "mixed_affinity"])
        torch.cuda.synchronize()
    finally:
        rec_mod.RECORDER = real
    t_end = time.perf_counter()
    cli_s = t_end - t
    launches = dict(kernels.LAUNCHES)
    if rc != 0 or len(at_enable) != 1:
        fail(f"13b: the CLI returned {rc}, armed the ring "
             f"{len(at_enable)} times")
    waves = COUNTERS.snapshot().get("engine.wave_dispatch",
                                    (0, 0))[0] - at_enable[0]
    with open(out) as f:
        trace = json.load(f)
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    per = {p: sum(1 for e in spans if e["name"].startswith(p))
           for p in ("dispatch w", "device-eval w", "bind-flush w")}
    if waves <= 0 or set(per.values()) != {waves}:
        fail(f"13b: {waves} waves dispatched, trace spans {per}")
    if any(e["dur"] <= 0 for e in spans):
        fail("13b: a span of zero or negative length")
    # both of the CLI's drains (the warm one and the recorded one)
    hidden = perfetto.overlap_seconds(COUNTERS.spans(t, t_end))
    if hidden < 0:
        fail(f"13b: overlap_seconds {hidden}")
    share, wall = device_window_share(trace)
    err = spy.check("13b recorded drains")
    if launches["capacity_fit"] == 0 or launches["incidence_matmul"] == 0:
        fail(f"13b: a kernel never launched in the CLI's drains "
             f"({launches})")
    log(f"13b flight recorder: python -m kubernetes_tpu_torch.observability "
        f"--trace at {n_nodes} x {n_pods} mixed_affinity on the card in "
        f"{cli_s:.1f} s (warm drain + recorded drain); {waves} waves, "
        f"{len(trace['traceEvents'])} trace events, {per}; recorded wall "
        f"{wall:.3f} s; host work hidden under device-eval windows "
        f"{hidden * 1e3:.1f} ms; device-window share {share:.4f} (the union "
        f"of the waves' asynchronous windows over the recorded wall: an "
        f"upper bound on the card's busy share); launches {launches} "
        f"[{card}]")
    # the same build, a second recorded drain under the profiler
    api = apiserver_lite.ApiServerLite(max_log=max(200_000,
                                                   3 * (n_nodes + n_pods)))
    hollow.load_cluster(api, hollow.hollow_nodes(n_nodes),
                        hollow.PROFILES["mixed_affinity"](n_pods))
    sched = Scheduler(api, record_events=False)
    sched.start()
    real.clear()
    real.enable()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        tot = sched.run_until_drained()
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t
    real.disable()
    ring = real.snapshot()
    ring_spans = COUNTERS.spans(t, t + drain_s)
    real.clear()
    sched.engine.close()
    if tot["bound"] != n_pods:
        fail(f"13b: the profiled drain bound {tot['bound']} of {n_pods}")
    prof_path = os.path.join(tmp, "profile.json")
    prof.export_chrome_trace(prof_path)
    with open(prof_path) as f:
        dev = [(e["ts"], e["ts"] + e["dur"])
               for e in json.load(f).get("traceEvents", [])
               if e.get("ph") == "X" and e.get("cat") in (
                   "kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        fail("13b: the profiler's trace holds no kernel or copy")
    busy = interval_union(dev) / 1e6 / drain_s
    ring_share, ring_wall = device_window_share(
        perfetto.build_chrome_trace(ring, ring_spans))
    log(f"13b profiled drain (the same build, {n_nodes} x {n_pods} "
        f"mixed_affinity, recorder on): wall {drain_s:.3f} s, "
        f"{len(dev)} kernels and copies, card busy share {busy:.4f} "
        f"(union of kernel and memcpy intervals over the drain's wall), "
        f"idle share {1 - busy:.4f}; device-window share of the same "
        f"drain {ring_share:.4f} over its recorded wall {ring_wall:.3f} s "
        f"[{card}]")
    shares = {"device_window_share": share, "busy_share": busy,
              "idle_share": 1 - busy, "profiled_window_share": ring_share}
    return launches, err, shares


def controllers_on_the_card(mods, card):
    """Phase 13: the controller manager, the cloud and volumes in front of
    the card's scheduler (13a), the flight recorder's trace of a drain
    through the port's own entry point (13b), card == CPU (13c). Returns
    (launches of 13a and 13b, max abs err per kernel)."""
    import tempfile
    (world_mods, trace_mods) = mods
    kernels = world_mods[-1]
    t_phase = time.perf_counter()
    total = {k: 0 for k in kernels.LAUNCHES}
    err = {k: 0 for k in kernels.LAUNCHES}
    # 13a
    spy = OperandSpy(kernels)
    run = controller_world(world_mods, P13_NODES, P13_TEMPLATES, P13_PDS,
                           spy=spy)
    n_pods = check_controller_world(run, "13a")
    launches = run["launches"]
    if launches["capacity_fit"] == 0 or launches["incidence_matmul"] == 0:
        fail(f"13a: a kernel never launched behind the controllers "
             f"({launches})")
    for k, v in spy.check("13a controllers").items():
        err[k] = max(err[k], v)
    for k, v in launches.items():
        total[k] += v
    w, r = run["walls"], run["rounds"]
    log(f"13a controllers: {P13_NODES} nodes, {len(P13_TEMPLATES)} "
        f"Deployments x {P13_REPLICAS} (half then scaled by half), a "
        f"DaemonSet, a Job of {P13_JOB}, {P13_PDS} PD pods; {n_pods} pods. "
        f"PVs through ApiServer (PersistentVolumeLabel on the FakeCloud) "
        f"and claims bound in {w['pv_and_claims']:.3f} s "
        f"({r['claims']} rounds); controller convergence {r['first_pump']} "
        f"rounds in {w['first_pump']:.3f} s ({run['created'][0]} pods "
        f"created, {run['created'][0] / w['first_pump']:.0f} pods/s), "
        f"drain {w['first_drain']:.3f} s, first Deployment create to last "
        f"bind {w['first_create_to_last_bind']:.3f} s, attach "
        f"{w['first_attach']:.3f} s ({r['first_attach']} rounds, "
        f"{len(run['cloud'].attachments)} disks); scaled: "
        f"{r['scaled_pump']} rounds in {w['scaled_pump']:.3f} s "
        f"({run['created'][1]} pods, "
        f"{run['created'][1] / w['scaled_pump']:.0f} pods/s), drain "
        f"{w['scaled_drain']:.3f} s, attach {w['scaled_attach']:.3f} s; "
        f"totals {json.dumps(run['tot'])}; drain spans (ms) and "
        f"counters {json.dumps(run['drain_spans'])}; launches {launches}, "
        f"by shape (capacity (mask or wave, C, N, R), incidence (M, N, L)) "
        f"{spy.launches_by_shape()} [{card}]")
    del run
    # 13b
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        got, got_err, _ = flight_recorder_trace(trace_mods, card, tmp)
    for k, v in got.items():
        total[k] += v
    for k, v in got_err.items():
        err[k] = max(err[k], v)
    # 13c: card == CPU
    n_nodes, templates, n_pd = P13_CHECK
    runs = {}
    for tag, dev in (("card", None), ("CPU", "cpu")):
        r = controller_world(world_mods, n_nodes, templates, n_pd,
                             device=dev)
        check_controller_world(r, f"13c {tag}")
        runs[tag] = controller_outcome(r)
        log(f"13c controllers {n_nodes} nodes x {len(templates)} "
            f"Deployments + {n_pd} PD pods on the {tag}: drains "
            f"{r['walls']['first_drain']:.3f} / "
            f"{r['walls']['scaled_drain']:.3f} s")
    names = ("placements", "ReplicaSets", "PV bindings", "attachments")
    for name, a, b in zip(names, runs["card"], runs["CPU"]):
        if a != b:
            fail(f"13c: card != CPU in {name}")
    log(f"13c: card == CPU in {len(runs['CPU'][0])} placements, "
        f"{len(runs['CPU'][1])} ReplicaSets, {len(runs['CPU'][2])} PV "
        f"bindings and {len(runs['CPU'][3])} attachments")
    log(f"phase 13 launches {total}; phase 13 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total, err


# ---------------------------------------------------------------- phase 14


P14 = {"nodes": 5000, "pods": 15000, "sets": 4, "replicas": 16,
       "rs": 1000, "dead_per_zone": 50, "pressure": 50, "best_effort": 200}
P14_CHECK = {"nodes": 512, "pods": 1536, "sets": 4, "replicas": 16,
             "rs": 100, "dead_per_zone": 5, "pressure": 5,
             "best_effort": 20}                      # 14e
P14_GRACE = 40.0              # NodeLifecycleController's default grace
P14_EVICTION_TIMEOUT = 60.0   # --pod-eviction-timeout cut from 300 s, as
#                               tests/test_chaos.py does
P14_TICK = 10.0               # one token of --node-eviction-rate 0.1/s
P14_HEARTBEAT_EVERY = 3       # ticks between heartbeats (30 s < the grace)
P14_PUMP_EVERY = 5            # ticks between the controllers' and the
#                               scheduler's passes while evictions run
P14_MAX_TICKS = 200
P14_REFUSED = ("OutOfcpu", "OutOfmemory", "OutOfPods")
Mi14 = 1 << 20


def node_agents_world(mods, cfg, device=None):
    """14a-14d in one world (14e runs it at P14_CHECK on the card and on
    the CPU): an ApiServerLite with a HollowFleet of cfg["nodes"] hollow
    kubelets, each registering its own Node; one SharedInformerFactory
    behind the fleet, the NodeLifecycleController, ReplicaSet, StatefulSet
    and Endpoint controllers and a HollowProxy; the card's Scheduler; one
    FakeClock for the kubelets, the lifecycle controller and the
    scheduler. Returns a dict of what the checks and the log read."""
    import urllib.request
    import torch
    (hollow, types, workloads, apiserver_lite, informer, kubelet_mod,
     proxy_mod, nodelifecycle, replicaset, statefulset, endpoint,
     Scheduler, COUNTERS, kernels, kubelet_server, probe) = mods
    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    clock = FakeClock()
    api = apiserver_lite.ApiServerLite(max_log=4_000_000)
    factory = informer.SharedInformerFactory(api)
    fleet = kubelet_mod.HollowFleet(api, factory, now=clock)
    t = time.perf_counter()
    for node in hollow.hollow_nodes(cfg["nodes"]):
        fleet.add_node(node)
    walls = {"register": time.perf_counter() - t}
    nlc = nodelifecycle.NodeLifecycleController(
        api, factory, grace_period=P14_GRACE,
        eviction_timeout=P14_EVICTION_TIMEOUT, record_events=False,
        now=clock)
    rsc = replicaset.ReplicaSetController(api, factory, record_events=False)
    ssc = statefulset.StatefulSetController(api, factory,
                                            record_events=False)
    epc = endpoint.EndpointController(api, factory, record_events=False)
    proxy = proxy_mod.HollowProxy(factory)
    sched = Scheduler(api, record_events=False, now=clock, device=device)
    sched.start()
    factory.step_all()
    # the first write that sets a pod Running, on the host clock
    running_at, created_at = {}, {}
    update = api.update

    def stamped_update(kind, obj, *a, **kw):
        out = update(kind, obj, *a, **kw)
        if kind == "Pod" and obj.phase == "Running":
            running_at.setdefault(obj.key(), time.perf_counter())
        return out

    api.update = stamped_update
    drains, tot = [], {}

    def drain(tag):
        COUNTERS.reset()
        t = time.perf_counter()
        got = sched.run_until_drained()
        sync()
        snap = COUNTERS.snapshot()
        drains.append({
            "tag": tag, "s": time.perf_counter() - t, "bound": got["bound"],
            **{k: round(1e3 * v, 1) for k, (_, v) in sorted(snap.items())
               if k.startswith("pipeline.") and v > 0},
            **{k: n for k, (n, _) in sorted(snap.items())
               if k.startswith("snapshot.refresh")
               or k in ("engine.device_upload_arrays",
                        "engine.shard_upload_bytes", "engine.wave_dispatch")}})
        for k, v in got.items():
            tot[k] = tot.get(k, 0) + v
        return got

    def settle():
        """Deliver the store's events, then one kubelet sync pass."""
        factory.step_all()
        t = time.perf_counter()
        fleet.step()
        factory.step_all()
        return time.perf_counter() - t

    # ---- 14a: kubemark density
    pods = hollow.mixed_affinity_pods(cfg["pods"])
    sync()
    kernels.reset_launch_counts()
    t_first = time.perf_counter()
    for p in pods:
        created_at[p.key()] = time.perf_counter()
        api.create("Pod", p)
    walls["14a_create"] = time.perf_counter() - t_first
    drain("14a")
    walls["14a_drain"] = drains[-1]["s"]
    bound = {p.key() for p in api.list("Pod")[0] if p.node_name}
    fleet_s, passes = 0.0, 0
    while passes < 5 and not bound <= running_at.keys():
        fleet_s += settle()
        passes += 1
    walls["14a_fleet_step"] = fleet_s
    walls["14a_fleet_passes"] = passes
    audit_14a = audit_store(api, "mixed_affinity", cfg["pods"])
    lat = [running_at[k] - created_at[k] for k in bound if k in running_at]
    walls["14a_first_create_to_last_running"] = (
        max(running_at.values()) - t_first if running_at else 0.0)
    # heartbeats: 5,000 Node writes that change no condition
    t = time.perf_counter()
    fleet.heartbeat_all()
    walls["14a_heartbeat_all"] = time.perf_counter() - t
    factory.step_all()
    COUNTERS.reset()
    t = time.perf_counter()
    sched.sync()
    sched.engine._refresh()
    dirty = sorted(sched.engine.snapshot.dirty)
    sched.engine._nodes_on_device()
    sync()
    snap = COUNTERS.snapshot()
    heartbeat_sync = {
        "s": time.perf_counter() - t, "dirty": dirty,
        **{k: n for k, (n, _) in sorted(snap.items())
           if k.startswith("snapshot.refresh")
           or k in ("engine.device_upload_arrays",
                    "engine.shard_upload_bytes")}}
    # the kubelet API of one kubelet, through the port's prober
    kl_name = sorted(fleet.kubelets)[0]
    kl = fleet.kubelets[kl_name]
    srv = kubelet_server.KubeletServer(kl)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        probes = {path: probe.probe_http(base + path)
                  for path in ("/healthz", "/pods")}
        with urllib.request.urlopen(base + "/pods", timeout=5) as r:
            served = json.loads(r.read())["items"]
    finally:
        srv.stop()
    admitted_14a = len(kl.serve_pods())

    # ---- 14b: StatefulSets, ordered
    t = time.perf_counter()
    for j in range(cfg["sets"]):
        app = f"ss-{j}"
        api.create("StatefulSet", workloads.StatefulSet(
            name=app, replicas=cfg["replicas"],
            selector=types.LabelSelector(match_labels={"app": app}),
            template=types.make_pod("", labels={"app": app}, cpu=100,
                                    memory=128 * Mi14)))
    ss_rounds = 0
    want_ss = cfg["sets"] * cfg["replicas"]

    def ss_pods():
        return [p for p in api.list("Pod")[0]
                if p.owner_kind == "StatefulSet"]

    while ss_rounds < 4 * cfg["replicas"]:
        factory.step_all()
        ssc.pump()
        drain("14b")
        settle()
        ss_rounds += 1
        if sum(p.phase == "Running" for p in ss_pods()) == want_ss:
            break
    factory.step_all()
    ssc.pump()
    walls["14b"] = time.perf_counter() - t
    walls["14b_rounds"] = ss_rounds

    # ---- 14c: node death (a Service in front of the ReplicaSet: the
    # endpoints controller and kube-proxy follow its live pods)
    rs_sel = types.LabelSelector(match_labels={"app": "web"})
    api.create("Service", workloads.Service(
        "web", "default", selector={"app": "web"},
        ports=[workloads.ServicePort(port=80)]))
    api.create("ReplicaSet", workloads.ReplicaSet(
        name="web", replicas=cfg["rs"], selector=rs_sel,
        template=types.make_pod("", labels={"app": "web"}, cpu=100,
                                memory=128 * Mi14)))

    def rs_pods():
        return [p for p in api.list("Pod")[0]
                if p.owner_kind == "ReplicaSet" and p.owner_name == "web"]

    t = time.perf_counter()
    for _ in range(20):
        factory.step_all()
        rsc.pump()
        drain("14c_fill")
        settle()
        if sum(p.phase == "Running" for p in rs_pods()) == cfg["rs"]:
            break
    walls["14c_fill"] = time.perf_counter() - t
    nodes = {n.name: n for n in api.list("Node")[0]}
    zone_of = {n: nodes[n].labels.get(hollow.ZONE_KEY) for n in nodes}
    web_nodes = sorted({p.node_name for p in rs_pods()})
    ss_nodes = sorted({p.node_name for p in ss_pods()})
    dead = []
    for zone in hollow.ZONES:
        # one node a zone that holds a StatefulSet ordinal, then the
        # ReplicaSet's nodes, then the rest
        pick = [n for n in ss_nodes if zone_of[n] == zone][:1]
        pick += [n for n in web_nodes if zone_of[n] == zone
                 and n not in pick]
        pick += [n for n in sorted(nodes) if zone_of[n] == zone
                 and n not in pick]
        dead += pick[:cfg["dead_per_zone"]]
    dead_set = set(dead)
    on_dead = {p.key(): p.node_name for p in api.list("Pod")[0]
               if p.node_name in dead_set}
    rs_on_dead = {p.key() for p in rs_pods() if p.node_name in dead_set}
    ss_on_dead = {p.key() for p in ss_pods() if p.node_name in dead_set}
    for name in dead:
        del fleet.kubelets[name]          # the process is gone
    t_first_evict = None
    rs_before = {p.key() for p in rs_pods()}
    t = time.perf_counter()
    ticks = left = 0
    while ticks < P14_MAX_TICKS:
        ticks += 1
        clock.t += P14_TICK
        if ticks % P14_HEARTBEAT_EVERY == 0:
            fleet.heartbeat_all()
        factory.step_all()
        nlc.monitor_tick()
        # while pods still stand on dead nodes, the controllers and the
        # scheduler run every P14_PUMP_EVERY ticks; after that, every tick
        if ticks % P14_PUMP_EVERY and left:
            continue
        # a recreated StatefulSet ordinal keeps its key: count what still
        # stands on a dead node, not what is present
        left = sum(p.node_name in dead_set for p in api.list("Pod")[0])
        if t_first_evict is None and left < len(on_dead):
            t_first_evict = time.perf_counter()
        factory.step_all()
        rsc.pump()
        ssc.pump()
        drain("14c")
        settle()
        epc.pump()
        web = rs_pods()
        if not left and len(web) == cfg["rs"] and all(
                p.phase == "Running" for p in web) and sum(
                p.phase == "Running" for p in ss_pods()) == want_ss:
            break
    walls["14c_ticks"] = ticks
    walls["14c"] = time.perf_counter() - t
    replaced = {p.key(): p.node_name for p in rs_pods()
                if p.key() not in rs_before}
    rs_running = [running_at.get(k) for k in replaced]
    walls["14c_first_evict_to_last_replacement_running"] = (
        max(rs_running) - t_first_evict
        if rs_running and None not in rs_running and t_first_evict
        else None)
    factory.step_all()
    ssc.pump()
    epc.pump()
    factory.step_all()
    backends = proxy.backends("default/web", 80)

    # ---- 14d: memory pressure
    live = sorted(n for n in nodes if n not in dead_set)
    hot = live[:cfg["pressure"]]
    hog_mem = int(nodes[hot[0]].allocatable.memory * 0.97)
    for i, name in enumerate(hot):
        be = types.make_pod(f"be-{i:04d}", node_name=name,
                            labels={"app": "pressure"})
        be.annotations[kubelet_mod.ACTUAL_MEM_ANNOTATION] = str(64 * Mi14)
        hog = types.make_pod(f"hog-{i:04d}", cpu=100, memory=128 * Mi14,
                             node_name=name, labels={"app": "pressure"})
        hog.annotations[kubelet_mod.ACTUAL_MEM_ANNOTATION] = str(hog_mem)
        api.create("Pod", be)
        api.create("Pod", hog)
    settle()
    fleet.heartbeat_all()
    factory.step_all()
    pressured = sorted(
        n.name for n in api.list("Node")[0]
        if n.condition("MemoryPressure") == types.ConditionStatus.TRUE)
    best_effort = [f"default/late-be-{i:04d}"
                   for i in range(cfg["best_effort"])]
    for i in range(cfg["best_effort"]):
        api.create("Pod", types.make_pod(f"late-be-{i:04d}",
                                         labels={"app": "late"}))
    drain("14d")
    settle()
    launches = dict(kernels.LAUNCHES)
    walls["total"] = time.perf_counter() - t_first
    sched.engine.close()
    return {"api": api, "walls": walls, "backends": backends,
            "drains": drains, "tot": tot, "latency": lat,
            "n_bound_14a": len(bound),
            "heartbeat_sync": heartbeat_sync, "probes": probes,
            "served": served, "admitted_14a": admitted_14a,
            "kubelet": kl_name, "dead": dead, "on_dead": on_dead,
            "rs_on_dead": rs_on_dead, "ss_on_dead": ss_on_dead,
            "replaced": replaced,
            "hot": hot, "pressured": pressured,
            "best_effort": best_effort, "launches": launches, "cfg": cfg,
            "ss_rounds": ss_rounds, "audit_14a": audit_14a}


def ss_creation_order(api):
    """Per StatefulSet, its ordinals in the order the store created
    them, each with the log index of its creation and of the first
    write that set its ordinal before it Running."""
    out, running = {}, {}
    for i, e in enumerate(api._log):
        if e.kind != "Pod" or e.obj.owner_kind != "StatefulSet":
            continue
        name = e.obj.name
        if e.type == "ADDED":
            out.setdefault(e.obj.owner_name, []).append((name, i))
        elif e.type == "MODIFIED" and e.obj.phase == "Running":
            running.setdefault(name, i)
    return out, running


def check_node_agents(run, tag, types):
    """14a-14d's audits (also 14e's): one bind per pod life and no bind
    error, no pod refused by kubelet admission, 14a's pods bound and
    Running (phase 6's store audit ran on the 14a store), the kubelet
    server's probes, each StatefulSet ordinal created only after the one
    before it ran, nothing left on a dead node, each evicted ReplicaSet
    pod replaced once on a live one and each evicted ordinal recreated
    under its name on one, every ordinal Running, MemoryPressure reported
    by exactly the loaded kubelets, no BestEffort pod placed on them and
    BestEffort evicted before the hog on each. Returns counts for the
    log."""
    api, cfg = run["api"], run["cfg"]
    pods = api.list("Pod")[0]
    by_key = {p.key(): p for p in pods}
    nodes = {n.name: n for n in api.list("Node")[0]}
    dead = set(run["dead"])
    # one bind per pod life, 0 bind errors
    binds = store_binds(api)
    twice = {k: v for k, v in binds.items() if len(v) > 1}
    if twice or run["tot"].get("bind_errors"):
        fail(f"{tag}: {len(twice)} pods bound twice in one life "
             f"({sorted(twice)[:3]}), totals {run['tot']}")
    # zero pods refused by kubelet admission
    refused = [p.key() for p in pods if p.annotations.get(
        "kubernetes.io/failure-reason") in P14_REFUSED]
    if refused:
        fail(f"{tag}: kubelet admission refused {len(refused)} pods the "
             f"card placed ({refused[:3]})")
    # 14a: every density pod bound and Running on its node, else fits
    # nowhere (phase 6's rule, checked on the 14a store before the rest)
    density = [p for p in pods if p.name.startswith("mixed-")]
    unbound = [p for p in density if not p.node_name]
    if unbound:
        fail(f"{tag}: {len(unbound)} density pods unbound")
    if run["n_bound_14a"] != cfg["pods"] or \
            len(run["latency"]) != cfg["pods"]:
        fail(f"{tag}: 14a bound {run['n_bound_14a']}, Running "
             f"{len(run['latency'])} of {cfg['pods']}")
    for p in density:
        if p.node_name in dead:
            continue          # evicted with its node in 14c
        if p.phase != "Running":
            fail(f"{tag}: {p.key()} is {p.phase} on {p.node_name}")
    if run["probes"]["/healthz"][0] != "Success" or \
            run["probes"]["/pods"][0] != "Success" or \
            len(run["served"]) != run["admitted_14a"]:
        fail(f"{tag}: kubelet server probes {run['probes']}, "
             f"{len(run['served'])} pods served of {run['admitted_14a']}")
    # 14b: ordinal i created only after ordinal i-1 was Running
    order, running = ss_creation_order(api)
    if len(order) != cfg["sets"]:
        fail(f"{tag}: {len(order)} StatefulSets created pods")
    for name, made in order.items():
        first = {}
        for pod, i in made:
            first.setdefault(pod, i)
        for i in range(cfg["replicas"]):
            pod = f"{name}-{i}"
            if pod not in first:
                fail(f"{tag}: {pod} never created")
            if i and not running.get(f"{name}-{i - 1}", 1 << 62) < \
                    first[pod]:
                fail(f"{tag}: {pod} created before {name}-{i - 1} ran")
    # 14c: nothing left on a dead node, each evicted RS pod replaced once
    for n in dead:
        if nodes[n].condition("Ready") != types.ConditionStatus.UNKNOWN:
            fail(f"{tag}: dead node {n} is not Unknown")
    on_dead = [p.key() for p in pods if p.node_name in dead]
    if on_dead:
        fail(f"{tag}: {len(on_dead)} pods still on Unknown nodes "
             f"({on_dead[:3]})")
    web = [p for p in pods if p.owner_kind == "ReplicaSet"]
    if len(web) != cfg["rs"] or any(p.phase != "Running" for p in web):
        fail(f"{tag}: the ReplicaSet holds {len(web)} pods, "
             f"{sum(p.phase == 'Running' for p in web)} Running")
    if len(run["replaced"]) != len(run["rs_on_dead"]) or any(
            n in dead for n in run["replaced"].values()):
        fail(f"{tag}: {len(run['rs_on_dead'])} RS pods evicted, "
             f"{len(run['replaced'])} replacements")
    if not run["rs_on_dead"]:
        fail(f"{tag}: no ReplicaSet pod stood on a killed node")
    # each StatefulSet ordinal evicted with its node is recreated under its
    # name (its second life) on a live node, and every ordinal runs
    if not run["ss_on_dead"]:
        fail(f"{tag}: no StatefulSet ordinal stood on a killed node")
    for k in sorted(run["ss_on_dead"]):
        again = binds.get((k, 1), [])
        if k not in by_key or len(again) != 1 or again[0] in dead or \
                by_key[k].node_name != again[0]:
            fail(f"{tag}: StatefulSet ordinal {k} evicted from a killed "
                 f"node, recreated on {again}")
    ss = [p for p in pods if p.owner_kind == "StatefulSet"]
    if len(ss) != cfg["sets"] * cfg["replicas"] or any(
            p.phase != "Running" for p in ss):
        fail(f"{tag}: {sum(p.phase == 'Running' for p in ss)} of "
             f"{len(ss)} StatefulSet pods Running after 14c")
    routed = sorted(node for _, _, node in run["backends"])
    if routed != sorted(p.node_name for p in web):
        fail(f"{tag}: kube-proxy routes to {len(routed)} backends, the "
             f"ReplicaSet runs {len(web)} pods")
    # 14d: pressure reported, BestEffort kept off, BestEffort evicted first
    if run["pressured"] != sorted(run["hot"]):
        fail(f"{tag}: MemoryPressure on {len(run['pressured'])} nodes, "
             f"{len(run['hot'])} expected")
    hot = set(run["hot"])
    late = [by_key[k] for k in run["best_effort"]]
    if any(not p.node_name for p in late) or any(
            p.node_name in hot for p in late):
        fail(f"{tag}: BestEffort pods unbound or on pressure nodes")
    evicted_at = {}
    for i, e in enumerate(api._log):
        if e.kind == "Pod" and e.type == "MODIFIED" and \
                e.obj.annotations.get("kubernetes.io/failure-reason") \
                == "Evicted":
            evicted_at.setdefault(e.obj.name, i)
    for i in range(len(run["hot"])):
        be, hog = evicted_at.get(f"be-{i:04d}"), evicted_at.get(
            f"hog-{i:04d}")
        if be is None or hog is None or not be < hog:
            fail(f"{tag}: be-{i:04d} / hog-{i:04d} evicted at {be} / {hog}"
                 f" (BestEffort first)")
    return {"pods": len(pods), "binds": sum(map(len, binds.values())),
            "ss_recreated": len(run["ss_on_dead"]),
            "evicted_pressure": len(evicted_at)}


def node_agents_outcome(k_wire, run):
    """What 14e holds the card against the CPU in, as wire JSON."""
    api = run["api"]
    order, _ = ss_creation_order(api)
    return {
        "pods": sorted(json.dumps(k_wire.encode(p, kind="Pod"),
                                  sort_keys=True)
                       for p in api.list("Pod")[0]),
        "statefulset_order": {s: [n for n, _ in v]
                              for s, v in sorted(order.items())},
        "evicted": sorted(run["on_dead"]),
        "replacements": sorted(run["replaced"].items()),
    }


def node_agents_on_the_card(mods, card):
    """Phase 14: the node agents behind the card's scheduler, 14a-14d in
    one world on the card, then 14e (card == CPU at P14_CHECK). Returns
    (launches of 14a-14d, max abs err per kernel)."""
    import numpy as np
    wire = mods[-1]
    mods = mods[:-1]
    kernels = mods[13]
    t_phase = time.perf_counter()
    err = {k: 0 for k in kernels.LAUNCHES}
    spy = OperandSpy(kernels)
    with spy:
        run = node_agents_world(mods, P14)
    audit = check_node_agents(run, "14", mods[1])
    launches = run["launches"]
    if launches["capacity_fit"] == 0 or launches["incidence_matmul"] == 0:
        fail(f"14: a kernel never launched behind the node agents "
             f"({launches})")
    for k, v in spy.check("14 node agents").items():
        err[k] = max(err[k], v)
    w, lat = run["walls"], run["latency"]
    p50, p90, p99 = (float(np.percentile(lat, q)) for q in (50, 90, 99))
    n = P14["nodes"]
    log(f"14a kubemark density: {n} hollow kubelets registered in "
        f"{w['register']:.3f} s; {P14['pods']} mixed_affinity pods created "
        f"in {w['14a_create']:.3f} s, drain {w['14a_drain']:.3f} s, fleet "
        f"step {w['14a_fleet_step']:.3f} s ({w['14a_fleet_passes']} "
        f"passes), heartbeat_all {w['14a_heartbeat_all']:.3f} s; burst "
        f"create -> Running (host clock) p50 {p50:.3f} s, p90 {p90:.3f} s, "
        f"p99 {p99:.3f} s; "
        f"{len(lat) / w['14a_first_create_to_last_running']:.1f} pods/s "
        f"first create to last Running; store audit (bound, unbound) "
        f"{run['audit_14a']}; after the heartbeats, sync + refresh + "
        f"device sync {json.dumps(run['heartbeat_sync'])}; kubelet "
        f"{run['kubelet']} probed /healthz and /pods: "
        f"{run['probes']['/healthz'][0]}, {run['probes']['/pods'][0]} "
        f"({len(run['served'])} pods) [{card}]")
    ordinals = P14["sets"] * P14["replicas"]
    log(f"14b StatefulSets {P14['sets']} x {P14['replicas']}: "
        f"{run['ss_rounds']} rounds in {w['14b']:.3f} s, "
        f"{w['14b'] / P14['replicas']:.3f} s per ordinal step "
        f"({w['14b'] / ordinals:.3f} s per ordinal of {ordinals})")
    rec = w["14c_first_evict_to_last_replacement_running"]
    log(f"14c node death: ReplicaSet of {P14['rs']} placed in "
        f"{w['14c_fill']:.3f} s; {len(run['dead'])} kubelets stopped "
        f"({P14['dead_per_zone']} per zone); {len(run['on_dead'])} pods on "
        f"them evicted ({len(run['rs_on_dead'])} of the ReplicaSet, each "
        f"replaced once on a live node; {len(run['ss_on_dead'])} StatefulSet "
        f"ordinals, each recreated under its name on a live node) over "
        f"{w['14c_ticks']} ticks of "
        f"{P14_TICK} s in {w['14c']:.3f} s; host time of the recovery "
        f"passes (FakeClock, a pass every {P14_PUMP_EVERY} ticks), first "
        f"eviction to last replacement Running "
        f"{rec if rec is None else round(rec, 3)} s")
    log(f"14d memory pressure: {len(run['pressured'])} kubelets report "
        f"MemoryPressure; {len(run['best_effort'])} BestEffort pods placed "
        f"off them; BestEffort evicted before the hog on each")
    by_tag = {}
    for d in run["drains"]:
        agg = by_tag.setdefault(d["tag"], {"drains": 0})
        agg["drains"] += 1
        for k, v in d.items():
            if k != "tag":
                agg[k] = round(agg.get(k, 0) + v, 3)
    log(f"14 drains by sub-phase, summed (s, pipeline spans in ms, "
        f"counters): {json.dumps(by_tag)}; the first: "
        f"{json.dumps(run['drains'][0])}")
    log(f"14 totals {json.dumps(run['tot'])}; audit {audit}; "
        f"launches {launches}, by shape {spy.launches_by_shape()}; world "
        f"{w['total']:.1f} s [{card}]")
    del run
    # 14e: card == CPU at P14_CHECK
    outs = {}
    for tag, dev in (("card", None), ("CPU", "cpu")):
        t = time.perf_counter()
        r = node_agents_world(mods, P14_CHECK, device=dev)
        check_node_agents(r, f"14e {tag}", mods[1])
        outs[tag] = node_agents_outcome(wire, r)
        log(f"14e {P14_CHECK['nodes']} kubelets on the {tag}: "
            f"{time.perf_counter() - t:.1f} s")
    for key in outs["CPU"]:
        if outs["card"][key] != outs["CPU"][key]:
            fail(f"14e: card != CPU in {key}")
    log(f"14e: card == CPU in {len(outs['CPU']['pods'])} pods (wire JSON), "
        f"{len(outs['CPU']['statefulset_order'])} StatefulSet orders, "
        f"{len(outs['CPU']['evicted'])} evictions and "
        f"{len(outs['CPU']['replacements'])} replacements")
    log(f"phase 14 launches {launches}; phase 14 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, err


# ---------------------------------------------------------------- phase 15

# 15a: the hyperkube entry point in child processes; the scheduler child
# runs the daemon's demo on the card by default (no --device)
P15_SCHED = {"nodes": 5000, "pods": 5000}
# 15b: the cluster in a box at kubemark's scale and the v1.7 cluster limit;
# 15c runs the same script at P15_CHECK on the card and on the CPU
P15 = {"nodes": 5000, "workers": 8, "replicas": 3000, "scaled": 4500}
P15_CHECK = {"nodes": 512, "workers": 8, "replicas": 300, "scaled": 450}
P15_MAX_ROUNDS = 30         # converge rounds a ktctl step may take
P15_IMAGE = "nginx:1.13"
P15_HOST_OUT = "web-v2"     # the hollow runtime's canned `hostname`


def p15_patch(cfg):
    """The strategic-merge patch of the rollout: requests for the one
    container, the tier=web-v2 label, one hollow log and exec handler, a
    required pod anti-affinity on the hostname over tier=web-v2 with a
    preferred one on the zone (spread the tier across zones), and
    apps/v1beta1's default rolling budget (25% surge, 25% unavailable).
    The hostname term is answered per node; the zone term's domain
    product is what reaches the incidence kernel."""
    quarter = cfg["replicas"] // 4
    return {
        "max_surge": quarter, "max_unavailable": quarter,
        "template": {
            "labels": {"tier": "web-v2"},
            "annotations": {"bench/log-lines": "booting\nserving",
                            "bench/exec-hostname": P15_HOST_OUT},
            "containers": [{"name": "web", "requests": {
                "cpu": 100, "memory": 64 << 20}}],
            "affinity": {"pod_anti_affinity": {
                "required_terms": [{
                    "label_selector": {"match_labels": {"tier": "web-v2"}},
                    "topology_key": "kubernetes.io/hostname"}],
                "preferred_terms": [[100, {
                    "label_selector": {"match_labels": {"tier": "web-v2"}},
                    "topology_key":
                        "failure-domain.beta.kubernetes.io/zone"}]]}}}}


def hyperkube_entry(card):
    """15a: `python -m kubernetes_tpu_torch version`, `apiserver --once`
    and `scheduler` (no --device: the card is its default) as child
    processes of this interpreter, started together, the repository on
    PYTHONPATH. Returns {component: seconds from the start to its exit}."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p)
    runs = (("version", ["version"], 120),
            ("apiserver", ["apiserver", "--once", "--nodes", "16"], 120),
            ("scheduler", ["scheduler", "--nodes", str(P15_SCHED["nodes"]),
                           "--pods", str(P15_SCHED["pods"])], 600))
    # the three children start together; each is waited for (and killed
    # at its time limit) before the phase goes on
    t0 = time.perf_counter()
    procs = [(name, args, timeout, subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch", *args], cwd=repo,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name, args, timeout in runs]
    walls, outs = {}, {}

    def stop_all(why):
        for *_, p in procs:
            p.kill()
            p.communicate()
        fail(f"15a: python -m kubernetes_tpu_torch {' '.join(args)} {why}")

    for name, args, timeout, proc in procs:
        try:
            out, err = proc.communicate(
                timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            stop_all(f"ran past {timeout} s")
        walls[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            stop_all(f"exited {proc.returncode}: {err[-800:]}")
        outs[name] = out.strip().splitlines()[-1] if out.strip() else ""
        log(f"15a python -m kubernetes_tpu_torch {' '.join(args)}: "
            f"{outs[name]!r}, done {walls[name]:.3f} s after the three "
            f"children started [{card}]")
    last = outs["scheduler"]
    want = f"bound={P15_SCHED['pods']}/{P15_SCHED['pods']}"
    if want not in last:
        fail(f"15a: the scheduler child printed {last!r}, not {want}")
    return walls


def cli_world(mods, cfg, workdir, device=None, http=False):
    """15b (15c at P15_CHECK): ktadm init, `workers` nodes joining over
    the bootstrap-token flow, the admin registering the rest as hollow
    nodes, a HollowFleet of kubelets, the Deployment and ReplicaSet
    controllers and the Scheduler on `device` over the one store; then
    the user acting only through ktctl: run, patch + rollout status,
    scale, drain, logs, exec (and, with `http`, one `get pods -o json`
    through the hyperkube entry point against a RestServer on the same
    store). Returns a dict of what the checks and the log read."""
    import contextlib
    import io
    import torch
    (ktadm, ktctl, hyperkube, informer, deployment, replicaset, Scheduler,
     kubelet_mod, hollow, apiserver, rest_http, kernels, COUNTERS) = mods
    tag = "15b" if http else f"15c {device or 'card'}"
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    walls = {}
    t = time.perf_counter()
    adm = ktadm.KtAdm(out=io.StringIO())
    cluster = adm.init(os.path.join(workdir, "cluster"))
    api, store = cluster.api, cluster.api.store
    factory = informer.SharedInformerFactory(store)
    fleet = kubelet_mod.HollowFleet(store, factory)
    ca = ktadm.ca_hash(cluster.ca_key)
    for i in range(cfg["workers"]):
        name = f"worker-{i}"
        adm.join(cluster, name, cluster.token, ca_cert_hash=ca)
        fleet.add_node(api.get("Node", "", name, cred=cluster.admin_cred),
                       register=False)
    walls["init_join"] = time.perf_counter() - t
    t = time.perf_counter()
    for node in hollow.hollow_nodes(cfg["nodes"] - cfg["workers"]):
        api.create("Node", node, cred=cluster.admin_cred)
        fleet.add_node(node, register=False)
    walls["register"] = time.perf_counter() - t
    dep_ctl = deployment.DeploymentController(store, factory,
                                              record_events=False)
    rs_ctl = replicaset.ReplicaSetController(store, factory,
                                             record_events=False)
    sched = Scheduler(store, record_events=False, device=device)
    sched.start()
    factory.step_all()
    out = io.StringIO()
    kt = ktctl.Ktctl(api, out=out, cred=cluster.admin_cred,
                     kubelets=fleet.kubelets)

    def run(*argv):
        out.truncate(0)
        out.seek(0)
        rc = kt.run(list(argv))
        if rc != 0:
            fail(f"{tag}: ktctl {' '.join(argv)[:200]} exited {rc}: "
                 f"{out.getvalue()[-400:]}")
        return out.getvalue()

    # a joined node carries no labels; the admin gives each the hostname
    # and zone labels a kubelet sets on itself, which the anti-affinity
    # ranges over
    for i in range(cfg["workers"]):
        run("label", "nodes", f"worker-{i}",
            f"kubernetes.io/hostname=worker-{i}",
            f"failure-domain.beta.kubernetes.io/zone="
            f"{hollow.ZONES[i % len(hollow.ZONES)]}")

    drains, tot = [], {}

    def converge(step):
        """Controllers to quiescence, one drain, one kubelet pass."""
        while factory.step_all() + dep_ctl.pump() + rs_ctl.pump():
            pass
        COUNTERS.reset()
        t = time.perf_counter()
        got = sched.run_until_drained()
        sync()
        snap = COUNTERS.snapshot()
        drains.append({
            "step": step, "s": time.perf_counter() - t,
            "bound": got["bound"],
            **{k: round(1e3 * v, 1) for k, (_, v) in sorted(snap.items())
               if k.startswith("pipeline.") and v > 0}})
        for k, v in got.items():
            tot[k] = tot.get(k, 0) + v
        factory.step_all()
        fleet.step()
        factory.step_all()

    def web():
        return [p for p in store.list("Pod")[0]
                if p.labels.get("run") == "web" and not p.deleted]

    def running(pods):
        return [p for p in pods if p.phase == "Running" and p.node_name]

    def until(step, done):
        for rounds in range(1, P15_MAX_ROUNDS + 1):
            converge(step)
            if done():
                return rounds
        fail(f"{tag}: {step} did not converge in {P15_MAX_ROUNDS} rounds")

    def rs_running():
        """Running pods per ReplicaSet of the Deployment, and which of
        them carries tier=web-v2."""
        count = {}
        for p in running(web()):
            count[p.owner_name] = count.get(p.owner_name, 0) + 1
        rses = [r for r in store.list("ReplicaSet")[0]
                if r.owner_name == "web"]
        new = [r.name for r in rses
               if r.template.labels.get("tier") == "web-v2"]
        return {r.name: count.get(r.name, 0) for r in rses}, new

    rounds = {}
    kernels.reset_launch_counts()
    # ---- run: a Deployment of `replicas`, every pod Running
    t = time.perf_counter()
    run("run", "web", f"--image={P15_IMAGE}",
        f"--replicas={cfg['replicas']}")
    rounds["run"] = until("run", lambda: len(running(web()))
                          == cfg["replicas"])
    walls["run_to_all_running"] = time.perf_counter() - t
    # ---- patch: the template changes, the rollout replaces every pod
    t = time.perf_counter()
    run("patch", "deployment", "web", "-p", json.dumps(p15_patch(cfg)))
    status = []

    def rolled_out():
        status.append(run("rollout", "status", "deployment", "web").strip())
        by_rs, new = rs_running()
        return ("successfully rolled out" in status[-1] and len(new) == 1
                and by_rs[new[0]] == cfg["replicas"]
                and all(n == 0 for r, n in by_rs.items() if r != new[0])
                and len(web()) == cfg["replicas"])

    rounds["rollout"] = until("rollout", rolled_out)
    walls["patch_to_rollout_complete"] = time.perf_counter() - t
    # ---- scale
    t = time.perf_counter()
    run("scale", "deployment", "web", f"--replicas={cfg['scaled']}")
    rounds["scale"] = until("scale", lambda: len(running(web()))
                            == cfg["scaled"] == len(web()))
    walls["scale"] = time.perf_counter() - t
    # ---- drain the node of the first web pod by name
    victim = min(running(web()), key=lambda p: p.name)
    drained, before = victim.node_name, {p.key() for p in web()}
    log_mark = len(store._log)
    t = time.perf_counter()
    drain_text = run("drain", drained)

    def replaced():
        pods = web()
        return (len(running(pods)) == cfg["scaled"] == len(pods)
                and victim.key() not in {p.key() for p in pods})

    rounds["drain"] = until("drain", replaced)
    walls["drain_to_replacement_running"] = time.perf_counter() - t
    new_pods = [p for p in web() if p.key() not in before]
    late_binds = [e.obj.key() for e in store._log[log_mark:]
                  if e.kind == "Pod" and e.obj.node_name == drained
                  and e.type != "DELETED" and e.obj.key() != victim.key()]
    # ---- logs and exec on one pod through the kubelet routing table
    probe_pod = min(running(web()), key=lambda p: p.name)
    logs = run("logs", probe_pod.name, "--tail", "1").strip()
    exec_out = run("exec", probe_pod.name, "--", "hostname").strip()
    wide = run("get", "pods", "-o", "wide")
    in_process = len(running(web()))
    over_http = None
    if http:
        srv = rest_http.RestServer(apiserver.ApiServer(store=store))
        srv.start()
        try:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = hyperkube.main(["ktctl", "--server",
                                     f"http://127.0.0.1:{srv.port}", "get",
                                     "pods", "-o", "json"])
            if rc != 0:
                fail(f"{tag}: ktctl over HTTP exited {rc}")
            over_http = sum(
                1 for d in json.loads(buf.getvalue())
                if d.get("status", d).get("phase") == "Running"
                and d.get("metadata", d).get("labels", {}).get("run")
                == "web")
        finally:
            srv.stop()
    launches = dict(kernels.LAUNCHES)
    return {"api": api, "store": store, "walls": walls, "rounds": rounds,
            "drains": drains, "tot": tot, "launches": launches,
            "status": status, "drained": drained, "victim": victim.key(),
            "drain_text": drain_text, "new_pods": new_pods,
            "late_binds": late_binds, "logs": logs, "exec": exec_out,
            "wide": wide, "in_process": in_process, "over_http": over_http,
            "nodes": cfg["nodes"], "log_len": len(store._log)}


def check_cli_world(run, cfg, tag):
    """15b's gates (15c runs them on both devices)."""
    store = run["store"]
    if run["log_len"] >= store._max_log:
        fail(f"{tag}: the store's log was trimmed; the audits read all "
             "of it")
    pods = store.list("Pod")[0]
    nodes = store.list("Node")[0]
    if len(nodes) != run["nodes"]:
        fail(f"{tag}: {len(nodes)} nodes registered, {run['nodes']} meant")
    audit = audit_store(store, tag, len(pods))
    web = [p for p in pods if p.labels.get("run") == "web"
           and not p.deleted]
    up = [p for p in web if p.phase == "Running" and p.node_name]
    if len(up) != cfg["scaled"] or len(web) != cfg["scaled"]:
        fail(f"{tag}: {len(up)} of {len(web)} web pods Running, "
             f"{cfg['scaled']} wanted")
    per_node = {}
    for p in web:
        if p.labels.get("tier") != "web-v2":
            fail(f"{tag}: {p.key()} is not of the patched template")
        if p.node_name:
            per_node[p.node_name] = per_node.get(p.node_name, 0) + 1
    crowded = {n: c for n, c in per_node.items() if c > 1}
    if crowded:
        fail(f"{tag}: tier=web-v2 pods share {len(crowded)} nodes "
             f"({sorted(crowded.items())[:3]})")
    node = {n.name: n for n in nodes}[run["drained"]]
    if not node.unschedulable:
        fail(f"{tag}: the drained node {run['drained']} is not cordoned")
    if run["late_binds"] or per_node.get(run["drained"]):
        fail(f"{tag}: pods placed on the cordoned node {run['drained']} "
             f"after the drain ({run['late_binds'][:3]})")
    evicted = f"pod/{run['victim'].split('/')[1]} evicted"
    if len(run["new_pods"]) != 1 or run["new_pods"][0].node_name in (
            "", run["drained"]) or evicted not in run["drain_text"]:
        fail(f"{tag}: the drained pod {run['victim']} was replaced by "
             f"{[(p.key(), p.node_name) for p in run['new_pods']]}")
    refused = sorted({e.obj.key() for e in store._log if e.kind == "Pod"
                      and e.obj.annotations.get(
                          "kubernetes.io/failure-reason") in P14_REFUSED})
    if refused:
        fail(f"{tag}: kubelet admission refused {len(refused)} pods "
             f"({refused[:3]})")
    if run["tot"].get("bind_errors"):
        fail(f"{tag}: bind errors {run['tot']}")
    if run["logs"] != "serving" or run["exec"] != P15_HOST_OUT:
        fail(f"{tag}: logs {run['logs']!r}, exec {run['exec']!r}")
    if run["over_http"] is not None and run["over_http"] != \
            run["in_process"]:
        fail(f"{tag}: {run['over_http']} Running over HTTP, "
             f"{run['in_process']} in process")
    return audit


def cli_outcome(run):
    """What 15c holds the card against the CPU in."""
    return {"placements": sorted((p.key(), p.node_name, p.phase)
                                 for p in run["store"].list("Pod")[0]),
            "wide": run["wide"], "rounds": run["rounds"],
            "status": run["status"]}


def command_line_on_the_card(mods, card):
    """Phase 15: the hyperkube entry point (15a), the cluster in a box
    driven through ktctl in front of the card's scheduler (15b), card ==
    CPU (15c). Returns (launches of 15b, max abs err per kernel)."""
    import tempfile
    kernels = mods[11]
    t_phase = time.perf_counter()
    err = {k: 0 for k in kernels.LAUNCHES}
    walls_a = hyperkube_entry(card)
    spy = OperandSpy(kernels)
    with tempfile.TemporaryDirectory() as tmp:
        with spy:
            run = cli_world(mods, P15, tmp, http=True)
    audit = check_cli_world(run, P15, "15b")
    launches = run["launches"]
    if launches["capacity_fit"] == 0 or launches["incidence_matmul"] == 0:
        fail(f"15b: a kernel never launched behind ktctl ({launches})")
    for k, v in spy.check("15b command line").items():
        err[k] = max(err[k], v)
    w = run["walls"]
    log(f"15b cluster in a box: ktadm init + {P15['workers']} joins "
        f"{w['init_join']:.3f} s, {P15['nodes'] - P15['workers']} hollow "
        f"nodes registered by the admin {w['register']:.3f} s; ktctl run "
        f"--replicas={P15['replicas']} to all Running "
        f"{w['run_to_all_running']:.3f} s ({run['rounds']['run']} rounds); "
        f"patch to rollout complete {w['patch_to_rollout_complete']:.3f} s "
        f"({run['rounds']['rollout']} rounds); scale to {P15['scaled']} "
        f"{w['scale']:.3f} s ({run['rounds']['scale']} rounds); drain "
        f"{run['drained']} to replacement Running "
        f"{w['drain_to_replacement_running']:.3f} s "
        f"({run['rounds']['drain']} rounds) [{card}]")
    log(f"15b rollout status lines: {run['status']}")
    log(f"15b logs {run['logs']!r}, exec {run['exec']!r}; get pods -o json "
        f"over HTTP: {run['over_http']} Running web pods, in process "
        f"{run['in_process']}; store audit (bound, unbound) {audit}")
    by_step = {}
    for d in run["drains"]:
        agg = by_step.setdefault(d["step"], {"drains": 0})
        agg["drains"] += 1
        for k, v in d.items():
            if k != "step":
                agg[k] = round(agg.get(k, 0) + v, 3)
    log(f"15b drains by ktctl step, summed (s, pipeline spans in ms): "
        f"{json.dumps(by_step)}")
    log(f"15b totals {json.dumps(run['tot'])}; launches {launches}, by "
        f"shape {spy.launches_by_shape()} [{card}]")
    del run
    outs = {}
    for tag, dev in (("card", None), ("CPU", "cpu")):
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            r = cli_world(mods, P15_CHECK, tmp, device=dev)
        check_cli_world(r, P15_CHECK, f"15c {tag}")
        outs[tag] = cli_outcome(r)
        log(f"15c {P15_CHECK['nodes']} nodes, {P15_CHECK['replicas']} -> "
            f"{P15_CHECK['scaled']} replicas on the {tag}: "
            f"{time.perf_counter() - t:.1f} s")
    for key in outs["CPU"]:
        if outs["card"][key] != outs["CPU"][key]:
            fail(f"15c: card != CPU in {key}")
    log(f"15c: card == CPU in {len(outs['CPU']['placements'])} placements "
        f"and the get pods -o wide text ({len(outs['CPU']['wide'])} chars)")
    log(f"phase 15 launches {launches}; 15a children "
        f"{json.dumps({k: round(v, 3) for k, v in walls_a.items()})} s; "
        f"phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return launches, err


# ---------------------------------------------------------------- phase 16

# 16a: bench.py's arrival headline (bench.py:3606-3624): 20,000 pods/s
# offered into 5,000 density nodes for 3 s, a 250 ms budget, quanta
# 256-16,384; then one window of P16A_TRACED_S at the same rate with the
# flight recorder and podtrace armed
P16A = dict(n_nodes=5000, rate=20000.0, duration_s=3.0, budget_ms=250.0,
            min_quantum=256, max_quantum=16384, profile="density")
P16A_TRACED_S = 1.0
# 16b: bench.py measure_churn as bench's main runs it at the headline
# (bench.py:3797-3812): the churn profile at min(20,000, 5,000) pods/s, a
# quiet leg and a leg under the fault schedule of measure_churn's defaults
# (bench.py:2579-2585). Bench offers max(4, min(10, 40,000 / 5,000)) = 8 s;
# cut to bench's floor of 4 s for the whole run's time (the run took 678.6
# s with 8 s on NVIDIA H100 80GB HBM3, 700.00 W)
P16B = dict(n_nodes=5000, rate=5000.0, duration_s=4.0, budget_ms=250.0,
            min_quantum=256, max_quantum=16384, profile="churn")
P16B_CHURN = dict(seed=11, node_churn_per_min=0.10, bind_fail_rate=0.002,
                  bind_timeout_rate=0.001)
# 16c: measure_rolling_update's defaults (bench.py:3824-3834); its node
# count grows to ceil((replicas + surge + 12 s of background + 64) / 36)
P16C = dict(n_nodes=256, replicas=400, max_surge=40, max_unavailable=40,
            bg_rate=1500.0, diurnal_amp=0.5, diurnal_period_s=3.0,
            budget_ms=250.0)
# 16d: tests/test_churn.py's frozen churn trace (TRACE, _run_trace) scaled
# from 16 nodes to 512 and from groups of 25-48 pods to groups of about
# 500 churn-profile pods, one quantum a step; the faults come one at a
# time, so that the encoding rebuilds a fault of each kind costs can be
# read off the ops up to the next one (16b's rebuild bound).
# By step 12 hollow-node-10 holds an anti-affinity pod and hollow-node-1
# targets but none; "new-class" creates a pod of a shape of its own while
# both are dead, so that the encoding rebuilds without them; the anti
# pod's return then rebuilds, and the targets' return patches their
# node's forbid column.
# "evict-anti" and "evict-plain" evict the first bound pod of that kind;
# "timeout" and "timeout-plain" make the bind of the group's first
# anti-affinity pod, or of its first plain pod labeled like one (a target),
# land but answer with an error (FaultyBindApi's landed timeout): the pod
# comes back on the watch as a foreign bind
P16D_NODES = 512
P16D_TRACE = (
    (473, ()),
    (512, (("kill", "hollow-node-3"),)),
    (389, (("respawn", "hollow-node-3"),)),
    (506, (("cordon", "hollow-node-5"),)),
    (448, (("uncordon", "hollow-node-5"),)),
    (501, (("flap_down", "hollow-node-9"),)),
    (467, (("flap_up", "hollow-node-9"),)),
    (495, (("relabel", "hollow-node-6"),)),
    (430, (("evict-anti", ""),)),
    (512, (("evict-plain", ""),)),
    (477, (("timeout", ""),)),
    (499, (("timeout-plain", ""),)),
    (463, (("kill", "hollow-node-10"), ("kill", "hollow-node-1"),
           ("new-class", ""))),
    (488, (("respawn", "hollow-node-10"),)),
    (452, (("respawn", "hollow-node-1"),)),
)
P16D_QUANTUM = 512
P16_COUNTERS = ("engine.aff_patch_rows", "engine.aff_full_rebuilds",
                "engine.label_patch_rows", "engine.liveness_fence_requeues",
                "stream.degraded_enter", "stream.degraded_exit",
                "engine.wave_dispatch", "engine.tail_rounds",
                "engine.wave_tail_dispatch", "engine.tail_round_dispatch")


def stream_mods():
    """The port's modules phase 16 drives, by name."""
    import types as pytypes
    from kubernetes_tpu_torch.engine.scheduler import Scheduler
    from kubernetes_tpu_torch.models import hollow
    from kubernetes_tpu_torch.observability import podtrace, recorder, slo
    from kubernetes_tpu_torch.ops import kernels, predicates
    from kubernetes_tpu_torch.server import apiserver_lite
    from kubernetes_tpu_torch.testing import churn
    from kubernetes_tpu_torch.utils.trace import COUNTERS
    return pytypes.SimpleNamespace(
        Scheduler=Scheduler, hollow=hollow, podtrace=podtrace,
        recorder=recorder, slo=slo, kernels=kernels,
        predicates=predicates, apiserver_lite=apiserver_lite, churn=churn,
        COUNTERS=COUNTERS)


def interval_series(bind_events, create_log, backlog_samples, interval_s):
    """bench.py interval_series: binds, offered pods and the backlog per
    interval of FULL buckets only; the partial remainder after the last
    full bucket is returned apart as `tail` (binds, offered, backlog,
    width_s), so sum(intervals) + tail["binds"] is every bind."""
    offer_end = create_log[-1][0] if create_log else 0.0
    end = max([t for t, _ in bind_events] + [offer_end]) if bind_events \
        else offer_end
    n_full = int(end / interval_s)
    intervals, offered, backlog = [0] * n_full, [0] * n_full, [0] * n_full
    tail = {"binds": 0, "offered": 0, "backlog": 0,
            "width_s": round(end - n_full * interval_s, 6)}
    for ts, keys in bind_events:
        b = int(ts / interval_s)
        if b < n_full:
            intervals[b] += len(keys)
        else:
            tail["binds"] += len(keys)
    for ts, n in create_log:
        b = int(ts / interval_s)
        if b < n_full:
            offered[b] += n
        else:
            tail["offered"] += n
    for ts, q in backlog_samples:
        b = int(ts / interval_s)
        if b < n_full:
            backlog[b] = q
        else:
            tail["backlog"] = q
    return intervals, offered, backlog, tail


def new_stream(m, api, device, **stream_kw):
    """A started Scheduler over `api` on `device` (None = the card) and
    its always-on loop (Scheduler.stream(**stream_kw)), with the kernels'
    launch counts and the span counters set to 0 once the card's queue
    has drained."""
    if device != "cpu":
        import torch
        torch.cuda.synchronize()
    m.kernels.reset_launch_counts()
    m.COUNTERS.reset()
    sched = m.Scheduler(api, record_events=False, device=device)
    sched.start()
    return sched, sched.stream(**stream_kw)


@contextlib.contextmanager
def stream_window(sched, loop, device, stop, threads):
    """The measured window of a stream: the gc collected, frozen and
    disabled inside it; on the way out the gc restored, `stop` set, the
    loop closed, every thread of `threads` (a list the window may still
    grow) joined, the bind observer dropped and the card's queue
    drained."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()
        stop.set()
        loop.close()
        for th in threads:
            th.join(timeout=10)
        sched.wave_observer = None
    if device != "cpu":
        import torch
        torch.cuda.synchronize()


def first_binds(bind_events):
    """The first bind instant of each pod key in wave_observer's
    (instant, keys) events, and the count of binds past a key's first."""
    first, dup = {}, 0
    for ts, keys in bind_events:
        for k in keys:
            if k in first:
                dup += 1
            else:
                first[k] = ts
    return first, dup


def arrival(m, n_nodes, rate, duration_s, profile="density",
            budget_ms=250.0, min_quantum=256, max_quantum=16384,
            churn_cfg=None, recorder=False, podtrace=False, device=None,
            spy=None):
    """bench.py run_arrival on the port: pods of `profile` created at
    `rate` a second for `duration_s` by a creator thread while the
    always-on loop (Scheduler.stream()) runs on `device` (None = the
    card). Before the window 64 prime pods bind, excluded from every
    number: they prime this scheduler's resident state (the first
    snapshot, the device upload, the class encoding). bench.py's
    _warm_stream_shapes compiles an XLA shape ladder first; eager torch
    compiles nothing, so there is no ladder here. The gc is frozen and
    disabled for the window. Per pod, create->bound joins the creator's
    stamps with the bind instants of Scheduler.wave_observer;
    `sustained_pods_s` is the median bind rate over the full buckets
    inside the offer window, the first dropped as ramp. The creator
    (paced_create) sends bursts of at most about 4 ms of the rate; its
    lag p99 and `creator_jitter_ok` are reported. `churn_cfg` (a
    ChurnConfig) wraps the store in FaultyBindApi and runs
    ChurnInjector's seeded schedule beside the stream; `recorder` and
    `podtrace` arm the flight recorder and the pod tracer with its SLO
    monitor for the window. Returns bench's fields
    plus the store (`api`, the one under any fault proxy), the stopped
    scheduler, counters, launches and the wall."""
    import threading
    import numpy as np
    hollow, churn = m.hollow, m.churn
    total = int(rate * duration_s)
    budget_s = budget_ms / 1e3
    interval_s = min(1.0, max(0.25, round(duration_s / 4.0, 2)))
    max_burst = max(4, int(rate * 0.004))   # paced_create's burst
    base = m.apiserver_lite.ApiServerLite(
        max_log=max(200_000, 3 * (n_nodes + total)))
    nodes = hollow.hollow_nodes(n_nodes)
    hollow.load_cluster(base, nodes, [])
    api, injector = base, None
    if churn_cfg is not None:
        api = churn.FaultyBindApi(base, fail_rate=churn_cfg.bind_fail_rate,
                                  timeout_rate=churn_cfg.bind_timeout_rate,
                                  seed=churn_cfg.seed)
        injector = churn.ChurnInjector(api, churn.make_churn_schedule(
            [n.name for n in nodes], churn_cfg, duration_s))
    pods = hollow.PROFILES[profile](total)
    pod_index = {p.key(): i for i, p in enumerate(pods)}
    seed = m.predicates.bucket(max(min_quantum, min(int(rate * budget_s / 4),
                                                    max_quantum)))
    sched, loop = new_stream(m, api, device, budget_s=budget_s,
                             min_quantum=min_quantum,
                             max_quantum=max_quantum, chunk=seed)
    flight, tracer, slo = m.recorder.RECORDER, m.podtrace.TRACER, m.slo.SLO
    was = (flight.enabled, tracer.enabled, slo.enabled)
    created = [0]
    create_ts = np.full(total, -1.0)
    create_log, bind_events, backlog_samples = [], [], []
    quantum_peak, last_sample = [0], [0.0]
    backlog_at_offer_end = [None]
    agg = {"bind_errors": 0, "fence_requeued": 0, "liveness_requeued": 0,
           "degraded_steps": 0}
    stop = threading.Event()
    threads = []
    with spy if spy is not None else contextlib.nullcontext():
        for p in hollow.PROFILES[profile](min(64, min_quantum)):
            p.name = "prime-" + p.name
            api.create("Pod", p)
        loop.drain()

        def stamp(burst, ts):
            i = created[0]       # paced_create counts the burst after this
            create_ts[i:i + len(burst)] = ts - t0
            create_log.append((ts - t0, len(burst)))

        def backlog():
            inflight = len(loop.inflight.pods) if loop.inflight else 0
            return len(sched.queue) + inflight

        def note(stats, lp):
            now = time.monotonic() - t0
            for k in agg:
                agg[k] += stats.get(k, 0)
            quantum_peak[0] = max(quantum_peak[0], lp.quantum)
            if now - last_sample[0] >= 0.05 or stats["bound"]:
                backlog_samples.append((now, backlog()))
                last_sample[0] = now
            if backlog_at_offer_end[0] is None and created[0] >= total:
                backlog_at_offer_end[0] = backlog()

        def done(stats, lp):
            if created[0] >= total and stats["popped"] == 0 \
                    and lp.settled():
                return True
            if time.monotonic() > deadline:
                fail(f"arrival {profile} {n_nodes} nodes at {rate:g}/s: "
                     f"incomplete after {deadline - t0:.0f} s, created "
                     f"{created[0]}/{total}, bound "
                     f"{sum(len(ks) for _, ks in bind_events)}")
            return False

        try:
            with stream_window(sched, loop, device, stop, threads):
                if recorder:
                    flight.clear()
                    flight.enable()
                else:
                    flight.disable()
                if podtrace:
                    tracer.clear()
                    tracer.enable()
                    slo.clear()
                    slo.enable()
                else:
                    tracer.disable()
                    slo.disable()
                span_t0 = time.perf_counter()  # the span ring's clock
                t0 = time.monotonic()
                deadline = t0 + max(60.0, duration_s * 20) \
                    + (120.0 if injector is not None else 0.0)
                sched.wave_observer = lambda ts, keys: bind_events.append(
                    (ts - t0, keys))
                threads.append(threading.Thread(
                    target=paced_create,
                    args=(api, pods, rate, t0, created, stamp), daemon=True))
                threads[0].start()
                if injector is not None:
                    threads.append(injector.run_thread(stop, t0=t0))
                loop.run(done, on_step=note)
        finally:
            flight.enabled, tracer.enabled, slo.enabled = was
    wall = time.monotonic() - t0
    launches = dict(m.kernels.LAUNCHES)
    snap = m.COUNTERS.snapshot()
    counters = {k: snap.get(k, (0, 0.0))[0] for k in P16_COUNTERS}
    lat = np.full(total, -1.0)
    first, duplicate_binds = first_binds(bind_events)
    for k, ts in first.items():
        i = pod_index.get(k)
        if i is not None and create_ts[i] >= 0:
            lat[i] = ts - create_ts[i]
    bound = int((lat >= 0).sum())
    lat = lat[lat >= 0]
    if injector is not None:
        # store truth: a landed-but-timed-out bind never reached the
        # observer; it is bound, without a latency sample
        state = {p.key(): bool(p.node_name) for p in base.list("Pod")[0]}
        bound = sum(1 for p in pods if state.get(p.key(), True))
    offer_end = create_log[-1][0] if create_log else 0.0
    intervals, offered_series, backlog_series, tail_partial = \
        interval_series(bind_events, create_log, backlog_samples,
                        interval_s)
    k_end = int(offer_end / interval_s)
    steady = intervals[1:k_end] if k_end > 1 else intervals[:max(k_end, 1)]
    sustained = (sorted(steady)[len(steady) // 2] / interval_s) if steady \
        else 0.0
    lags = [ts - n_done / rate for (ts, _), n_done in
            zip(create_log, np.cumsum([n for _, n in create_log]))]
    lag_p99_ms = float(np.percentile(lags, 99) * 1e3) if lags else 0.0
    realized = total / offer_end if offer_end > 0 else 0.0
    lag_bound_ms = max(2e3 * max_burst / rate, 100.0)
    out = {
        "intervals": [int(v) for v in intervals], "interval_s": interval_s,
        "offered_series": [int(v) for v in offered_series],
        "backlog_series": [int(v) for v in backlog_series],
        "tail_partial": tail_partial,
        "offered_pods_s": float(rate),
        "offered_realized_pods_s": round(realized, 1),
        "sustained_pods_s": round(float(sustained), 1),
        "p50_ms": float(np.percentile(lat, 50) * 1e3) if lat.size else None,
        "p99_ms": float(np.percentile(lat, 99) * 1e3) if lat.size else None,
        "bound": int(bound), "unbound": total - int(bound),
        "backlog_at_offer_end": int(backlog_at_offer_end[0] or 0),
        "budget_ms": float(budget_ms), "quantum_peak": int(quantum_peak[0]),
        "creator_max_burst": int(max_burst),
        "creator_lag_p99_ms": round(lag_p99_ms, 3),
        "creator_lag_bound_ms": round(lag_bound_ms, 3),
        "creator_jitter_ok": bool(lag_p99_ms <= lag_bound_ms
                                  and realized >= 0.95 * rate),
        "duplicate_binds": int(duplicate_binds), **agg,
        "counters": counters, "launches": launches,
        "wall_s": round(wall, 3), "api": base, "sched": sched,
        "offered": pods}
    if recorder:
        # the waves' dispatch, device block and bind write are span
        # records, always on; the recorder holds the rarer typed events
        out["span_records"] = len(m.COUNTERS.spans(span_t0))
        out["recorder_events"] = int(flight.stats()["events"])
        out["recorder_dropped"] = int(flight.stats()["dropped"])
    if podtrace:
        out["podtrace"] = tail_exemplars(tracer.snapshot(), m.podtrace)
        out["slo"] = slo.snapshot()
    if injector is not None:
        out.update({
            "churn_ops_applied": dict(injector.applied),
            "churn_ops_noop": int(injector.noop),
            "injected_bind_failures": int(api.injected_failures),
            "injected_bind_timeouts": int(api.injected_timeouts)})
    return out


def tail_exemplars(psnap, podtrace):
    """bench.py run_arrival's podtrace report: one exemplar per (wave,
    phase sequence), the slowest of its group, each with its phase
    attribution and whether the phases telescope to its create->bound
    span (`attribution_exact`). The wave is read from the event named
    podtrace.KIND_NAMES[WAVE_DISPATCHED]; bench.py compares the kind with
    the upper-case constant name, which no event carries, so its groups
    ignore the wave."""
    dispatched = podtrace.KIND_NAMES[podtrace.WAVE_DISPATCHED]
    exemplars, seen = [], {}
    for ex in psnap["exemplars"]:
        ssum = sum(ex["phases_ms"].values())
        wave = next((e["a"] for e in ex["events"]
                     if e["kind"] == dispatched), None)
        sig = (wave, tuple(e["kind"] for e in ex["events"]))
        if sig in seen:
            g = seen[sig]
            g["multiplicity"] += 1
            g["span_ms_range"][0] = min(g["span_ms_range"][0], ex["span_ms"])
            g["span_ms_range"][1] = max(g["span_ms_range"][1], ex["span_ms"])
            continue
        seen[sig] = row = {
            "key": ex["key"], "wave": wave,
            "create_to_bound_ms": ex["span_ms"],
            "phases_ms": ex["phases_ms"], "phase_sum_ms": round(ssum, 6),
            "attribution_exact": bool(abs(ssum - ex["span_ms"]) < 1e-3),
            "events": [e["kind"] for e in ex["events"]],
            "multiplicity": 1,
            "span_ms_range": [ex["span_ms"], ex["span_ms"]]}
        exemplars.append(row)
    return {"stats": psnap["stats"], "phases": psnap["phases"],
            "tail_exemplars": exemplars,
            "tail_exemplars_raw": len(psnap["exemplars"])}


def audit_stream(m, api, sched, tag, profile):
    """The gates of one stream after it settled: every pod in the store
    bound (the offered ones less any a churn op evicted), no node over
    its CPU, memory or pod count, no pod bound twice in one life, the
    store's transitions one bind per pod (audit_store_transitions), the
    scheduler's cache equal to the store (audit_cache_vs_store), and for
    the churn profile one anti-affinity pod of an app per host with no
    other pod of that app beside it. Returns the bound count."""
    pods = api.list("Pod")[0]
    nodes = {n.name: n for n in api.list("Node")[0]}
    unbound = [p.key() for p in pods if not p.node_name]
    if unbound:
        fail(f"{tag}: {len(unbound)} pods left unbound, e.g. {unbound[:3]}")
    used = {}
    for p in pods:
        r = p.resource_request()
        u = used.setdefault(p.node_name, [0, 0, 0])
        u[0] += r.milli_cpu
        u[1] += r.memory
        u[2] += 1
    for name, u in used.items():
        nd = nodes.get(name)
        if nd is not None and (u[0] > nd.allocatable.milli_cpu
                               or u[1] > nd.allocatable.memory
                               or u[2] > nd.allowed_pod_number):
            fail(f"{tag}: node {name} over allocatable: {u}")
    dups = [k for k, v in store_binds(api).items() if len(v) > 1]
    trans = m.churn.audit_store_transitions(api)
    multi = [k for k, c in trans["binds"].items() if c != 1]
    ghosts = m.churn.audit_cache_vs_store(sched, api)
    if dups or multi or ghosts:
        fail(f"{tag}: pods bound twice in one life {dups[:3]}, store "
             f"transitions {multi[:3]}, cache vs store {ghosts[:3]}")
    if profile == "churn":
        anti, labeled = {}, {}
        for p in pods:
            key = (p.node_name, p.labels.get("app", ""))
            labeled[key] = labeled.get(key, 0) + 1
            if p.affinity is not None \
                    and p.affinity.pod_anti_affinity is not None:
                anti[key] = anti.get(key, 0) + 1
        bad = [k for k, c in anti.items() if c > 1 or labeled[k] > 1]
        if bad:
            fail(f"{tag}: anti-affinity broken on {len(bad)} (host, app) "
                 f"pairs, e.g. {sorted(bad)[:3]}")
    return len(pods)


def report_arrival(tag, r, card):
    log(f"{tag}: offered {r['offered_pods_s']:g} pods/s (realized "
        f"{r['offered_realized_pods_s']}), sustained "
        f"{r['sustained_pods_s']} pods/s, create->bound p50 "
        f"{r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms, bound "
        f"{r['bound']}/{r['bound'] + r['unbound']}, backlog at offer end "
        f"{r['backlog_at_offer_end']}, quantum peak {r['quantum_peak']}, "
        f"creator lag p99 {r['creator_lag_p99_ms']} ms (bound "
        f"{r['creator_lag_bound_ms']}), jitter_ok {r['creator_jitter_ok']}, "
        f"intervals {r['intervals']} of {r['interval_s']} s (tail "
        f"{r['tail_partial']}), bind errors {r['bind_errors']}, fence "
        f"requeued {r['fence_requeued']}, liveness requeued "
        f"{r['liveness_requeued']}, degraded steps {r['degraded_steps']}, "
        f"counters {r['counters']}, launches {r['launches']}, wall "
        f"{r['wall_s']} s [{card}]")
    if not r["creator_jitter_ok"]:
        log(f"{tag}: the creator fell behind its schedule (jitter_ok "
            f"False): the rates above are not to be read; the gates hold")


def rolling_update(m, cfg, device=None, spy=None):
    """bench.py measure_rolling_update on the port: `replicas` old-
    revision web pods bound through Scheduler.stream(), then
    RollingUpdateDriver replaces them under max_surge and max_unavailable
    while a diurnal background stream of density pods rides the same
    loop. No shape ladder (nothing to compile). Returns bench's fields
    plus counters and launches; fails on a duplicate bind, a replacement
    bound other than once, a ghost in the cache, or a bound broken."""
    import threading
    import numpy as np
    from kubernetes_tpu_torch.api.types import make_pod
    hollow, churn = m.hollow, m.churn
    replicas = cfg["replicas"]
    bg_cap = int(cfg["bg_rate"] * 12.0)
    need = replicas + cfg["max_surge"] + bg_cap + 64
    n_nodes = max(cfg["n_nodes"], -(-need // 36))
    api = m.apiserver_lite.ApiServerLite(
        max_log=max(400_000, 6 * (n_nodes + need)))
    hollow.load_cluster(api, hollow.hollow_nodes(n_nodes), [])
    sched, loop = new_stream(m, api, device, budget_s=cfg["budget_ms"] / 1e3,
                             min_quantum=64, max_quantum=256)

    def web_pod(rev, i):
        return make_pod(f"web-{rev}-{i:05d}", cpu=100, memory=128 << 20,
                        labels={"app": "web", "rev": rev})

    bind_events = []
    bg_created = [0]
    stop = threading.Event()
    with spy if spy is not None else contextlib.nullcontext():
        for i in range(replicas):
            api.create("Pod", web_pod("1", i))
        loop.drain()
        old = sum(1 for p in api.list("Pod")[0]
                  if p.labels.get("rev") == "1" and p.node_name)
        if old != replicas:
            fail(f"16c: {old}/{replicas} old-revision pods bound")
        sched.wave_observer = lambda ts, keys: bind_events.append((ts, keys))
        driver = churn.RollingUpdateDriver(api, churn.RollingUpdateConfig(
            replicas=replicas, max_surge=cfg["max_surge"],
            max_unavailable=cfg["max_unavailable"]),
            lambda i: web_pod("2", i))
        rate_fn = churn.diurnal_rate(cfg["bg_rate"], amp=cfg["diurnal_amp"],
                                     period_s=cfg["diurnal_period_s"])
        bg_pods = hollow.PROFILES["density"](bg_cap)
        for p in bg_pods:
            p.name = "bgload-" + p.name
        t0 = time.monotonic()

        def bg_creator():
            due_f, last = 0.0, time.monotonic()
            while not stop.is_set() and bg_created[0] < len(bg_pods):
                now = time.monotonic()
                due_f += rate_fn(now - t0) * (now - last)
                last = now
                due = min(int(due_f), len(bg_pods))
                while bg_created[0] < due:
                    api.create("Pod", bg_pods[bg_created[0]])
                    bg_created[0] += 1
                stop.wait(0.002)

        bg_thread = threading.Thread(target=bg_creator, daemon=True)
        deadline = t0 + 120.0

        def done(stats, lp):
            if driver.completed_at is not None:
                stop.set()
                if stats["popped"] == 0 and lp.settled() \
                        and not bg_thread.is_alive():
                    return True
            if time.monotonic() > deadline:
                fail(f"16c: rolling update incomplete after 120 s: "
                     f"{driver.bounds_report()}")
            return False

        threads = [bg_thread]
        with stream_window(sched, loop, device, stop, threads):
            bg_thread.start()
            threads.append(driver.run_thread(stop, poll_s=0.005))
            loop.run(done)
            loop.drain()
    launches = dict(m.kernels.LAUNCHES)
    repl_keys = set(driver.replacement_keys)
    first, dup = first_binds(bind_events)
    repl_first = {k: ts for k, ts in first.items() if k in repl_keys}
    lat = [ts - driver.create_ts[k] for k, ts in repl_first.items()]
    last_bind = max(repl_first.values(), default=t0)
    bounds = driver.bounds_report()
    trans = churn.audit_store_transitions(api)
    multi = sum(1 for k in repl_keys if trans["binds"].get(k, 0) != 1)
    ghosts = churn.audit_cache_vs_store(sched, api)
    if dup or multi or ghosts or not bounds["surge_respected"] \
            or not bounds["unavailable_respected"] \
            or bounds["created"] != replicas or bounds["evicted"] != replicas:
        fail(f"16c: duplicate binds {dup}, replacements bound other than "
             f"once {multi}, cache vs store {ghosts[:3]}, bounds {bounds}")
    audit_stream(m, api, sched, "16c", "density")
    lat_a = np.asarray(lat)
    return {
        "nodes": n_nodes,
        "completion_s": round((driver.completed_at or last_bind)
                              - driver.started_at, 3),
        "replacement_p50_ms": round(float(np.percentile(lat_a, 50)) * 1e3,
                                    3),
        "replacement_p99_ms": round(float(np.percentile(lat_a, 99)) * 1e3,
                                    3),
        "replacements_bound": len(lat), "bounds": bounds,
        "bg_created": bg_created[0], "duplicate_binds": dup,
        "launches": launches}


class LandedTimeout:
    """A store proxy whose bulk binds land, except that the bind of each
    pod named by `arm(key)` answers with an error after it landed: one
    of FaultyBindApi's landed timeouts, placed on a chosen pod."""

    def __init__(self, api):
        self._api = api
        self.armed = set()
        self.injected = 0

    def __getattr__(self, name):
        return getattr(self._api, name)

    def arm(self, key):
        self.armed.add(key)

    def _mark(self, keys, out):
        out = list(out)
        for i, k in enumerate(keys):
            if k in self.armed and out[i] is None:
                out[i] = "injected: bind timeout"
                self.injected += 1
                self.armed.discard(k)
        return out

    def bind_pods_bulk(self, pods):
        keys = [p.key() for p in pods]
        return self._mark(keys, self._api.bind_pods_bulk(pods))

    def bind_many(self, bindings):
        keys = [f"{b.pod_namespace}/{b.pod_name}" for b in bindings]
        return self._mark(keys, self._api.bind_many(bindings))


def resident_check(eng, dev, width, tag, in_dispatch):
    """The resident device arrays a sync just left behind (`dev`, before
    any kernel reads them) equal a fresh upload of a full rewrite of the
    snapshot: a copy of it with every row rewritten from the cache's
    NodeInfos as they stand. Dispatch runs on the calling thread and
    nothing mutates the cache between its refresh and its sync, so these
    are the infos the sync was made from. In a wave dispatch, which
    flushes the cached encoding's patches before its sync, that
    encoding's affinity tensors on the device equal its host views, and
    those equal the views derived afresh from the snapshot's labels.
    Returns the arrays compared."""
    import copy
    import numpy as np
    import torch
    from kubernetes_tpu_torch.analysis.sanitize import upload_copied
    from kubernetes_tpu_torch.engine.scheduler_engine import _aff_node_views
    infos = eng.cache.snapshot_infos()
    # the copy forgets every row's generation, so that its refresh
    # rewrites every row from the cache under the same vocabularies
    snap = eng.snapshot
    fresh = copy.deepcopy(snap, {id(snap._generations): {}})
    fresh.refresh(infos, volume_ctx=eng.volume_ctx)
    n = 0
    for k, t in sorted(dev.items()):
        host = fresh.port_bitmap[:, :width] if k == "port_bitmap" \
            else getattr(fresh, k)
        want = upload_copied(host, torch.device("cpu"))
        if t.shape != want.shape or t.dtype != want.dtype \
                or not torch.equal(t.cpu(), want):
            fail(f"{tag}: resident {k} != a fresh upload of the snapshot")
        n += 1
    enc = eng._wave_enc
    if in_dispatch and enc is not None and enc.aff_wave_dev is not None:
        if enc.aff_patch_dirty or enc.labels_gen != snap.labels_gen:
            fail(f"{tag}: a dispatch synced with its encoding's patches "
                 f"unflushed or its labels stale")
        key_node, sfh = _aff_node_views(enc.adata, *snap.label_nonzeros(),
                                        snap.labels.shape[0])
        merged = sfh.astype(np.int32)
        if enc.foreign_forbid is not None:
            merged = merged + enc.foreign_forbid
        merged = np.minimum(merged, 127).astype(np.int8)
        for k, want in (("key_node", key_node), ("static_forbid", merged)):
            got = enc.aff_wave_dev[k].cpu().numpy()
            if got.shape != want.shape or not np.array_equal(got, want):
                fail(f"{tag}: resident affinity {k} != its fresh view")
            n += 1
    return n


def watch_resident(eng, tally):
    """Wrap the engine's host-to-device sync so that every sync is held to
    resident_check right after it, before the kernels read the tensors,
    and its wave dispatch so that the check knows it runs inside one.
    `tally` = [tag, syncs, arrays]: the caller sets the tag per step; the
    counts accumulate."""
    sync, dispatch = eng._nodes_on_device, eng.dispatch_waves
    inside = [False]

    def checked(port_words=1):
        dev = sync(port_words=port_words)
        tally[1] += 1
        tally[2] += resident_check(eng, dev, port_words, tally[0],
                                   inside[0])
        return dev

    def dispatching(*args, **kw):
        inside[0] = True
        try:
            return dispatch(*args, **kw)
        finally:
            inside[0] = False
    eng._nodes_on_device = checked
    eng.dispatch_waves = dispatching


def churn_trace(m, device, streaming, clock_cls):
    """16d: P16D_TRACE through Scheduler.stream() (`streaming`) or the
    fixed-chunk pipeline, one quantum a step, on a FakeClock: before each
    step its fault is applied (ChurnInjector for node and eviction ops,
    LandedTimeout for the timeout), then its group of churn-profile pods
    is created, then one step; every host-to-device sync of a dispatch,
    the drain's too, is checked against a fresh upload (watch_resident)
    before the kernels read it. The drain jumps the clock past the
    backoff as tests/test_churn.py's _run_trace does. Returns
    (placements, encoding rebuilds per fault kind and ops applied,
    arrays checked, the patch and liveness-fence counters); fails unless
    the affinity-row patch, the label-row patch and the liveness fence
    each ran and both landed timeouts were injected."""
    from kubernetes_tpu_torch.api.types import make_pod
    clock = clock_cls()
    base = m.apiserver_lite.ApiServerLite()
    m.hollow.load_cluster(base, m.hollow.hollow_nodes(P16D_NODES), [])
    api = LandedTimeout(base)
    sched = m.Scheduler(api, record_events=False, device=device, now=clock)
    sched.start()
    if streaming:
        loop = sched.stream(budget_s=30.0, min_quantum=P16D_QUANTUM,
                            max_quantum=P16D_QUANTUM)
    else:
        loop = sched.pipeline(chunk=P16D_QUANTUM)
    injector = m.churn.ChurnInjector(api, [])
    pool = m.hollow.PROFILES["churn"](sum(g for g, _ in P16D_TRACE))
    # one pod selecting a zone interns the zone labels, so that a relabel
    # takes the label-row patch (as tests/test_churn.py's relabel case)
    sel = make_pod("p16d-zone-selector", cpu=100, memory=128 << 20)
    sel.node_selector = {m.hollow.ZONE_KEY: "zone-a"}
    pool.insert(1, sel)
    # a pod of a class of its own ("new-class"): its first dispatch
    # rebuilds the encoding
    odd = make_pod("p16d-new-class", cpu=250, memory=128 << 20)
    m.COUNTERS.reset()
    marks, at = [], 0
    tally = ["16d warm", 0, 0]
    watch_resident(sched.engine, tally)

    def rebuilt():
        return m.COUNTERS.snapshot().get("engine.aff_full_rebuilds",
                                         (0, 0.0))[0]

    for gi, (group, ops) in enumerate(P16D_TRACE):
        tally[0] = f"16d step {gi}"
        for kind, node in ops:
            marks.append((kind, rebuilt()))
            if kind == "new-class":
                api.create("Pod", odd)
                continue
            if kind.startswith("timeout"):
                want_anti = kind == "timeout"
                pick = next(p for p in pool[at:at + group]
                            if (p.affinity is not None) == want_anti
                            and (want_anti or p.name.startswith("churn-tgt")))
                api.arm(pick.key())
                continue
            if kind.startswith("evict"):
                bound = [p for p in base.list("Pod")[0] if p.node_name]
                want_anti = kind == "evict-anti"
                slot = next(i for i, p in enumerate(bound)
                            if (p.affinity is not None) == want_anti
                            and (want_anti or p.name.startswith("churn-tgt")))
                op = m.churn.ChurnOp(0.0, "evict", evict_slot=slot)
            elif kind == "relabel":
                op = m.churn.ChurnOp(0.0, kind, node=node, zone="zone-b")
            else:
                op = m.churn.ChurnOp(0.0, kind, node=node)
            injector.schedule = [op]
            injector._next = 0
            injector.apply_until(0.0)
        for p in pool[at:at + group]:
            api.create("Pod", p)
        at += group
        loop.step()
    if tally[1] < len(P16D_TRACE):
        fail(f"16d: {tally[1]} device syncs in {len(P16D_TRACE)} steps")
    tally[0] = "16d drain"
    clock.t += 120.0
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        loop.step()
        if loop.settled():
            break
        clock.t += 120.0
        sched.sync(wait=0.02)
    if not loop.settled():
        fail(f"16d: the trace did not settle ({device or 'card'}, "
             f"streaming {streaming})")
    loop.close()
    checked = tally[2]
    # a fault's cost: the rebuilds from its application to the next
    # fault's (the last one's through the drain), since a landed timeout
    # returns on the watch steps later; "warm" is the build before any
    rebuilds = {"warm": marks[0][1]}
    marks.append(("end", rebuilt()))
    for (kind, r0), (_k, r1) in zip(marks, marks[1:]):
        rebuilds[kind] = max(rebuilds.get(kind, 0), r1 - r0)
    audit_stream(m, base, sched, f"16d ({device or 'card'}, streaming "
                 f"{streaming})", "churn")
    if injector.noop:
        fail(f"16d: {injector.noop} trace ops found nothing to act on")
    snap = m.COUNTERS.snapshot()
    patches = {k: snap.get(k, (0, 0.0))[0] for k in (
        "engine.aff_patch_rows", "engine.label_patch_rows",
        "engine.liveness_fence_requeues")}
    if not all(patches.values()) or api.injected != 2:
        fail(f"16d ({device or 'card'}, streaming {streaming}): a patch or "
             f"fence path was not reached: {patches}, landed timeouts "
             f"{api.injected}")
    out = {p.key(): p.node_name for p in base.list("Pod")[0]}
    sched.engine.close()
    return out, rebuilds, checked, patches


def rebuild_bound(quiet, churned, per_kind):
    """16b's rebuild bound: the churn leg's encoding rebuilds may exceed
    the quiet leg's only by what its faults cost, each fault at the most
    16d's CPU run paid for one of its kind; plain foreign binds and
    evictions (the patch rows) are not in the bound. Returns (bound,
    the faults counted by kind)."""
    faults = dict(churned["churn_ops_applied"])
    faults["timeout"] = churned["injected_bind_timeouts"]
    bound = quiet["counters"]["engine.aff_full_rebuilds"]
    for k, n in faults.items():
        c = max(per_kind.get(k, 0), per_kind.get(f"{k}-anti", 0),
                per_kind.get(f"{k}-plain", 0))
        bound += c * n
    return bound, faults


def arrival_on_the_card(m, card, clock_cls):
    """Phase 16: the always-on arrival stream on the card. Returns
    (launches of 16a-16c, max abs err per kernel)."""
    import collections
    import threading
    t_phase = time.perf_counter()
    # threads left by earlier phases share the interpreter lock with the
    # stream (each of ktadm's join informers used to poll its store's
    # event log every 50 ms for good)
    alive = collections.Counter(t.name for t in threading.enumerate())
    log(f"phase 16 starts with {sum(alive.values())} threads: "
        f"{dict(alive)}")
    spy = OperandSpy(m.kernels)
    launches = {k: 0 for k in m.kernels.LAUNCHES}

    def add(got):
        for k, v in got.items():
            launches[k] += v

    walls = {}
    t_sub = time.perf_counter()
    # 16a: the headline stream, then a traced window at the same rate
    r = arrival(m, spy=spy, **P16A)
    audit_stream(m, r["api"], r["sched"], "16a", "density")
    if r["duplicate_binds"] or r["unbound"] or not r["p50_ms"] \
            or r["p50_ms"] == r["p99_ms"]:
        fail(f"16a: duplicate binds {r['duplicate_binds']}, unbound "
             f"{r['unbound']}, p50 {r['p50_ms']} p99 {r['p99_ms']}")
    report_arrival("16a headline", r, card)
    add(r["launches"])
    r["sched"].engine.close()
    t = arrival(m, spy=spy, recorder=True, podtrace=True,
                **dict(P16A, duration_s=P16A_TRACED_S))
    audit_stream(m, t["api"], t["sched"], "16a traced", "density")
    ex = t["podtrace"]["tail_exemplars"]
    if not ex or not all(e["attribution_exact"] for e in ex) \
            or t["duplicate_binds"] or t["unbound"]:
        fail(f"16a traced: exemplars {len(ex)}, inexact "
             f"{[e['key'] for e in ex if not e['attribution_exact']][:3]}, "
             f"duplicate binds {t['duplicate_binds']}, unbound "
             f"{t['unbound']}")
    report_arrival("16a traced (recorder + podtrace)", t, card)
    raw = t["podtrace"]["tail_exemplars_raw"]
    log(f"16a traced: {len(ex)} tail exemplars ({raw} raw), every "
        f"attribution exact; slowest "
        f"{ex[0]['create_to_bound_ms']} ms = "
        f"{json.dumps(ex[0]['phases_ms'])}; span records "
        f"{t['span_records']}, recorder events "
        f"{t['recorder_events']} (dropped {t['recorder_dropped']}); SLO "
        f"{json.dumps(t['slo'].get('objectives', t['slo']))[:300]}")
    add(t["launches"])
    t["sched"].engine.close()

    walls["16a"] = time.perf_counter() - t_sub
    t_sub = time.perf_counter()
    # 16b: churn, a quiet leg and a leg under the seeded faults
    quiet = arrival(m, spy=spy, **P16B)
    audit_stream(m, quiet["api"], quiet["sched"], "16b quiet", "churn")
    report_arrival("16b quiet", quiet, card)
    add(quiet["launches"])
    quiet["sched"].engine.close()
    churned = arrival(m, spy=spy, churn_cfg=m.churn.ChurnConfig(
        **P16B_CHURN), **P16B)
    audit_stream(m, churned["api"], churned["sched"], "16b churn", "churn")
    report_arrival("16b churn", churned, card)
    add(churned["launches"])
    churned["sched"].engine.close()
    if quiet["duplicate_binds"] or churned["duplicate_binds"]:
        fail(f"16b: duplicate binds quiet {quiet['duplicate_binds']} "
             f"churn {churned['duplicate_binds']}")
    c = churned["counters"]
    fields = {
        "churn_offered_pods_s": P16B["rate"],
        "churn_quiet_sustained_pods_s": quiet["sustained_pods_s"],
        "churn_sustained_pods_s": churned["sustained_pods_s"],
        "churn_vs_quiet": round(churned["sustained_pods_s"]
                                / quiet["sustained_pods_s"], 3)
        if quiet["sustained_pods_s"] else 0.0,
        "churn_p99_create_to_bound_ms": round(churned["p99_ms"], 3),
        "churn_bound": churned["bound"], "churn_unbound": churned["unbound"],
        "churn_bind_errors": churned["bind_errors"],
        "churn_injected_bind_failures": churned["injected_bind_failures"],
        "churn_injected_bind_timeouts": churned["injected_bind_timeouts"],
        "churn_duplicate_binds": churned["duplicate_binds"],
        "churn_ops_applied": churned["churn_ops_applied"],
        "churn_ops_noop": churned["churn_ops_noop"],
        "churn_liveness_requeued": churned["liveness_requeued"],
        "churn_fence_requeued": churned["fence_requeued"],
        "churn_degraded_steps": churned["degraded_steps"],
        "churn_aff_patch_rows": c["engine.aff_patch_rows"],
        "churn_aff_full_rebuilds": c["engine.aff_full_rebuilds"],
        "churn_label_patch_rows": c["engine.label_patch_rows"],
        "churn_liveness_fence_requeues": c["engine.liveness_fence_requeues"],
        "churn_degraded_enter": c["stream.degraded_enter"],
        "churn_degraded_exit": c["stream.degraded_exit"],
        "quiet_aff_full_rebuilds": quiet["counters"][
            "engine.aff_full_rebuilds"]}
    log("16b churn fields: " + json.dumps(fields) + f" [{card}]")
    if c["stream.degraded_enter"] > c["stream.degraded_exit"]:
        fail(f"16b: the loop entered degraded mode "
             f"{c['stream.degraded_enter']} times and left it "
             f"{c['stream.degraded_exit']}")

    walls["16b"] = time.perf_counter() - t_sub
    t_sub = time.perf_counter()
    # 16c: the rolling update
    ru = rolling_update(m, P16C, spy=spy)
    add(ru["launches"])
    log(f"16c rolling update at {ru['nodes']} nodes: completion "
        f"{ru['completion_s']} s, replacement create->bound p50 "
        f"{ru['replacement_p50_ms']} ms p99 {ru['replacement_p99_ms']} ms, "
        f"{ru['replacements_bound']} replacements, bounds "
        f"{json.dumps(ru['bounds'])}, background pods {ru['bg_created']}, "
        f"launches {ru['launches']} [{card}]")
    walls["16c"] = time.perf_counter() - t_sub
    err = spy.check("phase 16")
    if launches["capacity_fit"] == 0:
        fail("phase 16 never launched the capacity kernel")

    # 16d: card == CPU on the frozen churn trace
    t_sub = time.perf_counter()
    runs = {}
    for tag, dev, streaming in (("card stream", None, True),
                                ("card pipeline", None, False),
                                ("CPU stream", "cpu", True)):
        runs[tag] = churn_trace(m, dev, streaming, clock_cls)
    want = runs["CPU stream"][0]
    for tag in ("card stream", "card pipeline"):
        got = runs[tag][0]
        diff = {k: (got.get(k), v) for k, v in want.items()
                if got.get(k) != v}
        if diff or set(got) != set(want):
            fail(f"16d: the {tag} placements differ from the CPU stream's "
                 f"in {len(diff)} pods, e.g. {list(diff.items())[:3]}")
    per_kind = runs["CPU stream"][1]
    log(f"16d: card stream == card pipeline == CPU stream in {len(want)} "
        f"placements; resident arrays equal a fresh upload at every sync "
        f"({runs['card stream'][2]} arrays checked on the card stream; "
        f"patch and fence counters {json.dumps(runs['card stream'][3])}); "
        f"encoding rebuilds per fault on the CPU {json.dumps(per_kind)}")
    walls["16d"] = time.perf_counter() - t_sub
    bound, faults = rebuild_bound(quiet, churned, per_kind)
    if c["engine.aff_full_rebuilds"] > bound:
        fail(f"16b: {c['engine.aff_full_rebuilds']} encoding rebuilds under "
             f"churn, past the bound {bound} (quiet "
             f"{quiet['counters']['engine.aff_full_rebuilds']} + faults "
             f"{faults} at 16d's cost per kind)")
    log(f"16b: {c['engine.aff_full_rebuilds']} encoding rebuilds under "
        f"churn within the bound {bound} (quiet "
        f"{quiet['counters']['engine.aff_full_rebuilds']} + faults "
        f"{json.dumps(faults)} at 16d's cost per kind), "
        f"{c['engine.aff_patch_rows']} patch rows")
    log(f"phase 16 launches {launches}; walls (s) "
        f"{json.dumps({k: round(v, 1) for k, v in walls.items()})}; phase "
        f"16 took {time.perf_counter() - t_phase:.1f} s")
    return launches, err


def table_cases(mod):
    """(name, body, kwargs) for every case of the test bodies of `mod`:
    each test function once per combination of its parametrize marks."""
    import inspect
    import itertools
    for name, fn in vars(mod).items():
        if not name.startswith("test_") or not inspect.isfunction(fn):
            continue
        grids = []
        for mark in getattr(fn, "pytestmark", []):
            if mark.name != "parametrize":
                continue
            names = [a.strip() for a in mark.args[0].split(",")]
            grids.append([dict(zip(names, v if len(names) > 1 else (v,)))
                          for v in mark.args[1]])
        for combo in itertools.product(*grids):
            kw = {}
            for part in combo:
                kw.update(part)
            extra = set(inspect.signature(fn).parameters) - {"k"} - set(kw)
            if extra:
                fail(f"phase 17: {name} needs fixtures {sorted(extra)}")
            yield name, fn, kw


def checkout_tests():
    """The checkout's tests/ as the package `tests`: it has no
    __init__.py, so an installed package of that name would otherwise
    shadow it."""
    import types
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests")
    if here not in list(getattr(sys.modules.get("tests"), "__path__", [])):
        pkg = types.ModuleType("tests")
        pkg.__path__ = [here]
        sys.modules["tests"] = pkg


def oracle_tables(kernels, device="cuda"):
    """Every case of tests/test_torch_kernel_tables.py through the port
    on `device`, its table helpers held against the port's CPU route.
    Returns (cases, the `k` of the run, the spy, launches)."""
    checkout_tests()
    from tests import test_torch_kernel_tables as tables_mod
    from tests.torch_tables import Tables
    k = tables_mod.port_tables(device, against=Tables("cpu"))
    spy = OperandSpy(kernels, every=True)
    cases = list(table_cases(tables_mod))
    kernels.reset_launch_counts()
    with spy:
        for name, fn, kw in cases:
            fn(k, **kw)
    launches = dict(kernels.LAUNCHES)
    return cases, k, spy, launches


def oracle_tables_on_the_card(kernels):
    """Phase 17: the reference's kernel-versus-oracle tables on the card.
    Returns (launches, max abs err per kernel)."""
    t_phase = time.perf_counter()
    cases, k, spy, launches = oracle_tables(kernels)
    t_run = time.perf_counter() - t_phase
    names = sorted({name for name, _, _ in cases})
    log(f"17: {len(cases)} cases of {len(names)} table bodies on the card "
        f"in {t_run:.2f} s; {k.tables.cells} (pod, node) cells equal to "
        f"the CPU route, {k.tables.verdicts} inter-pod oracle answers "
        f"matched by evaluate_pod; launches {launches}; launch shapes "
        f"{spy.launches_by_shape()}")
    if not k.tables.cells or not k.tables.verdicts:
        fail(f"17: {k.tables.cells} cells and {k.tables.verdicts} "
             f"verdicts held against the CPU route")
    for name, n in launches.items():
        if n == 0:
            fail(f"17: the tables never launched the {name} kernel")
    err = spy.check("17")
    log(f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return launches, err


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
        from kubernetes_tpu_torch import admission
        from kubernetes_tpu_torch.admission import webhook
        from kubernetes_tpu_torch.api import cluster, rbac
        from kubernetes_tpu_torch.auth import authn
        from kubernetes_tpu_torch.cli import rest_client
        from kubernetes_tpu_torch.server import (apiserver, replication,
                                                 rest_http)
        from kubernetes_tpu_torch.testing import chaosmonkey
        from kubernetes_tpu_torch import cloud as cloud_mod
        from kubernetes_tpu_torch import controllers
        from kubernetes_tpu_torch.admission import plugins as adm_plugins
        from kubernetes_tpu_torch.observability import __main__ as obs_cli
        from kubernetes_tpu_torch.observability import perfetto
        from kubernetes_tpu_torch.observability import recorder as rec_mod
        from kubernetes_tpu_torch import native
        from kubernetes_tpu_torch.api import wire
        from kubernetes_tpu_torch.client import informer
        from kubernetes_tpu_torch.controllers import (endpoint,
                                                      nodelifecycle,
                                                      replicaset,
                                                      statefulset)
        from kubernetes_tpu_torch.nodes import kubelet as kubelet_mod
        from kubernetes_tpu_torch.nodes import kubelet_server
        from kubernetes_tpu_torch.nodes import proxy as proxy_mod
        from kubernetes_tpu_torch.utils import probe
        from kubernetes_tpu_torch import __main__ as hyperkube
        from kubernetes_tpu_torch.cli import ktadm, ktctl
        from kubernetes_tpu_torch.controllers import deployment
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
    host_ops = ("native " + native._SO if native.available()
                else "the numpy fallback")
    log(f"host ops: {host_ops} (kubernetes_tpu_torch.native; the "
        f"snapshot's label scatter)")
    try:
        import yaml
        yaml_state = f"PyYAML {yaml.__version__} importable"
    except ImportError:
        yaml_state = ("PyYAML not importable (ktctl's -o yaml, create -f, "
                      "apply -f and edit need it; phase 15 uses none)")
    log(f"yaml: {yaml_state}")

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

    # 12. the full apiserver in front of the card's scheduler
    launches_p12, err_p12 = front_door(
        (hollow, kernels, features, workloads, cluster, apiserver,
         apiserver_lite, rest_http, rest_client, admission, webhook, authn,
         rbac, types, replication, chaosmonkey, Scheduler), card)
    for k, v in err_p12.items():
        max_err[k] = max(max_err[k], v)

    # 13. the controller manager, the cloud and volumes; the trace
    launches_p13, err_p13 = controllers_on_the_card(
        ((hollow, types, workloads, admission, adm_plugins, apiserver,
          apiserver_lite, cloud_mod, controllers, Scheduler, COUNTERS,
          kernels),
         (obs_cli, rec_mod, perfetto, hollow, apiserver_lite, Scheduler,
          kernels, COUNTERS)), card)
    for k, v in err_p13.items():
        max_err[k] = max(max_err[k], v)

    # 14. the node agents behind the card's scheduler
    launches_p14, err_p14 = node_agents_on_the_card(
        (hollow, types, workloads, apiserver_lite, informer, kubelet_mod,
         proxy_mod, nodelifecycle, replicaset, statefulset, endpoint,
         Scheduler, COUNTERS, kernels, kubelet_server, probe, wire), card)
    for k, v in err_p14.items():
        max_err[k] = max(max_err[k], v)

    # 15. the command line and the hyperkube entry point
    launches_p15, err_p15 = command_line_on_the_card(
        (ktadm, ktctl, hyperkube, informer, deployment, replicaset,
         Scheduler, kubelet_mod, hollow, apiserver, rest_http, kernels,
         COUNTERS), card)
    for k, v in err_p15.items():
        max_err[k] = max(max_err[k], v)

    # 16. the always-on arrival stream
    launches_p16, err_p16 = arrival_on_the_card(stream_mods(), card,
                                                FakeClock)
    for k, v in err_p16.items():
        max_err[k] = max(max_err[k], v)

    # 17. the reference's oracle tables on the card
    launches_p17, err_p17 = oracle_tables_on_the_card(kernels)
    for k, v in err_p17.items():
        max_err[k] = max(max_err[k], v)

    # 18. summary
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
                         + launches_p10[name] + launches_p11[name]
                         + launches_p12[name] + launches_p13[name]
                         + launches_p14[name] + launches_p15[name]
                         + launches_p16[name] + launches_p17[name]),
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
        f"mesh {launches_p11}, front door {launches_p12}, controllers "
        f"and the trace {launches_p13}, node agents {launches_p14}, "
        f"command line {launches_p15}, arrival stream {launches_p16}, "
        f"oracle tables {launches_p17}")
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
