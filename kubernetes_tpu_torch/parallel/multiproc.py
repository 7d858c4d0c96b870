"""Omega for real: M independent scheduler PROCESSES over one
shared cell, racing through the bind fence.

The multi-frontend benches already run many scheduler
*threads* against one backend — but every thread shares the parent's
GIL, device context and cache, so "N schedulers" was really one
interpreter time-slicing. This module runs the paper's actual shape
(PAPERS.md §Omega): each scheduler is a FULL OS process with its own
interpreter, its own CUDA context, its own TPUExtenderBackend evaluator
(driving engine/scheduler_engine's fused kernels locally) and its own
bounded-stale snapshot — all sharing ONE cell through the binary wire.

The concurrency contract is exactly Omega's:

  - each worker hydrates from the shared cell with RELIST (one round
    trip: nodes + bound pods from commit truth) and re-pulls
    periodically — that pull cadence IS its staleness window;
  - placement decisions run on the worker's LOCAL evaluator against its
    possibly-stale view (zero shared locks on the decision path);
  - the only shared-state touch is the fenced BIND commit: the shared
    backend re-validates every commit against live cache truth
    (extender.py _bind_fence) and refuses with a TYPED conflict —
    capacity/affinity (stale-snapshot shapes), liveness, or
    double_claim (another process already placed this pod);
  - a refused worker refreshes (relist) and retries — optimistic
    concurrency, no pessimistic cell lock anywhere.

Exactly-once is audited against STORE truth (audit_duplicate_binds):
with W workers racing overlapping pending pools, every pod must land on
exactly one node, duplicates hard-zero — the fence plus the double-claim
probe plus the idempotency ledger carry that bar across process
boundaries.

This module is pure HOST-side orchestration: it imports no torch at
module level (workers import the evaluator stack inside their own process).
Every evaluator, the shared one and each worker's, runs on ``device``:
the card by default. A worker gets it in its ``cfg`` as a string, since
a spawned process builds its own CUDA context.
"""

from __future__ import annotations

import multiprocessing
import re
import time
from typing import Dict, List, Optional

_OWNER_RE = re.compile(r"already (?:claimed on|assigned to node) (\S+)")

# events kept per worker for perfetto lanes / debugging; the counters
# are exact regardless — this only bounds the queue payload
MAX_EVENTS_PER_WORKER = 4096


def audit_duplicate_binds(api, prefix: str = "") -> int:
    """STORE-TRUTH exactly-once audit over the full event log: a pod
    whose MODIFIED events ever name two different nodes was double-
    booked. This is the hard-zero acceptance bar for every multiproc
    scenario — same audit the thread fleets use."""
    first_node, dups = {}, 0
    for e in api._log:
        if e.kind == "Pod" and e.type == "MODIFIED" and e.obj.node_name \
                and e.obj.name.startswith(prefix):
            prev = first_node.setdefault(e.obj.name, e.obj.node_name)
            if prev != e.obj.node_name:
                dups += 1
    return dups


def _worker_main(cfg: Dict, out_q) -> None:
    """One scheduler process (spawn target — module level, import-safe).

    Owns a full local evaluator: TPUExtenderBackend(binder=None) is the
    fused-kernel scheduler_engine front (its fused_verdict/bind_verdict
    are the same seams the wave engine drives), hydrated by RELIST and
    committed-to only AFTER the shared cell accepted the fenced bind.
    ``cfg["device"]`` is its device ("cuda", "cpu"; None = the card).
    """
    import random

    from kubernetes_tpu_torch.client.binarywire import (
        BinaryWireClient, WireDeadline, WireError, WireOverloaded)
    from kubernetes_tpu_torch.server import framing
    from kubernetes_tpu_torch.server.extender import TPUExtenderBackend

    wid = cfg["worker_id"]
    rng = random.Random((0xED6A << 4) ^ (wid * 7919))
    pods = framing.decode_items_blob(cfg["pods_blob"], "pods")
    local = TPUExtenderBackend(
        binder=None,
        stale_window_s=cfg.get("stale_window_ms", 0) / 1e3,
        coalesce_window_s=0.0005, device=cfg.get("device"))
    cli = BinaryWireClient(cfg["host"], cfg["port"],
                           timeout=cfg.get("wire_timeout_s", 60.0))
    cli.connect()

    counts = {"binds": 0, "conflicts": 0, "double_claim": 0,
              "stale_snapshot": 0, "pending": 0, "relists": 0,
              "attempts": 0, "overloaded": 0, "gave_up": 0,
              "wire_replays": 0}
    events: List[Dict] = []
    bound: Dict[str, str] = {}

    def ev(kind: str, t0: float, **kw) -> None:
        if len(events) < MAX_EVENTS_PER_WORKER:
            e = {"kind": kind, "t": t0,
                 "dur": time.monotonic() - t0}
            e.update(kw)
            events.append(e)

    def relist() -> None:
        t0 = time.monotonic()
        nodes, bound_pods = cli.relist()
        local.sync_nodes(nodes)
        local.sync_pods(bound_pods)
        counts["relists"] += 1
        ev("relist", t0, n=len(bound_pods))

    try:
        relist()  # hydrate: the per-process snapshot
        relist_every = max(int(cfg.get("relist_every", 16)), 1)
        top_k = int(cfg.get("top_k", 32))
        since_relist = 0
        t_start = time.monotonic()
        for pod in pods:
            key = pod.key()
            blob = framing.encode_pod_blob(pod)
            placed = None
            for attempt in range(80):
                counts["attempts"] += 1
                # DECIDE locally: the fused verdict runs on THIS
                # process's evaluator against its bounded-stale view —
                # no shared lock, no wire round trip
                _passed, _failed, top, _gen = local.fused_verdict(
                    pod, None, top_k=top_k)
                if not top:
                    relist()
                    time.sleep(0.002 * rng.uniform(0.5, 1.5))
                    continue
                best = top[0][1]
                host = rng.choice([n for n, s in top if s == best])
                # COMMIT remotely: gen=None forces the shared fence —
                # a local generation can never attest the shared cell
                idem = f"{key}:w{wid}:{attempt}"
                t0 = time.monotonic()
                try:
                    r = cli.bind(pod.name, pod.namespace, pod.uid, host,
                                 snapshot_gen=None, idem_key=idem,
                                 pod_blob=blob)
                except WireOverloaded as e:
                    counts["overloaded"] += 1
                    time.sleep(e.retry_after_s * rng.uniform(0.5, 1.5))
                    continue
                except WireDeadline:
                    continue
                except (WireError, ConnectionError, OSError):
                    # ambiguous wire fault: reconnect and replay the
                    # SAME ledger key — the service converges it
                    counts["wire_replays"] += 1
                    try:
                        cli.connect()
                        r = cli.bind(pod.name, pod.namespace, pod.uid,
                                     host, snapshot_gen=None,
                                     idem_key=idem, pod_blob=blob)
                    except Exception:
                        time.sleep(0.01)
                        continue
                if r.kind == "ok":
                    placed = host
                    counts["binds"] += 1
                    ev("bind", t0, pod=key, node=host,
                       attempt=attempt)
                    # local commit mirrors the accepted placement so
                    # subsequent verdicts see the capacity charge now,
                    # not at the next relist
                    local.bind_verdict(pod.name, pod.namespace,
                                       pod.uid, host, pod_spec=pod)
                    break
                if r.kind == "conflict":
                    counts["conflicts"] += 1
                    m = _OWNER_RE.search(r.error)
                    if "double-claim" in r.error and m:
                        # another PROCESS placed this pod: store truth
                        # wins — converge, don't fight
                        counts["double_claim"] += 1
                        ev("conflict", t0, pod=key,
                           reason="double_claim", owner=m.group(1))
                        placed = m.group(1)
                        break
                    counts["stale_snapshot"] += 1
                    ev("conflict", t0, pod=key, reason="stale_snapshot")
                    time.sleep(max(r.retry_after_s, 0.001)
                               * rng.uniform(0.5, 1.5))
                    relist()
                    continue
                if r.kind == "pending":
                    counts["pending"] += 1
                    time.sleep(max(r.retry_after_s, 0.001))
                    continue
                if r.kind == "shed":
                    continue
                # kind == "error": the store write failed. A different-
                # node refusal means a racing process landed first at
                # the STORE (fence raced the same microsecond) —
                # converge on the store's owner like a double-claim.
                m = _OWNER_RE.search(r.error or "")
                if m and m.group(1) != host:
                    counts["conflicts"] += 1
                    counts["double_claim"] += 1
                    ev("conflict", t0, pod=key, reason="double_claim",
                       owner=m.group(1))
                    placed = m.group(1)
                    break
                # ambiguous store fault: same-key replay next round
                time.sleep(0.005 * rng.uniform(0.5, 1.5))
            else:
                counts["gave_up"] += 1
            if placed is not None:
                bound[key] = placed
            since_relist += 1
            if since_relist >= relist_every:
                since_relist = 0
                relist()  # the watch cadence: bounded staleness
        t_end = time.monotonic()
        out_q.put({"worker": wid, "ok": True, "counts": counts,
                   "bound": bound, "events": events,
                   "t0": t_start, "t1": t_end,
                   "elapsed_s": t_end - t_start})
    except Exception as e:  # noqa: BLE001 — report, never hang the join
        out_q.put({"worker": wid, "ok": False,
                   "error": f"{type(e).__name__}: {e}",
                   "counts": counts, "bound": bound, "events": events,
                   "t0": 0.0, "t1": 0.0, "elapsed_s": 0.0})
    finally:
        cli.close()


def run_process_fleet(n_workers: int, pods_per_worker: int = 64,
                      overlap: float = 0.0, n_nodes: int = 64,
                      stale_window_ms: float = 0.0,
                      bind_fail_rate: float = 0.0,
                      bind_timeout_rate: float = 0.0,
                      relist_every: int = 16, top_k: int = 32,
                      seed: int = 0, pod_prefix: str = "mp",
                      durable_dir: Optional[str] = None,
                      timeout_s: float = 300.0, device=None) -> Dict:
    """Spawn ``n_workers`` full scheduler processes over one shared cell
    and drain their pending pools through the fenced wire.

    ``overlap`` is the fraction of each worker's pool that is SHARED
    with every other worker (the same pod objects, raced): overlap 0.0
    partitions the pending pool (Omega's happy case — conflicts only
    from capacity races), overlap 1.0 makes every pod contested
    (worst case — W-1 of every W claims must lose typed).

    Returns {"workers": [...], "agg": {...}} — per-worker raw results
    (counts/events/bound, perfetto-lane ready) plus the aggregate:
    scheduleOnes/s over the fleet wall-clock, conflict totals split by
    typed reason, the server's fence-conflict counter snapshot and the
    store-truth duplicate audit (must be 0).

    ``device`` (None = the card) runs the shared backend and every
    worker's evaluator.
    """
    from kubernetes_tpu_torch.api.types import make_pod
    from kubernetes_tpu_torch.models.hollow import hollow_nodes
    from kubernetes_tpu_torch.server import framing
    from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite
    from kubernetes_tpu_torch.server.asyncwire import AsyncBinaryServer
    from kubernetes_tpu_torch.server.embedded import VerdictService
    from kubernetes_tpu_torch.server.extender import TPUExtenderBackend
    from kubernetes_tpu_torch.testing.churn import (FaultyBindApi,
                                              extender_store_binder)

    n_workers = max(int(n_workers), 1)
    overlap = min(max(float(overlap), 0.0), 1.0)
    total_pods = n_workers * pods_per_worker
    api = ApiServerLite(max_log=max(200_000, 8 * (n_nodes + total_pods)),
                        data_dir=durable_dir)
    nodes = hollow_nodes(n_nodes, seed=seed)
    for i, n in enumerate(nodes):
        n.labels["zone"] = f"z{i % 16}"
        api.create("Node", n)
    faulty = FaultyBindApi(api, fail_rate=bind_fail_rate,
                           timeout_rate=bind_timeout_rate, seed=seed)
    backend = TPUExtenderBackend(binder=extender_store_binder(faulty),
                                 stale_window_s=stale_window_ms / 1e3,
                                 coalesce_window_s=0.0005, device=device)
    backend.sync_nodes(nodes)
    backend.filter(make_pod(f"{pod_prefix}-warm", cpu=100,
                            memory=256 << 20), None, None)
    service = VerdictService(backend)
    srv = AsyncBinaryServer(service, max_inflight=max(64, 4 * n_workers))
    srv.start()

    # pending pools: a per-worker OWN slice plus a SHARED slice every
    # worker races (the overlap knob). All pods exist in the store
    # first, like a real pending queue.
    n_shared = int(round(overlap * pods_per_worker))
    n_own = pods_per_worker - n_shared
    shared = [make_pod(f"{pod_prefix}-sh-{i}", cpu=100,
                       memory=256 << 20) for i in range(n_shared)]
    own = {w: [make_pod(f"{pod_prefix}-w{w}-{i}", cpu=100,
                        memory=256 << 20) for i in range(n_own)]
           for w in range(n_workers)}
    for p in shared:
        api.create("Pod", p)
    for w in range(n_workers):
        for p in own[w]:
            api.create("Pod", p)

    ctx = multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    procs = []
    t_wall0 = time.monotonic()
    try:
        for w in range(n_workers):
            pool = own[w] + shared  # shared pods raced by everyone
            cfg = {"worker_id": w, "host": "127.0.0.1",
                   "port": srv.port,
                   "pods_blob": framing.encode_items_blob(pool, "pods"),
                   "stale_window_ms": stale_window_ms,
                   "relist_every": relist_every, "top_k": top_k,
                   "device": None if device is None else str(device)}
            p = ctx.Process(target=_worker_main, args=(cfg, out_q),
                            name=f"sched-proc-{w}", daemon=True)
            p.start()
            procs.append(p)
        results = []
        deadline = time.monotonic() + timeout_s
        while len(results) < n_workers and time.monotonic() < deadline:
            try:
                results.append(out_q.get(timeout=0.5))
                continue
            except Exception:
                pass
            # a worker that died before reporting (spawn failure, OOM)
            # must not stall the join for the full timeout
            if all(not p.is_alive() for p in procs):
                try:
                    while len(results) < n_workers:
                        results.append(out_q.get(timeout=0.5))
                except Exception:
                    pass
                break
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        t_wall1 = time.monotonic()
        srv.stop()

    results.sort(key=lambda r: r["worker"])
    ok = [r for r in results if r.get("ok")]
    binds = sum(r["counts"]["binds"] for r in results)
    conflicts = sum(r["counts"]["conflicts"] for r in results)
    # fleet wall-clock: first worker's scheduling start to last end
    # (CLOCK_MONOTONIC is system-wide on Linux, so worker stamps are
    # directly comparable); falls back to the parent's wall if a worker
    # died before stamping
    t0s = [r["t0"] for r in ok if r["t0"]]
    t1s = [r["t1"] for r in ok if r["t1"]]
    span = (max(t1s) - min(t0s)) if t0s and t1s else (t_wall1 - t_wall0)
    span = max(span, 1e-9)
    vars_snap = service.debug_snapshot(0)["vars"]
    fence = {k.rsplit("bind_conflict_reason_", 1)[1]: v
             for k, v in vars_snap.items()
             if "bind_conflict_reason_" in k}
    agg = {
        "workers": n_workers,
        "pods_per_worker": pods_per_worker,
        "overlap": overlap,
        "n_nodes": n_nodes,
        "binds": binds,
        "scheduled_pods_s": binds / span,
        "wall_s": span,
        "conflicts": conflicts,
        "conflict_rate": conflicts / max(binds + conflicts, 1),
        "double_claim": sum(r["counts"]["double_claim"]
                            for r in results),
        "stale_snapshot": sum(r["counts"]["stale_snapshot"]
                              for r in results),
        "relists": sum(r["counts"]["relists"] for r in results),
        "gave_up": sum(r["counts"]["gave_up"] for r in results),
        "worker_failures": [r.get("error") for r in results
                            if not r.get("ok")],
        "missing_workers": n_workers - len(results),
        "server_bind_conflicts": vars_snap.get(
            "counter.extender.bind_conflicts", 0),
        "server_conflict_reasons": fence,
        "duplicate_binds": audit_duplicate_binds(api, pod_prefix),
    }
    return {"workers": results, "agg": agg, "api": api}


__all__ = ["MAX_EVENTS_PER_WORKER", "audit_duplicate_binds",
           "run_process_fleet"]
