"""Batch episodes, closed loop: one submitter creates a backlog of
`pods_per_episode` pods in the store, Scheduler.run_until_drained()
places it (ending in a device synchronize), and the pods are deleted
outside the clock before the next episode, which also trims the store's
watch log to its default bound (World.trim_log). Episodes repeat until their
timed intervals add up to the window; the last one is finished."""

import gc
import time

from benchmark.gen.pods import make_pods
from benchmark.lib.adapter import port_pods
from benchmark.lib.gcpauses import GcPauses
from benchmark.lib.world import log

# the program's host spans an episode's log line breaks out
PHASES = ("pipeline.dispatch", "pipeline.device_block", "pipeline.fence",
          "pipeline.assume", "pipeline.tail", "pipeline.host_tail")


def _episode(w, k: int, span) -> dict:
    from kubernetes_tpu_torch.utils.trace import COUNTERS
    n = int(w.params["pods_per_episode"])
    podset = make_pods(w.conf, n, w.seed, k, prefix=f"e{k}-")
    objs = port_pods(podset)
    rv0 = w.api.current_rv()
    w.sync_device()
    c0 = COUNTERS.snapshot()
    t0 = time.perf_counter()
    create = w.api.create
    for p in objs:
        create("Pod", p)
    t1 = time.perf_counter()
    w.sched.sync()
    tot = w.sched.run_until_drained()
    w.sync_device()
    t2 = time.perf_counter()
    c1 = COUNTERS.snapshot()
    span("store.create", t0, t1)
    span("scheduler.drain", t1, t2)
    w.timed.append((t0, t2))
    out = w.judge(podset, rv0)
    # the reset: complete the episode's pods and wait until the scheduler
    # has observed every deletion
    ns = podset.namespace
    for name in podset.names:
        w.api.delete("Pod", ns, name)
    deadline = time.monotonic() + float(w.params["settle_s"])
    while w.sched.sync() > 0:
        if time.monotonic() > deadline:
            raise RuntimeError("the scheduler did not observe the "
                               "episode's deletions")
    w.trim_log()
    t3 = time.perf_counter()
    span("episode.reset", t2, t3)
    phases = {k: c1.get(k, (0, 0.0))[1] - c0.get(k, (0, 0.0))[1]
              for k in PHASES}
    return {"pods": n, "bound": int((out.node_of >= 0).sum()),
            "drain_bound": int(tot["bound"]), "create_s": t1 - t0,
            "drain_s": t2 - t1, "wall_s": t2 - t0, "reset_s": t3 - t2,
            "t0": t0, "t2": t2, "phases": phases}


def setup(w, span) -> None:
    """The warm-up: one whole episode at the cell's own shapes. The window
    then starts from a collected heap, whatever set-up left behind, so
    that every run's collector starts alike (it is not switched off)."""
    ep = _episode(w, 0, span)
    w.judged.clear()
    gc.collect()
    log(f"warm-up episode: {ep['bound']} of {ep['pods']} bound, "
        f"wall {ep['wall_s']:.3f} s, reset {ep['reset_s']:.3f} s")


def window(w, seconds: float, span) -> dict:
    eps = []
    t0 = time.perf_counter()
    w.timed.clear()
    with GcPauses() as gcp:
        while sum(e["wall_s"] for e in eps) < seconds:
            eps.append(_episode(w, len(eps) + 1, span))
    for i, ep in enumerate(eps):
        n2, s2, n_all, s_all = gcp.within(ep["t0"], ep["t2"])
        ph = " ".join(f"{k.split('.')[1]} {v:.3f}"
                      for k, v in ep["phases"].items())
        log(f"episode {i + 1}: {ep['bound']} of {ep['pods']} bound, create "
            f"{ep['create_s']:.3f} s, drain {ep['drain_s']:.3f} s ({ph}; "
            f"gc: {n_all} collections {s_all:.3f} s, {n2} full "
            f"{s2:.3f} s), reset (outside the clock) {ep['reset_s']:.3f} s")
    return {"episodes": eps, "attempted": sum(e["pods"] for e in eps),
            "bound": sum(e["bound"] for e in eps),
            "window_s": time.perf_counter() - t0}
