"""The reference's always-on streaming loop contracts
(tests/test_stream_loop.py) on both packages: streaming micro-waves place
a frozen arrival trace exactly as the fixed-chunk pipelined drain does;
while the loop is live only the delta touches the device; the admission
quantum adapts inside its bounds; and a small offered stream is consumed
at the offered rate. Each body runs through the `k` fixture with every
Scheduler of the port on the CPU. The arrival smoke asserts the
reference's contract (bench.run_arrival's offered-vs-sustained series and
create->bound p99) through `_arrival` below, which runs the same steps on
either package: bench.run_arrival itself drives the reference only."""

from __future__ import annotations

import gc
import threading
import time

import numpy as np
import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "api_types": "api.types",
    "sched": "engine.scheduler",
    "streaming": "engine.streaming",
    "hollow": "models.hollow",
    "apiserver_lite": "server.apiserver_lite",
    "trace": "utils.trace",
}

PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}
DEVICE = {REF: {}, PORT: {"device": "cpu"}}

# a ragged arrival trace: group sizes deliberately non-bucket-aligned so
# the reference's pad-floor machinery (not luck) keeps its shapes stable;
# the port dispatches each group at its own size
TRACE = (37, 128, 5, 96, 64, 111)


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


def mk_sched(k, n_nodes=64):
    api = k.ApiServerLite()
    k.load_cluster(api, k.hollow_nodes(n_nodes), [])
    s = k.sched.Scheduler(api, record_events=False, **DEVICE[k.root])
    s.start()
    return api, s


def feed(k, api, group, tag):
    pods = k.PROFILES["density"](group)
    for p in pods:
        p.name = f"{tag}-{p.name}"
        api.create("Pod", p)


def placements(api):
    return {p.name: p.node_name for p in api.list("Pod")[0]}


def drain_idle(sched, loop):
    loop.drain()  # the loop's shared quiesce predicate (settled())


# ------------------------------------------------------- frozen-trace A/B


def test_frozen_trace_streaming_equals_pipelined_drain(k):
    """The same frozen arrival trace consumed (a) by the streaming loop
    and (b) by the fixed-chunk pipelined drain places every pod on the
    SAME node: admission control changes when waves run, never what a
    wave means."""
    quantum = 128  # >= max(TRACE): one step consumes one group exactly
    api_a, s_a = mk_sched(k)
    loop = s_a.stream(budget_s=30.0, min_quantum=quantum,
                      max_quantum=quantum)
    for gi, group in enumerate(TRACE):
        feed(k, api_a, group, f"g{gi}")
        loop.step()
    drain_idle(s_a, loop)
    loop.close()

    api_b, s_b = mk_sched(k)
    pipe = s_b.pipeline(chunk=quantum)
    for gi, group in enumerate(TRACE):
        feed(k, api_b, group, f"g{gi}")
        pipe.step()
    drain_idle(s_b, pipe)
    pipe.close()

    pa, pb = placements(api_a), placements(api_b)
    assert pa == pb, {x: (pa[x], pb[x]) for x in pa if pa[x] != pb[x]}
    assert all(v for v in pa.values()), "trace must fully bind"
    assert len(pa) == sum(TRACE)


# ----------------------------------------------------- delta-only invariant


def test_stream_delta_only_invariants(k):
    """While the loop is live, between micro-waves ONLY the delta touches
    the device: encoding reuse, hinted refresh and raw-delta assume folds
    for every bound pod."""
    api, s = mk_sched(k)
    loop = s.stream(budget_s=30.0, min_quantum=128, max_quantum=128)
    feed(k, api, 128, "warm")  # warm: builds the encoding
    loop.step()
    drain_idle(s, loop)

    COUNTERS = k.trace.COUNTERS
    COUNTERS.reset()
    groups = (96, 128, 57)
    for gi, group in enumerate(groups):
        feed(k, api, group, f"live{gi}")
        loop.step()
    drain_idle(s, loop)
    loop.close()
    snap = COUNTERS.snapshot()

    def cnt(name):
        return snap.get(name, (0, 0.0))[0]

    bound = sum(groups)
    assert {p.name: p.node_name
            for p in api.list("Pod")[0] if p.name.startswith("live")} \
        and all(p.node_name for p in api.list("Pod")[0])
    # zero re-tensorization: the cached class encoding serves every wave
    assert cnt("engine.wave_encode_build") == 0, snap
    assert cnt("engine.wave_encode_reuse") >= len(groups)
    # zero full snapshot walks: the owner's dirty notes cover everything
    assert cnt("snapshot.refresh_scan") == 0, snap
    assert cnt("snapshot.refresh_rebuild") == 0, snap
    assert cnt("snapshot.refresh_hinted") >= len(groups)
    # every fence-accepted assume rode the raw-delta fold, none walked
    assert cnt("snapshot.assume_delta_rows") == bound, snap
    # one fused dispatch per micro-wave
    assert cnt("engine.wave_dispatch") == len(groups), snap


# ------------------------------------------------------ quantum adaptation


class _FakeEngine:
    pass


class _FakeSched:
    def __init__(self):
        self.engine = _FakeEngine()
        self._pipeline = None
        self.pipeline_chunk = 4096


class _FakeHandle:
    def __init__(self, n, latency):
        self.pods = [None] * n
        self.pop_ts = time.monotonic() - latency


def test_quantum_adaptation_bounds_and_hysteresis(k):
    """Grow only after TWO consecutive saturated waves well under budget,
    shrink immediately when the EWMA crosses the budget, clamp to
    [min_quantum, max_quantum]."""
    s = _FakeSched()
    loop = k.ScheduleLoop(s, budget_s=0.2, min_quantum=64, max_quantum=256)
    assert loop.quantum == 64
    if k.root == REF:
        assert s.engine.wave_pad_floor == 64  # the shape-ladder floor
    else:
        assert vars(s.engine) == {}  # the port's loop pins no shape

    # one fast full wave: no growth yet (hysteresis)
    loop._observe_wave(_FakeHandle(64, 0.01))
    assert loop.quantum == 64
    # second consecutive: grows
    loop._observe_wave(_FakeHandle(64, 0.01))
    assert loop.quantum == 128
    # a partial wave resets the streak
    loop._observe_wave(_FakeHandle(10, 0.01))
    loop._observe_wave(_FakeHandle(128, 0.01))
    assert loop.quantum == 128
    loop._observe_wave(_FakeHandle(128, 0.01))
    assert loop.quantum == 256
    # cap: saturated fast waves cannot exceed max_quantum
    loop._observe_wave(_FakeHandle(256, 0.01))
    loop._observe_wave(_FakeHandle(256, 0.01))
    assert loop.quantum == 256
    # over-budget wave shrinks immediately...
    loop._observe_wave(_FakeHandle(256, 5.0))
    assert loop.quantum == 128
    # ...and the floor holds no matter how slow it gets
    loop._observe_wave(_FakeHandle(128, 5.0))
    loop._observe_wave(_FakeHandle(64, 5.0))
    loop._observe_wave(_FakeHandle(64, 5.0))
    assert loop.quantum == 64


def test_fixed_mode_pins_one_shape(k):
    """budget_s=None is the drain: quantum == chunk (and the reference's
    pad floor == chunk; the port's engine uploads live rows only)."""
    s = _FakeSched()
    loop = k.ScheduleLoop(s, chunk=1000)
    assert loop.quantum == 1000
    if k.root == REF:
        assert s.engine.wave_pad_floor == 1000
    else:
        assert vars(s.engine) == {}
    loop._observe_wave(_FakeHandle(1000, 9.9))  # adaptation inert
    assert loop.quantum == 1000


# ------------------------------------------------------- tier-1 fast smoke


def _warm_ladder(k, n_nodes, sizes):
    """bench._warm_stream_shapes on package `k`: one throwaway cluster,
    one fixed-chunk drain per ladder size (the reference compiles its
    shapes here; the port has nothing to compile)."""
    api, s = mk_sched(k, n_nodes)
    for sz in sizes:
        for p in k.PROFILES["density"](sz):
            p.name = f"warm{sz}-{p.name}"
            api.create("Pod", p)
        s.run_until_drained(max_batch=sz)


def _arrival(k, n_nodes, rate, duration_s, min_quantum, max_quantum,
             budget_ms):
    """bench.run_arrival's quiet-box scenario on package `k`: the warm
    shape ladder and 64 prime pods, then density pods created at `rate`
    by a creator thread while the always-on loop runs; create->bound per
    pod from the creator's stamps and the scheduler's bind instants;
    `sustained` is the median per-interval bind rate over the buckets
    fully inside the offer window, the first dropped as ramp."""
    sizes, q = [], min_quantum
    while q <= max_quantum:
        sizes.append(q)
        q *= 2
    _warm_ladder(k, n_nodes, sizes)
    total = int(rate * duration_s)
    budget_s = budget_ms / 1e3
    interval_s = min(1.0, max(0.25, round(duration_s / 4.0, 2)))
    max_burst = max(4, int(rate * 0.004))
    api, sched = mk_sched(k, n_nodes)
    pods = k.PROFILES["density"](total)
    index = {p.key(): i for i, p in enumerate(pods)}
    loop = sched.stream(budget_s=budget_s, min_quantum=min_quantum,
                        max_quantum=max_quantum, chunk=min_quantum)
    for p in k.PROFILES["density"](min(64, min_quantum)):
        p.name = "prime-" + p.name
        api.create("Pod", p)
    loop.drain()
    # bench.run_arrival's quiet box for the measured window: a gen-2
    # collection over the warm heap stops the creator and the loop alike
    # for hundreds of ms (over a second beside a parallel suite), long
    # enough to leave a whole interval bucket without a bind
    gc.collect()
    gc.freeze()
    gc.disable()
    created = [0]
    create_ts = np.full(total, -1.0)
    create_log = []
    bind_events = []
    t0 = time.monotonic()
    sched.wave_observer = lambda ts, keys: bind_events.append((ts - t0,
                                                               keys))

    def creator():
        while created[0] < total:
            now = time.monotonic() - t0
            due = min(total, int(rate * now), created[0] + max_burst)
            if due > created[0]:
                for p in pods[created[0]:due]:
                    api.create("Pod", p)
                ts = time.monotonic() - t0
                create_ts[created[0]:due] = ts
                create_log.append((ts, due - created[0]))
                created[0] = due
            delay = t0 + (created[0] + 1) / rate - time.monotonic()
            if delay > 0:
                time.sleep(min(delay, max(0.0005, max_burst / rate / 4)))

    thread = threading.Thread(target=creator, daemon=True)
    backlog_at_offer_end = [None]
    deadline = t0 + max(60.0, duration_s * 20)

    def note(stats, loop):
        if backlog_at_offer_end[0] is None and created[0] >= total:
            inflight = len(loop.inflight.pods) if loop.inflight else 0
            backlog_at_offer_end[0] = len(sched.queue) + inflight

    def done(stats, loop):
        if created[0] >= total and stats["popped"] == 0 and loop.settled():
            return True
        assert time.monotonic() < deadline, "arrival run incomplete"
        return False
    try:
        thread.start()
        loop.run(done, on_step=note)
    finally:
        loop.close()
        gc.enable()
        gc.unfreeze()
    thread.join(timeout=10)
    sched.wave_observer = None
    lat = np.full(total, -1.0)
    for ts, keys in bind_events:
        for key in keys:
            i = index.get(key)
            if i is not None and create_ts[i] >= 0:
                lat[i] = ts - create_ts[i]
    bound = int((lat >= 0).sum())
    lat = lat[lat >= 0]
    offer_end = create_log[-1][0]
    n_buckets = int(offer_end / interval_s)
    intervals = [0] * max(n_buckets, 1)
    for ts, keys in bind_events:
        b = int(ts / interval_s)
        if b < n_buckets:
            intervals[b] += sum(1 for key in keys if key in index)
    steady = intervals[1:n_buckets] if n_buckets > 1 else intervals
    sustained = sorted(steady)[len(steady) // 2] / interval_s
    return {"bound": bound, "unbound": total - bound,
            "offered_pods_s": float(rate), "sustained_pods_s": sustained,
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "backlog_at_offer_end": int(backlog_at_offer_end[0] or 0),
            "intervals": intervals}


def test_arrival_smoke_sustains_offered_rate(k):
    """A small offered stream must be consumed AT the offered rate with a
    loose latency bound: 300 pods/s for 2 s into 64 nodes."""
    out = _arrival(k, 64, rate=300, duration_s=2.0, min_quantum=64,
                   max_quantum=256, budget_ms=500.0)
    assert out["bound"] == 600 and out["unbound"] == 0
    # sustained >= offered: the loop kept up INSIDE the offer window
    # (tolerance for interval-edge rounding on a 2-bucket window)
    assert out["sustained_pods_s"] >= 0.95 * out["offered_pods_s"], out
    # loose p99: double-digit ms warm; anything near a second means the
    # stream went cold mid-offer
    assert out["p99_ms"] < 1500.0, out
    assert out["backlog_at_offer_end"] < 300, out
