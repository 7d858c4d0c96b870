"""The port's pipelined drain through Scheduler.run_until_drained on the
CPU against the reference package's, exactly: the same hollow cluster and
seeded pods go through both, and the pod->node placements, the drain
totals and the wave/tail/fence counters must be equal — with the strict
tail run as conflict rounds and as the per-pod scan, and with overlap on
and off (overlap=False must give the same placements as overlap=True).
The port's dispatches carry live rows only, so two counters depart from
the reference's on purpose, each by an exact rule: a harvest fetches
[3n+2] int32 for n pods, and a conflict-round tail in which every live
row places skips the empty round that retires the reference's padding
rows.
Also: the blind-window fence cases, and the drain on an 8-shard node-axis
mesh against the reference's 8-device mesh and the unsharded port."""

import sys

import numpy as np
import pytest

import kubernetes_tpu.api.types as jt
import kubernetes_tpu.api.workloads as jw
import kubernetes_tpu.engine.scheduler as jsched
import kubernetes_tpu.engine.waves as jwaves
import kubernetes_tpu.models.hollow as jh
import kubernetes_tpu.ops.predicates as jpred
import kubernetes_tpu.server.apiserver_lite as japi
import kubernetes_tpu.utils.trace as jtrace
import kubernetes_tpu_torch.api.types as tt
import kubernetes_tpu_torch.api.workloads as tw
import kubernetes_tpu_torch.engine.scheduler as tsched
import kubernetes_tpu_torch.engine.waves as twaves
import kubernetes_tpu_torch.models.hollow as th
import kubernetes_tpu_torch.server.apiserver_lite as tapi
import kubernetes_tpu_torch.utils.trace as ttrace

Gi = 1 << 30
REF = (jt, jw, jh, japi, jsched, jtrace)
PORT = (tt, tw, th, tapi, tsched, ttrace)
COUNTER_KEYS = (
    "engine.wave_dispatch", "engine.wave_dispatch_pods",
    "engine.wave_encode_build",
    "engine.wave_encode_reuse", "engine.wave_aff_build",
    "engine.affinity_strict_tail", "engine.wave_tail_dispatch",
    "engine.tail_round_dispatch",
    "engine.affinity_fence_requeues", "engine.affinity_straggler_requeues",
    "engine.fence_reason_capacity", "engine.fence_reason_affinity",
    "engine.liveness_fence_requeues", "stream.chunk_flush")
# counters the port departs from on purpose (see _live_rows)
DEPARTED = ("engine.host_fetch_bytes", "engine.tail_rounds")


def _anti(types, app, key):
    return types.Affinity(pod_anti_affinity=types.PodAffinity(
        required_terms=[types.PodAffinityTerm(
            label_selector=types.LabelSelector(match_labels={"app": app}),
            namespaces=[], topology_key=key)]))


def _aff(types, app, key):
    return types.Affinity(pod_affinity=types.PodAffinity(
        required_terms=[types.PodAffinityTerm(
            label_selector=types.LabelSelector(match_labels={"app": app}),
            namespaces=[], topology_key=key)]))


# ------------------------------------------------------------- scenarios
# each builds (nodes, pods, workload objects) from one package's modules


def _profile(name, n_nodes, n_pods):
    def build(types, wl, hollow):
        return (hollow.hollow_nodes(n_nodes, seed=7),
                hollow.PROFILES[name](n_pods), [])
    return build


def _mixed_with_service(types, wl, hollow):
    svc = wl.Service(name="web", namespace="bench",
                     selector={"app": "web-1"})
    return (hollow.hollow_nodes(64, seed=7),
            hollow.PROFILES["mixed_affinity"](600), [svc])


def _blind_capacity(types, wl, hollow):
    nodes = [types.make_node(f"n{i:03d}", cpu=2000, memory=8 * Gi, pods=110)
             for i in range(16)]  # each node fits exactly 2 pods
    pods = [types.make_pod(f"p{i:03d}", cpu=1000, memory=256 << 20)
            for i in range(40)]
    return nodes, pods, []


def _blind_port(types, wl, hollow):
    nodes = [types.make_node(f"n{i}", cpu=4000, memory=16 * Gi, pods=110)
             for i in range(2)]
    pods = [types.make_pod(f"port-{i}", cpu=100, memory=128 << 20,
                           ports=[8080]) for i in range(2)]
    return nodes, pods, []


def _anti_hosts(types, wl, hollow):
    nodes = [types.make_node(f"n{i:02d}", cpu=8000, memory=32 * Gi,
                             pods=110, labels={"host": f"h{i}"})
             for i in range(8)]
    pods = []
    for i in range(8):
        p = types.make_pod(f"iso-{i}", cpu=100, memory=128 << 20,
                           labels={"app": "iso"})
        p.affinity = _anti(types, "iso", "host")
        pods.append(p)
    return nodes, pods, []


def _zone_pack(n_pods):
    def build(types, wl, hollow):
        nodes = [types.make_node(f"n{i:02d}", cpu=8000, memory=32 * Gi,
                                 pods=110, labels={"host": f"h{i}",
                                                   "zone": f"z{i % 2}"})
                 for i in range(6)]
        pods = []
        for i in range(n_pods):
            p = types.make_pod(f"pack-{i}", cpu=100, memory=128 << 20,
                               labels={"app": "pack"})
            p.affinity = _aff(types, "pack", "zone")
            pods.append(p)
        return nodes, pods, []
    return build


_zone_group = _zone_pack(6)


def _zone_anti_blind(types, wl, hollow):
    nodes = [types.make_node(f"n{i}", cpu=4000, memory=16 * Gi, pods=110,
                             labels={"host": f"h{i}", "zone": "z0"})
             for i in range(3)]
    pods = []
    for i, host in enumerate(("h0", "h1")):
        p = types.make_pod(f"za-{i}", cpu=100 * (i + 1), memory=128 << 20,
                           labels={"app": "za"})
        p.node_selector = {"host": host}
        p.affinity = _anti(types, "za", "zone")
        pods.append(p)
    return nodes, pods, []


# id -> (builder, chunk, max_batch, run options, checks on the port's run)
SCENARIOS = {
    "density-96x700": (_profile("density", 96, 700), 128, 0, {}, {}),
    "density-96x600-ragged": (_profile("density", 96, 600), 256, 0, {},
                              {}),
    "binpack-96x700": (_profile("binpack", 96, 700), 128, 0, {}, {}),
    "mixed-64x600-default": (_profile("mixed_affinity", 64, 600), 128, 128,
                             {}, {"engine.affinity_strict_tail": 1}),
    "mixed-64x600-rounds": (_profile("mixed_affinity", 64, 600), 128, 256,
                            {"tail_rounds_min": 1},
                            {"engine.tail_rounds": 2}),
    "mixed-64x600-scan": (_profile("mixed_affinity", 64, 600), 128, 0,
                          {"tail_rounds": False},
                          {"engine.wave_tail_dispatch": 1}),
    "mixed-64x600-service": (_mixed_with_service, 128, 128,
                             {"tail_rounds_min": 1},
                             {"engine.tail_round_dispatch": 1}),
    "blind-capacity": (_blind_capacity, 8, 0, {},
                       {"engine.fence_reason_capacity": 1}),
    "blind-port": (_blind_port, 1, 0, {}, {}),
    "anti-hosts": (_anti_hosts, 3, 0, {}, {"engine.wave_dispatch": 2}),
    "zone-group": (_zone_group, 2, 0, {},
                   {"engine.affinity_strict_tail": 6}),
    "zone-anti-blind": (_zone_anti_blind, 1, 1, {}, {}),
    # round tails with a live row left unplaced, and with no padding rows
    "zone-anti-rounds": (_zone_anti_blind, 2, 2, {"tail_rounds_min": 1},
                         {"engine.tail_round_dispatch": 1}),
    "zone-group-16-rounds": (_zone_pack(16), 16, 16, {"tail_rounds_min": 1},
                             {"engine.tail_round_dispatch": 1}),
}


def _drain(side, build, chunk, max_batch, overlap=True, tail_rounds=True,
           tail_rounds_min=None, mesh_shards=0):
    types, wl, hollow, api_mod, sched_mod, trace = side
    nodes, pods, workloads = build(types, wl, hollow)
    api = api_mod.ApiServerLite()
    for w in workloads:
        api.create("Service", w)
    hollow.load_cluster(api, nodes, pods)
    kw = {"device": "cpu"} if side is PORT else {}
    if mesh_shards:
        if side is PORT:
            from kubernetes_tpu_torch.parallel.mesh import make_mesh
            kw["mesh"] = make_mesh(mesh_shards, device="cpu")
        else:
            from kubernetes_tpu.parallel.mesh import make_mesh
            kw["mesh"] = make_mesh(mesh_shards)
    s = sched_mod.Scheduler(api, record_events=False, **kw)
    s.pipeline_chunk = chunk
    s.engine.tail_rounds = tail_rounds
    if tail_rounds_min is not None:
        s.engine.tail_rounds_min = tail_rounds_min
    payloads = []
    if side is PORT:
        harvest = s.engine.harvest_waves

        def harvest_and_record(handle):
            out = harvest(handle)
            payloads.append((len(handle.pods), handle.packed_h.size))
            return out
        s.engine.harvest_waves = harvest_and_record
    # each conflict-round tail: (rows, rounds, selections of its rows)
    tails = []
    waves = twaves if side is PORT else jwaves
    rounds_loop = waves.tail_rounds_loop

    def rounds_and_record(*args, **kw):
        packed, state = rounds_loop(*args, **kw)
        got = np.asarray(packed.cpu() if side is PORT else packed)
        rows = (len(got) - 2) // 2
        tails.append((rows, int(got[2 * rows + 1]), got[:rows]))
        return packed, state
    waves.tail_rounds_loop = rounds_and_record
    try:
        s.start()
        trace.COUNTERS.reset()
        tot = s.run_until_drained(max_batch=max_batch, overlap=overlap)
    finally:
        waves.tail_rounds_loop = rounds_loop
    snap = trace.COUNTERS.snapshot()
    if side is PORT:
        s.engine.close()
    return ({p.key(): p.node_name for p in api.list("Pod")[0]}, tot,
            {k: snap.get(k, (0, 0.0))[0] for k in COUNTER_KEYS},
            {k: snap.get(k, (0, 0.0))[0] for k in DEPARTED}, payloads,
            tails)


def _live_rows(port, ref):
    """Each of the port's harvests fetched [3n+2] int32 for its n pods
    (selection, fit count and activity per pod, the counter, the wave
    count): 12 bytes per pod harvested plus 8 per harvest. Its conflict-
    round tails are the reference's, in order, at their live rows: the
    reference pads a tail of n rows to bucket(n) with rows that fit
    nothing, which stay active until a round commits nothing. So where
    every live row places and there are padding rows, the reference runs
    exactly one empty round more; otherwise the same rounds."""
    counters, departed, payloads = port[2], port[3], port[4]
    assert len(payloads) == counters["engine.wave_dispatch"]
    assert all(size == 3 * n + 2 for n, size in payloads), payloads
    assert departed["engine.host_fetch_bytes"] == \
        12 * counters["engine.wave_dispatch_pods"] \
        + 8 * counters["engine.wave_dispatch"]
    tails, ref_tails = port[5], ref[5]
    assert len(tails) == len(ref_tails) \
        == counters["engine.tail_round_dispatch"]
    for (n, rounds, sel), (n_ref, ref_rounds, ref_sel) in zip(tails,
                                                            ref_tails):
        assert n_ref == jpred.bucket(n)
        np.testing.assert_array_equal(sel, ref_sel[:n])
        assert (ref_sel[n:] == -1).all()
        skipped = int(n_ref > n and bool((sel >= 0).all()))
        assert rounds == ref_rounds - skipped, (n, n_ref, sel)
    assert departed["engine.tail_rounds"] == sum(t[1] for t in tails)
    assert ref[3]["engine.tail_rounds"] == sum(t[1] for t in ref_tails)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pipelined_drain_matches_reference(name):
    build, chunk, max_batch, opts, floors = SCENARIOS[name]
    ref = _drain(REF, build, chunk, max_batch, **opts)
    port = _drain(PORT, build, chunk, max_batch, **opts)
    seq = _drain(PORT, build, chunk, max_batch, overlap=False, **opts)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    # the overlap changes wall clock, never results
    assert seq[0] == port[0]
    assert seq[1] == port[1]
    _live_rows(port, ref)
    _live_rows(seq, ref)
    for key, floor in floors.items():
        got = {**port[2], **port[3]}
        assert got[key] >= floor, (key, got)
    assert port[2]["stream.chunk_flush"] == 0
    assert port[1]["bound"] > 0


def test_fence_cases_hold_their_constraints():
    """The blind-window cases keep the constraint the fence exists for:
    no node over its two-pod capacity, the two port pods on two nodes,
    one anti pod per host, one zone for the group, one pod per zone."""
    pl, tot = _drain(PORT, _blind_capacity, 8, 0)[:2]
    assert tot["bound"] == 32 and tot["fence_requeued"] > 0
    per_node = {}
    for node in pl.values():
        if node:
            per_node[node] = per_node.get(node, 0) + 1
    assert max(per_node.values()) == 2
    pl, tot = _drain(PORT, _blind_port, 1, 0)[:2]
    assert tot["bound"] == 2 and set(pl.values()) == {"n0", "n1"}
    pl, tot = _drain(PORT, _anti_hosts, 3, 0)[:2]
    assert tot["bound"] == 8 and len(set(pl.values())) == 8
    pl, tot = _drain(PORT, _zone_group, 2, 0)[:2]
    assert tot["bound"] == 6
    assert len({int(n[1:]) % 2 for n in pl.values()}) == 1
    pl, tot = _drain(PORT, _zone_anti_blind, 1, 1)[:2]
    assert tot["bound"] == 1 and tot["unschedulable"] == 1


def test_stream_without_the_fast_lane_drains():
    """stream()'s streaming mode (adaptive micro-waves, no fast lane) runs
    the same dispatch/harvest: every pod binds, one iso-* pod of an app
    per host."""
    _types, _wl, hollow, api_mod, sched_mod, _tr = PORT
    api = api_mod.ApiServerLite()
    hollow.load_cluster(api, hollow.hollow_nodes(64),
                        hollow.PROFILES["mixed_affinity"](600))
    s = sched_mod.Scheduler(api, record_events=False, device="cpu")
    s.start()
    loop = s.stream(budget_s=0.25, min_quantum=64, max_quantum=256)
    tot = loop.drain()
    loop.close()
    s.engine.close()
    pods = api.list("Pod")[0]
    assert tot["bound"] == 600 and all(p.node_name for p in pods)
    iso = [(p.node_name, p.labels["app"]) for p in pods
           if p.affinity is not None and p.affinity.pod_anti_affinity]
    assert len(iso) == len(set(iso)) == 90


def test_overlap_is_stable_under_a_short_switch_interval():
    """The wave worker thread and the harvesting thread share nothing but
    the dispatch's copies and the job's result: with the interpreter
    switching threads every microsecond, repeated overlapped drains give
    the sequential drain's placements every time."""
    build = _profile("mixed_affinity", 64, 600)
    want = _drain(PORT, build, 64, 64, overlap=False)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            got = _drain(PORT, build, 64, 64)
            assert got[0] == want[0]
            assert got[1] == want[1]
    finally:
        sys.setswitchinterval(old)


def test_mesh_drain_matches_reference_and_unsharded():
    """Scheduler(mesh=...) on 8 CPU shards drains the mixed_affinity
    profile exactly as the reference's Scheduler on its 8-device mesh and
    as the unsharded port: placements, totals and counters."""
    build = _profile("mixed_affinity", 64, 600)
    ref = _drain(REF, build, 128, 128, mesh_shards=8)
    port = _drain(PORT, build, 128, 128, mesh_shards=8)
    flat = _drain(PORT, build, 128, 128)
    assert port[0] == ref[0] == flat[0]
    assert port[1] == ref[1] == flat[1]
    assert port[2] == ref[2] == flat[2]
    assert port[1]["bound"] == 600
    _live_rows(port, ref)
    assert port[3] == flat[3]
