"""The port's upload sanitizer (kubernetes_tpu_torch/analysis/sanitize.py),
the port's form of tests/test_pipeline_drain.py's sanitizer tests: under
GRAFT_SANITIZE=1 the pipelined drains (density and mixed_affinity, also on
a 4-shard mesh) place every pod exactly as the unsanitized runs; a copy
seam whose constructor degrades to an alias raises AliasingViolation; a
frozen seam's host source refuses a later write at the write; the mesh's
per-shard row update never aliases the live snapshot; the knob arms both
kinds of check at the seams a drain goes through, and reaches a spawned
worker of parallel/multiproc.py through the environment."""

import multiprocessing
from collections import Counter

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.analysis import sanitize
from kubernetes_tpu_torch.api import types
from kubernetes_tpu_torch.engine.scheduler import Scheduler
from kubernetes_tpu_torch.models.hollow import PROFILES, hollow_nodes
from kubernetes_tpu_torch.parallel import mesh as tmesh
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite
from kubernetes_tpu_torch.utils.trace import COUNTERS

Gi = 1 << 30


def _sched(nodes, pods, chunk, mesh=None):
    api = ApiServerLite()
    for n in nodes:
        api.create("Node", n)
    for p in pods:
        api.create("Pod", p)
    s = Scheduler(api, record_events=False, device="cpu", mesh=mesh)
    s.pipeline_chunk = chunk
    s.start()
    return api, s


def _placements(api):
    return {p.name: p.node_name for p in api.list("Pod")[0]}


def _count_seam_checks(monkeypatch):
    """Count the sanitizer's checks as the seams make them: alias checks
    (upload_copied / upload_view) and seals (upload_frozen)."""
    seen = Counter()
    real_alias, real_freeze = sanitize._assert_no_alias, sanitize.freeze

    def alias(dev, host):
        seen["alias"] += 1
        return real_alias(dev, host)

    def freeze(host):
        seen["freeze"] += 1
        return real_freeze(host)
    monkeypatch.setattr(sanitize, "_assert_no_alias", alias)
    monkeypatch.setattr(sanitize, "freeze", freeze)
    return seen


def _drain(build, mesh_shards=0):
    mesh = tmesh.make_mesh(mesh_shards, device="cpu") if mesh_shards \
        else None
    api, s = _sched(*build(), mesh=mesh)
    COUNTERS.reset()
    tot = s.run_until_drained()
    harvests = COUNTERS.count("engine.wave_dispatch")
    s.engine.close()
    return api, tot, harvests


def _density():
    return hollow_nodes(96, seed=7), PROFILES["density"](700), 128


def _anti(app, key):
    return types.Affinity(pod_anti_affinity=types.PodAffinity(
        required_terms=[types.PodAffinityTerm(
            label_selector=types.LabelSelector(match_labels={"app": app}),
            namespaces=[], topology_key=key)]))


def _mixed():
    nodes = [types.make_node(f"n{i:02d}", cpu=8000, memory=32 * Gi, pods=110,
                             labels={"host": f"h{i}", "zone": f"z{i % 2}"})
             for i in range(8)]
    pods = []
    for i in range(6):  # one-per-host anti: rides the wave path
        p = types.make_pod(f"iso-{i}", cpu=100, memory=128 << 20,
                           labels={"app": "iso"})
        p.affinity = _anti("iso", "host")
        pods.append(p)
    for i in range(4):  # zone co-location group: seeded strict tail
        p = types.make_pod(f"co-{i}", cpu=100, memory=128 << 20,
                           labels={"app": "co"})
        p.affinity = types.Affinity(pod_affinity=types.PodAffinity(
            required_terms=[types.PodAffinityTerm(
                label_selector=types.LabelSelector(
                    match_labels={"app": "co"}),
                namespaces=[], topology_key="zone")]))
        pods.append(p)
    pods += [types.make_pod(f"plain-{i}", cpu=200, memory=256 << 20)
             for i in range(12)]
    return nodes, pods, 5


def test_density_drain_under_sanitizer(monkeypatch):
    """GRAFT_SANITIZE=1 on the seeded density drain: the armed seams catch
    nothing and change nothing, and their alias checks ran."""
    seen = _count_seam_checks(monkeypatch)
    api_ref, tot_ref, _ = _drain(_density)
    assert not seen
    monkeypatch.setenv("GRAFT_SANITIZE", "1")
    api, tot, harvests = _drain(_density)
    assert tot["bound"] == tot_ref["bound"] == 700
    assert _placements(api) == _placements(api_ref)
    assert harvests > 0 and seen["alias"] > 0


@pytest.mark.parametrize("mesh_shards", [0, 4])
def test_mixed_affinity_drain_under_sanitizer(monkeypatch, mesh_shards):
    """A pipelined mixed-affinity drain with every upload seam armed, on
    one device and on a 4-shard mesh: nothing is caught, not a placement
    changes, and the constraints hold."""
    api_ref, tot_ref, _ = _drain(_mixed)
    monkeypatch.setenv("GRAFT_SANITIZE", "1")
    api, tot, harvests = _drain(_mixed, mesh_shards)
    assert tot["bound"] == tot_ref["bound"] == 22
    assert _placements(api) == _placements(api_ref), \
        "arming the sanitizer must not change placements"
    assert harvests > 0
    pods = api.list("Pod")[0]
    per_host = Counter(p.node_name for p in pods
                       if p.node_name and p.name.startswith("iso-"))
    assert all(v == 1 for v in per_host.values()), per_host
    zone_of = {n.name: n.labels["zone"] for n in api.list("Node")[0]}
    co_zone = {zone_of[p.node_name] for p in pods
               if p.node_name and p.name.startswith("co-")}
    assert len(co_zone) == 1, co_zone


def _alias(host, device):
    return torch.from_numpy(host)  # the regression: no copy


def test_sanitizer_catches_deliberate_aliasing_regression(monkeypatch):
    """Re-introduce the regression shape — a copy seam whose constructor
    silently aliases its host source — and the sanitizer raises at the
    seam, on one device, on a mesh placement and at the view seam."""
    monkeypatch.setenv("GRAFT_SANITIZE", "1")
    buf = np.arange(64 * 8, dtype=np.int32).reshape(64, 8)
    assert np.shares_memory(_alias(buf, "cpu").numpy(), buf)
    monkeypatch.setattr(sanitize, "_copy_ctor", _alias)
    with pytest.raises(sanitize.AliasingViolation):
        sanitize.upload_copied(buf, "cpu")
    mesh = tmesh.make_mesh(4, device="cpu")
    with pytest.raises(sanitize.AliasingViolation):
        sanitize.upload_copied(buf, "cpu", tmesh.Placement(mesh, 0))
    with pytest.raises(sanitize.AliasingViolation):
        sanitize.upload_view(buf, "cpu")
    # knob off: the same aliasing constructor passes unchecked
    monkeypatch.setenv("GRAFT_SANITIZE", "0")
    assert np.shares_memory(sanitize.upload_copied(buf, "cpu").numpy(), buf)


def test_sanitizer_freeze_crashes_at_the_offending_write(monkeypatch):
    """upload_frozen seals its source: a late in-place write dies at the
    WRITE site with numpy's read-only error; the upload itself is still a
    copy. With the knob off the source stays writable."""
    monkeypatch.setenv("GRAFT_SANITIZE", "1")
    host = np.ones((16, 4), dtype=np.int8)
    dev = sanitize.upload_frozen(host, "cpu")
    assert not np.shares_memory(dev.numpy(), host)
    with pytest.raises(ValueError):
        host[0, 0] = 7
    view = np.ones((8, 8), dtype=np.int32)[:, :4]  # freezing reaches its base
    sanitize.upload_frozen(view, "cpu", tmesh.Placement(
        tmesh.make_mesh(2, device="cpu"), 0))
    with pytest.raises(ValueError):
        view.base[0, 7] = 3
    monkeypatch.setenv("GRAFT_SANITIZE", "0")
    host2 = np.ones(8, dtype=np.int32)
    sanitize.upload_frozen(host2, "cpu")
    host2[0] = 5


def test_update_rows_never_aliases_the_live_snapshot(monkeypatch):
    """ResidentMesh.update_rows re-uploads only the shards owning the
    dirty rows, each a copy of its host rows (verified under sanitize),
    and keeps the other shards' tensors by reference."""
    monkeypatch.setenv("GRAFT_SANITIZE", "1")
    mesh = tmesh.make_mesh(4, device="cpu")
    rm = tmesh.ResidentMesh(mesh)
    host = np.arange(32 * 3, dtype=np.int32).reshape(32, 3)
    cur = sanitize.upload_copied(host, "cpu", tmesh.Placement(
        mesh, tmesh.node_spec("requested")))
    host[9] += 100
    host[30] += 7
    new = rm.update_rows(cur, host, [9, 30])
    np.testing.assert_array_equal(np.asarray(new), host)
    assert new.shards[0] is cur.shards[0] and new.shards[2] is cur.shards[2]
    assert new.shards[1] is not cur.shards[1]
    for s in new.shards:
        assert not np.shares_memory(s.numpy(), host)
    assert rm.touched_nbytes(host, [9, 30]) == 2 * 8 * 3 * 4
    # the regression shape is caught on this path too
    monkeypatch.setattr(sanitize, "_copy_ctor", _alias)
    with pytest.raises(sanitize.AliasingViolation):
        rm.update_rows(cur, host, [1])


@pytest.mark.parametrize("mesh_shards", [0, 4])
def test_knob_arms_both_checks_at_a_drains_seams(monkeypatch, mesh_shards):
    """A mixed-affinity drain goes through both kinds of seam: under
    GRAFT_SANITIZE=1 its copies are alias-checked and its frozen sources
    sealed, on one device and on a 4-shard mesh; with the knob off the
    seams check and seal nothing."""
    seen = _count_seam_checks(monkeypatch)
    _drain(_mixed, mesh_shards)
    assert not seen
    monkeypatch.setenv("GRAFT_SANITIZE", "1")
    _drain(_mixed, mesh_shards)
    assert seen["alias"] > 0 and seen["freeze"] > 0, seen


def _report_knob(cfg, out_q):
    """Spawn target: run a fleet worker of parallel/multiproc.py, counting
    the sanitizer's alias checks its uploads made, then report the knob
    as the child saw it."""
    from kubernetes_tpu_torch.analysis import sanitize as san
    from kubernetes_tpu_torch.parallel.multiproc import _worker_main
    seen = []
    real = san._assert_no_alias

    def counting(dev, host):
        seen.append(1)
        return real(dev, host)
    san._assert_no_alias = counting
    _worker_main(cfg, out_q)
    out_q.put({"sanitize": san.enabled(), "checks": len(seen)})


def test_knob_reaches_a_spawned_fleet_worker(monkeypatch):
    """GRAFT_SANITIZE=1 in the parent's environment arms the seams of a
    spawned multiproc worker: the child reads the knob per call from its
    inherited environment, and its evaluator's uploads are checked."""
    from kubernetes_tpu_torch.server import framing
    from kubernetes_tpu_torch.server.asyncwire import AsyncBinaryServer
    from kubernetes_tpu_torch.server.embedded import VerdictService
    from kubernetes_tpu_torch.server.extender import TPUExtenderBackend

    monkeypatch.setenv("GRAFT_SANITIZE", "1")
    backend = TPUExtenderBackend(device="cpu")
    backend.sync_nodes(hollow_nodes(8))
    srv = AsyncBinaryServer(VerdictService(backend))
    srv.start()
    pods = [types.make_pod(f"san-{i}", cpu=100, memory=64 << 20)
            for i in range(2)]
    cfg = {"worker_id": 0, "host": "127.0.0.1", "port": srv.port,
           "pods_blob": framing.encode_items_blob(pods, "pods"),
           "device": "cpu"}
    ctx = multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    proc = ctx.Process(target=_report_knob, args=(cfg, out_q), daemon=True)
    proc.start()
    try:
        msgs = []
        while not msgs or "sanitize" not in msgs[-1]:
            msgs.append(out_q.get(timeout=120))
        proc.join(timeout=30)
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=5)
        srv.stop()
    assert msgs[0]["counts"]["binds"] == 2
    assert msgs[-1]["sanitize"] is True
    assert msgs[-1]["checks"] > 0
