"""The reference's snapshot contracts (tests/test_snapshot.py) on both
packages: the per-array dirty tracking, the pod-demand-driven label
vocabulary, conservative quantization, the membership rebuild after a
node is removed and added again, and the bulk rebuild equal to the
per-row writers. Each body runs through the `k` fixture with the seeded
cluster generator built on that package's types."""

from __future__ import annotations

import random

import numpy as np

import pytest

from tests.torch_packages import (PORT, REF, Pkg, helpers,
                                   reference_test_module)

MODULES = {
    "api_types": "api.types",
    "state_node_info": "state.node_info",
    "state_snapshot": "state.snapshot",
}
HELPER_NAMES = ('Gi', 'random_nodes', 'random_pod')


def _pkg(root):
    h = helpers(root)
    return Pkg(root, MODULES,
               extra={n: getattr(h, n) for n in HELPER_NAMES})


PKGS = {root: _pkg(root) for root in (REF, PORT)}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


def build(k, n_nodes=24, seed=3):
    rng = random.Random(seed)
    nodes = k.random_nodes(rng, n_nodes)
    infos = k.node_info_map(nodes, [])
    snap = k.ClusterSnapshot()
    snap.refresh(infos)
    return rng, nodes, infos, snap


def test_pod_add_marks_only_dynamic_arrays_dirty(k):
    rng, nodes, infos, snap = build(k)
    k.PodBatch([k.random_pod(rng, i, [n.name for n in nodes]) for i in range(30)], snap)
    snap.dirty.clear()
    p = k.make_pod("x", cpu=100, memory=1 * k.Gi)
    p.node_name = nodes[0].name
    infos[nodes[0].name].add_pod(p)
    assert not snap.refresh(infos)  # delta, not rebuild
    assert snap.dirty == {"requested", "nonzero", "pod_count"}


def test_pod_with_ports_also_dirties_port_bitmap(k):
    rng, nodes, infos, snap = build(k)
    snap.dirty.clear()
    p = k.make_pod("y", ports=[8080])
    p.node_name = nodes[1].name
    infos[nodes[1].name].add_pod(p)
    snap.refresh(infos)
    assert snap.dirty == {"requested", "nonzero", "pod_count", "port_bitmap"}


def test_node_spec_change_dirties_static_arrays(k):
    """Change detection: a spec change dirties exactly the
    arrays whose values moved; re-setting an identical spec (the respawn
    /flap-heavy churn shape) dirties NO static array — a dirty mark per
    fault event re-uploaded megabytes and invalidated the cached wave
    precompute once per kill, which measured as the churn collapse."""
    import dataclasses
    rng, nodes, infos, snap = build(k)
    snap.dirty.clear()
    infos[nodes[2].name].set_node(nodes[2])  # identical values
    snap.refresh(infos)
    assert not (snap.dirty & set(snap.STATIC)), snap.dirty
    snap.dirty.clear()
    node = nodes[2]
    changed = dataclasses.replace(
        node, labels=dict(node.labels, zone="zz-new"),
        allocatable=dataclasses.replace(node.allocatable,
                                        milli_cpu=node.allocatable.milli_cpu
                                        + 1000))
    # intern the new pair so the label ROW actually changes content
    snap.ensure_label_pair("zone", "zz-new")
    snap.finalize_labels()
    infos[node.name].set_node(changed)
    snap.refresh(infos)
    assert "labels" in snap.dirty and "alloc" in snap.dirty


def test_label_vocab_is_pod_demand_driven(k):
    # node-unique labels (hostname-style) must not widen the label matrix
    nodes = [k.make_node(f"n{i}", labels={"hostname": f"n{i}", "zone": "a"})
             for i in range(100)]
    infos = k.node_info_map(nodes, [])
    snap = k.ClusterSnapshot()
    snap.refresh(infos)
    k.PodBatch([k.make_pod("p", node_selector={"zone": "a"})], snap)
    assert snap.labels.shape[1] <= 8  # only 'zone=a' interned (+padding)
    # selecting a hostname interns exactly that pair and still matches
    k.PodBatch([k.make_pod("q", node_selector={"hostname": "n42"})], snap)
    assert len(snap.label_vocab) == 2


def test_identical_batches_do_not_rebuild_labels(k):
    rng, nodes, infos, snap = build(k)
    pods = [k.random_pod(rng, i, [n.name for n in nodes]) for i in range(30)]
    k.PodBatch(pods, snap)
    v0 = snap.version
    k.PodBatch(pods, snap)
    assert snap.version == v0


def test_quantization_is_conservative(k):
    snap = k.ClusterSnapshot()
    infos = k.node_info_map([k.make_node("n", memory=1 * k.Gi + 512)], [])
    snap.refresh(infos)
    i = snap.node_index["n"]
    # allocatable rounds DOWN (can't overcommit via quantization)
    assert snap.alloc[i, 1] == (1 * k.Gi + 512) >> 10
    p = k.make_pod("p", memory=1023)  # request rounds UP to 1 KiB
    b = k.PodBatch([p], snap)
    assert b.req[0, 1] == 1


def test_removed_then_readded_node_membership_rebuild(k):
    rng, nodes, infos, snap = build(k, n_nodes=9)
    del infos[nodes[0].name]
    assert snap.refresh(infos)  # membership change -> rebuild
    assert nodes[0].name not in snap.node_index


def test_unknown_extended_resource_marks_pod_impossible(k):
    # a pod requesting an ext resource NO node advertises must become
    # unschedulable, not crash the batch build (padded-vocab overflow)
    rng, nodes, infos, snap = build(k, n_nodes=8)
    pods = [k.make_pod(f"x{i}", cpu=100,
                     extended={f"example.com/weird-{i}": 1}) for i in range(6)]
    b = k.PodBatch(pods, snap)
    assert b.impossible.all()
    sane = k.PodBatch([k.make_pod("ok", cpu=100)], snap)
    assert not sane.impossible.any()


def test_bound_pod_with_unknown_extended_resource_interned_on_refresh(k):
    rng, nodes, infos, snap = build(k, n_nodes=8)
    p = k.make_pod("b", cpu=100, extended={"example.com/foreign": 2})
    p.node_name = nodes[0].name
    infos[nodes[0].name].add_pod(p)
    snap.refresh(infos)  # must not raise; vocab grows, arrays widen
    assert snap.ext_vocab.get("example.com/foreign", "") >= 0


def test_bulk_rebuild_matches_per_row_writers(k):
    """The vectorized full-rebuild path (_write_rows_bulk) must produce
    byte-identical arrays to the per-row delta writers over a feature-rich
    random cluster: re-running the per-row writers on every row after a
    bulk build must change nothing."""
    import random

    import numpy as np

    # the reference's generators, built on this package's types
    fuzz = reference_test_module("test_full_fuzz", k.root)

    rng = random.Random(31)
    nodes = fuzz.full_random_nodes(rng, 24)
    existing = fuzz._existing(rng, nodes, 16)
    infos = k.node_info_map(nodes, existing)
    snap = k.ClusterSnapshot()
    snap.refresh(infos)  # full build -> bulk path

    arrays = ("alloc", "requested", "nonzero", "pod_count", "allowed_pods",
              "schedulable", "mem_pressure", "disk_pressure", "labels",
              "taints_sched", "taints_pref", "port_bitmap", "valid",
              "avoid", "image_sizes", "has_zone", "vol_present", "vol_rw",
              "pd_present", "pd_counts")
    before = {kk: np.copy(getattr(snap, kk)) for kk in arrays}
    for nm in snap.node_names:
        i = snap.node_index[nm]
        snap._write_dynamic_row(i, infos[nm])
        snap._write_static_row(i, infos[nm])
        snap._write_ports_row(i, infos[nm])
    for kk in arrays:
        np.testing.assert_array_equal(
            getattr(snap, kk), before[kk], err_msg=f"bulk != per-row for {kk}")
