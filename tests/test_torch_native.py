"""The port's host-ops loader (native/__init__.py) against the reference's.
The bodies of tests/test_native.py run on both packages (the `k` fixture):
the C++ library builds and loads, and its port bitmaps, multi-hot rows
and FNV-1a hash equal the pure-Python fallbacks; the snapshot's label
matrix rebuild goes through the batch scatter. Then the two packages are
held against each other: the port's three functions equal the
reference's on seeded inputs, and the port's snapshot label matrix equals
the reference's with the library loaded and with the fallback forced.

Each case loads a copy of the library of its own: the package's `_SO` is
pointed at a library built once per package into a temporary directory
(g++ on the shared native/hostops.cc), so that a `make clean` of the
repository's build in another test worker cannot pull the shared
native/libhostops.so away mid-case. The `make` and pause build cases of
tests/test_native.py test build/, not a module, and stay there."""

from __future__ import annotations

import os
import random
import shutil

import numpy as np
import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "api_types": "api.types",
    "hollow": "models.hollow",
    "native": "native",
    "state_node_info": "state.node_info",
    "state_snapshot": "state.snapshot",
}

PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HAVE_GXX = shutil.which("g++") is not None


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Per package, a library built from the shared source by the
    package's own loader into a directory of its own."""
    out = {}
    for root in (REF, PORT):
        native = PKGS[root].native
        so = str(tmp_path_factory.mktemp(root) / "libhostops.so")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(native, "_SO", so)
            mp.setattr(native, "_lib", None)
            mp.setattr(native, "_tried", False)
            native.lib()
        out[root] = so
    return out


def _own_library(mp, root, so):
    """Point the package's loader at its own built copy."""
    native = PKGS[root].native
    mp.setattr(native, "_SO", so)
    mp.setattr(native, "_lib", None)
    mp.setattr(native, "_tried", False)


def _python_only(mp, native):
    """Force the fallback path regardless of the loaded library."""
    mp.setattr(native, "_lib", None)
    mp.setattr(native, "_tried", True)


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request, built, monkeypatch):
    _own_library(monkeypatch, request.param, built[request.param])
    return PKGS[request.param]


def test_port_loader_resolves_the_repository_root():
    port, ref = PKGS[PORT].native, PKGS[REF].native
    assert port._ROOT == ref._ROOT == ROOT
    assert port._SRC == ref._SRC == os.path.join(ROOT, "native",
                                                 "hostops.cc")


@pytest.mark.skipif(not HAVE_GXX, reason="no g++ in image")
def test_hostops_builds_and_loads(k, built):
    assert k.native.available(), "hostops must build on demand with g++"
    assert os.path.exists(built[k.root])


def _port_pairs(seed):
    rng = random.Random(seed)
    return np.array([[rng.randrange(0, 64),
                      rng.randrange(-5, 70000)]  # incl. out-of-range
                     for _ in range(500)], dtype=np.int64)


def _hot_pairs(seed):
    rng = random.Random(seed)
    return np.array([[rng.randrange(-2, 40), rng.randrange(-2, 70)]
                     for _ in range(400)], dtype=np.int64)


@pytest.mark.skipif(not HAVE_GXX, reason="no g++ in image")
def test_port_bitmaps_native_matches_python(k):
    pairs = _port_pairs(7)
    a = np.zeros((64, 2048), dtype=np.uint32)
    k.native.fill_port_bitmaps(pairs, a)
    b = np.zeros((64, 2048), dtype=np.uint32)
    with pytest.MonkeyPatch.context() as mp:
        _python_only(mp, k.native)
        k.native.fill_port_bitmaps(pairs, b)
    np.testing.assert_array_equal(a, b)
    assert a.any()


@pytest.mark.skipif(not HAVE_GXX, reason="no g++ in image")
def test_multi_hot_native_matches_python(k):
    pairs = _hot_pairs(11)
    a = np.zeros((32, 64), dtype=np.int8)
    k.native.fill_multi_hot(pairs, a)
    b = np.zeros((32, 64), dtype=np.int8)
    with pytest.MonkeyPatch.context() as mp:
        _python_only(mp, k.native)
        k.native.fill_multi_hot(pairs, b)
    np.testing.assert_array_equal(a, b)
    assert a.any()


@pytest.mark.skipif(not HAVE_GXX, reason="no g++ in image")
def test_fnv1a64_native_matches_python(k):
    for data in (b"", b"x", b"kubernetes-tpu", bytes(range(256)) * 3):
        got = k.native.fnv1a64(data)
        with pytest.MonkeyPatch.context() as mp:
            _python_only(mp, k.native)
            want = k.native.fnv1a64(data)
        assert got == want


def test_snapshot_label_rebuild_uses_batch_scatter(k):
    """The wiring point: finalize_labels' full-matrix rebuild goes through
    fill_multi_hot and stays correct (vs the logical per-row content)."""
    nodes = [k.make_node(f"n{i}", labels={"zone": f"z{i % 3}",
                                          "disk": "ssd" if i % 2 else "hdd"})
             for i in range(16)]
    snap = k.ClusterSnapshot()
    snap.refresh(k.node_info_map(nodes, []))
    # grow the demand-driven vocab -> full rebuild through the batch scatter
    pod = k.make_pod("p", node_selector={"zone": "z1", "disk": "ssd"})
    k.PodBatch([pod], snap)
    # every INTERNED pair's column carries exactly its nodes' bits (the
    # vocab is selector-demand-driven; un-referenced labels have no column)
    for key, val in (("zone", "z1"), ("disk", "ssd")):
        col = snap.label_vocab.get(key, val)
        assert col >= 0
        for n in nodes:
            row = snap.node_index[n.name]  # rows are sorted-name order
            want = 1 if n.labels.get(key) == val else 0
            assert snap.labels[row, col] == want, (n.name, key, val)


def test_snapshot_scatter_calls_the_native_encoder(k, monkeypatch):
    """The snapshot's label scatter reaches the package's own
    native.fill_multi_hot (the port calls it as the reference does)."""
    calls = []
    real = k.native.fill_multi_hot

    def spy(pairs, out):
        calls.append(len(pairs))
        return real(pairs, out)

    monkeypatch.setattr(k.native, "fill_multi_hot", spy)
    nodes = [k.make_node(f"n{i}", labels={"zone": f"z{i % 3}"})
             for i in range(6)]
    snap = k.ClusterSnapshot()
    snap.refresh(k.node_info_map(nodes, []))
    k.PodBatch([k.make_pod("p", node_selector={"zone": "z2"})], snap)
    assert calls and sum(calls) >= 2


# ------------------------------------------------ the two packages, equal

MODES = ["library", "fallback"]


def _both(built, mode):
    """Enter each package's loader in `mode`; returns the context."""
    mp = pytest.MonkeyPatch()
    for root in (REF, PORT):
        _own_library(mp, root, built[root])
        if mode == "fallback":
            _python_only(mp, PKGS[root].native)
        elif HAVE_GXX:
            assert PKGS[root].native.available()
    return mp


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_ops_equal_the_reference(built, mode, seed):
    data = np.random.default_rng(seed).integers(
        0, 256, size=1 + 97 * seed, dtype=np.uint8).tobytes()
    mp = _both(built, mode)
    try:
        got = {}
        for root in (REF, PORT):
            native = PKGS[root].native
            bm = np.zeros((64, 2048), dtype=np.uint32)
            native.fill_port_bitmaps(_port_pairs(seed), bm)
            hot = np.zeros((32, 64), dtype=np.int8)
            native.fill_multi_hot(_hot_pairs(seed), hot)
            got[root] = (bm, hot, native.fnv1a64(data))
        np.testing.assert_array_equal(got[PORT][0], got[REF][0])
        np.testing.assert_array_equal(got[PORT][1], got[REF][1])
        assert got[PORT][2] == got[REF][2]
    finally:
        mp.undo()


def _label_matrix(k, n_nodes, seed):
    rng = random.Random(seed)
    nodes = k.hollow_nodes(n_nodes, seed=seed, heterogeneous=True,
                           gpu_fraction=0.2, taint_fraction=0.1)
    for n in nodes:
        n.labels = dict(n.labels, rack=f"r{rng.randrange(8)}",
                        disk=rng.choice(["ssd", "hdd"]))
    snap = k.ClusterSnapshot()
    snap.refresh(k.node_info_map(nodes, []))
    sel = [{"rack": f"r{i}", "disk": "ssd"} for i in range(8)]
    sel += [{"failure-domain.beta.kubernetes.io/zone": z}
            for z in k.ZONES]
    sel += [{"accelerator": "nvidia"}]
    k.PodBatch([k.make_pod(f"p{i}", node_selector=s)
                for i, s in enumerate(sel)], snap)
    return snap


@pytest.mark.parametrize("mode", MODES)
def test_snapshot_label_matrix_equals_the_reference(built, mode):
    mp = _both(built, mode)
    try:
        ref = _label_matrix(PKGS[REF], 200, 5)
        port = _label_matrix(PKGS[PORT], 200, 5)
        assert port.labels.shape == ref.labels.shape
        np.testing.assert_array_equal(port.labels, ref.labels)
        assert port.node_index == ref.node_index
        assert port.labels.any()
    finally:
        mp.undo()
