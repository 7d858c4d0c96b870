"""The port's own versions of the kernel-table helpers of the reference's
tests: test_predicates_kernel's `kernel_fits_matrix`, the `build` of
test_priorities_kernel and test_priorities_ext, test_priorities_ext's
`kernel_scores` and test_volumes' `_kernel_matrix`, built on
ops.predicates.fits, pod_arrays_bucketed, node_arrays(snap, device) and
priorities.score, and cropped to the live rows and columns. The
inter-pod oracle calls of test_priorities_ext also go through the fused
verdict (engine.scheduler_engine.evaluate_pod), so that the incidence
product runs at those tables' shapes.

`Tables(device, against, translate)` runs them on one device and holds
every (pod, node) cell equal to the same helper of `against`, called on
`translate` of the same inputs: the reference's helpers (on the
reference's twins of the objects) in tests/test_torch_kernel_tables.py,
the port's CPU route (on the objects themselves) in chip_smoke.py's
phase 17. Imports only kubernetes_tpu_torch."""

from __future__ import annotations

import importlib
import types

import numpy as np
import torch

PKG = "kubernetes_tpu_torch"
# what the port's `k` of the kernel tables takes from a Tables
NAMES = ("kernel_fits_matrix", "build", "kernel_scores", "_kernel_matrix",
         "pod_arrays", "node_arrays", "place_batch", "prio", "oracle_ext",
         "jnp")
# the inter-pod verdicts are read with this priority alone
INTERPOD = (("InterPodAffinityPriority", 1),)


def _mod(name):
    return importlib.import_module(f"{PKG}.{name}")


def _np(t):
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class Tables:
    """The table helpers on `device`, each result held equal to
    `against`'s (when given) on `translate` of the same arguments.
    `cells` counts the (pod, node) cells so held, `verdicts` the
    inter-pod oracle answers matched by the fused verdict."""

    def __init__(self, device, against=None, translate=None):
        self.device = torch.device(device)
        self.against = against
        self.translate = translate or (lambda obj: obj)
        self.cells = 0
        self.verdicts = 0
        self._pred = _mod("ops.predicates")
        self._prio = _mod("ops.priorities")
        self._snap = _mod("state.snapshot")
        self._node_info = _mod("state.node_info")
        self._volumes = _mod("state.volumes")
        self._engine = _mod("engine.scheduler_engine")
        self._batch = _mod("engine.batch")
        # pod arrays of build() -> what score() holds them against
        self._built = {}
        self.prio = _Priorities(self)
        self.oracle_ext = _InterPodRoute(self)
        dev = self.device
        self.jnp = types.SimpleNamespace(
            uint32=lambda v: torch.tensor(int(v), dtype=torch.int64,
                                          device=dev))

    def __repr__(self):
        return f"Tables({self.device})"

    # ------------------------------------------------------------ inputs

    def _encode(self, pods, nodes, bound=(), ctx=None):
        infos = self._node_info.node_info_map(nodes, list(bound))
        snap = self._snap.ClusterSnapshot()
        if ctx is None:
            snap.refresh(infos)
        else:
            snap.refresh(infos, volume_ctx=ctx)
        return infos, snap, self._snap.PodBatch(pods, snap)

    def pod_arrays(self, batch):
        return self._pred.pod_arrays_bucketed(batch, self.device)

    def node_arrays(self, snap):
        return self._pred.node_arrays(snap, self.device)

    def place_batch(self, *args, **kw):
        """engine.batch.place_batch with its tensors handed back on the
        CPU (numpy reads them there)."""
        return tuple(t.cpu() if torch.is_tensor(t) else t
                     for t in self._batch.place_batch(*args, **kw))

    def _fits(self, batch, snap):
        m = self._pred.fits(self.pod_arrays(batch), self.node_arrays(snap))
        return _np(m)[:len(batch), :len(snap.node_names)]

    def _hold(self, name, got, *args):
        """`got` equal, cell by cell, to `against`'s `name` on the
        translated arguments (its first result, cropped to got's
        shape)."""
        if self.against is None:
            return
        want = getattr(self.against, name)(*map(self.translate, args))
        want = np.asarray(_np(want[0]))[:got.shape[0], :got.shape[1]]
        np.testing.assert_array_equal(
            got, want, err_msg=f"{name} on {self!r} != {self.against!r}")
        self.cells += got.size

    # ----------------------------------------------------------- helpers

    def kernel_fits_matrix(self, pods, nodes, bound_pods=()):
        infos, snap, batch = self._encode(pods, nodes, bound_pods)
        m = self._fits(batch, snap)
        self._hold("kernel_fits_matrix", m, pods, nodes, bound_pods)
        return m, snap.node_names, infos, batch

    def _kernel_matrix(self, pods, nodes, bound=(), ctx=None):
        infos, snap, batch = self._encode(
            pods, nodes, bound, ctx or self._volumes.VolumeContext())
        m = self._fits(batch, snap)
        self._hold("_kernel_matrix", m, pods, nodes, bound, ctx)
        return m, snap, infos, batch

    def build(self, pods, nodes, bound=()):
        infos, snap, batch = self._encode(pods, nodes, bound)
        parrs, narrs = self.pod_arrays(batch), self.node_arrays(snap)
        if self.against is not None:
            twin = self.against.build(*map(self.translate,
                                           (pods, nodes, bound)))
            self._built[id(parrs)] = (parrs, twin[0], twin[1], len(pods),
                                      len(snap.node_names))
        return parrs, narrs, snap, infos

    def kernel_scores(self, pods, nodes, pset, bound=()):
        infos, snap, batch = self._encode(pods, nodes, bound)
        parrs, narrs = self.pod_arrays(batch), self.node_arrays(snap)
        ones = torch.ones((parrs["nonzero"].shape[0],
                           narrs["alloc"].shape[0]), dtype=torch.bool,
                          device=self.device)
        got = _np(self._prio.score(parrs, narrs, pset, ones))
        got = got[:len(pods), :len(snap.node_names)]
        self._hold("kernel_scores", got, pods, nodes, pset, bound)
        return got, snap, infos

    def verdict(self, pod, nodes, bound, priorities):
        """evaluate_pod of `pod` against `nodes` with `bound` on them:
        (fits [N], scores [N], node names), held equal to `against`'s."""
        infos = self._node_info.node_info_map(list(nodes), list(bound))
        snap = self._snap.ClusterSnapshot()
        snap.refresh(infos)
        fits, scores = self._engine.evaluate_pod(pod, infos, snap,
                                                 priorities,
                                                 device=self.device)
        fits, scores = np.asarray(fits), np.asarray(scores)
        if self.against is not None:
            tf, ts, tn = self.against.verdict(
                self.translate(pod), self.translate(list(nodes)),
                self.translate(list(bound)), priorities)
            assert list(tn) == list(snap.node_names), (tn, snap.node_names)
            np.testing.assert_array_equal(fits, np.asarray(tf))
            np.testing.assert_array_equal(scores, np.asarray(ts))
            self.cells += 2 * len(snap.node_names)
        return fits, scores, snap.node_names


class _Priorities:
    """ops.priorities whose `score` of build()'s arrays is held equal to
    `against`'s on its twin arrays, and handed back on the CPU."""

    def __init__(self, tables):
        self._t = tables

    def __getattr__(self, name):
        return getattr(self._t._prio, name)

    def score(self, pods, nodes, priorities, fits=None):
        t = self._t
        got = _np(t._prio.score(pods, nodes, priorities, fits))
        rec = t._built.get(id(pods))
        if rec is not None and rec[0] is pods and fits is None:
            _, tp, tn, p, n = rec
            want = _np(t.against.prio.score(tp, tn, priorities))
            np.testing.assert_array_equal(
                got[:p, :n], np.asarray(want)[:p, :n],
                err_msg=f"score {priorities} on {t!r} != {t.against!r}")
            t.cells += p * n
        return got


class _InterPodRoute:
    """ops.oracle_ext whose inter-pod answers are also read from the fused
    verdict (evaluate_pod over the context's nodes and pods) and must
    agree with the oracle's."""

    def __init__(self, tables):
        self._t = tables
        self._oracle = _mod("ops.oracle_ext")

    def __getattr__(self, name):
        return getattr(self._oracle, name)

    def _verdict(self, pod, ctx):
        infos = ctx.infos
        nodes = [i.node for i in infos.values()]
        bound = [p for i in infos.values() for p in i.pods]
        fits, scores, names = self._t.verdict(pod, nodes, bound, INTERPOD)
        col = {nm: i for i, nm in enumerate(names)}
        return fits, scores, col

    def inter_pod_affinity_fits(self, pod, node, ctx):
        want = self._oracle.inter_pod_affinity_fits(pod, node, ctx)
        fits, _, col = self._verdict(pod, ctx)
        got = bool(fits[col[node.name]])
        assert got == want, (pod.name, node.name, got, want)
        self._t.verdicts += 1
        return want

    def interpod_affinity_scores(self, pod, infos, ctx):
        want = self._oracle.interpod_affinity_scores(pod, infos, ctx)
        _, scores, col = self._verdict(pod, ctx)
        got = [int(scores[col[i.node.name]]) for i in infos]
        assert got == list(want), (pod.name, got, want)
        self._t.verdicts += 1
        return want
