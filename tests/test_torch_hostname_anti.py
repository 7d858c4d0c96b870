"""The port's required anti-affinity on the wave path, held against a
plain-PyTorch reference written from the v1.7 predicate
(benchmark/reference/anti_mask.py, the one the benchmark's check uses):
the per-wave mask (_wave_aff_mask, built from AffinityData on the CPU)
equals the reference's forbidden nodes wave after wave of a drain (and the engine's count of the cells each
dispatch's first wave forbids agrees), the one-pod-per-node gate admits
what the reference's gate admits, and a whole Scheduler drain leaves no
pod on a node its own terms or another pod's terms forbid.

Each case is a seeded mix on 64 nodes: 2-4 templates with hostname and
zone terms, self and cross-template, over a cluster holding bound pods
that carry terms of their own."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference.anti_mask import forbidden, gate_accept, violations
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.engine import waves as twaves
from kubernetes_tpu_torch.engine.scheduler import Scheduler
from kubernetes_tpu_torch.engine.scheduler_engine import SchedulingEngine
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite
from kubernetes_tpu_torch.state.cache import SchedulerCache
from kubernetes_tpu_torch.utils.trace import COUNTERS

HOST = "kubernetes.io/hostname"
ZONE = "failure-domain.beta.kubernetes.io/zone"
NS = "bench"
N_NODES = 64
SEEDS = [0, 1, 2, 3, 4, 5]


class Mix:
    """A seeded cluster, its bound pods and the pending pods' templates,
    as plain data."""

    def __init__(self, seed: int):
        rng = np.random.default_rng(seed)
        self.names = [f"node-{i}" for i in range(N_NODES)]
        # every ninth node carries no zone label: it shares no zone
        self.zone = np.where(np.arange(N_NODES) % 9 == 8, -1,
                             rng.integers(0, 3, N_NODES))
        t = int(rng.integers(2, 5))
        apps = [f"a{j}" for j in range(t)]
        self.templates = []
        for j in range(t):
            labels = {"app": apps[j]}
            if rng.random() < 0.5:
                labels["tier"] = "web"
            anti = []
            if j == 0 or rng.random() < 0.6:
                anti.append(({"app": apps[j]}, HOST))
            if j and rng.random() < 0.5:
                anti.append(({"app": apps[int(rng.integers(0, t))]}, HOST))
            if j and rng.random() < 0.25:
                anti.append(({"tier": "web"}, HOST))
            if j and rng.random() < 0.25:
                # a zone term routes its class, and the classes it
                # targets, to the strict tail: never the first template,
                # which keeps one gated class in every mix
                anti.append(({"app": apps[int(rng.integers(1, t))]}, ZONE))
            self.templates.append((labels, anti))
        # bound pods, some with terms of their own (zone ones among them)
        self.bound = []
        for _ in range(int(rng.integers(6, 14))):
            labels = {"app": str(rng.choice(apps + ["other"]))}
            anti = []
            if rng.random() < 0.5:
                key = HOST if rng.random() < 0.6 else ZONE
                anti.append(({"app": str(rng.choice(apps))}, key))
            self.bound.append((labels, anti, int(rng.integers(0, N_NODES))))
        # half a node's CPU on all but every eighth node: the empty ones
        # score best, so a class's pods draw from a few tied nodes and
        # meet on them, where the gate has to choose
        self.heavy = len(self.bound)
        self.bound += [({"app": "filler"}, [], i) for i in range(N_NODES)
                       if i % 8]
        counts = rng.integers(8, 17, t)
        self.pending = [int(j) for j in
                        rng.permutation(np.repeat(np.arange(t), counts))]

    def nodes(self):
        out = []
        for i, name in enumerate(self.names):
            labels = {HOST: name}
            if self.zone[i] >= 0:
                labels[ZONE] = f"zone-{self.zone[i]}"
            out.append(tt.make_node(name, labels=labels))
        return out

    def _pod(self, name, labels, anti, node="", cpu=100):
        aff = None
        if anti:
            aff = tt.Affinity(pod_anti_affinity=tt.PodAffinity(
                required_terms=[tt.PodAffinityTerm(
                    label_selector=tt.LabelSelector(match_labels=dict(sel)),
                    namespaces=[], topology_key=key) for sel, key in anti]))
        return tt.make_pod(name, namespace=NS, cpu=cpu, memory=1 << 28,
                           labels=dict(labels), affinity=aff,
                           node_name=node)

    def bound_pods(self):
        return [self._pod(f"bound-{i}", labels, anti, self.names[node],
                          2000 if i >= self.heavy else 100)
                for i, (labels, anti, node) in enumerate(self.bound)]

    def pending_pods(self):
        return [self._pod(f"p-{i}", *self.templates[j])
                for i, j in enumerate(self.pending)]

    def domains(self, order):
        """Each key's domain per row of a node order (names; padding rows,
        not in the cluster, are -1)."""
        idx = {n: i for i, n in enumerate(self.names)}
        rows = [idx.get(n, -1) for n in order]
        host = torch.tensor(rows, dtype=torch.int64)
        zone = torch.tensor([int(self.zone[r]) if r >= 0 else -1
                             for r in rows], dtype=torch.int64)
        return {HOST: host, ZONE: zone}, rows

    def template_of(self, pod):
        return next(j for j, (labels, _) in enumerate(self.templates)
                    if labels == pod.labels)


def _engine_drain(mix: Mix, chunk: int, monkeypatch):
    """The engine's pipelined path on the CPU, one chunk at a time (each
    dispatched and harvested, fence conflicts dispatched again), with
    every wave's inputs and outputs recorded from inside the wave loop.
    Each record carries the encoding its dispatch used, the pods the
    engine had assumed before that encoding was built (its static side
    holds them; the occupancy carry holds the commits since), and whether
    it is its dispatch's first wave; with it comes the drain's count of
    engine.wave_forbid_cells."""
    cache = SchedulerCache()
    for nd in mix.nodes():
        cache.add_node(nd)
    for p in mix.bound_pods():
        cache.add_pod(p)
    eng = SchedulingEngine(cache, device="cpu")
    waves = []
    real = twaves._wave_once

    def spy(cls, nodes, state, pre, pod_class, active, counter, priorities,
            aff=None, committed=None, col=None):
        out = real(cls, nodes, state, pre, pod_class, active, counter,
                   priorities, aff=aff, committed=committed, col=col)
        if aff is not None:
            waves.append({"committed": committed.clone(),
                          "mask": twaves._wave_aff_mask(aff, committed),
                          "gate": aff["wave_gate"].clone(),
                          "pod_class": pod_class.clone(),
                          "active": active.clone(),
                          "sel": out[0].clone(), "accepted": out[1].clone()})
        return out

    monkeypatch.setattr(twaves, "_wave_once", spy)
    queue = mix.pending_pods()
    assumed, base, enc = [], [], None
    c0 = COUNTERS.snapshot().get("engine.wave_forbid_cells", (0, 0.0))[0]
    try:
        while queue:
            n0 = len(waves)
            h = eng.dispatch_waves(queue[:chunk])
            queue = queue[chunk:]
            if h.enc is not enc:
                enc, base = h.enc, list(assumed)
            res = eng.harvest_waves(h)
            for w in waves[n0:]:
                w["enc"], w["base"], w["first"] = enc, base, False
            if len(waves) > n0:
                waves[n0]["first"] = True
            assumed += [(p, p.node_name) for p in res.bound]
            queue += list(res.conflicts)
    finally:
        eng.close()
    forbid_cells = COUNTERS.snapshot().get("engine.wave_forbid_cells",
                                           (0, 0.0))[0] - c0
    return eng, waves, forbid_cells


@pytest.mark.parametrize("seed", SEEDS)
def test_wave_mask_equals_the_plain_reference_wave_after_wave(seed,
                                                              monkeypatch):
    mix = Mix(seed)
    eng, waves, forbid_cells = _engine_drain(mix, 16, monkeypatch)
    assert waves
    n_pad = waves[0]["committed"].shape[1]
    order = eng.snapshot.node_names
    domains, rows = mix.domains(order + [""] * (n_pad - len(order)))
    real_cols = torch.tensor([r >= 0 for r in rows])
    # the bound pods' nodes as snapshot rows
    row_of = {nm: i for i, nm in enumerate(order)}
    bound = [(labels, anti, row_of[mix.names[node]])
             for labels, anti, node in mix.bound]
    checked = 0
    for w in waves:
        enc = w["enc"]
        templates = [mix.templates[mix.template_of(rep)]
                     for rep in enc.reps]
        eligible = ~torch.from_numpy(enc.wave_strict[:enc.num_classes])
        before = [(*mix.templates[mix.template_of(p)], row_of[node])
                  for p, node in w["base"]]
        comm = w["committed"][:enc.num_classes]
        placed = [(*templates[c], int(n))
                  for c, n in comm.nonzero().tolist()
                  for _ in range(int(comm[c, n]))]
        ref = forbidden(domains, bound + before + placed, templates)
        got = w["mask"][:enc.num_classes]
        for c in torch.nonzero(eligible).flatten().tolist():
            assert torch.equal(got[c][real_cols], ~ref[c][real_cols]), \
                (seed, c)
            checked += 1
        # the gate: a gated pod is accepted exactly when the reference's
        # gate admits it, and no pod the gate refuses is accepted
        pc = w["pod_class"]
        sel = torch.where(w["active"], w["sel"], -1)
        admit = gate_accept(sel, pc, w["gate"])
        acc = w["accepted"] & w["active"]
        assert not (acc & ~admit).any(), seed
        gated = w["gate"][pc.long()] & (sel >= 0)
        assert torch.equal(acc[gated], admit[gated]), seed
    assert checked
    # engine.wave_forbid_cells: the cells each dispatch's first wave
    # forbade to the classes riding it
    want = 0
    for w in waves:
        if w["first"]:
            cls = torch.unique(w["pod_class"][w["active"]]).long()
            want += int((~w["mask"][cls]).sum())
    assert want > 0
    assert forbid_cells == want, seed
    # the gate refused a second pod on some node
    assert any(bool((w["gate"][w["pod_class"].long()] & w["active"]
                     & (w["sel"] >= 0) & ~w["accepted"]).any())
               for w in waves)
    assert any(bool(w["gate"][w["pod_class"].long()].any()) for w in waves)
    assert any(bool(w["committed"].any()) or w["base"] for w in waves[1:])


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_a_whole_drain_holds_anti_affinity_both_ways(seed):
    mix = Mix(seed)
    api = ApiServerLite()
    for nd in mix.nodes():
        api.create("Node", nd)
    for p in mix.bound_pods():
        api.create("Pod", p)
    pending = mix.pending_pods()
    s = Scheduler(api, record_events=False, device="cpu")
    s.start()
    rv0 = api.current_rv()
    for p in pending:
        api.create("Pod", p)
    try:
        s.sync()
        s.run_until_drained(max_batch=16)
    finally:
        s.engine.close()
    idx = {n: i for i, n in enumerate(mix.names)}
    domains, _ = mix.domains(mix.names)
    order, seen = [], set()
    for e in api.watch_since(("Pod",), rv0):
        if e.type != "DELETED" and e.obj.node_name \
                and e.obj.name not in seen:
            seen.add(e.obj.name)
            order.append(e.obj.name)
    by_name = {p.name: p for p in pending}
    placed = []
    for name in order:
        p = by_name[name]
        node = api.get("Pod", NS, name).node_name
        placed.append((*mix.templates[mix.template_of(p)], idx[node]))
    assert len(placed) >= len(pending) // 2
    assert violations(domains, placed, prior=mix.bound) == (0, 0)
    # a pod left pending fits nowhere among the bound pods
    everyone = mix.bound + placed
    for p in pending:
        if p.name not in seen:
            ref = forbidden(domains, everyone,
                            [mix.templates[mix.template_of(p)]])
            assert ref.all(), (seed, p.name)


def test_the_reference_itself():
    """forbidden's two directions, a node without the key, blocks;
    gate_accept's earliest-pod rule; violations in bind order."""
    dom = {HOST: torch.arange(4), ZONE: torch.tensor([0, 0, 1, -1])}
    green = ({"color": "green"}, [({"color": "green"}, HOST)])
    plain = ({"color": "green"}, [])
    zoned = ({"app": "x"}, [({"color": "green"}, ZONE)])
    bound = [({"color": "green"}, [], 0), ({"app": "y"},
             [({"app": "x"}, ZONE)], 2)]
    f = forbidden(dom, bound, [green, plain, zoned])
    assert f.tolist() == [[True, False, False, False],
                          [False, False, False, False],
                          [True, True, True, False]]
    assert torch.equal(forbidden(dom, bound, [green, plain, zoned],
                                 block=3), f)
    assert forbidden(dom, bound, [zoned], own=False).tolist() == [
        [False, False, True, False]]
    sel = torch.tensor([2, 2, 5, -1, 5, 7, 7])
    pc = torch.tensor([0, 0, 1, 0, 0, 1, 1])
    assert gate_accept(sel, pc, torch.tensor([True, False])).tolist() == [
        True, False, True, False, False, True, True]
    placed = [(*green, 1), (*green, 1), (*plain, 3)]
    assert violations(dom, placed) == (1, 1)
    assert violations(dom, [(*green, 1), (*plain, 1)]) == (0, 1)
    assert violations(dom, [(*plain, 1), (*green, 1)]) == (1, 0)
    assert violations(dom, [(*green, 0)], prior=bound[:1]) == (1, 0)
    assert violations(dom, [(*plain, 0)], prior=bound[:1]) == (0, 0)

