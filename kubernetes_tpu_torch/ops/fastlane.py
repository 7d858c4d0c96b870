"""Sampled power-of-k eval for the Sparrow fast lane.

PyTorch port of kubernetes_tpu/ops/fastlane.py (``_sample_eval``, a
jitted XLA function of the reference, not a Pallas kernel): PyTorch ops on
the device of the resident node tensors — the card on the main path, the
CPU in the tests.

The bulk wave path amortizes its cost over thousands of pods: encoding
build, vocab interning, a [P, N] fused eval. A latency-critical pod can't
wait for any of that. This is the whole device story of the fast lane:
gather k sampled node rows out of the RESIDENT snapshot tensors (the same
ones `_nodes_on_device` keeps between waves — nothing is re-encoded) and
score the pod against exactly those k rows.

Admission keeps the eval tiny by construction: the fast lane only takes
"simple" pods — no affinity, no selector, no tolerations, no host ports,
no volumes, no extended resources (engine/fastlane.py gates this). That
shrinks the predicate chain to resources + pod count + node conditions +
an any-taint check (a toleration-free pod fails on ANY NoSchedule taint,
so the intolerated×taint product degenerates to a row-sum), which is
EXACT for the admitted population — and the late-bind fence re-validates
the winner against live cache truth anyway, so a stale score costs a
resample, never a wrong bind.

``sample_eval_host`` is the same math in numpy over the HOST snapshot
arrays (a copy of the reference's). The fast lane uses it whenever a bulk
wave is in flight. Device and host twins are held equal by the tests, so
the routing choice is pure latency policy, never a semantics fork. The
f32 division and product are IEEE on both (nothing here is built with
fast math).
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch.convert import tensor_from_numpy
from kubernetes_tpu_torch.state.snapshot import (
    NUM_BASE_RESOURCES,
    R_CPU,
    R_MEM,
    R_OVERLAY,
    R_SCRATCH,
)

# node-side rows the sampled eval gathers — a strict subset of the
# engine's resident _nodes_on_device tensors (scheduler_engine.py), so
# the device path reads state that is already there. The port's node
# dict uses the reference's key names for all nine, so no mapping.
FAST_NODE_KEYS = ("alloc", "requested", "pod_count", "allowed_pods",
                  "schedulable", "valid", "mem_pressure", "disk_pressure",
                  "taints_sched")

# score floor for unfit rows: real scores are fractional headroom in
# [0, 1] (fit guarantees spare >= 0), so -1 can never win argmax
_UNFIT = -1.0

I32 = torch.int32


def sample_eval_device(idx, req, zero_req: bool, best_effort: bool,
                       nodes) -> torch.Tensor:
    """Score one pod against k sampled nodes -> int32 [3] on the nodes'
    device, not fetched.

    idx int64 [k] node row indices and req int32 [R] quantized request
    row (resource_row semantics), both on the nodes' device; zero_req /
    best_effort Python bools; nodes = the FAST_NODE_KEYS dict of resident
    tensors. Returns [winner_local_index, fit_count, best_score * 1e6] —
    winner is meaningful only when fit_count > 0."""
    a = nodes["alloc"].index_select(0, idx)                  # [k, R]
    r = nodes["requested"].index_select(0, idx)              # [k, R]
    total = req[None, :] + r
    ok = total <= a
    # cpu/mem/gpu + extended: plain elementwise (resources_fit layout)
    plain = torch.cat([ok[:, :R_SCRATCH], ok[:, NUM_BASE_RESOURCES:]],
                      dim=-1).all(dim=-1)
    # storage special-case (predicates.go:590-604): no overlay capacity
    # means overlay requests fall back onto scratch space
    alloc_s = a[:, R_SCRATCH]
    alloc_o = a[:, R_OVERLAY]
    pod_s = req[R_SCRATCH]
    pod_o = req[R_OVERLAY]
    node_s = r[:, R_SCRATCH]
    node_o = r[:, R_OVERLAY]
    no_overlay = alloc_o == 0
    scratch_ok = torch.where(
        no_overlay,
        pod_s + pod_o + node_s + node_o <= alloc_s,
        pod_s + node_s <= alloc_s,
    )
    overlay_ok = no_overlay | (pod_o + node_o <= alloc_o)
    res_ok = plain & scratch_ok & overlay_ok
    if zero_req:
        res_ok = torch.ones_like(res_ok)
    count_ok = (nodes["pod_count"].index_select(0, idx) + 1
                <= nodes["allowed_pods"].index_select(0, idx))
    cond_ok = (nodes["schedulable"].index_select(0, idx)
               & nodes["valid"].index_select(0, idx))
    fit = res_ok & count_ok & cond_ok
    if best_effort:
        fit = fit & ~nodes["mem_pressure"].index_select(0, idx)
    fit = fit & ~nodes["disk_pressure"].index_select(0, idx)
    # toleration-free admission: ANY NoSchedule/NoExecute taint fails
    taint_free = nodes["taints_sched"].index_select(0, idx).to(I32).sum(
        dim=-1) == 0
    fit = fit & taint_free
    # power-of-k choice: the least-loaded fit sample by worst-dimension
    # fractional headroom AFTER placement
    spare_c = (a[:, R_CPU] - total[:, R_CPU]).to(torch.float32)
    spare_m = (a[:, R_MEM] - total[:, R_MEM]).to(torch.float32)
    cap_c = torch.clamp(a[:, R_CPU], min=1).to(torch.float32)
    cap_m = torch.clamp(a[:, R_MEM], min=1).to(torch.float32)
    score = torch.where(fit, torch.minimum(spare_c / cap_c, spare_m / cap_m),
                        _UNFIT)
    # argmax returns the first maximal index, as jnp.argmax does
    win = torch.argmax(score).to(I32)
    return torch.stack([win, fit.sum().to(I32),
                        (score.max() * 1e6).to(I32)])


def sample_eval(idx, req, zero_req, best_effort, nodes) -> torch.Tensor:
    """The fast lane's device route: upload the k indices and the request
    row (copies), run ``sample_eval_device`` on the nodes' device and
    fetch its int32 [3] to the host (a CPU tensor; np.asarray reads it).

    The launch goes on the calling thread's current stream. The resident
    tensors it reads were uploaded by ``_nodes_on_device`` on the same
    thread and stream (dispatch and harvest run on the loop thread; the
    wave worker's stream only reads them), so the gather is ordered
    after every upload without an event."""
    dev = nodes["alloc"].device
    idx_t = tensor_from_numpy(np.asarray(idx, dtype=np.int64), dev)
    req_t = tensor_from_numpy(np.asarray(req, dtype=np.int32), dev)
    return sample_eval_device(idx_t, req_t, bool(zero_req),
                              bool(best_effort), nodes).cpu()


def sample_eval_host(idx, req, zero_req, best_effort, nodes) -> np.ndarray:
    """Numpy twin of ``sample_eval`` over the HOST snapshot arrays —
    bit-identical verdicts by test (same inputs -> same [3] output), used
    when a wave owns the device (FIFO execution would stall the fast pod
    behind it) and for resample retries."""
    idx = np.asarray(idx)
    a = nodes["alloc"][idx]
    r = nodes["requested"][idx]
    total = req[None, :] + r
    ok = total <= a
    plain = np.concatenate(
        [ok[:, :R_SCRATCH], ok[:, NUM_BASE_RESOURCES:]], axis=-1
    ).all(axis=-1)
    alloc_s = a[:, R_SCRATCH]
    alloc_o = a[:, R_OVERLAY]
    pod_s = req[R_SCRATCH]
    pod_o = req[R_OVERLAY]
    node_s = r[:, R_SCRATCH]
    node_o = r[:, R_OVERLAY]
    no_overlay = alloc_o == 0
    scratch_ok = np.where(
        no_overlay,
        pod_s + pod_o + node_s + node_o <= alloc_s,
        pod_s + node_s <= alloc_s,
    )
    overlay_ok = no_overlay | (pod_o + node_o <= alloc_o)
    res_ok = (plain & scratch_ok & overlay_ok) | zero_req
    count_ok = nodes["pod_count"][idx] + 1 <= nodes["allowed_pods"][idx]
    cond_ok = nodes["schedulable"][idx] & nodes["valid"][idx]
    mem_ok = (not best_effort) | (~nodes["mem_pressure"][idx])
    disk_ok = ~nodes["disk_pressure"][idx]
    taint_free = nodes["taints_sched"][idx].astype(
        np.int32).sum(axis=-1) == 0
    fit = res_ok & count_ok & cond_ok & mem_ok & disk_ok & taint_free
    spare_c = (a[:, R_CPU] - total[:, R_CPU]).astype(np.float32)
    spare_m = (a[:, R_MEM] - total[:, R_MEM]).astype(np.float32)
    cap_c = np.maximum(a[:, R_CPU], 1).astype(np.float32)
    cap_m = np.maximum(a[:, R_MEM], 1).astype(np.float32)
    score = np.where(fit, np.minimum(spare_c / cap_c, spare_m / cap_m),
                     np.float32(_UNFIT))
    win = np.int32(np.argmax(score))
    return np.array([win, fit.astype(np.int32).sum(),
                     np.int32(score.max() * 1e6)], dtype=np.int32)


__all__ = ["FAST_NODE_KEYS", "sample_eval", "sample_eval_device",
           "sample_eval_host"]
