"""Fused [C, M] cross-cell routing scores for the federation tier.

PyTorch port of kubernetes_tpu/ops/federation.py (``_route_scores``, a
jitted XLA function of the reference, not a Pallas kernel): PyTorch ops
on the router's device — the card on the main path, the CPU in the
tests.

The per-cell engine's dense-eval idiom, one level up: the front-door
router holds M cell-aggregate columns (federation/aggregate.py) and C
pending pods/gangs, and scores every (candidate, cell) pair in ONE fused
pass instead of M wire round-trips per pod. The tensor is tiny — M is
cells (single digits), C is a routing batch — so the win is not FLOPs,
it is the same property the wave path buys: one upload, one host fetch,
argmax tie-breaks deterministic by first occurrence.

Scoring mirrors the fast lane's least-loaded rule at cell granularity:
fit = cell ready (not browned out) AND affinity-domain present AND the
candidate's summed (cpu, mem) demand fits the cell's headroom; score =
worst-dimension fractional headroom AFTER placement minus a band-pressure
penalty (pending backlog normalized by ready nodes — Borg's "spare
capacity" spillover signal, PAPERS.md §Borg). Gangs enter as ONE row with
summed demand: their atomicity point never crosses a cell boundary
(§Tiresias), the per-cell quorum fence does the rest.

``route_scores_host`` is the numpy twin (same math, same tie-break; a
copy of the reference's) used for tiny batches where a device pass is
pure overhead; the tests pin the twins equal so the routing choice is
latency policy, never a semantics fork. The C axis is padded to the
bucket ladder by the router (ops.predicates.bucket): a padded row has
zero demand and fits everywhere, and the router never reads its verdict.

Exactness against the reference: the int32 subtractions happen before
the cast to float32, so they wrap as the reference's do; every division
is an IEEE float32 ``/`` (nothing here runs with TF32 or fast math);
``torch.argmax`` returns the first maximal index, as ``jnp.argmax``
does; the fit count's ``sum`` (int64 in torch) is cast back to int32.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch import resolve_device
from kubernetes_tpu_torch.convert import tensor_from_numpy

# score floor for unfit (candidate, cell) pairs: real scores are
# fractional headroom in [0, 1] minus a bounded pressure term, so any
# fit cell beats _UNFIT at argmax
_UNFIT = -1e9

# band-pressure weight: one unit of pending-per-ready-node costs the
# same as the full headroom range, so a drowning cell loses to any
# comparably-free quiet one but still wins over cells that don't fit
PRESSURE_W = 1.0

I32 = torch.int32
F32 = torch.float32

# the nine operands in call order with the dtypes the reference's jit
# sees them in (host arrays are coerced to these before the upload)
OPERAND_DTYPES = (np.int32, np.int32, np.int32, np.int32, np.int32,
                  np.int32, np.float32, np.bool_, np.bool_)


def route_scores_device(dem_cpu, dem_mem, cpu_free, mem_free, cpu_cap,
                        mem_cap, pressure, ready, dom_ok) -> torch.Tensor:
    """Score C candidates against M cells -> int32 [2, C] on the
    operands' device, not fetched: row 0 the chosen cell index per
    candidate (argmax, first occurrence — the deterministic tie-break),
    row 1 the count of cells that fit (row 0 is meaningful only where
    row 1 > 0).

    dem_cpu/dem_mem int32 [C] summed candidate demand (millicores, MiB);
    cpu_free/mem_free int32 [M] cell headroom; cpu_cap/mem_cap int32 [M]
    ready-node capacity; pressure float32 [M] pending per ready node;
    ready bool [M] cell routable; dom_ok bool [C, M] affinity-domain
    presence.
    """
    spare_c = (cpu_free[None, :] - dem_cpu[:, None]).to(F32)
    spare_m = (mem_free[None, :] - dem_mem[:, None]).to(F32)
    fit = (ready[None, :] & dom_ok
           & (spare_c >= 0) & (spare_m >= 0))          # [C, M]
    cap_c = torch.clamp(cpu_cap, min=1).to(F32)
    cap_m = torch.clamp(mem_cap, min=1).to(F32)
    head = torch.minimum(spare_c / cap_c[None, :], spare_m / cap_m[None, :])
    score = torch.where(fit, head - PRESSURE_W * pressure[None, :], _UNFIT)
    # argmax returns the first maximal index, as jnp.argmax does
    choice = torch.argmax(score, dim=-1).to(I32)
    return torch.stack([choice, fit.to(I32).sum(dim=-1).to(I32)])


def route_scores(dem_cpu, dem_mem, cpu_free, mem_free, cpu_cap, mem_cap,
                 pressure, ready, dom_ok, device=None) -> np.ndarray:
    """The router's device route: upload the nine host operands (copies)
    to ``device`` (None = the card, RuntimeError without one), run
    ``route_scores_device`` there and return its int32 [2, C] verdict as
    numpy, from one fetch."""
    dev = resolve_device(device)
    args = [tensor_from_numpy(np.asarray(a, dtype=dt), dev)
            for a, dt in zip((dem_cpu, dem_mem, cpu_free, mem_free,
                              cpu_cap, mem_cap, pressure, ready, dom_ok),
                             OPERAND_DTYPES)]
    return route_scores_device(*args).cpu().numpy()


def route_scores_host(dem_cpu, dem_mem, cpu_free, mem_free, cpu_cap,
                      mem_cap, pressure, ready, dom_ok) -> np.ndarray:
    """Numpy twin of ``route_scores`` — identical verdicts by test, used
    when the routing batch is too small to amortize a dispatch."""
    dem_cpu = np.asarray(dem_cpu)
    dem_mem = np.asarray(dem_mem)
    spare_c = (cpu_free[None, :] - dem_cpu[:, None]).astype(np.float32)
    spare_m = (mem_free[None, :] - dem_mem[:, None]).astype(np.float32)
    fit = (ready[None, :] & dom_ok
           & (spare_c >= 0) & (spare_m >= 0))
    cap_c = np.maximum(cpu_cap, 1).astype(np.float32)
    cap_m = np.maximum(mem_cap, 1).astype(np.float32)
    head = np.minimum(spare_c / cap_c[None, :], spare_m / cap_m[None, :])
    score = np.where(fit, head - PRESSURE_W * pressure[None, :],
                     np.float32(_UNFIT))
    choice = np.argmax(score, axis=-1).astype(np.int32)
    return np.stack([choice, fit.astype(np.int32).sum(axis=-1)])


__all__ = ["PRESSURE_W", "route_scores", "route_scores_device",
           "route_scores_host"]
