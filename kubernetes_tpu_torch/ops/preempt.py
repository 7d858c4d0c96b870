"""Device-side victim selection for wave-path preemption.

PyTorch port of kubernetes_tpu/ops/preempt.py (``_victim_scan``, a jitted
XLA function of the reference, not a Pallas kernel): PyTorch ops on the
device of the tensors given — the card on the main path, the CPU in the
tests.

The classic preemption pre-filter (engine/preemption.py candidate_mask /
tight_bounds) builds O(total pods) host arrays per round. This module is
its tensor form: the snapshot maintains per-node PRIORITY-BAND aggregates
(band_cpu / band_mem / band_count, [N, B] with B a small interned vocab
of distinct pod priorities), and ONE call answers, for every pending
preemptor class at once:

  - candidate[c, n]: could evicting some set of strictly-lower-priority
    pods on node n free enough room for class c?
  - bound[c, n]: the minimal highest-victim-priority that frees enough —
    the exact band form of tight_bounds. Used to rank candidates when
    the exact host verification must be truncated.

Over-approximation contract: the mask may only ever INCLUDE too much,
never exclude a node the exact oracle would accept — memory is quantized
(alloc floors, requested and band sums ceil), so the comparison carries a
+2-quantum slack. False positives cost one exact `_select_victims`
verification each; a false negative would change a scheduling outcome.

Integer semantics are the reference's int32 throughout, wrap-around
included (see ``victim_scan``).
"""

from __future__ import annotations

import torch

# padding rows use this priority: no band can sit strictly below it, so
# a padding class has no candidates and commits nothing
PAD_PRIO = -(2 ** 31)
# unused band slots carry this priority: never strictly below any real
# preemptor, so they can't widen a threshold (their sums are zero anyway)
UNUSED_BAND_PRIO = 2 ** 31 - 1
INFEASIBLE = 2 ** 31 - 1
# quantization slack for the memory comparison: alloc floors, requested
# ceils, band sums ceil — raw-feasible can lose at most 2 quanta here
MEM_SLACK = 2

I32 = torch.int32


def band_prefix(band_x: torch.Tensor, le: torch.Tensor) -> torch.Tensor:
    """cum[n, t] = sum over b of band_x[n, b] * le[t, b], int32 [N, B].

    The reference computes ``band_x @ le.T`` with an int32 accumulator.
    CUDA has no int32 matrix product, and a float32 one is not exact
    here: band_mem is in KiB quanta, so one 32 GiB node already sums to
    2^25 > 2^24. So this is a masked sum over [N, B, B] in int64, cast
    back to int32 — the cast wraps modulo 2^32 exactly as the
    reference's int32 accumulation does (the sum is the same modulo
    2^32 whatever the order)."""
    prod = band_x.to(torch.int64)[:, None, :] * le.to(torch.int64)[None]
    return prod.sum(dim=-1).to(I32)


def victim_scan(need_cpu, need_mem, prio, spare_cpu, spare_mem,
                pod_count, allowed, band_cpu, band_mem, band_count,
                band_prio):
    """One [C, N] victim pre-filter.

    need_cpu/need_mem [C] int32 (mem floor-quantized), prio [C] int32;
    spare_cpu/spare_mem [N] int32 (alloc - requested, snapshot columns);
    pod_count/allowed [N] int32; band_* [N, B] int32 (mem ceil-quantized);
    band_prio [B] int32. Returns (candidate [C, N] bool, bound [C, N]
    int32 with INFEASIBLE where no threshold works). The int32 sums
    below wrap on overflow, as the reference's do."""
    # prefix sums over priority thresholds: cum[n, t] = total over bands
    # whose priority <= band_prio[t] — the "evict every band up to t" form
    le = band_prio[None, :] <= band_prio[:, None]             # [t, b]
    cum_cpu = band_prefix(band_cpu, le)
    cum_mem = band_prefix(band_mem, le)
    cum_cnt = band_prefix(band_count, le)
    # thresholds a class may use: strictly below its own priority
    thr_ok = band_prio[None, :] < prio[:, None]               # [C, B]
    ok_cpu = (spare_cpu[None, :, None] + cum_cpu[None, :, :]
              >= need_cpu[:, None, None])                     # [C, N, B]
    ok_mem = (spare_mem[None, :, None] + cum_mem[None, :, :] + MEM_SLACK
              >= need_mem[:, None, None])
    ok_cnt = (pod_count[None, :, None] - cum_cnt[None, :, :] + 1
              <= allowed[None, :, None])
    has_victim = cum_cnt[None, :, :] > 0
    ok = (ok_cpu & ok_mem & ok_cnt & has_victim
          & thr_ok[:, None, :])                               # [C, N, B]
    candidate = ok.any(dim=-1)
    bound = torch.where(ok, band_prio[None, None, :],
                        INFEASIBLE).amin(dim=-1)
    return candidate, bound


__all__ = ["INFEASIBLE", "MEM_SLACK", "PAD_PRIO", "UNUSED_BAND_PRIO",
           "band_prefix", "victim_scan"]
