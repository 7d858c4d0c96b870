"""Kubernetes v1.7's resource priorities, plain: LeastRequestedPriority
(least_requested.go) and BalancedResourceAllocation
(balanced_resource_allocation.go), on the non-zero requests
(priorities/util/non_zero.go). The default provider's other priorities
give every node the same value for pods with no preferred terms,
tolerations or services, which the mixes assert, so they do not move a
comparison between nodes."""

import numpy as np

MAX_PRIORITY = 10
DEFAULT_CPU = 100                    # millicores, non_zero.go
DEFAULT_MEM = 200 * 1024 * 1024      # bytes


def nonzero(cpu, mem):
    cpu = np.asarray(cpu, dtype=np.int64)
    mem = np.asarray(mem, dtype=np.int64)
    return (np.where(cpu == 0, DEFAULT_CPU, cpu),
            np.where(mem == 0, DEFAULT_MEM, mem))


def _unused(total, cap):
    total = np.asarray(total, dtype=np.int64)
    cap = np.asarray(cap, dtype=np.int64)
    score = ((cap - total) * MAX_PRIORITY) // np.maximum(cap, 1)
    return np.where((cap == 0) | (total > cap), 0, score)


def score(tot_cpu, tot_mem, cap_cpu, cap_mem):
    """The sum of the two priorities for a node whose non-zero requests,
    the pod's included, total (tot_cpu, tot_mem)."""
    least = (_unused(tot_cpu, cap_cpu) + _unused(tot_mem, cap_mem)) // 2
    fc = np.where(cap_cpu == 0, 1.0,
                  np.asarray(tot_cpu, np.float64) / np.maximum(cap_cpu, 1))
    fm = np.where(cap_mem == 0, 1.0,
                  np.asarray(tot_mem, np.float64) / np.maximum(cap_mem, 1))
    bal = ((1.0 - np.abs(fc - fm)) * MAX_PRIORITY).astype(np.int64)
    bal = np.where((fc >= 1.0) | (fm >= 1.0), 0, bal)
    return least + bal
