"""The port's kernel module on the CPU: each kernel's plain version equals
the reference's Pallas kernel (interpret mode) and the reference's jnp
path, exactly. On CPU tensors the wrappers run the plain versions and
leave the launch counters at 0; the CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops.pallas_kernels import (
    capacity_fits_pallas,
    incidence_matmul_pallas,
)
from kubernetes_tpu.ops.predicates import resources_fit as jax_resources_fit
from kubernetes_tpu.state.snapshot import R_OVERLAY, R_SCRATCH
from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.ops.predicates import resources_fit


def cap_case(rng, p, n, r):
    pod_req = rng.integers(0, 1000, size=(p, r), dtype=np.int32)
    zero = rng.random(p) < 0.1
    pod_req[zero] = 0
    alloc = rng.integers(0, 4000, size=(n, r), dtype=np.int32)
    alloc[rng.random(n) < 0.4, R_OVERLAY] = 0        # overlay spill path
    requested = (alloc * rng.random((n, r))).astype(np.int32)
    k = min(p, n)
    pod_req[:k] = alloc[:k] - requested[:k]          # exactly on the limit
    return pod_req, zero, alloc, requested


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("p,n,r", [
    (1, 1, 5), (7, 255, 5), (16, 257, 7), (130, 64, 9), (3, 700, 12),
])
def test_capacity_plain_matches_pallas_and_jnp(p, n, r):
    rng = np.random.default_rng(p * 7919 + n * 31 + r)
    pod_req, zero, alloc, requested = cap_case(rng, p, n, r)
    want = np.asarray(capacity_fits_pallas(pod_req, alloc, requested,
                                           interpret=True))
    got = kernels.capacity_fit(t(pod_req), t(alloc), t(requested)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        resources_fit(t(pod_req), t(zero), t(alloc), t(requested)).numpy(),
        np.asarray(jax_resources_fit(pod_req, zero, alloc, requested)))


def test_capacity_storage_spill_cases():
    """Hand cases of the overlay->scratch fallback (predicates.go:590-604)."""
    r = 6
    alloc = np.zeros((3, r), np.int32)
    alloc[:, :3] = 1000
    alloc[0, R_SCRATCH], alloc[0, R_OVERLAY] = 100, 0    # no overlay
    alloc[1, R_SCRATCH], alloc[1, R_OVERLAY] = 100, 50   # overlay capacity
    alloc[2, R_SCRATCH], alloc[2, R_OVERLAY] = 0, 0
    alloc[:, 5] = 4                                      # extended column
    requested = np.zeros((3, r), np.int32)
    requested[0, R_OVERLAY] = 40                         # spills to scratch
    pod_req = np.zeros((4, r), np.int32)
    pod_req[0, R_SCRATCH], pod_req[0, R_OVERLAY] = 30, 30
    pod_req[1, R_SCRATCH], pod_req[1, R_OVERLAY] = 31, 30
    pod_req[2, R_OVERLAY] = 50
    pod_req[3, 5] = 5
    want = np.asarray(capacity_fits_pallas(pod_req, alloc, requested,
                                           interpret=True))
    got = kernels.capacity_fit(t(pod_req), t(alloc), t(requested)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] and not got[1, 0] and got[2, 1] and not got[3].any()


@pytest.mark.parametrize("m,l,n", [(6, 40, 9), (70, 513, 130), (1, 1, 1)])
def test_incidence_plain_matches_pallas(m, l, n):
    rng = np.random.default_rng(m * 1000 + l + n)
    a = (rng.random((m, l)) < 0.3).astype(np.int32)
    a[m // 2:] *= rng.integers(-100, 101, size=(m - m // 2, l)) \
        .astype(np.int32)                                # weight rows
    b = (rng.random((n, l)) < 0.2).astype(np.int8)
    want = np.asarray(incidence_matmul_pallas(a, b, interpret=True))
    got = kernels.incidence_matmul(t(a), t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_leave_launch_counts_at_zero():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(3)
    pod_req, _, alloc, requested = cap_case(rng, 4, 9, 5)
    kernels.capacity_fit(t(pod_req), t(alloc), t(requested))
    kernels.incidence_matmul(t(np.ones((2, 3), np.int32)),
                             t(np.ones((4, 3), np.int8)))
    assert kernels.LAUNCHES == {"capacity_fit": 0, "incidence_matmul": 0}
