"""The port's kernel module on the CPU: each kernel's plain version equals
the reference's Pallas kernel (interpret mode) and the reference's jnp
path, exactly. On CPU tensors the wrappers run the plain versions and
leave the launch counters at 0; the CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops.affinity import (
    precompute_static as jax_precompute_static,
)
from kubernetes_tpu.ops.pallas_kernels import (
    capacity_fits_pallas,
    incidence_matmul_pallas,
)
from kubernetes_tpu.ops.predicates import resources_fit as jax_resources_fit
from kubernetes_tpu.state.snapshot import R_OVERLAY, R_SCRATCH
from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.ops.affinity import (
    precompute_static as torch_precompute_static,
)
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


I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


def incidence_case(rng, m, l, n, wmax):
    """A [m, l] int32: 0/1 incidence rows, then weight rows with entries in
    [-wmax, wmax]; with wmax = I32_MAX two rows of int32 extremes whose
    sums still fit int32, one of them carrying across the int32 boundary
    in the kernel's plane recombination. B_t [n, l] int8 0/1."""
    a = (rng.random((m, l)) < 0.3).astype(np.int64)
    w = min(wmax, 2 ** 22)
    a[m // 2:] *= rng.integers(-w, w + 1, size=(m - m // 2, l))
    if wmax == I32_MAX and l >= 5:
        a[-1] = 0
        a[-1, 0], a[-1, 1] = I32_MIN + 1, I32_MAX
        if m > 1:
            a[-2] = 0
            a[-2, 2], a[-2, 3], a[-2, 4] = I32_MAX - 1, 1, -1
    b = (rng.random((n, l)) < 0.2).astype(np.int8)
    exact = a @ b.T.astype(np.int64)
    assert np.abs(exact).max(initial=0) <= I32_MAX, "case must fit int32"
    return a.astype(np.int32), b, exact


@pytest.mark.parametrize("m,l,n,wmax", [
    pytest.param(6, 40, 9, 100, id="6-40-9"),
    pytest.param(70, 513, 130, 100, id="70-513-130"),
    pytest.param(1, 1, 1, 100, id="1-1-1"),
    pytest.param(6, 5008, 9, 300_000, id="6-5008-9-w300k"),
    pytest.param(17, 700, 33, 2 ** 22, id="17-700-33-w2e22"),
    pytest.param(130, 104, 255, 2 ** 22, id="130-104-255-w2e22"),
    pytest.param(6, 40, 9, I32_MAX, id="6-40-9-i32extreme"),
    pytest.param(16, 5000, 20, I32_MAX, id="16-5000-20-i32extreme"),
])
def test_incidence_plain_matches_pallas(m, l, n, wmax):
    """The plain version equals the reference's Pallas kernel (interpret
    mode) wherever that kernel's float32 sums are exact (every partial sum
    below 2^24), and the reference's jnp precompute_static (int32 einsum)
    in every case: each row of A rides as one class's preferred-weight
    row."""
    rng = np.random.default_rng(m * 1000 + l + n)
    a, b, exact = incidence_case(rng, m, l, n, wmax)
    got = kernels.incidence_matmul(t(a), t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exact)
    if (np.abs(a).astype(np.int64) @ b.T.astype(np.int64)).max() < 2 ** 24:
        want = np.asarray(incidence_matmul_pallas(a, b, interpret=True))
        np.testing.assert_array_equal(got.numpy(), want)
    aff = {"aff_allow": np.zeros((m, 0, l), np.int8),
           "forbid_static": np.zeros((m, l), np.int8), "prio_static": a}
    want = jax_precompute_static(aff, b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want["prio_counts"]))
    mine = torch_precompute_static({k: t(v) for k, v in aff.items()}, t(b))
    for k in ("allow_hit", "forbid_hit", "prio_counts"):
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("l", [8, 5000, 5008])
@pytest.mark.parametrize("n", [1, 5000])
@pytest.mark.parametrize("m", [1, 6, 17, 640, 2560])
def test_incidence_plan_covers_each_cell_and_k_once(m, n, l):
    """The launch plan's blocks cover every output cell exactly once and,
    within each output tile, every k < L exactly once; the limits the
    kernel checks hold (block depth per tile height, L padded by less than
    one block, no empty slice)."""
    plan = kernels.incidence_plan(m, n, l)
    tm, tn, bk = plan["tile_m"], plan["tile_n"], plan["block_k"]
    split, kps, l_pad = plan["split"], plan["kb_per_split"], plan["l_pad"]
    gx, gy, gz = plan["grid"]
    assert tm in (16, 128) and bk == 128
    assert tn == 128 and gz == split >= 1
    assert l_pad % bk == 0 and 0 <= l_pad - l < bk
    assert plan["chunks"] == -(-l_pad // 1024)
    nkb = l_pad // bk
    assert (split - 1) * kps < nkb <= split * kps
    cells = np.zeros((gy * tm, gx * tn), np.int16)
    for y in range(gy):
        for x in range(gx):
            cells[y * tm:(y + 1) * tm, x * tn:(x + 1) * tn] += 1
    assert (cells[:m, :n] == 1).all()
    ks = np.zeros(l_pad, np.int16)
    for z in range(gz):
        kb0, kb1 = z * kps, min(nkb, (z + 1) * kps)
        assert kb1 > kb0
        ks[kb0 * bk:kb1 * bk] += 1
    assert (ks[:l] == 1).all()
    assert tm == (16 if m <= 16 else 128)
    # split-K fills at most one wave, and at least half of what it can
    wave = 132 * kernels.INCIDENCE_BLOCKS_PER_SM
    assert gx * gy * split <= max(wave, gx * gy)
    assert 2 * gx * gy * split > min(wave, gx * gy * nkb)


@pytest.mark.parametrize("m,n,l", [(0, 5, 8), (6, 0, 8), (6, 5, 0),
                                   (6, 5, 5004), (1, 1, 1)])
def test_incidence_plan_refuses_empty_or_unpadded(m, n, l):
    """The plan takes no empty product and no L that is not a multiple of
    8 (the wrapper pads L before it plans)."""
    with pytest.raises(ValueError):
        kernels.incidence_plan(m, n, l)


def kernel_arithmetic(a, b):
    """What the CUDA kernel computes, in numpy: the pre-pass's planes and
    row counts (the port's plain version), one int64 product per plane and
    k slice of the launch plan, each slice's planes combined in uint32 (as
    sum_p P_p << 8p for 16-row tiles, else highest plane first as
    acc = (acc << 8) + P_p), the slices added in uint32."""
    m, l = a.shape
    n = b.shape[0]
    plan = kernels.incidence_plan(m, n, l)
    planes, count = kernels.incidence_planes_plain(t(a), plan["l_pad"])
    planes, count = planes.numpy().astype(np.int64), count.numpy()
    b_pad = np.zeros((n, plan["l_pad"]), np.int64)
    b_pad[:, :l] = b
    tm, bk, kps = plan["tile_m"], plan["block_k"], plan["kb_per_split"]
    out = np.zeros((m, n), np.uint32)
    for m0 in range(0, m, tm):
        rows = slice(m0, m0 + tm)
        tile_count = count[rows].max()
        for z in range(plan["split"]):
            ks = slice(z * kps * bk, (z + 1) * kps * bk)
            acc = np.zeros((len(range(m)[rows]), n), np.uint32)
            for p in range(tile_count - 1, -1, -1):
                prod = planes[p, rows, ks] @ b_pad[:, ks].T
                assert np.abs(prod).max(initial=0) <= I32_MAX
                prod = prod.astype(np.uint32)
                if tm == 16:
                    acc += prod << np.uint32(8 * p)
                else:
                    acc = (acc << np.uint32(8)) + prod
            out[rows] += acc
    return out.view(np.int32), planes, count


@pytest.mark.parametrize("m,l,n,wmax", [
    (6, 5008, 40, 1), (17, 520, 33, 127), (12, 96, 7, 300_000),
    (16, 200, 9, I32_MAX), (40, 64, 11, I32_MAX),
])
def test_incidence_byte_planes_recombine_to_the_int32_product(m, l, n,
                                                              wmax):
    """The identity the kernel relies on: A split into signed base-256
    digit planes, one product per plane against any int8 B_t, recombined
    by shifts in uint32, equals the int32 product (modulo 2^32, so exactly
    wherever the sums fit int32); each row's plane count is the fewest
    digits that represent it."""
    rng = np.random.default_rng(m + l + n)
    a = rng.integers(-wmax, wmax, size=(m, l), endpoint=True,
                     dtype=np.int64)
    a[rng.random((m, l)) < 0.5] = 0
    a[0] = 0                                        # a zero row
    if wmax == I32_MAX:
        a[1, :4] = [I32_MIN, I32_MAX, I32_MIN + 1, I32_MAX - 1]
    a = a.astype(np.int32)
    b = rng.integers(-128, 127, size=(n, l), endpoint=True, dtype=np.int8)
    got, planes, count = kernel_arithmetic(a, b)
    want = (a.astype(np.int64) @ b.T.astype(np.int64)).astype(np.int32)
    np.testing.assert_array_equal(got, want)   # int64 -> int32 wraps too
    weights = 256 ** np.arange(4, dtype=np.int64)[:, None, None]
    back = (planes * weights).sum(axis=0)[:, :l]
    np.testing.assert_array_equal(back.astype(np.uint32).view(np.int32), a)
    assert count[0] == 0
    for r in range(1, m):
        # k signed digits reach [-128, 127] * (256^k - 1) / 255
        span = [(256 ** k - 1) // 255 for k in (1, 2, 3)]
        fits = [(a[r] >= -128 * s).all() and (a[r] <= 127 * s).all()
                for s in span]
        want_count = 0 if not a[r].any() else next(
            (k for k, ok in zip((1, 2, 3), fits) if ok), 4)
        assert count[r] == want_count, (r, count[r], want_count)


def test_cpu_tensors_leave_launch_counts_at_zero():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(3)
    pod_req, _, alloc, requested = cap_case(rng, 4, 9, 5)
    kernels.capacity_fit(t(pod_req), t(alloc), t(requested))
    kernels.incidence_matmul(t(np.ones((2, 3), np.int32)),
                             t(np.ones((4, 3), np.int8)))
    assert kernels.LAUNCHES == {"capacity_fit": 0, "incidence_matmul": 0}
