// Integer incidence product C = A @ B_t^T, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel kubernetes_tpu/ops/pallas_kernels.py
// incidence_matmul_pallas (_incidence_kernel): the affinity static
// precompute stacks the classes' allowed-domain rows, static forbid rows
// and preferred-weight rows into one A [M, L] (int32: 0/1 incidences and
// small signed weights) and hits them against the node label incidence
// B_t [N, L] (int8, 0/1), giving int32 [M, N].
//
// What bounds it: at the evaluate_pod shape (one class, so M = S + 2 = 6
// rows; N = 5,000 nodes; L ~ 5,000 label pairs) the product is ~0.3 GOP
// against ~25 MB of B_t, so bytes bound it; at stacked shapes with M in the
// thousands it is operations. This first
// version is a plain shared-memory tiled GEMM on the CUDA cores: a 64 x 64
// output tile per block of 256 threads, each thread owning a 4 x 4 grid of
// outputs strided by 16, and a K loop over L in steps of 32 with both
// tiles staged in shared memory (rows padded by one word so the column
// reads of B fall in distinct banks). The sum is an exact int32
// accumulation; the TPU kernel sums in float32, which is exact only below
// 2^24. Tensor-core int8 (wgmma / dp4a on the 0/1 rows) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;   // output rows and columns per block
constexpr int kK = 32;      // contraction step
constexpr int kThreads = 16;  // threads per tile side (16 x 16 = 256)
constexpr int kPer = kTile / kThreads;  // outputs per thread per side

__global__ void incidence_matmul_kernel(const int32_t* __restrict__ a,
                                        const int8_t* __restrict__ b_t,
                                        int32_t* __restrict__ c, int M, int N,
                                        int L) {
  __shared__ int32_t s_a[kTile][kK + 1];
  __shared__ int32_t s_b[kTile][kK + 1];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreads + tx;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;

  int32_t acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < L; k0 += kK) {
    // each of the 256 threads stages 8 of the 64 x 32 entries of each
    // tile; consecutive threads read consecutive entries of one row
    for (int e = tid; e < kTile * kK; e += kThreads * kThreads) {
      const int row = e / kK, col = e % kK;
      const int k = k0 + col;
      const int am = m0 + row, bn = n0 + row;
      s_a[row][col] =
          (am < M && k < L) ? a[static_cast<int64_t>(am) * L + k] : 0;
      s_b[row][col] = (bn < N && k < L)
                          ? static_cast<int32_t>(
                                b_t[static_cast<int64_t>(bn) * L + k])
                          : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kK; ++k) {
      int32_t av[kPer], bv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) av[i] = s_a[ty + kThreads * i][k];
#pragma unroll
      for (int j = 0; j < kPer; ++j) bv[j] = s_b[tx + kThreads * j][k];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int m = m0 + ty + kThreads * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int n = n0 + tx + kThreads * j;
      if (n < N) c[static_cast<int64_t>(m) * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// C interface for ctypes. a int32 [M, L], b_t int8 [N, L], c int32 [M, N],
// all contiguous on the device; stream is a cudaStream_t. Returns the
// launch's cudaError_t (0 on success).
extern "C" int incidence_matmul_launch(const void* a, const void* b_t, void* c,
                                       int M, int N, int L, void* stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 block(kThreads, kThreads);
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  incidence_matmul_kernel<<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int8_t*>(b_t),
      static_cast<int32_t*>(c), M, N, L);
  return static_cast<int>(cudaGetLastError());
}
