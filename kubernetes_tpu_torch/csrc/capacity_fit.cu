// PodFitsResources capacity mask, [P, N] bool, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel kubernetes_tpu/ops/pallas_kernels.py
// capacity_fits_pallas (_capacity_kernel). Same function, cell for cell:
// for every resource column except scratch (3) and overlay (4),
// pod_req[p, r] + requested[n, r] <= alloc[n, r]; plus the storage special
// case of predicates.go:590-604 (a node with no overlay capacity takes the
// pod's overlay request on its scratch space). The zero-request override is
// ORed in by the caller, as on the TPU.
//
// What bounds it: bytes. Each (p, n) cell reads R ints of three rows and
// writes one byte; at the wave shape (P = 16 classes, N = 5,000 nodes,
// R = 5) the kernel moves about 80 KB out and 200 KB in, well under a
// microsecond at 3.35 TB/s, so one launch is bound by the launch itself.
// The design keeps it simple: one thread per output cell, the block's pod
// rows and node rows staged once in shared memory with coalesced loads,
// the R loop in registers, and neighbouring threads writing neighbouring
// bytes of one output row.
//
// Integer semantics follow the reference's int32 arithmetic: sums wrap
// modulo 2^32 (done in unsigned arithmetic, which C++ defines) before the
// signed compare.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScratch = 3;
constexpr int kOverlay = 4;
constexpr int kBlockN = 128;  // nodes per block (threadIdx.x)
constexpr int kBlockP = 16;   // pods per block (threadIdx.y, two rows each)
constexpr int kThreadsY = 8;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__global__ void capacity_fit_kernel(const int32_t* __restrict__ pod_req,
                                    const int32_t* __restrict__ alloc,
                                    const int32_t* __restrict__ requested,
                                    uint8_t* __restrict__ out, int P, int N,
                                    int R) {
  extern __shared__ int32_t smem[];
  int32_t* s_pod = smem;                       // [kBlockP][R]
  int32_t* s_alloc = s_pod + kBlockP * R;      // [kBlockN][R]
  int32_t* s_req = s_alloc + kBlockN * R;      // [kBlockN][R]

  const int p0 = blockIdx.y * kBlockP;
  const int n0 = blockIdx.x * kBlockN;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  // coalesced staging: the tile rows are contiguous runs of R ints
  for (int i = tid; i < kBlockP * R; i += nthreads) {
    const int p = p0 + i / R;
    s_pod[i] = p < P ? pod_req[static_cast<int64_t>(p0) * R + i] : 0;
  }
  for (int i = tid; i < kBlockN * R; i += nthreads) {
    const int n = n0 + i / R;
    const int64_t g = static_cast<int64_t>(n0) * R + i;
    s_alloc[i] = n < N ? alloc[g] : 0;
    s_req[i] = n < N ? requested[g] : 0;
  }
  __syncthreads();

  const int nl = threadIdx.x;
  const int n = n0 + nl;
  if (n >= N) return;
  const int32_t* a = s_alloc + nl * R;
  const int32_t* q = s_req + nl * R;
  const bool no_overlay = a[kOverlay] == 0;

  for (int pl = threadIdx.y; pl < kBlockP; pl += kThreadsY) {
    const int p = p0 + pl;
    if (p >= P) break;
    const int32_t* r = s_pod + pl * R;
    bool ok = true;
    for (int k = 0; k < R; ++k) {
      if (k == kScratch || k == kOverlay) continue;
      ok = ok && (wrap_add(r[k], q[k]) <= a[k]);
    }
    const int32_t pod_s = r[kScratch], pod_o = r[kOverlay];
    const int32_t node_s = q[kScratch], node_o = q[kOverlay];
    const int32_t alloc_s = a[kScratch], alloc_o = a[kOverlay];
    bool scratch_ok, overlay_ok;
    if (no_overlay) {
      scratch_ok = wrap_add(wrap_add(wrap_add(pod_s, pod_o), node_s),
                            node_o) <= alloc_s;
      overlay_ok = true;
    } else {
      scratch_ok = wrap_add(pod_s, node_s) <= alloc_s;
      overlay_ok = wrap_add(pod_o, node_o) <= alloc_o;
    }
    out[static_cast<int64_t>(p) * N + n] =
        static_cast<uint8_t>(ok && scratch_ok && overlay_ok);
  }
}

}  // namespace

// C interface for ctypes. pod_req int32 [P, R], alloc and requested int32
// [N, R], out uint8 [P, N], all contiguous on the device; stream is a
// cudaStream_t. Returns the launch's cudaError_t (0 on success).
extern "C" int capacity_fit_launch(const void* pod_req, const void* alloc,
                                   const void* requested, void* out, int P,
                                   int N, int R, void* stream) {
  if (P == 0 || N == 0) return 0;
  const dim3 block(kBlockN, kThreadsY);
  const dim3 grid((N + kBlockN - 1) / kBlockN, (P + kBlockP - 1) / kBlockP);
  const size_t smem = sizeof(int32_t) * static_cast<size_t>(R) *
                      (kBlockP + 2 * kBlockN);
  capacity_fit_kernel<<<grid, block, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pod_req), static_cast<const int32_t*>(alloc),
      static_cast<const int32_t*>(requested), static_cast<uint8_t*>(out), P,
      N, R);
  return static_cast<int>(cudaGetLastError());
}
