// PodFitsResources capacity mask and per-class headroom, [C, N], for
// NVIDIA Hopper (sm_90a), in one launch.
//
// Replaces the TPU kernel kubernetes_tpu/ops/pallas_kernels.py
// capacity_fits_pallas (_capacity_kernel), and on the wave path also the
// eager ops of kubernetes_tpu/engine/waves.py _class_capacity, which read
// the same rows. Two outputs, the second on request:
//
//   fit[c, n]  the mask, cell for cell the TPU kernel's: for every resource
//              column except scratch (3) and overlay (4),
//              req[c, r] + requested[n, r] <= alloc[n, r]; plus the storage
//              special case of predicates.go:590-604 (a node with no
//              overlay capacity takes the class's overlay request on its
//              scratch space). With a zero_req pointer the zero-request
//              override (predicates.go:576-578) is ORed in, as
//              predicates.resources_fit does.
//   cap[c, n]  int32, how many more pods of class c fit on node n, cell for
//              cell _class_capacity: floor(max(alloc - requested, 0) / req)
//              per plain column (2^31 - 1 where req <= 0), the same over
//              the storage columns with the scratch/overlay fallback, 2^31
//              - 1 for a zero-request class, and at most
//              max(allowed_pods - pod_count, 0).
//
// The mask and cap are computed side by side, never one from the other:
// they differ on over-committed nodes (requested > alloc in a column the
// class requests nothing of) and under wrap-around.
//
// What bounds it: latency. At the wave shape (C = 16 classes, N = 5,000
// nodes, R = 5) the launch reads 200 KB and writes 400 KB, a fraction of
// a microsecond at 3.35 TB/s; tensor cores and TMA have nothing to do.
// What costs is the launch and the chain of dependent memory round trips
// in each thread. So: one thread per cell, blocks of 128 nodes of one
// class (640 blocks at the wave shape, every SM gets several; variant runs
// on the card found one class per thread fastest, and every block size
// from 32 to 256 within 3% at one class); no shared-memory staging of node
// rows; each thread issues all
// loads of its node's rows through the read-only path at once (a warp's
// reads are contiguous) while the block's first threads copy its class row
// into shared memory; one barrier; then registers only, and coalesced
// stores (a warp writes 32 neighbouring cells of its class row).
//
// Integer semantics follow the reference's int32 arithmetic: sums and
// differences wrap modulo 2^32 (done in unsigned arithmetic, which C++
// defines) before the signed compare. Division operands are clamped to
// rem > 0 and req > 0 first, so the unsigned divide equals torch's and
// jnp's floor division.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScratch = 3;
constexpr int kOverlay = 4;
constexpr int kBaseColumns = 5;  // NUM_BASE_RESOURCES
constexpr int kMaxR = 40;        // CAPACITY_MAX_R in ops/kernels.py
constexpr int kRegR = 8;         // columns held in registers; more loop
constexpr int kBlockN = 128;     // nodes (threads) per block
constexpr int32_t kBig = 0x7fffffff;
constexpr int kBadArgs = -1;     // BAD_PLAN in ops/kernels.py

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// pods of request `req` that fit in `rem`: floor(max(rem, 0) / req) for
// req > 0, else kBig
__device__ __forceinline__ int32_t headroom(int32_t rem, int32_t req) {
  if (req <= 0) return kBig;
  if (rem <= 0) return 0;
  return static_cast<int32_t>(static_cast<uint32_t>(rem) /
                              static_cast<uint32_t>(req));
}

// One thread per (class, node) cell: blockIdx.x is the class, blockIdx.y
// a run of kBlockN nodes, so blocks that run together share node rows in
// L2.
template <bool kCap>
__global__ void __launch_bounds__(kBlockN)
    capacity_kernel(const int32_t* __restrict__ pod_req,
                    const uint8_t* __restrict__ zero_req,
                    const int32_t* __restrict__ alloc,
                    const int32_t* __restrict__ requested,
                    const int32_t* __restrict__ pod_count,
                    const int32_t* __restrict__ allowed_pods,
                    uint8_t* __restrict__ fit, int32_t* __restrict__ cap,
                    int N, int R) {
  __shared__ int32_t s_req[kMaxR];
  __shared__ uint8_t s_zero;
  const int c = blockIdx.x;
  // the block's class row, read once
  for (int k = threadIdx.x; k < R; k += kBlockN)
    s_req[k] = __ldg(pod_req + static_cast<int64_t>(c) * R + k);
  if (threadIdx.x == 0) s_zero = zero_req != nullptr ? __ldg(zero_req + c) : 0;

  // the node's rows, all loads in flight before the barrier
  const int n = blockIdx.y * kBlockN + threadIdx.x;
  const bool live = n < N;
  const int64_t row = static_cast<int64_t>(live ? n : 0) * R;
  int32_t a[kRegR], q[kRegR];
#pragma unroll
  for (int k = 0; k < kRegR; ++k) {
    const bool in = live && k < R;
    a[k] = in ? __ldg(alloc + row + k) : 0;
    q[k] = in ? __ldg(requested + row + k) : 0;
  }
  int32_t count_cap = kBig;
  if (kCap && live)
    count_cap = max(wrap_sub(__ldg(allowed_pods + n), __ldg(pod_count + n)),
                    0);
  __syncthreads();
  if (!live) return;

  const int32_t* r = s_req;
  bool ok = true;
  int32_t room = kBig;
#pragma unroll
  for (int k = 0; k < kRegR; ++k) {
    if (k >= R || k == kScratch || k == kOverlay) continue;
    ok &= wrap_add(r[k], q[k]) <= a[k];
    if (kCap) room = min(room, headroom(wrap_sub(a[k], q[k]), r[k]));
  }
  for (int k = kRegR; k < R; ++k) {  // columns past the register window
    const int32_t ak = __ldg(alloc + row + k);
    const int32_t qk = __ldg(requested + row + k);
    ok &= wrap_add(r[k], qk) <= ak;
    if (kCap) room = min(room, headroom(wrap_sub(ak, qk), r[k]));
  }
  // storage (predicates.go:590-604): with no overlay capacity the overlay
  // request falls back onto scratch space
  const int32_t alloc_s = a[kScratch], alloc_o = a[kOverlay];
  const int32_t node_s = q[kScratch], node_o = q[kOverlay];
  const int32_t pod_s = r[kScratch], pod_o = r[kOverlay];
  const bool no_overlay = alloc_o == 0;
  bool storage_ok;
  if (no_overlay)
    storage_ok =
        wrap_add(wrap_add(wrap_add(pod_s, pod_o), node_s), node_o) <= alloc_s;
  else
    storage_ok = (wrap_add(pod_s, node_s) <= alloc_s) &
                 (wrap_add(pod_o, node_o) <= alloc_o);
  const bool zero = s_zero != 0;
  const int64_t cell = static_cast<int64_t>(c) * N + n;
  fit[cell] = static_cast<uint8_t>((ok & storage_ok) | zero);
  if (kCap) {
    const int32_t rem_s = wrap_sub(alloc_s, node_s);
    if (no_overlay) {
      room = min(room,
                 headroom(wrap_sub(rem_s, node_o), wrap_add(pod_s, pod_o)));
    } else {
      room = min(room, headroom(rem_s, pod_s));
      room = min(room, headroom(wrap_sub(alloc_o, node_o), pod_o));
    }
    cap[cell] = min(zero ? kBig : room, count_cap);
  }
}

}  // namespace

// C interface for ctypes. pod_req int32 [C, R]; zero_req uint8 [C] or
// null (no override); alloc and requested int32 [N, R]; pod_count and
// allowed_pods int32 [N]; fit uint8 [C, N]; cap int32 [C, N] or null (mask
// only; when given, zero_req, pod_count and allowed_pods must be too). All
// contiguous on the current device; stream is a cudaStream_t of it.
// Returns kBadArgs for arguments the kernel cannot run, 0 without
// launching for an empty output, else the launch's cudaError_t.
extern "C" int capacity_fit_launch(const void* pod_req, const void* zero_req,
                                   const void* alloc, const void* requested,
                                   const void* pod_count,
                                   const void* allowed_pods, void* fit,
                                   void* cap, int C, int N, int R,
                                   void* stream) {
  if (R < kBaseColumns || R > kMaxR || C < 0 || N < 0) return kBadArgs;
  if (cap != nullptr &&
      (zero_req == nullptr || pod_count == nullptr || allowed_pods == nullptr))
    return kBadArgs;
  if (C == 0 || N == 0) return 0;
  const dim3 grid(C, (N + kBlockN - 1) / kBlockN);
  if (grid.y > 65535) return kBadArgs;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* req = static_cast<const int32_t*>(pod_req);
  const auto* zero = static_cast<const uint8_t*>(zero_req);
  const auto* al = static_cast<const int32_t*>(alloc);
  const auto* rq = static_cast<const int32_t*>(requested);
  const auto* pc = static_cast<const int32_t*>(pod_count);
  const auto* ap = static_cast<const int32_t*>(allowed_pods);
  auto* f = static_cast<uint8_t*>(fit);
  auto* cp = static_cast<int32_t*>(cap);
  if (cp != nullptr)
    capacity_kernel<true><<<grid, kBlockN, 0, s>>>(req, zero, al, rq, pc, ap,
                                                   f, cp, N, R);
  else
    capacity_kernel<false><<<grid, kBlockN, 0, s>>>(req, zero, al, rq, pc,
                                                    ap, f, cp, N, R);
  return static_cast<int>(cudaGetLastError());
}
