// Masked coordinate-wise trimmed mean over sites for Hopper: the robust
// aggregation rules trimmed:f and median.
//
// Replaces: src/repro/kernels/robust.py::trimmed_mean and ::masked_median
// (the Pallas TPU kernel _trimmed_kernel, whose body _trim_block sorted one
// [S, block_n] VMEM slab over the site axis per grid step, over a buffer
// zero-padded to a block multiple).
//
// For every column j of the [S, N] fp32 buffer x, with k rows active
// (active[r] > 0.5): the inactive rows become +inf, the column is sorted
// ascending with NaN last (the order of jnp.sort and torch.sort), and the
// result is the unweighted mean of ranks [fe, k - fe), where
// fe = min(f, max(k - 1, 0) / 2); with k = 0 it is 0.  The median is f = S.
//
// Bound: memory.  The kernel reads [S, N] once and writes [N] once.  At
// S = 4 and the full-width SA-Net's N = 6,844,323 that is (4 + 1) * 4 * N =
// 136.9 MB, about 41 us at an H100 SXM's 3.35 TB/s: the same bound as fedagg.
// Sorting four values is six compare-swaps per column, far below the card's
// operations-per-byte balance point.
//
// Design against that bound: one pass, one thread per column, grid-stride
// as in fedagg.cu.  Loads are scalar and coalesced (N is odd on the main
// path, so rows s > 0 are not 16-byte aligned) and the ragged tail is masked
// by the column bound instead of padding N.  The active mask stays a device
// tensor: every thread counts k itself, so the host computes nothing per
// round.  Up to 32 sites the column lives in registers: the kernel is
// templated on the smallest S_MAX in {4, 8, 16, 32} that holds S, and an
// odd-even transposition network of compile-time indices sorts it.  The
// inactive rows (not read) are +inf, so an active NaN sorts past them, as in
// the plain version; the padding rows past S are NaN, so they sort past
// everything and the first S ranks are the plain version's.  From 33
// to kMaxSites sites the column lives in shared memory ([S][threads], so
// neighbouring threads hit neighbouring banks) and an insertion sort orders
// it.  Either way the kept ranks are added in ascending order with __fadd_rn
// from +0.0 and divided with __fdiv_rn, the sequence of the plain version
// (trimmed_mean_ref): built without --use_fast_math, the two are bit-equal.
// Adding a value only where its rank is kept, instead of adding 0.0
// elsewhere as the plain version does, changes nothing: the running sum
// starts at +0.0 and never becomes -0.0, so adding +0.0 leaves it as it is.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// are passed as void*, sizes as int64.  The entry point returns
// cudaGetLastError() after the launch, so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSites = 256;     // the wrapper refuses more (MAX_SITES)
constexpr int kThreads = 256;      // register kernels
constexpr int kWideThreads = 32;   // shared-memory kernel: <= 32 KB a block
// Enough resident blocks to fill 132 SMs several times over; larger N is
// covered by the grid-stride loop.
constexpr int64_t kMaxBlocks = 132 * 16;

// a sorts after b: a > b, and NaN after every number (torch.sort's order).
__device__ __forceinline__ bool after(float a, float b) {
  return (b < a) || (isnan(a) && !isnan(b));
}

__device__ __forceinline__ void compare_swap(float& a, float& b) {
  const bool swap = after(a, b);
  const float lo = swap ? b : a;
  const float hi = swap ? a : b;
  a = lo;
  b = hi;
}

template <int SMAX>
__device__ __forceinline__ void sort_network(float (&v)[SMAX]) {
#pragma unroll
  for (int pass = 0; pass < SMAX; ++pass) {
#pragma unroll
    for (int i = pass & 1; i + 1 < SMAX; i += 2) compare_swap(v[i], v[i + 1]);
  }
}

// SMAX <= 32: the column in registers.  SMAX == kMaxSites: the column in
// shared memory, kWideThreads columns a block.
template <int SMAX>
__global__ void trimmed_mean_kernel(const float* __restrict__ x,
                                    const float* __restrict__ active,
                                    float* __restrict__ out, int s, int64_t n,
                                    int f) {
  int k = 0;
  for (int r = 0; r < s; ++r) k += __ldg(active + r) > 0.5f;
  const int fe = min(f, max(k - 1, 0) / 2);
  const int lo = fe, hi = k - fe;
  const float denom = (float)max(k - 2 * fe, 1);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;

  if constexpr (SMAX <= 32) {
    uint32_t act = 0;
    for (int r = 0; r < s; ++r)
      act |= (uint32_t)(__ldg(active + r) > 0.5f) << r;
    for (int64_t j = first; j < n; j += stride) {
      float v[SMAX];
#pragma unroll
      for (int r = 0; r < SMAX; ++r)
        v[r] = r >= s ? NAN
                      : (((act >> r) & 1u) ? __ldg(x + (int64_t)r * n + j)
                                           : INFINITY);
      sort_network<SMAX>(v);
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < SMAX; ++r)
        if (r >= lo && r < hi) acc = __fadd_rn(acc, v[r]);
      out[j] = __fdiv_rn(acc, denom);
    }
  } else {
    extern __shared__ float columns[];            // [s][blockDim.x]
    float* col = columns + threadIdx.x;
    const int b = blockDim.x;
    // the loop bound is the same for every thread of the block, so the
    // threads leave it together (no barrier is needed: each thread only
    // touches its own column)
    for (int64_t j = first; j < n; j += stride) {
      for (int r = 0; r < s; ++r)
        col[r * b] = __ldg(active + r) > 0.5f ? __ldg(x + (int64_t)r * n + j)
                                               : INFINITY;
      for (int i = 1; i < s; ++i) {
        const float key = col[i * b];
        int p = i - 1;
        while (p >= 0 && after(col[p * b], key)) {
          col[(p + 1) * b] = col[p * b];
          --p;
        }
        col[(p + 1) * b] = key;
      }
      float acc = 0.0f;
      for (int r = lo; r < hi; ++r) acc = __fadd_rn(acc, col[r * b]);
      out[j] = __fdiv_rn(acc, denom);
    }
  }
}

template <int SMAX>
int launch(const void* x, const void* active, void* out, int s, int64_t n,
           int f, void* stream) {
  const int threads = SMAX <= 32 ? kThreads : kWideThreads;
  const size_t smem = SMAX <= 32 ? 0 : (size_t)s * threads * sizeof(float);
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  trimmed_mean_kernel<SMAX>
      <<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
          static_cast<const float*>(x), static_cast<const float*>(active),
          static_cast<float*>(out), s, n, f);
  return (int)cudaGetLastError();
}

}  // namespace

// x [s, n] fp32, active [s] fp32, out [n] fp32; 1 <= s <= kMaxSites, f >= 0.
extern "C" int trimmed_mean_f32(const void* x, const void* active, void* out,
                                int64_t s, int64_t n, int64_t f, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (s < 1 || s > kMaxSites || f < 0) return (int)cudaErrorInvalidValue;
  const int fi = f > s ? (int)s : (int)f;   // fe <= (s - 1) / 2 whatever f is
  if (s <= 4) return launch<4>(x, active, out, (int)s, n, fi, stream);
  if (s <= 8) return launch<8>(x, active, out, (int)s, n, fi, stream);
  if (s <= 16) return launch<16>(x, active, out, (int)s, n, fi, stream);
  if (s <= 32) return launch<32>(x, active, out, (int)s, n, fi, stream);
  return launch<kMaxSites>(x, active, out, (int)s, n, fi, stream);
}
