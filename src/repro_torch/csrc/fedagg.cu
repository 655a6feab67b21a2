// Federated weight aggregation (paper Eq. 1) for Hopper: out = sum_s w_s * x_s.
//
// Replaces: src/repro/kernels/fedagg.py::fedagg (the Pallas TPU kernel
// _fedagg_kernel, which reduced one [S, block_n] VMEM slab per grid step
// over a buffer zero-padded to a block multiple).
//
// Bound: memory.  The kernel reads the [S, N] buffer once (S*N*b bytes) and
// writes [N] once (N*b bytes) with one fused multiply-add per element read,
// far below the card's operations-per-byte balance point.  At S = 4 and the
// full-width SA-Net's N = 6,844,323 in fp32 that is 136.9 MB, about 41 us at
// an H100 SXM's 3.35 TB/s (use the bandwidth of the card actually run on).
//
// Design against that bound: one pass and no intermediate per-site buffers.
// Each thread owns columns (grid-stride), loops over the S rows keeping the
// sum in an fp32 register, and writes each output element exactly once: no
// atomics, so the result is deterministic.  Neighbouring threads read
// neighbouring addresses of each row, so every load is coalesced.  The ragged
// tail is masked by the column bound instead of padding N, and nothing is
// copied.  Rows start at s*N with 64-bit offsets.  Loads are scalar on
// purpose: N is odd on the main path, so rows s > 0 are not 16-byte aligned
// and a float4 load would be misaligned there.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// are passed as void*, sizes as int64.  Each entry point returns
// cudaGetLastError() after the launch, so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void fedagg_kernel(const T* __restrict__ x,
                              const float* __restrict__ w,
                              T* __restrict__ out, int64_t s, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    float acc = 0.0f;
#pragma unroll 4
    for (int64_t r = 0; r < s; ++r) {
      acc = fmaf(__ldg(w + r), load_f32(x + r * n + j), acc);
    }
    store_from_f32(out + j, acc);
  }
}

constexpr int kThreads = 256;
// Enough resident blocks to fill 132 SMs several times over; larger N is
// covered by the grid-stride loop.
constexpr int64_t kMaxBlocks = 132 * 16;

template <typename T>
int launch(const void* x, const void* w, void* out, int64_t s, int64_t n,
           void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fedagg_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(out), s, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fedagg_f32(const void* x, const void* w, void* out, int64_t s,
                          int64_t n, void* stream) {
  return launch<float>(x, w, out, s, n, stream);
}

extern "C" int fedagg_bf16(const void* x, const void* w, void* out, int64_t s,
                           int64_t n, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, s, n, stream);
}
