// Per-chunk int8 quantization for Hopper: fp32 x [C, c] -> int8 q [C, c] and
// fp32 scales [C], with scale = max(absmax(row) / 127, MIN_SCALE) and
// q = clip(rint(x / scale), -127, 127).
//
// Replaces: src/repro/kernels/quantize.py::quantize_int8 (the Pallas TPU
// kernel _quantize_kernel, which held one [block_c, chunk] slab in VMEM per
// grid step and reduced |x| along the chunk axis on the VPU).
//
// Bound: memory.  The kernel reads C*c fp32 once and writes C*c int8 and C
// fp32 once: 5 bytes per element for about 6 operations, far below the
// card's operations-per-byte balance point.  On the compressed round's path
// at full width (S = 4 sites x 6,797 chunk rows, 6,872,960 padded elements
// per site) that is 137.6 MB, about 41 us at an H100 SXM's 3.35 TB/s (use
// the bandwidth of the card actually run on).  99.7% of those bytes are in
// the 1024-wide chunk group.
//
// Design against that bound: one warp per row, grid-striding over rows, so
// the row's absmax is a warp-shuffle reduction with no shared memory and no
// second launch.
// - Rows whose width is a multiple of 4, at most 1024, with 16-byte aligned
//   pointers (every chunk group of the round): the row is read from device
//   memory once, into registers.  An instance is templated on the width
//   class (NV = 1, 2, 4 or 8 float4 a lane, up to 128 * NV elements), and a
//   lane issues all its 16-byte loads (float4 j*32 + lane: neighbouring
//   lanes on neighbouring addresses) before the shuffle reduction, so a
//   1024-wide row has 4 KB in flight a warp; with about 40 warps an SM that
//   is far above the ~25 KB an SM that hides the memory latency.  Each lane
//   then packs its four int8 values of a float4 into one 32-bit store.
// - Any other row (widths not a multiple of 4, wider than 1024, or
//   misaligned pointers): a generic path of two passes, an absmax of 4-byte
//   loads, then a second read (from L1/L2; a row is a few KB) that writes
//   one byte a lane.  Any c >= 1 and any row count; nothing is padded.
//
// Bit-exactness with the reference's numpy codec: IEEE division written out
// (__fdiv_rn; the build has no --use_fast_math), round half to even
// (rintf), then the clamp; the floor MIN_SCALE is passed in from Python, the
// same fp32 value the plain version uses.
//
// Plain C interface, bound from Python with ctypes; returns
// cudaGetLastError() after the launch, so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 32;

__device__ __forceinline__ float row_scale(float amax, float min_scale) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = __fdiv_rn(amax, 127.0f);
  return s < min_scale ? min_scale : s;
}

__device__ __forceinline__ float quant(float v, float s) {
  return fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
}

__device__ __forceinline__ uint32_t pack4(float4 v, float s) {
  return (uint32_t)(uint8_t)(int8_t)quant(v.x, s) |
         (uint32_t)(uint8_t)(int8_t)quant(v.y, s) << 8 |
         (uint32_t)(uint8_t)(int8_t)quant(v.z, s) << 16 |
         (uint32_t)(uint8_t)(int8_t)quant(v.w, s) << 24;
}

// One row in registers: c % 4 == 0, c <= 128 * NV, 16-byte aligned x.
template <int NV>
__global__ void __launch_bounds__(kThreads)
quantize_int8_vec(const float* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scales, int64_t rows, int64_t c, float min_scale) {
  const int lane = threadIdx.x & 31;
  const int quads = (int)(c / 4);
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  // the row index is the same for all lanes of a warp, so the loop is
  // warp-uniform and the full-mask shuffles are safe
  for (int64_t row = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
       row < rows; row += stride) {
    const float4* xr = reinterpret_cast<const float4*>(x + row * c);
    float4 v[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k = j * 32 + lane;
      v[j] = k < quads ? __ldg(xr + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      amax = fmaxf(fmaxf(amax, fmaxf(fabsf(v[j].x), fabsf(v[j].y))),
                   fmaxf(fabsf(v[j].z), fabsf(v[j].w)));
    const float s = row_scale(amax, min_scale);
    uint32_t* qr = reinterpret_cast<uint32_t*>(q + row * c);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k = j * 32 + lane;
      if (k < quads) qr[k] = pack4(v[j], s);
    }
    if (lane == 0) scales[row] = s;
  }
}

// Any width and alignment: two passes over the row, one byte stored a lane.
__global__ void __launch_bounds__(kThreads)
quantize_int8_any(const float* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scales, int64_t rows, int64_t c, float min_scale) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
       row < rows; row += stride) {
    const float* xr = x + row * c;
    float amax = 0.0f;
    for (int64_t j = lane; j < c; j += 32) amax = fmaxf(amax, fabsf(__ldg(xr + j)));
    const float s = row_scale(amax, min_scale);
    int8_t* qr = q + row * c;
    for (int64_t j = lane; j < c; j += 32) qr[j] = (int8_t)quant(__ldg(xr + j), s);
    if (lane == 0) scales[row] = s;
  }
}

using Kernel = void (*)(const float*, int8_t*, float*, int64_t, int64_t, float);

// The instance for rows of width c; `vec` when the pointers allow 16-byte loads.
Kernel pick(int64_t c, bool vec) {
  if (!vec || c % 4 != 0 || c > 1024) return quantize_int8_any;
  if (c <= 128) return quantize_int8_vec<1>;
  if (c <= 256) return quantize_int8_vec<2>;
  if (c <= 512) return quantize_int8_vec<4>;
  return quantize_int8_vec<8>;
}

}  // namespace

extern "C" int quantize_int8(const void* x, void* q, void* scales, int64_t rows,
                             int64_t c, float min_scale, void* stream) {
  if (rows <= 0 || c <= 0) return (int)cudaSuccess;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q)) & 15) == 0;
  int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  pick(c, vec)<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(scales),
      rows, c, min_scale);
  return (int)cudaGetLastError();
}

// For reports: the instance that takes rows of width c (aligned);
// out[5] = registers, local bytes, shared bytes, threads, blocks an SM.
extern "C" int quantize_int8_resources(int64_t c, int* out) {
  if (c < 1) return (int)cudaErrorInvalidValue;
  const Kernel kernel = pick(c, true);
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = kThreads;
  out[4] = blocks;
  return (int)cudaSuccess;
}
