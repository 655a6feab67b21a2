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
// the bandwidth of the card actually run on).
//
// Design against that bound: one warp per row, grid-stride over rows, so the
// row's absmax is a warp-shuffle reduction with no shared memory and no
// second launch.  Pass one reads the row (lane l reads elements l, l+32, ...:
// coalesced) for the absmax; pass two reads it again, from L1/L2 (a row is a
// few KB), and writes q.  Any c >= 1 and any row count: the lanes mask the
// ragged end of a row, and nothing is padded.
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
constexpr int64_t kMaxBlocks = 132 * 16;

__global__ void quantize_int8_kernel(const float* __restrict__ x,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scales, int64_t rows,
                                     int64_t c, float min_scale) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  // the row index is the same for all lanes of a warp, so every loop below
  // is warp-uniform and the full-mask shuffles are safe
  for (int64_t row = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
       row < rows; row += stride) {
    const float* xr = x + row * c;
    float amax = 0.0f;
    for (int64_t j = lane; j < c; j += 32) amax = fmaxf(amax, fabsf(__ldg(xr + j)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    float s = __fdiv_rn(amax, 127.0f);
    s = s < min_scale ? min_scale : s;
    int8_t* qr = q + row * c;
    for (int64_t j = lane; j < c; j += 32) {
      const float v = rintf(__fdiv_rn(__ldg(xr + j), s));
      qr[j] = (int8_t)fminf(fmaxf(v, -127.0f), 127.0f);
    }
    if (lane == 0) scales[row] = s;
  }
}

}  // namespace

extern "C" int quantize_int8(const void* x, void* q, void* scales, int64_t rows,
                             int64_t c, float min_scale, void* stream) {
  if (rows <= 0 || c <= 0) return (int)cudaSuccess;
  int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  quantize_int8_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scales), rows, c, min_scale);
  return (int)cudaGetLastError();
}
