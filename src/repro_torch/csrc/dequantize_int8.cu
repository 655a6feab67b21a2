// Per-chunk int8 dequantization for Hopper: int8 q [C, c] x fp32 scales [C]
// -> fp32 out [C, c] = q * scale.
//
// Replaces: src/repro/kernels/quantize.py::dequantize_int8 (the Pallas TPU
// kernel _dequantize_kernel, one [block_c, chunk] VMEM slab per grid step).
//
// Bound: memory.  It reads C*c int8 and C fp32 and writes C*c fp32 once:
// 5 bytes and one multiply per element.  Decoding one full-width SA-Net
// model off the wire (6,872,960 padded elements) moves 34.4 MB, about 10 us
// at an H100 SXM's 3.35 TB/s (use the bandwidth of the card actually run on).
//
// Design: one block per row, grid-stride over rows, threads stride over the
// row's columns (coalesced), so the row's scale is one load per thread and
// no per-element index division is needed.  The block is 256 threads, or
// the row width rounded up to a warp for narrow rows.  Any c >= 1 and any
// row count; the ragged end of a row is masked, nothing is padded.  The
// product is __fmul_rn: one rounding, as in the plain version.
//
// Plain C interface, bound from Python with ctypes; returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int64_t kMaxBlocks = 132 * 32;

__global__ void dequantize_int8_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scales,
                                       float* __restrict__ out, int64_t rows,
                                       int64_t c) {
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const float s = __ldg(scales + row);
    const int64_t base = row * c;
    for (int64_t j = threadIdx.x; j < c; j += blockDim.x)
      out[base + j] = __fmul_rn((float)q[base + j], s);
  }
}

}  // namespace

extern "C" int dequantize_int8(const void* q, const void* scales, void* out,
                               int64_t rows, int64_t c, void* stream) {
  if (rows <= 0 || c <= 0) return (int)cudaSuccess;
  const int threads = c >= 256 ? 256 : (int)((c + 31) / 32 * 32);
  const int64_t blocks = rows < kMaxBlocks ? rows : kMaxBlocks;
  dequantize_int8_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), rows, c);
  return (int)cudaGetLastError();
}
