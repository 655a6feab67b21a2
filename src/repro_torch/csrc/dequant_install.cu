// Fused int8 dequantize + per-site install for Hopper: the compressed
// downlink.  Every site's int8 broadcast delta q [S, C, c] with per-row
// fp32 scales [S, C] is added onto that site's held reference base
// [S, C, c]: out = base + q * scale.
//
// Replaces: src/repro/kernels/fedagg.py::dequant_install (the Pallas TPU
// kernel _dequant_install_kernel, one [S, block_c, chunk] VMEM slab per
// grid step).
//
// Bound: memory.  It reads q (1 byte), base (4 bytes) and the scales once
// and writes out (4 bytes) per site-element, for 2 operations each.  At full
// width (S = 4, 6,872,960 padded elements per site) that is 247.5 MB, about
// 74 us at an H100 SXM's 3.35 TB/s (use the bandwidth of the card actually
// run on).
//
// Design: the [S, C] rows are one [S*C] row axis.  One block per row
// (grid-stride over rows), threads over the row's columns (coalesced), the
// row's scale loaded once per thread; the dense per-site deltas never exist.
// Any c >= 1 and any row count; the ragged end of a row is masked, nothing
// is padded.  __fmul_rn then __fadd_rn, so nvcc contracts nothing into an
// FMA and the result is bit-equal to the plain version's base + q * scale.
//
// Plain C interface, bound from Python with ctypes; returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int64_t kMaxBlocks = 132 * 32;

__global__ void dequant_install_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scales,
                                       const float* __restrict__ base,
                                       float* __restrict__ out, int64_t rows,
                                       int64_t c) {
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const float s = __ldg(scales + row);
    const int64_t first = row * c;
    for (int64_t j = threadIdx.x; j < c; j += blockDim.x) {
      const int64_t i = first + j;
      out[i] = __fadd_rn(__ldg(base + i), __fmul_rn((float)q[i], s));
    }
  }
}

}  // namespace

extern "C" int dequant_install(const void* q, const void* scales,
                               const void* base, void* out, int64_t rows,
                               int64_t c, void* stream) {
  if (rows <= 0 || c <= 0) return (int)cudaSuccess;
  const int threads = c >= 256 ? 256 : (int)((c + 31) / 32 * 32);
  const int64_t blocks = rows < kMaxBlocks ? rows : kMaxBlocks;
  dequant_install_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<const float*>(base), static_cast<float*>(out), rows, c);
  return (int)cudaGetLastError();
}
