// Fused int8 dequantize + Eq. 1 fold for Hopper: the compressed round's
// server step.  Inputs: every site's int8 upload q [S, C, c] with per-row
// fp32 scales [S, C], the quantized fp32 input u [S, C, c] and the weights
// w [S].  Outputs: g [C, c] = sum_s w_s * deq_s and the error-feedback
// residual r [S, C, c] = u - deq, where deq = q * scale.
//
// Replaces: src/repro/kernels/fedagg.py::fedagg_dequant (the Pallas TPU
// kernel _fedagg_dequant_kernel, which held one [S, block_c, chunk] slab of
// q, scales and u in VMEM per grid step).
//
// Bound: memory.  It reads q (1 byte), u (4 bytes) and the scales once and
// writes r (4 bytes) per site-element and g (4 bytes) per element, for 4
// operations per site-element.  At full width (S = 4, 6,872,960 padded
// elements per site) that is 275.0 MB, about 82 us at an H100 SXM's
// 3.35 TB/s (use the bandwidth of the card actually run on).
//
// Design against that bound: one pass, and the dense fp32 per-site models
// never exist.  One block per chunk row (grid-stride over rows), threads over
// the row's columns (coalesced); each thread loops over the S sites with the
// sum in an fp32 register, writes each site's residual as it goes and g once:
// no atomics, so the result is deterministic.  Any c >= 1, any row count and
// any S; the ragged end of a row is masked, nothing is padded.
//
// Rounding: deq = __fmul_rn, r = __fsub_rn and the fold's products and sums
// __fmul_rn/__fadd_rn, so nvcc contracts nothing into an FMA.  The residual
// is then bit-equal to the plain version's u - q * scale; g is summed over
// sites in order 0..S-1, which may differ from the plain version's order in
// the last bits.
//
// Plain C interface, bound from Python with ctypes; returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int64_t kMaxBlocks = 132 * 32;

__global__ void fedagg_dequant_kernel(const int8_t* __restrict__ q,
                                      const float* __restrict__ scales,
                                      const float* __restrict__ u,
                                      const float* __restrict__ w,
                                      float* __restrict__ g,
                                      float* __restrict__ r, int64_t s,
                                      int64_t rows, int64_t c) {
  const int64_t site_stride = rows * c;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    for (int64_t j = threadIdx.x; j < c; j += blockDim.x) {
      const int64_t col = row * c + j;
      float acc = 0.0f;
      for (int64_t k = 0; k < s; ++k) {
        const int64_t i = k * site_stride + col;
        const float deq = __fmul_rn((float)q[i], __ldg(scales + k * rows + row));
        r[i] = __fsub_rn(__ldg(u + i), deq);
        acc = __fadd_rn(acc, __fmul_rn(__ldg(w + k), deq));
      }
      g[col] = acc;
    }
  }
}

}  // namespace

extern "C" int fedagg_dequant(const void* q, const void* scales, const void* u,
                              const void* w, void* g, void* r, int64_t s,
                              int64_t rows, int64_t c, void* stream) {
  if (s <= 0 || rows <= 0 || c <= 0) return (int)cudaSuccess;
  const int threads = c >= 256 ? 256 : (int)((c + 31) / 32 * 32);
  const int64_t blocks = rows < kMaxBlocks ? rows : kMaxBlocks;
  fedagg_dequant_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<const float*>(u), static_cast<const float*>(w),
      static_cast<float*>(g), static_cast<float*>(r), s, rows, c);
  return (int)cudaGetLastError();
}
