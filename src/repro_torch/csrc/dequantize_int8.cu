// Per-chunk int8 dequantization of a whole message in one launch, for Hopper.
//
// Replaces: src/repro/kernels/quantize.py:107 dequantize_int8 (the Pallas
// TPU kernel _dequantize_kernel: one [block_c, chunk] VMEM slab of one
// matrix per grid step; the reference's codec calls it once per leaf).
//
// What it computes: for every int8 leaf of a message, given as a row of a
// leaf table, out[out_off + r * width + j] = q[r, j] * scale[r] for the
// leaf's first `size` elements in row-major order (the padding of its last
// row is not written), so the decoded tree is views of one fp32 buffer.
// The product is __fmul_rn((float)q, s): one rounding, bit-equal to the
// plain version and to the reference's numpy codec.
//
// Bound: memory.  It reads sum(rows * width) int8, sum(rows) fp32 scales and
// the table, and writes sum(size) fp32 once.  One full-width SA-Net message
// (160 leaves, 6,797 rows at align 128) moves about 34.4 MB: 10.3 us at an
// H100 SXM's 3.35 TB/s.  Per-leaf launches were what held the old kernel
// back (160 of them a message, most for leaves of a few hundred bytes).
//
// Design:
// - one launch a message.  The table is int64 [leaves, 7]: q offset, scale
//   offset, rows, width, size, output offset, first row in the flat row
//   space.  q and scale offsets are added to two base addresses, so one
//   cached table serves every message of a layout: offsets into one copied
//   payload span (a received frame, q_base = s_base = the span), or into
//   the encoder's own q and scale buffers.
// - work: one warp a row of the flat row space over all leaves, grid-stride;
//   a warp finds its leaf by binary search over the table's first-row column
//   (read-only cache; a model has a few hundred leaves).
// - stores: the output of most rows is NOT 16-byte aligned (the leaves are
//   packed without padding, and one leaf of odd size shifts every leaf
//   after it: 6,100 of SA-Net's 6,797 rows).  So a warp writes the up to
//   three values before the row's first 16-byte boundary one a lane, then
//   four values a lane with one 16-byte store, lane after lane (each warp
//   store is 512 contiguous bytes), then the ragged end.  Sixteen int8 a
//   lane (one 16-byte load, four 16-byte stores: 64 contiguous bytes a
//   lane) took 0.035 ms against this design's 0.022 ms on one full-width
//   message (probe_dequant_lanes.py; H100 80GB HBM3, 700 W).
// - loads: a q row at a 4-byte boundary whose width is a multiple of 4
//   (every row of the card's align=128 encodes) is read a 32-bit word a
//   lane, realigned to the output by a funnel shift with the next word; a
//   row from a CPU encoder (align=1: odd widths, rows and scales at any
//   byte offset) is read byte by byte, and a scale at any offset as four
//   bytes.  Nothing gives way to the plain version.
//
// Plain C interface, bound from Python with ctypes; each entry returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 7;          // q_off, s_off, rows, width, size, out_off, row0
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 16;

struct Leaf {
  int64_t q_off, s_off, rows, width, size, out_off, row0;
};

__device__ __forceinline__ Leaf load_leaf(const int64_t* __restrict__ t, int64_t i) {
  const int64_t* e = t + i * kCols;
  return Leaf{__ldg(e), __ldg(e + 1), __ldg(e + 2), __ldg(e + 3),
              __ldg(e + 4), __ldg(e + 5), __ldg(e + 6)};
}

__device__ __forceinline__ float load_scale(const unsigned char* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 3) == 0) return __ldg(reinterpret_cast<const float*>(p));
  const uint32_t b = (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + 1) << 8) |
                     ((uint32_t)__ldg(p + 2) << 16) | ((uint32_t)__ldg(p + 3) << 24);
  return __uint_as_float(b);
}

__device__ __forceinline__ float deq(uint32_t word, int k, float s) {
  return __fmul_rn((float)(int8_t)(word >> (8 * k)), s);
}

__device__ __forceinline__ float4 deq4(uint32_t word, float s) {
  return make_float4(deq(word, 0, s), deq(word, 1, s), deq(word, 2, s), deq(word, 3, s));
}

// One row, by one warp: the values before the output's first 16-byte
// boundary one a lane, then four values a lane (lane after lane, so a
// warp's store is 512 contiguous bytes), then the ragged end.
__device__ void row(const Leaf& lf, int64_t r, const unsigned char* __restrict__ q_base,
                    const unsigned char* __restrict__ s_base, float* __restrict__ out,
                    int lane) {
  const unsigned char* q = q_base + lf.q_off + r * lf.width;
  const float s = load_scale(s_base + lf.s_off + 4 * r);
  const int64_t first = r * lf.width;
  const int64_t n = lf.size - first < lf.width ? lf.size - first : lf.width;
  float* dst = out + lf.out_off + first;
  const int64_t head = (4 - ((reinterpret_cast<uintptr_t>(dst) >> 2) & 3)) & 3;
  const int a = (int)(head < n ? head : n);
  if (lane < a) dst[lane] = __fmul_rn((float)(int8_t)__ldg(q + lane), s);
  const int64_t groups = (n - a) >> 2;
  float4* dst4 = reinterpret_cast<float4*>(dst + a);
  if ((reinterpret_cast<uintptr_t>(q) & 3) == 0 && (lf.width & 3) == 0) {
    // word loads; a funnel shift realigns q to the output (the word after
    // lies inside the row: the width is a multiple of 4)
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q);
    if (a == 0) {
      for (int64_t t = lane; t < groups; t += 32) dst4[t] = deq4(__ldg(q32 + t), s);
    } else {
      for (int64_t t = lane; t < groups; t += 32)
        dst4[t] = deq4(__funnelshift_r(__ldg(q32 + t), __ldg(q32 + t + 1), 8 * a), s);
    }
  } else {
    // a CPU encoder's message: rows at any byte offset, read byte by byte
    for (int64_t t = lane; t < groups; t += 32) {
      const unsigned char* p = q + a + 4 * t;
      const uint32_t w = (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + 1) << 8) |
                         ((uint32_t)__ldg(p + 2) << 16) | ((uint32_t)__ldg(p + 3) << 24);
      dst4[t] = deq4(w, s);
    }
  }
  const int64_t j = a + 4 * groups + lane;
  if (j < n) dst[j] = __fmul_rn((float)(int8_t)__ldg(q + j), s);
}

// A message's leaves come from `table` (device); one matrix (table ==
// nullptr) is the one-entry table `single`, passed by value.
__global__ void __launch_bounds__(kThreads)
dequantize_int8_kernel(const int64_t* __restrict__ table, int64_t leaves, int64_t total_rows,
                       Leaf single, const unsigned char* __restrict__ q_base,
                       const unsigned char* __restrict__ s_base, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t g = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); g < total_rows;
       g += warps) {
    Leaf lf = single;
    if (table != nullptr) {
      int64_t lo = 0, hi = leaves - 1;        // the last leaf whose first row <= g
      while (lo < hi) {
        const int64_t mid = (lo + hi + 1) >> 1;
        if (__ldg(table + mid * kCols + 6) <= g) lo = mid; else hi = mid - 1;
      }
      lf = load_leaf(table, lo);
    }
    row(lf, g - lf.row0, q_base, s_base, out, lane);
  }
}

int64_t blocks_for(int64_t rows) {
  const int64_t b = (rows + kWarps - 1) / kWarps;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

}  // namespace

// A message: `leaves` rows of `table` (device, int64 [leaves, 7]); q and
// scale offsets are relative to q_base and s_base.
extern "C" int dequantize_int8_grouped(const void* table, int64_t leaves, int64_t total_rows,
                                       const void* q_base, const void* s_base, void* out,
                                       void* stream) {
  if (leaves <= 0 || total_rows <= 0) return (int)cudaSuccess;
  dequantize_int8_kernel<<<(unsigned)blocks_for(total_rows), kThreads, 0,
                           (cudaStream_t)stream>>>(
      static_cast<const int64_t*>(table), leaves, total_rows, Leaf{},
      static_cast<const unsigned char*>(q_base), static_cast<const unsigned char*>(s_base),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// One [rows, c] matrix: the one-entry table.
extern "C" int dequantize_int8(const void* q, const void* scales, void* out, int64_t rows,
                               int64_t c, void* stream) {
  if (rows <= 0 || c <= 0) return (int)cudaSuccess;
  dequantize_int8_kernel<<<(unsigned)blocks_for(rows), kThreads, 0, (cudaStream_t)stream>>>(
      nullptr, 1, rows, Leaf{0, 0, rows, c, rows * c, 0, 0},
      static_cast<const unsigned char*>(q), static_cast<const unsigned char*>(scales),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// Registers, local memory, shared memory, threads and blocks an SM of the
// kernel, as cudaFuncGetAttributes and the occupancy calculator
// give them.
extern "C" int dequantize_int8_resources(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, dequantize_int8_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dequantize_int8_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = kThreads;
  out[4] = blocks;
  return 0;
}
