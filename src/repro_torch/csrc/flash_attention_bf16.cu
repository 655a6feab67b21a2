// Causal GQA attention with an online softmax (flash attention) for Hopper, in
// bf16 on the warpgroup products (wgmma).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel _flash_kernel) for bf16 tensors; flash_attention.cu keeps the
// fp32 instance.
//
// q [B, Hq, Lq, Dqk], k [B, Hkv, Lk, Dqk], v [B, Hkv, Lk, Dv], out [B, Hq, Lq,
// Dv], bf16, contiguous, 16-byte aligned; lse, where not null, [B, Hq, Lq]
// fp32, each row's log-sum-exp of the scaled scores, which the backward
// (flash_attention_bwd_bf16.cu) reads.  Instances (Dqk, Dv): (32, 32), (64,
// 64), (128, 128), (256, 256) and DeepSeek-V2's MLA (192, 128), so that MLA
// runs unpadded.  q head h reads kv head h / (Hq / Hkv); the queries are the
// last Lq positions; a key at position j is seen from position i if j <= i
// (causal) and j > i - window (window > 0).  Scores are q.k * scale (Dqk^-0.5
// unless the caller passes another) in fp32, softmax and the sums in fp32, P
// rounded to bf16 before P V (the row sum l is taken from the fp32 P), l
// clamped at 1e-30 before the division.
//
// Bound: at smollm-135m's shape (B 4, Hq 9, Hkv 3, L 2048, D 64, causal) the
// two products are 2 * 2 * D flops for each of the 75.5 M pairs seen, 19.3
// GFLOP: 0.0196 ms at an H100 SXM's 989 TFLOP/s of dense bf16; its bytes (q,
// k, v in, out out) 25 MB, 0.0075 ms at 3.35 TB/s.  Bound by operations.
//
// Design.
// - Products on wgmma, bf16 operands, fp32 accumulators.  S = Q K^T with Q
//   and K read K-major from shared memory (wgmma_ss); O += P V with P from
//   registers (the score accumulators rounded to bf16 are its A fragments as
//   they stand) and V read MN-major from the same shared layout (the
//   transpose bit: no transposed copy).  Each 16-deep step of S is one
//   instruction over the whole key tile (m64 n128 or n64), each step of P V
//   one over all of Dv.  The scale multiplies the fp32 scores inside the
//   exponent (2^(s scale log2 e - m)), so a bf16 q is not rounded again.
// - A block: two warpgroups (256 threads), each with 64 packed rows of one
//   (batch, kv head): packed row R is q head hk * G + R % G at query R / G for
//   the group G = Hq / Hkv, so each K/V tile is staged once for the whole
//   group and the rows of a query share its causal/window range.  Each
//   warpgroup keeps its own online softmax (a thread owns rows g and g + 8 of
//   its warp's 16: their max and sum are quad shuffles), and skips a tile
//   that none of its rows sees; a tile that all of its rows see in full skips
//   the mask.  Keys past the range are zero-filled, never read as garbage.
// - Staging: Q (128 rows) once, K and V through a ring of tiles of kN keys
//   filled by cp.async (16 bytes a thread, into the swizzled layout;
//   fence.proxy.async makes each thread's copies visible to wgmma), so the
//   next tile's copy runs under this tile's products and softmax.  kN = 128
//   keys up to Dqk 192, 64 at 256.
// - A warpgroup takes S, the softmax and P V of a tile in turn; the block's
//   two warpgroups overlap each other's products and softmax.
// - Shared memory: Q 128 x Dqk + 2 x kN x (Dqk + Dv) bf16, plus 1 KB to
//   align: 41 KB at D 32, 81 KB at D 64, 161 KB at D 128, 193 KB at D 256,
//   209 KB at MLA's (192, 128).  Registers a thread: O Dv / 2, S kN / 2, P
//   kN / 4.  Two blocks an SM up to D 64, one above.
// - The grid is one row of B * Hkv * row-tile blocks, the row tiles with the
//   most keys first across every batch and kv head.
// - What it does not do yet: no TMA and no producer warp (every thread
//   copies), no overlap of one tile's softmax with the next tile's S inside
//   a warpgroup, no persistence.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// as void*, sizes as int64.  The entry returns cudaGetLastError() after the
// launch, so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace {

using namespace wgbf16;
using bf16 = __nv_bfloat16;

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kRows = 64 * kWarpgroups;     // packed rows a block: 64 a warpgroup
constexpr float kNegInf = -1e30f;

template <int DQK, int DV>
struct Shape {
  static constexpr int kN = DQK > 192 ? 64 : 128;      // keys a K/V tile
  using TQ = Tile<DQK>;
  using TV = Tile<DV>;
  static constexpr int kQBytes = TQ::template bytes<kRows>();
  static constexpr int kKBytes = TQ::template bytes<kN>();
  static constexpr int kVBytes = TV::template bytes<kN>();
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kStages = 2;
  static constexpr size_t kSmem = kQBytes + kStages * kStageBytes + 1024;   // + alignment
  static_assert(kQBytes % 1024 == 0 && kKBytes % 1024 == 0 && kVBytes % 1024 == 0, "align");
};

// two blocks an SM up to D 64 (128 registers, a few spilled): the other
// block's products run under this one's softmax (chip_smoke.py phase 24a
// prints the registers and spilled bytes of each instance)
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, DQK <= 64 ? 2 : 1)
flash_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out,
                            float* __restrict__ lse, int hq, int hkv, int lq, int lk,
                            int causal, int window, float scale) {
  using F = Shape<DQK, DV>;
  using TQ = typename F::TQ;
  using TV = typename F::TV;
  constexpr int kN = F::kN, kStages = F::kStages;
  extern __shared__ uint8_t smem_raw[];
  // the tiles start on a 1024-byte boundary (the swizzle's period)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;                 // Q [kRows x DQK]
  const uint32_t sring = sq + F::kQBytes;                    // [kStages][K, V]

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = hq / hkv;
  const int nrows = lq * group;                               // packed (query, head) rows
  const int ntr = (nrows + kRows - 1) / kRows;
  const int nbh = gridDim.x / ntr;
  const int r0 = (ntr - 1 - (int)blockIdx.x / nbh) * kRows;   // the most keys first
  const int hk = blockIdx.x % nbh % hkv, b = blockIdx.x % nbh / hkv;
  const int offset = lk - lq;
  const int64_t kbase = ((int64_t)b * hkv + hk) * lk * DQK;
  const int64_t vbase = ((int64_t)b * hkv + hk) * lk * DV;
  auto row_index = [&](int row) -> int64_t {              // [B, Hq, Lq] index of a packed row
    return ((int64_t)b * hq + hk * group + row % group) * lq + row / group;
  };

  for (int i = tid; i < kRows * (DQK / 8); i += kThreads) {
    const int row = i / (DQK / 8), c = i % (DQK / 8);
    const bool ok = r0 + row < nrows;
    cp_async16(sq + TQ::template offset<kRows>(row, c),
               q + (ok ? row_index(r0 + row) * DQK : 0) + 8 * c, ok);
  }

  // the keys this block's rows can see: [kbeg, kend)
  const int pos_lo = r0 / group + offset;
  const int pos_hi = (min(r0 + kRows, nrows) - 1) / group + offset;
  const int kend = causal ? min(lk, pos_hi + 1) : lk;
  const int kbeg = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int ntiles = kend > kbeg ? (kend - kbeg + kN - 1) / kN : 0;

  // the warpgroup's 64 rows, and this thread's two (g and g + 8 of its warp)
  const int w0 = r0 + 64 * wg;
  const bool wg_live = w0 < nrows;
  const int wpos_lo = w0 / group + offset;
  const int wpos_hi = (min(w0 + 64, nrows) - 1) / group + offset;
  const int rows[2] = {w0 + 16 * warp + g, w0 + 16 * warp + g + 8};
  const int pos[2] = {rows[0] / group + offset, rows[1] / group + offset};

  auto load_tile = [&](int it) {
    const int t0 = kbeg + it * kN;
    const uint32_t ks = sring + (it % kStages) * F::kStageBytes;
    const uint32_t vs = ks + F::kKBytes;
    for (int i = tid; i < kN * (DQK / 8); i += kThreads) {
      const int j = i / (DQK / 8), c = i % (DQK / 8);
      const bool ok = t0 + j < kend;
      cp_async16(ks + TQ::template offset<kN>(j, c), k + kbase + (int64_t)(ok ? t0 + j : 0) * DQK
                 + 8 * c, ok);
    }
    for (int i = tid; i < kN * (DV / 8); i += kThreads) {
      const int j = i / (DV / 8), c = i % (DV / 8);
      const bool ok = t0 + j < kend;
      cp_async16(vs + TV::template offset<kN>(j, c), v + vbase + (int64_t)(ok ? t0 + j : 0) * DV
                 + 8 * c, ok);
    }
    cp_async_commit();
  };

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};      // m in log2 units
  const float sl2 = scale * kLog2e;

  if (ntiles > 0) {
    load_tile(0);                                             // Q joins tile 0's group
  } else {
    cp_async_commit();
    cp_async_wait<0>();
  }
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_tile(it + 1);                      // its stage was freed by the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();                          // tile it (and Q) visible to every warpgroup
    const int t0 = kbeg + it * kN;
    const bool live = wg_live && (!causal || t0 <= wpos_hi) &&
                      (window <= 0 || t0 + kN - 1 > wpos_lo - window);
    if (live) {
      const uint32_t ks = sring + (it % kStages) * F::kStageBytes;
      const uint32_t vs = ks + F::kKBytes;
      float s[kN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        wgmma_ss<kN>(s, TQ::kdesc(sq + TQ::template kmajor<kRows>(64 * wg, kk)),
                     TQ::kdesc(ks + TQ::template kmajor<kN>(0, kk)), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // every row of the warpgroup sees every key of the tile: no mask
      const bool full = t0 + kN <= kend && (!causal || t0 + kN - 1 <= wpos_lo) &&
                        (window <= 0 || t0 > wpos_hi - window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const int h = (i >> 1) & 1;
        float x = s[i] * sl2;
        if (!full) {
          const int key = t0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const bool ok = key < kend && (!causal || key <= pos[h]) &&
                          (window <= 0 || key > pos[h] - window);
          x = ok ? x : -INFINITY;
        }
        s[i] = x;
        mx[h] = fmaxf(mx[h], x);
      }
      float alpha[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = ex2(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const int h = (i >> 1) & 1;
        s[i] = ex2(s[i] - m[h]);                          // -inf (masked) -> 0
        rsum[h] += s[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rsum[h];
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      uint32_t a[kN / 16][4];
      to_frags<kN>(s, a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wgmma_rs<DV>(o, a[kk], TV::template mndesc<kN>(vs + TV::template mnmajor<kN>(kk, 0)), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    __syncthreads();                          // the stage is consumed
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= nrows) continue;
    const float denom = fmaxf(l[h], 1e-30f), inv = 1.0f / denom;
    const int64_t row = row_index(rows[h]);
    if (lse != nullptr && t == 0) lse[row] = m[h] * 0.6931471805599453f + logf(denom);
    bf16* dst = out + row * DV + 2 * t;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

// Raise the instance's dynamic shared memory limit, once, so that no launch
// inside a CUDA-graph capture sets it.
template <int DQK, int DV>
cudaError_t prepare() {
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Shape<DQK, DV>::kSmem);
  return err;
}

template <int DQK, int DV>
int resources(int* out) {
  constexpr size_t smem = Shape<DQK, DV>::kSmem;
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t err = prepare<DQK, DV>();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, flash_attention_bf16_kernel<DQK, DV>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flash_attention_bf16_kernel<DQK, DV>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + smem);
  out[3] = kThreads;
  out[4] = blocks;
  return (int)cudaSuccess;
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int64_t b,
           int64_t hq, int64_t hkv, int64_t lq, int64_t lk, int64_t causal, int64_t window,
           double scale, void* stream) {
  const cudaError_t err = prepare<DQK, DV>();
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = lq * (hq / hkv);
  const dim3 grid((unsigned)((rows + kRows - 1) / kRows * hkv * b));
  flash_attention_bf16_kernel<DQK, DV><<<grid, kThreads, Shape<DQK, DV>::kSmem,
                                         (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), (int)hq, (int)hkv, (int)lq, (int)lk,
      (int)causal, (int)window, (float)(scale > 0.0 ? scale : 1.0 / sqrt((double)DQK)));
  return (int)cudaGetLastError();
}

}  // namespace

// window 0 means none; causal 0 or 1; lse may be null; scale <= 0 means Dqk^-0.5.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    void* lse, int64_t b, int64_t hq, int64_t hkv, int64_t lq,
                                    int64_t lk, int64_t dqk, int64_t dv, int64_t causal,
                                    int64_t window, double scale, void* stream) {
  if (b <= 0 || hq <= 0 || lq <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv || lq > lk || window < 0 || b > 65535 || hkv > 65535 ||
      lq * hq > 0x7fffffff || lk > 0x7fffffff || (lq * hq / kRows + 1) * b > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
#define FA_BF16(DQK, DV)                                                                  \
  if (dqk == DQK && dv == DV)                                                             \
    return launch<DQK, DV>(q, k, v, out, lse, b, hq, hkv, lq, lk, causal, window, scale, \
                           stream);
  FA_BF16(32, 32)
  FA_BF16(64, 64)
  FA_BF16(128, 128)
  FA_BF16(256, 256)
  FA_BF16(192, 128)
#undef FA_BF16
  return (int)cudaErrorInvalidValue;
}

// For reports: out[5] = registers, local bytes, shared bytes, threads, blocks an SM
// of the (dqk, dv) instance.
extern "C" int flash_attention_bf16_resources(int64_t dqk, int64_t dv, int* out) {
  if (dqk == 32 && dv == 32) return resources<32, 32>(out);
  if (dqk == 64 && dv == 64) return resources<64, 64>(out);
  if (dqk == 128 && dv == 128) return resources<128, 128>(out);
  if (dqk == 256 && dv == 256) return resources<256, 256>(out);
  if (dqk == 192 && dv == 128) return resources<192, 128>(out);
  return (int)cudaErrorInvalidValue;
}
