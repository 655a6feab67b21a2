// The gradient of causal GQA flash attention for Hopper, in bf16 on the
// warpgroup products (wgmma): dq, dk, dv from q, k, v, the forward's output
// and row log-sum-exp, and dout.
//
// Replaces: no TPU kernel.  The reference trains its token models through
// plain jnp attention (src/repro/models/attention.py) and differentiates it
// with XLA.  This is the gradient of flash_attention_bf16.cu; the fp32
// gradient stays in flash_attention_bwd.cu.
//
// q, dq [B, Hq, Lq, Dqk]; out, dout [B, Hq, Lq, Dv]; k, dk [B, Hkv, Lk, Dqk];
// v, dv [B, Hkv, Lk, Dv]; all bf16, contiguous, 16-byte aligned; lse and delta
// [B, Hq, Lq] fp32.  Instances (Dqk, Dv): (32, 32), (64, 64), (128, 128),
// (256, 256) and DeepSeek-V2's MLA (192, 128), unpadded.  q head h reads kv
// head h / (Hq / Hkv); the masks, positions and scale are the forward's, and
// lse is its log-sum-exp of the scaled scores, so p = exp(s - lse).  Then
//   delta_i = sum_d dout_id out_id,   dp = dout v^T,   ds = p (dp - delta),
//   dv = p^T dout,   dk = scale ds^T q,   dq = scale ds k.
//
// Bound: at smollm-135m's training shape (B 4, Hq 9, Hkv 3, L 2048, D 64,
// causal) the five products of 2 D flops a seen pair are 48.3 GFLOP: 0.0489
// ms at an H100 SXM's 989 TFLOP/s of dense bf16; its bytes 51 MB, 0.015 ms at
// 3.35 TB/s.  Bound by operations.
//
// Design.
// - Every product on wgmma, bf16 operands, fp32 accumulators.  s^T, dp^T (and
//   in dQ s, dp) read both operands K-major from shared memory; dv += p^T dO,
//   dk += ds^T Q and dq += ds K take p and ds from registers (the
//   accumulators of s^T or s, rounded to bf16, are the A fragments as they
//   stand) and read dO, Q or K MN-major from the same shared layout (the
//   transpose bit), so nothing is copied transposed.  Tiles are staged as
//   bf16 bytes, unconverted, by cp.async into the swizzled layout of
//   wgmma_bf16.cuh (fence.proxy.async makes each thread's copies visible to
//   wgmma).  lse, delta, the softmax and every sum stay fp32.
// - Rounding points: p and ds, rounded to bf16 before their products.  dk,
//   dv and dq stay in the tensor cores' accumulators for the whole walk (a
//   chain of 16-deep steps, each sum rounded toward zero): in bf16 the drift
//   that made the fp32 kernel add each stage's product in fp32 is far below
//   the gate, and tests/test_torch_bf16_attn_rehearsal.py emulates this
//   design on the CPU (its tiles, its order, its rounding) and holds it to
//   the plain backward within one bf16 ulp of the largest value.
// - Three kernels on one stream, launched by one entry point: delta (one warp
//   a row), dK/dV (a block a 64-key tile), dQ (a block a 128-query tile); at
//   Dqk 256 a fourth adds the q heads' shares of dk and dv.
// - dK/dV with the keys on M: a block of two warpgroups owns 64 keys of one
//   (batch, kv head), K and V resident in shared memory, and walks the q heads
//   of the GQA group, each over the 64-query tiles that see its keys, in that
//   fixed order; Q, dO, lse and delta arrive through a cp.async ring of 2
//   stages.  dK and dV go to separate warpgroups: warpgroup 0 takes s^T = K
//   Q^T, p^T = 2^(s^T scale log2 e - lse log2 e) and dv += p^T dO; warpgroup
//   1 takes dp^T = V dO^T, reads p^T from shared memory (fp32, 16 KB, after
//   a named barrier that warpgroup 0 arrives at), ds^T = p^T (dp^T - delta)
//   and dk += ds^T Q.  Each does Dqk + Dv columns of products a stage, and
//   each holds one of the two sums: Dv / 2 or Dqk / 2 fp32 accumulators a
//   thread, 128 at D 256, where one warpgroup could not hold both.
// - At Dqk 256 (gemma3-1b: 4 q heads on 1 kv head, batch 2) a block a kv head
//   would leave most of the card idle (32 blocks), so a block walks one q
//   head: its share of dk (unscaled) and dv goes to `part` ([2, B, Hq, Lk,
//   D] fp32) and flash_attention_bwd_bf16_sum_kernel adds the shares in head
//   order and scales dk.
// - dQ as the forward: a block of two warpgroups owns 128 queries of one
//   (batch, q head), 64 a warpgroup, Q, dO, lse and delta staged once, K and
//   V tiles of kNk keys (64; 32 at Dqk 256) through a cp.async ring of 2
//   stages.  A warpgroup takes s = Q K^T and dp = dO V^T, p and ds in
//   registers, and dq += ds K.  It recomputes s and dp: seven products where
//   the bound counts five.  Taking dq from the dK/dV walk needs a sum over
//   key tiles by atomics (an order that changes from launch to launch); the
//   port relies on two launches giving the same bits.
// - Deterministic: no atomics; every output element is written once, by one
//   thread, after sums taken in a fixed order.
// - Whole tiles outside the masks are skipped; a tile that every pair of it
//   sees skips the mask.  Key tiles that no query sees get zero dk and dv.
//   The grids put the blocks with the most work first.
// - Resources: 256 threads a block.  Shared memory (bf16 tiles, 1 KB to
//   align): dK/dV K, V (64 keys) + 2 x (Q, dO) (64 queries) + 2 x 512 B of lse
//   and delta + 16 KB of p^T: 66 KB at D 64, 114 KB at D 128, 210 KB at D 256
//   and 138 KB at MLA's; dQ Q, dO (128 queries) + 1 KB + 2 x (K, V): 66 KB at
//   D 64, 130 KB at D 128, 194 KB at D 256 (32-key stages), 162 KB at MLA's.
//   Two blocks an SM up to D 64 (dK/dV and dQ), one above;
//   flash_attention_bwd_bf16_resources reports registers and blocks an SM.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// as void*, sizes as int64; the entry returns cudaGetLastError() after its
// launches, so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "wgmma_bf16.cuh"

namespace {

using namespace wgbf16;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;               // two warpgroups
constexpr int kKeys = 64;                   // keys a dK/dV block
constexpr int kQueries = 64;                // queries a dK/dV stage
constexpr int kDqRows = 128;                // queries a dQ block: 64 a warpgroup
constexpr int kStages = 2;

struct Sh {
  int hq, hkv, lq, lk, causal, window;
  float scale;
};

template <int DQK>
__host__ __device__ constexpr bool per_head() { return DQK == 256; }
template <int DQK>
__host__ __device__ constexpr int dq_keys() { return DQK > 192 ? 32 : 64; }

template <int DQK, int DV>
struct DkdvShape {
  using TQ = Tile<DQK>;
  using TV = Tile<DV>;
  static constexpr int kKBytes = TQ::template bytes<kKeys>();
  static constexpr int kVBytes = TV::template bytes<kKeys>();
  static constexpr int kQBytes = TQ::template bytes<kQueries>();
  static constexpr int kOBytes = TV::template bytes<kQueries>();
  static constexpr int kStageBytes = kQBytes + kOBytes;
  static constexpr int kVecBytes = 2 * kQueries * 4;        // lse, delta a stage
  static constexpr int kXBytes = kQueries / 2 * 128 * 4;    // p^T: warpgroup 0's accumulators
  static constexpr size_t kSmem =
      kKBytes + kVBytes + kStages * (kStageBytes + kVecBytes) + kXBytes + 1024;
};

template <int DQK, int DV>
struct DqShape {
  static constexpr int kNk = dq_keys<DQK>();
  using TQ = Tile<DQK>;
  using TV = Tile<DV>;
  static constexpr int kQBytes = TQ::template bytes<kDqRows>();
  static constexpr int kOBytes = TV::template bytes<kDqRows>();
  static constexpr int kKBytes = TQ::template bytes<kNk>();
  static constexpr int kVBytes = TV::template bytes<kNk>();
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kVecBytes = 2 * kDqRows * 4;
  static constexpr size_t kSmem = kQBytes + kOBytes + kStages * kStageBytes + kVecBytes + 1024;
};

__device__ __forceinline__ bool seen(int qpos, int key, int lk, int causal, int window) {
  return key < lk && (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

// whether some pair of queries [q, q + nq) and keys [k, k + nk) can be seen
__device__ __forceinline__ bool any_seen(int q, int nq, int k, int nk, const Sh& sh) {
  const int offset = sh.lk - sh.lq;
  const int qlast = min(q + nq, sh.lq) - 1;
  return q < sh.lq && k < sh.lk && (!sh.causal || k <= qlast + offset) &&
         (sh.window <= 0 || k + nk - 1 > q + offset - sh.window);
}

// whether every pair of queries [q, q + nq) and keys [k, k + nk) is seen
__device__ __forceinline__ bool all_seen(int q, int nq, int k, int nk, const Sh& sh) {
  const int offset = sh.lk - sh.lq;
  return q + nq <= sh.lq && k + nk <= sh.lk && (!sh.causal || k + nk - 1 <= q + offset) &&
         (sh.window <= 0 || k > q + nq - 1 + offset - sh.window);
}

// rows [r0, r0 + R) of a [len, C] bf16 matrix into a tile of R rows (zeros
// past len), by cp.async
template <int C, int R>
__device__ __forceinline__ void stage_tile(uint32_t dst, const bf16* __restrict__ src, int r0,
                                           int len) {
  for (int i = threadIdx.x; i < R * (C / 8); i += kThreads) {
    const int r = i / (C / 8), c = i % (C / 8);
    const bool ok = r0 + r < len;
    cp_async16(dst + Tile<C>::template offset<R>(r, c), src + (int64_t)(ok ? r0 + r : 0) * C + 8 * c,
               ok);
  }
}

// n values of lse and of delta from r0 (zeros past len), by cp.async
__device__ __forceinline__ void stage_vecs(uint32_t dst, const float* __restrict__ lse,
                                           const float* __restrict__ delta, int r0, int len,
                                           int n) {
  const int i = threadIdx.x;
  if (i < 2 * n) {
    const int j = i % n;
    const bool ok = r0 + j < len;
    cp_async4(dst + 4 * i, (i < n ? lse : delta) + (ok ? r0 + j : 0), ok);
  }
}

// delta[r] = sum_d dout[r][d] out[r][d]: one warp a row, 8 rows a block
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_bf16_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                                      float* __restrict__ delta, int64_t rows, int d) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* o = out + row * d;
  const bf16* g = dout + row * d;
  float s = 0.0f;
  for (int i = lane; i < d; i += 32) s = fmaf(__bfloat162float(o[i]), __bfloat162float(g[i]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// a warpgroup's accumulators (rows 16 warp + g and + 8, columns 8 j + 2 t and
// + 1) into rows [k0, ...) of a [len, W] matrix, times mul: bf16 or fp32
__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <int W, int R, typename T>
__device__ __forceinline__ void store_acc(T* dst, int r0, int len, const float (&acc)[R],
                                          float mul) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + g + 8 * h;
    if (r >= len) continue;
    T* p = dst + (int64_t)r * W + 2 * t;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      store_pair(p + 8 * j, acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

// One block a (batch, kv head, key tile): dk and dv of its 64 keys over every
// query tile of every q head of the group that sees them (at Dqk 256 a block
// a (batch, q head, key tile), its share to `part`).  Warpgroup 0: s^T, p^T,
// dv; warpgroup 1: dp^T, ds^T, dk.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, DQK <= 64 ? 2 : 1)
flash_attention_bwd_bf16_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta, bf16* __restrict__ dk,
                                     bf16* __restrict__ dv, float* __restrict__ part, Sh sh) {
  using F = DkdvShape<DQK, DV>;
  using TQ = typename F::TQ;
  using TV = typename F::TV;
  constexpr bool kPerHead = per_head<DQK>();
  constexpr int kAcc = (DQK > DV ? DQK : DV) / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023) & ~1023u;                 // K [64 x DQK]
  const uint32_t sv = sk + F::kKBytes;                       // V [64 x DV]
  const uint32_t sring = sv + F::kVBytes;                    // [kStages][Q, dO]
  const uint32_t svec = sring + kStages * F::kStageBytes;    // [kStages][lse, delta][64]
  const uint32_t sx = svec + kStages * F::kVecBytes;         // p^T [8][128] float4
  uint8_t* base = smem_raw + (sk - raw);
  const float* vecs = reinterpret_cast<const float*>(base + (svec - sk));
  float4* xp = reinterpret_cast<float4*>(base + (sx - sk));

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = (sh.lk + kKeys - 1) / kKeys;
  const int nbh = (int)gridDim.x / ntiles;                   // (batch, kv or q head) pairs
  const int k0 = ((int)blockIdx.x / nbh) * kKeys;           // the most-seen key tiles first
  const int group = sh.hq / sh.hkv;
  const int heads = kPerHead ? sh.hq : sh.hkv;
  const int b = (int)blockIdx.x % nbh / heads;
  const int h0 = kPerHead ? (int)blockIdx.x % nbh % heads : (int)blockIdx.x % nbh % heads * group;
  const int hk = h0 / group;
  const int offset = sh.lk - sh.lq;

  // the queries [lo, hi) that can see a key of the tile
  const int lo = sh.causal ? max(0, k0 - offset) : 0;
  const int hi = sh.window > 0 ? min(sh.lq, k0 + kKeys - 1 + sh.window - offset) : sh.lq;
  const int t_lo = lo / kQueries;
  const int nt = hi > lo ? (hi + kQueries - 1) / kQueries - t_lo : 0;
  const int steps = (kPerHead ? 1 : group) * nt;   // (q head, query tile), heads outermost

  auto load_stage = [&](int s) {
    const int h = h0 + s / nt, q0 = (t_lo + s % nt) * kQueries;
    const int64_t row0 = ((int64_t)b * sh.hq + h) * sh.lq;
    const uint32_t st = sring + (s % kStages) * F::kStageBytes;
    stage_tile<DQK, kQueries>(st, q + row0 * DQK, q0, sh.lq);
    stage_tile<DV, kQueries>(st + F::kQBytes, dout + row0 * DV, q0, sh.lq);
    stage_vecs(svec + (s % kStages) * F::kVecBytes, lse + row0, delta + row0, q0, sh.lq,
               kQueries);
    cp_async_commit();
  };

  float acc[kAcc];                            // warpgroup 0: dv; 1: dk
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  const int key[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  const float sl2 = sh.scale * kLog2e;
  const int64_t kv_row = ((int64_t)b * sh.hkv + hk) * sh.lk;
  if (steps > 0) {
    stage_tile<DQK, kKeys>(sk, k + kv_row * DQK, k0, sh.lk);   // K and V join stage 0's group
    stage_tile<DV, kKeys>(sv, v + kv_row * DV, k0, sh.lk);
    load_stage(0);
  }
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load_stage(s + 1);                      // its stage was freed by the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();                          // stage s visible to both warpgroups
    const int q0 = (t_lo + s % nt) * kQueries;
    if (any_seen(q0, kQueries, k0, kKeys, sh)) {
      const uint32_t sq = sring + (s % kStages) * F::kStageBytes, sdo = sq + F::kQBytes;
      const float* ls = vecs + (s % kStages) * 2 * kQueries;   // lse, then delta
      const bool full = all_seen(q0, kQueries, k0, kKeys, sh);  // no mask inside
      float x[kQueries / 2];                  // s^T (warpgroup 0), dp^T (1)
      uint32_t a[kQueries / 16][4];
      // warpgroup 0: s^T = K Q^T, 1: dp^T = V dO^T; where Dqk = Dv one
      // instruction stream on each warpgroup's own operands (wgmma in
      // divergent paths is serialized by the compiler)
      wgmma_fence();
      if constexpr (DQK == DV) {
        const uint32_t ta = wg ? sv : sk, tb = wg ? sdo : sq;
#pragma unroll
        for (int kk = 0; kk < DQK / 16; ++kk)
          wgmma_ss<kQueries>(x, TQ::kdesc(ta + TQ::template kmajor<kKeys>(0, kk)),
                             TQ::kdesc(tb + TQ::template kmajor<kQueries>(0, kk)), kk > 0);
      } else if (wg == 0) {
#pragma unroll
        for (int kk = 0; kk < DQK / 16; ++kk)
          wgmma_ss<kQueries>(x, TQ::kdesc(sk + TQ::template kmajor<kKeys>(0, kk)),
                             TQ::kdesc(sq + TQ::template kmajor<kQueries>(0, kk)), kk > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk)
          wgmma_ss<kQueries>(x, TV::kdesc(sv + TV::template kmajor<kKeys>(0, kk)),
                             TV::kdesc(sdo + TV::template kmajor<kQueries>(0, kk)), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < kQueries / 2; ++i) {
          const int col = 8 * (i >> 2) + 2 * t + (i & 1), query = q0 + col;
          float pe = ex2(fmaf(x[i], sl2, -ls[col] * kLog2e));
          if (!full && !(query < sh.lq && seen(query + offset, key[(i >> 1) & 1], sh.lk,
                                               sh.causal, sh.window)))
            pe = 0.0f;
          x[i] = pe;
        }
#pragma unroll
        for (int i = 0; i < kQueries / 8; ++i)
          xp[i * 128 + wtid] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
        bar_arrive(1, kThreads);              // p^T for warpgroup 1
      } else {
        bar_sync(1, kThreads);                // p^T written
#pragma unroll
        for (int i = 0; i < kQueries / 8; ++i) {
          const float4 p = xp[i * 128 + wtid];
          const float pp[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * i + 2 * t + (e & 1);
            x[4 * i + e] = pp[e] * (x[4 * i + e] - ls[kQueries + col]);
          }
        }
      }
      to_frags<kQueries>(x, a);
      // warpgroup 0: dv += p^T dO, 1: dk += ds^T Q
      wgmma_fence();
      if constexpr (DQK == DV) {
        const uint32_t tc = wg ? sq : sdo;
#pragma unroll
        for (int kk = 0; kk < kQueries / 16; ++kk)
          wgmma_rs<DQK>(acc, a[kk],
                        TQ::template mndesc<kQueries>(tc + TQ::template mnmajor<kQueries>(kk, 0)),
                        1);
      } else if (wg == 0) {
#pragma unroll
        for (int kk = 0; kk < kQueries / 16; ++kk)
          wgmma_rs<DV>(first<DV / 2>(acc), a[kk],
                       TV::template mndesc<kQueries>(sdo + TV::template mnmajor<kQueries>(kk, 0)),
                       1);
      } else {
#pragma unroll
        for (int kk = 0; kk < kQueries / 16; ++kk)
          wgmma_rs<DQK>(first<DQK / 2>(acc), a[kk],
                        TQ::template mndesc<kQueries>(sq + TQ::template mnmajor<kQueries>(kk, 0)),
                        1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncthreads();                          // the stage is consumed
  }
  if constexpr (kPerHead) {
    const int64_t share = ((int64_t)b * sh.hq + h0) * sh.lk;
    const int64_t plane = (int64_t)nbh * sh.lk * DQK;           // B Hq Lk D
    if (wg == 0)
      store_acc<DV>(part + plane + share * DV, k0, sh.lk, first<DV / 2>(acc), 1.0f);
    else
      store_acc<DQK>(part + share * DQK, k0, sh.lk, first<DQK / 2>(acc), 1.0f);
  } else {
    if (wg == 0)
      store_acc<DV>(dv + kv_row * DV, k0, sh.lk, first<DV / 2>(acc), 1.0f);
    else
      store_acc<DQK>(dk + kv_row * DQK, k0, sh.lk, first<DQK / 2>(acc), sh.scale);
  }
}

// dk and dv from the q heads' shares in `part` ([2, B, Hq, Lk, D], the group's
// heads of a kv head adjacent): each element the sum over the group in head
// order, dk's then scaled; n4 float4s of dk, len4 of a head's share.
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_bf16_sum_kernel(const float4* __restrict__ part, bf16* __restrict__ dk,
                                    bf16* __restrict__ dv, int64_t n4, int64_t len4, int group,
                                    float scale) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < 2 * n4;
       i += (int64_t)gridDim.x * kThreads) {
    const bool is_v = i >= n4;
    const int64_t j = is_v ? i - n4 : i;
    const float4* src = part + (is_v ? n4 * group : 0) + j / len4 * group * len4 + j % len4;
    float4 x = src[0];
    for (int h = 1; h < group; ++h) {
      const float4 y = src[h * len4];
      x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
    }
    if (!is_v) x.x *= scale, x.y *= scale, x.z *= scale, x.w *= scale;
    uint2 u;
    u.x = pack_bf16(x.x, x.y);
    u.y = pack_bf16(x.z, x.w);
    *reinterpret_cast<uint2*>((is_v ? dv : dk) + 4 * j) = u;
  }
}

// One block a (batch, q head, 128-query tile): dq of its queries, summed over
// the key tiles they see; warpgroup w takes queries 64 w to 64 w + 63.
// two blocks an SM up to D 64 (128 registers, a few spilled), as the
// forward
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, DQK <= 64 ? 2 : 1)
flash_attention_bwd_bf16_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta, bf16* __restrict__ dq, Sh sh) {
  using F = DqShape<DQK, DV>;
  using TQ = typename F::TQ;
  using TV = typename F::TV;
  constexpr int kNk = F::kNk;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;                 // Q [128 x DQK]
  const uint32_t sdo = sq + F::kQBytes;                      // dO [128 x DV]
  const uint32_t sring = sdo + F::kOBytes;                   // [kStages][K, V]
  const uint32_t svec = sring + kStages * F::kStageBytes;    // lse, delta [128]
  const float* vecs =
      reinterpret_cast<const float*>(smem_raw + (sq - raw) + (svec - sq));

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = (sh.lq + kDqRows - 1) / kDqRows;
  const int nbh = (int)gridDim.x / ntiles;
  const int q0 = (ntiles - 1 - (int)blockIdx.x / nbh) * kDqRows;   // the most keys first
  const int h = (int)blockIdx.x % nbh % sh.hq, b = (int)blockIdx.x % nbh / sh.hq;
  const int hk = h / (sh.hq / sh.hkv);
  const int offset = sh.lk - sh.lq;
  const int64_t row0 = ((int64_t)b * sh.hq + h) * sh.lq;
  const int64_t kv_row = ((int64_t)b * sh.hkv + hk) * sh.lk;

  // the keys [lo, hi) that a query of the block can see
  const int last = min(q0 + kDqRows, sh.lq) - 1;
  const int lo = sh.window > 0 ? max(0, q0 + offset - sh.window + 1) : 0;
  const int hi = sh.causal ? min(sh.lk, last + offset + 1) : sh.lk;
  const int t_lo = lo / kNk;
  const int nt = hi > lo ? (hi + kNk - 1) / kNk - t_lo : 0;

  auto load_stage = [&](int s) {
    const int kt = (t_lo + s) * kNk;
    const uint32_t st = sring + (s % kStages) * F::kStageBytes;
    stage_tile<DQK, kNk>(st, k + kv_row * DQK, kt, sh.lk);
    stage_tile<DV, kNk>(st + F::kKBytes, v + kv_row * DV, kt, sh.lk);
    cp_async_commit();
  };

  float acc[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.0f;
  const int wq0 = q0 + 64 * wg;             // the warpgroup's first query
  const bool wg_live = wq0 < sh.lq;
  const int rq[2] = {16 * warp + g, 16 * warp + g + 8};   // this thread's rows of its 64
  const float sl2 = sh.scale * kLog2e;
  if (nt > 0) {
    stage_tile<DQK, kDqRows>(sq, q + row0 * DQK, q0, sh.lq);   // Q, dO, lse, delta join
    stage_tile<DV, kDqRows>(sdo, dout + row0 * DV, q0, sh.lq);   // stage 0's group
    stage_vecs(svec, lse + row0, delta + row0, q0, sh.lq, kDqRows);
    load_stage(0);
  }
  for (int s = 0; s < nt; ++s) {
    if (s + 1 < nt) {
      load_stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const int kt = (t_lo + s) * kNk;
    if (wg_live && any_seen(wq0, 64, kt, kNk, sh)) {
      const uint32_t ks = sring + (s % kStages) * F::kStageBytes, vs = ks + F::kKBytes;
      float sc[kNk / 2], dp[kNk / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        wgmma_ss<kNk>(sc, TQ::kdesc(sq + TQ::template kmajor<kDqRows>(64 * wg, kk)),
                      TQ::kdesc(ks + TQ::template kmajor<kNk>(0, kk)), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss<kNk>(dp, TV::kdesc(sdo + TV::template kmajor<kDqRows>(64 * wg, kk)),
                      TV::kdesc(vs + TV::template kmajor<kNk>(0, kk)), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const bool full = all_seen(wq0, 64, kt, kNk, sh);
      float lrow[2], drow[2];
      int qpos[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lrow[r] = vecs[64 * wg + rq[r]] * kLog2e;
        drow[r] = vecs[kDqRows + 64 * wg + rq[r]];
        qpos[r] = wq0 + rq[r];
      }
#pragma unroll
      for (int i = 0; i < kNk / 2; ++i) {
        const int r = (i >> 1) & 1, key = kt + 8 * (i >> 2) + 2 * t + (i & 1);
        float pe = ex2(fmaf(sc[i], sl2, -lrow[r]));
        if (!full && !(qpos[r] < sh.lq && seen(qpos[r] + offset, key, sh.lk, sh.causal,
                                               sh.window)))
          pe = 0.0f;
        dp[i] = pe * (dp[i] - drow[r]);
      }
      uint32_t a[kNk / 16][4];
      to_frags<kNk>(dp, a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kNk / 16; ++kk)          // dq += ds K
        wgmma_rs<DQK>(acc, a[kk], TQ::template mndesc<kNk>(ks + TQ::template mnmajor<kNk>(kk, 0)),
                      1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncthreads();
  }
  store_acc<DQK>(dq + row0 * DQK, wq0, sh.lq, acc, sh.scale);
}

// Raise each instance's dynamic shared memory limit, once, so that no launch
// inside a CUDA-graph capture sets it.
template <int DQK, int DV>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_bwd_bf16_dkdv_kernel<DQK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)DkdvShape<DQK, DV>::kSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_attention_bwd_bf16_dq_kernel<DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)DqShape<DQK, DV>::kSmem);
    return e;
  }();
  return err;
}

// registers, local bytes, shared bytes, threads, blocks an SM, blocks a
// cluster (1) and clusters at once (0) of the dK/dV (which 0) or dQ (which 1)
// kernel
template <int DQK, int DV>
int resources(int which, int* out) {
  cudaFuncAttributes a;
  int blocks = 0;
  const void* fn = which ? (const void*)flash_attention_bwd_bf16_dq_kernel<DQK, DV>
                         : (const void*)flash_attention_bwd_bf16_dkdv_kernel<DQK, DV>;
  const size_t smem = which ? DqShape<DQK, DV>::kSmem : DkdvShape<DQK, DV>::kSmem;
  cudaError_t err = prepare<DQK, DV>();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + smem);
  out[3] = kThreads;
  out[4] = blocks;
  out[5] = 1;
  out[6] = 0;
  return (int)cudaSuccess;
}

template <int DQK, int DV>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* out, const float* lse,
           const bf16* dout, float* delta, float* part, bf16* dq, bf16* dk, bf16* dv, int64_t b,
           const Sh& sh, cudaStream_t stream) {
  cudaError_t err = prepare<DQK, DV>();
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = b * sh.hq * sh.lq;
  flash_attention_bwd_bf16_delta_kernel<<<(unsigned)((rows + 7) / 8), kThreads, 0, stream>>>(
      out, dout, delta, rows, DV);
  constexpr bool kPerHead = per_head<DQK>();
  const int64_t kt = (sh.lk + kKeys - 1) / kKeys, qt = (sh.lq + kDqRows - 1) / kDqRows;
  flash_attention_bwd_bf16_dkdv_kernel<DQK, DV>
      <<<(unsigned)(kt * b * (kPerHead ? sh.hq : sh.hkv)), kThreads, DkdvShape<DQK, DV>::kSmem,
         stream>>>(q, k, v, dout, lse, delta, dk, dv, part, sh);
  if (kPerHead) {
    const int64_t n4 = b * sh.hkv * sh.lk * DQK / 4;
    const unsigned grid = (unsigned)std::min<int64_t>((2 * n4 + kThreads - 1) / kThreads, 8192);
    flash_attention_bwd_bf16_sum_kernel<<<grid, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(part), dk, dv, n4, (int64_t)sh.lk * DQK / 4,
        sh.hq / sh.hkv, sh.scale);
  }
  flash_attention_bwd_bf16_dq_kernel<DQK, DV>
      <<<(unsigned)(qt * b * sh.hq), kThreads, DqShape<DQK, DV>::kSmem, stream>>>(
          q, k, v, dout, lse, delta, dq, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// delta is [B, Hq, Lq] scratch; part [2, B, Hq, Lk, D] fp32 scratch at Dqk 256 (the
// q heads' shares of dk and dv), unread below; window 0 means none; causal 0 or 1;
// scale <= 0 means Dqk^-0.5 (the forward's).
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* out, const void* lse, const void* dout,
                                        void* delta, void* part, void* dq, void* dk, void* dv,
                                        int64_t b, int64_t hq, int64_t hkv, int64_t lq,
                                        int64_t lk, int64_t dqk, int64_t dvh, int64_t causal,
                                        int64_t window, double scale, void* stream) {
  if (b <= 0 || hq <= 0 || lq <= 0 || lk <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv || lq > lk || window < 0 || lk > 0x7fffffff ||
      b * hq * ((lq + kDqRows - 1) / kDqRows) > 0x7fffffff ||
      b * hq * ((lk + kKeys - 1) / kKeys) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Sh sh{(int)hq, (int)hkv, (int)lq, (int)lk, (int)causal, (int)window,
              (float)(scale > 0.0 ? scale : 1.0 / sqrt((double)dqk))};
  const auto s = (cudaStream_t)stream;
#define FA_BWD_BF16(DQK, DV)                                                                 \
  if (dqk == DQK && dvh == DV)                                                               \
    return launch<DQK, DV>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),         \
                           static_cast<const bf16*>(v), static_cast<const bf16*>(out),       \
                           static_cast<const float*>(lse), static_cast<const bf16*>(dout),   \
                           static_cast<float*>(delta), static_cast<float*>(part),            \
                           static_cast<bf16*>(dq), static_cast<bf16*>(dk),                   \
                           static_cast<bf16*>(dv), b, sh, s);
  FA_BWD_BF16(32, 32)
  FA_BWD_BF16(64, 64)
  FA_BWD_BF16(128, 128)
  FA_BWD_BF16(256, 256)
  FA_BWD_BF16(192, 128)
#undef FA_BWD_BF16
  return (int)cudaErrorInvalidValue;
}

// For reports: out[7] = registers, local bytes, shared bytes, threads, blocks an SM,
// blocks a cluster, clusters at once of the dK/dV (which 0) or dQ (which 1) kernel
// of the (dqk, dv) instance.
extern "C" int flash_attention_bwd_bf16_resources(int64_t dqk, int64_t dv, int64_t which,
                                                  int* out) {
  if (which < 0 || which > 1) return (int)cudaErrorInvalidValue;
  if (dqk == 32 && dv == 32) return resources<32, 32>((int)which, out);
  if (dqk == 64 && dv == 64) return resources<64, 64>((int)which, out);
  if (dqk == 128 && dv == 128) return resources<128, 128>((int)which, out);
  if (dqk == 256 && dv == 256) return resources<256, 256>((int)which, out);
  if (dqk == 192 && dv == 128) return resources<192, 128>((int)which, out);
  return (int)cudaErrorInvalidValue;
}
