// The gradient of causal GQA flash attention for Hopper: dq, dk, dv from q,
// k, v, the forward's output and row log-sum-exp, and dout.
//
// Replaces: no TPU kernel.  The reference trains its token models through
// plain jnp attention (src/repro/models/attention.py: sdpa below 1024 tokens,
// sdpa_blockwise from there) and differentiates it with XLA; it has no
// custom_vjp.  The port's forward is the hand-written kernel of
// flash_attention.cu, so training through it needs this kernel as its
// gradient (kernels/flash_attention.py wraps both in a torch.autograd.Function).
//
// q, out, dout, dq [B, Hq, Lq, D]; k, v, dk, dv [B, Hkv, Lk, D]; lse and delta
// [B, Hq, Lq]; fp32, contiguous.  q head h reads kv head h / (Hq / Hkv).  The
// masks, positions and scale are the forward's: query row r sits at key
// position r + Lk - Lq, a key at position j is seen from position i if j <= i
// (causal) and j > i - window (window > 0), s = q.k * D^-0.5, and lse is the
// forward's m + log(l) in those units, so p = exp(s - lse).  Then
//   delta_i = sum_d dout_id out_id,   dp = dout v^T,   ds = p (dp - delta),
//   dv = p^T dout,   dk = scale ds^T q,   dq = scale ds k.
//
// Bound: at smollm-135m's training shape (B 4, Hq 9, Hkv 3, L 2048, D 64,
// causal) the five products of 2 L^2 D flops a head, halved by the mask, are
// 48.3 GFLOP: 0.29 ms at an H100 SXM's 495 TFLOP/s of TF32 over three
// products a flop (3xTF32, fp32-accurate, as the forward's bound counts);
// its bytes (q, k, v, out, dout, lse in; dq, dk, dv out) are 101 MB, 0.03 ms
// at 3.35 TB/s.  It is bound by operations.  This design's fp32 FMAs on the
// CUDA cores (67 TFLOP/s) set a floor of 0.72 ms, 2.5 times the bound.
//
// Design: a simple, deterministic kernel, fp32 FMAs on the CUDA cores.
// - Three kernels, launched in order on one stream by one entry point: delta
//   (one warp a row), dK/dV (one block a key tile), dQ (one block a query
//   tile).  dk and dv of a key tile sum over every query of every q head of
//   its GQA group, so the dK/dV block walks them all and keeps both sums in
//   registers; dq sums over keys, so the dQ block walks the key tiles.  No
//   atomics: each output element is written once, by one thread, after a
//   sum taken in a fixed order, and two launches give the same bits.  The
//   cost is two products done twice (s and dp, recomputed by the dQ
//   kernel): seven products where the bound counts five.
// - Tiles of 64 queries by 64 keys in shared memory, rows padded by one word
//   so that the 16 rows a warp reads at one column sit in 16 banks.  256
//   threads as 16 x 16: a thread holds a 4 x 4 block of s, p, dp and ds
//   (rows ty + 16 r, keys tx + 16 c) and a 4 x D/16 block of each output
//   tile (rows ty + 16 r, columns tx + 16 c).  Every inner step reads 8
//   words of shared memory for 16 FMAs, so shared memory bounds the kernel at
//   about half the fp32 rate; the tensor cores (3xTF32, as the forward's) are
//   for a later step.
// - Whole tiles outside the masks are skipped: a key tile's query range and a
//   query tile's key range follow from the causal and window bounds.  Key
//   tiles that no query sees get zero dk and dv.  The grid puts the tiles
//   with the most work first (key tiles from the left, query tiles from the
//   right) across every batch and head.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// as void*, sizes as int64; the entry returns cudaGetLastError() after its
// launches, so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // 16 x 16
constexpr int kTile = 64;                   // queries a query tile, keys a key tile
constexpr int kSP = kTile + 1;              // row stride of a [64][64] tile

template <int D>
constexpr size_t dkdv_smem() {              // K, V, Q, dO; P, dS; lse, delta
  return sizeof(float) * ((size_t)4 * kTile * (D + 1) + 2 * kTile * kSP + 2 * kTile);
}
template <int D>
constexpr size_t dq_smem() {                // Q, dO, K, V; dS; lse, delta
  return sizeof(float) * ((size_t)4 * kTile * (D + 1) + kTile * kSP + 2 * kTile);
}

struct Shape {
  int hq, hkv, lq, lk, causal, window;
  float scale;
};

// delta[r] = sum_d dout[r][d] out[r][d]: one warp a row, 8 rows a block
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_delta_kernel(const float* __restrict__ out,
                                 const float* __restrict__ dout, float* __restrict__ delta,
                                 int64_t rows, int d) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* o = out + row * d;
  const float* g = dout + row * d;
  float s = 0.0f;
  for (int i = lane; i < d; i += 32) s = fmaf(o[i], g[i], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// rows [r0, r0 + 64) of a [len, D] matrix into a [64][D + 1] tile, zeros past len
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int r0,
                                          int len) {
  const int n = min(kTile, len - r0) * D;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads)
    dst[(i / D) * (D + 1) + i % D] = i < n ? src[(int64_t)r0 * D + i] : 0.0f;
}

__device__ __forceinline__ bool seen(int qpos, int key, int lk, int causal, int window) {
  return key < lk && (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

// For the thread's 4 x 4 block (query rows ty + 16 r of the query tile at q0,
// keys tx + 16 c of the key tile at k0): p = exp(s - lse) and ds = p (dp -
// delta), 0 where the masks hide the key or the row is past Lq.
template <int D>
__device__ __forceinline__ void probs(const float* qs, const float* dos, const float* ks,
                                      const float* vs, const float* lse_s,
                                      const float* delta_s, int q0, int k0, const Shape& sh,
                                      float (&p)[4][4], float (&ds)[4][4]) {
  constexpr int S = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], ga[4], kb[4], vb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qa[r] = qs[(ty + 16 * r) * S + d];
      ga[r] = dos[(ty + 16 * r) * S + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kb[c] = ks[(tx + 16 * c) * S + d];
      vb[c] = vs[(tx + 16 * c) * S + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
        dp[r][c] = fmaf(ga[r], vb[c], dp[r][c]);
      }
  }
  const int offset = sh.lk - sh.lq;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r, query = q0 + i;
    const float l = lse_s[i], dl = delta_s[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool ok = query < sh.lq && seen(query + offset, k0 + tx + 16 * c, sh.lk,
                                            sh.causal, sh.window);
      p[r][c] = ok ? expf(s[r][c] * sh.scale - l) : 0.0f;
      ds[r][c] = p[r][c] * (dp[r][c] - dl);
    }
  }
}

// the queries [lo, hi) that can see a key in [k0, k0 + 64)
__device__ __forceinline__ void query_range(int k0, const Shape& sh, int& lo, int& hi) {
  const int offset = sh.lk - sh.lq;
  lo = sh.causal ? max(0, k0 - offset) : 0;
  hi = sh.window > 0 ? min(sh.lq, k0 + kTile - 1 + sh.window - offset) : sh.lq;
}

// the keys [lo, hi) that a query in [q0, q0 + 64) can see
__device__ __forceinline__ void key_range(int q0, const Shape& sh, int& lo, int& hi) {
  const int offset = sh.lk - sh.lq;
  const int last = min(q0 + kTile, sh.lq) - 1;
  lo = sh.window > 0 ? max(0, q0 + offset - sh.window + 1) : 0;
  hi = sh.causal ? min(sh.lk, last + offset + 1) : sh.lk;
}

// One block a (batch, kv head, key tile): dk and dv of its 64 keys, summed
// over every query tile of every q head of the group that sees them.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta, float* __restrict__ dk,
                                float* __restrict__ dv, Shape sh) {
  constexpr int S = D + 1, C = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * S;
  float* qs = vs + kTile * S;
  float* dos = qs + kTile * S;
  float* ps = dos + kTile * S;
  float* dss = ps + kTile * kSP;
  float* lse_s = dss + kTile * kSP;
  float* delta_s = lse_s + kTile;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ntiles = (sh.lk + kTile - 1) / kTile;
  const int nbh = gridDim.x / ntiles;
  const int k0 = ((int)blockIdx.x / nbh) * kTile;       // the most-seen key tiles first
  const int hk = (int)blockIdx.x % nbh % sh.hkv, b = (int)blockIdx.x % nbh / sh.hkv;
  const int group = sh.hq / sh.hkv;
  const int64_t kv_off = ((int64_t)b * sh.hkv + hk) * sh.lk * D;
  load_tile<D>(ks, k + kv_off, k0, sh.lk);
  load_tile<D>(vs, v + kv_off, k0, sh.lk);

  float acc_k[4][C], acc_v[4][C];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc_k[r][c] = acc_v[r][c] = 0.0f;

  int lo, hi;
  query_range(k0, sh, lo, hi);
  const int t_lo = lo / kTile, t_hi = hi > lo ? (hi + kTile - 1) / kTile : t_lo;
  for (int gh = 0; gh < group; ++gh) {
    const int h = hk * group + gh;
    const int64_t q_off = ((int64_t)b * sh.hq + h) * sh.lq;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * kTile;
      __syncthreads();                      // the last tile's readers are done
      load_tile<D>(qs, q + q_off * D, q0, sh.lq);
      load_tile<D>(dos, dout + q_off * D, q0, sh.lq);
      if (threadIdx.x < kTile) {
        const bool ok = q0 + (int)threadIdx.x < sh.lq;
        lse_s[threadIdx.x] = ok ? lse[q_off + q0 + threadIdx.x] : 0.0f;
        delta_s[threadIdx.x] = ok ? delta[q_off + q0 + threadIdx.x] : 0.0f;
      }
      __syncthreads();
      float p[4][4], ds[4][4];
      probs<D>(qs, dos, ks, vs, lse_s, delta_s, q0, k0, sh, p, ds);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ps[(ty + 16 * r) * kSP + tx + 16 * c] = p[r][c];
          dss[(ty + 16 * r) * kSP + tx + 16 * c] = ds[r][c];
        }
      __syncthreads();
      // dv[j] += p[:, j]^T dout, dk[j] += ds[:, j]^T q: the thread's keys are
      // ty + 16 r, its columns tx + 16 c
#pragma unroll 2
      for (int i = 0; i < kTile; ++i) {
        float pj[4], dj[4], g[C], x[C];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pj[r] = ps[i * kSP + ty + 16 * r];
          dj[r] = dss[i * kSP + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          g[c] = dos[i * S + tx + 16 * c];
          x[c] = qs[i * S + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            acc_v[r][c] = fmaf(pj[r], g[c], acc_v[r][c]);
            acc_k[r][c] = fmaf(dj[r], x[c], acc_k[r][c]);
          }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty + 16 * r;
    if (key >= sh.lk) continue;
    const int64_t o = kv_off + (int64_t)key * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[o + tx + 16 * c] = acc_k[r][c] * sh.scale;
      dv[o + tx + 16 * c] = acc_v[r][c];
    }
  }
}

// One block a (batch, q head, query tile): dq of its 64 queries, summed over
// the key tiles they see.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dq, Shape sh) {
  constexpr int S = D + 1, C = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * S;
  float* ks = dos + kTile * S;
  float* vs = ks + kTile * S;
  float* dss = vs + kTile * S;
  float* lse_s = dss + kTile * kSP;
  float* delta_s = lse_s + kTile;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ntiles = (sh.lq + kTile - 1) / kTile;
  const int nbh = gridDim.x / ntiles;
  const int q0 = (ntiles - 1 - (int)blockIdx.x / nbh) * kTile;   // the most keys first
  const int h = (int)blockIdx.x % nbh % sh.hq, b = (int)blockIdx.x % nbh / sh.hq;
  const int hk = h / (sh.hq / sh.hkv);
  const int64_t q_off = ((int64_t)b * sh.hq + h) * sh.lq;
  const int64_t kv_off = ((int64_t)b * sh.hkv + hk) * sh.lk * D;
  load_tile<D>(qs, q + q_off * D, q0, sh.lq);
  load_tile<D>(dos, dout + q_off * D, q0, sh.lq);
  if (threadIdx.x < kTile) {
    const bool ok = q0 + (int)threadIdx.x < sh.lq;
    lse_s[threadIdx.x] = ok ? lse[q_off + q0 + threadIdx.x] : 0.0f;
    delta_s[threadIdx.x] = ok ? delta[q_off + q0 + threadIdx.x] : 0.0f;
  }

  float acc[4][C];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;

  int lo, hi;
  key_range(q0, sh, lo, hi);
  const int t_lo = lo / kTile, t_hi = hi > lo ? (hi + kTile - 1) / kTile : t_lo;
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kTile;
    __syncthreads();                        // the last tile's readers are done
    load_tile<D>(ks, k + kv_off, k0, sh.lk);
    load_tile<D>(vs, v + kv_off, k0, sh.lk);
    __syncthreads();
    float p[4][4], ds[4][4];
    probs<D>(qs, dos, ks, vs, lse_s, delta_s, q0, k0, sh, p, ds);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dss[(ty + 16 * r) * kSP + tx + 16 * c] = ds[r][c];
    __syncthreads();
    // dq[i] += ds[i, :] k: the thread's queries are ty + 16 r, its columns tx + 16 c
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      float dj[4], kj[C];
#pragma unroll
      for (int r = 0; r < 4; ++r) dj[r] = dss[(ty + 16 * r) * kSP + j];
#pragma unroll
      for (int c = 0; c < C; ++c) kj[c] = ks[j * S + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(dj[r], kj[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int query = q0 + ty + 16 * r;
    if (query >= sh.lq) continue;
    const int64_t o = (q_off + query) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) dq[o + tx + 16 * c] = acc[r][c] * sh.scale;
  }
}

// Raise each instance's dynamic shared memory limit, once, so that no launch
// inside a CUDA-graph capture sets it.
template <int D>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dkdv_smem<D>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem<D>());
    return e;
  }();
  return err;
}

// registers, local bytes, shared bytes, threads and blocks an SM of the
// dK/dV (which = 0) or dQ (which = 1) kernel
template <int D>
int resources(int which, int* out) {
  cudaFuncAttributes a;
  int blocks = 0;
  const void* fn = which ? (const void*)flash_attention_bwd_dq_kernel<D>
                         : (const void*)flash_attention_bwd_dkdv_kernel<D>;
  const size_t smem = which ? dq_smem<D>() : dkdv_smem<D>();
  cudaError_t err = prepare<D>();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + smem);
  out[3] = kThreads;
  out[4] = blocks;
  return (int)cudaSuccess;
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* out,
           const float* lse, const float* dout, float* delta, float* dq, float* dk,
           float* dv, int64_t b, const Shape& sh, cudaStream_t stream) {
  cudaError_t err = prepare<D>();
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = b * sh.hq * sh.lq;
  flash_attention_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), kThreads, 0, stream>>>(
      out, dout, delta, rows, D);
  const int64_t kt = (sh.lk + kTile - 1) / kTile, qt = (sh.lq + kTile - 1) / kTile;
  flash_attention_bwd_dkdv_kernel<D>
      <<<(unsigned)(kt * b * sh.hkv), kThreads, dkdv_smem<D>(), stream>>>(
          q, k, v, dout, lse, delta, dk, dv, sh);
  flash_attention_bwd_dq_kernel<D>
      <<<(unsigned)(qt * b * sh.hq), kThreads, dq_smem<D>(), stream>>>(
          q, k, v, dout, lse, delta, dq, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// delta is [B, Hq, Lq] scratch; window 0 means none; causal 0 or 1.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* out, const void* lse, const void* dout,
                                       void* delta, void* dq, void* dk, void* dv, int64_t b,
                                       int64_t hq, int64_t hkv, int64_t lq, int64_t lk,
                                       int64_t d, int64_t causal, int64_t window,
                                       void* stream) {
  if (b <= 0 || hq <= 0 || lq <= 0 || lk <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv || lq > lk || window < 0 || lk > 0x7fffffff ||
      b * hq * ((lq + kTile - 1) / kTile) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Shape sh{(int)hq, (int)hkv, (int)lq, (int)lk, (int)causal, (int)window,
                 (float)(1.0 / sqrt((double)d))};
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fo = static_cast<const float*>(out);
  const auto* fl = static_cast<const float*>(lse);
  const auto* fg = static_cast<const float*>(dout);
  auto* fd = static_cast<float*>(delta);
  auto* gq = static_cast<float*>(dq);
  auto* gk = static_cast<float*>(dk);
  auto* gv = static_cast<float*>(dv);
  const auto s = (cudaStream_t)stream;
  switch (d) {
    case 32: return launch<32>(fq, fk, fv, fo, fl, fg, fd, gq, gk, gv, b, sh, s);
    case 64: return launch<64>(fq, fk, fv, fo, fl, fg, fd, gq, gk, gv, b, sh, s);
    case 128: return launch<128>(fq, fk, fv, fo, fl, fg, fd, gq, gk, gv, b, sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// For reports: out[5] = registers, local bytes, shared bytes, threads, blocks an
// SM of the dK/dV (which 0) or dQ (which 1) kernel at head dim d.
extern "C" int flash_attention_bwd_resources(int64_t d, int64_t which, int* out) {
  switch (d) {
    case 32: return resources<32>((int)which, out);
    case 64: return resources<64>((int)which, out);
    case 128: return resources<128>((int)which, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
