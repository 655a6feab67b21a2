// Causal GQA attention with an online softmax (flash attention) for Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel _flash_kernel: grid (batch, q heads, q blocks, kv blocks) with
// the kv blocks innermost and the fp32 accumulators carried in VMEM scratch
// across them; it asserted that Lq and Lk divide the block sizes).
//
// q [B, Hq, Lq, D], k and v [B, Hkv, Lk, D], out [B, Hq, Lq, D], fp32
// (bf16 has its own design, flash_attention_bf16.cu), contiguous and 16-byte
// aligned; lse, where not null, [B, Hq,
// Lq] fp32, each row's log-sum-exp m + log(l) in the units of the scaled
// scores, which the backward (flash_attention_bwd.cu) reads; serving passes
// null and the kernel writes nothing more.  q head h reads kv head
// h / (Hq / Hkv).  The queries are the last Lq positions: query row r sits at
// key position r + Lk - Lq.  A key at position j is seen from position i if
// j <= i (when causal) and j > i - window (when window > 0).  Scores are
// q.k * scale (D^-0.5 unless the caller passes another: MLA's padded route
// passes its q/k head dim's), softmax and accumulation in fp32, and the row
// sum l is clamped at 1e-30 before the division.
//
// Bound: at gemma3-1b's global layer (B 4, Hq 4, Hkv 1, L 1024, D 256, fp32)
// the kernel must read q, k, v and write out, 42 MB, about 12.5 us at an H100
// SXM's 3.35 TB/s; the causal work is 4 * D flops for each of the 8.4 M
// (query, key) pairs seen, 8.6 GFLOP.  On the tensor cores an fp32-accurate
// product costs three TF32 products (below), so the least time is
// 3 * 8.6 GFLOP at the card's 495 TFLOP/s TF32 rate: 0.052 ms (0.039 ms at
// window 512).  The kernel is bound by operations.
//
// Design.
// - Tensor cores, fp32 as 3xTF32.  S = Q K^T and O += P V run on
//   mma.sync.m16n8k8 with tf32 operands and fp32 accumulators.  Each fp32
//   operand x is split in registers into hi (x rounded to TF32 as
//   cvt.rna.tf32 rounds) and lo = x - hi, of which the tensor cores read the
//   top 19 bits, and each product is hi*lo + lo*hi + hi*hi (lo*lo dropped):
//   about fp32's accuracy, where one TF32 product misses the 1e-5 tolerance
//   by two orders of magnitude (tests/test_torch_tf32_split.py emulates both
//   on the CPU).  In S the three products go to three accumulators, so that
//   the chain of dependent products is a third as long.  mma.sync and not
//   wgmma: wgmma reads B, and for tf32 also A, from shared memory, K-major
//   only, so the split would need hi and lo copies of Q, K and V^T in shared
//   memory, more than the 227 KB a block has at D = 256 in fp32; mma.sync
//   takes its fragments from registers, where the split costs no shared
//   memory.  q is scaled as it is staged.
// - GQA heads packed.  A block owns kBlockM = 64 packed rows of one (batch,
//   kv head): packed row R is q head hk * G + R % G at query R / G, for the
//   group G = Hq / Hkv (gemma3-1b: 16 queries x 4 heads).  Each K/V tile is
//   staged once for the whole group, and the rows of one query share its
//   causal/window range, so whole tiles outside the block's range are
//   skipped, and a warp skips a tile half that none of its rows sees.  Any G
//   works; rows past Lq * G and keys past the range are masked, not padded.
// - Asynchronous K/V ring.  kStages = 2 stages of kBlockN = 32 keys of K and
//   V, filled by cp.async (16 bytes a thread; keys past the range are
//   zero-filled), so the next tile's copy runs under this tile's products and
//   softmax.  Q (64 rows) is staged once.  Rows are padded by 16 bytes: a row
//   stride of 4 * odd words puts the 8 rows a fragment load touches on 8
//   distinct bank quads.  At D = 256 fp32: Q 66.6 KB + 2 x (K + V) 133.1 KB =
//   199.7 KB, one block an SM.
// - 8 warps: 4 row slices of 16 packed rows x 2 key halves of each stage.  A
//   warp holds all D output columns of its 16 rows (128 fp32 accumulators a
//   thread at D = 256, so a block of 8 warps fills the register file) and
//   keeps its own online softmax over its half of the keys; at the end the
//   two halves of a slice merge through shared memory.  The softmax works on
//   the m16n8 accumulator layout (a thread holds rows g and g + 8, columns
//   2t and 2t + 1 of each 16 x 8 tile): masked keys get -inf and so p = 0,
//   the row maximum and sum are quad shuffles, and m starts at -1e30, so a
//   wholly masked tile leaves m, l and O as they were.  For the tf32 P V the
//   keys of each 8-key tile are taken in the order 0, 2, 4, 6, 1, 3, 5, 7, so
//   the score accumulators are the A fragment as they stand (no shuffle); V
//   is read in the same order.
// - The grid is one row of B * Hkv * row-tile blocks, the row tiles with the
//   most keys first across every batch and kv head, so a causal run's long
//   blocks start in the first wave and the short ones fill in behind them.
//   The dynamic shared memory limit is raised once per instance, outside
//   any CUDA-graph capture.
//
// The tile sizes kBlockM and kBlockN are BLOCK_ROWS and BLOCK_KEYS in
// kernels/flash_attention.py, which the CPU rehearsal of the split uses.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// are passed as void*, sizes as int64.  Each entry point returns
// cudaGetLastError() after the launch, so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                   // 4 row slices x 2 key halves
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = 64;                 // packed rows a block: 16 a row slice
constexpr int kBlockN = 32;                 // keys a K/V stage: 16 a key half
constexpr int kStages = 2;
constexpr int kHalfN = kBlockN / 2;         // keys a warp takes from a stage
constexpr int kNT = kHalfN / 8;             // its 8-key score tiles
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr int row_stride(int d) { return d + 4; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)row_stride(D) * (kBlockM + 2 * kStages * kBlockN);
}
// the merge of the key halves parks 4 slices x (D / 8 + 1) x 32 float4s there
static_assert(4 * (32 / 8 + 1) * 32 * 16 <= smem_bytes<32>(), "park");

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo: hi is x rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest,
// ties away from zero: add half a TF32 ulp to the bits, clear the low 13);
// lo = x - hi is exact, and the tensor cores read its top 19 bits.  Two
// integer operations and a subtraction: two cvt.rna conversions a split
// were a quarter slower on the H100.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// 16 bytes of q into shared memory, scaled
__device__ __forceinline__ void stage_q(float* dst, const float* src, bool ok, float scale) {
  float4 x = ok ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
  x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// s = q k^T for the warp's 16 rows (qw) and the stage's kBlockN keys (ks):
// three TF32 products, q already scaled.
template <int D>
__device__ __forceinline__ void scores(const float* qw, const float* ks, float (&s)[kNT][4],
                                       int g, int t) {
  constexpr int S = row_stride(D);
#pragma unroll
  for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
  float c1[kNT][4], c2[kNT][4];             // the two small products apart
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[j][e] = c2[j][e] = 0.0f;
#pragma unroll 4
  for (int kk = 0; kk < D / 8; ++kk) {
    const float* qa = qw + g * S + 8 * kk + t;
    uint32_t ah[4], al[4];
    split(qa[0], ah[0], al[0]);
    split(qa[8 * S], ah[1], al[1]);
    split(qa[4], ah[2], al[2]);
    split(qa[8 * S + 4], ah[3], al[3]);
    uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float* kb = ks + (8 * j + g) * S + 8 * kk + t;
      split(kb[0], bh[j][0], bl[j][0]);
      split(kb[4], bh[j][1], bl[j][1]);
    }
    // three chains of independent accumulators a key tile
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_tf32(c1[j], ah, bl[j]);
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_tf32(c2[j], al, bh[j]);
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_tf32(s[j], ah, bh[j]);
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += c1[j][e] + c2[j][e];
}

// o += p v over the stage's keys: three TF32 products; the k index
// t of an 8-key tile is key 2t and t + 4 is key 2t + 1, so the score
// accumulators are the A fragment as they stand.
template <int D>
__device__ __forceinline__ void accumulate(float (&o)[D / 8][4], const float (&p)[kNT][4],
                                           const float* vs, int g, int t) {
  constexpr int S = row_stride(D);
  uint32_t ph[kNT][4], pl[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    split(p[j][0], ph[j][0], pl[j][0]);
    split(p[j][2], ph[j][1], pl[j][1]);
    split(p[j][1], ph[j][2], pl[j][2]);
    split(p[j][3], ph[j][3], pl[j][3]);
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {              // independent accumulators
      const float* vb = vs + (8 * j + 2 * t) * S + 8 * n + g;
      uint32_t bh[2], bl[2];
      split(vb[0], bh[0], bl[0]);
      split(vb[S], bh[1], bl[1]);
      mma_tf32(o[n], ph[j], bl);
      mma_tf32(o[n], pl[j], bh);
      mma_tf32(o[n], ph[j], bh);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int hq,
                       int hkv, int lq, int lk, int causal, int window,
                       float scale) {
  constexpr int S = row_stride(D);
  constexpr int kVec = 4;                             // elements a 16-byte copy
  constexpr int kChunks = D / kVec;                   // 16-byte copies a row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);        // [kBlockM][S]
  float* kvs = qs + kBlockM * S;                      // [kStages][K, V][kBlockN][S]

  const int tid = threadIdx.x, lane = tid & 31;
  const int slice = (tid >> 5) & 3, half = tid >> 7;   // the warp's rows and keys
  const int g = lane >> 2, t = lane & 3;
  const int group = hq / hkv;
  const int nrows = lq * group;                       // packed (query, head) rows
  // block i takes row tile ntr - 1 - i / (B Hkv) of (batch, kv head) i % (B Hkv):
  // the row tiles with the most keys start first, across every batch and head
  const int ntr = (nrows + kBlockM - 1) / kBlockM;
  const int nbh = gridDim.x / ntr;
  const int r0 = (ntr - 1 - (int)blockIdx.x / nbh) * kBlockM;
  const int hk = blockIdx.x % nbh % hkv, b = blockIdx.x % nbh / hkv;
  const int offset = lk - lq;
  const int64_t kbase = ((int64_t)b * hkv + hk) * lk * D;
  // packed row R: q head hk * group + R % group, query R / group
  auto row_base = [&](int row) -> int64_t {
    return (((int64_t)b * hq + hk * group + row % group) * lq + row / group) * D;
  };

  for (int i = tid; i < kBlockM * kChunks; i += kThreads) {
    const int row = i / kChunks, c = (i % kChunks) * kVec;
    const bool ok = r0 + row < nrows;
    stage_q(qs + row * S + c, q + (ok ? row_base(r0 + row) : 0) + c, ok, scale);
  }

  // the keys this block's rows can see: [kbeg, kend)
  const int pos_lo = r0 / group + offset;
  const int pos_hi = (min(r0 + kBlockM, nrows) - 1) / group + offset;
  const int kend = causal ? min(lk, pos_hi + 1) : lk;
  const int kbeg = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int ntiles = kend > kbeg ? (kend - kbeg + kBlockN - 1) / kBlockN : 0;

  // the warp's 16 rows, and this thread's two (g and g + 8)
  const int w0 = r0 + 16 * slice;
  const bool warp_live = w0 < nrows;
  const int wpos_lo = w0 / group + offset;
  const int wpos_hi = (min(w0 + 16, nrows) - 1) / group + offset;
  const int pos[2] = {(w0 + g) / group + offset, (w0 + g + 8) / group + offset};

  auto load_tile = [&](int it) {
    const int t0 = kbeg + it * kBlockN;
    float* ks = kvs + (it % kStages) * 2 * kBlockN * S;
    float* vs = ks + kBlockN * S;
    for (int i = tid; i < kBlockN * kChunks; i += kThreads) {
      const int j = i / kChunks, c = (i % kChunks) * kVec;
      const bool ok = t0 + j < kend;
      const int64_t src = kbase + (int64_t)(ok ? t0 + j : 0) * D + c;
      cp_async16(ks + j * S + c, k + src, ok);
      cp_async16(vs + j * S + c, v + src, ok);
    }
    cp_async_commit();
  };

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  if (ntiles > 0) load_tile(0);
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_tile(it + 1);                    // its stage was freed by the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                        // tile it (and q) visible to every thread
    const int t0 = kbeg + it * kBlockN + kHalfN * half;  // the warp's first key
    const bool live = warp_live && t0 < kend && (!causal || t0 <= wpos_hi) &&
                      (window <= 0 || t0 + kHalfN - 1 > wpos_lo - window);
    if (live) {
      const float* ks = kvs + (it % kStages) * 2 * kBlockN * S + kHalfN * half * S;
      float s[kNT][4];
      scores<D>(qs + 16 * slice * S, ks, s, g, t);

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + 8 * j + 2 * t + (e & 1), p = pos[e >> 1];
          const bool ok = key < kend && (!causal || key <= p) &&
                          (window <= 0 || key > p - window);
          s[j][e] = ok ? s[j][e] : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float alpha[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]);          // -inf (masked) -> 0
          rsum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rsum[h];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      accumulate<D>(o, s, ks + kBlockN * S, g, t);
    }
    __syncthreads();                        // the stage is consumed
  }

  // the two key halves of a row slice merge: half 1 parks m, l and o in
  // shared memory (Q and the ring are consumed), half 0 folds them in and
  // writes the rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float4* park = reinterpret_cast<float4*>(smem4) + slice * (D / 8 + 1) * 32 + lane;
  __syncthreads();
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      park[32 * n] = make_float4(o[n][0], o[n][1], o[n][2], o[n][3]);
    park[32 * (D / 8)] = make_float4(m[0], m[1], l[0], l[1]);
  }
  __syncthreads();
  if (half == 1) return;
  const float4 ml = park[32 * (D / 8)];
  const float m2[2] = {ml.x, ml.y}, l2[2] = {ml.z, ml.w};
  float a[2], a2[2], denom[2], m_new[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_new[h] = fmaxf(m[h], m2[h]);
    a[h] = expf(m[h] - m_new[h]);
    a2[h] = expf(m2[h] - m_new[h]);
    denom[h] = fmaxf(l[h] * a[h] + l2[h] * a2[h], 1e-30f);
  }
  float* dst[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w0 + g + 8 * h;
    ok[h] = row < nrows;
    dst[h] = out + (ok[h] ? row_base(row) : 0) + 2 * t;
    if (lse != nullptr && ok[h] && t == 0) lse[row_base(row) / D] = m_new[h] + logf(denom[h]);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const float4 p = park[32 * n];
    const float x[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (ok[h])
        store2(dst[h] + 8 * n, (o[n][2 * h] * a[h] + x[2 * h] * a2[h]) / denom[h],
               (o[n][2 * h + 1] * a[h] + x[2 * h + 1] * a2[h]) / denom[h]);
  }
}

// Raise the instance's dynamic shared memory limit, once, so that no launch
// inside a CUDA-graph capture sets it.
template <int D>
cudaError_t prepare() {
  constexpr size_t smem = smem_bytes<D>();
  if (smem <= 48 * 1024) return cudaSuccess;
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return err;
}

// One instance's registers and local bytes a thread, shared bytes a block
// (static and dynamic), threads a block and blocks an SM.
template <int D>
int resources(int* out) {
  constexpr int threads = kThreads;
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t err = prepare<D>();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, flash_attention_kernel<D>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_attention_kernel<D>, threads,
                                                        smem_bytes<D>());
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + smem_bytes<D>());
  out[3] = threads;
  out[4] = blocks;
  return (int)cudaSuccess;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int64_t b,
           int64_t hq, int64_t hkv, int64_t lq, int64_t lk, int64_t causal,
           int64_t window, double scale, void* stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_kernel<D>;
  const cudaError_t err = prepare<D>();
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = lq * (hq / hkv);
  const dim3 grid((unsigned)((rows + kBlockM - 1) / kBlockM * hkv * b));
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), static_cast<float*>(lse), (int)hq, (int)hkv, (int)lq,
      (int)lk, (int)causal, (int)window, (float)(scale > 0.0 ? scale : 1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* out, void* lse, int64_t b,
             int64_t hq, int64_t hkv, int64_t lq, int64_t lk, int64_t d,
             int64_t causal, int64_t window, double scale, void* stream) {
  if (b <= 0 || hq <= 0 || lq <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv || lq > lk || window < 0 || b > 65535 || hkv > 65535 ||
      lq * hq > 0x7fffffff || lk > 0x7fffffff || (lq * hq / kBlockM + 1) * b > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32:
      return launch<32>(q, k, v, out, lse, b, hq, hkv, lq, lk, causal, window, scale,
                            stream);
    case 64:
      return launch<64>(q, k, v, out, lse, b, hq, hkv, lq, lk, causal, window, scale,
                            stream);
    case 128:
      return launch<128>(q, k, v, out, lse, b, hq, hkv, lq, lk, causal, window, scale,
                            stream);
    case 256:
      return launch<256>(q, k, v, out, lse, b, hq, hkv, lq, lk, causal, window, scale,
                            stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// window 0 means none; causal 0 or 1; lse may be null; scale <= 0 means D^-0.5.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int64_t b, int64_t hq, int64_t hkv,
                                   int64_t lq, int64_t lk, int64_t d, int64_t causal,
                                   int64_t window, double scale, void* stream) {
  return dispatch(q, k, v, out, lse, b, hq, hkv, lq, lk, d, causal, window, scale, stream);
}

// For reports: out[5] = registers, local bytes, shared bytes, threads, blocks an SM.
extern "C" int flash_attention_resources(int64_t d, int* out) {
  switch (d) {
    case 32: return resources<32>(out);
    case 64: return resources<64>(out);
    case 128: return resources<128>(out);
    case 256: return resources<256>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
