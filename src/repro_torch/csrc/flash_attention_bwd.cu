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
// [B, Hq, Lq], fp32; the eight others fp32 (flash_attention_bwd_f32) or bf16
// (flash_attention_bwd_bf16); contiguous, 16-byte aligned.  q head h reads kv head
// h / (Hq / Hkv).  The masks, positions and scale are the forward's: query
// row r sits at key position r + Lk - Lq, a key at position j is seen from
// position i if j <= i (causal) and j > i - window (window > 0), s = q.k *
// scale (D^-0.5 unless the caller passes the forward's other scale), and lse
// is the forward's m + log(l) in those units, so p = exp(s - lse).  Then
//   delta_i = sum_d dout_id out_id,   dp = dout v^T,   ds = p (dp - delta),
//   dv = p^T dout,   dk = scale ds^T q,   dq = scale ds k.
//
// Bound: at smollm-135m's training shape (B 4, Hq 9, Hkv 3, L 2048, D 64,
// causal) the five products of 2 L^2 D flops a head, halved by the mask, are
// 48.3 GFLOP: 0.2930 ms at an H100 SXM's 495 TFLOP/s of TF32 over three
// products a flop (3xTF32, fp32-accurate, as the forward's bound counts);
// its bytes (q, k, v, out, dout, lse in; dq, dk, dv out) are 101 MB, 0.0301
// ms at 3.35 TB/s.  It is bound by operations.  mma.sync itself reaches 318
// TFLOP/s of TF32 on the card (64% of 495), and about 200 when each product
// brings its share of a split (probe_mma_tf32.py; H100 80GB HBM3, 700 W):
// the ceiling of any design built on it.
//
// What held the first design back: its five products ran as fp32
// FMAs on the CUDA cores, each inner step reading 8 words of shared memory
// for 16 FMAs, so shared memory capped it near half the 67 TFLOP/s fp32
// rate: 3.03 ms at smollm's shape, 10% of the bound.  Its tiles were staged
// by plain loads between barriers, so no copy overlapped the arithmetic.
// This design takes 1.49 ms there (dK/dV 0.88, dQ 0.58, delta 0.02), 20%
// of the bound (NVIDIA H100 80GB HBM3, 700 W; the first design 3.06 ms in
// the same run).
//
// Design.
// - Tensor cores, fp32 as 3xTF32, as flash_attention.cu does it: every
//   product runs on mma.sync.m16n8k8 with tf32 operands and fp32
//   accumulators; each fp32 operand x is split in registers into hi (x
//   rounded as cvt.rna.tf32 rounds) and lo = x - hi, and each product is
//   hi*lo + lo*hi + hi*hi (lo*lo dropped), the two small products first.
//   One TF32 product misses the 1e-5 gate; three meet it
//   (tests/test_torch_tf32_split_bwd.py emulates both on the CPU, in these
//   kernels' tile and accumulation order).  mma.sync and not wgmma: wgmma
//   reads tf32 operands K-major from shared memory only, so the split would
//   need hi and lo copies of every tile there (twice the 105 KB a block
//   stages at D 64, more than a block has at D 128) and Q/dO transposed
//   copies for dK and dV; mma.sync splits in registers.  Splitting each
//   staged tile once into hi and lo planes in shared memory instead (twice
//   the bytes and the loads, none of the split's arithmetic in the inner
//   loops) was slower on the card: dK/dV 0.961 ms against 0.871, dQ 0.712
//   against 0.581 (H100 80GB HBM3, 700 W).  The loads, not the arithmetic,
//   hold these loops.
// - The tensor cores round each mma's sum toward zero, so a sum kept in
//   their accumulators drifts: dk and dv kept there for a whole walk (1,152
//   mma.sync in a chain at smollm's shape) came out 1.2e-4 of dk's 4.0 low
//   on the card, beyond the gate.  So each stage's product is taken in fresh
//   accumulators (12 mma.sync in a chain) and added to the running sums in
//   fp32, rounded to nearest; s and dp (24 in a chain at D 64) start from
//   zero each stage anyway.  The CPU rehearsal models the rounding.
// - Three kernels on one stream, launched by one entry point: delta (one warp
//   a row), dK/dV (one block a key tile), dQ (one block a query tile).  Both
//   big kernels have the same shape: 8 warps, 4 row slices of 16 rows (the
//   mma's M) by 2 column halves of 32 columns of each 64-wide stage; every
//   warp keeps its own partial sums, and at the end the two halves of a
//   slice meet in shared memory, half 0 adding half 1's.
// - dK/dV with the keys on M.  A block owns 64 keys of one (batch, kv head)
//   and walks the q heads of the GQA group, each over the query tiles that
//   see its keys, in that fixed order.  A warp computes s^T = K Q^T and dp^T =
//   V dO^T for its 16 keys and 32 queries, then p^T = 2^(s^T scale log2 e -
//   lse log2 e) (ex2 on the special-function unit) and ds^T = p^T (dp^T -
//   delta) in the accumulators' layout (lse and delta are per column), and
//   feeds them as the A fragments of dv += p^T dO and dk += ds^T Q: the 8
//   queries of each k step are taken in the order 0, 2, 4, 6, 1, 3, 5, 7, so
//   the accumulators are the A fragment as they stand (the forward's P V
//   trick) and nothing goes through shared memory.  K and V stay resident
//   in shared memory (at D 128 the registers cannot hold them beside dk and
//   dv); Q, dO, lse and delta arrive through a cp.async ring of 2 stages, so
//   the next stage's copy runs under this one's products.  dk and dv (2 x
//   D/8 x 4 sums a thread) stay in registers for the whole walk.
// - dQ as the forward.  A block owns 64 queries of one (batch, q head); Q,
//   dO, lse and delta are staged once, K and V tiles of 64 keys arrive
//   through a cp.async ring of 2 stages.  A warp computes s = Q K^T and dp =
//   dO V^T for its 16 queries and 32 keys, p and ds in place, and dq += ds K
//   with ds as the A fragment.  It recomputes s and dp: seven products where
//   the bound counts five (the floor of this count at 495 TFLOP/s is 0.41
//   ms).  Taking dq from the dK/dV walk instead (five products) needs a sum
//   over key tiles: atomics (an order that changes from launch to launch)
//   or a partial dq a key tile summed in a fixed order by a second pass,
//   about 0.3 GB of scratch a call at smollm's shape.  The port relies on
//   two launches giving the same bits (chip_smoke.py phase 20a, bit-equal
//   resumes), so the two products are paid instead.
// - Deterministic: no atomics; every output element is written once, by
//   one thread, after sums taken in a fixed order.
// - Whole tiles outside the masks are skipped, as is a warp's quarter of a
//   stage that no pair of it sees; a quarter that every pair of it sees
//   skips the mask.  Key tiles that no query sees get zero dk and dv.  The
//   grids put the blocks with the most work first (key tiles from the left,
//   query tiles from the right) across every batch and head.  At smollm's
//   shape the 384 dK/dV blocks are uneven (the longest walks 96 stages in
//   0.53 ms alone); the card's dK/dV time grows from 0.88 ms at B 4 to 1.60
//   at B 8, so the tail costs about a tenth.
// - Rows are padded by 16 bytes (stride D + 4 words): the 8 rows x 4
//   columns a fragment load touches, and the 4 row pairs x 8 columns of a
//   B fragment of dv, dk and dq, fall on 32 distinct banks.
// - Resources (cudaFuncGetAttributes on the card, H100 80GB HBM3): 256
//   threads; dK/dV at D 64 219 registers, 105,472 shared bytes, 1 block an
//   SM (capped at 2 blocks it spilled and ran 8% slower); dQ at D 64 128
//   registers, 104,960 bytes, 2 blocks an SM; at D 128 255 (24 bytes of
//   spill) and 212 registers, about 204 KB, 1 block; at D 256 (a block of a
//   cluster) 255 and 199 registers, 171,008 and 170,496 bytes, 1 block an
//   SM, 30 clusters of 4 at once.  flash_attention_bwd_resources reports
//   each instance.
// - D 256 (gemma3-1b: 4 q heads on 1 kv head of 256) splits D over a thread
//   block cluster of four.  The D 128 layout does not fit there: K and V of
//   64 keys plus two stages of Q and dO take 400,384 bytes of shared memory
//   (a block has 232,448), dk and dv 128 sums a thread, and at gemma's one
//   kv head and a batch of 2 its dK/dV grid has 32 blocks for 132 SMs.  Each
//   block of a cluster owns kSplitCols = 64 columns of D and stages only
//   those of K, V, Q and dO: the D 64 kernels' tiles, products and register
//   budget.  s and dp contract over D, so each block takes its partial over
//   its columns in fresh accumulators (24 mma.sync in a chain, as at D 64)
//   and the cluster adds the four partials through distributed shared
//   memory (cluster_sum: a reduce-scatter and an all-gather, both by stores,
//   the sums in rank order 0 to 3), so every block holds the same s and dp,
//   bit for bit, and forms p and ds from them; then dk, dv (or dq) of its own
//   columns.  A dK/dV cluster walks one q head of the group, not the whole
//   group: four times the clusters, a walk a quarter as long.  Each head's
//   share of dk and dv goes to a scratch area ([2, B, Hq, Lk, D], 16.8 MB at
//   gemma's shape), and flash_attention_bwd_sum_kernel adds the shares in
//   head order.  Bound at gemma3-1b's training shape (B 2, Hq 4, Hkv 1, L
//   1024, D 256): five products of 2 D flops a seen pair, 10.75 GFLOP on a
//   global layer (0.0651 ms at 165 TFLOP/s) and 8.06 on a layer with the
//   512-key window (0.0488 ms); 42 MB of bytes, 0.0125 ms; bound by
//   operations.  The exchange moves the partials by stores and not by
//   remote loads, whose round trip across the cluster a warp would wait
//   for each stage.  Both kernels pass a cluster barrier at entry, before
//   the first store into a peer's shared memory: distributed shared memory
//   may be touched only once every block of the cluster is known to run.
//   The release in each of cluster_sum's barriers is what makes the stores
//   visible; probe_attn_bwd_256.py prices it (a relaxed arrive, with wrong
//   sums) and the exchange as a whole.  A chain over all of D 256 in one
//   accumulator (96 mma.sync) met the gate in the CPU rehearsal with half
//   the margin of the quarters.
//
// - bf16 (the mixed and bf16_train policies' models): the same kernels,
//   tiles and 3xTF32 products, at every head dim, on the bf16 values read as
//   fp32.  Each bf16 tile is converted as it is staged: 16-byte loads of 8
//   values, converted to fp32 and stored into the fp32 tile the fp32
//   instance's cp.async would have filled (a cp.async copies raw bytes, and a
//   bf16 row is half the bytes the ring's fp32 rows index), so the loads of
//   the next stage no longer overlap this stage's products; lse, delta, the
//   D 256 cluster's exchange of s and dp, the heads' shares in `part` and
//   every sum stay fp32.  delta is taken from the bf16 out the forward
//   wrote, as the fp32 instance takes it from its out.  dq, dk and dv are
//   rounded to bf16 as they are written: the fp32 gradient cast to bf16,
//   which is what differentiating the reference's attention gives its bf16
//   inputs (it computes in fp32 and casts its output to q's dtype).
//
// The tile sizes kKeys, kQueries and kSplitCols are BWD_BLOCK_KEYS,
// BWD_BLOCK_QUERIES and BWD_SPLIT_COLS in kernels/flash_attention.py, which
// the CPU rehearsal reads.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// as void*, sizes as int64; the entry returns cudaGetLastError() after its
// launches, so a refused launch is reported.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;                   // 4 row slices x 2 column halves
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 64;                   // keys a dK/dV block and a dQ stage
constexpr int kQueries = 64;                // queries a dQ block and a dK/dV stage
constexpr int kStages = 2;
constexpr int kHalf = 32;                   // columns a warp takes from a stage
constexpr int kNT = kHalf / 8;              // its 8-column tiles
static_assert(kKeys == 2 * kHalf && kQueries == 2 * kHalf, "2 column halves a stage");
static_assert(kKeys == 4 * 16 && kQueries == 4 * 16, "4 row slices of 16 a block");
constexpr int kSplitCols = 64;              // columns of D a block takes above D 128

// blocks of a cluster that share a tile, each taking its own kSplitCols
// columns of D: one up to D 128, four at D 256
__host__ __device__ constexpr int split_of(int d) { return d > 128 ? d / kSplitCols : 1; }
// a shared-memory row of w columns: padded by 16 bytes
__host__ __device__ constexpr int row_stride(int w) { return w + 4; }
// dQ blocks an SM that its register budget is set for (dK/dV's is one, for
// its dk and dv sums): at D 64, two took dQ from 0.725 to 0.680 ms at
// smollm's shape, and would take dK/dV from 1.006 to 1.091 (H100 80GB HBM3,
// 700 W)
__host__ __device__ constexpr int dq_min_blocks(int d) { return d <= 64 ? 2 : 1; }

// a cluster's exchange: its slots and its sums, each every warp's partial s
// and dp, a float4 a lane an 8-column tile; none without a cluster
__host__ __device__ constexpr size_t xchg_bytes(int d) {
  return split_of(d) > 1 ? (size_t)2 * kWarps * 2 * kNT * 32 * 16 : 0;
}

// K, V; a stage: Q, dO, lse, delta; the exchange (all of a block's columns)
template <int D>
__host__ __device__ constexpr size_t dkdv_smem() {
  constexpr int kS = row_stride(D / split_of(D));
  return sizeof(float) * ((size_t)2 * kKeys * kS +
                          kStages * ((size_t)2 * kQueries * kS + 2 * kQueries)) + xchg_bytes(D);
}
// Q, dO, lse, delta; a stage: K, V; the exchange
template <int D>
__host__ __device__ constexpr size_t dq_smem() {
  constexpr int kS = row_stride(D / split_of(D));
  return sizeof(float) * ((size_t)2 * kQueries * kS + 2 * kQueries +
                          (size_t)kStages * 2 * kKeys * kS) + xchg_bytes(D);
}
// bytes the halves' merge parks: 128 threads' m outputs of w / 8 float4s
__host__ __device__ constexpr size_t park_bytes(int m, int w) {
  return (size_t)m * (w / 8) * 128 * 16;
}

struct Shape {
  int hq, hkv, lq, lk, causal, window;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool fill) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(fill ? 4 : 0));
}
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// two adjacent outputs, fp32 or rounded to bf16 (to nearest)
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
// four adjacent outputs
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y), b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo: hi is x rounded to TF32 as cvt.rna.tf32.f32 rounds (add half
// a TF32 ulp to the bits, clear the low 13); lo = x - hi is exact, and the
// tensor cores read its top 19 bits.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2^-22)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c0 = a0 b0^T and c1 = a1 b1^T over D, for the warp's 16 rows of a0, a1 and
// the kHalf rows of b0, b1 (all shared memory, row stride D + 4): c[j] holds
// rows g, g + 8 and columns 8 j + 2 t, 8 j + 2 t + 1.  Three TF32 products a
// k step, the small ones first; the two results' 2 kNT accumulators are
// independent chains, taken in turn.
template <int D>
__device__ __forceinline__ void gemm_nt2(float (&c0)[kNT][4], const float* a0, const float* b0,
                                         float (&c1)[kNT][4], const float* a1, const float* b1,
                                         int g, int t) {
  constexpr int S = row_stride(D);
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c0[j][e] = c1[j][e] = 0.0f;
#pragma unroll 2
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float* pa = (m ? a1 : a0) + g * S + 8 * kk + t;
      split(pa[0], ah[m][0], al[m][0]);
      split(pa[8 * S], ah[m][1], al[m][1]);
      split(pa[4], ah[m][2], al[m][2]);
      split(pa[8 * S + 4], ah[m][3], al[m][3]);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* pb = (m ? b1 : b0) + (8 * j + g) * S + 8 * kk + t;
        uint32_t bh[2], bl[2];
        split(pb[0], bh[0], bl[0]);
        split(pb[4], bh[1], bl[1]);
        float (&c)[4] = m ? c1[j] : c0[j];
        mma_tf32(c, ah[m], bl);
        mma_tf32(c, al[m], bh);
        mma_tf32(c, ah[m], bh);
      }
  }
}

// o += p x over the warp's kHalf columns of p (accumulators of gemm_nt2) and
// the kHalf rows of x (shared memory): the k index t of an 8-column tile is
// column 2 t and t + 4 is 2 t + 1, so p's accumulators are the A fragment as
// they stand; x's rows are read in the same order.  Each 8-column block of o
// takes the stage's product in a fresh accumulator and adds it to o in fp32,
// rounded to nearest (the tensor cores round toward zero: see the header).
template <int D>
__device__ __forceinline__ void gemm_nn(float (&o)[D / 8][4], const float (&p)[kNT][4],
                                        const float* x, int g, int t) {
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
  for (int n = 0; n < D / 8; ++n) {
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float* pb = x + (8 * j + 2 * t) * S + 8 * n + g;
      uint32_t bh[2], bl[2];
      split(pb[0], bh[0], bl[0]);
      split(pb[S], bh[1], bl[1]);
      mma_tf32(c, ph[j], bl);
      mma_tf32(c, pl[j], bh);
      mma_tf32(c, ph[j], bh);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] += c[e];
  }
}

// rows [r0, r0 + 64) of a [len, LD] matrix, their first W columns, into a
// [64][W + 4] fp32 tile, zeros past len: fp32 rows by cp.async, bf16 rows by
// 16-byte loads of 8 values converted to fp32 on the way (done when the
// function returns)
template <int W, int LD = W, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src, int r0,
                                           int len) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr int kChunks = W / 4;          // 16-byte copies a row
    for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      const bool ok = r0 + r < len;
      cp_async16(dst + r * row_stride(W) + c, src + (int64_t)(ok ? r0 + r : 0) * LD + c, ok);
    }
  } else {
    constexpr int kChunks = W / 8;          // 16-byte loads a row
    for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
      if (r0 + r < len) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * LD + c);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
        const float2 e = __bfloat1622float2(h[2]), f = __bfloat1622float2(h[3]);
        lo = make_float4(a.x, a.y, b.x, b.y);
        hi = make_float4(e.x, e.y, f.x, f.y);
      }
      float* p = dst + r * row_stride(W) + c;
      *reinterpret_cast<float4*>(p) = lo;
      *reinterpret_cast<float4*>(p + 4) = hi;
    }
  }
}

// 64 values of a row vector from r0 by cp.async, zeros past len
__device__ __forceinline__ void stage_vec(float* dst, const float* __restrict__ src, int r0,
                                          int len) {
  if (threadIdx.x < 64) {
    const bool ok = r0 + (int)threadIdx.x < len;
    cp_async4(dst + threadIdx.x, src + (ok ? r0 + threadIdx.x : 0), ok);
  }
}

__device__ __forceinline__ bool seen(int qpos, int key, int lk, int causal, int window) {
  return key < lk && (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

// whether some pair of rows [q, q + nq) and keys [k, k + nk) can be seen
__device__ __forceinline__ bool any_seen(int q, int nq, int k, int nk, const Shape& sh) {
  const int offset = sh.lk - sh.lq;
  const int qlast = min(q + nq, sh.lq) - 1;
  return q < sh.lq && k < sh.lk && (!sh.causal || k <= qlast + offset) &&
         (sh.window <= 0 || k + nk - 1 > q + offset - sh.window);
}

// whether every pair of rows [q, q + nq) and keys [k, k + nk) is seen
__device__ __forceinline__ bool all_seen(int q, int nq, int k, int nk, const Shape& sh) {
  const int offset = sh.lk - sh.lq;
  return q + nq <= sh.lq && k + nk <= sh.lk && (!sh.causal || k + nk - 1 <= q + offset) &&
         (sh.window <= 0 || k > q + nq - 1 + offset - sh.window);
}

// the queries [lo, hi) that can see a key in [k0, k0 + kKeys)
__device__ __forceinline__ void query_range(int k0, const Shape& sh, int& lo, int& hi) {
  const int offset = sh.lk - sh.lq;
  lo = sh.causal ? max(0, k0 - offset) : 0;
  hi = sh.window > 0 ? min(sh.lq, k0 + kKeys - 1 + sh.window - offset) : sh.lq;
}

// the keys [lo, hi) that a query in [q0, q0 + kQueries) can see
__device__ __forceinline__ void key_range(int q0, const Shape& sh, int& lo, int& hi) {
  const int offset = sh.lk - sh.lq;
  const int last = min(q0 + kQueries, sh.lq) - 1;
  lo = sh.window > 0 ? max(0, q0 + offset - sh.window + 1) : 0;
  hi = sh.causal ? min(sh.lk, last + offset + 1) : sh.lk;
}

// delta[r] = sum_d dout[r][d] out[r][d]: one warp a row, 8 rows a block
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_delta_kernel(const T* __restrict__ out,
                                 const T* __restrict__ dout, float* __restrict__ delta,
                                 int64_t rows, int d) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + row * d;
  const T* g = dout + row * d;
  float s = 0.0f;
  for (int i = lane; i < d; i += 32) s = fmaf(to_f32(o[i]), to_f32(g[i]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// The two column halves of each row slice meet: half 1 parks its D/8 x 4
// sums of each of M outputs in shared memory, half 0 adds them to its own.
// Returns false for half 1, whose part is done.
template <int D, int M>
__device__ __forceinline__ bool merge_halves(float4* smem4, float (&acc)[M][D / 8][4]) {
  const int tid = threadIdx.x & 127;        // slice * 32 + lane
  __syncthreads();                          // every stage consumed
  if (threadIdx.x >= 128) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        smem4[(m * (D / 8) + n) * 128 + tid] =
            make_float4(acc[m][n][0], acc[m][n][1], acc[m][n][2], acc[m][n][3]);
  }
  __syncthreads();
  if (threadIdx.x >= 128) return false;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float4 x = smem4[(m * (D / 8) + n) * 128 + tid];
      acc[m][n][0] += x.x;
      acc[m][n][1] += x.y;
      acc[m][n][2] += x.z;
      acc[m][n][3] += x.w;
    }
  return true;
}

// the thread's rows g and g + 8 of a slice's W columns (of rows LD long): 8 n
// + 2 t and + 1
template <int W, int LD = W, typename T>
__device__ __forceinline__ void store_rows(T* dst, int r0, int len,
                                           const float (&acc)[W / 8][4], float mul, int g,
                                           int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= len) continue;
    T* p = dst + (int64_t)r * LD + 2 * t;
#pragma unroll
    for (int n = 0; n < W / 8; ++n) store2(p + 8 * n, acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
  }
}

// Above D 128 each block of a cluster holds the partial s and dp of its own
// columns of D (two kNT x 4 accumulators a thread); the cluster adds them
// by stores into each other's shared memory, never by remote loads (a
// remote load's round trip held the first form of this exchange to half
// of the kernels' time).  Rank o owns the elements of warps 2o and 2o + 1.
// 1. Each thread stores its partial into its warp's owner's slot for this
//    rank.  Cluster barrier.
// 2. Each rank's threads add the four slots of its two warps in rank order,
//    0 to 3, and store the sums into every rank's `sums`.  Cluster barrier.
// 3. Each thread reads its own sums: every block holds the same s and dp.
// A warp without work (`active(w)` false, the same in every rank) takes no
// part.  Two barriers a stage also keep the buffers safe to reuse: a rank
// stores into a slot again only after the barrier that follows its owner's
// reads, and into `sums` only after the barrier that follows their readers.
constexpr int kSlot = 2 * 2 * kNT * 32;     // float4s: two warps' a and b
template <int SPLIT, typename Active>
__device__ __forceinline__ void cluster_sum(float4* xbuf, float (&a)[kNT][4],
                                            float (&b)[kNT][4], Active active) {
  static_assert(kWarps == 2 * SPLIT, "two warps a rank");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* slots = xbuf;                     // [SPLIT][kSlot]: the owner's
  float4* sums = xbuf + SPLIT * kSlot;      // [kWarps][2][kNT][32]
  const bool mine = active(warp);
  if (mine) {
    float4* to = cluster.map_shared_rank(slots, warp / 2) + rank * kSlot +
                 (warp % 2) * 2 * kNT * 32 + lane;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      to[j * 32] = make_float4(a[j][0], a[j][1], a[j][2], a[j][3]);
      to[(kNT + j) * 32] = make_float4(b[j][0], b[j][1], b[j][2], b[j][3]);
    }
  }
  cluster.sync();
#pragma unroll
  for (int i = 0; i < kSlot / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;    // of the owned warps' elements
    if (!active(2 * rank + e / (2 * kNT * 32))) continue;
    float4 x = slots[e];
#pragma unroll
    for (int r = 1; r < SPLIT; ++r) {
      const float4 y = slots[r * kSlot + e];
      x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
    }
#pragma unroll
    for (int r = 0; r < SPLIT; ++r) cluster.map_shared_rank(sums, r)[rank * kSlot + e] = x;
  }
  cluster.sync();
  if (!mine) return;
  const float4* from = sums + warp * 2 * kNT * 32 + lane;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const float4 x = from[j * 32], y = from[(kNT + j) * 32];
    a[j][0] = x.x, a[j][1] = x.y, a[j][2] = x.z, a[j][3] = x.w;
    b[j][0] = y.x, b[j][1] = y.y, b[j][2] = y.z, b[j][3] = y.w;
  }
}

// One block a (batch, kv head, key tile): dk and dv of its 64 keys, summed
// over every query tile of every q head of the group that sees them.  Above D
// 128 a cluster of split_of(D) blocks a (batch, q head, key tile), each on its
// own C columns: the q head's share of dk (unscaled) and dv goes to `part`
// ([2, B, Hq, Lk, D]), and flash_attention_bwd_sum_kernel adds the shares.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta, T* __restrict__ dk,
                                T* __restrict__ dv, float* __restrict__ part, Shape sh) {
  constexpr int kSplit = split_of(D), C = D / kSplit;
  constexpr bool kPerHead = kSplit > 1;
  constexpr int S = row_stride(C);
  constexpr int kStage = 2 * kQueries * S + 2 * kQueries;   // Q, dO, lse, delta
  static_assert(park_bytes(2, C) <= dkdv_smem<D>(), "dk and dv park in shared memory");
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);             // [kKeys][S]
  float* vs = ks + kKeys * S;
  float* ring = vs + kKeys * S;                            // [kStages][kStage]
  float4* xbuf = reinterpret_cast<float4*>(ring + kStages * kStage);   // the exchange

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slice = warp & 3, half = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int tile = (int)blockIdx.x / kSplit;               // a cluster's blocks are adjacent
  const int col0 = ((int)blockIdx.x % kSplit) * C;         // the block's columns of D
  const int ntiles = (sh.lk + kKeys - 1) / kKeys;
  const int nbh = (int)gridDim.x / kSplit / ntiles;        // (batch, kv or q head) pairs
  const int k0 = (tile / nbh) * kKeys;                     // the most-seen key tiles first
  const int group = sh.hq / sh.hkv;
  const int heads = kPerHead ? sh.hq : sh.hkv;
  const int b = tile % nbh / heads;
  // the first q head the block walks, and its kv head
  const int h0 = kPerHead ? tile % nbh % heads : tile % nbh % heads * group;
  const int hk = h0 / group;
  const int offset = sh.lk - sh.lq;
  const int64_t kv_off = ((int64_t)b * sh.hkv + hk) * sh.lk * D + col0;

  int lo, hi;
  query_range(k0, sh, lo, hi);
  const int t_lo = lo / kQueries;
  const int nt = hi > lo ? (hi + kQueries - 1) / kQueries - t_lo : 0;
  const int steps = (kPerHead ? 1 : group) * nt;   // (q head, query tile), heads outermost

  auto load_stage = [&](int s) {
    const int h = h0 + s / nt, q0 = (t_lo + s % nt) * kQueries;
    const int64_t row0 = ((int64_t)b * sh.hq + h) * sh.lq;
    float* st = ring + (s % kStages) * kStage;
    stage_rows<C, D>(st, q + row0 * D + col0, q0, sh.lq);
    stage_rows<C, D>(st + kQueries * S, dout + row0 * D + col0, q0, sh.lq);
    stage_vec(st + 2 * kQueries * S, lse + row0, q0, sh.lq);
    stage_vec(st + 2 * kQueries * S + kQueries, delta + row0, q0, sh.lq);
    cp_async_commit();
  };

  float acc[2][C / 8][4];                   // dk, dv
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;

  const int kw = k0 + 16 * slice;           // the warp's first key
  const int key[2] = {kw + g, kw + g + 8};
  if (steps > 0) {
    stage_rows<C, D>(ks, k + kv_off, k0, sh.lk);   // K and V join the first stage's group
    stage_rows<C, D>(vs, v + kv_off, k0, sh.lk);
    load_stage(0);
  }
  // every rank of the cluster has started before any store into its shared
  // memory (the first cluster_sum); the first stage's copies run under it
  if constexpr (kSplit > 1) cg::this_cluster().sync();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load_stage(s + 1);                    // its stage was freed by the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                        // stage s visible to every thread
    const int qw = (t_lo + s % nt) * kQueries + kHalf * half;   // the warp's first query
    // whether warp w has a pair of this stage to see (w's slice and half)
    auto active_of = [&](int w) {
      return any_seen(qw - kHalf * half + kHalf * (w >> 2), kHalf, k0 + 16 * (w & 3), 16, sh);
    };
    const bool active = active_of(warp);
    const float* st = ring + (s % kStages) * kStage;
    const float* qs = st + kHalf * half * S;
    const float* dos = st + kQueries * S + kHalf * half * S;
    const float* ls = st + 2 * kQueries * S + kHalf * half;
    const float* dls = ls + kQueries;
    float p[kNT][4], ds[kNT][4];
    if (active)
      gemm_nt2<C>(p, ks + 16 * slice * S, qs, ds, vs + 16 * slice * S, dos, g, t);  // s^T, dp^T
    if constexpr (kSplit > 1) cluster_sum<kSplit>(xbuf, p, ds, active_of);
    if (active) {
      const bool full = all_seen(qw, kHalf, kw, 16, sh);   // no mask inside
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1), query = qw + col;
          float pe = ex2_approx(fmaf(p[j][e], sh.scale * kLog2e, -ls[col] * kLog2e));
          if (!full && !(query < sh.lq && seen(query + offset, key[e >> 1], sh.lk, sh.causal,
                                               sh.window)))
            pe = 0.0f;
          p[j][e] = pe;
          ds[j][e] = pe * (ds[j][e] - dls[col]);
        }
      gemm_nn<C>(acc[1], p, dos, g, t);     // dv += p^T dO
      gemm_nn<C>(acc[0], ds, qs, g, t);     // dk += ds^T Q
    }
    __syncthreads();                        // the stage is consumed
  }
  if (!merge_halves<C, 2>(smem4, acc)) return;
  if constexpr (kPerHead) {
    const int64_t share = ((int64_t)b * sh.hq + h0) * sh.lk * D + col0;
    const int64_t plane = (int64_t)nbh * sh.lk * D;       // B Hq Lk D
    store_rows<C, D>(part + share, kw, sh.lk, acc[0], 1.0f, g, t);
    store_rows<C, D>(part + plane + share, kw, sh.lk, acc[1], 1.0f, g, t);
  } else {
    store_rows<C, D>(dk + kv_off, kw, sh.lk, acc[0], sh.scale, g, t);
    store_rows<C, D>(dv + kv_off, kw, sh.lk, acc[1], 1.0f, g, t);
  }
}

// dk and dv from the q heads' shares in `part` ([2, B, Hq, Lk, D], the
// group's heads of a kv head adjacent): each element the sum over the group
// in head order, dk's then scaled; n4 float4s of dk, len4 of a head's share.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_sum_kernel(const float4* __restrict__ part, T* __restrict__ dk,
                               T* __restrict__ dv, int64_t n4, int64_t len4, int group,
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
    store4((is_v ? dv : dk) + 4 * j, x);
  }
}

// One block a (batch, q head, query tile): dq of its 64 queries, summed over
// the key tiles they see.  Above D 128 a cluster of split_of(D) blocks a tile.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, dq_min_blocks(D))
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              T* __restrict__ dq, Shape sh) {
  constexpr int kSplit = split_of(D), C = D / kSplit;
  constexpr int S = row_stride(C);
  static_assert(park_bytes(1, C) <= dq_smem<D>(), "dq parks in shared memory");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);             // [kQueries][S]
  float* dos = qs + kQueries * S;
  float* ls = dos + kQueries * S;                          // lse, delta [kQueries]
  float* ring = ls + 2 * kQueries;                         // [kStages][K, V][kKeys][S]
  float4* xbuf = reinterpret_cast<float4*>(ring + kStages * 2 * kKeys * S);   // the exchange

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slice = warp & 3, half = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int tile = (int)blockIdx.x / kSplit;
  const int col0 = ((int)blockIdx.x % kSplit) * C;
  const int ntiles = (sh.lq + kQueries - 1) / kQueries;
  const int nbh = (int)gridDim.x / kSplit / ntiles;
  const int q0 = (ntiles - 1 - tile / nbh) * kQueries;   // the most keys first
  const int h = tile % nbh % sh.hq, b = tile % nbh / sh.hq;
  const int hk = h / (sh.hq / sh.hkv);
  const int offset = sh.lk - sh.lq;
  const int64_t row0 = ((int64_t)b * sh.hq + h) * sh.lq;
  const int64_t kv_off = ((int64_t)b * sh.hkv + hk) * sh.lk * D + col0;

  int lo, hi;
  key_range(q0, sh, lo, hi);
  const int t_lo = lo / kKeys;
  const int nt = hi > lo ? (hi + kKeys - 1) / kKeys - t_lo : 0;

  auto load_stage = [&](int s) {
    const int kt = (t_lo + s) * kKeys;
    float* st = ring + (s % kStages) * 2 * kKeys * S;
    stage_rows<C, D>(st, k + kv_off, kt, sh.lk);
    stage_rows<C, D>(st + kKeys * S, v + kv_off, kt, sh.lk);
    cp_async_commit();
  };

  float acc[1][C / 8][4];
#pragma unroll
  for (int n = 0; n < C / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][n][e] = 0.0f;

  const int qw = q0 + 16 * slice;           // the warp's first query
  const int query[2] = {qw + g, qw + g + 8};
  if (nt > 0) {
    stage_rows<C, D>(qs, q + row0 * D + col0, q0, sh.lq);   // Q, dO, lse, delta join the
    stage_rows<C, D>(dos, dout + row0 * D + col0, q0, sh.lq);   // first group
    stage_vec(ls, lse + row0, q0, sh.lq);
    stage_vec(ls + kQueries, delta + row0, q0, sh.lq);
    load_stage(0);
  }
  if constexpr (kSplit > 1) cg::this_cluster().sync();   // every rank started, as above
  for (int s = 0; s < nt; ++s) {
    if (s + 1 < nt) {
      load_stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kw = (t_lo + s) * kKeys + kHalf * half;   // the warp's first key
    auto active_of = [&](int w) {
      return any_seen(q0 + 16 * (w & 3), 16, kw - kHalf * half + kHalf * (w >> 2), kHalf, sh);
    };
    const bool active = active_of(warp);
    const float* kst = ring + (s % kStages) * 2 * kKeys * S + kHalf * half * S;
    const float* vst = kst + kKeys * S;
    float p[kNT][4], ds[kNT][4];
    if (active)
      gemm_nt2<C>(p, qs + 16 * slice * S, kst, ds, dos + 16 * slice * S, vst, g, t);  // s, dp
    if constexpr (kSplit > 1) cluster_sum<kSplit>(xbuf, p, ds, active_of);
    if (active) {
      const float l[2] = {ls[16 * slice + g] * kLog2e, ls[16 * slice + g + 8] * kLog2e};
      const float dl[2] = {ls[kQueries + 16 * slice + g], ls[kQueries + 16 * slice + g + 8]};
      const bool full = all_seen(qw, 16, kw, kHalf, sh);   // no mask inside
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, kk = kw + 8 * j + 2 * t + (e & 1);
          float pe = ex2_approx(fmaf(p[j][e], sh.scale * kLog2e, -l[r]));
          if (!full && !(query[r] < sh.lq &&
                         seen(query[r] + offset, kk, sh.lk, sh.causal, sh.window)))
            pe = 0.0f;
          ds[j][e] = pe * (ds[j][e] - dl[r]);
        }
      gemm_nn<C>(acc[0], ds, kst, g, t);    // dq += ds K
    }
    __syncthreads();
  }
  if (!merge_halves<C, 1>(smem4, acc)) return;
  store_rows<C, D>(dq + row0 * D + col0, qw, sh.lq, acc[0], sh.scale, g, t);
}

// Raise each instance's dynamic shared memory limit, once, so that no launch
// inside a CUDA-graph capture sets it.
template <int D, typename T>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dkdv_smem<D>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<D, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem<D>());
    return e;
  }();
  return err;
}

// a grid of `tiles` tiles on the stream: a block a tile, or above D 128 a
// cluster of split_of(D) blocks (its dimension in attr)
template <int D>
cudaLaunchConfig_t tile_config(int64_t tiles, size_t smem, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * split_of(D)));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (split_of(D) > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split_of(D);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

template <int D, typename Kernel, typename... Args>
cudaError_t launch_tiles(Kernel kernel, int64_t tiles, size_t smem, cudaStream_t stream,
                         Args... args) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = tile_config<D>(tiles, smem, stream, attr);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// registers, local bytes, shared bytes, threads, blocks an SM, blocks a
// cluster and (above D 128) clusters the card holds at once of the dK/dV
// (which % 2 = 0) or dQ (which % 2 = 1) kernel, of the fp32 (which < 2) or
// bf16 (which >= 2) instance
template <int D, typename T>
int resources(int which, int* out) {
  cudaFuncAttributes a;
  int blocks = 0, clusters = 0;
  const void* fn = which ? (const void*)flash_attention_bwd_dq_kernel<D, T>
                         : (const void*)flash_attention_bwd_dkdv_kernel<D, T>;
  const size_t smem = which ? dq_smem<D>() : dkdv_smem<D>();
  cudaError_t err = prepare<D, T>();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
  if (err == cudaSuccess && split_of(D) > 1) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = tile_config<D>(1024, smem, nullptr, attr);
    err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + smem);
  out[3] = kThreads;
  out[4] = blocks;
  out[5] = split_of(D);
  out[6] = clusters;
  return (int)cudaSuccess;
}

template <int D, typename T>
int launch(const T* q, const T* k, const T* v, const T* out, const float* lse, const T* dout,
           float* delta, float* part, T* dq, T* dk, T* dv, int64_t b, const Shape& sh,
           cudaStream_t stream) {
  cudaError_t err = prepare<D, T>();
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = b * sh.hq * sh.lq;
  flash_attention_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), kThreads, 0, stream>>>(
      out, dout, delta, rows, D);
  const int64_t kt = (sh.lk + kKeys - 1) / kKeys, qt = (sh.lq + kQueries - 1) / kQueries;
  constexpr bool kPerHead = split_of(D) > 1;
  err = launch_tiles<D>(flash_attention_bwd_dkdv_kernel<D, T>,
                        kt * b * (kPerHead ? sh.hq : sh.hkv), dkdv_smem<D>(), stream, q, k, v,
                        dout, lse, (const float*)delta, dk, dv, part, sh);
  if (kPerHead && err == cudaSuccess) {
    const int64_t n4 = b * sh.hkv * sh.lk * D / 4;
    const unsigned grid = (unsigned)std::min<int64_t>((2 * n4 + kThreads - 1) / kThreads, 8192);
    flash_attention_bwd_sum_kernel<T><<<grid, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(part), dk, dv, n4, (int64_t)sh.lk * D / 4,
        sh.hq / sh.hkv, sh.scale);
  }
  if (err == cudaSuccess)
    err = launch_tiles<D>(flash_attention_bwd_dq_kernel<D, T>, qt * b * sh.hq, dq_smem<D>(),
                          stream, q, k, v, dout, lse, (const float*)delta, dq, sh);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int entry(const void* q, const void* k, const void* v, const void* out, const void* lse,
          const void* dout, void* delta, void* part, void* dq, void* dk, void* dv, int64_t b,
          int64_t hq, int64_t hkv, int64_t lq, int64_t lk, int64_t d, int64_t causal,
          int64_t window, double scale, void* stream) {
  if (b <= 0 || hq <= 0 || lq <= 0 || lk <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv || lq > lk || window < 0 || lk > 0x7fffffff ||
      b * hq * ((lq + kQueries - 1) / kQueries) * (d > 128 ? d / kSplitCols : 1) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Shape sh{(int)hq, (int)hkv, (int)lq, (int)lk, (int)causal, (int)window,
                 (float)(scale > 0.0 ? scale : 1.0 / sqrt((double)d))};
  const auto* tq = static_cast<const T*>(q);
  const auto* tk = static_cast<const T*>(k);
  const auto* tv = static_cast<const T*>(v);
  const auto* to = static_cast<const T*>(out);
  const auto* fl = static_cast<const float*>(lse);
  const auto* tg = static_cast<const T*>(dout);
  auto* fd = static_cast<float*>(delta);
  auto* fp = static_cast<float*>(part);
  auto* gq = static_cast<T*>(dq);
  auto* gk = static_cast<T*>(dk);
  auto* gv = static_cast<T*>(dv);
  const auto s = (cudaStream_t)stream;
  switch (d) {
    case 32: return launch<32, T>(tq, tk, tv, to, fl, tg, fd, fp, gq, gk, gv, b, sh, s);
    case 64: return launch<64, T>(tq, tk, tv, to, fl, tg, fd, fp, gq, gk, gv, b, sh, s);
    case 128: return launch<128, T>(tq, tk, tv, to, fl, tg, fd, fp, gq, gk, gv, b, sh, s);
    case 256: return launch<256, T>(tq, tk, tv, to, fl, tg, fd, fp, gq, gk, gv, b, sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int resources_of(int64_t d, int which, int* out) {
  switch (d) {
    case 32: return resources<32, T>(which, out);
    case 64: return resources<64, T>(which, out);
    case 128: return resources<128, T>(which, out);
    case 256: return resources<256, T>(which, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// delta is [B, Hq, Lq] scratch; part [2, B, Hq, Lk, D] fp32 scratch above D 128 (the
// q heads' shares of dk and dv), unread below; window 0 means none; causal 0 or 1;
// scale <= 0 means D^-0.5 (the forward's).
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* out, const void* lse, const void* dout,
                                       void* delta, void* part, void* dq, void* dk, void* dv,
                                       int64_t b,
                                       int64_t hq, int64_t hkv, int64_t lq, int64_t lk,
                                       int64_t d, int64_t causal, int64_t window,
                                       double scale, void* stream) {
  return entry<float>(q, k, v, out, lse, dout, delta, part, dq, dk, dv, b, hq, hkv, lq, lk, d,
                      causal, window, scale, stream);
}

// The same with q, k, v, out, dout, dq, dk, dv in bf16 (lse, delta, part fp32).
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* out, const void* lse, const void* dout,
                                        void* delta, void* part, void* dq, void* dk, void* dv,
                                        int64_t b,
                                        int64_t hq, int64_t hkv, int64_t lq, int64_t lk,
                                        int64_t d, int64_t causal, int64_t window,
                                        double scale, void* stream) {
  return entry<bf16>(q, k, v, out, lse, dout, delta, part, dq, dk, dv, b, hq, hkv, lq, lk, d,
                     causal, window, scale, stream);
}

// For reports: out[7] = registers, local bytes, shared bytes, threads, blocks an
// SM, blocks a cluster, clusters at once (0 below D 256) of the dK/dV (which 0)
// or dQ (which 1) kernel at head dim d, fp32; which 2 and 3 the bf16 instance's.
extern "C" int flash_attention_bwd_resources(int64_t d, int64_t which, int* out) {
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  return which < 2 ? resources_of<float>(d, (int)which, out)
                   : resources_of<bf16>(d, (int)which - 2, out);
}
