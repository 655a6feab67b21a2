// The gradient of the RWKV-6 WKV recurrence for Hopper.
//
// Replaces: no TPU kernel.  The reference differentiates its jnp scan
// (src/repro/models/rwkv6.py::wkv_scan) with XLA; its Pallas kernel
// (src/repro/kernels/rwkv6_scan.py) has no backward.  This is the gradient of
// rwkv6_scan.cu's recurrence, from S = 0:
//   out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T.
// With the adjoint G_t of S_t, G_{L-1} = dstate, G_{t-1} = diag(w_t) G_t + r_t dout_t^T:
//   dr_t = (S_{t-1} + diag(u) k_t v_t^T) dout_t      dk_t = G_t v_t + u * r_t (v_t . dout_t)
//   dv_t = G_t^T k_t + (sum_i u_i r_t,i k_t,i) dout_t  dw_t = rowsum(G_t * S_{t-1})
//   du   = sum_t r_t * k_t (v_t . dout_t), written per (batch, head): the wrapper sums
//          the batch rows, so that a per-example gradient can keep them apart.
//
// r, k, v, w, dout [B, H, L, D] fp32; u [H, D]; dstate [B, H, D, D]; ckpt
// [B, H, ceil(L / kSteps), D, D], the states the forward wrote before every
// kSteps-th step (rwkv6_scan.cu, asked for them); all 16-byte aligned.  dr,
// dk, dv, dw [B, H, L, D] and du [B, H, D] fp32.  D 32 or 64.
//
// Bound: at rwkv6-7b's training shape (B 2, H 64, L 1024, D 64) the gradient
// must read r, k, v, w, dout and write dr, dk, dv, dw (302 MB; u, dstate and
// du are small): 0.0908 ms at an H100 SXM's 3.35 TB/s.  Each state entry a step
// takes 14 flops: the state recomputed (k v, an FMA), the adjoint's update
// (r dout, an FMA) and four FMAs for dr, dk, dv, dw: 7.5 GFLOP.  These are
// products (S dout, G v, G^T k, rowsum(G * S)), which a chunked form runs on
// the tensor cores: at three TF32 products a flop (165 TFLOP/s, as the
// attention backward is priced) they take 46 us, so the bytes bound holds.
// This design's FMAs outside the tensor cores (67 TFLOP/s) take 112 us: its
// floor, not the function's.  The checkpoints (134 MB read) are this
// design's too.
//
// Design.  The recurrence is not inverted: S_{t-1} = (S_t - k_t v_t^T) / w_t is
// unusable where w_t reaches 0 in fp32.  The backward walks the forward's
// 16-step stages last to first and recomputes each one's states from its
// checkpoint with the forward's arithmetic (S = fma(w, S, k v): the forward's
// bits).  No state goes to global memory or L2 (the first design's scratch
// area cost 0.43 of its 1.13 ms on the card: PERF.md):
// - Each entry of S and of G evolves on its own; only the sums cross entries
//   (dr, dk, dw over a row's columns, dv over a column's rows).  So a (batch,
//   head)'s D rows are split over D / 32 blocks of 32 rows, a thread-block
//   cluster (2 at D 64: 256 blocks of 256 threads at the training shape, 2
//   an SM, all in one wave).  A thread holds a 2 x 4 tile of S and of G, a
//   warp 16 rows by 16 columns.  (Clusters of 4 blocks of 16 rows, 4 an SM,
//   held 124 of the shape's 128 clusters at once: a second wave.)
// - Sub-stages of 8 steps: the 8 states a thread's tile takes before the
//   steps of a sub-stage are recomputed into registers, fully unrolled, and
//   walked back from there; the first half of a stage is recomputed twice
//   (1.5 recomputes a step, a cheap share of the arithmetic).
// - A step's sums leave the thread through shuffles: a row's over the warp's
//   4 column groups, a column's over its 8 row groups, each a fixed tree.
//   The column warps' shares of dr, dk, dw go to shared memory and are added
//   in order after the sub-stage, so each block writes its own rows.  A
//   column's dv is a sum over every row: each warp stores its share straight
//   into the shared memory of the rank that owns the column (st.async to
//   distributed shared memory, counted by the owner's mbarrier), as each
//   block does its rows' share of sum_i u_i r_i k_i, and the owner adds the
//   shares in row order once its mbarrier's phase completes.  A relaxed
//   cluster barrier a sub-stage keeps a rank from refilling a buffer that
//   another still reads (the release form, a GPU-wide memory barrier in
//   the SASS, is slower: probe_scan_bwd.py times both).
// - A stage's inputs (the block's rows of r, k, w, every column of v and
//   dout, its checkpoint rows) come through a two-stage cp.async ring: stage
//   c - 1 is in flight while stage c walks back.  A last, ragged stage is
//   padded with steps that change nothing (w = 1, r = k = v = dout = 0).
// - du is a register sum over the steps, last to first, of the row's
//   owner.  No atomics, every sum in a fixed order: two launches are
//   bit-equal.  At D 64: at most 128 registers (the 8 states take 64), 45 KB
//   of stages and 32 KB of sums in shared memory.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// are passed as void*, sizes as int64.  The entry point returns
// cudaGetLastError() after the launch, so a refused launch is reported.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cgrp = cooperative_groups;

constexpr int kSteps = 16;                  // steps a checkpoint: rwkv6_scan.cu's stage
constexpr int kSub = 8;                     // steps a sub-stage, its states in registers
static_assert(kSteps % (2 * kSub) == 0, "an even number of sub-stages a stage");
constexpr int kRows = 32;                   // state rows a block of the cluster
constexpr int kRowWarps = kRows / 16;       // a warp holds 16 rows x 16 columns
constexpr int kCols = 4;                    // state columns a thread holds (and 2 rows)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
// The cluster barrier.  Its release form waits for every memory access of
// the thread to be visible GPU-wide (MEMBAR.ALL.GPU); the relaxed arrive
// orders nothing, and serves once a sub-stage only to keep a rank from
// refilling a buffer that another rank still reads: a rank passes the
// barrier of sub-stage k + 1 only after every rank has walked it, and so
// has read sub-stage k's buffers (their values were used).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// the address of this block's shared p in the shared memory of cluster rank `rank`
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}
// The data a rank sends another: st.async stores into the other's shared
// memory, each counted against the receiver's mbarrier of that buffer, which
// the receiver waits on; a rank's own shares are plain stores.
__device__ __forceinline__ void st_async_if(unsigned addr, float x, unsigned mbar, bool on) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n"
               " @p st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n}\n"
               ::"r"(addr), "f"(x), "r"(mbar), "r"((int)on));
}
__device__ __forceinline__ void st_shared_if(unsigned addr, float x, bool on) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n @p st.shared.f32 [%0], %1;\n}\n"
               ::"r"(addr), "f"(x), "r"((int)on));
}
__device__ __forceinline__ void mbar_init(unsigned mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar));
}
// this phase's one arrival, and the bytes the other ranks send in it
__device__ __forceinline__ void mbar_expect(unsigned mbar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(mbar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned mbar, unsigned parity) {
  unsigned done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
  } while (!done);
}

template <int D>
struct Smem {
  static constexpr int kRanks = D / kRows;  // blocks a (batch, head): the cluster
  static constexpr int kColWarps = D / 16;
  static constexpr int kWarps = kRowWarps * kColWarps;
  static constexpr int kThreads = 32 * kWarps;
  struct Stage {
    float r[kSteps][kRows], k[kSteps][kRows], w[kSteps][kRows];  // the block's rows
    float v[kSteps][D], dout[kSteps][D];                          // every column
    float ck[kRows][D];                                           // the checkpoint's rows
  };
  Stage in[2];
  struct RowShares {                        // dr, dk or dw: each column warp's share
    float s[kSub][kColWarps][kRows];
    float pad[8];                           // dr's and dw's shares a step on other banks
  } rowp[2][3];
  // dv of the block's columns: each rank's row warps' shares, which the
  // ranks store here; and each rank's share of sum_i u_i r_i k_i, by stage
  float dvp[2][kSub][kRanks][kRowWarps][kRows];
  float ruk[2][kRanks][kSteps];
  float vd[kSteps];                         // v_t . dout_t
  float u[kRows];
  unsigned long long mbar[2];               // the other ranks' stores into dvp[par] (and ruk)
};

template <int D>
__global__ void __launch_bounds__(Smem<D>::kThreads, 2)
rwkv6_scan_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const float* __restrict__ ckpt,
                      const float* __restrict__ dout, const float* __restrict__ dstate,
                      float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
                      float* __restrict__ dw, float* __restrict__ du, int h, int l) {
  using S = Smem<D>;
  constexpr int kThreads = S::kThreads, kRanks = S::kRanks, kColWarps = S::kColWarps;
  extern __shared__ float4 smem4[];
  S& sm = *reinterpret_cast<S*>(smem4);
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t bh = blockIdx.x / kRanks;
  const int row0 = rank * kRows;            // the block's first row of S
  // warp (rw, cw) holds rows 16 rw .. and columns 16 cw ..; its thread (rg, q)
  // holds S[i0 + a][j0 + b], a < 2, b < kCols, of the block's rows
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int rw = wp / kColWarps, cw = wp % kColWarps, rg = lane & 7;
  const int i0 = 16 * rw + 2 * rg, j0 = 16 * cw + kCols * (lane >> 3);
  // where a lane's reduced sums go: lanes with bit 4 keep pk[1], pw[0],
  // pw[1], the others pr[0], pr[1], pk[0]; a column's sum, column jv, to
  // the rank that owns it
  const bool up = lane & 16, b2 = lane & 4, b1 = lane & 2;
  const int pair_q = up ? 2 : 0, single_i = up ? i0 + 1 : i0;
  const int jv = j0 + (b2 ? 2 : 0) + (b1 ? 1 : 0), owner = jv / kRows;  // a warp's owner
  const bool dv_mine = owner == rank;
  const unsigned dv_to = dv_mine ? smem_addr(&sm.dvp[0][0][rank][rw][jv % kRows])
                                 : cluster_addr(&sm.dvp[0][0][rank][rw][jv % kRows], owner);
  const unsigned mbar_to = cluster_addr(&sm.mbar[0], owner);
  // the bytes the other ranks send a block a sub-stage (dv's shares), and a
  // stage (their shares of sum u r k)
  constexpr unsigned kDvBytes = (kRanks - 1) * kSub * kRowWarps * kRows * 4;
  constexpr unsigned kRukBytes = (kRanks - 1) * kSteps * 4;
  const int64_t base = bh * l * D;
  const int nc = (l + kSteps - 1) / kSteps;

  float g[2][kCols];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float4 x = *reinterpret_cast<const float4*>(
        dstate + (bh * D + row0 + i0 + a) * D + j0);
    g[a][0] = x.x; g[a][1] = x.y; g[a][2] = x.z; g[a][3] = x.w;
  }
  if (tid < kRows) sm.u[tid] = u[(bh % h) * D + row0 + tid];
  float du_acc = 0.0f;                      // du of row row0 + tid, tid < kRows
  if (tid == 0) {
    mbar_init(smem_addr(&sm.mbar[0]));
    mbar_init(smem_addr(&sm.mbar[1]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive();                         // every rank runs, its mbarriers set, before
  cluster_wait();                           // any stores to it

  // stage c's inputs into in[buf]; steps past L are padded with w = 1 and 0s
  auto stage = [&](int c, int buf) {
    typename S::Stage& st = sm.in[buf];
    const int t0 = c * kSteps, nt = min(kSteps, l - t0);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f), one = make_float4(1.f, 1.f, 1.f, 1.f);
    for (int i = tid; i < kSteps * kRows / 4; i += kThreads) {
      const int t = i / (kRows / 4), q = 4 * (i % (kRows / 4));
      if (t < nt) {
        const int64_t off = base + (int64_t)(t0 + t) * D + row0 + q;
        cp_async16(&st.r[t][q], r + off);
        cp_async16(&st.k[t][q], k + off);
        cp_async16(&st.w[t][q], w + off);
      } else {
        *reinterpret_cast<float4*>(&st.r[t][q]) = zero;
        *reinterpret_cast<float4*>(&st.k[t][q]) = zero;
        *reinterpret_cast<float4*>(&st.w[t][q]) = one;
      }
    }
    for (int i = tid; i < kSteps * D / 4; i += kThreads) {
      const int t = i / (D / 4), q = 4 * (i % (D / 4));
      if (t < nt) {
        const int64_t off = base + (int64_t)(t0 + t) * D + q;
        cp_async16(&st.v[t][q], v + off);
        cp_async16(&st.dout[t][q], dout + off);
      } else {
        *reinterpret_cast<float4*>(&st.v[t][q]) = zero;
        *reinterpret_cast<float4*>(&st.dout[t][q]) = zero;
      }
    }
    const float* ck = ckpt + ((bh * nc + c) * D + row0) * D;
    for (int i = tid; i < kRows * D / 4; i += kThreads)
      cp_async16(&st.ck[0][0] + 4 * i, ck + 4 * i);
    cp_async_commit();
  };

  // one step of the forward's recurrence on the thread's tile
  auto advance = [&](float (&s)[2][kCols], const typename S::Stage& st, int t) {
    const float2 k2 = *reinterpret_cast<const float2*>(&st.k[t][i0]);
    const float2 w2 = *reinterpret_cast<const float2*>(&st.w[t][i0]);
    const float4 v4 = *reinterpret_cast<const float4*>(&st.v[t][j0]);
    const float kk[2] = {k2.x, k2.y}, ww[2] = {w2.x, w2.y}, vv[kCols] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < kCols; ++b) s[a][b] = fmaf(ww[a], s[a][b], kk[a] * vv[b]);
  };

  if (nc > 0) stage(nc - 1, (nc - 1) & 1);
  for (int c = nc - 1; c >= 0; --c) {
    const int buf = c & 1, t0 = c * kSteps, nt = min(kSteps, l - t0);
    cp_async_wait_all();
    __syncthreads();                        // stage c landed; stage c + 1's buffer is free
    if (c > 0) stage(c - 1, buf ^ 1);
    const typename S::Stage& st = sm.in[buf];
    // v_t . dout_t, 4 threads a step; the block's rows' share of
    // sum_i u_i r_i k_i, 2 threads a step, sent to every rank; each a sum
    // of the threads' runs of columns or rows, added by a fixed tree
    if (tid < 4 * kSteps) {
      const int t = tid / 4, j1 = (tid % 4) * (D / 4);
      float acc = 0.0f;
#pragma unroll
      for (int j = j1; j < j1 + D / 4; ++j) acc = fmaf(st.v[t][j], st.dout[t][j], acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (tid % 4 == 0) sm.vd[t] = acc;
    } else if (tid < 6 * kSteps) {
      const int t = (tid - 4 * kSteps) / 2, i1 = (tid % 2) * (kRows / 2);
      float acc = 0.0f;
#pragma unroll
      for (int i = i1; i < i1 + kRows / 2; ++i) acc = fmaf(sm.u[i] * st.r[t][i], st.k[t][i], acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
#pragma unroll
      for (int q = 0; q < kRanks; ++q) {
        if (q == rank)
          st_shared_if(smem_addr(&sm.ruk[buf][rank][t]), acc, tid % 2 == 0);
        else
          st_async_if(cluster_addr(&sm.ruk[buf][rank][t], q), acc,
                      cluster_addr(&sm.mbar[1], q), tid % 2 == 0);
      }
    }

#pragma unroll 1
    for (int hf = kSteps / kSub - 1; hf >= 0; --hf) {
      const int par = hf & 1;               // the sub-stage's buffers of sums
      // the states before the sub-stage's steps, recomputed from the checkpoint
      float s[2][kCols], p[kSub][2][kCols];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float4 x = *reinterpret_cast<const float4*>(&st.ck[i0 + a][j0]);
        s[a][0] = x.x; s[a][1] = x.y; s[a][2] = x.z; s[a][3] = x.w;
      }
#pragma unroll 1
      for (int t = 0; t < kSub * hf; ++t) advance(s, st, t);
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < kCols; ++b) p[j][a][b] = s[a][b];
        if (j + 1 < kSub) advance(s, st, kSub * hf + j);
      }
      // the walk back: G_t, then G_{t-1}
#pragma unroll
      for (int j = kSub - 1; j >= 0; --j) {
        const int t = kSub * hf + j;
        const float2 r2 = *reinterpret_cast<const float2*>(&st.r[t][i0]);
        const float2 k2 = *reinterpret_cast<const float2*>(&st.k[t][i0]);
        const float2 w2 = *reinterpret_cast<const float2*>(&st.w[t][i0]);
        const float4 v4 = *reinterpret_cast<const float4*>(&st.v[t][j0]);
        const float4 d4 = *reinterpret_cast<const float4*>(&st.dout[t][j0]);
        const float rr[2] = {r2.x, r2.y}, kk[2] = {k2.x, k2.y}, ww[2] = {w2.x, w2.y};
        const float vv[kCols] = {v4.x, v4.y, v4.z, v4.w}, dd[kCols] = {d4.x, d4.y, d4.z, d4.w};
        float pr[2] = {0.f, 0.f}, pk[2] = {0.f, 0.f}, pw[2] = {0.f, 0.f};
        float pv[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < kCols; ++b) {
            pr[a] = fmaf(p[j][a][b], dd[b], pr[a]);
            pk[a] = fmaf(g[a][b], vv[b], pk[a]);
            pw[a] = fmaf(g[a][b], p[j][a][b], pw[a]);
            pv[b] = fmaf(g[a][b], kk[a], pv[b]);
            g[a][b] = fmaf(ww[a], g[a][b], rr[a] * dd[b]);
          }
        // rows: the warp's 4 column groups (lane bits 3, 4), a fixed tree
        float x0 = (up ? pk[1] : pr[0]) + __shfl_xor_sync(0xffffffffu, up ? pr[0] : pk[1], 16);
        float x1 = (up ? pw[0] : pr[1]) + __shfl_xor_sync(0xffffffffu, up ? pr[1] : pw[0], 16);
        float x2 = (up ? pw[1] : pk[0]) + __shfl_xor_sync(0xffffffffu, up ? pk[0] : pw[1], 16);
        x0 += __shfl_xor_sync(0xffffffffu, x0, 8);
        x1 += __shfl_xor_sync(0xffffffffu, x1, 8);
        x2 += __shfl_xor_sync(0xffffffffu, x2, 8);
        // columns: the 8 row groups (lane bits 0-2), a fixed tree
        const float y0 = (b2 ? pv[2] : pv[0]) + __shfl_xor_sync(0xffffffffu, b2 ? pv[0] : pv[2], 4);
        const float y1 = (b2 ? pv[3] : pv[1]) + __shfl_xor_sync(0xffffffffu, b2 ? pv[1] : pv[3], 4);
        float z = (b1 ? y1 : y0) + __shfl_xor_sync(0xffffffffu, b1 ? y0 : y1, 2);
        z += __shfl_xor_sync(0xffffffffu, z, 1);
        // every lane stores: the lanes that hold a sum twice store it twice
        *reinterpret_cast<float2*>(&sm.rowp[par][pair_q].s[j][cw][i0]) =
            up ? make_float2(x1, x2) : make_float2(x0, x1);
        sm.rowp[par][1].s[j][cw][single_i] = up ? x0 : x2;
        const unsigned at = dv_to + 4 * ((par * kSub + j) * kRanks * kRowWarps * kRows);
        st_shared_if(at, z, dv_mine && !(lane & 1));
        st_async_if(at, z, mbar_to + 8 * par, !dv_mine && !(lane & 1));
      }
      if (tid == 0)
        mbar_expect(smem_addr(&sm.mbar[par]), kDvBytes + (hf == kSteps / kSub - 1 ? kRukBytes : 0));
      __syncthreads();                      // the block's own shares are in
      cluster_arrive_relaxed();             // ... and the last sub-stage's buffers read
      for (int idx = tid; idx < kSub * kRows; idx += kThreads) {
        const int j = idx / kRows, i = idx % kRows, t = kSub * hf + j;
        if (t < nt) {
          float sr = sm.rowp[par][0].s[j][0][i], sk = sm.rowp[par][1].s[j][0][i];
          float sw = sm.rowp[par][2].s[j][0][i];
#pragma unroll
          for (int q = 1; q < kColWarps; ++q) {
            sr += sm.rowp[par][0].s[j][q][i];
            sk += sm.rowp[par][1].s[j][q][i];
            sw += sm.rowp[par][2].s[j][q][i];
          }
          const float ui = sm.u[i], vdt = sm.vd[t];
          const int64_t off = base + (int64_t)(t0 + t) * D + row0 + i;
          dr[off] = fmaf(ui * st.k[t][i], vdt, sr);
          dk[off] = fmaf(ui * st.r[t][i], vdt, sk);
          dw[off] = sw;
        }
      }
      if (tid < kRows) {
#pragma unroll
        for (int j = kSub - 1; j >= 0; --j) {
          const int t = kSub * hf + j;
          if (t < nt) du_acc = fmaf(st.r[t][tid] * st.k[t][tid], sm.vd[t], du_acc);
        }
      }
      // the other ranks' shares are in: mbar[par] serves once a stage
      mbar_wait(smem_addr(&sm.mbar[par]), (nc - 1 - c) & 1);
      // dv of the block's columns row0 ..: the row warps' shares of each rank,
      // the ranks in order
      for (int idx = tid; idx < kSub * kRows; idx += kThreads) {
        const int j = idx / kRows, c_ = idx % kRows, t = kSub * hf + j;
        if (t < nt) {
          float sv = sm.dvp[par][j][0][0][c_], ruk = sm.ruk[buf][0][t];
#pragma unroll
          for (int q = 1; q < kRowWarps; ++q) sv += sm.dvp[par][j][0][q][c_];
#pragma unroll
          for (int rk = 1; rk < kRanks; ++rk) {
#pragma unroll
            for (int q = 0; q < kRowWarps; ++q) sv += sm.dvp[par][j][rk][q][c_];
            ruk += sm.ruk[buf][rk][t];
          }
          dv[base + (int64_t)(t0 + t) * D + row0 + c_] = fmaf(ruk, st.dout[t][row0 + c_], sv);
        }
      }
      cluster_wait();                       // every rank has read the last sub-stage's buffers
    }
  }
  if (tid < kRows) du[bh * D + row0 + tid] = du_acc;
}

template <int D>
cudaLaunchConfig_t config(unsigned clusters, cudaStream_t stream, cudaLaunchAttribute* attr) {
  using S = Smem<D>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * S::kRanks);
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = sizeof(S);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S::kRanks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Set the instance's shared memory limit and carveout, once, so that no
// launch inside a CUDA-graph capture sets them.
template <int D>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(rwkv6_scan_bwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sizeof(Smem<D>));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(rwkv6_scan_bwd_kernel<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

template <int D>
int resources(int* out) {
  cudaFuncAttributes a;
  int blocks = 0, clusters = 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<D>(128, nullptr, attr);
  cudaError_t err = prepare<D>();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, rwkv6_scan_bwd_kernel<D>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rwkv6_scan_bwd_kernel<D>,
                                                        Smem<D>::kThreads, sizeof(Smem<D>));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, rwkv6_scan_bwd_kernel<D>, &cfg);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + sizeof(Smem<D>));
  out[3] = Smem<D>::kThreads;
  out[4] = blocks;
  out[5] = Smem<D>::kRanks;
  out[6] = clusters;
  return (int)cudaSuccess;
}

template <int D>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* ckpt, const void* dout, const void* dstate, void* dr, void* dk,
           void* dv, void* dw, void* du, int64_t b, int64_t h, int64_t l, void* stream) {
  cudaError_t err = prepare<D>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<D>((unsigned)(b * h), (cudaStream_t)stream, attr);
  err = cudaLaunchKernelEx(&cfg, rwkv6_scan_bwd_kernel<D>,
                           static_cast<const float*>(r), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<const float*>(w),
                           static_cast<const float*>(u), static_cast<const float*>(ckpt),
                           static_cast<const float*>(dout), static_cast<const float*>(dstate),
                           static_cast<float*>(dr), static_cast<float*>(dk),
                           static_cast<float*>(dv), static_cast<float*>(dw),
                           static_cast<float*>(du), (int)h, (int)l);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rwkv6_scan_bwd_f32(const void* r, const void* k, const void* v, const void* w,
                                  const void* u, const void* ckpt, const void* dout,
                                  const void* dstate, void* dr, void* dk, void* dv, void* dw,
                                  void* du, int64_t b, int64_t h, int64_t l, int64_t d,
                                  void* stream) {
  if (b * h <= 0) return (int)cudaSuccess;
  if (l < 0 || b * h > 0x7fffffff / 4 || l > 0x7fffffff) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch<32>(r, k, v, w, u, ckpt, dout, dstate, dr, dk, dv, dw, du, b, h, l,
                               stream);
    case 64: return launch<64>(r, k, v, w, u, ckpt, dout, dstate, dr, dk, dv, dw, du, b, h, l,
                               stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// For reports: out[7] = registers, local bytes, shared bytes, threads, blocks
// an SM, blocks a cluster, clusters the card holds at once.
extern "C" int rwkv6_scan_bwd_resources(int64_t d, int* out) {
  switch (d) {
    case 32: return resources<32>(out);
    case 64: return resources<64>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
