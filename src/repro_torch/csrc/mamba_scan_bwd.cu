// The gradient of the Mamba-1 selective scan for Hopper.
//
// Replaces: no TPU kernel.  The reference differentiates its jnp scan
// (src/repro/models/mamba.py::selective_scan) with XLA; its Pallas kernel
// (src/repro/kernels/mamba_scan.py) has no backward.  This is the gradient of
// mamba_scan.cu's scan: with A = -exp(log_a), a_t = exp(dt_t A) and s from 0,
//   s_t = a_t * s_{t-1} + (dt_t x_t) B_t,   y_t = s_t . C_t.
// The adjoint g of s starts at dstate; each step back adds y_t's share,
// g_t += dy_t C_t, and passes a_t * g_t on.  Then, per channel i and state n,
//   dC_t[n] = sum_i dy_t[i] s_t[i][n]      dB_t[n] = sum_i g_t[i][n] dt_t[i] x_t[i]
//   dx_t[i] = dt_t[i] sum_n g_t[i][n] B_t[n]
//   ddt_t[i] = sum_n g_t[i][n] (x_t[i] B_t[n] + A[i][n] a_t[i][n] s_{t-1}[i][n])
//   dlog_a[i][n] = A[i][n] sum_t g_t[i][n] dt_t[i] a_t[i][n] s_{t-1}[i][n],
// written per batch row [B, di, ds]: the wrapper sums the rows, so that a
// per-example gradient can keep them apart.
//
// dt, x, dy [B, L, di]; B, C [B, L, ds]; log_a [di, ds]; dstate [B, di, ds];
// ckpt [B, ceil(L / kSteps), di, ds], the states the forward wrote before
// every kSteps-th step (mamba_scan.cu, asked for them); all fp32.  ddt, dx
// [B, L, di], dB, dC [B, L, ds], dlog_a [B, di, ds]; part_b, part_c
// [ceil(di / channels a block), B, L, ds] scratch.  1 <= ds <= 32.
//
// Bound: at Jamba-1.5-Large's shape (B 2, L 512, di 16384, ds 16) the gradient
// must read dt, x, dy and write ddt, dx (336 MB; B, C, dB, dC, log_a, dlog_a
// and dstate add 4 MB): 0.1021 ms at an H100 SXM's 3.35 TB/s.  Each state
// entry a step needs one exp (a_t) and about 19 flops: 268 M exps, 0.064 ms on
// the special-function unit, and 5.1 GFLOP, 0.076 ms at 67 TFLOP/s.  So the
// bytes bound holds.  The checkpoints (67 MB read) and the blocks' partials
// of dB and dC (67 MB written and read at 32 channels a block) are this
// design's.
//
// Design.  The recurrence is not inverted: s_{t-1} = (s_t - dt x B) / a_t is
// unusable where a_t underflows to 0 in fp32.  The walk goes over the
// forward's 16-step stages last to first and recomputes each stage's states
// from its checkpoint with the forward's arithmetic (ex2.approx of dt * A
// log2 e, an FMA), so they are the forward's bits.
// - A channel's states are split over G threads in G warps (the same lane),
//   4 states a thread: ds <= 4 takes 1 thread, <= 8 2, <= 16 4, <= 32 8.  A
//   block has 128 threads (256 at G = 8) and 128 / G channels (32 at G = 8).
// - One exp an entry: a whole stage runs unrolled, and each entry's decay
//   a_t stays in registers from the recompute to the walk back (64 a
//   thread); the states, which the walk reads once each, wait in shared
//   memory as one 16-byte slot a thread a step.
// - The stage's dt, x, dy, B and C come through a two-stage cp.async ring
//   that runs backwards: stage c - 1 is in flight while stage c walks, and
//   its checkpoint is loaded into registers then too.  A last, ragged stage
//   reads zeros past L (dt = 0: a step that changes nothing).
// - Sums over a channel's states (dx, ddt) are deferred: each thread leaves
//   its share of a step in its state slot of that step, which the walk has
//   read, and after the stage the block adds the G shares in order.  Sums
//   over channels (dB, dC) reduce within a warp, by a butterfly that halves
//   the values it carries at each of the first steps (8 values over 32
//   lanes in 9 shuffles), with no step waiting on it; after the stage the
//   block adds a slice's warps in order into a per-block partial.
// - A second kernel adds the blocks' partials of each output in block order:
//   a block of 8 warps takes 32 outputs, each warp a contiguous run of the
//   blocks (coalesced), and the warps' sums are added in warp order; 1,024
//   blocks at Jamba's shape.  No atomics: two launches are bit-equal.
// - Occupancy at ds 16: 16 KB of ring, 34 KB of states and 2 KB of warp sums
//   in shared memory, at most 128 registers (the decays take 64): 4 blocks
//   of 4 warps an SM, so Jamba's 1,024 blocks run in two waves (at 3 blocks
//   an SM, 167 registers, the walk ran a fifth slower on the card: PERF.md).
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// are passed as void*, sizes as int64.  The entry point returns
// cudaGetLastError() after the launches, so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 16;                  // steps a checkpoint: mamba_scan.cu's stage
constexpr int kThreadsB = 128;              // threads a block, or 32 G where G > 4
constexpr int kPer = 4;                     // states a thread
constexpr int kReduceWarps = 8;             // warps a block of the partials' sum
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// v[N] on each lane (N a power of 2 up to 32); after it, v[0] is the sum over
// the warp's 32 lanes of element lane / (32 / N), the same on each of the 32 / N
// lanes that hold it.  The first log2 N steps send half the values each.
template <int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  int m = 16;
#pragma unroll
  for (int n = N; n > 1; n >>= 1, m >>= 1) {
    const bool upper = lane & m;
#pragma unroll
    for (int k = 0; k < n / 2; ++k) {
      const float send = upper ? v[k] : v[k + n / 2];
      const float keep = upper ? v[k + n / 2] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
#pragma unroll
  for (; m >= 1; m >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
}

template <int G>
struct Smem {
  static constexpr int kThreads = G <= 4 ? kThreadsB : 32 * G;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kChan = kThreads / G;       // channels a block
  static constexpr int kDs = G * kPer;
  struct Stage {
    float dt[kSteps][kChan], x[kSteps][kChan], dy[kSteps][kChan];
    float b[kSteps][kDs], c[kSteps][kDs];
  };
  Stage in[2];
  float4 st[kSteps + 1][kThreads];                 // s before and after each step
  float red[kWarps][kSteps][2 * kPer];             // each warp's dC and dB
};

template <int G>
__global__ void __launch_bounds__(Smem<G>::kThreads, G <= 4 ? 4 : 1)
mamba_scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                      const float* __restrict__ cm, const float* __restrict__ x,
                      const float* __restrict__ log_a, const float* __restrict__ ckpt,
                      const float* __restrict__ dy, const float* __restrict__ dstate,
                      float* __restrict__ ddt, float* __restrict__ dx,
                      float* __restrict__ dlog_a, float* __restrict__ part_b,
                      float* __restrict__ part_c, int l, int di, int ds, bool vec) {
  using S = Smem<G>;
  constexpr int kChan = S::kChan, kT = S::kThreads, kWarps = S::kWarps;
  constexpr int kRed = 2 * kPer, kLanes = 32 / kRed;
  extern __shared__ float4 smem4[];
  S& sm = *reinterpret_cast<S*>(smem4);
  const int64_t b = blockIdx.y, bsz = gridDim.y;
  const int ch0 = blockIdx.x * kChan;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = w % G, cl = (w / G) * 32 + lane;
  const int i = ch0 + cl;
  const bool live = i < di;
  const int nc = (l + kSteps - 1) / kSteps;

  {  // zero the ring: states past ds, channels past di and steps past L read 0
    float4* ring = reinterpret_cast<float4*>(sm.in);
    for (int k = tid; k < (int)(sizeof(sm.in) / sizeof(float4)); k += kT)
      ring[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float A[kPer], a2[kPer], gg[kPer], dA[kPer];
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int nn = g * kPer + n;
    const bool ok = live && nn < ds;
    A[n] = ok ? -expf(log_a[(int64_t)i * ds + nn]) : 0.0f;
    a2[n] = A[n] * kLog2e;                  // the forward's exponent scale, bit for bit
    gg[n] = ok ? dstate[(b * di + i) * ds + nn] : 0.0f;
    dA[n] = 0.0f;
  }
  __syncthreads();                          // zeros in before any copy lands

  auto load_stage = [&](int c, int buf) {
    typename S::Stage& in = sm.in[buf];
    const int t0 = c * kSteps, nt = min(kSteps, l - t0);
    const int64_t row0 = b * l + t0;
    if (vec) {
      constexpr int kQuads = kChan / 4;
      for (int idx = tid; idx < nt * kQuads; idx += kT) {
        const int t = idx / kQuads, j = 4 * (idx % kQuads);
        if (ch0 + j < di) {
          const int64_t off = (row0 + t) * di + ch0 + j;
          cp_async16(&in.dt[t][j], dt + off);
          cp_async16(&in.x[t][j], x + off);
          cp_async16(&in.dy[t][j], dy + off);
        }
      }
      const int quads = ds / 4;
      for (int idx = tid; idx < nt * quads; idx += kT) {
        const int t = idx / quads, n = 4 * (idx % quads);
        const int64_t off = (row0 + t) * ds + n;
        cp_async16(&in.b[t][n], bm + off);
        cp_async16(&in.c[t][n], cm + off);
      }
    } else {
      for (int idx = tid; idx < nt * kChan; idx += kT) {
        const int t = idx / kChan, j = idx % kChan;
        if (ch0 + j < di) {
          const int64_t off = (row0 + t) * di + ch0 + j;
          cp_async4(&in.dt[t][j], dt + off);
          cp_async4(&in.x[t][j], x + off);
          cp_async4(&in.dy[t][j], dy + off);
        }
      }
      for (int idx = tid; idx < nt * ds; idx += kT) {
        const int t = idx / ds, n = idx % ds;
        const int64_t off = (row0 + t) * ds + n;
        cp_async4(&in.b[t][n], bm + off);
        cp_async4(&in.c[t][n], cm + off);
      }
    }
    cp_async_commit();
  };
  auto load_ckpt = [&](int c, float (&s)[kPer]) {
#pragma unroll
    for (int n = 0; n < kPer; ++n) {
      const int nn = g * kPer + n;
      s[n] = (live && nn < ds) ? ckpt[((b * nc + c) * di + i) * ds + nn] : 0.0f;
    }
  };

  float cur[kPer], nxt[kPer];
  if (nc > 0) {
    load_stage(nc - 1, (nc - 1) & 1);
    load_ckpt(nc - 1, cur);
  }
  for (int c = nc - 1; c >= 0; --c) {
    const int buf = c & 1, t0 = c * kSteps, nt = min(kSteps, l - t0);
    const int64_t row0 = b * l + t0;
    cp_async_wait_all();
    __syncthreads();                        // stage c landed; stage c + 1's buffer and sums read
    if (c > 0) {
      load_stage(c - 1, buf ^ 1);
      load_ckpt(c - 1, nxt);
    }
    const typename S::Stage& in = sm.in[buf];
    float s[kPer], dec[kSteps][kPer];
#pragma unroll
    for (int n = 0; n < kPer; ++n) s[n] = cur[n];
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {      // the stage's states and decays, recomputed
      const float dtv = in.dt[t][cl];
      const float drive = dtv * in.x[t][cl];
      const float4 b4 = *reinterpret_cast<const float4*>(&in.b[t][g * kPer]);
      const float bv[kPer] = {b4.x, b4.y, b4.z, b4.w};
      sm.st[t][tid] = make_float4(s[0], s[1], s[2], s[3]);
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        dec[t][n] = ex2_approx(dtv * a2[n]);
        s[n] = fmaf(dec[t][n], s[n], drive * bv[n]);
      }
    }
    sm.st[kSteps][tid] = make_float4(s[0], s[1], s[2], s[3]);
#pragma unroll
    for (int t = kSteps - 1; t >= 0; --t) { // the walk back; s holds s_t
      const float dtv = in.dt[t][cl], xv = in.x[t][cl], dyv = in.dy[t][cl];
      const float dtx = dtv * xv;
      const float4 b4 = *reinterpret_cast<const float4*>(&in.b[t][g * kPer]);
      const float4 c4 = *reinterpret_cast<const float4*>(&in.c[t][g * kPer]);
      const float4 p4 = sm.st[t][tid];
      const float bv[kPer] = {b4.x, b4.y, b4.z, b4.w}, cv[kPer] = {c4.x, c4.y, c4.z, c4.w};
      const float prev[kPer] = {p4.x, p4.y, p4.z, p4.w};
      float v[kRed], pbs = 0.0f, pas = 0.0f;
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        gg[n] = fmaf(dyv, cv[n], gg[n]);    // g_t: y_t's share added
        v[n] = dyv * s[n];                  // dC
        v[kPer + n] = gg[n] * dtx;          // dB
        pbs = fmaf(gg[n], bv[n], pbs);
        const float gds = gg[n] * dec[t][n] * prev[n];
        pas = fmaf(gds, A[n], pas);
        dA[n] = fmaf(gds, dtv, dA[n]);
        gg[n] *= dec[t][n];                 // g_{t-1}, before y_{t-1}'s share
        s[n] = prev[n];
      }
      // the slot of s_t is read: it takes this step's shares of dx and ddt
      *reinterpret_cast<float2*>(&sm.st[t + 1][tid]) = make_float2(pbs, pas);
      reduce_scatter<kRed>(v, lane);
      if (lane % kLanes == 0) sm.red[w][t][lane / kLanes] = v[0];
    }
    __syncthreads();                        // every slice's and warp's sums are in
    for (int idx = tid; idx < nt * kChan; idx += kT) {
      const int t = idx / kChan, j = idx % kChan, ch = ch0 + j;
      if (ch < di) {
        const float4* slot = &sm.st[t + 1][(j / 32) * G * 32 + j % 32];
        float sb = slot[0].x, sa = slot[0].y;
#pragma unroll
        for (int q = 1; q < G; ++q) {
          sb += slot[32 * q].x;
          sa += slot[32 * q].y;
        }
        const int64_t off = (row0 + t) * di + ch;
        ddt[off] = fmaf(in.x[t][j], sb, sa);
        dx[off] = in.dt[t][j] * sb;
      }
    }
    for (int idx = tid; idx < nt * ds; idx += kT) {
      const int t = idx / ds, n = idx % ds, q0 = n / kPer, nl = n % kPer;
      float sc = sm.red[q0][t][nl], sb = sm.red[q0][t][kPer + nl];
      for (int ww = q0 + G; ww < kWarps; ww += G) {   // the slice's warps, in order
        sc += sm.red[ww][t][nl];
        sb += sm.red[ww][t][kPer + nl];
      }
      const int64_t off = ((blockIdx.x * bsz + b) * l + t0 + t) * ds + n;
      part_c[off] = sc;
      part_b[off] = sb;
    }
#pragma unroll
    for (int n = 0; n < kPer; ++n) cur[n] = nxt[n];
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < kPer; ++n) {
      const int nn = g * kPer + n;
      if (nn < ds) dlog_a[(b * di + i) * ds + nn] = dA[n] * A[n];
    }
  }
}

// dB and dC: the blocks' partials [nbx][n] added in block order.  Block
// (x, y) takes outputs 32 x .. 32 x + 31 of dB (y 0) or dC (y 1); warp w adds
// blocks w * per .. (w + 1) * per - 1 of them, and warp 0 adds the warps' sums
// in warp order.
__global__ void __launch_bounds__(32 * kReduceWarps)
mamba_scan_bwd_reduce_kernel(const float* __restrict__ part_b, const float* __restrict__ part_c,
                             float* __restrict__ db, float* __restrict__ dc, int nbx,
                             int64_t n) {
  __shared__ float acc[kReduceWarps][32];
  const float* part = blockIdx.y ? part_c : part_b;
  float* out = blockIdx.y ? dc : db;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t idx = (int64_t)blockIdx.x * 32 + lane;
  const int per = (nbx + kReduceWarps - 1) / kReduceWarps;
  const int q0 = w * per, q1 = min(nbx, q0 + per);
  float s = 0.0f;
  if (idx < n) {
#pragma unroll 8
    for (int q = q0; q < q1; ++q) s += part[(int64_t)q * n + idx];
  }
  acc[w][lane] = s;
  __syncthreads();
  if (w == 0 && idx < n) {
    float t = acc[0][lane];
#pragma unroll
    for (int q = 1; q < kReduceWarps; ++q) t += acc[q][lane];
    out[idx] = t;
  }
}

// Set the instance's shared memory limit and carveout, once, so that no
// launch inside a CUDA-graph capture sets them.
template <int G>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(mamba_scan_bwd_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sizeof(Smem<G>));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(mamba_scan_bwd_kernel<G>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

// parts: 1 the walk, 2 the partials' sum, 3 both (the gradient)
template <int G>
int launch(const void* dt, const void* bm, const void* cm, const void* x, const void* log_a,
           const void* ckpt, const void* dy, const void* dstate, void* ddt, void* db,
           void* dc, void* dx, void* dlog_a, void* part_b, void* part_c, int64_t bsz,
           int64_t l, int64_t di, int64_t ds, void* stream, int parts) {
  using S = Smem<G>;
  cudaError_t err = prepare<G>();
  if (err != cudaSuccess) return (int)err;
  const int nbx = (int)((di + S::kChan - 1) / S::kChan);
  if (parts & 1) {
    const bool aligned = ((reinterpret_cast<uintptr_t>(dt) | reinterpret_cast<uintptr_t>(x) |
                           reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(bm) |
                           reinterpret_cast<uintptr_t>(cm)) & 15) == 0;
    const bool vec = aligned && di % 4 == 0 && ds % 4 == 0;
    const dim3 grid((unsigned)nbx, (unsigned)bsz);
    mamba_scan_bwd_kernel<G><<<grid, S::kThreads, sizeof(S), (cudaStream_t)stream>>>(
        static_cast<const float*>(dt), static_cast<const float*>(bm),
        static_cast<const float*>(cm), static_cast<const float*>(x),
        static_cast<const float*>(log_a), static_cast<const float*>(ckpt),
        static_cast<const float*>(dy), static_cast<const float*>(dstate),
        static_cast<float*>(ddt), static_cast<float*>(dx), static_cast<float*>(dlog_a),
        static_cast<float*>(part_b), static_cast<float*>(part_c), (int)l, (int)di, (int)ds,
        vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t n = bsz * l * ds;
  if ((parts & 2) && n > 0) {
    const dim3 grid((unsigned)((n + 31) / 32), 2);
    mamba_scan_bwd_reduce_kernel<<<grid, 32 * kReduceWarps, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(part_b), static_cast<const float*>(part_c),
        static_cast<float*>(db), static_cast<float*>(dc), nbx, n);
  }
  return (int)cudaGetLastError();
}

template <int G>
int resources(int* out) {
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t err = prepare<G>();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, mamba_scan_bwd_kernel<G>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, mamba_scan_bwd_kernel<G>, Smem<G>::kThreads, sizeof(Smem<G>));
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + sizeof(Smem<G>));
  out[3] = Smem<G>::kThreads;
  out[4] = blocks;
  out[5] = Smem<G>::kChan;
  return (int)cudaSuccess;
}

int dispatch(const void* dt, const void* bm, const void* cm, const void* x, const void* log_a,
             const void* ckpt, const void* dy, const void* dstate, void* ddt, void* db,
             void* dc, void* dx, void* dlog_a, void* part_b, void* part_c, int64_t bsz,
             int64_t l, int64_t di, int64_t ds, void* stream, int parts) {
  if (bsz <= 0 || di <= 0) return (int)cudaSuccess;
  if (l < 0 || ds < 1 || ds > 32 || bsz > 65535 || l > 0x7fffffff || di > 0x7fffffff ||
      bsz * l * ds > 0x7fffffffLL * 16)
    return (int)cudaErrorInvalidValue;
  if (ds <= 4)
    return launch<1>(dt, bm, cm, x, log_a, ckpt, dy, dstate, ddt, db, dc, dx, dlog_a, part_b,
                     part_c, bsz, l, di, ds, stream, parts);
  if (ds <= 8)
    return launch<2>(dt, bm, cm, x, log_a, ckpt, dy, dstate, ddt, db, dc, dx, dlog_a, part_b,
                     part_c, bsz, l, di, ds, stream, parts);
  if (ds <= 16)
    return launch<4>(dt, bm, cm, x, log_a, ckpt, dy, dstate, ddt, db, dc, dx, dlog_a, part_b,
                     part_c, bsz, l, di, ds, stream, parts);
  return launch<8>(dt, bm, cm, x, log_a, ckpt, dy, dstate, ddt, db, dc, dx, dlog_a, part_b,
                   part_c, bsz, l, di, ds, stream, parts);
}

}  // namespace

// 1 <= ds <= 32; threads a channel (4 states each): ds <= 4: 1, <= 8: 2,
// <= 16: 4, <= 32: 8.  part_b and part_c hold ceil(di / channels a block)
// blocks' partials (mamba_scan_bwd_resources).  Two kernels; one launch
// counted by the wrapper.
extern "C" int mamba_scan_bwd_f32(const void* dt, const void* bm, const void* cm,
                                  const void* x, const void* log_a, const void* ckpt,
                                  const void* dy, const void* dstate, void* ddt, void* db,
                                  void* dc, void* dx, void* dlog_a, void* part_b,
                                  void* part_c, int64_t bsz, int64_t l, int64_t di,
                                  int64_t ds, void* stream) {
  return dispatch(dt, bm, cm, x, log_a, ckpt, dy, dstate, ddt, db, dc, dx, dlog_a, part_b,
                  part_c, bsz, l, di, ds, stream, 3);
}

// The walk kernel alone and the partials' sum alone, for timing each apart.
extern "C" int mamba_scan_bwd_walk_f32(const void* dt, const void* bm, const void* cm,
                                       const void* x, const void* log_a, const void* ckpt,
                                       const void* dy, const void* dstate, void* ddt, void* db,
                                       void* dc, void* dx, void* dlog_a, void* part_b,
                                       void* part_c, int64_t bsz, int64_t l, int64_t di,
                                       int64_t ds, void* stream) {
  return dispatch(dt, bm, cm, x, log_a, ckpt, dy, dstate, ddt, db, dc, dx, dlog_a, part_b,
                  part_c, bsz, l, di, ds, stream, 1);
}

extern "C" int mamba_scan_bwd_reduce_f32(const void* dt, const void* bm, const void* cm,
                                         const void* x, const void* log_a, const void* ckpt,
                                         const void* dy, const void* dstate, void* ddt,
                                         void* db, void* dc, void* dx, void* dlog_a,
                                         void* part_b, void* part_c, int64_t bsz, int64_t l,
                                         int64_t di, int64_t ds, void* stream) {
  return dispatch(dt, bm, cm, x, log_a, ckpt, dy, dstate, ddt, db, dc, dx, dlog_a, part_b,
                  part_c, bsz, l, di, ds, stream, 2);
}

// For reports: the instance that takes ds; out[6] = registers, local bytes,
// shared bytes, threads, blocks an SM, channels a block.
extern "C" int mamba_scan_bwd_resources(int64_t ds, int* out) {
  if (ds < 1 || ds > 32) return (int)cudaErrorInvalidValue;
  if (ds <= 4) return resources<1>(out);
  if (ds <= 8) return resources<2>(out);
  if (ds <= 16) return resources<4>(out);
  return resources<8>(out);
}
