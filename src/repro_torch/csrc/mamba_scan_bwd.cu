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
// [ceil(di / 32), B, L, ds] scratch.  1 <= ds <= 32.
//
// Bound: at Jamba-1.5-Large's shape (B 2, L 512, di 16384, ds 16) the gradient
// must read dt, x, dy and write ddt, dx (336 MB; B, C, dB, dC, log_a, dlog_a
// and dstate add 4 MB): 0.10 ms at an H100 SXM's 3.35 TB/s.  Each state entry
// a step needs one exp (a_t) and about 19 flops: 268 M exps, 0.064 ms on the
// special-function unit, and 5.1 GFLOP, 0.076 ms at 67 TFLOP/s.  So the bytes
// bound holds.  This design takes each exp twice (the forward's recompute and
// the walk back), 0.13 ms of SFU work.
//
// Design, a first one: simple and exact, not yet fast.
// - The recurrence is not inverted: s_{t-1} = (s_t - dt x B) / a_t is
//   unusable where a_t underflows to 0 in fp32.  The walk goes over the
//   stages last to first and recomputes each stage's states from its
//   checkpoint with the forward's arithmetic (ex2.approx of dt * A log2 e, an
//   FMA), so they are the forward's bits; they wait in shared memory, each
//   thread's own, (kSteps + 1) x NPER floats.
// - The forward's split: a channel's ds states over G threads in G warps (the
//   same lane), NPER states each; 128 threads and 128 / G channels a block.
// - Sums over a channel's states (dx, ddt) are deferred through shared memory
//   as the forward's y is.  Sums over channels (dB, dC) reduce first within a
//   warp, by a butterfly that halves the values it carries at each of the
//   first steps (2 NPER values over 32 lanes in 2 NPER - 1 + log2(16 / NPER)
//   shuffles), then over the block's warps of a slice in a fixed order into a
//   per-block partial, and a second kernel adds the blocks' partials in
//   order.  dlog_a sums over the steps in registers.  No atomics: two
//   launches are bit-equal.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// are passed as void*, sizes as int64.  The entry point returns
// cudaGetLastError() after the launches, so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 16;                  // steps a checkpoint: mamba_scan.cu's stage
constexpr int kThreadsB = 128;              // 4 warps
constexpr int kWarps = kThreadsB / 32;
constexpr int kMinChan = 32;                // the fewest channels a block (G = 4)
static_assert(kThreadsB / 4 == kMinChan, "part_b and part_c are sized for kMinChan");
constexpr float kLog2e = 1.4426950408889634f;

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

template <int G, int NPER>
struct Smem {
  static constexpr int kChan = kThreadsB / G;      // channels a block
  static constexpr int kDs = G * NPER;
  float st[kSteps + 1][NPER][kThreadsB];           // s before and after each step
  float dt[kSteps][kChan];
  float x[kSteps][kChan];
  float dy[kSteps][kChan];
  float b[kSteps][kDs];
  float c[kSteps][kDs];
  float pb[G][kSteps][kChan];                      // each slice's sum of g B
  float pa[G][kSteps][kChan];                      // each slice's sum of g a s_{t-1} A
  float red[kWarps][kSteps][2 * NPER];             // each warp's dC and dB
};

template <int G, int NPER>
__global__ void __launch_bounds__(kThreadsB)
mamba_scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                      const float* __restrict__ cm, const float* __restrict__ x,
                      const float* __restrict__ log_a, const float* __restrict__ ckpt,
                      const float* __restrict__ dy, const float* __restrict__ dstate,
                      float* __restrict__ ddt, float* __restrict__ dx,
                      float* __restrict__ dlog_a, float* __restrict__ part_b,
                      float* __restrict__ part_c, int l, int di, int ds) {
  using S = Smem<G, NPER>;
  constexpr int kChan = S::kChan, kDs = S::kDs, kRed = 2 * NPER, kLanes = 32 / kRed;
  extern __shared__ float4 smem4[];
  S& sm = *reinterpret_cast<S*>(smem4);
  const int64_t b = blockIdx.y, bsz = gridDim.y;
  const int ch0 = blockIdx.x * kChan;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = w % G, cl = (w / G) * 32 + lane;
  const int i = ch0 + cl;
  const bool live = i < di;
  const int nc = (l + kSteps - 1) / kSteps;

  float A[NPER], a2[NPER], gg[NPER], dA[NPER];
#pragma unroll
  for (int n = 0; n < NPER; ++n) {
    const int nn = g * NPER + n;
    const bool ok = live && nn < ds;
    A[n] = ok ? -expf(log_a[(int64_t)i * ds + nn]) : 0.0f;
    a2[n] = A[n] * kLog2e;                  // the forward's exponent scale, bit for bit
    gg[n] = ok ? dstate[(b * di + i) * ds + nn] : 0.0f;
    dA[n] = 0.0f;
  }

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kSteps, nt = min(kSteps, l - t0);
    const int64_t row0 = b * l + t0;
    __syncthreads();                        // the last stage's sums are read
    for (int idx = tid; idx < nt * kChan; idx += kThreadsB) {
      const int t = idx / kChan, j = idx % kChan, ch = ch0 + j;
      const int64_t off = (row0 + t) * di + ch;
      const bool in = ch < di;
      sm.dt[t][j] = in ? dt[off] : 0.0f;
      sm.x[t][j] = in ? x[off] : 0.0f;
      sm.dy[t][j] = in ? dy[off] : 0.0f;
    }
    for (int idx = tid; idx < nt * kDs; idx += kThreadsB) {
      const int t = idx / kDs, n = idx % kDs;
      const int64_t off = (row0 + t) * ds + n;
      sm.b[t][n] = n < ds ? bm[off] : 0.0f;
      sm.c[t][n] = n < ds ? cm[off] : 0.0f;
    }
    float s[NPER];
#pragma unroll
    for (int n = 0; n < NPER; ++n) {
      const int nn = g * NPER + n;
      s[n] = (live && nn < ds) ? ckpt[((b * nc + c) * di + i) * ds + nn] : 0.0f;
    }
    __syncthreads();                        // the stage's inputs are in
    for (int t = 0; t < nt; ++t) {          // the stage's states, recomputed
      const float dtv = sm.dt[t][cl];
      const float drive = dtv * sm.x[t][cl];
#pragma unroll
      for (int n = 0; n < NPER; ++n) {
        sm.st[t][n][tid] = s[n];
        s[n] = fmaf(ex2_approx(dtv * a2[n]), s[n], drive * sm.b[t][g * NPER + n]);
      }
    }
#pragma unroll
    for (int n = 0; n < NPER; ++n) sm.st[nt][n][tid] = s[n];
    for (int t = nt - 1; t >= 0; --t) {     // the walk back
      const float dtv = sm.dt[t][cl], xv = sm.x[t][cl], dyv = sm.dy[t][cl];
      const float dtx = dtv * xv;
      float v[kRed], pbs = 0.0f, pas = 0.0f;
#pragma unroll
      for (int n = 0; n < NPER; ++n) {
        const float bv = sm.b[t][g * NPER + n], cv = sm.c[t][g * NPER + n];
        gg[n] = fmaf(dyv, cv, gg[n]);       // g_t: y_t's share added
        v[n] = dyv * sm.st[t + 1][n][tid];  // dC
        v[NPER + n] = gg[n] * dtx;          // dB
        pbs = fmaf(gg[n], bv, pbs);
        const float dec = ex2_approx(dtv * a2[n]);
        const float gds = gg[n] * dec * sm.st[t][n][tid];
        pas = fmaf(gds, A[n], pas);
        dA[n] = fmaf(gds, dtv, dA[n]);
        gg[n] *= dec;                       // g_{t-1}, before y_{t-1}'s share
      }
      sm.pb[g][t][cl] = pbs;
      sm.pa[g][t][cl] = pas;
      reduce_scatter<kRed>(v, lane);
      if (lane % kLanes == 0) sm.red[w][t][lane / kLanes] = v[0];
    }
    __syncthreads();                        // every slice's and warp's sums are in
    for (int idx = tid; idx < nt * kChan; idx += kThreadsB) {
      const int t = idx / kChan, j = idx % kChan, ch = ch0 + j;
      if (ch < di) {
        float sb = sm.pb[0][t][j], sa = sm.pa[0][t][j];
#pragma unroll
        for (int q = 1; q < G; ++q) {
          sb += sm.pb[q][t][j];
          sa += sm.pa[q][t][j];
        }
        const int64_t off = (row0 + t) * di + ch;
        ddt[off] = fmaf(sm.x[t][j], sb, sa);
        dx[off] = sm.dt[t][j] * sb;
      }
    }
    for (int idx = tid; idx < nt * ds; idx += kThreadsB) {
      const int t = idx / ds, n = idx % ds, q0 = n / NPER, nl = n % NPER;
      float sc = 0.0f, sb = 0.0f;
      for (int ww = q0; ww < kWarps; ww += G) {   // the slice's warps, in order
        sc += sm.red[ww][t][nl];
        sb += sm.red[ww][t][NPER + nl];
      }
      const int64_t off = ((blockIdx.x * bsz + b) * l + t0 + t) * ds + n;
      part_c[off] = sc;
      part_b[off] = sb;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NPER; ++n) {
      const int nn = g * NPER + n;
      if (nn < ds) dlog_a[(b * di + i) * ds + nn] = dA[n] * A[n];
    }
  }
}

// dB and dC: the blocks' partials [nbx][B * L * ds] added in block order.
__global__ void mamba_scan_bwd_reduce_kernel(const float* __restrict__ part_b,
                                             const float* __restrict__ part_c,
                                             float* __restrict__ db, float* __restrict__ dc,
                                             int nbx, int64_t n) {
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    float sb = 0.0f, sc = 0.0f;
    for (int q = 0; q < nbx; ++q) {
      sb += part_b[q * n + idx];
      sc += part_c[q * n + idx];
    }
    db[idx] = sb;
    dc[idx] = sc;
  }
}

template <int G, int NPER>
cudaError_t prepare() {
  static const cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel<G, NPER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem<G, NPER>));
  return err;
}

template <int G, int NPER>
int launch(const void* dt, const void* bm, const void* cm, const void* x, const void* log_a,
           const void* ckpt, const void* dy, const void* dstate, void* ddt, void* db,
           void* dc, void* dx, void* dlog_a, void* part_b, void* part_c, int64_t bsz,
           int64_t l, int64_t di, int64_t ds, void* stream) {
  using S = Smem<G, NPER>;
  cudaError_t err = prepare<G, NPER>();
  if (err != cudaSuccess) return (int)err;
  const int nbx = (int)((di + S::kChan - 1) / S::kChan);
  const dim3 grid((unsigned)nbx, (unsigned)bsz);
  mamba_scan_bwd_kernel<G, NPER><<<grid, kThreadsB, sizeof(S), (cudaStream_t)stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(x),
      static_cast<const float*>(log_a), static_cast<const float*>(ckpt),
      static_cast<const float*>(dy), static_cast<const float*>(dstate),
      static_cast<float*>(ddt), static_cast<float*>(dx), static_cast<float*>(dlog_a),
      static_cast<float*>(part_b), static_cast<float*>(part_c), (int)l, (int)di, (int)ds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = bsz * l * ds;
  if (n > 0) {
    const int64_t blocks = (n + 255) / 256;
    mamba_scan_bwd_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                                   (cudaStream_t)stream>>>(
        static_cast<const float*>(part_b), static_cast<const float*>(part_c),
        static_cast<float*>(db), static_cast<float*>(dc), nbx, n);
  }
  return (int)cudaGetLastError();
}

template <int G, int NPER>
int resources(int* out) {
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t err = prepare<G, NPER>();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, mamba_scan_bwd_kernel<G, NPER>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, mamba_scan_bwd_kernel<G, NPER>, kThreadsB, sizeof(Smem<G, NPER>));
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + sizeof(Smem<G, NPER>));
  out[3] = kThreadsB;
  out[4] = blocks;
  return (int)cudaSuccess;
}

}  // namespace

// 1 <= ds <= 32; the forward's splits: ds <= 4: 2 threads x 2 states, <= 8:
// 2 x 4, <= 16: 2 x 8, <= 32: 4 x 8.  part_b and part_c hold ceil(di / 32)
// blocks' partials.  Two kernels; one launch counted by the wrapper.
extern "C" int mamba_scan_bwd_f32(const void* dt, const void* bm, const void* cm,
                                  const void* x, const void* log_a, const void* ckpt,
                                  const void* dy, const void* dstate, void* ddt, void* db,
                                  void* dc, void* dx, void* dlog_a, void* part_b,
                                  void* part_c, int64_t bsz, int64_t l, int64_t di,
                                  int64_t ds, void* stream) {
  if (bsz <= 0 || di <= 0) return (int)cudaSuccess;
  if (l < 0 || ds < 1 || ds > 32 || bsz > 65535 || l > 0x7fffffff || di > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (ds <= 4)
    return launch<2, 2>(dt, bm, cm, x, log_a, ckpt, dy, dstate, ddt, db, dc, dx, dlog_a,
                        part_b, part_c, bsz, l, di, ds, stream);
  if (ds <= 8)
    return launch<2, 4>(dt, bm, cm, x, log_a, ckpt, dy, dstate, ddt, db, dc, dx, dlog_a,
                        part_b, part_c, bsz, l, di, ds, stream);
  if (ds <= 16)
    return launch<2, 8>(dt, bm, cm, x, log_a, ckpt, dy, dstate, ddt, db, dc, dx, dlog_a,
                        part_b, part_c, bsz, l, di, ds, stream);
  return launch<4, 8>(dt, bm, cm, x, log_a, ckpt, dy, dstate, ddt, db, dc, dx, dlog_a,
                      part_b, part_c, bsz, l, di, ds, stream);
}

// For reports: the instance that takes ds; out[5] = registers, local bytes,
// shared bytes, threads, blocks an SM.
extern "C" int mamba_scan_bwd_resources(int64_t ds, int* out) {
  if (ds < 1 || ds > 32) return (int)cudaErrorInvalidValue;
  if (ds <= 4) return resources<2, 2>(out);
  if (ds <= 8) return resources<2, 4>(out);
  if (ds <= 16) return resources<2, 8>(out);
  return resources<4, 8>(out);
}
