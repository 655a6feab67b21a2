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
// kSteps-th step (rwkv6_scan.cu, asked for them); scratch [B * H, kSteps, D, D]
// fp32.  dr, dk, dv, dw [B, H, L, D] and du [B, H, D] fp32.  D 32 or 64.
//
// Bound: at rwkv6-7b's training shape (B 2, H 64, L 1024, D 64) the gradient
// must read r, k, v, w, dout and write dr, dk, dv, dw (302 MB; u, dstate and
// du are small): 90 us at an H100 SXM's 3.35 TB/s.  Each state entry a step
// takes 14 flops: the state recomputed (k v, an FMA), the adjoint's update
// (r dout, an FMA) and four FMAs for dr, dk, dv, dw: 7.5 GFLOP.  These are
// products (S dout, G v, G^T k, rowsum(G * S)), which a chunked form runs on
// the tensor cores: at three TF32 products a flop (165 TFLOP/s, as the
// attention backward is priced) they take 46 us, so the bytes bound, 90 us,
// holds.  This design's FMAs outside the tensor cores (67 TFLOP/s) take 112
// us: its floor, not the function's.  The checkpoints (34 MB read) are this
// design's too.
//
// Design, a first one: simple and exact, not yet fast.
// - The recurrence is not inverted: S_{t-1} = (S_t - k_t v_t^T) / w_t is
//   unusable where w_t reaches 0 in fp32.  The forward writes the state every
//   kSteps steps; the backward walks the stages last to first, and recomputes
//   each stage's states from its checkpoint with the forward's arithmetic
//   (S = fma(w, S, k v), so they are the forward's bits).
// - A block owns one (batch, head), as the forward's, and each thread a 4 x 8
//   tile of S and of G in registers.  A stage's states go to a global scratch
//   area of the block's own (256 KB at D 64, mostly in L2), each thread's tile
//   as 8 float4s laid out [step][quad][thread] so that a warp's store is one
//   contiguous run; the reverse walk loads step t - 1's tile while it works on
//   step t.
// - Sums over a tile's columns (dr, dk, dw) and rows (dv) are deferred as the
//   forward's are: each thread writes its partial sums to shared memory, and
//   after the stage the block adds them in a fixed order, with the bonus
//   terms (v . dout, sum u r k) taken once a step.  du is a register sum of
//   thread i over every step, last to first.  No atomics: two launches are
//   bit-equal.
// - Shared memory at D 64: 20 KB of inputs, 96 KB of column-group partials
//   and 68 KB of row-group partials, one block an SM.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// are passed as void*, sizes as int64.  The entry point returns
// cudaGetLastError() after the launch, so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 16;                  // steps a checkpoint: rwkv6_scan.cu's stage
constexpr int kCols = 8;                    // state columns a thread holds (and 4 rows)

template <int D>
struct Smem {
  static constexpr int kRowGroups = D / 4;
  static constexpr int kColGroups = D / kCols;
  static constexpr int kThreads = kRowGroups * kColGroups;
  static constexpr int kPart = D + 4;       // row stride of the row-group partials
  float in[5][kSteps][D];                   // r, k, v, w, dout of the stage
  float colp[3][kSteps][kColGroups][D];     // dr, dk, dw: each column group's share
  float rowp[kSteps][kRowGroups][kPart];    // dv: each row group's share
  float vd[kSteps];                         // v_t . dout_t
  float ruk[kSteps];                        // sum_i u_i r_t,i k_t,i
};

template <int D>
__global__ void __launch_bounds__(Smem<D>::kThreads)
rwkv6_scan_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const float* __restrict__ ckpt,
                      const float* __restrict__ dout, const float* __restrict__ dstate,
                      float4* __restrict__ scratch, float* __restrict__ dr,
                      float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dw,
                      float* __restrict__ du, int h, int l) {
  using S = Smem<D>;
  constexpr int kThreads = S::kThreads;
  extern __shared__ float4 smem4[];
  S& sm = *reinterpret_cast<S*>(smem4);
  // thread (rg, cg) holds S[4 rg + a][kCols cg + b] and G[4 rg + a][kCols cg + b]
  const int tid = threadIdx.x;
  const int rg = tid % S::kRowGroups, cg = tid / S::kRowGroups;
  const int64_t bh = blockIdx.x;
  const int64_t base = bh * l * D;
  const int nc = (l + kSteps - 1) / kSteps;
  const float* uh = u + (bh % h) * D;
  float4* scr = scratch + bh * kSteps * 8 * kThreads;  // [step][quad][thread]
  const float* srcs[5] = {r, k, v, w, dout};

  float g[4][kCols], uu[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    uu[a] = uh[4 * rg + a];
#pragma unroll
    for (int b = 0; b < kCols; ++b)
      g[a][b] = dstate[(bh * D + 4 * rg + a) * D + kCols * cg + b];
  }
  float du_acc = 0.0f;                      // du[tid], tid < D

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kSteps, nt = min(kSteps, l - t0);
    __syncthreads();                        // the last stage's sums are read
    for (int i = tid; i < nt * D; i += kThreads)
#pragma unroll
      for (int q = 0; q < 5; ++q) (&sm.in[q][0][0])[i] = srcs[q][base + (int64_t)t0 * D + i];
    float s[4][kCols];
    {
      const float* ck = ckpt + ((bh * nc + c) * D + 4 * rg) * D + kCols * cg;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < kCols; b += 4) {
          const float4 x = *reinterpret_cast<const float4*>(ck + a * D + b);
          s[a][b] = x.x; s[a][b + 1] = x.y; s[a][b + 2] = x.z; s[a][b + 3] = x.w;
        }
    }
    __syncthreads();                        // the stage's inputs are in
    // the stage's states S_{t-1}, t0 <= t < t0 + nt, recomputed into scratch
    for (int t = 0; t < nt; ++t) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int a = q / 2, b = 4 * (q % 2);
        scr[(t * 8 + q) * kThreads + tid] = make_float4(s[a][b], s[a][b + 1], s[a][b + 2],
                                                        s[a][b + 3]);
      }
      if (t + 1 < nt) {
        float kk[4], ww[4], vv[kCols];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          kk[a] = sm.in[1][t][4 * rg + a];
          ww[a] = sm.in[3][t][4 * rg + a];
        }
#pragma unroll
        for (int b = 0; b < kCols; ++b) vv[b] = sm.in[2][t][kCols * cg + b];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < kCols; ++b) s[a][b] = fmaf(ww[a], s[a][b], kk[a] * vv[b]);
      }
    }
    // the walk back: G_t, then G_{t-1}
    float4 cur[8], nxt[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) cur[q] = scr[((nt - 1) * 8 + q) * kThreads + tid];
#pragma unroll 1
    for (int t = nt - 1; t >= 0; --t) {
      if (t > 0) {
#pragma unroll
        for (int q = 0; q < 8; ++q) nxt[q] = scr[((t - 1) * 8 + q) * kThreads + tid];
      }
      float p[4][kCols];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int a = q / 2, b = 4 * (q % 2);
        p[a][b] = cur[q].x; p[a][b + 1] = cur[q].y; p[a][b + 2] = cur[q].z;
        p[a][b + 3] = cur[q].w;
      }
      float rr[4], kk[4], ww[4], vv[kCols], dd[kCols];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        rr[a] = sm.in[0][t][4 * rg + a];
        kk[a] = sm.in[1][t][4 * rg + a];
        ww[a] = sm.in[3][t][4 * rg + a];
      }
#pragma unroll
      for (int b = 0; b < kCols; ++b) {
        vv[b] = sm.in[2][t][kCols * cg + b];
        dd[b] = sm.in[4][t][kCols * cg + b];
      }
      float pr[4] = {0.f, 0.f, 0.f, 0.f}, pk[4] = {0.f, 0.f, 0.f, 0.f};
      float pw[4] = {0.f, 0.f, 0.f, 0.f}, pv[kCols];
#pragma unroll
      for (int b = 0; b < kCols; ++b) pv[b] = 0.0f;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < kCols; ++b) {
          pr[a] = fmaf(p[a][b], dd[b], pr[a]);
          pk[a] = fmaf(g[a][b], vv[b], pk[a]);
          pw[a] = fmaf(g[a][b], p[a][b], pw[a]);
          pv[b] = fmaf(g[a][b], kk[a], pv[b]);
          g[a][b] = fmaf(ww[a], g[a][b], rr[a] * dd[b]);
        }
      *reinterpret_cast<float4*>(&sm.colp[0][t][cg][4 * rg]) = make_float4(pr[0], pr[1], pr[2], pr[3]);
      *reinterpret_cast<float4*>(&sm.colp[1][t][cg][4 * rg]) = make_float4(pk[0], pk[1], pk[2], pk[3]);
      *reinterpret_cast<float4*>(&sm.colp[2][t][cg][4 * rg]) = make_float4(pw[0], pw[1], pw[2], pw[3]);
#pragma unroll
      for (int b = 0; b < kCols; b += 4)
        *reinterpret_cast<float4*>(&sm.rowp[t][rg][kCols * cg + b]) =
            make_float4(pv[b], pv[b + 1], pv[b + 2], pv[b + 3]);
      if (t > 0) {
#pragma unroll
        for (int q = 0; q < 8; ++q) cur[q] = nxt[q];
      }
    }
    if (tid < nt) {                         // each step's bonus terms
      float vd = 0.0f, ruk = 0.0f;
      for (int i = 0; i < D; ++i) {
        vd = fmaf(sm.in[2][tid][i], sm.in[4][tid][i], vd);
        ruk = fmaf(uh[i] * sm.in[0][tid][i], sm.in[1][tid][i], ruk);
      }
      sm.vd[tid] = vd;
      sm.ruk[tid] = ruk;
    }
    __syncthreads();                        // the partial sums and bonus terms are in
    for (int idx = tid; idx < nt * D; idx += kThreads) {
      const int t = idx / D, i = idx % D;
      float sr = 0.0f, sk = 0.0f, sw = 0.0f, sv = 0.0f;
#pragma unroll
      for (int q = 0; q < S::kColGroups; ++q) {
        sr += sm.colp[0][t][q][i];
        sk += sm.colp[1][t][q][i];
        sw += sm.colp[2][t][q][i];
      }
#pragma unroll
      for (int q = 0; q < S::kRowGroups; ++q) sv += sm.rowp[t][q][i];
      const float ui = uh[i], vdt = sm.vd[t];
      const int64_t off = base + (int64_t)(t0 + t) * D + i;
      dr[off] = fmaf(ui * sm.in[1][t][i], vdt, sr);
      dk[off] = fmaf(ui * sm.in[0][t][i], vdt, sk);
      dv[off] = fmaf(sm.ruk[t], sm.in[4][t][i], sv);
      dw[off] = sw;
    }
    if (tid < D)
      for (int t = nt - 1; t >= 0; --t)
        du_acc = fmaf(sm.in[0][t][tid] * sm.in[1][t][tid], sm.vd[t], du_acc);
  }
  if (tid < D) du[bh * D + tid] = du_acc;
}

// Raise the instance's dynamic shared memory limit, once, so that no launch
// inside a CUDA-graph capture sets it.
template <int D>
cudaError_t prepare() {
  static const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem<D>));
  return err;
}

template <int D>
int resources(int* out) {
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t err = prepare<D>();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, rwkv6_scan_bwd_kernel<D>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rwkv6_scan_bwd_kernel<D>,
                                                        Smem<D>::kThreads, sizeof(Smem<D>));
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + sizeof(Smem<D>));
  out[3] = Smem<D>::kThreads;
  out[4] = blocks;
  return (int)cudaSuccess;
}

template <int D>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* ckpt, const void* dout, const void* dstate, void* scratch, void* dr,
           void* dk, void* dv, void* dw, void* du, int64_t b, int64_t h, int64_t l,
           void* stream) {
  const cudaError_t err = prepare<D>();
  if (err != cudaSuccess) return (int)err;
  rwkv6_scan_bwd_kernel<D><<<(unsigned)(b * h), Smem<D>::kThreads, sizeof(Smem<D>),
                             (cudaStream_t)stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(ckpt), static_cast<const float*>(dout),
      static_cast<const float*>(dstate), static_cast<float4*>(scratch),
      static_cast<float*>(dr), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dw), static_cast<float*>(du), (int)h, (int)l);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rwkv6_scan_bwd_f32(const void* r, const void* k, const void* v, const void* w,
                                  const void* u, const void* ckpt, const void* dout,
                                  const void* dstate, void* scratch, void* dr, void* dk,
                                  void* dv, void* dw, void* du, int64_t b, int64_t h,
                                  int64_t l, int64_t d, void* stream) {
  if (b * h <= 0) return (int)cudaSuccess;
  if (l < 0 || b * h > 0x7fffffff || l > 0x7fffffff) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch<32>(r, k, v, w, u, ckpt, dout, dstate, scratch, dr, dk, dv, dw, du,
                               b, h, l, stream);
    case 64: return launch<64>(r, k, v, w, u, ckpt, dout, dstate, scratch, dr, dk, dv, dw, du,
                               b, h, l, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// For reports: out[5] = registers, local bytes, shared bytes, threads, blocks an SM.
extern "C" int rwkv6_scan_bwd_resources(int64_t d, int* out) {
  switch (d) {
    case 32: return resources<32>(out);
    case 64: return resources<64>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
