// The Mamba-1 selective scan for Hopper, with its final state.
//
// Replaces: src/repro/kernels/mamba_scan.py::mamba_scan (the Pallas TPU kernel
// _mamba_kernel: grid (B, d_inner / block_di, L / chunk) with the time chunks
// innermost and the [block_di, d_state] state carried in VMEM scratch; it
// returned only y).
//
// dt, x [B, L, di]; B, C [B, L, ds]; log_a [di, ds]; all fp32, contiguous.
// y [B, L, di] and state [B, di, ds] fp32.  With A = -exp(log_a) and s = 0:
//   s[i][n] = exp(dt_t[i] * A[i][n]) * s[i][n] + (dt_t[i] * x_t[i]) * B_t[n]
//   y_t[i]  = sum_n s[i][n] * C_t[n]
// and the final s is written out: the prefill hands it to the decode cache.
// expf, not __expf, and the build uses no --use_fast_math.
//
// Bound: at Jamba-1.5-Large's prefill (B 2, L 512, di 16384, ds 16) the kernel
// must read dt and x and write y (201 MB), read B, C and log_a (1.2 MB) and
// write the state (2.1 MB): 204 MB, 61 us at an H100 SXM's 3.35 TB/s.  The
// arithmetic (an exp and about 6 flops per state entry a step, 1.9 GFLOP) is
// under half of that at the card's fp32 rate, so bytes bound it.
//
// Design, simple first: one thread owns one (batch, channel) and walks all L
// steps with its ds state values and its row of A in registers (the loop over
// n is unrolled to the template's DSMAX, with n < ds as a predicate, so the
// arrays stay in registers).  A block holds kThreads channels of one batch
// row; B_t and C_t, shared by all channels, are staged in shared memory
// kSteps steps at a time, and each thread loads its kSteps values of dt and x
// into registers before it computes, so those loads are in flight together.
// Loads of dt and x and stores of y are coalesced across channels.  Ragged L
// and di are masked.  At Jamba's shapes the grid is 256 blocks of 128
// threads: few warps a SM to hide the exp's latency; a later PR can split
// the time axis into chunks scanned in parallel.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// are passed as void*, sizes as int64.  The entry point returns
// cudaGetLastError() after the launch, so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;               // channels per block
constexpr int kSteps = 16;                  // time steps staged at a time

template <int DSMAX>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                  const float* __restrict__ cm, const float* __restrict__ x,
                  const float* __restrict__ log_a, float* __restrict__ y,
                  float* __restrict__ state, int l, int di, int ds) {
  __shared__ float bs[kSteps][DSMAX], cs[kSteps][DSMAX];
  const int64_t b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < di;

  float a[DSMAX], s[DSMAX];
#pragma unroll
  for (int n = 0; n < DSMAX; ++n) {
    a[n] = (live && n < ds) ? -expf(log_a[(int64_t)i * ds + n]) : 0.0f;
    s[n] = 0.0f;
  }

  for (int t0 = 0; t0 < l; t0 += kSteps) {
    const int nt = min(kSteps, l - t0);
    __syncthreads();                        // the previous steps are consumed
    for (int idx = threadIdx.x; idx < nt * ds; idx += kThreads) {
      const int t = idx / ds, n = idx % ds;
      const int64_t off = (b * l + t0 + t) * ds + n;
      bs[t][n] = bm[off];
      cs[t][n] = cm[off];
    }
    __syncthreads();
    if (!live) continue;
    float dtv[kSteps], xv[kSteps];
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      if (t < nt) {
        const int64_t off = (b * l + t0 + t) * di + i;
        dtv[t] = dt[off];
        xv[t] = x[off];
      }
    }
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      if (t < nt) {
        const float drive = dtv[t] * xv[t];
        float acc = 0.0f;
#pragma unroll
        for (int n = 0; n < DSMAX; ++n) {
          if (n < ds) {
            s[n] = expf(dtv[t] * a[n]) * s[n] + drive * bs[t][n];
            acc = fmaf(s[n], cs[t][n], acc);
          }
        }
        y[(b * l + t0 + t) * di + i] = acc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < DSMAX; ++n)
      if (n < ds) state[(b * di + i) * ds + n] = s[n];
  }
}

template <int DSMAX>
int launch(const void* dt, const void* bm, const void* cm, const void* x,
           const void* log_a, void* y, void* state, int64_t bsz, int64_t l,
           int64_t di, int64_t ds, void* stream) {
  const dim3 grid((unsigned)((di + kThreads - 1) / kThreads), (unsigned)bsz);
  mamba_scan_kernel<DSMAX><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(x),
      static_cast<const float*>(log_a), static_cast<float*>(y),
      static_cast<float*>(state), (int)l, (int)di, (int)ds);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 <= ds <= 32; the template is the smallest of 4, 8, 16, 32 that holds ds.
extern "C" int mamba_scan_f32(const void* dt, const void* bm, const void* cm,
                              const void* x, const void* log_a, void* y, void* state,
                              int64_t bsz, int64_t l, int64_t di, int64_t ds,
                              void* stream) {
  if (bsz <= 0 || di <= 0) return (int)cudaSuccess;
  if (l < 0 || ds < 1 || ds > 32 || bsz > 65535) return (int)cudaErrorInvalidValue;
  if (ds <= 4) return launch<4>(dt, bm, cm, x, log_a, y, state, bsz, l, di, ds, stream);
  if (ds <= 8) return launch<8>(dt, bm, cm, x, log_a, y, state, bsz, l, di, ds, stream);
  if (ds <= 16) return launch<16>(dt, bm, cm, x, log_a, y, state, bsz, l, di, ds, stream);
  return launch<32>(dt, bm, cm, x, log_a, y, state, bsz, l, di, ds, stream);
}
