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
// Asked for them (training: ckpt not null), it also writes s before every
// kSteps-th step, ckpt [B, ceil(L / kSteps), di, ds] fp32, from which the
// backward (mamba_scan_bwd.cu) recomputes each stage's states; the arithmetic
// is the same either way, so y and state are bit-equal with and without them.
//
// The exp: exp(dt * A) is computed as ex2.approx.ftz.f32(dt * (A * log2 e)),
// with A * log2 e kept in registers (A itself with the accurate expf).  At
// every shape chip_smoke.py and the card tests check, with a row of A for
// each channel, it holds rtol 1e-5 and atol 1e-5 of the plain version's
// largest value, the gate the accurate expf was held to: the largest error
// chip_smoke.py measured over its 14 shapes was 6.7e-6 (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md, row 9).  The accurate expf would add
// its range reduction to every entry (below).  The build uses no
// --use_fast_math.
//
// Bound: memory.  At Jamba-1.5-Large's prefill (B 2, L 512, di 16384, ds 16)
// the kernel must read dt and x and write y (201 MB), read B, C and log_a
// (1.2 MB) and write the state (2.1 MB): 204 MB, 61 us at an H100 SXM's
// 3.35 TB/s.  The scan needs one exp per state entry a step, 268 M of them.
// This kernel takes every one on the special-function unit (ex2, 16 a clock
// an SM): 64 us at 1.98 GHz, a floor of this design, above the bytes.  An exp
// can also run on the fp32 lanes as a software exp2 (about 8 instructions);
// with an entry's 4 to 5 other fp32 instructions (dt * A', the drive times B,
// the update and the y sum, FMAs where they contract), issue (128 lanes a
// clock an SM, a MUFU one slot) and the SFU balance near 53 us with a sixth
// of the exps moved, below the bytes.  The accurate expf's range reduction
// would add several instructions an entry.  chip_smoke.py reckons both
// bounds in each run, from the fp32 instructions the SASS of this instance
// shows and the card's maximum SM clock, and prints the SFU floor.
//
// Design: a channel's state is split over G threads (2 or 4, chosen by ds),
// NPER states each (2, 4 or 8): ds 16 takes 2 of 8.  The G threads of a
// channel sit in G different warps, at the same lane: warp w holds state
// slice g = w % G of 32 consecutive channels.  So each step a warp reads dt
// and x for 32 channels (32 banks, one wavefront each) and its slice of B_t
// and C_t (one address for the whole warp: a broadcast), and stores its 32
// partial sums of y_t to shared memory; after the stage, the block sums the
// G partials and writes y with 16-byte stores.  A block has 4 warps and
// 128 / G channels; at Jamba's shape the grid is 512 blocks, about 15.5
// warps an SM, each with 8 independent ex2s a step; the previous kernel
// (one thread a channel, 16 states) had 7.75 warps an SM.  Two other splits
// ran slower on the card (probe_mamba_split.py builds and times them; the
// times are in PERF.md): 4 warps of 4 states (half the work between loads),
// and 4 lanes of one warp of 4 states with y reduced by __shfl_xor_sync (its
// warps read 4 slices of B and C a load, and the shuffles share the
// shared-memory pipe with the loads).  A whole stage runs its 16 steps
// unrolled with no predicate; only the last, ragged stage tests t < L.
//
// Staging: dt, x, B and C pass through a three-stage ring in shared memory,
// kSteps steps a stage, filled by cp.async: stage k + 2 is in flight while
// stage k is scanned, and the barrier a stage opens with waits on copies
// issued two stages earlier; the second barrier of a stage waits only on the
// scan (the partials of y).  Copies are 16 bytes where di and ds are
// multiples of 4 and every pointer is 16-byte aligned, else 4 bytes; channels
// past di and steps past L are masked.  Shared memory is zeroed first, so
// state slices past ds see B = C = 0 and A' = 0 and their state stays 0.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// are passed as void*, sizes as int64.  The entry point returns
// cudaGetLastError() after the launch, so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 16;                  // time steps a stage
constexpr int kStages = 3;                  // stages in the ring
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int G, int NPER>
struct Smem {
  static constexpr int kThreadsB = 128;            // 4 warps
  static constexpr int kChan = kThreadsB / G;      // channels a block
  static constexpr int kDs = G * NPER;
  float dt[kStages][kSteps][kChan];
  float x[kStages][kSteps][kChan];
  float b[kStages][kSteps][kDs];
  float c[kStages][kSteps][kDs];
  float part[G][kSteps][kChan];                    // each state slice's share of y
};

template <int G, int NPER>
__device__ __forceinline__ void load_stage(Smem<G, NPER>& sm, int buf, const float* dt,
                                           const float* x, const float* bm, const float* cm,
                                           int64_t row0, int nt, int ch0, int di, int ds,
                                           bool vec) {
  using S = Smem<G, NPER>;
  constexpr int kChan = S::kChan, kT = S::kThreadsB;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kQuads = kChan / 4;
    for (int idx = tid; idx < nt * kQuads; idx += kT) {
      const int t = idx / kQuads, j = 4 * (idx % kQuads);
      if (ch0 + j < di) {
        const int64_t off = (row0 + t) * di + ch0 + j;
        cp_async16(&sm.dt[buf][t][j], dt + off);
        cp_async16(&sm.x[buf][t][j], x + off);
      }
    }
    const int quads = ds / 4;
    for (int idx = tid; idx < nt * quads; idx += kT) {
      const int t = idx / quads, n = 4 * (idx % quads);
      const int64_t off = (row0 + t) * ds + n;
      cp_async16(&sm.b[buf][t][n], bm + off);
      cp_async16(&sm.c[buf][t][n], cm + off);
    }
  } else {
    for (int idx = tid; idx < nt * kChan; idx += kT) {
      const int t = idx / kChan, j = idx % kChan;
      if (ch0 + j < di) {
        const int64_t off = (row0 + t) * di + ch0 + j;
        cp_async4(&sm.dt[buf][t][j], dt + off);
        cp_async4(&sm.x[buf][t][j], x + off);
      }
    }
    for (int idx = tid; idx < nt * ds; idx += kT) {
      const int t = idx / ds, n = idx % ds;
      const int64_t off = (row0 + t) * ds + n;
      cp_async4(&sm.b[buf][t][n], bm + off);
      cp_async4(&sm.c[buf][t][n], cm + off);
    }
  }
}

// y of one stage: the sum of the G slices' shares, written out.
template <int G, int NPER>
__device__ __forceinline__ void store_y(const Smem<G, NPER>& sm, float* y, int64_t row0, int nt,
                                        int ch0, int di, bool vec) {
  using S = Smem<G, NPER>;
  constexpr int kChan = S::kChan, kT = S::kThreadsB;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kQuads = kChan / 4;
    for (int idx = tid; idx < nt * kQuads; idx += kT) {
      const int t = idx / kQuads, j = 4 * (idx % kQuads);
      if (ch0 + j < di) {
        float4 acc = *reinterpret_cast<const float4*>(&sm.part[0][t][j]);
#pragma unroll
        for (int g = 1; g < G; ++g) {
          const float4 p = *reinterpret_cast<const float4*>(&sm.part[g][t][j]);
          acc.x += p.x; acc.y += p.y; acc.z += p.z; acc.w += p.w;
        }
        *reinterpret_cast<float4*>(y + (row0 + t) * di + ch0 + j) = acc;
      }
    }
  } else {
    for (int idx = tid; idx < nt * kChan; idx += kT) {
      const int t = idx / kChan, j = idx % kChan;
      if (ch0 + j < di) {
        float acc = sm.part[0][t][j];
#pragma unroll
        for (int g = 1; g < G; ++g) acc += sm.part[g][t][j];
        y[(row0 + t) * di + ch0 + j] = acc;
      }
    }
  }
}

template <int G, int NPER>
__global__ void __launch_bounds__(Smem<G, NPER>::kThreadsB)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                  const float* __restrict__ cm, const float* __restrict__ x,
                  const float* __restrict__ log_a, float* __restrict__ y,
                  float* __restrict__ state, float* __restrict__ ckpt, int l, int di, int ds,
                  bool vec) {
  using S = Smem<G, NPER>;
  constexpr int kChan = S::kChan, kT = S::kThreadsB;
  __shared__ __align__(16) S sm;
  const int64_t b = blockIdx.y;
  const int ch0 = blockIdx.x * kChan;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = w % G, cl = (w / G) * 32 + lane;
  const int i = ch0 + cl;
  const bool live = i < di;
  const int64_t row_b = b * l;

  {  // zero the ring and the partials: state slices past ds read B = C = 0
    float* all = reinterpret_cast<float*>(&sm);
    for (int k = threadIdx.x; k < (int)(sizeof(S) / sizeof(float)); k += kT) all[k] = 0.0f;
  }
  float a2[NPER], s[NPER];
#pragma unroll
  for (int n = 0; n < NPER; ++n) {
    const int nn = g * NPER + n;
    a2[n] = (live && nn < ds) ? -expf(log_a[(int64_t)i * ds + nn]) * kLog2e : 0.0f;
    s[n] = 0.0f;
  }
  __syncthreads();

  const int stages = (l + kSteps - 1) / kSteps;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < stages)
      load_stage(sm, p, dt, x, bm, cm, row_b + p * kSteps, min(kSteps, l - p * kSteps), ch0,
                 di, ds, vec);
    cp_async_commit();
  }
  for (int k = 0; k < stages; ++k) {
    const int buf = k % kStages, t0 = k * kSteps, nt = min(kSteps, l - t0);
    cp_async_wait<kStages - 2>();
    __syncthreads();                        // stage k landed; stage k - 1's y is out
    const int next = k + kStages - 1;
    if (next < stages)
      load_stage(sm, next % kStages, dt, x, bm, cm, row_b + next * kSteps,
                 min(kSteps, l - next * kSteps), ch0, di, ds, vec);
    cp_async_commit();
    if (ckpt != nullptr && live) {          // s before this stage's first step
#pragma unroll
      for (int n = 0; n < NPER; ++n) {
        const int nn = g * NPER + n;
        if (nn < ds) ckpt[((b * stages + k) * di + i) * ds + nn] = s[n];
      }
    }
    auto step = [&](int t) {
      const float dtv = sm.dt[buf][t][cl];
      const float drive = dtv * sm.x[buf][t][cl];
      float bv[NPER], cv[NPER];
      if constexpr (NPER % 4 == 0) {
#pragma unroll
        for (int q = 0; q < NPER / 4; ++q) {
          const float4 b4 = *reinterpret_cast<const float4*>(&sm.b[buf][t][g * NPER + 4 * q]);
          const float4 c4 = *reinterpret_cast<const float4*>(&sm.c[buf][t][g * NPER + 4 * q]);
          bv[4 * q] = b4.x; bv[4 * q + 1] = b4.y; bv[4 * q + 2] = b4.z; bv[4 * q + 3] = b4.w;
          cv[4 * q] = c4.x; cv[4 * q + 1] = c4.y; cv[4 * q + 2] = c4.z; cv[4 * q + 3] = c4.w;
        }
      } else {
        const float2 b2 = *reinterpret_cast<const float2*>(&sm.b[buf][t][g * 2]);
        const float2 c2 = *reinterpret_cast<const float2*>(&sm.c[buf][t][g * 2]);
        bv[0] = b2.x; bv[1] = b2.y;
        cv[0] = c2.x; cv[1] = c2.y;
      }
      float acc = 0.0f;
#pragma unroll
      for (int n = 0; n < NPER; ++n) {
        s[n] = fmaf(ex2_approx(dtv * a2[n]), s[n], drive * bv[n]);
        acc = fmaf(s[n], cv[n], acc);
      }
      sm.part[g][t][cl] = acc;
    };
    if (nt == kSteps) {                     // a whole stage: no predicate a step
#pragma unroll
      for (int t = 0; t < kSteps; ++t) step(t);
    } else {
      for (int t = 0; t < nt; ++t) step(t);
    }
    __syncthreads();                        // every slice's share of stage k
    store_y(sm, y, row_b + t0, nt, ch0, di, vec);
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NPER; ++n) {
      const int nn = g * NPER + n;
      if (nn < ds) state[(b * di + i) * ds + nn] = s[n];
    }
  }
}

template <int G, int NPER>
int launch(const void* dt, const void* bm, const void* cm, const void* x,
           const void* log_a, void* y, void* state, void* ckpt, int64_t bsz, int64_t l,
           int64_t di, int64_t ds, void* stream) {
  using S = Smem<G, NPER>;
  const bool aligned = ((reinterpret_cast<uintptr_t>(dt) | reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(bm) | reinterpret_cast<uintptr_t>(cm) |
                         reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const bool vec = aligned && di % 4 == 0 && ds % 4 == 0;
  const dim3 grid((unsigned)((di + S::kChan - 1) / S::kChan), (unsigned)bsz);
  mamba_scan_kernel<G, NPER><<<grid, S::kThreadsB, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(x),
      static_cast<const float*>(log_a), static_cast<float*>(y),
      static_cast<float*>(state), static_cast<float*>(ckpt), (int)l, (int)di, (int)ds, vec);
  return (int)cudaGetLastError();
}

template <int G, int NPER>
int resources(int* out) {
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t err = cudaFuncGetAttributes(&a, mamba_scan_kernel<G, NPER>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mamba_scan_kernel<G, NPER>,
                                                        Smem<G, NPER>::kThreadsB, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = Smem<G, NPER>::kThreadsB;
  out[4] = blocks;
  return (int)cudaSuccess;
}

}  // namespace

// 1 <= ds <= 32; threads a channel x states a thread: ds <= 4: 2 x 2,
// <= 8: 2 x 4, <= 16: 2 x 8, <= 32: 4 x 8.
extern "C" int mamba_scan_f32(const void* dt, const void* bm, const void* cm,
                              const void* x, const void* log_a, void* y, void* state,
                              void* ckpt, int64_t bsz, int64_t l, int64_t di, int64_t ds,
                              void* stream) {
  if (bsz <= 0 || di <= 0) return (int)cudaSuccess;
  if (l < 0 || ds < 1 || ds > 32 || bsz > 65535 || l > 0x7fffffff || di > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (ds <= 4) return launch<2, 2>(dt, bm, cm, x, log_a, y, state, ckpt, bsz, l, di, ds, stream);
  if (ds <= 8) return launch<2, 4>(dt, bm, cm, x, log_a, y, state, ckpt, bsz, l, di, ds, stream);
  if (ds <= 16) return launch<2, 8>(dt, bm, cm, x, log_a, y, state, ckpt, bsz, l, di, ds, stream);
  return launch<4, 8>(dt, bm, cm, x, log_a, y, state, ckpt, bsz, l, di, ds, stream);
}

// For reports: the instance that takes ds; out[5] = registers, local bytes,
// shared bytes, threads, blocks an SM.
extern "C" int mamba_scan_resources(int64_t ds, int* out) {
  if (ds < 1 || ds > 32) return (int)cudaErrorInvalidValue;
  if (ds <= 4) return resources<2, 2>(out);
  if (ds <= 8) return resources<2, 4>(out);
  if (ds <= 16) return resources<2, 8>(out);
  return resources<4, 8>(out);
}
