// The RWKV-6 WKV recurrence for Hopper, with its final state.
//
// Replaces: src/repro/kernels/rwkv6_scan.py::rwkv6_scan (the Pallas TPU kernel
// _wkv_kernel: grid (B, H, L / chunk) with the time chunks innermost and the
// [D, D] state carried in VMEM scratch across them; it returned only the
// outputs).
//
// r, k, v, w [B, H, L, D] (fp32 or bf16, one dtype), u [H, D] fp32; out
// [B, H, L, D] in the inputs' dtype, state [B, H, D, D] fp32.  From S = 0:
//   out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j]  = w_t[i] * S[i][j] + k_t[i] * v_t[j]
// and the final S is written out: the prefill hands it to the decode cache.
//
// Bound: at rwkv6-7b's prefill (B 4, H 64, L 512, D 64, fp32) the kernel must
// read r, k, v, w and write out (168 MB) and write the state (4.2 MB): 172 MB,
// 51 us at an H100 SXM's 3.35 TB/s.  The recurrence does 7 flops for each of
// the D * D state entries a step: 3.8 GFLOP, 56 us at the card's 67 TFLOP/s
// fp32 rate outside the tensor cores, so the two bounds are close.
//
// Design, simple first: the recurrence is sequential in t, so one block owns
// one (batch, head) and walks all L steps; its D threads own one column j of
// S each, in registers (D floats a thread, the loop over i fully unrolled so
// that S stays in registers).  The step's r, k, w (shared by all columns) and
// v are staged in shared memory kSteps steps at a time, so a block syncs twice
// per kSteps steps, and every global load and store is coalesced across j.
// The output's sum over i is split over four accumulators to shorten its
// dependency chain.  The grid is B * H blocks: 256 at rwkv6-7b's prefill, two
// warps each, so the card is far from full; splitting S's columns over more
// blocks, or the chunked matrix form, is for a later PR.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// are passed as void*, sizes as int64.  Each entry point returns
// cudaGetLastError() after the launch, so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 32;                  // time steps staged at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int D, typename T>
__global__ void __launch_bounds__(D)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, T* __restrict__ out,
                  float* __restrict__ state, int h, int l) {
  __shared__ float rs[kSteps][D], ks[kSteps][D], ws[kSteps][D], vs[kSteps][D];
  __shared__ float us[D];
  const int j = threadIdx.x;
  const int64_t bh = blockIdx.x;
  const int64_t base = bh * l * D;
  us[j] = u[(bh % h) * D + j];

  float s[D];                               // column j of S: s[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < D; ++i) s[i] = 0.0f;

  for (int t0 = 0; t0 < l; t0 += kSteps) {
    const int nt = min(kSteps, l - t0);
    __syncthreads();                        // the previous steps are consumed
    for (int t = 0; t < nt; ++t) {
      const int64_t off = base + (int64_t)(t0 + t) * D + j;
      rs[t][j] = to_f32(r[off]);
      ks[t][j] = to_f32(k[off]);
      ws[t][j] = to_f32(w[off]);
      vs[t][j] = to_f32(v[off]);
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float vj = vs[t][j];
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float kv = ks[t][i] * vj;
        acc[i & 3] = fmaf(rs[t][i], fmaf(us[i], kv, s[i]), acc[i & 3]);
        s[i] = fmaf(ws[t][i], s[i], kv);
      }
      store(out + base + (int64_t)(t0 + t) * D + j, (acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }
  float* st = state + bh * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i) st[i * D + j] = s[i];
}

template <int D, typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* out, void* state, int64_t b, int64_t h,
           int64_t l, void* stream) {
  rwkv6_scan_kernel<D, T><<<(unsigned)(b * h), D, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const float*>(u), static_cast<T*>(out),
      static_cast<float*>(state), (int)h, (int)l);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* out, void* state, int64_t b, int64_t h,
             int64_t l, int64_t d, void* stream) {
  if (b * h <= 0) return (int)cudaSuccess;
  if (l < 0 || b * h > 0x7fffffff) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch<32, T>(r, k, v, w, u, out, state, b, h, l, stream);
    case 64: return launch<64, T>(r, k, v, w, u, out, state, b, h, l, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rwkv6_scan_f32(const void* r, const void* k, const void* v,
                              const void* w, const void* u, void* out, void* state,
                              int64_t b, int64_t h, int64_t l, int64_t d, void* stream) {
  return dispatch<float>(r, k, v, w, u, out, state, b, h, l, d, stream);
}

extern "C" int rwkv6_scan_bf16(const void* r, const void* k, const void* v,
                               const void* w, const void* u, void* out, void* state,
                               int64_t b, int64_t h, int64_t l, int64_t d, void* stream) {
  return dispatch<__nv_bfloat16>(r, k, v, w, u, out, state, b, h, l, d, stream);
}
