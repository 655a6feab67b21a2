// The RWKV-6 WKV recurrence for Hopper, with its final state.
//
// Replaces: src/repro/kernels/rwkv6_scan.py::rwkv6_scan (the Pallas TPU kernel
// _wkv_kernel: grid (B, H, L / chunk) with the time chunks innermost and the
// [D, D] state carried in VMEM scratch across them; it returned only the
// outputs).
//
// r, k, v, w [B, H, L, D] (fp32 or bf16, one dtype, 16-byte aligned), u [H, D]
// fp32; out [B, H, L, D] in the inputs' dtype, state [B, H, D, D] fp32.
// From S = 0:
//   out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j]  = w_t[i] * S[i][j] + k_t[i] * v_t[j]
// and the final S is written out: the prefill hands it to the decode cache.
// Asked for them (training: ckpt not null), it also writes the state before
// every kSteps-th step, ckpt [B, H, ceil(L / kSteps), D, D] fp32, from which
// the backward (rwkv6_scan_bwd.cu) recomputes each stage's states; the
// arithmetic is the same either way, so out and state are bit-equal with and
// without them.
//
// Bound: at rwkv6-7b's prefill (B 4, H 64, L 512, D 64, fp32) the kernel must
// read r, k, v, w and write out (168 MB) and write the state (4.2 MB): 172 MB,
// 51 us at an H100 SXM's 3.35 TB/s.  The recurrence needs 5 flops for each of
// the D * D state entries a step (k v, an FMA for the S update, an FMA for
// r S; the bonus term, factored out below, is O(D) a step): 2.7 GFLOP, 40 us
// at the card's 67 TFLOP/s fp32 rate outside the tensor cores, so the bytes
// bound, 51 us, is the one that holds.
//
// Design.  The recurrence is sequential in t, so a block owns one (batch,
// head) and walks its L steps; what a step costs is the instructions the
// block issues for its D * D state entries, and above all its shared-memory
// loads.  One column of S a thread (D rows) reads each step's r, k, w once
// for every column; four threads a column still take 12 16-byte loads a
// thread a step, 4 wavefronts each.  Tiles of S and a deferred sum cut both
// the loads and the shuffles:
// - The state is tiled over threads: thread (rg, cg) holds S[4 rg + a]
//   [kCols cg + b], a 4 x kCols = 4 x 8 tile, in registers (D * D / 32
//   threads: 128 at D = 64).  A step reads its rows' r, k, w and its columns'
//   v as 16-byte loads (5 at D = 64 for 32 state entries), and its u values
//   stay in registers for the whole scan.
// - The bonus term is factored out of the sum: out_t[j] = sum_i r_i S[i][j]
//   + v_j sum_i r_i u_i k_i, three operations a state entry (k v, the S
//   update, the r S product) where the plain form takes four.
// - The sum over rows is deferred: each thread writes its tile's partial
//   sums of out_t (one per column) to shared memory, and after kSteps steps
//   the block adds the D / 4 row groups' partials of each output and writes
//   them as 16-byte stores coalesced across j.  No shuffle sits in a step.
// - Asynchronous staging.  The inputs of kSteps = 16 steps are one
//   contiguous run of each of r, k, v, w; they are copied with cp.async (16
//   bytes a thread) into one of two stages while the previous group's steps
//   run.  Two barriers a group.  L need not be a multiple of kSteps; L = 0
//   writes a zero state.
// - The S update is the plain version's, S = fma(w, S, k v), so the final
//   state is written from registers after the last step.  Shared memory at
//   D = 64: 32 KB of stages (fp32) and 68 KB of partial sums, two blocks an
//   SM; the dynamic limit is raised once per instance.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// are passed as void*, sizes as int64.  Each entry point returns
// cudaGetLastError() after the launch, so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 16;                  // time steps a stage

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

constexpr int kCols = 8;                    // state columns a thread holds (and 4 rows)

template <int D, typename T>
constexpr size_t smem_bytes() {
  return 2 * 4 * kSteps * D * sizeof(T) + sizeof(float) * kSteps * (D / 4) * (D + 4);
}

template <int D, typename T>
__global__ void __launch_bounds__(D * D / (4 * kCols))
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, T* __restrict__ out,
                  float* __restrict__ state, float* __restrict__ ckpt, int h, int l) {
  constexpr int kRowGroups = D / 4;         // 4-row groups of S
  constexpr int kThreads = kRowGroups * (D / kCols);
  constexpr int kVec = 16 / (int)sizeof(T); // elements a 16-byte copy
  constexpr int kPart = D + 4;              // row stride of the partial sums
  // [stage][r, k, v, w][step][D], then the partial sums [step][row group][kPart]
  extern __shared__ float4 smem4[];
  T(*in)[4][kSteps * D] = reinterpret_cast<T(*)[4][kSteps * D]>(smem4);
  float* part = reinterpret_cast<float*>(smem4) + 2 * 4 * kSteps * D * sizeof(T) / 4;

  // thread (rg, cg) holds S[4 rg + a][kCols cg + b]
  const int tid = threadIdx.x;
  const int rg = tid % kRowGroups, cg = tid / kRowGroups;
  const int64_t bh = blockIdx.x;
  const int64_t base = bh * l * D;

  float s[4][kCols], uu[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    uu[a] = u[(bh % h) * D + 4 * rg + a];
#pragma unroll
    for (int b = 0; b < kCols; ++b) s[a][b] = 0.0f;
  }

  auto stage = [&](int t0, int buf) {
    const int n = min(kSteps, l - t0) * D / kVec;       // 16-byte copies an input
    const int64_t off = base + (int64_t)t0 * D;
    for (int i = tid; i < n; i += kThreads) {
      cp_async16(&in[buf][0][i * kVec], r + off + i * kVec);
      cp_async16(&in[buf][1][i * kVec], k + off + i * kVec);
      cp_async16(&in[buf][2][i * kVec], v + off + i * kVec);
      cp_async16(&in[buf][3][i * kVec], w + off + i * kVec);
    }
    cp_async_commit();
  };

  const int ngroups = (l + kSteps - 1) / kSteps;
  if (ngroups > 0) stage(0, 0);
  for (int grp = 0; grp < ngroups; ++grp) {
    const int t0 = grp * kSteps, nt = min(kSteps, l - t0), buf = grp & 1;
    if (grp + 1 < ngroups) {
      stage(t0 + kSteps, buf ^ 1);          // its stage was freed by the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                        // this group's inputs landed; part is free
    if (ckpt != nullptr) {                  // the state before this group's first step
      float* ck = ckpt + ((bh * ngroups + grp) * D + 4 * rg) * D + kCols * cg;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kCols; c += 4)
          *reinterpret_cast<float4*>(ck + a * D + c) =
              make_float4(s[a][c], s[a][c + 1], s[a][c + 2], s[a][c + 3]);
    }
#pragma unroll 2
    for (int t = 0; t < nt; ++t) {
      const float4 r4 = load4(in[buf][0] + t * D + 4 * rg);
      const float4 k4 = load4(in[buf][1] + t * D + 4 * rg);
      const float4 w4 = load4(in[buf][3] + t * D + 4 * rg);
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w}, kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; c += 4) {
        const float4 v4 = load4(in[buf][2] + t * D + kCols * cg + c);
        vv[c] = v4.x; vv[c + 1] = v4.y; vv[c + 2] = v4.z; vv[c + 3] = v4.w;
      }
      // out_t[j] = sum_i r_i S[i][j] + v_j sum_i r_i u_i k_i, over this thread's rows
      float ruk = 0.0f;
#pragma unroll
      for (int a = 0; a < 4; ++a) ruk = fmaf(rr[a] * uu[a], kk[a], ruk);
      float acc[kCols];
#pragma unroll
      for (int b = 0; b < kCols; ++b) acc[b] = ruk * vv[b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < kCols; ++b) {
          acc[b] = fmaf(rr[a], s[a][b], acc[b]);
          s[a][b] = fmaf(ww[a], s[a][b], kk[a] * vv[b]);
        }
      float* pt = part + (t * kRowGroups + rg) * kPart + kCols * cg;
#pragma unroll
      for (int c = 0; c < kCols; c += 4)
        *reinterpret_cast<float4*>(pt + c) = make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
    }
    __syncthreads();                        // part complete; the stage is consumed
    // out_t = the sum of the row groups' partial sums, 16 bytes a thread
    for (int i = tid; i < nt * D / 4; i += kThreads) {
      const int tt = i / (D / 4), j4 = 4 * (i % (D / 4));
      const float* pt = part + tt * kRowGroups * kPart + j4;
      float4 sum = *reinterpret_cast<const float4*>(pt);
#pragma unroll
      for (int g = 1; g < kRowGroups; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(pt + g * kPart);
        sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
      }
      store4(out + base + (int64_t)(t0 + tt) * D + j4, sum);
    }
  }

  float* st = state + bh * D * D + kCols * cg;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; c += 4)
      *reinterpret_cast<float4*>(st + (4 * rg + a) * D + c) =
          make_float4(s[a][c], s[a][c + 1], s[a][c + 2], s[a][c + 3]);
}

// Raise the instance's dynamic shared memory limit, once, so that no launch
// inside a CUDA-graph capture sets it.
template <int D, typename T>
cudaError_t prepare() {
  constexpr size_t smem = smem_bytes<D, T>();
  if (smem <= 48 * 1024) return cudaSuccess;
  static const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return err;
}

// One instance's registers and local bytes a thread, shared bytes a block
// (static and dynamic), threads a block and blocks an SM.
template <int D, typename T>
int resources(int* out) {
  constexpr int threads = D * D / (4 * kCols);
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t err = prepare<D, T>();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, rwkv6_scan_kernel<D, T>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rwkv6_scan_kernel<D, T>, threads,
                                                        smem_bytes<D, T>());
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + smem_bytes<D, T>());
  out[3] = threads;
  out[4] = blocks;
  return (int)cudaSuccess;
}

template <int D, typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* out, void* state, void* ckpt, int64_t b, int64_t h,
           int64_t l, void* stream) {
  constexpr size_t smem = smem_bytes<D, T>();
  auto kernel = rwkv6_scan_kernel<D, T>;
  const cudaError_t err = prepare<D, T>();
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(b * h), D * D / (4 * kCols), smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const float*>(u), static_cast<T*>(out),
      static_cast<float*>(state), static_cast<float*>(ckpt), (int)h, (int)l);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* out, void* state, void* ckpt, int64_t b, int64_t h,
             int64_t l, int64_t d, void* stream) {
  if (b * h <= 0) return (int)cudaSuccess;
  if (l < 0 || b * h > 0x7fffffff || l > 0x7fffffff) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch<32, T>(r, k, v, w, u, out, state, ckpt, b, h, l, stream);
    case 64: return launch<64, T>(r, k, v, w, u, out, state, ckpt, b, h, l, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rwkv6_scan_f32(const void* r, const void* k, const void* v,
                              const void* w, const void* u, void* out, void* state,
                              void* ckpt, int64_t b, int64_t h, int64_t l, int64_t d,
                              void* stream) {
  return dispatch<float>(r, k, v, w, u, out, state, ckpt, b, h, l, d, stream);
}

extern "C" int rwkv6_scan_bf16(const void* r, const void* k, const void* v,
                               const void* w, const void* u, void* out, void* state,
                               void* ckpt, int64_t b, int64_t h, int64_t l, int64_t d,
                               void* stream) {
  return dispatch<__nv_bfloat16>(r, k, v, w, u, out, state, ckpt, b, h, l, d, stream);
}

// For reports: out[5] = registers, local bytes, shared bytes, threads, blocks an SM.
extern "C" int rwkv6_scan_resources(int64_t d, int64_t bf16, int* out) {
  switch (d) {
    case 32: return bf16 ? resources<32, __nv_bfloat16>(out) : resources<32, float>(out);
    case 64: return bf16 ? resources<64, __nv_bfloat16>(out) : resources<64, float>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
