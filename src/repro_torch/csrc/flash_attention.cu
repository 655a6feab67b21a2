// Causal GQA attention with an online softmax (flash attention) for Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel _flash_kernel: grid (batch, q heads, q blocks, kv blocks) with
// the kv blocks innermost and the fp32 accumulators carried in VMEM scratch
// across them; it asserted that Lq and Lk divide the block sizes).
//
// q [B, Hq, Lq, D], k and v [B, Hkv, Lk, D], out [B, Hq, Lq, D], one dtype
// (fp32 or bf16), contiguous.  q head h reads kv head h / (Hq / Hkv).  The
// queries are the last Lq positions: query row r sits at key position
// r + Lk - Lq.  A key at position j is seen from position i if j <= i (when
// causal) and j > i - window (when window > 0).  Scores are q.k * D^-0.5
// (q is scaled on load, as the TPU kernel does), softmax and accumulation in
// fp32, and the row sum l is clamped at 1e-30 before the division.
//
// Bound: at gemma3-1b's global layer (B 4, Hq 4, Hkv 1, L 1024, D 256, fp32)
// the kernel must read q, k, v and write out, 42 MB, about 12.5 us at an H100
// SXM's 3.35 TB/s; the causal work is 4 * D flops for each of the 2.1 M
// (query, key) pairs a head sees, about 8.6 GFLOP, 0.13 ms at the card's
// 67 TFLOP/s fp32 rate outside the tensor cores.  So in fp32 the kernel is
// bound by operations; bf16 inputs could use the tensor cores (a later PR).
//
// Design: fp32 arithmetic on the CUDA cores (no tensor cores), tiled in
// registers the way a SIMT matrix product is.  A block of 256 threads owns
// kBlockQ = 64 query rows of one (batch, q head) and walks the keys its rows
// can see (a causal or windowed range; tiles outside it are skipped) in tiles
// of kBlockK = 64 keys staged in shared memory.  Thread (ty, tx), 16 x 16 of
// them, owns rows 4ty..4ty+3 and, in a tile, keys tx, tx+16, tx+32, tx+48:
// for each d it reads one float4 of q (4 rows; q is stored transposed) and 4
// keys of K (stored transposed with a row stride of kBlockK + 1, so the 16
// threads of a row group hit 16 banks) and does 16 FMAs.  The 16 threads
// that share a row group sit in one half-warp, so a row's tile maximum is a
// 4-step shuffle; p = exp(s - m) of masked keys is 0.  p goes to shared
// memory (transposed, rows contiguous) and the same thread then adds p . V
// for its 4 rows and the D / 16 output columns tx, tx + 16, ..., one float4
// of p and D / 16 values of V per key.  Each thread keeps partial row sums
// l: the rescale factor is the same across the row group, so the partial
// sums add up, and one reduction at the end gives the row's sum.  A wholly
// masked tile adds nothing and leaves m as it was, so skipping one changes
// nothing.  Ragged Lq and Lk are masked, not padded.  Block 0 takes the
// last query tile, so the causal rows with the most keys start first.  At
// D = 256 the tiles take 219 KB of shared memory (one block an SM), above
// the 48 KB default: the launch raises the limit once.
//
// Plain C interface, bound from Python with ctypes: pointers and the stream
// are passed as void*, sizes as int64.  Each entry point returns
// cudaGetLastError() after the launch, so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // 16 x 16
constexpr int kBlockQ = 64;                 // query rows per block: 4 a thread row
constexpr int kBlockK = 64;                 // keys per tile: 4 a thread column
constexpr int kQStride = kBlockQ + 4;       // transposed q and p: float4 rows
constexpr int kKStride = kBlockK + 1;       // transposed k: a bank per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// max / sum over the 16 threads of a row group (lanes differing in bits 0-3)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)D * kQStride + (size_t)D * kKStride +
                          (size_t)kBlockK * D + (size_t)kBlockK * kQStride);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq,
                       int hkv, int lq, int lk, int causal, int window,
                       float scale) {
  constexpr int kCols = D / 16;             // output columns a thread owns
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][kQStride], scaled q^T
  float* kt = qt + D * kQStride;                 // [D][kKStride], k^T
  float* vs = kt + D * kKStride;                 // [kBlockK][D]
  float* pt = vs + kBlockK * D;                  // [kBlockK][kQStride], p^T

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int64_t qbase = ((int64_t)b * hq + h) * lq * D;
  const int64_t kbase = ((int64_t)b * hkv + hk) * lk * D;
  const int offset = lk - lq;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int row = i / D, c = i % D;
    qt[c * kQStride + row] =
        q0 + row < lq ? to_f32(q[qbase + (int64_t)(q0 + row) * D + c]) * scale : 0.0f;
  }

  // the keys this block's rows can see: [kbeg, kend)
  const int pos_lo = q0 + offset;
  const int pos_hi = min(q0 + kBlockQ, lq) - 1 + offset;
  const int kend = causal ? min(lk, pos_hi + 1) : lk;
  const int kbeg = window > 0 ? max(0, pos_lo - window + 1) : 0;

  float m[4], l[4], acc[4][kCols];
  int pos[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
    pos[r] = q0 + 4 * ty + r + offset;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  for (int t0 = kbeg; t0 < kend; t0 += kBlockK) {
    __syncthreads();                        // the previous tile is consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int j = i / D, c = i % D;
      const int key = t0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (key < kend) {
        kv = to_f32(k[kbase + (int64_t)key * D + c]);
        vv = to_f32(v[kbase + (int64_t)key * D + c]);
      }
      kt[c * kKStride + j] = kv;
      vs[i] = vv;
    }
    __syncthreads();

    // s[r][c]: row 4ty + r against key t0 + tx + 16c
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * kQStride + 4 * ty);
      const float* kr = kt + d * kKStride + tx;
      const float kk[4] = {kr[0], kr[16], kr[32], kr[48]};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[0][c] = fmaf(qv.x, kk[c], s[0][c]);
        s[1][c] = fmaf(qv.y, kk[c], s[1][c]);
        s[2][c] = fmaf(qv.z, kk[c], s[2][c]);
        s[3][c] = fmaf(qv.w, kk[c], s[3][c]);
      }
    }

    // online softmax, one row at a time; p^T to shared memory
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      bool ok[4];
      float tmax = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = t0 + tx + 16 * c;
        ok[c] = key < kend && (!causal || key <= pos[r]) &&
                (window <= 0 || key > pos[r] - window);
        if (ok[c]) tmax = fmaxf(tmax, s[r][c]);
      }
      const float m_new = fmaxf(m[r], group_max(tmax));
      const float alpha = expf(m[r] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_new) : 0.0f;
        pt[(tx + 16 * c) * kQStride + 4 * ty + r] = p;
        psum += p;
      }
      l[r] = l[r] * alpha + psum;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
    }
    __syncthreads();

    // acc += p . V over the tile's keys
    const int nk = min(kBlockK, kend - t0);
    for (int j = 0; j < nk; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + j * kQStride + 4 * ty);
      const float* vr = vs + j * D + tx;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vr[16 * c];
        acc[0][c] = fmaf(pv.x, vv, acc[0][c]);
        acc[1][c] = fmaf(pv.y, vv, acc[1][c]);
        acc[2][c] = fmaf(pv.z, vv, acc[2][c]);
        acc[3][c] = fmaf(pv.w, vv, acc[3][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float denom = fmaxf(group_sum(l[r]), 1e-30f);
    const int row = q0 + 4 * ty + r;
    if (row < lq) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        store(out + qbase + (int64_t)row * D + tx + 16 * c, acc[r][c] / denom);
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int64_t b,
           int64_t hq, int64_t hkv, int64_t lq, int64_t lk, int64_t causal,
           int64_t window, void* stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_kernel<D, T>;
  if (smem > 48 * 1024) {
    // once per instance, so that no launch inside a CUDA-graph capture sets it
    static const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((lq + kBlockQ - 1) / kBlockQ), (unsigned)hq, (unsigned)b);
  const float scale = (float)(1.0 / sqrt((double)D));
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), (int)hq, (int)hkv, (int)lq, (int)lk, (int)causal,
      (int)window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int64_t b,
             int64_t hq, int64_t hkv, int64_t lq, int64_t lk, int64_t d,
             int64_t causal, int64_t window, void* stream) {
  if (b <= 0 || hq <= 0 || lq <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv || lq > lk || window < 0 || b > 65535 || hq > 65535)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch<32, T>(q, k, v, out, b, hq, hkv, lq, lk, causal, window, stream);
    case 64: return launch<64, T>(q, k, v, out, b, hq, hkv, lq, lk, causal, window, stream);
    case 128: return launch<128, T>(q, k, v, out, b, hq, hkv, lq, lk, causal, window, stream);
    case 256: return launch<256, T>(q, k, v, out, b, hq, hkv, lq, lk, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// window 0 means none; causal 0 or 1.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int64_t b, int64_t hq, int64_t hkv,
                                   int64_t lq, int64_t lk, int64_t d, int64_t causal,
                                   int64_t window, void* stream) {
  return dispatch<float>(q, k, v, out, b, hq, hkv, lq, lk, d, causal, window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* out, int64_t b, int64_t hq, int64_t hkv,
                                    int64_t lq, int64_t lk, int64_t d, int64_t causal,
                                    int64_t window, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, b, hq, hkv, lq, lk, d, causal, window,
                                 stream);
}
