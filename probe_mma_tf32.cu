// The TF32 rate that mma.sync.m16n8k8 reaches on the card, run from
// registers with no memory traffic in the loop (probe_mma_tf32.py builds,
// launches and times it).
//
// Each warp runs `iters` rounds of ILP independent accumulator chains; a
// round runs one m16n8k8 (2048 flops) a chain.  With split, a round first
// splits one word of each chain's accumulator into TF32 hi and lo (the
// integer add, mask and subtraction flash_attention_bwd.cu spends on a B
// fragment) and runs the three products of a 3xTF32 step, hi*lo, lo*hi and
// hi*hi: the tensor cores' rate when each product brings its share of the
// split's arithmetic, as the attention kernels' inner loops do.  One word a
// thread is written at the end, so the chains are not dead code.
//
// wgmma_bf16_rate: the bf16 rate of wgmma.mma_async.m64nNk16 (N 64, 128 or
// 256), fp32 accumulators, its operands in shared memory in the layout the
// bf16 attention kernels use (src/repro_torch/csrc/wgmma_bf16.cuh): A and B
// both from shared memory (ss) or A from registers (rs), 1 to 3 warpgroups a
// block, one block an SM.  A round issues 16 products into one accumulator
// (the 16-deep steps of a 256-deep product), commits them and waits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace {

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <int ILP, bool SPLIT>
__global__ void mma_tf32_rate_kernel(float* out, int64_t iters) {
  const float base = 1e-3f * (1.0f + (threadIdx.x & 31) * 0.03125f);
  uint32_t ah[4], al[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(base * (1.0f + 0.1f * i), ah[i], al[i]);
  b[0] = __float_as_uint(1.0f + 0.5f * base);
  b[1] = __float_as_uint(1.0f - 0.5f * base);
  float c[ILP][4];
#pragma unroll
  for (int j = 0; j < ILP; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = base * j;
  for (int64_t it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < ILP; ++j) {
      if (SPLIT) {
        uint32_t bh[2], bl[2];
        split(c[j][0] * 1e-6f + 1.0f, bh[0], bl[0]);
        split(c[j][1] * 1e-6f + 1.0f, bh[1], bl[1]);
        mma_tf32(c[j], ah, bl);
        mma_tf32(c[j], al, bh);
        mma_tf32(c[j], ah, bh);
      } else {
        mma_tf32(c[j], ah, b);
      }
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < ILP; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[(int64_t)blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <bool SPLIT>
int launch(int ilp, int64_t blocks, int threads, int64_t iters, float* out,
           cudaStream_t stream) {
  const dim3 grid((unsigned)blocks);
  switch (ilp) {
    case 1: mma_tf32_rate_kernel<1, SPLIT><<<grid, threads, 0, stream>>>(out, iters); break;
    case 2: mma_tf32_rate_kernel<2, SPLIT><<<grid, threads, 0, stream>>>(out, iters); break;
    case 4: mma_tf32_rate_kernel<4, SPLIT><<<grid, threads, 0, stream>>>(out, iters); break;
    case 8: mma_tf32_rate_kernel<8, SPLIT><<<grid, threads, 0, stream>>>(out, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int N, bool RS>
__global__ void wgmma_bf16_rate_kernel(float* out, int64_t iters) {
  using T = wgbf16::Tile<64>;
  using TB = wgbf16::Tile<256>;                      // B read MN-major: [64 x 256]
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wgbf16::smem_u32(smem_raw);
  const uint32_t sa = (raw + 1023) & ~1023u;          // A [64 x 64]; B [256 x 64] or [64 x 256]
  const uint32_t sb = sa + T::bytes<64>();
  uint8_t* base = smem_raw + (sa - raw);
  for (int i = threadIdx.x; i < (T::bytes<64>() + T::bytes<256>()) / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(base)[i] = 0x3c003c00u * (i & 1);   // small bf16 values
  wgbf16::fence_proxy_async();
  __syncthreads();
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.0f;
  uint32_t a[4] = {0x3c003c00u, 0u, 0x3c003c00u, 0u};
  for (int64_t it = 0; it < iters; ++it) {
    wgbf16::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const uint64_t db = T::kdesc(sb + T::kmajor<256>(0, kk % 4));
      if constexpr (RS)
        wgbf16::wgmma_rs<N>(d, a, TB::mndesc<64>(sb + TB::mnmajor<64>(kk % 4, 0)), 1);
      else
        wgbf16::wgmma_ss<N>(d, T::kdesc(sa + T::kmajor<64>(0, kk % 4)), db, 1);
    }
    wgbf16::wgmma_commit();
    wgbf16::wgmma_wait<0>();
    wgbf16::fence_regs(d);
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s += d[i];
  out[(int64_t)blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int N, bool RS>
int launch_wgmma(int64_t blocks, int threads, int64_t iters, float* out, cudaStream_t stream) {
  constexpr int smem = wgbf16::Tile<64>::bytes<64>() + wgbf16::Tile<64>::bytes<256>() + 1024;
  cudaError_t err = cudaFuncSetAttribute(wgmma_bf16_rate_kernel<N, RS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wgmma_bf16_rate_kernel<N, RS><<<(unsigned)blocks, threads, smem, stream>>>(out, iters);
  return (int)cudaGetLastError();
}

}  // namespace

// out holds blocks * warpgroups * 128 floats; wgmma instructions run: blocks *
// warpgroups * iters * 16, each 2 * 64 * n * 16 flops
extern "C" int wgmma_bf16_rate(int64_t n, int64_t rs, int64_t blocks, int64_t warpgroups,
                               int64_t iters, void* out, void* stream) {
  auto* o = static_cast<float*>(out);
  const auto s = (cudaStream_t)stream;
  const int threads = 128 * (int)warpgroups;
  switch (n * 2 + (rs ? 1 : 0)) {
    case 128: return launch_wgmma<64, false>(blocks, threads, iters, o, s);
    case 129: return launch_wgmma<64, true>(blocks, threads, iters, o, s);
    case 256: return launch_wgmma<128, false>(blocks, threads, iters, o, s);
    case 257: return launch_wgmma<128, true>(blocks, threads, iters, o, s);
    case 513: return launch_wgmma<256, true>(blocks, threads, iters, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out holds blocks * threads floats; mma.sync instructions run: blocks *
// threads / 32 * iters * ilp, times 3 with split
extern "C" int mma_tf32_rate(int64_t ilp, int64_t split, int64_t blocks, int64_t threads,
                             int64_t iters, void* out, void* stream) {
  auto* o = static_cast<float*>(out);
  const auto s = (cudaStream_t)stream;
  return split ? launch<true>((int)ilp, blocks, (int)threads, iters, o, s)
               : launch<false>((int)ilp, blocks, (int)threads, iters, o, s);
}
