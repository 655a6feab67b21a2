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

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// out holds blocks * threads floats; mma.sync instructions run: blocks *
// threads / 32 * iters * ilp, times 3 with split
extern "C" int mma_tf32_rate(int64_t ilp, int64_t split, int64_t blocks, int64_t threads,
                             int64_t iters, void* out, void* stream) {
  auto* o = static_cast<float*>(out);
  const auto s = (cudaStream_t)stream;
  return split ? launch<true>((int)ilp, blocks, (int)threads, iters, o, s)
               : launch<false>((int)ilp, blocks, (int)threads, iters, o, s);
}
