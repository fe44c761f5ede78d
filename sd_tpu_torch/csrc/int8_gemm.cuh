// The int8 tensor-core GEMM shared by K6 (int8_dense.cu) and K4
// (geglu_ff_int8.cu), for Hopper (sm_90a):
//
//   C[m, n] = epilogue( sum_k A[m, k] * B[n, k] )     (int8 x int8 -> int32)
//
// A holds int8 codes quantized per row, with one fp32 scale per row. Either
// the block quantizes its rows itself from bf16 (`QuantA`: each block reads
// its 64 rows whole, finds each row's max |x| and keeps the codes of the
// whole rows in shared memory; K at most kMaxQuantK), or A is read as int8
// codes with a scale array. B is int8 [n, k] row-major (a torch Linear
// weight quantized per output row) with one fp32 scale per row.
//
// Quantization is sd_tpu's exactly: s = max(max|x| / 127, 1e-12), q =
// clip(rint(x / s), -127, 127), a true division, round half to even.
//
// Tiles: 64x64 output per block, k steps of 64, 8 warps of 32 rows x 16
// columns, WMMA m16n16k16 on signed char with int32 accumulators. Int8
// fragments must start on 32-byte boundaries, but a 16-wide k slice of a
// row-major tile starts on a 16-byte one; so every int8 tile in shared
// memory is stored in k slabs: slab s holds columns [16s, 16s + 16) of all
// rows, 16 bytes a row, and a fragment is read with ldm = 16.
//
// Epilogues:
//   EpiBF16:  out bf16 = acc * (sa[row] * sb[col]) + bias[col]
//   EpiGEGLU: two B matrices (value and gate rows, B and B2): a = acc_a *
//             (sa * sb) + bias, g likewise with sb2, bias2; h = a *
//             gelu_fast(g) in fp32 is written to `out` (fp32), and each
//             row's max |h| is raised with atomicMax on the bits of the
//             non-negative float in `rowmax` (zeroed by the caller).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

// internal linkage: each source that includes this has its own copies
namespace sdt_i8 {
namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int kWarps = 8;  // 2 (rows, 32 each) x 4 (columns, 16 each)
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQuantK = 2560;

enum class Epi { BF16, GEGLU };

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// sd_tpu's _ERF_FAST: erf(x) ~ x * P6(x^2) on |x| <= 3, 1 beyond (signed)
__device__ __forceinline__ float erf_fast(float x) {
  const float a = fminf(fabsf(x), 3.f);
  const float t = a * a;
  float acc = 3.68124527e-06f;
  acc = acc * t + -0.000135903813f;
  acc = acc * t + 0.00211666563f;
  acc = acc * t + -0.0183764236f;
  acc = acc * t + 0.0998401577f;
  acc = acc * t + -0.366942461f;
  acc = acc * t + 1.12646408f;
  const float r = fabsf(x) > 3.f ? 1.f : a * acc;
  return x > 0.f ? r : (x < 0.f ? -r : 0.f);
}

__device__ __forceinline__ float gelu_fast(float g) {
  return 0.5f * g * (1.f + erf_fast(g * 0.70710678118654752f));
}

__device__ __forceinline__ float quant_scale(float amax) {
  return fmaxf(amax / 127.f, 1e-12f);
}

__device__ __forceinline__ signed char quant(float x, float s) {
  return static_cast<signed char>(fminf(fmaxf(rintf(x / s), -127.f), 127.f));
}

// offset of element (r, c) of an R-row int8 tile stored in 16-column slabs
__device__ __forceinline__ int slab(int r, int c, int rows) {
  return ((c >> 4) * rows + r) * 16 + (c & 15);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Shared-memory plan (bytes) for a block; kp is K rounded up to BK.
struct Plan {
  int a, b, stage, scale, bytes;
  __host__ __device__ Plan(bool quant_a, int nb, int kp) {
    a = 0;
    b = a + (quant_a ? BM * kp : BM * BK);
    stage = round_up(b + nb * BN * BK, 128);
    scale = stage + nb * kWarps * 256 * 4;
    bytes = scale + BM * 4;
  }
};

template <bool QUANT_A, Epi EPI>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const void* __restrict__ a_in, const float* __restrict__ a_scale,
                 const signed char* __restrict__ bq, const float* __restrict__ sb,
                 const float* __restrict__ bias, const signed char* __restrict__ bq2,
                 const float* __restrict__ sb2, const float* __restrict__ bias2,
                 void* __restrict__ out, float* __restrict__ rowmax, int m, int n, int k) {
  constexpr int NB = EPI == Epi::GEGLU ? 2 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kp = round_up(k, BK);
  const Plan plan(QUANT_A, NB, kp);
  signed char* as = reinterpret_cast<signed char*>(smem + plan.a);
  signed char* bs = reinterpret_cast<signed char*>(smem + plan.b);
  int* stage = reinterpret_cast<int*>(smem + plan.stage);
  float* sa = reinterpret_cast<float*>(smem + plan.scale);

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 4;
  const int wn = warp % 4;

  if (QUANT_A) {
    // each warp quantizes rows warp, warp + 8, ... of the block, whole
    const bf16* x = static_cast<const bf16*>(a_in);
    for (int r = warp; r < BM; r += kWarps) {
      const int row = m0 + r;
      float amax = 0.f;
      if (row < m) {
        for (int c = lane * 8; c < k; c += 256) {
          uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)row * k + c);
          const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(__bfloat162float(v[e])));
        }
      }
      const float s = quant_scale(warp_max(amax));
      if (lane == 0) sa[r] = s;
      for (int c = lane * 8; c < kp; c += 256) {
        alignas(8) signed char q[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        if (row < m && c < k) {
          uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)row * k + c);
          const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) q[e] = quant(__bfloat162float(v[e]), s);
        }
        *reinterpret_cast<uint2*>(as + slab(r, c, BM)) = *reinterpret_cast<uint2*>(q);
      }
    }
  } else {
    for (int r = threadIdx.x; r < BM; r += kThreads) sa[r] = m0 + r < m ? a_scale[m0 + r] : 0.f;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[NB][2];
#pragma unroll
  for (int hf = 0; hf < NB; ++hf)
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::fill_fragment(acc[hf][i], 0);

  for (int k0 = 0; k0 < k; k0 += BK) {
    __syncthreads();  // the previous step's tiles are consumed
    if (!QUANT_A) {
      const signed char* aq = static_cast<const signed char*>(a_in);
      for (int i = threadIdx.x; i < BM * BK / 16; i += kThreads) {
        const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < m && k0 + c < k)
          val = *reinterpret_cast<const uint4*>(aq + (size_t)(m0 + r) * k + k0 + c);
        *reinterpret_cast<uint4*>(as + slab(r, c, BM)) = val;
      }
    }
#pragma unroll
    for (int hf = 0; hf < NB; ++hf) {
      const signed char* w = hf == 0 ? bq : bq2;
      for (int i = threadIdx.x; i < BN * BK / 16; i += kThreads) {
        const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + r < n && k0 + c < k)
          val = *reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * k + k0 + c);
        *reinterpret_cast<uint4*>(bs + hf * BN * BK + slab(r, c, BN)) = val;
      }
    }
    __syncthreads();
    // A's slabs: the whole rows (QuantA) or this step's tile
    const signed char* abase = QUANT_A ? as + (size_t)(k0 / 16) * BM * 16 : as;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], abase + (kk * BM + wm * 32 + i * 16) * 16, 16);
#pragma unroll
      for (int hf = 0; hf < NB; ++hf) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, bs + hf * BN * BK + (kk * BN + wn * 16) * 16, 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[hf][i], fa[i], fb, acc[hf][i]);
      }
    }
  }

  int* st0 = stage + warp * 256;
  int* st1 = stage + (kWarps + warp) * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    wmma::store_matrix_sync(st0, acc[0][i], 16, wmma::mem_row_major);
    if (EPI == Epi::GEGLU) wmma::store_matrix_sync(st1, acc[NB - 1][i], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = lane + 32 * j;
      const int lr = wm * 32 + i * 16 + e / 16;
      const int row = m0 + lr;
      const int col = n0 + wn * 16 + e % 16;
      const bool in = row < m && col < n;
      if (EPI == Epi::BF16) {
        if (in) {
          const float y = static_cast<float>(st0[e]) * (sa[lr] * sb[col]) + bias[col];
          static_cast<bf16*>(out)[(size_t)row * n + col] = __float2bfloat16(y);
        }
      } else {
        float habs = 0.f;
        if (in) {
          const float a = static_cast<float>(st0[e]) * (sa[lr] * sb[col]) + bias[col];
          const float g = static_cast<float>(st1[e]) * (sa[lr] * sb2[col]) + bias2[col];
          const float h = a * gelu_fast(g);
          static_cast<float*>(out)[(size_t)row * n + col] = h;
          habs = fabsf(h);
        }
        // lanes 0-15 hold row 2j of the fragment, lanes 16-31 row 2j + 1
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          habs = fmaxf(habs, __shfl_xor_sync(0xffffffffu, habs, off));
        if ((lane & 15) == 0 && row < m)
          atomicMax(reinterpret_cast<int*>(rowmax + row), __float_as_int(habs));
      }
    }
    __syncwarp();
  }
}

template <bool QUANT_A, Epi EPI>
cudaError_t launch_gemm(const void* a, const float* a_scale, const signed char* bq,
                        const float* sb, const float* bias, const signed char* bq2,
                        const float* sb2, const float* bias2, void* out, float* rowmax, int m,
                        int n, int k, cudaStream_t stream) {
  if (k % 16 != 0 || (QUANT_A && k > kMaxQuantK)) return cudaErrorInvalidValue;
  const Plan plan(QUANT_A, EPI == Epi::GEGLU ? 2 : 1, round_up(k, BK));
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_kernel<QUANT_A, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, plan.bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  int8_gemm_kernel<QUANT_A, EPI><<<grid, kThreads, plan.bytes, stream>>>(
      a, a_scale, bq, sb, bias, bq2, sb2, bias2, out, rowmax, m, n, k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdt_i8
