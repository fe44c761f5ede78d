// Device pieces of X2 (tail_fused.cu), a fused transformer-block kernel:
// the single-pass LayerNorm of a row, the copy of one head's rows into
// shared memory, and a block-wide GEMM whose left operand is a tile of rows
// already in shared memory.
//
// Blocks have 4 warps. Tiles in shared memory keep a bf16 pitch that is a
// multiple of 8 elements, so every 16-row WMMA tile starts on a 32-byte
// boundary; the columns past the data up to the next multiple of GBK are
// zeros, so a product may run over them (zero times a weight read as zero).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace sdt_block {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int GBN = 64;        // output columns of one block_gemm chunk (one 16-wide tile a warp)
constexpr int GBK = 32;        // weight rows per slab
constexpr int LDW = GBN + 8;   // bf16 pitch of a weight slab
constexpr int LDST = GBN + 4;  // fp32 pitch of the staging tile
constexpr float kLnEps = 1e-5f;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

__host__ __device__ inline int align128(int x) { return round_up(x, 128); }

// bf16 pitch of a [rows, c] tile whose product runs over round_up(c, GBK) columns
__host__ __device__ inline int tile_pitch(int c) { return round_up(c, GBK) + 8; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The TPU kernels' _ln on one row, by one warp: fp32 mean and E[x^2] in one
// pass, var = E[x^2] - mean^2 clamped at 0 (a no-op wherever the TPU kernel
// is finite), (x - mean) * rsqrt(var + 1e-5) * gamma + beta rounded to bf16.
// src and dst may be the same row: each lane rewrites the 8 values it read.
// Writes zeros in [c, kp). c is a multiple of 8.
__device__ __forceinline__ void ln_row(const bf16* src, bf16* dst, int c, int kp,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta, int lane) {
  float s = 0.f, s2 = 0.f;
  for (int j = lane * 8; j < c; j += 256) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + j);
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float f = __bfloat162float(v[e]);
      s += f;
      s2 += f * f;
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = s / c;
  const float var = fmaxf(s2 / c - mean * mean, 0.f);
  const float rs = rsqrtf(var + kLnEps);
  for (int j = lane * 8; j < c; j += 256) {
    uint4 raw = *reinterpret_cast<const uint4*>(src + j);
    bf16* v = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float y = (__bfloat162float(v[e]) - mean) * rs;
      v[e] = __float2bfloat16(y * gamma[j + e] + beta[j + e]);
    }
    *reinterpret_cast<uint4*>(dst + j) = raw;
  }
  for (int j = c + lane; j < kp; j += 32) dst[j] = __float2bfloat16(0.f);
}

// LayerNorm of rows [row0, row0 + rows) of src ([*, c], row pitch lds) into
// the tile t (pitch ldt), one warp a row; rows at or past `valid` are zeros.
__device__ __forceinline__ void ln_rows(const bf16* src, int lds, int row0, int rows, int valid,
                                        int c, const float* __restrict__ gamma,
                                        const float* __restrict__ beta, bf16* t, int ldt) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kp = round_up(c, GBK);
  for (int r = warp; r < rows; r += kWarps) {
    bf16* dst = t + (size_t)r * ldt;
    if (row0 + r < valid) {
      ln_row(src + (size_t)(row0 + r) * lds, dst, c, kp, gamma, beta, lane);
    } else {
      for (int j = lane; j < kp; j += 32) dst[j] = __float2bfloat16(0.f);
    }
  }
}

// Copies rows [row0, row0 + rows) and columns [0, d) of a head's slice
// (row pitch `stride` elements) into dst (pitch ld), 16 bytes a thread and
// step; rows at or past `valid` and columns [d, dp) are zeros. d and dp are
// multiples of 8.
__device__ __forceinline__ void load_head_rows(bf16* dst, int ld, const bf16* src, size_t stride,
                                               int row0, int rows, int valid, int d, int dp) {
  const int chunks = dp / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < valid && c < d)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// stage[hf] [ROWS, LDST] (fp32) = a [ROWS, k] (shared, pitch lda, zeros in
// [k, round_up(k, GBK))) times columns [n0, n0 + GBN) of w[hf] (device
// memory, [k, ldw] row-major: the [in, out] layout), for each of the NW
// weights. Weight columns at or past n_end read as zeros, so the staged
// columns past n_end are zeros. Warp w owns the 16-wide column tile w of every
// row tile, so each B fragment serves ROWS / 16 products. Weight slabs go
// through wbuf (NW * GBK * LDW bf16). Starts and ends with __syncthreads().
template <int ROWS, int NW>
__device__ __forceinline__ void block_gemm(const bf16* a, int lda, const bf16* const* w, int ldw,
                                           int k, int n0, int n_end, bf16* wbuf, float* stage) {
  constexpr int TPW = ROWS / 16;
  static_assert(ROWS % 16 == 0, "row tile");
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NW][TPW];
#pragma unroll
  for (int hf = 0; hf < NW; ++hf)
#pragma unroll
    for (int i = 0; i < TPW; ++i) wmma::fill_fragment(acc[hf][i], 0.f);

  for (int k0 = 0; k0 < k; k0 += GBK) {
    __syncthreads();
#pragma unroll
    for (int hf = 0; hf < NW; ++hf) {
      for (int i = threadIdx.x; i < GBK * GBN / 8; i += kThreads) {
        const int r = i / (GBN / 8);
        const int c = (i % (GBN / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < k && n0 + c < n_end)
          val = *reinterpret_cast<const uint4*>(w[hf] + (size_t)(k0 + r) * ldw + n0 + c);
        *reinterpret_cast<uint4*>(wbuf + hf * GBK * LDW + r * LDW + c) = val;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[TPW];
#pragma unroll
      for (int i = 0; i < TPW; ++i)
        wmma::load_matrix_sync(fa[i], a + (size_t)i * 16 * lda + k0 + kk, lda);
#pragma unroll
      for (int hf = 0; hf < NW; ++hf) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, wbuf + hf * GBK * LDW + kk * LDW + warp * 16, LDW);
#pragma unroll
        for (int i = 0; i < TPW; ++i) wmma::mma_sync(acc[hf][i], fa[i], fb, acc[hf][i]);
      }
    }
  }
#pragma unroll
  for (int hf = 0; hf < NW; ++hf)
#pragma unroll
    for (int i = 0; i < TPW; ++i)
      wmma::store_matrix_sync(stage + hf * ROWS * LDST + i * 16 * LDST + warp * 16, acc[hf][i],
                              LDST, wmma::mem_row_major);
  __syncthreads();
}

}  // namespace sdt_block
