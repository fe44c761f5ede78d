// GEGLU feed-forward for Hopper (sm_90a):
//   a, g = x W1a^T + b1a, x W1g^T + b1g;  h = bf16(a * gelu(g));  y = h W2^T + b2
//
// Replaces the TPU kernel `_kernel` called through `_geglu_ff` in
// sd_tpu/ops/pallas/geglu_ff.py. That kernel keeps a whole [bm, inner] row
// tile of h in VMEM; on Hopper a row tile of h at inner = 5120 does not fit in
// the 227 KB of shared memory a block may use. So the port keeps what matters
// out of device memory in two launches, both written here:
//   1. a GEMM whose blocks compute matching value and gate column tiles of
//      x [M, C] times W1 [2I, C]^T. The epilogue applies a * gelu(g) in fp32
//      and rounds h to bf16, where the TPU kernel rounds it; only h [M, I]
//      bf16 is written, never the fp32 [M, 2I] projection;
//   2. a GEMM h [M, I] times W2 [C_out, I]^T plus b2, written as bf16.
// GELU is the exact form with CUDA's erff, not the TPU kernel's short erf
// polynomial (_ERF_FAST, max error 3.6e-4), which exists for the TPU's vector
// unit.
//
// What bounds it on the H100: at the SD sites (M = 2 * batch * 4096 ... 64,
// C = 320 ... 1280, I = 4C) the products are 6 * M * C * I flops against
// about 2 * M * (C + I) bytes of activations, so with large M they are
// compute bound and the design question is tensor-core feed. This first
// version is a plain tiled WMMA GEMM (128x64 output tile, 32-deep k-steps,
// 8 warps of 32x32, fp32 accumulate) with bias folded into the initial
// accumulator. No cp.async/TMA pipeline and no wgmma yet.
//
// Weights are in torch Linear layout ([out, in], row-major), so both operands
// of each product are contiguous along k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;       // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // k per step
constexpr int LDA = BK + 8;   // bf16 pitch of the operand tiles
constexpr int LDB = BN + 4;   // fp32 pitch of the bias rows
constexpr int kWarps = 8;     // 4 (rows) x 2 (columns), 32x32 each
constexpr int kThreads = kWarps * 32;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// out[m, n] = bf16(x . w[n]^T + bias[n]) or, with GEGLU, the gated product of
// the value row w[n] and the gate row w[n + n_out] (bias likewise).
template <bool GEGLU>
__global__ void __launch_bounds__(kThreads)
gemm_nt_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ out, int m, int n_out,
               int k) {
  constexpr int NB = GEGLU ? 2 : 1;  // weight halves: value (and gate)
  __shared__ __align__(128) bf16 xs[BM * LDA];
  __shared__ __align__(128) bf16 ws[NB][BN * LDA];
  __shared__ __align__(128) float bs[NB][16 * LDB];
  __shared__ __align__(128) float stage[kWarps][16 * 16];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 2;  // warp tile rows wm * 32 ...
  const int wn = warp % 2;  // warp tile columns wn * 32 ...

  // 16 copies of the bias row, so each accumulator starts from the bias
  for (int i = threadIdx.x; i < NB * 16 * BN; i += kThreads) {
    const int half = i / (16 * BN);
    const int r = (i / BN) % 16;
    const int c = i % BN;
    const int col = n0 + c;
    bs[half][r * LDB + c] = col < n_out ? bias[half * n_out + col] : 0.f;
  }
  __syncthreads();

  Acc acc[NB][2][2];
#pragma unroll
  for (int hf = 0; hf < NB; ++hf)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(acc[hf][i][j], &bs[hf][wn * 32 + j * 16], LDB,
                               wmma::mem_row_major);

  for (int k0 = 0; k0 < k; k0 += BK) {
    // 16-byte loads; rows past the edge and k past the end are zeros (k % 8 == 0)
    for (int i = threadIdx.x; i < BM * BK / 8; i += kThreads) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m && k0 + c < k)
        val = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * k + k0 + c);
      *reinterpret_cast<uint4*>(xs + r * LDA + c) = val;
    }
#pragma unroll
    for (int hf = 0; hf < NB; ++hf) {
      for (int i = threadIdx.x; i < BN * BK / 8; i += kThreads) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + r < n_out && k0 + c < k)
          val = *reinterpret_cast<const uint4*>(w + (size_t)(hf * n_out + n0 + r) * k + k0 + c);
        *reinterpret_cast<uint4*>(ws[hf] + r * LDA + c) = val;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], xs + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int hf = 0; hf < NB; ++hf)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, ws[hf] + (wn * 32 + j * 16) * LDA + kk, LDA);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[hf][i][j], fa[i], fb, acc[hf][i][j]);
        }
    }
    __syncthreads();
  }

  // epilogue: value and gate accumulators of the same type hold the same
  // elements at the same positions, so the gating is elementwise on them
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (GEGLU) {
#pragma unroll
        for (int e = 0; e < acc[0][i][j].num_elements; ++e) {
          const float g = acc[NB - 1][i][j].x[e];
          acc[0][i][j].x[e] *= 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
        }
      }
      wmma::store_matrix_sync(st, acc[0][i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = m0 + wm * 32 + i * 16 + e / 16;
        const int col = n0 + wn * 32 + j * 16 + e % 16;
        if (row < m && col < n_out) out[(size_t)row * n_out + col] = __float2bfloat16(st[e]);
      }
      __syncwarp();
    }
}

}  // namespace

// x [m, c], w1 [2 * inner, c] (value rows first), b1 [2 * inner] fp32,
// w2 [c_out, inner], b2 [c_out] fp32, h [m, inner] scratch, y [m, c_out].
// Returns the CUDA error code of the launches (0 on success). c and inner
// must be multiples of 8; the wrapper checks shapes and alignment.
extern "C" int sdt_geglu_ff(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* h, void* y, int m, int c, int inner,
                            int c_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid1((inner + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_nt_kernel<true><<<grid1, kThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<bf16*>(h), m, inner, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid2((c_out + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_nt_kernel<false><<<grid2, kThreads, 0, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<bf16*>(y), m, c_out, inner);
  return static_cast<int>(cudaGetLastError());
}
