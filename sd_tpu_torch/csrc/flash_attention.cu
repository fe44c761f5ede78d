// Flash-attention forward for Hopper (sm_90a): softmax(Q K^T * scale) V.
//
// Replaces the TPU kernel `_kernel_chunked` / `_kernel` driven by `_fwd_bhnd`
// in sd_tpu/ops/pallas/flash_attention.py. It computes the same thing: an
// exact fp32 online softmax in base 2 (scale * log2(e) folded into the
// logits), running row max and row sum in fp32, and P rounded to bf16 before
// the P.V product, as `_kernel_chunked` does.
//
// Layout: q, o are [B, Nq, H, D] and k, v are [B, Nk, H, D], bf16, contiguous.
// A (b, h) slice is read with row stride H * D, so nothing is transposed or
// padded in device memory.
//
// What bounds it on the H100: at the UNet's N = 4096 sites the logits are
// 2 * N^2 * D flops per head against N * D bytes, so the product is compute
// bound; the naive XLA-style path instead writes the [N, N] fp32 logits to
// device memory. Design: one block per (q-tile, head, batch); a loop over K/V
// tiles keeps the logits, the probabilities and the output accumulator in
// shared memory, so device memory sees Q, K, V once per q-tile and O once.
// The products run on the tensor cores through WMMA (16x16x16 bf16 tiles,
// fp32 accumulate). The head dimension is zero-padded in shared memory to the
// next instantiated multiple of 16 (d = 40 -> 48); the ragged last K/V tile is
// zero-filled and masked to -inf before the softmax. At d = 512 (the VAE
// mid-block) the fp32 output accumulator alone is 128 KB for 64 rows, so that
// head size uses 32-row tiles (173 KB of shared memory). This is the simple
// first version: no cp.async/TMA pipelining and no wgmma yet.
//
// For training, the caller may pass an fp32 [B, H, Nq] buffer `lse`: each
// row's log-sum-exp in base 2 (running max plus log2 of the running sum, in
// units of the logits times scale * log2(e)) is written there, and the
// backward (flash_attention_bwd.cu) rebuilds P from it. Inference passes null.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory plan of one block. Pitches are padded by 16 bytes to spread
// banks; every WMMA tile starts on a 32-byte boundary.
template <int BQ, int BK, int DP>
struct Smem {
  static constexpr int LDQ = DP + 8;  // bf16 pitch of the Q, K and V tiles
  static constexpr int LDS = BK + 4;  // fp32 pitch of the logits
  static constexpr int LDP = BK + 8;  // bf16 pitch of the probabilities
  static constexpr int LDO = DP + 4;  // fp32 pitch of the output accumulator
  static constexpr int Q = 0;
  static constexpr int K = round_up(Q + BQ * LDQ * 2, 128);
  static constexpr int V = round_up(K + BK * LDQ * 2, 128);
  static constexpr int S = round_up(V + BK * LDQ * 2, 128);
  static constexpr int P = round_up(S + BQ * LDS * 4, 128);
  static constexpr int O = round_up(P + BQ * LDP * 2, 128);
  static constexpr int M = round_up(O + BQ * LDO * 4, 128);  // running row max
  static constexpr int L = M + BQ * 4;                       // running row sum
  static constexpr int BYTES = L + BQ * 4;
};

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

// Copies rows [row0, row0 + ROWS) of one (batch, head) slice into shared
// memory, 16 bytes per thread and step. Rows at or past n and columns at or
// past d are written as zeros (d is a multiple of 8).
template <int ROWS, int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int n,
                                          int row_stride, int d) {
  constexpr int CHUNKS = DP / 8;
  constexpr int LD = DP + 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += kThreads) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n && c < d)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int BQ, int BK, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int nq, int nk, int heads, int d,
                 float scale_log2e) {
  using L = Smem<BQ, BK, DP>;
  static_assert(BQ % 16 == 0 && BK % 32 == 0 && DP % 16 == 0, "tile shape");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::K);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::V);
  float* ss = reinterpret_cast<float*>(smem + L::S);
  bf16* ps = reinterpret_cast<bf16*>(smem + L::P);
  float* os = reinterpret_cast<float*>(smem + L::O);
  float* ms = reinterpret_cast<float*>(smem + L::M);
  float* ls = reinterpret_cast<float*>(smem + L::L);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row_stride = heads * d;
  const bf16* qb = q + ((size_t)b * nq * heads + h) * d;
  const bf16* kb = k + ((size_t)b * nk * heads + h) * d;
  const bf16* vb = v + ((size_t)b * nk * heads + h) * d;
  bf16* ob = o + ((size_t)b * nq * heads + h) * d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_rows<BQ, DP>(qs, qb, q0, nq, row_stride, d);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += kThreads) os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    ms[i] = -INFINITY;
    ls[i] = 0.f;
  }

  constexpr int TQ = BQ / 16;  // 16-row tiles of the q block
  constexpr int TK = BK / 16;  // 16-column tiles of the logits
  constexpr int TD = DP / 16;  // 16-column tiles of the output
  for (int k0 = 0; k0 < nk; k0 += BK) {
    load_rows<BK, DP>(ks, kb, k0, nk, row_stride, d);
    load_rows<BK, DP>(vs, vb, k0, nk, row_stride, d);
    __syncthreads();

    // S = Q K^T, one 16x16 tile per warp and step
    for (int t = warp; t < TQ * TK; t += kWarps) {
      const int ti = t / TK, tj = t % TK;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qs + ti * 16 * L::LDQ + kk, L::LDQ);
        wmma::load_matrix_sync(fb, ks + tj * 16 * L::LDQ + kk, L::LDQ);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(ss + ti * 16 * L::LDS + tj * 16, acc, L::LDS, wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax, one warp per row: new max, P = exp2(s - max) in bf16,
    // row sum from the fp32 P, and the rescale of the rows already summed
    for (int r = warp; r < BQ; r += kWarps) {
      float x[BK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int c = lane + 32 * j;
        x[j] = (k0 + c < nk) ? ss[r * L::LDS + c] * scale_log2e : -INFINITY;
        mx = fmaxf(mx, x[j]);
      }
      mx = warp_max(mx);
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const float p = exp2f(x[j] - m_new);
        sum += p;
        ps[r * L::LDP + lane + 32 * j] = __float2bfloat16(p);
      }
      sum = warp_sum(sum);
      const float corr = exp2f(m_old - m_new);
      for (int c = lane; c < DP; c += 32) os[r * L::LDO + c] *= corr;
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = ls[r] * corr + sum;
      }
    }
    __syncthreads();

    // O += P V, the accumulator tiles kept in shared memory
    for (int t = warp; t < TQ * TD; t += kWarps) {
      const int ti = t / TD, tj = t % TD;
      float* optr = os + ti * 16 * L::LDO + tj * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, optr, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, ps + ti * 16 * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(fb, vs + kk * L::LDQ + tj * 16, L::LDQ);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(optr, acc, L::LDO, wmma::mem_row_major);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < BQ * d; i += kThreads) {
    const int r = i / d, c = i % d;
    if (q0 + r < nq)
      ob[(size_t)(q0 + r) * row_stride + c] = __float2bfloat16(os[r * L::LDO + c] / ls[r]);
  }
  if (lse != nullptr) {
    float* lb = lse + ((size_t)b * heads + h) * nq;
    for (int r = threadIdx.x; r < BQ; r += kThreads)
      if (q0 + r < nq) lb[q0 + r] = ms[r] + log2f(ls[r]);
  }
}

template <int BQ, int BK, int DP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int batch,
                   int nq, int nk, int heads, int d, float scale_log2e, cudaStream_t stream) {
  constexpr int bytes = Smem<BQ, BK, DP>::BYTES;
  static_assert(bytes <= 232448, "shared memory per block");
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<BQ, BK, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((nq + BQ - 1) / BQ, heads, batch);
  flash_fwd_kernel<BQ, BK, DP><<<grid, kThreads, bytes, stream>>>(q, k, v, o, lse, nq, nk, heads,
                                                                  d, scale_log2e);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success). d must be a
// multiple of 8 and at most 512; the wrapper checks shapes and alignment.
// `lse` is null, or fp32 [B, H, Nq] for the row log-sum-exp.
extern "C" int sdt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int batch, int nq, int nk, int heads, int d,
                                   float scale, void* stream) {
  const float sl = scale * 1.4426950408889634f;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 16) return launch<64, 64, 16>(qp, kp, vp, op, lp, batch, nq, nk, heads, d, sl, s);
  if (d <= 32) return launch<64, 64, 32>(qp, kp, vp, op, lp, batch, nq, nk, heads, d, sl, s);
  if (d <= 48) return launch<64, 64, 48>(qp, kp, vp, op, lp, batch, nq, nk, heads, d, sl, s);
  if (d <= 64) return launch<64, 64, 64>(qp, kp, vp, op, lp, batch, nq, nk, heads, d, sl, s);
  if (d <= 80) return launch<64, 64, 80>(qp, kp, vp, op, lp, batch, nq, nk, heads, d, sl, s);
  if (d <= 128) return launch<64, 64, 128>(qp, kp, vp, op, lp, batch, nq, nk, heads, d, sl, s);
  if (d <= 160) return launch<64, 64, 160>(qp, kp, vp, op, lp, batch, nq, nk, heads, d, sl, s);
  if (d <= 256) return launch<32, 32, 256>(qp, kp, vp, op, lp, batch, nq, nk, heads, d, sl, s);
  if (d <= 512) return launch<32, 32, 512>(qp, kp, vp, op, lp, batch, nq, nk, heads, d, sl, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* sdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
