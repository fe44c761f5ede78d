// Flash-attention backward for Hopper (sm_90a): dQ, dK, dV of
// O = softmax(Q K^T * scale) V, with the softmax recomputed.
//
// Replaces the TPU kernel `_bwd_kernel` driven by `_bwd_bhnd_pallas` in
// sd_tpu/ops/pallas/flash_attention.py. It computes the same thing:
//
//   p  = softmax(q k^T * scale)          recomputed, fp32
//   dV = bf16(p)^T dO                    fp32 accumulate
//   dP = dO v^T                          fp32
//   delta = rowsum(dO * o)               fp32
//   dS = bf16(p * (dP - delta) * scale)
//   dQ = dS k,  dK = dS^T q              fp32 accumulate, stored as bf16
//
// with the TPU kernel's two roundings to bf16 (`p_lo` and `ds`).
//
// Layout: q, o, dO, dQ are [B, Nq, H, D] and k, v, dK, dV are [B, Nk, H, D],
// bf16, contiguous; a (b, h) slice is read with row stride H * D, as K1 reads
// it. lse is K1's fp32 [B, H, Nq] row log-sum-exp in base 2 (m + log2 l of
// the logits times scale * log2(e)), so p = exp2(s * scale * log2(e) - lse).
//
// What bounds it on the H100: five products of 2 * Nq * Nk * D flops per
// head, 10 * B * H * Nq * Nk * D in all: 0.217 ms at [4, 4096, 8, 40] and
// 0.027 ms at [4, 1024, 8, 80] at the H100 SXM's published 989 TFLOP/s dense
// bf16 peak (at its 700 W limit); the bytes (q, k, v, o, dO in, dQ, dK, dV
// out, and the fp32 lse) take 0.025 and 0.013 ms at 3.35 TB/s. So it is
// bound by operations.
//
// Design. The TPU kernel keeps a whole K/V row in VMEM and carries dK/dV
// across a sequential q-block grid axis; here blocks run in parallel and in
// no order, so the work is split into three launches with no atomics, each
// output written once and the result deterministic:
//   1. delta: one warp per (b, n, h) row sums dO * o in fp32;
//   2. dK/dV: one block per (64-key tile, head, batch) loops over every
//      64-row q tile, rebuilds P from lse, and accumulates dK and dV in fp32
//      shared memory;
//   3. dQ: one block per (64-row q tile, head, batch) loops over the K/V
//      tiles and accumulates dQ in fp32 shared memory.
// S and dP are recomputed in both 2 and 3 (seven products instead of five),
// the price of having no atomics. The products run on the tensor cores
// through WMMA (16x16x16 bf16, fp32 accumulate), with 8 warps a block. The
// head dimension is zero-padded in shared memory to the next multiple of 16
// (d = 40 -> 48); ragged edges are zero-filled and masked to p = 0. d must be
// a multiple of 8 and at most 128 (190 KB of shared memory at d = 128). This
// is the simple first version: no cp.async/TMA pipelining, no wgmma, no
// register-resident accumulators yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int BQ = 64;  // q rows per tile
constexpr int BK = 64;  // key rows per tile

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory plan of one block. Pitches are padded by 16 bytes to spread
// banks; every WMMA tile starts on a 32-byte boundary.
template <int DP>
struct Smem {
  static constexpr int LDQ = DP + 8;  // bf16 pitch of the Q, dO, K and V tiles
  static constexpr int LDS = BK + 4;  // fp32 pitch of S (then P) and dP
  static constexpr int LDP = BK + 8;  // bf16 pitch of bf16(P) and dS
  static constexpr int LDA = DP + 4;  // fp32 pitch of the accumulators
  static constexpr int Q = 0;
  static constexpr int DO = round_up(Q + BQ * LDQ * 2, 128);
  static constexpr int K = round_up(DO + BQ * LDQ * 2, 128);
  static constexpr int V = round_up(K + BK * LDQ * 2, 128);
  static constexpr int S = round_up(V + BK * LDQ * 2, 128);
  static constexpr int DP_ = round_up(S + BQ * LDS * 4, 128);
  static constexpr int PB = round_up(DP_ + BQ * LDS * 4, 128);
  static constexpr int DS = round_up(PB + BQ * LDP * 2, 128);
  static constexpr int ACC0 = round_up(DS + BQ * LDP * 2, 128);  // dK, or dQ
  static constexpr int ACC1 = round_up(ACC0 + 64 * LDA * 4, 128);  // dV
  static constexpr int LSE = round_up(ACC1 + 64 * LDA * 4, 128);
  static constexpr int DELTA = LSE + BQ * 4;
  static constexpr int BYTES = DELTA + BQ * 4;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copies rows [row0, row0 + 64) of one (batch, head) slice into shared
// memory, 16 bytes per thread and step. Rows at or past n and columns at or
// past d are written as zeros (d is a multiple of 8).
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int n,
                                          int row_stride, int d) {
  constexpr int CHUNKS = DP / 8;
  constexpr int LD = DP + 8;
  for (int i = threadIdx.x; i < 64 * CHUNKS; i += kThreads) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n && c < d)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// c[64 x 64] (fp32) = a[64 x DP] b[64 x DP]^T, both bf16 row-major.
template <int DP>
__device__ __forceinline__ void gemm_nt(float* c, int ldc, const bf16* a, const bf16* b,
                                        int warp) {
  constexpr int LD = DP + 8;
  for (int t = warp; t < 16; t += kWarps) {
    const int ti = t / 4, tj = t % 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + ti * 16 * LD + kk, LD);
      wmma::load_matrix_sync(fb, b + tj * 16 * LD + kk, LD);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + ti * 16 * ldc + tj * 16, acc, ldc, wmma::mem_row_major);
  }
}

// acc[64 x DP] (fp32) += op(a) b, with a bf16 [64 x 64] (pitch lda) and
// b bf16 [64 x DP] row-major. op(a) = a^T when A_T, else a.
template <int DP, bool A_T>
__device__ __forceinline__ void gemm_acc(float* acc, const bf16* a, int lda, const bf16* b,
                                         int warp) {
  constexpr int LD = DP + 8;
  constexpr int LDA = DP + 4;
  constexpr int TD = DP / 16;
  using layout_a = typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
  for (int t = warp; t < 4 * TD; t += kWarps) {
    const int ti = t / TD, tj = t % TD;
    float* cptr = acc + ti * 16 * LDA + tj * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::load_matrix_sync(c, cptr, LDA, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, layout_a> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      // a^T (r, c) = a[c][r]: read column-major at the tile of a's rows kk..
      const bf16* aptr = A_T ? a + kk * lda + ti * 16 : a + ti * 16 * lda + kk;
      wmma::load_matrix_sync(fa, aptr, lda);
      wmma::load_matrix_sync(fb, b + kk * LD + tj * 16, LD);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(cptr, c, LDA, wmma::mem_row_major);
  }
}

// Loads 64 fp32 row statistics starting at row0; rows past n read as 0.
__device__ __forceinline__ void load_stats(float* dst, const float* src, int row0, int n) {
  for (int i = threadIdx.x; i < BQ; i += kThreads) dst[i] = (row0 + i < n) ? src[row0 + i] : 0.f;
}

// delta[b, h, n] = sum_d dO[b, n, h, d] * o[b, n, h, d], one warp per row.
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int nq, int heads, int d, long long rows) {
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* op = o + row * d;
  const bf16* dp = dout + row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += __bfloat162float(op[c]) * __bfloat162float(dp[c]);
  s = warp_sum(s);
  if (lane == 0) {
    const long long bn = row / heads;  // b * nq + n
    const int h = (int)(row % heads);
    const long long b = bn / nq;
    const int n = (int)(bn % nq);
    delta[(b * heads + h) * nq + n] = s;
  }
}

// One block per (64-key tile, head, batch): dK and dV of those keys.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int nq, int nk, int heads,
                      int d, float scale, float scale_log2e) {
  using L = Smem<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* dos = reinterpret_cast<bf16*>(smem + L::DO);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::K);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::V);
  float* ss = reinterpret_cast<float*>(smem + L::S);
  float* dps = reinterpret_cast<float*>(smem + L::DP_);
  bf16* pbs = reinterpret_cast<bf16*>(smem + L::PB);
  bf16* dss = reinterpret_cast<bf16*>(smem + L::DS);
  float* dks = reinterpret_cast<float*>(smem + L::ACC0);
  float* dvs = reinterpret_cast<float*>(smem + L::ACC1);
  float* lses = reinterpret_cast<float*>(smem + L::LSE);
  float* deltas = reinterpret_cast<float*>(smem + L::DELTA);

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row_stride = heads * d;
  const bf16* qb = q + ((size_t)b * nq * heads + h) * d;
  const bf16* dob = dout + ((size_t)b * nq * heads + h) * d;
  const bf16* kb = k + ((size_t)b * nk * heads + h) * d;
  const bf16* vb = v + ((size_t)b * nk * heads + h) * d;
  const float* lseb = lse + ((size_t)b * heads + h) * nq;
  const float* deltab = delta + ((size_t)b * heads + h) * nq;
  const int warp = threadIdx.x / 32;

  load_rows<DP>(ks, kb, k0, nk, row_stride, d);
  load_rows<DP>(vs, vb, k0, nk, row_stride, d);
  for (int i = threadIdx.x; i < 64 * L::LDA; i += kThreads) {
    dks[i] = 0.f;
    dvs[i] = 0.f;
  }

  for (int q0 = 0; q0 < nq; q0 += BQ) {
    load_rows<DP>(qs, qb, q0, nq, row_stride, d);
    load_rows<DP>(dos, dob, q0, nq, row_stride, d);
    load_stats(lses, lseb, q0, nq);
    load_stats(deltas, deltab, q0, nq);
    __syncthreads();

    gemm_nt<DP>(ss, L::LDS, qs, ks, warp);    // S = Q K^T
    gemm_nt<DP>(dps, L::LDS, dos, vs, warp);  // dP = dO V^T
    __syncthreads();

    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const float p = (q0 + r < nq && k0 + c < nk)
                          ? exp2f(ss[r * L::LDS + c] * scale_log2e - lses[r]) : 0.f;
      pbs[r * L::LDP + c] = __float2bfloat16(p);
      dss[r * L::LDP + c] = __float2bfloat16(p * (dps[r * L::LDS + c] - deltas[r]) * scale);
    }
    __syncthreads();

    gemm_acc<DP, true>(dvs, pbs, L::LDP, dos, warp);  // dV += bf16(P)^T dO
    gemm_acc<DP, true>(dks, dss, L::LDP, qs, warp);   // dK += dS^T Q
    __syncthreads();
  }

  bf16* dkb = dk + ((size_t)b * nk * heads + h) * d;
  bf16* dvb = dv + ((size_t)b * nk * heads + h) * d;
  for (int i = threadIdx.x; i < BK * d; i += kThreads) {
    const int r = i / d, c = i % d;
    if (k0 + r < nk) {
      dkb[(size_t)(k0 + r) * row_stride + c] = __float2bfloat16(dks[r * L::LDA + c]);
      dvb[(size_t)(k0 + r) * row_stride + c] = __float2bfloat16(dvs[r * L::LDA + c]);
    }
  }
}

// One block per (64-row q tile, head, batch): dQ of those rows.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int nq, int nk, int heads, int d, float scale,
                    float scale_log2e) {
  using L = Smem<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* dos = reinterpret_cast<bf16*>(smem + L::DO);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::K);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::V);
  float* ss = reinterpret_cast<float*>(smem + L::S);
  float* dps = reinterpret_cast<float*>(smem + L::DP_);
  bf16* dss = reinterpret_cast<bf16*>(smem + L::DS);
  float* dqs = reinterpret_cast<float*>(smem + L::ACC0);
  float* lses = reinterpret_cast<float*>(smem + L::LSE);
  float* deltas = reinterpret_cast<float*>(smem + L::DELTA);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row_stride = heads * d;
  const bf16* qb = q + ((size_t)b * nq * heads + h) * d;
  const bf16* dob = dout + ((size_t)b * nq * heads + h) * d;
  const bf16* kb = k + ((size_t)b * nk * heads + h) * d;
  const bf16* vb = v + ((size_t)b * nk * heads + h) * d;
  const int warp = threadIdx.x / 32;

  load_rows<DP>(qs, qb, q0, nq, row_stride, d);
  load_rows<DP>(dos, dob, q0, nq, row_stride, d);
  load_stats(lses, lse + ((size_t)b * heads + h) * nq, q0, nq);
  load_stats(deltas, delta + ((size_t)b * heads + h) * nq, q0, nq);
  for (int i = threadIdx.x; i < 64 * L::LDA; i += kThreads) dqs[i] = 0.f;

  for (int k0 = 0; k0 < nk; k0 += BK) {
    load_rows<DP>(ks, kb, k0, nk, row_stride, d);
    load_rows<DP>(vs, vb, k0, nk, row_stride, d);
    __syncthreads();

    gemm_nt<DP>(ss, L::LDS, qs, ks, warp);    // S = Q K^T
    gemm_nt<DP>(dps, L::LDS, dos, vs, warp);  // dP = dO V^T
    __syncthreads();

    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const float p = (q0 + r < nq && k0 + c < nk)
                          ? exp2f(ss[r * L::LDS + c] * scale_log2e - lses[r]) : 0.f;
      dss[r * L::LDP + c] = __float2bfloat16(p * (dps[r * L::LDS + c] - deltas[r]) * scale);
    }
    __syncthreads();

    gemm_acc<DP, false>(dqs, dss, L::LDP, ks, warp);  // dQ += dS K
    __syncthreads();
  }

  bf16* dqb = dq + ((size_t)b * nq * heads + h) * d;
  for (int i = threadIdx.x; i < BQ * d; i += kThreads) {
    const int r = i / d, c = i % d;
    if (q0 + r < nq) dqb[(size_t)(q0 + r) * row_stride + c] = __float2bfloat16(dqs[r * L::LDA + c]);
  }
}

template <int DP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                   const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv, int batch,
                   int nq, int nk, int heads, int d, float scale, cudaStream_t stream) {
  constexpr int bytes = Smem<DP>::BYTES;
  static_assert(bytes <= 232448, "shared memory per block");
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const float sl = scale * 1.4426950408889634f;

  const long long rows = (long long)batch * nq * heads;
  const unsigned delta_blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  flash_bwd_delta_kernel<<<delta_blocks, kThreads, 0, stream>>>(o, dout, delta, nq, heads, d,
                                                                rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid_kv((nk + BK - 1) / BK, heads, batch);
  flash_bwd_dkdv_kernel<DP><<<grid_kv, kThreads, bytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, nq, nk, heads, d, scale, sl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid_q((nq + BQ - 1) / BQ, heads, batch);
  flash_bwd_dq_kernel<DP><<<grid_q, kThreads, bytes, stream>>>(q, k, v, dout, lse, delta, dq,
                                                               nq, nk, heads, d, scale, sl);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error code of the launches (0 on success). `delta` is fp32
// scratch of [B, H, Nq]. d must be a multiple of 8 and at most 128; the
// wrapper checks shapes, types and alignment.
extern "C" int sdt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, int batch,
                                       int nq, int nk, int heads, int d, float scale,
                                       void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* op = static_cast<const bf16*>(o);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  bf16* dqp = static_cast<bf16*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SDT_BWD(DP) \
  launch<DP>(qp, kp, vp, op, dop, lp, dl, dqp, dkp, dvp, batch, nq, nk, heads, d, scale, s)
  if (d % 8 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 16) return SDT_BWD(16);
  if (d <= 32) return SDT_BWD(32);
  if (d <= 48) return SDT_BWD(48);
  if (d <= 64) return SDT_BWD(64);
  if (d <= 80) return SDT_BWD(80);
  if (d <= 96) return SDT_BWD(96);
  if (d <= 112) return SDT_BWD(112);
  if (d <= 128) return SDT_BWD(128);
#undef SDT_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
