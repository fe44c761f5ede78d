// K3, flash-attention backward for Hopper (sm_90a): dQ, dK, dV of
// O = softmax(Q K^T * scale) V, with the softmax recomputed.
//
// Replaces the TPU kernel `_bwd_kernel` driven by `_bwd_bhnd_pallas` in
// sd_tpu/ops/pallas/flash_attention.py and computes the same thing:
//
//   p  = exp2(s * scale * log2(e) - lse)   recomputed from K1's lse, fp32
//   dV = bf16(p)^T dO                      fp32 accumulate
//   dP = dO v^T                            fp32
//   delta = rowsum(dO * o)                 fp32
//   dS = bf16(p * (dP - delta) * scale)
//   dQ = dS k,  dK = dS^T q                fp32 accumulate, stored as bf16
//
// with the TPU kernel's two roundings to bf16 (`p_lo` and `ds`).
//
// Layout: q, o, dO, dQ are [B, Nq, H, D] and k, v, dK, dV are [B, Nk, H, D],
// bf16, contiguous; a (b, h) slice is read with row stride H * D, as K1 reads
// it. lse is K1's fp32 [B, H, Nq] row log-sum-exp in base 2 (m + log2 l of
// the logits times scale * log2(e)).
//
// What bounds it on the H100: operations. Five products of 2 * Nq * Nk * D
// flops per head, 10 * B * H * Nq * Nk * D in all: 0.217 ms at [4, 4096, 8,
// 40] and 0.027 ms at [4, 1024, 8, 80] at the H100 SXM's 989 TFLOP/s dense
// bf16 peak, against 0.025 and 0.013 ms for the bytes (q, k, v, o, dO in,
// dQ, dK, dV out, and the fp32 lse) at 3.35 TB/s.
//
// Design. Blocks run in parallel and in no order, so dK/dV and dQ come from
// two passes, each output written once by the block that owns it: no
// atomics, and the result is deterministic. Three launches, one call:
//   1. delta: one warp per (b, n, h) row sums dO * o in fp32;
//   2. dK/dV: a block of 4 warps owns 64 keys, each warp 16, and loops over
//      the q tiles (64 rows; 32 at d > 64). A warp computes S^T = K Q^T and
//      dP^T = V dO^T for its 16 keys on mma.sync.m16n8k16, rebuilds P^T and
//      dS^T in registers from lse and delta (indexed by the column, the
//      query), repacks both as bf16 A fragments (flash_mma.cuh) and
//      accumulates dV += P^T dO and dK += dS^T Q in registers;
//   3. dQ: a block of 4 warps owns 64 query rows, each warp 16 (at d <= 48
//      128 rows, each warp two m-tiles of 16, so that each K and V fragment
//      read from shared memory serves two products), with Q's and dO's
//      fragments loaded once, and loops over the key tiles (64 keys; 32 at
//      d > 64 or with two m-tiles): S = Q K^T and dP = dO V^T, P and dS in
//      registers, dQ += dS K in registers.
// S and dP are computed in both passes (seven products instead of five), the
// price of having no atomics. In both the streamed tiles (Q, dO, lse, delta;
// K, V) are double-buffered in shared memory by cp.async and read with
// ldmatrix (.trans where the tile is the product's B with the head dim as
// its columns), with one __syncthreads per tile. The contraction over the
// head dim is zero-padded in shared memory to a multiple of 16 (d = 40 ->
// 48); the ragged edges are zero-filled, and p and dS are set to 0 outside
// the valid rows and columns (selected, never computed from -inf). d must be
// a multiple of 8 and at most 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

using sdt::bf16;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The dQ pass's 16-row m-tiles per warp: two where the padded head dim is at
// most 48 and the accumulators of both fit in the registers, so that each B
// fragment read from shared memory serves two products. The dK/dV pass keeps
// one: its four accumulators of two m-tiles would spill.
__host__ __device__ constexpr int dq_m_tiles(int dk) { return dk <= 48 ? 2 : 1; }

// dS from p, dP and the row's delta, before its rounding to bf16.
__device__ __forceinline__ float ds_of(float p, float dp, float delta, float scale) {
  return p * (dp - delta) * scale;
}

// Copies rows [row0, row0 + ROWS) of one (batch, head) slice, the first d
// columns, into shared memory at pitch LD; rows at or past n are zero-filled.
template <int ROWS, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int n,
                                          int row_stride, int chunks) {
  for (int i = threadIdx.x; i < ROWS * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 8;
    const bool valid = row0 + r < n;
    sdt::cp_async16(dst + r * LD + c, src + (size_t)(valid ? row0 + r : 0) * row_stride + c,
                    valid);
  }
}

// Copies ROWS fp32 row statistics from row0; rows at or past n read as 0.
template <int ROWS>
__device__ __forceinline__ void load_stats(float* dst, const float* src, int row0, int n) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
    const bool valid = row0 + i < n;
    sdt::cp_async4(dst + i, src + (valid ? row0 + i : 0), valid);
  }
}

template <int DK, int LD>
__device__ __forceinline__ void zero_padding(bf16* base, int rows, int d) {
  const int pad = (DK - d) / 8;
  for (int i = threadIdx.x; i < rows * pad; i += kThreads) {
    const int r = i / pad;
    *reinterpret_cast<uint4*>(base + r * LD + d + (i - r * pad) * 8) = make_uint4(0, 0, 0, 0);
  }
}

// c[mt][16 x 8 * N] += a[mt] b^T over the padded head dim for each of MT
// m-tiles: a's A fragments in registers (KD k16 steps), b's rows (the n
// side) in shared memory at pitch LD, two n8 tiles per ldmatrix, each
// serving every m-tile.
template <int MT, int N, int KD, int LD>
__device__ __forceinline__ void gemm_abt(float (&c)[MT][N][4], const unsigned (&a)[MT][KD][4],
                                         const bf16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
    for (int jp = 0; jp < N / 2; ++jp) {
      unsigned f[4];
      sdt::ldmatrix_x4(f, b + (jp * 16 + lane % 8 + lane / 16 * 8) * LD + kk * 16 +
                              (lane / 8) % 2 * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        sdt::mma(c[mt][2 * jp], a[mt][kk], f[0], f[1]);
        sdt::mma(c[mt][2 * jp + 1], a[mt][kk], f[2], f[3]);
      }
    }
  }
}

// c[mt][16 x d] += a[mt] b for each of MT m-tiles: a's A fragments in
// registers (KS k16 steps over b's rows), b row-major in shared memory at
// pitch LD with the head dim as its columns; n8 tiles at or past nv = d / 8
// are skipped.
template <int MT, int NO, int KS, int LD>
__device__ __forceinline__ void gemm_ab(float (&c)[MT][NO][4], const unsigned (&a)[MT][KS][4],
                                        const bf16* b, int nv, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int dp = 0; dp < NO / 2; ++dp) {
      if (2 * dp < nv) {
        unsigned f[4];
        sdt::ldmatrix_x4_trans(f, b + (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * LD +
                                      dp * 16 + lane / 16 * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          sdt::mma(c[mt][2 * dp], a[mt][kk], f[0], f[1]);
          if (2 * dp + 1 < nv) sdt::mma(c[mt][2 * dp + 1], a[mt][kk], f[2], f[3]);
        }
      }
    }
  }
}

// A fragments of MT consecutive 16-row m-tiles of a row-major tile at pitch LD.
template <int MT, int KD, int LD>
__device__ __forceinline__ void load_a(unsigned (&a)[MT][KD][4], const bf16* tile, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      sdt::ldmatrix_x4(a[mt][kk], tile + (mt * 16 + lane % 16) * LD + kk * 16 + lane / 16 * 8);
}

template <int MT, int N>
__device__ __forceinline__ void zero(float (&c)[MT][N][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < N; ++j) c[mt][j][0] = c[mt][j][1] = c[mt][j][2] = c[mt][j][3] = 0.f;
}

// Stores rows g and g + 8 of each m-tile of an [MT * 16 x d] fp32
// accumulator, from row r0, as bf16.
template <int MT, int NO>
__device__ __forceinline__ void store_rows(bf16* out, const float (&c)[MT][NO][4], int r0, int n,
                                           int row_stride, int nv, int lane) {
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int ra = r0 + mt * 16 + g, rb = ra + 8;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      if (j < nv) {
        const int col = j * 8 + 2 * tq;
        if (ra < n)
          *reinterpret_cast<unsigned*>(out + (size_t)ra * row_stride + col) =
              sdt::pack_bf16(c[mt][j][0], c[mt][j][1]);
        if (rb < n)
          *reinterpret_cast<unsigned*>(out + (size_t)rb * row_stride + col) =
              sdt::pack_bf16(c[mt][j][2], c[mt][j][3]);
      }
    }
  }
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
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const long long bn = row / heads;  // b * nq + n
    const int h = (int)(row % heads);
    const long long b = bn / nq;
    const int n = (int)(bn % nq);
    delta[(b * heads + h) * nq + n] = s;
  }
}

// Shared memory of a pass with MT m-tiles per warp: the block's own rows
// (MT * 64) of two tensors (K, V or Q, dO), then two stages of the streamed
// tile of two tensors (BT rows each) and of two fp32 row statistics (lse,
// delta; the dK/dV pass only).
template <int DK, int MT_>
struct Plan {
  static constexpr int MT = MT_;
  static constexpr int LD = DK + 8;
  static constexpr int OWNED = 16 * MT * kWarps;  // the rows a block owns
  static constexpr int BT = MT == 2 || DK > 64 ? 32 : 64;
  static constexpr int OWN = 2 * OWNED;          // rows of the two owned tiles
  static constexpr int ROWS = OWN + 4 * BT;      // with both stages of the streamed pair
  static constexpr int STATS = ROWS * LD * 2;    // byte offset of [2 stages][lse, delta][BT]
  static constexpr int BYTES = STATS + 2 * 2 * BT * 4;
};

// One block per (MT * 64-key tile, head, batch): dK and dV of those keys.
template <int DK, int MT_>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int nq, int nk, int heads,
                      int d, float scale, float sl) {
  using P = Plan<DK, MT_>;
  constexpr int MT = P::MT;
  constexpr int LD = P::LD;
  constexpr int BQ = P::BT;
  constexpr int KD = DK / 16;
  constexpr int NS = BQ / 8;  // n8 tiles of S^T (queries)
  constexpr int NO = DK / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = smem;
  bf16* vs = smem + P::OWNED * LD;
  float* stats = reinterpret_cast<float*>(smem_raw + P::STATS);

  const int k0 = blockIdx.x * P::OWNED;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row_stride = heads * d;
  const int chunks = d / 8;
  const int nv = d / 8;
  const bf16* qb = q + ((size_t)b * nq * heads + h) * d;
  const bf16* dob = dout + ((size_t)b * nq * heads + h) * d;
  const bf16* kb = k + ((size_t)b * nk * heads + h) * d;
  const bf16* vb = v + ((size_t)b * nk * heads + h) * d;
  const float* lseb = lse + ((size_t)b * heads + h) * nq;
  const float* deltab = delta + ((size_t)b * heads + h) * nq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wrow = warp * MT * 16;  // this warp's first key in the block

  if (d < DK) zero_padding<DK, LD>(smem, P::ROWS, d);
  load_rows<P::OWNED, LD>(ks, kb, k0, nk, row_stride, chunks);
  load_rows<P::OWNED, LD>(vs, vb, k0, nk, row_stride, chunks);
  load_rows<BQ, LD>(smem + P::OWN * LD, qb, 0, nq, row_stride, chunks);
  load_rows<BQ, LD>(smem + (P::OWN + BQ) * LD, dob, 0, nq, row_stride, chunks);
  load_stats<BQ>(stats, lseb, 0, nq);
  load_stats<BQ>(stats + BQ, deltab, 0, nq);
  sdt::cp_async_commit();

  float dka[MT][NO][4], dva[MT][NO][4];
  zero(dka);
  zero(dva);

  const int ntiles = (nq + BQ - 1) / BQ;
  for (int t = 0; t < ntiles; ++t) {
    sdt::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < ntiles) {
      const int st = (t + 1) & 1;
      bf16* next = smem + (P::OWN + st * 2 * BQ) * LD;
      load_rows<BQ, LD>(next, qb, (t + 1) * BQ, nq, row_stride, chunks);
      load_rows<BQ, LD>(next + BQ * LD, dob, (t + 1) * BQ, nq, row_stride, chunks);
      load_stats<BQ>(stats + st * 2 * BQ, lseb, (t + 1) * BQ, nq);
      load_stats<BQ>(stats + st * 2 * BQ + BQ, deltab, (t + 1) * BQ, nq);
      sdt::cp_async_commit();
    }
    const bf16* qs = smem + (P::OWN + (t & 1) * 2 * BQ) * LD;
    const bf16* dos = qs + BQ * LD;
    const float* lses = stats + (t & 1) * 2 * BQ;
    const float* deltas = lses + BQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's keys
    float st_[MT][NS][4], dpt[MT][NS][4];
    zero(st_);
    zero(dpt);
    {
      unsigned a[MT][KD][4];
      load_a<MT, KD, LD>(a, ks + wrow * LD, lane);
      gemm_abt<MT, NS, KD, LD>(st_, a, qs, lane);
      load_a<MT, KD, LD>(a, vs + wrow * LD, lane);
      gemm_abt<MT, NS, KD, LD>(dpt, a, dos, lane);
    }

    // P^T and dS^T in registers: columns are queries
    unsigned pt[MT][NS / 2][4], dst[MT][NS / 2][4];
    const int qbase = t * BQ;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const bool key0 = k0 + wrow + mt * 16 + g < nk;
      const bool key1 = k0 + wrow + mt * 16 + g + 8 < nk;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * tq + (e & 1);
          const bool valid = (e < 2 ? key0 : key1) && qbase + col < nq;
          const float pe = sdt::exp2_approx(fmaf(st_[mt][j][e], sl, -lses[col]));
          p[e] = valid ? pe : 0.f;
          ds[e] = valid ? ds_of(pe, dpt[mt][j][e], deltas[col], scale) : 0.f;
        }
        pt[mt][j / 2][j % 2 * 2] = sdt::pack_bf16(p[0], p[1]);
        pt[mt][j / 2][j % 2 * 2 + 1] = sdt::pack_bf16(p[2], p[3]);
        dst[mt][j / 2][j % 2 * 2] = sdt::pack_bf16(ds[0], ds[1]);
        dst[mt][j / 2][j % 2 * 2 + 1] = sdt::pack_bf16(ds[2], ds[3]);
      }
    }

    // dV += bf16(P)^T dO and dK += dS^T Q
    gemm_ab<MT, NO, NS / 2, LD>(dva, pt, dos, nv, lane);
    gemm_ab<MT, NO, NS / 2, LD>(dka, dst, qs, nv, lane);
  }

  const int r0 = k0 + wrow;
  store_rows<MT, NO>(dk + ((size_t)b * nk * heads + h) * d, dka, r0, nk, row_stride, nv, lane);
  store_rows<MT, NO>(dv + ((size_t)b * nk * heads + h) * d, dva, r0, nk, row_stride, nv, lane);
}

// One block per (MT * 64-row q tile, head, batch): dQ of those rows.
template <int DK, int MT_>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int nq, int nk, int heads, int d, float scale,
                    float sl) {
  using P = Plan<DK, MT_>;
  constexpr int MT = P::MT;
  constexpr int LD = P::LD;
  constexpr int BK = P::BT;
  constexpr int KD = DK / 16;
  constexpr int NS = BK / 8;  // n8 tiles of S (keys)
  constexpr int NO = DK / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* qs = smem;
  bf16* dos = smem + P::OWNED * LD;

  const int q0 = blockIdx.x * P::OWNED;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row_stride = heads * d;
  const int chunks = d / 8;
  const int nv = d / 8;
  const bf16* qb = q + ((size_t)b * nq * heads + h) * d;
  const bf16* dob = dout + ((size_t)b * nq * heads + h) * d;
  const bf16* kb = k + ((size_t)b * nk * heads + h) * d;
  const bf16* vb = v + ((size_t)b * nk * heads + h) * d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wrow = warp * MT * 16;  // this warp's first query row in the block
  const float* lseb = lse + ((size_t)b * heads + h) * nq;
  const float* deltab = delta + ((size_t)b * heads + h) * nq;
  // lse and delta of rows g and g + 8 of each m-tile
  float lsr[MT][2], dlr[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + wrow + mt * 16 + g + 8 * i;
      lsr[mt][i] = r < nq ? lseb[r] : 0.f;
      dlr[mt][i] = r < nq ? deltab[r] : 0.f;
    }

  if (d < DK) zero_padding<DK, LD>(smem, P::ROWS, d);
  load_rows<P::OWNED, LD>(qs, qb, q0, nq, row_stride, chunks);
  load_rows<P::OWNED, LD>(dos, dob, q0, nq, row_stride, chunks);
  load_rows<BK, LD>(smem + P::OWN * LD, kb, 0, nk, row_stride, chunks);
  load_rows<BK, LD>(smem + (P::OWN + BK) * LD, vb, 0, nk, row_stride, chunks);
  sdt::cp_async_commit();

  float dqa[MT][NO][4];
  zero(dqa);
  unsigned qf[MT][KD][4], dof[MT][KD][4];

  const int ntiles = (nk + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    sdt::cp_async_wait<0>();
    __syncthreads();
    if (t == 0) {
      load_a<MT, KD, LD>(qf, qs + wrow * LD, lane);
      load_a<MT, KD, LD>(dof, dos + wrow * LD, lane);
    }
    if (t + 1 < ntiles) {
      bf16* next = smem + (P::OWN + ((t + 1) & 1) * 2 * BK) * LD;
      load_rows<BK, LD>(next, kb, (t + 1) * BK, nk, row_stride, chunks);
      load_rows<BK, LD>(next + BK * LD, vb, (t + 1) * BK, nk, row_stride, chunks);
      sdt::cp_async_commit();
    }
    const bf16* kt = smem + (P::OWN + (t & 1) * 2 * BK) * LD;
    const bf16* vt = kt + BK * LD;

    float s[MT][NS][4], dp[MT][NS][4];
    zero(s);
    zero(dp);
    gemm_abt<MT, NS, KD, LD>(s, qf, kt, lane);
    gemm_abt<MT, NS, KD, LD>(dp, dof, vt, lane);

    unsigned dsf[MT][NS / 2][4];
    const int kbase = t * BK;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? 0 : 1;
          const bool valid = q0 + wrow + mt * 16 + g + 8 * i < nq &&
                             kbase + j * 8 + 2 * tq + (e & 1) < nk;
          const float pe = sdt::exp2_approx(fmaf(s[mt][j][e], sl, -lsr[mt][i]));
          ds[e] = valid ? ds_of(pe, dp[mt][j][e], dlr[mt][i], scale) : 0.f;
        }
        dsf[mt][j / 2][j % 2 * 2] = sdt::pack_bf16(ds[0], ds[1]);
        dsf[mt][j / 2][j % 2 * 2 + 1] = sdt::pack_bf16(ds[2], ds[3]);
      }
    }

    // dQ += dS K
    gemm_ab<MT, NO, NS / 2, LD>(dqa, dsf, kt, nv, lane);
  }

  store_rows<MT, NO>(dq + ((size_t)b * nq * heads + h) * d, dqa, q0 + wrow, nq, row_stride, nv,
                     lane);
}

// The two passes' plans at padded head dim DK.
template <int DK>
struct Passes {
  using DKDV = Plan<DK, 1>;
  using DQ = Plan<DK, dq_m_tiles(DK)>;
};

template <int DK>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                   const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv, int batch,
                   int nq, int nk, int heads, int d, float scale, cudaStream_t stream) {
  using X = Passes<DK>;
  static_assert(X::DKDV::BYTES <= 232448 && X::DQ::BYTES <= 232448, "shared memory per block");
  const auto dkdv_kernel = flash_bwd_dkdv_kernel<DK, X::DKDV::MT>;
  const auto dq_kernel = flash_bwd_dq_kernel<DK, X::DQ::MT>;
  cudaError_t err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         X::DKDV::BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             X::DQ::BYTES);
  if (err != cudaSuccess) return err;
  const float sl = scale * 1.4426950408889634f;

  const long long rows = (long long)batch * nq * heads;
  const unsigned delta_blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  flash_bwd_delta_kernel<<<delta_blocks, kThreads, 0, stream>>>(o, dout, delta, nq, heads, d,
                                                                rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid_kv((nk + X::DKDV::OWNED - 1) / X::DKDV::OWNED, heads, batch);
  dkdv_kernel<<<grid_kv, kThreads, X::DKDV::BYTES, stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                                             nq, nk, heads, d, scale, sl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid_q((nq + X::DQ::OWNED - 1) / X::DQ::OWNED, heads, batch);
  dq_kernel<<<grid_q, kThreads, X::DQ::BYTES, stream>>>(q, k, v, dout, lse, delta, dq, nq, nk,
                                                        heads, d, scale, sl);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int bytes, int* blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, bytes);
}

template <typename P, typename Kernel>
cudaError_t plan_of(Kernel kernel, int* out) {
  int blocks = 0;
  const cudaError_t err = occupancy(kernel, P::BYTES, &blocks);
  out[0] = P::OWNED;
  out[1] = P::BT;
  out[2] = kThreads;
  out[3] = P::BYTES;
  out[4] = blocks;
  return err;
}

// The plan of one pass (which: 1 dK/dV, 2 dQ) at padded head dim DK.
template <int DK>
cudaError_t plan(int which, int* out) {
  using X = Passes<DK>;
  return which == 1 ? plan_of<typename X::DKDV>(flash_bwd_dkdv_kernel<DK, X::DKDV::MT>, out)
                    : plan_of<typename X::DQ>(flash_bwd_dq_kernel<DK, X::DQ::MT>, out);
}

}  // namespace

#define SDT_BWD_DIMS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

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
  if (d % 8 || d <= 0 || d > 128) return static_cast<int>(cudaErrorInvalidValue);
#define SDT_BWD(DK)                                                                        \
  if (round_up(d, 16) == DK)                                                               \
    return static_cast<int>(                                                               \
        launch<DK>(qp, kp, vp, op, dop, lp, dl, dqp, dkp, dvp, batch, nq, nk, heads, d, scale, \
                   s));
  SDT_BWD_DIMS(SDT_BWD)
#undef SDT_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3's plan for head dim d and pass `which` (1: dK/dV, 2: dQ): out = {rows a
// block owns, rows of the streamed tile, threads, shared-memory bytes,
// resident blocks per SM}.
extern "C" int sdt_flash_bwd_plan(int d, int which, int* out) {
  if (d % 8 || d <= 0 || d > 128 || (which != 1 && which != 2))
    return static_cast<int>(cudaErrorInvalidValue);
#define SDT_PLAN(DK) \
  if (round_up(d, 16) == DK) return static_cast<int>(plan<DK>(which, out));
  SDT_BWD_DIMS(SDT_PLAN)
#undef SDT_PLAN
  return static_cast<int>(cudaErrorInvalidValue);
}
