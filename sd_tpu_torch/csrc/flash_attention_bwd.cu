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
// the valid rows and columns (selected, never computed from -inf).
//
// At 128 < d <= 2048 (the VAE mid-block's single head, d = 512, at [12,
// 1024, 1, 512] for a 256² batch of 12 and [B, 4096, 1, 512] at 512², in
// every first-stage training step) a warp's fp32 dK and dV for 16 keys
// would be 2 x 32 KiB, more than its registers, and the owned and streamed
// rows at the whole head more than a block's shared memory. Both passes
// then take the cluster plan (flash_bwd_cluster_kernel): the head's columns
// are split over the blocks of a thread-block cluster, C = ceil(d / 256)
// blocks (1 up to d = 256, 2 up to 512, 4 up to 1024, 8 up to 2048, the
// portable cluster size), each of two warpgroups that own 64 rows (keys for
// dK/dV, queries for dQ; one wgmma M) and 128 columns apiece. Per 32-row
// streamed tile each warpgroup contracts its columns into partials X = S^T
// (or S) and Y = dP^T (or dP) on wgmma (both operands K-major from shared
// memory), the block adds its two warpgroups' partials, and after one
// cluster barrier every block sums the C block partials through
// distributed shared memory in rank order: every warpgroup holds the same
// X and Y to the bit, forms P and dS in registers (the two roundings as
// above) and accumulates its 64 x 128 of dK += dS^T Q and dV += P^T dO, or
// of dQ += dS K, on wgmma with P and dS as the A operand in registers and
// the streamed tile read MN-major. So the seven products are done once (a
// split of the output's columns over independent blocks would recompute S
// and dP in every slice), and S, dP, P and dS stay in registers. Thread 0
// brings the owned tiles and the streamed tiles by TMA (4-D boxes of 64
// columns, zero-filled past the rows and the head dim) into two stages on
// mbarriers. 197,648 bytes of
// shared memory (the owned pair 64 KB, two stages of the streamed pair 64
// KB, the warpgroups' partials 32 KB, two buffers of the block's partial
// 32 KB), one block an SM; 229 registers a thread for dK/dV and 146 for
// dQ, no spills. cudaOccupancyMaxActiveClusters reads 132
// clusters of 1, 66 of 2, 30 of 4 and 15 of 8 on an H100 (sdt_flash_bwd_plan).
// Its bound at [12, 1024, 1, 512] is 0.065 ms of operations against 0.030
// ms of bytes.
//
// At d > 2048 (any head dim sd_tpu's backward kernel runs at; no config of
// the repository reaches one) a cluster would need more than 8 blocks, past
// the portable size, so the slice plan takes it
// (flash_bwd_slice_kernel): a block owns 16 rows and a slice of 256 of the
// output's columns (grid.y runs over heads x slices). Per 32-row streamed
// tile it recomputes X and Y over the whole d, 128 columns at a time: each
// cp.async stage holds a chunk of the owned pair (16 rows each) and of the
// streamed pair (32 rows each); one n8 tile of X or Y a warp into fp32
// shared memory, P and dS elementwise into bf16 tiles; then the block loads
// only its slice of the streamed tile's columns and accumulates its slice
// of dV = P^T dO and dK = dS^T Q, or of dQ = dS K. 93,440 bytes of shared
// memory at every d. Each slice recomputes X and Y: (4 * slices + 4) * Nq
// * Nk * d flops per head for dK/dV and dQ with the slices' products,
// against the function's 10 * Nq * Nk * d (the bound counts the
// function's). d must be a multiple of 8 (the wrapper zero-pads another
// head dim on d).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "tma.cuh"

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
template <int ROWS, int LD, int THREADS = kThreads>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int n,
                                          int row_stride, int chunks) {
  for (int i = threadIdx.x; i < ROWS * chunks; i += THREADS) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 8;
    const bool valid = row0 + r < n;
    sdt::cp_async16(dst + r * LD + c, src + (size_t)(valid ? row0 + r : 0) * row_stride + c,
                    valid);
  }
}

// Copies columns [c0, c0 + COLS) of rows [row0, row0 + ROWS) of one (batch,
// head) slice into shared memory at pitch LD; rows at or past n and columns
// at or past `cols` are zero-filled.
template <int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int n,
                                          int row_stride, int c0, int cols) {
  constexpr int CH = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH;
    const int c = (i - r * CH) * 8;
    const bool valid = row0 + r < n && c0 + c < cols;
    sdt::cp_async16(dst + r * LD + c,
                    src + (valid ? (size_t)(row0 + r) * row_stride + c0 + c : 0), valid);
  }
}

// Copies ROWS fp32 row statistics from row0; rows at or past n read as 0.
template <int ROWS, int THREADS = kThreads>
__device__ __forceinline__ void load_stats(float* dst, const float* src, int row0, int n) {
  for (int i = threadIdx.x; i < ROWS; i += THREADS) {
    const bool valid = row0 + i < n;
    sdt::cp_async4(dst + i, src + (valid ? row0 + i : 0), valid);
  }
}

template <int DK, int LD, int THREADS = kThreads>
__device__ __forceinline__ void zero_padding(bf16* base, int rows, int d) {
  const int pad = (DK - d) / 8;
  for (int i = threadIdx.x; i < rows * pad; i += THREADS) {
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

// The plan of the cluster passes (128 < d <= 2048): a block of two
// warpgroups owns 64 rows (one wgmma M) and 256 columns of the head, each
// warpgroup 128 of them; a cluster of ceil(d / 256) blocks covers the head.
// Streamed tiles of 32 rows. Shared memory, in wgmma's 128-byte-swizzled
// K-major layout (blocks of 64 columns, rows of 128 bytes, 8-row atoms of
// 1024 bytes): the block's columns of the two owned tiles and two stages of
// its columns of the streamed pair; then the two warpgroups' fp32 partials
// of X and Y in the accumulators' register order (the room where the
// cluster's sum lands too), two buffers of the block's partial and the
// stages' mbarriers. Thread 0 brings the owned tiles and every streamed
// tile by TMA (one box a 64-column block, head_map's 4-D boxes,
// zero-filled past the rows and the head dim).
struct ClusterPlan {
  static constexpr int THREADS = 256;
  static constexpr int OWNED = 64;
  static constexpr int BT = 32;
  static constexpr int W = 256;                       // the block's columns
  static constexpr int OWN = OWNED * W * 2;           // bytes of an owned tile
  static constexpr int STR = BT * W * 2;              // bytes of a streamed tile
  static constexpr int STAGES = 2 * OWN;              // byte offset of stage 0 (C, then D)
  static constexpr int PBUF = 2 * OWNED * BT * 4;     // one partial: X, then Y
  static constexpr int SLOTS = STAGES + 2 * 2 * STR;  // byte offset of the warpgroups' partials
  static constexpr int BP = SLOTS + 2 * PBUF;         // byte offset of the block's partials
  static constexpr int BARS = BP + 2 * PBUF;          // byte offset of the stages' mbarriers
  static constexpr int BYTES = BARS + 16 + 1024;      // with the slack that aligns the atoms
  static constexpr int MAX_CLUSTER = 8;               // the portable cluster size
};

// The cluster plans' largest head dim.
constexpr int kClusterMaxDim = ClusterPlan::W * ClusterPlan::MAX_CLUSTER;

// Both passes at 128 < d <= 2048 (the VAE mid-block's single head, d = 512,
// in every first-stage training step). The roles are the slice plan's: a
// block owns 64 rows of A and B and streams 32-row tiles of C and D; with
// KV it owns keys (A = K, B = V; C = Q, D = dO) and writes dK and dV, else
// it owns queries (A = Q, B = dO; C = K, D = V) and writes dQ. Block `rank`
// of a cluster holds columns [256 rank, 256 rank + 256) of all four,
// warpgroup wg of them the 128 from 256 rank + 128 wg. Per streamed tile:
// - each warpgroup computes its partial X = A C^T (S^T or S) and Y = B D^T
//   (dP^T or dP) over its 128 columns on wgmma (64 x 32 each) and stores
//   them in the accumulators' register order;
// - the block adds its two warpgroups' partials (warpgroup 0's first) into
//   its partial, a quarter of the elements a thread;
// - after the cluster's barrier, the block sums the cluster's partials in
//   rank order through distributed shared memory, again a quarter of the
//   elements a thread: each block's partial crosses the cluster once per
//   reader block, not once per warpgroup, and every block adds in one
//   order, so that every warpgroup holds the same X and Y to the bit and
//   forms the same P and dS, in registers;
// - each warpgroup accumulates its columns of dK += dS^T Q and dV += P^T
//   dO, or of dQ += dS K, on wgmma with P and dS as A in registers and the
//   streamed tile read MN-major.
// The block's partials are double-buffered: a block writes tile t's buffer
// again at tile t + 2, after it has passed the barrier of tile t + 1, which
// no block reaches before it has read tile t's partials; so one cluster
// barrier a tile suffices.
template <bool KV>
__global__ void __launch_bounds__(ClusterPlan::THREADS, 1)
flash_bwd_cluster_kernel(const __grid_constant__ CUtensorMap am,
                         const __grid_constant__ CUtensorMap bm,
                         const __grid_constant__ CUtensorMap cm,
                         const __grid_constant__ CUtensorMap dm, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ out_ds,
                         bf16* __restrict__ out_p, int nq, int nk, int heads, int d,
                         float scale, float sl) {
  using P = ClusterPlan;
  constexpr int T = P::THREADS;
  constexpr int BT = P::BT;
  constexpr int W = P::W;
  constexpr int NX = BT / 8;             // n8 tiles of X and Y
  constexpr int NO = 16;                 // n8 tiles of a warpgroup's 128 output columns
  constexpr int NP = 2 * NX * 128;       // float4s of a partial (X, then Y)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the atoms' 1024-byte alignment; the same offset in every CTA, so the
  // partials sit at one offset across the cluster
  unsigned char* smem = smem_raw + ((1024 - (sdt::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BARS);

  const int csize = gridDim.x;
  const int r0 = blockIdx.y * P::OWNED;
  const int h = blockIdx.z % heads;
  const int b = blockIdx.z / heads;
  const int row_stride = heads * d;
  const int n_own = KV ? nk : nq;
  const int n_str = KV ? nq : nk;
  const size_t q_off = ((size_t)b * nq * heads + h) * d;
  const size_t k_off = ((size_t)b * nk * heads + h) * d;
  const float* lseb = lse + ((size_t)b * heads + h) * nq;
  const float* deltab = delta + ((size_t)b * heads + h) * nq;
  const int tid = threadIdx.x;
  const int wg = tid / 128, wt = tid % 128;  // this thread's warpgroup, its index there
  const int warp = wt / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int bc0 = blockIdx.x * W;   // the block's first column
  const int c0 = bc0 + wg * 128;    // this warpgroup's first column

  // thread 0: streamed tile t's C and D into stage t & 1, 4 boxes of 64
  // columns each
  auto load_streamed = [&](int t) {
    unsigned char* st = smem + P::STAGES + (t & 1) * 2 * P::STR;
    for (int cb = 0; cb < W / 64; ++cb) {
      sdt::tma_load_4d(st + cb * (BT * 128), &cm, bc0 + 64 * cb, h, t * BT, b, &full[t & 1]);
      sdt::tma_load_4d(st + P::STR + cb * (BT * 128), &dm, bc0 + 64 * cb, h, t * BT, b,
                       &full[t & 1]);
    }
  };
  if (tid == 0) {
    sdt::mbar_init(&full[0], 1);
    sdt::mbar_init(&full[1], 1);
    sdt::mbar_init_fence();
    sdt::mbar_expect_tx(&full[0], P::STAGES + 2 * P::STR);
    for (int cb = 0; cb < W / 64; ++cb) {
      sdt::tma_load_4d(smem + cb * (P::OWNED * 128), &am, bc0 + 64 * cb, h, r0, b, &full[0]);
      sdt::tma_load_4d(smem + P::OWN + cb * (P::OWNED * 128), &bm, bc0 + 64 * cb, h, r0, b,
                       &full[0]);
    }
    load_streamed(0);
  }
  __syncthreads();

  // this thread's accumulator rows 16 warp + g + 8 hh, their lse and delta
  // (dQ: rows are queries)
  const int ra = r0 + warp * 16 + g;
  const bool row_ok[2] = {ra < n_own, ra + 8 < n_own};
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  if (!KV) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (row_ok[hh]) {
        lse_r[hh] = lseb[ra + 8 * hh];
        delta_r[hh] = deltab[ra + 8 * hh];
      }
  }

  // acc0: dS C (dK or dQ); acc1: P D (dV)
  float acc0[NO * 4], acc1[KV ? NO * 4 : 1];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (KV ? NO * 4 : 1); ++i) acc1[i] = 0.f;
  float4* slots = reinterpret_cast<float4*>(smem + P::SLOTS);  // [2 warpgroups][NP]

  const int ntiles = (n_str + BT - 1) / BT;
  for (int t = 0; t < ntiles; ++t) {
    sdt::mbar_wait(&full[t & 1], (t >> 1) & 1);
    const unsigned char* cs = smem + P::STAGES + (t & 1) * 2 * P::STR;
    const unsigned char* dts = cs + P::STR;

    // dK/dV: the lse and delta of this thread's columns (queries)
    float lc[NX][2], dc[NX][2];
#pragma unroll
    for (int j = 0; j < NX; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = t * BT + j * 8 + 2 * tq + e;
        lc[j][e] = KV && col < nq ? lseb[col] : 0.f;
        dc[j][e] = KV && col < nq ? deltab[col] : 0.f;
      }

    // this warpgroup's partial X and Y over its 128 columns: column blocks
    // 2 wg and 2 wg + 1 of the owned and streamed tiles
    float x[NX * 4], y[NX * 4];
    sdt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int ao = (2 * wg + kk / 4) * (P::OWNED * 128) + kk % 4 * 32;
      const int co = (2 * wg + kk / 4) * (BT * 128) + kk % 4 * 32;
      sdt::wgmma_bf16_k<BT>(x, sdt::wgmma_desc<128>(smem + ao, 1024),
                            sdt::wgmma_desc<128>(cs + co, 1024), kk > 0);
      sdt::wgmma_bf16_k<BT>(y, sdt::wgmma_desc<128>(smem + P::OWN + ao, 1024),
                            sdt::wgmma_desc<128>(dts + co, 1024), kk > 0);
    }
    sdt::wgmma_commit();
    sdt::wgmma_wait<0>();
    sdt::fence_regs(x);
    sdt::fence_regs(y);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      slots[wg * NP + i * 128 + wt] =
          make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
      slots[wg * NP + (NX + i) * 128 + wt] =
          make_float4(y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]);
    }
    // every thread is past tile t - 1's products: its stage takes tile t + 1
    __syncthreads();
    if (tid == 0 && t + 1 < ntiles) {
      sdt::mbar_expect_tx(&full[(t + 1) & 1], 2 * P::STR);
      load_streamed(t + 1);
    }

    // the block's partial, then the cluster's sum in rank order, into the
    // warpgroups' room
    float4* bp = reinterpret_cast<float4*>(smem + P::BP + (t & 1) * P::PBUF);
#pragma unroll
    for (int m = 0; m < NP / T; ++m) {
      const int e = tid + m * T;
      bp[e] = sdt::add4(slots[e], slots[NP + e]);
    }
    sdt::cluster_sync();
#pragma unroll
    for (int m = 0; m < NP / T; ++m) {
      const int e = tid + m * T;  // X below NX * 128, Y from there
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < P::MAX_CLUSTER; ++r)
        if (r < csize) sum = sdt::add4(sum, *sdt::cluster_ptr(bp + e, r));
      slots[e] = sum;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const float4 xs = slots[i * 128 + wt], ys = slots[(NX + i) * 128 + wt];
      x[4 * i] = xs.x;
      x[4 * i + 1] = xs.y;
      x[4 * i + 2] = xs.z;
      x[4 * i + 3] = xs.w;
      y[4 * i] = ys.x;
      y[4 * i + 1] = ys.y;
      y[4 * i + 2] = ys.z;
      y[4 * i + 3] = ys.w;
    }

    // P and dS, bf16 A fragments, 0 outside the valid rows and columns
    unsigned pa[BT / 16][4], da[BT / 16][4];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int hh = e4 / 2, e = e4 % 2;
        const bool valid = row_ok[hh] && t * BT + j * 8 + 2 * tq + e < n_str;
        const float l = KV ? lc[j][e] : lse_r[hh];
        const float dl = KV ? dc[j][e] : delta_r[hh];
        const float pe = sdt::exp2_approx(fmaf(x[4 * j + e4], sl, -l));
        p[e4] = valid ? pe : 0.f;
        ds[e4] = valid ? ds_of(pe, y[4 * j + e4], dl, scale) : 0.f;
      }
      pa[j / 2][j % 2 * 2] = sdt::pack_bf16(p[0], p[1]);
      pa[j / 2][j % 2 * 2 + 1] = sdt::pack_bf16(p[2], p[3]);
      da[j / 2][j % 2 * 2] = sdt::pack_bf16(ds[0], ds[1]);
      da[j / 2][j % 2 * 2 + 1] = sdt::pack_bf16(ds[2], ds[3]);
    }

    // this warpgroup's columns: acc0 += dS C and, with KV, acc1 += P D
    sdt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      const int bo = 2 * wg * (BT * 128) + kk * 2048;
      sdt::wgmma_bf16_rs<128>(acc0, da[kk], sdt::wgmma_desc<128>(cs + bo, 1024, BT * 128), 1);
      if constexpr (KV)
        sdt::wgmma_bf16_rs<128>(acc1, pa[kk], sdt::wgmma_desc<128>(dts + bo, 1024, BT * 128),
                                1);
    }
    sdt::wgmma_commit();
    sdt::wgmma_wait<0>();
    sdt::fence_regs(acc0);
    sdt::fence_regs(acc1);
  }
  // no block leaves while another may still read its last partial
  sdt::cluster_sync();

  const size_t own_off = KV ? k_off : q_off;
  auto store = [&](bf16* out, const float(&acc)[NO * 4]) {
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = c0 + j * 8 + 2 * tq;
      if (col < d) {
        if (row_ok[0])
          *reinterpret_cast<unsigned*>(out + (size_t)ra * row_stride + col) =
              sdt::pack_bf16(acc[4 * j], acc[4 * j + 1]);
        if (row_ok[1])
          *reinterpret_cast<unsigned*>(out + (size_t)(ra + 8) * row_stride + col) =
              sdt::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  };
  store(out_ds + own_off, acc0);
  if constexpr (KV) store(out_p + own_off, acc1);
}

// The plan of the d > 2048 passes: 8 warps, 16 owned rows and 32 streamed
// rows per tile, the output's columns in slices of OC.
// Shared memory: two stages of a DC-column chunk of the owned pair (A, B)
// and of the streamed pair (C, D), the slice's columns of the streamed
// tile (C, and D for dK/dV), the fp32 X and Y tiles [2][16][LDS], the bf16
// P and dS tiles [2][16][LDP], and the streamed rows' lse and delta.
template <int OC>
struct SlicePlan {
  static constexpr int THREADS = 256;
  static constexpr int OWNED = 16;
  static constexpr int BT = 32;
  static constexpr int DC = 128;
  static constexpr int LDK = DC + 8;
  static constexpr int LDV = OC + 8;
  static constexpr int LDS = BT + 4;
  static constexpr int LDP = BT + 8;
  static constexpr int STAGE = (2 * OWNED + 2 * BT) * LDK;  // A, B, C, D chunks
  static constexpr int CD = 2 * STAGE;                      // element offset of the slices
  static constexpr int XY = (CD + 2 * BT * LDV) * 2;
  static constexpr int PD = XY + 2 * OWNED * LDS * 4;
  static constexpr int STATS = PD + 2 * OWNED * LDP * 2;
  static constexpr int BYTES = STATS + 2 * BT * 4;
  static_assert(OC % 128 == 0, "a slice's columns split into pairs of n8 tiles over 8 warps");
};

// Both passes at d > 2048: the cluster plan's roles (A, B owned; C, D
// streamed; with KV dK and dV, else dQ), with the contraction of X = A C^T
// and Y = B D^T streamed in chunks of DC columns and the accumulators over
// the block's slice of OC output columns; X and Y (one n8 tile a warp, warps
// 0-3 X, 4-7 Y) go through fp32 shared memory, P and dS through bf16 tiles.
template <int OC, bool KV>
__global__ void __launch_bounds__(256)
flash_bwd_slice_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ out_ds, bf16* __restrict__ out_p, int nq, int nk,
                       int heads, int d, float scale, float sl) {
  using P = SlicePlan<OC>;
  constexpr int T = P::THREADS;
  constexpr int BT = P::BT;
  constexpr int DC = P::DC;
  constexpr int LDK = P::LDK;
  constexpr int LDV = P::LDV;
  constexpr int OWNED = P::OWNED;
  constexpr int NW = OC / 64;  // n8 tiles of each accumulator per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* cds = smem + P::CD;
  float* xy = reinterpret_cast<float*>(smem_raw + P::XY);
  bf16* pd = reinterpret_cast<bf16*>(smem_raw + P::PD);
  float* stats = reinterpret_cast<float*>(smem_raw + P::STATS);

  const int slices = gridDim.y / heads;
  const int h = blockIdx.y / slices;
  const int s0 = (blockIdx.y - h * slices) * OC;  // the block's first output column
  const int ow = min(OC, d - s0);                 // its output columns
  const int r0 = blockIdx.x * OWNED;
  const int b = blockIdx.z;
  const int row_stride = heads * d;
  const int n_own = KV ? nk : nq;
  const int n_str = KV ? nq : nk;
  const size_t q_off = ((size_t)b * nq * heads + h) * d;
  const size_t k_off = ((size_t)b * nk * heads + h) * d;
  const bf16* ab = KV ? k + k_off : q + q_off;
  const bf16* bb = KV ? v + k_off : dout + q_off;
  const bf16* cb = KV ? q + q_off : k + k_off;
  const bf16* db = KV ? dout + q_off : v + k_off;
  const float* lseb = lse + ((size_t)b * heads + h) * nq;
  const float* deltab = delta + ((size_t)b * heads + h) * nq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int col0 = warp * (OC / 8);     // this warp's first column in the slice
  const int nv = (ow - col0 + 7) / 8;   // its n8 tiles inside the slice (may be <= 0)
  const int nchunks = (d + DC - 1) / DC;

  // a stage: chunk c0 .. of the owned pair's rows and of tile t's streamed pair
  auto load_chunk = [&](bf16* stage, int t, int c0) {
    load_tile<OWNED, DC, LDK, T>(stage, ab, r0, n_own, row_stride, c0, d);
    load_tile<OWNED, DC, LDK, T>(stage + OWNED * LDK, bb, r0, n_own, row_stride, c0, d);
    load_tile<BT, DC, LDK, T>(stage + 2 * OWNED * LDK, cb, t * BT, n_str, row_stride, c0, d);
    load_tile<BT, DC, LDK, T>(stage + (2 * OWNED + BT) * LDK, db, t * BT, n_str, row_stride, c0,
                              d);
  };
  load_chunk(smem, 0, 0);
  sdt::cp_async_commit();

  // the elementwise step's row and first column
  const int er = threadIdx.x / 16, ec = threadIdx.x % 16 * 2;
  const bool row_ok = r0 + er < n_own;
  float lse_r = 0.f, delta_r = 0.f;
  if (!KV && row_ok) {
    lse_r = lseb[r0 + er];
    delta_r = deltab[r0 + er];
  }

  // acc[0]: dS C (dK or dQ); acc[1]: P D (dV)
  float acc[KV ? 2 : 1][NW][4];
#pragma unroll
  for (int a = 0; a < (KV ? 2 : 1); ++a)
#pragma unroll
    for (int j = 0; j < NW; ++j) acc[a][j][0] = acc[a][j][1] = acc[a][j][2] = acc[a][j][3] = 0.f;

  const int which = warp / 4, nt = warp % 4;  // X (warps 0-3) or Y, and its n8 tile
  int step = 0;  // chunks streamed so far: chunk `step` sits in stage step & 1
  const int ntiles = (n_str + BT - 1) / BT;
  for (int t = 0; t < ntiles; ++t) {
    // X or Y over the whole contraction, one n8 tile a warp; ldmatrix_x4 on
    // the streamed rows gives the B fragments of two k16 steps
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ch = 0; ch < nchunks; ++ch, ++step) {
      sdt::cp_async_wait<0>();
      __syncthreads();
      if (ch == 0) {
        // the last tile's products are done: its slices and statistics may
        // be overwritten
        load_tile<BT, OC, LDV, T>(cds, cb, t * BT, n_str, row_stride, s0, s0 + ow);
        if (KV) {
          load_tile<BT, OC, LDV, T>(cds + BT * LDV, db, t * BT, n_str, row_stride, s0, s0 + ow);
          load_stats<BT, T>(stats, lseb, t * BT, nq);
          load_stats<BT, T>(stats + BT, deltab, t * BT, nq);
        }
      }
      bf16* next = smem + ((step + 1) & 1) * P::STAGE;
      if (ch + 1 < nchunks)
        load_chunk(next, t, (ch + 1) * DC);
      else if (t + 1 < ntiles)
        load_chunk(next, t + 1, 0);
      sdt::cp_async_commit();
      const bf16* stage = smem + (step & 1) * P::STAGE;
      const bf16* arow = stage + (which * OWNED + lane % 16) * LDK + lane / 16 * 8;
      const bf16* brow = stage + (2 * OWNED + which * BT + nt * 8 + lane % 8) * LDK + lane / 8 * 8;
#pragma unroll
      for (int kk = 0; kk < DC / 32; ++kk) {
        if (ch * DC + kk * 32 < d) {
          unsigned bf[4], a0[4], a1[4];
          sdt::ldmatrix_x4(bf, brow + kk * 32);
          sdt::ldmatrix_x4(a0, arow + kk * 32);
          sdt::ldmatrix_x4(a1, arow + kk * 32 + 16);
          sdt::mma(c, a0, bf[0], bf[1]);
          sdt::mma(c, a1, bf[2], bf[3]);
        }
      }
    }
    float* xr = xy + (which * OWNED + g) * P::LDS + nt * 8 + 2 * tq;
    xr[0] = c[0];
    xr[1] = c[1];
    xr[8 * P::LDS] = c[2];
    xr[8 * P::LDS + 1] = c[3];
    // the tile's slices and statistics have landed (issued with its first chunk)
    sdt::cp_async_wait<0>();
    __syncthreads();

    // P and dS, bf16, set to 0 outside the valid rows and columns
    {
      const float* lses = stats;
      const float* deltas = stats + BT;
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = ec + e;
        const bool valid = row_ok && t * BT + col < n_str;
        const float s = xy[er * P::LDS + col];
        const float dp = xy[(OWNED + er) * P::LDS + col];
        const float l = KV ? lses[col] : lse_r;
        const float dl = KV ? deltas[col] : delta_r;
        const float pe = sdt::exp2_approx(fmaf(s, sl, -l));
        p[e] = valid ? pe : 0.f;
        ds[e] = valid ? ds_of(pe, dp, dl, scale) : 0.f;
      }
      *reinterpret_cast<unsigned*>(pd + er * P::LDP + ec) = sdt::pack_bf16(p[0], p[1]);
      *reinterpret_cast<unsigned*>(pd + (OWNED + er) * P::LDP + ec) =
          sdt::pack_bf16(ds[0], ds[1]);
    }
    __syncthreads();

    // this warp's columns of the slice: acc[0] += dS C and, with KV, acc[1] += P D
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      unsigned sa[4], pa[4];
      sdt::ldmatrix_x4(sa, pd + (OWNED + lane % 16) * P::LDP + kk * 16 + lane / 16 * 8);
      if (KV) sdt::ldmatrix_x4(pa, pd + (lane % 16) * P::LDP + kk * 16 + lane / 16 * 8);
      const int brow = (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * LDV + col0 + lane / 16 * 8;
#pragma unroll
      for (int dp = 0; dp < NW / 2; ++dp) {
        if (2 * dp < nv) {
          unsigned f[4];
          sdt::ldmatrix_x4_trans(f, cds + brow + dp * 16);
          sdt::mma(acc[0][2 * dp], sa, f[0], f[1]);
          if (2 * dp + 1 < nv) sdt::mma(acc[0][2 * dp + 1], sa, f[2], f[3]);
          if (KV) {
            sdt::ldmatrix_x4_trans(f, cds + BT * LDV + brow + dp * 16);
            sdt::mma(acc[KV ? 1 : 0][2 * dp], pa, f[0], f[1]);
            if (2 * dp + 1 < nv) sdt::mma(acc[KV ? 1 : 0][2 * dp + 1], pa, f[2], f[3]);
          }
        }
      }
    }
  }

  const size_t own_off = (KV ? k_off : q_off) + s0;
  const int ra = r0 + g, rb = ra + 8;
#pragma unroll
  for (int a = 0; a < (KV ? 2 : 1); ++a) {
    bf16* out = (a == 0 ? out_ds : out_p) + own_off;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if (j < nv) {
        const int col = col0 + j * 8 + 2 * tq;
        if (ra < n_own)
          *reinterpret_cast<unsigned*>(out + (size_t)ra * row_stride + col) =
              sdt::pack_bf16(acc[a][j][0], acc[a][j][1]);
        if (rb < n_own)
          *reinterpret_cast<unsigned*>(out + (size_t)rb * row_stride + col) =
              sdt::pack_bf16(acc[a][j][2], acc[a][j][3]);
      }
    }
  }
}

// The slice plan's columns per block.
constexpr int kSliceCols = 256;

// The two passes' plans at padded head dim DK.
template <int DK>
struct Passes {
  using DKDV = Plan<DK, 1>;
  using DQ = Plan<DK, dq_m_tiles(DK)>;
};

// The delta pre-pass, one warp per (b, n, h) row.
cudaError_t launch_delta(const bf16* o, const bf16* dout, float* delta, int batch, int nq,
                         int heads, int d, cudaStream_t stream) {
  const long long rows = (long long)batch * nq * heads;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  flash_bwd_delta_kernel<<<blocks, kThreads, 0, stream>>>(o, dout, delta, nq, heads, d, rows);
  return cudaGetLastError();
}

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

  err = launch_delta(o, dout, delta, batch, nq, heads, d, stream);
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

// The cluster plan's CTAs per cluster at head dim d.
int cluster_size(int d) { return (d + ClusterPlan::W - 1) / ClusterPlan::W; }

cudaError_t launch_cluster(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                           const bf16* dout, const float* lse, float* delta, bf16* dq, bf16* dk,
                           bf16* dv, int batch, int nq, int nk, int heads, int d, float scale,
                           cudaStream_t stream) {
  using P = ClusterPlan;
  static_assert(P::BYTES <= 232448, "shared memory per block");
  const float sl = scale * 1.4426950408889634f;
  const int c = cluster_size(d);
  cudaError_t err = launch_delta(o, dout, delta, batch, nq, heads, d, stream);
  if (err != cudaSuccess) return err;
  // the owned tiles' maps (64-row boxes) and the streamed tiles' (32-row
  // boxes) of both passes
  CUtensorMap own[4], str[4];
  const bf16* tensors[4] = {k, v, q, dout};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    const int n = i < 2 ? nk : nq;
    err = sdt::cached_head_map(&own[i], tensors[i], batch, n, heads, d, P::OWNED);
    if (err == cudaSuccess)
      err = sdt::cached_head_map(&str[i], tensors[i], batch, n, heads, d, P::BT);
  }
  if (err != cudaSuccess) return err;
  err = sdt::launch_clustered(flash_bwd_cluster_kernel<true>,
                              dim3(c, (nk + P::OWNED - 1) / P::OWNED, batch * heads),
                              P::THREADS, P::BYTES, c, stream, own[0], own[1], str[2], str[3],
                              lse, (const float*)delta, dk, dv, nq, nk, heads, d, scale, sl);
  if (err != cudaSuccess) return err;
  return sdt::launch_clustered(flash_bwd_cluster_kernel<false>,
                               dim3(c, (nq + P::OWNED - 1) / P::OWNED, batch * heads),
                               P::THREADS, P::BYTES, c, stream, own[2], own[3], str[0], str[1],
                               lse, (const float*)delta, dq, (bf16*)nullptr, nq, nk, heads, d,
                               scale, sl);
}

template <int OC>
cudaError_t launch_slice(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                         const bf16* dout, const float* lse, float* delta, bf16* dq, bf16* dk,
                         bf16* dv, int batch, int nq, int nk, int heads, int d, float scale,
                         cudaStream_t stream) {
  using P = SlicePlan<OC>;
  static_assert(P::BYTES <= 232448, "shared memory per block");
  const auto kv_kernel = flash_bwd_slice_kernel<OC, true>;
  const auto q_kernel = flash_bwd_slice_kernel<OC, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return err;
  const float sl = scale * 1.4426950408889634f;

  err = launch_delta(o, dout, delta, batch, nq, heads, d, stream);
  if (err != cudaSuccess) return err;

  const int slices = (d + OC - 1) / OC;
  dim3 grid_kv((nk + P::OWNED - 1) / P::OWNED, heads * slices, batch);
  kv_kernel<<<grid_kv, P::THREADS, P::BYTES, stream>>>(q, k, v, dout, lse, delta, dk, dv, nq,
                                                       nk, heads, d, scale, sl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid_q((nq + P::OWNED - 1) / P::OWNED, heads * slices, batch);
  q_kernel<<<grid_q, P::THREADS, P::BYTES, stream>>>(q, k, v, dout, lse, delta, dq, nullptr,
                                                     nq, nk, heads, d, scale, sl);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, int bytes, int* blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, bytes);
}

template <typename P, typename Kernel>
cudaError_t plan_of(Kernel kernel, int* out, int threads = kThreads, int slices = 1,
                    int cluster = 0) {
  int blocks = 0, clusters = 0;
  cudaError_t err = occupancy(kernel, threads, P::BYTES, &blocks);
  if (err == cudaSuccess && cluster)
    err = sdt::active_clusters(reinterpret_cast<const void*>(kernel), threads, P::BYTES, cluster,
                               &clusters);
  out[0] = P::OWNED;
  out[1] = P::BT;
  out[2] = threads;
  out[3] = P::BYTES;
  out[4] = blocks;
  out[5] = cluster ? cluster : slices;
  out[6] = cluster ? cluster : 1;
  out[7] = clusters;
  return err;
}

// The plan of one pass (which: 1 dK/dV, 2 dQ) at padded head dim DK.
template <int DK>
cudaError_t plan(int which, int* out) {
  using X = Passes<DK>;
  return which == 1 ? plan_of<typename X::DKDV>(flash_bwd_dkdv_kernel<DK, X::DKDV::MT>, out)
                    : plan_of<typename X::DQ>(flash_bwd_dq_kernel<DK, X::DQ::MT>, out);
}

cudaError_t plan_cluster(int which, int d, int* out) {
  using P = ClusterPlan;
  const int c = cluster_size(d);
  return which == 1 ? plan_of<P>(flash_bwd_cluster_kernel<true>, out, P::THREADS, 1, c)
                    : plan_of<P>(flash_bwd_cluster_kernel<false>, out, P::THREADS, 1, c);
}

template <int OC>
cudaError_t plan_slice(int which, int d, int* out) {
  using P = SlicePlan<OC>;
  const int slices = (d + OC - 1) / OC;
  return which == 1 ? plan_of<P>(flash_bwd_slice_kernel<OC, true>, out, P::THREADS, slices)
                    : plan_of<P>(flash_bwd_slice_kernel<OC, false>, out, P::THREADS, slices);
}

}  // namespace

#define SDT_BWD_DIMS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

// Returns the CUDA error code of the launches (0 on success). `delta` is fp32
// scratch of [B, H, Nq]. d must be a multiple of 8; the wrapper checks
// shapes, types and alignment.
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
  if (d % 8 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (d > kClusterMaxDim)
    return static_cast<int>(launch_slice<kSliceCols>(qp, kp, vp, op, dop, lp, dl, dqp, dkp, dvp,
                                                     batch, nq, nk, heads, d, scale, s));
  if (d > 128)
    return static_cast<int>(launch_cluster(qp, kp, vp, op, dop, lp, dl, dqp, dkp, dvp, batch,
                                           nq, nk, heads, d, scale, s));
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
// resident blocks per SM, slices of the output's columns per row tile (the
// CTAs of a cluster in the cluster plan), CTAs of a cluster (1: no cluster
// launch), the clusters the card co-schedules (cudaOccupancyMaxActiveClusters;
// 0 without a cluster launch)}.
extern "C" int sdt_flash_bwd_plan(int d, int which, int* out) {
  if (d % 8 || d <= 0 || (which != 1 && which != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (d > kClusterMaxDim) return static_cast<int>(plan_slice<kSliceCols>(which, d, out));
  if (d > 128) return static_cast<int>(plan_cluster(which, d, out));
#define SDT_PLAN(DK) \
  if (round_up(d, 16) == DK) return static_cast<int>(plan<DK>(which, out));
  SDT_BWD_DIMS(SDT_PLAN)
#undef SDT_PLAN
  return static_cast<int>(cudaErrorInvalidValue);
}
