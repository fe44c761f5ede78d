// K1, flash-attention forward for Hopper (sm_90a): softmax(Q K^T * scale) V.
//
// Replaces the TPU kernel `_fwd_bhnd` (`_kernel_chunked` / `_kernel`) in
// sd_tpu/ops/pallas/flash_attention.py and computes the same thing: an exact
// fp32 online softmax in base 2 (scale * log2(e) folded into the logits), the
// running row max and row sum in fp32 (the sum over the fp32 P), and P
// rounded to bf16 before the P.V product.
//
// Layout: q, o are [B, Nq, H, D] and k, v are [B, Nk, H, D], bf16, contiguous;
// a (b, h) slice is read with row stride H * D, so nothing is transposed or
// padded in device memory. For training the caller may pass an fp32
// [B, H, Nq] buffer `lse`: each row's log-sum-exp in base 2 (running max plus
// log2 of the running sum, in units of the logits times scale * log2(e)),
// from which the backward (flash_attention_bwd.cu) rebuilds P.
//
// What bounds it on the H100: operations. Q K^T and P V are 4 * B * H * Nq *
// Nk * D flops against (Nq + 2 Nk) * D * 2 bytes per head read and Nq * D * 2
// written; at [2, 4096, 8, 40] that is 0.043 ms of the 989 TFLOP/s dense bf16
// peak against 0.010 ms of bytes at 3.35 TB/s. At d = 40 the B * H * Nq * Nk
// exponentials on the special-function unit (16 a clock per SM) are a second
// floor of the same order.
//
// Design. The products run on mma.sync.m16n8k16 (bf16 in, fp32 accumulate),
// and S, P and the O accumulator never leave the registers (flash_mma.cuh
// shows how an S accumulator fragment becomes P's A fragment):
//
// - d <= 160 (the UNet's d = 40, 80, 160): each warp owns 16 query rows, or
//   at d <= 48 two m-tiles of 16, so that each K and V fragment read from
//   shared memory serves two products (at d = 40 one m-tile reads 512 bytes
//   of ldmatrix for about two products, more shared-memory time than tensor
//   time; on an H100 two m-tiles are faster at [4 and 16, 4096, 8, 40] and a
//   little slower at B = 2, where 512 blocks fill 1.3 waves; PERF.md). A
//   block of 4 warps holds 128 rows at d <= 48, 8 warps of 16 rows at
//   d = 64, 4 warps of 16 rows above. Q's
//   fragments are loaded once. Per key tile of 64 keys (32 at d > 128) a
//   warp computes its 16 x 64 S in registers, reduces the row max over the
//   four threads of each quad with shuffles, exponentiates, repacks P as bf16
//   A fragments and rescales and accumulates O in registers. K and V tiles
//   are double-buffered in shared memory by cp.async (16 bytes a thread) and
//   read with ldmatrix (.trans for V); the pitch is the head dim padded to a
//   multiple of 16 plus 8 (an odd multiple of 16 bytes, so ldmatrix's eight
//   rows fall in eight bank groups). One __syncthreads per key tile: it both
//   publishes tile t and frees the buffer that the copy of tile t + 1 then
//   overwrites. Only the contraction of Q K^T is padded (d = 40 -> 48, zeros
//   in shared memory); the n8 tiles of P V cover d exactly.
// - d > 160 (the VAE mid-block's single head, d = 512; cin256-v2's one-head
//   sites at d = 384 and 576): 16 x 512 fp32 of O is 256 registers a thread,
//   more than a thread has. A block of 8 warps takes 32 query rows in two
//   groups of 16; the four warps of a group split the 32-key tile's columns
//   of S (8 keys each, the whole contraction) and O's columns (DK / 4 each).
//   Each exchanges its row max through 256 bytes of shared memory, writes its
//   slice of P in bf16 to a shared [32, 32] tile, and multiplies all of P by
//   its slice of V. Q stays in shared memory and is read with ldmatrix for
//   every tile. 32-row blocks give 128 blocks at B = 1, one per SM, where
//   64-row blocks would leave half of the 132 SMs idle. Three plans: DK = 256,
//   512 and 576 (512 < d <= 576). At DK = 576 a warp holds 16 x 144 fp32 of O
//   (72 registers a thread), and a block's shared memory is 189,952 bytes:
//   Q and two stages of K and V, 160 rows at a pitch of 584 (186,880 bytes),
//   the P tile (2,560) and the exchange (512), under the 232,448 a block may
//   use, so one block an SM. It is a simple plan: at [8, 256, 1, 576] its 64
//   blocks fill 64 of the 132 SMs.
// - 576 < d <= 1024 (the first-stage extras' one-head d = 640 to 1024 sites,
//   cin256-v2's d = 960): Q, two stages of K and V at the whole head no
//   longer fit in 232,448 bytes (at d = 1024, 160 rows at a pitch of 1,032
//   take 330,240). The split plan gives each block 32 query rows and a
//   slice of at most 256 of O's columns (grid.y runs over heads x slices, 4
//   slices at d = 1024). Q stays whole in shared memory (66,048 bytes); the
//   32-key tile's K streams through two stages of 128 columns by cp.async,
//   so that S = Q K^T over the whole d accumulates chunk by chunk in
//   registers (the same warp split as the wide plan: four warps of a row
//   group take 8 keys each); then the block loads only its slice of V's
//   columns (32 x 256), and P V runs as in the wide plan on the slice. The
//   first slice writes lse. Each slice recomputes Q K^T, so the kernel does
//   (2 * slices + 2) * Nq * Nk * d flops per head where the function needs
//   4 * Nq * Nk * d: 2.5x at d = 1024, 2x at d = 640 and 768 (the bound
//   counts the function's work). 103,424 bytes of shared memory, two
//   blocks an SM. A plan that is right first; making it fast is later work.
//
// The ragged last key tile is zero-filled by the copy and masked to -inf
// before the max; query rows past Nq are zero-filled and not stored. d must
// be a multiple of 8 and at most 1024, and scale positive.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

using sdt::bf16;

namespace {

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Copies rows [row0, row0 + ROWS) of one (batch, head) slice, the first d
// columns, into shared memory at pitch LD with cp.async; rows at or past n
// are zero-filled. Columns [d, LD) are left as they are.
template <int ROWS, int LD, int THREADS>
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

// Zeroes columns [d, DK) of `rows` rows at pitch LD: the padding of the
// contraction, which the copies never write.
template <int DK, int LD, int THREADS>
__device__ __forceinline__ void zero_padding(bf16* base, int rows, int d) {
  const int pad = (DK - d) / 8;
  for (int i = threadIdx.x; i < rows * pad; i += THREADS) {
    const int r = i / pad;
    *reinterpret_cast<uint4*>(base + r * LD + d + (i - r * pad) * 8) = make_uint4(0, 0, 0, 0);
  }
}

// The plan of the d <= 160 kernel: DK the padded contraction, WARPS warps of
// MT 16-row m-tiles each, BK keys per tile. Shared memory: Q, then two
// stages of K and V.
template <int DK, int WARPS, int BK, int MT>
struct Plan {
  static constexpr int BQ = 16 * MT * WARPS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = DK + 8;
  static constexpr int KV = BQ * LD;  // element offset of stage 0's K
  static constexpr int ROWS = BQ + 4 * BK;
  static constexpr int BYTES = ROWS * LD * 2;
};

template <int DK, int WARPS, int BK_, int MT>
__global__ void __launch_bounds__(32 * WARPS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int nq, int nk, int heads, int d, float sl) {
  using P = Plan<DK, WARPS, BK_, MT>;
  constexpr int BK = BK_;
  constexpr int LD = P::LD;
  constexpr int KD = DK / 16;  // k16 steps of Q K^T
  constexpr int NS = BK / 8;   // n8 tiles of S
  constexpr int NO = DK / 8;   // n8 tiles of O; those at or past d / 8 are skipped
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int q0 = blockIdx.x * P::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row_stride = heads * d;
  const int chunks = d / 8;
  const int nv = d / 8;
  const bf16* qb = q + ((size_t)b * nq * heads + h) * d;
  const bf16* kb = k + ((size_t)b * nk * heads + h) * d;
  const bf16* vb = v + ((size_t)b * nk * heads + h) * d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;

  if (d < DK) zero_padding<DK, LD, P::THREADS>(smem, P::ROWS, d);
  load_rows<P::BQ, LD, P::THREADS>(smem, qb, q0, nq, row_stride, chunks);
  load_rows<BK, LD, P::THREADS>(smem + P::KV, kb, 0, nk, row_stride, chunks);
  load_rows<BK, LD, P::THREADS>(smem + P::KV + BK * LD, vb, 0, nk, row_stride, chunks);
  sdt::cp_async_commit();

  // per m-tile: the O accumulator, the running max of rows g and g + 8 (log2
  // units), this thread's part of their running sums, Q's fragments
  float acc[MT][NO][4];
  float m[MT][2], l[MT][2];
  unsigned qf[MT][KD][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < NO; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  const int ntiles = (nk + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    sdt::cp_async_wait<0>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          sdt::ldmatrix_x4(qf[mt][kk], smem + ((warp * MT + mt) * 16 + lane % 16) * LD +
                                           kk * 16 + lane / 16 * 8);
    }
    if (t + 1 < ntiles) {
      bf16* next = smem + P::KV + ((t + 1) & 1) * 2 * BK * LD;
      load_rows<BK, LD, P::THREADS>(next, kb, (t + 1) * BK, nk, row_stride, chunks);
      load_rows<BK, LD, P::THREADS>(next + BK * LD, vb, (t + 1) * BK, nk, row_stride, chunks);
      sdt::cp_async_commit();
    }
    const bf16* ks = smem + P::KV + (t & 1) * 2 * BK * LD;
    const bf16* vs = ks + BK * LD;

    // S = Q K^T, 16 x BK per m-tile; each K fragment serves every m-tile
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        unsigned kf[4];
        sdt::ldmatrix_x4(kf, ks + (jp * 16 + lane % 8 + lane / 16 * 8) * LD + kk * 16 +
                                 (lane / 8) % 2 * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          sdt::mma(s[mt][2 * jp], qf[mt][kk], kf[0], kf[1]);
          sdt::mma(s[mt][2 * jp + 1], qf[mt][kk], kf[2], kf[3]);
        }
      }
    }
    const int kbase = t * BK;
    if (kbase + BK > nk) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int c = kbase + j * 8 + 2 * tq;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (c >= nk) s[mt][j][0] = s[mt][j][2] = -INFINITY;
          if (c + 1 >= nk) s[mt][j][1] = s[mt][j][3] = -INFINITY;
        }
      }
    }

    // online softmax of rows g and g + 8 of each m-tile, in registers
    unsigned pf[MT][NS / 2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        t0 = fmaxf(t0, fmaxf(s[mt][j][0], s[mt][j][1]));
        t1 = fmaxf(t1, fmaxf(s[mt][j][2], s[mt][j][3]));
      }
      const float n0 = fmaxf(m[mt][0], sdt::quad_max(t0) * sl);
      const float n1 = fmaxf(m[mt][1], sdt::quad_max(t1) * sl);
      const float e0 = n0 == -INFINITY ? 0.f : n0;  // a row with no key yet stays at p = 0
      const float e1 = n1 == -INFINITY ? 0.f : n1;
      const float c0 = sdt::exp2_approx(m[mt][0] - e0), c1 = sdt::exp2_approx(m[mt][1] - e1);
      m[mt][0] = n0;
      m[mt][1] = n1;
      l[mt][0] *= c0;
      l[mt][1] *= c1;
      sdt::rescale_rows(acc[mt], c0, c1);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float p0 = sdt::exp2_approx(fmaf(s[mt][j][0], sl, -e0));
        const float p1 = sdt::exp2_approx(fmaf(s[mt][j][1], sl, -e0));
        const float p2 = sdt::exp2_approx(fmaf(s[mt][j][2], sl, -e1));
        const float p3 = sdt::exp2_approx(fmaf(s[mt][j][3], sl, -e1));
        l[mt][0] += p0 + p1;
        l[mt][1] += p2 + p3;
        pf[mt][j / 2][j % 2 * 2] = sdt::pack_bf16(p0, p1);
        pf[mt][j / 2][j % 2 * 2 + 1] = sdt::pack_bf16(p2, p3);
      }
    }

    // O += P V; each V fragment serves every m-tile
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        if (2 * dp < nv) {
          unsigned vf[4];
          sdt::ldmatrix_x4_trans(vf, vs + (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * LD +
                                         dp * 16 + lane / 16 * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            sdt::mma(acc[mt][2 * dp], pf[mt][kk], vf[0], vf[1]);
            if (2 * dp + 1 < nv) sdt::mma(acc[mt][2 * dp + 1], pf[mt][kk], vf[2], vf[3]);
          }
        }
      }
    }
  }

  bf16* ob = o + ((size_t)b * nq * heads + h) * d;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float l0 = sdt::quad_sum(l[mt][0]), l1 = sdt::quad_sum(l[mt][1]);
    const int r0 = q0 + (warp * MT + mt) * 16 + g;
    const int r1 = r0 + 8;
    const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      if (j < nv) {
        const int c = j * 8 + 2 * tq;
        if (r0 < nq)
          *reinterpret_cast<unsigned*>(ob + (size_t)r0 * row_stride + c) =
              sdt::pack_bf16(acc[mt][j][0] * i0, acc[mt][j][1] * i0);
        if (r1 < nq)
          *reinterpret_cast<unsigned*>(ob + (size_t)r1 * row_stride + c) =
              sdt::pack_bf16(acc[mt][j][2] * i1, acc[mt][j][3] * i1);
      }
    }
    if (lse != nullptr && tq == 0) {
      float* lb = lse + ((size_t)b * heads + h) * nq;
      if (r0 < nq) lb[r0] = sdt::row_lse(m[mt][0], l0);
      if (r1 < nq) lb[r1] = sdt::row_lse(m[mt][1], l1);
    }
  }
}

// The plan of the d > 160 kernel: 8 warps, 32 query rows in two groups of
// 16, 32 keys per tile; the four warps of a group split S's keys (8 each) and
// O's columns (DK / 4 each). Shared memory: Q, two stages of K and V, the
// bf16 P tile, the exchanged row maxima and, at the end, the row sums.
template <int DK>
struct WidePlan {
  static constexpr int WARPS = 8;
  static constexpr int THREADS = 256;
  static constexpr int BQ = 32;
  static constexpr int BK = 32;
  static constexpr int LD = DK + 8;
  static constexpr int LDP = BK + 8;
  static constexpr int KV = BQ * LD;
  static constexpr int ROWS = BQ + 4 * BK;
  static constexpr int PT = ROWS * LD;           // element offset of P
  static constexpr int RED = (PT + BQ * LDP) * 2;  // byte offset of the fp32 [2][4][16] exchange
  static constexpr int BYTES = RED + 2 * 4 * 16 * 4;
  // a warp's DK / 4 columns of O are whole pairs of n8 tiles (one
  // ldmatrix_x4_trans each), and Q K^T takes two k16 steps at a time
  static_assert(DK % 64 == 0, "O's columns split into pairs of n8 tiles over 4 warps");
  static_assert(DK / 32 * 4 <= 72, "O's accumulator: at most 72 registers a thread");
};

template <int DK>
__global__ void __launch_bounds__(256)
flash_fwd_kernel_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int nq, int nk, int heads, int d, float sl) {
  using P = WidePlan<DK>;
  constexpr int BK = P::BK;
  constexpr int LD = P::LD;
  constexpr int KD = DK / 16;
  constexpr int NO = DK / 32;  // n8 tiles of O per warp (DK / 4 columns)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* ps = smem + P::PT;
  float* red = reinterpret_cast<float*>(smem_raw + P::RED);

  const int q0 = blockIdx.x * P::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row_stride = heads * d;
  const int chunks = d / 8;
  const bf16* qb = q + ((size_t)b * nq * heads + h) * d;
  const bf16* kb = k + ((size_t)b * nk * heads + h) * d;
  const bf16* vb = v + ((size_t)b * nk * heads + h) * d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int rg = warp / 4;              // row group: rows rg * 16 ..
  const int cg = warp % 4;              // keys cg * 8 .. of a tile, O columns cg * DK / 4 ..
  const int col0 = cg * (DK / 4);
  const int nv = (d - col0 + 7) / 8;    // this warp's n8 tiles of O inside d (may be <= 0)
  float* red_row = red + rg * 64;       // [4][16] of this row group

  if (d < DK) zero_padding<DK, LD, P::THREADS>(smem, P::ROWS, d);
  load_rows<P::BQ, LD, P::THREADS>(smem, qb, q0, nq, row_stride, chunks);
  load_rows<BK, LD, P::THREADS>(smem + P::KV, kb, 0, nk, row_stride, chunks);
  load_rows<BK, LD, P::THREADS>(smem + P::KV + BK * LD, vb, 0, nk, row_stride, chunks);
  sdt::cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;  // this thread's part of the sums over its warp's keys
  const bf16* qrow = smem + (rg * 16 + lane % 16) * LD + lane / 16 * 8;

  const int ntiles = (nk + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    sdt::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < ntiles) {
      bf16* next = smem + P::KV + ((t + 1) & 1) * 2 * BK * LD;
      load_rows<BK, LD, P::THREADS>(next, kb, (t + 1) * BK, nk, row_stride, chunks);
      load_rows<BK, LD, P::THREADS>(next + BK * LD, vb, (t + 1) * BK, nk, row_stride, chunks);
      sdt::cp_async_commit();
    }
    const bf16* ks = smem + P::KV + (t & 1) * 2 * BK * LD;
    const bf16* vs = ks + BK * LD;

    // S over this warp's 8 keys, the whole contraction; ldmatrix_x4 on K
    // gives the B fragments of two k16 steps
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* krow = ks + (cg * 8 + lane % 8) * LD + lane / 8 * 8;
#pragma unroll
    for (int kk = 0; kk < KD; kk += 2) {
      unsigned kf[4], qa[4], qc[4];
      sdt::ldmatrix_x4(kf, krow + kk * 16);
      sdt::ldmatrix_x4(qa, qrow + kk * 16);
      sdt::ldmatrix_x4(qc, qrow + kk * 16 + 16);
      sdt::mma(s, qa, kf[0], kf[1]);
      sdt::mma(s, qc, kf[2], kf[3]);
    }
    const int c = t * BK + cg * 8 + 2 * tq;
    if (c >= nk) s[0] = s[2] = -INFINITY;
    if (c + 1 >= nk) s[1] = s[3] = -INFINITY;

    // the row max over the group's four warps
    float t0 = sdt::quad_max(fmaxf(s[0], s[1]));
    float t1 = sdt::quad_max(fmaxf(s[2], s[3]));
    if (tq == 0) {
      red_row[cg * 16 + g] = t0;
      red_row[cg * 16 + g + 8] = t1;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      t0 = fmaxf(t0, red_row[w * 16 + g]);
      t1 = fmaxf(t1, red_row[w * 16 + g + 8]);
    }
    const float n0 = fmaxf(m0, t0 * sl);
    const float n1 = fmaxf(m1, t1 * sl);
    const float e0 = n0 == -INFINITY ? 0.f : n0;
    const float e1 = n1 == -INFINITY ? 0.f : n1;
    const float c0 = sdt::exp2_approx(m0 - e0), c1 = sdt::exp2_approx(m1 - e1);
    m0 = n0;
    m1 = n1;
    l0 *= c0;
    l1 *= c1;
    sdt::rescale_rows(acc, c0, c1);
    const float p0 = sdt::exp2_approx(fmaf(s[0], sl, -e0));
    const float p1 = sdt::exp2_approx(fmaf(s[1], sl, -e0));
    const float p2 = sdt::exp2_approx(fmaf(s[2], sl, -e1));
    const float p3 = sdt::exp2_approx(fmaf(s[3], sl, -e1));
    l0 += p0 + p1;
    l1 += p2 + p3;
    bf16* prow = ps + (rg * 16 + g) * P::LDP + cg * 8 + 2 * tq;
    *reinterpret_cast<unsigned*>(prow) = sdt::pack_bf16(p0, p1);
    *reinterpret_cast<unsigned*>(prow + 8 * P::LDP) = sdt::pack_bf16(p2, p3);
    __syncthreads();

    // O[:, this warp's columns] += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned pa[4];
      sdt::ldmatrix_x4(pa, ps + (rg * 16 + lane % 16) * P::LDP + kk * 16 + lane / 16 * 8);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        if (2 * dp < nv) {
          unsigned vf[4];
          sdt::ldmatrix_x4_trans(vf, vs + (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * LD +
                                         col0 + dp * 16 + lane / 16 * 8);
          sdt::mma(acc[2 * dp], pa, vf[0], vf[1]);
          if (2 * dp + 1 < nv) sdt::mma(acc[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }

  // the row sums over the group's four warps
  l0 = sdt::quad_sum(l0);
  l1 = sdt::quad_sum(l1);
  __syncthreads();
  if (tq == 0) {
    red_row[cg * 16 + g] = l0;
    red_row[cg * 16 + g + 8] = l1;
  }
  __syncthreads();
  l0 = l1 = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    l0 += red_row[w * 16 + g];
    l1 += red_row[w * 16 + g + 8];
  }
  const int r0 = q0 + rg * 16 + g;
  const int r1 = r0 + 8;
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  bf16* ob = o + ((size_t)b * nq * heads + h) * d;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (j < nv) {
      const int cc = col0 + j * 8 + 2 * tq;
      if (r0 < nq)
        *reinterpret_cast<unsigned*>(ob + (size_t)r0 * row_stride + cc) =
            sdt::pack_bf16(acc[j][0] * i0, acc[j][1] * i0);
      if (r1 < nq)
        *reinterpret_cast<unsigned*>(ob + (size_t)r1 * row_stride + cc) =
            sdt::pack_bf16(acc[j][2] * i1, acc[j][3] * i1);
    }
  }
  if (lse != nullptr && cg == 0 && tq == 0) {
    float* lb = lse + ((size_t)b * heads + h) * nq;
    if (r0 < nq) lb[r0] = sdt::row_lse(m0, l0);
    if (r1 < nq) lb[r1] = sdt::row_lse(m1, l1);
  }
}

// The plan of the 576 < d <= 1024 kernel: the wide plan's 8 warps, 32 query
// rows and 32 keys per tile, with O's columns split over blocks in slices of
// OC. Shared memory: Q at the whole padded head dim DK, two stages of a
// DC-column chunk of K, one V tile of the slice's OC columns, the bf16 P
// tile and the exchange of row maxima and sums.
template <int DK, int OC>
struct SplitPlan {
  static constexpr int WARPS = 8;
  static constexpr int THREADS = 256;
  static constexpr int BQ = 32;
  static constexpr int BK = 32;
  static constexpr int DC = 128;
  static constexpr int LDQ = DK + 8;
  static constexpr int LDK = DC + 8;
  static constexpr int LDV = OC + 8;
  static constexpr int LDP = BK + 8;
  static constexpr int KS = BQ * LDQ;            // element offset of K's stage 0
  static constexpr int VS = KS + 2 * BK * LDK;   // element offset of V
  static constexpr int PT = VS + BK * LDV;       // element offset of P
  static constexpr int RED = (PT + BQ * LDP) * 2;  // byte offset of the fp32 [2][4][16] exchange
  static constexpr int BYTES = RED + 2 * 4 * 16 * 4;
  static_assert(OC % 64 == 0, "a slice's columns split into pairs of n8 tiles over 4 warps");
  static_assert(DK % DC == 0, "Q's padding covers the last chunk");
};

// Copies columns [c0, c0 + COLS) of rows [row0, row0 + ROWS) of one (batch,
// head) slice into shared memory at pitch LD with cp.async; rows at or past
// n and columns at or past `cols` are zero-filled.
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

template <int DK, int OC>
__global__ void __launch_bounds__(256)
flash_fwd_kernel_split(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int nq, int nk, int heads, int d, float sl) {
  using P = SplitPlan<DK, OC>;
  constexpr int BK = P::BK;
  constexpr int DC = P::DC;
  constexpr int NO = OC / 32;  // n8 tiles of O per warp (OC / 4 columns)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = smem + P::VS;
  bf16* ps = smem + P::PT;
  float* red = reinterpret_cast<float*>(smem_raw + P::RED);

  const int slices = gridDim.y / heads;
  const int h = blockIdx.y / slices;
  const int slice = blockIdx.y - h * slices;
  const int q0 = blockIdx.x * P::BQ;
  const int b = blockIdx.z;
  const int s0 = slice * OC;            // the block's first column of O
  const int ow = min(OC, d - s0);       // its columns of O
  const int row_stride = heads * d;
  const bf16* qb = q + ((size_t)b * nq * heads + h) * d;
  const bf16* kb = k + ((size_t)b * nk * heads + h) * d;
  const bf16* vb = v + ((size_t)b * nk * heads + h) * d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int rg = warp / 4;              // row group: rows rg * 16 ..
  const int cg = warp % 4;              // keys cg * 8 .. of a tile, slice columns cg * OC / 4 ..
  const int col0 = cg * (OC / 4);
  const int nv = (ow - col0 + 7) / 8;   // this warp's n8 tiles of O inside the slice (may be <= 0)
  float* red_row = red + rg * 64;       // [4][16] of this row group
  const int nchunks = (d + DC - 1) / DC;

  if (d < DK) zero_padding<DK, P::LDQ, P::THREADS>(smem, P::BQ, d);
  load_rows<P::BQ, P::LDQ, P::THREADS>(smem, qb, q0, nq, row_stride, d / 8);
  load_tile<BK, DC, P::LDK, P::THREADS>(smem + P::KS, kb, 0, nk, row_stride, 0, d);
  sdt::cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;  // this thread's part of the sums over its warp's keys
  const bf16* qrow = smem + (rg * 16 + lane % 16) * P::LDQ + lane / 16 * 8;

  int step = 0;  // chunks streamed so far: chunk `step` sits in stage step & 1
  const int ntiles = (nk + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    // S over this warp's 8 keys of the tile, the contraction in chunks of DC
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < nchunks; ++c, ++step) {
      sdt::cp_async_wait<0>();
      __syncthreads();
      // the last tile's P V is done: its V tile may be overwritten
      if (c == 0)
        load_tile<BK, OC, P::LDV, P::THREADS>(vs, vb, t * BK, nk, row_stride, s0, s0 + ow);
      bf16* next = smem + P::KS + ((step + 1) & 1) * BK * P::LDK;
      if (c + 1 < nchunks)
        load_tile<BK, DC, P::LDK, P::THREADS>(next, kb, t * BK, nk, row_stride, (c + 1) * DC, d);
      else if (t + 1 < ntiles)
        load_tile<BK, DC, P::LDK, P::THREADS>(next, kb, (t + 1) * BK, nk, row_stride, 0, d);
      sdt::cp_async_commit();
      const bf16* krow = smem + P::KS + (step & 1) * BK * P::LDK + (cg * 8 + lane % 8) * P::LDK +
                         lane / 8 * 8;
#pragma unroll
      for (int kk = 0; kk < DC / 16; kk += 2) {
        if (c * DC + kk * 16 < d) {
          unsigned kf[4], qa[4], qc[4];
          sdt::ldmatrix_x4(kf, krow + kk * 16);
          sdt::ldmatrix_x4(qa, qrow + c * DC + kk * 16);
          sdt::ldmatrix_x4(qc, qrow + c * DC + kk * 16 + 16);
          sdt::mma(s, qa, kf[0], kf[1]);
          sdt::mma(s, qc, kf[2], kf[3]);
        }
      }
    }
    const int cidx = t * BK + cg * 8 + 2 * tq;
    if (cidx >= nk) s[0] = s[2] = -INFINITY;
    if (cidx + 1 >= nk) s[1] = s[3] = -INFINITY;

    // the row max over the group's four warps
    float t0 = sdt::quad_max(fmaxf(s[0], s[1]));
    float t1 = sdt::quad_max(fmaxf(s[2], s[3]));
    if (tq == 0) {
      red_row[cg * 16 + g] = t0;
      red_row[cg * 16 + g + 8] = t1;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      t0 = fmaxf(t0, red_row[w * 16 + g]);
      t1 = fmaxf(t1, red_row[w * 16 + g + 8]);
    }
    const float n0 = fmaxf(m0, t0 * sl);
    const float n1 = fmaxf(m1, t1 * sl);
    const float e0 = n0 == -INFINITY ? 0.f : n0;
    const float e1 = n1 == -INFINITY ? 0.f : n1;
    const float c0 = sdt::exp2_approx(m0 - e0), c1 = sdt::exp2_approx(m1 - e1);
    m0 = n0;
    m1 = n1;
    l0 *= c0;
    l1 *= c1;
    sdt::rescale_rows(acc, c0, c1);
    const float p0 = sdt::exp2_approx(fmaf(s[0], sl, -e0));
    const float p1 = sdt::exp2_approx(fmaf(s[1], sl, -e0));
    const float p2 = sdt::exp2_approx(fmaf(s[2], sl, -e1));
    const float p3 = sdt::exp2_approx(fmaf(s[3], sl, -e1));
    l0 += p0 + p1;
    l1 += p2 + p3;
    bf16* prow = ps + (rg * 16 + g) * P::LDP + cg * 8 + 2 * tq;
    *reinterpret_cast<unsigned*>(prow) = sdt::pack_bf16(p0, p1);
    *reinterpret_cast<unsigned*>(prow + 8 * P::LDP) = sdt::pack_bf16(p2, p3);
    // this tile's V has landed (it was issued with the tile's first chunk)
    sdt::cp_async_wait<0>();
    __syncthreads();

    // O[:, this warp's columns of the slice] += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned pa[4];
      sdt::ldmatrix_x4(pa, ps + (rg * 16 + lane % 16) * P::LDP + kk * 16 + lane / 16 * 8);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        if (2 * dp < nv) {
          unsigned vf[4];
          sdt::ldmatrix_x4_trans(vf, vs + (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * P::LDV +
                                         col0 + dp * 16 + lane / 16 * 8);
          sdt::mma(acc[2 * dp], pa, vf[0], vf[1]);
          if (2 * dp + 1 < nv) sdt::mma(acc[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }

  // the row sums over the group's four warps
  l0 = sdt::quad_sum(l0);
  l1 = sdt::quad_sum(l1);
  __syncthreads();
  if (tq == 0) {
    red_row[cg * 16 + g] = l0;
    red_row[cg * 16 + g + 8] = l1;
  }
  __syncthreads();
  l0 = l1 = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    l0 += red_row[w * 16 + g];
    l1 += red_row[w * 16 + g + 8];
  }
  const int r0 = q0 + rg * 16 + g;
  const int r1 = r0 + 8;
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  bf16* ob = o + ((size_t)b * nq * heads + h) * d + s0;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (j < nv) {
      const int cc = col0 + j * 8 + 2 * tq;
      if (r0 < nq)
        *reinterpret_cast<unsigned*>(ob + (size_t)r0 * row_stride + cc) =
            sdt::pack_bf16(acc[j][0] * i0, acc[j][1] * i0);
      if (r1 < nq)
        *reinterpret_cast<unsigned*>(ob + (size_t)r1 * row_stride + cc) =
            sdt::pack_bf16(acc[j][2] * i1, acc[j][3] * i1);
    }
  }
  if (lse != nullptr && slice == 0 && cg == 0 && tq == 0) {
    float* lb = lse + ((size_t)b * heads + h) * nq;
    if (r0 < nq) lb[r0] = sdt::row_lse(m0, l0);
    if (r1 < nq) lb[r1] = sdt::row_lse(m1, l1);
  }
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, int bq, int slices, int threads, int bytes,
                          const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                          int batch, int nq, int nk, int heads, int d, float sl,
                          cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((nq + bq - 1) / bq, heads * slices, batch);
  kernel<<<grid, threads, bytes, stream>>>(q, k, v, o, lse, nq, nk, heads, d, sl);
  return cudaGetLastError();
}

// One plan per padded head dim: the kernel, its rows per block, keys per tile,
// threads and shared memory, and the split plan's column width (0 elsewhere).
struct Choice {
  void (*kernel)(const bf16*, const bf16*, const bf16*, bf16*, float*, int, int, int, int,
                 float);
  int bq, bk, threads, bytes, oc;
};

template <int DK, int WARPS, int BK, int MT>
Choice narrow() {
  using P = Plan<DK, WARPS, BK, MT>;
  static_assert(P::BYTES <= 232448, "shared memory per block");
  return {flash_fwd_kernel<DK, WARPS, BK, MT>, P::BQ, BK, P::THREADS, P::BYTES, 0};
}

template <int DK>
Choice wide() {
  using P = WidePlan<DK>;
  static_assert(P::BYTES <= 232448, "shared memory per block");
  return {flash_fwd_kernel_wide<DK>, P::BQ, P::BK, P::THREADS, P::BYTES, 0};
}

template <int DK, int OC>
Choice split() {
  using P = SplitPlan<DK, OC>;
  static_assert(P::BYTES <= 232448, "shared memory per block");
  return {flash_fwd_kernel_split<DK, OC>, P::BQ, P::BK, P::THREADS, P::BYTES, OC};
}

// The slices of O's columns a plan's grid runs over at head dim d.
int slices_of(const Choice& c, int d) { return c.oc ? (d + c.oc - 1) / c.oc : 1; }

// The widest head dim K1 takes (the first-stage extras' d = 1024 sites).
constexpr int kMaxHeadDim = 1024;

bool choose(int d, Choice* c) {
  if (d <= 0 || d % 8 || d > kMaxHeadDim) return false;
  switch (round_up(d, 16)) {
    case 16: *c = narrow<16, 4, 64, 2>(); return true;
    case 32: *c = narrow<32, 4, 64, 2>(); return true;
    case 48: *c = narrow<48, 4, 64, 2>(); return true;
    case 64: *c = narrow<64, 8, 64, 1>(); return true;
    case 80: *c = narrow<80, 4, 64, 1>(); return true;
    case 96: *c = narrow<96, 4, 64, 1>(); return true;
    case 112: *c = narrow<112, 4, 64, 1>(); return true;
    case 128: *c = narrow<128, 4, 64, 1>(); return true;
    case 144: *c = narrow<144, 4, 32, 1>(); return true;
    case 160: *c = narrow<160, 4, 32, 1>(); return true;
    default: break;
  }
  *c = d <= 256 ? wide<256>() : d <= 512 ? wide<512>() : d <= 576 ? wide<576>()
                                                     : split<1024, 256>();
  return true;
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success). d must be a
// multiple of 8 and at most 1024; the wrapper checks shapes and alignment.
// `lse` is null, or fp32 [B, H, Nq] for the row log-sum-exp.
extern "C" int sdt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int batch, int nq, int nk, int heads, int d,
                                   float scale, void* stream) {
  Choice c;
  if (!choose(d, &c)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_kernel(
      c.kernel, c.bq, slices_of(c, d), c.threads, c.bytes, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), batch, nq, nk, heads, d, scale * 1.4426950408889634f,
      static_cast<cudaStream_t>(stream)));
}

// K1's plan for head dim d: out = {query rows per block, keys per tile,
// threads, shared-memory bytes, resident blocks per SM, slices of O's columns
// per row tile}. Returns a CUDA error
// code (cudaErrorInvalidValue for a head dim K1 does not take).
extern "C" int sdt_flash_plan(int d, int* out) {
  Choice c;
  if (!choose(d, &c)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, c.kernel, c.threads, c.bytes);
  out[0] = c.bq;
  out[1] = c.bk;
  out[2] = c.threads;
  out[3] = c.bytes;
  out[4] = blocks;
  out[5] = slices_of(c, d);
  return static_cast<int>(err);
}

extern "C" const char* sdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
