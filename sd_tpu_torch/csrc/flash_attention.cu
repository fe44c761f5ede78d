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
// peak against 0.010 ms of bytes at 3.35 TB/s, at [1, 4096, 1, 1024] 0.069
// ms against 0.007 ms. At d = 40 the B * H * Nq * Nk exponentials on the
// special-function unit (16 a clock per SM) are a second floor of the same
// order.
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
// - 576 < d <= 4096 (the first-stage extras' one-head d = 640 to 1024
//   sites, cin256-v2's d = 960): the cluster plan. Q, K and V at the whole
//   head no longer fit a block, and O's 64 x d fp32 no longer fits a
//   warpgroup's registers, so the head's columns are split over the blocks
//   of a thread-block cluster: C = ceil(d / 512) blocks (2 up to d = 1024,
//   3 up to 1536, 4 up to 2048, 8 up to 4096, the portable cluster size),
//   each of two warpgroups that own 64 query rows (one wgmma M) and 256
//   columns apiece. Per 32-key tile each warpgroup contracts its columns
//   into a partial S = Q K^T on wgmma (both operands K-major from shared
//   memory), the block adds its two partials, and after one cluster barrier
//   every block sums the C block partials through distributed shared
//   memory in rank order, so that every warpgroup holds the same S to the
//   bit: the same P, row max and row sum, and rank 0's lse is the one every
//   block used. Then each warpgroup rescales and accumulates its 64 x 256
//   of O += P V on wgmma, P in registers as the A operand and V's tile read
//   MN-major. The function's 4 * Nq * Nk * d flops are done once (a split
//   of O's columns over independent blocks would recompute Q K^T in every
//   slice, 2-2.5x the work). Thread 0 brings Q and the key tiles by TMA (4-D boxes of 64
//   columns, zero-filled past the rows and the head dim) into two stages on
//   mbarriers. 230,416 bytes of shared memory (Q 64 KB, two stages of K and
//   V 128 KB, the warpgroups' partials 16 KB, two buffers of the block's
//   partial 16 KB), one block an SM; 216 registers a thread, no spills.
//   The cluster's blocks share one GPC: cudaOccupancyMaxActiveClusters
//   reads 66 clusters of 2, 30 of 4 and 15 of 8 on an H100 (sdt_flash_plan).
//   Its sum adds the partials in another order than one dot product over
//   d: within bf16 rounding of the plain version.
// - d > 4096 (any head dim sd_tpu's kernel runs at; no config of the
//   repository reaches one): a cluster would need more than 8 blocks, past
//   the portable size, so the stream plan takes it. Nothing of the
//   head is held whole: each cp.async stage holds a 128-column chunk of the
//   32-key tile's K and the same chunk of the block's 32 query rows, and
//   S = Q K^T accumulates over the whole d chunk by chunk in registers (four
//   warps of a row group take 8 keys each). The block then loads only its
//   slice of V's 256 columns (grid.y runs over heads x slices), and the
//   first slice writes lse. 54,784 bytes of shared memory at every d. Each
//   slice streams Q's and K's whole rows and recomputes Q K^T: (2 * slices
//   + 2) * Nq * Nk * d flops per head, 9.5x the function's at d = 4608.
//
// The ragged last key tile is zero-filled by the copy and masked to -inf
// before the max; query rows past Nq are zero-filled and not stored. d must
// be a multiple of 8 (the wrapper zero-pads another head dim on d), and
// scale positive.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "tma.cuh"

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

// The plan of the d > 2048 kernel (the stream plan): the wide plan's 8
// warps, 32 query rows and 32 keys per tile, with O's columns split over
// blocks in slices of OC. Shared memory: two stages of a DC-column chunk of
// the key tile's K and of the block's Q rows, one V tile of the slice's OC
// columns, the bf16 P tile and the exchange of row maxima and sums.
template <int OC>
struct StreamPlan {
  static constexpr int WARPS = 8;
  static constexpr int THREADS = 256;
  static constexpr int BQ = 32;
  static constexpr int BK = 32;
  static constexpr int DC = 128;
  static constexpr int LDK = DC + 8;
  static constexpr int LDV = OC + 8;
  static constexpr int LDP = BK + 8;
  static constexpr int STAGE = (BK + BQ) * LDK;  // K's chunk, then Q's
  static constexpr int VS = 2 * STAGE;           // element offset of V
  static constexpr int PT = VS + BK * LDV;       // element offset of P
  static constexpr int RED = (PT + BQ * LDP) * 2;  // byte offset of the fp32 [2][4][16] exchange
  static constexpr int BYTES = RED + 2 * 4 * 16 * 4;
  static_assert(OC % 64 == 0, "a slice's columns split into pairs of n8 tiles over 4 warps");
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

template <int OC>
__global__ void __launch_bounds__(256)
flash_fwd_kernel_stream(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int nq, int nk, int heads, int d, float sl) {
  using P = StreamPlan<OC>;
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

  // a stage's chunk: K's of keys row0 .. and the block's Q rows'
  auto load_chunk = [&](bf16* stage, int row0, int c0) {
    load_tile<BK, DC, P::LDK, P::THREADS>(stage, kb, row0, nk, row_stride, c0, d);
    load_tile<P::BQ, DC, P::LDK, P::THREADS>(stage + BK * P::LDK, qb, q0, nq, row_stride, c0,
                                             d);
  };
  load_chunk(smem, 0, 0);
  sdt::cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;  // this thread's part of the sums over its warp's keys
  // this thread's ldmatrix row of Q in a stage's Q chunk
  const int qoff = BK * P::LDK + (rg * 16 + lane % 16) * P::LDK + lane / 16 * 8;

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
      bf16* next = smem + ((step + 1) & 1) * P::STAGE;
      if (c + 1 < nchunks)
        load_chunk(next, t * BK, (c + 1) * DC);
      else if (t + 1 < ntiles)
        load_chunk(next, (t + 1) * BK, 0);
      sdt::cp_async_commit();
      const bf16* stage = smem + (step & 1) * P::STAGE;
      const bf16* krow = stage + (cg * 8 + lane % 8) * P::LDK + lane / 8 * 8;
      const bf16* qrow = stage + qoff;
#pragma unroll
      for (int kk = 0; kk < DC / 16; kk += 2) {
        if (c * DC + kk * 16 < d) {
          unsigned kf[4], qa[4], qc[4];
          sdt::ldmatrix_x4(kf, krow + kk * 16);
          sdt::ldmatrix_x4(qa, qrow + kk * 16);
          sdt::ldmatrix_x4(qc, qrow + kk * 16 + 16);
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

// The plan of the cluster kernel (576 < d <= 4096): a block of two
// warpgroups owns 64 query rows (one wgmma M) and 512 columns of the head,
// each warpgroup 256 of them; a cluster of ceil(d / 512) blocks covers the
// head. Keys come in tiles of 32. Shared memory, in wgmma's
// 128-byte-swizzled K-major layout (blocks of 64 columns, rows of 128
// bytes, 8-row atoms of 1024 bytes): Q's columns, two stages of K's and
// V's columns of a key tile, the two warpgroups' fp32 partial S in the
// accumulator's register order (the room where the cluster's sum lands
// too), two buffers of the block's partial S and the stages' mbarriers.
// Thread 0 brings Q and every key tile by TMA (one box a 64-column block,
// head_map's 4-D boxes, zero-filled past the rows and the head dim).
struct ClusterPlan {
  static constexpr int THREADS = 256;
  static constexpr int BQ = 64;
  static constexpr int BK = 32;
  static constexpr int W = 512;                  // the block's columns
  static constexpr int MAX_CLUSTER = 8;          // the portable cluster size
  static constexpr int KS = BQ * W * 2;          // byte offset of stage 0 (K, then V)
  static constexpr int STAGE = 2 * BK * W * 2;
  static constexpr int PBUF = BQ * BK * 4;       // one partial S
  static constexpr int SLOTS = KS + 2 * STAGE;   // byte offset of the warpgroups' partials
  static constexpr int BP = SLOTS + 2 * PBUF;    // byte offset of the block's partials
  static constexpr int BARS = BP + 2 * PBUF;     // byte offset of the stages' mbarriers
  static constexpr int BYTES = BARS + 16 + 1024;  // with the slack that aligns the atoms
};

// 576 < d <= 4096 (the first-stage extras' one-head d = 640 to 1024 sites,
// cin256-v2's d = 960). Block `rank` of a cluster owns columns [512 rank,
// 512 rank + 512) of the head for 64 query rows, warpgroup wg of them the
// 256 from 512 rank + 256 wg. Per key tile:
// - each warpgroup computes its partial S = Q[:, cols] K[:, cols]^T on
//   wgmma (64 x 32, 16 k16 steps) and stores it in the accumulator's
//   register order;
// - the block adds its two warpgroups' partials (warpgroup 0's first) into
//   its partial, a quarter of the elements a thread;
// - after the cluster's barrier, the block sums the cluster's partials in
//   rank order through distributed shared memory, again a quarter of the
//   elements a thread: each block's partial crosses the cluster once per
//   reader block, and every block adds in one order, so that every
//   warpgroup of the cluster holds the same S to the bit and so the same P,
//   row max and row sum;
// - each warpgroup runs the online softmax in registers and accumulates
//   O[:, cols] += P V[:, cols] on wgmma with P in registers.
// The block's partials are double-buffered: a block writes tile t's buffer
// again at tile t + 2, after it has passed the barrier of tile t + 1, which
// no block reaches before it has read tile t's partials; so one cluster
// barrier a tile suffices. Warpgroup 0 of rank 0 writes lse.
__global__ void __launch_bounds__(ClusterPlan::THREADS, 1)
flash_fwd_kernel_cluster(const __grid_constant__ CUtensorMap qm,
                         const __grid_constant__ CUtensorMap km,
                         const __grid_constant__ CUtensorMap vm, bf16* __restrict__ o,
                         float* __restrict__ lse, int nq, int nk, int heads, int d, float sl) {
  using P = ClusterPlan;
  constexpr int T = P::THREADS;
  constexpr int BK = P::BK;
  constexpr int W = P::W;
  constexpr int NS = BK / 8;       // n8 tiles of S
  constexpr int NO = 256 / 8;      // n8 tiles of a warpgroup's columns of O
  constexpr int NP = NS * 128;     // float4s of a partial S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the atoms' 1024-byte alignment; the same offset in every CTA, so the
  // partials sit at one offset across the cluster
  unsigned char* smem = smem_raw + ((1024 - (sdt::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BARS);

  const int csize = gridDim.x;
  const int q0 = blockIdx.y * P::BQ;
  const int h = blockIdx.z % heads;
  const int b = blockIdx.z / heads;
  const int row_stride = heads * d;
  const int tid = threadIdx.x;
  const int wg = tid / 128, wt = tid % 128;  // this thread's warpgroup, its index there
  const int warp = wt / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int bc0 = blockIdx.x * W;   // the block's first column
  const int c0 = bc0 + wg * 256;    // this warpgroup's first column

  // thread 0: key tile t's K and V into stage t & 1, 8 boxes of 64 columns each
  auto load_kv = [&](int t) {
    unsigned char* st = smem + P::KS + (t & 1) * P::STAGE;
    for (int cb = 0; cb < W / 64; ++cb) {
      sdt::tma_load_4d(st + cb * (BK * 128), &km, bc0 + 64 * cb, h, t * BK, b, &full[t & 1]);
      sdt::tma_load_4d(st + BK * W * 2 + cb * (BK * 128), &vm, bc0 + 64 * cb, h, t * BK, b,
                       &full[t & 1]);
    }
  };
  if (tid == 0) {
    sdt::mbar_init(&full[0], 1);
    sdt::mbar_init(&full[1], 1);
    sdt::mbar_init_fence();
    sdt::mbar_expect_tx(&full[0], P::KS + P::STAGE);
    for (int cb = 0; cb < W / 64; ++cb)
      sdt::tma_load_4d(smem + cb * (P::BQ * 128), &qm, bc0 + 64 * cb, h, q0, b, &full[0]);
    load_kv(0);
  }
  __syncthreads();

  float acc[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;  // this thread's part of the sums of rows g and g + 8
  float4* slots = reinterpret_cast<float4*>(smem + P::SLOTS);  // [2 warpgroups][NP]

  const int ntiles = (nk + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    sdt::mbar_wait(&full[t & 1], (t >> 1) & 1);
    const unsigned char* ks = smem + P::KS + (t & 1) * P::STAGE;
    const unsigned char* vs = ks + BK * W * 2;

    // this warpgroup's partial S over its 256 columns: column blocks 4 wg ..
    // 4 wg + 3 of Q and K
    float s[NS * 4];
    sdt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const int cb = 4 * wg + kk / 4;
      sdt::wgmma_bf16_k<BK>(s, sdt::wgmma_desc<128>(smem + cb * (P::BQ * 128) + kk % 4 * 32, 1024),
                            sdt::wgmma_desc<128>(ks + cb * (BK * 128) + kk % 4 * 32, 1024),
                            kk > 0);
    }
    sdt::wgmma_commit();
    sdt::wgmma_wait<0>();
    sdt::fence_regs(s);
#pragma unroll
    for (int i = 0; i < NS; ++i)
      slots[wg * NP + i * 128 + wt] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2],
                                                  s[4 * i + 3]);
    // every thread is past tile t - 1's P V: its stage takes tile t + 1
    __syncthreads();
    if (tid == 0 && t + 1 < ntiles) {
      sdt::mbar_expect_tx(&full[(t + 1) & 1], P::STAGE);
      load_kv(t + 1);
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
      const int e = tid + m * T;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < P::MAX_CLUSTER; ++r)
        if (r < csize) sum = sdt::add4(sum, *sdt::cluster_ptr(bp + e, r));
      slots[e] = sum;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float4 x = slots[i * 128 + wt];
      s[4 * i] = x.x;
      s[4 * i + 1] = x.y;
      s[4 * i + 2] = x.z;
      s[4 * i + 3] = x.w;
    }
    const int kbase = t * BK;
    if (kbase + BK > nk) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int c = kbase + j * 8 + 2 * tq;
        if (c >= nk) s[4 * j] = s[4 * j + 2] = -INFINITY;
        if (c + 1 >= nk) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
      }
    }

    // online softmax of rows g and g + 8 of this warp's 16, in registers
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      t0 = fmaxf(t0, fmaxf(s[4 * j], s[4 * j + 1]));
      t1 = fmaxf(t1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float n0 = fmaxf(m0, sdt::quad_max(t0) * sl);
    const float n1 = fmaxf(m1, sdt::quad_max(t1) * sl);
    const float e0 = n0 == -INFINITY ? 0.f : n0;  // a row with no key yet stays at p = 0
    const float e1 = n1 == -INFINITY ? 0.f : n1;
    const float c0r = sdt::exp2_approx(m0 - e0), c1r = sdt::exp2_approx(m1 - e1);
    m0 = n0;
    m1 = n1;
    l0 *= c0r;
    l1 *= c1r;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[4 * j] *= c0r;
      acc[4 * j + 1] *= c0r;
      acc[4 * j + 2] *= c1r;
      acc[4 * j + 3] *= c1r;
    }
    unsigned pf[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p0 = sdt::exp2_approx(fmaf(s[4 * j], sl, -e0));
      const float p1 = sdt::exp2_approx(fmaf(s[4 * j + 1], sl, -e0));
      const float p2 = sdt::exp2_approx(fmaf(s[4 * j + 2], sl, -e1));
      const float p3 = sdt::exp2_approx(fmaf(s[4 * j + 3], sl, -e1));
      l0 += p0 + p1;
      l1 += p2 + p3;
      pf[j / 2][j % 2 * 2] = sdt::pack_bf16(p0, p1);
      pf[j / 2][j % 2 * 2 + 1] = sdt::pack_bf16(p2, p3);
    }

    // O[:, cols] += P V[:, cols], P from the registers
    sdt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sdt::wgmma_bf16_rs<256>(acc, pf[kk],
                              sdt::wgmma_desc<128>(vs + 4 * wg * (BK * 128) + kk * 2048, 1024,
                                                   BK * 128),
                              1);
    sdt::wgmma_commit();
    sdt::wgmma_wait<0>();
    sdt::fence_regs(acc);
  }
  // no block leaves while another may still read its last partial
  sdt::cluster_sync();

  l0 = sdt::quad_sum(l0);
  l1 = sdt::quad_sum(l1);
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  bf16* ob = o + ((size_t)b * nq * heads + h) * d;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = c0 + j * 8 + 2 * tq;
    if (c < d) {
      if (r0 < nq)
        *reinterpret_cast<unsigned*>(ob + (size_t)r0 * row_stride + c) =
            sdt::pack_bf16(acc[4 * j] * i0, acc[4 * j + 1] * i0);
      if (r1 < nq)
        *reinterpret_cast<unsigned*>(ob + (size_t)r1 * row_stride + c) =
            sdt::pack_bf16(acc[4 * j + 2] * i1, acc[4 * j + 3] * i1);
    }
  }
  if (lse != nullptr && blockIdx.x == 0 && wg == 0 && tq == 0) {
    float* lb = lse + ((size_t)b * heads + h) * nq;
    if (r0 < nq) lb[r0] = sdt::row_lse(m0, l0);
    if (r1 < nq) lb[r1] = sdt::row_lse(m1, l1);
  }
}

using Kernel = void (*)(const bf16*, const bf16*, const bf16*, bf16*, float*, int, int, int, int,
                        float);

// One plan per padded head dim: the kernel (null for the cluster plan, whose
// kernel takes tensor maps), its rows per block, keys per tile, threads and
// shared memory, the stream plan's column width (0 elsewhere) and the CTAs
// of a cluster (0: no cluster launch).
struct Choice {
  Kernel kernel;
  int bq, bk, threads, bytes, oc, cluster;
};

template <int DK, int WARPS, int BK, int MT>
Choice narrow() {
  using P = Plan<DK, WARPS, BK, MT>;
  static_assert(P::BYTES <= 232448, "shared memory per block");
  return {flash_fwd_kernel<DK, WARPS, BK, MT>, P::BQ, BK, P::THREADS, P::BYTES, 0, 0};
}

template <int DK>
Choice wide() {
  using P = WidePlan<DK>;
  static_assert(P::BYTES <= 232448, "shared memory per block");
  return {flash_fwd_kernel_wide<DK>, P::BQ, P::BK, P::THREADS, P::BYTES, 0, 0};
}

template <int OC>
Choice stream() {
  using P = StreamPlan<OC>;
  static_assert(P::BYTES <= 232448, "shared memory per block");
  return {flash_fwd_kernel_stream<OC>, P::BQ, P::BK, P::THREADS, P::BYTES, OC, 0};
}

Choice cluster(int d) {
  using P = ClusterPlan;
  static_assert(P::BYTES <= 232448, "shared memory per block");
  return {nullptr, P::BQ, P::BK, P::THREADS, P::BYTES, 0, (d + P::W - 1) / P::W};
}

const void* kernel_of(const Choice& c) {
  return c.cluster ? reinterpret_cast<const void*>(flash_fwd_kernel_cluster)
                   : reinterpret_cast<const void*>(c.kernel);
}

// The slices of O's columns a plan's grid runs over at head dim d.
int slices_of(const Choice& c, int d) {
  return c.oc ? (d + c.oc - 1) / c.oc : c.cluster ? c.cluster : 1;
}

bool choose(int d, Choice* c) {
  if (d <= 0 || d % 8) return false;
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
  *c = d <= 256   ? wide<256>()
       : d <= 512 ? wide<512>()
       : d <= 576 ? wide<576>()
       : d <= ClusterPlan::W * ClusterPlan::MAX_CLUSTER ? cluster(d)
                                                          : stream<256>();
  return true;
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success). d must be a
// multiple of 8; the wrapper checks shapes and alignment.
// `lse` is null, or fp32 [B, H, Nq] for the row log-sum-exp.
extern "C" int sdt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int batch, int nq, int nk, int heads, int d,
                                   float scale, void* stream) {
  Choice c;
  if (!choose(d, &c)) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  const float sl = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = (nq + c.bq - 1) / c.bq;
  cudaError_t err;
  if (c.cluster) {
    using P = ClusterPlan;
    CUtensorMap qm, km, vm;
    err = sdt::cached_head_map(&qm, qp, batch, nq, heads, d, P::BQ);
    if (err == cudaSuccess) err = sdt::cached_head_map(&km, kp, batch, nk, heads, d, P::BK);
    if (err == cudaSuccess) err = sdt::cached_head_map(&vm, vp, batch, nk, heads, d, P::BK);
    if (err == cudaSuccess)
      err = sdt::launch_clustered(flash_fwd_kernel_cluster, dim3(c.cluster, rows, batch * heads),
                                  c.threads, c.bytes, c.cluster, s, qm, km, vm, op, lp, nq, nk,
                                  heads, d, sl);
    return static_cast<int>(err);
  }
  err = sdt::smem_limit(reinterpret_cast<const void*>(c.kernel), c.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  c.kernel<<<dim3(rows, heads * slices_of(c, d), batch), c.threads, c.bytes, s>>>(
      qp, kp, vp, op, lp, nq, nk, heads, d, sl);
  return static_cast<int>(cudaGetLastError());
}

// K1's plan for head dim d: out = {query rows per block, keys per tile,
// threads, shared-memory bytes, resident blocks per SM, slices of O's columns
// per row tile, CTAs of a cluster (1: no cluster launch), the clusters the
// card co-schedules (cudaOccupancyMaxActiveClusters; 0 without a cluster
// launch)}. Returns a CUDA error code (cudaErrorInvalidValue for a head dim
// K1 does not take).
extern "C" int sdt_flash_plan(int d, int* out) {
  Choice c;
  if (!choose(d, &c)) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = kernel_of(c);
  cudaError_t err = sdt::smem_limit(kernel, c.bytes);
  int blocks = 0, clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, c.threads, c.bytes);
  if (err == cudaSuccess && c.cluster)
    err = sdt::active_clusters(kernel, c.threads, c.bytes, c.cluster, &clusters);
  out[0] = c.bq;
  out[1] = c.bk;
  out[2] = c.threads;
  out[3] = c.bytes;
  out[4] = blocks;
  out[5] = slices_of(c, d);
  out[6] = c.cluster ? c.cluster : 1;
  out[7] = clusters;
  return static_cast<int>(err);
}

extern "C" const char* sdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
