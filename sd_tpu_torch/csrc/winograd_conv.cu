// K8 and X3: Winograd F(2x2, 3x3) stride-1 SAME convolution for Hopper
// (sm_90a), NCHW activations, bias-free:
//
//   per 2x2 output tile (r, s) and its 4x4 input tile d = xpad[2r:2r+4, 2s:2s+4]
//   V_ab = (B^T d B)_ab            fp32, rounded to bf16 once
//   M_ab = sum_c V_ab[c] U_ab[c, k] bf16 products, fp32 accumulation
//   Y    = A^T M A                  fp32, combining over b first, then a
//
//   B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]]   A^T = [[1,1,1,0],[0,1,-1,-1]]
//
// K8 replaces the TPU kernel `_kernel` called through `_wino_pallas` in
// sd_tpu/ops/pallas/winograd_conv.py, which reads the four parity planes
// P_ij[r, s] = xpad[2r + i, 2s + j] that the host builds; here the host
// builds all four in one copy, [B, C, 2, 2, R + 1, S1p] with the row pitch
// S1p = S + 1 rounded up to 8 elements (16-byte rows). X3 replaces the
// kernel of `wino_split` in tools/exp_winograd.py, which splits the
// parities itself: the port's X3 reads the unpadded x and makes the SAME
// border zeros with cp.async's zero fill, so it needs no host pass at all.
// One kernel, templated on where the 4x4 tiles come from.
//
// What bounds it on the H100: the algorithm's products are
// 2 * B * (H/2) * (W/2) * 16 * C * K flops (2.25x fewer than the direct
// conv's) against about 2 * (B*C*H*W + 16*C*K + B*K*H*W) bytes; operations
// at the SD sites.
//
// Design, in the loop order of the TPU kernel (a outermost, C inside):
//
// - A block owns a TR x TS patch of the tile grid of one image (TM = TR * TS
//   = 16, 32, 48 or 64 tiles, 2TR x 2TS output pixels) and KB = 64 or 128
//   output channels, one
//   warpgroup (128 threads) per 64. For each row combination a the block
//   walks all of C in steps of CS channels and accumulates the four
//   products M_a0 .. M_a3 in registers: wgmma.mma_async m64nTMk16 (bf16 in,
//   fp32 accumulators, flash_mma.cuh's helpers) with the output channels as
//   M and the tiles as N, both operands read from shared memory. Only after
//   the last step does each thread fold them, elementwise in its own
//   registers (the four products' accumulators hold the same (channel,
//   tile) in the same thread): z0 = M_a0 + M_a1 + M_a2, z1 = M_a1 - M_a2 -
//   M_a3, into the four output sums Y_pq with A^T's signs. The fold runs 4
//   times a block, not once per channel step. Y_pq stays in registers where
//   TM = 32 or 16; at TM = 48 and 64 the products take 96 or 128 registers
//   a thread and Y_pq lives in fp32 shared memory, each thread's own words.
// - Per step, U's [4, CS, KB] slice of the row a and the rows of the input
//   patch that a reads arrive by cp.async (16 bytes a copy; 4 where X3's
//   rows are not 16-byte aligned, W % 8 != 0), with the SAME border and
//   ragged C zero-filled by the copy's source size. X3 stages the 2TR + 2
//   input rows and an aligned column window of 2TS + 16 around the 2TS + 2
//   columns it needs, so the halo is read once per patch; K8 the four
//   planes' TR + 1 rows. Each thread owns one spatial slot of the patch copy
//   and walks the channels, so a copy costs a few adds. The transform
//   computes V_a0 .. V_a3 of the step once for the block (fp32, one
//   rounding; a thread takes four neighbouring tiles of one channel). U and
//   V are stored in wgmma's swizzled layouts (atoms of 8 input channels x
//   128, 64 or 32 bytes), so the copies of a row of U and eight channels'
//   stores of V fill whole rows without bank conflicts. At step t the products of
//   t run on the tensor cores while the threads transform the input of
//   t + 1 and the copies of U(t + 1) and of the patch of t + 2 are in
//   flight; one __syncthreads a step.
// - The input transform of a (tile, channel) is done once per block of KB
//   output channels. The plan (patch, KB, CS) is chosen per shape by
//   `choose_plan` from the blocks each plan gives and how many fit on an
//   SM; `sdt_winograd_plan` reports it.
// - The epilogue writes y[b, k, 2r + p, 2s + q] as bf16 pairs (q = 0, 1);
//   tiles past R or S and channels past K are not stored.
//
// What holds it back (PERF.md): the copies, the transform, the products and
// the barrier of a step each take a similar share and overlap only in
// part; the sites with fewer blocks than SMs leave SMs idle. The TPU kernel
// rounds V to bf16 after each of its two combination steps (bf16 vector
// arithmetic); this kernel rounds once, after both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using sdt::bf16;

// A plan: NWG warpgroups, each owning 64 output channels of the block's KB
// = 64 NWG; the block's TM tiles (16, 32 or 64) form a TR x TS patch; CS
// input channels a step. The products run as wgmma with the output
// channels as M and the tiles as N: D[k][tile] += U_ab[c][k]^T V_ab[c][tile].
// Each thread holds 4 x TM / 2 accumulators; with YS the four output sums
// Y_pq live in fp32 shared memory (each thread's own words), else in
// registers beside them.
template <bool SPLIT, int NWG, int TM, int TS, int CS, bool YS>
struct Plan {
  static constexpr int TR = TM / TS;
  static constexpr int KB = 64 * NWG;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int NACC = TM / 2;  // accumulators a thread, per product
  // staged rows a channel: X3 the input rows 2 r0 - 1 .. 2 r0 + 2 TR; K8 the
  // rows r0 .. r0 + TR of each of the four planes
  static constexpr int PROWS = SPLIT ? 2 * TR + 2 : 4 * (TR + 1);
  // staged columns: X3 from 2 s0 - 8 (16-byte aligned), 2 TS + 16; K8 from
  // s0 rounded down to 8, the TS + 1 columns past s0 % 8
  static constexpr int PW = SPLIT ? 2 * TS + 16 : 8 * ((TS + 1 + TS % 8 + 7) / 8);
  // a channel's patch, padded to an odd multiple of 16 bytes so that eight
  // channels' 16-byte reads fall in eight bank groups
  static constexpr int CP = (PROWS * PW + 8) / 16 * 16 + 8;
  static constexpr int PATCH = CS * CP;
  // U's slice [b][c / 8][k / 64][c % 8][k % 64] and V's [b][c / 8][tile /
  // (VROW / 2)][c % 8][tile % (VROW / 2)]: wgmma's swizzled atoms of 8 rows
  // (128 bytes a row for U, VROW for V), aligned to 1024 bytes
  static constexpr int UBUF = 4 * CS * KB;
  static constexpr int VBUF = 4 * CS * TM;
  // V's atoms: rows of VROW bytes, VATOMS of them across the TM tiles
  static constexpr int VROW = TM % 64 == 0 ? 128 : TM % 32 == 0 ? 64 : 32;
  static constexpr int VATOMS = 2 * TM / VROW;
  static constexpr int YBYTES = YS ? 4 * NACC * THREADS * 4 : 0;
  static constexpr int BYTES = 1024 + 2 * 2 * (PATCH + UBUF + VBUF) + YBYTES;
  static_assert(TM % TS == 0 && TS % 4 == 0 && CS % 16 == 0 && TM % 16 == 0, "plan shape");
};

__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// in: K8 the parity buffer [B, C, 2, 2, R + 1, S1p]; X3 x [B, C, H, W].
// u [16, C, K], y [B, K, H, W].
template <bool SPLIT, int NWG, int TM, int TS, int CS, bool YS>
__global__ void __launch_bounds__(128 * NWG, 1)
winograd_kernel(const bf16* __restrict__ in, const bf16* __restrict__ u, bf16* __restrict__ y,
                int C, int H, int W, int K, int S1p) {
  using P = Plan<SPLIT, NWG, TM, TS, CS, YS>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (-sdt::smem_addr(smem_raw) & 1023);  // 1024-byte aligned
  bf16* us = reinterpret_cast<bf16*>(smem);  // [2][4][CS / 8][KB / 64][8][64]
  bf16* vs = us + 2 * P::UBUF;               // [2][4][CS / 8][8][TM]
  bf16* patch = vs + 2 * P::VBUF;            // [2][CS][CP]
  float* ys = reinterpret_cast<float*>(patch + 2 * P::PATCH);  // [4][NACC][THREADS]
  const int R = H / 2, S = W / 2;
  const int pcols = (S + TS - 1) / TS;
  const int r0 = blockIdx.x / pcols * P::TR;
  const int s0 = blockIdx.x % pcols * TS;
  const int k0 = blockIdx.y * P::KB;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, wg = tid / 128, wq = (tid / 32) % 4;
  const int nsteps = (C + CS - 1) / CS;
  const int total = 4 * nsteps;

  // The patch copies. Each thread owns one spatial slot (a row of the patch
  // and a 16- or 4-byte column chunk of it; X3's rows are 4-byte aligned
  // only where W % 8 != 0) and walks the channels with a stride; the slot's
  // decomposition is computed once here, so a copy costs a few adds.
  const int vec = SPLIT && W % 8 ? 2 : 8;  // elements a copy
  const int nch = P::PW / vec;
  constexpr int SROWS = SPLIT ? 2 * P::TR : (P::TR > 1 ? 4 * P::TR : 2 * P::TR + 2);
  static_assert(P::PW / (SPLIT ? 2 : 8) * SROWS <= P::THREADS, "a slot for each chunk");
  int slots = 1;
  while (slots < nch * SROWS) slots *= 2;
  const int slot = tid % slots, clanes = P::THREADS / slots, clane = tid / slots;
  const int srow = slot / nch, sch = slot % nch;
  const int xs = SPLIT ? 2 * s0 - 8 : s0 & ~7;
  const int xx = xs + vec * sch;

  // The rows of the patch that the row combination a reads, channels
  // c0 .. c0 + CS, into patch buffer buf (no copy group of its own). X3:
  // a = 0 reads the even rows 2k, a = 3 the odd rows 2k + 1, a = 1, 2 the
  // rows 1 .. 2 TR. K8: a = 0 the planes P0j, a = 3 P1j, rows 0 .. TR;
  // a = 1, 2 P0j rows 1 .. TR and P1j rows 0 .. TR - 1.
  auto stage_patch = [&](int a, int c0, int buf) {
    const bool mid = a == 1 || a == 2;
    // a slot past this pass's rows copies nothing: its row would fall in
    // the next channel's
    if (srow >= (SPLIT ? (mid ? 2 * P::TR : P::TR + 1) : (mid ? 4 * P::TR : 2 * P::TR + 2)))
      return;
    bf16* pd = patch + buf * P::PATCH + vec * sch;
    if (SPLIT) {
      const int pr = mid ? srow + 1 : 2 * srow + (a == 3);
      const int yy = 2 * r0 - 1 + pr;
      const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const size_t plane = (size_t)H * W;
      const bf16* src = in + ((size_t)b * C + c0 + clane) * plane + (size_t)yy * W + xx;
      bf16* dst = pd + clane * P::CP + pr * P::PW;
      for (int c = clane; c < CS; c += clanes) {
        const bool cok = ok && c0 + c < C;
        if (vec == 8)
          sdt::cp_async16(dst, cok ? src : in, cok);
        else
          sdt::cp_async4(dst, cok ? src : in, cok);
        src += clanes * plane;
        dst += clanes * P::CP;
      }
    } else {
      constexpr int PR = P::TR + 1;
      int pl, row;
      if (mid) {
        pl = srow / P::TR;
        row = srow % P::TR + (pl < 2);
      } else {
        pl = srow / PR + (a == 3 ? 2 : 0);
        row = srow % PR;
      }
      const int rr = r0 + row;
      const bool ok = rr <= R && xx < S1p;
      const size_t plane = (size_t)(R + 1) * S1p;
      const bf16* src =
          in + (((size_t)b * C + c0 + clane) * 4 + pl) * plane + (size_t)rr * S1p + xx;
      bf16* dst = pd + clane * P::CP + (pl * PR + row) * P::PW;
      for (int c = clane; c < CS; c += clanes) {
        const bool cok = ok && c0 + c < C;
        sdt::cp_async16(dst, cok ? src : in, cok);
        src += clanes * 4 * plane;
        dst += clanes * P::CP;
      }
    }
  };

  // U[4a .. 4a + 3, c0 .. c0 + CS, k0 .. k0 + KB] into U buffer buf, a 16-byte
  // chunk (8 output channels of one input channel) a copy, neighbouring
  // threads along a row of U
  constexpr int UCH = 4 * CS * P::KB / 8;
  static_assert(UCH % P::THREADS == 0, "U copy");
  auto stage_u = [&](int a, int c0, int buf) {
    unsigned char* ud = reinterpret_cast<unsigned char*>(us + buf * P::UBUF);
#pragma unroll
    for (int j = 0; j < UCH / P::THREADS; ++j) {
      const int q = tid + j * P::THREADS;
      const int kc = q % (P::KB / 8), c = q / (P::KB / 8) % CS, bb = q / (P::KB / 8 * CS);
      const bool ok = c0 + c < C && k0 + 8 * kc < K;
      const unsigned atom = ((bb * (CS / 8) + c / 8) * (P::KB / 64) + kc / 8) * 1024;
      sdt::cp_async16(ud + atom + sdt::swizzle<128>((c % 8) * 128 + (kc % 8) * 16),
                      ok ? u + ((size_t)(4 * a + bb) * C + c0 + c) * K + k0 + 8 * kc : u, ok);
    }
  };

  // V_a0 .. V_a3 of the row combination a from patch buffer buf into V buffer
  // buf: B^T's row a is t = d_i1 + sg d_i2 (fp32), then the four column
  // combinations, rounded once. A thread takes four neighbouring tiles of one
  // channel (ten columns of t); eight neighbouring threads take eight
  // channels, so that their stores fill one core matrix.
  auto transform = [&](int a, int buf) {
    const int i1 = a == 0 ? 0 : a == 2 ? 2 : 1;
    const int i2 = a == 0 ? 2 : a == 2 ? 1 : a == 1 ? 2 : 3;
    const float sg = a == 1 ? 1.f : -1.f;
    const bf16* pd = patch + buf * P::PATCH;
    bf16* vd = vs + buf * P::VBUF;
    for (int i = tid; i < CS * TM / 4; i += P::THREADS) {
      const int cl = i % 8, quad = i / 8 % (TM / 4), cg = i / (2 * TM);
      const int c = cg * 8 + cl, tile = 4 * quad;
      const int rr = tile / TS, sq = tile % TS / 4;
      float d[2][10];  // the rows i1, i2 of the four tiles' input, columns 0 .. 9
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int ii = n == 0 ? i1 : i2;
        if (SPLIT) {
          // window columns 8 sq + 7 .. 8 sq + 16
          const bf16* row = pd + c * P::CP + (2 * rr + ii) * P::PW + 8 * sq;
          const unsigned w0 = *reinterpret_cast<const unsigned*>(row + 6);
          const uint4 q = *reinterpret_cast<const uint4*>(row + 8);
          const unsigned w2 = *reinterpret_cast<const unsigned*>(row + 16);
          d[n][0] = bf_hi(w0);
          d[n][1] = bf_lo(q.x);
          d[n][2] = bf_hi(q.x);
          d[n][3] = bf_lo(q.y);
          d[n][4] = bf_hi(q.y);
          d[n][5] = bf_lo(q.z);
          d[n][6] = bf_hi(q.z);
          d[n][7] = bf_lo(q.w);
          d[n][8] = bf_hi(q.w);
          d[n][9] = bf_lo(w2);
        } else {
          // column j of the tiles is plane column (s0 % 8) + 4 sq + j / 2 of
          // the plane of parity (ii % 2, j % 2), row rr + ii / 2
#pragma unroll
          for (int pj = 0; pj < 2; ++pj) {
            const bf16* row = pd + c * P::CP +
                              ((2 * (ii & 1) + pj) * (P::TR + 1) + rr + (ii >> 1)) * P::PW +
                              (s0 & 7) + 4 * sq;
            const uint2 q = *reinterpret_cast<const uint2*>(row);
            d[n][pj] = bf_lo(q.x);
            d[n][pj + 2] = bf_hi(q.x);
            d[n][pj + 4] = bf_lo(q.y);
            d[n][pj + 6] = bf_hi(q.y);
            d[n][pj + 8] = __bfloat162float(row[4]);
          }
        }
      }
      float t[10];
#pragma unroll
      for (int j = 0; j < 10; ++j) t[j] = d[0][j] + sg * d[1][j];
      unsigned char* vt = reinterpret_cast<unsigned char*>(vd) +
                          (cg * P::VATOMS + tile / (P::VROW / 2)) * 8 * P::VROW +
                          sdt::swizzle<P::VROW>(cl * P::VROW + tile % (P::VROW / 2) * 2);
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        float v[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float* th = t + 2 * h;
          v[h] = bb == 0 ? th[0] - th[2] : bb == 1 ? th[1] + th[2] : bb == 2 ? th[2] - th[1]
                                                                             : th[1] - th[3];
        }
        *reinterpret_cast<uint2*>(vt + bb * CS * 2 * TM) =
            make_uint2(sdt::pack_bf16(v[0], v[1]), sdt::pack_bf16(v[2], v[3]));
      }
    }
  };

  // The products of step st: for each b and k16 step, U's 64 x 16 (this
  // warpgroup's channels) and V's 16 x TM core matrices, MN-major.
  float m[4][P::NACC];  // M_ab over C: [b][wgmma accumulator]
  auto products = [&](int buf, int accumulate) {
    const bf16* ub = us + buf * P::UBUF;
    const bf16* vb = vs + buf * P::VBUF;
    sdt::wgmma_fence();
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)
#pragma unroll
      for (int kk = 0; kk < CS / 16; ++kk) {
        const uint64_t da = sdt::wgmma_desc<128>(
            ub + ((bb * (CS / 8) + 2 * kk) * (P::KB / 64) + wg) * 512, P::KB / 64 * 1024);
        const uint64_t db = sdt::wgmma_desc<P::VROW>(vb + (bb * (CS / 8) + 2 * kk) * 8 * TM,
                                                     P::VATOMS * 8 * P::VROW, 8 * P::VROW);
        sdt::wgmma_bf16<TM>(m[bb], da, db, accumulate | kk);
      }
    sdt::wgmma_commit();
  };

  float yv[YS ? 1 : 4][YS ? 1 : P::NACC];  // Y_pq in registers (not YS)
  // Y_pq [2p + q] of this thread's accumulator element j
  auto yat = [&](int pq, int j) -> float& {
    if constexpr (YS)
      return ys[(pq * P::NACC + j) * P::THREADS + tid];
    else
      return yv[pq][j];
  };

  // Pipeline: at step st the products of st run on the tensor cores while
  // the threads transform the input of st + 1 and the copies of U(st + 1)
  // and of the patch of st + 2 are in flight.
  int a0 = 0, cs0 = 0, a1 = nsteps > 1 ? 0 : 1, cs1 = nsteps > 1 ? 1 : 0;
  int a2 = a1, cs2 = cs1 + 1;
  if (cs2 == nsteps) {
    cs2 = 0;
    ++a2;
  }
  stage_patch(0, 0, 0);
  stage_u(0, 0, 0);
  if (total > 1) stage_patch(a1, cs1 * CS, 1);
  sdt::cp_async_commit();
  sdt::cp_async_wait<0>();
  __syncthreads();
  transform(0, 0);
  for (int st = 0; st < total; ++st) {
    // publishes V(st), U(st) and the patch of st + 1 (to wgmma's proxy too),
    // and frees the buffers that step st - 1 read
    sdt::cp_async_wait<0>();
    sdt::fence_proxy_async();
    __syncthreads();
    if (st + 1 < total) stage_u(a1, cs1 * CS, (st + 1) & 1);
    if (st + 2 < total) stage_patch(a2, cs2 * CS, st & 1);
    sdt::cp_async_commit();
    products(st & 1, cs0 > 0);
    if (st + 1 < total) transform(a1, (st + 1) & 1);
    sdt::wgmma_wait<0>();
    if (cs0 == nsteps - 1) {
      // M_a. summed over all of C: fold over b, then into Y over a (the
      // first touch of Y_0q at a = 0 and of Y_1q at a = 1 stores)
      const int a = a0;
#pragma unroll
      for (int j = 0; j < P::NACC; ++j) {
        const float z0 = m[0][j] + m[1][j] + m[2][j];
        const float z1 = m[1][j] - m[2][j] - m[3][j];
        if (a == 0) {
          yat(0, j) = z0;
          yat(1, j) = z1;
        } else if (a == 1) {
          yat(0, j) += z0;
          yat(1, j) += z1;
          yat(2, j) = z0;
          yat(3, j) = z1;
        } else if (a == 2) {
          yat(0, j) += z0;
          yat(1, j) += z1;
          yat(2, j) -= z0;
          yat(3, j) -= z1;
        } else {
          yat(2, j) -= z0;
          yat(3, j) -= z1;
        }
      }
    }
    a0 = a1;
    cs0 = cs1;
    a1 = a2;
    cs1 = cs2;
    if (++cs2 == nsteps) {
      cs2 = 0;
      ++a2;
    }
  }

  // accumulator j = 4 n + 2 h + e: channel 16 wq + g + 8 h of this
  // warpgroup's 64, tile 8 n + 2 t + e
#pragma unroll
  for (int j = 0; j < P::NACC; ++j) {
    const int k = k0 + 64 * wg + 16 * wq + lane / 4 + 8 * (j / 2 % 2);
    const int tl = 8 * (j / 4) + 2 * (lane % 4) + j % 2;
    const int r = r0 + tl / TS, s = s0 + tl % TS;
    if (r >= R || s >= S || k >= K) continue;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const size_t off = (((size_t)b * K + k) * H + 2 * r + p) * W + 2 * s;
      *reinterpret_cast<unsigned*>(y + off) = sdt::pack_bf16(yat(2 * p, j), yat(2 * p + 1, j));
    }
  }
}

typedef void (*Kernel)(const bf16*, const bf16*, bf16*, int, int, int, int, int);

struct Choice {
  Kernel kernel;
  int tr, ts, kb, cs, threads, bytes;
};

template <bool SPLIT, int NWG, int TM, int TS, int CS, bool YS>
Choice make() {
  using P = Plan<SPLIT, NWG, TM, TS, CS, YS>;
  static_assert(P::BYTES <= 232448, "shared memory per block");
  return {winograd_kernel<SPLIT, NWG, TM, TS, CS, YS>, P::TR, TS, P::KB, CS, P::THREADS,
          P::BYTES};
}

constexpr int kPlans = 6;

// (NWG, TM, TS, CS, Y in shared memory): TM tiles a block as (TM / TS) x
// TS, 64 NWG output channels
template <bool SPLIT>
Choice plan_at(int i) {
  switch (i) {
    case 0: return make<SPLIT, 2, 64, 16, 16, true>();  // 4 x 16 tiles, 128 channels
    case 1: return make<SPLIT, 2, 32, 16, 32, false>();  // 2 x 16, 128
    case 2: return make<SPLIT, 1, 32, 16, 32, false>();  // 2 x 16, 64
    case 3: return make<SPLIT, 2, 32, 8, 32, false>();   // 4 x 8, 128
    case 4: return make<SPLIT, 1, 16, 4, 32, false>();   // 4 x 4, 64
    default: return make<SPLIT, 2, 48, 16, 16, true>();  // 3 x 16, 128
  }
}

// The plan's shared-memory attribute, set once, and its resident blocks per SM.
template <bool SPLIT>
cudaError_t prepare(int i, const Choice& c, int* per_sm) {
  static int cached[kPlans] = {};
  if (cached[i] == 0) {
    cudaError_t err =
        cudaFuncSetAttribute(c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached[i], c.kernel, c.threads,
                                                          c.bytes);
    if (err != cudaSuccess) return err;
  }
  *per_sm = cached[i];
  return cudaSuccess;
}

long blocks_of(const Choice& c, int batch, int h, int w, int k) {
  const long R = h / 2, S = w / 2;
  return (long)batch * ((R + c.tr - 1) / c.tr) * ((S + c.ts - 1) / c.ts) *
         ((k + c.kb - 1) / c.kb);
}

// The plan whose busiest SM has the least work: the blocks it runs, each
// its padded tiles x channels, with an overhead for the input transform and
// U's copy that falls as KB and TM grow, at the rate its resident warps give.
template <bool SPLIT>
cudaError_t choose_plan(int batch, int h, int w, int k, int* best) {
  int sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  double best_cost = 0.0;
  *best = -1;
  for (int i = 0; i < kPlans; ++i) {
    const Choice c = plan_at<SPLIT>(i);
    int per_sm = 0;
    err = prepare<SPLIT>(i, c, &per_sm);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) continue;
    const long blocks = blocks_of(c, batch, h, w, k);
    const long slots = (long)sms * per_sm;
    const double waves = (double)((blocks + slots - 1) / slots);
    const double warps = (double)per_sm * c.threads / 32;
    const double tm = (double)c.tr * c.ts;
    const double cost = waves * per_sm * tm * c.kb * (1.0 + 48.0 / c.kb + 16.0 / tm) /
                        (warps >= 8 ? 1.0 : warps / 8);
    if (*best < 0 || cost < best_cost) {
      best_cost = cost;
      *best = i;
    }
  }
  return *best < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <bool SPLIT>
int launch(const void* in, const void* u, void* y, int batch, int c, int h, int w, int k,
           int s1p, cudaStream_t stream) {
  int plan = 0, per_sm = 0;
  cudaError_t err = choose_plan<SPLIT>(batch, h, w, k, &plan);
  const Choice ch = plan_at<SPLIT>(plan);
  if (err == cudaSuccess) err = prepare<SPLIT>(plan, ch, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int R = h / 2, S = w / 2;
  dim3 grid(((R + ch.tr - 1) / ch.tr) * ((S + ch.ts - 1) / ch.ts), (k + ch.kb - 1) / ch.kb,
            batch);
  ch.kernel<<<grid, ch.threads, ch.bytes, stream>>>(
      static_cast<const bf16*>(in), static_cast<const bf16*>(u), static_cast<bf16*>(y), c, h, w,
      k, s1p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8 (split = 0): in is the parity buffer [batch, c, 2, 2, h/2 + 1, s1p],
// s1p >= w/2 + 1 a multiple of 8. X3 (split = 1): in is x [batch, c, h, w],
// s1p unused. u [16, c, k] bf16 (G w G^T), y [batch, k, h, w] bf16. Needs h,
// w even, k % 8 == 0, u and in 16-byte aligned (X3 where w % 8 == 0: else 4);
// the wrapper checks. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int sdt_winograd_conv3x3(const void* in, const void* u, void* y, int batch, int c,
                                    int h, int w, int k, int s1p, int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return split ? launch<true>(in, u, y, batch, c, h, w, k, s1p, s)
               : launch<false>(in, u, y, batch, c, h, w, k, s1p, s);
}

// The plan K8 (split = 0) or X3 takes at this shape: out = {plan, tile rows
// a block, tile columns a block, output channels a block, input channels a
// step, threads, shared-memory bytes, resident blocks per SM, blocks}.
// Returns a CUDA error code.
extern "C" int sdt_winograd_plan(int split, int batch, int h, int w, int k, int* out) {
  int plan = 0, per_sm = 0;
  cudaError_t err = split ? choose_plan<true>(batch, h, w, k, &plan)
                          : choose_plan<false>(batch, h, w, k, &plan);
  const Choice c = split ? plan_at<true>(plan) : plan_at<false>(plan);
  if (err == cudaSuccess)
    err = split ? prepare<true>(plan, c, &per_sm) : prepare<false>(plan, c, &per_sm);
  const int vals[9] = {plan,    c.tr,    c.ts,   c.kb, c.cs, c.threads,
                       c.bytes, per_sm, (int)blocks_of(c, batch, h, w, k)};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return static_cast<int>(err);
}
