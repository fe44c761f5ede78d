// The launches X1 (fused_block.cu) and X2's attention half (tail_fused.cu)
// share, for Hopper (sm_90a); each source instantiates what it launches.
//   qkv::x1_qkv_kernel: LayerNorm of a block's rows into a swizzled shared
//     tile, times a weight [f, C] (out x in) streamed by TMA, on wgmma:
//     X1's QKV (f = 3C), X2's Q (f = C).
//   attn::x1_attn_kernel<P, LN>: per block of BQ query rows of one batch
//     element, softmax attention over every head into a [BQ, C] shared tile
//     (K1's register-resident mma.sync design), then the out-projection on
//     wgmma plus bias and residual. Queries, keys and values are given by
//     pointer and stride: X1's come from its qkv scratch, X2's keys and
//     values from the context's kc/vc, of which only the first `nkeys` rows
//     are read and every column at or past nkeys is masked. With LN (X2),
//     a block that owns its rows' every column follows with LayerNorm of
//     the rows it wrote (ln_rows), so that LN3(x1) is computed where x1
//     is; where the columns are split over blocks, the caller launches
//     ln_rows_kernel after it.
// fused_block.cu's header says why the design is so.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "tma.cuh"

using sdt::bf16;

namespace {

// d (+)= A B, m64nNk16, bf16 operands K-major in shared memory (128-byte
// swizzled atoms, as flash_mma.cuh's wgmma_bf16_k), fp32 accumulators.
template <int N>
__device__ __forceinline__ void wgmma_bf16_kk(float (&d)[N / 2], uint64_t a, uint64_t b,
                                              int accumulate);

template <>
__device__ __forceinline__ void wgmma_bf16_kk<64>(float (&d)[32], uint64_t a, uint64_t b,
                                                     int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16_kk<96>(float (&d)[48], uint64_t a, uint64_t b,
                                                     int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16_kk<128>(float (&d)[64], uint64_t a, uint64_t b,
                                                     int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16_kk<192>(float (&d)[96], uint64_t a, uint64_t b,
                                                     int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(accumulate));
}

constexpr int SMEM_MAX = 232448;
constexpr float kLnEps = 1e-5f;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The byte offset of element (r, k) of a K-major bf16 tile of `rows` rows
// in 128-byte-swizzled atoms: k block k / 64 (rows x 128 bytes each), the
// row's 16-byte chunk (k % 64) / 8 XOR r % 8.
__device__ __forceinline__ unsigned kmajor(int r, int k, int rows) {
  return (k / 64) * rows * 128 + r * 128 + ((((k % 64) / 8) ^ (r & 7)) << 4) + (k % 8) * 2;
}

// LayerNorm of rows [0, rows) of c bf16 values each (c % 8 == 0, c <= 1280;
// row pitch c) from src into dst, by warp `warp` of `warps`: the tool's _ln,
// fp32 mean and E[x^2] in one pass, the variance clamped at 0, (x - mean) *
// rstd * gamma + beta rounded to bf16. LPR lanes take a row, 32 / LPR rows at
// a time, each lane 16-byte chunks sub + LPR j (at most five), so that short
// rows keep a warp's loads in flight together.
template <int LPR>
__device__ __forceinline__ void ln_rows_lpr(const bf16* src, bf16* dst, int rows, int c,
                                            const float* __restrict__ gamma,
                                            const float* __restrict__ beta, int warp, int warps,
                                            int lane) {
  constexpr int CHUNKS = 5, RPW = 32 / LPR;
  const int chunks = c / 8, sub = lane % LPR;
  for (int r0 = warp * RPW; r0 < rows; r0 += warps * RPW) {
    const int r = r0 + lane / LPR;
    const bool valid = r < rows;
    uint4 v[CHUNKS];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int i = sub + LPR * j;
      v[j] = valid && i < chunks ? *reinterpret_cast<const uint4*>(src + (size_t)r * c + i * 8)
                                 : make_uint4(0u, 0u, 0u, 0u);
      const bf16* e = reinterpret_cast<const bf16*>(&v[j]);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float xv = __bfloat162float(e[k]);
        sum += xv;
        sq = fmaf(xv, xv, sq);
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    const float mu = sum / c;
    const float rstd = rsqrtf(fmaxf(sq / c - mu * mu, 0.f) + kLnEps);
    if (!valid) continue;
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int i = sub + LPR * j;
      if (i >= chunks) continue;
      const bf16* e = reinterpret_cast<const bf16*>(&v[j]);
      uint4 o;
      unsigned* op = reinterpret_cast<unsigned*>(&o);
#pragma unroll
      for (int k = 0; k < 8; k += 2) {
        const int col = i * 8 + k;
        const float y0 = __fmul_rn(__fsub_rn(__bfloat162float(e[k]), mu), rstd);
        const float y1 = __fmul_rn(__fsub_rn(__bfloat162float(e[k + 1]), mu), rstd);
        op[k / 2] = sdt::pack_bf16(__fadd_rn(__fmul_rn(y0, gamma[col]), beta[col]),
                                   __fadd_rn(__fmul_rn(y1, gamma[col + 1]), beta[col + 1]));
      }
      *reinterpret_cast<uint4*>(dst + (size_t)r * c + i * 8) = o;
    }
  }
}

// The lanes ln_rows gives a row of c values: 8, 16 or 32, the fewest that
// hold it in five 16-byte chunks each.
__host__ __device__ constexpr int ln_lanes(int c) { return c <= 320 ? 8 : c <= 640 ? 16 : 32; }

__device__ __forceinline__ void ln_rows(const bf16* src, bf16* dst, int rows, int c,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta, int warp, int warps,
                                        int lane) {
  if (ln_lanes(c) == 8)
    ln_rows_lpr<8>(src, dst, rows, c, gamma, beta, warp, warps, lane);
  else if (ln_lanes(c) == 16)
    ln_rows_lpr<16>(src, dst, rows, c, gamma, beta, warp, warps, lane);
  else
    ln_rows_lpr<32>(src, dst, rows, c, gamma, beta, warp, warps, lane);
}

// ---------------------------------------------------------------- launch A

namespace qkv {

constexpr int BK = 64;          // k values a stage: one 128-byte swizzled row of bf16
constexpr int THREADS = 384;    // a producer warpgroup and two consumer warpgroups
constexpr int MAX_STAGES = 6;
constexpr int MAX_CHUNKS = 5;   // 8-value chunks a lane holds of a row: C <= 1280

// Shared memory: the normalised rows (k blocks x BM x 128 bytes), the ring
// of weight stages (BN x 128 each), the barriers full[stages], empty[stages].
struct Smem {
  int a, ring, bars, bytes;
  __host__ __device__ Smem(int bm, int bn, int c, int stages) {
    a = 0;
    ring = round_up(c, BK) / BK * bm * 128;
    bars = ring + stages * bn * 128;
    bytes = bars + 2 * stages * 8 + 1024;  // + slack to align the base
  }
};

// out[m0 .. m0 + BM, tiles nt0 .. nt1 of BN columns] = bf16(LN(x) W'^T) with
// W' [f, C] by TMA (map mw; X1: f = 3C, X2: f = C): grid (column runs, m
// tiles). BM = 128: the consumer warpgroups take 64 rows each; BM = 64: BN /
// 2 columns each.
template <int BM, int BN>
__global__ void __launch_bounds__(THREADS, 1)
x1_qkv_kernel(const __grid_constant__ CUtensorMap mw, const bf16* __restrict__ x,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              bf16* __restrict__ out, int m, int c, int f, int stages, int tiles_per_block) {
  constexpr int NW = BM == 64 ? BN / 2 : BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (sdt::smem_addr(smem_raw) & 1023)) & 1023);
  const Smem L(BM, BN, c, stages);
  unsigned char* as = base + L.a;
  unsigned char* ring = base + L.ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* empty = full + stages;

  const int kblocks = round_up(c, BK) / BK;
  const int ntiles = (f + BN - 1) / BN;
  const int nt0 = blockIdx.x * tiles_per_block;
  const int nt1 = min(ntiles, nt0 + tiles_per_block);
  const int m0 = blockIdx.y * BM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sdt::mbar_init(&full[s], 1);
      sdt::mbar_init(&empty[s], 8);  // the consumer warps
    }
    sdt::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int nt = nt0; nt < nt1; ++nt)
        for (int kb = 0; kb < kblocks; ++kb) {
          sdt::mbar_wait(&empty[stage], phase ^ 1);
          sdt::mbar_expect_tx(&full[stage], BN * 128);
          sdt::tma_load_2d(ring + stage * BN * 128, &mw, kb * BK, nt * BN, &full[stage]);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int cwarp = (threadIdx.x - 128) / 32;  // 0 .. 7
  const int warp = cwarp % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // LayerNorm: LPR lanes a row (each holding at most MAX_CHUNKS 8-value
  // chunks), the loads of two row groups in flight before either's sums are
  // taken; fp32 mean and E[x^2] in one pass, the variance clamped at 0,
  // (x - mean) * rstd * gamma + beta rounded to bf16 into the swizzled tile;
  // rows past m and columns past c are zeros
  const int chunks = c / 8, kchunks = kblocks * 8;
  const int lpr = kchunks <= 8 * MAX_CHUNKS ? 8 : kchunks <= 16 * MAX_CHUNKS ? 16 : 32;
  const int rpw = 32 / lpr;  // rows a warp takes at a time
  const int sub = lane % lpr;
  for (int r0 = cwarp * rpw; r0 < BM; r0 += 2 * 8 * rpw) {
    uint4 v[2][MAX_CHUNKS];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + u * 8 * rpw + lane / lpr;
      const bool valid = r < BM && m0 + r < m;
      const bf16* row = x + (size_t)(m0 + r) * c;
#pragma unroll
      for (int j = 0; j < MAX_CHUNKS; ++j) {
        const int i = sub + j * lpr;
        v[u][j] = valid && i < chunks ? *reinterpret_cast<const uint4*>(row + i * 8)
                                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + u * 8 * rpw + lane / lpr;
      const bool valid = r < BM && m0 + r < m;
      float sum = 0.f, sumsq = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_CHUNKS; ++j) {
        const bf16* e = reinterpret_cast<const bf16*>(&v[u][j]);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xv = __bfloat162float(e[k]);
          sum += xv;
          sumsq = fmaf(xv, xv, sumsq);
        }
      }
      for (int off = lpr / 2; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        sumsq += __shfl_xor_sync(0xffffffffu, sumsq, off);
      }
      const float mean = sum / c;
      const float var = fmaxf(sumsq / c - mean * mean, 0.f);
      const float rstd = rsqrtf(var + kLnEps);
      if (r >= BM) continue;
#pragma unroll
      for (int j = 0; j < MAX_CHUNKS; ++j) {
        const int i = sub + j * lpr;
        if (i >= kchunks) continue;
        uint4 o = make_uint4(0u, 0u, 0u, 0u);
        if (valid && i < chunks) {
          const bf16* e = reinterpret_cast<const bf16*>(&v[u][j]);
          unsigned* op = reinterpret_cast<unsigned*>(&o);
#pragma unroll
          for (int k = 0; k < 8; k += 2) {
            const int col = i * 8 + k;
            const float y0 = __fmul_rn(__fsub_rn(__bfloat162float(e[k]), mean), rstd);
            const float y1 = __fmul_rn(__fsub_rn(__bfloat162float(e[k + 1]), mean), rstd);
            op[k / 2] = sdt::pack_bf16(__fadd_rn(__fmul_rn(y0, gamma[col]), beta[col]),
                                       __fadd_rn(__fmul_rn(y1, gamma[col + 1]), beta[col + 1]));
          }
        }
        *reinterpret_cast<uint4*>(as + kmajor(r, i * 8, BM)) = o;
      }
    }
  }
  sdt::fence_proxy_async();  // the tile, written here, is read by wgmma
  sdt::named_sync(3, 256);

  const int arow0 = BM == 64 ? 0 : cw * 64;   // this warpgroup's rows of the block
  const int bcol0 = BM == 64 ? cw * NW : 0;   // and columns of each tile
  int stage = 0, phase = 0;
  for (int nt = nt0; nt < nt1; ++nt) {
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int kb = 0; kb < kblocks; ++kb) {
      sdt::mbar_wait(&full[stage], phase);
      const unsigned char* sb = ring + stage * BN * 128 + bcol0 * 128;
      const unsigned char* sa = as + kb * BM * 128 + arow0 * 128;
      sdt::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_bf16_kk<NW>(acc, sdt::wgmma_desc<128>(sa + ks * 32, 1024),
                          sdt::wgmma_desc<128>(sb + ks * 32, 1024), 1);
      sdt::wgmma_commit();
      // the batch before this one is done: its stage goes back to the producer
      sdt::wgmma_wait<1>();
      if (prev >= 0 && lane == 0) sdt::mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    sdt::wgmma_wait<0>();
    sdt::fence_regs(acc);
    if (lane == 0) sdt::mbar_arrive(&empty[prev]);
    const int n0 = nt * BN + bcol0;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + arow0 + warp * 16 + g + 8 * hh;
        if (row < m && col < f)
          *reinterpret_cast<unsigned*>(out + (size_t)row * f + col) =
              sdt::pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      }
    }
  }
}

typedef void (*QkvFn)(CUtensorMap, const bf16*, const float*, const float*, bf16*, int, int, int,
                      int, int);

struct Plan {
  QkvFn kernel;
  int bm, bn, stages, bytes, runs, mtiles, tiles_per_block;
};

QkvFn kernel_of(int bm, int bn) {
  if (bm == 128) return x1_qkv_kernel<128, 192>;
  return bn == 192 ? x1_qkv_kernel<64, 192> : x1_qkv_kernel<64, 128>;
}

// The least estimated time over the tiles and the column runs for x [m, c]
// times W' [f, c], as K6's choose (int8_wgmma.cuh) with the bf16 rate: a
// block's LayerNorm (its rows' bytes at an SM's share of the memory rate),
// then per tile the larger of its products (an SM's share of the bf16 peak
// at 70%) and its output's bytes, plus its weight tile's bytes from L2.
cudaError_t choose(int m, int c, int f, Plan* best) {
  if (c % 8 || c > 8 * 32 * MAX_CHUNKS || m <= 0 || f <= 0 || f % 8) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const double sm_ops = 989e12 / sms * 0.7, sm_bytes = 3.35e12 / sms, sm_l2 = 5e12 / sms;
  double best_t = 1e30;
  const int tiles[3][2] = {{128, 192}, {64, 192}, {64, 128}};
  for (const auto& tile : tiles) {
    const int bm = tile[0], bn = tile[1];
    const int fixed = Smem(bm, bn, c, 0).bytes;
    const int stages = min(MAX_STAGES, (SMEM_MAX - fixed) / (bn * 128 + 16));
    if (stages < 3) continue;
    const int mtiles = (m + bm - 1) / bm, ntiles = (f + bn - 1) / bn;
    for (int runs = 1; runs <= ntiles; ++runs) {
      const int tpb = (ntiles + runs - 1) / runs;
      if ((ntiles + tpb - 1) / tpb != runs) continue;
      const int waves = (mtiles * runs + sms - 1) / sms;
      const double t_rows = (double)bm * c * 2 / sm_bytes + 1e-6;
      const double t_tile = fmax(2.0 * bm * bn * c / sm_ops, (double)bm * bn * 2 / sm_bytes) +
                            (double)bn * c * 2 / sm_l2;
      const double t = waves * (t_rows + tpb * (t_tile + 0.3e-6));
      if (t < best_t) {
        best_t = t;
        *best = {kernel_of(bm, bn), bm, bn, stages, Smem(bm, bn, c, stages).bytes, runs, mtiles,
                 tpb};
      }
    }
  }
  return best_t < 1e30 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace qkv

// ---------------------------------------------------------------- launch B

namespace attn {

// Copies rows [row0, row0 + ROWS) of one head's slice, the first d columns,
// into shared memory at pitch LD with cp.async; rows at or past n are
// zero-filled. Columns [d, LD) are left as they are.
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

// The plan of a head dim: DK the padded contraction, BK keys a tile, WARPS
// warps of MT 16-row m-tiles each (BQ = 16 MT WARPS query rows a block; in
// the out-projection each warpgroup takes MT 64-row m-tiles), NC output
// columns a step of the out-projection. Shared memory: T (BQ x
// round_up(C, 64) bf16), then the K/V stages (two of K and V, BK x LD each;
// the second holds a head's Q first), which the out-projection's weight
// ring reuses, then its barriers.
template <int DK_, int BK_, int MT_, int WARPS_>
struct Plan {
  static constexpr int DK = DK_, BK = BK_, MT = MT_, WARPS = WARPS_;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * MT * WARPS;
  static constexpr int LD = DK + 8;
  static constexpr int NC = 128 / MT;   // 64 fp32 accumulators a thread
  static constexpr int KV_BYTES = 4 * BK * LD * 2;
  static_assert(BQ <= 2 * BK, "a head's Q fits in the second K/V stage");
  static_assert(BQ == 64 * MT * (WARPS / 4), "each warpgroup takes MT 64-row m-tiles");
};

// Two blocks an SM where T and the K/V stages fit in this much; then the
// weight ring takes what K/V leave, else what the block's limit leaves.
constexpr int TWO_A_SM = 113 * 1024;

struct Smem {
  int t, kv, region, bars, wstages, bytes;
  __host__ __device__ Smem(int bq, int c, int kv_bytes, int nc) {
    t = 0;
    kv = bq * round_up(c, 64) * 2;
    const int fixed = kv + 8 * 8 + 1024;
    const int room = fixed + kv_bytes <= TWO_A_SM ? kv_bytes : SMEM_MAX - fixed;
    wstages = max(2, min(8, room / (nc * 128)));
    region = round_up(max(kv_bytes, wstages * nc * 128), 1024);
    bars = kv + region;
    bytes = bars + wstages * 8 + 1024;  // + slack to align the base
  }
};

// The operands of the attention launch. Row r of batch element b of q
// starts at q + b * q_batch + r * q_stride, and key row j of k and v at
// k + b * kv_batch + j * kv_stride (head h at column h * d of each); n query
// rows and nkeys keys a batch element (rows past nkeys are never read, and
// columns past it are masked). x, out [B, n, C]; with LN, ln_out [B, n, C]
// takes LayerNorm(out) with gamma, beta.
struct AttnArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long long q_batch, kv_batch;
  int q_stride, kv_stride, n, nkeys, heads, d;
  const bf16* x;
  const float* bo;
  bf16* out;
  const float* gamma;
  const float* beta;
  bf16* ln_out;
};

// out[b, q0 .. q0 + BQ, the block's columns] = bf16(bf16(attend(q, k, v) Wo
// + bo) + x) for batch element blockIdx.y; the map mwo reads Wo' [C, C] (out
// x in) in 64-deep k tiles of NC rows. Block z takes the out-projection's
// column chunks [z * chunks_per_split, ...) of NC each; where several blocks
// share rows (attention cheap against the out-projection), each computes
// their attention itself. With LN and one block to the rows, it then writes
// LayerNorm of its rows of out.
template <class P, bool LN>
__global__ void __launch_bounds__(P::THREADS)
x1_attn_kernel(const __grid_constant__ CUtensorMap mwo, const AttnArgs a, int chunks_per_split) {
  constexpr int DK = P::DK, BK = P::BK, MT = P::MT, BQ = P::BQ, LD = P::LD, NC = P::NC;
  constexpr int THREADS = P::THREADS;
  constexpr int KD = DK / 16;  // k16 steps of Q K^T
  constexpr int NS = BK / 8;   // n8 tiles of S
  constexpr int NO = DK / 8;   // n8 tiles of O; those at or past d / 8 are skipped
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (sdt::smem_addr(smem_raw) & 1023)) & 1023);
  const int n = a.n, heads = a.heads, d = a.d;
  const int c = heads * d;
  const int cp = round_up(c, 64);
  const Smem L(BQ, c, P::KV_BYTES, NC);
  unsigned char* tile = base + L.t;
  bf16* kv = reinterpret_cast<bf16*>(base + L.kv);
  unsigned char* ring = base + L.kv;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y;
  const bf16* qb = a.q + b * a.q_batch;
  const bf16* kb = a.k + b * a.kv_batch;
  const bf16* vb = a.v + b * a.kv_batch;
  const int chunks = d / 8;
  const int nv = d / 8;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wg = warp / 4, wwarp = warp % 4;  // the out-projection's warpgroup and warp in it

  if (threadIdx.x == 0) {
    for (int s = 0; s < L.wstages; ++s) sdt::mbar_init(&full[s], 1);
    sdt::mbar_init_fence();
  }
  // zeros: T's columns [c, cp), over which the out-projection's k runs, and
  // the K/V rows' padding [d, DK), which the copies never write
  for (int i = threadIdx.x; i < BQ * (cp - c) / 8; i += THREADS) {
    const int r = i / ((cp - c) / 8), k = c + (i % ((cp - c) / 8)) * 8;
    *reinterpret_cast<uint4*>(tile + kmajor(r, k, BQ)) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (d < DK)
    for (int i = threadIdx.x; i < 4 * BK * (DK - d) / 8; i += THREADS) {
      const int r = i / ((DK - d) / 8);
      *reinterpret_cast<uint4*>(kv + r * LD + d + (i % ((DK - d) / 8)) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }

  const int nkeys = a.nkeys;
  const int ntiles = (nkeys + BK - 1) / BK;
  for (int h = 0; h < heads; ++h) {
    __syncthreads();  // the previous head's last tiles are read
    // the head's Q into the second stage, K and V tile 0 into the first
    load_rows<BQ, LD, THREADS>(kv + 2 * BK * LD, qb + h * d, q0, n, a.q_stride, chunks);
    load_rows<BK, LD, THREADS>(kv, kb + h * d, 0, nkeys, a.kv_stride, chunks);
    load_rows<BK, LD, THREADS>(kv + BK * LD, vb + h * d, 0, nkeys, a.kv_stride, chunks);
    sdt::cp_async_commit();

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

    for (int t = 0; t < ntiles; ++t) {
      sdt::cp_async_wait<0>();
      __syncthreads();
      if (t == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < KD; ++kk)
            sdt::ldmatrix_x4(qf[mt][kk], kv + 2 * BK * LD +
                                             ((warp * MT + mt) * 16 + lane % 16) * LD +
                                             kk * 16 + lane / 16 * 8);
        __syncthreads();  // Q is in registers: the second stage takes tile 1
      }
      if (t + 1 < ntiles) {
        bf16* next = kv + ((t + 1) & 1) * 2 * BK * LD;
        load_rows<BK, LD, THREADS>(next, kb + h * d, (t + 1) * BK, nkeys, a.kv_stride, chunks);
        load_rows<BK, LD, THREADS>(next + BK * LD, vb + h * d, (t + 1) * BK, nkeys,
                                   a.kv_stride, chunks);
        sdt::cp_async_commit();
      }
      const bf16* ks = kv + (t & 1) * 2 * BK * LD;
      const bf16* vs = ks + BK * LD;

      // S = Q K^T, 16 x BK per m-tile (base-2 logits: q carries the scale)
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
      // key columns at or past nkeys out, before the row max (their rows
      // were zero-filled, which alone would give logits of 0)
      const int kbase = t * BK;
      if (kbase + BK > nkeys) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int col = kbase + j * 8 + 2 * tq;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (col >= nkeys) s[mt][j][0] = s[mt][j][2] = -INFINITY;
            if (col + 1 >= nkeys) s[mt][j][1] = s[mt][j][3] = -INFINITY;
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
        const float n0 = fmaxf(m[mt][0], sdt::quad_max(t0));
        const float n1 = fmaxf(m[mt][1], sdt::quad_max(t1));
        const float e0 = n0 == -INFINITY ? 0.f : n0;
        const float e1 = n1 == -INFINITY ? 0.f : n1;
        const float c0 = sdt::exp2_approx(m[mt][0] - e0), c1 = sdt::exp2_approx(m[mt][1] - e1);
        m[mt][0] = n0;
        m[mt][1] = n1;
        l[mt][0] *= c0;
        l[mt][1] *= c1;
        sdt::rescale_rows(acc[mt], c0, c1);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float p0 = sdt::exp2_approx(s[mt][j][0] - e0);
          const float p1 = sdt::exp2_approx(s[mt][j][1] - e0);
          const float p2 = sdt::exp2_approx(s[mt][j][2] - e1);
          const float p3 = sdt::exp2_approx(s[mt][j][3] - e1);
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

    // this head's output, divided by the row sum and rounded, into its
    // columns of T
    const int hcol = h * d;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float l0 = sdt::quad_sum(l[mt][0]), l1 = sdt::quad_sum(l[mt][1]);
      const int r0 = (warp * MT + mt) * 16 + g;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        if (j < nv) {
          const int col = hcol + j * 8 + 2 * tq;
          *reinterpret_cast<unsigned*>(tile + kmajor(r0, col, BQ)) =
              sdt::pack_bf16(__fdiv_rn(acc[mt][j][0], l0), __fdiv_rn(acc[mt][j][1], l0));
          *reinterpret_cast<unsigned*>(tile + kmajor(r0 + 8, col, BQ)) =
              sdt::pack_bf16(__fdiv_rn(acc[mt][j][2], l1), __fdiv_rn(acc[mt][j][3], l1));
        }
      }
    }
  }

  // out-projection: T [BQ, cp] times Wo'^T, NC columns a step, Wo's 64-deep
  // k tiles through the ring over the K/V stages
  sdt::fence_proxy_async();  // T and the stages, written and read here, go to wgmma and TMA
  __syncthreads();
  const int kblocks = cp / 64;
  const int nc0 = blockIdx.z * chunks_per_split;
  const int steps = (min((c + NC - 1) / NC, nc0 + chunks_per_split) - nc0) * kblocks;
  const int wst = L.wstages;
  if (threadIdx.x == 0)
    for (int i = 0; i < min(wst, steps); ++i) {
      sdt::mbar_expect_tx(&full[i], NC * 128);
      sdt::tma_load_2d(ring + i * NC * 128, &mwo, (i % kblocks) * 64, (nc0 + i / kblocks) * NC,
                       &full[i]);
    }
  float acc2[MT][NC / 2];
  for (int i = 0; i < steps; ++i) {
    const int kb = i % kblocks, nc = nc0 + i / kblocks;
    if (kb == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < NC / 2; ++e) acc2[mt][e] = 0.f;
    }
    const int slot = i % wst;
    sdt::mbar_wait(&full[slot], (i / wst) & 1);
    const unsigned char* sb = ring + slot * NC * 128;
    sdt::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        wgmma_bf16_kk<NC>(acc2[mt],
                          sdt::wgmma_desc<128>(tile + kb * BQ * 128 + (wg * MT + mt) * 64 * 128 +
                                                   ks * 32,
                                               1024),
                          sdt::wgmma_desc<128>(sb + ks * 32, 1024), 1);
    sdt::wgmma_commit();
    // the step before this one is done (every step, where this one ends a
    // chunk): its slot takes the step wst after it
    if (kb == kblocks - 1) {
      sdt::wgmma_wait<0>();
    } else {
      sdt::wgmma_wait<1>();
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) sdt::fence_regs(acc2[mt]);
    __syncthreads();  // every warp is done with the previous step's slot
    if (threadIdx.x == 0 && i > 0 && i - 1 + wst < steps) {
      const int j = i - 1 + wst, pslot = (i - 1) % wst;
      sdt::mbar_expect_tx(&full[pslot], NC * 128);
      sdt::tma_load_2d(ring + pslot * NC * 128, &mwo, (j % kblocks) * 64,
                       (nc0 + j / kblocks) * NC, &full[pslot]);
    }
    if (kb == kblocks - 1) {
      // bias, rounding, residual, rounding
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          const int col = nc * NC + j * 8 + 2 * tq;
          if (col >= c) continue;
          const float2 bv = *reinterpret_cast<const float2*>(a.bo + col);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = q0 + (wg * MT + mt) * 64 + wwarp * 16 + g + 8 * hh;
            if (row >= n) continue;
            const size_t at = ((size_t)b * n + row) * c + col;
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(a.x + at);
            const __nv_bfloat162 yv = __floats2bfloat162_rn(
                __fadd_rn(acc2[mt][4 * j + 2 * hh], bv.x),
                __fadd_rn(acc2[mt][4 * j + 2 * hh + 1], bv.y));
            *reinterpret_cast<unsigned*>(a.out + at) = sdt::pack_bf16(
                __fadd_rn(__low2float(yv), __low2float(xv)),
                __fadd_rn(__high2float(yv), __high2float(xv)));
          }
        }
    }
  }
  if (LN && gridDim.z == 1) {
    // every column of the block's rows is written: LayerNorm of each, read
    // back (the block's own stores, visible after the barrier), a warp a row
    __syncthreads();
    const size_t at = ((size_t)b * n + q0) * c;
    ln_rows(a.out + at, a.ln_out + at, min(BQ, n - q0), c, a.gamma, a.beta, warp, THREADS / 32,
            lane);
  }
}

typedef void (*AttnFn)(CUtensorMap, AttnArgs, int);

struct Choice {
  AttnFn kernel;
  int bq, bk, dk, nc, kv_bytes, threads;
};

template <class P, bool LN>
Choice make() {
  return {x1_attn_kernel<P, LN>, P::BQ, P::BK, P::DK, P::NC, P::KV_BYTES, P::THREADS};
}

// The plan for head dim d (a multiple of 8, at most 160) and C: K1's tiles;
// where a warp takes one m-tile, eight warps (two warpgroups of the
// out-projection) where the [128, C] tile fits, else four.
template <bool LN>
bool choose(int d, int c, Choice* ch) {
  if (d <= 0 || d % 8 || d > 160) return false;
  if (d <= 48) {
    *ch = make<Plan<48, 64, 2, 4>, LN>();
    return true;
  }
  if (d <= 80) *ch = make<Plan<80, 64, 1, 8>, LN>();
  else if (d <= 128) *ch = make<Plan<128, 64, 1, 8>, LN>();
  if (d <= 128 && Smem(ch->bq, c, ch->kv_bytes, ch->nc).bytes <= SMEM_MAX) return true;
  if (d <= 80) *ch = make<Plan<80, 64, 1, 4>, LN>();
  else if (d <= 128) *ch = make<Plan<128, 64, 1, 4>, LN>();
  else *ch = make<Plan<160, 32, 1, 4>, LN>();
  return true;
}

}  // namespace attn

}  // namespace
