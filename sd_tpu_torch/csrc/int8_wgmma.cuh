// K6's int8 tensor-core GEMM for Hopper (sm_90a), the W8A8 dense projection
//
//   out[m, f] = bf16( float(sum_k q(x)[m, k] Wq[f, k]) * (sx[m] * sw[f]) + b[f] )
//
// with x [M, C] bf16 quantized per row (sd_tpu's math exactly: s = max(max|x|
// / 127, 1e-12), q = clip(rint(x / s), -127, 127), a true division, round
// half to even) and Wq [F, C] int8 quantized per output row at load time.
// int8_gemm.cuh (K4's GEMM) is the earlier, WMMA version of this product.
//
// Each row of x is quantized once for all of F. A block owns BM rows of x
// (BM = 256, 128 or 64) and walks a run of F's BN-column tiles (BN = 256 or
// 128) with the codes of its rows resident in shared memory, K-major in
// wgmma's 128-byte-swizzled atoms (kblocks of 128 k values, 8 rows an
// atom): the consumer warps read their rows of x once (a few lanes a row,
// the loads of two row groups in flight before a row's max is taken),
// quantize them and store the codes into the swizzled atoms. F is split
// over a few blocks only where M's tiles alone cannot fill the card; then
// each of those blocks quantizes the same rows. (A one-pass pre-pass that
// wrote codes and scales for the producer to copy by TMA measured slower
// at most SD sites, with its second launch, and was not kept.)
//
// Products: wgmma.mma_async m64nNk32 s32.s8.s8, both operands K-major in
// shared memory, int32 accumulators in registers. One producer warp copies
// Wq's tiles (BN rows x 128 k, 128-byte swizzled) with TMA into a ring of
// stages guarded by full/empty mbarriers, running ahead into the next
// column tile while two consumer warpgroups multiply (BM = 256 or 128: half
// the rows each; BM = 64: the same 64 rows, BN / 2 columns each) and run the
// epilogue: acc * (sx * sw) + b in fp32, one rounding to bf16, the tile
// staged in shared memory (16-byte chunks XOR-swizzled by row) and written
// as whole rows of 16-byte stores.
//
// What bounds it on the H100: 2 M C F int8 operations (1979 TOP/s dense)
// against 2 M C bytes of x, M F * 2 of out and F C of Wq (3.35 TB/s): at
// the SD sites (C = 320 ... 1280, F = C or 3C) that is about 2 C F / (2 C
// + 2 F) operations a byte, below the int8 ridge (about 590), so the
// output's bytes bound it and the design keeps x's bytes to one read.
//
// C must be a multiple of 32 (k32 steps) and at most 1280 (a lane holds at
// most 5 chunks of 8 values of a row), F a multiple of 8.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "tma.cuh"

namespace sdt_i8w {
namespace {

using sdt::bf16;

// d (+)= A B, m64nNk32, s8 operands K-major in shared memory (128-byte
// swizzled atoms, as wgmma_bf16_k), s32 accumulators in the layout of
// wgmma_bf16's: d[4 j + 2 h + e] = D[16 w + g + 8 h][8 j + 2 t + e].
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void fence_iregs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

constexpr int BK = 128;          // k values a stage: one 128-byte swizzled row of int8
constexpr int THREADS = 384;     // a producer warpgroup and two consumer warpgroups
constexpr int SMEM_MAX = 232448;
constexpr int MAX_STAGES = 8;
constexpr int MAX_C = 1280;       // the widest row a block quantizes
constexpr int QUANT_CHUNKS = 5;    // 8-value chunks a lane holds of a row

__device__ __forceinline__ float quant_scale(float amax) { return fmaxf(amax / 127.f, 1e-12f); }

__device__ __forceinline__ unsigned quant4(const bf16* v, float s) {
  unsigned r = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int q = static_cast<int>(fminf(fmaxf(rintf(__bfloat162float(v[e]) / s), -127.f), 127.f));
    r |= (static_cast<unsigned>(q) & 0xffu) << (8 * e);
  }
  return r;
}

__device__ __forceinline__ float chunk_amax(const uint4& raw) {
  const bf16* v = reinterpret_cast<const bf16*>(&raw);
  float a = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) a = fmaxf(a, fabsf(__bfloat162float(v[e])));
  return a;
}

// The 8 codes of chunk i (k = 8 i .. 8 i + 7) of a block row r, in the
// resident tile: kblock i / 16, 16-byte chunk (i % 16) / 2 of the row's
// 128 bytes XOR r % 8, half i % 2.
__device__ __forceinline__ unsigned a_offset(int r, int i, int bm) {
  return (i / 16) * bm * 128 + r * 128 + ((((i % 16) / 2) ^ (r & 7)) * 16) + (i % 2) * 8;
}

// Shared memory: the resident codes (kblocks x BM x 128), the ring of
// Wq stages (BN x 128 each), the output tile (BM x BN bf16), the row
// scales (BM fp32), then the barriers: full[stages], empty[stages].
struct Smem {
  int a, ring, out, scale, bars, bytes;
  __host__ __device__ Smem(int bm, int bn, int c, int stages) {
    a = 0;
    ring = ((c + BK - 1) / BK) * bm * BK;
    out = ring + stages * bn * BK;
    scale = out + bm * bn * 2;
    bars = scale + bm * 4;
    bytes = bars + 2 * stages * 8 + 1024;  // + slack to align the base
  }
};

// One (m tile, run of n tiles) a block: grid (n runs, m tiles).
template <int BM, int BN>
__global__ void __launch_bounds__(THREADS, 1)
int8_dense_kernel(const __grid_constant__ CUtensorMap mw, const bf16* __restrict__ x,
                  const float* __restrict__ sw, const float* __restrict__ bias,
                  bf16* __restrict__ out, int m, int c, int f, int stages,
                  int tiles_per_block) {
  // a consumer warpgroup's rows and columns of a tile: half the rows (BM =
  // 128 or 256, in RW / 64 wgmma row blocks), or all 64 rows and half the
  // columns (BM = 64)
  constexpr int RW = BM == 64 ? 64 : BM / 2;
  constexpr int MT = RW / 64;
  constexpr int NW = BM == 64 ? BN / 2 : BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (sdt::smem_addr(smem_raw) & 1023)) & 1023);
  const Smem L(BM, BN, c, stages);
  unsigned char* as = base + L.a;
  unsigned char* ring = base + L.ring;
  float* scale = reinterpret_cast<float*>(base + L.scale);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* empty = full + stages;

  const int kblocks = (c + BK - 1) / BK;
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
      for (int nt = nt0; nt < nt1; ++nt) {
        for (int kb = 0; kb < kblocks; ++kb) {
          sdt::mbar_wait(&empty[stage], phase ^ 1);
          sdt::mbar_expect_tx(&full[stage], BN * BK);
          sdt::tma_load_2d(ring + stage * BN * BK, &mw, kb * BK, nt * BN, &full[stage]);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int ctid = threadIdx.x - 128;      // 0 .. 255 over both consumer warpgroups
  const int cwarp = ctid / 32;             // 0 .. 7
  const int warp = cwarp % 4;              // within the warpgroup
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // the block's rows quantized into the resident tile: LPR lanes a row, each
  // holding QUANT_CHUNKS 8-value chunks at most; two row groups' loads in
  // flight before either row's max is taken
  const int chunks = c / 8;
  const int lpr = chunks <= 8 * QUANT_CHUNKS ? 8 : chunks <= 16 * QUANT_CHUNKS ? 16 : 32;
  const int rpw = 32 / lpr;  // rows a warp takes at a time
  const int sub = lane % lpr;
  for (int r0 = cwarp * rpw; r0 < BM; r0 += 2 * 8 * rpw) {
    uint4 v[2][QUANT_CHUNKS];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + u * 8 * rpw + lane / lpr;
      const bf16* row = x + (size_t)(m0 + r) * c;
#pragma unroll
      for (int j = 0; j < QUANT_CHUNKS; ++j) {
        const int i = sub + j * lpr;
        v[u][j] = r < BM && m0 + r < m && i < chunks
                      ? *reinterpret_cast<const uint4*>(row + i * 8)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + u * 8 * rpw + lane / lpr;
      float amax = 0.f;
#pragma unroll
      for (int j = 0; j < QUANT_CHUNKS; ++j) amax = fmaxf(amax, chunk_amax(v[u][j]));
      for (int off = lpr / 2; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float s = quant_scale(amax);
      if (r < BM) {
        if (sub == 0) scale[r] = s;
#pragma unroll
        for (int j = 0; j < QUANT_CHUNKS; ++j) {
          const int i = sub + j * lpr;
          if (i < chunks) {
            const bf16* e = reinterpret_cast<const bf16*>(&v[u][j]);
            *reinterpret_cast<uint2*>(as + a_offset(r, i, BM)) =
                make_uint2(quant4(e, s), quant4(e + 4, s));
          }
        }
      }
    }
  }
  sdt::fence_proxy_async();  // the codes, written here, are read by wgmma
  sdt::named_sync(3, 256);

  const int arow0 = BM == 64 ? 0 : cw * RW;   // this warpgroup's rows of the block
  const int bcol0 = BM == 64 ? cw * NW : 0;   // and columns of each tile
  const int ksteps = c / 32;
  unsigned char* stg = base + L.out + cw * RW * NW * 2;
  int stage = 0, phase = 0;
  for (int nt = nt0; nt < nt1; ++nt) {
    int acc[MT][NW / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[mt][i] = 0;
    int prev = -1;
    for (int kb = 0; kb < kblocks; ++kb) {
      sdt::mbar_wait(&full[stage], phase);
      const unsigned char* sb = ring + stage * BN * BK + bcol0 * BK;
      const unsigned char* sa = as + kb * BM * BK + arow0 * BK;
      sdt::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks)
        if (kb * (BK / 32) + ks < ksteps)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            wgmma_s8<NW>(acc[mt], sdt::wgmma_desc<128>(sa + mt * 64 * BK + ks * 32, 1024),
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
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_iregs(acc[mt]);
    if (lane == 0) sdt::mbar_arrive(&empty[prev]);

    // epilogue: this warpgroup's RW rows x NW columns, 16-byte chunk j of
    // row r at chunk j ^ (r % 8); the barrier keeps the last tile's loads first
    const int n0 = nt * BN + bcol0;
    sdt::named_sync(1 + cw, 128);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int rl = mt * 64 + warp * 16 + g;  // the row of accumulators 4 j + 0, 1
      const float s_lo = scale[arow0 + rl], s_hi = scale[arow0 + rl + 8];
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int col = n0 + j * 8 + 2 * t;
        float2 wv = make_float2(0.f, 0.f), bv = make_float2(0.f, 0.f);
        if (col < f) {
          wv = *reinterpret_cast<const float2*>(sw + col);
          bv = *reinterpret_cast<const float2*>(bias + col);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float sr = hh ? s_hi : s_lo;
          const float v0 = __fadd_rn(__fmul_rn(static_cast<float>(acc[mt][4 * j + 2 * hh]),
                                               __fmul_rn(sr, wv.x)), bv.x);
          const float v1 = __fadd_rn(__fmul_rn(static_cast<float>(acc[mt][4 * j + 2 * hh + 1]),
                                               __fmul_rn(sr, wv.y)), bv.y);
          const int r = rl + 8 * hh;
          *reinterpret_cast<unsigned*>(stg + r * NW * 2 + ((j ^ (r & 7)) * 16) + 4 * t) =
              sdt::pack_bf16(v0, v1);
        }
      }
    }
    sdt::named_sync(1 + cw, 128);
    for (int i = threadIdx.x % 128; i < RW * (NW / 8); i += 128) {
      const int r = i / (NW / 8), cc = i % (NW / 8);
      const int row = m0 + arow0 + r, col = n0 + cc * 8;
      if (row < m && col < f)
        *reinterpret_cast<uint4*>(out + (size_t)row * f + col) =
            *reinterpret_cast<const uint4*>(stg + r * NW * 2 + ((cc ^ (r & 7)) * 16));
    }
  }
}

typedef void (*DenseFn)(CUtensorMap, const bf16*, const float*, const float*, bf16*, int, int,
                        int, int, int);

// A chosen plan: the kernel and its tile, its stages and shared memory, the
// blocks launched (n runs x m tiles) and the n tiles a block walks.
struct Plan {
  DenseFn kernel;
  int bm, bn, stages, bytes, runs, mtiles, tiles_per_block;
};

DenseFn kernel_of(int bm, int bn) {
  if (bm == 256) return int8_dense_kernel<256, 128>;
  if (bm == 128) return bn == 256 ? int8_dense_kernel<128, 256> : int8_dense_kernel<128, 128>;
  return bn == 256 ? int8_dense_kernel<64, 256> : int8_dense_kernel<64, 128>;
}

// The least estimated time over the tiles and the F splits. A block's time:
// its quantization (its rows' bytes at an SM's share of the memory rate)
// and, per n tile, the larger of its products (an SM's share of the int8
// peak at 70%) and its output's bytes, plus its weight tile's bytes at an
// SM's share of 5 TB/s from L2 (which every block of a run reads again);
// blocks run in waves of one an SM.
cudaError_t choose(int m, int c, int f, Plan* best) {
  if (c % 32 || c > MAX_C || f % 8 || m <= 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const double sm_ops = 1979e12 / sms * 0.7, sm_bytes = 3.35e12 / sms, sm_l2 = 5e12 / sms;
  double best_t = 1e30;
  const int tiles[5][2] = {{256, 128}, {128, 256}, {128, 128}, {64, 256}, {64, 128}};
  for (const auto& tile : tiles) {
    const int bm = tile[0], bn = tile[1];
    const int fixed = Smem(bm, bn, c, 0).bytes;
    const int stages = min(MAX_STAGES, (SMEM_MAX - fixed) / (bn * BK + 16));
    if (stages < 3) continue;  // fewer leave the products waiting on each copy
    const int mtiles = (m + bm - 1) / bm, ntiles = (f + bn - 1) / bn;
    for (int runs = 1; runs <= ntiles; ++runs) {
      const int tpb = (ntiles + runs - 1) / runs;
      if ((ntiles + tpb - 1) / tpb != runs) continue;
      const int waves = (mtiles * runs + sms - 1) / sms;
      const double t_rows = (double)bm * c * 2 / sm_bytes + 1e-6;
      const double t_tile = fmax(2.0 * bm * bn * c / sm_ops, (double)bm * bn * 2 / sm_bytes) +
                            (double)bn * c / sm_l2;
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

// out = the product by `plan`.
cudaError_t int8_dense(const Plan& p, const bf16* x, const signed char* wq, const float* sw,
                       const float* bias, bf16* out, int m, int c, int f, cudaStream_t s) {
  CUtensorMap mw;
  cudaError_t err = sdt::matrix_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, f, c, BK, p.bn);
  if (err == cudaSuccess) err = sdt::smem_limit(reinterpret_cast<const void*>(p.kernel), p.bytes);
  if (err != cudaSuccess) return err;
  p.kernel<<<dim3(p.runs, p.mtiles), THREADS, p.bytes, s>>>(mw, x, sw, bias, out, m, c, f,
                                                           p.stages, p.tiles_per_block);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdt_i8w
