// K4: the W8A8 GEGLU feed-forward for Hopper (sm_90a):
//   a = q(x) W1a^T * (sx * sw1a) + b1a,  g = q(x) W1g^T * (sx * sw1g) + b1g,
//   h = a * gelu_fast(g)  (fp32),  y = q(h) W2^T * (sh * sw2) + b2  (bf16)
// x [M, C] bf16 quantized per row; W1a, W1g [I, C] and W2 [C_out, I] int8
// quantized per output channel at load time; h quantized per row over all
// of I, in fp32 (it is not rounded to bf16 first); gelu_fast is sd_tpu's
// degree-6 erf polynomial (_ERF_FAST), whatever the input type.
//
// Replaces the TPU kernel `_kernel_int8` called through `_geglu_ff_int8` in
// sd_tpu/ops/pallas/geglu_ff.py. That kernel keeps a whole [bm, I] row tile
// of fp32 h in VMEM and quantizes each row against its max over all I (up
// to 5120) before the output product. At 5120 fp32 values a row, 64 rows
// are 1.3 MB, far above the 227 KB of shared memory a block may use, and a
// row's max is known only once every column tile of it is done. So h makes
// one round trip through device memory, in two launches (and a memset of
// the row maxima), both on int8 wgmma m64nNk32 (s32 accumulators):
//   1. K6's kernel (int8_wgmma.cuh) with its GEGLU epilogue: a block
//      quantizes its rows of x once into shared memory and walks a run of
//      the interleaved weight's tiles (W1a's and W1g's rows in alternating
//      runs of 64, built once at load time), which a producer warp streams
//      by TMA; value and gate columns land in the same threads, which
//      write fp32 h and raise each row's max |h| (atomicMax on the float's
//      bits, once a row and block);
//   2. the output GEMM below, with h quantized as it is loaded: TMA copies
//      h's fp32 k-steps (32 values a row, 128-byte swizzled) and W2's int8
//      tiles into two rings of mbarrier-guarded stages; the consumer warps
//      read the block's 64 rows from each h stage, divide them by the row's
//      scale (from the row max), round them to codes and store those into a
//      double-buffered, 128-byte-swizzled K-major stage that wgmma reads,
//      releasing the h stage once its values are consumed; so no int8 copy
//      of h exists in device memory. Each of two consumer warpgroups
//      multiplies the codes by its half of the block's W2 columns. The
//      epilogue is K6's, acc * (sh * sw2) + b2 rounded once to bf16; where
//      M's tiles cannot fill the card the k range splits over blocks, which
//      add exact int32 sums into a zeroed scratch, and the last block of a
//      tile (a counter) writes it.
// What bounds it on the H100: 6 M C I int8 operations (1979 TOP/s) against
// x, the weights and y; on top of that bound, h's fp32 round trip (8 M I
// bytes at 3.35 TB/s) is the price of the row max, the division of each h
// value by its scale (once for each of the C_out / 2 NW column blocks that
// read it; a reciprocal per row and one correction, not a division) and
// the epilogue's GELU polynomial. Measured on an H100 (PERF.md): the first
// GEMM's time is mostly its GEGLU epilogue, which no warpgroup overlaps
// with products; the output GEMM's time moved with none of its products,
// its quantization or h's copies taken out one at a time, nor with W2's
// tiles shared over a two-CTA cluster, which was not kept.

#include "int8_wgmma.cuh"

namespace {

using sdt::bf16;

// d (+)= A B, m64nNk32, both s8 operands K-major in shared memory (128-byte
// swizzled atoms), s32 accumulators, as int8_wgmma.cuh's wgmma_s8, with N =
// 160 beside 64.
template <int N>
__device__ __forceinline__ void wgmma_s8_ss(int (&d)[N / 2], uint64_t a, uint64_t b,
                                            int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8_ss<64>(int (&d)[32], uint64_t a, uint64_t b,
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
__device__ __forceinline__ void wgmma_s8_ss<160>(int (&d)[80], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p;\n}\n"
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
        "+r"(d[78]), "+r"(d[79])
      : "l"(a), "l"(b), "r"(accumulate));
}

constexpr int HK = 32;         // k values of an h stage: 32 fp32, one 128-byte swizzled row
constexpr int WK = 128;        // k values of a W2 stage: 128 int8, one 128-byte swizzled row
constexpr int ROWS = 64;       // rows a block, quantized by both consumer warpgroups
constexpr int THREADS = 384;   // a producer warpgroup and two consumer warpgroups
constexpr int SMEM_MAX = 232448;
constexpr int MAX_SPLITS = 8;

// v / s for a row's scale s and its correctly rounded reciprocal r: the
// product, corrected once by its exact residual (Markstein), which is the
// correctly rounded quotient, as a true division gives, in three
// instructions where the division takes about ten.
__device__ __forceinline__ float div_by(float v, float s, float r) {
  const float q = __fmul_rn(v, r);
  return __fmaf_rn(__fmaf_rn(-q, s, v), r, q);
}

// Four fp32 values as four codes against the row scale s (reciprocal r):
// sd_tpu's clip(rint(v / s), -127, 127); the rounding to nearest even is
// the addition of 1.5 * 2^23, whose float's low byte is then the code
// (|v / s| <= 127). Lowest k in the low byte.
__device__ __forceinline__ unsigned quant4f(float4 v, float s, float r) {
  constexpr float kRound = 12582912.f;
  const unsigned b0 = __float_as_uint(__fadd_rn(fminf(fmaxf(div_by(v.x, s, r), -127.f), 127.f), kRound));
  const unsigned b1 = __float_as_uint(__fadd_rn(fminf(fmaxf(div_by(v.y, s, r), -127.f), 127.f), kRound));
  const unsigned b2 = __float_as_uint(__fadd_rn(fminf(fmaxf(div_by(v.z, s, r), -127.f), 127.f), kRound));
  const unsigned b3 = __float_as_uint(__fadd_rn(fminf(fmaxf(div_by(v.w, s, r), -127.f), 127.f), kRound));
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

// The output GEMM's shared memory: the h ring (hstages x ROWS x 128 bytes),
// the W2 ring (wstages x BN x 128), two stages of h's codes (ROWS x 128,
// K-major, 128-byte swizzled), the barriers hfull, hempty, wfull, wempty,
// and the split's last-block flag.
struct Smem2 {
  int h, w, a, bars, flag, bytes;
  __host__ __device__ Smem2(int bn, int hstages, int wstages) {
    h = 0;
    w = hstages * ROWS * 128;
    a = w + wstages * bn * WK;
    bars = a + 2 * ROWS * WK;
    flag = bars + 2 * (hstages + wstages) * 8;
    bytes = flag + 16 + 1024;  // + slack to align the base
  }
};

// y[m0 .. m0 + ROWS, n0 .. n0 + 2 NW] for the k blocks of split blockIdx.z:
// grid (C_out / 2 NW column blocks, M / ROWS row tiles, splits). Both
// consumer warpgroups quantize the block's rows of h, a 32-deep step at a
// time (thread i: row i / 4, the 16-byte chunks i % 4 and i % 4 + 4), into
// a swizzled stage of codes that wgmma reads; each then multiplies them by
// its NW columns of W2.
template <int NW>
__global__ void __launch_bounds__(THREADS, 1)
k4_out_kernel(const __grid_constant__ CUtensorMap mh, const __grid_constant__ CUtensorMap mw,
              const float* __restrict__ rowmax, const float* __restrict__ sw,
              const float* __restrict__ bias, bf16* __restrict__ out, int* __restrict__ ws,
              int* __restrict__ counters, int m, int inner, int c, int hstages, int wstages,
              int kb_per_split) {
  constexpr int BN = 2 * NW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (sdt::smem_addr(smem_raw) & 1023)) & 1023);
  const Smem2 L(BN, hstages, wstages);
  unsigned char* hring = base + L.h;
  unsigned char* wring = base + L.w;
  unsigned char* codes = base + L.a;
  uint64_t* hfull = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* hempty = hfull + hstages;
  uint64_t* wfull = hempty + hstages;
  uint64_t* wempty = wfull + wstages;
  int* last = reinterpret_cast<int*>(base + L.flag);

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * ROWS;
  const int kblocks = inner / WK;
  const int kb0 = blockIdx.z * kb_per_split;
  const int kb1 = min(kblocks, kb0 + kb_per_split);
  if (threadIdx.x == 0) {
    for (int s = 0; s < hstages; ++s) {
      sdt::mbar_init(&hfull[s], 1);
      sdt::mbar_init(&hempty[s], 8);  // the consumer warps
    }
    for (int s = 0; s < wstages; ++s) {
      sdt::mbar_init(&wfull[s], 1);
      sdt::mbar_init(&wempty[s], 8);
    }
    sdt::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      // W2's 128-deep k block, then its four 32-deep h steps, in the order
      // the consumers take them
      int hs = 0, hph = 0, wsi = 0, wph = 0;
      for (int kb = kb0; kb < kb1; ++kb) {
        sdt::mbar_wait(&wempty[wsi], wph ^ 1);
        sdt::mbar_expect_tx(&wfull[wsi], BN * WK);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          sdt::tma_load_2d(wring + wsi * BN * WK + half * NW * WK, &mw, kb * WK, n0 + half * NW,
                           &wfull[wsi]);
        if (++wsi == wstages) {
          wsi = 0;
          wph ^= 1;
        }
        for (int q = 0; q < WK / HK; ++q) {
          sdt::mbar_wait(&hempty[hs], hph ^ 1);
          sdt::mbar_expect_tx(&hfull[hs], ROWS * 128);
          sdt::tma_load_2d(hring + hs * ROWS * 128, &mh, kb * WK + q * HK, m0, &hfull[hs]);
          if (++hs == hstages) {
            hs = 0;
            hph ^= 1;
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int ctid = threadIdx.x - 128;      // 0 .. 255 over both consumer warpgroups
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // the row this thread quantizes, its scale from the row max, and its two
  // 16-byte chunks (k 4 t4 .. and 16 + 4 t4 ..) in an h stage and in the codes
  const int qr = ctid / 4, t4 = ctid % 4;
  const float qs = m0 + qr < m ? sdt_i8w::quant_scale(rowmax[m0 + qr]) : 1.f;
  const float qr_inv = __frcp_rn(qs);
  const unsigned h_lo = qr * 128 + ((t4 ^ (qr & 7)) << 4);
  const unsigned h_hi = qr * 128 + (((t4 + 4) ^ (qr & 7)) << 4);

  int acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0;
  int hs = 0, hph = 0, wsi = 0, wph = 0, prev = -1;
  for (int kb = kb0; kb < kb1; ++kb) {
    // h's codes for this k block, quantized as they leave the h stages; a
    // stage goes back to the producer once its values are consumed
    unsigned char* ab = codes + ((kb - kb0) & 1) * ROWS * WK;
#pragma unroll
    for (int q = 0; q < WK / HK; ++q) {
      sdt::mbar_wait(&hfull[hs], hph);
      const unsigned char* hb = hring + hs * ROWS * 128;
      const unsigned lo = quant4f(*reinterpret_cast<const float4*>(hb + h_lo), qs, qr_inv);
      const unsigned hi = quant4f(*reinterpret_cast<const float4*>(hb + h_hi), qs, qr_inv);
      *reinterpret_cast<unsigned*>(ab + qr * 128 + (((2 * q) ^ (qr & 7)) << 4) + 4 * t4) = lo;
      *reinterpret_cast<unsigned*>(ab + qr * 128 + (((2 * q + 1) ^ (qr & 7)) << 4) + 4 * t4) = hi;
      __syncwarp();
      if (lane == 0) sdt::mbar_arrive(&hempty[hs]);
      if (++hs == hstages) {
        hs = 0;
        hph ^= 1;
      }
    }
    sdt::fence_proxy_async();  // the codes, written here, are read by wgmma
    sdt::named_sync(1, 256);
    sdt::mbar_wait(&wfull[wsi], wph);
    const unsigned char* wb = wring + wsi * BN * WK + cw * NW * WK;
    sdt::wgmma_fence();
#pragma unroll
    for (int q = 0; q < WK / 32; ++q)
      wgmma_s8_ss<NW>(acc, sdt::wgmma_desc<128>(ab + q * 32, 1024),
                      sdt::wgmma_desc<128>(wb + q * 32, 1024), 1);
    sdt::wgmma_commit();
    // the k block before this one is done: its W2 stage goes back to the
    // producer, and (after both warpgroups are past this point) its codes'
    // stage takes the next k block's
    sdt::wgmma_wait<1>();
    if (prev >= 0 && lane == 0) sdt::mbar_arrive(&wempty[prev]);
    prev = wsi;
    if (++wsi == wstages) {
      wsi = 0;
      wph ^= 1;
    }
    sdt::named_sync(2, 256);
  }
  sdt::wgmma_wait<0>();
  sdt_i8w::fence_iregs(acc);
  if (prev >= 0 && lane == 0) sdt::mbar_arrive(&wempty[prev]);

  const int cn0 = n0 + cw * NW;  // this warpgroup's columns
  const int r0 = warp * 16 + g;  // and rows r0, r0 + 8 of each accumulator pair
  if (gridDim.z > 1) {
    // this split's exact sums into the scratch; the tile's last block reads
    // the totals back
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = cn0 + j * 8 + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + r0 + 8 * hh;
        if (row < m && col < c) {
          atomicAdd(ws + (size_t)row * c + col, acc[4 * j + 2 * hh]);
          atomicAdd(ws + (size_t)row * c + col + 1, acc[4 * j + 2 * hh + 1]);
        }
      }
    }
    __threadfence();
    sdt::named_sync(1, 256);
    if (ctid == 0)
      *last = atomicAdd(counters + blockIdx.y * gridDim.x + blockIdx.x, 1) == (int)gridDim.z - 1;
    sdt::named_sync(1, 256);
    if (!*last) return;
    __threadfence();
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = cn0 + j * 8 + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + r0 + 8 * hh;
        if (row < m && col < c) {
          acc[4 * j + 2 * hh] = __ldcg(ws + (size_t)row * c + col);
          acc[4 * j + 2 * hh + 1] = __ldcg(ws + (size_t)row * c + col + 1);
        }
      }
    }
  }

  // y = bf16(acc * (sh * sw2) + b2), as K6's epilogue
  const float s_r0 = m0 + r0 < m ? sdt_i8w::quant_scale(rowmax[m0 + r0]) : 1.f;
  const float s_r1 = m0 + r0 + 8 < m ? sdt_i8w::quant_scale(rowmax[m0 + r0 + 8]) : 1.f;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = cn0 + j * 8 + 2 * t;
    if (col >= c) continue;
    const float2 wv = *reinterpret_cast<const float2*>(sw + col);
    const float2 bv = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + r0 + 8 * hh;
      const float sr = hh ? s_r1 : s_r0;
      const float v0 = __fadd_rn(__fmul_rn(static_cast<float>(acc[4 * j + 2 * hh]),
                                           __fmul_rn(sr, wv.x)), bv.x);
      const float v1 = __fadd_rn(__fmul_rn(static_cast<float>(acc[4 * j + 2 * hh + 1]),
                                           __fmul_rn(sr, wv.y)), bv.y);
      if (row < m)
        *reinterpret_cast<unsigned*>(out + (size_t)row * c + col) = sdt::pack_bf16(v0, v1);
    }
  }
}

typedef void (*OutFn)(CUtensorMap, CUtensorMap, const float*, const float*, const float*, bf16*,
                      int*, int*, int, int, int, int, int, int);

// The output GEMM's plan: the kernel, its columns a warpgroup, its rings,
// shared memory, grid and k split; the scratch of int32 after the row
// maxima (the split's tile counters and sums, or none).
struct Plan2 {
  OutFn kernel;
  int nw, hstages, wstages, bytes, nblocks, mtiles, splits, kb_per_split;
  long long scratch;
};

// The least estimated time over the column blocks and the k splits. A
// block's time: the larger of its products (an SM's share of the int8 peak
// at 70%), its quantization (about 7 instructions an h value on 128 lanes)
// and its bytes from L2 (h's and W2's) at an SM's share of 5.5 TB/s; plus,
// split, its sums' atomics and the scratch's memset; blocks run in waves of
// one an SM. (On the card none of the three moved the time at the SD
// sites: PERF.md.)
cudaError_t choose2(int m, int inner, int c, Plan2* best) {
  if (inner % WK || c % 8 || m <= 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const double lanes = 128 * 1.755e9, sm_l2 = 5.5e12 / sms;
  const int kblocks = inner / WK;
  double best_t = 1e30;
  const int mtiles = (m + ROWS - 1) / ROWS;
  for (const int nw : {160, 64}) {
    const int bn = 2 * nw;
    const int wstages = 3;
    const int hstages = min(8, (SMEM_MAX - Smem2(bn, 0, wstages).bytes) / (ROWS * 128 + 16));
    if (hstages < WK / HK) continue;
    const int nblocks = (c + bn - 1) / bn;
    for (int splits = 1; splits <= min(kblocks, MAX_SPLITS); ++splits) {
      const int kbps = (kblocks + splits - 1) / splits;
      if ((kblocks + kbps - 1) / kbps != splits) continue;
      const int blocks = nblocks * mtiles * splits;
      const double kspan = (double)kbps * WK;
      const double t_mma = 2.0 * ROWS * bn * kspan / (1979e12 / sms * 0.7);
      const double t_quant = ROWS * kspan * 7 / lanes;
      const double t_mem = (ROWS * kspan * 4 + bn * kspan) / sm_l2;
      const double t_split = splits > 1 ? 3.0 * ROWS * bn * 4 / sm_l2 : 0.0;
      const double t = (double)((blocks + sms - 1) / sms) *
                           (fmax(t_mma, fmax(t_quant, t_mem)) + t_split + 2e-6) +
                       (splits > 1 ? (double)m * c * 4 / 3.35e12 : 0.0);
      if (t < best_t) {
        best_t = t;
        const long long tiles = (long long)nblocks * mtiles;
        *best = {nw == 160 ? k4_out_kernel<160> : k4_out_kernel<64>, nw, hstages, wstages,
                 Smem2(bn, hstages, wstages).bytes, nblocks, mtiles, splits, kbps,
                 splits > 1 ? (tiles + 3) / 4 * 4 + (long long)m * c : 0};
      }
    }
  }
  return best_t < 1e30 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// Both plans at a shape; the int32 scratch: the row maxima (M, rounded up
// to 4), then the second plan's.
cudaError_t plans(int m, int c, int inner, int c_out, sdt_i8w::Plan* p1, Plan2* p2,
                  long long* scratch) {
  if (inner % WK || c_out % 8) return cudaErrorInvalidValue;
  cudaError_t err = sdt_i8w::choose<sdt_i8w::EPI_GEGLU>(m, c, 2 * inner, p1);
  if (err == cudaSuccess) err = choose2(m, inner, c_out, p2);
  if (err == cudaSuccess) *scratch = (m + 3) / 4 * 4 + p2->scratch;
  return err;
}

}  // namespace

// x [m, c] bf16; w1q [2 inner, c] int8, W1a's and W1g's rows interleaved in
// runs of 64, with its scales s1 [2 inner] interleaved alike; b1 [2 inner]
// fp32 (value half first); w2q [c_out, inner] int8 with s2, b2 [c_out] fp32;
// scratch: h [m, inner] fp32 and `scratch` int32 of sdt_geglu_ff_int8_plan's
// size (zeroed here); y [m, c_out] bf16; all 16-byte aligned. c a multiple
// of 32 and at most 1280, inner of 128, c_out of 8. Returns the CUDA error
// code.
extern "C" int sdt_geglu_ff_int8(const void* x, const void* w1q, const void* s1, const void* b1,
                                 const void* w2q, const void* s2, const void* b2, void* h,
                                 void* scratch, void* y, int m, int c, int inner, int c_out,
                                 void* stream) {
  sdt_i8w::Plan p1;
  Plan2 p2;
  long long words = 0;
  cudaError_t err = plans(m, c, inner, c_out, &p1, &p2, &words);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rowmax = static_cast<float*>(scratch);
  int* counters = static_cast<int*>(scratch) + (m + 3) / 4 * 4;
  int* ws = counters + ((long long)p2.nblocks * p2.mtiles + 3) / 4 * 4;
  err = cudaMemsetAsync(scratch, 0, (size_t)words * 4, s);
  if (err == cudaSuccess)
    err = sdt_i8w::int8_dense(p1, static_cast<const bf16*>(x),
                              static_cast<const signed char*>(w1q), static_cast<const float*>(s1),
                              static_cast<const float*>(b1), h, rowmax, m, c, 2 * inner, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mh, mw;
  err = sdt::matrix_map(&mh, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, h, m, inner, HK, ROWS);
  if (err == cudaSuccess)
    err = sdt::matrix_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w2q, c_out, inner, WK, p2.nw);
  if (err == cudaSuccess) err = sdt::smem_limit(reinterpret_cast<const void*>(p2.kernel), p2.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  p2.kernel<<<dim3(p2.nblocks, p2.mtiles, p2.splits), THREADS, p2.bytes, s>>>(
      mh, mw, rowmax, static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<bf16*>(y), ws, counters, m, inner, c_out, p2.hstages, p2.wstages,
      p2.kb_per_split);
  return static_cast<int>(cudaGetLastError());
}

// K4's plans at this shape: out = {the first GEMM's rows a block, columns a
// tile, stages, blocks, F runs, tiles a block, shared memory bytes; the
// output GEMM's rows a block, columns a block, columns a warpgroup's wgmma, h stages,
// W2 stages, blocks, k splits, shared memory bytes; the int32 scratch's
// size (low and high 31 bits)}, 17 values. Returns a CUDA error code.
extern "C" int sdt_geglu_ff_int8_plan(int m, int c, int inner, int c_out, int* out) {
  sdt_i8w::Plan p1;
  Plan2 p2;
  long long words = 0;
  const cudaError_t err = plans(m, c, inner, c_out, &p1, &p2, &words);
  if (err == cudaSuccess) {
    const int vals[17] = {p1.bm, p1.bn, p1.stages, p1.runs * p1.mtiles, p1.runs,
                          p1.tiles_per_block, p1.bytes, ROWS, 2 * p2.nw, p2.nw,
                          p2.hstages, p2.wstages, p2.nblocks * p2.mtiles * p2.splits, p2.splits,
                          p2.bytes, static_cast<int>(words & 0x7fffffff),
                          static_cast<int>(words >> 31)};
    for (int j = 0; j < 17; ++j) out[j] = vals[j];
  }
  return static_cast<int>(err);
}
