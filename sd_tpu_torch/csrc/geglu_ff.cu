// K2: the GEGLU feed-forward for Hopper (sm_90a):
//   a, g = x W1a^T + b1a, x W1g^T + b1g;  h = bf16(a * gelu(g));  y = h W2^T + b2
//
// Replaces the TPU kernel `_kernel` called through `_geglu_ff` in
// sd_tpu/ops/pallas/geglu_ff.py. That kernel keeps a whole [bm, inner] row
// tile of h in VMEM; on Hopper a row tile of h at inner = 5120 does not fit in
// the 227 KB of shared memory a block may use. So the port keeps what matters
// out of device memory in two launches (three where the second GEMM splits
// over k), all written here:
//   1. a GEMM whose tiles compute matching value and gate column tiles of
//      x [M, C] times W1 [2I, C]^T. The epilogue adds b1 and applies
//      a * gelu(g) in fp32, and rounds h to bf16, where the TPU kernel rounds
//      it; only h [M, I] bf16 is written, never the fp32 [M, 2I] projection;
//   2. a GEMM h [M, I] times W2 [C_out, I]^T plus b2, written as bf16; at a
//      small M it splits over k into fp32 partial sums [splits, M, C_out],
//      which a third launch adds with b2.
// GELU is the exact form with CUDA's erff, not the TPU kernel's short erf
// polynomial (_ERF_FAST, max error 3.6e-4), which exists for the TPU's vector
// unit.
//
// What bounds it on the H100: at the SD sites (M = 2 * batch * 4096 ... 64,
// C = 320 ... 1280, I = 4C) the products are 6 M C I flops against about
// 2 M (C + C_out) bytes of activations and 6 C I of weights, so with M in
// the thousands they are bound by the tensor cores (989 TFLOP/s bf16 dense),
// and h's round trip (2 M I bf16 bytes written and read back) adds about a
// tenth of that bound in bytes. At C = 320 the first GEMM's tiles are only
// five k steps deep, so its epilogue (erff and h's stores) weighs as much as
// its products (PERF.md).
//
// Design. Both GEMMs run on wgmma.mma_async m64nNk16 (bf16 in, fp32
// accumulate, flash_mma.cuh) in one persistent, warp-specialized kernel:
// one block an SM walks over the output tiles (128 rows, with the k splits
// of the second GEMM as tiles of their own). A producer warp copies each
// tile's 64-deep k steps with TMA (cp.async.bulk.tensor, zero-filled past
// M, N and K) into a ring of stages, each guarded by a "full" and an
// "empty" mbarrier, and runs ahead into the next tile while two consumer
// warpgroups (64 rows each) multiply and run the epilogue: the copies of
// tile t + 1 overlap the epilogue of tile t. Both operands are K-major in
// shared memory, in wgmma's 128-byte-swizzled atoms, which TMA writes:
// x (or h) and the weights in torch layout are both contiguous along k.
// The first GEMM copies BN value rows of W1 and the BN matching gate rows
// as one B tile of 2 BN rows and issues one wgmma of N = 2 BN, so that value
// column j and gate column j land in the same thread (accumulators 4 j' +
// 2 h + e, with j' = j and j + BN / 8). The epilogue adds the bias (read
// once per column pair), gates and rounds to bf16 in registers, stages each
// warpgroup's 64 output rows in shared memory (16-byte chunks XOR-swizzled
// by row) and writes them as whole rows of 16-byte stores. Where there are
// two m tiles to pair, a cluster of two CTAs takes them together and each
// copies half of their shared B tile into both (TMA multicast), which
// halves each SM's copies of B. The plan (columns a tile, k splits,
// clusters) is chosen per shape from the tiles it gives over the SMs and a
// per-plan efficiency (`choose`); `sdt_geglu_ff_plan` reports it.
//
// Weights are in torch Linear layout ([out, in], row-major). C, inner and
// C_out must be multiples of 8 (16-byte rows, TMA's stride rule).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "tma.cuh"

using sdt::bf16;
using sdt::cluster_rank;
using sdt::cluster_sync;
using sdt::mbar_arrive;
using sdt::mbar_arrive_cluster;
using sdt::mbar_expect_tx;
using sdt::mbar_init;
using sdt::mbar_wait;

namespace {

constexpr int BM = 128;         // output rows a tile: two consumer warpgroups
constexpr int BK = 64;          // k a stage: one 128-byte swizzled row of bf16
constexpr int THREADS = 384;    // a producer warpgroup and two consumers
constexpr int CONSUMER_WARPS = 8;

enum Mode { GEGLU = 0, BIAS = 1, PARTIAL = 2 };

// Shared memory: STAGES x (A [128 x 64], B [NT x 64]) in 1024-byte aligned
// atoms, as many as fit beside the rest (at most 6), then the bf16 output
// tile [128 x BN] the epilogue stages (not for PARTIAL), then the
// 2 x STAGES mbarriers, plus slack to align the ring.
template <int NT, int MODE>
struct Ring {
  static constexpr int A = BM * BK * 2;
  static constexpr int STAGE = A + NT * BK * 2;
  static constexpr int OUT = MODE == PARTIAL ? 0 : BM * (MODE == GEGLU ? NT / 2 : NT) * 2;
  static constexpr int FIT = (232448 - 1024 - 2 * 8 * 8 - OUT) / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int BARS = STAGES * STAGE + OUT;
  static constexpr int BYTES = BARS + 2 * STAGES * 8 + 1024;
};

__device__ __forceinline__ float gelu(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

// The end of a tile's k steps: the producer's copies and the consumers'
// products both read it.
template <int MODE>
__device__ __forceinline__ int k_end(int ktiles, int kt0, int tiles_per_split) {
  return min(ktiles, kt0 + tiles_per_split);
}

// The output tiles of one GEMM: a [m, k] (map `ma`, box 64 x 128) times rows
// of w (map `mb`, box 64 x NT, or 64 x NT / 2 for GEGLU's value and gate
// halves) over tiles (m tile, n tile, k split), n fastest. GEGLU: NT / 2
// output columns a tile, value rows n0 + j and gate rows n + n0 + j of w;
// h = bf16((acc_v + b[c]) * gelu(acc_g + b[n + c])) into out [m, n]. BIAS:
// NT columns, bf16(acc + b[c]) into out [m, n]. PARTIAL: NT columns, the
// fp32 sum over the tile's k split into out [splits, m, n]. CL = 2: the two
// CTAs of a cluster take two tiles stacked along m (a unit) and each copies
// half of the shared B tile into both (TMA multicast); a stage is free
// again once the consumers of both have released it.
template <int CL>
__device__ __forceinline__ void release(uint64_t* bar) {
  if (CL == 1) {
    mbar_arrive(bar);
  } else {
#pragma unroll
    for (unsigned r = 0; r < CL; ++r) mbar_arrive_cluster(bar, r);
  }
}

template <int NT, int MODE, int CL>
__global__ void __launch_bounds__(THREADS, 1)
geglu_gemm_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                  const float* __restrict__ bias, void* __restrict__ out, int m, int n, int k,
                  int splits, int tiles_per_split) {
  using R = Ring<NT, MODE>;
  constexpr int BN = MODE == GEGLU ? NT / 2 : NT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (sdt::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::BARS);  // after the staged tile
  uint64_t* empty = full + R::STAGES;
  const unsigned rank = CL > 1 ? cluster_rank() : 0;

  const int ktiles = (k + BK - 1) / BK;
  const int ntn = (n + BN - 1) / BN;
  const int units = (m + BM * CL - 1) / (BM * CL) * ntn * splits;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS * CL);
    }
    sdt::mbar_init_fence();
  }
  if (CL > 1)
    cluster_sync();
  else
    __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int unit = blockIdx.x / CL; unit < units; unit += gridDim.x / CL) {
        const int split = unit % splits;
        const int n0 = (unit / splits) % ntn * BN;
        const int m0 = unit / (splits * ntn) * BM * CL + rank * BM;
        const int kt0 = split * tiles_per_split;
        const int kt1 = k_end<MODE>(ktiles, kt0, tiles_per_split);
        for (int kt = kt0; kt < kt1; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], R::STAGE);
          unsigned char* sa = ring + stage * R::STAGE;
          sdt::tma_load_2d(sa, &ma, kt * BK, m0, &full[stage]);
          if (CL > 1) {
            // this CTA's half of the B tile, into both CTAs: GEGLU's value
            // (rank 0) or gate (rank 1) rows, or rows NT / 2 apart
            const int row = MODE == GEGLU ? rank * n + n0 : n0 + rank * (NT / 2);
            sdt::tma_load_2d_multicast(sa + R::A + rank * (NT / 2) * BK * 2, &mb, kt * BK, row,
                               &full[stage], (1u << CL) - 1);
          } else if (MODE == GEGLU) {
            sdt::tma_load_2d(sa + R::A, &mb, kt * BK, n0, &full[stage]);
            sdt::tma_load_2d(sa + R::A + BN * BK * 2, &mb, kt * BK, n + n0, &full[stage]);
          } else {
            sdt::tma_load_2d(sa + R::A, &mb, kt * BK, n0, &full[stage]);
          }
          if (++stage == R::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      // the consumers' last releases (the peer CTA's too) land before this
      // CTA may exit
      for (int i = 0; i < R::STAGES; ++i) {
        mbar_wait(&empty[stage], phase ^ 1);
        if (++stage == R::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg - 1 owns rows 64 (wg - 1) .. of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  int stage = 0, phase = 0;
  for (int unit = blockIdx.x / CL; unit < units; unit += gridDim.x / CL) {
    const int split = unit % splits;
    const int n0 = (unit / splits) % ntn * BN;
    const int m0 = unit / (splits * ntn) * BM * CL + rank * BM;
    const int kt0 = split * tiles_per_split;
    const int nkt = k_end<MODE>(ktiles, kt0, tiles_per_split) - kt0;

    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int i = 0; i < nkt; ++i) {
      mbar_wait(&full[stage], phase);
      const unsigned char* sa = ring + stage * R::STAGE;
      sdt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sdt::wgmma_bf16_k<NT>(acc, sdt::wgmma_desc<128>(sa + cw * 64 * 128 + kk * 32, 1024),
                              sdt::wgmma_desc<128>(sa + R::A + kk * 32, 1024), 1);
      sdt::wgmma_commit();
      // the batch before this one is done: its stage goes back to the producer
      sdt::wgmma_wait<1>();
      if (prev >= 0 && lane == 0) release<CL>(&empty[prev]);
      prev = stage;
      if (++stage == R::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    sdt::wgmma_wait<0>();
    sdt::fence_regs(acc);
    if (prev >= 0 && lane == 0) release<CL>(&empty[prev]);

    const int r0 = m0 + cw * 64 + warp * 16 + g;  // the row of accumulators 4j + 0, 1
    // this warpgroup's 64 rows of the output tile, 16-byte chunk c of row r
    // at chunk c ^ (r % 8): the fragments' stores and the rows' loads both
    // spread over the banks; the barrier keeps the last tile's loads first
    unsigned char* stg = ring + R::STAGES * R::STAGE + cw * 64 * BN * 2;
    if (MODE != PARTIAL) asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      if (col >= n) continue;
      if (MODE == PARTIAL) {
        float* o = static_cast<float*>(out) + (size_t)split * m * n;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          if (r0 + 8 * hh < m)
            *reinterpret_cast<float2*>(o + (size_t)(r0 + 8 * hh) * n + col) =
                make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        continue;
      }
      const float2 bv = *reinterpret_cast<const float2*>(bias + col);
      float2 bg = make_float2(0.f, 0.f);
      if (MODE == GEGLU) bg = *reinterpret_cast<const float2*>(bias + n + col);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v0 = acc[4 * j + 2 * hh] + bv.x;
        float v1 = acc[4 * j + 2 * hh + 1] + bv.y;
        if (MODE == GEGLU) {
          v0 *= gelu(acc[4 * (j + BN / 8) + 2 * hh] + bg.x);
          v1 *= gelu(acc[4 * (j + BN / 8) + 2 * hh + 1] + bg.y);
        }
        const int r = warp * 16 + g + 8 * hh;
        *reinterpret_cast<unsigned*>(stg + r * BN * 2 + ((j ^ (r & 7)) * 16) + 4 * t) =
            sdt::pack_bf16(v0, v1);
      }
    }
    if (MODE == PARTIAL) continue;
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    bf16* o = static_cast<bf16*>(out);
    for (int i = threadIdx.x % 128; i < 64 * (BN / 8); i += 128) {
      const int r = i / (BN / 8), c = i % (BN / 8);
      const int row = m0 + cw * 64 + r, col = n0 + c * 8;
      if (row < m && col < n)
        *reinterpret_cast<uint4*>(o + (size_t)row * n + col) =
            *reinterpret_cast<const uint4*>(stg + r * BN * 2 + ((c ^ (r & 7)) * 16));
    }
  }
}

// y [m, n] = bf16(sum over splits of ws [splits, m, n] + b), 4 columns a thread
__global__ void __launch_bounds__(256)
geglu_splitk_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                           bf16* __restrict__ y, int m, int n, int splits) {
  const size_t total = (size_t)m * n;
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= total) return;
  float4 s = *reinterpret_cast<const float4*>(ws + i);
  for (int z = 1; z < splits; ++z) {
    const float4 v = *reinterpret_cast<const float4*>(ws + z * total + i);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const float4 b = *reinterpret_cast<const float4*>(bias + i % n);
  uint2 packed;
  packed.x = sdt::pack_bf16(s.x + b.x, s.y + b.y);
  packed.y = sdt::pack_bf16(s.z + b.z, s.w + b.w);
  *reinterpret_cast<uint2*>(y + i) = packed;
}

typedef void (*GemmFn)(CUtensorMap, CUtensorMap, const float*, void*, int, int, int, int, int);

// One candidate plan of a GEMM: its kernel, the B rows a k step copies
// (NT), the output columns a tile (BN), the CTAs of a cluster (CL), the
// rows of B one TMA box copies, and the share of the tensor cores' peak its
// mainloop is assumed to reach (for `choose`).
struct Plan {
  GemmFn kernel;
  int nt, bn, cl, box_rows, stages, bytes;
  float eff;
};

template <int NT, int MODE, int CL>
Plan plan_of(float eff) {
  using R = Ring<NT, MODE>;
  static_assert(R::STAGES >= 3 && R::BYTES <= 232448, "shared memory per block");
  return {geglu_gemm_kernel<NT, MODE, CL>, NT, MODE == GEGLU ? NT / 2 : NT, CL,
          MODE == GEGLU || CL > 1 ? NT / 2 : NT, R::STAGES, R::BYTES, eff};
}

// The candidates, (NT, CL): the first GEMM (GEGLU) with 128 or 64 output
// columns a tile, alone or in clusters of two; the second (BIAS, or PARTIAL
// split over k) likewise with 128 or 64. A cluster cuts each SM's copies of
// B by half, which the efficiency credits.
constexpr int kPlans = 4;

template <int MODE>
Plan plan_at(int i) {
  switch (i) {
    case 0: return plan_of<256, MODE, 1>(MODE == GEGLU ? 0.75f : 0.8f);
    case 1: return plan_of<256, MODE, 2>(MODE == GEGLU ? 0.95f : 1.0f);
    case 2: return plan_of<128, MODE, 1>(MODE == GEGLU ? 0.65f : 0.65f);
    default: return plan_of<128, MODE, 2>(MODE == GEGLU ? 0.8f : 0.8f);
  }
}

Plan gemm1_plan(int i) { return plan_at<GEGLU>(i); }

Plan gemm2_plan(int i, bool partial) { return partial ? plan_at<PARTIAL>(i) : plan_at<BIAS>(i); }

// A chosen plan: the candidate, its k splits, the k tiles a split takes,
// its tiles and the blocks launched (one an SM at most, a multiple of the
// cluster).
struct Choice {
  Plan plan;
  int splits, tiles_per_split, tiles, blocks;
};

// The least estimated time over the candidates: the most units (CL tiles
// along m) one cluster runs, each tile's mainloop at the plan's efficiency
// of an SM's share of the bf16 peak plus a fixed cost a tile, and for a
// split the partial sums' round trip and the reduction's launch. Clusters
// only where there are two m tiles to pair.
cudaError_t choose(bool second, int m, int n, int k, Choice* best) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int ktiles = (k + BK - 1) / BK;
  const double sm_rate = 989e12 / 132;
  double best_t = 1e30;
  for (int i = 0; i < kPlans; ++i) {
    for (int splits = 1; splits <= (second ? 8 : 1); ++splits) {
      const int tps = (ktiles + splits - 1) / splits;
      if ((ktiles + tps - 1) / tps != splits) continue;  // a split with no k tile
      const Plan p = second ? gemm2_plan(i, splits > 1) : gemm1_plan(i);
      if (p.cl > 1 && m <= BM) continue;
      err = sdt::smem_limit(reinterpret_cast<const void*>(p.kernel), p.bytes);
      if (err != cudaSuccess) return err;
      const int units = (m + BM * p.cl - 1) / (BM * p.cl) * ((n + p.bn - 1) / p.bn) * splits;
      const int clusters = units < sms / p.cl ? units : sms / p.cl;
      const int per_cluster = (units + clusters - 1) / clusters;
      double t = per_cluster * (tps * (double)BM * p.nt * BK * 2 / (sm_rate * p.eff) + 1e-6);
      if (splits > 1) t += (double)m * n * 4 * (2.0 * splits) / 3.35e12 + 3e-6;
      if (t < best_t) {
        best_t = t;
        *best = {p, splits, tps, units * p.cl, clusters * p.cl};
      }
    }
  }
  return best_t < 1e30 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// a [m, k] times w (w_rows rows of k) by the chosen plan, into out.
cudaError_t gemm(const Choice& c, const bf16* a, const bf16* w, int w_rows, const float* bias,
                 void* out, float* ws, int m, int n, int k, cudaStream_t s) {
  const Plan& p = c.plan;
  CUtensorMap ma, mb;
  cudaError_t err = sdt::matrix_map(&ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, m, k, BK, BM);
  if (err == cudaSuccess)
    err = sdt::matrix_map(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, w_rows, k, BK, p.box_rows);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.bytes;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = p.cl;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, p.kernel, ma, mb, bias, c.splits > 1 ? ws : out, m, n, k,
                           c.splits, c.tiles_per_split);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || c.splits == 1) return err;
  const size_t quads = (size_t)m * n / 4;
  geglu_splitk_reduce_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, s>>>(
      ws, bias, static_cast<bf16*>(out), m, n, c.splits);
  return cudaGetLastError();
}

}  // namespace

// The fp32 scratch the second GEMM's k split needs at this shape, in
// elements (0: none), into *out: the wrapper allocates it. Returns a CUDA
// error code.
extern "C" int sdt_geglu_ff_workspace(int m, int c, int inner, int c_out, long long* out) {
  if (m <= 0 || c % 8 || inner % 8 || c_out % 8) return static_cast<int>(cudaErrorInvalidValue);
  Choice c2 = {};
  const cudaError_t err = choose(true, m, c_out, inner, &c2);
  *out = c2.splits > 1 ? (long long)c2.splits * m * c_out : 0;
  return static_cast<int>(err);
}

// x [m, c], w1 [2 * inner, c] (value rows first), b1 [2 * inner] fp32,
// w2 [c_out, inner], b2 [c_out] fp32, h [m, inner] scratch, ws fp32 scratch
// of sdt_geglu_ff_workspace elements (or null), y [m, c_out], all 16-byte
// aligned. Returns the CUDA error code of the launches (0 on success). c,
// inner and c_out must be multiples of 8; the wrapper checks shapes and
// alignment.
extern "C" int sdt_geglu_ff(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* h, void* ws, void* y, int m, int c, int inner,
                            int c_out, void* stream) {
  if (m <= 0 || c % 8 || inner % 8 || c_out % 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Choice c1, c2;
  cudaError_t err = choose(false, m, inner, c, &c1);
  if (err == cudaSuccess) err = choose(true, m, c_out, inner, &c2);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c2.splits > 1 && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  err = gemm(c1, static_cast<const bf16*>(x), static_cast<const bf16*>(w1), 2 * inner,
             static_cast<const float*>(b1), h, nullptr, m, inner, c, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gemm(c2, static_cast<const bf16*>(h), static_cast<const bf16*>(w2),
                               c_out, static_cast<const float*>(b2), y, static_cast<float*>(ws),
                               m, c_out, inner, s));
}

// K2's plan at this shape, per GEMM (first, then second): out = {rows a
// tile, output columns a tile, stages, tiles, blocks launched, k splits,
// CTAs a cluster}, 14 values. Returns a CUDA error code.
extern "C" int sdt_geglu_ff_plan(int m, int c, int inner, int c_out, int* out) {
  if (m <= 0 || c % 8 || inner % 8 || c_out % 8) return static_cast<int>(cudaErrorInvalidValue);
  Choice ch[2];
  cudaError_t err = choose(false, m, inner, c, &ch[0]);
  if (err == cudaSuccess) err = choose(true, m, c_out, inner, &ch[1]);
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    const int vals[7] = {BM,           ch[i].plan.bn, ch[i].plan.stages, ch[i].tiles,
                         ch[i].blocks, ch[i].splits,  ch[i].plan.cl};
    for (int j = 0; j < 7; ++j) out[7 * i + j] = vals[j];
  }
  return static_cast<int>(err);
}
