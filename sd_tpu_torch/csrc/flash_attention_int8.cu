// K5: attention with an int8 Q K^T for Hopper (sm_90a), the int8 serving
// mode's `attn` (mode "qk") and `attn_pv` (mode "qkpv") buckets:
//
//   logits = (q(Q) q(K)^T) * (sq * scale * log2 e) * sk      (base-2 units)
//   online softmax over 1024-key chunks, running max and sum in fp32
//   "qk":   O += bf16(P) V                                   (fp32 accumulate)
//   "qkpv": O += (round(P * 127) q_chunk(V)) * (sv / 127)     (int32 per chunk)
//
// Q is quantized per row over d, K per key over d, V (qkpv) per feature
// over each 1024-key chunk; P against the running max *after* the whole
// chunk. Round half to even, true division, clip to +-127, scales floored
// at 1e-12, as sd_tpu.
//
// Replaces the TPU kernel `_kernel_chunked_int8` driven by `_fwd_bhnd` in
// sd_tpu/ops/pallas/flash_attention.py. That kernel walks the K/V row in
// 1024-key chunks held in VMEM. In "qk" the chunk touches the function only
// through where P is rounded to bf16 (against the chunk's max there), so
// this kernel runs one pass with a running max per key tile, as K1 does; P
// is rounded against that max, a difference of bf16 rounding that
// tests/test_torch_int8.py sizes against the chunked plain version. In
// "qkpv" the chunk is part of the function: P's codes are taken against the
// max after the whole chunk and V's scales are per chunk, so each chunk
// takes two passes over its key tiles, the first for each row's max (int8
// Q K^T only), the second for P and P V; O is rescaled once per chunk, and
// the chunk's int32 P V times sv / 127 is added after the chunk, in the TPU
// kernel's order. Launches:
//   1. Q and K quantized per row into [B, H, N, DP] int8 codes (d zero-padded
//      to DP: 48 up to d = 48, else 512) with fp32 [B, H, N] scales, one
//      launch each (K's codes are shared by every q block; what Q's
//      pre-pass costs, the most that quantizing Q inside the attention
//      could save, is in PERF.md);
//   2. (qkpv) V quantized per feature and 1024-key chunk, each block 32
//      features of one chunk, into transposed codes [B, H, DP, N] (keys
//      contiguous per feature, in P's fragment order within each 32, below)
//      with [B, H, N / 1024, DP] scales;
//   3. the attention, one block per (q tile, head, batch).
//
// What bounds it on the H100: at the UNet's N = 4096, d = 40 sites the
// products are 4 N^2 d operations per head (half of them int8, at twice the
// bf16 rate) against N d bytes: operations. As in K1, the N^2 exponentials
// on the special-function unit (16 a clock per SM) and the fp32 work per
// logit (here also its dequantization) are a floor of the same order.
//
// Design (the model is K1, flash_attention.cu; fragments in flash_mma.cuh).
// S, P and O stay in registers; K and V tiles are double-buffered by
// cp.async, one __syncthreads a tile.
// - Q K^T runs on mma.sync.m16n8k32 s8 (s32 accumulate): d = 40 pads to 48,
//   one k32 step and one m16n8k16 s8 step. The s32 C fragment has the (row,
//   column) layout of K1's fp32 one, so the dequantization is elementwise in
//   each thread's registers, with `sk` of the thread's columns read from
//   shared memory once a tile (staged with the K tile). At DP = 48 the
//   accumulators start at 0x4B400000, so that each sum reads as the float
//   1.5 * 2^23 + s (|s| <= 127^2 * 48 < 2^22) and one subtraction converts
//   it, where cvt.rn.f32.s32 would take the special-function unit's rate.
// - "qk": P is repacked from the S fragments into bf16 A fragments and P V
//   runs on m16n8k16 bf16 with V read by ldmatrix.trans, exactly as K1.
// - "qkpv": P V runs on m16n8k32 s8. The A fragment wants four consecutive
//   keys per register, while the S fragments give a thread keys 8 j + 2 t +
//   e of each n8 tile j; so a thread packs its own eight codes of each
//   32-key step as its A slots (slot 16 (j / 2) + 4 t + 2 (j % 2) + e, the
//   function pv_slot), and the V quantizer writes each feature's keys in
//   that order (the contraction does not care about the order of the keys,
//   only that P's and V's agree). Its B fragments are then read by plain
//   ldmatrix from the transposed codes.
// - d <= 48: 4 warps; in "qk" each owns two m-tiles of 16 rows (128 rows a
//   block, each K and V fragment serving both), in "qkpv" one (64 rows),
//   with 64-key tiles; "qk" takes 32-key tiles instead where that fits the
//   grid in fewer waves (`choose`).
// - d > 48 (the VAE mid-block's single head, d = 512): 16 x 512 fp32 of O
//   does not fit a warp's registers. K1's wide design: 32-row blocks of 8
//   warps in two groups of 16 rows; the four warps of a group split a
//   32-key tile's keys (8 each, the whole contraction, Q's fragments read
//   from shared memory) and O's columns (128 each); P goes through a shared
//   [32, 32] tile (bf16, or int8 codes in pv_slot order); "qk" exchanges
//   the row max through shared memory each tile, "qkpv" once a chunk.
//   128 blocks at B = 1.
// - d > 512 (any head dim sd_tpu's int8 kernel runs at; no config of the
//   repository reaches one): the split plan. Q and K are quantized per row
//   over the whole d, as `_kernel_chunked_int8` does, into codes padded to
//   a multiple of 512 (DP); the wide plan's 32-row blocks and warp split,
//   with O's columns in slices of 512 over blocks (grid.y runs over heads x
//   slices). Per key tile the int32 logits accumulate over 512-column
//   chunks of the codes: each cp.async stage holds one chunk of the
//   block's Q codes and of the tile's K codes, so nothing of the head is
//   held whole. The block then loads only its slice of V (bf16 for "qk";
//   for "qkpv" the slice's features of V's transposed codes, with their
//   per-chunk scales) and runs the wide plan's P V on it. Each slice
//   recomputes the int8 Q K^T, the price of the split, as K1's split plan.
//
// N must be a multiple of 1024 (no ragged tiles or rows), d a multiple of 8
// (the wrapper zero-pads another head dim on d, which changes no code or
// scale); self-attention only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

using sdt::bf16;

namespace {

constexpr int kChunk = 1024;
constexpr int kQuantWarps = 8;
constexpr unsigned kMagic = 0x4B400000u;  // the float 1.5 * 2^23
constexpr float kMagicF = 12582912.f;

__device__ __forceinline__ float quant_scale(float amax) { return fmaxf(amax / 127.f, 1e-12f); }

__device__ __forceinline__ signed char quant(float x, float s) {
  return static_cast<signed char>(fminf(fmaxf(rintf(x / s), -127.f), 127.f));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Where key k (0 .. 31) of a 32-key step sits in P's A fragment of
// m16n8k32: the key 8 j + 2 t + e that thread t of a quad holds in n8 tile j
// (element e) fills A slot 16 (j / 2) + 4 t + 2 (j % 2) + e. V's transposed
// codes hold key k of each 32 at this position.
__host__ __device__ __forceinline__ int pv_slot(int k) {
  return 16 * (k / 16) + 4 * ((k % 8) / 2) + 2 * ((k / 8) % 2) + (k % 2);
}

// Four codes (0 .. 127) into one register, the first in the low byte.
__device__ __forceinline__ unsigned pack_codes(float p0, float p1, float p2, float p3) {
  return (unsigned)__float2int_rn(p0 * 127.f) | (unsigned)__float2int_rn(p1 * 127.f) << 8 |
         (unsigned)__float2int_rn(p2 * 127.f) << 16 | (unsigned)__float2int_rn(p3 * 127.f) << 24;
}

// x [B, N, H, d] bf16 -> codes [B, H, N, dp] (zero-padded), scales [B, H, N].
// dp = 48: one thread per row, consecutive threads on consecutive tokens of
// one (b, h), so that the codes are written contiguously; 16-byte loads and
// stores. dp = 512: one warp per row, 16 bytes a lane. dp > 512: one warp
// per row in two passes over it, the max and then the codes, 8 values a
// lane at a time.
__global__ void __launch_bounds__(256)
quant_heads_kernel(const bf16* __restrict__ x, signed char* __restrict__ xq,
                   float* __restrict__ sx, int batch, int n, int heads, int d, int dp) {
  const int chunks = d / 8;
  if (dp == 48) {
    const long row = (long)blockIdx.x * 256 + threadIdx.x;  // (b, h, t), t fastest
    if (row >= (long)batch * n * heads) return;
    const int t = row % n;
    const long bh = row / n;
    const bf16* src = x + (((bh / heads) * n + t) * heads + bh % heads) * d;
    uint4 raw[6];
    float amax = 0.f;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      raw[c] = c < chunks ? reinterpret_cast<const uint4*>(src)[c] : make_uint4(0u, 0u, 0u, 0u);
      const bf16* e = reinterpret_cast<const bf16*>(&raw[c]);
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(__bfloat162float(e[i])));
    }
    const float s = quant_scale(amax);
    sx[row] = s;
    uint4 out[3];
    signed char* o = reinterpret_cast<signed char*>(out);
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const bf16* e = reinterpret_cast<const bf16*>(&raw[c]);
#pragma unroll
      for (int i = 0; i < 8; ++i) o[c * 8 + i] = quant(__bfloat162float(e[i]), s);
    }
    uint4* dst = reinterpret_cast<uint4*>(xq + row * 48);
#pragma unroll
    for (int c = 0; c < 3; ++c) dst[c] = out[c];
    return;
  }
  const long row = (long)blockIdx.x * kQuantWarps + threadIdx.x / 32;  // (b, n, h)
  const int lane = threadIdx.x % 32;
  if (row >= (long)batch * n * heads) return;
  const int h = row % heads;
  const int t = (row / heads) % n;
  const int b = row / ((long)heads * n);
  const bf16* src = x + row * d;
  if (dp > 512) {
    float amax = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[c];
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(__bfloat162float(e[i])));
    }
    const float s = quant_scale(warp_max(amax));
    const size_t out_row = ((size_t)b * heads + h) * n + t;
    if (lane == 0) sx[out_row] = s;
    for (int c = lane; c < dp / 8; c += 32) {
      uint2 out = make_uint2(0u, 0u);
      if (c < chunks) {
        const uint4 raw = reinterpret_cast<const uint4*>(src)[c];
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
        signed char* o = reinterpret_cast<signed char*>(&out);
#pragma unroll
        for (int i = 0; i < 8; ++i) o[i] = quant(__bfloat162float(e[i]), s);
      }
      reinterpret_cast<uint2*>(xq + out_row * dp)[c] = out;
    }
    return;
  }
  float amax = 0.f;
  uint4 raw[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = lane + 32 * r;
    raw[r] = c < chunks ? reinterpret_cast<const uint4*>(src)[c] : make_uint4(0u, 0u, 0u, 0u);
    const bf16* e = reinterpret_cast<const bf16*>(&raw[r]);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(__bfloat162float(e[i])));
  }
  const float s = quant_scale(warp_max(amax));
  const size_t out_row = ((size_t)b * heads + h) * n + t;
  if (lane == 0) sx[out_row] = s;
  // lane writes codes 16 lane .. 16 lane + 15: chunks 2 lane and 2 lane + 1
  // of 8 values, which lanes lane / 2 and 16 + lane / 2 loaded
  uint4 out;
  signed char* o = reinterpret_cast<signed char*>(&out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = 2 * lane + half;
    uint4 v[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      v[r].x = __shfl_sync(0xffffffffu, raw[r].x, c % 32);
      v[r].y = __shfl_sync(0xffffffffu, raw[r].y, c % 32);
      v[r].z = __shfl_sync(0xffffffffu, raw[r].z, c % 32);
      v[r].w = __shfl_sync(0xffffffffu, raw[r].w, c % 32);
    }
    const uint4 w = c < 32 ? v[0] : v[1];
    const bf16* e = reinterpret_cast<const bf16*>(&w);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[half * 8 + i] = c < chunks ? quant(__bfloat162float(e[i]), s) : 0;
  }
  if (16 * lane < dp) reinterpret_cast<uint4*>(xq + out_row * dp)[lane] = out;
}

// v [B, N, H, d] -> transposed codes vq [B, H, dp, N] (zero rows past d;
// keys in pv_slot order within each 32) and scales sv [B, H, N / 1024, dp]:
// per feature over each 1024-key chunk. Grid (chunks, dp / 32, B * H), 256
// threads: each block takes 32 features of one chunk, four threads a key
// row with 16-byte loads; the max over the chunk first, then 64 keys at a
// time quantized into a shared [32, 64] tile and written out as 16-byte
// rows of keys.
constexpr int kVF = 32;
constexpr int kVKeys = 64;

__global__ void __launch_bounds__(256)
quant_v_kernel(const bf16* __restrict__ v, signed char* __restrict__ vq,
               float* __restrict__ sv, int n, int heads, int d, int dp) {
  __shared__ float red[8][kVF];
  __shared__ float scale[kVF];
  __shared__ __align__(16) signed char tile[kVF][kVKeys];
  const int chunk = blockIdx.x, f0 = blockIdx.y * kVF, bh = blockIdx.z;
  const int b = bh / heads, h = bh % heads;
  const int fc = threadIdx.x % 4, kr = threadIdx.x / 4;  // 8 features fc * 8 .., key kr
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f = f0 + fc * 8;
  const bool live = f < d;
  const bf16* src = v + ((size_t)b * n + (size_t)chunk * kChunk) * heads * d + (size_t)h * d + f;
  const size_t key_stride = (size_t)heads * d;

  float amax[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) amax[e] = 0.f;
  if (live) {
    for (int k0 = 0; k0 < kChunk; k0 += kVKeys) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)(k0 + kr) * key_stride);
      const bf16* x = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax[e] = fmaxf(amax[e], fabsf(__bfloat162float(x[e])));
    }
  }
  // over the 8 key rows of a warp (lanes fc, fc + 4, ...), then the 8 warps
#pragma unroll
  for (int e = 0; e < 8; ++e) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      amax[e] = fmaxf(amax[e], __shfl_xor_sync(0xffffffffu, amax[e], off));
    if (lane < 4) red[warp][lane * 8 + e] = amax[e];
  }
  __syncthreads();
  if (threadIdx.x < kVF) {
    float m = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) m = fmaxf(m, red[w][threadIdx.x]);
    const float s = quant_scale(m);
    scale[threadIdx.x] = s;
    if (f0 + threadIdx.x < dp)
      sv[((size_t)bh * (n / kChunk) + chunk) * dp + f0 + threadIdx.x] = s;
  }
  __syncthreads();
  float s[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = scale[fc * 8 + e];
  const int slot = (kr / 32) * 32 + pv_slot(kr % 32);
  for (int k0 = 0; k0 < kChunk; k0 += kVKeys) {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (live) raw = *reinterpret_cast<const uint4*>(src + (size_t)(k0 + kr) * key_stride);
    const bf16* x = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) tile[fc * 8 + e][slot] = quant(__bfloat162float(x[e]), s[e]);
    __syncthreads();
    if (threadIdx.x < kVF * 4) {
      const int fr = threadIdx.x / 4, part = threadIdx.x % 4;
      if (f0 + fr < dp)
        *reinterpret_cast<uint4*>(vq + ((size_t)bh * dp + f0 + fr) * n + chunk * kChunk + k0 +
                                  part * 16) = *reinterpret_cast<const uint4*>(&tile[fr][part * 16]);
    }
    __syncthreads();
  }
}

// Copies `rows` rows of `chunks` 16-byte chunks each from src (row stride
// `stride` bytes) to dst (pitch `pitch` bytes) with cp.async.
template <int THREADS>
__device__ __forceinline__ void copy_rows(void* dst, const void* src, int rows, int chunks,
                                          size_t stride, int pitch) {
  for (int i = threadIdx.x; i < rows * chunks; i += THREADS) {
    const int r = i / chunks, c = i - r * chunks;
    sdt::cp_async16(static_cast<unsigned char*>(dst) + r * pitch + c * 16,
                    static_cast<const unsigned char*>(src) + r * stride + c * 16, true);
  }
}

// ---------------------------------------------------------------- d <= 48

// The plan of the narrow kernel: 4 warps of MT m-tiles, BK-key tiles, the
// contraction padded to 48. Shared memory (bytes): Q codes, then two stages
// of (K codes, the keys' scales, V: bf16 [64, 56] in "qk", transposed codes
// [48, 64 + 16] in "qkpv").
template <bool PV8, int BK_>
struct NarrowPlan {
  static constexpr int DP = 48;
  static constexpr int WARPS = 4;
  static constexpr int MT = PV8 ? 1 : 2;
  static constexpr int BQ = 16 * MT * WARPS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BK = BK_;
  static constexpr int LDV = DP + 8;    // bf16 pitch of V (qk)
  static constexpr int LDT = BK + 16;   // byte pitch of V's transposed codes (qkpv)
  static constexpr int K = 0;
  static constexpr int SK = K + BK * DP;
  static constexpr int V = SK + BK * 4;
  static constexpr int STAGE = V + (PV8 ? DP * LDT : BK * LDV * 2);
  static constexpr int Q = 2 * STAGE;
  static constexpr int BYTES = Q + BQ * DP;
};

template <bool PV8, int BK_>
__global__ void __launch_bounds__(128)
int8_attn_kernel(const signed char* __restrict__ qq, const float* __restrict__ sq,
                 const signed char* __restrict__ kq, const float* __restrict__ sk,
                 const bf16* __restrict__ v, const signed char* __restrict__ vq,
                 const float* __restrict__ sv, bf16* __restrict__ o, int n, int heads, int d,
                 float sl) {
  using P = NarrowPlan<PV8, BK_>;
  constexpr int DP = P::DP, BK = P::BK, MT = P::MT;
  constexpr int NS = BK / 8;  // n8 tiles of S
  constexpr int NO = DP / 8;  // n8 tiles of O; those at or past d / 8 are skipped
  constexpr int TILES = kChunk / BK;
  extern __shared__ __align__(128) unsigned char smem[];

  const int q0 = blockIdx.x * P::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * heads + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int nv = d / 8;
  const int nchunks = n / kChunk;
  // "qk": one step per key tile; "qkpv": per chunk, its tiles for the max,
  // then again for P and P V
  const int steps = PV8 ? nchunks * 2 * TILES : n / BK;

  auto load = [&](int step) {
    unsigned char* st = smem + (step & 1) * P::STAGE;
    const bool pass2 = PV8 && (step / TILES) % 2 == 1;
    const int k0 = PV8 ? (step / (2 * TILES)) * kChunk + (step % TILES) * BK : step * BK;
    copy_rows<P::THREADS>(st + P::K, kq + (bh * n + k0) * DP, 1, BK * DP / 16, 0, 0);
    copy_rows<P::THREADS>(st + P::SK, sk + bh * n + k0, 1, BK / 4, 0, 0);
    if (!PV8)
      copy_rows<P::THREADS>(st + P::V, v + ((size_t)(b * n + k0) * heads + h) * d, BK, nv,
                            (size_t)heads * d * 2, P::LDV * 2);
    else if (pass2)
      copy_rows<P::THREADS>(st + P::V, vq + bh * DP * n + k0, DP, BK / 16, n, P::LDT);
  };

  copy_rows<P::THREADS>(smem + P::Q, qq + (bh * n + q0) * DP, 1, P::BQ * DP / 16, 0, 0);
  load(0);
  sdt::cp_async_commit();

  float acc[MT][NO][4];
  int oi[PV8 ? MT : 1][NO][4];
  float m[MT][2], l[MT][2], mc[MT][2], rs[MT][2];
  unsigned qa[MT][4], qb[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[mt][hh] = mc[mt][hh] = -INFINITY;
      l[mt][hh] = 0.f;
      rs[mt][hh] = sq[bh * n + q0 + (warp * MT + mt) * 16 + g + 8 * hh] * sl;
    }
  }

  for (int step = 0; step < steps; ++step) {
    sdt::cp_async_wait<0>();
    __syncthreads();
    if (step == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const signed char* qrow = reinterpret_cast<const signed char*>(smem + P::Q) +
                                  ((warp * MT + mt) * 16 + lane % 16) * DP;
        sdt::ldmatrix_x4(qa[mt], qrow + lane / 16 * 16);
        sdt::ldmatrix_x2(qb[mt], qrow + 32);
      }
    }
    if (step + 1 < steps) load(step + 1);
    sdt::cp_async_commit();
    const unsigned char* st = smem + (step & 1) * P::STAGE;
    const signed char* ks = reinterpret_cast<const signed char*>(st + P::K);
    const float* sks = reinterpret_cast<const float*>(st + P::SK);
    const int within = step % (2 * TILES);
    const bool pass1 = PV8 && within < TILES;

    // S = q(Q) q(K)^T: a k32 step (d 0..31) and a k16 step (d 32..47)
    int si[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j) si[mt][j][0] = si[mt][j][1] = si[mt][j][2] = si[mt][j][3] = kMagic;
#pragma unroll
    for (int jp = 0; jp < NS / 2; ++jp) {
      unsigned kf[4];
      sdt::ldmatrix_x4(kf, ks + (jp * 16 + lane % 8 + lane / 16 * 8) * DP + (lane / 8) % 2 * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        sdt::mma_s8(si[mt][2 * jp], qa[mt], kf[0], kf[1]);
        sdt::mma_s8(si[mt][2 * jp + 1], qa[mt], kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int jq = 0; jq < NS / 4; ++jq) {
      unsigned kf[4];
      sdt::ldmatrix_x4(kf, ks + (jq * 32 + lane) * DP + 32);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sdt::mma_s8_k16(si[mt][4 * jq + i], qb[mt][0], qb[mt][1], kf[i]);
    }

    // s * sk; the logits in log2 units are that times the row's rs = sq *
    // scale * log2 e > 0, which the max takes once a row and the exponent
    // in its fma
    float s[MT][NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float2 kc = *reinterpret_cast<const float2*>(sks + j * 8 + 2 * tq);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        s[mt][j][0] = (__int_as_float(si[mt][j][0]) - kMagicF) * kc.x;
        s[mt][j][1] = (__int_as_float(si[mt][j][1]) - kMagicF) * kc.y;
        s[mt][j][2] = (__int_as_float(si[mt][j][2]) - kMagicF) * kc.x;
        s[mt][j][3] = (__int_as_float(si[mt][j][3]) - kMagicF) * kc.y;
      }
    }

    if (pass1) {
      // each row's max over the chunk; at its last tile, the chunk's new
      // max: O and the sums rescaled once, the chunk's P V zeroed
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          mc[mt][0] = fmaxf(mc[mt][0], fmaxf(s[mt][j][0], s[mt][j][1]));
          mc[mt][1] = fmaxf(mc[mt][1], fmaxf(s[mt][j][2], s[mt][j][3]));
        }
      if (within == TILES - 1) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float c[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float mn = fmaxf(m[mt][hh], sdt::quad_max(mc[mt][hh]) * rs[mt][hh]);
            c[hh] = sdt::exp2_approx(m[mt][hh] - mn);
            m[mt][hh] = mn;
            mc[mt][hh] = -INFINITY;
            l[mt][hh] *= c[hh];
          }
          sdt::rescale_rows(acc[mt], c[0], c[1]);
          if (PV8)
#pragma unroll
            for (int j = 0; j < NO; ++j)
              oi[mt][j][0] = oi[mt][j][1] = oi[mt][j][2] = oi[mt][j][3] = 0;
        }
      }
      continue;
    }

    if (!PV8) {
      // the running max over key tiles, as K1
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          t0 = fmaxf(t0, fmaxf(s[mt][j][0], s[mt][j][1]));
          t1 = fmaxf(t1, fmaxf(s[mt][j][2], s[mt][j][3]));
        }
        const float n0 = fmaxf(m[mt][0], sdt::quad_max(t0) * rs[mt][0]);
        const float n1 = fmaxf(m[mt][1], sdt::quad_max(t1) * rs[mt][1]);
        const float c0 = sdt::exp2_approx(m[mt][0] - n0), c1 = sdt::exp2_approx(m[mt][1] - n1);
        m[mt][0] = n0;
        m[mt][1] = n1;
        l[mt][0] *= c0;
        l[mt][1] *= c1;
        sdt::rescale_rows(acc[mt], c0, c1);
      }
    }

    // P against the running max (qk) or the chunk's (qkpv)
    float pr[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      pr[mt][0] = m[mt][0];
      pr[mt][1] = m[mt][1];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[mt][j][0] = sdt::exp2_approx(fmaf(s[mt][j][0], rs[mt][0], -pr[mt][0]));
        s[mt][j][1] = sdt::exp2_approx(fmaf(s[mt][j][1], rs[mt][0], -pr[mt][0]));
        s[mt][j][2] = sdt::exp2_approx(fmaf(s[mt][j][2], rs[mt][1], -pr[mt][1]));
        s[mt][j][3] = sdt::exp2_approx(fmaf(s[mt][j][3], rs[mt][1], -pr[mt][1]));
        l[mt][0] += s[mt][j][0] + s[mt][j][1];
        l[mt][1] += s[mt][j][2] + s[mt][j][3];
      }

    if (!PV8) {
      // O += bf16(P) V; P's C fragments repacked as A fragments
      const bf16* vs = reinterpret_cast<const bf16*>(st + P::V);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned pf[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pf[mt][0] = sdt::pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pf[mt][1] = sdt::pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pf[mt][2] = sdt::pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pf[mt][3] = sdt::pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          if (2 * dp < nv) {
            unsigned vf[4];
            sdt::ldmatrix_x4_trans(vf, vs + (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * P::LDV +
                                           dp * 16 + lane / 16 * 8);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              sdt::mma(acc[mt][2 * dp], pf[mt], vf[0], vf[1]);
              if (2 * dp + 1 < nv) sdt::mma(acc[mt][2 * dp + 1], pf[mt], vf[2], vf[3]);
            }
          }
        }
      }
    } else {
      // the chunk's P V in int32: P's codes packed in pv_slot order, V's
      // transposed codes read as B fragments
      const signed char* vts = reinterpret_cast<const signed char*>(st + P::V);
#pragma unroll
      for (int ks2 = 0; ks2 < BK / 32; ++ks2) {
        unsigned pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int j = 4 * ks2;
          pa[mt][0] = pack_codes(s[mt][j][0], s[mt][j][1], s[mt][j + 1][0], s[mt][j + 1][1]);
          pa[mt][1] = pack_codes(s[mt][j][2], s[mt][j][3], s[mt][j + 1][2], s[mt][j + 1][3]);
          pa[mt][2] = pack_codes(s[mt][j + 2][0], s[mt][j + 2][1], s[mt][j + 3][0], s[mt][j + 3][1]);
          pa[mt][3] = pack_codes(s[mt][j + 2][2], s[mt][j + 2][3], s[mt][j + 3][2], s[mt][j + 3][3]);
        }
#pragma unroll
        for (int fp = 0; fp < NO / 2; ++fp) {
          if (2 * fp < nv) {
            unsigned vf[4];
            sdt::ldmatrix_x4(vf, vts + (fp * 16 + lane % 8 + lane / 16 * 8) * P::LDT + ks2 * 32 +
                                     (lane / 8) % 2 * 16);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              sdt::mma_s8(oi[mt][2 * fp], pa[mt], vf[0], vf[1]);
              if (2 * fp + 1 < nv) sdt::mma_s8(oi[mt][2 * fp + 1], pa[mt], vf[2], vf[3]);
            }
          }
        }
      }
      if (within == 2 * TILES - 1) {
        // O += (P V)_int32 * (sv / 127), the chunk's per-feature V scales
        const float* svc = sv + (bh * nchunks + step / (2 * TILES)) * DP;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          if (j < nv) {
            const float2 vs2 = *reinterpret_cast<const float2*>(svc + j * 8 + 2 * tq);
            const float f0 = vs2.x / 127.f, f1 = vs2.y / 127.f;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              acc[mt][j][0] += static_cast<float>(oi[mt][j][0]) * f0;
              acc[mt][j][1] += static_cast<float>(oi[mt][j][1]) * f1;
              acc[mt][j][2] += static_cast<float>(oi[mt][j][2]) * f0;
              acc[mt][j][3] += static_cast<float>(oi[mt][j][3]) * f1;
            }
          }
        }
      }
    }
  }

  bf16* ob = o + ((size_t)b * n * heads + h) * d;
  const int row_stride = heads * d;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float i0 = 1.f / sdt::quad_sum(l[mt][0]), i1 = 1.f / sdt::quad_sum(l[mt][1]);
    const int r0 = q0 + (warp * MT + mt) * 16 + g;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      if (j < nv) {
        const int c = j * 8 + 2 * tq;
        *reinterpret_cast<unsigned*>(ob + (size_t)r0 * row_stride + c) =
            sdt::pack_bf16(acc[mt][j][0] * i0, acc[mt][j][1] * i0);
        *reinterpret_cast<unsigned*>(ob + (size_t)(r0 + 8) * row_stride + c) =
            sdt::pack_bf16(acc[mt][j][2] * i1, acc[mt][j][3] * i1);
      }
    }
  }
}

// ----------------------------------------------------------------- d > 48

// The plan of the wide kernel: 8 warps, 32 query rows in two groups of 16,
// 32-key tiles; the four warps of a group split S's keys (8 each) and O's
// columns (DP / 4 each). Shared memory (bytes): two stages of (K codes, the
// keys' scales, V: bf16 [32, DP + 8] in "qk", transposed codes [DP, 48] in
// "qkpv"), Q's codes, the P tile (bf16 [32, 40] or codes [32, 48]) and the
// fp32 [2][4][16] row exchange.
template <bool PV8>
struct WidePlan {
  static constexpr int DP = 512;
  static constexpr int THREADS = 256;
  static constexpr int BQ = 32;
  static constexpr int BK = 32;
  static constexpr int LDQ = DP + 16;  // byte pitch of the Q and K codes
  static constexpr int LDV = DP + 8;   // bf16 pitch of V (qk)
  static constexpr int LDT = BK + 16;  // byte pitch of V's transposed codes (qkpv)
  static constexpr int LDP = PV8 ? BK + 16 : (BK + 8) * 2;  // byte pitch of P
  static constexpr int K = 0;
  static constexpr int SK = K + BK * LDQ;
  static constexpr int V = SK + BK * 4;
  static constexpr int STAGE = V + (PV8 ? DP * LDT : BK * LDV * 2);
  static constexpr int Q = 2 * STAGE;
  static constexpr int PT = Q + BQ * LDQ;
  static constexpr int RED = PT + BQ * LDP;
  static constexpr int BYTES = RED + 2 * 4 * 16 * 4;
};

template <bool PV8>
__global__ void __launch_bounds__(256)
int8_attn_kernel_wide(const signed char* __restrict__ qq, const float* __restrict__ sq,
                      const signed char* __restrict__ kq, const float* __restrict__ sk,
                      const bf16* __restrict__ v, const signed char* __restrict__ vq,
                      const float* __restrict__ sv, bf16* __restrict__ o, int n, int heads,
                      int d, float sl) {
  using P = WidePlan<PV8>;
  constexpr int DP = P::DP, BK = P::BK, LDQ = P::LDQ;
  constexpr int NO = DP / 32;  // n8 tiles of O per warp (DP / 4 columns)
  constexpr int TILES = kChunk / BK;
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + P::RED);

  const int q0 = blockIdx.x * P::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * heads + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int rg = warp / 4;  // row group: rows rg * 16 ..
  const int cg = warp % 4;  // keys cg * 8 .. of a tile, O columns cg * DP / 4 ..
  const int col0 = cg * (DP / 4);
  const int nv = min(NO, (d - col0 + 7) / 8);  // this warp's n8 tiles of O inside d
  float* red_row = red + rg * 64;
  const int nchunks = n / kChunk;
  const int steps = PV8 ? nchunks * 2 * TILES : n / BK;

  auto load = [&](int step) {
    unsigned char* st = smem + (step & 1) * P::STAGE;
    const bool pass2 = PV8 && (step / TILES) % 2 == 1;
    const int k0 = PV8 ? (step / (2 * TILES)) * kChunk + (step % TILES) * BK : step * BK;
    copy_rows<P::THREADS>(st + P::K, kq + (bh * n + k0) * DP, BK, DP / 16, DP, LDQ);
    copy_rows<P::THREADS>(st + P::SK, sk + bh * n + k0, 1, BK / 4, 0, 0);
    if (!PV8)
      copy_rows<P::THREADS>(st + P::V, v + ((size_t)(b * n + k0) * heads + h) * d, BK, d / 8,
                            (size_t)heads * d * 2, P::LDV * 2);
    else if (pass2)
      copy_rows<P::THREADS>(st + P::V, vq + bh * DP * n + k0, DP, BK / 16, n, P::LDT);
  };

  copy_rows<P::THREADS>(smem + P::Q, qq + (bh * n + q0) * DP, P::BQ, DP / 16, DP, LDQ);
  load(0);
  sdt::cp_async_commit();

  float acc[NO][4];
  int oi[PV8 ? NO : 1][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, mc0 = -INFINITY, mc1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;  // this thread's part of the sums over its warp's keys
  const float rs0 = sq[bh * n + q0 + rg * 16 + g] * sl;
  const float rs1 = sq[bh * n + q0 + rg * 16 + g + 8] * sl;
  const signed char* qrow =
      reinterpret_cast<const signed char*>(smem + P::Q) + (rg * 16 + lane % 16) * LDQ + lane / 16 * 16;

  for (int step = 0; step < steps; ++step) {
    sdt::cp_async_wait<0>();
    __syncthreads();
    if (step + 1 < steps) load(step + 1);
    sdt::cp_async_commit();
    const unsigned char* st = smem + (step & 1) * P::STAGE;
    const int within = step % (2 * TILES);
    const bool pass1 = PV8 && within < TILES;

    // S over this warp's 8 keys, the whole contraction; ldmatrix_x4 on K
    // gives the B fragments of two k32 steps
    int si[4] = {0, 0, 0, 0};
    const signed char* krow = reinterpret_cast<const signed char*>(st + P::K) +
                              (cg * 8 + lane % 8) * LDQ + lane / 8 * 16;
#pragma unroll 4
    for (int kk = 0; kk < DP / 32; kk += 2) {
      unsigned kf[4], qa[4], qc[4];
      sdt::ldmatrix_x4(kf, krow + kk * 32);
      sdt::ldmatrix_x4(qa, qrow + kk * 32);
      sdt::ldmatrix_x4(qc, qrow + kk * 32 + 32);
      sdt::mma_s8(si, qa, kf[0], kf[1]);
      sdt::mma_s8(si, qc, kf[2], kf[3]);
    }
    const float2 kc = *reinterpret_cast<const float2*>(
        reinterpret_cast<const float*>(st + P::SK) + cg * 8 + 2 * tq);
    float s[4];
    s[0] = static_cast<float>(si[0]) * rs0 * kc.x;
    s[1] = static_cast<float>(si[1]) * rs0 * kc.y;
    s[2] = static_cast<float>(si[2]) * rs1 * kc.x;
    s[3] = static_cast<float>(si[3]) * rs1 * kc.y;
    float t0 = sdt::quad_max(fmaxf(s[0], s[1]));
    float t1 = sdt::quad_max(fmaxf(s[2], s[3]));

    if (pass1) {
      mc0 = fmaxf(mc0, t0);
      mc1 = fmaxf(mc1, t1);
      if (within == TILES - 1) {
        // the chunk's max over the group's four warps; O and the sums
        // rescaled once, the chunk's P V zeroed
        if (tq == 0) {
          red_row[cg * 16 + g] = mc0;
          red_row[cg * 16 + g + 8] = mc1;
        }
        __syncthreads();
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          mc0 = fmaxf(mc0, red_row[w * 16 + g]);
          mc1 = fmaxf(mc1, red_row[w * 16 + g + 8]);
        }
        const float n0 = fmaxf(m0, mc0), n1 = fmaxf(m1, mc1);
        const float c0 = sdt::exp2_approx(m0 - n0), c1 = sdt::exp2_approx(m1 - n1);
        m0 = n0;
        m1 = n1;
        mc0 = mc1 = -INFINITY;
        l0 *= c0;
        l1 *= c1;
        sdt::rescale_rows(acc, c0, c1);
        if (PV8)
#pragma unroll
          for (int j = 0; j < NO; ++j) oi[j][0] = oi[j][1] = oi[j][2] = oi[j][3] = 0;
      }
      continue;
    }

    if (!PV8) {
      // the row max over the group's four warps, each tile
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
      const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
      const float c0 = sdt::exp2_approx(m0 - n0), c1 = sdt::exp2_approx(m1 - n1);
      m0 = n0;
      m1 = n1;
      l0 *= c0;
      l1 *= c1;
      sdt::rescale_rows(acc, c0, c1);
    }

    // P against the running max (qk) or the chunk's (qkpv)
    const float pr0 = m0, pr1 = m1;
    const float p0 = sdt::exp2_approx(s[0] - pr0);
    const float p1 = sdt::exp2_approx(s[1] - pr0);
    const float p2 = sdt::exp2_approx(s[2] - pr1);
    const float p3 = sdt::exp2_approx(s[3] - pr1);
    l0 += p0 + p1;
    l1 += p2 + p3;
    unsigned char* ps = smem + P::PT;
    if (!PV8) {
      unsigned char* prow = ps + (rg * 16 + g) * P::LDP + (cg * 8 + 2 * tq) * 2;
      *reinterpret_cast<unsigned*>(prow) = sdt::pack_bf16(p0, p1);
      *reinterpret_cast<unsigned*>(prow + 8 * P::LDP) = sdt::pack_bf16(p2, p3);
    } else {
      signed char* prow = reinterpret_cast<signed char*>(ps + (rg * 16 + g) * P::LDP);
      const int k0s = pv_slot(cg * 8 + 2 * tq), k1s = pv_slot(cg * 8 + 2 * tq + 1);
      prow[k0s] = static_cast<signed char>(__float2int_rn(p0 * 127.f));
      prow[k1s] = static_cast<signed char>(__float2int_rn(p1 * 127.f));
      prow[8 * P::LDP + k0s] = static_cast<signed char>(__float2int_rn(p2 * 127.f));
      prow[8 * P::LDP + k1s] = static_cast<signed char>(__float2int_rn(p3 * 127.f));
    }
    __syncthreads();

    if (!PV8) {
      // O[:, this warp's columns] += bf16(P) V
      const bf16* vs = reinterpret_cast<const bf16*>(st + P::V);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned pa[4];
        sdt::ldmatrix_x4(pa, ps + (rg * 16 + lane % 16) * P::LDP + (kk * 16 + lane / 16 * 8) * 2);
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
    } else {
      // the chunk's P V in int32 over this warp's columns
      const signed char* vts = reinterpret_cast<const signed char*>(st + P::V);
      unsigned pa[4];
      sdt::ldmatrix_x4(pa, ps + (rg * 16 + lane % 16) * P::LDP + lane / 16 * 16);
#pragma unroll
      for (int fp = 0; fp < NO / 2; ++fp) {
        if (2 * fp < nv) {
          unsigned vf[4];
          sdt::ldmatrix_x4(vf, vts + (col0 + fp * 16 + lane % 8 + lane / 16 * 8) * P::LDT +
                                   (lane / 8) % 2 * 16);
          sdt::mma_s8(oi[2 * fp], pa, vf[0], vf[1]);
          if (2 * fp + 1 < nv) sdt::mma_s8(oi[2 * fp + 1], pa, vf[2], vf[3]);
        }
      }
      if (within == 2 * TILES - 1) {
        const float* svc = sv + (bh * nchunks + step / (2 * TILES)) * DP + col0;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          if (j < nv) {
            const float2 vs2 = *reinterpret_cast<const float2*>(svc + j * 8 + 2 * tq);
            const float f0 = vs2.x / 127.f, f1 = vs2.y / 127.f;
            acc[j][0] += static_cast<float>(oi[j][0]) * f0;
            acc[j][1] += static_cast<float>(oi[j][1]) * f1;
            acc[j][2] += static_cast<float>(oi[j][2]) * f0;
            acc[j][3] += static_cast<float>(oi[j][3]) * f1;
          }
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
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const int row_stride = heads * d;
  bf16* ob = o + ((size_t)b * n * heads + h) * d;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (j < nv) {
      const int cc = col0 + j * 8 + 2 * tq;
      *reinterpret_cast<unsigned*>(ob + (size_t)r0 * row_stride + cc) =
          sdt::pack_bf16(acc[j][0] * i0, acc[j][1] * i0);
      *reinterpret_cast<unsigned*>(ob + (size_t)(r0 + 8) * row_stride + cc) =
          sdt::pack_bf16(acc[j][2] * i1, acc[j][3] * i1);
    }
  }
}

// ---------------------------------------------------------------- d > 512

// The plan of the split kernel: the wide plan's 8 warps, 32 query rows in
// two groups of 16 and 32-key tiles, O's columns in slices of OC over
// blocks, the contraction in chunks of DC columns of the codes. Shared
// memory (bytes): two stages of (a DC-column chunk of the block's Q codes,
// the same chunk of the tile's K codes), the tile's keys' scales, its V
// slice (bf16 [32, OC + 8] in "qk", transposed codes [OC, 48] in "qkpv"),
// the P tile and the fp32 [2][4][16] row exchange.
template <bool PV8>
struct SplitPlan {
  static constexpr int DC = 512;
  static constexpr int OC = 512;
  static constexpr int THREADS = 256;
  static constexpr int BQ = 32;
  static constexpr int BK = 32;
  static constexpr int LDQ = DC + 16;  // byte pitch of the Q and K code chunks
  static constexpr int LDV = OC + 8;   // bf16 pitch of V (qk)
  static constexpr int LDT = BK + 16;  // byte pitch of V's transposed codes (qkpv)
  static constexpr int LDP = PV8 ? BK + 16 : (BK + 8) * 2;  // byte pitch of P
  static constexpr int STAGE = (BQ + BK) * LDQ;              // Q's chunk, then K's
  static constexpr int SK = 2 * STAGE;
  static constexpr int V = SK + BK * 4;
  static constexpr int PT = V + (PV8 ? OC * LDT : BK * LDV * 2);
  static constexpr int RED = PT + BQ * LDP;
  static constexpr int BYTES = RED + 2 * 4 * 16 * 4;
};

template <bool PV8>
__global__ void __launch_bounds__(256)
int8_attn_kernel_split(const signed char* __restrict__ qq, const float* __restrict__ sq,
                       const signed char* __restrict__ kq, const float* __restrict__ sk,
                       const bf16* __restrict__ v, const signed char* __restrict__ vq,
                       const float* __restrict__ sv, bf16* __restrict__ o, int n, int heads,
                       int d, float sl) {
  using P = SplitPlan<PV8>;
  constexpr int DC = P::DC, OC = P::OC, BK = P::BK, LDQ = P::LDQ;
  constexpr int NO = OC / 32;  // n8 tiles of O per warp (OC / 4 columns)
  constexpr int TILES = kChunk / BK;
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + P::RED);

  const int dp = (d + DC - 1) / DC * DC;  // the codes' padded head dim
  const int nc = dp / DC;                 // contraction chunks
  const int slices = gridDim.y / heads;
  const int h = blockIdx.y / slices;
  const int s0 = (blockIdx.y - h * slices) * OC;  // the block's first column of O
  const int ow = min(OC, d - s0);                 // its columns of O
  const int q0 = blockIdx.x * P::BQ;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * heads + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int rg = warp / 4;  // row group: rows rg * 16 ..
  const int cg = warp % 4;  // keys cg * 8 .. of a tile, slice columns cg * OC / 4 ..
  const int col0 = cg * (OC / 4);
  const int nv = min(NO, (ow - col0 + 7) / 8);  // this warp's n8 tiles of O inside the slice
  float* red_row = red + rg * 64;
  const int nchunks = n / kChunk;
  const int steps = PV8 ? nchunks * 2 * TILES : n / BK;

  // the key tile of a step: "qk" one step a tile; "qkpv" per chunk its tiles
  // for the max, then again for P and P V
  auto tile_of = [&](int step) {
    return PV8 ? (step / (2 * TILES)) * kChunk + (step % TILES) * BK : step * BK;
  };
  // a stage: chunk c of the contraction, of Q's codes and of the step's K codes
  auto load_chunk = [&](unsigned char* stage, int step, int c) {
    copy_rows<P::THREADS>(stage, qq + (bh * n + q0) * dp + c * DC, P::BQ, DC / 16, dp, LDQ);
    copy_rows<P::THREADS>(stage + P::BQ * LDQ, kq + (bh * n + tile_of(step)) * dp + c * DC, BK,
                          DC / 16, dp, LDQ);
  };
  load_chunk(smem, 0, 0);
  sdt::cp_async_commit();

  float acc[NO][4];
  int oi[PV8 ? NO : 1][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, mc0 = -INFINITY, mc1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;  // this thread's part of the sums over its warp's keys
  const float rs0 = sq[bh * n + q0 + rg * 16 + g] * sl;
  const float rs1 = sq[bh * n + q0 + rg * 16 + g + 8] * sl;
  const int qoff = (rg * 16 + lane % 16) * LDQ + lane / 16 * 16;
  const int koff = P::BQ * LDQ + (cg * 8 + lane % 8) * LDQ + lane / 8 * 16;

  int u = 0;  // chunks streamed so far: chunk u sits in stage u & 1
  for (int step = 0; step < steps; ++step) {
    const int within = step % (2 * TILES);
    const bool pass1 = PV8 && within < TILES;
    const int k0 = tile_of(step);

    // S over this warp's 8 keys, the contraction in chunks of DC codes
    int si[4] = {0, 0, 0, 0};
    for (int c = 0; c < nc; ++c, ++u) {
      sdt::cp_async_wait<0>();
      __syncthreads();
      if (c == 0) {
        // the last step's P V is done: its scales and V may be overwritten
        copy_rows<P::THREADS>(smem + P::SK, sk + bh * n + k0, 1, BK / 4, 0, 0);
        if (!PV8)
          copy_rows<P::THREADS>(smem + P::V, v + ((size_t)(b * n + k0) * heads + h) * d + s0, BK,
                                ow / 8, (size_t)heads * d * 2, P::LDV * 2);
        else if (!pass1)
          copy_rows<P::THREADS>(smem + P::V, vq + (bh * dp + s0) * n + k0, OC, BK / 16, n,
                                P::LDT);
      }
      if (c + 1 < nc)
        load_chunk(smem + ((u + 1) & 1) * P::STAGE, step, c + 1);
      else if (step + 1 < steps)
        load_chunk(smem + ((u + 1) & 1) * P::STAGE, step + 1, 0);
      sdt::cp_async_commit();
      const signed char* st = reinterpret_cast<const signed char*>(smem + (u & 1) * P::STAGE);
#pragma unroll 4
      for (int kk = 0; kk < DC / 32; kk += 2) {
        unsigned kf[4], qa[4], qc[4];
        sdt::ldmatrix_x4(kf, st + koff + kk * 32);
        sdt::ldmatrix_x4(qa, st + qoff + kk * 32);
        sdt::ldmatrix_x4(qc, st + qoff + kk * 32 + 32);
        sdt::mma_s8(si, qa, kf[0], kf[1]);
        sdt::mma_s8(si, qc, kf[2], kf[3]);
      }
    }
    // the tile's scales and V slice have landed (issued with its first chunk)
    sdt::cp_async_wait<0>();
    __syncthreads();
    const float2 kc = *reinterpret_cast<const float2*>(
        reinterpret_cast<const float*>(smem + P::SK) + cg * 8 + 2 * tq);
    float s[4];
    s[0] = static_cast<float>(si[0]) * rs0 * kc.x;
    s[1] = static_cast<float>(si[1]) * rs0 * kc.y;
    s[2] = static_cast<float>(si[2]) * rs1 * kc.x;
    s[3] = static_cast<float>(si[3]) * rs1 * kc.y;
    float t0 = sdt::quad_max(fmaxf(s[0], s[1]));
    float t1 = sdt::quad_max(fmaxf(s[2], s[3]));

    if (pass1) {
      mc0 = fmaxf(mc0, t0);
      mc1 = fmaxf(mc1, t1);
      if (within == TILES - 1) {
        // the chunk's max over the group's four warps; O and the sums
        // rescaled once, the chunk's P V zeroed
        if (tq == 0) {
          red_row[cg * 16 + g] = mc0;
          red_row[cg * 16 + g + 8] = mc1;
        }
        __syncthreads();
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          mc0 = fmaxf(mc0, red_row[w * 16 + g]);
          mc1 = fmaxf(mc1, red_row[w * 16 + g + 8]);
        }
        const float n0 = fmaxf(m0, mc0), n1 = fmaxf(m1, mc1);
        const float c0 = sdt::exp2_approx(m0 - n0), c1 = sdt::exp2_approx(m1 - n1);
        m0 = n0;
        m1 = n1;
        mc0 = mc1 = -INFINITY;
        l0 *= c0;
        l1 *= c1;
        sdt::rescale_rows(acc, c0, c1);
        if (PV8)
#pragma unroll
          for (int j = 0; j < NO; ++j) oi[j][0] = oi[j][1] = oi[j][2] = oi[j][3] = 0;
      }
      continue;
    }

    if (!PV8) {
      // the row max over the group's four warps, each tile
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
      const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
      const float c0 = sdt::exp2_approx(m0 - n0), c1 = sdt::exp2_approx(m1 - n1);
      m0 = n0;
      m1 = n1;
      l0 *= c0;
      l1 *= c1;
      sdt::rescale_rows(acc, c0, c1);
    }

    // P against the running max (qk) or the chunk's (qkpv)
    const float p0 = sdt::exp2_approx(s[0] - m0);
    const float p1 = sdt::exp2_approx(s[1] - m0);
    const float p2 = sdt::exp2_approx(s[2] - m1);
    const float p3 = sdt::exp2_approx(s[3] - m1);
    l0 += p0 + p1;
    l1 += p2 + p3;
    unsigned char* ps = smem + P::PT;
    if (!PV8) {
      unsigned char* prow = ps + (rg * 16 + g) * P::LDP + (cg * 8 + 2 * tq) * 2;
      *reinterpret_cast<unsigned*>(prow) = sdt::pack_bf16(p0, p1);
      *reinterpret_cast<unsigned*>(prow + 8 * P::LDP) = sdt::pack_bf16(p2, p3);
    } else {
      signed char* prow = reinterpret_cast<signed char*>(ps + (rg * 16 + g) * P::LDP);
      const int k0s = pv_slot(cg * 8 + 2 * tq), k1s = pv_slot(cg * 8 + 2 * tq + 1);
      prow[k0s] = static_cast<signed char>(__float2int_rn(p0 * 127.f));
      prow[k1s] = static_cast<signed char>(__float2int_rn(p1 * 127.f));
      prow[8 * P::LDP + k0s] = static_cast<signed char>(__float2int_rn(p2 * 127.f));
      prow[8 * P::LDP + k1s] = static_cast<signed char>(__float2int_rn(p3 * 127.f));
    }
    __syncthreads();

    if (!PV8) {
      // O[:, this warp's columns of the slice] += bf16(P) V
      const bf16* vs = reinterpret_cast<const bf16*>(smem + P::V);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned pa[4];
        sdt::ldmatrix_x4(pa, ps + (rg * 16 + lane % 16) * P::LDP + (kk * 16 + lane / 16 * 8) * 2);
#pragma unroll
        for (int fp = 0; fp < NO / 2; ++fp) {
          if (2 * fp < nv) {
            unsigned vf[4];
            sdt::ldmatrix_x4_trans(vf, vs + (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * P::LDV +
                                           col0 + fp * 16 + lane / 16 * 8);
            sdt::mma(acc[2 * fp], pa, vf[0], vf[1]);
            if (2 * fp + 1 < nv) sdt::mma(acc[2 * fp + 1], pa, vf[2], vf[3]);
          }
        }
      }
    } else {
      // the chunk's P V in int32 over this warp's columns of the slice
      const signed char* vts = reinterpret_cast<const signed char*>(smem + P::V);
      unsigned pa[4];
      sdt::ldmatrix_x4(pa, ps + (rg * 16 + lane % 16) * P::LDP + lane / 16 * 16);
#pragma unroll
      for (int fp = 0; fp < NO / 2; ++fp) {
        if (2 * fp < nv) {
          unsigned vf[4];
          sdt::ldmatrix_x4(vf, vts + (col0 + fp * 16 + lane % 8 + lane / 16 * 8) * P::LDT +
                                   (lane / 8) % 2 * 16);
          sdt::mma_s8(oi[2 * fp], pa, vf[0], vf[1]);
          if (2 * fp + 1 < nv) sdt::mma_s8(oi[2 * fp + 1], pa, vf[2], vf[3]);
        }
      }
      if (within == 2 * TILES - 1) {
        const float* svc = sv + (bh * nchunks + step / (2 * TILES)) * dp + s0 + col0;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          if (j < nv) {
            const float2 vs2 = *reinterpret_cast<const float2*>(svc + j * 8 + 2 * tq);
            const float f0 = vs2.x / 127.f, f1 = vs2.y / 127.f;
            acc[j][0] += static_cast<float>(oi[j][0]) * f0;
            acc[j][1] += static_cast<float>(oi[j][1]) * f1;
            acc[j][2] += static_cast<float>(oi[j][2]) * f0;
            acc[j][3] += static_cast<float>(oi[j][3]) * f1;
          }
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
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const int row_stride = heads * d;
  bf16* ob = o + ((size_t)b * n * heads + h) * d + s0;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (j < nv) {
      const int cc = col0 + j * 8 + 2 * tq;
      *reinterpret_cast<unsigned*>(ob + (size_t)r0 * row_stride + cc) =
          sdt::pack_bf16(acc[j][0] * i0, acc[j][1] * i0);
      *reinterpret_cast<unsigned*>(ob + (size_t)(r0 + 8) * row_stride + cc) =
          sdt::pack_bf16(acc[j][2] * i1, acc[j][3] * i1);
    }
  }
}

typedef void (*AttnFn)(const signed char*, const float*, const signed char*, const float*,
                       const bf16*, const signed char*, const float*, bf16*, int, int, int, float);

// One kernel per (padded head dim, mode): its rows a block, keys a tile,
// threads and shared memory, and the split plan's columns of O a block (0
// elsewhere).
struct Choice {
  AttnFn kernel;
  int bq, bk, threads, bytes, oc;
};

template <bool PV8, int BK>
Choice narrow() {
  using P = NarrowPlan<PV8, BK>;
  return {int8_attn_kernel<PV8, BK>, P::BQ, P::BK, P::THREADS, P::BYTES, 0};
}

template <bool PV8>
Choice wide() {
  using P = WidePlan<PV8>;
  static_assert(P::BYTES <= 232448, "shared memory per block");
  return {int8_attn_kernel_wide<PV8>, P::BQ, P::BK, P::THREADS, P::BYTES, 0};
}

template <bool PV8>
Choice split() {
  using P = SplitPlan<PV8>;
  static_assert(P::BYTES <= 232448, "shared memory per block");
  return {int8_attn_kernel_split<PV8>, P::BQ, P::BK, P::THREADS, P::BYTES, P::OC};
}

int padded_dim(int d) {
  if (d <= 0 || d % 8 != 0) return 0;
  return d <= 48 ? 48 : d <= 512 ? 512 : (d + 511) / 512 * 512;
}

// The slices of O's columns a plan's grid runs over at head dim d.
int slices_of(const Choice& c, int d) { return c.oc ? (d + c.oc - 1) / c.oc : 1; }

// A kernel's shared-memory attribute, set once per device, and its
// resident blocks per SM.
cudaError_t prepare(const Choice& c, int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  constexpr int kDevices = 16, kKernels = 7;
  static const void* seen[kDevices][kKernels];
  static int blocks[kDevices][kKernels];
  const void* key = reinterpret_cast<const void*>(c.kernel);
  int slot = -1;
  for (int i = 0; dev < kDevices && i < kKernels && slot < 0; ++i)
    if (seen[dev][i] == key || seen[dev][i] == nullptr) slot = i;
  if (slot >= 0 && seen[dev][slot] == key) {
    *per_sm = blocks[dev][slot];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, c.kernel, c.threads, c.bytes);
  if (err == cudaSuccess && slot >= 0) {
    seen[dev][slot] = key;
    blocks[dev][slot] = *per_sm;
  }
  return err;
}

// The plan at this shape. "qk" at d <= 48 has two: 64-key tiles (168
// registers, 3 blocks an SM) and 32-key tiles (128 registers, 4 blocks an
// SM, about 1.5x the time a wave); the 32-key plan where its waves are
// fewer than two thirds of the other's, as at B = 2 (512 blocks: one wave
// against two).
cudaError_t choose(int dp, bool pv8, long blocks_of_rows, Choice* c, int* per_sm) {
  if (dp > 512) {
    *c = pv8 ? split<true>() : split<false>();
    return prepare(*c, per_sm);
  }
  if (dp != 48) {
    *c = pv8 ? wide<true>() : wide<false>();
    return prepare(*c, per_sm);
  }
  if (pv8) {
    *c = narrow<true, 64>();
    return prepare(*c, per_sm);
  }
  int dev = 0, sms = 0, per64 = 0, per32 = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const Choice c64 = narrow<false, 64>(), c32 = narrow<false, 32>();
  if (err == cudaSuccess) err = prepare(c64, &per64);
  if (err == cudaSuccess) err = prepare(c32, &per32);
  if (err != cudaSuccess) return err;
  const long blocks = blocks_of_rows / c64.bq;
  const long w64 = (blocks + (long)sms * per64 - 1) / ((long)sms * per64);
  const long w32 = (blocks + (long)sms * per32 - 1) / ((long)sms * per32);
  const bool short_tiles = 3 * w32 < 2 * w64;
  *c = short_tiles ? c32 : c64;
  *per_sm = short_tiles ? per32 : per64;
  return cudaSuccess;
}

}  // namespace

// The padded head dim the kernel uses for head dim d (0 if d is not a
// multiple of 8). Three plans: head dims up to 48 pad to 48 (the UNet's
// d = 40), up to 512 to 512 (the VAE mid-block's d = 512), wider ones to a
// multiple of 512 (the split plan).
extern "C" int sdt_flash_int8_padded_dim(int d) { return padded_dim(d); }

// q, k, v, o [B, N, H, d] bf16 (self-attention, N a multiple of 1024, d a
// multiple of 8); scratch from the wrapper: qq, kq [B, H, N, dp]
// int8 and sq, sk [B, H, N] fp32; for pv8 also vq [B, H, dp, N] int8 and
// sv [B, H, N / 1024, dp] fp32; dp from sdt_flash_int8_padded_dim;
// scale_log2e is the logit scale times log2(e), rounded once to fp32 as
// sd_tpu's is. Returns the CUDA error code of the launches.
extern "C" int sdt_flash_attention_int8(const void* q, const void* k, const void* v, void* o,
                                        void* qq, void* sq, void* kq, void* sk, void* vq,
                                        void* sv, int batch, int n, int heads, int d,
                                        float scale_log2e, int pv8, void* stream) {
  const int dp = padded_dim(d);
  if (dp == 0 || n % kChunk != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long rows = (long)batch * n * heads;
  const long per_block = dp == 48 ? 256 : kQuantWarps;
  const unsigned qblocks = (unsigned)((rows + per_block - 1) / per_block);
  quant_heads_kernel<<<qblocks, kQuantWarps * 32, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<signed char*>(qq), static_cast<float*>(sq), batch,
      n, heads, d, dp);
  quant_heads_kernel<<<qblocks, kQuantWarps * 32, 0, s>>>(
      static_cast<const bf16*>(k), static_cast<signed char*>(kq), static_cast<float*>(sk), batch,
      n, heads, d, dp);
  if (pv8)
    quant_v_kernel<<<dim3(n / kChunk, (dp + kVF - 1) / kVF, batch * heads), 256, 0, s>>>(
        static_cast<const bf16*>(v), static_cast<signed char*>(vq), static_cast<float*>(sv), n,
        heads, d, dp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Choice c = {};
  int per_sm = 0;
  err = choose(dp, pv8 != 0, (long)batch * heads * n, &c, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  c.kernel<<<dim3(n / c.bq, heads * slices_of(c, d), batch), c.threads, c.bytes, s>>>(
      static_cast<const signed char*>(qq), static_cast<const float*>(sq),
      static_cast<const signed char*>(kq), static_cast<const float*>(sk),
      static_cast<const bf16*>(v), static_cast<const signed char*>(vq),
      static_cast<const float*>(sv), static_cast<bf16*>(o), n, heads, d, scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

// K5's plan at [batch, n, heads, d] in mode pv8: out = {query rows per
// block, keys per tile, threads, shared-memory bytes, resident blocks per
// SM, slices of O's columns per row tile}. Returns a CUDA error code
// (cudaErrorInvalidValue for a head dim that is not a multiple of 8).
extern "C" int sdt_flash_int8_plan(int batch, int n, int heads, int d, int pv8, int* out) {
  const int dp = padded_dim(d);
  if (dp == 0) return static_cast<int>(cudaErrorInvalidValue);
  Choice c = {};
  int blocks = 0;
  const cudaError_t err = choose(dp, pv8 != 0, (long)batch * heads * n, &c, &blocks);
  out[0] = c.bq;
  out[1] = c.bk;
  out[2] = c.threads;
  out[3] = c.bytes;
  out[4] = blocks;
  out[5] = slices_of(c, d);
  return static_cast<int>(err);
}
