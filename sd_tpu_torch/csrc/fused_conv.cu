// K7: fused GroupNorm-apply + SiLU + 3x3 conv (+bias, +skip, moments) for
// Hopper (sm_90a), NCHW activations:
//
//   h = bf16(silu(x * A[b, c] + D[b, c]))          (h = x without A and D)
//   y = bf16(sum_{c, dy, dx} h[c, i + dy - 1, j + dx - 1] w[n, c, dy, dx]
//            + bias[n] + skip[b, n, i, j])          (fp32 accumulation)
//   m1[b, tile, n] = sum over the tile's pixels of y, m2 = of y * y (fp32)
//
// Taps outside the image read 0 AFTER the prologue (SAME padding lives in
// the normalized domain, not silu(D)).
//
// Replaces the TPU kernel `_kernel` called through `_fused_pallas` in
// sd_tpu/ops/pallas/fused_conv.py. That kernel streams halo'd row windows
// of NHWC x through VMEM and runs the conv as nine [trh*W, C] x [C, tk]
// products. Here the conv is an implicit GEMM: M = the 8 x 16 output pixels
// of a block, N = 128 output channels a block, K = 9 * C, walked in steps
// of 64 input channels.
//
// What bounds it on the H100: 2 * B * H * W * 9 * C * N flops against about
// 2 * (B*C*H*W + 9*C*N + 2*B*N*H*W) bytes: at the SD sites (C >= 256,
// N >= 256) it is compute bound (989 TFLOP/s bf16 dense), so the design is
// about keeping the tensor cores fed, and the prologue (an exp-class
// function of every input element) off their path.
//
// Design. One block of 16 warps: a producer warp, seven prologue warps and
// two consumer warpgroups (8 output columns each, all 8 rows: 64 pixels,
// one wgmma row block).
//   - Weights: repacked once per weight (the wrapper caches it) into
//     wk [9, N, C], K-major rows of each tap; warp 0 copies the [128 x 64]
//     tile of each (step, tap) by TMA (128-byte swizzled) into a ring of
//     mbarrier-guarded stages.
//   - Window: the prologue warps copy each step's raw x [64 c][10 rows]
//     [32 cols] (NCHW rows r0-1 .. r0+8, columns q0-8 .. q0+23: 16-byte
//     cp.async, zero-filled outside the image) into one of two staging
//     buffers, a step ahead, then apply the prologue ONCE per element and
//     block: ldmatrix.trans reads 8 channels x 8 pixels of the tile's own
//     16 columns, the fp32 affine + SiLU rounds h to bf16, pixels outside
//     the image become 0, and stmatrix writes them channel-last into a
//     two-deep window ring, 10 rows of 25 pixels (columns q0-8 .. q0+16),
//     one 128-byte row a pixel with its 16-byte chunks XOR-swizzled by the
//     pixel index (the swizzle wgmma and TMA use); the halo columns q0-1
//     and q0+16 go the same way a channel pair at a time. So each input
//     element goes through the prologue N / 128 times in all, and the
//     transpose costs nothing beyond it.
//   - Products: wgmma.mma_async m64n128k16, bf16 in, fp32 accumulators in
//     registers, both operands K-major from shared memory. The nine taps
//     are shifted views of the window: the A descriptor of tap (dy, dx)
//     starts at window pixel dy * 25 + 7 + dx (+ 8 for the second
//     warpgroup), with 8 pixels a row of atoms and the 25-pixel row pitch
//     as the stride between atoms. The hardware applies the 128-byte
//     swizzle to the addresses it computes, as it does for the k16 steps
//     inside an atom, so one copy of the window serves all nine taps with
//     no base offset in the descriptor. This is the "swizzle-compatible
//     window layout" of the three ways round a shifted operand: shifted
//     copies would triple the prologue's stores and the window's shared
//     memory, and A in registers would tie the fragments to each wgmma
//     until it completes.
//   - Overlap: the staging, window and weight rings are at least two deep,
//     so step t + 1's copies and prologue run while step t multiplies.
//   - Split over C: where the output tiles cannot fill the SMs, the steps
//     are split over blocks (`choose`), each writing fp32 partial sums
//     [split, B, N, H, W]; fused_conv_reduce_kernel adds them in split
//     order and applies bias, skip, the rounding and the moments once.
// The epilogue stages the accumulators as [n][pixel] fp32 in the freed
// buffers; two threads finish a channel: +bias, +skip, one rounding,
// 16-byte stores of 8 pixels, and the moments of the rounded values over
// their pixels in a fixed order into a per-tile partial that the wrapper
// sums: no float atomics, so the moments do not vary between runs. The
// squares are summed in fp32; the TPU kernel rounds them to bf16 first.
// The SiLU is tanh.approx's (x / 2 (1 + tanh(x / 2))) in fp32, then h is
// rounded to bf16.
//
// Needs C % 64 == 0, H % 8 == 0, W % 16 == 0, N % 8 == 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "tma.cuh"

using sdt::bf16;

namespace {

constexpr int TR = 8;          // output rows a block
constexpr int TW = 16;         // output columns a block: 8 a consumer warpgroup
constexpr int BN = 128;        // output channels a block
constexpr int BC = 64;         // input channels a step: one 128-byte row of bf16
constexpr int WR = TR + 2;     // rows of the halo window
constexpr int XC = 32;         // columns of a staged x row: q0-8 .. q0+23, four 16-byte chunks
constexpr int XPITCH = WR * XC * 2;  // bytes of a staged channel
constexpr int XBOX = BC * XPITCH;    // a step's staged x, [BC][WR][XC] bf16, chunks swizzled
// The window keeps columns q0-8 .. q0+16 (25 pixels a row, of which the
// taps read q0-1 .. q0+16): [WR][25] pixels of 128 bytes
constexpr int WP = 25;
constexpr int WIN = WR * WP * 128;
constexpr int WIN_ROOM = (WIN + 1023) / 1024 * 1024;
constexpr int THREADS = 512;   // a producer warp, 7 prologue warps, two consumer warpgroups
constexpr int PRO_WARPS = 7;
constexpr int LDS = TR * TW + 4;     // fp32 pitch of the epilogue's [n][pixel] tile
constexpr int SMEM_MAX = 232448;
constexpr int BSTAGE = BN * BC * 2;  // a weight tile

// Shared memory: two x staging buffers, two windows, the weight ring (as
// many stages as fit), the mbarriers, plus slack to align the base to 1024
// bytes. The epilogue's [BN][LDS] fp32 tile reuses the buffers.
struct Smem {
  static constexpr int XS = 0;
  static constexpr int WS = 2 * XBOX;
  static constexpr int RING = WS + 2 * WIN_ROOM;
  static constexpr int STAGES = (SMEM_MAX - 1024 - 256 - RING) / BSTAGE;
  static constexpr int BARS = RING + STAGES * BSTAGE;
  static constexpr int BYTES = BARS + 256 + 1024;
  static_assert(XBOX % 1024 == 0 && STAGES >= 3 && BN * LDS * 4 <= BARS && BYTES <= SMEM_MAX,
                "shared memory");
};

// The byte offset of 16-byte chunk `seg` of row r of channel c in a staged
// step: its position in the channel's 40 chunks XOR c % 8, so that the 8
// channel rows one ldmatrix reads fall in 8 different bank groups.
__device__ __forceinline__ int staged(int c, int r, int seg) {
  return c * XPITCH + (((r * (XC / 8) + seg) ^ (c & 7)) * 16);
}

// Four 8x8 b16 matrices to shared memory; lane i gives the address of row
// i % 8 of matrix i / 8, and holds (row i / 4, columns 2 (i % 4) ..) of each.
__device__ __forceinline__ void stmatrix_x4(void* p, const unsigned (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   sdt::smem_addr(p)),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// Whether window pixel (gy, gx) lies in the image: the prologue writes 0
// where it does not (SAME padding of h).
__device__ __forceinline__ bool in_image(int gy, int gx, int H, int W) {
  return gy >= 0 && gy < H && gx >= 0 && gx < W;
}

// silu(v) = v sigmoid(v) = v / 2 (1 + tanh(v / 2)), on the special-function unit
__device__ __forceinline__ float silu(float v) {
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(0.5f * v));
  const float hv = 0.5f * v;
  return fmaf(hv, t, hv);
}

// 16 fp32 sums of one (n, output row) of the tile plus bias and skip,
// rounded once: stored as 16 bf16 at y_row, their moments added to s1, s2.
__device__ __forceinline__ void finish_row(const float (&v)[16], float bn, const bf16* skip_row,
                                           bf16* y_row, float& s1, float& s2) {
  float sk[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) sk[i] = 0.f;
  if (skip_row != nullptr) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint4 raw = *reinterpret_cast<const uint4*>(skip_row + 8 * hh);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) sk[8 * hh + i] = __bfloat162float(e[i]);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    unsigned packed[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 8 * hh + 2 * i;
      const bf16 lo = __float2bfloat16((v[k] + bn) + sk[k]);
      const bf16 hi = __float2bfloat16((v[k + 1] + bn) + sk[k + 1]);
      const float fl = __bfloat162float(lo), fh = __bfloat162float(hi);
      s1 += fl;
      s1 += fh;
      s2 += fl * fl;
      s2 += fh * fh;
      packed[i] = (unsigned)__bfloat16_as_ushort(lo) | (unsigned)__bfloat16_as_ushort(hi) << 16;
    }
    *reinterpret_cast<uint4*>(y_row + 8 * hh) = make_uint4(packed[0], packed[1], packed[2],
                                                           packed[3]);
  }
}

// grid (tiles of an image, n tiles x splits, batch). Without a split the
// block writes y and (m1 != null) its tile's moments; with one, its fp32
// partial sums into ws [split, batch, N, H, W].
__global__ void __launch_bounds__(THREADS, 1)
fused_conv_kernel(const __grid_constant__ CUtensorMap mw, const bf16* __restrict__ x,
                  const float* __restrict__ A, const float* __restrict__ D,
                  const float* __restrict__ bias, const bf16* __restrict__ skip,
                  bf16* __restrict__ y, float* __restrict__ m1, float* __restrict__ m2,
                  float* __restrict__ ws, int C, int H, int W, int N, int splits,
                  int chunks_per_split) {
  using S = Smem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (sdt::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::BARS);
  uint64_t* empty = full + S::STAGES;
  uint64_t* win_full = empty + S::STAGES;  // [2]
  uint64_t* win_empty = win_full + 2;      // [2]

  const int tiles_x = W / TW;
  const int tile = blockIdx.x;
  const int r0 = (tile / tiles_x) * TR;
  const int q0 = (tile % tiles_x) * TW;
  const int split = blockIdx.y % splits;
  const int n0 = (blockIdx.y / splits) * BN;
  const int b = blockIdx.z;
  const int ch0 = split * chunks_per_split;
  const int nch = min(C / BC, ch0 + chunks_per_split) - ch0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      sdt::mbar_init(&full[s], 1);
      sdt::mbar_init(&empty[s], 8);  // the consumer warps
    }
    for (int s = 0; s < 2; ++s) {
      sdt::mbar_init(&win_full[s], PRO_WARPS);
      sdt::mbar_init(&win_empty[s], 8);
    }
    sdt::mbar_init_fence();
  }
  __syncthreads();

  const int warp_id = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp_id == 0) {
    // the weights: the tap-major tiles of each step
    if (lane == 0) {
      int stage = 0, phase = 0;
      for (int i = 0; i < nch; ++i) {
        for (int tap = 0; tap < 9; ++tap) {
          sdt::mbar_wait(&empty[stage], phase ^ 1);
          sdt::mbar_expect_tx(&full[stage], BSTAGE);
          sdt::tma_load_2d(base + S::RING + stage * BSTAGE, &mw, (ch0 + i) * BC, tap * N + n0,
                           &full[stage]);
          if (++stage == S::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  if (warp_id <= PRO_WARPS) {
    // the prologue: a step's raw x by cp.async into a staging buffer (16
    // bytes at a time, zero-filled outside the image) one step ahead, then
    // h into the window
    const int pw = warp_id - 1;
    const int pt = threadIdx.x - 32;
    const float* Ab = A != nullptr ? A + (size_t)b * C : nullptr;
    const float* Db = D != nullptr ? D + (size_t)b * C : nullptr;
    auto stage_x = [&](int step) {
      const bf16* xb = x + ((size_t)b * C + (ch0 + step) * BC) * H * W;
      unsigned char* xs = base + S::XS + (step & 1) * XBOX;
      for (int i = pt; i < BC * WR * (XC / 8); i += PRO_WARPS * 32) {
        const int seg = i % (XC / 8), r = (i / (XC / 8)) % WR, c = i / (WR * (XC / 8));
        const int gy = r0 - 1 + r, gx = q0 - 8 + seg * 8;
        const bool valid = gy >= 0 && gy < H && gx >= 0 && gx < W;
        sdt::cp_async16(xs + staged(c, r, seg), valid ? xb + ((size_t)c * H + gy) * W + gx : x,
                        valid);
      }
      sdt::cp_async_commit();
    };
    stage_x(0);
    for (int i = 0; i < nch; ++i) {
      const int s = i & 1;
      sdt::cp_async_wait<0>();
      // step i's x is in, from every thread, and every prologue warp is done
      // with step i - 1's staging buffer, which step i + 1 takes
      sdt::named_sync(4, PRO_WARPS * 32);
      if (i + 1 < nch) stage_x(i + 1);
      sdt::mbar_wait(&win_empty[s], ((i >> 1) & 1) ^ 1);
      const unsigned char* xs = base + S::XS + s * XBOX;
      unsigned char* win = base + S::WS + s * WIN_ROOM;
      const int cbase = (ch0 + i) * BC;
      // the tile's own columns q0 .. q0+15 (window pixels 8 .. 23), items of
      // (window row, 8-pixel segment, 32-channel half)
      for (int it = pw; it < WR * 2 * 2; it += PRO_WARPS) {
        const int half = it & 1, seg = 1 + ((it >> 1) & 1), r = it >> 2;
        unsigned v[4];
        const int cl = half * 32 + lane;  // lane i: row i % 8 of matrix i / 8
        sdt::ldmatrix_x4_trans(v, xs + staged(cl, r, seg));
        // v[mi] holds channels half * 32 + mi * 8 + 2 (lane % 4) + {0, 1}
        // of pixel seg * 8 + lane / 4 of window row r
        const bool inside = in_image(r0 - 1 + r, q0 - 8 + seg * 8 + lane / 4, H, W);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          if (!inside) {
            v[mi] = 0u;
          } else if (Ab != nullptr) {
            const int c = cbase + half * 32 + mi * 8 + 2 * (lane % 4);
            const float2 a = *reinterpret_cast<const float2*>(Ab + c);
            const float2 d = *reinterpret_cast<const float2*>(Db + c);
            const __nv_bfloat162 raw = *reinterpret_cast<const __nv_bfloat162*>(&v[mi]);
            v[mi] = sdt::pack_bf16(silu(__low2float(raw) * a.x + d.x),
                                   silu(__high2float(raw) * a.y + d.y));
          }
        }
        const int p = r * WP + seg * 8 + (lane % 8);  // lane i: row i % 8 of matrix i / 8
        const int chunk = half * 4 + lane / 8;
        stmatrix_x4(win + p * 128 + ((chunk ^ (p & 7)) * 16), v);
      }
      // the halo columns q0-1 and q0+16 (window pixels 7 and 24): a channel
      // pair of one pixel a thread
      for (int u = pt; u < WR * (BC / 2) * 2; u += PRO_WARPS * 32) {
        const int j = (u & 1) ? 24 : 7, cp = (u >> 1) % (BC / 2), r = u / BC;
        unsigned val = 0u;
        if (in_image(r0 - 1 + r, q0 - 8 + j, H, W)) {
          const unsigned char* src = xs + (j % 8) * 2;
          const float lo = __bfloat162float(
              *reinterpret_cast<const bf16*>(src + staged(2 * cp, r, j / 8)));
          const float hi = __bfloat162float(
              *reinterpret_cast<const bf16*>(src + staged(2 * cp + 1, r, j / 8)));
          if (Ab != nullptr) {
            const float2 a = *reinterpret_cast<const float2*>(Ab + cbase + 2 * cp);
            const float2 d = *reinterpret_cast<const float2*>(Db + cbase + 2 * cp);
            val = sdt::pack_bf16(silu(lo * a.x + d.x), silu(hi * a.y + d.y));
          } else {
            val = sdt::pack_bf16(lo, hi);
          }
        }
        const int p = r * WP + j;
        *reinterpret_cast<unsigned*>(win + p * 128 + (((cp / 4) ^ (p & 7)) * 16) + (cp % 4) * 4) =
            val;
      }
      sdt::fence_proxy_async();  // h, written here, is read by wgmma
      __syncwarp();
      if (lane == 0) sdt::mbar_arrive(&win_full[s]);
    }
    return;
  }

  // consumers: warpgroup cw owns output columns q0 + 8 cw .. + 7, all 8 rows
  const int cw = threadIdx.x / 128 - 2;
  const int warp = warp_id % 4;
  const int g = lane / 4, t = lane % 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int stage = 0, phase = 0, prev = -1, prev_win = -1;
  for (int i = 0; i < nch; ++i) {
    const int s = i & 1;
    sdt::mbar_wait(&win_full[s], (i >> 1) & 1);
    // pixel 8 of a window row is column q0 of the image
    const unsigned char* win = base + S::WS + s * WIN_ROOM + (8 * cw + 7) * 128;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      sdt::mbar_wait(&full[stage], phase);
      // tap (dy, dx) of the warpgroup's 8 x 8 pixels: 8 atoms of 8 pixels,
      // one a window row; the hardware swizzles the addresses it computes,
      // so a start a few 128-byte rows past a 1024-byte boundary is read as
      // the prologue wrote it
      const unsigned char* wa = win + (dy * WP + dx) * 128;
      const unsigned char* wb = base + S::RING + stage * BSTAGE;
      sdt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)
        sdt::wgmma_bf16_k<BN>(acc, sdt::wgmma_desc<128>(wa + kk * 32, WP * 128),
                              sdt::wgmma_desc<128>(wb + kk * 32, 1024), 1);
      sdt::wgmma_commit();
      // the batch before this one is done: its weight stage (and, after a
      // step's last tap, its window) goes back to the producers
      sdt::wgmma_wait<1>();
      if (lane == 0 && prev >= 0) sdt::mbar_arrive(&empty[prev]);
      if (lane == 0 && prev_win >= 0) sdt::mbar_arrive(&win_empty[prev_win]);
      prev_win = tap == 8 ? s : -1;
      prev = stage;
      if (++stage == S::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  sdt::wgmma_wait<0>();
  sdt::fence_regs(acc);

  // the accumulators as [n][pixel] fp32 over the buffers, once both
  // warpgroups are done with them
  float* st = reinterpret_cast<float*>(base);
  sdt::named_sync(2, 256);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int px = (2 * warp + hh) * TW + 8 * cw + g;
      st[(8 * j + 2 * t) * LDS + px] = acc[4 * j + 2 * hh];
      st[(8 * j + 2 * t + 1) * LDS + px] = acc[4 * j + 2 * hh + 1];
    }
  sdt::named_sync(2, 256);

  // two threads a channel: rows sub, sub + 2, .. of channel n0 + nl
  const int ctid = threadIdx.x - 256;
  const int nl = ctid / 2, sub = ctid % 2;
  const int n = n0 + nl;
  const size_t HW = (size_t)H * W;
  float s1 = 0.f, s2 = 0.f;
  if (n < N) {
    const float bn = bias != nullptr ? bias[n] : 0.f;
    for (int r = sub; r < TR; r += 2) {
      const float* src = st + nl * LDS + r * TW;
      const size_t off = ((size_t)b * N + n) * HW + (size_t)(r0 + r) * W + q0;
      float v[16];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 q = *reinterpret_cast<const float4*>(src + 4 * k);
        v[4 * k] = q.x;
        v[4 * k + 1] = q.y;
        v[4 * k + 2] = q.z;
        v[4 * k + 3] = q.w;
      }
      if (splits > 1) {
        float* dst = ws + (size_t)split * gridDim.z * N * HW + off;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          *reinterpret_cast<float4*>(dst + 4 * k) =
              make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
      } else {
        finish_row(v, bn, skip != nullptr ? skip + off : nullptr, y + off, s1, s2);
      }
    }
  }
  if (splits == 1 && m1 != nullptr) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
    if (n < N && sub == 0) {
      const size_t mo = ((size_t)b * gridDim.x + tile) * N + n;
      m1[mo] = s1;
      m2[mo] = s2;
    }
  }
}

// After a split over C: y = bf16(sum over splits of ws + bias + skip), in
// split order, and each tile's moments. grid (tiles of an image, N / 32
// rounded up, batch); thread: channel blockIdx.y * 32 + tid / 8, row tid % 8.
__global__ void __launch_bounds__(256)
fused_conv_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                         const bf16* __restrict__ skip, bf16* __restrict__ y,
                         float* __restrict__ m1, float* __restrict__ m2, int N, int H, int W,
                         int splits) {
  const int tiles_x = W / TW;
  const int tile = blockIdx.x;
  const int r0 = (tile / tiles_x) * TR, q0 = (tile % tiles_x) * TW;
  const int b = blockIdx.z;
  const int n = blockIdx.y * 32 + threadIdx.x / 8;
  const int r = threadIdx.x % 8;
  const size_t HW = (size_t)H * W;
  float s1 = 0.f, s2 = 0.f;
  if (n < N) {
    const size_t off = ((size_t)b * N + n) * HW + (size_t)(r0 + r) * W + q0;
    const size_t plane = (size_t)gridDim.z * N * HW;
    float v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = 0.f;
    for (int sp = 0; sp < splits; ++sp)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 q = *reinterpret_cast<const float4*>(ws + sp * plane + off + 4 * k);
        v[4 * k] += q.x;
        v[4 * k + 1] += q.y;
        v[4 * k + 2] += q.z;
        v[4 * k + 3] += q.w;
      }
    finish_row(v, bias != nullptr ? bias[n] : 0.f, skip != nullptr ? skip + off : nullptr,
               y + off, s1, s2);
  }
  if (m1 == nullptr) return;
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  if (n < N && r == 0) {
    const size_t mo = ((size_t)b * gridDim.x + tile) * N + n;
    m1[mo] = s1;
    m2[mo] = s2;
  }
}

// A plan: the splits over C, the 64-channel steps a split takes and the
// blocks launched.
struct Plan {
  int splits, chunks_per_split, blocks;
};

// The least estimated time over the splits: blocks run in waves of one an
// SM; a block's steps each take its products at an SM's share of the bf16
// peak at 60% plus a fixed cost a block; a split adds its partial sums'
// round trip and the reduction's launch.
cudaError_t choose(int batch, int c, int h, int w, int n, Plan* best) {
  if (batch <= 0 || c <= 0 || c % BC || h % TR || w % TW || n <= 0 || n % 8)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int chunks = c / BC;
  const int tiles = batch * (h / TR) * (w / TW) * ((n + BN - 1) / BN);
  const double t_step = 2.0 * TR * TW * BN * 9 * BC / (989e12 / sms * 0.6);
  double best_t = 1e30;
  for (int splits = 1; splits <= chunks && splits <= 16; ++splits) {
    const int cps = (chunks + splits - 1) / splits;
    if ((chunks + cps - 1) / cps != splits) continue;  // a split with no step
    const int blocks = tiles * splits;
    const int waves = (blocks + sms - 1) / sms;
    double t = waves * (cps * t_step + 2e-6);
    if (splits > 1) t += (double)splits * batch * n * h * w * 4 * 2 / 3.35e12 + 3e-6;
    if (t < best_t) {
      best_t = t;
      *best = {splits, cps, blocks};
    }
  }
  return cudaSuccess;
}

}  // namespace

// K7's plan at this shape: out = {output rows a block, output columns a
// block, output channels a block, weight stages, splits over C, 64-channel
// steps a split, blocks launched, shared memory bytes}, 8 values. Returns a
// CUDA error code.
extern "C" int sdt_fused_conv_plan(int batch, int c, int h, int w, int n, int* out) {
  Plan p;
  const cudaError_t err = choose(batch, c, h, w, n, &p);
  if (err == cudaSuccess) {
    const int vals[8] = {TR, TW, BN, Smem::STAGES, p.splits, p.chunks_per_split, p.blocks,
                         Smem::BYTES};
    for (int j = 0; j < 8; ++j) out[j] = vals[j];
  }
  return static_cast<int>(err);
}

// x [batch, c, h, w] bf16; wk [9, n, c] bf16 (the taps of OIHW w, K-major);
// a, d [batch, c] fp32 (both or neither null); bias [n] fp32 or null; skip
// [batch, n, h, w] bf16 or null; y [batch, n, h, w] bf16; m1, m2 [batch,
// tiles, n] fp32 or null, with tiles = (h / 8) * (w / 16); ws fp32
// [splits, batch, n, h, w] where the plan splits over C (else null). All 16-byte
// aligned. Needs c % 64 == 0, h % 8 == 0, w % 16 == 0, n % 8 == 0; the
// wrapper checks. Returns the CUDA error code of the launches (0 on success).
extern "C" int sdt_fused_conv3x3(const void* x, const void* wk, const void* a, const void* d,
                                 const void* bias, const void* skip, void* y, void* m1,
                                 void* m2, void* ws, int batch, int c, int h, int w, int n,
                                 void* stream) {
  Plan p;
  cudaError_t err = choose(batch, c, h, w, n, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.splits > 1 && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mw;
  err = sdt::matrix_map(&mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wk, 9 * n, c, BC, BN);
  if (err == cudaSuccess)
    err = sdt::smem_limit(reinterpret_cast<const void*>(fused_conv_kernel), Smem::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (h / TR) * (w / TW);
  const int ntiles = (n + BN - 1) / BN;
  fused_conv_kernel<<<dim3(tiles, ntiles * p.splits, batch), THREADS, Smem::BYTES, s>>>(
      mw, static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(d),
      static_cast<const float*>(bias), static_cast<const bf16*>(skip), static_cast<bf16*>(y),
      static_cast<float*>(m1), static_cast<float*>(m2), static_cast<float*>(ws), c, h, w, n,
      p.splits, p.chunks_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  fused_conv_reduce_kernel<<<dim3(tiles, (n + 31) / 32, batch), 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<const bf16*>(skip), static_cast<bf16*>(y), static_cast<float*>(m1),
      static_cast<float*>(m2), n, h, w, p.splits);
  return static_cast<int>(cudaGetLastError());
}
