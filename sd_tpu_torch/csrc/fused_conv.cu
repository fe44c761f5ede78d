// K7: fused GroupNorm-apply + SiLU + 3x3 conv (+bias, +skip, moments) for
// Hopper (sm_90a), NCHW activations and OIHW weights:
//
//   h = bf16(silu(x * A[b, c] + D[b, c]))          (h = x without A and D)
//   y = bf16(sum_{c, dy, dx} h[c, i + dy - 1, j + dx - 1] w[n, c, dy, dx]
//            + bias[n] + skip[b, n, i, j])          (fp32 accumulation)
//   m1[b, tile, n] = sum over the tile's pixels of y, m2 = of y * y (fp32)
//
// Replaces the TPU kernel `_kernel` called through `_fused_pallas` in
// sd_tpu/ops/pallas/fused_conv.py. That kernel streams halo'd row windows
// of NHWC x through VMEM and runs the conv as nine [trh*W, C] x [C, tk]
// products. Here the conv is an implicit GEMM over the port's layout:
// M = pixels, N = output channels, K = 9 * C. A block owns 128 output
// pixels of one image (8 rows by 16 columns) and 64 output channels, and
// walks C in steps of 32:
//   - the step's 10 x 18 halo window of 32 channels is read from
//     global memory (contiguous along the pixels in NCHW), the prologue is
//     applied in fp32 and h rounded to bf16 once; taps outside the image are
//     zero AFTER the prologue (SAME padding lives in the normalized domain,
//     not silu(D)). The window is stored three times, shifted by dx = 0, 1, 2
//     columns, so that every WMMA operand pointer is 32-byte aligned;
//   - the step's weights w[n0:n0+64, c:c+32, :, :] (contiguous runs of 288
//     values per n) are scattered into [tap][n][c] in shared memory;
//   - nine taps x two k-slices of bf16 WMMA m16n16k16 with fp32 accumulators
//     (8 warps, 32x32 outputs each).
// The epilogue adds bias and skip in fp32, rounds once, stores y, and with
// moments reduces y and y*y of the rounded values per channel over the
// block's pixels (fixed-order warp shuffles) into a per-tile partial that
// the wrapper sums: no float atomics, so the result does not vary between
// runs. The squares are summed in fp32; the TPU kernel rounds them to bf16
// before its sum.
//
// What bounds it on the H100: 2 * B * H * W * 9 * C * N flops against about
// 2 * (B*C*H*W + 9*C*N + 2*B*N*H*W) bytes: at the SD sites (C >= 640,
// N >= 512) it is compute bound, so the question is tensor-core feed. This
// first version has no cp.async/TMA pipeline and no wgmma; the prologue is
// recomputed once per 64 output channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TR = 8;         // output rows per block
constexpr int TW = 16;        // output columns per block (one WMMA row of pixels)
constexpr int BM = TR * TW;   // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BC = 32;        // input channels per k-step
constexpr int LDW = BC + 8;   // bf16 pitch of the weight rows [tap][n][c]
constexpr int LDS = BM + 4;   // fp32 pitch of the epilogue's [n][m] stage
constexpr int kWarps = 8;     // 4 (pixels) x 2 (channels), 32x32 each
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

__global__ void __launch_bounds__(kThreads)
fused_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ A, const float* __restrict__ D,
                  const float* __restrict__ bias, const bf16* __restrict__ skip,
                  bf16* __restrict__ y, float* __restrict__ m1, float* __restrict__ m2,
                  int C, int H, int W, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles_x = W / TW;
  const int tiles = (H / TR) * tiles_x;
  const int tile = blockIdx.x;
  const int r0 = (tile / tiles_x) * TR;
  const int q0 = (tile % tiles_x) * TW;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  constexpr int plane = (TR + 2) * TW;  // one channel of one shifted window
  constexpr int rowsz = TW + 2;         // padded columns of the halo window
  const size_t HW = (size_t)H * W;
  bf16* hs = reinterpret_cast<bf16*>(smem);  // [3 (dx)][BC][TR + 2][TW]
  bf16* ws = hs + 3 * BC * plane;             // [9][BN][LDW]
  const bf16* xb = x + (size_t)b * C * HW;

  Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int cc = 0; cc < C; cc += BC) {
    // halo window through the prologue, zero outside the image
    constexpr int window = BC * (TR + 2) * rowsz;
    for (int i = threadIdx.x; i < window; i += kThreads) {
      const int col = i % rowsz;
      const int row = (i / rowsz) % (TR + 2);
      const int c = i / (rowsz * (TR + 2));
      const int gy = r0 - 1 + row;
      const int gx = q0 - 1 + col;
      bf16 hv = __float2bfloat16(0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        hv = xb[(size_t)(cc + c) * HW + (size_t)gy * W + gx];
        if (A != nullptr) {
          const int bc = b * C + cc + c;
          const float xf = __bfloat162float(hv) * A[bc] + D[bc];
          hv = __float2bfloat16(xf * (1.f / (1.f + exp2f(xf * -kLog2e))));
        }
      }
      // padded column `col` is column col - dx of the window shifted by dx
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int cd = col - dx;
        if (cd >= 0 && cd < TW) hs[(dx * BC + c) * plane + row * TW + cd] = hv;
      }
    }
    // weights: w[n, cc:cc+BC, 3, 3] is 9 * BC contiguous values per n
    constexpr int kVecPerN = BC * 9 / 8;
    for (int i = threadIdx.x; i < BN * kVecPerN; i += kThreads) {
      const int n = i / kVecPerN;
      const int e0 = (i % kVecPerN) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + n < N)
        val = *reinterpret_cast<const uint4*>(w + ((size_t)(n0 + n) * C + cc) * 9 + e0);
      const bf16* v8 = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int ce = (e0 + e) / 9;
        const int tap = (e0 + e) % 9;
        ws[(tap * BN + n) * LDW + ce] = v8[e];
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const bf16* hsd = hs + (tap % 3) * BC * plane;
#pragma unroll
      for (int kk = 0; kk < BC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = wm * 2 + i;  // 16 pixels: one row of the tile
          wmma::load_matrix_sync(fa[i], hsd + kk * plane + (row + dy) * TW, plane);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, ws + (tap * BN + wn * 32 + j * 16) * LDW + kk, LDW);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: the accumulators to shared memory as [n][m], then each warp
  // finishes whole channels: +bias, +skip, one rounding, the moments
  float* st = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(st + (wn * 32 + j * 16) * LDS + wm * 32 + i * 16, acc[i][j], LDS,
                              wmma::mem_col_major);
  __syncthreads();
  for (int nl = warp; nl < BN; nl += kWarps) {
    const int n = n0 + nl;
    if (n >= N) break;
    const float bn = bias != nullptr ? bias[n] : 0.f;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < BM / 32; ++q) {
      const int m = lane + 32 * q;
      const size_t off = ((size_t)b * N + n) * HW + (size_t)(r0 + m / TW) * W + q0 + m % TW;
      float v = st[nl * LDS + m] + bn;
      if (skip != nullptr) v += __bfloat162float(skip[off]);
      const bf16 yb = __float2bfloat16(v);
      y[off] = yb;
      const float yf = __bfloat162float(yb);
      s1 += yf;
      s2 += yf * yf;
    }
    if (m1 != nullptr) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (lane == 0) {
        const size_t mo = ((size_t)b * tiles + tile) * N + n;
        m1[mo] = s1;
        m2[mo] = s2;
      }
    }
  }
}

}  // namespace

// x [batch, c, h, w] bf16, wt [n, c, 3, 3] bf16; a, d [batch, c] fp32 (both
// or neither null); bias [n] fp32 or null; skip [batch, n, h, w] bf16 or
// null; y [batch, n, h, w] bf16; m1, m2 [batch, tiles, n] fp32 or null, with
// tiles = (h / 8) * (w / 16). Needs h % 8 == 0, w % 16 == 0, c % 32 == 0
// and a 16-byte aligned wt; the wrapper checks. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int sdt_fused_conv3x3(const void* x, const void* wt, const void* a, const void* d,
                                 const void* bias, const void* skip, void* y, void* m1,
                                 void* m2, int batch, int c, int h, int w, int n,
                                 void* stream) {
  constexpr size_t in_bytes = (size_t)3 * BC * (TR + 2) * TW * sizeof(bf16) +
                              (size_t)9 * BN * LDW * sizeof(bf16);
  constexpr size_t out_bytes = (size_t)BN * LDS * sizeof(float);
  constexpr size_t bytes = in_bytes > out_bytes ? in_bytes : out_bytes;
  cudaError_t err = cudaFuncSetAttribute(fused_conv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((h / TR) * (w / TW), (n + BN - 1) / BN, batch);
  fused_conv_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt), static_cast<const float*>(a),
      static_cast<const float*>(d), static_cast<const float*>(bias),
      static_cast<const bf16*>(skip), static_cast<bf16*>(y), static_cast<float*>(m1),
      static_cast<float*>(m2), c, h, w, n);
  return static_cast<int>(cudaGetLastError());
}
