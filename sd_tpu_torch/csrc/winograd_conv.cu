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
// P_ij[r, s] = xpad[2r + i, 2s + j] ([B, C, H/2+1, W/2+1] here) that the
// host builds. X3 replaces the kernel of `wino_split` in
// tools/exp_winograd.py, which reads the padded input whole and splits the
// parities itself; the port's X3 reads the unpadded x and makes the SAME
// border zeros by bounds checks, so it needs no host pass at all. One
// kernel, templated on where the 4x4 tiles come from.
//
// A block owns 64 output tiles (256 output pixels, the tiles in row-major
// order over the image) and 64 output channels, and walks C in
// steps of 16: the step's V (16 transforms x 16 channels x 64 tiles) is
// computed once into shared memory and U's [16, 16, 64] slice is copied
// beside it; each of 8 warps (4 x 2, 16 tiles x 32 channels) then runs the
// 16 products V_ab U_ab as bf16 WMMA m16n16k16 into a fresh fp32 fragment,
// folds the four of each a into z0 / z1 (the A^T row combinations over b),
// and adds those into the four output accumulators Y_pq (over a). The
// transforms have coefficients 0 and +-1, so the folds are adds.
// The TPU kernel rounds V to bf16 after each of its two combination steps
// (bf16 vector arithmetic); this kernel rounds once, after both.
//
// What bounds it on the H100: the algorithm's products are
// 2 * B * (H/2) * (W/2) * 16 * C * K flops (2.25x fewer than the direct
// conv's), against about 2 * (B*C*H*W + 16*C*K + B*K*H*W) bytes; compute
// bound at the SD sites. This first version has no cp.async/TMA pipeline
// and no wgmma, and pays the output folds on the FP32 pipe every 16
// channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int WT = 64;        // output tiles per block
constexpr int WK = 64;        // output channels per block
constexpr int WC = 16;        // input channels per k-step
constexpr int LDV = WT + 8;   // bf16 pitch of V [16][WC][WT]
constexpr int LDU = WK + 8;   // bf16 pitch of U [16][WC][WK]
constexpr int LDY = WT + 4;   // fp32 pitch of the output stage [4][WK][WT]
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSmemIn = 16 * WC * (LDV + LDU) * 2;
constexpr int kSmemOut = 4 * WK * LDY * 4;
constexpr int kSmem = kSmemIn > kSmemOut ? kSmemIn : kSmemOut;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

__device__ __forceinline__ void add_frag(Acc& dst, const Acc& src, float sign) {
#pragma unroll
  for (int e = 0; e < dst.num_elements; ++e) dst.x[e] += sign * src.x[e];
}

// SPLIT: tiles from the unpadded x [B, C, H, W]; else from the parity
// planes p[0..3] = P00 P01 P10 P11, each [B, C, H/2 + 1, W/2 + 1].
template <bool SPLIT>
__global__ void __launch_bounds__(kThreads)
winograd_kernel(const bf16* __restrict__ p00, const bf16* __restrict__ p01,
                const bf16* __restrict__ p10, const bf16* __restrict__ p11,
                const bf16* __restrict__ x, const bf16* __restrict__ u,
                bf16* __restrict__ y, int C, int H, int W, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* vs = reinterpret_cast<bf16*>(smem);  // [16][WC][LDV]
  bf16* us = vs + 16 * WC * LDV;               // [16][WC][LDU]
  const int R = H / 2, S = W / 2;
  const int t0 = blockIdx.x * WT;
  const int k0 = blockIdx.y * WK;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int wt = warp / 2;  // 16 tiles wt * 16 ...
  const int wk = warp % 2;  // 32 channels wk * 32 ...
  const size_t plane = SPLIT ? (size_t)H * W : (size_t)(R + 1) * (S + 1);
  const int pw = SPLIT ? W : S + 1;

  Acc yacc[4][2];
#pragma unroll
  for (int pq = 0; pq < 4; ++pq)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(yacc[pq][j], 0.f);

  for (int c0 = 0; c0 < C; c0 += WC) {
    // input transform of WC channels x WT tiles, one (c, t) per iteration
    for (int i = threadIdx.x; i < WC * WT; i += kThreads) {
      const int t = i % WT;
      const int c = i / WT;
      const int tg = t0 + t;
      float d[4][4];
      if (tg < R * S && c0 + c < C) {
        const int r = tg / S, s = tg % S;
        const size_t base = ((size_t)b * C + c0 + c) * plane;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (SPLIT) {
              const int gy = 2 * r + ii - 1, gx = 2 * s + jj - 1;
              d[ii][jj] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                              ? __bfloat162float(x[base + (size_t)gy * W + gx])
                              : 0.f;
            } else {
              const bf16* p = (ii % 2) ? ((jj % 2) ? p11 : p10) : ((jj % 2) ? p01 : p00);
              d[ii][jj] = __bfloat162float(p[base + (size_t)(r + ii / 2) * pw + s + jj / 2]);
            }
          }
      } else {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) d[ii][jj] = 0.f;
      }
      float tr[4][4];  // B^T d
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        tr[0][jj] = d[0][jj] - d[2][jj];
        tr[1][jj] = d[1][jj] + d[2][jj];
        tr[2][jj] = d[2][jj] - d[1][jj];
        tr[3][jj] = d[1][jj] - d[3][jj];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {  // (B^T d) B
        const float v[4] = {tr[a][0] - tr[a][2], tr[a][1] + tr[a][2], tr[a][2] - tr[a][1],
                            tr[a][1] - tr[a][3]};
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
          vs[((4 * a + bb) * WC + c) * LDV + t] = __float2bfloat16(v[bb]);
      }
    }
    // U[16, C, K]: rows c0 .. c0 + WC, columns k0 .. k0 + WK (K % 8 == 0)
    for (int i = threadIdx.x; i < 16 * WC * (WK / 8); i += kThreads) {
      const int col = (i % (WK / 8)) * 8;
      const int c = (i / (WK / 8)) % WC;
      const int ab = i / (WK / 8 * WC);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (c0 + c < C && k0 + col < K)
        val = *reinterpret_cast<const uint4*>(u + ((size_t)ab * C + c0 + c) * K + k0 + col);
      *reinterpret_cast<uint4*>(us + (ab * WC + c) * LDU + col) = val;
    }
    __syncthreads();

#pragma unroll 1
    for (int a = 0; a < 4; ++a) {
      Acc z0[2], z1[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fill_fragment(z0[j], 0.f);
        wmma::fill_fragment(z1[j], 0.f);
      }
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        wmma::load_matrix_sync(fa, vs + (4 * a + bb) * WC * LDV + wt * 16, LDV);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, us + (4 * a + bb) * WC * LDU + wk * 32 + j * 16, LDU);
          Acc m;
          wmma::fill_fragment(m, 0.f);
          wmma::mma_sync(m, fa, fb, m);
          // A^T row 0 = (1, 1, 1, 0), row 1 = (0, 1, -1, -1), over b
          if (bb < 3) add_frag(z0[j], m, 1.f);
          if (bb > 0) add_frag(z1[j], m, bb == 1 ? 1.f : -1.f);
        }
      }
      // over a: Y_0q += z_q for a < 3; Y_1q += z_q (a = 1), -z_q (a = 2, 3)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (a < 3) {
          add_frag(yacc[0][j], z0[j], 1.f);
          add_frag(yacc[1][j], z1[j], 1.f);
        }
        if (a > 0) {
          const float sign = a == 1 ? 1.f : -1.f;
          add_frag(yacc[2][j], z0[j], sign);
          add_frag(yacc[3][j], z1[j], sign);
        }
      }
    }
    __syncthreads();
  }

  // Y_pq [t][k] -> shared [pq][k][t], then y[b, k, 2r + p, 2s + q] as bf16 pairs
  float* st = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int pq = 0; pq < 4; ++pq)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(st + (pq * WK + wk * 32 + j * 16) * LDY + wt * 16, yacc[pq][j],
                              LDY, wmma::mem_col_major);
  __syncthreads();
  for (int i = threadIdx.x; i < WK * 2 * WT; i += kThreads) {
    const int t = i % WT;
    const int p = (i / WT) % 2;
    const int kl = i / (2 * WT);
    const int tg = t0 + t;
    if (tg >= R * S || k0 + kl >= K) continue;
    const int r = tg / S, s = tg % S;
    __nv_bfloat162 pair;
    pair.x = __float2bfloat16(st[((2 * p) * WK + kl) * LDY + t]);
    pair.y = __float2bfloat16(st[((2 * p + 1) * WK + kl) * LDY + t]);
    const size_t off = (((size_t)b * K + k0 + kl) * H + 2 * r + p) * W + 2 * s;
    *reinterpret_cast<__nv_bfloat162*>(y + off) = pair;
  }
}

template <bool SPLIT>
int launch(const void* const* planes, const void* x, const void* u, void* y, int batch, int c,
           int h, int w, int k, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(winograd_kernel<SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (h / 2) * (w / 2);
  dim3 grid((tiles + WT - 1) / WT, (k + WK - 1) / WK, batch);
  winograd_kernel<SPLIT><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(planes[0]), static_cast<const bf16*>(planes[1]),
      static_cast<const bf16*>(planes[2]), static_cast<const bf16*>(planes[3]),
      static_cast<const bf16*>(x), static_cast<const bf16*>(u), static_cast<bf16*>(y), c, h, w,
      k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8 (split = 0): p00..p11 the parity planes [batch, c, h/2 + 1, w/2 + 1],
// x null. X3 (split = 1): x [batch, c, h, w], planes null. u [16, c, k]
// bf16 (G w G^T), y [batch, k, h, w] bf16. Needs h, w even and k % 8 == 0
// with 16-byte aligned u; the wrapper checks. Returns the CUDA error code
// of the launch (0 on success).
extern "C" int sdt_winograd_conv3x3(const void* p00, const void* p01, const void* p10,
                                    const void* p11, const void* x, const void* u, void* y,
                                    int batch, int c, int h, int w, int k, int split,
                                    void* stream) {
  const void* planes[4] = {p00, p01, p10, p11};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return split ? launch<true>(planes, x, u, y, batch, c, h, w, k, s)
               : launch<false>(planes, x, u, y, batch, c, h, w, k, s);
}
