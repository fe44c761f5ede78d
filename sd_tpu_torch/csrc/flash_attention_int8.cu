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
// 1024-key chunks held in VMEM, and in qkpv mode the chunk is part of the
// function: P is quantized against the max after the chunk, and V's scales
// are per chunk. Here a block's key tiles are 64 (32 at d > 160) keys, so
// each chunk takes two passes over its key tiles: the first recomputes the
// int8 logits only for each row's chunk max, the second forms P against it
// and accumulates P V. Both modes use that schedule, so the softmax's
// reference max is the TPU kernel's in both. Three launches:
//   1. Q and K quantized per row into [B, H, N, DP] int8 codes (d zero-padded
//      to DP, 40 -> 48) with fp32 [B, H, N] scales (one launch each);
//   2. (qkpv) V quantized per feature and 1024-key chunk into [B, H, N, DP]
//      codes with [B, H, N / 1024, DP] scales;
//   3. the attention, one block per (q tile, head, batch).
//
// What bounds it on the H100: at the UNet's N = 4096, d = 40 sites the
// products are 4 N^2 d operations per head against N d bytes, so they are
// operation bound, with the logits now int8 (twice the bf16 rate, computed
// twice) and P V in bf16. WMMA m16n16k16 (signed char, int32 accumulate;
// bf16 for P V in qk mode), logits and accumulators in shared memory, no
// cp.async/TMA pipeline and no wgmma yet. Int8 fragments are read from
// 16-column slabs (int8_gemm.cuh says why).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kChunk = 1024;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ float quant_scale(float amax) { return fmaxf(amax / 127.f, 1e-12f); }

__device__ __forceinline__ signed char quant(float x, float s) {
  return static_cast<signed char>(fminf(fmaxf(rintf(x / s), -127.f), 127.f));
}

__device__ __forceinline__ int slab(int r, int c, int rows) {
  return ((c >> 4) * rows + r) * 16 + (c & 15);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// x [B, N, H, d] bf16 -> codes [B, H, N, dp] (zero-padded), scales [B, H, N];
// one warp per (b, n, h) row
__global__ void __launch_bounds__(kThreads)
quant_heads_kernel(const bf16* __restrict__ x, signed char* __restrict__ xq,
                   float* __restrict__ sx, int batch, int n, int heads, int d, int dp) {
  const long row = (long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long)batch * n * heads) return;
  const int h = row % heads;
  const int t = (row / heads) % n;
  const int b = row / ((long)heads * n);
  const bf16* src = x + row * d;
  float amax = 0.f;
  for (int c = lane; c < d; c += 32) amax = fmaxf(amax, fabsf(__bfloat162float(src[c])));
  const float s = quant_scale(warp_max(amax));
  const size_t out_row = ((size_t)b * heads + h) * n + t;
  if (lane == 0) sx[out_row] = s;
  for (int c = lane; c < dp; c += 32)
    xq[out_row * dp + c] = c < d ? quant(__bfloat162float(src[c]), s) : 0;
}

// v [B, N, H, d] -> codes [B, H, N, dp], scales [B, H, N / 1024, dp]: per
// feature over each 1024-key chunk; grid (chunks, heads, batch)
__global__ void __launch_bounds__(kThreads)
quant_v_kernel(const bf16* __restrict__ v, signed char* __restrict__ vq,
               float* __restrict__ sv, int n, int heads, int d, int dp) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nchunks = n / kChunk;
  const size_t stride = (size_t)heads * d;
  const bf16* src = v + ((size_t)b * n + (size_t)c * kChunk) * stride + (size_t)h * d;
  signed char* dst = vq + (((size_t)b * heads + h) * n + (size_t)c * kChunk) * dp;
  for (int f = threadIdx.x; f < dp; f += kThreads) {
    float amax = 0.f;
    if (f < d)
      for (int t = 0; t < kChunk; ++t) amax = fmaxf(amax, fabsf(__bfloat162float(src[t * stride + f])));
    const float s = quant_scale(amax);
    sv[(((size_t)b * heads + h) * nchunks + c) * dp + f] = s;
    for (int t = 0; t < kChunk; ++t)
      dst[(size_t)t * dp + f] = f < d ? quant(__bfloat162float(src[t * stride + f]), s) : 0;
  }
}

// Shared-memory plan of the attention block (bytes, 128-aligned sections)
template <int BQ, int BKT, int DP, bool PV8>
struct Smem {
  static constexpr int LDS = BKT + 4;  // int/fp32 pitch of the logits
  static constexpr int LDP = BKT + 8;  // bf16 pitch of P (qk)
  static constexpr int LDV = DP + 8;   // bf16 pitch of V (qk)
  static constexpr int LDO = DP + 4;   // fp32/int pitch of the accumulators
  static constexpr int Q = 0;
  static constexpr int K = round_up(Q + BQ * DP, 128);
  static constexpr int S = round_up(K + BKT * DP, 128);
  static constexpr int P = round_up(S + BQ * LDS * 4, 128);
  static constexpr int V = round_up(P + (PV8 ? BQ * BKT : BQ * LDP * 2), 128);
  static constexpr int O = round_up(V + (PV8 ? BKT * DP : BKT * LDV * 2), 128);
  static constexpr int OI = round_up(O + BQ * LDO * 4, 128);
  static constexpr int ROW = round_up(OI + (PV8 ? BQ * LDO * 4 : 0), 128);
  // per row: sq * scale * log2 e, running max, running sum, chunk max
  static constexpr int SK = ROW + 4 * BQ * 4;
  static constexpr int BYTES = SK + BKT * 4;
};

template <int BQ, int BKT, int DP, bool PV8>
__global__ void __launch_bounds__(kThreads)
flash_int8_kernel(const signed char* __restrict__ qq, const float* __restrict__ sq,
                  const signed char* __restrict__ kq, const float* __restrict__ sk,
                  const bf16* __restrict__ v, const signed char* __restrict__ vq,
                  const float* __restrict__ sv, bf16* __restrict__ o, int n, int heads,
                  int d, float scale_log2e) {
  using L = Smem<BQ, BKT, DP, PV8>;
  static_assert(BQ % 16 == 0 && BKT % 32 == 0 && DP % 16 == 0 && kChunk % BKT == 0, "tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  signed char* qs = reinterpret_cast<signed char*>(smem + L::Q);
  signed char* ks = reinterpret_cast<signed char*>(smem + L::K);
  int* si = reinterpret_cast<int*>(smem + L::S);
  unsigned char* pbuf = smem + L::P;
  unsigned char* vbuf = smem + L::V;
  float* os = reinterpret_cast<float*>(smem + L::O);
  int* oi = reinterpret_cast<int*>(smem + L::OI);
  float* sqp = reinterpret_cast<float*>(smem + L::ROW);
  float* ms = sqp + BQ;
  float* ls = ms + BQ;
  float* mc = ls + BQ;
  float* skt = reinterpret_cast<float*>(smem + L::SK);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * heads + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  constexpr int TQ = BQ / 16, TK = BKT / 16, TD = DP / 16;

  for (int i = threadIdx.x; i < BQ * DP / 16; i += kThreads) {
    const int r = i / (DP / 16), c = (i % (DP / 16)) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < n) val = *reinterpret_cast<const uint4*>(qq + (bh * n + q0 + r) * DP + c);
    *reinterpret_cast<uint4*>(qs + slab(r, c, BQ)) = val;
  }
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    sqp[r] = q0 + r < n ? sq[bh * n + q0 + r] * scale_log2e : 0.f;
    ms[r] = -INFINITY;
    ls[r] = 0.f;
  }
  for (int i = threadIdx.x; i < BQ * L::LDO; i += kThreads) os[i] = 0.f;

  // logits of key tile k0 into si (int32), its key scales into skt
  auto logits = [&](int k0) {
    __syncthreads();
    for (int i = threadIdx.x; i < BKT * DP / 16; i += kThreads) {
      const int r = i / (DP / 16), c = (i % (DP / 16)) * 16;
      *reinterpret_cast<uint4*>(ks + slab(r, c, BKT)) =
          *reinterpret_cast<const uint4*>(kq + (bh * n + k0 + r) * DP + c);
    }
    for (int r = threadIdx.x; r < BKT; r += kThreads) skt[r] = sk[bh * n + k0 + r];
    __syncthreads();
    for (int t = warp; t < TQ * TK; t += kWarps) {
      const int ti = t / TK, tj = t % TK;
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
      wmma::fill_fragment(acc, 0);
#pragma unroll
      for (int kk = 0; kk < TD; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qs + (kk * BQ + ti * 16) * 16, 16);
        wmma::load_matrix_sync(fb, ks + (kk * BKT + tj * 16) * 16, 16);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(si + ti * 16 * L::LDS + tj * 16, acc, L::LDS, wmma::mem_row_major);
    }
    __syncthreads();
  };

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    // pass 1: each row's max over the chunk
    for (int r = threadIdx.x; r < BQ; r += kThreads) mc[r] = -INFINITY;
    for (int k0 = c0; k0 < c0 + kChunk; k0 += BKT) {
      logits(k0);
      for (int r = warp; r < BQ; r += kWarps) {
        float mx = -INFINITY;
        for (int c = lane; c < BKT; c += 32)
          mx = fmaxf(mx, static_cast<float>(si[r * L::LDS + c]) * sqp[r] * skt[c]);
        mx = warp_max(mx);
        if (lane == 0) mc[r] = fmaxf(mc[r], mx);
      }
    }
    __syncthreads();
    // the chunk's new max; rescale the sum and the accumulator once
    for (int r = warp; r < BQ; r += kWarps) {
      const float m_new = fmaxf(ms[r], mc[r]);
      const float corr = exp2f(ms[r] - m_new);
      for (int c = lane; c < DP; c += 32) {
        os[r * L::LDO + c] *= corr;
        if (PV8) oi[r * L::LDO + c] = 0;
      }
      __syncwarp();
      if (lane == 0) {
        ls[r] *= corr;
        ms[r] = m_new;
      }
    }
    // pass 2: P against the chunk's max, and P V
    for (int k0 = c0; k0 < c0 + kChunk; k0 += BKT) {
      logits(k0);  // its barriers also order the rescale above
      for (int r = warp; r < BQ; r += kWarps) {
        float sum = 0.f;
        const float m = ms[r];
        for (int c = lane; c < BKT; c += 32) {
          const float p = exp2f(static_cast<float>(si[r * L::LDS + c]) * sqp[r] * skt[c] - m);
          sum += p;
          if (PV8)
            reinterpret_cast<signed char*>(pbuf)[slab(r, c, BQ)] =
                static_cast<signed char>(rintf(p * 127.f));
          else
            reinterpret_cast<bf16*>(pbuf)[r * L::LDP + c] = __float2bfloat16(p);
        }
        sum = warp_sum(sum);
        if (lane == 0) ls[r] += sum;
      }
      if (PV8) {
        signed char* vs = reinterpret_cast<signed char*>(vbuf);
        for (int i = threadIdx.x; i < BKT * DP / 16; i += kThreads) {
          const int r = i / (DP / 16), c = (i % (DP / 16)) * 16;
          *reinterpret_cast<uint4*>(vs + slab(r, c, BKT)) =
              *reinterpret_cast<const uint4*>(vq + (bh * n + k0 + r) * DP + c);
        }
      } else {
        bf16* vs = reinterpret_cast<bf16*>(vbuf);
        const bf16* vb = v + ((size_t)b * n * heads + h) * d;
        for (int i = threadIdx.x; i < BKT * DP / 8; i += kThreads) {
          const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (c < d)
            val = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * heads * d + c);
          *reinterpret_cast<uint4*>(vs + r * L::LDV + c) = val;
        }
      }
      __syncthreads();
      for (int t = warp; t < TQ * TD; t += kWarps) {
        const int ti = t / TD, tj = t % TD;
        if (PV8) {
          int* optr = oi + ti * 16 * L::LDO + tj * 16;
          wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
          wmma::load_matrix_sync(acc, optr, L::LDO, wmma::mem_row_major);
#pragma unroll
          for (int kk = 0; kk < TK; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb;
            wmma::load_matrix_sync(fa, reinterpret_cast<signed char*>(pbuf) +
                                           (kk * BQ + ti * 16) * 16, 16);
            // V slabs run over features: keys kk*16.. of feature slab tj
            wmma::load_matrix_sync(fb, reinterpret_cast<signed char*>(vbuf) +
                                           (tj * BKT + kk * 16) * 16, 16);
            wmma::mma_sync(acc, fa, fb, acc);
          }
          wmma::store_matrix_sync(optr, acc, L::LDO, wmma::mem_row_major);
        } else {
          float* optr = os + ti * 16 * L::LDO + tj * 16;
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
          wmma::load_matrix_sync(acc, optr, L::LDO, wmma::mem_row_major);
#pragma unroll
          for (int kk = 0; kk < BKT; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fa, reinterpret_cast<bf16*>(pbuf) + ti * 16 * L::LDP + kk,
                                   L::LDP);
            wmma::load_matrix_sync(fb, reinterpret_cast<bf16*>(vbuf) + kk * L::LDV + tj * 16,
                                   L::LDV);
            wmma::mma_sync(acc, fa, fb, acc);
          }
          wmma::store_matrix_sync(optr, acc, L::LDO, wmma::mem_row_major);
        }
      }
    }
    __syncthreads();
    if (PV8) {
      // O += (P V)_int32 * (sv / 127), the chunk's per-feature V scales
      const float* svc = sv + (bh * (n / kChunk) + c0 / kChunk) * DP;
      for (int i = threadIdx.x; i < BQ * DP; i += kThreads) {
        const int r = i / DP, c = i % DP;
        os[r * L::LDO + c] += static_cast<float>(oi[r * L::LDO + c]) * (svc[c] / 127.f);
      }
      __syncthreads();
    }
  }

  bf16* ob = o + ((size_t)b * n * heads + h) * d;
  for (int i = threadIdx.x; i < BQ * d; i += kThreads) {
    const int r = i / d, c = i % d;
    if (q0 + r < n)
      ob[(size_t)(q0 + r) * heads * d + c] = __float2bfloat16(os[r * L::LDO + c] / ls[r]);
  }
}

template <int BQ, int BKT, int DP, bool PV8>
cudaError_t launch_attention(const signed char* qq, const float* sq, const signed char* kq,
                             const float* sk, const bf16* v, const signed char* vq,
                             const float* sv, bf16* o, int batch, int n, int heads, int d,
                             float scale_log2e, cudaStream_t stream) {
  constexpr int bytes = Smem<BQ, BKT, DP, PV8>::BYTES;
  static_assert(bytes <= 232448, "shared memory per block");
  cudaError_t err = cudaFuncSetAttribute(flash_int8_kernel<BQ, BKT, DP, PV8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BQ - 1) / BQ, heads, batch);
  flash_int8_kernel<BQ, BKT, DP, PV8><<<grid, kThreads, bytes, stream>>>(
      qq, sq, kq, sk, v, vq, sv, o, n, heads, d, scale_log2e);
  return cudaGetLastError();
}

template <int BQ, int BKT, int DP>
cudaError_t launch_mode(bool pv8, const signed char* qq, const float* sq, const signed char* kq,
                        const float* sk, const bf16* v, const signed char* vq, const float* sv,
                        bf16* o, int batch, int n, int heads, int d, float sl,
                        cudaStream_t stream) {
  if (pv8)
    return launch_attention<BQ, BKT, DP, true>(qq, sq, kq, sk, v, vq, sv, o, batch, n, heads,
                                               d, sl, stream);
  return launch_attention<BQ, BKT, DP, false>(qq, sq, kq, sk, v, vq, sv, o, batch, n, heads, d,
                                              sl, stream);
}

}  // namespace

// The padded head dim the kernel uses for head dim d (0 if d is not taken).
// Two instantiations, those of SD v1's int8 serving path: head dims up to 48
// pad to 48 (the UNet's d = 40), the others up to 512 pad to 512 (the VAE
// mid-block's d = 512).
extern "C" int sdt_flash_int8_padded_dim(int d) {
  if (d <= 0 || d % 8 != 0 || d > 512) return 0;
  return d <= 48 ? 48 : 512;
}

// q, k, v, o [B, N, H, d] bf16 (self-attention, N a multiple of 1024, d a
// multiple of 8 up to 512); scratch from the wrapper: qq, kq, vq [B, H, N,
// dp] int8 and sq, sk [B, H, N], sv [B, H, N / 1024, dp] fp32, dp from
// sdt_flash_int8_padded_dim (vq and sv only for pv8); scale_log2e is the
// logit scale times log2(e), rounded once to fp32 as sd_tpu's is. Returns the CUDA error
// code of the launches.
extern "C" int sdt_flash_attention_int8(const void* q, const void* k, const void* v, void* o,
                                        void* qq, void* sq, void* kq, void* sk, void* vq,
                                        void* sv, int batch, int n, int heads, int d,
                                        float scale_log2e, int pv8, void* stream) {
  const int dp = sdt_flash_int8_padded_dim(d);
  if (dp == 0 || n % kChunk != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long rows = (long)batch * n * heads;
  const unsigned qblocks = (unsigned)((rows + kWarps - 1) / kWarps);
  quant_heads_kernel<<<qblocks, kThreads, 0, s>>>(static_cast<const bf16*>(q),
                                                  static_cast<signed char*>(qq),
                                                  static_cast<float*>(sq), batch, n, heads, d, dp);
  quant_heads_kernel<<<qblocks, kThreads, 0, s>>>(static_cast<const bf16*>(k),
                                                  static_cast<signed char*>(kq),
                                                  static_cast<float*>(sk), batch, n, heads, d, dp);
  if (pv8)
    quant_v_kernel<<<dim3(n / kChunk, heads, batch), kThreads, 0, s>>>(
        static_cast<const bf16*>(v), static_cast<signed char*>(vq), static_cast<float*>(sv), n,
        heads, d, dp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float sl = scale_log2e;
  const signed char* qqp = static_cast<const signed char*>(qq);
  const signed char* kqp = static_cast<const signed char*>(kq);
  const signed char* vqp = static_cast<const signed char*>(vq);
  const float* sqp = static_cast<const float*>(sq);
  const float* skp = static_cast<const float*>(sk);
  const float* svp = static_cast<const float*>(sv);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  const bool p8 = pv8 != 0;
#define SDT_MODE(BQ, BKT, DP) \
  launch_mode<BQ, BKT, DP>(p8, qqp, sqp, kqp, skp, vp, vqp, svp, op, batch, n, heads, d, sl, s)
  err = dp == 48 ? SDT_MODE(64, 64, 48) : SDT_MODE(32, 32, 512);
#undef SDT_MODE
  return static_cast<int>(err);
}
