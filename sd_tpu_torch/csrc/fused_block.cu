// X1: the fused self-attention sub-block for Hopper (sm_90a):
//   y = bf16(bf16(attend(LN(x) Wq', LN(x) Wk, LN(x) Wv) Wo + bo) + x)
// with 8-head (any head count) softmax attention in base 2 and Wq' = Wq
// scaled by d^-0.5 * log2(e) (the wrapper prepares it, as the TPU kernel's
// caller does).
//
// Replaces the TPU kernel `_kernel` driven by `fused_block` in
// tools/exp_block_kernel.py. It computes the same function at the same
// rounding points: LayerNorm with the single-pass fp32 variance, rounded to
// bf16; q, k and v each rounded after an fp32 accumulation; P unnormalised
// and rounded to bf16 before P.V, the fp32 accumulator divided by the row
// sum at the end and each head's output rounded; (y + bo) rounded, then added
// to x. Unlike the TPU kernel, which drops the last N mod chunk keys, it
// attends over every key.
//
// What bounds it on the H100: 8 B N C^2 flops of projections and 4 B H N^2 d
// of attention against about 4 B N C bytes of activations, so it is compute
// bound at every SD v1 site; at N = 4096 the attention core is 86% of the
// flops. The TPU kernel holds one batch element's [N, C] and four [C, C]
// weights in VMEM; a block here has 227 KB of shared memory, so the work is
// two launches, each written here:
//   A. LayerNorm in the prologue of the QKV GEMM against [C, 3C]: each block
//      normalises its BQ rows into shared memory once and multiplies them by
//      up to four 64-column chunks of the weight, streamed in 32-row slabs.
//      Only q (pre-scaled), k and v reach device memory, in bf16, which is
//      the TPU kernel's rounding of them; LN(x) never does.
//   B. One block takes BQ query rows of one batch element for every head: an
//      online softmax over 64-key tiles per head (K1's scheme: logits,
//      probabilities and the output accumulator in shared memory), each
//      head's bf16 output written into a [BQ, C] tile in shared memory; then
//      that tile times Wo, streamed in slabs, plus bo and x. The attention
//      output never reaches device memory.
// BQ is 64 where launch B's shared memory fits (C = 320, 640), else 32
// (C = 1280) or 16. Products run on the tensor cores through WMMA (16x16x16
// bf16, fp32 accumulate); the head dimension is zero-padded in shared memory
// to a multiple of 16 (d = 40 -> 48). This is the simple first version: no
// cp.async/TMA pipelining, no wgmma, 4 warps a block.

#include "block_tile.cuh"

using namespace sdt_block;

namespace {

constexpr int kBK = 64;           // keys per tile of the online softmax
constexpr int kLDS = kBK + 4;     // fp32 pitch of the logits
constexpr int kLDP = kBK + 8;     // bf16 pitch of the probabilities
constexpr int kQkvChunks = 4;     // 64-column chunks of [C, 3C] per block of launch A
constexpr int kMaxSmem = 232448;  // shared memory a block may use

// Launch A's shared memory: the normalised rows, a weight slab, the staging tile.
struct QkvPlan {
  int t, w, st, bytes;
  __host__ __device__ QkvPlan(int bq, int c) {
    int at = 0;
    t = at;
    at = align128(at + bq * tile_pitch(c) * 2);
    w = at;
    at = align128(at + GBK * LDW * 2);
    st = at;
    at = align128(at + bq * LDST * 4);
    bytes = at;
  }
};

// Launch B's shared memory: the [BQ, C] attention tile, one head's Q, K and V
// tiles, logits, probabilities, output accumulator, running max and sum, and
// the out-projection's weight slab and staging tile.
struct AttnPlan {
  int t, q, k, v, s, p, o, m, l, w, st, bytes;
  __host__ __device__ AttnPlan(int bq, int c, int d) {
    const int dp = round_up(d, 16);
    int at = 0;
    t = at;
    at = align128(at + bq * tile_pitch(c) * 2);
    q = at;
    at = align128(at + bq * (dp + 8) * 2);
    k = at;
    at = align128(at + kBK * (dp + 8) * 2);
    v = at;
    at = align128(at + kBK * (dp + 8) * 2);
    s = at;
    at = align128(at + bq * kLDS * 4);
    p = at;
    at = align128(at + bq * kLDP * 2);
    o = at;
    at = align128(at + bq * (dp + 4) * 4);
    m = at;
    at = align128(at + bq * 4);
    l = at;
    at = align128(at + bq * 4);
    w = at;
    at = align128(at + GBK * LDW * 2);
    st = at;
    at = align128(at + bq * LDST * 4);
    bytes = at;
  }
};

// qkv[row, :] = bf16(LN(x[row]) . [Wq' | Wk | Wv]) for BQ rows and up to
// kQkvChunks 64-column chunks of the 3C outputs.
template <int BQ>
__global__ void __launch_bounds__(kThreads)
ln_qkv_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, const bf16* __restrict__ wqkv,
              bf16* __restrict__ qkv, int m, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  const QkvPlan plan(BQ, c);
  bf16* t = reinterpret_cast<bf16*>(smem + plan.t);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + plan.w);
  float* stage = reinterpret_cast<float*>(smem + plan.st);
  const int ldt = tile_pitch(c);
  const int row0 = blockIdx.y * BQ;
  const int n_out = 3 * c;

  ln_rows(x, c, row0, BQ, m, c, gamma, beta, t, ldt);
  const bf16* w[1] = {wqkv};
  const int first = blockIdx.x * kQkvChunks * GBN;
  const int last = imin(n_out, first + kQkvChunks * GBN);
  for (int n0 = first; n0 < last; n0 += GBN) {
    block_gemm<BQ, 1>(t, ldt, w, n_out, c, n0, n_out, wbuf, stage);
    for (int i = threadIdx.x; i < BQ * GBN; i += kThreads) {
      const int r = i / GBN, cc = i % GBN;
      if (row0 + r < m && n0 + cc < n_out)
        qkv[(size_t)(row0 + r) * n_out + n0 + cc] = __float2bfloat16(stage[r * LDST + cc]);
    }
  }
}

// out = bf16(bf16(attend(q, k, v) Wo + bo) + x) for BQ query rows of batch
// element blockIdx.y; q, k, v are the column thirds of qkv [B * N, 3C].
template <int BQ>
__global__ void __launch_bounds__(kThreads)
attn_out_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ x,
                const bf16* __restrict__ wo, const float* __restrict__ bo,
                bf16* __restrict__ out, int n, int heads, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = heads * d;
  const AttnPlan plan(BQ, c, d);
  bf16* t = reinterpret_cast<bf16*>(smem + plan.t);
  bf16* qs = reinterpret_cast<bf16*>(smem + plan.q);
  bf16* ks = reinterpret_cast<bf16*>(smem + plan.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + plan.v);
  float* ss = reinterpret_cast<float*>(smem + plan.s);
  bf16* ps = reinterpret_cast<bf16*>(smem + plan.p);
  float* os = reinterpret_cast<float*>(smem + plan.o);
  float* ms = reinterpret_cast<float*>(smem + plan.m);
  float* ls = reinterpret_cast<float*>(smem + plan.l);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + plan.w);
  float* stage = reinterpret_cast<float*>(smem + plan.st);

  const int ldt = tile_pitch(c);
  const int kp = round_up(c, GBK);
  const int dp = round_up(d, 16);
  const int ldq = dp + 8, ldo = dp + 4;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y;
  const size_t stride = 3 * (size_t)c;
  const bf16* base = qkv + (size_t)b * n * stride;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  constexpr int TQ = BQ / 16;
  constexpr int TK = kBK / 16;
  const int TD = dp / 16;

  // the product with Wo runs over the tile's zero columns [c, kp)
  for (int i = threadIdx.x; i < BQ * (kp - c); i += kThreads)
    t[(i / (kp - c)) * ldt + c + i % (kp - c)] = __float2bfloat16(0.f);

  for (int h = 0; h < heads; ++h) {
    __syncthreads();  // the previous head's output has left os
    load_head_rows(qs, ldq, base + h * d, stride, q0, BQ, n, d, dp);
    for (int i = threadIdx.x; i < BQ * ldo; i += kThreads) os[i] = 0.f;
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      ms[i] = -INFINITY;
      ls[i] = 0.f;
    }
    for (int k0 = 0; k0 < n; k0 += kBK) {
      __syncthreads();  // the previous tile's P.V is done with ks, vs and ps
      load_head_rows(ks, ldq, base + c + h * d, stride, k0, kBK, n, d, dp);
      load_head_rows(vs, ldq, base + 2 * c + h * d, stride, k0, kBK, n, d, dp);
      __syncthreads();

      // S = Q K^T (q carries d^-0.5 log2(e): these are base-2 logits)
      for (int tt = warp; tt < TQ * TK; tt += kWarps) {
        const int ti = tt / TK, tj = tt % TK;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < dp; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, qs + ti * 16 * ldq + kk, ldq);
          wmma::load_matrix_sync(fb, ks + tj * 16 * ldq + kk, ldq);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(ss + ti * 16 * kLDS + tj * 16, acc, kLDS, wmma::mem_row_major);
      }
      __syncthreads();

      // online softmax, one warp a row; keys at or past n are masked
      for (int r = warp; r < BQ; r += kWarps) {
        float xv[kBK / 32];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBK / 32; ++j) {
          const int cc = lane + 32 * j;
          xv[j] = (k0 + cc < n) ? ss[r * kLDS + cc] : -INFINITY;
          mx = fmaxf(mx, xv[j]);
        }
        mx = warp_max(mx);
        const float m_old = ms[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kBK / 32; ++j) {
          const float p = exp2f(xv[j] - m_new);
          sum += p;
          ps[r * kLDP + lane + 32 * j] = __float2bfloat16(p);
        }
        sum = warp_sum(sum);
        const float corr = exp2f(m_old - m_new);
        for (int cc = lane; cc < dp; cc += 32) os[r * ldo + cc] *= corr;
        if (lane == 0) {
          ms[r] = m_new;
          ls[r] = ls[r] * corr + sum;
        }
      }
      __syncthreads();

      // O += P V
      for (int tt = warp; tt < TQ * TD; tt += kWarps) {
        const int ti = tt / TD, tj = tt % TD;
        float* optr = os + ti * 16 * ldo + tj * 16;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, optr, ldo, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, ps + ti * 16 * kLDP + kk, kLDP);
          wmma::load_matrix_sync(fb, vs + kk * ldq + tj * 16, ldq);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(optr, acc, ldo, wmma::mem_row_major);
      }
    }
    __syncthreads();
    // this head's output, divided by the row sum and rounded, into its columns
    for (int i = threadIdx.x; i < BQ * d; i += kThreads) {
      const int r = i / d, cc = i % d;
      t[r * ldt + h * d + cc] = __float2bfloat16(os[r * ldo + cc] / ls[r]);
    }
  }

  // out-projection, bias and residual, 64 output columns at a time
  const bf16* w[1] = {wo};
  for (int n0 = 0; n0 < c; n0 += GBN) {
    block_gemm<BQ, 1>(t, ldt, w, c, c, n0, c, wbuf, stage);
    for (int i = threadIdx.x; i < BQ * GBN; i += kThreads) {
      const int r = i / GBN, col = n0 + i % GBN;
      if (q0 + r < n && col < c) {
        const size_t at = ((size_t)b * n + q0 + r) * c + col;
        const float y = bf16_round(stage[r * LDST + i % GBN] + bo[col]);
        out[at] = __float2bfloat16(y + __bfloat162float(x[at]));
      }
    }
  }
}

// The largest row tile whose launch fits in shared memory, or 0.
int qkv_rows(int c) {
  for (int bq = 64; bq >= 16; bq /= 2)
    if (QkvPlan(bq, c).bytes <= kMaxSmem) return bq;
  return 0;
}

int attn_rows(int c, int d) {
  for (int bq = 64; bq >= 16; bq /= 2)
    if (AttnPlan(bq, c, d).bytes <= kMaxSmem) return bq;
  return 0;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int BQ>
cudaError_t launch_qkv(const bf16* x, const float* gamma, const float* beta, const bf16* wqkv,
                       bf16* qkv, int m, int c, cudaStream_t stream) {
  const int bytes = QkvPlan(BQ, c).bytes;
  cudaError_t err = set_smem(ln_qkv_kernel<BQ>, bytes);
  if (err != cudaSuccess) return err;
  const int per_block = kQkvChunks * GBN;
  dim3 grid((3 * c + per_block - 1) / per_block, (m + BQ - 1) / BQ);
  ln_qkv_kernel<BQ><<<grid, kThreads, bytes, stream>>>(x, gamma, beta, wqkv, qkv, m, c);
  return cudaGetLastError();
}

template <int BQ>
cudaError_t launch_attn(const bf16* qkv, const bf16* x, const bf16* wo, const float* bo,
                        bf16* out, int batch, int n, int heads, int d, cudaStream_t stream) {
  const int bytes = AttnPlan(BQ, heads * d, d).bytes;
  cudaError_t err = set_smem(attn_out_kernel<BQ>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BQ - 1) / BQ, batch);
  attn_out_kernel<BQ><<<grid, kThreads, bytes, stream>>>(qkv, x, wo, bo, out, n, heads, d);
  return cudaGetLastError();
}

}  // namespace

// The row tile of launch B for C = heads * d, or 0 if no tile fits (the
// wrapper raises then). d must be a multiple of 8.
extern "C" int sdt_fused_block_q(int c, int d) {
  if (d <= 0 || d % 8 || c % d || qkv_rows(c) == 0) return 0;
  return attn_rows(c, d);
}

// x [batch, n, c] bf16, gamma/beta [c] fp32, wqkv [c, 3c] bf16 ([in, out],
// the query third pre-scaled), wo [c, c] bf16, bo [c] fp32, qkv [batch * n,
// 3c] bf16 scratch, out [batch, n, c] bf16; c = heads * d. Returns the CUDA
// error code of the launches (0 on success); the wrapper checks shapes and
// alignment.
extern "C" int sdt_fused_block(const void* x, const void* gamma, const void* beta,
                               const void* wqkv, const void* wo, const void* bo, void* qkv,
                               void* out, int batch, int n, int heads, int d, void* stream) {
  const int c = heads * d;
  const int m = batch * n;
  const int bq_a = qkv_rows(c), bq_b = sdt_fused_block_q(c, d);
  if (bq_a == 0 || bq_b == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  const bf16* wp = static_cast<const bf16*>(wqkv);
  bf16* qp = static_cast<bf16*>(qkv);
  cudaError_t err;
  if (bq_a == 64) err = launch_qkv<64>(xp, gp, bp, wp, qp, m, c, s);
  else if (bq_a == 32) err = launch_qkv<32>(xp, gp, bp, wp, qp, m, c, s);
  else err = launch_qkv<16>(xp, gp, bp, wp, qp, m, c, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* wop = static_cast<const bf16*>(wo);
  const float* bop = static_cast<const float*>(bo);
  bf16* op = static_cast<bf16*>(out);
  if (bq_b == 64) err = launch_attn<64>(qp, xp, wop, bop, op, batch, n, heads, d, s);
  else if (bq_b == 32) err = launch_attn<32>(qp, xp, wop, bop, op, batch, n, heads, d, s);
  else err = launch_attn<16>(qp, xp, wop, bop, op, batch, n, heads, d, s);
  return static_cast<int>(err);
}
