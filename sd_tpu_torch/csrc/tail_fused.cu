// X2: the fused tail of a transformer block for Hopper (sm_90a):
//   x1  = bf16(bf16(attend(LN2(x) Wq', kc, vc) Wo + bo) + x)
//   h   = bf16((LN3(x1) W1a + b1a) * gelu(LN3(x1) W1g + b1g))
//   out = bf16(bf16(h W2 + bff) + x1)
// with cross-attention over the first kv_len of nk context keys per head, in
// base 2, and Wq' = Wq scaled by d^-0.5 * log2(e) (prepared by the wrapper).
// The context's K and V projections (kc, vc) are inputs, as in the TPU kernel.
//
// Replaces the TPU kernel `_tail_kernel` driven by `tail_fused` in
// tools/exp_block_kernel.py, at its rounding points: both LayerNorms with
// the single-pass fp32 variance, rounded to bf16; q rounded after an fp32
// accumulation; key columns at or past kv_len masked before the row max
// (whatever the padded rows hold); P unnormalised and rounded to bf16 before
// P.V, divided by the fp32 row sum after it, each head's output rounded;
// (y + bo) rounded, then added to x; the GEGLU in fp32, h rounded; (h W2 +
// bff) rounded, then added to x1. GELU is the exact form through CUDA's erff,
// not sd_tpu's erf polynomial (_gelu_f32, max error 5.5e-7), as in K2.
//
// What bounds it on the H100: 4 B N C^2 + 6 B N C I flops (I = 4C) against
// about 4 B N C bytes of activations, compute bound at every SD v1 site; the
// attention over 77 keys is about 3% of the flops. The TPU kernel holds a
// [bq, C] row block with all its weights in VMEM and writes only the output.
// Here a block has 227 KB of shared memory, and the [BQ, I] tile of h at
// I = 5120 does not fit beside the rest (nor does it for K2, geglu_ff.cu), so the
// work is two launches, each written here:
//   A. Per block of BQ rows of one batch element: LN2 into shared memory;
//      per head, q = LN2(x) Wq' for the head's columns, the logits against
//      the head's keys (all of them fit: one softmax pass), P.V; the heads'
//      bf16 outputs in a [BQ, C] tile; times Wo, plus bo and x, gives x1,
//      kept in shared memory and written to device memory for launch B; LN3
//      in place; the value and gate GEMMs in one pass over 64-column chunks
//      of W1, and h = a * gelu(g) written in bf16 (the TPU kernel's rounding
//      of h, so writing it costs no accuracy).
//   B. h times W2 (64 x 64 output tiles, 32-deep slabs of both operands),
//      plus bff, rounded, plus x1.
// Weights stream through shared memory in 32-row slabs; every product runs on
// the tensor cores through WMMA (16x16x16 bf16, fp32 accumulate). BQ is 64,
// 32 or 16, the largest whose launch A fits (64 at C = 320, 32 at C = 640 and
// 1280 with 77 keys). Simple first version: no cp.async/TMA, no wgmma.

#include "block_tile.cuh"

using namespace sdt_block;

namespace {

constexpr int kMaxSmem = 232448;  // shared memory a block may use
constexpr int kBM = 64;           // launch B: output rows per block
constexpr int kLDA = GBK + 8;     // launch B: bf16 pitch of an h slab

// Launch A's shared memory. Phases reuse two regions: `kv` holds one head's
// K, then its V, and the weight slabs of every GEMM; `f` (fp32) holds the
// logits, then the head's P.V, and every GEMM's staging tiles.
struct TailPlan {
  int t0, t1, q, kv, f, p, l, bytes;
  __host__ __device__ TailPlan(int bq, int c, int d, int kv_len) {
    const int dp = round_up(d, 16);
    const int nkp = round_up(kv_len, 16);
    const int kv_elems = imax(nkp * (dp + 8), 2 * GBK * LDW);
    const int f_elems = imax(imax(bq * (nkp + 4), bq * (dp + 4)), 2 * bq * LDST);
    int at = 0;
    t0 = at;  // LN2(x), then x1, then LN3(x1)
    at = align128(at + bq * tile_pitch(c) * 2);
    t1 = at;  // the heads' outputs
    at = align128(at + bq * tile_pitch(c) * 2);
    q = at;   // one head's q
    at = align128(at + bq * (dp + 8) * 2);
    kv = at;
    at = align128(at + kv_elems * 2);
    f = at;
    at = align128(at + f_elems * 4);
    p = at;
    at = align128(at + bq * (nkp + 8) * 2);
    l = at;
    at = align128(at + bq * 4);
    bytes = at;
  }
};

template <int BQ>
__global__ void __launch_bounds__(kThreads)
tail_attn_ff_kernel(const bf16* __restrict__ x, const float* __restrict__ g2,
                    const float* __restrict__ b2, const bf16* __restrict__ wq,
                    const bf16* __restrict__ wo, const float* __restrict__ bo,
                    const bf16* __restrict__ kc, const bf16* __restrict__ vc,
                    const float* __restrict__ g3, const float* __restrict__ b3,
                    const bf16* __restrict__ w1, const float* __restrict__ b1,
                    bf16* __restrict__ x1, bf16* __restrict__ hout, int n, int nk, int kv_len,
                    int heads, int d, int inner) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = heads * d;
  const TailPlan plan(BQ, c, d, kv_len);
  bf16* t0 = reinterpret_cast<bf16*>(smem + plan.t0);
  bf16* t1 = reinterpret_cast<bf16*>(smem + plan.t1);
  bf16* qs = reinterpret_cast<bf16*>(smem + plan.q);
  bf16* kvs = reinterpret_cast<bf16*>(smem + plan.kv);
  float* fs = reinterpret_cast<float*>(smem + plan.f);
  bf16* ps = reinterpret_cast<bf16*>(smem + plan.p);
  float* ls = reinterpret_cast<float*>(smem + plan.l);

  const int ldt = tile_pitch(c);
  const int kp = round_up(c, GBK);
  const int dp = round_up(d, 16);
  const int nkp = round_up(kv_len, 16);
  const int ldq = dp + 8, ldo = dp + 4, lds = nkp + 4, ldp = nkp + 8;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y;
  const int valid = imin(BQ, n - q0);  // rows of this block inside the sequence
  const bf16* xb = x + ((size_t)b * n + q0) * c;
  const bf16* kb = kc + (size_t)b * nk * c;
  const bf16* vb = vc + (size_t)b * nk * c;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  constexpr int TQ = BQ / 16;
  const int TK = nkp / 16;
  const int TD = dp / 16;

  // LN2 into t0; the heads' tile gets its zero columns [c, kp)
  ln_rows(xb, c, 0, BQ, valid, c, g2, b2, t0, ldt);
  for (int i = threadIdx.x; i < BQ * (kp - c); i += kThreads)
    t1[(i / (kp - c)) * ldt + c + i % (kp - c)] = __float2bfloat16(0.f);

  const bf16* wq_[1] = {wq};
  for (int h = 0; h < heads; ++h) {
    // q for this head's d columns (zeros in [d, dp))
    for (int n0 = h * d; n0 < h * d + d; n0 += GBN) {
      block_gemm<BQ, 1>(t0, ldt, wq_, c, c, n0, h * d + d, kvs, fs);
      for (int i = threadIdx.x; i < BQ * GBN; i += kThreads) {
        const int r = i / GBN, cc = n0 - h * d + i % GBN;
        if (cc < dp) qs[r * ldq + cc] = __float2bfloat16(fs[r * LDST + i % GBN]);
      }
    }
    __syncthreads();
    load_head_rows(kvs, ldq, kb + h * d, c, 0, nkp, kv_len, d, dp);
    __syncthreads();

    // S = q K^T over the head's keys, base-2 logits
    for (int tt = warp; tt < TQ * TK; tt += kWarps) {
      const int ti = tt / TK, tj = tt % TK;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < dp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qs + ti * 16 * ldq + kk, ldq);
        wmma::load_matrix_sync(fb, kvs + tj * 16 * ldq + kk, ldq);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(fs + ti * 16 * lds + tj * 16, acc, lds, wmma::mem_row_major);
    }
    __syncthreads();

    // one-pass softmax, one warp a row; key columns at or past kv_len are masked
    for (int r = warp; r < BQ; r += kWarps) {
      float mx = -INFINITY;
      for (int cc = lane; cc < kv_len; cc += 32) mx = fmaxf(mx, fs[r * lds + cc]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int cc = lane; cc < nkp; cc += 32) {
        const float p = cc < kv_len ? exp2f(fs[r * lds + cc] - mx) : 0.f;
        sum += p;
        ps[r * ldp + cc] = __float2bfloat16(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) ls[r] = sum;
    }
    __syncthreads();
    load_head_rows(kvs, ldq, vb + h * d, c, 0, nkp, kv_len, d, dp);
    __syncthreads();

    // O = P V into fs, then divided by the row sum and rounded into t1
    for (int tt = warp; tt < TQ * TD; tt += kWarps) {
      const int ti = tt / TD, tj = tt % TD;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < nkp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, ps + ti * 16 * ldp + kk, ldp);
        wmma::load_matrix_sync(fb, kvs + kk * ldq + tj * 16, ldq);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(fs + ti * 16 * ldo + tj * 16, acc, ldo, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * d; i += kThreads) {
      const int r = i / d, cc = i % d;
      t1[r * ldt + h * d + cc] = __float2bfloat16(fs[r * ldo + cc] / ls[r]);
    }
  }

  // x1 = bf16(bf16(att Wo + bo) + x) into t0 (LN2(x) is no longer needed)
  // and device memory; rows past the sequence stay zero in t0
  const bf16* wo_[1] = {wo};
  for (int n0 = 0; n0 < c; n0 += GBN) {
    block_gemm<BQ, 1>(t1, ldt, wo_, c, c, n0, c, kvs, fs);
    for (int i = threadIdx.x; i < BQ * GBN; i += kThreads) {
      const int r = i / GBN, col = n0 + i % GBN;
      if (r < valid && col < c) {
        const size_t at = ((size_t)b * n + q0 + r) * c + col;
        const float y = bf16_round(fs[r * LDST + i % GBN] + bo[col]);
        const bf16 v = __float2bfloat16(y + __bfloat162float(xb[(size_t)r * c + col]));
        t0[r * ldt + col] = v;
        x1[at] = v;
      }
    }
  }
  __syncthreads();
  // LN3 in place
  ln_rows(t0, ldt, 0, BQ, valid, c, g3, b3, t0, ldt);

  // h = bf16((a + b1a) * gelu(g + b1g)), value and gate chunks in one pass
  const bf16* w1_[2] = {w1, w1 + inner};
  for (int n0 = 0; n0 < inner; n0 += GBN) {
    block_gemm<BQ, 2>(t0, ldt, w1_, 2 * inner, c, n0, inner, kvs, fs);
    for (int i = threadIdx.x; i < BQ * GBN; i += kThreads) {
      const int r = i / GBN, col = n0 + i % GBN;
      if (r < valid && col < inner) {
        const float a = fs[r * LDST + i % GBN] + b1[col];
        const float g = fs[BQ * LDST + r * LDST + i % GBN] + b1[inner + col];
        const float gelu = 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
        hout[((size_t)b * n + q0 + r) * inner + col] = __float2bfloat16(a * gelu);
      }
    }
  }
}

// out = bf16(bf16(h W2 + bff) + x1): h [m, k], w2 [k, c] ([in, out]), a
// 64 x 64 output tile per block, 4 warps of 32 x 32.
__global__ void __launch_bounds__(kThreads)
ff_out_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w2,
              const float* __restrict__ bff, const bf16* __restrict__ x1,
              bf16* __restrict__ out, int m, int k, int c) {
  __shared__ __align__(128) bf16 as[kBM * kLDA];
  __shared__ __align__(128) bf16 ws[GBK * LDW];
  __shared__ __align__(128) float stage[kBM * LDST];
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * GBN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;  // the warp's 32 x 32 quadrant
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < k; k0 += GBK) {
    // 16-byte loads; rows past m, columns past c and k past its end are zeros
    for (int i = threadIdx.x; i < kBM * GBK / 8; i += kThreads) {
      const int r = i / (GBK / 8), cc = (i % (GBK / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m && k0 + cc < k)
        val = *reinterpret_cast<const uint4*>(h + (size_t)(m0 + r) * k + k0 + cc);
      *reinterpret_cast<uint4*>(as + r * kLDA + cc) = val;
    }
    for (int i = threadIdx.x; i < GBK * GBN / 8; i += kThreads) {
      const int r = i / (GBN / 8), cc = (i % (GBN / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < k && n0 + cc < c)
        val = *reinterpret_cast<const uint4*>(w2 + (size_t)(k0 + r) * c + n0 + cc);
      *reinterpret_cast<uint4*>(ws + r * LDW + cc) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * kLDA + kk, kLDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], ws + kk * LDW + wn * 32 + j * 16, LDW);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(stage + (wm * 32 + i * 16) * LDST + wn * 32 + j * 16, acc[i][j],
                              LDST, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * GBN; i += kThreads) {
    const int r = i / GBN, col = n0 + i % GBN;
    if (m0 + r < m && col < c) {
      const size_t at = (size_t)(m0 + r) * c + col;
      const float y = bf16_round(stage[r * LDST + i % GBN] + bff[col]);
      out[at] = __float2bfloat16(y + __bfloat162float(x1[at]));
    }
  }
}

int tail_rows(int c, int d, int kv_len) {
  for (int bq = 64; bq >= 16; bq /= 2)
    if (TailPlan(bq, c, d, kv_len).bytes <= kMaxSmem) return bq;
  return 0;
}

template <int BQ>
cudaError_t launch_tail(const bf16* x, const float* g2, const float* b2, const bf16* wq,
                        const bf16* wo, const float* bo, const bf16* kc, const bf16* vc,
                        const float* g3, const float* b3, const bf16* w1, const float* b1,
                        bf16* x1, bf16* h, int batch, int n, int nk, int kv_len, int heads,
                        int d, int inner, cudaStream_t stream) {
  const int bytes = TailPlan(BQ, heads * d, d, kv_len).bytes;
  cudaError_t err = cudaFuncSetAttribute(tail_attn_ff_kernel<BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BQ - 1) / BQ, batch);
  tail_attn_ff_kernel<BQ><<<grid, kThreads, bytes, stream>>>(
      x, g2, b2, wq, wo, bo, kc, vc, g3, b3, w1, b1, x1, h, n, nk, kv_len, heads, d, inner);
  return cudaGetLastError();
}

}  // namespace

// The row tile of launch A, or 0 where no tile fits (the wrapper raises
// then). d must be a multiple of 8 and 1 <= kv_len.
extern "C" int sdt_tail_fused_q(int c, int d, int kv_len) {
  if (d <= 0 || d % 8 || c % d || kv_len < 1) return 0;
  return tail_rows(c, d, kv_len);
}

// x [batch, n, c] bf16; g2, b2, g3, b3, bo, bff [c] fp32; wq, wo [c, c] bf16
// ([in, out], wq pre-scaled); kc, vc [batch, nk, c] bf16 of which the first
// kv_len rows are keys; w1 [c, 2 * inner] bf16 (value columns first), b1
// [2 * inner] fp32; w2 [inner, c] bf16; scratch x1 [batch * n, c] and h
// [batch * n, inner] bf16; out [batch, n, c] bf16; c = heads * d. Returns the
// CUDA error code of the launches (0 on success); the wrapper checks shapes
// and alignment.
extern "C" int sdt_tail_fused(const void* x, const void* g2, const void* b2, const void* wq,
                              const void* wo, const void* bo, const void* kc, const void* vc,
                              const void* g3, const void* b3, const void* w1, const void* b1,
                              const void* w2, const void* bff, void* x1, void* h, void* out,
                              int batch, int n, int nk, int kv_len, int heads, int d, int inner,
                              void* stream) {
  const int c = heads * d;
  const int bq = sdt_tail_fused_q(c, d, kv_len);
  if (bq == 0 || kv_len > nk || inner % 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* g2p = static_cast<const float*>(g2);
  const float* b2p = static_cast<const float*>(b2);
  const bf16* wqp = static_cast<const bf16*>(wq);
  const bf16* wop = static_cast<const bf16*>(wo);
  const float* bop = static_cast<const float*>(bo);
  const bf16* kcp = static_cast<const bf16*>(kc);
  const bf16* vcp = static_cast<const bf16*>(vc);
  const float* g3p = static_cast<const float*>(g3);
  const float* b3p = static_cast<const float*>(b3);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const float* b1p = static_cast<const float*>(b1);
  bf16* x1p = static_cast<bf16*>(x1);
  bf16* hp = static_cast<bf16*>(h);
  cudaError_t err;
  if (bq == 64)
    err = launch_tail<64>(xp, g2p, b2p, wqp, wop, bop, kcp, vcp, g3p, b3p, w1p, b1p, x1p, hp,
                          batch, n, nk, kv_len, heads, d, inner, s);
  else if (bq == 32)
    err = launch_tail<32>(xp, g2p, b2p, wqp, wop, bop, kcp, vcp, g3p, b3p, w1p, b1p, x1p, hp,
                          batch, n, nk, kv_len, heads, d, inner, s);
  else
    err = launch_tail<16>(xp, g2p, b2p, wqp, wop, bop, kcp, vcp, g3p, b3p, w1p, b1p, x1p, hp,
                          batch, n, nk, kv_len, heads, d, inner, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m = batch * n;
  dim3 grid((c + GBN - 1) / GBN, (m + kBM - 1) / kBM);
  ff_out_kernel<<<grid, kThreads, 0, s>>>(hp, static_cast<const bf16*>(w2),
                                          static_cast<const float*>(bff), x1p,
                                          static_cast<bf16*>(out), m, inner, c);
  return static_cast<int>(cudaGetLastError());
}
