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
// the single-pass fp32 variance, clamped at 0, rounded to bf16; q rounded
// after an fp32 accumulation; key columns at or past kv_len masked before
// the row max (whatever the padded rows hold); P unnormalised and rounded to
// bf16 before P.V, divided by the fp32 row sum after it, each head's output
// rounded; (y + bo) rounded, then added to x; the GEGLU in fp32, h rounded;
// (h W2 + bff) rounded, then added to x1. GELU is the exact form through
// CUDA's erff, not sd_tpu's erf polynomial (_gelu_f32, max error 5.5e-7), as
// in K2.
//
// What bounds it on the H100: 4 B N C^2 + 6 B N C I flops (I = 4C) against
// about 4 B N C bytes of activations, compute bound at every SD v1 site; the
// attention over 77 keys is about 3% of the flops and the feed-forward 86%.
// The TPU kernel holds a [bq, C] row block with all its weights in VMEM and
// writes only the output. Here a block has 227 KB of shared memory, and the
// [BQ, I] tile of h at I = 5120 does not fit beside the rest (K2's header,
// geglu_ff.cu), so the work is four launches (five where the attention
// launch splits its columns, six where K2's second GEMM splits over k),
// each written in this repository and none of them a library's:
//   1. LN2 and the Q projection: X1's launch A (fused_block.cuh's
//      x1_qkv_kernel) with a [C, C] weight, q = bf16(LN2(x) Wq') by wgmma
//      with the weight by TMA, over the flattened B N rows.
//   2. The cross-attention and the out-projection: X1's launch B
//      (x1_attn_kernel<P, true>) per block of BQ rows of one batch element
//      (a block never straddles two elements' contexts), with the keys and
//      values read from kc/vc, only their first kv_len rows, the columns at
//      or past kv_len masked; the epilogue adds bo, rounds, adds x and
//      rounds, writes x1, and the block then takes LN3 of the rows it wrote
//      (read back from L2) into LN3(x1). Where the out-projection's columns
//      are split over blocks (few blocks against the SMs, and the attention
//      over kv_len keys cheap against the out-projection), no block owns a
//      whole row, and ln_rows_kernel takes LN3 after the launch.
//   3-4. K2's GEMM pair (geglu_ff.cu, through geglu_ff.cuh) over the
//      flattened B N rows of LN3(x1): h = GEGLU in the first GEMM's
//      epilogue, then h W2 + bff with x1 added in the second's (its
//      residual mode), or in its k-split reduction.
// So each weight tile of W1 and W2 is copied once per 128-row m tile of the
// whole batch, and no block walks all of W1, as the first design's did.

#include "fused_block.cuh"
#include "geglu_ff.cuh"

namespace {

// LN3 of x1's rows where the attention launch split its columns: eight warps
// a block, each with the rows of c values that ln_rows takes at a time (so
// that at the C = 1280 sites, the split ones, the rows spread over the SMs).
__host__ __device__ constexpr int ln_block_rows(int c) { return 8 * (32 / ln_lanes(c)); }

__global__ void __launch_bounds__(256)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, bf16* __restrict__ out, int m, int c) {
  const int r0 = blockIdx.x * ln_block_rows(c);
  ln_rows(x + (size_t)r0 * c, out + (size_t)r0 * c, min(ln_block_rows(c), m - r0), c, gamma,
          beta, threadIdx.x / 32, 8, threadIdx.x % 32);
}

// The attention launch's column split at (batch, n, kv_len, C): where its
// blocks fill at most half of the SMs and the attention over kv_len keys is
// cheap against the out-projection (8 kv_len < C, as X1's rule in
// fused_block.cu with kv_len for N), the out-projection's NC-column chunks
// are split over blocks, each of which computes its rows' attention; a
// block takes enough chunks that the blocks fit in one wave. Returns the
// chunks a block takes.
int column_chunks(int batch, int n, int kv_len, int c, const attn::Choice& pb, int sms) {
  const int chunks = (c + pb.nc - 1) / pb.nc;
  const long long blocks = (long long)(n + pb.bq - 1) / pb.bq * batch;
  if (8 * kv_len >= c || 2 * blocks > sms) return chunks;
  return (int)((chunks * blocks + sms - 1) / sms);
}

// The plans of every launch: launch 1's, launch 2's (its shared memory
// bytes, the chunks a block takes and the column splits), and K2's per GEMM
// (14 values, sdt::geglu_ff_plans) with its k-split scratch in elements.
struct Plans {
  qkv::Plan q;
  attn::Choice att;
  int bytes, cps, splits;
  int ff[14];
  long long ws;
};

cudaError_t plans(int batch, int n, int c, int d, int kv_len, int inner, Plans* p) {
  if (d <= 0 || c % d || c % 8 || batch <= 0 || n <= 0 || kv_len < 1 || inner <= 0 ||
      inner % 8 || !attn::choose<true>(d, c, &p->att))
    return cudaErrorInvalidValue;
  p->bytes = attn::Smem(p->att.bq, c, p->att.kv_bytes, p->att.nc).bytes;
  if (p->bytes > SMEM_MAX) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  p->cps = column_chunks(batch, n, kv_len, c, p->att, sms);
  p->splits = ((c + p->att.nc - 1) / p->att.nc + p->cps - 1) / p->cps;
  err = qkv::choose(batch * n, c, c, &p->q);
  if (err == cudaSuccess) err = sdt::geglu_ff_plans(batch * n, c, inner, c, true, p->ff, &p->ws);
  return err;
}

}  // namespace

// X2's plans at (batch, n, C, d, kv_len, inner): out = {launch 1 (LN2 + Q):
// rows a block, columns a tile, stages, blocks, column runs, tiles a block,
// shared memory bytes; launch 2 (attention + out-projection): query rows a
// block, keys a tile, padded head dim, output columns a wgmma step, weight
// stages, shared memory bytes, blocks resident per SM, threads, column
// splits, blocks; LN3's route (0: in launch 2, 1: a launch of its own);
// K2's plan per GEMM (7 values each, as sdt_geglu_ff_plan); the fp32
// elements of K2's k-split scratch}, 33 values. Returns a CUDA error code.
extern "C" int sdt_tail_fused_plan(int batch, int n, int c, int d, int kv_len, int inner,
                                   int* out) {
  Plans p;
  cudaError_t err = plans(batch, n, c, d, kv_len, inner, &p);
  int per_sm = 0;
  if (err == cudaSuccess && p.ws > 0x7fffffff) err = cudaErrorInvalidValue;
  if (err == cudaSuccess)
    err = sdt::smem_limit(reinterpret_cast<const void*>(p.att.kernel), p.bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.att.kernel, p.att.threads,
                                                         p.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const attn::Smem L(p.att.bq, c, p.att.kv_bytes, p.att.nc);
  const int vals[18] = {p.q.bm, p.q.bn, p.q.stages, p.q.runs * p.q.mtiles, p.q.runs,
                        p.q.tiles_per_block, p.q.bytes, p.att.bq, p.att.bk, p.att.dk, p.att.nc,
                        L.wstages, p.bytes, per_sm, p.att.threads, p.splits,
                        (n + p.att.bq - 1) / p.att.bq * batch * p.splits, p.splits > 1};
  for (int j = 0; j < 18; ++j) out[j] = vals[j];
  for (int j = 0; j < 14; ++j) out[18 + j] = p.ff[j];
  out[32] = static_cast<int>(p.ws);
  return 0;
}

// x [batch, n, c] bf16; g2, b2, bo, g3, b3, bff [c] fp32; wq, wo [c, c] bf16
// (out x in, wq pre-scaled); kc, vc [batch, nk, c] bf16 of which the first
// kv_len rows are keys; w1 [2 * inner, c] bf16 (value rows first), b1
// [2 * inner] fp32; w2 [c, inner] bf16; scratch q, x1, xln [batch * n, c] and
// h [batch * n, inner] bf16, ws fp32 of the plan's last value (or null);
// out [batch, n, c] bf16; c = heads * d; all 16-byte aligned. Returns the
// CUDA error code of the launches (0 on success); the wrapper checks shapes
// and alignment.
extern "C" int sdt_tail_fused(const void* x, const void* g2, const void* b2, const void* wq,
                              const void* wo, const void* bo, const void* kc, const void* vc,
                              const void* g3, const void* b3, const void* w1, const void* b1,
                              const void* w2, const void* bff, void* q, void* x1, void* xln,
                              void* h, void* ws, void* out, int batch, int n, int nk, int kv_len,
                              int heads, int d, int inner, void* stream) {
  const int c = heads * d;
  const int m = batch * n;
  Plans p;
  cudaError_t err = kv_len > nk ? cudaErrorInvalidValue : plans(batch, n, c, d, kv_len, inner, &p);
  if (err == cudaSuccess && p.ws > 0 && ws == nullptr) err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* x1p = static_cast<bf16*>(x1);
  bf16* xlnp = static_cast<bf16*>(xln);
  CUtensorMap mq, mwo;
  err = sdt::matrix_map(&mq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wq, c, c, qkv::BK, p.q.bn);
  if (err == cudaSuccess)
    err = sdt::matrix_map(&mwo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wo, c, c, 64, p.att.nc);
  if (err == cudaSuccess)
    err = sdt::smem_limit(reinterpret_cast<const void*>(p.q.kernel), p.q.bytes);
  if (err == cudaSuccess)
    err = sdt::smem_limit(reinterpret_cast<const void*>(p.att.kernel), p.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);

  // 1. q = bf16(LN2(x) Wq')
  p.q.kernel<<<dim3(p.q.runs, p.q.mtiles), qkv::THREADS, p.q.bytes, s>>>(
      mq, xp, static_cast<const float*>(g2), static_cast<const float*>(b2),
      static_cast<bf16*>(q), m, c, c, p.q.stages, p.q.tiles_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // 2. x1 and LN3(x1)
  attn::AttnArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(kc);
  a.v = static_cast<const bf16*>(vc);
  a.q_batch = (long long)n * c;
  a.kv_batch = (long long)nk * c;
  a.q_stride = a.kv_stride = c;
  a.n = n;
  a.nkeys = kv_len;
  a.heads = heads;
  a.d = d;
  a.x = xp;
  a.bo = static_cast<const float*>(bo);
  a.out = x1p;
  a.gamma = static_cast<const float*>(g3);
  a.beta = static_cast<const float*>(b3);
  a.ln_out = xlnp;
  p.att.kernel<<<dim3((n + p.att.bq - 1) / p.att.bq, batch, p.splits), p.att.threads, p.bytes,
                 s>>>(mwo, a, p.cps);
  err = cudaGetLastError();
  if (err == cudaSuccess && p.splits > 1) {
    const int rows = ln_block_rows(c);
    ln_rows_kernel<<<(m + rows - 1) / rows, 256, 0, s>>>(x1p, a.gamma, a.beta, xlnp, m, c);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  // 3-4. out = bf16(bf16(GEGLU(LN3(x1)) W2 + bff) + x1)
  const bf16* resid = x1p;
  return static_cast<int>(sdt::geglu_ff_forward(
      xlnp, static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(bff), resid, static_cast<bf16*>(h),
      static_cast<float*>(ws), static_cast<bf16*>(out), m, c, inner, c, s));
}
