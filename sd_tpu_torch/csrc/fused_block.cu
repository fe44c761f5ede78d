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
// flops, and there, as in K1, the softmax's per-logit work (exponentials on
// the special-function unit, the max and the rescale) weighs as much as the
// d = 40 products. The TPU kernel holds one batch element's [N, C] and four
// [C, C] weights in VMEM; a block here has 227 KB of shared memory, so the
// work is two launches, each written here:
//   A. LayerNorm and the QKV product (x1_qkv_kernel): a block normalises its
//      BM rows once (fp32 single-pass variance, clamped at 0) into shared
//      memory, rounded to bf16, K-major in wgmma's 128-byte-swizzled atoms,
//      and walks a run of [3C, C]'s column tiles (the wrapper's transposed
//      weight), which a producer warp streams by TMA into a ring of
//      mbarrier-guarded stages while two consumer warpgroups multiply on
//      wgmma m64nNk16 and write q (pre-scaled), k and v in bf16. LN(x) never
//      reaches device memory.
//   B. Attention and the out-projection (x1_attn_kernel): one block of four
//      warps (eight where each warp takes one m-tile and a [128, C] tile
//      fits) takes BQ query rows of one batch element and walks every head.
//      The attention is K1's design (flash_attention.cu): mma.sync m16n8k16
//      with S, P and the output accumulator in registers, each warp 16 query
//      rows or, at d <= 48, two m-tiles of 16 (BQ = 128), K and V tiles
//      double-buffered by 16-byte cp.async and read with ldmatrix (.trans
//      for V), one __syncthreads a key tile; a head's Q is copied into the
//      second K/V stage before its first tile is fetched there. Each head's
//      output, divided by its row sum and rounded to bf16, goes into its
//      columns of the block's [BQ, C] tile T, which lies in shared memory in
//      the K-major swizzled layout that wgmma reads as its A operand; the
//      attention output never reaches device memory. Then T times Wo' (the
//      wrapper's transposed Wo, [C, C] out x in) runs on wgmma, each
//      warpgroup on its 64-row m-tiles, NC output columns at a time, Wo's
//      64-deep k tiles streamed by TMA into a ring that reuses the K/V
//      stages' shared memory (the two phases are never live together), one
//      step's products in flight while the next is issued; the epilogue
//      adds bo, rounds, adds x and rounds. At C = 320 a block takes about
//      110 KB, so two blocks (eight warps) share an SM. Where N is small
//      against C (8 N < C) and the blocks cannot fill the card, the
//      out-projection's columns are split over blocks, each of which
//      computes its rows' attention itself.
// Measured on an H100 (PERF.md): at N = 4096 launch B takes over 90% of
// X1's time and about 1.3x K1 alone at [16, 4096, 8, 40]; at C = 1280 the
// [64, 1280] tile (160 KB) leaves one four-warp block an SM, too few warps
// for the attention's latencies.
// The kernels are in fused_block.cuh, which X2's attention half shares.

#include "fused_block.cuh"

namespace {

// The attention launch's column split at (batch, n, C): where its blocks
// cannot fill the card and the attention is cheap against the
// out-projection, the out-projection's NC-column chunks are split over
// blocks that each compute their rows' attention; returns the chunks a
// block takes. Cheap: 8 N < C. A block's attention takes 4 BQ N C
// operations, its out-projection 2 BQ C^2, but four warps of mma.sync do
// the first at about a quarter of the rate of wgmma (PERF.md: a split at
// (N, C) = (256, 1280) measured slower).
int column_chunks(int batch, int n, int c, const attn::Choice& pb, int sms) {
  const int chunks = (c + pb.nc - 1) / pb.nc;
  const long long blocks = (long long)(n + pb.bq - 1) / pb.bq * batch;
  if (8 * n >= c || blocks >= sms) return chunks;
  return max(1, (int)(chunks * blocks / sms));
}

// Both plans at (batch, n, C, d), or an error code where a launch does not
// fit; cps: the out-projection's column chunks a block takes.
cudaError_t plans(int batch, int n, int c, int d, qkv::Plan* pa, attn::Choice* pb, int* bytes_b,
                  int* cps) {
  if (d <= 0 || c % d || c % 8 || batch <= 0 || n <= 0 || !attn::choose<false>(d, c, pb))
    return cudaErrorInvalidValue;
  *bytes_b = attn::Smem(pb->bq, c, pb->kv_bytes, pb->nc).bytes;
  if (*bytes_b > SMEM_MAX) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *cps = column_chunks(batch, n, c, *pb, sms);
  return qkv::choose(batch * n, c, 3 * c, pa);
}

}  // namespace

// The query rows a block of the attention launch takes at C = heads * d, or
// 0 where the kernels do not take (C, d) (the wrapper raises then).
extern "C" int sdt_fused_block_q(int c, int d) {
  qkv::Plan pa;
  attn::Choice pb;
  int bytes_b = 0, cps = 0;
  return plans(1, 1, c, d, &pa, &pb, &bytes_b, &cps) == cudaSuccess ? pb.bq : 0;
}

// X1's plans at (batch, n, C, d): out = {launch A: rows a block, columns a
// tile, stages, blocks, column runs, tiles a block, shared memory bytes;
// launch B: query rows a block, keys a tile, padded head dim, output
// columns a wgmma step, weight stages, shared memory bytes, blocks resident
// per SM, threads, column splits, blocks}, 17 values. Returns a CUDA error
// code.
extern "C" int sdt_fused_block_plan(int batch, int n, int c, int d, int* out) {
  qkv::Plan pa;
  attn::Choice pb;
  int bytes_b = 0, cps = 0;
  cudaError_t err = plans(batch, n, c, d, &pa, &pb, &bytes_b, &cps);
  int per_sm = 0;
  if (err == cudaSuccess) err = sdt::smem_limit(reinterpret_cast<const void*>(pb.kernel), bytes_b);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pb.kernel, pb.threads, bytes_b);
  if (err == cudaSuccess) {
    const attn::Smem L(pb.bq, c, pb.kv_bytes, pb.nc);
    const int splits = ((c + pb.nc - 1) / pb.nc + cps - 1) / cps;
    const int vals[17] = {pa.bm, pa.bn, pa.stages, pa.runs * pa.mtiles, pa.runs,
                          pa.tiles_per_block, pa.bytes, pb.bq, pb.bk, pb.dk, pb.nc, L.wstages,
                          bytes_b, per_sm, pb.threads, splits,
                          (n + pb.bq - 1) / pb.bq * batch * splits};
    for (int j = 0; j < 17; ++j) out[j] = vals[j];
  }
  return static_cast<int>(err);
}

// x [batch, n, c] bf16, gamma/beta [c] fp32, wqkv [3c, c] bf16 (out x in:
// the transposed [Wq' | Wk | Wv], the query third pre-scaled), wo [c, c] bf16
// (out x in), bo [c] fp32, qkv [batch * n, 3c] bf16 scratch, out [batch, n,
// c] bf16; c = heads * d; all 16-byte aligned. Returns the CUDA error code of
// the launches (0 on success); the wrapper checks shapes and alignment.
extern "C" int sdt_fused_block(const void* x, const void* gamma, const void* beta,
                               const void* wqkv, const void* wo, const void* bo, void* qkv_out,
                               void* out, int batch, int n, int heads, int d, void* stream) {
  const int c = heads * d;
  const int m = batch * n;
  qkv::Plan pa;
  attn::Choice pb;
  int bytes_b = 0, cps = 0;
  cudaError_t err = plans(batch, n, c, d, &pa, &pb, &bytes_b, &cps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap mw, mwo;
  err = sdt::matrix_map(&mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wqkv, 3 * c, c, qkv::BK, pa.bn);
  if (err == cudaSuccess)
    err = sdt::matrix_map(&mwo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wo, c, c, 64, pb.nc);
  if (err == cudaSuccess) err = sdt::smem_limit(reinterpret_cast<const void*>(pa.kernel), pa.bytes);
  if (err == cudaSuccess) err = sdt::smem_limit(reinterpret_cast<const void*>(pb.kernel), bytes_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  pa.kernel<<<dim3(pa.runs, pa.mtiles), qkv::THREADS, pa.bytes, s>>>(
      mw, static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(qkv_out), m, c, 3 * c, pa.stages,
      pa.tiles_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = ((c + pb.nc - 1) / pb.nc + cps - 1) / cps;
  const bf16* qkv = static_cast<const bf16*>(qkv_out);
  attn::AttnArgs a = {};
  a.q = qkv;
  a.k = qkv + c;
  a.v = qkv + 2 * c;
  a.q_batch = a.kv_batch = (long long)n * 3 * c;
  a.q_stride = a.kv_stride = 3 * c;
  a.n = a.nkeys = n;
  a.heads = heads;
  a.d = d;
  a.x = static_cast<const bf16*>(x);
  a.bo = static_cast<const float*>(bo);
  a.out = static_cast<bf16*>(out);
  pb.kernel<<<dim3((n + pb.bq - 1) / pb.bq, batch, splits), pb.threads, bytes_b, s>>>(mwo, a, cps);
  return static_cast<int>(cudaGetLastError());
}
