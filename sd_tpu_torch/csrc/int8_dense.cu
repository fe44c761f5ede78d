// K6: the W8A8 dense projection for Hopper (sm_90a),
//   out = (q(x) Wq^T) * (sx * sw) + b,  bf16 out
// with x [M, C] bf16 quantized per row once and Wq [F, C] int8 quantized per
// output channel at load time (torch Linear layout), on the int8 wgmma GEMM
// of int8_wgmma.cuh (its header gives the design and what bounds it).
//
// Replaces the TPU kernel `_kernel` called through `int8_dense` in
// sd_tpu/ops/pallas/int8_dense.py, the `proj` bucket of the int8 serving
// mode: the self-attention's fused QKV [C, 3C], the cross-attention's q and
// every to_out. The TPU kernel quantizes a [bm, C] row tile in VMEM and
// holds the whole [C, F] weight there; here a block keeps its rows' codes
// in shared memory and streams Wq's tiles by TMA.

#include "int8_wgmma.cuh"

// x [m, c] bf16, wq [f, c] int8, sw [f] fp32, b [f] fp32, out [m, f] bf16,
// all 16-byte aligned; c a multiple of 32 and at most 1280, f of 8.
// Returns the CUDA error code.
extern "C" int sdt_int8_dense(const void* x, const void* wq, const void* sw, const void* b,
                              void* out, int m, int c, int f, void* stream) {
  using namespace sdt_i8w;
  Plan p;
  cudaError_t err = choose(m, c, f, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(int8_dense(
      p, static_cast<const bf16*>(x), static_cast<const signed char*>(wq),
      static_cast<const float*>(sw), static_cast<const float*>(b), out, nullptr, m, c, f,
      static_cast<cudaStream_t>(stream)));
}

// K6's plan at this shape: out = {rows a block, columns a tile, stages,
// blocks launched, F runs, n tiles a block, shared memory bytes}, 7 values.
// Returns a CUDA error code.
extern "C" int sdt_int8_dense_plan(int m, int c, int f, int* out) {
  using namespace sdt_i8w;
  Plan p;
  const cudaError_t err = choose(m, c, f, &p);
  if (err == cudaSuccess) {
    const int vals[7] = {p.bm, p.bn, p.stages, p.runs * p.mtiles, p.runs, p.tiles_per_block,
                         p.bytes};
    for (int j = 0; j < 7; ++j) out[j] = vals[j];
  }
  return static_cast<int>(err);
}
