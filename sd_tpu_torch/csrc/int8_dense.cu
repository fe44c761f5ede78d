// K6: the W8A8 dense projection for Hopper (sm_90a),
//   out = (q(x) Wq^T) * (sx * sw) + b,  bf16 out
// with x [M, C] bf16 quantized per row inside the kernel and Wq [F, C] int8
// quantized per output channel at load time (torch Linear layout).
//
// Replaces the TPU kernel `_kernel` called through `int8_dense` in
// sd_tpu/ops/pallas/int8_dense.py, the `proj` bucket of the int8 serving
// mode: the self-attention's fused QKV [C, 3C], the cross-attention's q and
// every to_out. The TPU kernel quantizes a [bm, C] row tile in VMEM and
// holds the whole [C, F] weight there; here every block recomputes the max
// of its 64 rows over C (at most 1280 values a row, kept whole in shared
// memory as int8 codes) and streams 64x64 weight tiles (int8_gemm.cuh).
//
// What bounds it on the H100: 2 M C F int8 operations against 2 M C bytes
// in, M F * 2 bytes out and F C bytes of weights. At the SD sites (M = 128
// ... 65536, C = 320 ... 1280, F = C or 3C) the large-M sites are above the
// int8 ridge (about 590 operations a byte), so tensor-core feed is the
// design question; this first version is WMMA m16n16k16 with no cp.async
// pipeline, so it is bound by its shared-memory traffic, not the card.

#include "int8_gemm.cuh"

// x [m, c] bf16, wq [f, c] int8, sw [f] fp32, b [f] fp32, out [m, f] bf16.
// c must be a multiple of 16 and at most 2560. Returns the CUDA error code.
extern "C" int sdt_int8_dense(const void* x, const void* wq, const void* sw, const void* b,
                              void* out, int m, int c, int f, void* stream) {
  using namespace sdt_i8;
  return static_cast<int>(launch_gemm<true, Epi::BF16>(
      x, nullptr, static_cast<const signed char*>(wq), static_cast<const float*>(sw),
      static_cast<const float*>(b), nullptr, nullptr, nullptr, out, nullptr, m, f, c,
      static_cast<cudaStream_t>(stream)));
}
