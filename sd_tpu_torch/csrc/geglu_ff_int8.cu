// K4: the W8A8 GEGLU feed-forward for Hopper (sm_90a):
//   a = q(x) W1a^T * (sx * sw1a) + b1a,  g = q(x) W1g^T * (sx * sw1g) + b1g,
//   h = a * gelu_fast(g)  (fp32),  y = q(h) W2^T * (sh * sw2) + b2  (bf16)
// x [M, C] bf16 quantized per row; W1a, W1g [I, C] and W2 [C_out, I] int8
// quantized per output channel at load time; h quantized per row over all
// of I, in fp32 (it is not rounded to bf16 first); gelu_fast is sd_tpu's
// degree-6 erf polynomial (_ERF_FAST), whatever the input type.
//
// Replaces the TPU kernel `_kernel_int8` called through `_geglu_ff_int8` in
// sd_tpu/ops/pallas/geglu_ff.py. That kernel keeps a whole [bm, I] row tile
// of fp32 h in VMEM and quantizes each row against its max over all I
// (up to 5120) before the output product. At 5120 fp32 values a row, 64 rows
// are 1.3 MB, far above the 227 KB of shared memory a block may use, and a
// row's max is only known once every column tile of it is done. So the port
// runs three launches, all written here:
//   1. the gated int8 GEMM (int8_gemm.cuh, Epi::GEGLU): each block
//      quantizes its 64 rows of x whole (C <= 1280), computes matching value
//      and gate tiles, writes fp32 h and raises each row's max |h| with
//      atomicMax on the float's bits (non-negative, so the order is the
//      integers');
//   2. one block per row quantizes h against its row max into int8 and
//      writes the row's scale;
//   3. the int8 GEMM h_q W2^T with the bf16 dequant + bias epilogue.
//
// What bounds it on the H100: 6 M C I int8 operations; the fp32 h round
// trip (M I * 4 bytes out and in, M I bytes of codes) is the price of the
// row max and makes the small-M sites bound by bytes. WMMA m16n16k16 int8,
// no cp.async/TMA pipeline and no wgmma yet.

#include "int8_gemm.cuh"

namespace {

using sdt_i8::quant;
using sdt_i8::quant_scale;

constexpr int kRowThreads = 256;

// one block per row: hq[row, :] = q(h[row, :]) against rowmax[row]
__global__ void __launch_bounds__(kRowThreads)
quant_rows_kernel(const float* __restrict__ h, const float* __restrict__ rowmax,
                  signed char* __restrict__ hq, float* __restrict__ sh, int inner) {
  const int row = blockIdx.x;
  const float s = quant_scale(rowmax[row]);
  if (threadIdx.x == 0) sh[row] = s;
  const float4* src = reinterpret_cast<const float4*>(h + (size_t)row * inner);
  char4* dst = reinterpret_cast<char4*>(hq + (size_t)row * inner);
  for (int i = threadIdx.x; i < inner / 4; i += kRowThreads) {
    const float4 v = src[i];
    dst[i] = make_char4(quant(v.x, s), quant(v.y, s), quant(v.z, s), quant(v.w, s));
  }
}

}  // namespace

// x [m, c] bf16; w1aq, w1gq [inner, c] int8 with scales s1a, s1g [inner]
// and biases b1a, b1g [inner] fp32; w2q [c_out, inner] int8 with s2, b2
// [c_out] fp32; scratch: h [m, inner] fp32, rowmax [m] fp32 (zeroed), hq
// [m, inner] int8, sh [m] fp32; y [m, c_out] bf16. c and inner must be
// multiples of 16, c at most 2560. Returns the CUDA error code.
extern "C" int sdt_geglu_ff_int8(const void* x, const void* w1aq, const void* s1a,
                                 const void* b1a, const void* w1gq, const void* s1g,
                                 const void* b1g, const void* w2q, const void* s2,
                                 const void* b2, void* h, void* rowmax, void* hq, void* sh,
                                 void* y, int m, int c, int inner, int c_out, void* stream) {
  using namespace sdt_i8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_gemm<true, Epi::GEGLU>(
      x, nullptr, static_cast<const signed char*>(w1aq), static_cast<const float*>(s1a),
      static_cast<const float*>(b1a), static_cast<const signed char*>(w1gq),
      static_cast<const float*>(s1g), static_cast<const float*>(b1g), h,
      static_cast<float*>(rowmax), m, inner, c, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_rows_kernel<<<m, kRowThreads, 0, s>>>(static_cast<const float*>(h),
                                              static_cast<const float*>(rowmax),
                                              static_cast<signed char*>(hq),
                                              static_cast<float*>(sh), inner);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_gemm<false, Epi::BF16>(
      hq, static_cast<const float*>(sh), static_cast<const signed char*>(w2q),
      static_cast<const float*>(s2), static_cast<const float*>(b2), nullptr, nullptr, nullptr,
      y, nullptr, m, c_out, inner, s));
}
