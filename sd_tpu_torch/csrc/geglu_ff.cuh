// K2's GEGLU feed-forward (geglu_ff.cu) as X2 (tail_fused.cu) calls it:
// both GEMMs on the plans K2 chooses, with an optional residual added in
// the second GEMM's epilogue (or in its k-split reduction):
//   h = bf16((x W1a^T + b1a) * gelu(x W1g^T + b1g))
//   y = bf16(h W2^T + b2), or bf16(bf16(h W2^T + b2) + resid) given resid.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sdt {

// x [m, c], w1 [2 inner, c] (value rows first), b1 [2 inner] fp32, w2
// [c_out, inner], b2 [c_out] fp32, resid [m, c_out] or null, h [m, inner]
// scratch, ws fp32 scratch of geglu_ff_plans' *ws_elems (or null), y [m,
// c_out]; all 16-byte aligned, c, inner and c_out multiples of 8.
cudaError_t geglu_ff_forward(const __nv_bfloat16* x, const __nv_bfloat16* w1, const float* b1,
                             const __nv_bfloat16* w2, const float* b2,
                             const __nv_bfloat16* resid, __nv_bfloat16* h, float* ws,
                             __nv_bfloat16* y, int m, int c, int inner, int c_out,
                             cudaStream_t stream);

// The plans of both GEMMs at this shape (with the residual epilogue or
// without): out = {rows a tile, output columns a tile, stages, tiles,
// blocks launched, k splits, CTAs a cluster} per GEMM, 14 values (or null),
// and the fp32 elements of the k-split scratch (0: none) into *ws_elems (or
// null).
cudaError_t geglu_ff_plans(int m, int c, int inner, int c_out, bool resid, int* out,
                           long long* ws_elems);

}  // namespace sdt
