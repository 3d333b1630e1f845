// Bias-free ReLU MLP device code shared by the NRC inference kernels
// (fused_encode_mlp.cu, fused_mlp.cu).
//
// Weights are bf16, row-major (in, out) matrices in shared memory, read as
// uint4 rows of 8 values; every weight read is a warp-wide broadcast, since
// all threads of a warp walk the same row.  Products of two bf16 values
// are exact in float32, so each fused multiply-add rounds exactly as the
// plain version's float32 sum of products does; only the order of the sum
// differs from a library matrix product.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "bf16.cuh"

namespace mlp {

// bf16(max(a, 0)) in the low half, bf16(max(b, 0)) in the high half.
__device__ __forceinline__ uint32_t relu_pack(float a, float b) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(fmaxf(a, 0.0f)));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(fmaxf(b, 0.0f)));
  return lo | (hi << 16);
}

// acc[0..8*Q) += h * row, row = Q x 8 bf16 starting at `row`.
template <int Q>
__device__ __forceinline__ void fma_row(float* acc, float h,
                                        const uint4* row) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const uint4 w = row[q];
    acc[8 * q + 0] += h * bf16::lo(w.x);
    acc[8 * q + 1] += h * bf16::hi(w.x);
    acc[8 * q + 2] += h * bf16::lo(w.y);
    acc[8 * q + 3] += h * bf16::hi(w.y);
    acc[8 * q + 4] += h * bf16::lo(w.z);
    acc[8 * q + 5] += h * bf16::hi(w.z);
    acc[8 * q + 6] += h * bf16::lo(w.w);
    acc[8 * q + 7] += h * bf16::hi(w.w);
  }
}

}  // namespace mlp
