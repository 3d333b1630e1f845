// bf16 helpers shared by the CUDA sources: the two halves of a 32-bit word
// that packs two bf16 values, and round-to-nearest-even to bf16.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16 {

// The bf16 value in the low half of w, as float32.
__device__ __forceinline__ float lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

// The bf16 value in the high half of w, as float32.
__device__ __forceinline__ float hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ float round_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace bf16
