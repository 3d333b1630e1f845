// bf16 helpers shared by the CUDA sources: the two halves of a 32-bit word
// that packs two bf16 values, round-to-nearest-even to bf16, and the
// packing of two float32 values into such a word.
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

// bf16(a) in the low half, bf16(b) in the high half.
__device__ __forceinline__ uint32_t pack(float a, float b) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
  return lo | (hi << 16);
}

}  // namespace bf16
