// The shader RNG on the card, shared by the CUDA sources that draw: Bob
// Jenkins' one-at-a-time hash on a float state's IEEE-754 bits and the
// mantissa trick to a float in [0, 1), in native uint32 (utils/rng.py's
// plain versions hold each uint32 in an int64 and mask to 32 bits).  The
// one float operation is an explicit round-to-nearest subtraction, so it
// rounds as the plain versions' does under any -fmad setting.
#pragma once

#include <stdint.h>

namespace rng {

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x = x + (x << 10);
  x = x ^ (x >> 6);
  x = x + (x << 3);
  x = x ^ (x >> 11);
  x = x + (x << 15);
  return x;
}

__device__ __forceinline__ float float_construct(uint32_t m) {
  return __fsub_rn(__uint_as_float((m & 0x007FFFFFu) | 0x3F800000u), 1.0f);
}

// RandFloat's step: the new state, which is also the sample at maxval 1.
__device__ __forceinline__ float random1(float x) {
  return float_construct(hash_u32(__float_as_uint(x)));
}

__device__ __forceinline__ float random2(float x, float y) {
  return float_construct(hash_u32(__float_as_uint(x) ^
                                  hash_u32(__float_as_uint(y))));
}

}  // namespace rng
