// Draw kernels of the RNG and draw glue (utils/rng.py): one launch per draw
// call of the frame path.
//
// They replace no Pallas kernel.  The JAX package leaves this glue to XLA,
// which fuses each draw (Bob Jenkins' one-at-a-time hash on a float
// state's bits, the mantissa trick to a float in [0, 1)) into the ops
// around it.  PyTorch runs eagerly, and on the CPU it has no uint32
// shifts, so the port's plain versions hold each uint32 in an int64
// tensor: one hash round is 11 PyTorch ops, one uniform about 20, and an
// indexed draw two hashes and the float over an (N, n) int64 tensor.  The
// frame path makes some 1,000 such calls a frame, and every cell of the
// benchmark is bound by the host's launches; these kernels compute each
// call in native uint32 in one launch.
//
//   uniform_kernel        RandFloat: (sample, new state) of every lane
//   masked_uniform_kernel the same; lanes off the mask keep their state
//   advance_dead_kernel   `steps` draws on the lanes that are not alive
//   indexed_draws_kernel  hash(seed ^ hash(salt + k)), k in [k0, k0 + n),
//                         event axis last (LEAD false) or first (true)
//   init_state_kernel     InitRandom from the pixel UVs and the frame seed
//
// What bounds them on the H100: bytes.  A lane's few dozen integer
// instructions are far below what its 4-16 bytes of traffic allow, so
// each kernel is one grid-stride pass that reads its inputs once and
// writes its outputs once, neighbouring threads on neighbouring words:
// uniform reads 4 B and writes 8 B a lane, indexed_draws reads 4 B a lane
// and writes 4 B an event (2,073,600 lanes x 8 events: about 75 MB, 22 us
// at 3.35 TB/s).  The grid is capped at 16 blocks an SM; a small call is
// its launch.
//
// Bitwise the plain versions: the state's bits are read by reinterpreting
// the float, the hash wraps in uint32 where the plain version masks to 32
// bits, the float is (m & 0x7FFFFF) | 0x3F800000 minus 1.0f, a sample is
// one multiply by maxval, and the file is compiled with -fmad=false.  The
// hash and the float live in rng.cuh, which the ReSTIR reuse kernels share.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rng.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 16;

using rng::float_construct;
using rng::hash_u32;
using rng::random1;
using rng::random2;

__global__ void __launch_bounds__(THREADS)
uniform_kernel(const float* __restrict__ state, float maxval, long long n,
               float* __restrict__ sample, float* __restrict__ new_state) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float s = random1(state[i]);
    new_state[i] = s;
    sample[i] = s * maxval;
  }
}

__global__ void __launch_bounds__(THREADS)
masked_uniform_kernel(const float* __restrict__ state,
                      const bool* __restrict__ active, float maxval,
                      long long n, float* __restrict__ sample,
                      float* __restrict__ new_state) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float old = state[i];
    const float s = random1(old);
    new_state[i] = active[i] ? s : old;
    sample[i] = s * maxval;
  }
}

__global__ void __launch_bounds__(THREADS)
advance_dead_kernel(const float* __restrict__ state,
                    const bool* __restrict__ alive, int steps, long long n,
                    float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = state[i];
    if (!alive[i])
      for (int k = 0; k < steps; ++k) s = random1(s);
    out[i] = s;
  }
}

// One thread per output element e of an (lanes, n) (LEAD false) or (n,
// lanes) (LEAD true) layout; the wrapper keeps lanes * n below 2^31.
template <bool LEAD>
__global__ void __launch_bounds__(THREADS)
indexed_draws_kernel(const uint32_t* __restrict__ seed, uint32_t k0,
                     uint32_t salt, unsigned lanes, unsigned n,
                     unsigned total, float* __restrict__ out) {
  for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const unsigned lane = LEAD ? e % lanes : e / n;
    const unsigned k = LEAD ? e / lanes : e % n;
    out[e] = float_construct(hash_u32(__ldg(seed + lane) ^
                                      hash_u32(k0 + k + salt)));
  }
}

__global__ void __launch_bounds__(THREADS)
init_state_kernel(const float* __restrict__ frag_uv,
                  const float* __restrict__ frame_random, long long n,
                  float* __restrict__ out) {
  const uint32_t m4 = __float_as_uint(frame_random[0]) ^
                      hash_u32(__float_as_uint(frame_random[1])) ^
                      hash_u32(__float_as_uint(frame_random[2])) ^
                      hash_u32(__float_as_uint(frame_random[3]));
  const float r4 = float_construct(hash_u32(m4));
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = random2(random2(frag_uv[2 * i], frag_uv[2 * i + 1]), r4);
  }
}

int grid_for(long long n) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return -1;
  const long long tiles = (n + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  return (int)(tiles < cap ? tiles : cap);
}

}  // namespace

extern "C" int rng_uniform_launch(const void* state, float maxval,
                                  long long n, void* sample, void* new_state,
                                  void* stream) {
  const int blocks = grid_for(n);
  if (n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  uniform_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)state, maxval, n, (float*)sample, (float*)new_state);
  return (int)cudaGetLastError();
}

extern "C" int rng_masked_uniform_launch(const void* state,
                                         const void* active, float maxval,
                                         long long n, void* sample,
                                         void* new_state, void* stream) {
  const int blocks = grid_for(n);
  if (n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  masked_uniform_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)state, (const bool*)active, maxval, n, (float*)sample,
      (float*)new_state);
  return (int)cudaGetLastError();
}

extern "C" int rng_advance_dead_launch(const void* state, const void* alive,
                                       int steps, long long n, void* out,
                                       void* stream) {
  const int blocks = grid_for(n);
  if (n < 1 || steps < 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  advance_dead_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)state, (const bool*)alive, steps, n, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int rng_indexed_draws_launch(const void* seed, unsigned k0,
                                        unsigned salt, int lanes, int n,
                                        int lead, void* out, void* stream) {
  const long long total = (long long)lanes * n;
  const int blocks = grid_for(total);
  if (lanes < 1 || n < 1 || total >= (1LL << 31) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (lead)
    indexed_draws_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)seed, k0, salt, lanes, n, (unsigned)total,
        (float*)out);
  else
    indexed_draws_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)seed, k0, salt, lanes, n, (unsigned)total,
        (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int rng_init_state_launch(const void* frag_uv,
                                     const void* frame_random, long long n,
                                     void* out, void* stream) {
  const int blocks = grid_for(n);
  if (n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  init_state_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)frag_uv, (const float*)frame_random, n, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* rng_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
