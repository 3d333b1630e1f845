// Hash-grid encode for training (kernel K7) and its table gradient.
//
// Replaces the Pallas kernel nrc_hpm_tpu/models/nrc/encoding.py:_sweep_kernel
// (wrapper _grouped_sweep), which serves the packed-table forward of
// hash_grid_encode_train, and the one-hot matmul backward
// _level_grad_matmul.  Both exist on the TPU only because it has no vector
// gather and no atomics; here the forward gathers and the backward
// scatters with atomics, as tiny-cuda-nn's grid encoding does.
//
// Forward: one thread per (sample, level): the cell of the level, 8 corner
// gathers, the trilinear sum, one float2 store into the (N, L*2) output.
// PACKED reads the bf16-packed (P,) word table (the JAX
// hash_grid_encode_train forward); otherwise the (P, 2) float32 table (the
// JAX hash_grid_encode, used for tables above 2^16 entries per level).
//
// Backward: the same threads add w * g into a zeroed (P, 2) float32
// gradient with one float2 atomicAdd per corner.  Under PACKED each w * g
// is rounded to bf16 first, as the JAX backward casts its operand to bf16
// before an f32-accumulated matmul.  x gets no gradient.
//
// What bounds them on the H100: per sample and level 8 random 4- or
// 8-byte reads (forward) or atomics (backward) into a table that stays in
// the 50 MB L2 (2^19 entries per level: 57 MB of float32 pairs over all
// levels, mostly resident); the coarse dense levels take many atomics on
// few rows.  The simple design leaves both to the L2: no shared-memory
// staging, no warp-level pre-reduction of colliding atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "hash_grid.cuh"

namespace {

using hash_grid::Cell;
using hash_grid::Levels;

constexpr int THREADS = 256;

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
hash_grid_train_fwd_kernel(const float* __restrict__ x,
                           const void* __restrict__ table, Levels lv,
                           int n_levels, long long n_threads,
                           float2* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_threads) return;
  const long long s = t / n_levels;
  const int l = (int)(t - s * n_levels);
  const Cell cell =
      hash_grid::cell_of(x[3 * s], x[3 * s + 1], x[3 * s + 2], lv.scale[l]);
  float f0 = 0.0f, f1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = hash_grid::corner_weight(cell, c);
    const uint32_t idx = lv.offset[l] + hash_grid::corner_index(
                                            cell, c, lv.res[l], lv.dense[l],
                                            lv.params[l]);
    float v0, v1;
    if (PACKED) {
      const uint32_t word = __ldg(static_cast<const uint32_t*>(table) + idx);
      v0 = bf16::hi(word);
      v1 = bf16::lo(word);
    } else {
      const float2 v = __ldg(static_cast<const float2*>(table) + idx);
      v0 = v.x;
      v1 = v.y;
    }
    f0 = __fadd_rn(f0, __fmul_rn(v0, w));
    f1 = __fadd_rn(f1, __fmul_rn(v1, w));
  }
  out[t] = make_float2(f0, f1);
}

__device__ __forceinline__ void add2(float2* dst, float a, float b) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(dst, make_float2(a, b));
#else
  atomicAdd(&dst->x, a);
  atomicAdd(&dst->y, b);
#endif
}

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
hash_grid_train_bwd_kernel(const float* __restrict__ x,
                           const float2* __restrict__ gout, Levels lv,
                           int n_levels, long long n_threads,
                           float2* __restrict__ dtable) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_threads) return;
  const long long s = t / n_levels;
  const int l = (int)(t - s * n_levels);
  const float2 g = gout[t];
  const Cell cell =
      hash_grid::cell_of(x[3 * s], x[3 * s + 1], x[3 * s + 2], lv.scale[l]);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = hash_grid::corner_weight(cell, c);
    const uint32_t idx = lv.offset[l] + hash_grid::corner_index(
                                            cell, c, lv.res[l], lv.dense[l],
                                            lv.params[l]);
    float v0 = __fmul_rn(w, g.x), v1 = __fmul_rn(w, g.y);
    if (PACKED) {
      v0 = bf16::round_rn(v0);
      v1 = bf16::round_rn(v1);
    }
    add2(dtable + idx, v0, v1);
  }
}

int blocks_for(long long n_threads) {
  return (int)((n_threads + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" int hash_grid_train_fwd_launch(
    const void* x, int n, const void* table, int packed,
    const float* level_scale, const int* level_res, const int* level_dense,
    const unsigned* level_params, const int* level_offset, int n_levels,
    void* out, void* stream) {
  if (n_levels < 1 || n_levels > hash_grid::MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  const Levels lv = hash_grid::make_levels(level_scale, level_res,
                                           level_dense, level_params,
                                           level_offset, n_levels);
  const long long n_threads = (long long)n * n_levels;
  const cudaStream_t st = (cudaStream_t)stream;
  if (packed)
    hash_grid_train_fwd_kernel<true><<<blocks_for(n_threads), THREADS, 0,
                                       st>>>(
        (const float*)x, table, lv, n_levels, n_threads, (float2*)out);
  else
    hash_grid_train_fwd_kernel<false><<<blocks_for(n_threads), THREADS, 0,
                                        st>>>(
        (const float*)x, table, lv, n_levels, n_threads, (float2*)out);
  return (int)cudaGetLastError();
}

extern "C" int hash_grid_train_bwd_launch(
    const void* x, const void* gout, int n, int packed,
    const float* level_scale, const int* level_res, const int* level_dense,
    const unsigned* level_params, const int* level_offset, int n_levels,
    void* dtable, void* stream) {
  if (n_levels < 1 || n_levels > hash_grid::MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  const Levels lv = hash_grid::make_levels(level_scale, level_res,
                                           level_dense, level_params,
                                           level_offset, n_levels);
  const long long n_threads = (long long)n * n_levels;
  const cudaStream_t st = (cudaStream_t)stream;
  if (packed)
    hash_grid_train_bwd_kernel<true><<<blocks_for(n_threads), THREADS, 0,
                                       st>>>(
        (const float*)x, (const float2*)gout, lv, n_levels, n_threads,
        (float2*)dtable);
  else
    hash_grid_train_bwd_kernel<false><<<blocks_for(n_threads), THREADS, 0,
                                        st>>>(
        (const float*)x, (const float2*)gout, lv, n_levels, n_threads,
        (float2*)dtable);
  return (int)cudaGetLastError();
}

extern "C" const char* hash_grid_train_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
