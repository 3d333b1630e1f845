// Fully fused NRC inference (kernel K3): hash-grid encode -> OneBlob ->
// ones padding -> bias-free ReLU MLP, one pass per sample.
//
// Replaces the Pallas kernel nrc_hpm_tpu/ops/fused_encode_mlp.py:_kernel
// (wrapper fused_encode_mlp_infer).
//
// What bounds it on the H100: per sample, 16 levels x 8 corners = 128
// random 4-byte reads from the bf16-packed table (2^19 entries per level:
// 28.5 MB, which stays resident in the 50 MB L2), and 6 x 64 x 64 + 64 x 3
// ~ 24.8 k multiply-adds for the network.  The simple design: one thread
// per sample, gathers straight from global memory (L2), all 7 layer
// matrices (47.5 KB of bf16, layer 0 padded to 64 rows) in dynamic shared
// memory, loaded once per persistent block; the activations stay in
// registers and each product is a plain FMA loop in float32 on bf16
// values, with every weight read a warp-wide shared-memory broadcast
// (the row loop is csrc/mlp.cuh's, shared with K4).  Tensor cores
// (mma.sync / wgmma) are left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "hash_grid.cuh"
#include "mlp.cuh"

namespace {

using hash_grid::Levels;
using hash_grid::MAX_LEVELS;
using mlp::fma_row;

constexpr int THREADS = 128;
constexpr int WIDTH = 64;      // hidden width (and padded input width)
constexpr int OUT_PAD = 8;     // output columns padded to one 16-byte row
constexpr int MAX_BINS = 8;

__global__ void __launch_bounds__(THREADS)
fused_encode_mlp_kernel(const float* __restrict__ x5,
                        const uint32_t* __restrict__ table,
                        const uint4* __restrict__ weights, Levels lv,
                        int n_levels, int n_bins, float denom, int in_dim,
                        int depth, int out_dim, int n,
                        float* __restrict__ out) {
  extern __shared__ uint4 w_smem[];
  const int n_vec = (depth * WIDTH * WIDTH + WIDTH * OUT_PAD) / 8;
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x)
    w_smem[i] = weights[i];
  __syncthreads();

  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < n;
       s += gridDim.x * blockDim.x) {
    const float x = x5[5 * s], y = x5[5 * s + 1], z = x5[5 * s + 2];
    float h[WIDTH];

    // -- hash-grid encode ----------------------------------------------
#pragma unroll
    for (int l = 0; l < MAX_LEVELS; ++l) {
      float f0 = 0.0f, f1 = 0.0f;
      if (l < n_levels) {
        const hash_grid::Cell cell = hash_grid::cell_of(x, y, z, lv.scale[l]);
        const uint32_t* tbl = table + lv.offset[l];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float wc = hash_grid::corner_weight(cell, c);
          const uint32_t idx = hash_grid::corner_index(
              cell, c, lv.res[l], lv.dense[l], lv.params[l]);
          const uint32_t word = __ldg(tbl + idx);
          f0 += bf16::hi(word) * wc;
          f1 += bf16::lo(word) * wc;
        }
      }
      h[2 * l] = f0;
      h[2 * l + 1] = f1;
    }
    // -- OneBlob on (theta, phi), ones padding, zeros beyond in_dim --------
    const int base = 2 * n_levels;
#pragma unroll
    for (int k = 2 * MAX_LEVELS; k < WIDTH; ++k) h[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) {
      if (k >= base) {
        float v = 0.0f;
        const int j = k - base;
        if (j < 2 * n_bins) {
          const float xd = x5[5 * s + 3 + j / n_bins];
          const int b = j % n_bins;
          const float z_hi = ((float)(b + 1) / n_bins - xd) / denom;
          const float z_lo = ((float)b / n_bins - xd) / denom;
          v = 0.5f * (erff(z_hi) - erff(z_lo));
        } else if (k < in_dim) {
          v = 1.0f;
        }
        h[k] = v;
      }
    }

    // -- MLP: depth hidden layers (layer 0 padded to 64 rows), output ------
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) h[k] = bf16::round_rn(h[k]);
    for (int m = 0; m < depth; ++m) {
      const uint4* W = w_smem + m * (WIDTH * WIDTH / 8);
      float acc[WIDTH];
#pragma unroll
      for (int j = 0; j < WIDTH; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int k = 0; k < WIDTH; ++k)
        fma_row<WIDTH / 8>(acc, h[k], W + k * (WIDTH / 8));
#pragma unroll
      for (int j = 0; j < WIDTH; ++j) h[j] = bf16::round_rn(fmaxf(acc[j], 0.0f));
    }
    const uint4* Wo = w_smem + depth * (WIDTH * WIDTH / 8);
    float acc[OUT_PAD];
#pragma unroll
    for (int j = 0; j < OUT_PAD; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) fma_row<OUT_PAD / 8>(acc, h[k], Wo + k);
#pragma unroll
    for (int j = 0; j < OUT_PAD; ++j)
      if (j < out_dim) out[(size_t)s * out_dim + j] = acc[j];
  }
}

}  // namespace

extern "C" int fused_encode_mlp_launch(
    const void* x5, int n, const void* table, const void* weights,
    const float* level_scale, const int* level_res, const int* level_dense,
    const unsigned* level_params, const int* level_offset, int n_levels,
    int n_bins, float denom, int in_dim, int depth, int out_dim, void* out,
    void* stream) {
  if (n_levels > MAX_LEVELS || n_bins > MAX_BINS || in_dim > WIDTH ||
      out_dim > OUT_PAD || 2 * n_levels + 2 * n_bins > in_dim)
    return (int)cudaErrorInvalidValue;
  const Levels lv = hash_grid::make_levels(level_scale, level_res,
                                           level_dense, level_params,
                                           level_offset, n_levels);
  const size_t smem =
      (size_t)(depth * WIDTH * WIDTH + WIDTH * OUT_PAD) * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      fused_encode_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_encode_mlp_kernel, THREADS, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (n + THREADS - 1) / THREADS;
  const int blocks = tiles < sms * per_sm ? tiles : sms * per_sm;
  fused_encode_mlp_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x5, (const uint32_t*)table, (const uint4*)weights, lv,
      n_levels, n_bins, denom, in_dim, depth, out_dim, n, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_encode_mlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
