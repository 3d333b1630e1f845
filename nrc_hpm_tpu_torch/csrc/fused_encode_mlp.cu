// Fully fused NRC inference (kernel K3): hash-grid encode -> OneBlob ->
// ones padding -> bias-free ReLU MLP on the tensor cores.
//
// Replaces the Pallas kernel nrc_hpm_tpu/ops/fused_encode_mlp.py:_kernel
// (wrapper fused_encode_mlp_infer).
//
// What bounds it on the H100: per sample, 16 levels x 8 corners = 128
// random 4-byte reads from the bf16-packed table (2^19 entries per level:
// 28.5 MB, which stays resident in the 50 MB L2), and 2 x (6 x 64 x 64 +
// 64 x 3) ~ 50 k bf16 operations for the network (51.9 GFLOP at 2^20
// samples: 0.053 ms at the tensor cores' 989 TFLOP/s).  Once the network
// runs on the tensor cores, the L2 gathers set the pace.
//
// The design is tiny-cuda-nn's fully fused MLP on Hopper's mma.sync.  A
// persistent block of 4 warps keeps every weight matrix in shared memory
// (49 KB at depth 6, in the layout kernel_weights() prepares for ldmatrix),
// loaded once; each warp walks tiles of 32 samples on its own:
// - encode: each thread takes one sample of the tile and its 16 (sample,
//   level) pairs, each pair 8 independent corner gathers summed in corner
//   order; the features, OneBlob and the ones padding go as bf16 into the
//   warp's [32][64] shared-memory tile, one 16-byte chunk at a time;
// - MLP: the warp loads the tile as A fragments (ldmatrix) and runs every
//   layer as mma.sync m16n8k16 (csrc/mlp_mma.cuh); the activations stay in
//   registers between layers, rounded bf16(max(acc, 0)) as the plain
//   version rounds them.
// A warp reads only the rows its own threads wrote, so the tile needs no
// block-wide barrier, and one warp's gathers overlap another's products.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "hash_grid.cuh"
#include "mlp_mma.cuh"

namespace {

using hash_grid::Levels;
using hash_grid::MAX_LEVELS;

constexpr int WIDTH = 64;                   // the MLP's width and in_dim cap
constexpr int KSTEPS = WIDTH / 16;
constexpr int ROW_BYTES = mlp_mma::row_bytes(WIDTH);
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_ROWS = 32;               // samples per warp tile
constexpr int MT = WARP_ROWS / 16;          // m16 row tiles per warp
constexpr int OUT_PAD = 8;                  // output layer: one n-tile
constexpr int MAX_BINS = 8;
constexpr int TILE_BYTES = WARP_ROWS * ROW_BYTES;

// OneBlob bin of (theta, phi), the ones padding, or zero past in_dim, for
// input column k >= 2 n_levels.
__device__ __forceinline__ float blob_or_pad(int k, int base, float th,
                                             float ph, int n_bins,
                                             float denom, int in_dim) {
  const int j = k - base;
  if (j < 2 * n_bins) {
    const float xd = j < n_bins ? th : ph;
    const int b = j % n_bins;
    const float z_hi = ((float)(b + 1) / n_bins - xd) / denom;
    const float z_lo = ((float)b / n_bins - xd) / denom;
    return 0.5f * (erff(z_hi) - erff(z_lo));
  }
  return k < in_dim ? 1.0f : 0.0f;
}

// The two features of level l at (x, y, z): 8 corner gathers, then the
// trilinear sum in corner order.
__device__ __forceinline__ void level_features(
    const uint32_t* __restrict__ table, const Levels& lv, int l, float x,
    float y, float z, float& f0, float& f1) {
  const hash_grid::Cell cell = hash_grid::cell_of(x, y, z, lv.scale[l]);
  const uint32_t* tbl = table + lv.offset[l];
  uint32_t word[8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
    word[c] = __ldg(tbl + hash_grid::corner_index(cell, c, lv.res[l],
                                                  lv.dense[l], lv.params[l]));
  f0 = 0.0f;
  f1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wc = hash_grid::corner_weight(cell, c);
    f0 = __fadd_rn(f0, __fmul_rn(bf16::hi(word[c]), wc));
    f1 = __fadd_rn(f1, __fmul_rn(bf16::lo(word[c]), wc));
  }
}

// Row `row` of a warp tile: the 64 network inputs of one sample (x5 row
// xr) as bf16, written 8 values (one swizzled 16-byte chunk) at a time.
__device__ __forceinline__ void encode_row(
    uint8_t* tile, int row, const float* __restrict__ xr,
    const uint32_t* __restrict__ table, const Levels& lv, int n_levels,
    int n_bins, float denom, int in_dim) {
  const float x = xr[0], y = xr[1], z = xr[2], th = xr[3], ph = xr[4];
  const int base = 2 * n_levels;
#pragma unroll
  for (int c = 0; c < WIDTH / 8; ++c) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = 4 * c + q;   // columns 2l, 2l + 1
      float f0 = 0.0f, f1 = 0.0f;
      // levels past n_levels read row 0 of level 0 (make_levels), so the
      // chunk's gathers issue together, unconditionally
      if (l < MAX_LEVELS) level_features(table, lv, l, x, y, z, f0, f1);
      if (l >= n_levels) {
        f0 = blob_or_pad(2 * l, base, th, ph, n_bins, denom, in_dim);
        f1 = blob_or_pad(2 * l + 1, base, th, ph, n_bins, denom, in_dim);
      }
      w[q] = bf16::pack(f0, f1);
    }
    *reinterpret_cast<uint4*>(tile + mlp_mma::offset(row, c, WIDTH)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__global__ void __launch_bounds__(THREADS, 3)
fused_encode_mlp_kernel(const float* __restrict__ x5,
                        const uint32_t* __restrict__ table,
                        const uint4* __restrict__ weights, Levels lv,
                        int n_levels, int n_bins, float denom, int in_dim,
                        int depth, int out_dim, int n,
                        float* __restrict__ out) {
  extern __shared__ uint4 smem[];
  const int n_vec = (depth * WIDTH + OUT_PAD) * ROW_BYTES / 16;
  for (int i = threadIdx.x; i < n_vec; i += THREADS) smem[i] = weights[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t* tile = reinterpret_cast<uint8_t*>(smem + n_vec) + warp * TILE_BYTES;
  const uint32_t w_addr = mlp_mma::smem_addr(smem);
  const uint32_t tile_addr = mlp_mma::smem_addr(tile);
  const int g = lane >> 2, tq = lane & 3;
  const int n_tiles = (n + WARP_ROWS - 1) / WARP_ROWS;
  for (int t = blockIdx.x * WARPS + warp; t < n_tiles;
       t += gridDim.x * WARPS) {
    const int s0 = t * WARP_ROWS;
    // rows past n encode the last sample again; their outputs are dropped
    const int s = min(s0 + lane, n - 1);
    encode_row(tile, lane, x5 + 5 * (size_t)s, table, lv, n_levels, n_bins,
               denom, in_dim);
    __syncwarp();
    uint32_t a[MT][KSTEPS][4];
    mlp_mma::load_a<MT, WIDTH>(a, tile_addr, 0);
    __syncwarp();  // the tile is free for the next encode from here

    for (int m = 0; m < depth; ++m)
      mlp_mma::hidden_layer<MT, WIDTH>(a, w_addr + m * WIDTH * ROW_BYTES);
    float o[MT][4];
    mlp_mma::output_layer<MT, WIDTH>(a, w_addr + depth * WIDTH * ROW_BYTES,
                                    o);
    // o[mt][2 h + e]: row 16 mt + g + 8 h, column 2 tq + e
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = s0 + 16 * mt + g + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 2 * tq + e;
          if (row < n && col < out_dim)
            out[(size_t)row * out_dim + col] = o[mt][2 * h + e];
        }
      }
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
      out_dim > OUT_PAD || 2 * n_levels + 2 * n_bins > in_dim || depth < 1)
    return (int)cudaErrorInvalidValue;
  const Levels lv = hash_grid::make_levels(level_scale, level_res,
                                           level_dense, level_params,
                                           level_offset, n_levels);
  const size_t smem =
      (size_t)(depth * WIDTH + OUT_PAD) * ROW_BYTES + WARPS * TILE_BYTES;
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
  const int block_tiles = (n + WARPS * WARP_ROWS - 1) / (WARPS * WARP_ROWS);
  const int blocks = block_tiles < sms * per_sm ? block_tiles : sms * per_sm;
  fused_encode_mlp_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x5, (const uint32_t*)table, (const uint4*)weights, lv,
      n_levels, n_bins, denom, in_dim, depth, out_dim, n, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_encode_mlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
