// Hash-grid encode for training (kernel K7) and its table gradient.
//
// Replaces the Pallas kernel nrc_hpm_tpu/models/nrc/encoding.py:_sweep_kernel
// (wrapper _grouped_sweep), which serves the packed-table forward of
// hash_grid_encode_train, and the one-hot matmul backward
// _level_grad_matmul.  Both exist on the TPU only because it has no vector
// gather and no atomics; here the forward gathers and the backward
// scatters with atomics, as tiny-cuda-nn's grid encoding does.  PACKED
// reads the bf16-packed (P,) word table (the JAX hash_grid_encode_train
// forward, and inference's split encode); otherwise the (P, 2) float32
// table (the JAX hash_grid_encode, used for tables above 2^16 entries per
// level).  Both kernels read the level constants from a device array of
// hash_grid::Level records, so they take any number of levels.
//
// Forward: what bounds it on the H100 is its gathers, 8 a (sample, level)
// from a table of up to 57 MB (float32 at 2^19 entries a level, larger
// than the 50 MB L2), not its arithmetic.  A block encodes 32 samples at
// every level, a warp a level (more levels than warps take turns), so a
// level's constants and its dense or hashed branch are uniform across the
// warp, indices are 32-bit, and a hashed level of 2^k rows takes its
// modulo as a mask.  A sample's x-neighbour corners c and c + 4 are read
// as one 16-byte (float32) or 8-byte (packed) load where their rows are
// the two halves of an aligned pair (an even hashed x0 flips only the
// hash's low bit, an even dense row has its neighbour next to it), so a
// sample reads 4 to 8 table sectors a level, not 8.  The block's positions
// are staged once in shared memory, and so are its outputs, which leave
// as coalesced rows of the (N, L, 2) output rather than 8-byte stores at
// the output's row stride.  The 8 corners are summed in corner order, as
// the plain version's products are.
//
// Backward: w * g is added into a zeroed (P, 2) float32 gradient with
// atomics.  Under PACKED each w * g is rounded to bf16 first, as the JAX
// backward casts its operand to bf16 before an f32-accumulated matmul.  x
// gets no gradient.  Its layout follows tiny-cuda-nn's grid-encoding
// backward, a block of samples of one level, so a warp is 32 samples of
// one level, with the forward's uniform branches, 32-bit indices and
// masks.  The levels run from the last one down:
// the wrapper's torch.zeros has just written the table front to back, and
// its tail is the part still in L2.  A gradient the L2 holds whole (the
// packed tables) has few rows a level, so there a wave of blocks spans the
// levels rather than queueing its atomics on one level's rows.
//
// What bounds the backward on the H100 is the atomics, not the arithmetic
// (without them a level-uniform kernel took 4.5 us of 70 at 2^14 random
// samples on an H100 80GB HBM3): their count, the rows they share, and the
// sectors of a 57 MB gradient (2^19 entries a level) they pull into the
// 50 MB L2.  So each sample adds its corner c
// and x-neighbour c + 4 together, as one 16-byte atomic where their rows
// pair, as the forward loads them; and the lanes of a warp that add into
// one row, or one pair, form a group
// (__match_any_sync) whose lowest lane adds the group's sum, its terms
// taken in lane order after rounding.  A frame's own train batch repeats
// positions, so a warp's samples share rows on every level.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "hash_grid.cuh"

namespace {

using hash_grid::Cell;
using hash_grid::Level;

constexpr int THREADS = 256;
constexpr int FWD_SAMPLES = 32;  // a forward block's samples
constexpr int FWD_WARPS = 16;    // the most levels a forward block encodes
                                 // at once, a warp each
// K7's backward spreads a wave of blocks over the levels where the whole
// gradient takes at most this many bytes: a third of the H100's 50 MB L2
constexpr double SPREAD_BYTES = 16.0 * (1 << 20);

// The two features of one level at (px, py, pz), the level uniform across
// the warp: the 8 corners read as x-neighbour pairs (one load where their
// rows pair), then summed in corner order.
template <bool PACKED>
__device__ __forceinline__ float2 level_features(
    const void* __restrict__ table, const Level lv, float px, float py,
    float pz) {
  const Cell cell = hash_grid::cell_of(px, py, pz, lv.scale);
  const bool dense = lv.dense != 0;
  const uint32_t mask = hash_grid::hash_mask(lv.params);
  float v0[8], v1[8];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t r0 = lv.offset + hash_grid::level_corner_index(
                                        cell, c, lv.res, dense, lv.params,
                                        mask);
    const uint32_t r1 = lv.offset + hash_grid::level_corner_index(
                                        cell, c + 4, lv.res, dense,
                                        lv.params, mask);
    // the aligned pair of rows that holds r0 (level offsets are multiples
    // of 8 rows); r1 is its other half where the rows pair
    const bool pair = (r0 ^ r1) == 1u, odd = (r0 & 1u) != 0;
    if (PACKED) {
      const uint32_t* tbl = static_cast<const uint32_t*>(table);
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(tbl) + (r0 >> 1));
      const uint32_t w0 = odd ? q.y : q.x;
      const uint32_t w1 = pair ? (odd ? q.x : q.y) : __ldg(tbl + r1);
      v0[c] = bf16::hi(w0);
      v1[c] = bf16::lo(w0);
      v0[c + 4] = bf16::hi(w1);
      v1[c + 4] = bf16::lo(w1);
    } else {
      const float2* tbl = static_cast<const float2*>(table);
      const float4 q = __ldg(reinterpret_cast<const float4*>(tbl) + (r0 >> 1));
      const float2 lo = make_float2(q.x, q.y), hi = make_float2(q.z, q.w);
      const float2 a = odd ? hi : lo;
      const float2 b = pair ? (odd ? lo : hi) : __ldg(tbl + r1);
      v0[c] = a.x;
      v1[c] = a.y;
      v0[c + 4] = b.x;
      v1[c + 4] = b.y;
    }
  }
  float f0 = 0.0f, f1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = hash_grid::corner_weight(cell, c);
    f0 = __fadd_rn(f0, __fmul_rn(v0[c], w));
    f1 = __fadd_rn(f1, __fmul_rn(v1[c], w));
  }
  return make_float2(f0, f1);
}

// Block b encodes samples [32 b, 32 b + 32) at every level: warp w takes
// levels w, w + warps, ...; each round of levels is staged in shared
// memory and stored as the samples' rows of the (N, L) float2 output.
template <bool PACKED>
__global__ void __launch_bounds__(FWD_WARPS * 32, 2)
hash_grid_train_fwd_kernel(const float* __restrict__ x,
                           const void* __restrict__ table,
                           const Level* __restrict__ levels, int n_levels,
                           int n, float2* __restrict__ out) {
  __shared__ float pos[3 * FWD_SAMPLES];
  // a sample's row padded to an odd number of float2: the lanes' stores
  // of one level fall in different banks
  __shared__ float2 stage[FWD_SAMPLES][FWD_WARPS + 1];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s0 = blockIdx.x * FWD_SAMPLES;
  const int ns = min(FWD_SAMPLES, n - s0);
  for (int i = threadIdx.x; i < 3 * ns; i += blockDim.x)
    pos[i] = x[3 * (size_t)s0 + i];
  __syncthreads();
  // lanes past the last sample encode sample 0 again; nothing stores them
  const int s = lane < ns ? lane : 0;
  const float px = pos[3 * s], py = pos[3 * s + 1], pz = pos[3 * s + 2];
  for (int l0 = 0; l0 < n_levels; l0 += warps) {
    if (l0 + warp < n_levels)
      stage[lane][warp] =
          level_features<PACKED>(table, levels[l0 + warp], px, py, pz);
    __syncthreads();
    const int g = min(warps, n_levels - l0);
    for (int i = threadIdx.x; i < ns * g; i += blockDim.x) {
      const int si = i / g, k = i - si * g;
      out[(size_t)(s0 + si) * n_levels + l0 + k] = stage[si][k];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void add2(float2* dst, float a, float b) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(dst, make_float2(a, b));
#else
  atomicAdd(&dst->x, a);
  atomicAdd(&dst->y, b);
#endif
}

__device__ __forceinline__ void add4(float4* dst, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(dst, v);
#else
  add2(reinterpret_cast<float2*>(dst), v.x, v.y);
  add2(reinterpret_cast<float2*>(dst) + 1, v.z, v.w);
#endif
}

// The lanes of a warp whose keys are equal form a group: the group's
// lowest lane adds the group's terms, taken in lane order, into its row
// (WIDE: the aligned 16-byte pair of rows at row), one atomic for the
// group.  A lane with the key ~0u has nothing to add.  Every lane of the
// warp calls it.
template <bool WIDE>
__device__ __forceinline__ void group_add(float2* dtable, uint32_t key,
                                          uint32_t row, float4 v,
                                          float4* warp_terms) {
  const int lane = threadIdx.x & 31;
  const unsigned grp = __match_any_sync(0xFFFFFFFFu, key);
  if (key == ~0u) return;
  if (grp != 1u << lane) {
    warp_terms[lane] = v;
    __syncwarp(grp);
    const bool leader = lane == __ffs(grp) - 1;
    if (leader) {
      for (unsigned rest = grp & (grp - 1); rest; rest &= rest - 1) {
        const float4 t = warp_terms[__ffs(rest) - 1];
        v.x = __fadd_rn(v.x, t.x);
        v.y = __fadd_rn(v.y, t.y);
        if (WIDE) {
          v.z = __fadd_rn(v.z, t.z);
          v.w = __fadd_rn(v.w, t.w);
        }
      }
    }
    __syncwarp(grp);  // read before the next group_add writes
    if (!leader) return;
  }
  if (WIDE)
    add4(reinterpret_cast<float4*>(dtable + row), v);
  else
    add2(dtable + row, v.x, v.y);
}

// Block b is (a tile of THREADS samples, a level counted from the last
// one), so a warp is 32 samples of one level.  Each sample adds its corner
// c and x-neighbour c + 4 together.  Without SPREAD the level changes
// slowest with b: a wave of blocks adds into one level's rows, which keeps
// a gradient larger than the L2 in it a level at a time.  With SPREAD
// (a gradient the L2 holds whole) the level changes fastest: a wave
// spreads its atomics over every level's rows instead of queueing them on
// one level's few.
template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
hash_grid_train_bwd_kernel(const float* __restrict__ x,
                           const float2* __restrict__ gout,
                           const Level* __restrict__ levels, int n_levels,
                           int n, int spread, float2* __restrict__ dtable) {
  __shared__ float4 terms[THREADS];  // a group's terms, for its leader
  const int n_tiles = gridDim.x / n_levels;
  const int b = blockIdx.x;
  const int l = n_levels - 1 - (spread ? b % n_levels : b / n_tiles);
  const int s = (spread ? b / n_levels : b % n_tiles) * THREADS + threadIdx.x;
  const bool on = s < n;  // an idle lane still takes part in the groups
  const Level lv = levels[l];
  const int res = lv.res;
  const bool dense = lv.dense != 0;
  const uint32_t params = lv.params;
  const uint32_t mask = hash_grid::hash_mask(params);
  const uint32_t offset = (uint32_t)lv.offset;
  const int sl = on ? s : 0;
  const float2 g = gout[(size_t)sl * n_levels + l];
  const Cell cell = hash_grid::cell_of(x[3 * sl], x[3 * sl + 1],
                                       x[3 * sl + 2], lv.scale);
  float4* const warp_terms = terms + (threadIdx.x & ~31);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float w0 = hash_grid::corner_weight(cell, c);
    const float w1 = hash_grid::corner_weight(cell, c + 4);
    const uint32_t r0 = offset + hash_grid::level_corner_index(
                                     cell, c, res, dense, params, mask);
    const uint32_t r1 = offset + hash_grid::level_corner_index(
                                     cell, c + 4, res, dense, params, mask);
    float a0 = __fmul_rn(w0, g.x), a1 = __fmul_rn(w0, g.y);
    float b0 = __fmul_rn(w1, g.x), b1 = __fmul_rn(w1, g.y);
    if (PACKED) {
      a0 = bf16::round_rn(a0);
      a1 = bf16::round_rn(a1);
      b0 = bf16::round_rn(b0);
      b1 = bf16::round_rn(b1);
    }
    // the two rows are one aligned 16-byte pair (the level offsets are
    // multiples of 8): one 16-byte atomic; its group key has the top bit
    // set, above every row, and ~0u is no key
    const bool pair = (r0 ^ r1) == 1u;
    if (__any_sync(0xFFFFFFFFu, on && pair)) {
      const float4 v = r0 & 1u ? make_float4(b0, b1, a0, a1)
                               : make_float4(a0, a1, b0, b1);
      group_add<true>(dtable, on && pair ? 0x80000000u | (r0 >> 1) : ~0u,
                      r0 & ~1u, v, warp_terms);
    }
    if (__any_sync(0xFFFFFFFFu, on && !pair)) {
      const bool single = on && !pair;
      group_add<false>(dtable, single ? r0 : ~0u, r0,
                       make_float4(a0, a1, 0.0f, 0.0f), warp_terms);
      group_add<false>(dtable, single ? r1 : ~0u, r1,
                       make_float4(b0, b1, 0.0f, 0.0f), warp_terms);
    }
  }
}

}  // namespace

// x (n, 3) -> out (n, n_levels) float2; `levels` is the device array of
// n_levels Level records.
extern "C" int hash_grid_train_fwd_launch(const void* x, int n,
                                          const void* table, int packed,
                                          const void* levels, int n_levels,
                                          void* out, void* stream) {
  if (n < 1 || n_levels < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + FWD_SAMPLES - 1) / FWD_SAMPLES;
  const int threads = 32 * (n_levels < FWD_WARPS ? n_levels : FWD_WARPS);
  const cudaStream_t st = (cudaStream_t)stream;
  const Level* lv = (const Level*)levels;
  if (packed)
    hash_grid_train_fwd_kernel<true><<<blocks, threads, 0, st>>>(
        (const float*)x, table, lv, n_levels, n, (float2*)out);
  else
    hash_grid_train_fwd_kernel<false><<<blocks, threads, 0, st>>>(
        (const float*)x, table, lv, n_levels, n, (float2*)out);
  return (int)cudaGetLastError();
}

// x (n, 3), gout (n, n_levels) float2 -> += dtable (total_params, 2).
extern "C" int hash_grid_train_bwd_launch(const void* x, const void* gout,
                                          int n, int packed,
                                          const void* levels, int n_levels,
                                          long long total_params,
                                          void* dtable, void* stream) {
  if (n < 1 || n_levels < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS * n_levels;
  const int spread = 8.0 * (double)total_params <= SPREAD_BYTES;
  const cudaStream_t st = (cudaStream_t)stream;
  const Level* lv = (const Level*)levels;
  if (packed)
    hash_grid_train_bwd_kernel<true><<<blocks, THREADS, 0, st>>>(
        (const float*)x, (const float2*)gout, lv, n_levels, n, spread,
        (float2*)dtable);
  else
    hash_grid_train_bwd_kernel<false><<<blocks, THREADS, 0, st>>>(
        (const float*)x, (const float2*)gout, lv, n_levels, n, spread,
        (float2*)dtable);
  return (int)cudaGetLastError();
}

extern "C" const char* hash_grid_train_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
