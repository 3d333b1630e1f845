// Multiresolution hash-grid corner math shared by the NRC kernels
// (fused_encode_mlp.cu, hash_grid_train.cu).
//
// Instant-NGP / tiny-cuda-nn conventions, as in models/nrc/encoding.py: a
// level's grid point is pos * scale + 0.5; corner c of the cell has offset
// bits ((c >> 2) & 1, (c >> 1) & 1, c & 1); a DENSE level (res^3 fits the
// table) indexes the clamped corner linearly, a hashed level XORs the
// corner coordinates times the primes (1, 2654435761, 805459861) modulo the
// level's table size.  The products and sums round exactly as the plain
// PyTorch version's, so the indices and weights agree bit for bit.
#pragma once

#include <stdint.h>

namespace hash_grid {

// The constants of one level, one 32-byte record of a device array the
// training kernels (hash_grid_train.cu) read, so they take any number of
// levels; the wrapper builds it (ops/hash_grid_train.level_table).
struct __align__(16) Level {
  float scale;
  int res;
  int dense;
  uint32_t params;
  int offset;
  int unused[3];
};

// The fused encode kernel (K3) takes its level constants by value, up to
// MAX_LEVELS of them.
constexpr int MAX_LEVELS = 16;

struct Levels {
  float scale[MAX_LEVELS];
  int res[MAX_LEVELS];
  int dense[MAX_LEVELS];
  unsigned params[MAX_LEVELS];
  int offset[MAX_LEVELS];
};

// Host side: copy the per-level arrays into a Levels (levels past
// n_levels get harmless values).
inline Levels make_levels(const float* scale, const int* res,
                          const int* dense, const unsigned* params,
                          const int* offset, int n_levels) {
  Levels lv;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    const bool on = l < n_levels;
    lv.scale[l] = on ? scale[l] : 0.0f;
    lv.res[l] = on ? res[l] : 1;
    lv.dense[l] = on ? dense[l] : 1;
    lv.params[l] = on ? params[l] : 1u;
    lv.offset[l] = on ? offset[l] : 0;
  }
  return lv;
}

// The cell of one level that holds a point: its low corner and the
// fractional position inside it.
struct Cell {
  int x0, y0, z0;
  float wx, wy, wz;
};

__device__ __forceinline__ Cell cell_of(float x, float y, float z,
                                        float sc) {
  const float px = __fadd_rn(__fmul_rn(x, sc), 0.5f);
  const float py = __fadd_rn(__fmul_rn(y, sc), 0.5f);
  const float pz = __fadd_rn(__fmul_rn(z, sc), 0.5f);
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  Cell cell;
  cell.x0 = (int)fx;
  cell.y0 = (int)fy;
  cell.z0 = (int)fz;
  cell.wx = px - fx;
  cell.wy = py - fy;
  cell.wz = pz - fz;
  return cell;
}

// Trilinear weight of corner c: (wx' * wy') * wz'.
__device__ __forceinline__ float corner_weight(const Cell& cell, int c) {
  const int bx = (c >> 2) & 1, by = (c >> 1) & 1, bz = c & 1;
  return __fmul_rn(__fmul_rn(bx ? cell.wx : 1.0f - cell.wx,
                             by ? cell.wy : 1.0f - cell.wy),
                   bz ? cell.wz : 1.0f - cell.wz);
}

// Level-local table row of corner c.
__device__ __forceinline__ uint32_t corner_index(const Cell& cell, int c,
                                                 int res, int dense,
                                                 uint32_t params) {
  const int cx = cell.x0 + ((c >> 2) & 1);
  const int cy = cell.y0 + ((c >> 1) & 1);
  const int cz = cell.z0 + (c & 1);
  if (dense) {
    const int ccx = min(max(cx, 0), res - 1);
    const int ccy = min(max(cy, 0), res - 1);
    const int ccz = min(max(cz, 0), res - 1);
    return (uint32_t)(ccx + ccy * res + ccz * (res * res));
  }
  const uint32_t hsh = (uint32_t)cx ^ ((uint32_t)cy * 2654435761u) ^
                       ((uint32_t)cz * 805459861u);
  return hsh % params;
}

// The mask that takes a hash modulo params: params - 1 where params is a
// power of two (hsh & (params - 1) == hsh % params, bit for bit), else 0
// (take the modulo).
__device__ __forceinline__ uint32_t hash_mask(uint32_t params) {
  return (params & (params - 1)) == 0 ? params - 1 : 0u;
}

// corner_index for a caller whose level is uniform across the warp (K7
// and its backward): the same row, with the hashed level's modulo taken by its
// hash_mask where it has one.
__device__ __forceinline__ uint32_t level_corner_index(const Cell& cell,
                                                       int c, int res,
                                                       bool dense,
                                                       uint32_t params,
                                                       uint32_t mask) {
  if (dense) return corner_index(cell, c, res, 1, params);
  const int cx = cell.x0 + ((c >> 2) & 1);
  const int cy = cell.y0 + ((c >> 1) & 1);
  const int cz = cell.z0 + (c & 1);
  const uint32_t hsh = (uint32_t)cx ^ ((uint32_t)cy * 2654435761u) ^
                       ((uint32_t)cz * 805459861u);
  return mask ? hsh & mask : hsh % params;
}

}  // namespace hash_grid
