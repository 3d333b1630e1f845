// Bias-free ReLU MLP layers on the tensor cores, one warp per group of
// 16-row tiles: mma.sync m16n8k16 with bf16 operands and float32
// accumulators (used by fused_encode_mlp.cu and fused_mlp.cu).  A layer's
// depth K and width N are template parameters, multiples of 16 (a narrower
// layer is padded with zero rows and columns, which leave the result
// exact); the output layer is one n-tile of 8 columns.
//
// Layout.  A weight matrix is stored transposed, one K-value row per
// output column n, so that ldmatrix (not transposed) hands out the "col" B
// fragments directly; an activation tile is one K-value row per sample.
// Both are cut into 16-byte chunks of 8 values.  Where a row holds a
// multiple of 64 values, chunk c of row r sits at position c ^ (r & 7)
// (within its aligned group of 8 chunks) and rows follow each other; any
// other row is padded by one chunk, an odd number of 16-byte chunks a row.
// Either way the 8 row addresses of one ldmatrix fall in 8 different bank
// groups.
//
// Fragments (PTX ISA, mma.m16n8k16, groupID g = lane / 4, t = lane % 4):
// A a0/a1 hold rows g / g + 8 at k = 2t, 2t + 1, a2/a3 the same rows at
// k = 8 + 2t, 9 + 2t; the accumulator c0/c1 holds row g at n = 2t, 2t + 1,
// c2/c3 row g + 8.  So the accumulators of n-tiles 2j and 2j + 1 are, once
// rounded, exactly the A fragment of k-step j of the next layer: the
// activations can stay in registers between layers.  Each is rounded as
// bf16(max(acc, 0)), as the plain version rounds; only the order of the
// float32 sum differs from a library matrix product.
#pragma once

#include <stdint.h>

#include "bf16.cuh"

namespace mlp_mma {

// Bytes of one row of k values.
__host__ __device__ constexpr int row_bytes(int k) {
  return k % 64 == 0 ? 2 * k : 2 * k + 16;
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a block of k-value
// rows.
__host__ __device__ constexpr uint32_t offset(int row, int chunk, int k) {
  return k % 64 == 0
             ? (uint32_t)(row * 2 * k + ((chunk ^ (row & 7)) << 4))
             : (uint32_t)(row * (2 * k + 16) + (chunk << 4));
}

// bf16(max(a, 0)) in the low half, bf16(max(b, 0)) in the high half.
__device__ __forceinline__ uint32_t relu_pack(float a, float b) {
  return bf16::pack(fmaxf(a, 0.0f), fmaxf(b, 0.0f));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, which lands in r[i].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two 8x8 bf16 matrices; lanes 0..15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of k-step ks of the row tile at row0 of a k-value
// activation tile at shared address `tile`.
__device__ __forceinline__ void load_a_step(uint32_t (&a)[4], uint32_t tile,
                                            int row0, int ks, int k) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
  ldmatrix_x4(a, tile + offset(row0 + ((mi & 1) << 3) + r,
                               2 * ks + (mi >> 1), k));
}

// The A fragments of MT row tiles (rows row0 + 16 mt ...) of a K-value
// activation tile at shared address `tile`.
template <int MT, int K>
__device__ __forceinline__ void load_a(uint32_t (&a)[MT][K / 16][4],
                                       uint32_t tile, int row0) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks)
      load_a_step(a[mt][ks], tile, row0 + 16 * mt, ks, K);
}

// acc[mt][nt] += A(k-step ks) @ W(k-step ks, n-tiles 0 .. N/8): the B
// fragment pairs of the k-step from the transposed k-value matrix at
// shared address `w`, each loaded once for all MT row tiles.
template <int MT, int N>
__device__ __forceinline__ void mma_step(float (&acc)[MT][N / 8][4],
                                         const uint32_t (&a)[MT][4],
                                         uint32_t w, int ks, int k) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int nt = 0; nt < N / 8; nt += 2) {
    // b0/b1 of n-tile nt, then of nt + 1
    uint32_t b[4];
    ldmatrix_x4(b, w + offset(8 * nt + ((mi >> 1) << 3) + r,
                              2 * ks + (mi & 1), k));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma(acc[mt][nt], a[mt], b[0], b[1]);
      mma(acc[mt][nt + 1], a[mt], b[2], b[3]);
    }
  }
}

template <int MT, int N>
__device__ __forceinline__ void zero(float (&acc)[MT][N / 8][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
}

// a <- bf16(relu(acc)): the accumulators of n-tiles 2j, 2j + 1 become the
// A fragment of k-step j.
template <int MT, int N>
__device__ __forceinline__ void relu_to_a(const float (&acc)[MT][N / 8][4],
                                          uint32_t (&a)[MT][N / 16][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      a[mt][j][0] = relu_pack(acc[mt][2 * j][0], acc[mt][2 * j][1]);
      a[mt][j][1] = relu_pack(acc[mt][2 * j][2], acc[mt][2 * j][3]);
      a[mt][j][2] = relu_pack(acc[mt][2 * j + 1][0], acc[mt][2 * j + 1][1]);
      a[mt][j][3] = relu_pack(acc[mt][2 * j + 1][2], acc[mt][2 * j + 1][3]);
    }
}

// One hidden layer, a <- bf16(relu(a @ W)), W the transposed K x N matrix
// at shared address `w` (K == N: the activations stay in place).
template <int MT, int K>
__device__ __forceinline__ void hidden_layer(uint32_t (&a)[MT][K / 16][4],
                                             uint32_t w) {
  float acc[MT][K / 8][4];
  zero<MT, K>(acc);
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    uint32_t ak[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) ak[mt][i] = a[mt][ks][i];
    mma_step<MT, K>(acc, ak, w, ks, K);
  }
  relu_to_a<MT, K>(acc, a);
}

// The output layer (no activation): one n-tile of 8 columns, W the
// transposed 8 x K matrix at shared address `w`.
template <int MT, int K>
__device__ __forceinline__ void output_layer(
    const uint32_t (&a)[MT][K / 16][4], uint32_t w, float (&out)[MT][4]) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) out[mt][i] = 0.0f;
#pragma unroll
  for (int ks = 0; ks + 1 < K / 16; ks += 2) {
    // b0/b1 of k-step ks, then of ks + 1
    uint32_t b[4];
    ldmatrix_x4(b, w + offset(r, 2 * ks + mi, K));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma(out[mt], a[mt][ks], b[0], b[1]);
      mma(out[mt], a[mt][ks + 1], b[2], b[3]);
    }
  }
  if constexpr (K / 16 % 2) {
    constexpr int ks = K / 16 - 1;
    uint32_t b0, b1;
    ldmatrix_x2(b0, b1, w + offset(r, 2 * ks + (mi & 1), K));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma(out[mt], a[mt][ks], b0, b1);
  }
}

}  // namespace mlp_mma
