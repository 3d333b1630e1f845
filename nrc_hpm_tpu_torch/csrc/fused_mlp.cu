// Fused NRC MLP inference (kernel K4): bias-free ReLU MLP with bf16
// operands, float32 accumulation and bf16 activations, on the tensor cores.
//
// Replaces the Pallas kernel nrc_hpm_tpu/ops/fused_mlp.py:_kernel (wrapper
// fused_mlp_infer), which serves cache inference for every shape the fused
// encode kernel (K3) does not take: the features are encoded first, then
// this kernel runs the network.
//
// What bounds it on the H100: at the reference's shapes (in_dim 80, width
// 64, depth 6) a sample reads 320 bytes of float32 features and costs
// 2 x 26 k bf16 operations, ~160 operations a byte, below the tensor
// cores' ~295: the feature reads bound it (0.10 ms at 2^20 samples).  So
// the network runs on mma.sync m16n8k16 (csrc/mlp_mma.cuh) and the
// features are read once, coalesced, 32 bytes a lane.
//
// Every width up to 256 and every in_dim up to 256 is served: the wrapper
// pads both to multiples of 16 with zero weights (kernel_weights), which
// leaves the result exact, and the output layer to one n-tile of 8.  The
// weight block holds each layer transposed (one row of K inputs per
// output), rows back to back; the kernels place its rows in shared memory
// in mlp_mma's bank-conflict-free layout.  Two designs, chosen by the
// wrapper from the shapes:
// - RESIDENT (widths up to 128 whose weights fit in shared memory): a
//   persistent block of 4 warps loads every weight matrix once; each warp
//   walks tiles of 16 MT samples, rounds their features to bf16 into its
//   own shared tile, runs layer 0 from that tile one k-step at a time and
//   the other layers with the activations in registers, as K3 does.
// - STREAM (width 144-256, where a hidden layer alone takes up to 128 KB,
//   or a net too deep for shared memory): a persistent block of 8 warps
//   walks tiles of 128 samples; the layers' weights stream from the L2 in
//   chunks of 64 output rows through a double-buffered shared ring
//   (cp.async, the next chunk in flight while the block multiplies the
//   current one), and the activations pass between layers through two
//   shared tiles, 64 columns at a time: a 256-wide accumulator row tile
//   would be 128 floats a thread and spill.
// The output is written unpadded, out_dim columns.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "mlp_mma.cuh"

namespace {

using mlp_mma::offset;
using mlp_mma::row_bytes;

constexpr int OUT_PAD = 8;    // the output layer: one n-tile of 8 columns
constexpr int MAX_DIM = 256;  // widest layer and widest input
constexpr int RES_THREADS = 128;
constexpr int STREAM_THREADS = 256;
constexpr int STREAM_ROWS = STREAM_THREADS / 32 * 16;  // one m16 tile a warp
constexpr int CHUNK = 64;     // output rows of one streamed weight chunk

// Rows of a warp tile of the resident kernel at hidden width W: two m16
// tiles share each B fragment up to width 64, one above (the accumulators
// of two 128-wide tiles would not fit the registers).
template <int W>
__host__ __device__ constexpr int res_mt() { return W <= 64 ? 2 : 1; }

// Element offset of layer l in the weight block.
__host__ __device__ inline size_t layer_offset(int l, int k_in, int width) {
  return l == 0 ? 0
                : (size_t)width * k_in + (size_t)(l - 1) * width * width;
}

// Rows [row0, row0 + rows) of the features (n, in_dim) as bf16 into a
// k_in-value shared tile at `tile` (columns past in_dim zero); rows past
// n repeat the last sample, whose outputs are dropped.  One 16-byte chunk
// of 8 features a lane, consecutive lanes on consecutive chunks.
__device__ __forceinline__ void load_features(
    uint8_t* tile, int rows, const float* __restrict__ x, int row0, int n,
    int in_dim, int k_in, bool vec, int lane, int lanes) {
  const int chunks = k_in / 8;
  for (int i = lane; i < rows * chunks; i += lanes) {
    const int r = i / chunks, c = i - r * chunks;
    const float* src = x + (size_t)min(row0 + r, n - 1) * in_dim + 8 * c;
    float v[8];
    if (vec && 8 * c + 8 <= in_dim) {
      const float4 lo = __ldg(reinterpret_cast<const float4*>(src));
      const float4 hi = __ldg(reinterpret_cast<const float4*>(src) + 1);
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = 8 * c + e < in_dim ? __ldg(src + e) : 0.0f;
    }
    *reinterpret_cast<uint4*>(tile + offset(r, c, k_in)) =
        make_uint4(bf16::pack(v[0], v[1]), bf16::pack(v[2], v[3]),
                   bf16::pack(v[4], v[5]), bf16::pack(v[6], v[7]));
  }
}

// Rows [0, rows) of a transposed k-value weight matrix at `src` into
// shared memory at `dst` in mlp_mma's layout, 16 bytes a step.
__device__ __forceinline__ void load_weights(uint8_t* dst,
                                             const uint4* __restrict__ src,
                                             int rows, int k, int tid,
                                             int threads) {
  const int chunks = k / 8;
  for (int i = tid; i < rows * chunks; i += threads) {
    const int r = i / chunks, c = i - r * chunks;
    *reinterpret_cast<uint4*>(dst + offset(r, c, k)) = src[i];
  }
}

// The output stores of one warp tile: o[mt][2 h + e] is row
// 16 mt + g + 8 h, column 2 tq + e.
template <int MT>
__device__ __forceinline__ void store_out(const float (&o)[MT][4], int s0,
                                          int n, int out_dim,
                                          float* __restrict__ out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
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

// ---------------------------------------------------------------------------
// RESIDENT: hidden width W <= 128, every weight in shared memory.

__host__ __device__ inline size_t resident_weight_bytes(int k_in, int width,
                                                        int depth) {
  return (size_t)width * row_bytes(k_in) +
         (size_t)(depth - 1) * width * row_bytes(width) +
         (size_t)OUT_PAD * row_bytes(width);
}

template <int W>
__global__ void __launch_bounds__(RES_THREADS)
fused_mlp_resident_kernel(const float* __restrict__ x,
                          const uint4* __restrict__ weights, int in_dim,
                          int k_in, int depth, int out_dim, int n, int vec,
                          float* __restrict__ out) {
  constexpr int MT = res_mt<W>();
  constexpr int ROWS = 16 * MT;
  constexpr int WARPS = RES_THREADS / 32;
  extern __shared__ uint4 smem_res[];
  uint8_t* const base = reinterpret_cast<uint8_t*>(smem_res);
  // layer 0, the hidden layers, the output layer, then the warp tiles
  const uint32_t w0_bytes = W * row_bytes(k_in);
  const uint32_t wh_bytes = W * row_bytes(W);
  load_weights(base, weights, W, k_in, threadIdx.x, RES_THREADS);
  for (int m = 1; m < depth; ++m)
    load_weights(base + w0_bytes + (m - 1) * wh_bytes,
                 weights + layer_offset(m, k_in, W) / 8, W, W, threadIdx.x,
                 RES_THREADS);
  const uint32_t out_at = w0_bytes + (depth - 1) * wh_bytes;
  load_weights(base + out_at, weights + layer_offset(depth, k_in, W) / 8,
               OUT_PAD, W, threadIdx.x, RES_THREADS);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t tiles_at = out_at + OUT_PAD * row_bytes(W);
  uint8_t* const tile =
      base + tiles_at + warp * ROWS * row_bytes(k_in);
  const uint32_t w_addr = mlp_mma::smem_addr(base);
  const uint32_t tile_addr = mlp_mma::smem_addr(tile);
  const int n_tiles = (n + ROWS - 1) / ROWS;
  for (int t = blockIdx.x * WARPS + warp; t < n_tiles;
       t += gridDim.x * WARPS) {
    const int s0 = t * ROWS;
    load_features(tile, ROWS, x, s0, n, in_dim, k_in, vec, lane, 32);
    __syncwarp();
    // layer 0 from the tile, one k-step of A fragments at a time
    float acc[MT][W / 8][4];
    mlp_mma::zero<MT, W>(acc);
    for (int ks = 0; ks < k_in / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mlp_mma::load_a_step(a[mt], tile_addr, 16 * mt, ks, k_in);
      mlp_mma::mma_step<MT, W>(acc, a, w_addr, ks, k_in);
    }
    __syncwarp();  // the tile is free for the next features from here
    uint32_t h[MT][W / 16][4];
    mlp_mma::relu_to_a<MT, W>(acc, h);
    for (int m = 1; m < depth; ++m)
      mlp_mma::hidden_layer<MT, W>(h, w_addr + w0_bytes + (m - 1) * wh_bytes);
    float o[MT][4];
    mlp_mma::output_layer<MT, W>(h, w_addr + out_at, o);
    store_out<MT>(o, s0, n, out_dim, out);
  }
}

// ---------------------------------------------------------------------------
// STREAM: any width up to 256 and any depth; weights streamed per chunk.

__host__ __device__ inline size_t stream_tile_bytes(int k_max) {
  return (size_t)STREAM_ROWS * row_bytes(k_max);
}

__host__ __device__ inline size_t stream_slot_bytes(int k_max) {
  return (size_t)CHUNK * row_bytes(k_max);
}

// Chunk j of a tile's sequence: layer l, its first output row n0, its row
// count and the layer's depth k.  Each hidden layer (and layer 0) is
// ceil(width / CHUNK) chunks; the output layer is the last, one chunk.
struct Chunk {
  int layer, n0, rows, k;
};

__device__ __forceinline__ Chunk chunk_of(int j, int k_in, int width,
                                          int depth) {
  const int per = (width + CHUNK - 1) / CHUNK;
  Chunk ch;
  if (j < depth * per) {
    ch.layer = j / per;
    ch.n0 = (j - ch.layer * per) * CHUNK;
    ch.rows = min(CHUNK, width - ch.n0);
    ch.k = ch.layer == 0 ? k_in : width;
  } else {
    ch.layer = depth;
    ch.n0 = 0;
    ch.rows = OUT_PAD;
    ch.k = width;
  }
  return ch;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of chunk j into the slot at shared address `slot`.
__device__ __forceinline__ void issue_chunk(uint32_t slot,
                                            const uint4* __restrict__ weights,
                                            int j, int k_in, int width,
                                            int depth) {
  const Chunk ch = chunk_of(j, k_in, width, depth);
  const uint4* src =
      weights + (layer_offset(ch.layer, k_in, width) + (size_t)ch.n0 * ch.k) / 8;
  const int chunks = ch.k / 8;
  for (int i = threadIdx.x; i < ch.rows * chunks; i += STREAM_THREADS) {
    const int r = i / chunks, c = i - r * chunks;
    cp_async16(slot + offset(r, c, ch.k), src + i);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(STREAM_THREADS)
fused_mlp_stream_kernel(const float* __restrict__ x,
                        const uint4* __restrict__ weights, int in_dim,
                        int k_in, int width, int depth, int out_dim, int n,
                        int vec, float* __restrict__ out) {
  extern __shared__ uint4 smem_str[];
  uint8_t* const base = reinterpret_cast<uint8_t*>(smem_str);
  const int k_max = max(k_in, width);
  const size_t tile_bytes = stream_tile_bytes(k_max);
  const size_t slot_bytes = stream_slot_bytes(k_max);
  uint8_t* const act[2] = {base, base + tile_bytes};
  const uint32_t slots = mlp_mma::smem_addr(base + 2 * tile_bytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mi = lane >> 3, r8 = lane & 7, g = lane >> 2, tq = lane & 3;
  const int row0 = 16 * warp;  // the warp's rows of the block tile
  const int per = (width + CHUNK - 1) / CHUNK;
  const int n_chunks = depth * per + 1;
  const int n_tiles = (n + STREAM_ROWS - 1) / STREAM_ROWS;

  int q = 0;  // chunks taken so far: chunk q sits in slot q % 2
  if (blockIdx.x < n_tiles)
    issue_chunk(slots, weights, 0, k_in, width, depth);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int s0 = t * STREAM_ROWS;
    // the warp's own rows: no other warp reads them
    load_features(act[0] + row0 * row_bytes(k_in), 16, x, s0 + row0, n,
                  in_dim, k_in, vec, lane, 32);
    for (int j = 0; j < n_chunks; ++j, ++q) {
      const uint32_t slot = slots + (q & 1) * slot_bytes;
      const bool more = j + 1 < n_chunks || t + gridDim.x < n_tiles;
      // the other slot was freed by the barrier that ended chunk q - 1
      if (more)
        issue_chunk(slots + ((q + 1) & 1) * slot_bytes, weights,
                    j + 1 < n_chunks ? j + 1 : 0, k_in, width, depth);
      if (more)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // chunk q has landed for every thread

      const Chunk ch = chunk_of(j, k_in, width, depth);
      const uint32_t in = mlp_mma::smem_addr(act[ch.layer & 1]);
      if (ch.layer < depth) {
        float acc[1][CHUNK / 8][4];
        mlp_mma::zero<1, CHUNK>(acc);
        for (int ks = 0; ks < ch.k / 16; ++ks) {
          uint32_t a[4];
          mlp_mma::load_a_step(a, in, row0, ks, ch.k);
#pragma unroll
          for (int nt = 0; nt < CHUNK / 8; nt += 2) {
            if (8 * nt < ch.rows) {
              uint32_t b[4];
              mlp_mma::ldmatrix_x4(
                  b, slot + offset(8 * nt + ((mi >> 1) << 3) + r8,
                                   2 * ks + (mi & 1), ch.k));
              mlp_mma::mma(acc[0][nt], a, b[0], b[1]);
              mlp_mma::mma(acc[0][nt + 1], a, b[2], b[3]);
            }
          }
        }
        // bf16(relu(acc)) into the next layer's tile, columns n0 ...
        uint8_t* const dst = act[(ch.layer + 1) & 1];
#pragma unroll
        for (int nt = 0; nt < CHUNK / 8; ++nt) {
          if (8 * nt < ch.rows) {
            const int c = ch.n0 / 8 + nt;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<uint32_t*>(
                  dst + offset(row0 + g + 8 * h, c, width) + 4 * tq) =
                  mlp_mma::relu_pack(acc[0][nt][2 * h],
                                     acc[0][nt][2 * h + 1]);
          }
        }
      } else {
        float o[1][4] = {{0.0f, 0.0f, 0.0f, 0.0f}};
        for (int ks = 0; ks < ch.k / 16; ++ks) {
          uint32_t a[4], b0, b1;
          mlp_mma::load_a_step(a, in, row0, ks, ch.k);
          mlp_mma::ldmatrix_x2(b0, b1,
                               slot + offset(r8, 2 * ks + (mi & 1), ch.k));
          mlp_mma::mma(o[0], a, b0, b1);
        }
        store_out<1>(o, s0 + row0, n, out_dim, out);
      }
      __syncthreads();  // every warp is done with slot q % 2 and its tile
    }
  }
}

int sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     device);
}

template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, int threads, size_t smem, int tiles,
                      cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  if (int rc = sm_count(&sms)) return rc;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = tiles < sms * per_sm ? tiles : sms * per_sm;
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int W>
int launch_resident(const float* x, int n, const uint4* weights, int in_dim,
                    int k_in, int depth, int out_dim, int vec, float* out,
                    cudaStream_t stream) {
  constexpr int rows = 16 * res_mt<W>();
  const size_t smem = resident_weight_bytes(k_in, W, depth) +
                      (size_t)(RES_THREADS / 32) * rows * row_bytes(k_in);
  const int tiles = (n + rows * (RES_THREADS / 32) - 1) /
                    (rows * (RES_THREADS / 32));
  return launch_persistent(fused_mlp_resident_kernel<W>, RES_THREADS, smem,
                           tiles, stream, x, weights, in_dim, k_in, depth,
                           out_dim, n, vec, out);
}

}  // namespace

// x (n, in_dim) float32 features -> out (n, out_dim) float32.  `weights`
// is the wrapper's bf16 block for k_in = in_dim and width rounded up to
// multiples of 16; stream_mode picks the STREAM design.
extern "C" int fused_mlp_launch(const void* x, int n, const void* weights,
                                int in_dim, int k_in, int width, int depth,
                                int out_dim, int stream_mode, void* out,
                                void* stream) {
  if (n < 1 || in_dim < 1 || k_in < in_dim || k_in % 16 || k_in > MAX_DIM ||
      width < 16 || width % 16 || width > MAX_DIM || depth < 1 ||
      out_dim < 1 || out_dim > OUT_PAD)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int vec = in_dim % 4 == 0 && ((uintptr_t)x & 15) == 0;
  const float* xf = (const float*)x;
  const uint4* w = (const uint4*)weights;
  float* o = (float*)out;
  if (stream_mode) {
    const int k_max = k_in > width ? k_in : width;
    const size_t smem = 2 * stream_tile_bytes(k_max) +
                        2 * stream_slot_bytes(k_max);
    const int tiles = (n + STREAM_ROWS - 1) / STREAM_ROWS;
    return launch_persistent(fused_mlp_stream_kernel, STREAM_THREADS, smem,
                             tiles, st, xf, w, in_dim, k_in, width, depth,
                             out_dim, n, vec, o);
  }
  switch (width) {
    case 16: return launch_resident<16>(xf, n, w, in_dim, k_in, depth, out_dim, vec, o, st);
    case 32: return launch_resident<32>(xf, n, w, in_dim, k_in, depth, out_dim, vec, o, st);
    case 48: return launch_resident<48>(xf, n, w, in_dim, k_in, depth, out_dim, vec, o, st);
    case 64: return launch_resident<64>(xf, n, w, in_dim, k_in, depth, out_dim, vec, o, st);
    case 80: return launch_resident<80>(xf, n, w, in_dim, k_in, depth, out_dim, vec, o, st);
    case 96: return launch_resident<96>(xf, n, w, in_dim, k_in, depth, out_dim, vec, o, st);
    case 112: return launch_resident<112>(xf, n, w, in_dim, k_in, depth, out_dim, vec, o, st);
    case 128: return launch_resident<128>(xf, n, w, in_dim, k_in, depth, out_dim, vec, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fused_mlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
