// Fused NRC MLP inference (kernel K4): bias-free ReLU MLP with bf16
// operands, float32 accumulation and bf16 activations, one pass per
// sample.
//
// Replaces the Pallas kernel nrc_hpm_tpu/ops/fused_mlp.py:_kernel (wrapper
// fused_mlp_infer), which serves cache inference for every input encoding
// the fused encode kernel (K3) does not take: the features are encoded
// first, then this kernel runs the network.
//
// What bounds it on the H100: per sample in_dim x W + (depth - 1) x W x W
// + W x 8 multiply-adds (26.1 k at in_dim 80, W 64, depth 6) against
// in_dim x 4 bytes read and out_dim x 4 bytes written, ~80 multiply-adds
// per byte: the float32 FMA pipes bound it (this simple design uses no
// tensor cores), not memory.  The design: one thread per sample in
// persistent blocks; every layer matrix (bf16) in dynamic shared memory,
// loaded once per block, each read a warp-wide broadcast (csrc/mlp.cuh);
// layer 0 streams the sample's input row from global memory one value at
// a time, so in_dim up to 128 needs no registers beyond the W float32
// accumulators; the hidden activations stay in registers as packed bf16
// pairs (they are bf16 values anyway), which keeps W = 128 within the
// register file.  The output is written unpadded, out_dim floats a row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "mlp.cuh"

namespace {

using mlp::fma_row;

constexpr int THREADS = 128;
constexpr int OUT_PAD = 8;    // output columns padded to one 16-byte row
constexpr int MAX_IN = 128;

template <int W>
__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const float* __restrict__ x,
                 const uint4* __restrict__ weights, int in_dim, int depth,
                 int out_dim, int n, float* __restrict__ out) {
  constexpr int Q = W / 8;    // uint4 per weight row
  extern __shared__ uint4 w_smem[];
  const int n_vec = (in_dim * W + (depth - 1) * W * W + W * OUT_PAD) / 8;
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x)
    w_smem[i] = weights[i];
  __syncthreads();
  const uint4* w_hidden = w_smem + in_dim * Q;
  const uint4* w_out = w_hidden + (depth - 1) * W * Q;

  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < n;
       s += gridDim.x * blockDim.x) {
    const float* xs = x + (size_t)s * in_dim;
    float acc[W];
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = 0.0f;
    // layer 0: the input row, rounded to bf16 value by value
    for (int k = 0; k < in_dim; ++k)
      fma_row<Q>(acc, bf16::round_rn(__ldg(xs + k)), w_smem + k * Q);
    uint32_t h[W / 2];
#pragma unroll
    for (int j = 0; j < W / 2; ++j)
      h[j] = mlp::relu_pack(acc[2 * j], acc[2 * j + 1]);

    // hidden layers 1 .. depth - 1
    for (int m = 1; m < depth; ++m) {
      const uint4* Wm = w_hidden + (m - 1) * W * Q;
#pragma unroll
      for (int j = 0; j < W; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int k = 0; k < W / 2; ++k) {
        fma_row<Q>(acc, bf16::lo(h[k]), Wm + (2 * k) * Q);
        fma_row<Q>(acc, bf16::hi(h[k]), Wm + (2 * k + 1) * Q);
      }
#pragma unroll
      for (int j = 0; j < W / 2; ++j)
        h[j] = mlp::relu_pack(acc[2 * j], acc[2 * j + 1]);
    }

    // output projection, no activation
    float o[OUT_PAD];
#pragma unroll
    for (int j = 0; j < OUT_PAD; ++j) o[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < W / 2; ++k) {
      fma_row<1>(o, bf16::lo(h[k]), w_out + 2 * k);
      fma_row<1>(o, bf16::hi(h[k]), w_out + 2 * k + 1);
    }
#pragma unroll
    for (int j = 0; j < OUT_PAD; ++j)
      if (j < out_dim) out[(size_t)s * out_dim + j] = o[j];
  }
}

template <int W>
int launch(const void* x, int n, const void* weights, int in_dim, int depth,
           int out_dim, void* out, cudaStream_t stream) {
  const size_t smem =
      (size_t)(in_dim * W + (depth - 1) * W * W + W * OUT_PAD) *
      sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_mlp_kernel<W>, THREADS, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (n + THREADS - 1) / THREADS;
  const int blocks = tiles < sms * per_sm ? tiles : sms * per_sm;
  fused_mlp_kernel<W><<<blocks, THREADS, smem, stream>>>(
      (const float*)x, (const uint4*)weights, in_dim, depth, out_dim, n,
      (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// One library per width: the fully unrolled width-128 loops alone take
// minutes of nvcc, so each width is its own build, started in parallel and
// only for the widths a run uses.
#if !defined(K4_WIDTH) || (K4_WIDTH != 16 && K4_WIDTH != 32 && \
                           K4_WIDTH != 64 && K4_WIDTH != 128)
#error "build with -DK4_WIDTH=16, 32, 64 or 128"
#endif

extern "C" int fused_mlp_launch(const void* x, int n, const void* weights,
                                int width, int in_dim, int depth,
                                int out_dim, void* out, void* stream) {
  if (width != K4_WIDTH || in_dim < 16 || in_dim > MAX_IN ||
      in_dim % 16 != 0 || depth < 1 || out_dim < 1 || out_dim > OUT_PAD ||
      n < 1)
    return (int)cudaErrorInvalidValue;
  return launch<K4_WIDTH>(x, n, weights, in_dim, depth, out_dim, out,
                          (cudaStream_t)stream);
}

extern "C" const char* fused_mlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
