// ReSTIR's temporal and spatial reuse (models/restir.py `_temporal_reuse`,
// `_spatial_reuse`): one thread a pixel walks the stage's candidate stream
// in registers, one launch a stage.
//
// They replace no Pallas kernel.  The JAX package leaves the reuse to XLA,
// which fuses each candidate's work into a few passes.  PyTorch runs
// eagerly, so the plain versions make about 28 full-image operations a
// candidate on strided views of the (H, W, V, 6) reservoir, each reading
// 32-byte sectors to use 12 bytes: at 8 vertices, 2 ring slots and a 3x3
// neighbourhood, 70 candidates and some 2,000 passes a 1080p frame.
//
//   temporal_reuse_kernel  the T ring slots x V - 1 suffixes of a pixel; the
//                          new ring (slot frame % T takes the reservoir where
//                          the pixel resampled, every other slot is copied)
//                          and the splice gathered from that new ring;
//                          blocks of 256 pixels
//   spatial_reuse_kernel   the K^2 - 1 neighbours x V - 1 suffixes (dx, then
//                          dy, then the vertex) read from the stage's input,
//                          and the splice of the selected neighbour's suffix;
//                          tiles of 32 x 8 pixels, a warp a row
//
// What bounds them on the H100: bytes, and for the spatial stream also its
// float32 work.  A candidate's weight is an IEEE square root, four
// divisions and a powf, which bit-for-bit rounding forbids shortening, on
// 24 bytes of positions; at 56 candidates a pixel that work is of the
// order of the spatial kernel's 0.26 ms of bytes at 1080p.  Each kernel
// reads a pixel's inputs once and writes its outputs once, into fresh
// tensors (no input is written: the ring is copied whole, as `index_copy`
// did): temporal about 1.2 KB a pixel at V = 8, T = 2, spatial about 0.4
// KB.  A thread walks its pixel's stream with its own positions, its
// prefix's directions and one neighbour's or ring slot's positions in
// registers (arrays sized by MAXV, 4, 8 or 16 >= V), read as 8-byte loads
// (a pixel is 6V floats, a whole number of float2s at every V).  The
// reservoir and ring it writes are not its own pixel's 8-byte pieces,
// which would leave each warp store on 32 sectors: the block's (temporal)
// or the warp's (spatial) pixels are one run of memory, which its threads
// write together, neighbouring threads on neighbouring float2s, from the
// per-pixel choices they leave in shared memory.  The spatial kernel's
// 32 x 8 tiles keep the 3x3 neighbours' positions in L1/L2.
//
// Bitwise the plain versions on the card: the draws are rng.cuh's, the
// candidates come in the plain loops' order, and every float operation is
// an explicit round-to-nearest intrinsic, so nothing contracts into an FMA
// and each rounds as PyTorch's own CUDA kernel for it does.  The file is
// built with nvcc's default -fmad=true, as PyTorch's kernels are, so the
// CUDA library's powf is compiled as in PyTorch's pow kernel (built with
// -fmad=false, the kernels gave the same bits on every case of
// chip_smoke.py's reuse phase and ran 1.7x slower on an H100).  A
// 3-element `vector_norm` or `sum` over the last axis adds in the order of
// PyTorch's reduction, which gives the axis to two threads:
// (x0 + x2) + x1.
// `hg_phase`'s power is powf(x, 1.5f), as PyTorch's pow kernel calls it; a
// Python scalar divided by a tensor is the tensor's reciprocal times the
// scalar (`Tensor.__rtruediv__`); hg_phase's float32 constants and the
// clamps' minimums are cast from the same doubles PyTorch casts.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rng.cuh"

namespace {

constexpr int MAX_VERTICES = 16;
constexpr int TEMPORAL_THREADS = 256;
constexpr int TILE_X = 32;
constexpr int TILE_Y = 8;
// torch.clamp's minimums, Python floats cast to float32 as PyTorch does
constexpr float NORM_MIN = (float)1e-12;
constexpr float WSUM_MIN = (float)1e-20;

// hg_phase's float32 constants (sampling.hg_constants): 1 + g^2, 2 g and
// 0.5 (1 - g^2)
struct Phase {
  float one_g2, two_g, half_1mg2;
};

struct Vec {
  float x, y, z;
};

struct TemporalArgs {
  const float* seeds;       // (H, W)
  const float* res;         // (H, W, V, 6)
  const float* ring;        // (T, H, W, V, 6)
  const float* stats;       // (H, W, 2)
  const float* mis;         // (H, W, 2)
  const float* pixel_info;  // (H, W, 4)
  float* res_out;
  float* ring_out;
  float* stats_out;
  float* mis_out;
  float* seeds_out;
  long long frame;
  int T, V, lanes;
  Phase ph;
};

struct SpatialArgs {
  const float* seeds;
  const float* res;
  const float* stats;
  const float* mis;
  const float* pixel_info;
  float* res_out;
  float* stats_out;
  float* mis_out;
  float* seeds_out;
  int H, W, V, k_max;
  Phase ph;
};

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// _normalized(a - b)
__device__ __forceinline__ Vec unit_diff(Vec a, Vec b) {
  const float dx = __fsub_rn(a.x, b.x), dy = __fsub_rn(a.y, b.y),
              dz = __fsub_rn(a.z, b.z);
  const float sq = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz)),
                             __fmul_rn(dy, dy));
  const float n = clamp_min(__fsqrt_rn(sq), NORM_MIN);
  return {__fdiv_rn(dx, n), __fdiv_rn(dy, n), __fdiv_rn(dz, n)};
}

// _splice_weight: hg_phase of the angle between the prefix's incoming
// direction `in` at its last vertex r and the connection from r to q
__device__ __forceinline__ float splice_weight(Vec in, Vec r, Vec q,
                                               const Phase& ph) {
  const Vec c = unit_diff(q, r);
  const float cos_t = __fadd_rn(__fadd_rn(__fmul_rn(in.x, -c.x),
                                          __fmul_rn(in.z, -c.z)),
                                __fmul_rn(in.y, -c.y));
  const float denom = clamp_min(
      __fsub_rn(ph.one_g2, __fmul_rn(ph.two_g, cos_t)), NORM_MIN);
  return __fmul_rn(__fdiv_rn(1.0f, powf(denom, 1.5f)), ph.half_1mg2);
}

__device__ __forceinline__ int floor_mod(long long a, int m) {
  const int r = (int)(a % m);
  return r < 0 ? r + m : r;
}

// The positions of a pixel's V vertices.
template <int MAXV>
__device__ __forceinline__ void load_positions(const float* __restrict__ px,
                                               int V, Vec (&pos)[MAXV]) {
  const float2* src = reinterpret_cast<const float2*>(px);
#pragma unroll
  for (int v = 0; v < MAXV; ++v) {
    pos[v] = {0.0f, 0.0f, 0.0f};
    if (v < V) {
      const float2 a = __ldg(src + 3 * v), b = __ldg(src + 3 * v + 1);
      pos[v] = {a.x, a.y, b.x};
    }
  }
}

// The prefix's incoming direction at the last vertex of each candidate v's
// prefix [0..v-1]: zero for v = 1, else _normalized(pos[v-1] - pos[v-2]).
template <int MAXV>
__device__ __forceinline__ void incoming(const Vec (&pos)[MAXV], int V,
                                         Vec (&in)[MAXV]) {
  in[0] = in[1] = Vec{0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int v = 2; v < MAXV; ++v)
    in[v] = v < V ? unit_diff(pos[v - 1], pos[v - 2]) : Vec{0.0f, 0.0f, 0.0f};
}

// One step of the stream: the candidate of weight w, drawn against the
// running sum; returns whether it was selected.
__device__ __forceinline__ bool stream_step(float w, float& wsum,
                                            float& stream, float& state) {
  const float wsum_new = __fadd_rn(wsum, w);
  const float prob = __fdiv_rn(w, clamp_min(wsum_new, WSUM_MIN));
  state = rng::random1(state);
  wsum = wsum_new;
  stream = __fadd_rn(stream, 1.0f);
  return state < prob;
}

// Walks the float2s [i, n) of a run of pixels of n3 float2s each, in steps
// of `step`, tracking the pixel and the float2 within it without dividing
// in the loop.
struct Run {
  int j, pixel, rem, step_p, step_r, n3;
  __device__ Run(int i, int step, int n3_)
      : j(i), pixel(i / n3_), rem(i % n3_), step_p(step / n3_),
        step_r(step % n3_), n3(n3_) {}
  __device__ void next(int step) {
    j += step;
    pixel += step_p;
    rem += step_r;
    if (rem >= n3) {
      rem -= n3;
      ++pixel;
    }
  }
  __device__ int vertex() const { return rem / 3; }
};

template <int MAXV, bool WEIGHTED>
__global__ void __launch_bounds__(TEMPORAL_THREADS)
temporal_reuse_kernel(const TemporalArgs a) {
  // the block's pixels: the first vertex spliced in (V: none), the ring
  // slot it comes from (-1: the reservoir itself), and whether the
  // reservoir goes into the current slot
  __shared__ int from_v[TEMPORAL_THREADS], from_slot[TEMPORAL_THREADS];
  __shared__ bool into_ring[TEMPORAL_THREADS];
  const int V = a.V, T = a.T, tid = threadIdx.x;
  const int p0 = blockIdx.x * TEMPORAL_THREADS, p = p0 + tid;
  const long long slot = (long long)a.lanes * 6 * V;  // floats a ring slot
  const long long frame = a.frame;
  const int cur = floor_mod(frame, T);

  if (p < a.lanes) {
    const long long px = (long long)p * 6 * V;      // the pixel's first float
    const bool scat = a.pixel_info[4 * p + 3] == 1.0f;
    float stream = a.stats[2 * p];
    float wsum = a.mis[2 * p], w_sel = a.mis[2 * p + 1];
    float state = a.seeds[p];
    int t_idx = -1, v_idx = 0;
    if (scat) {
      Vec pos[MAXV], in[MAXV];
      if (WEIGHTED) {
        load_positions<MAXV>(a.res + px, V, pos);
        incoming<MAXV>(pos, V, in);
      }
      for (int t = 0; t < T; ++t) {
        // the bank of the frame t + 1 back
        Vec q[MAXV];
        if (WEIGHTED)
          load_positions<MAXV>(
              a.ring + floor_mod(frame - (t + 1), T) * slot + px, V, q);
        const float valid = frame > t ? 1.0f : 0.0f;
#pragma unroll
        for (int v = 1; v < MAXV; ++v) {
          if (v < V) {
            const float w = WEIGHTED
                ? __fmul_rn(splice_weight(in[v], pos[v - 1], q[v], a.ph),
                            valid)
                : 1.0f;
            if (stream_step(w, wsum, stream, state)) {
              t_idx = t;
              v_idx = v;
              w_sel = w;
            }
          }
        }
      }
    }
    a.stats_out[2 * p] = stream;
    a.stats_out[2 * p + 1] = scat ? (float)v_idx : a.stats[2 * p + 1];
    a.mis_out[2 * p] = wsum;
    a.mis_out[2 * p + 1] = w_sel;
    a.seeds_out[p] = state;
    // the current reservoir into slot frame % T where the pixel resampled,
    // before the splice gathers from the new ring (the ported fault: at
    // t = T - 1 the gathered slot is this one, so the splice keeps the
    // pixel's own path)
    const bool take = scat && t_idx >= 0 && frame > 0;
    int last = -1;
    if (take) {
      const long long t_back = (t_idx < frame - 1 ? t_idx : frame - 1) + 1;
      last = floor_mod(frame - t_back, T);
    }
    into_ring[tid] = take;
    from_v[tid] = take ? v_idx : V;
    from_slot[tid] = last == cur ? -1 : last;
  }
  __syncthreads();

  // The block's pixels are one run of floats in every (.., H, W, V, 6)
  // tensor: the new ring and the spliced reservoir are written by
  // neighbouring threads on neighbouring float2s.
  const int n3 = 3 * V;                                   // float2s a pixel
  const int n = min(TEMPORAL_THREADS, a.lanes - p0) * n3;
  const long long at = (long long)p0 * n3, slot2 = slot / 2;
  const float2* res = reinterpret_cast<const float2*>(a.res) + at;
  const float2* ring = reinterpret_cast<const float2*>(a.ring) + at;
  float2* ring_out = reinterpret_cast<float2*>(a.ring_out) + at;
  float2* res_out = reinterpret_cast<float2*>(a.res_out) + at;
  for (int s = 0; s < T; ++s)
    if (s != cur)
      for (int j = tid; j < n; j += TEMPORAL_THREADS)
        ring_out[s * slot2 + j] = __ldg(ring + s * slot2 + j);
  for (Run r(tid, TEMPORAL_THREADS, n3); r.j < n; r.next(TEMPORAL_THREADS)) {
    const float2 own = __ldg(res + r.j);
    ring_out[cur * slot2 + r.j] =
        into_ring[r.pixel] ? own : __ldg(ring + cur * slot2 + r.j);
    const int fs = from_slot[r.pixel];
    res_out[r.j] = fs >= 0 && r.vertex() >= from_v[r.pixel]
                       ? __ldg(ring + fs * slot2 + r.j) : own;
  }
}

template <int MAXV, bool WEIGHTED>
__global__ void __launch_bounds__(TILE_X * TILE_Y)
spatial_reuse_kernel(const SpatialArgs a) {
  // the tile's pixels: the first vertex spliced in (V: none) and the pixel
  // it comes from
  __shared__ int from_v[TILE_Y][TILE_X], from_px[TILE_Y][TILE_X];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * TILE_X, x = x0 + tx;
  const int y = blockIdx.y * TILE_Y + ty;
  const int V = a.V;
  const long long n = 6LL * V;                      // floats a pixel
  if (y >= a.H) return;                             // a whole warp's row

  if (x < a.W) {
    const int p = y * a.W + x;
    const bool scat = a.pixel_info[4 * p + 3] == 1.0f;
    float stream = a.stats[2 * p];
    float wsum = a.mis[2 * p], w_sel = a.mis[2 * p + 1];
    float state = a.seeds[p];
    int sel = p, v_idx = 0;
    bool found = false;
    if (scat) {
      Vec pos[MAXV], in[MAXV];
      if (WEIGHTED) {
        load_positions<MAXV>(a.res + p * n, V, pos);
        incoming<MAXV>(pos, V, in);
      }
      for (int dx = -a.k_max; dx <= a.k_max; ++dx) {
        for (int dy = -a.k_max; dy <= a.k_max; ++dy) {
          const int nx = x + dx, ny = y + dy;
          if ((dx == 0 && dy == 0) || nx < 0 || nx >= a.W || ny < 0 ||
              ny >= a.H)
            continue;
          const int q = ny * a.W + nx;
          if (!(a.pixel_info[4 * q + 3] == 1.0f)) continue;
          Vec nb[MAXV];
          if (WEIGHTED) load_positions<MAXV>(a.res + q * n, V, nb);
#pragma unroll
          for (int v = 1; v < MAXV; ++v) {
            if (v < V) {
              const float w = WEIGHTED
                  ? splice_weight(in[v], pos[v - 1], nb[v], a.ph) : 1.0f;
              if (stream_step(w, wsum, stream, state)) {
                sel = q;
                v_idx = v;
                w_sel = w;
                found = true;
              }
            }
          }
        }
      }
    }
    a.stats_out[2 * p] = stream;
    a.stats_out[2 * p + 1] = found ? (float)v_idx : a.stats[2 * p + 1];
    a.mis_out[2 * p] = wsum;
    a.mis_out[2 * p + 1] = w_sel;
    a.seeds_out[p] = state;
    from_v[ty][tx] = found ? v_idx : V;
    from_px[ty][tx] = sel;
  }
  __syncwarp();

  // A warp's pixels are one run of floats of the reservoir: the spliced
  // reservoir is written by neighbouring lanes on neighbouring float2s.
  const int n3 = 3 * V;
  const int m = min(TILE_X, a.W - x0) * n3;
  const long long at = ((long long)y * a.W + x0) * n3;
  const float2* res = reinterpret_cast<const float2*>(a.res);
  float2* res_out = reinterpret_cast<float2*>(a.res_out) + at;
  for (Run r(tx, TILE_X, n3); r.j < m; r.next(TILE_X)) {
    const long long src = r.vertex() >= from_v[ty][r.pixel]
                              ? (long long)from_px[ty][r.pixel] * n3
                              : at + r.j - r.rem;
    res_out[r.j] = __ldg(res + src + r.rem);
  }
}

template <bool WEIGHTED>
void launch_temporal(const TemporalArgs& a, cudaStream_t stream) {
  const int blocks = (a.lanes + TEMPORAL_THREADS - 1) / TEMPORAL_THREADS;
  if (a.V <= 4)
    temporal_reuse_kernel<4, WEIGHTED>
        <<<blocks, TEMPORAL_THREADS, 0, stream>>>(a);
  else if (a.V <= 8)
    temporal_reuse_kernel<8, WEIGHTED>
        <<<blocks, TEMPORAL_THREADS, 0, stream>>>(a);
  else
    temporal_reuse_kernel<16, WEIGHTED>
        <<<blocks, TEMPORAL_THREADS, 0, stream>>>(a);
}

template <bool WEIGHTED>
void launch_spatial(const SpatialArgs& a, cudaStream_t stream) {
  const dim3 block(TILE_X, TILE_Y);
  const dim3 grid((a.W + TILE_X - 1) / TILE_X, (a.H + TILE_Y - 1) / TILE_Y);
  if (a.V <= 4)
    spatial_reuse_kernel<4, WEIGHTED><<<grid, block, 0, stream>>>(a);
  else if (a.V <= 8)
    spatial_reuse_kernel<8, WEIGHTED><<<grid, block, 0, stream>>>(a);
  else
    spatial_reuse_kernel<16, WEIGHTED><<<grid, block, 0, stream>>>(a);
}

}  // namespace

extern "C" int restir_temporal_reuse_launch(
    const void* seeds, const void* res, const void* ring, const void* stats,
    const void* mis, const void* pixel_info, long long frame, int T, int V,
    int lanes, int weighted, float one_g2, float two_g, float half_1mg2,
    void* res_out, void* ring_out, void* stats_out, void* mis_out,
    void* seeds_out, void* stream) {
  if (lanes < 1 || T < 1 || V < 1 || V > MAX_VERTICES || frame < 0)
    return (int)cudaErrorInvalidValue;
  const TemporalArgs a{
      (const float*)seeds, (const float*)res, (const float*)ring,
      (const float*)stats, (const float*)mis, (const float*)pixel_info,
      (float*)res_out, (float*)ring_out, (float*)stats_out, (float*)mis_out,
      (float*)seeds_out, frame, T, V, lanes, {one_g2, two_g, half_1mg2}};
  if (weighted)
    launch_temporal<true>(a, (cudaStream_t)stream);
  else
    launch_temporal<false>(a, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int restir_spatial_reuse_launch(
    const void* seeds, const void* res, const void* stats, const void* mis,
    const void* pixel_info, int H, int W, int V, int k_max, int weighted,
    float one_g2, float two_g, float half_1mg2, void* res_out,
    void* stats_out, void* mis_out, void* seeds_out, void* stream) {
  if (H < 1 || W < 1 || (long long)H * W >= (1LL << 31) || V < 1 ||
      V > MAX_VERTICES || k_max < 0 || H > 65535 * TILE_Y)
    return (int)cudaErrorInvalidValue;
  const SpatialArgs a{
      (const float*)seeds, (const float*)res, (const float*)stats,
      (const float*)mis, (const float*)pixel_info, (float*)res_out,
      (float*)stats_out, (float*)mis_out, (float*)seeds_out, H, W, V, k_max,
      {one_g2, two_g, half_1mg2}};
  if (weighted)
    launch_spatial<true>(a, (cudaStream_t)stream);
  else
    launch_spatial<false>(a, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" const char* restir_reuse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
