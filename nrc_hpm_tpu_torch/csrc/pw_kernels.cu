// Piecewise-majorant tracking event engine (kernels K1 and K2).
//
// Replaces the Pallas kernels of nrc_hpm_tpu/ops/pw_kernels.py:
//   K1 pw_events_kernel  <- _make_kernel (wrapper pw_events)
//   K2 pw_profile_kernel <- _make_profile_kernel (wrapper pw_profile)
//
// Per lane: the C = 32 interval majorant/control profile along the segment
// from the bf16-packed macrocell table, its cumulative control and residual
// optical depths, S stateless Exp(1) draws hash(seed ^ hash(salt + k)) at
// global event indices k = e_base + s, inversion of the piecewise-linear
// residual depth by telescoping sums, and the fine-grid linear index at
// each event (-1 where there is no density).  K2 is the same profile sweep
// with one control-stream draw (salt 0x165667B1) inverted through ccum.
//
// What bounds it on the H100: per lane, 33 dependent macro-table lookups
// and S x 32 telescoping steps of scalar FP32 work; the only device-memory
// traffic is the per-lane inputs and the (S, N) outputs (~16 B per event).
// So it is bound by latency and instruction rate, not by bandwidth.  The
// simple design:
// one thread per lane, the whole macro table (14 KB for the 126x86x154
// cloud) staged in shared memory per block, the profile held in per-thread
// arrays.  The TPU's rowsweep gather, (8, 128) tiles and unrolled loops
// are not carried over.  This file is compiled with -fmad=false and every
// expression keeps the operation order of the plain PyTorch version
// (ops/pw_kernels.py), so the two agree to the bit up to libm ulps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;

struct Scene {
  float inv_sky[3];  // 1 / world box size
  float mdim[3];     // macro grid dims
  float fdim[3];     // fine grid dims
  float density;     // density factor
};

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x = x + (x << 10);
  x = x ^ (x >> 6);
  x = x + (x << 3);
  x = x ^ (x >> 11);
  x = x + (x << 15);
  return x;
}

__device__ __forceinline__ float uniform(uint32_t seed, uint32_t k,
                                         uint32_t salt) {
  uint32_t m = hash_u32(seed ^ hash_u32(k + salt));
  return __uint_as_float((m & 0x007FFFFFu) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// (majorant, control) at a world position from the packed table in smem.
__device__ __forceinline__ void macro_lookup(const uint32_t* tbl,
                                             const Scene& sc, float px,
                                             float py, float pz, float& sig,
                                             float& ctl) {
  const float mx = sc.mdim[0], my = sc.mdim[1], mz = sc.mdim[2];
  float cx = (px * sc.inv_sky[0] + 0.5f) * mx;
  float cy = (py * sc.inv_sky[1] + 0.5f) * my;
  float cz = (pz * sc.inv_sky[2] + 0.5f) * mz;
  bool in_strict = cx >= 0.0f && cx < mx && cy >= 0.0f && cy < my &&
                   cz >= 0.0f && cz < mz;
  bool in_ext = cx >= -1.0f && cx < mx + 1.0f && cy >= -1.0f &&
                cy < my + 1.0f && cz >= -1.0f && cz < mz + 1.0f;
  float ix = clampf(floorf(cx), 0.0f, mx - 1.0f);
  float iy = clampf(floorf(cy), 0.0f, my - 1.0f);
  float iz = clampf(floorf(cz), 0.0f, mz - 1.0f);
  int lin = (int)(ix * (my * mz) + iy * mz + iz);
  uint32_t w = tbl[lin];
  float s = __uint_as_float(w & 0xFFFF0000u);
  float c = fminf(__uint_as_float(w << 16), s);
  sig = (in_ext ? s : 0.0f) * sc.density;
  ctl = (in_strict ? c : 0.0f) * sc.density;
}

// The C-interval profile: sig/ctl per interval (index C holds 0), running
// residual and control depths after each interval.
__device__ __forceinline__ void profile(const uint32_t* tbl, const Scene& sc,
                                        const float o[3], const float v[3],
                                        float h, float* sig, float* ctl,
                                        float* rcum, float* ccum) {
  float p_sig, p_ctl;
  macro_lookup(tbl, sc, o[0], o[1], o[2], p_sig, p_ctl);
  float cc = 0.0f, rc = 0.0f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    float t_i = (float)(i + 1) * h;
    float n_sig, n_ctl;
    macro_lookup(tbl, sc, o[0] + t_i * v[0], o[1] + t_i * v[1],
                 o[2] + t_i * v[2], n_sig, n_ctl);
    float s = fmaxf(p_sig, n_sig);
    float c = fminf(fminf(p_ctl, n_ctl), s);
    cc = cc + c * h;
    rc = rc + (s - c) * h;
    sig[i] = s;
    ctl[i] = c;
    rcum[i] = rc;
    ccum[i] = cc;
    p_sig = n_sig;
    p_ctl = n_ctl;
  }
  sig[C] = 0.0f;
  ctl[C] = 0.0f;
}

__device__ __forceinline__ void stage_table(const uint32_t* macro,
                                            int n_macro, uint32_t* tbl) {
  for (int i = threadIdx.x; i < n_macro; i += blockDim.x) tbl[i] = macro[i];
  __syncthreads();
}

__global__ void pw_events_kernel(
    const float* __restrict__ start, const float* __restrict__ dir,
    const float* __restrict__ tmax, const uint32_t* __restrict__ seed,
    const float* __restrict__ e_last, const uint32_t* __restrict__ macro,
    int n_macro, Scene sc, uint32_t e_base, uint32_t salt, int S, int n,
    int* __restrict__ lin_out, float* __restrict__ t_out,
    float* __restrict__ c_out, float* __restrict__ sres_out,
    float* __restrict__ enew_out, float* __restrict__ rtot_out,
    float* __restrict__ ctot_out) {
  extern __shared__ uint32_t tbl[];
  stage_table(macro, n_macro, tbl);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  const float o[3] = {start[3 * lane], start[3 * lane + 1],
                      start[3 * lane + 2]};
  const float v[3] = {dir[3 * lane], dir[3 * lane + 1], dir[3 * lane + 2]};
  const float h = tmax[lane] * (1.0f / C);
  float sig[C + 1], ctl[C + 1], rcum[C], ccum[C];
  profile(tbl, sc, o, v, h, sig, ctl, rcum, ccum);
  const float rtot = rcum[C - 1];
  rtot_out[lane] = rtot;
  ctot_out[lane] = ccum[C - 1];

  const uint32_t sd = seed[lane];
  float E = e_last[lane];
  for (int s = 0; s < S; ++s) {
    E = E - log1pf(-uniform(sd, e_base + (uint32_t)s, salt));
    float kacc = 0.0f, e_left = 0.0f, c_at = ctl[0], sig_at = sig[0];
    float r_prev = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float rc = rcum[c];
      float gef = E >= rc ? 1.0f : 0.0f;
      kacc = kacc + gef;
      e_left = e_left + gef * (rc - r_prev);
      c_at = c_at + gef * (ctl[c + 1] - ctl[c]);
      sig_at = sig_at + gef * (sig[c + 1] - sig[c]);
      r_prev = rc;
    }
    const bool beyond = E >= rtot;
    const float sres = fmaxf(sig_at - c_at, 1e-12f);
    const float rate_h = sres * h;
    float t = kacc * h + (E - e_left) * h / fmaxf(rate_h, 1e-20f);
    t = beyond ? -1.0f : t;
    float ux = (o[0] + t * v[0]) * sc.inv_sky[0] + 0.5f;
    float uy = (o[1] + t * v[1]) * sc.inv_sky[1] + 0.5f;
    float uz = (o[2] + t * v[2]) * sc.inv_sky[2] + 0.5f;
    bool inside = ux >= 0.0f && ux < 1.0f && uy >= 0.0f && uy < 1.0f &&
                  uz >= 0.0f && uz < 1.0f;
    const float X = sc.fdim[0], Y = sc.fdim[1], Z = sc.fdim[2];
    float gx = clampf(floorf(ux * X), 0.0f, X - 1.0f);
    float gy = clampf(floorf(uy * Y), 0.0f, Y - 1.0f);
    float gz = clampf(floorf(uz * Z), 0.0f, Z - 1.0f);
    int lin = (int)(gx * (Y * Z) + gy * Z + gz);
    const size_t at = (size_t)s * n + lane;
    lin_out[at] = (inside && !beyond) ? lin : -1;
    t_out[at] = t;
    c_out[at] = c_at;
    sres_out[at] = sres;
  }
  enew_out[lane] = E;
}

__global__ void pw_profile_kernel(
    const float* __restrict__ start, const float* __restrict__ dir,
    const float* __restrict__ tmax, const uint32_t* __restrict__ seed,
    const uint32_t* __restrict__ macro, int n_macro, Scene sc,
    int want_ctrl, uint32_t salt_ctrl, int n, float* __restrict__ rtot_out,
    float* __restrict__ ctot_out, float* __restrict__ tctrl_out) {
  extern __shared__ uint32_t tbl[];
  stage_table(macro, n_macro, tbl);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  const float o[3] = {start[3 * lane], start[3 * lane + 1],
                      start[3 * lane + 2]};
  const float v[3] = {dir[3 * lane], dir[3 * lane + 1], dir[3 * lane + 2]};
  const float h = tmax[lane] * (1.0f / C);
  float sig[C + 1], ctl[C + 1], rcum[C], ccum[C];
  profile(tbl, sc, o, v, h, sig, ctl, rcum, ccum);
  const float ctot = ccum[C - 1];
  rtot_out[lane] = rcum[C - 1];
  ctot_out[lane] = ctot;

  float t_ctrl = 3.0e38f;
  if (want_ctrl) {
    const float E = -log1pf(-uniform(seed[lane], 0u, salt_ctrl));
    float kacc = 0.0f, e_left = 0.0f, c_at = ctl[0], cc_prev = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float cc = ccum[c];
      float gef = E >= cc ? 1.0f : 0.0f;
      kacc = kacc + gef;
      e_left = e_left + gef * (cc - cc_prev);
      c_at = c_at + gef * (ctl[c + 1] - ctl[c]);
      cc_prev = cc;
    }
    const float rate_h = fmaxf(c_at * h, 1e-20f);
    const float t = kacc * h + (E - e_left) * h / rate_h;
    t_ctrl = E >= ctot ? 3.0e38f : t;
  }
  tctrl_out[lane] = t_ctrl;
}

constexpr int THREADS = 128;

Scene make_scene(float isx, float isy, float isz, int mx, int my, int mz,
                 int X, int Y, int Z, float density) {
  Scene sc;
  sc.inv_sky[0] = isx;
  sc.inv_sky[1] = isy;
  sc.inv_sky[2] = isz;
  sc.mdim[0] = (float)mx;
  sc.mdim[1] = (float)my;
  sc.mdim[2] = (float)mz;
  sc.fdim[0] = (float)X;
  sc.fdim[1] = (float)Y;
  sc.fdim[2] = (float)Z;
  sc.density = density;
  return sc;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" int pw_events_launch(
    const void* start, const void* dir, const void* tmax, const void* seed,
    const void* e_last, const void* macro, int n_macro, float isx, float isy,
    float isz, int mx, int my, int mz, int X, int Y, int Z, float density,
    unsigned e_base, unsigned salt, int S, int n, void* lin, void* t,
    void* c_at, void* sres, void* e_new, void* rtot, void* ctot,
    void* stream) {
  const size_t smem = (size_t)n_macro * sizeof(uint32_t);
  cudaError_t err = set_smem(pw_events_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const Scene sc = make_scene(isx, isy, isz, mx, my, mz, X, Y, Z, density);
  const int blocks = (n + THREADS - 1) / THREADS;
  pw_events_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)start, (const float*)dir, (const float*)tmax,
      (const uint32_t*)seed, (const float*)e_last, (const uint32_t*)macro,
      n_macro, sc, e_base, salt, S, n, (int*)lin, (float*)t, (float*)c_at,
      (float*)sres, (float*)e_new, (float*)rtot, (float*)ctot);
  return (int)cudaGetLastError();
}

extern "C" int pw_profile_launch(
    const void* start, const void* dir, const void* tmax, const void* seed,
    const void* macro, int n_macro, float isx, float isy, float isz, int mx,
    int my, int mz, int X, int Y, int Z, float density, int want_ctrl,
    unsigned salt_ctrl, int n, void* rtot, void* ctot, void* t_ctrl,
    void* stream) {
  const size_t smem = (size_t)n_macro * sizeof(uint32_t);
  cudaError_t err = set_smem(pw_profile_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const Scene sc = make_scene(isx, isy, isz, mx, my, mz, X, Y, Z, density);
  const int blocks = (n + THREADS - 1) / THREADS;
  pw_profile_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)start, (const float*)dir, (const float*)tmax,
      (const uint32_t*)seed, (const uint32_t*)macro, n_macro, sc, want_ctrl,
      salt_ctrl, n, (float*)rtot, (float*)ctot, (float*)t_ctrl);
  return (int)cudaGetLastError();
}

extern "C" const char* pw_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
