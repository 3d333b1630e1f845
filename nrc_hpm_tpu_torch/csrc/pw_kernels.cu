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
// What bounds them on the H100: per lane, 33 dependent macro-table lookups
// and the inversion's scalar FP32 work; the only device-memory traffic is
// the per-lane inputs and K1's (S, N) outputs (~16 B per event, ~320 MB at
// 2^20 lanes and S = 16).  The train paths' late bounces launch K1 on a
// few hundred lanes, where one thread's dependent chain is the launch.
//
// K1 is one interval walk, O(S + C) per lane.  The residual depth rcum is
// non-decreasing (each interval adds (sig - ctl) h >= 0) and the event
// depths E_s only grow, so the intervals event s counts (E_s >= rcum[c])
// are a prefix that never shrinks from one event to the next.  Beyond the
// prefix the telescoping sums add gef * x = +-0, which leaves a float
// unchanged, so running sums carried from event to event add the same
// terms in the same order as the S x C loop of the plain version and are
// bitwise equal to it.  Per lane, in three passes:
// - the S event depths, drawn in order (the draws are independent, only
//   the running depth chains them);
// - one sweep of the C intervals, CHUNK macro lookups at a time (the
//   lookups are independent, so a chunk's latencies overlap), the walk one
//   interval behind (the next interval's majorant and control enter the
//   current one's terms); event s is finished at the first interval with
//   E_s < rcum[c], and only its interval count and sums are recorded, a
//   few shared-memory stores, so lanes whose events finish at other
//   intervals diverge for little;
// - the outputs of every event, a loop uniform across the warp, so the
//   lane-minor (S, N) stores stay coalesced; an event the sweep did not
//   finish lies beyond the segment.
// No profile arrays are kept: the sweep holds one chunk of intervals, and
// the S records live in shared memory (5 floats per event and thread).
//
// K2 is the same walk with one event.  Its control depth E does not depend
// on the profile, so it is drawn before the sweep; the control depth ccum
// is non-decreasing as rcum is, so the intervals with E >= ccum[c] form a
// prefix, and the walk adds each interval's telescoping terms until the
// first interval with E < ccum[c] and nothing after it (where the plain
// version adds +-0).  With one event and three running sums the whole
// sweep runs ahead of the walk, its 33 lookups overlapping, and each
// interval's control and control depth stay in registers; without the
// control draw (want_ctrl false) it is the sweep alone.  K2 is bound by
// instruction issue (~2,300 a lane, most of them in the 33 lookups), so
// its lookups work on integer cell coordinates (macro_lookup_cells): the
// same bits in 7% fewer instructions a lane.
//
// Both run on a persistent grid sized by occupancy, so each block stages
// the macro table once, with 16-byte loads, for many lanes.  This file is
// compiled with -fmad=false and every expression keeps the operation order
// of the plain PyTorch version (ops/pw_kernels.py), so the kernels agree
// with it to the bit up to libm ulps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;
constexpr int THREADS = 128;
constexpr int CHUNK = 4;  // K1's intervals looked up together

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

// macro_lookup on integer cell coordinates (K2), the same result bit for
// bit for finite positions in fewer instructions: floor(c) is one
// conversion rounding down (saturated where c is beyond the int range,
// where both bounds tests fail as they do on c), c in [0, m) <=> floor(c)
// in [0, m - 1] and c in [-1, m + 1) <=> floor(c) in [-1, m], and the
// float clamp and index of macro_lookup are exact on these integers (the
// table has far fewer than 2^24 cells).
__device__ __forceinline__ void macro_lookup_cells(const uint32_t* tbl,
                                                   const Scene& sc, float px,
                                                   float py, float pz,
                                                   float& sig, float& ctl) {
  const float cx = (px * sc.inv_sky[0] + 0.5f) * sc.mdim[0];
  const float cy = (py * sc.inv_sky[1] + 0.5f) * sc.mdim[1];
  const float cz = (pz * sc.inv_sky[2] + 0.5f) * sc.mdim[2];
  const int mx = (int)sc.mdim[0], my = (int)sc.mdim[1], mz = (int)sc.mdim[2];
  const int ix = __float2int_rd(cx), iy = __float2int_rd(cy),
            iz = __float2int_rd(cz);
  const bool in_strict = (unsigned)ix < (unsigned)mx &&
                         (unsigned)iy < (unsigned)my &&
                         (unsigned)iz < (unsigned)mz;
  const bool in_ext = (unsigned)ix + 1u < (unsigned)mx + 2u &&
                      (unsigned)iy + 1u < (unsigned)my + 2u &&
                      (unsigned)iz + 1u < (unsigned)mz + 2u;
  const int lin = min(max(ix, 0), mx - 1) * (my * mz) +
                  min(max(iy, 0), my - 1) * mz + min(max(iz, 0), mz - 1);
  uint32_t w = tbl[lin];
  float s = __uint_as_float(w & 0xFFFF0000u);
  float c = fminf(__uint_as_float(w << 16), s);
  sig = (in_ext ? s : 0.0f) * sc.density;
  ctl = (in_strict ? c : 0.0f) * sc.density;
}

// The sweep's lookup: macro_lookup (K1) or macro_lookup_cells (K2).
template <bool CELLS>
__device__ __forceinline__ void lookup(const uint32_t* tbl, const Scene& sc,
                                       float px, float py, float pz,
                                       float& sig, float& ctl) {
  if (CELLS)
    macro_lookup_cells(tbl, sc, px, py, pz, sig, ctl);
  else
    macro_lookup(tbl, sc, px, py, pz, sig, ctl);
}

// One interval of the profile sweep: its majorant and control, and the
// running residual depth after it.
struct Interval {
  float sig, ctl, rc;
};

// The sweep along one segment: the lookup at the far end of the last
// interval computed, the running depths, and the next interval's index.
struct Sweep {
  float p_sig, p_ctl, rc, cc;
  int i;
};

template <bool CELLS = false>
__device__ __forceinline__ Sweep sweep_start(const uint32_t* tbl,
                                             const Scene& sc,
                                             const float o[3]) {
  Sweep sw;
  lookup<CELLS>(tbl, sc, o[0], o[1], o[2], sw.p_sig, sw.p_ctl);
  sw.rc = 0.0f;
  sw.cc = 0.0f;
  sw.i = 0;
  return sw;
}

// Interval sw.i of C along o + t v, t in [i h, (i + 1) h].
template <bool CELLS = false>
__device__ __forceinline__ Interval sweep_next(const uint32_t* tbl,
                                               const Scene& sc,
                                               const float o[3],
                                               const float v[3], float h,
                                               Sweep& sw) {
  float t_i = (float)(sw.i + 1) * h;
  float n_sig, n_ctl;
  lookup<CELLS>(tbl, sc, o[0] + t_i * v[0], o[1] + t_i * v[1],
                o[2] + t_i * v[2], n_sig, n_ctl);
  float s = fmaxf(sw.p_sig, n_sig);
  float c = fminf(fminf(sw.p_ctl, n_ctl), s);
  sw.cc = sw.cc + c * h;
  sw.rc = sw.rc + (s - c) * h;
  sw.p_sig = n_sig;
  sw.p_ctl = n_ctl;
  sw.i += 1;
  return Interval{s, c, sw.rc};
}

// The packed macro table into shared memory: 16-byte loads where the
// table is 16-byte aligned, then the words left over.
__device__ __forceinline__ void stage_table(const uint32_t* macro,
                                            int n_macro, uint32_t* tbl) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(macro) & 15) == 0) {
    done = n_macro & ~3;
    const uint4* src = reinterpret_cast<const uint4*>(macro);
    uint4* dst = reinterpret_cast<uint4*>(tbl);
#pragma unroll 8
    for (int i = threadIdx.x; i < done / 4; i += blockDim.x) dst[i] = src[i];
  }
  for (int i = done + threadIdx.x; i < n_macro; i += blockDim.x)
    tbl[i] = macro[i];
  __syncthreads();
}

// K1's per-thread event records in shared memory, one row of THREADS
// floats per event and field (so each thread's column is conflict-free):
// the event depth, then the interval count and the three running sums at
// the interval where the walk finished the event.
constexpr int REC_FIELDS = 5;

__global__ void __launch_bounds__(THREADS) pw_events_kernel(
    const float* __restrict__ start, const float* __restrict__ dir,
    const float* __restrict__ tmax, const uint32_t* __restrict__ seed,
    const float* __restrict__ e_last, const uint32_t* __restrict__ macro,
    int n_macro, Scene sc, uint32_t e_base, uint32_t salt, int S, int n,
    int* __restrict__ lin_out, float* __restrict__ t_out,
    float* __restrict__ c_out, float* __restrict__ sres_out,
    float* __restrict__ enew_out, float* __restrict__ rtot_out,
    float* __restrict__ ctot_out) {
  extern __shared__ uint32_t smem[];
  uint32_t* tbl = smem;
  stage_table(macro, n_macro, tbl);
  const int rs = S * THREADS;  // one field's rows
  float* const rE = reinterpret_cast<float*>(smem + ((n_macro + 3) & ~3)) +
                    threadIdx.x;
  float* const rK = rE + rs;
  float* const rL = rK + rs;
  float* const rC = rL + rs;
  float* const rS = rC + rs;
  const Interval zero{0.0f, 0.0f, 0.0f};
  for (int lane = blockIdx.x * blockDim.x + threadIdx.x; lane < n;
       lane += gridDim.x * blockDim.x) {
    const float o[3] = {start[3 * lane], start[3 * lane + 1],
                        start[3 * lane + 2]};
    const float v[3] = {dir[3 * lane], dir[3 * lane + 1],
                        dir[3 * lane + 2]};
    const float h = tmax[lane] * (1.0f / C);

    // 1. the S event depths, drawn in order
    const uint32_t sd = seed[lane];
    float E = e_last[lane];
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      E = E - log1pf(-uniform(sd, e_base + (uint32_t)s, salt));
      rE[s * THREADS] = E;
    }

    // 2. one sweep over the C intervals, CHUNK lookups at a time.  The
    // running sums take every interval's terms; event s is finished (its
    // sums recorded) at the first interval c with E_s < rcum[c], before
    // interval c's terms are added.
    Sweep sw = sweep_start(tbl, sc, o);
    Interval cur = sweep_next(tbl, sc, o, v, h, sw);
    float kacc = 0.0f, e_left = 0.0f, c_at = cur.ctl, sig_at = cur.sig;
    float r_prev = 0.0f;
    int s = 0;
    float Es = S > 0 ? rE[0] : 0.0f;
#pragma unroll
    for (int c0 = 0; c0 < C; c0 += CHUNK) {
      Interval nx[CHUNK];  // intervals c0 + 1 ... c0 + CHUNK (zero at C)
#pragma unroll
      for (int j = 0; j < CHUNK; ++j)
        nx[j] = c0 + 1 + j < C ? sweep_next(tbl, sc, o, v, h, sw) : zero;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        while (s < S && Es < cur.rc) {
          rK[s * THREADS] = kacc;
          rL[s * THREADS] = e_left;
          rC[s * THREADS] = c_at;
          rS[s * THREADS] = sig_at;
          ++s;
          Es = s < S ? rE[s * THREADS] : 0.0f;
        }
        kacc = kacc + 1.0f;
        e_left = e_left + (cur.rc - r_prev);
        c_at = c_at + (nx[j].ctl - cur.ctl);
        sig_at = sig_at + (nx[j].sig - cur.sig);
        r_prev = cur.rc;
        cur = nx[j];
      }
    }

    // 3. every event's outputs, one coalesced (S, N) row at a time; the
    // events the sweep did not finish lie beyond the segment (E_s >=
    // rcum[C - 1]) and take the sums over all C intervals
    const int finished = s;
    for (int e = 0; e < S; ++e) {
      const bool beyond = e >= finished;
      const float Ee = rE[e * THREADS];
      const float k = beyond ? kacc : rK[e * THREADS];
      const float el = beyond ? e_left : rL[e * THREADS];
      const float ca = beyond ? c_at : rC[e * THREADS];
      const float sa = beyond ? sig_at : rS[e * THREADS];
      const float sres = fmaxf(sa - ca, 1e-12f);
      const float rate_h = sres * h;
      float t = k * h + (Ee - el) * h / fmaxf(rate_h, 1e-20f);
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
      const size_t at = (size_t)e * n + lane;
      lin_out[at] = (inside && !beyond) ? lin : -1;
      t_out[at] = t;
      c_out[at] = ca;
      sres_out[at] = sres;
    }
    enew_out[lane] = E;
    rtot_out[lane] = sw.rc;
    ctot_out[lane] = sw.cc;
  }
}

template <bool CTRL>
__global__ void __launch_bounds__(THREADS) pw_profile_kernel(
    const float* __restrict__ start, const float* __restrict__ dir,
    const float* __restrict__ tmax, const uint32_t* __restrict__ seed,
    const uint32_t* __restrict__ macro, int n_macro, Scene sc,
    uint32_t salt_ctrl, int n, float* __restrict__ rtot_out,
    float* __restrict__ ctot_out, float* __restrict__ tctrl_out) {
  extern __shared__ uint32_t tbl[];
  stage_table(macro, n_macro, tbl);
  for (int lane = blockIdx.x * blockDim.x + threadIdx.x; lane < n;
       lane += gridDim.x * blockDim.x) {
    const float o[3] = {start[3 * lane], start[3 * lane + 1],
                        start[3 * lane + 2]};
    const float v[3] = {dir[3 * lane], dir[3 * lane + 1],
                        dir[3 * lane + 2]};
    const float h = tmax[lane] * (1.0f / C);
    // the control depth, drawn before the sweep
    const float E =
        CTRL ? -log1pf(-uniform(seed[lane], 0u, salt_ctrl)) : 0.0f;

    // the whole sweep first: its 33 lookups are independent, so their
    // latencies overlap, and the unrolled loop keeps each interval's
    // control and control depth in registers
    Sweep sw = sweep_start<true>(tbl, sc, o);
    float ctl[C + 1], cc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ctl[c] = sweep_next<true>(tbl, sc, o, v, h, sw).ctl;
      cc[c] = sw.cc;
    }
    ctl[C] = 0.0f;

    // the walk adds interval c's terms while E >= ccum[c] and stops at the
    // first interval with E < ccum[c]
    float kacc = 0.0f, e_left = 0.0f, c_at = ctl[0];
    if (CTRL) {
      bool live = true;
      float cc_prev = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        live = live && E >= cc[c];
        if (live) {
          kacc = kacc + 1.0f;
          e_left = e_left + (cc[c] - cc_prev);
          c_at = c_at + (ctl[c + 1] - ctl[c]);
        }
        cc_prev = cc[c];
      }
    }
    const float ctot = sw.cc;
    rtot_out[lane] = sw.rc;
    ctot_out[lane] = ctot;
    float t_ctrl = 3.0e38f;
    if (CTRL) {
      const float rate_h = fmaxf(c_at * h, 1e-20f);
      const float t = kacc * h + (E - e_left) * h / rate_h;
      t_ctrl = E >= ctot ? 3.0e38f : t;
    }
    tctrl_out[lane] = t_ctrl;
  }
}

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

// A persistent grid: as many blocks as fit on the card at once (at most
// one per THREADS lanes), so each stages the table once for many lanes.
template <typename K>
cudaError_t persistent_blocks(K kernel, size_t smem, int n, int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (n + THREADS - 1) / THREADS;
  *blocks = tiles < sms * per_sm ? tiles : sms * per_sm;
  return cudaSuccess;
}

template <bool CTRL>
int profile_launch(const void* start, const void* dir, const void* tmax,
                   const void* seed, const void* macro, int n_macro,
                   const Scene& sc, unsigned salt_ctrl, int n, void* rtot,
                   void* ctot, void* t_ctrl, void* stream) {
  const size_t smem = (size_t)n_macro * sizeof(uint32_t);
  cudaError_t err = set_smem(pw_profile_kernel<CTRL>, smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  if ((err = persistent_blocks(pw_profile_kernel<CTRL>, smem, n, &blocks)) !=
      cudaSuccess)
    return (int)err;
  pw_profile_kernel<CTRL><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)start, (const float*)dir, (const float*)tmax,
      (const uint32_t*)seed, (const uint32_t*)macro, n_macro, sc, salt_ctrl,
      n, (float*)rtot, (float*)ctot, (float*)t_ctrl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pw_events_launch(
    const void* start, const void* dir, const void* tmax, const void* seed,
    const void* e_last, const void* macro, int n_macro, float isx, float isy,
    float isz, int mx, int my, int mz, int X, int Y, int Z, float density,
    unsigned e_base, unsigned salt, int S, int n, void* lin, void* t,
    void* c_at, void* sres, void* e_new, void* rtot, void* ctot,
    void* stream) {
  const size_t smem = ((size_t)((n_macro + 3) & ~3) +
                       (size_t)REC_FIELDS * S * THREADS) * sizeof(uint32_t);
  cudaError_t err = set_smem(pw_events_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const Scene sc = make_scene(isx, isy, isz, mx, my, mz, X, Y, Z, density);
  int blocks = 0;
  if ((err = persistent_blocks(pw_events_kernel, smem, n, &blocks)) !=
      cudaSuccess)
    return (int)err;
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
  const Scene sc = make_scene(isx, isy, isz, mx, my, mz, X, Y, Z, density);
  return want_ctrl
             ? profile_launch<true>(start, dir, tmax, seed, macro, n_macro, sc,
                                    salt_ctrl, n, rtot, ctot, t_ctrl, stream)
             : profile_launch<false>(start, dir, tmax, seed, macro, n_macro,
                                     sc, salt_ctrl, n, rtot, ctot, t_ctrl,
                                     stream);
}

extern "C" const char* pw_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
