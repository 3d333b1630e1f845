#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``nrc_hpm_tpu_torch``) once on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``nrc_hpm_tpu_torch/csrc`` (one nvcc per
source, in parallel; ptxas's registers and spills per kernel, K1, K2, K4
and K7 must not spill; the tensor-core instructions in K3's and K4's
SASS, which must exist),
checks each kernel against its plain PyTorch version at the main paths'
shapes and times it by its device time in torch.profiler beside its bound
(K1/K2 also at 65,536 and 1,024 lanes; K4 also at widths 16-256 and at a
depth beyond shared memory; K7 and K7' also at 20 levels), runs
``cache.infer`` at the MLP widths and grid K3 does not take (the split
encode: K7's packed forward, then K4) against the CPU, then drives the
NRC frame on a procedural cloud with seeded random weights: three
frozen-cache frames at
1920x1080 with the default 2^19 hash grid and 64x6 MLP; five
online-training frames (4 Adam steps of 2^14 samples, 32-bounce train
paths) at the same configuration, then one more timed by stage and one
under torch.profiler (each kernel's launches and device ms, the device's
busy share; K3 timed on that frame's own inference input); two online
frames at ``AppConfig.tpu_tuned()`` (2^12 tables, the packed
training encode); small frames against the CPU, one of them an online
frame from ``init_state(0)`` with its own frame seed (the port's threefry
key chain: the caches and keys must agree bit for bit).  Then the other
input encodings (path A): two frozen
and three online 1080p frames at Frequency + TriangleWave (the split
encode and the fused MLP kernel K4), two frozen frames at hash grid +
Identity (K7's packed forward, then K4).  Then the per-interval trackers
(path B): ``trace_fixed`` on the 65,536 train rays of a 1080p frame, 32
bounces at ``coarse=64`` (the packed-table gather K5), and the volume's
float32 macrocell lookups on those rays (K6).  It checks that every kernel
of each path ran in that path's loop (and that the kernels a path does not
take did not), and checks small frames of each configuration and a small
``trace_fixed`` at ``coarse=16`` and ``64`` against the same runs through
the plain versions on the CPU.  Then the Monte-Carlo path: three 1080p
``McRenderer`` frames of 32 bounces on every pixel (K1/K2 and no other
kernel) and one under torch.profiler; 48x27 MC frames in each tracking
mode (``pw``, ``fast``, ``seq``) against the CPU; the port's own golden
(``generate_golden`` at 192x108, 64 frames of 64-bounce MC, under the
git-ignored ``nrc_hpm_tpu_torch/_build/golden/``), which a run resumed at
half its frames must equal bitwise; then a 12-frame MC render scored
against it (|relBias| < 0.06) and the online cache's NRC frames scored
through ``compare_nrc`` (MSE, relBias, CV; not gated).  Last, the app as
a user starts it: the procedural cloud written as a VDB (read back
bitwise) at the scene's path in a scratch working directory beside that
golden, ``app.main`` at ``AppConfig()`` and 1920x1080 with ``--renderer
both``, four frames, the golden compared every other frame, the stage
profile, EXRs and a checkpoint (the online frame's kernels and no
other), then a frozen run from the checkpoint, which must load it
bitwise.  It prints the
card's name and power limit, one line
per kernel, the frame and path times, a JSON kernel summary, and as its
last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises.  Without a CUDA device it exits with code 1.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_LANES = 1 << 20            # K1/K2 lanes: camera rays through the cloud
# K1/K2 are also timed at the train loop's first bounce (65,536 lanes) and
# at a late bounce (1,024 lanes)
PW_TIME_LANES = (N_LANES, 1 << 16, 1 << 10)
N_X5 = 1 << 20               # K3 samples
N_TRAIN = 1 << 14            # K7: one train batch ...
N_TIME = 1 << 20             # ... and the timing size
REPS = 5
# K1/K2 share the plain version's operation order (-fmad=false), so they
# must agree to libm ulps: every element within 1e-5 + 1e-5|ref| and lin
# equal, except at most 1e-5 of the elements (an ulp that crosses a cell
# boundary moves one event).
PW_TOL = dict(rtol=1e-5, atol=1e-5, max_bad=1e-5)
# K3 sums in another order than torch.matmul; a one-ulp bf16 flip of an
# activation moves an output by ~0.4%: 99.99% of the elements within
# 1e-2 + 1e-2|ref|, all within 1e-1 + 1e-1|ref|.
K3_TOL = dict(rtol=1e-2, atol=1e-2, max_bad=1e-4, hard=1e-1)
# K4 sums in another order than torch.matmul, as K3 does: the same bound.
K4_TOL = K3_TOL
N_K4 = 1 << 20               # K4 samples
N_K4_WIDTHS = 1 << 16        # K4 samples checked at each other shape
# K4's other (width, depth): each padded width's instance, STREAM above 128
# and where the weights outgrow shared memory (128 x 8)
K4_SHAPES = ((16, 6), (32, 6), (48, 6), (128, 6), (256, 6), (128, 8))
# K5/K6 copy table words: bitwise.
BITWISE = dict(rtol=0.0, atol=0.0, max_bad=0.0)
N_PROFILE = 1 << 16          # K5/K6 lanes: the train rays of a 1080p frame
COARSE = 64                  # intervals of the per-interval trackers
N_COARSE_CPU = 4096          # lanes of the coarse=16/64 checks on the CPU
# K7 forward: the same corner math and products as the plain version, the
# 8 products summed in another order: every feature within 2e-6 + 1e-5|ref|.
K7_FWD_TOL = dict(rtol=1e-5, atol=2e-6, max_bad=0.0)
# K7 backward: float32 atomics add in an order that changes from run to
# run: every entry within 1e-7 + 1e-4 S, S the sum of the |terms| added
# into it (the terms themselves are bitwise the plain version's).
K7_BWD_TOL = dict(rtol=1e-4, atol=1e-7, max_bad=0.0)
# Small online frame, kernels against plain-on-CPU.  The same train inputs
# and state through train_frame: every trained entry within 1e-4 +
# 1e-3|ref| (cuBLAS and atomics sum in another order).  The whole frame: a
# train ray whose primary or train path flips on a libm ulp between CUDA
# and the CPU gets another input or target (>= 99% of the train lanes
# must agree within 1e-3), and Adam (steps of ~lr = 1e-2 wherever |g| >>
# eps) spreads such a lane over the first MLP layer: >= 95% of the
# entries of every leaf within 1e-4 + 1e-3|ref|.
TRAIN_TOL = dict(rtol=1e-3, atol=1e-4, share=1.0)
FRAME_TRAIN_TOL = dict(rtol=1e-3, atol=1e-4, share=0.95)
# How far the whole frame's training spreads those few lanes depends on
# the lanes and the features: without a hash grid the position features
# are O(1), and features an ulp apart at TriangleWave's and Frequency's
# 2^11 frequencies reach every entry of every layer, which Adam's first
# steps move by ~lr whatever the gradient's size (on the card 72% of the
# first layer was within FRAME_TRAIN_TOL at TriangleWave + OneBlob, 65% at
# the default encoding with env_fixed16).  So the frames of the other
# configurations hold their trained cache by its loss, which every entry
# moves: within FRAME_LOSS_RTOL of the CPU frame's (the six small frames
# read 0.18%-2.25% apart on the card, the most at Frequency +
# TriangleWave, the same in every call), and by their train inputs
# (above) and the training on the same inputs (below), which together
# fix what a frame trains.  Without a hash grid the NRC term of a pixel
# moves with K4's bf16 flips, which are relative (the K4 bound): >= 99%
# of the pixels within 1e-3 + 1e-2|ref|.  Frequency(12)'s 2^11 pi x turns an ulp of x
# into ~4e-4 of the feature, a bf16 flip of K4's input: 98.53% of that
# frame's pixels were within 1e-3 alone on the card.
FRAME_IMAGE_RTOL = 1e-2
FRAME_LOSS_RTOL = 5e-2
# The same inputs at the other configurations: a bf16 activation flipped
# by a float32 sum in another order reaches the gradient, and Adam's first
# steps move an entry whose gradient is near 0 by ~lr either way (the CPU
# tests hold the JAX and port steps so; on the card 99.15% of one hidden
# layer at env_fixed16, max_abs_err 1.2e-2 ~ lr): >= 99% of the entries
# of every leaf within 1e-4 + 1e-3|ref|.
SAME_INPUT_TOL = dict(rtol=1e-3, atol=1e-4, share=0.99)
# The coarse=16/64 trace_fixed through the kernels against the plain run on
# the CPU: the RNG state equal; lanes (alive, and radiance, throughput and
# terminal point within 1e-3) agree on >= 99%: an event depth an ulp apart
# may pick another fine cell, as the CPU tests against JAX allow.
COARSE_LANE_SHARE = 0.99
# NVIDIA H100 SXM peaks (data sheet, dense): device memory bytes/s, bf16
# tensor-core and float32 (outside the tensor cores) operations/s
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
F32_OPS_S = 67e12
# float32 operations per lane counted from csrc/pw_kernels.cu: one macro
# lookup (box coordinates, bounds tests, clamp, index, decode), one
# profile interval (point, max/min, two running sums), one event (hash,
# log1p, walk steps, inversion, fine cell); and per (sample, level) of the
# hash-grid encode (cell, 8 corner weights and indices, 16 products/sums)
LOOKUP_OPS, INTERVAL_OPS, EVENT_OPS, LEVEL_OPS = 30, 14, 60, 150
# kernels whose every instance must not spill registers
NO_SPILL = ("pw_events_kernel", "pw_profile_kernel", "fused_mlp_resident",
            "fused_mlp_stream", "hash_grid_train_fwd_kernel",
            "hash_grid_train_bwd_kernel")
# the kernel of each wrapper, by the name the profiler shows
KERNEL_NAMES = dict(pw_events="pw_events_kernel",
                    pw_profile="pw_profile_kernel",
                    fused_encode_mlp="fused_encode_mlp_kernel",
                    hash_grid_train_fwd="hash_grid_train_fwd_kernel",
                    hash_grid_train_bwd="hash_grid_train_bwd_kernel",
                    fused_mlp="fused_mlp_",
                    table_gather="table_gather_kernel",
                    small_table_lookup="small_table_lookup_kernel")


def gpu_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    """Median milliseconds of REPS calls (CUDA events), after a warm-up."""
    fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def sm_clock() -> str:
    """The card's SM and memory clocks now (the SM clock falls under a
    heavy load at the power limit, so they go beside every time)."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip() or "unknown"


def device_rows(torch, prof) -> list:
    """(name, self device ms, count) of the kernels and copies a profile
    saw on the card (CPU operator rows, which carry their kernels' time
    too, left out)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(r.key, r.self_device_time_total / 1e3, r.count)
            for r in prof.key_averages()
            if r.device_type == cuda and r.self_device_time_total > 0]


def busy_ms(torch, prof) -> float:
    """Milliseconds in which at least one device operation ran: the union
    of their intervals."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def device_ms(torch, fn, name: str, reps: int = REPS, kernel=None,
              optional: bool = False):
    """Milliseconds of device time per call of ``fn`` spent in the kernel
    ``KERNEL_NAMES[name]`` (or in those whose name holds ``kernel``), from
    torch.profiler over ``reps`` calls after a warm-up (the kernel alone:
    no launch gaps, no set-up kernels of the wrapper).  A trace that lost
    the kernel's events is taken again, up to three times in all; then it
    raises, or returns None (not measured) where ``optional``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        want = KERNEL_NAMES[name] if kernel is None else kernel
        ms = sum(t for key, t, _ in device_rows(torch, prof) if want in key)
        if ms > 0:
            return ms / reps
    if optional:
        return None
    raise AssertionError(f"{name}: the profiler saw no device time")


def bound(n_bytes: float, bf16_ops: float = 0.0, f32_ops: float = 0.0):
    """(bound_ms, bound_by): the least time the card could take, the
    larger of the bytes over device memory's rate and the operations over
    their type's peak rate."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_S
    t_ops = 1e3 * max(bf16_ops / BF16_OPS_S, f32_ops / F32_OPS_S)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pw_bound(n: int, n_macro: int, S: int = 0, draw: bool = True):
    """K1 (S events) or K2 (S = 0: the control draw, none without
    ``draw``) on n lanes: per lane the 32 bytes of start/direction/tmax/
    seed read, K1's e_last read and 16 bytes per event plus e_new/rtot/ctot
    written, K2's rtot/ctot/t_ctrl written; the macro table read once."""
    per_lane = 32 + (4 + 16 * S + 12 if S else 12)
    ops = (33 * LOOKUP_OPS + 32 * INTERVAL_OPS
           + (S or int(draw)) * EVENT_OPS)
    return bound(n * per_lane + 4 * n_macro, f32_ops=n * ops)


def mlp_ops(layers) -> int:
    """Operations per sample of a bias-free MLP (a multiply and an add per
    weight)."""
    return sum(2 * w.shape[0] * w.shape[1] for w in layers)


def gpu_sass_count(so, opcode: str) -> int:
    """Instructions of ``opcode`` in a library's SASS (cuobjdump of the CUDA
    toolkit, or the copy Triton bundles)."""
    import importlib.util
    import shutil

    cands = [shutil.which("cuobjdump"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.submodule_search_locations:
        cands.append(os.path.join(spec.submodule_search_locations[0],
                                  "backends", "nvidia", "bin", "cuobjdump"))
    tool = next((c for c in cands if c and os.path.exists(c)), None)
    if tool is None:
        raise AssertionError("cuobjdump not found: cannot read the SASS")
    res = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True, timeout=300, check=True)
    return sum(1 for line in res.stdout.splitlines()
               if re.search(rf"\b{opcode}\b", line))


def ptxas_kernels(log: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from an ``nvcc -Xptxas -v`` log."""
    out, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)),) + spills
            spills = (0, 0)
    return out


def kernel_name(mangled: str) -> str:
    """The kernel's own name in a mangled symbol: the last identifier,
    read by its length prefix, that ends in ``_kernel``."""
    name = mangled
    for m in re.finditer(r"(?=(\d+))", mangled):
        at = m.start() + len(m.group(1))
        ident = mangled[at:at + int(m.group(1))]
        if ident.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", ident):
            name = ident
    return name


def compare(torch, name, got: dict, want: dict, rtol, atol, max_bad,
            hard=None, scale=None) -> float:
    """Max abs error over all outputs; raises if more than ``max_bad`` of
    the elements miss rtol/atol (integer outputs must be equal), or any
    misses ``hard``.  ``scale`` (per key) replaces |ref| in the rtol
    term."""
    worst, bad, total = 0.0, 0, 0
    for key, w in want.items():
        g = got[key]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}.{key}: {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        if not torch.is_floating_point(w):
            miss = g != w
        else:
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{name}.{key}: non-finite output")
            err = (g - w).abs()
            worst = max(worst, float(err.max()))
            ref = w.abs() if scale is None else scale[key]
            miss = err > atol + rtol * ref
            if hard is not None and bool((err > hard + hard * w.abs()).any()):
                raise AssertionError(f"{name}.{key}: error above {hard}")
        bad += int(miss.sum())
        total += miss.numel()
    print(f"{name}: max_abs_err={worst:.3e} mismatched={bad}/{total} "
          f"(allowed {max_bad:g} at rtol={rtol:g} atol={atol:g})")
    if bad > max_bad * total:
        raise AssertionError(f"{name}: {bad} of {total} elements mismatch")
    return worst


def build() -> dict:
    """Build every library, one nvcc each, all started together (timed);
    print ptxas's registers and spills for each kernel and the tensor-core
    (HMMA) instructions of K3's and K4's libraries.  K1, K2, K4 and K7
    (both directions) must not spill and K3 and K4 must run on the tensor
    cores.  Returns the library path of each source."""
    from nrc_hpm_tpu_torch.ops import (_build, fused_encode_mlp, fused_mlp,
                                       hash_grid_train, pw_kernels,
                                       table_gather)

    t0 = time.perf_counter()
    jobs = [(pw_kernels._LIB, ("-fmad=false",)), (fused_encode_mlp._LIB, ()),
            (hash_grid_train._LIB, ()), (table_gather._LIB, ()),
            (fused_mlp._LIB, ())]

    def run(job):
        so = _build.library_path(*job)
        return so, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        done = list(pool.map(run, jobs))
    each = ", ".join(f"{' '.join((job[0],) + job[1])} {s:.1f} s"
                     for job, (_, s) in zip(jobs, done))
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, "
          f"{len(jobs)} builds in parallel; done after: {each})")
    spills = {}
    for so, _ in done:
        log = so.with_suffix(".log")
        for kern, (n_regs, st, ld) in ptxas_kernels(
                log.read_text() if log.exists() else "").items():
            spills[kern] = st + ld
            inst = re.search(r"ILb[01]E|ILi\d+E", kern)
            short = kernel_name(kern) + (
                f"<{inst.group(0)[3:-1]}>" if inst else "")
            print(f"ptxas {so.name} {short}: {n_regs} registers, spill "
                  f"stores {st} B, spill loads {ld} B")
    for kern in NO_SPILL:
        found = [v for k, v in spills.items() if kern in k]
        if not found or any(found):
            raise AssertionError(f"{kern} spills (or was not found in the "
                                 f"ptxas log)")
    libs = {job[0]: so for job, (so, _) in zip(jobs, done)}
    for lib in (fused_encode_mlp._LIB, fused_mlp._LIB):
        hmma = gpu_sass_count(libs[lib], "HMMA")
        print(f"SASS of {libs[lib].name}: {hmma} HMMA instructions (tensor "
              f"cores)")
        if hmma <= 0:
            raise AssertionError(f"{lib} has no HMMA instruction")
    return libs


def kernel_row(name, source, replaces, err, ms, plain_ms, bnd,
               library_ms=None) -> dict:
    bound_ms, bound_by = bnd
    lib = "" if library_ms is None else f", library call {library_ms:.4f} ms"
    print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}){lib}, clocks {sm_clock()}")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def camera_lanes(torch, dev, vol, cfg, gen):
    """K1/K2's lanes: N_LANES random camera rays of the reference camera
    clipped to the volume's box (start, direction, tmax), random seeds and
    a zero event depth."""
    from nrc_hpm_tpu_torch.camera import Camera, pixel_rays
    from nrc_hpm_tpu_torch.volume import find_entry_exit

    cam = Camera.reference_camera(device=dev)
    ro, rd, _ = pixel_rays(cam, cfg.render_width, cfg.render_height)
    rd = rd.reshape(-1, 3)
    pick = torch.randperm(rd.shape[0], generator=gen)[:N_LANES].to(dev)
    rd = rd[pick].contiguous()
    entry, exit_, hit = find_entry_exit(vol, ro.expand_as(rd), rd)
    tmax = torch.where(hit, torch.linalg.vector_norm(exit_ - entry, dim=-1),
                       0.0)
    seed = torch.randint(-2**31, 2**31 - 1, (N_LANES,), generator=gen,
                         dtype=torch.int32).to(dev)
    print(f"K1/K2 lanes: {N_LANES} camera rays, {int(hit.sum())} hit the box")
    return (entry.contiguous(), rd, tmax, seed,
            torch.zeros(N_LANES, device=dev))


def seeded_key(torch, gen):
    """A threefry key (the port's cache init) whose seed ``gen`` draws."""
    from nrc_hpm_tpu_torch.utils.prng import prng_key

    return prng_key(int(torch.randint(0, 2 ** 31, (1,), generator=gen)))


def k3_inputs(torch, dev, cfg, gen):
    """K3's arguments at ``cfg``: a unit-scale packed table (it exercises
    the gathers more than tcnn's 1e-4 init), the seeded MLP, N_X5 random
    inputs with theta spanning [-0.5, 1.5], the grid spec."""
    from nrc_hpm_tpu_torch.models.nrc.cache import NeuralRadianceCache
    from nrc_hpm_tpu_torch.models.nrc.encoding import pack_table_bf16

    cache = NeuralRadianceCache(cfg)
    spec = cache.encoding.grid_spec
    layers = cache.init_state(seeded_key(torch, gen),
                              dev).ema_params["mlp"]["layers"]
    table = (torch.rand((spec.total_params, 2), generator=gen) * 2 - 1)
    x5 = torch.rand((N_X5, 5), generator=gen).to(dev)
    x5[:, 3] = x5[:, 3] * 2.0 - 0.5
    return pack_table_bf16(table).to(dev), layers, x5, spec


def kernel_phase(torch, dev, vol, cfg) -> list:
    from nrc_hpm_tpu_torch.config import AppConfig
    from nrc_hpm_tpu_torch.ops import fused_encode_mlp as fem
    from nrc_hpm_tpu_torch.ops import hash_grid_train as hgt
    from nrc_hpm_tpu_torch.ops import pw_kernels as pk

    gen = torch.Generator().manual_seed(1)
    start, rd, tmax, seed, e_last = camera_lanes(torch, dev, vol, cfg, gen)
    rows = []

    def row(*args):
        rows.append(kernel_row(*args))

    src_pw = "nrc_hpm_tpu_torch/csrc/pw_kernels.cu"
    n_macro = vol.macro_packed.numel()
    args = (vol, start, rd, tmax, seed)
    # both instances of K2: with the control draw (delta tracking) and
    # without it (ratio tracking)
    err = max(compare(torch, f"pw_profile want_ctrl={ctrl}",
                      pk.pw_profile(*args, want_ctrl=ctrl),
                      pk.pw_profile_plain(*args, want_ctrl=ctrl), **PW_TOL)
              for ctrl in (True, False))
    pw_ms = pw_times(torch, pk, args, e_last)
    row("pw_profile", src_pw, "nrc_hpm_tpu/ops/pw_kernels.py:231", err,
        pw_ms[("pw_profile", N_LANES)],
        time_ms(torch, lambda: pk.pw_profile_plain(*args, want_ctrl=True)),
        pw_bound(N_LANES, n_macro))
    rows[-1]["no_ctrl_ms"] = pw_ms[("pw_profile no ctrl", N_LANES)]
    err = 0.0
    for salt in (pk.SALT_RATIO, pk.SALT_DELTA):
        err = max(err, compare(
            torch, f"pw_events salt={salt:#x}",
            pk.pw_events(*args, e_last, 0, S=16, salt=salt),
            pk.pw_events_plain(*args, e_last, 0, S=16, salt=salt), **PW_TOL))
    row("pw_events", src_pw, "nrc_hpm_tpu/ops/pw_kernels.py:78", err,
        pw_ms[("pw_events", N_LANES)],
        time_ms(torch, lambda: pk.pw_events_plain(*args, e_last, 0, S=16)),
        pw_bound(N_LANES, n_macro, 16))

    fargs = k3_inputs(torch, dev, cfg, gen)
    packed, layers, x5, spec = fargs
    err = compare(torch, "fused_encode_mlp",
                  dict(out=fem.fused_encode_mlp_infer(*fargs)),
                  dict(out=fem.fused_encode_mlp_plain(*fargs)), **K3_TOL)
    row("fused_encode_mlp", "nrc_hpm_tpu_torch/csrc/fused_encode_mlp.cu",
        "nrc_hpm_tpu/ops/fused_encode_mlp.py:66", err,
        k3_ms(torch, fem, fargs),
        time_ms(torch, lambda: fem.fused_encode_mlp_plain(*fargs)),
        k3_bound(N_X5, spec, layers))
    # the same work on the tpu_tuned 2^12 table (256 KB, L2-resident): what
    # the 2^19 table's size costs the gathers
    k3_ms(torch, fem, k3_inputs(torch, dev, AppConfig.tpu_tuned(),
                                torch.Generator().manual_seed(2)),
          " at the 2^12 table")
    # hash grid + another direction encoding infers through K7's packed
    # forward at the default 2^19 table (then K4)
    x = x5[:, :3].contiguous()
    compare(torch, "hash_grid_train_fwd packed 2^19 (inference)",
            dict(out=hgt.hash_grid_train_fwd(packed, x, spec, True)),
            dict(out=hgt.hash_grid_train_fwd_plain(packed, x, spec, True)),
            **K7_FWD_TOL)
    rows += train_encode_phase(torch, dev, cfg, gen)
    rows += mlp_and_lookup_kernels(torch, dev, vol, cfg, gen)
    return rows


def pw_times(torch, pk, args, e_last) -> dict:
    """K1 (S = 16) and K2 (with the control draw, and without it as
    "pw_profile no ctrl") device times on the first m of the lanes, m in
    PW_TIME_LANES."""
    out = {}
    n_macro = args[0].macro_packed.numel()
    for m in PW_TIME_LANES:
        sub = (args[0],) + tuple(a[:m] for a in args[1:])
        for label, fn, bnd in (
                ("pw_events", lambda: pk.pw_events(*sub, e_last[:m], 0, S=16),
                 pw_bound(m, n_macro, 16)),
                ("pw_profile", lambda: pk.pw_profile(*sub, want_ctrl=True),
                 pw_bound(m, n_macro)),
                ("pw_profile no ctrl",
                 lambda: pk.pw_profile(*sub, want_ctrl=False),
                 pw_bound(m, n_macro, draw=False))):
            name = label.split()[0]
            out[(label, m)] = device_ms(torch, fn, name)
            print(f"{label} {m} lanes: kernel {out[(label, m)]:.4f} ms "
                  f"(device), wrapper call {time_ms(torch, fn):.4f} ms, "
                  f"bound {bnd[0]:.4f} ms ({bnd[1]}), clocks {sm_clock()}")
    return out


def k3_bound(n: int, spec, layers):
    """K3 on n samples: x5 read and the outputs written, the packed table
    and the weights read once; the MLP's bf16 products and the encode's
    float32 work."""
    out_dim = layers[-1].shape[1]
    n_bytes = (n * (20 + 4 * out_dim) + 4 * spec.total_params
               + 2 * sum(w.numel() for w in layers))
    return bound(n_bytes, bf16_ops=n * mlp_ops(layers),
                 f32_ops=n * spec.n_levels * LEVEL_OPS)


def k3_ms(torch, fem, fargs, label: str = "") -> float:
    """K3's device time at fargs' sample count (printed beside its wrapper
    call, which also lays out the weights, and its bound)."""
    ms = device_ms(torch, lambda: fem.fused_encode_mlp_infer(*fargs),
                   "fused_encode_mlp")
    bnd = k3_bound(fargs[2].shape[0], fargs[3], fargs[1])
    wrapper = time_ms(torch, lambda: fem.fused_encode_mlp_infer(*fargs))
    print(f"fused_encode_mlp {fargs[2].shape[0]} samples{label}: kernel "
          f"{ms:.4f} ms (device), wrapper call {wrapper:.4f} ms, bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}), clocks {sm_clock()}")
    return ms


def mlp_and_lookup_kernels(torch, dev, vol, cfg, gen) -> list:
    """K4 on 2^20 samples of the 80 Frequency(12) + TriangleWave(4)
    features of random inputs through the 64x6 MLP, and on 2^16 of them
    (checked) and 2^20 (timed) at the other widths K4_SHAPES; K5 on the
    packed macro table and K6 on the float32 macro tables with (65, 65,536)
    random cell indices."""
    from nrc_hpm_tpu_torch.config import EncodingConfig
    from nrc_hpm_tpu_torch.models.nrc.cache import NeuralRadianceCache
    from nrc_hpm_tpu_torch.ops import fused_mlp as fm
    from nrc_hpm_tpu_torch.ops import macro_gather as mg
    from nrc_hpm_tpu_torch.ops import table_gather as tg

    rows = []
    src = "nrc_hpm_tpu_torch/csrc/fused_mlp.cu"
    enc = EncodingConfig(pos_id=3, dir_id=2)
    cache = NeuralRadianceCache(dataclasses.replace(cfg, encoding=enc))
    mlp = cache.init_state(seeded_key(torch, gen), dev).ema_params["mlp"]
    x5 = torch.rand((N_K4, 5), generator=gen).to(dev)
    feats = cache.encoding({}, x5)
    print(f"fused_mlp: {N_K4} samples of {feats.shape[1]} features, "
          f"{[tuple(w.shape) for w in mlp['layers']]}")
    err = compare(torch, "fused_mlp",
                  dict(out=fm.fused_mlp_infer(mlp, feats)),
                  dict(out=fm.fused_mlp_plain(mlp, feats)), **K4_TOL)
    layers = mlp["layers"]
    rows.append(kernel_row(
        "fused_mlp", src, "nrc_hpm_tpu/ops/fused_mlp.py:37", err,
        device_ms(torch, lambda: fm.fused_mlp_infer(mlp, feats),
                  "fused_mlp"),
        time_ms(torch, lambda: fm.fused_mlp_plain(mlp, feats)),
        k4_bound(feats, layers)))
    # the other shapes: every padded width, STREAM above 128 and where the
    # weights outgrow shared memory (width 128, depth 8)
    few = feats[:N_K4_WIDTHS]
    widths_ms = {}
    for width, depth in K4_SHAPES:
        w_cache = NeuralRadianceCache(dataclasses.replace(
            cfg, nn_width=width, nn_depth=depth, encoding=enc))
        w_mlp = w_cache.init_state(seeded_key(torch, gen),
                                   dev).ema_params["mlp"]
        ly = w_mlp["layers"]
        stream = fm.plan(ly, feats.shape[1], ly[-1].shape[1])[2]
        label = (f"fused_mlp width {width} depth {depth} "
                 f"({'STREAM' if stream else 'RESIDENT'})")
        compare(torch, f"{label} ({N_K4_WIDTHS} samples)",
                dict(out=fm.fused_mlp_infer(w_mlp, few)),
                dict(out=fm.fused_mlp_plain(w_mlp, few)), **K4_TOL)
        ms = device_ms(torch, lambda: fm.fused_mlp_infer(w_mlp, feats),
                       "fused_mlp")
        bnd = k4_bound(feats, ly)
        widths_ms[f"{width}x{depth}"] = ms
        print(f"{label} {N_K4} samples: kernel {ms:.4f} ms (device), bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}), clocks {sm_clock()}")
    rows[-1]["shapes_ms"] = widths_ms

    src = "nrc_hpm_tpu_torch/csrc/table_gather.cu"
    n_cells = vol.macro_packed.shape[0]
    idx = torch.randint(0, n_cells, (COARSE + 1, N_PROFILE), generator=gen,
                        dtype=torch.int32).to(dev)
    table = vol.macro_packed
    err = compare(torch, f"table_gather ({n_cells} words)",
                  dict(out=tg.table_gather(table, idx)),
                  dict(out=tg.table_gather_plain(table, idx)), **BITWISE)
    # indices read and words written once each, the table read once
    lookup_bound = bound(8 * idx.numel() + 4 * n_cells)
    rows.append(kernel_row(
        "table_gather", src, "nrc_hpm_tpu/ops/table_gather.py:40", err,
        device_ms(torch, lambda: tg.table_gather(table, idx),
                  "table_gather"),
        time_ms(torch, lambda: tg.table_gather_plain(table, idx)),
        lookup_bound, library_ms=time_ms(torch, lambda: table[idx])))
    # float32 words compared as their bits
    err = max(compare(torch, f"small_table_lookup {key} bits",
                      dict(out=mg.small_table_lookup(
                          getattr(vol, key), idx).view(torch.int32)),
                      dict(out=mg.small_table_lookup_plain(
                          getattr(vol, key), idx).view(torch.int32)),
                      **BITWISE)
              for key in ("macro", "macro_min"))
    rows.append(kernel_row(
        "small_table_lookup", src, "nrc_hpm_tpu/ops/macro_gather.py:30", err,
        device_ms(torch, lambda: mg.small_table_lookup(vol.macro, idx),
                  "small_table_lookup"),
        time_ms(torch, lambda: mg.small_table_lookup_plain(vol.macro, idx)),
        lookup_bound, library_ms=time_ms(torch, lambda: vol.macro[idx])))
    return rows


def k4_bound(feats, layers):
    """K4: the features read and the outputs written once, the weights
    read once; the MLP's bf16 products."""
    n = feats.shape[0]
    return bound(feats.numel() * 4 + n * 4 * layers[-1].shape[1]
                 + 2 * sum(w.numel() for w in layers),
                 bf16_ops=n * mlp_ops(layers))


def repeating_positions(torch, n: int, gen):
    """n box positions (on the CPU) that repeat as a frame's train batch
    does: each 32 consecutive samples lie within 2e-3 of one random point,
    and every third position is the one before it."""
    centers = torch.rand((n // 32 + 1, 3), generator=gen) * 0.8 + 0.1
    x = centers[torch.arange(n) // 32] + (
        torch.rand((n, 3), generator=gen) * 4e-3 - 2e-3)
    x[2::3] = x[1::3][:x[2::3].shape[0]]
    return x


def train_encode_phase(torch, dev, cfg, gen) -> list:
    """K7 forward and backward against their plain versions: the float32
    table at the default 2^19 per level and the packed table at the
    tpu_tuned 2^12, one train batch and 2^20 samples, unit-scale tables;
    the backward also on one train batch of repeating positions; both at
    20 levels (past the 16 of K3's level arrays) on one train batch.
    The rows carry the 2^19 float32 times at 2^20 samples (the default
    configuration's route) and at one train batch (``train_batch_ms``).
    Both bounds count the table rows the lookups touch, the forward's
    read and the backward's written; ``zeros_ms`` / ``zeros_bound_ms``
    time and bound the backward wrapper's torch.zeros of the whole
    gradient, which runs before it."""
    from nrc_hpm_tpu_torch.config import AppConfig
    from nrc_hpm_tpu_torch.models.nrc.encoding import (CompositeEncoding,
                                                       pack_table_bf16)
    from nrc_hpm_tpu_torch.ops import hash_grid_train as hgt

    src = "nrc_hpm_tpu_torch/csrc/hash_grid_train.cu"
    replaces = "nrc_hpm_tpu/models/nrc/encoding.py:296"
    errs = {"hash_grid_train_fwd": 0.0, "hash_grid_train_bwd": 0.0}
    times = {}
    tuned = AppConfig.tpu_tuned().encoding
    for packed, enc, sizes in (
            (False, cfg.encoding, (N_TRAIN, N_TIME)),
            (True, tuned, (N_TRAIN, N_TIME)),
            (False, dataclasses.replace(cfg.encoding, n_levels=20),
             (N_TRAIN,)),
            (True, dataclasses.replace(tuned, n_levels=20), (N_TRAIN,))):
        spec = CompositeEncoding(enc).grid_spec
        table = (torch.rand((spec.total_params, 2), generator=gen) * 2 - 1
                 ).to(dev)
        src_table = pack_table_bf16(table) if packed else table
        tag = (f"{'packed' if packed else 'float32'} "
               f"2^{enc.log2_hashmap_size} {spec.n_levels} levels")
        for n in sizes:
            x = torch.rand((n, 3), generator=gen).to(dev)
            x = x * 1.2 - 0.1          # box coordinates, a little outside
            g = torch.randn((n, spec.out_dim), generator=gen).to(dev)
            fargs = (src_table, x, spec, packed)
            bargs = (x, g, spec, packed)
            errs["hash_grid_train_fwd"] = max(
                errs["hash_grid_train_fwd"], compare(
                    torch, f"hash_grid_train_fwd {tag} n={n}",
                    dict(out=hgt.hash_grid_train_fwd(*fargs)),
                    dict(out=hgt.hash_grid_train_fwd_plain(*fargs)),
                    **K7_FWD_TOL))
            s = hgt.hash_grid_train_bwd_plain(x, g.abs(), spec, packed)
            errs["hash_grid_train_bwd"] = max(
                errs["hash_grid_train_bwd"], compare(
                    torch, f"hash_grid_train_bwd {tag} n={n}",
                    dict(dtable=hgt.hash_grid_train_bwd(*bargs)),
                    dict(dtable=hgt.hash_grid_train_bwd_plain(*bargs)),
                    scale=dict(dtable=s), **K7_BWD_TOL))
            if spec.n_levels != cfg.encoding.n_levels:
                continue
            # the rows the lookups touch (read forward, written backward);
            # the backward wrapper's torch.zeros writes the whole (P, 2)
            # gradient first
            touched = int((s.sum(-1) > 0).sum())
            zeros_ms = bound(8 * spec.total_params)[0]
            # an aside, not a check: the profiler's trace of this memset
            # once came back empty three times in a row
            zeros_dev = device_ms(
                torch, lambda: torch.zeros((spec.total_params, 2),
                                           device=dev), "torch.zeros",
                kernel="", optional=True)
            for name, fn, plain, args in (
                    ("hash_grid_train_fwd", hgt.hash_grid_train_fwd,
                     hgt.hash_grid_train_fwd_plain, fargs),
                    ("hash_grid_train_bwd", hgt.hash_grid_train_bwd,
                     hgt.hash_grid_train_bwd_plain, bargs)):
                ms = device_ms(torch, lambda: fn(*args), name)
                plain_ms = time_ms(torch, lambda: plain(*args))
                # x and the (N, L, 2) features or their gradient once; the
                # touched rows read (forward, 4 bytes a packed row) or
                # written (backward, float32)
                fwd = name.endswith("fwd")
                bnd = bound(12 * n + 8 * n * spec.n_levels
                            + (4 if fwd and packed else 8) * touched,
                            f32_ops=n * spec.n_levels * LEVEL_OPS)
                took = ("not measured" if zeros_dev is None
                        else f"{zeros_dev:.4f} ms (device)")
                zeros = "" if fwd else (
                    f" (the wrapper's torch.zeros "
                    f"of the {8 * spec.total_params / 1e6:.1f} MB gradient "
                    f"before it: {took}, bound {zeros_ms:.4f} ms)")
                print(f"{name} {tag} n={n}: kernel {ms:.4f} ms (device), "
                      f"plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms "
                      f"({bnd[1]}; {touched} of {spec.total_params} rows "
                      f"touched){zeros}")
                times[(name, packed, n)] = (ms, plain_ms, bnd, zeros_ms,
                                            zeros_dev)
            if n != N_TRAIN:
                continue
            # one train batch that repeats positions, as a frame's does:
            # the lanes of a warp share rows on every level, so the
            # backward's __match_any_sync groups carry the work
            x = repeating_positions(torch, N_TRAIN, gen).to(dev)
            g = torch.randn((N_TRAIN, spec.out_dim), generator=gen).to(dev)
            bargs = (x, g, spec, packed)
            s = hgt.hash_grid_train_bwd_plain(x, g.abs(), spec, packed)
            errs["hash_grid_train_bwd"] = max(
                errs["hash_grid_train_bwd"], compare(
                    torch, f"hash_grid_train_bwd {tag} n={N_TRAIN} "
                    f"repeating", dict(dtable=hgt.hash_grid_train_bwd(
                        *bargs)),
                    dict(dtable=hgt.hash_grid_train_bwd_plain(*bargs)),
                    scale=dict(dtable=s), **K7_BWD_TOL))
            ms = device_ms(torch, lambda: hgt.hash_grid_train_bwd(*bargs),
                           "hash_grid_train_bwd")
            print(f"hash_grid_train_bwd {tag} n={N_TRAIN} repeating "
                  f"positions: kernel {ms:.4f} ms (device), "
                  f"{int((s.sum(-1) > 0).sum())} rows touched")
    rows = []
    for name in ("hash_grid_train_fwd", "hash_grid_train_bwd"):
        ms, plain_ms, bnd, zeros_ms, zeros_dev = times[(name, False, N_TIME)]
        row = dict(name=name, route="cuda", source=src, replaces=replaces,
                   max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                   bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                   train_batch_ms=times[(name, False, N_TRAIN)][0],
                   train_batch_bound_ms=times[(name, False, N_TRAIN)][2][0])
        if name.endswith("bwd"):
            row.update(zeros_ms=zeros_dev, zeros_bound_ms=zeros_ms)
        rows.append(row)
    return rows


def wrappers() -> dict:
    """Every kernel wrapper, by kernel name; each counts its launches."""
    from nrc_hpm_tpu_torch.ops import fused_encode_mlp as fem
    from nrc_hpm_tpu_torch.ops import fused_mlp as fm
    from nrc_hpm_tpu_torch.ops import hash_grid_train as hgt
    from nrc_hpm_tpu_torch.ops import macro_gather as mg
    from nrc_hpm_tpu_torch.ops import pw_kernels as pk
    from nrc_hpm_tpu_torch.ops import table_gather as tg

    return dict(pw_events=pk.pw_events, pw_profile=pk.pw_profile,
                fused_encode_mlp=fem.fused_encode_mlp_infer,
                hash_grid_train_fwd=hgt.hash_grid_train_fwd,
                hash_grid_train_bwd=hgt.hash_grid_train_bwd,
                fused_mlp=fm.fused_mlp_infer, table_gather=tg.table_gather,
                small_table_lookup=mg.small_table_lookup)


# The kernels each path must launch; every other kernel must not run there.
TRACK = ("pw_events", "pw_profile")
# cache.infer at the shapes K3 does not take: K7's packed forward, then K4
SPLIT_INFER = ("hash_grid_train_fwd", "fused_mlp")
N_INFER = 1 << 14
# (nn_width, nn_depth, n_levels, the kernels cache.infer launches there):
# every K4 design and padding, 128 x 8 beyond shared memory, 20 levels
INFER_ROUTES = ((16, 6, 16, SPLIT_INFER), (32, 6, 16, SPLIT_INFER),
                (48, 6, 16, SPLIT_INFER), (128, 6, 16, SPLIT_INFER),
                (256, 6, 16, SPLIT_INFER), (128, 8, 16, SPLIT_INFER),
                (64, 6, 20, SPLIT_INFER), (64, 6, 16, ("fused_encode_mlp",)))
TRAIN = ("hash_grid_train_fwd", "hash_grid_train_bwd")
FROZEN_KERNELS = TRACK + ("fused_encode_mlp",)
ONLINE_KERNELS = FROZEN_KERNELS + TRAIN
# Frequency(12) + TriangleWave(4): split encode in torch, then K4
FREQ_TRI_FROZEN = TRACK + ("fused_mlp",)
# hash grid + Identity: K7's packed forward, then K4; trained through K7
HASH_ID_FROZEN = TRACK + ("hash_grid_train_fwd", "fused_mlp")


def zero_launches() -> None:
    for w in wrappers().values():
        w.launches = 0


def read_launches() -> dict:
    return {k: w.launches for k, w in wrappers().items()}


def run_frames(torch, r, state, cam, frames: int, train: bool):
    """Drive ``frames`` frames with every launch count set to 0 just
    before; returns (state, launches, per-frame seconds)."""
    zero_launches()
    times = []
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = r.step(state, cam, train=train)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return state, read_launches(), times


def check_image(torch, r, img, label: str) -> None:
    if tuple(img.shape) != (r.height, r.width, 4):
        raise AssertionError(f"{label}: image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label}: non-finite pixels")
    env = r.lights.env.strength
    scattered = (img[..., :3] - env).abs().amax(-1) > 1e-6
    frac = float(scattered.float().mean())
    inside = float(img[..., :3][scattered].mean()) if frac > 0 else 0.0
    print(f"{label}: scattered fraction {frac:.4f}, mean rgb inside "
          f"{inside:.4f}")
    if frac <= 0 or inside <= 0:
        raise AssertionError(f"{label}: no scattered pixels with radiance")


def check_launches(launches: dict, names, label: str) -> None:
    """Every kernel of ``names`` ran in the loop and no other did."""
    print(f"{label}: launches {launches}")
    for k, n in launches.items():
        if k in names and n <= 0:
            raise AssertionError(f"{label}: {k} was not launched by the "
                                 f"loop")
        if k not in names and n > 0:
            raise AssertionError(f"{label}: {k} ran {n} times in a loop "
                                 f"that does not take it")


def frame_phase(torch, dev, vol, cfg, gpu, frames: int, label: str,
                kernels) -> dict:
    """``frames`` frozen-cache frames: a finite image, the path's kernels
    (and no other) launched in the loop."""
    from nrc_hpm_tpu_torch.camera import Camera
    from nrc_hpm_tpu_torch.renderer import NrcRenderer

    r = NrcRenderer(cfg, vol)
    cam = Camera.reference_camera(aspect=r.width / r.height, device=dev)
    state, launches, times = run_frames(torch, r, r.init_state(seed=0), cam,
                                        frames, train=False)
    check_image(torch, r, state.image, label)
    check_launches(launches, kernels, label)
    ms = 1e3 * statistics.mean(times[1:])
    print(f"{label}: {ms:.1f} ms/frame (frozen, frames 2-{frames}), "
          f"{r.width * r.height / (ms / 1e3):.4g} rays/s, first frame "
          f"{1e3 * times[0]:.1f} ms, on {gpu}")
    return launches


def online_phase(torch, dev, vol, cfg, gpu, frames: int, label: str,
                 kernels):
    """``frames`` online-training frames: finite image and loss, 4 steps a
    frame, the ring moved, the path's kernels (and no other) launched in
    the loop."""
    from nrc_hpm_tpu_torch.camera import Camera
    from nrc_hpm_tpu_torch.renderer import NrcRenderer

    r = NrcRenderer(cfg, vol)
    cam = Camera.reference_camera(aspect=r.width / r.height, device=dev)
    torch.cuda.reset_peak_memory_stats()
    state, launches, times = run_frames(torch, r, r.init_state(seed=0), cam,
                                        frames, train=True)
    check_image(torch, r, state.image, label)
    check_launches(launches, kernels, label)
    loss = float(state.nrc.loss)
    if not torch.isfinite(state.nrc.loss):
        raise AssertionError(f"{label}: non-finite loss")
    if state.nrc.step != cfg.train_batch_count * frames:
        raise AssertionError(f"{label}: {state.nrc.step} optimizer steps")
    head, tail = int(state.ring.head), int(state.ring.tail)
    if head == 0 and tail == 0:
        raise AssertionError(f"{label}: the ring did not move")
    ms = 1e3 * statistics.mean(times[1:])
    print(f"{label}: {ms:.1f} ms/frame (online, frames 2-{frames}), "
          f"first frame {1e3 * times[0]:.1f} ms, loss {loss:.4g}, "
          f"{state.nrc.step} steps, ring head {head} tail {tail}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on {gpu}")
    return launches, r, state, cam, ms


def split_frame(torch, r, state, cam, gpu) -> None:
    """One more synchronized online frame, with trace_fixed and
    train_frame timed on the host clock around synchronized calls."""
    from nrc_hpm_tpu_torch import renderer

    spent = {"trace_fixed": 0.0, "train_frame": 0.0}

    def timed(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return run

    trace_fixed = renderer.trace_fixed
    renderer.trace_fixed = timed("trace_fixed", trace_fixed)
    r.cache.train_frame = timed("train_frame", r.cache.train_frame)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.step(state, cam)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        renderer.trace_fixed = trace_fixed
        del r.cache.train_frame
    rest = total - spent["trace_fixed"] - spent["train_frame"]
    print(f"split online frame: {1e3 * total:.1f} ms = trace_fixed "
          f"{1e3 * spent['trace_fixed']:.1f} ms + train_frame "
          f"{1e3 * spent['train_frame']:.1f} ms + the rest (primary, "
          f"inference, train rays, ring) {1e3 * rest:.1f} ms, on {gpu}")


def profile_step(torch, label: str, step, frame_ms: float, gpu) -> None:
    """torch.profiler over one call of ``step``: each kernel's launches
    (the wrappers' counts) and device ms, the device's busy share (its
    device time over the profiled call's host time, and over an
    unprofiled one's ``frame_ms``) and the largest device operations."""
    from torch.profiler import ProfilerActivity, profile

    zero_launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    launches = read_launches()
    ops = device_rows(torch, prof)
    busy = busy_ms(torch, prof)
    print(f"profiled {label}: {wall_ms:.1f} ms under the profiler, "
          f"{sum(c for _, _, c in ops)} device operations, "
          f"{sum(t for _, t, _ in ops):.3f} ms of device time, busy "
          f"{busy:.3f} ms: {busy / wall_ms:.4f} of the profiled frame, "
          f"{busy / frame_ms:.4f} of an unprofiled one ({frame_ms:.1f} ms), "
          f"on {gpu}")
    for name, kernel in KERNEL_NAMES.items():
        ms = sum(t for key, t, _ in ops if kernel in key)
        calls = sum(c for key, _, c in ops if kernel in key)
        print(f"profiled {label} {name}: {launches[name]} launches "
              f"({calls} in the trace), {ms:.4f} ms of device time, "
              f"{ms / max(busy, 1e-9):.4f} of the frame's")
    top = sorted(ops, key=lambda o: -o[1])[:8]
    print(f"profiled {label}, largest device operations: "
          + "; ".join(f"{k[:50]} {t:.3f} ms x{c}" for k, t, c in top))


def profile_frame(torch, r, state, cam, gpu, frame_ms: float) -> None:
    """``profile_step`` over one online frame; then K3 timed on the
    frame's own inference input, its scattered samples."""
    from nrc_hpm_tpu_torch.models.nrc.encoding import pack_table_bf16
    from nrc_hpm_tpu_torch.ops import fused_encode_mlp as fem

    seen = []
    infer = r.cache.infer

    def record(st, x5):
        seen.append((st, x5))
        return infer(st, x5)

    r.cache.infer = record
    try:
        profile_step(torch, "online frame", lambda: r.step(state, cam),
                     frame_ms, gpu)
    finally:
        del r.cache.infer
    if len(seen) != 1:
        raise AssertionError(f"{len(seen)} inference calls in the frame")
    st, x5 = seen[0]
    ema = st.ema_params
    spec = r.cache.encoding.grid_spec
    print(f"frame's inference input: {x5.shape[0]} scattered samples")
    k3_ms(torch, fem, (pack_table_bf16(ema["encoding"]["hash_table"]),
                       ema["mlp"]["layers"], x5.contiguous(), spec))


def small_frame_check(torch, dev, vol, cfg) -> None:
    """A 96x54 frame through the kernels against the same frame through
    the plain versions on the CPU (same frame seed and weights)."""
    from nrc_hpm_tpu_torch.camera import Camera
    from nrc_hpm_tpu_torch.renderer import NrcRenderer

    small = dataclasses.replace(cfg, render_width=96, render_height=54)
    fr = torch.tensor([0.11, 0.52, 0.73, 0.34])
    imgs = []
    nrc = None
    for d in (dev, torch.device("cpu")):
        r = NrcRenderer(small, vol.to(d))
        st = r.init_state(seed=3, nrc=None if nrc is None else
                          r.cache.state_from_params(nrc.ema_params, d))
        nrc = st.nrc
        cam = Camera.reference_camera(aspect=96 / 54, device=d)
        imgs.append(r.step(st, cam, train=False, frame_random=fr).image.cpu())
    err = (imgs[0] - imgs[1]).abs().amax(-1)
    close = float((err <= 1e-3).float().mean())
    print(f"small frame 96x54, kernels vs plain on the CPU: max_abs_err "
          f"{float(err.max()):.3e}, {close:.4f} of pixels within 1e-3 "
          f"(need >= 0.99)")
    if close < 0.99:
        raise AssertionError("kernel frame disagrees with the plain frame")


def check_trained(torch, label, got, want, rtol, atol, share) -> None:
    """Every parameter and EMA leaf of ``got`` against ``want``."""
    from nrc_hpm_tpu_torch.models.nrc.cache import tree_leaves

    bad = []
    for what in ("params", "ema_params"):
        shares, worst = [], 0.0
        for i, (g, w) in enumerate(zip(tree_leaves(getattr(got, what)),
                                       tree_leaves(getattr(want, what)))):
            e = (g.cpu() - w).abs()
            shares.append(float((e <= atol + rtol * w.abs()).float().mean()))
            worst = max(worst, float(e.max()))
            if shares[-1] < share:
                bad.append(f"{what} leaf {i}")
        print(f"{label} {what}: shares of entries within {atol:g} + "
              f"{rtol:g}|ref| by leaf {[round(v, 5) for v in shares]} "
              f"(need >= {share}), max_abs_err {worst:.3e}")
    if bad:
        raise AssertionError(f"{label}: {', '.join(bad)} disagree")


def small_online_check(torch, dev, vol, cfg, label="small online frame",
                       strict=True, seed=5,
                       frame_random=(0.61, 0.27, 0.93, 0.08)) -> None:
    """A 96x54 online frame (1,024 train rays, 4 steps of 256) through
    the kernels against the same frame through the plain versions on the
    CPU, from the same ``init_state(seed)`` and frame seed (the state's
    own key's where ``frame_random`` is None); then train_frame through
    the kernels on the CPU frame's own train inputs and state.  The two
    initial caches and the keys after the frame must be equal bit for
    bit.  The frame's loss is held to FRAME_LOSS_RTOL.  ``strict`` holds
    the frame's trained leaves to FRAME_TRAIN_TOL and the same-input step
    to TRAIN_TOL; else the same-input step to SAME_INPUT_TOL.  Without a
    hash grid the image is held to FRAME_IMAGE_RTOL."""
    from nrc_hpm_tpu_torch.camera import Camera
    from nrc_hpm_tpu_torch.models.nrc.cache import tree_leaves
    from nrc_hpm_tpu_torch.renderer import NrcRenderer

    small = dataclasses.replace(cfg, render_width=96, render_height=54,
                                log2_train_batch_size=8)
    fr = None if frame_random is None else torch.tensor(frame_random)
    out, inputs, renderers, starts = [], [], [], []
    for d in (dev, torch.device("cpu")):
        r = NrcRenderer(small, vol.to(d))
        train_frame = r.cache.train_frame

        def record(st, x5, target, train_frame=train_frame):
            inputs.append((st, x5, target))
            return train_frame(st, x5, target)

        r.cache.train_frame = record
        cam = Camera.reference_camera(aspect=96 / 54, device=d)
        st = r.init_state(seed=seed)
        starts.append([t.cpu() for t in tree_leaves(st.nrc.params)])
        out.append(r.step(st, cam, frame_random=fr))
        del r.cache.train_frame
        renderers.append(r)
    gpu, cpu = out
    if not (all(torch.equal(a, b) for a, b in zip(*starts))
            and torch.equal(gpu.key, cpu.key)):
        raise AssertionError(f"{label}: init_state({seed}) or the frame's "
                             f"key differs between the card and the CPU")
    grid = cfg.encoding.pos_id == 0
    diff = (gpu.image.cpu() - cpu.image).abs()
    err = diff.amax(-1)
    within = float((err <= 1e-3).float().mean())
    rtol = 0.0 if grid else FRAME_IMAGE_RTOL
    close = float((diff <= 1e-3 + rtol * cpu.image.abs()).all(-1)
                  .float().mean())
    ring = [(int(s.ring.head), int(s.ring.tail)) for s in out]
    lane_err = torch.maximum(
        (inputs[0][1].cpu() - inputs[1][1]).abs().amax(-1),
        (inputs[0][2].cpu() - inputs[1][2]).abs().amax(-1))
    lanes = float((lane_err <= 1e-3).float().mean())
    print(f"{label} 96x54, kernels vs plain on the CPU: image "
          f"max_abs_err {float(err.max()):.3e}, {within:.4f} of pixels "
          f"within 1e-3, {close:.4f} within 1e-3 + {rtol:g}|ref| (need >= "
          f"0.99); train inputs and targets: "
          f"{lanes:.4f} of {lane_err.numel()} lanes within 1e-3 (need >= "
          f"0.99); ring (head, tail) {ring}; steps "
          f"{gpu.nrc.step}/{cpu.nrc.step}")
    if close < 0.99 or lanes < 0.99:
        raise AssertionError(f"{label}: the kernel frame disagrees with the "
                             f"plain frame")
    if ring[0] != ring[1] or gpu.nrc.step != cpu.nrc.step:
        raise AssertionError("ring cursors or step counts differ")
    if strict:
        check_trained(torch, label, gpu.nrc, cpu.nrc, **FRAME_TRAIN_TOL)
    loss, loss_cpu = float(gpu.nrc.loss), float(cpu.nrc.loss)
    rel = abs(loss - loss_cpu) / abs(loss_cpu)
    print(f"{label}: loss {loss:.6g} vs {loss_cpu:.6g} on the CPU, "
          f"{rel:.3e} relative (allowed {FRAME_LOSS_RTOL:g})")
    if not rel <= FRAME_LOSS_RTOL:
        raise AssertionError(f"{label}: the frame's loss disagrees with the "
                             f"CPU frame's")
    st, x5, target = inputs[1]
    same = renderers[0].cache.train_frame(st.to(dev), x5.to(dev),
                                          target.to(dev))
    check_trained(torch, f"{label}: train_frame on the same inputs", same,
                  cpu.nrc, **(TRAIN_TOL if strict else SAME_INPUT_TOL))


def infer_routes_phase(torch, dev, cfg, gen) -> None:
    """cache.infer on the card at the MLP shapes and grid K3 does not take
    (INFER_ROUTES: each through K7's packed forward and K4, not K3) and at
    the default (K3 only), on N_INFER random inputs with a unit-scale
    table (tcnn's 1e-4 init hides the grid), against the same cache's
    plain run on the CPU within K4_TOL."""
    from nrc_hpm_tpu_torch.models.nrc.cache import NeuralRadianceCache

    x5 = torch.rand((N_INFER, 5), generator=gen)
    for width, depth, levels, kernels in INFER_ROUTES:
        c = NeuralRadianceCache(dataclasses.replace(
            cfg, nn_width=width, nn_depth=depth,
            encoding=dataclasses.replace(cfg.encoding, n_levels=levels)))
        st = c.init_state(seeded_key(torch, gen), dev)
        table = st.ema_params["encoding"]["hash_table"]
        st.ema_params["encoding"]["hash_table"] = (
            torch.rand(table.shape, generator=gen) * 2 - 1).to(dev)
        label = (f"cache.infer {N_INFER} samples, {c.width}x{c.depth}, "
                 f"{c.encoding.grid_spec.n_levels} levels")
        zero_launches()
        got = c.infer(st, x5.to(dev))
        torch.cuda.synchronize()
        check_launches(read_launches(), kernels, label)
        compare(torch, f"{label} vs the CPU", dict(out=got.cpu()),
                dict(out=c.infer(st.to("cpu"), x5)), **K4_TOL)


def encodings_phase(torch, dev, vol, cfg, gpu) -> dict:
    """Path A at the configuration's 1080p and 64x6 MLP: Frequency(12) +
    TriangleWave(4) frozen and online, hash grid + Identity frozen; then
    small online frames of four encodings and of ``env_fixed16`` against
    the CPU.  Returns the launches of the online frames."""
    from nrc_hpm_tpu_torch.config import EncodingConfig, SceneConfig

    size = f"{cfg.render_width}x{cfg.render_height}"

    def enc(pos, dir_):
        return dataclasses.replace(
            cfg, encoding=EncodingConfig(pos_id=pos, dir_id=dir_))

    frame_phase(torch, dev, vol, enc(3, 2), gpu, 2,
                f"frozen {size} pos 3 dir 2", FREQ_TRI_FROZEN)
    launches = online_phase(torch, dev, vol, enc(3, 2), gpu, 3,
                            f"online {size} pos 3 dir 2",
                            FREQ_TRI_FROZEN)[0]
    frame_phase(torch, dev, vol, enc(0, 1), gpu, 2,
                f"frozen {size} pos 0 dir 1", HASH_ID_FROZEN)
    for pos, dir_ in ((1, 1), (2, 0), (3, 2), (0, 1)):
        small_online_check(torch, dev, vol, enc(pos, dir_),
                           f"small online frame pos {pos} dir {dir_}",
                           strict=False)
    small_online_check(torch, dev, vol, dataclasses.replace(
        cfg, scene=SceneConfig.preset(4), env_fixed16=True),
        "small online frame preset 4 env_fixed16", strict=False)
    return launches


def coarse_phase(torch, dev, vol, cfg, gpu) -> dict:
    """Path B on the 65,536 train rays of the second online 1080p frame:
    ``trace_fixed`` with 32 bounces at ``coarse=64`` (K5; K1/K2 must not
    run), timed beside the ``coarse=32`` kernel path on the same rays; the
    volume's float32 macrocell lookups at the rays' 65 profile points (K6)
    against the CPU; ``trace_fixed`` at ``coarse=16`` and ``64`` on 4,096
    of the rays against the plain runs on the CPU.  Returns both paths'
    launches."""
    from nrc_hpm_tpu_torch import renderer, volume
    from nrc_hpm_tpu_torch.camera import Camera
    from nrc_hpm_tpu_torch.integrator import trace_fixed
    from nrc_hpm_tpu_torch.lights import lights_from_scene
    from nrc_hpm_tpu_torch.renderer import NrcRenderer

    r = NrcRenderer(cfg, vol)
    cam = Camera.reference_camera(aspect=r.width / r.height, device=dev)
    rays = []

    def record(state, vol_, lights, p, ro, rd, n):
        rays.append((state, ro, rd))
        return traced(state, vol_, lights, p, ro, rd, n)

    traced, renderer.trace_fixed = renderer.trace_fixed, record
    try:
        st = r.step(r.init_state(seed=0), cam)
        r.step(st, cam)
    finally:
        renderer.trace_fixed = traced
    state, ro, rd = rays[-1]
    n, bounces = ro.shape[0], cfg.train_ray_length
    if n != N_PROFILE:
        raise AssertionError(f"{n} train rays, expected {N_PROFILE}")

    def run(coarse: int):
        p = dataclasses.replace(r.params, coarse=coarse)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trace_fixed(state, vol, r.lights, p, ro, rd, bounces)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    label = f"trace_fixed {n} lanes x {bounces} bounces coarse={COARSE}"
    zero_launches()
    res, first_ms = run(COARSE)
    launches = read_launches()
    check_launches(launches, ("table_gather",), label)
    ms = run(COARSE)[1]
    ref, ms32 = run(32)
    ms32 = run(32)[1]
    rad, rad32 = res["radiance"].sum(-1), ref["radiance"].sum(-1)
    for key, v in res.items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label}: non-finite {key}")
    alive = float(res["alive"].float().mean())
    # both are unbiased estimates of the same paths' radiance
    mean, mean32 = float(rad.mean()), float(rad32.mean())
    se = float(torch.sqrt((rad.var() + rad32.var()) / n))
    print(f"{label}: {ms:.1f} ms (first call {first_ms:.1f} ms), coarse=32 "
          f"kernel path {ms32:.1f} ms, on {gpu}; alive {alive:.4f}, mean "
          f"radiance {mean:.5g} vs {mean32:.5g} at coarse=32 (standard "
          f"error of the difference {se:.3g}, allowed 5)")
    if bool((rad < 0).any()) or not float(rad.max()) > 0.0:
        raise AssertionError(f"{label}: negative or no radiance")
    if abs(mean - mean32) > 5 * se:
        raise AssertionError(f"{label}: mean radiance disagrees with the "
                             f"coarse=32 kernel path")

    # K6: the majorant and control at each ray's 65 profile points
    _, exit_pt, _ = volume.find_entry_exit(vol, ro, rd)
    tmax = torch.linalg.vector_norm(exit_pt - ro, dim=-1)
    ts = torch.arange(COARSE + 1, dtype=torch.float32, device=dev)[:, None] \
        * (tmax / COARSE)[None, :]
    pts = ro[None] + ts[..., None] * rd[None]

    def lookups(v, p):
        xyz = p.unbind(-1)
        return dict(sigma=volume.macro_sigma(v, p),
                    control=volume.macro_control(v, p),
                    sigma_xyz=volume.macro_sigma_xyz(v, *xyz),
                    control_xyz=volume.macro_control_xyz(v, *xyz))

    zero_launches()
    got = lookups(vol, pts)
    lookup_launches = read_launches()
    label = f"macro lookups ({COARSE + 1}, {n}) points"
    check_launches(lookup_launches, ("small_table_lookup",), label)
    want = lookups(vol.to("cpu"), pts.cpu())
    compare(torch, f"{label} vs the CPU, bits",
            {k: v.cpu().view(torch.int32) for k, v in got.items()},
            {k: v.view(torch.int32) for k, v in want.items()}, **BITWISE)
    if bool((got["sigma"] < got["control"]).any()):
        raise AssertionError(f"{label}: the control exceeds the majorant")

    # coarse=16 and 64 on 4,096 spread lanes: kernels against the plain
    # CPU run
    pick = torch.arange(0, n, n // N_COARSE_CPU, device=dev)
    cpu = torch.device("cpu")
    for coarse in (16, COARSE):
        p = dataclasses.replace(r.params, coarse=coarse)
        outs = [trace_fixed(state[pick].to(d), v, lights, p, ro[pick].to(d),
                            rd[pick].to(d), bounces)
                for d, v, lights in ((dev, vol, r.lights),
                                     (cpu, vol.to(cpu), lights_from_scene(
                                         cfg.scene, device=cpu)))]
        g, c = ({k: v.cpu() for k, v in o.items()} for o in outs)
        err = torch.stack([(g[k] - c[k]).abs().reshape(len(pick), -1)
                           .amax(-1) for k in ("radiance", "throughput",
                                               "terminal_pos")]).amax(0)
        shares = dict(state=(g["state"] == c["state"]).float().mean(),
                      alive=(g["alive"] == c["alive"]).float().mean(),
                      within_1e_3=(err <= 1e-3).float().mean())
        shares = {k: float(v) for k, v in shares.items()}
        print(f"trace_fixed {len(pick)} lanes coarse={coarse}, kernels vs "
              f"plain on the CPU: shares of equal lanes {shares} (need >= "
              f"{COARSE_LANE_SHARE}), max_abs_err {float(err.max()):.3e}")
        if min(shares.values()) < COARSE_LANE_SHARE:
            raise AssertionError(f"coarse={coarse} trace_fixed disagrees "
                                 f"with the plain CPU run")
    return dict(table_gather=launches["table_gather"],
                small_table_lookup=lookup_launches["small_table_lookup"])


# The MC path (McRenderer): K1/K2 and no other kernel, on every pixel
MC_KERNELS = TRACK
MC_FRAMES = 3                  # 1080p MC frames, 32 bounces
SMALL_MC = (48, 27)            # the small MC frames of each tracking mode
GOLDEN_SIZE = (192, 108)       # the repository's low.exr goldens' size
GOLDEN_PATH = 64               # the reference's golden path length
GOLDEN_FRAMES = 64
MC_GATE_FRAMES = 12            # the JAX package's statistical MC test ...
MC_GATE_REL_BIAS = 0.06        # ... and its gate
GOLDEN_DIR = os.path.join(ROOT, "nrc_hpm_tpu_torch", "_build", "golden")


def check_mc_image(torch, img, shape, env: float, label: str) -> float:
    """A finite, non-negative MC image of ``shape`` whose corner pixel
    misses the box (the constant env radiance ``env``, no scatter);
    returns the scatter share (the did-scatter channel's mean), which must
    lie in (0.05, 0.95)."""
    if tuple(img.shape) != shape:
        raise AssertionError(f"{label}: image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()) or bool((img[..., :3] < 0).any()):
        raise AssertionError(f"{label}: non-finite or negative pixels")
    corner = img[0, 0].tolist()
    if any(abs(c - env) > 1e-5 for c in corner[:3]) or corner[3] != 0.0:
        raise AssertionError(f"{label}: corner pixel {corner} is not the "
                             f"env {env} without scatter")
    share = float(img[..., 3].mean())
    if not 0.05 < share < 0.95:
        raise AssertionError(f"{label}: scatter share {share:.4f}")
    return share


def mc_phase(torch, dev, vol, cfg, gpu) -> None:
    """``MC_FRAMES`` MC frames of ``McRenderer(cfg)`` at the configuration's
    size and ``mc_path_length`` on every pixel (K1/K2 and no other kernel
    launched in the loop), one more under torch.profiler (each kernel's
    launches and device ms, the busy share), and K1/K2 against their plain
    versions on the inputs of one more frame."""
    from nrc_hpm_tpu_torch.camera import Camera
    from nrc_hpm_tpu_torch.renderer import McRenderer

    r = McRenderer(cfg, vol)
    cam = Camera.reference_camera(aspect=r.width / r.height, device=dev)
    label = (f"MC {r.width}x{r.height} {r.path_length} bounces, "
             f"{r.width * r.height} lanes")
    state = r.init_state(seed=0)
    zero_launches()
    times = []
    for _ in range(MC_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = r.step(state, cam)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    check_launches(read_launches(), MC_KERNELS, label)
    share = check_mc_image(torch, state.image, (r.height, r.width, 4),
                           r.lights.env.strength, label)
    ms = 1e3 * statistics.mean(times[1:])
    print(f"{label}: {ms:.1f} ms/frame (frames 2-{MC_FRAMES}), first frame "
          f"{1e3 * times[0]:.1f} ms, scatter share {share:.4f}, on {gpu}")

    profile_step(torch, f"{label} frame", lambda: r.step(state, cam), ms,
                 gpu)
    mc_kernel_inputs_check(torch, r, state, cam)


def mc_kernel_inputs_check(torch, r, state, cam) -> None:
    """K1/K2 on the inputs a 1080p MC frame hands them: one more frame
    records (a copy of) the first call of each instance, K2 with and
    without the control draw and K1 with the delta and the ratio salt,
    then each kernel runs against its plain version on those inputs under
    PW_TOL."""
    from nrc_hpm_tpu_torch import transmittance as tr
    from nrc_hpm_tpu_torch.ops import pw_kernels as pk

    seen = {}

    def recorder(name, fn, instance):
        def call(*args, **kwargs):
            seen.setdefault((name, instance(kwargs)), (
                tuple(a.clone() if torch.is_tensor(a) else a for a in args),
                kwargs))
            return fn(*args, **kwargs)
        return call

    tr.pw_profile = recorder("pw_profile", pk.pw_profile,
                             lambda kw: kw.get("want_ctrl", False))
    tr.pw_events = recorder("pw_events", pk.pw_events, lambda kw: kw["salt"])
    try:
        r.step(state, cam)
    finally:
        tr.pw_profile, tr.pw_events = pk.pw_profile, pk.pw_events
    for name, instance, label in (
            ("pw_profile", True, "delta track's pw_profile want_ctrl=True"),
            ("pw_profile", False, "ratio track's pw_profile"),
            ("pw_events", pk.SALT_DELTA, "delta track's pw_events"),
            ("pw_events", pk.SALT_RATIO, "ratio track's pw_events")):
        if (name, instance) not in seen:
            raise AssertionError(f"the MC frame made no {label} call")
        args, kwargs = seen[(name, instance)]
        compare(torch, f"MC frame's first {label}, {args[1].shape[0]} lanes "
                f"{kwargs}", getattr(pk, name)(*args, **kwargs),
                getattr(pk, name + "_plain")(*args, **kwargs), **PW_TOL)


def small_mc_check(torch, dev) -> None:
    """48x27 MC frames on the 8^3 test volume of the CPU tests, each
    tracking mode, two frames from ``init_state(3)`` through the kernels
    on the card against the plain run on the CPU: the did-scatter channel
    equal on >= 99% of the pixels, the image within 1e-3 there, the keys
    equal."""
    import numpy as np

    from nrc_hpm_tpu_torch.camera import Camera
    from nrc_hpm_tpu_torch.config import AppConfig
    from nrc_hpm_tpu_torch.renderer import McRenderer
    from nrc_hpm_tpu_torch.volume import Volume

    w, h = SMALL_MC
    cfg = AppConfig(render_width=w, render_height=h)
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    for mode in ("pw", "fast", "seq"):
        outs = []
        for d in (dev, torch.device("cpu")):
            r = McRenderer(cfg, Volume.from_dense(data, 0.6, 0.8, device=d))
            r.params = dataclasses.replace(r.params, mode=mode)
            cam = Camera.reference_camera(aspect=w / h, device=d)
            st = r.multi_step(r.init_state(3), cam, 2)
            outs.append((st.image.cpu(), st.key))
        (got, key), (want, key_cpu) = outs
        agree = got[..., 3] == want[..., 3]
        err = (got - want).abs().amax(-1)
        share, worst = float(agree.float().mean()), float(err[agree].max())
        print(f"small MC {w}x{h} mode={mode}, kernels vs plain on the CPU: "
              f"did-scatter agrees on {share:.4f} (need >= 0.99), "
              f"max_abs_err there {worst:.3e} (need <= 1e-3)")
        if share < 0.99 or worst > 1e-3 or not torch.equal(key, key_cpu):
            raise AssertionError(f"mode={mode}: the card's MC frame "
                                 f"disagrees with the CPU's")


def quality_phase(torch, dev, vol, gpu, nrc_renderer, nrc_state) -> None:
    """The port's own golden: ``generate_golden`` on the procedural cloud
    at ``GOLDEN_SIZE`` with ``GOLDEN_PATH`` bounces (written under the
    git-ignored build directory), a run of half the frames resumed to all
    of them (bitwise the single run), then scored: an
    ``MC_GATE_FRAMES``-frame MC render with another seed (|relBias| <
    ``MC_GATE_REL_BIAS``, the gate) and the online NRC renderer's trained
    cache through ``compare_nrc`` at the golden's size (recorded, not
    gated)."""
    import shutil

    from nrc_hpm_tpu_torch.config import AppConfig
    from nrc_hpm_tpu_torch.reference import GoldenReference, generate_golden
    from nrc_hpm_tpu_torch.renderer import McRenderer, NrcRenderer

    w, h = GOLDEN_SIZE
    cfg = AppConfig()
    shutil.rmtree(GOLDEN_DIR, ignore_errors=True)
    path = os.path.join(GOLDEN_DIR, str(cfg.scene.id), "0.exr")
    zero_launches()
    t0 = time.perf_counter()
    img = generate_golden(cfg, path, vol, frames=GOLDEN_FRAMES,
                          path_length=GOLDEN_PATH, width=w, height=h)
    secs = time.perf_counter() - t0
    check_launches(read_launches(), MC_KERNELS, "golden")
    share = check_mc_image(torch, torch.from_numpy(img), (h, w, 4),
                           cfg.scene.hdr_env_map_strength, "golden")
    print(f"golden {w}x{h}: {GOLDEN_FRAMES} frames of {GOLDEN_PATH}-bounce "
          f"MC in {secs:.1f} s ({1e3 * secs / GOLDEN_FRAMES:.1f} ms/frame), "
          f"scatter share {share:.4f}, written to "
          f"{os.path.relpath(path, ROOT)}, on {gpu}")

    part = os.path.join(GOLDEN_DIR, "resumed", "0.exr")
    generate_golden(cfg, part, vol, frames=GOLDEN_FRAMES // 2,
                    path_length=GOLDEN_PATH, width=w, height=h)
    resumed = generate_golden(cfg, part, vol, frames=GOLDEN_FRAMES,
                              path_length=GOLDEN_PATH, width=w, height=h,
                              resume=True)
    with open(path + ".progress.json") as f, \
            open(part + ".progress.json") as g:
        same_meta = f.read() == g.read()
    same = same_meta and resumed.tobytes() == img.tobytes()
    print(f"golden resumed at {GOLDEN_FRAMES // 2} of {GOLDEN_FRAMES} "
          f"frames: bitwise the single run {same}")
    if not same:
        raise AssertionError("the resumed golden differs from the single run")

    golden = GoldenReference.load(cfg.scene.id, search_paths=(GOLDEN_DIR,),
                                  device=dev)
    mc = McRenderer(cfg, vol, width=w, height=h)
    t0 = time.perf_counter()
    res = golden.compare(mc.render(golden.camera, MC_GATE_FRAMES, seed=1))
    secs = time.perf_counter() - t0
    print(f"MC {w}x{h} {mc.path_length} bounces, {MC_GATE_FRAMES} frames "
          f"(seed 1, {secs:.1f} s) vs the golden: MSE {res.mse:.6g} relBias "
          f"{res.rel_bias:.6g} CV {res.cv:.6g} ({res.valid_pixel_count:.0f} "
          f"pixels; gate |relBias| < {MC_GATE_REL_BIAS}), on {gpu}")
    if not abs(res.rel_bias) < MC_GATE_REL_BIAS:
        raise AssertionError(f"MC relBias {res.rel_bias} vs the golden")

    small = NrcRenderer(nrc_renderer.cfg, vol, width=w, height=h)
    res = golden.compare_nrc(small, small.init_state(0, nrc=nrc_state.nrc))
    print(f"NRC frame {w}x{h}, cache after "
          f"{nrc_state.nrc.step // small.cfg.train_batch_count} online "
          f"frames, vs the golden: MSE {res.mse:.6g} relBias "
          f"{res.rel_bias:.6g} CV {res.cv:.6g} (recorded, not gated), on "
          f"{gpu}")
    if not all(map(math.isfinite, (res.mse, res.rel_bias, res.cv))):
        raise AssertionError(f"NRC frame {w}x{h}: non-finite scores")


APP_DIR = os.path.join(ROOT, "nrc_hpm_tpu_torch", "_build", "app_run")
APP_FRAMES = 4                 # the app's --renderer both run ...
APP_RELOAD_FRAMES = 2          # ... and the frozen run from its checkpoint
# the keys of the JAX package's profile_nrc_frame
STAGE_KEYS = ("clear", "gen_rays", "prep_infer", "filter", "nn_infer",
              "prep_train", "nn_train", "nn", "render", "stage_sum",
              "total", "theoretical_fps")


def app_phase(torch, gpu, extra=()) -> None:
    """The port's app as a user starts it, on the procedural cloud written
    as the WDAS file is (VDB version 223, zip with the active mask) at the
    scene's relative volume_path under the git-ignored ``APP_DIR``, with
    the quality phase's golden at ``reference/4/0.exr`` there: one
    ``app.main`` at ``AppConfig()`` and 1920x1080, NRC online and MC, the
    golden compared every other frame, the stage profile, the EXRs and
    the checkpoint; then a frozen NRC run from that checkpoint, which
    saves the state it loaded.  Checks the VDB read back bitwise, rc 0,
    every frame's finite loss, finite EXRs, every stage key, the reloaded
    state bitwise the saved one, and that the first run launched the
    online frame's kernels and no other.  ``extra`` goes before each
    run's arguments (a rehearsal on the CPU passes ``--platform cpu``, a
    small size and the reference's positional arguments)."""
    import shutil

    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_vdb_writer as vw
    from nrc_hpm_tpu_torch import app
    from nrc_hpm_tpu_torch.profiler import format_stage_report
    from nrc_hpm_tpu_torch.utils.exr import read_exr_rgba
    from nrc_hpm_tpu_torch.utils.procedural import cloud_density
    from nrc_hpm_tpu_torch.utils.vdb import load_vdb

    t_phase = time.perf_counter()
    extra = list(extra)
    cfg = app._config(app.build_argparser().parse_args(extra))
    shutil.rmtree(APP_DIR, ignore_errors=True)
    vdb = os.path.join(APP_DIR, cfg.scene.volume_path)
    os.makedirs(os.path.dirname(vdb))
    data = cloud_density(seed=0)
    t0 = time.perf_counter()
    vw.write_vdb(vdb, [vw.Grid(data)], version=223,
                 compression=vw.COMPRESS_ZIP | vw.COMPRESS_ACTIVE_MASK)
    back = load_vdb(vdb).data
    secs = time.perf_counter() - t0
    if back.shape != data.shape or back.tobytes() != data.tobytes():
        raise AssertionError("the written VDB does not read back bitwise")
    print(f"app scene: the procedural cloud {data.shape} (the WDAS cloud "
          f"is absent), written to {cfg.scene.volume_path} as VDB v223 zip "
          f"+ active mask ({os.path.getsize(vdb)} bytes), read back "
          f"bitwise; {secs:.1f} s")
    golden = os.path.join(APP_DIR, "reference", str(cfg.scene.id), "0.exr")
    os.makedirs(os.path.dirname(golden))
    shutil.copy(os.path.join(GOLDEN_DIR, str(cfg.scene.id), "0.exr"),
                golden)

    ck, ck2 = "cache.npz", "reloaded.npz"
    cwd = os.getcwd()
    os.chdir(APP_DIR)
    try:
        zero_launches()
        t0 = time.perf_counter()
        rc = app.main(extra + [
            "--renderer", "both", "--frames", str(APP_FRAMES),
            "--benchmark-every", "2", "--profile", "--export-exr",
            "--checkpoint", ck, "--out", "run"])
        secs = time.perf_counter() - t0
        launches = read_launches()
        zero_launches()
        rc2 = app.main(extra + [
            "--load-checkpoint", ck, "--no-train", "--renderer", "nrc",
            "--frames", str(APP_RELOAD_FRAMES), "--checkpoint", ck2,
            "--out", "reload"])
        reload_launches = read_launches()
    finally:
        os.chdir(cwd)
    label = f"app {cfg.render_width}x{cfg.render_height} --renderer both"
    if rc != 0 or rc2 != 0:
        raise AssertionError(f"app.main returned {rc}, then {rc2}")
    check_launches(launches, ONLINE_KERNELS, label)
    check_launches(reload_launches, FROZEN_KERNELS, "app frozen reload")

    def records(run):
        with open(os.path.join(APP_DIR, run, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    recs = records("run")
    frames = [r for r in recs if "frame" in r]
    reload = [r for r in records("reload") if "frame" in r]
    (stages,) = [{k: v for k, v in r.items() if k not in ("event", "t")}
                 for r in recs if r.get("event") == "stage_profile"]
    if (len(frames) != APP_FRAMES or len(reload) != APP_RELOAD_FRAMES
            or not all(math.isfinite(r["loss"]) for r in frames + reload)):
        raise AssertionError(f"{label}: frame records {frames} {reload}")
    if sorted(stages) != sorted(STAGE_KEYS):
        raise AssertionError(f"{label}: stage keys {sorted(stages)}")
    if [r["loss"] for r in reload] != [frames[-1]["loss"]] * len(reload):
        raise AssertionError("the reloaded frozen frames lost the loss")
    for name in ("nrc.exr", "mc.exr"):
        img = read_exr_rgba(os.path.join(APP_DIR, "run", name))
        if img.shape != (cfg.render_height, cfg.render_width, 4) or \
                not np.isfinite(img).all():
            raise AssertionError(f"{label}: {name} {img.shape} not finite")
    with np.load(os.path.join(APP_DIR, ck)) as a, \
            np.load(os.path.join(APP_DIR, ck2)) as b:
        same = sorted(a.files) == sorted(b.files) and all(
            a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
            for k in a.files)
        n_leaves = len(a.files) - 1
    if not same:
        raise AssertionError("the state the reload saved differs from the "
                             "checkpoint it loaded")
    times = [r["frame_time_ms"] for r in frames]
    frozen = [r["frame_time_ms"] for r in reload]
    scores = [(r["frame"], r["nrc"]["rel_bias"], r["mc"]["rel_bias"])
              for r in frames if "nrc" in r]
    print(format_stage_report(stages))
    print(f"{label}: {APP_FRAMES} frames (online NRC + {cfg.mc_path_length}"
          f"-bounce MC) of {times} ms, mean of frames 2-{APP_FRAMES} "
          f"{statistics.mean(times[1:]):.1f} ms; frozen reload {frozen} ms; "
          f"relBias vs the golden (frame, NRC, MC) {scores}; checkpoint of "
          f"{n_leaves} leaves reloaded bitwise; the first run "
          f"{secs:.1f} s, the phase {time.perf_counter() - t_phase:.1f} s; "
          f"on {gpu}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nrc_hpm_tpu_torch.config import AppConfig
    from nrc_hpm_tpu_torch.utils.procedural import cloud_density
    from nrc_hpm_tpu_torch.volume import Volume

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    print(gpu)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    build()
    cfg = AppConfig()
    t0 = time.perf_counter()
    vol = Volume.from_dense(cloud_density(seed=0), cfg.scene.density,
                            cfg.scene.volume_g, device=dev)
    print(f"procedural cloud {vol.dims}, macro {vol.macro_dims}: "
          f"{time.perf_counter() - t0:.1f} s")
    rows = kernel_phase(torch, dev, vol, cfg)
    infer_routes_phase(torch, dev, cfg, torch.Generator().manual_seed(4))
    size = f"{cfg.render_width}x{cfg.render_height}"
    frame_phase(torch, dev, vol, cfg, gpu, 3, f"frozen {size}",
                FROZEN_KERNELS)
    launches, r, state, cam, frame_ms = online_phase(
        torch, dev, vol, cfg, gpu, 5,
        f"online {size} 2^{cfg.encoding.log2_hashmap_size}", ONLINE_KERNELS)
    split_frame(torch, r, state, cam, gpu)
    profile_frame(torch, r, state, cam, gpu, frame_ms)
    tuned = AppConfig.tpu_tuned()
    online_phase(torch, dev, vol, tuned, gpu, 2,
                 f"online tpu_tuned 2^{tuned.encoding.log2_hashmap_size}",
                 ONLINE_KERNELS)
    small_frame_check(torch, dev, vol, cfg)
    small_online_check(torch, dev, vol, cfg)
    # the key chain: the caches and keys bitwise; the frame's own seed
    # picks other lanes than the fixed one, so the frame is held as the
    # other configurations' are (its loss, its inputs, SAME_INPUT_TOL)
    small_online_check(torch, dev, vol, cfg, "small online frame from "
                       "init_state(0), its own frame seed", strict=False,
                       seed=0, frame_random=None)
    launches["fused_mlp"] = encodings_phase(torch, dev, vol, cfg,
                                            gpu)["fused_mlp"]
    launches.update(coarse_phase(torch, dev, vol, cfg, gpu))
    mc_phase(torch, dev, vol, cfg, gpu)
    small_mc_check(torch, dev)
    quality_phase(torch, dev, vol, gpu, r, state)
    del r, state
    app_phase(torch, gpu)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
