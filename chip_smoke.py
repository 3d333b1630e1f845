#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``nrc_hpm_tpu_torch``) once on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the three CUDA kernels from ``nrc_hpm_tpu_torch/csrc``, checks
each against its plain PyTorch version at the main path's shapes, renders
three frozen-cache NRC frames at 1920x1080 with the default 2^19 hash grid
and 64x6 MLP (seeded random weights) on a procedural cloud, checks that
every kernel ran in that frame loop, and checks a small frame against the
same frame rendered through the plain versions on the CPU.  It prints the
card's name and power limit, one line per kernel, the frame time, a JSON
kernel summary, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises.  Without a CUDA device it exits with code 1.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_LANES = 1 << 20            # K1/K2 lanes: camera rays through the cloud
N_X5 = 1 << 20               # K3 samples
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


def compare(torch, name, got: dict, want: dict, rtol, atol, max_bad,
            hard=None) -> float:
    """Max abs error over all outputs; raises if more than ``max_bad`` of
    the elements miss rtol/atol (integer outputs must be equal), or any
    misses ``hard``."""
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
            miss = err > atol + rtol * w.abs()
            if hard is not None and bool((err > hard + hard * w.abs()).any()):
                raise AssertionError(f"{name}.{key}: error above {hard}")
        bad += int(miss.sum())
        total += miss.numel()
    print(f"{name}: max_abs_err={worst:.3e} mismatched={bad}/{total} "
          f"(allowed {max_bad:g} at rtol={rtol:g} atol={atol:g})")
    if bad > max_bad * total:
        raise AssertionError(f"{name}: {bad} of {total} elements mismatch")
    return worst


def build() -> None:
    """Build both libraries (timed) and print ptxas's register/spill lines."""
    from nrc_hpm_tpu_torch.ops import _build, fused_encode_mlp, pw_kernels

    t0 = time.perf_counter()
    sos = [_build.library_path(pw_kernels._LIB, ("-fmad=false",)),
           _build.library_path(fused_encode_mlp._LIB)]
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for so in sos:
        log = so.with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if re.search(r"registers|spill", line):
                print(f"ptxas {so.name}: {line.strip()}")


def kernel_phase(torch, dev, vol, cfg) -> list:
    from nrc_hpm_tpu_torch.camera import Camera, pixel_rays
    from nrc_hpm_tpu_torch.models.nrc.cache import NeuralRadianceCache
    from nrc_hpm_tpu_torch.models.nrc.encoding import pack_table_bf16
    from nrc_hpm_tpu_torch.ops import fused_encode_mlp as fem
    from nrc_hpm_tpu_torch.ops import pw_kernels as pk
    from nrc_hpm_tpu_torch.volume import find_entry_exit

    gen = torch.Generator().manual_seed(1)
    cam = Camera.reference_camera(device=dev)
    ro, rd, _ = pixel_rays(cam, cfg.render_width, cfg.render_height)
    rd = rd.reshape(-1, 3)
    pick = torch.randperm(rd.shape[0], generator=gen)[:N_LANES].to(dev)
    rd = rd[pick].contiguous()
    entry, exit_, hit = find_entry_exit(vol, ro.expand_as(rd), rd)
    start = entry.contiguous()
    tmax = torch.where(hit, torch.linalg.vector_norm(exit_ - entry, dim=-1),
                       0.0)
    seed = torch.randint(-2**31, 2**31 - 1, (N_LANES,), generator=gen,
                         dtype=torch.int32).to(dev)
    e_last = torch.zeros(N_LANES, device=dev)
    print(f"K1/K2 lanes: {N_LANES} camera rays, {int(hit.sum())} hit the box")
    rows = []

    def row(name, route_src, replaces, err, ms, plain_ms):
        print(f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        rows.append(dict(name=name, route="cuda", source=route_src,
                         replaces=replaces, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms))

    src_pw = "nrc_hpm_tpu_torch/csrc/pw_kernels.cu"
    args = (vol, start, rd, tmax, seed)
    err = compare(torch, "pw_profile",
                  pk.pw_profile(*args, want_ctrl=True),
                  pk.pw_profile_plain(*args, want_ctrl=True), **PW_TOL)
    row("pw_profile", src_pw, "nrc_hpm_tpu/ops/pw_kernels.py:231", err,
        time_ms(torch, lambda: pk.pw_profile(*args, want_ctrl=True)),
        time_ms(torch, lambda: pk.pw_profile_plain(*args, want_ctrl=True)))
    err = 0.0
    for salt in (pk.SALT_RATIO, pk.SALT_DELTA):
        err = max(err, compare(
            torch, f"pw_events salt={salt:#x}",
            pk.pw_events(*args, e_last, 0, S=16, salt=salt),
            pk.pw_events_plain(*args, e_last, 0, S=16, salt=salt), **PW_TOL))
    row("pw_events", src_pw, "nrc_hpm_tpu/ops/pw_kernels.py:78", err,
        time_ms(torch, lambda: pk.pw_events(*args, e_last, 0, S=16)),
        time_ms(torch, lambda: pk.pw_events_plain(*args, e_last, 0, S=16)))

    cache = NeuralRadianceCache(cfg)
    spec = cache.encoding.grid_spec
    nrc = cache.init_state(gen, dev)
    # a table of unit scale exercises the gathers more than tcnn's 1e-4 init
    table = (torch.rand((spec.total_params, 2), generator=gen) * 2 - 1)
    packed = pack_table_bf16(table).to(dev)
    layers = nrc.ema_params["mlp"]["layers"]
    x5 = torch.rand((N_X5, 5), generator=gen).to(dev)
    x5[:, 3] = x5[:, 3] * 2.0 - 0.5     # theta spans [-0.5, 1.5]
    fargs = (packed, layers, x5, spec)
    err = compare(torch, "fused_encode_mlp",
                  dict(out=fem.fused_encode_mlp_infer(*fargs)),
                  dict(out=fem.fused_encode_mlp_plain(*fargs)), **K3_TOL)
    row("fused_encode_mlp", "nrc_hpm_tpu_torch/csrc/fused_encode_mlp.cu",
        "nrc_hpm_tpu/ops/fused_encode_mlp.py:66", err,
        time_ms(torch, lambda: fem.fused_encode_mlp_infer(*fargs)),
        time_ms(torch, lambda: fem.fused_encode_mlp_plain(*fargs)))
    return rows


def frame_phase(torch, dev, vol, cfg, gpu) -> dict:
    from nrc_hpm_tpu_torch.camera import Camera
    from nrc_hpm_tpu_torch.ops import fused_encode_mlp as fem
    from nrc_hpm_tpu_torch.ops import pw_kernels as pk
    from nrc_hpm_tpu_torch.renderer import NrcRenderer

    r = NrcRenderer(cfg, vol)
    state = r.init_state(seed=0)
    cam = Camera.reference_camera(aspect=r.width / r.height, device=dev)
    wrappers = dict(pw_events=pk.pw_events, pw_profile=pk.pw_profile,
                    fused_encode_mlp=fem.fused_encode_mlp_infer)
    for w in wrappers.values():
        w.launches = 0
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = r.step(state, cam, train=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: w.launches for k, w in wrappers.items()}
    img = state.image
    if tuple(img.shape) != (r.height, r.width, 4):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("non-finite pixels")
    env = r.lights.env.strength
    scattered = (img[..., :3] - env).abs().amax(-1) > 1e-6
    frac = float(scattered.float().mean())
    inside = float(img[..., :3][scattered].mean()) if frac > 0 else 0.0
    print(f"frame: 3 frozen frames {r.width}x{r.height}, launches "
          f"{launches}, scattered fraction {frac:.4f}, mean rgb inside "
          f"{inside:.4f}")
    if frac <= 0 or inside <= 0:
        raise AssertionError("no scattered pixels with radiance")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} was not launched by the frame loop")
    ms = 1e3 * statistics.mean(times[1:])
    print(f"frame: {ms:.1f} ms/frame (frames 2-3), "
          f"{r.width * r.height / (ms / 1e3):.4g} rays/s, first frame "
          f"{1e3 * times[0]:.1f} ms, on {gpu}")
    return launches


def small_frame_check(torch, dev, vol, cfg) -> None:
    """A 96x54 frame through the kernels against the same frame through
    the plain versions on the CPU (same frame seed and weights)."""
    import dataclasses

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
        imgs.append(r.step(st, cam, frame_random=fr).image.cpu())
    err = (imgs[0] - imgs[1]).abs().amax(-1)
    close = float((err <= 1e-3).float().mean())
    print(f"small frame 96x54, kernels vs plain on the CPU: max_abs_err "
          f"{float(err.max()):.3e}, {close:.4f} of pixels within 1e-3 "
          f"(need >= 0.99)")
    if close < 0.99:
        raise AssertionError("kernel frame disagrees with the plain frame")


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
    launches = frame_phase(torch, dev, vol, cfg, gpu)
    small_frame_check(torch, dev, vol, cfg)
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
