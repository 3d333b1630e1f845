#!/usr/bin/env python3
"""Image-quality studies of the PyTorch + CUDA port, on one CUDA GPU.

Run from the repository root:

    python3 quality_torch.py {convergence,interactive,restir,gates,scenes,all}
        [--seed N] [--frames N] [--golden-frames N]

Five studies back the system's claims about image quality, each scored
against a golden that ``golden()`` renders once with
``reference.generate_golden`` and caches under
``nrc_hpm_tpu_torch/_build/golden_cache/<key>/``, the key a hash of all
that decides the image (the scene preset's fields, the camera, the size,
the seed, the path length, the frame count and the bytes of the volume's
density grid and macro tables):

- ``convergence``: ``app.main --renderer both --benchmark-every 1`` at
  scene 4 and 1920x1080 for 24 frames, once at ``AppConfig()`` (2^19 hash
  tables) and once at ``AppConfig.tpu_tuned()`` (2^12).  Every frame the
  app renders a fresh reference-camera NRC frame and MC frame and scores
  both against the golden (480x270, 256 frames of 64-bounce MC; a frame
  of another size is average-pooled to the golden's).  ``summarize`` reads
  the run's ``metrics.jsonl``: NRC's wins over equal-budget MC and the
  tail means of MSE, relBias and CV.
- ``interactive``: online NRC at the interactive points (480x270 with
  2 x 2^11, 1 x 2^12 and 4 x 2^12 train samples, the last trained every
  4th frame, and 320x180 with 2 x 2^11, all at 2^12 tables; the first
  also at 2^19): ms per frame over 10 frames after an untimed first one,
  then a 24-frame quality trace of the adopted point (480x270, 2 x 2^11,
  2^12) through the app against the golden.
- ``restir``: the ReSTIR renderer at 960x540 (4 path vertices, 3x3
  spatial, 2 temporal slots, MIS weights on and off, 16 frames each)
  against 16 frames of 32-bounce MC, both scored by RGB MSE against a
  256-frame MC truth (seed 7) from the golden cache.
- ``gates``: the reference's MC golden gates on every scene preset
  (``experiments/make_goldens.py``, ``golden_gate_calibration.py``,
  ``tests/test_goldens_all_scenes.py`` and ``test_long_budget_bias.py``).
  Per preset a golden at 192x108 (256 frames of 64-bounce MC, seed 0),
  then 10-frame 32-bounce MC renders at 96x54 with seeds 1-10 scored by
  relBias, raw and with both images clamped at 20x the golden's
  valid-pixel mean: the clamped values' mean is the preset's centre, tol
  = max(3.5 sigma, 0.08).  The test run, at a seed outside the
  calibration's (``11 + scene``), must read |raw relBias| < 1.5 and
  |clamped - centre| < tol; the centres of
  presets 0, 3, 4 and 5, whose radiance has no mass above the clamp,
  must lie within tol of zero; presets 1 and 2 (a point light in the
  medium) render 256 frames (seed ``scene + 17``), unclamped |relBias| <
  0.05.
- ``scenes``: ``convergence``'s protocol at 2^19 tables on scene 0 (with
  the reference's loss and target clamp, with the L2 loss, with a clamp
  of 16) and scene 5 (with and without ``env_fixed16``), each against
  its own golden; NRC's tail MSE must lie below MC's on scene 0.

The procedural 126x86x154 cloud of ``--seed`` stands in for the WDAS
cloud, at each scene preset's own density and phase g
(``preset_scene``).  The app runs in a directory of its own under
``nrc_hpm_tpu_torch/_build/quality_run/``, which holds that cloud as a
VDB at the scene's ``volume_path`` and the golden at
``reference/<scene>/0.exr``.  Each study writes
``output_torch/quality_<study>.json`` and prints its record on stdout;
logs go to stderr.  A failing study, or a gate it breaks, fails the run
(its record is written first).  Without a CUDA device
it exits with code 1 before any work; it never falls back to the CPU
(the functions take ``device=`` for tests on the CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from nrc_hpm_tpu_torch.camera import Camera
from nrc_hpm_tpu_torch.config import AppConfig, RestirConfig, SceneConfig
from nrc_hpm_tpu_torch.models.restir import RestirRenderer
from nrc_hpm_tpu_torch.ops import _build, read_launches, zero_launches
from nrc_hpm_tpu_torch.reference import (GoldenReference, _downsample,
                                         generate_golden)
from nrc_hpm_tpu_torch.renderer import McRenderer, NrcRenderer
from nrc_hpm_tpu_torch.utils.exr import read_exr_rgba
from nrc_hpm_tpu_torch.utils.procedural import cloud_density
from nrc_hpm_tpu_torch.volume import Volume

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(ROOT, "nrc_hpm_tpu_torch", "_build")
GOLDEN_CACHE = os.path.join(BUILD, "golden_cache")
RUN_DIR = os.path.join(BUILD, "quality_run")
OUT_DIR = "output_torch"
GOLDEN_SIZE = (480, 270)
GOLDEN_FRAMES = 256
GOLDEN_PATH = 64              # bounces of the golden's MC paths
GOLDEN_SAVE_EVERY = 16        # frames between the resume sidecar's writes
TRUTH_SEED = 7                # the seed of every golden's MC
FRAMES = 24                   # frames of a convergence run and the trace
TAIL_N = 8                    # frames of the tail means
TIMED_FRAMES = 10             # timed frames of an interactive point
RESTIR_SIZE = (960, 540)
RESTIR_FRAMES = 16
MC_SEED = 1                   # the seed of the MC frames ReSTIR is held to

# the MC golden gates (tests/test_goldens_all_scenes.py and
# experiments/golden_gate_calibration.py): test runs of GATE_FRAMES frames
# of GATE_PATH bounces at GATE_SIZE, a golden of GATE_GOLDEN_SIZE
PRESETS = tuple(range(6))
GATE_SIZE = (96, 54)
GATE_FRAMES = 10
GATE_PATH = 32
GATE_SEEDS = tuple(range(1, 11))
GATE_GOLDEN_SIZE = (192, 108)
# make_goldens.py's seed: apart from every test seed, so no test run
# repeats the golden's first frames
GATE_GOLDEN_SEED = 0
GATE_CLIP = 20.0              # the clamp, times the golden's valid mean
GATE_RAW = 1.5                # the bound on the unclamped relBias
GATE_SIGMAS = 3.5             # tol = max(GATE_SIGMAS * sigma, GATE_TOL_MIN)
GATE_TOL_MIN = 0.08
# presets without radiance above the clamp: their centre lies at zero
CENTRED = (0, 3, 4, 5)
# the point-light presets and their long-budget run (test_long_budget_bias)
LONG_PRESETS = (1, 2)
LONG_SEED = 17                # a long run's seed: LONG_SEED + preset
LONG_FRAMES = 256
LONG_BOUND = 0.05

# (label, scene preset, AppConfig fields) of the scenes study:
# BASELINE.md's scene-0/5 runs and its scene-0 bias study
SCENE_RUNS = (
    ("scene0", 0, {}),
    ("scene0_l2", 0, dict(loss_fn="L2")),
    ("scene0_clamp16", 0, dict(train_target_clamp=16.0)),
    ("scene5", 5, {}),
    ("scene5_env_fixed16", 5, dict(env_fixed16=True)),
)
# the runs whose NRC tail MSE must lie below MC's
SCENE_GATED = ("scene0",)

# (tag, width, height, train batches, log2 train batch, train every,
# log2 hash table): the interactive points
POINTS = (
    ("480x270 train 2x2^11", 480, 270, 2, 11, 1, 12),
    ("480x270 train 1x2^12", 480, 270, 1, 12, 1, 12),
    ("480x270 train 4x2^12 every 4", 480, 270, 4, 12, 4, 12),
    ("320x180 train 2x2^11", 320, 180, 2, 11, 1, 12),
    ("480x270 train 2x2^11 tables 2^19", 480, 270, 2, 11, 1, 19),
)
ADOPTED = POINTS[0]           # the point the quality trace runs


# ---- the record: logs, the card and the kernels launched --------------------

def log(*a):
    print(*a, file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def built_libraries() -> int:
    """Libraries in the build cache (``nrc_hpm_tpu_torch/_build/``)."""
    return len(list(_build.BUILD_DIR.glob("lib*.so")))


@contextlib.contextmanager
def launched(record: dict, section: str):
    """Record the port kernels launched in the block, with their counts,
    under ``record["kernels_launched"][section]``."""
    zero_launches()
    yield
    record["kernels_launched"][section] = {
        k: n for k, n in read_launches().items() if n}


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def device_record(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"device": "cpu"}
    return {"device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(), "gpu": gpu_line(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


# ---- the golden cache -------------------------------------------------------

def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        a = t.detach().cpu().contiguous().numpy()
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def volume_digest(vol: Volume) -> str:
    """A hash of the bytes the trackers read: the density grid, the macro
    tables and the box, with the density factor and the phase g."""
    return _digest(vol.grid, vol.macro, vol.macro_min, vol.macro_packed,
                   vol.sky_size) + f":{vol.density_factor!r}:{vol.g!r}"


def golden_key(cfg: AppConfig, vol: Volume, width: int, height: int,
               frames: int, path_length: int, seed: int) -> str:
    """The cache key of a golden: a hash of everything that decides the
    image."""
    cam = Camera.reference_camera(aspect=width / height, device="cpu")
    spec = dict(scene=dataclasses.asdict(cfg.scene),
                camera=_digest(cam.pos, cam.inv_proj_view),
                max_track_steps=cfg.max_track_steps,
                env_fixed16=cfg.env_fixed16, width=width, height=height,
                frames=frames, path_length=path_length, seed=seed,
                volume=volume_digest(vol))
    blob = json.dumps(spec, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:24]


def golden_done(path: str, frames: int) -> bool:
    """Whether the cache's golden at ``path`` holds all ``frames``."""
    side = path + ".progress.json"
    if not os.path.exists(side):
        return False
    with open(side) as f:
        return json.load(f).get("frames_done") == frames


def golden_file(cfg: AppConfig, vol: Volume, width: int, height: int,
                frames: int, path_length: int = GOLDEN_PATH,
                seed: int = TRUTH_SEED, device="cuda") -> str:
    """The EXR of the golden of these inputs, rendered by
    ``generate_golden`` on ``device`` unless the cache holds it complete.
    A build that was cut resumes from its sidecar."""
    key = golden_key(cfg, vol, width, height, frames, path_length, seed)
    path = os.path.join(GOLDEN_CACHE, key, "0.exr")
    if golden_done(path, frames):
        return path
    log(f"golden {key}: {width}x{height}, {frames} frames of "
        f"{path_length}-bounce MC, seed {seed}")
    t0 = time.perf_counter()
    generate_golden(cfg, path, vol, frames=frames, path_length=path_length,
                    width=width, height=height, seed=seed, resume=True,
                    save_every=GOLDEN_SAVE_EVERY, device=device)
    log(f"golden {key}: {time.perf_counter() - t0:.1f} s")
    return path


def golden(cfg: AppConfig, vol: Volume, width: int, height: int,
           frames: int, path_length: int = GOLDEN_PATH,
           seed: int = TRUTH_SEED, device="cuda") -> GoldenReference:
    """The golden of these inputs from the cache (rendered on a miss), as
    a ``GoldenReference`` on ``device``: its ``compare`` pools the larger
    of two images to the smaller one."""
    path = golden_file(cfg, vol, width, height, frames, path_length, seed,
                       device)
    return GoldenReference(read_exr_rgba(path), device=device)


def preset_scene(scene_id: int, density, cfg: AppConfig | None = None,
                 device="cuda"):
    """``cfg`` (``AppConfig()`` by default) at scene preset ``scene_id``,
    and the volume of the density grid ``density`` at that preset's
    density and phase g: a renderer given a volume never reads
    ``cfg.scene.density`` itself."""
    cfg = dataclasses.replace(cfg or AppConfig(),
                              scene=SceneConfig.preset(scene_id))
    vol = Volume.from_dense(density, cfg.scene.density, cfg.scene.volume_g,
                            device=device)
    return cfg, vol


# ---- the summary of a run ---------------------------------------------------

def _mean(xs) -> float:
    xs = list(xs)
    return sum(xs) / max(len(xs), 1)


def summarize(rows, tail_n: int = 16) -> dict:
    """A run's comparison rows (``metrics.jsonl`` records with ``nrc``) as
    ``experiments/summarize_run.py`` reads them: the frames compared, NRC's
    wins over MC and the first, the tail means of MSE, relBias and CV of
    both, the NRC/MC tail MSE ratio, the mean frame time without frame 0,
    the first and the last loss.  MC's entries are None in a run without
    MC, the frame time where fewer than two frames have one."""
    rows = [r for r in rows if "nrc" in r]
    if not rows:
        raise ValueError("no comparison rows")
    tail = rows[-tail_n:]
    wins = [r["frame"] for r in rows
            if "mc" in r and r["nrc"]["mse"] < r["mc"]["mse"]]
    out = dict(frames=len(rows), tail_n=tail_n, nrc_wins=len(wins),
               first_win=wins[0] if wins else None,
               nrc_mse=_mean(r["nrc"]["mse"] for r in tail),
               nrc_rel_bias=_mean(r["nrc"]["rel_bias"] for r in tail),
               nrc_cv=_mean(r["nrc"]["cv"] for r in tail),
               mc_mse=None, mc_rel_bias=None, mc_cv=None, mse_ratio=None)
    mc = [r["mc"] for r in tail if "mc" in r]
    if mc:
        out.update(mc_mse=_mean(m["mse"] for m in mc),
                   mc_rel_bias=_mean(m["rel_bias"] for m in mc),
                   mc_cv=_mean(m["cv"] for m in mc))
        out["mse_ratio"] = out["nrc_mse"] / out["mc_mse"]
    ft = [r["frame_time_ms"] for r in rows if "frame_time_ms" in r]
    out["mean_frame_time_ms"] = _mean(ft[1:]) if len(ft) > 1 else None
    losses = [r["loss"] for r in rows if "loss" in r]
    out["loss_first"] = losses[0] if losses else None
    out["loss_last"] = losses[-1] if losses else None
    return out


# ---- the app in a directory of its own --------------------------------------

def app_argv(cfg: AppConfig) -> list:
    """The app's arguments for ``cfg``: the 17 positional ones, the size
    and the hash grid.  Raises where the app cannot run ``cfg``."""
    from nrc_hpm_tpu_torch import app

    pos = [cfg.loss_fn, cfg.optimizer, repr(cfg.learning_rate),
           repr(cfg.ema_decay), cfg.encoding.pos_id, cfg.encoding.dir_id,
           cfg.nn_width, cfg.nn_depth, cfg.log2_infer_batch_size,
           cfg.log2_train_batch_size, cfg.train_batch_count, cfg.scene.id,
           repr(cfg.train_ring_buf_size), cfg.train_spp,
           cfg.primary_ray_length, repr(cfg.primary_ray_prob),
           cfg.train_ray_length]
    argv = [str(a) for a in pos] + [
        "--width", str(cfg.render_width), "--height", str(cfg.render_height),
        "--log2-hashmap", str(cfg.encoding.log2_hashmap_size),
        "--n-levels", str(cfg.encoding.n_levels),
        "--target-clamp", repr(cfg.train_target_clamp)]
    if cfg.env_fixed16:
        argv.append("--env-fixed16")
    if cfg.train_cache_bootstrap:
        argv.append("--cache-bootstrap")
    got = app._config(app.build_argparser().parse_args(argv))
    if got != cfg:
        diff = [f.name for f in dataclasses.fields(cfg)
                if getattr(got, f.name) != getattr(cfg, f.name)]
        raise ValueError(f"the app cannot run this configuration: {diff}")
    return argv


def write_scene(root: str, cfg: AppConfig, density: np.ndarray,
                device) -> Volume:
    """``density`` as a VDB at the scene's ``volume_path`` under ``root``
    (emptied first); returns the volume the app reads from it."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_vdb_writer as vw

    shutil.rmtree(root, ignore_errors=True)
    vdb = os.path.join(root, cfg.scene.volume_path)
    os.makedirs(os.path.dirname(vdb))
    vw.write_vdb(vdb, [vw.Grid(np.asarray(density, np.float32))])
    return Volume.from_vdb(vdb, cfg.scene.density, cfg.scene.volume_g,
                           device=device)


def app_run(root: str, cfg: AppConfig, golden_exr: str, frames: int,
            label: str, device) -> list:
    """``app.main --renderer both --benchmark-every 1`` for ``frames``
    frames at ``cfg`` from ``root`` (which holds the scene), the golden
    copied to ``reference/<scene>/0.exr`` there; returns the run's frame
    records.  The app's prints go to stderr."""
    from nrc_hpm_tpu_torch import app

    ref = os.path.join(root, "reference", str(cfg.scene.id), "0.exr")
    os.makedirs(os.path.dirname(ref), exist_ok=True)
    shutil.copy(golden_exr, ref)
    out = os.path.join(root, label)
    argv = app_argv(cfg) + [
        "--renderer", "both", "--frames", str(frames),
        "--benchmark-every", "1", "--out", out,
        "--platform", torch.device(device).type]
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            rc = app.main(argv)
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"app.main returned {rc}")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    rows = [r for r in rows if "frame" in r]
    if len(rows) != frames:
        raise RuntimeError(f"{label}: {len(rows)} of {frames} frames")
    return rows


def _cloud(density, seed):
    return cloud_density(seed=seed) if density is None else density


def _golden_record(cfg, vol, size, frames, path_length, device,
                   seed: int = TRUTH_SEED) -> dict:
    """Render (or find) the golden; its inputs, key, file, whether the
    cache held it and the seconds it took."""
    w, h = size
    key = golden_key(cfg, vol, w, h, frames, path_length, seed)
    cached = golden_done(os.path.join(GOLDEN_CACHE, key, "0.exr"), frames)
    t0 = time.perf_counter()
    path = golden_file(cfg, vol, w, h, frames, path_length, seed, device)
    return dict(width=w, height=h, frames=frames, path_length=path_length,
                seed=seed, key=key, file=path, cached=cached,
                seconds=time.perf_counter() - t0)


# ---- the studies ------------------------------------------------------------

def convergence(cfg: AppConfig | None = None, frames: int = FRAMES,
                tail_n: int = TAIL_N, golden_size=GOLDEN_SIZE,
                golden_frames: int = GOLDEN_FRAMES,
                golden_path: int = GOLDEN_PATH, width: int = 1920,
                height: int = 1080, tables=(19, 12), seed: int = 0,
                density=None, device="cuda") -> dict:
    """NRC against equal-budget MC: the app with ``--renderer both``,
    every frame scored against the golden, once per hash-table size of
    ``tables`` (``cfg`` is ``AppConfig()``, 19 its own size and 12
    ``AppConfig.tpu_tuned()``'s).  ``density`` defaults to the procedural
    cloud of ``seed``."""
    cfg = dataclasses.replace(cfg or AppConfig(), render_width=width,
                              render_height=height)
    root = os.path.join(RUN_DIR, "convergence")
    rec = dict(study="convergence", **device_record(torch.device(device)),
               seed=seed, width=width, height=height, frames=frames,
               tail_n=tail_n, kernels_launched={}, runs={})
    vol = write_scene(root, cfg, _cloud(density, seed), device)
    with launched(rec, "golden"):
        rec["golden"] = _golden_record(cfg, vol, golden_size, golden_frames,
                                       golden_path, device)
    exr = rec["golden"]["file"]
    for log2 in tables:
        run_cfg = dataclasses.replace(cfg, encoding=dataclasses.replace(
            cfg.encoding, log2_hashmap_size=log2))
        label = f"2e{log2}"
        t0 = time.perf_counter()
        with launched(rec, label):
            rows = app_run(root, run_cfg, exr, frames, label, device)
        s = summarize(rows, tail_n)
        rec["runs"][label] = dict(log2_hashmap_size=log2,
                                  seconds=time.perf_counter() - t0,
                                  summary=s, rows=rows)
        log(f"convergence {label}: NRC wins {s['nrc_wins']}/{s['frames']}, "
            f"tail({tail_n}) MSE NRC {s['nrc_mse']:.6g} MC {s['mc_mse']:.6g}"
            f" (ratio {s['mse_ratio']:.4g}), relBias NRC "
            f"{s['nrc_rel_bias']:+.4f} MC {s['mc_rel_bias']:+.4f}, frame "
            f"{s['mean_frame_time_ms']} ms")
    return rec


def point_cfg(base: AppConfig, point) -> AppConfig:
    _, w, h, batches, log2_train, _, log2_table = point
    return dataclasses.replace(
        base, render_width=w, render_height=h,
        encoding=dataclasses.replace(base.encoding,
                                     log2_hashmap_size=log2_table),
        log2_train_batch_size=log2_train, train_batch_count=batches)


def run_point(point, cfg: AppConfig, vol: Volume, frames: int,
              device) -> dict:
    """One interactive point: an untimed first frame (and a frozen one
    where training skips frames), then ``frames`` frames on the host
    clock, training every ``train_every``-th."""
    tag, w, h, _, _, every, _ = point
    dev = torch.device(device)
    r = NrcRenderer(cfg, vol)
    cam = Camera.reference_camera(aspect=w / h, device=dev)
    before = built_libraries()
    t0 = time.perf_counter()
    state = r.step(r.init_state(0), cam, train=True)
    if every > 1:
        state = r.step(state, cam, train=False)
    sync(dev)
    first_s = time.perf_counter() - t0
    built = built_libraries() - before
    t0 = time.perf_counter()
    for i in range(frames):
        state = r.step(state, cam, train=i % every == 0)
    sync(dev)
    dt = (time.perf_counter() - t0) / frames
    rec = dict(tag=tag, width=w, height=h,
               train_samples=cfg.train_pixel_count, train_every=every,
               log2_hashmap_size=cfg.encoding.log2_hashmap_size,
               ms_per_frame=dt * 1e3, fps=1.0 / dt, rays_per_s=w * h / dt,
               compile_plus_first_s=first_s,
               compile_cache_status="cold" if built else "warm",
               loss=float(state.nrc.loss))
    log(f"interactive {tag}: {dt * 1e3:.1f} ms/frame, {1 / dt:.2f} fps, "
        f"loss {rec['loss']:.4f}")
    return rec


def interactive(cfg: AppConfig | None = None, points=POINTS,
                adopted=ADOPTED, timed_frames: int = TIMED_FRAMES,
                frames: int = FRAMES, tail_n: int = TAIL_N,
                golden_size=GOLDEN_SIZE, golden_frames: int = GOLDEN_FRAMES,
                golden_path: int = GOLDEN_PATH, seed: int = 0,
                density=None, device="cuda") -> dict:
    """The interactive points timed, then the adopted point's
    ``frames``-frame quality trace through the app against the golden:
    the tail means of the last ``tail_n`` frames, NRC's wins over all."""
    base = cfg or AppConfig()
    root = os.path.join(RUN_DIR, "interactive")
    rec = dict(study="interactive", **device_record(torch.device(device)),
               seed=seed, kernels_launched={}, points=[])
    trace_cfg = point_cfg(base, adopted)
    vol = write_scene(root, trace_cfg, _cloud(density, seed), device)
    for point in points:
        with launched(rec, point[0]):
            rec["points"].append(run_point(point, point_cfg(base, point),
                                           vol, timed_frames, device))
    with launched(rec, "golden"):
        rec["golden"] = _golden_record(trace_cfg, vol, golden_size,
                                       golden_frames, golden_path, device)
    t0 = time.perf_counter()
    with launched(rec, "trace"):
        rows = app_run(root, trace_cfg, rec["golden"]["file"], frames,
                       "trace", device)
    window = rows[-tail_n:]

    def m(side, k):
        return float(np.mean([r[side][k] for r in window]))

    rec["operating_point"] = next(p for p in rec["points"]
                                  if p["tag"] == adopted[0])
    rec["quality"] = dict(
        tag=adopted[0], frames=len(rows), window=[window[0]["frame"],
                                                  window[-1]["frame"]],
        nrc_mse=m("nrc", "mse"), nrc_rel_bias=m("nrc", "rel_bias"),
        nrc_cv=m("nrc", "cv"), mc_mse=m("mc", "mse"),
        mc_rel_bias=m("mc", "rel_bias"),
        nrc_wins=int(sum(r["nrc"]["mse"] < r["mc"]["mse"] for r in rows)),
        seconds=time.perf_counter() - t0)
    rec["trace_rows"] = rows
    q = rec["quality"]
    log(f"interactive trace: NRC wins {q['nrc_wins']}/{q['frames']}, "
        f"window MSE NRC {q['nrc_mse']:.6g} MC {q['mc_mse']:.6g}")
    return rec


def _host(img) -> np.ndarray:
    return np.asarray(img.detach().cpu() if torch.is_tensor(img) else img,
                      np.float32)


def mse(a, b) -> float:
    """RGB mean squared error over every pixel (``restir_960.mse``)."""
    return float(np.mean((_host(a)[..., :3] - _host(b)[..., :3]) ** 2))


def restir(cfg: AppConfig | None = None, width: int = RESTIR_SIZE[0],
           height: int = RESTIR_SIZE[1], frames: int = RESTIR_FRAMES,
           truth_frames: int = GOLDEN_FRAMES, seed: int = 0, density=None,
           device="cuda") -> dict:
    """ReSTIR (MIS weights on, then off) against MC at an equal frame
    count, each scored by RGB MSE against an MC truth of
    ``truth_frames`` frames from the golden cache."""
    dev = torch.device(device)
    base = cfg or AppConfig()
    cfg = dataclasses.replace(
        base, render_width=width, render_height=height, mc_path_length=32,
        restir=RestirConfig(path_vertex_count=4, spatial_kernel_size=3,
                            temporal_kernel_size=2, mis_weights=True))
    vol = Volume.from_dense(_cloud(density, seed), cfg.scene.density,
                            cfg.scene.volume_g, device=dev)
    cam = Camera.reference_camera(aspect=width / height, device=dev)
    rec = dict(study="restir", **device_record(dev), seed=seed,
               resolution=f"{width}x{height}", frames=frames,
               truth_frames=truth_frames, scene=cfg.scene.id,
               kernels_launched={})

    def timed(label, r, state):
        """The first frame, then frames 2..``frames`` on the host clock."""
        before = built_libraries()
        t0 = time.perf_counter()
        state = r.step(state, cam)
        sync(dev)
        rec[f"{label}_first_frame_s"] = time.perf_counter() - t0
        rec[f"{label}_compile_cache_status"] = \
            "cold" if built_libraries() - before else "warm"
        t0 = time.perf_counter()
        for _ in range(frames - 1):
            state = r.step(state, cam)
        sync(dev)
        rec[f"{label}_ms_per_frame"] = \
            (time.perf_counter() - t0) / max(frames - 1, 1) * 1e3
        log(f"{label}: {rec[f'{label}_ms_per_frame']:.1f} ms/frame")
        return state.image

    images = {}
    for label, mis in (("restir", True), ("restir_uniform", False)):
        rcfg = dataclasses.replace(cfg, restir=dataclasses.replace(
            cfg.restir, mis_weights=mis))
        # the last frame alone, as experiments/restir_960.py scores it
        r = RestirRenderer(rcfg, vol, blend=False)
        with launched(rec, label):
            images[label] = timed(label, r, r.init_state(0))
    mc = McRenderer(cfg, vol)
    with launched(rec, "mc"):
        images["mc"] = timed("mc", mc, mc.init_state(MC_SEED))
    with launched(rec, "truth"):
        rec["truth"] = _golden_record(cfg, vol, (width, height),
                                      truth_frames, cfg.mc_path_length,
                                      device)
    truth = read_exr_rgba(rec["truth"]["file"])
    rec["restir_mse_vs_truth"] = mse(images["restir"], truth)
    rec["restir_mse_vs_truth_uniform"] = mse(images["restir_uniform"], truth)
    rec["mc_mse_vs_truth"] = mse(images["mc"], truth)
    rec["mse_ratio_restir_over_mc"] = \
        rec["restir_mse_vs_truth"] / max(rec["mc_mse_vs_truth"], 1e-12)
    rec["mse_ratio_uniform_over_mc"] = \
        rec["restir_mse_vs_truth_uniform"] / max(rec["mc_mse_vs_truth"],
                                                 1e-12)
    log(f"restir MSE vs truth {rec['restir_mse_vs_truth']:.6g} (uniform "
        f"{rec['restir_mse_vs_truth_uniform']:.6g}), MC "
        f"{rec['mc_mse_vs_truth']:.6g}")
    return rec


# ---- the golden gates and the scene presets ---------------------------------

def gate_band(values) -> dict:
    """The gate of a preset from its clamped relBias values: their mean
    (the centre), their spread (sigma, numpy's population std, as
    golden_gate_calibration.py) and tol = max(GATE_SIGMAS * sigma,
    GATE_TOL_MIN)."""
    arr = np.asarray(values, np.float64)
    centre, sigma = float(arr.mean()), float(arr.std())
    return dict(centre=centre, sigma=sigma,
                tol=max(GATE_SIGMAS * sigma, GATE_TOL_MIN))


def gates(presets=PRESETS, cfg: AppConfig | None = None, size=GATE_SIZE,
          frames: int = GATE_FRAMES, path_length: int = GATE_PATH,
          seeds=GATE_SEEDS, golden_size=GATE_GOLDEN_SIZE,
          golden_frames: int = GOLDEN_FRAMES,
          golden_path: int = GOLDEN_PATH, long_frames: int = LONG_FRAMES, long_size=None, seed: int = 0,
          density=None, device="cuda") -> dict:
    """The reference's MC golden gates on each preset of ``presets``, each
    on its own volume (``preset_scene``): a golden from the cache
    (GATE_GOLDEN_SEED), ``frames``-frame MC renders of ``path_length``
    bounces at ``size`` with each seed of ``seeds`` (the calibration: raw
    and clamped relBias, ``gate_band`` of the clamped ones), the test run
    (seed ``max(seeds) + 1 + scene``, apart from the calibration's)
    against GATE_RAW and the band, the centre of a CENTRED preset against
    zero, and for LONG_PRESETS a ``long_frames``-frame render at
    ``long_size`` (``size`` by default; seed ``LONG_SEED + scene``)
    unclamped against LONG_BOUND.  ``failures`` lists each broken gate,
    ``passed`` is whether there is none."""
    dev = torch.device(device)
    w, h = size
    long_w, long_h = long_size or size
    rec = dict(study="gates", **device_record(dev), seed=seed, width=w,
               height=h, frames=frames, path_length=path_length,
               seeds=list(seeds), golden_seed=GATE_GOLDEN_SEED,
               clip_factor=GATE_CLIP, raw_bound=GATE_RAW,
               tol_sigmas=GATE_SIGMAS, tol_min=GATE_TOL_MIN,
               long_frames=long_frames, long_width=long_w,
               long_height=long_h, long_bound=LONG_BOUND,
               kernels_launched={}, presets={}, failures=[])
    density = _cloud(density, seed)
    spent = dict(s=0.0, frames=0)

    def render(mc, n, s):
        cam = Camera.reference_camera(aspect=mc.width / mc.height,
                                      device=dev)
        sync(dev)
        t0 = time.perf_counter()
        img = mc.render(cam, n, seed=s)
        sync(dev)
        spent["s"] += time.perf_counter() - t0
        spent["frames"] += n
        return img

    def fail(what):
        rec["failures"].append(what)
        log(f"gates: FAILED {what}")

    for sid in presets:
        pcfg, vol = preset_scene(sid, density, cfg, device=dev)
        with launched(rec, f"{sid} golden"):
            g = _golden_record(pcfg, vol, golden_size, golden_frames,
                               golden_path, device, seed=GATE_GOLDEN_SEED)
        gold = GoldenReference(read_exr_rgba(g["file"]), device=dev)
        valid = gold.image[..., 3] != 0
        clip = GATE_CLIP * float(gold.image[..., :3][valid].mean())
        # the golden pooled to the runs' size once, as compare pools it
        pooled = gold if gold.image.shape[:2] == (h, w) else \
            GoldenReference(_downsample(gold.image, (h, w)), device=dev)

        def mc_at(width, height):
            return McRenderer(dataclasses.replace(
                pcfg, render_width=width, render_height=height,
                mc_path_length=path_length), vol)

        mc = mc_at(w, h)

        def score(img):
            return (float(pooled.compare(img).rel_bias),
                    float(pooled.compare(img, clip=clip).rel_bias))

        s0, f0 = spent["s"], spent["frames"]
        calibration = []
        with launched(rec, f"{sid} calibration"):
            for s in seeds:
                raw, clamped = score(render(mc, frames, s))
                calibration.append(dict(seed=s, raw=raw, clamped=clamped))
        band = gate_band([c["clamped"] for c in calibration])
        test_seed = max(seeds) + 1 + sid
        with launched(rec, f"{sid} test"):
            raw, clamped = score(render(mc, frames, test_seed))
        test = dict(seed=test_seed, raw=raw, clamped=clamped,
                    raw_ok=abs(raw) < GATE_RAW,
                    band_ok=abs(clamped - band["centre"]) < band["tol"])
        p = dict(scene=dataclasses.asdict(pcfg.scene), golden=g, clip=clip,
                 calibration=calibration, **band,
                 raw_min=min(c["raw"] for c in calibration),
                 raw_max=max(c["raw"] for c in calibration), test=test,
                 centred_ok=(abs(band["centre"]) < band["tol"]
                             if sid in CENTRED else None), long=None)
        if not test["raw_ok"]:
            fail(f"preset {sid}: test run's raw relBias {raw:+.4f} "
                 f"(bound {GATE_RAW})")
        if not test["band_ok"]:
            fail(f"preset {sid}: test run's clamped relBias {clamped:+.4f} "
                 f"outside {band['centre']:+.4f} +- {band['tol']:.4f}")
        if p["centred_ok"] is False:
            fail(f"preset {sid}: centre {band['centre']:+.4f} outside +- "
                 f"{band['tol']:.4f} of zero")
        if sid in LONG_PRESETS:
            long_seed = LONG_SEED + sid
            with launched(rec, f"{sid} long"):
                rb = float(gold.compare(render(
                    mc_at(long_w, long_h), long_frames, long_seed)).rel_bias)
            p["long"] = dict(seed=long_seed, frames=long_frames, rel_bias=rb,
                             ok=abs(rb) < LONG_BOUND)
            if not p["long"]["ok"]:
                fail(f"preset {sid}: long-budget relBias {rb:+.4f} (bound "
                     f"{LONG_BOUND})")
        p["ms_per_mc_frame"] = \
            1e3 * (spent["s"] - s0) / (spent["frames"] - f0)
        rec["presets"][str(sid)] = p
        log(f"gates preset {sid}: golden {g['seconds']:.1f} s (cached "
            f"{g['cached']}), clip {clip:.4g}, centre {band['centre']:+.4f} "
            f"sigma {band['sigma']:.4f} tol {band['tol']:.4f}; test raw "
            f"{raw:+.4f} clamped {clamped:+.4f}"
            + (f"; long {p['long']['rel_bias']:+.4f}" if p["long"] else "")
            + f"; {p['ms_per_mc_frame']:.1f} ms per MC frame")
    rec["mc_frames"] = spent["frames"]
    rec["ms_per_mc_frame"] = 1e3 * spent["s"] / max(spent["frames"], 1)
    rec["passed"] = not rec["failures"]
    return rec


def scenes(runs=SCENE_RUNS, cfg: AppConfig | None = None,
           frames: int = FRAMES, tail_n: int = TAIL_N,
           golden_size=GOLDEN_SIZE, golden_frames: int = GOLDEN_FRAMES,
           golden_path: int = GOLDEN_PATH, width: int = 1920,
           height: int = 1080, seed: int = 0, density=None,
           device="cuda") -> dict:
    """``convergence``'s protocol for each run of ``runs`` ((label, scene
    preset, AppConfig fields) over ``cfg``, ``AppConfig()`` by default)
    at its own table size, each against its own golden (the cache keys
    the scene and ``env_fixed16``); NRC's tail MSE must lie below MC's
    on each run of SCENE_GATED.  Where a scene ran with and without
    ``env_fixed16`` the fixed-step golden is scored against the
    ratio-tracked one (``env_fixed16_golden_rel_bias``)."""
    rec = dict(study="scenes", **device_record(torch.device(device)),
               seed=seed, width=width, height=height, frames=frames,
               tail_n=tail_n, kernels_launched={}, runs={}, failures=[],
               env_fixed16_golden_rel_bias={})
    density = _cloud(density, seed)
    for label, sid, fields in runs:
        run_cfg = dataclasses.replace(cfg or AppConfig(),
                                      scene=SceneConfig.preset(sid),
                                      **fields)
        conv = convergence(run_cfg, frames, tail_n, golden_size,
                           golden_frames, golden_path, width, height,
                           tables=(run_cfg.encoding.log2_hashmap_size,),
                           seed=seed, density=density, device=device)
        (run,) = conv["runs"].values()
        for section, launches in conv["kernels_launched"].items():
            rec["kernels_launched"][f"{label} {section}"] = launches
        s = run["summary"]
        rec["runs"][label] = dict(scene=sid, fields=fields,
                                  golden=conv["golden"],
                                  seconds=run["seconds"], summary=s,
                                  rows=run["rows"])
        if label in SCENE_GATED and not s["mse_ratio"] < 1.0:
            rec["failures"].append(f"{label}: NRC/MC tail MSE "
                                   f"{s['mse_ratio']:.4f}, not below 1")
            log(f"scenes: FAILED {rec['failures'][-1]}")
    files = {(r["scene"], bool(r["fields"].get("env_fixed16"))):
             r["golden"]["file"] for r in rec["runs"].values()}
    for (sid, fixed), path in files.items():
        if fixed and (sid, False) in files:
            ref = GoldenReference(read_exr_rgba(files[sid, False]),
                                  device=device)
            gap = float(ref.compare(read_exr_rgba(path)).rel_bias)
            rec["env_fixed16_golden_rel_bias"][str(sid)] = gap
            log(f"scenes: scene {sid}'s env_fixed16 golden against its "
                f"ratio-tracked one: relBias {gap:+.4f}")
    rec["passed"] = not rec["failures"]
    return rec


STUDIES = ("convergence", "interactive", "restir", "gates", "scenes")


def run_study(name: str, seed: int = 0, frames: int | None = None,
              golden_frames: int | None = None, device="cuda") -> dict:
    """One study at full size; ``frames`` and ``golden_frames`` override
    its frame counts (the tail stays at most TAIL_N frames; for ``gates``
    ``frames`` is the calibration and test runs')."""
    kw = dict(seed=seed, device=device)
    if frames is not None:
        kw["frames"] = frames
        if name not in ("restir", "gates"):
            kw["tail_n"] = min(TAIL_N, frames)
    if golden_frames is not None:
        kw["truth_frames" if name == "restir" else "golden_frames"] = \
            golden_frames
    fn = dict(convergence=convergence, interactive=interactive,
              restir=restir, gates=gates, scenes=scenes)[name]
    t0 = time.perf_counter()
    rec = fn(**kw)
    rec["run_s"] = time.perf_counter() - t0
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="The port's image-quality studies on one CUDA GPU")
    p.add_argument("study", choices=STUDIES + ("all",))
    p.add_argument("--seed", type=int, default=0,
                   help="the procedural cloud's seed")
    p.add_argument("--frames", type=int, default=None,
                   help="frames of each run (default: 24 for convergence, "
                        "the interactive trace and scenes, 16 for ReSTIR, "
                        "10 for the gates' test runs)")
    p.add_argument("--golden-frames", type=int, default=None,
                   help="frames of the goldens and of ReSTIR's truth "
                        "(default 256)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("quality_torch: no CUDA device; the studies run only on a GPU",
              file=sys.stderr)
        return 1
    names = STUDIES if args.study == "all" else (args.study,)
    os.makedirs(OUT_DIR, exist_ok=True)
    failed = []
    for name in names:
        rec = run_study(name, args.seed, args.frames, args.golden_frames)
        path = os.path.join(OUT_DIR, f"quality_{name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        log(f"{name}: record written to {path}")
        print(json.dumps(rec), flush=True)
        if rec.get("passed") is False:
            failed.append(name)
    if failed:
        log(f"quality_torch: gates broken in {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
