#!/usr/bin/env python3
"""Benchmark entry point of the PyTorch + CUDA port: one JSON line.

Run from the repository root on a machine with one CUDA GPU:

    python3 bench_torch.py [--seed N]

It measures with ``nrc_hpm_tpu_torch`` on the card what ``bench.py``
measures with the JAX package, under the same record keys.  Headline:
rays/s of the full online NRC frame (trace, filtered cache inference,
65,536 train paths through 4 Adam steps, composite) at ``AppConfig()``
(2^19 hash tables) and 1920x1080 on the procedural 126x86x154 cloud.
Context, in ``bench.py``'s order: the frozen-cache frame, ``cache.infer``
samples/s at 622,592 and at 2,073,600 inputs, the 32-bounce MC frame, the
online frame at 2^12 tables (``AppConfig.tpu_tuned()``), and the stage
total.  ``NRC_BENCH_FULL=0`` keeps the headline, the inference and the
stage total; ``NRC_BENCH_PROFILE=1`` adds ``profiler.profile_nrc_frame``'s
per-stage profile.  Each section records the port kernels it launched.

Frames are timed on the host clock with one ``torch.cuda.synchronize`` at
the end of each run of frames; inference by CUDA events over repeated
calls after a warm-up.  The first frame includes the kernels' builds when
the ``nrc_hpm_tpu_torch/_build/`` cache lacks them: the record says
whether it did (``compile_cache_status``).  The record also holds the
card's name and power limit, the host's core count and load average, and
the process's CPU seconds beside the run's wall seconds, since the frame
is paced by the host.

Logs go to stderr, the record to ``output_torch/bench_full.json`` (and
the stage profile to ``output_torch/stage_profile.json``), and the last
line of stdout is
``{"metric": "nrc_online_rays_per_s_1080p", "value": ..., "unit":
"rays/s/chip"}``.  A failing section fails the run.  Without a CUDA device
it exits with code 1 before any work.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import torch

from chip_smoke import gpu_line, read_launches, zero_launches
from nrc_hpm_tpu_torch.camera import Camera
from nrc_hpm_tpu_torch.config import AppConfig
from nrc_hpm_tpu_torch.ops import _build
from nrc_hpm_tpu_torch.profiler import (format_stage_report,
                                        profile_nrc_frame, stage_ms)
from nrc_hpm_tpu_torch.renderer import McRenderer, NrcRenderer
from nrc_hpm_tpu_torch.utils import prng
from nrc_hpm_tpu_torch.utils.procedural import cloud_density
from nrc_hpm_tpu_torch.volume import Volume

# ~30% of a 1080p frame: the JAX package's inference-compaction capacity
N_INFER = 622592
INFER_REPS = 5
FROZEN_FRAMES = 4
MC_FRAMES = 3
TUNED_FRAMES = 3
TUNED_LOG2_TABLE = 12          # AppConfig.tpu_tuned()'s hash tables
OUT_DIR = "output_torch"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _flag(name, default="1"):
    return os.environ.get(name, default).lower() not in ("", "0", "false")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall(step, n: int, state, device: torch.device):
    """Seconds per call of ``n`` chained calls of ``step``: the host clock
    around them, one synchronize at the end."""
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        state = step(state)
    sync(device)
    return (time.perf_counter() - t0) / n, state


def built_libraries() -> int:
    """Libraries in the build cache (``nrc_hpm_tpu_torch/_build/``)."""
    return len(list(_build.BUILD_DIR.glob("lib*.so")))


def infer_inputs(seed: int, n: int, n_dense: int, device) -> tuple:
    """The (n, 5) and (n_dense, 5) inference inputs in [0, 1):
    ``jax.random.uniform`` at ``PRNGKey(seed + 1)`` and ``PRNGKey(seed +
    2)``, bench.py's own at seed 0."""
    return tuple(prng.uniform(prng.prng_key(seed + k), (m, 5), device=device)
                 for k, m in ((1, n), (2, n_dense)))


def tuned(cfg: AppConfig) -> AppConfig:
    """``cfg`` at 2^12 hash tables: ``AppConfig.tpu_tuned()`` where
    ``cfg`` is ``AppConfig()``."""
    return dataclasses.replace(cfg, encoding=dataclasses.replace(
        cfg.encoding, log2_hashmap_size=TUNED_LOG2_TABLE))


@contextlib.contextmanager
def launched(record: dict, section: str):
    """Record the port kernels launched in the block, with their counts,
    under ``record["kernels_launched"][section]``."""
    zero_launches()
    yield
    record["kernels_launched"][section] = {
        k: n for k, n in read_launches().items() if n}


def device_record(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"device": "cpu"}
    return {"device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(), "gpu": gpu_line(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def run(seed: int = 0, device="cuda", width: int = 1920, height: int = 1080,
        full: bool = True, profile: bool = False,
        cfg: AppConfig | None = None, vol: Volume | None = None,
        frames: int = 8) -> dict:
    """Measure every section on ``device`` and return the record.  ``cfg``
    (``AppConfig()`` by default) renders at ``width`` x ``height``; ``vol``
    defaults to the procedural cloud of ``seed``; ``frames`` online frames
    are timed after the first."""
    device = torch.device(device)
    t_run, cpu_run = time.perf_counter(), time.process_time()
    cfg = dataclasses.replace(cfg or AppConfig(), render_width=width,
                              render_height=height)
    n_rays = width * height
    record = {**device_record(device), "seed": seed, "width": width,
              "height": height, "log2_hashmap_size":
                  cfg.encoding.log2_hashmap_size,
              "compile_cache_entries_before": built_libraries(),
              "kernels_launched": {}}
    log(f"device: {record['device']}; build cache "
        f"{record['compile_cache_entries_before']} libraries")
    if vol is None:
        vol = Volume.from_dense(cloud_density(seed=seed), cfg.scene.density,
                                cfg.scene.volume_g, device=device)
    cam = Camera.reference_camera(aspect=width / height, device=device)

    # ---- the NRC online-training frame (the headline) ----
    r = NrcRenderer(cfg, vol)
    with launched(record, "online"):
        state = r.init_state(seed)
        t0 = time.perf_counter()
        state = r.step(state, cam, train=True)
        sync(device)
        record["compile_plus_first_frame_s"] = time.perf_counter() - t0
        built = built_libraries() - record["compile_cache_entries_before"]
        record["compile_cache_built_in_first_frame"] = built
        record["compile_cache_status"] = "cold" if built else "warm"
        dt, state = wall(lambda s: r.step(s, cam, train=True), frames,
                         state, device)
    record["nrc_online_ms_per_frame"] = dt * 1e3
    record["nrc_online_rays_per_s"] = n_rays / dt
    record["nrc_loss"] = float(state.nrc.loss)
    # bench.py's context row at 2^19 tables is this frame here
    record["nrc_online_2e19_ms_per_frame"] = record["nrc_online_ms_per_frame"]
    record["nrc_online_2e19_rays_per_s"] = record["nrc_online_rays_per_s"]
    log(f"compile+first frame: {record['compile_plus_first_frame_s']:.1f} s "
        f"({record['compile_cache_status']}: {built} libraries built)")
    log(f"nrc online: {dt * 1e3:.1f} ms/frame, {n_rays / dt:.3e} rays/s, "
        f"loss {record['nrc_loss']:.4f}")

    # ---- context: the frozen-cache frame ----
    if full:
        with launched(record, "frozen"):
            state = r.step(state, cam, train=False)
            sync(device)
            fdt, state = wall(lambda s: r.step(s, cam, train=False),
                              FROZEN_FRAMES, state, device)
        record["nrc_frozen_ms_per_frame"] = fdt * 1e3
        record["nrc_frozen_rays_per_s"] = n_rays / fdt
        log(f"nrc frozen: {fdt * 1e3:.1f} ms/frame, {n_rays / fdt:.3e} "
            f"rays/s")

    # ---- context: cache inference samples/s, compacted and full batch ----
    with launched(record, "inference"):
        inputs = infer_inputs(seed, N_INFER, n_rays, device)
        for key, x5 in zip(("nrc_infer", "nrc_infer_fullbatch"), inputs):
            n = x5.shape[0]
            ms = stage_ms(lambda x5=x5: r.cache.infer(state.nrc, x5), device,
                          INFER_REPS)
            record[f"{key}_ms"] = ms
            record[f"{key}_samples_per_s"] = n / (ms / 1e3)
            log(f"{key}: {ms:.3f} ms / {n} samples = "
                f"{n / (ms / 1e3):.3e} samples/s")

    # ---- context: the MC renderer ----
    if full:
        mc = McRenderer(cfg, vol)
        with launched(record, "mc32"):
            mst = mc.step(mc.init_state(seed), cam)
            sync(device)
            mdt, mst = wall(lambda s: mc.step(s, cam), MC_FRAMES, mst, device)
        record["mc32_ms_per_frame"] = mdt * 1e3
        record["mc32_rays_per_s"] = n_rays / mdt
        log(f"mc32: {mdt * 1e3:.1f} ms/frame, {n_rays / mdt:.3e} rays/s")

    # ---- context: the other operating point, 2^12 tables ----
    if full:
        r12 = NrcRenderer(tuned(cfg), vol)
        with launched(record, "nrc_online_2e12"):
            s12 = r12.step(r12.init_state(seed), cam, train=True)
            sync(device)
            tdt, s12 = wall(lambda s: r12.step(s, cam, train=True),
                            TUNED_FRAMES, s12, device)
        record["nrc_online_2e12_ms_per_frame"] = tdt * 1e3
        record["nrc_online_2e12_rays_per_s"] = n_rays / tdt
        log(f"nrc online (2^12 tables): {tdt * 1e3:.1f} ms/frame, "
            f"{n_rays / tdt:.3e} rays/s")

    # ---- context: the stage breakdown ----
    record["stages_ms"] = {
        "total": record["nrc_online_ms_per_frame"],
        "theoretical_fps": 1e3 / record["nrc_online_ms_per_frame"]}
    if full and profile:
        with launched(record, "stages"):
            record["stages_ms"] = profile_nrc_frame(r, state, cam)
        log(format_stage_report(record["stages_ms"]))

    record["host_cores"] = os.cpu_count()
    record["host_loadavg"] = list(os.getloadavg())
    # the host's share of the run: this process's CPU seconds (all its
    # threads) beside the run's wall seconds
    record["run_s"] = time.perf_counter() - t_run
    record["process_cpu_s"] = time.process_time() - cpu_run
    return record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="The port's benchmark on one CUDA GPU (bench.py's "
                    "metrics)")
    p.add_argument("--seed", type=int, default=0,
                   help="the cache init, the procedural cloud and the "
                        "inference inputs (seed+1, seed+2)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device; the benchmark runs only on a GPU",
              file=sys.stderr)
        return 1
    full = _flag("NRC_BENCH_FULL")
    record = run(seed=args.seed, full=full,
                 profile=full and _flag("NRC_BENCH_PROFILE", default="0"))
    os.makedirs(OUT_DIR, exist_ok=True)
    if "stages" in record["kernels_launched"]:
        with open(os.path.join(OUT_DIR, "stage_profile.json"), "w") as f:
            json.dump({"stages_ms": record["stages_ms"],
                       "device": record["device"],
                       "gpu": record["gpu"]}, f, indent=1)
    path = os.path.join(OUT_DIR, "bench_full.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    log(f"full metrics written to {path}")
    print(json.dumps({"metric": "nrc_online_rays_per_s_1080p",
                      "value": record["nrc_online_rays_per_s"],
                      "unit": "rays/s/chip"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
