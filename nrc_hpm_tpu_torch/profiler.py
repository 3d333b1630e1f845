"""Per-frame stage profiler: the reference's 8-query timestamp pool.

Port of ``nrc_hpm_tpu/profiler.py``.  The reference brackets every NRC
frame with timestamp queries and reports per-stage milliseconds plus
"theoretical FPS".  Here each stage runs in isolation on the renderer's
device, on the inputs one frame from the caller's state would give it:
on the card timed by CUDA events around the call, on the CPU by the host
clock; one warm-up call, then the median of ``reps`` calls.  Every stage
builds new tensors, so the caller's state is read and never written.

Stage taxonomy (the JAX package's keys):
  clear        ring head/tail wrap
  gen_rays     primary short paths + NRC query export (``primary_pass``)
  prep_infer   5-float NrcInput pack
  filter       scattered-pixel compaction index (``torch.nonzero``)
  nn_infer     cache inference on the scattered pixels
  prep_train   train rays, long paths, ring push, pack
  nn_train     the frame's optimizer steps
  nn           nn_infer + nn_train
  render       composite + temporal blend
``stage_sum`` adds the stages.  ``total`` is a real ``step`` (training)
with the same arguments, timed the same way, and ``theoretical_fps`` is
1000 / total; stages timed apart need not add up to it.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Dict

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str = os.path.join("output_torch", "trace")):
    """Wrap a region in torch.profiler (the host and, where there is one,
    the card) and write its Chrome trace to ``<log_dir>/trace.json``: the
    kernel-level complement to the stage taxonomy below."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _stage_ms(fn, device: torch.device, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls after one
    warm-up: CUDA events on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_nrc_frame(renderer, state, camera,
                      reps: int = 3) -> Dict[str, float]:
    """Profile one NRC frame stage by stage.  Returns {stage: ms} plus
    'total' (a real training step) and 'theoretical_fps' = 1000/total."""
    from .camera import pixel_rays
    from .renderer import infer_filtered, pack_nrc_inputs, primary_pass
    from .ring_buffer import ring_wrap
    from .utils import prng, rng

    r = renderer
    cfg, vol = r.cfg, r.vol
    device = torch.device(r.device)
    n = r.height * r.width

    _, sub = prng.split(state.key)
    frame_rand = rng.frame_random(sub)
    ro, rd, frag_uv = pixel_rays(camera, r.width, r.height)
    rng_state = rng.init_state(frag_uv, frame_rand).reshape(n)
    o, d = ro.expand(n, 3), rd.reshape(n, 3)

    def timed(fn):
        return _stage_ms(fn, device, reps)

    def gen():
        return primary_pass(rng_state, vol, r.lights, r.primary_params, cfg,
                            o, d)

    out: Dict[str, float] = {}
    out["clear"] = timed(lambda: ring_wrap(state.ring))
    out["gen_rays"] = timed(gen)
    prim = gen()
    out["prep_infer"] = timed(
        lambda: pack_nrc_inputs(vol, prim["nrc_pos"], prim["nrc_dir"]))
    x5 = pack_nrc_inputs(vol, prim["nrc_pos"], prim["nrc_dir"])
    scat = prim["did_scatter"]
    out["filter"] = timed(lambda: torch.nonzero(scat))
    out["nn_infer"] = timed(
        lambda: infer_filtered(r.cache, state.nrc, x5, scat))

    ring = ring_wrap(state.ring)
    out["prep_train"] = timed(
        lambda: r.train_set(state.nrc, ring, prim, frame_rand))
    _, train_x5, target = r.train_set(state.nrc, ring, prim, frame_rand)
    out["nn_train"] = timed(
        lambda: r.cache.train_frame(state.nrc, train_x5, target))
    out["nn"] = out["nn_infer"] + out["nn_train"]

    nrc_rgb = infer_filtered(r.cache, state.nrc, x5, scat)
    out["render"] = timed(lambda: r.composite(state, prim, nrc_rgb))

    out["total"] = timed(lambda: r.step(state, camera, train=True))
    out["theoretical_fps"] = 1000.0 / max(out["total"], 1e-9)
    out["stage_sum"] = sum(out[k] for k in (
        "clear", "gen_rays", "prep_infer", "filter", "nn_infer",
        "prep_train", "nn_train", "render"))
    return out


def format_stage_report(stages: Dict[str, float]) -> str:
    """Human-readable per-stage table (the reference's frame panel)."""
    order = ["clear", "gen_rays", "prep_infer", "filter", "prep_train",
             "nn_infer", "nn_train", "nn", "render", "stage_sum", "total"]
    lines = ["frame stage breakdown (ms):"]
    for k in order:
        if k in stages:
            lines.append(f"  {k:<12s} {stages[k]:9.2f}")
    if "theoretical_fps" in stages:
        lines.append(f"  theoretical FPS: {stages['theoretical_fps']:.2f}")
    return "\n".join(lines)
