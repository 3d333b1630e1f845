"""Application entry point: the reference's main loop, headless.

Port of ``nrc_hpm_tpu/app.py``, the same flags, defaults and frame loop:
- the 17 positional experiment args (or the built-in defaults when
  absent), plus optional ``--flag`` overrides;
- output_torch/<configName>/ with log.txt benchmark lines and
  metrics.jsonl (the JAX app writes under output/; the port keeps its
  runs apart), opened once the scene has loaded;
- per frame: NRC render (+ online training), optional MC render, golden
  comparison for both, NaN/Inf-loss abort;
- EXR export of the accumulated images on exit and checkpointing of the
  trained cache.

``--renderer restir`` runs the ReSTIR renderer instead (its temporal
history cleared on a camera cut; ``restir.exr`` on export).  It runs on
the card (``--platform cuda``, the default) and fails where there is
none; ``--platform cpu`` runs the plain versions on the CPU.

``--mesh N`` (N > 0) renders the NRC frames with ``ShardedNrcRenderer``
over a process group of N ranks (``parallel.sharding.make_group``): one
process per rank, started by ``torchrun --nproc-per-node N -m
nrc_hpm_tpu_torch.app --mesh N ...`` (``--mesh 1`` also runs alone).
Every rank runs the frame loop, the golden compares and the export,
which gather the image; rank 0 alone runs the MC and ReSTIR renderers,
prints, and writes the logs, EXRs and checkpoint.  ``--profile`` is
skipped under a mesh, as the JAX app skips it.

Usage:
  python -m nrc_hpm_tpu_torch.app [17 positional args] [--frames N]
      [--width W] [--height H] [--renderer nrc|mc|both|restir]
      [--benchmark-every K] [--platform cuda|cpu] [--mesh N] [--out DIR]
      [--checkpoint PATH] [--load-checkpoint PATH] [--export-exr]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="NRC-HPM renderer (PyTorch + CUDA port)",
        usage=__doc__)
    p.add_argument("config_args", nargs="*",
                   help="the reference's 17 positional experiment args")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--renderer", choices=("nrc", "mc", "both", "restir"),
                   default="both")
    p.add_argument("--benchmark-every", type=int, default=1,
                   help="compare against the golden every K frames "
                        "(the reference benchmarks every frame)")
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard the NRC frames over a process group of N "
                        "ranks (0 = single device)")
    p.add_argument("--out", default=None, help="output directory")
    p.add_argument("--checkpoint", default=None,
                   help="save the trained cache state here on exit")
    p.add_argument("--load-checkpoint", default=None)
    p.add_argument("--no-train", action="store_true",
                   help="frozen-cache rendering")
    p.add_argument("--export-exr", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="print the per-stage frame breakdown (the "
                        "reference's 8-query timestamp pool) of real "
                        "frames before the run, and write one more frame's "
                        "profiler trace to <out>/trace/trace.json")
    p.add_argument("--compare-accumulated", action="store_true",
                   help="compare the accumulated on-screen image instead "
                        "of a fresh ref-camera frame (NOT the reference's "
                        "Reference::CompareNrc semantics; cheaper)")
    p.add_argument("--target-clamp", type=float, default=None,
                   help="train-target radiance clamp override "
                        "(reference parity: 8.0)")
    p.add_argument("--tpu-tuned", action="store_true",
                   help="use the JAX package's TPU operating point "
                        "(AppConfig.tpu_tuned: 2^12 hash tables)")
    p.add_argument("--log2-hashmap", type=int, default=0,
                   help="override the hash-grid table size (reference "
                        "default 19)")
    p.add_argument("--n-levels", type=int, default=0,
                   help="override the hash-grid level count (default 16)")
    p.add_argument("--env-fixed16", action="store_true",
                   help="golden-era env transmittance: 16-step "
                        "GetTransmittance for the env in-scatter term "
                        "(config.env_fixed16)")
    p.add_argument("--cache-bootstrap", action="store_true",
                   help="terminate surviving train paths into the EMA "
                        "cache (config.train_cache_bootstrap; default off)")
    p.add_argument("--camera-path", default=None,
                   help="JSON camera-path script replayed through the "
                        "reference's camera-controller semantics "
                        "(camera_path.py)")
    return p


def _config(args):
    from .config import DEFAULT_ARGV, AppConfig

    if args.config_args:
        cfg = AppConfig.from_argv(args.config_args)
    else:
        print("No arguments found. Loading defaults")
        cfg = AppConfig.from_argv(DEFAULT_ARGV)
    if args.tpu_tuned:
        cfg = dataclasses.replace(
            cfg, encoding=dataclasses.replace(cfg.encoding,
                                              log2_hashmap_size=12))
    if args.log2_hashmap:
        cfg = dataclasses.replace(
            cfg, encoding=dataclasses.replace(
                cfg.encoding, log2_hashmap_size=args.log2_hashmap))
    if args.n_levels:
        cfg = dataclasses.replace(
            cfg, encoding=dataclasses.replace(cfg.encoding,
                                              n_levels=args.n_levels))
    if args.cache_bootstrap:
        cfg = dataclasses.replace(cfg, train_cache_bootstrap=True)
    if args.target_clamp is not None:
        cfg = dataclasses.replace(cfg, train_target_clamp=args.target_clamp)
    if args.env_fixed16:
        cfg = dataclasses.replace(cfg, env_fixed16=True)
    if args.width or args.height:
        cfg = dataclasses.replace(
            cfg, render_width=args.width or cfg.render_width,
            render_height=args.height or cfg.render_height)
    return cfg


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import torch
    import torch.distributed as dist

    device = torch.device(args.platform)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the app runs on the card; pass "
                           "--platform cpu for a run on the CPU")
    if not args.mesh:
        return _run(args, device, None)
    from .parallel.sharding import rank_device, make_group
    device = rank_device(device)
    owns_group = not dist.is_initialized()
    group = make_group(args.mesh, device)
    try:
        return _run(args, device, group)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _run(args, device, group) -> int:
    """The frame loop on ``device``; under a mesh on this process's rank
    of ``group``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from .camera import Camera
    from .reference import GoldenReference, _renderer_image
    from .renderer import McRenderer, NrcRenderer, reset_accumulation
    from .utils.metrics import RunLogger

    # under a mesh every rank renders its rows and joins the collectives;
    # rank 0 alone runs the unsharded renderers, prints and writes
    lead = group is None or dist.get_rank(group) == 0
    say = print if lead else (lambda *a, **k: None)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg = _config(args)
    out_dir = args.out or os.path.join("output_torch", cfg.name())
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    mesh = "" if group is None else \
        f"; mesh of {dist.get_world_size(group)} ranks"
    say(f"device: {name}{mesh}; output: {out_dir}")

    aspect = cfg.render_width / cfg.render_height
    cam = Camera.reference_camera(aspect=aspect, device=device)
    cam_player = None
    if args.camera_path:
        from .camera_path import CameraPath
        cam_player = CameraPath.load(args.camera_path).player(aspect,
                                                              device=device)
        cam = cam_player.camera

    golden = None
    try:
        golden = GoldenReference.load(cfg.scene.id, device=device)
    except FileNotFoundError:
        say(f"no golden image for scene {cfg.scene.id}; "
            "comparisons disabled")

    # renderers -----------------------------------------------------------
    nrc_renderer = nrc_state = None
    mc_renderer = mc_state = None
    if args.renderer in ("nrc", "both"):
        if group is not None:
            from .parallel.sharding import ShardedNrcRenderer
            nrc_renderer = ShardedNrcRenderer(cfg, group=group,
                                              device=device)
        else:
            nrc_renderer = NrcRenderer(cfg, device=device)
        nrc_state = nrc_renderer.init_state(0)
        if args.load_checkpoint:
            from .utils.checkpoint import load_pytree
            nrc_state = dataclasses.replace(
                nrc_state, nrc=load_pytree(args.load_checkpoint,
                                           nrc_state.nrc, device=device))
            say(f"loaded cache checkpoint {args.load_checkpoint}")
    if args.renderer in ("mc", "both") and lead:
        mc_renderer = McRenderer(cfg, device=device)
        mc_state = mc_renderer.init_state(0)
    restir_renderer = restir_state = None
    if args.renderer == "restir" and lead:
        from .models.restir import RestirRenderer
        # each frame alone, as the JAX app shows it
        restir_renderer = RestirRenderer(cfg, device=device, blend=False)
        restir_state = restir_renderer.init_state(0)

    # opened only now, so a run that fails to load its scene leaves the
    # logs of an earlier run as they were
    logger = RunLogger(out_dir) if lead else None

    if args.profile and nrc_renderer is not None and group is None:
        from .profiler import format_stage_report, profile_nrc_frame
        stages = profile_nrc_frame(nrc_renderer, nrc_state, cam,
                                   trace_dir=os.path.join(out_dir, "trace"))
        print(format_stage_report(stages), flush=True)
        logger.event("stage_profile", **{k: round(v, 3)
                                         for k, v in stages.items()})

    train = not args.no_train
    t_start = time.time()
    frame = -1
    last_t = time.time()
    for frame in range(args.frames):
        t0 = time.time()
        # HpmScene::Update: dynamic scenes animate the dir light
        if cfg.scene.dynamic:
            from .lights import update_scene
            dt_s = t0 - last_t
            for r in (nrc_renderer, mc_renderer, restir_renderer):
                if r is not None:
                    r.lights = update_scene(r.lights, cfg.scene, dt_s)
        last_t = t0
        if cam_player is not None:
            # a camera change restarts the progressive accumulation
            cam, cam_changed = cam_player.update(frame)
            if cam_changed:
                if nrc_state is not None:
                    nrc_state = reset_accumulation(nrc_state)
                if mc_state is not None:
                    mc_state = reset_accumulation(mc_state)
                if restir_state is not None:
                    # also its temporal-reuse ring and frame counter
                    restir_state = reset_accumulation(restir_state)
        if nrc_renderer is not None:
            nrc_state = nrc_renderer.step(nrc_state, cam, train=train)
        if mc_renderer is not None:
            mc_state = mc_renderer.step(mc_state, cam)
        if restir_renderer is not None:
            restir_state = restir_renderer.step(restir_state, cam)
        sync()
        frame_ms = (time.time() - t0) * 1000.0

        loss = float(nrc_state.nrc.loss) if nrc_renderer is not None else None
        nrc_cmp = mc_cmp = None
        if (golden is not None and args.benchmark_every > 0
                and frame % args.benchmark_every == 0):
            if args.compare_accumulated:
                # score the on-screen accumulation (valid while the camera
                # is static; NOT reference-comparable per frame)
                if nrc_renderer is not None:
                    nrc_cmp = golden.compare(
                        _renderer_image(nrc_renderer, nrc_state))
                if mc_renderer is not None:
                    mc_cmp = golden.compare(mc_state.image)
            else:
                # Reference::CompareNrc/CompareMc: one fresh frame with the
                # stored ref camera, accumulation cleared, training off;
                # the caller's state is untouched
                if nrc_renderer is not None:
                    nrc_cmp = golden.compare_nrc(nrc_renderer, nrc_state)
                if mc_renderer is not None:
                    mc_cmp = golden.compare_mc(mc_renderer, mc_state)
        if logger is not None:
            logger.frame(frame, frame_ms, loss=loss, nrc_cmp=nrc_cmp,
                         mc_cmp=mc_cmp)

        msg = f"frame {frame}: {frame_ms:.1f} ms"
        if loss is not None:
            msg += f", loss {loss:.4f}"
        if nrc_cmp is not None:
            msg += (f", nrc mse {nrc_cmp.mse:.5f} relBias "
                    f"{nrc_cmp.rel_bias:+.4f} cv {nrc_cmp.cv:.3f}")
        if mc_cmp is not None:
            msg += f", mc mse {mc_cmp.mse:.5f}"
        say(msg, flush=True)

        # NaN/Inf loss abort (the loss is replicated: every rank stops)
        if loss is not None and not math.isfinite(loss):
            say("Loss is NaN or Inf — aborting")
            break

    total = time.time() - t_start
    if frame >= 0 and total > 0:
        say(f"{frame + 1} frames in {total:.1f}s "
            f"({(frame + 1) / total:.2f} fps)")

    if args.export_exr:
        from .utils.exr import write_exr

        def host(img):
            return np.asarray(img.detach().cpu().numpy(), np.float32)

        if nrc_state is not None:
            # gathered on every rank
            nrc_img = host(_renderer_image(nrc_renderer, nrc_state))
        if lead:
            if nrc_state is not None:
                write_exr(os.path.join(out_dir, "nrc.exr"), nrc_img)
            if mc_state is not None:
                write_exr(os.path.join(out_dir, "mc.exr"),
                          host(mc_state.image))
            if restir_state is not None:
                write_exr(os.path.join(out_dir, "restir.exr"),
                          host(restir_state.image))
            print(f"exported EXRs to {out_dir}")

    if args.checkpoint and nrc_state is not None and lead:
        from .utils.checkpoint import save_pytree
        save_pytree(args.checkpoint, nrc_state.nrc)
        print(f"saved cache checkpoint {args.checkpoint}")

    if logger is not None:
        logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
