"""Multi-process execution: one worker process per rank, joined over TCP.

Port of ``nrc_hpm_tpu/parallel/multihost.py``.  The JAX worker joins
``jax.distributed`` and spans one device mesh over its processes; here
each process is one rank of a ``torch.distributed`` process group (NCCL
on the card, gloo on the CPU) that drives one device and renders its own
rows with ``ShardedNrcRenderer``.  Every rank's work is a function of
global screen coordinates and the frame seed, so the only traffic between
processes is the gradient all-reduce and the final image's all-gather.

Run one worker per process, e.g. two on the CPU:

  python -m nrc_hpm_tpu_torch.parallel.multihost --coordinator \
      127.0.0.1:29500 --num-processes 2 --process-id 0 --platform cpu \
      [--steps N] [--width W] [--height H] [--out img.npy]

(and ``--process-id 1`` in a second process).  On the card
(``--platform cuda``, the default) process i drives
``cuda:(i % device_count)``.  The worker reads the scene's cloud from the
working directory, as the app does.
"""

from __future__ import annotations

import argparse
import sys


def initialize(coordinator: str, num_processes: int, process_id: int,
               device="cuda") -> None:
    """Join the process group at ``tcp://coordinator`` as rank
    ``process_id`` of ``num_processes``: NCCL on a CUDA ``device`` (this
    process's card set current first), gloo on the CPU."""
    import torch
    import torch.distributed as dist

    backend = "gloo"
    if torch.device(device).type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def run_worker(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--out", default=None,
                   help="process 0 writes the final gathered image (npy) "
                        "here and the step time to OUT.time")
    args = p.parse_args(argv)

    import time

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..camera import Camera
    from ..config import AppConfig, EncodingConfig
    from .sharding import ShardedNrcRenderer

    device = torch.device("cpu")
    if args.platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --platform cpu for a "
                               "run on the CPU")
        device = torch.device(
            "cuda", args.process_id % torch.cuda.device_count())
    initialize(args.coordinator, args.num_processes, args.process_id,
               device)
    try:
        cfg = AppConfig(
            render_width=args.width, render_height=args.height,
            encoding=EncodingConfig(log2_hashmap_size=14),
            log2_infer_batch_size=12, log2_train_batch_size=7,
            train_batch_count=2, mc_path_length=4, train_ray_length=4,
            max_track_steps=32)
        r = ShardedNrcRenderer(cfg, group=dist.group.WORLD, device=device)
        cam = Camera.reference_camera(aspect=args.width / args.height,
                                      device=device)
        state = r.init_state(0)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        sync()
        t0 = time.time()
        for _ in range(args.steps):
            state = r.step(state, cam, train=True)
        sync()
        dt = (time.time() - t0) / max(args.steps, 1)
        img = r.final_image(state)
        # the loss is replicated on every rank
        loss = float(state.nrc.loss)
        if dist.get_rank() == 0:
            print(f"multihost: {dist.get_world_size()} processes, "
                  f"{dist.get_world_size()} devices, {dt * 1e3:.1f} "
                  f"ms/step, loss {loss:.4f}", flush=True)
            if args.out:
                np.save(args.out, img.cpu().numpy())
                with open(args.out + ".time", "w") as f:
                    f.write(f"{dt}\n")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(run_worker())
