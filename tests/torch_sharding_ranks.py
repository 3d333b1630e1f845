"""Ranks of a gloo process group on the CPU, for the sharding tests.

``spawn(n, tmp_dir, fn, *args)`` starts ``n`` processes
(``torch.multiprocessing``, the spawn method), joins them in one gloo
group over a ``FileStore`` under ``tmp_dir``, runs ``fn(group, rank,
*args)`` on every rank and returns the ranks' results in rank order.
``step_runs`` steps the port's ``ShardedNrcRenderer`` through each run of
a list; ``app_main`` runs the port's app from a working directory.  Torch
only: the ranks import no JAX.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(n: int, tmp_dir: str, fn, *args) -> list:
    store = os.path.join(tmp_dir, "store")
    mp.start_processes(_rank_main, args=(n, store, tmp_dir, fn, args),
                       nprocs=n, join=True, start_method="spawn")
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]


def _rank_main(rank: int, n: int, store: str, tmp_dir: str, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=n)
    try:
        out = fn(dist.group.WORLD, rank, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp_dir, f"rank{rank}.pt"))


def step_runs(group, rank: int, runs: list) -> dict:
    """``{name: step_run(...)}`` of runs ``(name, cfg, vol, start, train[,
    steps])``."""
    return {name: step_run(group, rank, *run) for name, *run in runs}


def step_run(group, rank: int, cfg, vol, start, train: bool,
             steps: int = 1) -> dict:
    """``steps`` steps (``train``) of this rank's renderer of ``cfg`` on
    ``vol`` from ``start``, a seed for ``init_state`` or a list of
    per-rank ``NrcRenderState``: the gathered and the local image, the
    cache state and key, the ring, the layout."""
    from nrc_hpm_tpu_torch.camera import Camera
    from nrc_hpm_tpu_torch.parallel.sharding import ShardedNrcRenderer

    r = ShardedNrcRenderer(cfg, group=group, vol=vol, device="cpu")
    state = r.init_state(start) if isinstance(start, int) else start[rank]
    cam = Camera.reference_camera(
        aspect=cfg.render_width / cfg.render_height, device="cpu")
    st = state
    for _ in range(steps):
        st = r.step(st, cam, train=train)
    return dict(image=r.final_image(st), local=st.image, nrc=st.nrc,
                key=st.key, head=int(st.ring.head), tail=int(st.ring.tail),
                ring=st.ring.data, pad_h=r.pad_h, local_h=r.local_h,
                bs_l=r._bs_l, padded_train=r._padded_train)


def app_main(group, rank: int, cwd: str, argv: list) -> int:
    """``app.main(argv + ["--out", "rank<k>"])`` from ``cwd``, on the
    initialized group."""
    from nrc_hpm_tpu_torch import app

    os.chdir(cwd)
    return app.main(argv + ["--out", f"rank{rank}"])
