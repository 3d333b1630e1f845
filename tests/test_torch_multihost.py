"""The port's multi-process worker (``python -m
nrc_hpm_tpu_torch.parallel.multihost``) on the CPU: two gloo processes,
each one rank of a group joined over TCP, with the JAX worker's
configuration and flags (64x32, two online steps from ``init_state(0)``);
against two ranks of the same renderer started by torch.multiprocessing
in this test (the port's other way to run two ranks), and against the
JAX package's ShardedNrcRenderer at mesh 2 in this process.

The scene is the 8^3 volume of tests/test_torch_frame.py written as a VDB
at the scene's ``volume_path`` in the workers' working directory (the
worker loads the configuration's cloud, as the JAX worker does).

Tolerances: the port's two runs within tests/test_multihost.py's
``atol=rtol=1e-5``; against JAX, see ``test_workers_match_jax_mesh_2``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from nrc_hpm_tpu import camera as jcam
from nrc_hpm_tpu import config as jcfg
from nrc_hpm_tpu.parallel.sharding import ShardedNrcRenderer, make_mesh
from nrc_hpm_tpu.volume import Volume as JVolume
from nrc_hpm_tpu_torch import config as tcfg
from nrc_hpm_tpu_torch.volume import Volume as TVolume

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharding_ranks as tsr  # noqa: E402
import torch_vdb_writer as vw  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, STEPS = 64, 32, 2


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _volume_data():
    return np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)


def _worker(root, pid, port):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "nrc_hpm_tpu_torch.parallel.multihost",
           "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
           "--process-id", str(pid), "--platform", "cpu", "--steps",
           str(STEPS), "--width", str(W), "--height", str(H), "--out",
           str(root / "img.npy")]
    return subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _config(mod):
    """The JAX worker's configuration (multihost.py:95-100)."""
    return mod.AppConfig(
        render_width=W, render_height=H,
        encoding=mod.EncodingConfig(log2_hashmap_size=14),
        log2_infer_batch_size=12, log2_train_batch_size=7,
        train_batch_count=2, mc_path_length=4, train_ray_length=4,
        max_track_steps=32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two worker processes and, meanwhile, two ranks spawned in this
    test with the worker's configuration: (image, the workers' outputs,
    the time file) and the spawned ranks' results."""
    root = tmp_path_factory.mktemp("multihost")
    vdb = root / tcfg.SceneConfig().volume_path
    vdb.parent.mkdir(parents=True)
    vw.write_vdb(str(vdb), [vw.Grid(_volume_data())])
    port = _free_port()
    procs = [_worker(root, pid, port) for pid in range(2)]
    try:
        cfg = _config(tcfg)
        vol = TVolume.from_vdb(str(vdb), cfg.scene.density,
                               cfg.scene.volume_g, device="cpu")
        spawned = tsr.spawn(2, str(tmp_path_factory.mktemp("ranks2")),
                            tsr.step_runs,
                            [("worker", cfg, vol, 0, True, STEPS)])
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n---\n".join(logs)
    return (np.load(root / "img.npy"), logs, root / "img.npy.time",
            spawned)


def test_workers_match_spawned_ranks(runs):
    """The worker's two processes joined over TCP against two ranks of
    the same configuration started by torch.multiprocessing."""
    img, _, _, spawned = runs
    assert img.shape == (H, W, 4) and np.isfinite(img).all()
    np.testing.assert_allclose(img, spawned[0]["worker"]["image"].numpy(),
                               atol=1e-5, rtol=1e-5)
    assert spawned[0]["worker"]["nrc"].step == 2 * STEPS


def test_rank_zero_reports_and_writes(runs):
    _, logs, time_file, spawned = runs
    loss = float(spawned[0]["worker"]["nrc"].loss)
    assert f"multihost: 2 processes, 2 devices" in logs[0]
    assert f"loss {loss:.4f}" in logs[0]
    assert "multihost:" not in logs[1]
    assert float(time_file.read_text()) > 0


def test_workers_match_jax_mesh_2(runs):
    """The JAX ShardedNrcRenderer at mesh 2 with the worker's
    configuration and steps on the same volume (the JAX worker itself
    loads the absent WDAS cloud).  The 64x6 bfloat16 MLP's activations
    flip by a bf16 ulp between XLA's and torch's CPU matmuls, and Adam's
    first steps spread that over the cache (ROADMAP.md §3): did-scatter on
    >= 99% of the pixels, and >= 99% of the pixels within 1e-3 +
    1e-2|ref|, chip_smoke.py's rule for bfloat16 cache terms."""
    cfg = _config(jcfg)
    vol = JVolume.from_dense(_volume_data(), cfg.scene.density,
                             cfg.scene.volume_g)
    r = ShardedNrcRenderer(cfg, mesh=make_mesh(2), vol=vol)
    cam = jcam.Camera.reference_camera(aspect=W / H)
    state = r.init_state(0)
    for _ in range(STEPS):
        state = r.step(state, cam, train=True)
    want = np.asarray(r.final_image(state))
    got = runs[0]
    scat = [np.abs(img[..., :3] - 0.1).max(-1) > 1e-6 for img in (got, want)]
    agree = (scat[0] == scat[1]).mean()
    assert agree >= 0.99, f"did_scatter agrees on {agree:.4f}"
    close = (np.abs(got - want) <= 1e-3 + 1e-2 * np.abs(want)).all(-1)
    assert close.mean() >= 0.99, f"{close.mean():.4f} of pixels close"
