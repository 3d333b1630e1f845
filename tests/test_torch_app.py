"""The port's application (``nrc_hpm_tpu_torch.app.main``) against the
JAX package's, both run with ``--platform cpu`` at 48x27 from a working
directory that holds a cloud written by tests/torch_vdb_writer.py at the
scene's ``volume_path`` and a golden at ``reference/4/0.exr`` (made by
the port's ``generate_golden`` on that cloud), with the reference's 17
positional arguments cut to a 16x2 MLP, 2 x 64 train samples and 4-bounce
train paths, and 4 hash levels at 2^12: ``--renderer both`` for two
frames, a camera path that moves on frame 1, the golden compared every
other frame, the EXRs exported.

Checked: ``log.txt`` and ``metrics.jsonl`` have the JAX app's format
(the same records with the same keys, one log line per compared frame);
the first frames' loss within 1e-4 relative and the exported MC image
under the frame tests' rule (did-scatter agrees on >= 99% of pixels, the
image within 1e-3 there), as tests/test_torch_train.py and
test_torch_mc_renderer.py hold them; the port's run with ``--mesh 1``
(the sharded renderer on a one-rank group) equals its run without,
bitwise, and with ``--mesh 2`` on two spawned ranks agrees with it;
without ``--platform cpu`` the app needs the card; ``--mesh 2`` without
a group of two ranks refuses.  The port's other runs are in
test_torch_app_runs.py, the ``--renderer restir`` runs in
test_torch_app_restir.py."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from nrc_hpm_tpu import app as japp
from nrc_hpm_tpu_torch import app as tapp
from nrc_hpm_tpu_torch.config import AppConfig
from nrc_hpm_tpu_torch.utils.exr import read_exr_rgba

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharding_ranks as tsr  # noqa: E402
import torch_vdb_writer as vw  # noqa: E402

W, H = 48, 27
ARGV = ["RelativeL2Luminance", "Adam", "0.01", "0.99", "0", "0", "16", "2",
        "21", "6", "2", "4", "1.0", "1", "1", "0.0", "4"]
FLAGS = ["--platform", "cpu", "--width", str(W), "--height", str(H),
         "--log2-hashmap", "12", "--n-levels", "4"]
PATH = {"commands": [{"frame": 1, "keys": "W"}]}


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [line.split() for line in f]


def make_scene() -> None:
    """The working directory of a run: the cloud at the scene's
    volume_path, a 2-frame golden of it at reference/4/0.exr, a camera
    path."""
    from nrc_hpm_tpu_torch.reference import generate_golden
    from nrc_hpm_tpu_torch.utils.procedural import cloud_density

    vdb = AppConfig().scene.volume_path
    os.makedirs(os.path.dirname(vdb))
    vw.write_vdb(vdb, [vw.Grid(cloud_density(0, (40, 27, 48)))])
    with open("path.json", "w") as f:
        json.dump(PATH, f)
    generate_golden(AppConfig(), "reference/4/0.exr", frames=2,
                    path_length=8, width=W, height=H, device="cpu")


def run_in(root, fn):
    """``fn()`` with ``root`` as the working directory and JAX's
    persistent compilation cache off."""
    old_cwd, old_env = os.getcwd(), os.environ.get("NRC_NO_COMPILE_CACHE")
    os.chdir(root)
    os.environ["NRC_NO_COMPILE_CACHE"] = "1"
    try:
        return fn()
    finally:
        os.chdir(old_cwd)
        if old_env is None:
            os.environ.pop("NRC_NO_COMPILE_CACHE")
        else:
            os.environ["NRC_NO_COMPILE_CACHE"] = old_env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both apps' runs from one working directory: {name: out dir}."""
    root = tmp_path_factory.mktemp("app")
    argv = ARGV + FLAGS + ["--frames", "2", "--benchmark-every", "2",
                           "--camera-path", "path.json", "--export-exr"]

    def both():
        make_scene()
        assert japp.main(argv + ["--out", "jax"]) == 0
        assert tapp.main(argv + ["--out", "port"]) == 0
        assert tapp.main(argv + ["--mesh", "1", "--out", "mesh1"]) == 0

    run_in(root, both)
    # two ranks, each its own process, each writing to --out rank<k>
    assert tsr.spawn(2, str(tmp_path_factory.mktemp("mesh2")), tsr.app_main,
                     str(root), argv + ["--mesh", "2"]) == [0, 0]
    return {k: str(root / k) for k in ("jax", "port", "mesh1", "rank0",
                                       "rank1")}


def _keys(rec):
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in rec.items()}


def test_logs_have_the_jax_format(runs):
    t, j = _records(runs["port"]), _records(runs["jax"])
    assert [_keys(r) for r in t] == [_keys(r) for r in j]
    # compared every 2 frames: frame 0
    assert [(r["frame"], "nrc" in r, "mc" in r) for r in t] == \
        [(0, True, True), (1, False, False)]
    assert {"loss", "nrc", "mc", "frame_time_ms"} <= set(t[0])
    (tline,), (jline,) = _log(runs["port"]), _log(runs["jax"])
    assert len(tline) == len(jline) == 4 and tline[0] == jline[0] == "0"
    assert [float(v) for v in tline[1:]] == [
        t[0]["nrc"]["mse"], t[0]["nrc"]["rel_bias"], t[0]["nrc"]["cv"]]
    for name in ("nrc", "mc"):
        assert all(np.isfinite(v) for v in t[0][name].values())


def test_first_frames_match_jax(runs):
    t, j = _records(runs["port"]), _records(runs["jax"])
    for a, b in zip(t, j):
        assert np.isfinite(a["loss"])
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    timg = read_exr_rgba(os.path.join(runs["port"], "mc.exr"))
    jimg = read_exr_rgba(os.path.join(runs["jax"], "mc.exr"))
    assert timg.shape == jimg.shape == (H, W, 4)
    assert np.isfinite(timg).all()
    agree = timg[..., 3] == jimg[..., 3]
    assert agree.mean() >= 0.99, f"did_scatter agrees on {agree.mean():.4f}"
    assert np.abs(timg - jimg).max(-1)[agree].max() <= 1e-3
    # the camera moved on frame 1: the accumulation restarted, so the
    # image is that one frame's (its scatter channel is 0 or 1)
    assert set(np.unique(timg[..., 3])) <= {0.0, 1.0}
    nrc = read_exr_rgba(os.path.join(runs["port"], "nrc.exr"))
    assert nrc.shape == (H, W, 4) and np.isfinite(nrc).all()


def test_mesh_one_runs_like_the_single_device_app(runs):
    """``--mesh 1``: the sharded renderer on a one-rank group of the
    app's own process, which it tears down after; the same records, and
    the losses and the exported images equal to the run without a
    mesh's."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    t, m = _records(runs["port"]), _records(runs["mesh1"])
    assert [_keys(r) for r in m] == [_keys(r) for r in t]
    assert [r["loss"] for r in m] == [r["loss"] for r in t]
    assert m[0]["nrc"] == t[0]["nrc"] and m[0]["mc"] == t[0]["mc"]
    for name in ("nrc.exr", "mc.exr"):
        a = read_exr_rgba(os.path.join(runs["mesh1"], name))
        b = read_exr_rgba(os.path.join(runs["port"], name))
        assert a.shape == (H, W, 4) and a.tobytes() == b.tobytes(), name


def test_mesh_two_runs_on_two_ranks(runs):
    """``--mesh 2`` on a group of two ranks (processes spawned here): rank
    0 alone writes, the records as the single-device run's, the first
    frame's loss (the same cache and targets, summed over two ranks)
    within 1e-4 relative and the exported NRC image under the frame rule
    (did-scatter on >= 99% of the pixels, within 1e-3 there); the MC
    image is rank 0's single-device MC frame."""
    assert not os.path.exists(runs["rank1"])
    t, m = _records(runs["port"]), _records(runs["rank0"])
    assert [_keys(r) for r in m] == [_keys(r) for r in t]
    np.testing.assert_allclose(m[0]["loss"], t[0]["loss"], rtol=1e-4)
    assert m[0]["mc"] == t[0]["mc"]
    a = read_exr_rgba(os.path.join(runs["rank0"], "nrc.exr"))
    b = read_exr_rgba(os.path.join(runs["port"], "nrc.exr"))
    assert a.shape == b.shape == (H, W, 4)
    scat = [np.abs(img[..., :3] - 0.1).max(-1) > 1e-6 for img in (a, b)]
    agree = scat[0] == scat[1]
    assert agree.mean() >= 0.99
    assert np.abs(a - b).max(-1)[agree].max() <= 1e-3
    for name in ("mc.exr", "log.txt"):
        assert os.path.exists(os.path.join(runs["rank0"], name))


def test_refusals(monkeypatch):
    # no process group of 2 ranks to join: the error names torchrun
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        tapp.main(ARGV + FLAGS + ["--mesh", "2"])
    assert tapp.build_argparser().parse_args([]).platform == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.main(ARGV + ["--frames", "1"])
