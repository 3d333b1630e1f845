"""The port's application with ``--renderer restir`` against the JAX
package's, both with ``--platform cpu`` at 48x27 from one working
directory made as in test_torch_app.py (the written cloud at the scene's
volume_path, a golden, a camera path that moves on frame 1): three
frames with the default ReSTIR (8 vertices, 3x3, 2 slots, MIS), the
camera cut clearing the temporal history, ``restir.exr`` exported; and
the port's run from the command line, as a user starts it.

Checked: ``log.txt`` and ``metrics.jsonl`` have the JAX app's format (the
same records with the same keys; a ReSTIR run records no loss and no
comparison, so it writes no log line); the exported image of each app has 99% of its
pixels within 1e-3 + 1e-3|ref| of the other's (the ReSTIR frame rule of
test_torch_restir.py, whose stats the EXR does not carry) and its
never-scattered pixels the env colour exactly."""

import os
import subprocess
import sys

import numpy as np
import pytest

from nrc_hpm_tpu import app as japp
from nrc_hpm_tpu_torch import app as tapp
from nrc_hpm_tpu_torch.utils.exr import read_exr_rgba
from test_torch_app import (ARGV, FLAGS, H, W, _keys, _log, _records,
                            make_scene, run_in)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both apps' ReSTIR runs from one working directory: {name: dir}."""
    root = tmp_path_factory.mktemp("app_restir")
    argv = ARGV + FLAGS + ["--renderer", "restir", "--frames", "3",
                           "--camera-path", "path.json", "--export-exr"]

    def both():
        make_scene()
        assert japp.main(argv + ["--out", "jax"]) == 0
        assert tapp.main(argv + ["--out", "port"]) == 0

    run_in(root, both)
    return {k: str(root / k) for k in ("jax", "port")} | {"root": str(root)}


def test_restir_logs_have_the_jax_format(runs):
    t, j = _records(runs["port"]), _records(runs["jax"])
    assert [_keys(r) for r in t] == [_keys(r) for r in j]
    assert [r["frame"] for r in t] == [0, 1, 2]
    assert all("loss" not in r and r["frame_time_ms"] > 0 for r in t)
    assert _log(runs["port"]) == _log(runs["jax"]) == []


def test_restir_exr_matches_jax(runs):
    timg = read_exr_rgba(os.path.join(runs["port"], "restir.exr"))
    jimg = read_exr_rgba(os.path.join(runs["jax"], "restir.exr"))
    assert timg.shape == jimg.shape == (H, W, 4)
    assert np.isfinite(timg).all()
    ok = (np.abs(timg - jimg) <= 1e-3 + 1e-3 * np.abs(jimg)).all(-1)
    assert ok.mean() >= 0.99, f"restir.exr agrees on {ok.mean():.4f}"
    # the border rays miss the box: the env colour, transmittance 1
    assert np.array_equal(timg[0, 0], np.float32([0.1, 0.1, 0.1, 1.0]))
    shaded = timg[..., 3] < 1.0
    assert 0.05 < shaded.mean() < 0.95
    assert (timg[shaded, :3].sum(-1) > 0).mean() > 0.9


def test_restir_app_from_the_command_line(runs):
    """``python -m nrc_hpm_tpu_torch.app --renderer restir --platform cpu
    --frames 2 --width 48 --height 27 --export-exr`` from the working
    directory that holds the written cloud."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run(
        [sys.executable, "-m", "nrc_hpm_tpu_torch.app", "--renderer",
         "restir", "--platform", "cpu", "--frames", "2", "--width", str(W),
         "--height", str(H), "--export-exr", "--out", "cli"],
        cwd=runs["root"], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "frame 1:" in res.stdout
    img = read_exr_rgba(os.path.join(runs["root"], "cli", "restir.exr"))
    assert img.shape == (H, W, 4) and np.isfinite(img).all()
