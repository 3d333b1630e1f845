"""bench_torch.py, the port's benchmark, on the CPU.

Its inference inputs are bench.py's bit for bit; a small run records
every key of bench.py's record on the device it ran on; that run's online
frames are the JAX package's frames from the same seed (the tolerances of
``tests/test_torch_train.py``'s frame tests: did_scatter on >= 99% of
pixels, the image within 1e-3 on those pixels, the loss within 1e-4
relative); a failing section fails the run; and without a card the
command exits 1 before any work.  The small run uses the 8^3 volume: on
the dense procedural cloud the jitted JAX frame flips null collisions
against its own unjitted run, which the port matches.
"""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import bench_torch
from nrc_hpm_tpu import camera as jcam
from nrc_hpm_tpu import renderer as jren
from nrc_hpm_tpu_torch import renderer as tren
from nrc_hpm_tpu_torch.config import AppConfig
from test_torch_train import H, W, _frame_cfgs, _scattered, _volumes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 2
# bench.py's record (bench.py:99-227), vs_baseline aside: it is a ratio to
# a TPU number and goes only into bench.py's last line
BENCH_PY_KEYS = (
    "device", "compile_cache_entries_before", "compile_cache_status",
    "compile_plus_first_frame_s", "nrc_online_ms_per_frame",
    "nrc_online_rays_per_s", "nrc_loss", "nrc_frozen_ms_per_frame",
    "nrc_frozen_rays_per_s", "nrc_infer_ms", "nrc_infer_samples_per_s",
    "nrc_infer_fullbatch_ms", "nrc_infer_fullbatch_samples_per_s",
    "mc32_ms_per_frame", "mc32_rays_per_s", "nrc_online_2e19_ms_per_frame",
    "nrc_online_2e19_rays_per_s", "stages_ms")
STAGE_KEYS = ("clear", "gen_rays", "prep_infer", "filter", "nn_infer",
              "prep_train", "nn_train", "nn", "render", "total",
              "theoretical_fps", "stage_sum")


def _numbers(value):
    if isinstance(value, dict):
        for v in value.values():
            yield from _numbers(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _numbers(v)
    elif isinstance(value, (int, float)) and not isinstance(value, bool):
        yield value


@pytest.fixture(scope="module")
def small_run():
    """The bench on the CPU at 48x27 on the 8^3 volume, every section and
    the stage profile; with the states its NrcRenderer steps returned."""
    _, tc = _frame_cfgs()
    _, tv = _volumes()
    steps = []
    step = tren.NrcRenderer.step

    def record(self, state, camera, train=True, frame_random=None):
        out = step(self, state, camera, train=train,
                   frame_random=frame_random)
        steps.append((self, train, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tren.NrcRenderer, "step", record)
        rec = bench_torch.run(device="cpu", width=W, height=H, frames=FRAMES,
                              profile=True, cfg=tc, vol=tv)
    return rec, steps


def test_infer_inputs_are_bench_py_s():
    """At seed 0 the inputs are bench.py's jax.random.uniform(PRNGKey(1))
    and PRNGKey(2) draws, bitwise."""
    got = bench_torch.infer_inputs(0, 4096, 4096, "cpu")
    for key, x in zip((1, 2), got):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(key),
                                             (4096, 5)))
        assert x.dtype == torch.float32 and x.shape == (4096, 5)
        assert np.array_equal(x.numpy().view(np.uint32),
                              want.view(np.uint32)), f"PRNGKey({key})"


def test_tuned_is_tpu_tuned():
    assert bench_torch.tuned(AppConfig()) == AppConfig.tpu_tuned()


def test_record_has_bench_py_keys(small_run):
    rec, _ = small_run
    missing = [k for k in BENCH_PY_KEYS if k not in rec]
    assert not missing, missing
    assert "vs_baseline" not in rec
    assert rec["device"] == "cpu"
    assert rec["compile_cache_status"] in ("warm", "cold")
    assert all(math.isfinite(v) for v in _numbers(rec))
    assert set(STAGE_KEYS) <= set(rec["stages_ms"])
    for key in ("nrc_online_ms_per_frame", "nrc_frozen_ms_per_frame",
                "nrc_infer_ms", "nrc_infer_fullbatch_ms", "mc32_ms_per_frame",
                "nrc_online_2e12_ms_per_frame", "nrc_loss"):
        assert rec[key] > 0, key
    # every section ran; a CPU run launches no kernel
    assert set(rec["kernels_launched"]) == {
        "online", "frozen", "inference", "mc32", "nrc_online_2e12", "stages"}
    assert not any(rec["kernels_launched"].values())
    assert rec["nrc_infer_samples_per_s"] == pytest.approx(
        bench_torch.N_INFER / (rec["nrc_infer_ms"] / 1e3))
    assert rec["nrc_infer_fullbatch_samples_per_s"] == pytest.approx(
        W * H / (rec["nrc_infer_fullbatch_ms"] / 1e3))
    json.dumps(rec)


def test_online_frames_match_jax(small_run):
    """The bench's first 1 + FRAMES online frames against the JAX
    renderer's from init_state(0) on the same config and volume."""
    rec, steps = small_run
    headline = steps[0][0]
    online = [out for r, train, out in steps if r is headline and train]
    ts = online[FRAMES]
    jc, _ = _frame_cfgs()
    jv, _ = _volumes()
    jr = jren.NrcRenderer(jc, vol=jv)
    js = jr.init_state(0)
    cam = jcam.Camera.reference_camera(W / H)
    for _ in range(1 + FRAMES):
        js = jr.step(js, cam)
    jimg, timg = np.asarray(js.image), ts.image.numpy()
    agree = _scattered(jimg) == _scattered(timg)
    assert agree.mean() >= 0.99, "did_scatter"
    assert np.abs(timg - jimg).max(-1)[agree].max() <= 1e-3
    assert ts.nrc.step == int(js.nrc.step)
    assert rec["nrc_loss"] == float(ts.nrc.loss)
    assert rec["nrc_loss"] == pytest.approx(float(js.nrc.loss), rel=1e-4)


def test_failing_section_fails_the_run(monkeypatch):
    """A section that raises fails the run: nothing catches it."""
    _, tc = _frame_cfgs()
    _, tv = _volumes()

    def fail(self, state, camera):
        raise RuntimeError("mc step failed")

    monkeypatch.setattr(bench_torch.McRenderer, "step", fail)
    with pytest.raises(RuntimeError, match="mc step failed"):
        bench_torch.run(device="cpu", width=W, height=H, frames=1, cfg=tc,
                        vol=tv)


def test_main_writes_the_record_and_the_last_line(small_run, monkeypatch,
                                                  tmp_path, capsys):
    """main() on a card: the record and the stage profile under
    output_torch/, the metric line last (``run`` and the card stubbed)."""
    rec = dict(small_run[0], gpu="NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(bench_torch.torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("NRC_BENCH_FULL", "1")
    monkeypatch.setenv("NRC_BENCH_PROFILE", "1")
    calls = []
    monkeypatch.setattr(bench_torch, "run",
                        lambda **kw: calls.append(kw) or rec)
    assert bench_torch.main(["--seed", "3"]) == 0
    assert calls == [dict(seed=3, full=True, profile=True)]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"metric": "nrc_online_rays_per_s_1080p",
                                "value": rec["nrc_online_rays_per_s"],
                                "unit": "rays/s/chip"}
    with open(tmp_path / "output_torch" / "bench_full.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    with open(tmp_path / "output_torch" / "stage_profile.json") as f:
        assert json.load(f)["stages_ms"] == rec["stages_ms"]


def test_without_a_card_exits_1(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, os.path.join(ROOT,
                                                       "bench_torch.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 1, res.stdout + res.stderr
    assert "CUDA" in res.stderr
    assert res.stdout == ""
    assert not (tmp_path / "output_torch").exists()
