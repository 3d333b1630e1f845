"""The port's application on the CPU in the runs that need no JAX run
beside them, from a working directory made as in test_torch_app.py (the
written cloud at the scene's volume_path, a golden): ``--profile`` with
``--compare-accumulated``, ``--checkpoint`` then ``--load-checkpoint``
with ``--no-train``, and ``--renderer mc``; and the profiler itself.

Checked: the stage profile's keys and ``format_stage_report``'s text are
the JAX package's for the same stage dict (the keys of
``nrc_hpm_tpu/profiler.py``: running the JAX profiler compiles every
stage twice); the accumulated image is scored on the frames asked for;
the checkpoint reads back into the next run bitwise; the MC-only run
exports a finite image; ``profile_nrc_frame`` leaves the caller's state
as it was, its ``total`` timed on a real step, and ``profile_trace``
writes a Chrome trace."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from nrc_hpm_tpu import profiler as jprof
from nrc_hpm_tpu_torch import app as tapp
from nrc_hpm_tpu_torch import profiler as tprof
from nrc_hpm_tpu_torch.utils.exr import read_exr_rgba
from test_torch_app import (ARGV, FLAGS, H, W, _log, _records, make_scene,
                            run_in)

# the keys of nrc_hpm_tpu/profiler.py's profile_nrc_frame
STAGE_KEYS = {"clear", "gen_rays", "prep_infer", "filter", "nn_infer",
              "prep_train", "nn_train", "nn", "render", "total",
              "theoretical_fps", "stage_sum"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("app_runs")

    def all_runs():
        make_scene()
        assert tapp.main(ARGV + FLAGS + [
            "--renderer", "nrc", "--frames", "2", "--profile",
            "--compare-accumulated", "--checkpoint", "ck.npz",
            "--out", "profiled"]) == 0
        assert tapp.main(ARGV + FLAGS + [
            "--renderer", "nrc", "--frames", "1", "--no-train",
            "--load-checkpoint", "ck.npz", "--out", "loaded"]) == 0
        assert tapp.main(ARGV + FLAGS + [
            "--renderer", "mc", "--frames", "1", "--benchmark-every", "0",
            "--export-exr", "--out", "mc"]) == 0

    run_in(root, all_runs)
    return {k: str(root / k) for k in ("profiled", "loaded", "mc")} | {
        "root": str(root)}


def test_profile_keys_and_report_are_jax_s(runs):
    (event,) = [r for r in _records(runs["profiled"])
                if r.get("event") == "stage_profile"]
    stages = {k: v for k, v in event.items() if k not in ("event", "t")}
    assert set(stages) == STAGE_KEYS
    assert all(v >= 0 for v in stages.values())
    assert stages["nn"] == pytest.approx(stages["nn_infer"]
                                         + stages["nn_train"], abs=2e-3)
    assert tprof.format_stage_report(stages) == \
        jprof.format_stage_report(stages)


def test_compare_accumulated_scores_the_screen(runs):
    recs = [r for r in _records(runs["profiled"]) if "frame" in r]
    assert [(r["frame"], "nrc" in r, "mc" in r) for r in recs] == \
        [(0, True, False), (1, True, False)]
    assert [int(line[0]) for line in _log(runs["profiled"])] == [0, 1]


def test_checkpoint_reloads_the_cache(runs):
    from nrc_hpm_tpu_torch.models.nrc.cache import NeuralRadianceCache
    from nrc_hpm_tpu_torch.utils.checkpoint import load_pytree
    from nrc_hpm_tpu_torch.utils.prng import prng_key

    saved = [r["loss"] for r in _records(runs["profiled"]) if "frame" in r]
    # a frozen frame keeps the loaded state's loss
    assert [r["loss"] for r in _records(runs["loaded"])
            if "frame" in r] == saved[-1:]
    cfg = tapp._config(tapp.build_argparser().parse_args(ARGV + FLAGS))
    cache = NeuralRadianceCache(cfg)
    st = load_pytree(os.path.join(runs["root"], "ck.npz"),
                     cache.init_state(prng_key(1), device="cpu"),
                     device="cpu")
    assert st.step == 2 * cfg.train_batch_count == st.opt_state["count"]
    assert float(st.loss) == saved[-1]
    assert st.params["encoding"]["hash_table"].dtype == torch.float32


def test_mc_run_exports_its_image(runs):
    recs = _records(runs["mc"])
    assert [(r["frame"], "loss" in r, "mc" in r) for r in recs] == \
        [(0, False, False)]
    img = read_exr_rgba(os.path.join(runs["mc"], "mc.exr"))
    assert img.shape == (H, W, 4) and np.isfinite(img).all()
    assert 0.05 < img[..., 3].mean() < 0.95
    assert not os.path.exists(os.path.join(runs["mc"], "nrc.exr"))


def test_profiler_leaves_the_state_and_writes_a_trace(tmp_path):
    from nrc_hpm_tpu_torch.camera import Camera
    from nrc_hpm_tpu_torch.models.nrc.cache import tree_leaves
    from nrc_hpm_tpu_torch.renderer import NrcRenderer
    from nrc_hpm_tpu_torch.volume import Volume

    cfg = tapp._config(tapp.build_argparser().parse_args(ARGV + FLAGS))
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    r = NrcRenderer(cfg, Volume.from_dense(data, 0.6, 0.8, device="cpu"))
    cam = Camera.reference_camera(W / H, device="cpu")
    state = r.step(r.init_state(0), cam)

    def leaves():
        return tree_leaves([dataclasses.asdict(state.ring), state.image,
                            state.key, state.nrc.params,
                            state.nrc.ema_params, state.nrc.opt_state["mu"],
                            state.nrc.loss])

    before = [t.clone() for t in leaves()]
    stages = tprof.profile_nrc_frame(r, state, cam, reps=1)
    assert set(stages) == STAGE_KEYS
    assert stages["total"] > 0
    assert stages["theoretical_fps"] == 1000.0 / stages["total"]
    assert all(torch.equal(a, b) for a, b in zip(before, leaves()))
    assert state.nrc.step == 2 and state.blend_index == 2
    prim = {"primary_color": torch.ones(W * H, 4),
            "did_scatter": torch.zeros(W * H, dtype=torch.bool)}
    with tprof.profile_trace(str(tmp_path / "trace")):
        r.composite(state, prim, None)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
