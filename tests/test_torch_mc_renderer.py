"""The port's Monte-Carlo renderer and the NrcRenderer arguments against
the JAX package: 48x27 pixels, scene preset 4, the 8^3 heterogeneous
volume (passed to the JAX renderers explicitly: without one they load the
WDAS cloud), 8-bounce MC paths, frames seeded through ``init_state``.

Tolerances, as the port's frame tests: the RNG and the key chain are
bitwise, so pixels differ only where an ulp of float reassociation flips
a stochastic decision.  The did-scatter channel must agree on >= 99% of
pixels; on those pixels the image agrees within 1e-3; the key after each
step is bitwise."""

import dataclasses
from functools import partial

import jax
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import camera as jcam
from nrc_hpm_tpu import config as jcfg
from nrc_hpm_tpu import integrator as jint
from nrc_hpm_tpu import renderer as jren
from nrc_hpm_tpu import transmittance as jtr
from nrc_hpm_tpu.volume import Volume as JVolume
from nrc_hpm_tpu_torch import camera as tcam
from nrc_hpm_tpu_torch import config as tcfg
from nrc_hpm_tpu_torch import renderer as tren
from nrc_hpm_tpu_torch import transmittance as ttr
from nrc_hpm_tpu_torch.volume import Volume as TVolume

W, H = 48, 27
PATH = 8
ENV = 0.1   # scene 4: constant env map of strength 0.1


def _cfgs(**kw):
    kw = dict(render_width=W, render_height=H, mc_path_length=PATH, **kw)
    return jcfg.AppConfig(**kw), tcfg.AppConfig(**kw)


def _volumes():
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    return (JVolume.from_dense(data, 0.6, 0.8),
            TVolume.from_dense(data, 0.6, 0.8, device="cpu"))


def _cams(w=W, h=H):
    return (jcam.Camera.reference_camera(w / h),
            tcam.Camera.reference_camera(w / h, device="cpu"))


def _same_frame(timg, jimg, w_channel=True):
    """The frame tests' rule; the MC image's fourth channel is the
    did-scatter mean (the NRC frame's is 1, so scatter shows as a pixel
    off the env)."""
    assert timg.shape == jimg.shape and np.isfinite(timg).all()
    if w_channel:
        agree = timg[..., 3] == jimg[..., 3]
    else:
        agree = ((np.abs(timg[..., :3] - ENV).max(-1) > 1e-6)
                 == (np.abs(jimg[..., :3] - ENV).max(-1) > 1e-6))
    assert agree.mean() >= 0.99, f"did_scatter agrees on {agree.mean():.4f}"
    err = np.abs(timg - jimg).max(-1)
    assert err[agree].max() <= 1e-3, "image within 1e-3 on agreeing pixels"


def _same_key(ts, js):
    assert np.array_equal(ts.key.numpy(), np.asarray(js.key).astype(np.int64))


@pytest.fixture(scope="module")
def renderers():
    jc, tc = _cfgs()
    jv, tv = _volumes()
    return jren.McRenderer(jc, vol=jv), tren.McRenderer(tc, tv)


@pytest.mark.parametrize("seed", [0, 3])
def test_mc_steps_match_jax(renderers, seed):
    jr, tr = renderers
    jc_, tc_ = _cams()
    js, ts = jr.init_state(seed), tr.init_state(seed)
    _same_key(ts, js)
    for i in range(2):
        js, ts = jr.step(js, jc_), tr.step(ts, tc_)
        _same_frame(ts.image.numpy(), np.asarray(js.image))
        _same_key(ts, js)
        assert ts.blend_index == int(js.blend_index) == i + 2
    assert 0.05 < float(ts.image[..., 3].mean()) < 0.95


def test_mc_render_matches_jax(renderers):
    jr, tr = renderers
    jc_, tc_ = _cams()
    _same_frame(tr.render(tc_, frames=3, seed=5).numpy(),
                np.asarray(jr.render(jc_, frames=3, seed=5)))


def test_mc_frame_basics(renderers):
    _, tr = renderers
    img = tr.render(_cams()[1], frames=2).numpy()
    assert img.shape == (H, W, 4) and np.isfinite(img).all()
    assert (img[..., :3] >= 0).all()
    # border rays miss the box: the env, and no scatter
    assert img[0, 0, 0] == pytest.approx(ENV, abs=1e-5)
    assert img[0, 0, 3] == 0.0
    assert (img[..., 3] > 0).mean() > 0.1
    a = tr.render(_cams()[1], frames=1, seed=5)
    assert torch.equal(a, tr.render(_cams()[1], frames=1, seed=5))
    assert not torch.equal(a, tr.render(_cams()[1], frames=1, seed=6))


def test_mc_blend_is_running_mean(renderers):
    """The temporal blend (weight 1/blend_index) is the running mean of
    the per-frame images, each reconstructed from consecutive
    accumulations."""
    _, tr = renderers
    cam = _cams()[1]
    state = tr.init_state(3)
    frames = []
    prev = state.image.numpy()
    for i in range(3):
        state = tr.step(state, cam)
        cur = state.image.numpy()
        bf = 1.0 / (i + 1)
        frames.append((cur - (1.0 - bf) * prev) / bf)
        prev = cur
    assert state.blend_index == 4
    np.testing.assert_allclose(np.mean(frames, axis=0), prev, rtol=1e-4,
                               atol=1e-5)
    reset = tren.reset_accumulation(state)
    assert reset.blend_index == 1 and not reset.image.any()
    assert torch.equal(reset.key, state.key)


def test_mc_blend_false_matches_jax():
    jc, tc = _cfgs()
    jv, tv = _volumes()
    jr = jren.McRenderer(jc, vol=jv, blend=False)
    tr = tren.McRenderer(tc, tv, blend=False)
    jc_, tc_ = _cams()
    js, ts = jr.init_state(1), tr.init_state(1)
    for _ in range(2):
        js, ts = jr.step(js, jc_), tr.step(ts, tc_)
    _same_frame(ts.image.numpy(), np.asarray(js.image))
    _same_key(ts, js)
    assert ts.blend_index == int(js.blend_index) == 1
    # the image is the latest frame alone: its did-scatter flags are 0/1
    assert set(np.unique(ts.image[..., 3].numpy())) <= {0.0, 1.0}


def _lower_compaction(monkeypatch):
    """COMPACT_MIN_LANES at 256 in both packages: at 48x27 the JAX
    package's compaction capacities and staged schedules then run, as
    they do on a full-size frame."""
    for mod in (jint, jtr, ttr):
        monkeypatch.setattr(mod, "COMPACT_MIN_LANES", 256)


def _mc_frames_match_jax(mode, seed):
    """Two MC frames through the JAX renderer's own step function at
    TraceParams(mode=...) and the port's, image and key after each."""
    jc, tc = _cfgs()
    jv, tv = _volumes()
    jr, tr = jren.McRenderer(jc, vol=jv), tren.McRenderer(tc, tv)
    jp = dataclasses.replace(jr.params, mode=mode)
    jstep = jax.jit(partial(jren._mc_step, params=jp, width=W, height=H,
                            path_length=PATH, blend=True))
    tr.params = dataclasses.replace(tr.params, mode=mode)
    jc_, tc_ = _cams()
    js, ts = jr.init_state(seed), tr.init_state(seed)
    for _ in range(2):
        js, ts = jstep(js, jc_, jv, jr.lights), tr.step(ts, tc_)
        _same_frame(ts.image.numpy(), np.asarray(js.image))
        _same_key(ts, js)


@pytest.mark.parametrize("mode", ["pw", "fast"])
def test_mc_compacted_match_jax(monkeypatch, mode):
    """MC frames whose bounces compact their live lanes and stage their
    tracker segments (the dead lanes' RNG advance of both modes)."""
    _lower_compaction(monkeypatch)
    _mc_frames_match_jax(mode, 2)


@pytest.mark.parametrize("mode", ["fast", "seq"])
def test_mc_modes_match_jax(mode):
    """MC frames with the other trackers: the JAX renderer's own step
    function at TraceParams(mode=...)."""
    _mc_frames_match_jax(mode, 4)


def test_nrc_renderer_arguments_match_jax():
    """NrcRenderer(width=, height=, show_nrc=False, blend=False): a 32x18
    frame of a 48x27 configuration, trained (the train grid of 32x18
    pixels), without the cache term in the composite and without the
    blend."""
    kw = dict(render_width=W, render_height=H, nn_width=16, nn_depth=2,
              log2_train_batch_size=8, train_batch_count=2)
    jc = jcfg.AppConfig(encoding=jcfg.EncodingConfig(
        n_levels=4, log2_hashmap_size=12), **kw)
    tc = tcfg.AppConfig(encoding=tcfg.EncodingConfig(
        n_levels=4, log2_hashmap_size=12), **kw)
    jv, tv = _volumes()
    args = dict(width=32, height=18, show_nrc=False, blend=False)
    jr = jren.NrcRenderer(jc, vol=jv, **args)
    tr = tren.NrcRenderer(tc, tv, **args)
    assert (tr.train_w, tr.train_h, tr.train_x_dist, tr.train_y_dist) == (
        jr.train_w, jr.train_h, jr.train_x_dist, jr.train_y_dist)
    assert (tr.train_w, tr.train_h, tr.train_x_dist) == (32, 16, 1)
    jc_, tc_ = _cams(32, 18)
    js, ts = jr.init_state(0), tr.init_state(0)
    for _ in range(2):
        js, ts = jr.step(js, jc_), tr.step(ts, tc_)
        timg = ts.image.numpy()
        assert timg.shape == (18, 32, 4)
        _same_frame(timg, np.asarray(js.image), w_channel=False)
        _same_key(ts, js)
        assert ts.blend_index == int(js.blend_index) == 1
    assert ts.nrc.step == int(js.nrc.step) == 4
    assert float(ts.nrc.loss) == pytest.approx(float(js.nrc.loss), rel=1e-3)
    # show_nrc=False: the composite is the primary color alone
    prim_only = tren.NrcRenderer(tc, tv, **args).step(
        ts, tc_, train=False).image
    shown = tren.NrcRenderer(tc, tv, width=32, height=18, blend=False).step(
        ts, tc_, train=False).image
    assert not torch.equal(prim_only, shown)


def test_nrc_compacted_frozen_frame_match_jax(monkeypatch):
    """A frozen NRC frame whose primary pass compacts its live lanes."""
    _lower_compaction(monkeypatch)
    kw = dict(render_width=W, render_height=H, nn_width=16, nn_depth=2)
    jc = jcfg.AppConfig(encoding=jcfg.EncodingConfig(
        n_levels=4, log2_hashmap_size=12), **kw)
    tc = tcfg.AppConfig(encoding=tcfg.EncodingConfig(
        n_levels=4, log2_hashmap_size=12), **kw)
    jv, tv = _volumes()
    jr, tr = jren.NrcRenderer(jc, vol=jv), tren.NrcRenderer(tc, tv)
    jc_, tc_ = _cams()
    js = jr.step(jr.init_state(1), jc_, train=False)
    ts = tr.step(tr.init_state(1), tc_, train=False)
    _same_frame(ts.image.numpy(), np.asarray(js.image), w_channel=False)
    _same_key(ts, js)
