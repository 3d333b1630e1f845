"""The port's frozen-cache NRC frame against the JAX package's
``NrcRenderer.step(train=False)``: 48x27 pixels, scene preset 4, an 8^3
heterogeneous volume, 4 hash levels at 2^12, a 16x2 MLP, the same frame
seed (the JAX key split, passed to the port as ``frame_random``) and the
same cache weights (``params_from_jax``).

Tolerances: the RNG is bitwise, so pixels differ only where an ulp of
float reassociation flips a stochastic decision.  did_scatter must agree
on >= 99% of pixels; on those pixels the image agrees within 1e-3."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import camera as jcam
from nrc_hpm_tpu import config as jcfg
from nrc_hpm_tpu import renderer as jren
from nrc_hpm_tpu.integrator import TraceParams as JTraceParams
from nrc_hpm_tpu.lights import LightFlags as JLightFlags
from nrc_hpm_tpu.lights import lights_from_scene as jlights
from nrc_hpm_tpu.utils import rng as jrng
from nrc_hpm_tpu.volume import Volume as JVolume
from nrc_hpm_tpu_torch import camera as tcam
from nrc_hpm_tpu_torch import config as tcfg
from nrc_hpm_tpu_torch import renderer as tren
from nrc_hpm_tpu_torch.integrator import TraceParams
from nrc_hpm_tpu_torch.lights import LightFlags, lights_from_scene
from nrc_hpm_tpu_torch.utils import rng as trng
from nrc_hpm_tpu_torch.volume import Volume as TVolume
from nrc_hpm_tpu_torch.weights import params_from_jax

W, H = 48, 27
KW = dict(render_width=W, render_height=H, nn_width=16, nn_depth=2)


def _cfgs():
    return (jcfg.AppConfig(encoding=jcfg.EncodingConfig(
                n_levels=4, log2_hashmap_size=12), **KW),
            tcfg.AppConfig(encoding=tcfg.EncodingConfig(
                n_levels=4, log2_hashmap_size=12), **KW))


def _volumes():
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    return (JVolume.from_dense(data, 0.6, 0.8),
            TVolume.from_dense(data, 0.6, 0.8, device="cpu"))


def test_primary_pass_matches_jax():
    jc, tc = _cfgs()
    jv, tv = _volumes()
    fr = np.array([0.3, 0.1, 0.7, 0.9], np.float32)
    ro, rd, uv = jcam.pixel_rays(jcam.Camera.reference_camera(W / H), W, H)
    st = jrng.init_state(uv, jnp.asarray(fr)).reshape(-1)
    rdf = rd.reshape(-1, 3)
    jp = jax.jit(partial(jren.primary_pass, vol=jv, lights=jlights(jc.scene),
                         params=JTraceParams(
                             flags=JLightFlags.from_scene(jc.scene)
                         ).primary_params(), cfg=jc))(
        st, ro=jnp.broadcast_to(ro, rdf.shape), rd=rdf)
    tcam_t = tcam.Camera.reference_camera(W / H, device="cpu")
    tro, trd, tuv = tcam.pixel_rays(tcam_t, W, H)
    tp = tren.primary_pass(
        trng.init_state(tuv, torch.from_numpy(fr)).reshape(-1), tv,
        lights_from_scene(tc.scene, device="cpu"),
        TraceParams(flags=LightFlags.from_scene(tc.scene)).primary_params(),
        tc, tro.expand(W * H, 3), trd.reshape(-1, 3))
    scat_j = np.asarray(jp["did_scatter"])
    scat_t = tp["did_scatter"].numpy()
    agree = scat_j == scat_t
    assert agree.mean() >= 0.99, f"did_scatter agrees on {agree.mean():.4f}"
    assert 0.05 < scat_t.mean() < 0.95, "some but not all pixels scatter"
    both = agree & scat_t
    for k in ("primary_color", "nrc_pos", "nrc_dir"):
        err = np.abs(tp[k].numpy() - np.asarray(jp[k])).max(-1)
        assert err[both].max() <= 1e-3, f"{k} within 1e-3 on agreeing pixels"


@pytest.fixture(scope="module")
def frames():
    """One JAX and one port frame, the same seed and weights."""
    jc, tc = _cfgs()
    jv, tv = _volumes()
    jr = jren.NrcRenderer(jc, vol=jv)
    js = jr.init_state(0)
    fr = np.asarray(jrng.frame_random(jax.random.split(js.key)[1]))
    ema = jax.tree.map(np.asarray, js.nrc.ema_params)
    jimg = np.asarray(jr.step(js, jcam.Camera.reference_camera(W / H),
                              train=False).image)
    tr = tren.NrcRenderer(tc, vol=tv)
    ts = tr.init_state(0, nrc=tr.cache.state_from_params(
        params_from_jax(ema, device="cpu"), device="cpu"))
    ts = tr.step(ts, tcam.Camera.reference_camera(W / H, device="cpu"),
                 train=False, frame_random=torch.tensor(fr))
    return jimg, ts, tr


def test_frozen_frame_matches_jax(frames):
    jimg, ts, _ = frames
    timg = ts.image.numpy()
    assert timg.shape == (H, W, 4) and np.isfinite(timg).all()
    env = 0.1   # scene 4: constant env map of strength 0.1
    scat_j = np.abs(jimg[..., :3] - env).max(-1) > 1e-6
    scat_t = np.abs(timg[..., :3] - env).max(-1) > 1e-6
    agree = scat_j == scat_t
    assert agree.mean() >= 0.99, f"did_scatter agrees on {agree.mean():.4f}"
    err = np.abs(timg - jimg).max(-1)
    assert err[agree].max() <= 1e-3, "image within 1e-3 on agreeing pixels"
    assert timg[0, 0, 0] == pytest.approx(0.1, abs=1e-6), "border = env"


def test_blend_reset_and_train_guard(frames):
    _, ts, tr = frames
    cam = tcam.Camera.reference_camera(W / H, device="cpu")
    fr = torch.tensor([0.2, 0.4, 0.6, 0.8])
    one = tr.step(dataclasses.replace(ts, image=torch.zeros_like(ts.image),
                                      blend_index=1), cam, train=False,
                  frame_random=fr)
    two = tr.step(one, cam, train=False, frame_random=fr)
    assert two.blend_index == 3
    torch.testing.assert_close(two.image, one.image, rtol=0, atol=1e-6)
    assert tren.reset_accumulation(two).blend_index == 1
    assert not tren.reset_accumulation(two).image.any()
    # a frozen step leaves the cache as it was
    layer0 = ts.nrc.params["mlp"]["layers"][0].clone()
    frozen = tr.step(ts, cam, train=False, frame_random=fr)
    assert frozen.nrc.step == ts.nrc.step == 0
    assert torch.equal(frozen.nrc.params["mlp"]["layers"][0], layer0)


@pytest.mark.parametrize("seed", [0, 3])
def test_seeded_frames_match_jax(seed):
    """init_state(seed) and two frozen frames with no frame_random
    override: the cache and the frame seeds come from the port's threefry
    key chain, as the JAX renderer draws them, so the images agree as
    test_frozen_frame_matches_jax holds them."""
    jc, tc = _cfgs()
    jv, tv = _volumes()
    jr, tr = jren.NrcRenderer(jc, vol=jv), tren.NrcRenderer(tc, vol=tv)
    js, ts = jr.init_state(seed), tr.init_state(seed)
    jcam_ = jcam.Camera.reference_camera(W / H)
    tcam_ = tcam.Camera.reference_camera(W / H, device="cpu")
    for _ in range(2):
        js = jr.step(js, jcam_, train=False)
        ts = tr.step(ts, tcam_, train=False)
    jimg, timg = np.asarray(js.image), ts.image.numpy()
    env = 0.1
    scat_j = np.abs(jimg[..., :3] - env).max(-1) > 1e-6
    scat_t = np.abs(timg[..., :3] - env).max(-1) > 1e-6
    agree = scat_j == scat_t
    assert agree.mean() >= 0.99, f"did_scatter agrees on {agree.mean():.4f}"
    assert 0.05 < scat_t.mean() < 0.95, "some but not all pixels scatter"
    err = np.abs(timg - jimg).max(-1)
    assert err[agree].max() <= 1e-3, "image within 1e-3 on agreeing pixels"
    assert np.array_equal(ts.key.numpy(), np.asarray(js.key).astype(np.int64))
