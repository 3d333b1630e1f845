"""Whole NRC frames of path A against the JAX ``NrcRenderer``: online
frames at non-default encodings (the split encode and K4's plain version
for inference), the float32 MLP, and the golden-era ``env_fixed16``
estimator; and every (pos_id, dir_id) pair stepping online and frozen.

48x27 pixels, an 8^3 heterogeneous volume, a 16x2 MLP.  Each frame starts
both packages from the same cache state (``state_from_jax`` of the JAX
state before the frame) and the same frame seed (the JAX key split,
passed to the port as ``frame_random``).

Tolerances, and why:
- As tests/test_torch_train.py: did_scatter on >= 99% of pixels and the
  image within 1e-3 on those pixels; ring cursors equal and ring rows on
  >= 99% within 1e-3; step counts equal.
- The frame's training: the port's train_frame against the JAX
  train_frame run on the port's train inputs from the same state, as
  tests/test_torch_train.py holds whole steps (>= 99% of the entries of
  every leaf within 1e-4 relative + 1e-6, loss within 1e-4 relative).
- With the hash grid (features of tcnn's 1e-4 scale, so the cache is
  nearly flat in space) the image within 1e-3 on every agreeing pixel and
  the trained cache leaf by leaf as tight as above.  The other encodings
  feed O(1) features, where the cache's output moves with one bf16
  activation flipped by a float32 sum in another order (the K4 bound,
  1e-2) and with an ulp that moves a pixel's NRC query: the image within
  1e-2 on every agreeing pixel and within 1e-3 on >= 98% of them.  The
  same flips in training become, through Adam, whose first steps move every
  entry by about lr whatever its gradient's size, turns into lr-sized
  moves of the entries whose gradients are near 0 (the JAX frame's own
  jitted and eager runs differ so): the trained cache's loss within 1e-2
  relative of the JAX frame's.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import camera as jcam
from nrc_hpm_tpu import config as jcfg
from nrc_hpm_tpu import renderer as jren
from nrc_hpm_tpu.utils import rng as jrng
from nrc_hpm_tpu.volume import Volume as JVolume
from nrc_hpm_tpu_torch import camera as tcam
from nrc_hpm_tpu_torch import config as tcfg
from nrc_hpm_tpu_torch import renderer as tren
from nrc_hpm_tpu_torch.models.nrc import cache as tcache
from nrc_hpm_tpu_torch.volume import Volume as TVolume
from nrc_hpm_tpu_torch.weights import state_from_jax

W, H = 48, 27
KW = dict(render_width=W, render_height=H, nn_width=16, nn_depth=2,
          log2_train_batch_size=6, train_batch_count=2, train_ray_length=4)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _volumes():
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    return (JVolume.from_dense(data, 0.6, 0.8),
            TVolume.from_dense(data, 0.6, 0.8, device="cpu"))


def _cfgs(pos=0, dir_=0, scene=4, **kw):
    enc = dict(pos_id=pos, dir_id=dir_, n_levels=4, log2_hashmap_size=12)
    return (jcfg.AppConfig(encoding=jcfg.EncodingConfig(**enc),
                           scene=jcfg.SceneConfig.preset(scene), **KW, **kw),
            tcfg.AppConfig(encoding=tcfg.EncodingConfig(**enc),
                           scene=tcfg.SceneConfig.preset(scene), **KW, **kw))


def _leaves_close(got_tree, want_tree, what):
    got = tcache.tree_leaves(got_tree)
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy().astype(np.float64), np.asarray(w, np.float64)
        share = (np.abs(g - w) <= 1e-6 + 1e-4 * np.abs(w)).mean()
        assert share >= 0.99, f"{what} leaf {i}: {share:.5f} close"


def _two_frames_match(jc, tc, env, strict):
    """Two online frames; ``strict`` for the hash-grid tolerances."""
    jv, tv = _volumes()
    jr = jren.NrcRenderer(jc, vol=jv)
    js = jr.init_state(0)
    tr = tren.NrcRenderer(tc, vol=tv)
    ts = tr.init_state(0)
    train_frame, inputs = tr.cache.train_frame, []

    def record(st, x5, target):
        inputs.append((x5, target))
        return train_frame(st, x5, target)

    tr.cache.train_frame = record
    cam_j = jcam.Camera.reference_camera(W / H)
    cam_t = tcam.Camera.reference_camera(W / H, device="cpu")
    key = js.key
    for frame in range(2):
        key, sub = jax.random.split(key)
        fr = np.asarray(jrng.frame_random(sub))
        before = _np(js.nrc)
        ts.nrc = state_from_jax(before, device="cpu")
        js = jr.step(js, cam_j)
        ts = tr.step(ts, cam_t, frame_random=torch.tensor(fr))
        jimg, timg = np.asarray(js.image), ts.image.numpy()
        assert np.isfinite(timg).all()
        scat_j = np.abs(jimg[..., :3] - env).max(-1) > 1e-6
        scat_t = np.abs(timg[..., :3] - env).max(-1) > 1e-6
        agree = scat_j == scat_t
        assert agree.mean() >= 0.99, f"frame {frame}: did_scatter"
        assert scat_t.mean() > 0.05, "the frame sees the cloud"
        img_err = np.abs(timg - jimg).max(-1)[agree]
        if strict:
            assert img_err.max() <= 1e-3
        else:
            assert img_err.max() <= 1e-2
            assert (img_err <= 1e-3).mean() >= 0.98
        assert ts.nrc.step == int(js.nrc.step) == 2 * (frame + 1)
        assert int(ts.ring.head) == int(js.ring.head)
        assert int(ts.ring.tail) == int(js.ring.tail)
        err = np.abs(ts.ring.data.numpy() - np.asarray(js.ring.data))
        assert (err.max(-1) <= 1e-3).mean() >= 0.99
        x5, target = inputs[-1]
        same = jr.cache.train_frame(jax.tree.map(jnp.asarray, before),
                                    jnp.asarray(x5.numpy()),
                                    jnp.asarray(target.numpy()))
        np.testing.assert_allclose(float(ts.nrc.loss), float(same.loss),
                                   rtol=1e-4)
        _leaves_close(ts.nrc.params, same.params, "params, same inputs")
        _leaves_close(ts.nrc.ema_params, same.ema_params, "ema, same inputs")
        if strict:
            _leaves_close(ts.nrc.params, js.nrc.params, "params")
            _leaves_close(ts.nrc.ema_params, js.nrc.ema_params, "ema")
        else:
            np.testing.assert_allclose(float(ts.nrc.loss),
                                       float(js.nrc.loss), rtol=1e-2)
    return ts


@pytest.mark.parametrize("pos,dir_", [(3, 2), (0, 1)])
def test_two_online_frames_match_jax(pos, dir_):
    ts = _two_frames_match(*_cfgs(pos, dir_), env=0.1, strict=pos == 0)
    if pos:
        assert ts.nrc.params["encoding"] == {}


def test_float32_online_frames_match_jax():
    _two_frames_match(*_cfgs(2, 1, mlp_dtype="float32"), env=0.1,
                      strict=False)


@pytest.mark.parametrize("scene,env", [(4, 0.1), (5, 1.0)])
def test_env_fixed16_frames_match_jax(scene, env):
    """Preset 4 tracks the directional light and estimates the env term
    with 16 fixed steps; preset 5 is env light only."""
    _two_frames_match(*_cfgs(scene=scene, env_fixed16=True), env=env,
                      strict=True)


@pytest.mark.parametrize("pos,dir_", list(itertools.product(range(4),
                                                            range(3))))
def test_every_encoding_steps_online_and_frozen(pos, dir_):
    _, tc = _cfgs(pos, dir_)
    _, tv = _volumes()
    r = tren.NrcRenderer(tc, vol=tv)
    st = r.init_state(0)
    cam = tcam.Camera.reference_camera(W / H, device="cpu")
    st = r.step(st, cam)
    assert st.nrc.step == tc.train_batch_count
    assert np.isfinite(float(st.nrc.loss))
    before = [t.clone() for t in tcache.tree_leaves(st.nrc.params)]
    st = r.step(st, cam, train=False)
    assert st.image.shape == (H, W, 4) and torch.isfinite(st.image).all()
    assert all(torch.equal(a, b) for a, b in
               zip(before, tcache.tree_leaves(st.nrc.params)))
