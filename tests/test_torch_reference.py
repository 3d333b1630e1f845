"""The port's golden comparator and golden writer against the JAX
package's ``reference.py``.

Tolerances: ``compare_images`` within 1e-5 relative of JAX's numbers on
the repository's goldens (float32 sums in another order), exact counts;
``_downsample`` bitwise (the same numpy code); golden images as the frame
tests hold frames (did-scatter channel equal on >= 99% of pixels, the
image within 1e-3 there) and the sidecars' fields and keys equal.  The
JAX writer is given the 8^3 test volume in place of the WDAS cloud it
loads (absent here).  A run resumed in the same package equals its
single run bit for bit."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import camera as jcam
from nrc_hpm_tpu import config as jcfg
from nrc_hpm_tpu import reference as jref
from nrc_hpm_tpu import renderer as jren
from nrc_hpm_tpu.utils.exr import read_exr_rgba as jread
from nrc_hpm_tpu.volume import Volume as JVolume
from nrc_hpm_tpu_torch import camera as tcam
from nrc_hpm_tpu_torch import config as tcfg
from nrc_hpm_tpu_torch import reference as tref
from nrc_hpm_tpu_torch import renderer as tren
from nrc_hpm_tpu_torch.utils import prng
from nrc_hpm_tpu_torch.volume import Volume as TVolume

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "reference")
GW, GH, FRAMES, PATH = 16, 9, 4, 8


def _low(scene: int) -> np.ndarray:
    return jread(os.path.join(GOLDENS, str(scene), "low.exr"))


def _same_result(got, want, rtol=1e-5):
    assert got.valid_pixel_count == want.valid_pixel_count
    for k in ("mse", "ref_mean", "own_mean", "own_var", "bias", "rel_bias",
              "rel_var", "cv"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=rtol,
                                                abs=1e-12), k


@pytest.mark.parametrize("pair", [(0, 1), (2, 3), (4, 5), (5, 0), (3, 3)])
def test_compare_images_matches_jax(pair):
    ref, own = _low(pair[0]), _low(pair[1])
    _same_result(tref.compare_images(torch.from_numpy(ref),
                                     torch.from_numpy(own)),
                 jref.compare_images(ref, own))
    # arrays are taken as they are
    _same_result(tref.compare_images(ref, own), jref.compare_images(ref, own))


def test_compare_images_formulas():
    ref = np.zeros((4, 4, 4), np.float32)
    ref[..., :3] = 2.0
    ref[..., 3] = 1.0
    ref[0, 0, 3] = 0.0  # invalid pixel
    own = np.zeros((4, 4, 4), np.float32)
    own[..., :3] = 3.0
    res = tref.compare_images(ref, torch.from_numpy(own))
    assert res.valid_pixel_count == 15
    assert res.mse == pytest.approx(1.0)
    assert res.ref_mean == pytest.approx(2.0)
    assert res.own_mean == pytest.approx(3.0)
    assert res.own_var == pytest.approx(0.0)
    assert res.rel_bias == pytest.approx(0.5)


@pytest.mark.parametrize("shape,hw", [((37, 53, 4), (9, 13)),
                                      ((108, 192, 4), (54, 96)),
                                      ((20, 30, 3), (20, 7))])
def test_downsample_bitwise(shape, hw):
    img = np.random.RandomState(7).gamma(1.0, 1.0, shape).astype(np.float32)
    assert np.array_equal(tref._downsample(img, hw),
                          jref._downsample(img, hw))


@pytest.mark.parametrize("clip", [None, 0.05])
@pytest.mark.parametrize("scale", [1, 2], ids=["same-size", "pooled"])
def test_golden_compare_matches_jax(clip, scale):
    """GoldenReference.compare: clip, and the average-pool of the larger
    image (own at twice the golden's size, then the golden at twice the
    image's)."""
    gold = _low(4)
    own = np.repeat(np.repeat(_low(3), scale, 0), scale, 1)
    jg = jref.GoldenReference(gold)
    tg = tref.GoldenReference(gold, device="cpu")
    _same_result(tg.compare(torch.from_numpy(own), clip=clip),
                 jg.compare(own, clip=clip))
    big = np.repeat(np.repeat(gold, 2, 0), 2, 1)
    _same_result(tref.GoldenReference(big, device="cpu").compare(
        _low(3), clip=clip), jref.GoldenReference(big).compare(
        _low(3), clip=clip))


def test_golden_load_matches_jax():
    tg = tref.GoldenReference.load(4, search_paths=(GOLDENS,),
                                   device="cpu")
    jg = jref.GoldenReference.load(4, search_paths=(GOLDENS,))
    assert np.array_equal(tg.image, jg.image)
    assert np.array_equal(tg.camera.inv_proj_view.numpy(),
                          np.asarray(jg.camera.inv_proj_view))
    with pytest.raises(FileNotFoundError):
        tref.GoldenReference.load(9, search_paths=(GOLDENS,), device="cpu")


def _volumes():
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    return (JVolume.from_dense(data, 0.6, 0.8),
            TVolume.from_dense(data, 0.6, 0.8, device="cpu"))


@pytest.fixture()
def jax_volume(monkeypatch):
    """The JAX renderers built without a volume get the 8^3 test volume
    (the WDAS cloud they load is absent)."""
    jv, tv = _volumes()
    monkeypatch.setattr(jren, "_volume_from_config", lambda cfg: jv)
    return tv


def _same_image(timg, jimg):
    agree = timg[..., 3] == jimg[..., 3]
    assert agree.mean() >= 0.99, f"did_scatter agrees on {agree.mean():.4f}"
    assert np.abs(timg - jimg).max(-1)[agree].max() <= 1e-3


def _meta(path):
    with open(path + ".progress.json") as f:
        return json.load(f)


def _golden(pkg, tv, path, frames, **kw):
    kw = dict(frames=frames, path_length=PATH, width=GW, height=GH, **kw)
    if pkg == "jax":
        return jref.generate_golden(jcfg.AppConfig(), path, **kw)
    return tref.generate_golden(tcfg.AppConfig(), path, tv, **kw)


def test_generate_golden_matches_jax(tmp_path, jax_volume):
    tpath, jpath = str(tmp_path / "t" / "0.exr"), str(tmp_path / "j.exr")
    timg = _golden("torch", jax_volume, tpath, FRAMES)
    jimg = _golden("jax", jax_volume, jpath, FRAMES)
    assert timg.shape == (GH, GW, 4)
    _same_image(timg, jimg)
    assert np.array_equal(jread(tpath), timg), "the EXR holds the image"
    assert _meta(tpath) == _meta(jpath)
    assert _meta(tpath)["frames_done"] == FRAMES
    assert 0.05 < timg[..., 3].mean() < 0.95


def test_golden_resume_is_bitwise(tmp_path, jax_volume):
    one, two = str(tmp_path / "one.exr"), str(tmp_path / "two.exr")
    full = _golden("torch", jax_volume, one, FRAMES)
    half = _golden("torch", jax_volume, two, FRAMES // 2)
    assert _meta(two)["frames_done"] == FRAMES // 2
    assert not np.array_equal(half, full)
    resumed = _golden("torch", jax_volume, two, FRAMES, resume=True)
    assert np.array_equal(resumed, full)
    assert _meta(two) == _meta(one)
    # save_every writes the partial state on the way: the same final file
    three = str(tmp_path / "three.exr")
    again = _golden("torch", jax_volume, three, FRAMES, save_every=1)
    assert np.array_equal(again, full) and _meta(three) == _meta(one)
    # another seed does not resume from this sidecar
    other = _golden("torch", jax_volume, two, FRAMES, resume=True, seed=1)
    assert not np.array_equal(other, full)


@pytest.mark.parametrize("first,then", [("jax", "torch"), ("torch", "jax")])
def test_golden_resumes_across_packages(tmp_path, jax_volume, first, then):
    """A run of 2 frames by one package, resumed to 4 by the other, as the
    resuming package's own 4-frame run."""
    path, own = str(tmp_path / "x.exr"), str(tmp_path / "own.exr")
    _golden(first, jax_volume, path, FRAMES // 2, save_every=1)
    resumed = _golden(then, jax_volume, path, FRAMES, resume=True)
    single = _golden(then, jax_volume, own, FRAMES)
    _same_image(resumed, single)
    assert _meta(path) == _meta(own)


def test_checked_in_sidecar_key_splits_like_jax():
    with open(os.path.join(GOLDENS, "3", "0.exr.progress.json")) as f:
        meta = json.load(f)
    key = torch.tensor(meta["key"], dtype=torch.int64)
    want = jax.random.split(jax.random.wrap_key_data(
        jnp.asarray(meta["key"], jnp.uint32)))
    want = np.asarray(jax.random.key_data(want)).astype(np.int64)
    assert np.array_equal(prng.split(key).numpy(), want)


def test_compare_nrc_and_mc_leave_state_untouched(jax_volume):
    """compare_mc / compare_nrc score one fresh frame from a reset copy
    of the state; the caller's tensors keep their values, and the MC
    score is JAX's within 1e-4 relative (the frames agree as the frame
    tests hold them, which moves the sums by ~1e-5)."""
    tv = jax_volume
    gold = _low(4)
    tg = tref.GoldenReference(gold, device="cpu")
    jg = jref.GoldenReference(gold)
    kw = dict(render_width=48, render_height=27, mc_path_length=PATH)
    tr = tren.McRenderer(tcfg.AppConfig(**kw), tv)
    jr = jren.McRenderer(jcfg.AppConfig(**kw))
    cam = tcam.Camera.reference_camera(48 / 27, device="cpu")
    ts = tr.step(tr.init_state(2), cam)
    js = jr.step(jr.init_state(2), jcam.Camera.reference_camera(48 / 27))
    before = ts.image.clone(), ts.key.clone(), ts.blend_index
    got = tg.compare_mc(tr, ts)
    assert torch.equal(ts.image, before[0]) and torch.equal(ts.key, before[1])
    assert ts.blend_index == before[2]
    _same_result(got, jg.compare_mc(jr, js), rtol=1e-4)

    ncfg = tcfg.AppConfig(render_width=48, render_height=27, nn_width=16,
                          nn_depth=2, encoding=tcfg.EncodingConfig(
                              n_levels=4, log2_hashmap_size=12))
    nr = tren.NrcRenderer(ncfg, tv)
    ns = nr.step(nr.init_state(0), cam, train=False)
    snap = (ns.image.clone(), ns.key.clone(), ns.ring.data.clone(),
            [p.clone() for p in ns.nrc.params["mlp"]["layers"]])
    res = tg.compare_nrc(nr, ns)
    assert np.isfinite([res.mse, res.rel_bias, res.cv]).all()
    assert torch.equal(ns.image, snap[0]) and torch.equal(ns.key, snap[1])
    assert torch.equal(ns.ring.data, snap[2])
    assert all(torch.equal(p, q) for p, q in
               zip(ns.nrc.params["mlp"]["layers"], snap[3]))
