"""The frame options ``compact``, ``trace_chunks`` and ``infer_filter``
of the port's renderers against the JAX package's: 48x27 pixels, scene
preset 4, the 8^3 heterogeneous volume passed to both renderers, 4 hash
levels at 2^12 and a 16x2 MLP, frames seeded through ``init_state`` (the
port's key chain is JAX's, bit for bit).

Tolerances, as the port's frame tests: did-scatter (a pixel off the env
colour; the MC image's fourth channel) agrees on >= 99% of pixels, and
on those pixels the image within 1e-3; the key after each step bitwise.
Online frames also hold the optimizer step count and the ring's head and
tail equal and the loss within 1e-4 relative, as
tests/test_torch_train.py holds them.  The port's chunked frame against
its own unchunked one (and ``infer_filter=False`` against the default)
has every pixel's did-scatter equal and the image within 1e-6 where
both run the same tracker schedule (every chunk below
COMPACT_MIN_LANES): the draws are the same, and PyTorch's vectorized CPU
math rounds a lane by its place in the vector, an ulp apart (2.4e-7
read).  It is held to the frame rule where the chunks run the staged
schedules of their own lane count, and so is ``compact``."""

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
from nrc_hpm_tpu_torch import integrator as tint
from nrc_hpm_tpu_torch import renderer as tren
from nrc_hpm_tpu_torch import transmittance as ttr
from nrc_hpm_tpu_torch.volume import Volume as TVolume

W, H = 48, 27
ENV = 0.1
OPTIONS = {"compact": dict(compact=True), "chunks2": dict(trace_chunks=2),
           "no-filter": dict(infer_filter=False)}


def _cfgs(**kw):
    kw = dict(render_width=W, render_height=H, nn_width=16, nn_depth=2,
              log2_train_batch_size=8, train_batch_count=2,
              mc_path_length=8, **kw)
    return (jcfg.AppConfig(encoding=jcfg.EncodingConfig(
                n_levels=4, log2_hashmap_size=12), **kw),
            tcfg.AppConfig(encoding=tcfg.EncodingConfig(
                n_levels=4, log2_hashmap_size=12), **kw))


def _volumes():
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    return (JVolume.from_dense(data, 0.6, 0.8),
            TVolume.from_dense(data, 0.6, 0.8, device="cpu"))


def _cams():
    return (jcam.Camera.reference_camera(W / H),
            tcam.Camera.reference_camera(W / H, device="cpu"))


def _scattered(img, w_channel):
    if w_channel:
        return img[..., 3] > 0
    return np.abs(img[..., :3] - ENV).max(-1) > 1e-6


def _same_frame(timg, jimg, w_channel=False):
    assert timg.shape == jimg.shape and np.isfinite(timg).all()
    agree = _scattered(timg, w_channel) == _scattered(jimg, w_channel)
    assert agree.mean() >= 0.99, f"did_scatter agrees on {agree.mean():.4f}"
    assert 0.05 < _scattered(timg, w_channel).mean() < 0.95
    err = np.abs(timg - jimg).max(-1)
    assert err[agree].max() <= 1e-3, "image within 1e-3 on agreeing pixels"


def _same_up_to_ulps(timg, bimg, w_channel=False):
    assert np.array_equal(_scattered(timg, w_channel),
                          _scattered(bimg, w_channel))
    assert np.abs(timg - bimg).max() <= 1e-6


def _same_key(ts, js):
    assert np.array_equal(ts.key.numpy(), np.asarray(js.key).astype(np.int64))


def _lower_compaction(monkeypatch):
    """COMPACT_MIN_LANES at 256 in both packages: at 48x27 (and in
    chunks of it) the compaction capacities and staged schedules run."""
    for mod in (jint, jtr, ttr):
        monkeypatch.setattr(mod, "COMPACT_MIN_LANES", 256)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_nrc_frames_with_option_match_jax(option):
    """A frozen frame, then two online frames, from init_state(1)."""
    jc, tc = _cfgs(**OPTIONS[option])
    jv, tv = _volumes()
    jr, tr = jren.NrcRenderer(jc, vol=jv), tren.NrcRenderer(tc, tv)
    jc_, tc_ = _cams()
    js, ts = jr.init_state(1), tr.init_state(1)
    for train in (False, True, True):
        js, ts = jr.step(js, jc_, train=train), tr.step(ts, tc_, train=train)
        _same_frame(ts.image.numpy(), np.asarray(js.image))
        _same_key(ts, js)
        assert ts.nrc.step == int(js.nrc.step)
        assert (int(ts.ring.head), int(ts.ring.tail)) == (
            int(js.ring.head), int(js.ring.tail))
        np.testing.assert_allclose(float(ts.nrc.loss), float(js.nrc.loss),
                                   rtol=1e-4)
    assert ts.nrc.step == 4 and np.isfinite(float(ts.nrc.loss))


@pytest.mark.parametrize("option", list(OPTIONS))
def test_nrc_frame_with_option_matches_the_default(option):
    """The option leaves the frame as it is: the frozen and the online
    frame against the port's default ones from the same seed, up to ulps
    for ``infer_filter=False`` (the composite reads the scattered pixels
    only) and ``trace_chunks=2`` (every chunk runs the schedule of the
    whole batch below COMPACT_MIN_LANES); under the frame rule for
    ``compact`` (its trackers see fewer lanes)."""
    _, tc = _cfgs(**OPTIONS[option])
    _, base = _cfgs()
    _, tv = _volumes()
    tr, tb = tren.NrcRenderer(tc, tv), tren.NrcRenderer(base, tv)
    cam = _cams()[1]
    ts, tbs = tr.init_state(2), tb.init_state(2)
    for train in (False, True):
        ts, tbs = tr.step(ts, cam, train=train), tb.step(tbs, cam,
                                                         train=train)
        if option == "compact":
            _same_frame(ts.image.numpy(), tbs.image.numpy())
        else:
            _same_up_to_ulps(ts.image.numpy(), tbs.image.numpy())
            np.testing.assert_allclose(float(ts.nrc.loss),
                                       float(tbs.nrc.loss), rtol=1e-6)


def test_nrc_chunked_compacted_frame_matches_jax(monkeypatch):
    """trace_chunks=3 (432 lanes a chunk) with the compaction threshold
    lowered: each chunk's trackers stage their segments for the chunk's
    own lane count, in both packages."""
    _lower_compaction(monkeypatch)
    jc, tc = _cfgs(trace_chunks=3)
    jv, tv = _volumes()
    jr, tr = jren.NrcRenderer(jc, vol=jv), tren.NrcRenderer(tc, tv)
    jc_, tc_ = _cams()
    js = jr.step(jr.init_state(3), jc_, train=False)
    ts = tr.step(tr.init_state(3), tc_, train=False)
    _same_frame(ts.image.numpy(), np.asarray(js.image))
    _same_key(ts, js)


@pytest.mark.parametrize("lowered", [False, True], ids=["whole", "staged"])
def test_mc_chunked_frames_match_jax(monkeypatch, lowered):
    """MC frames at trace_chunks=2 (648 lanes a chunk): against JAX's,
    and against the port's unchunked frames (up to ulps unless the
    lowered threshold gives the chunks their own staged schedules)."""
    if lowered:
        _lower_compaction(monkeypatch)
    jc, tc = _cfgs(trace_chunks=2)
    _, base = _cfgs()
    jv, tv = _volumes()
    jr, tr = jren.McRenderer(jc, vol=jv), tren.McRenderer(tc, tv)
    tb = tren.McRenderer(base, tv)
    jc_, tc_ = _cams()
    js, ts, tbs = jr.init_state(4), tr.init_state(4), tb.init_state(4)
    for _ in range(2):
        js, ts, tbs = jr.step(js, jc_), tr.step(ts, tc_), tb.step(tbs, tc_)
        _same_frame(ts.image.numpy(), np.asarray(js.image), w_channel=True)
        _same_key(ts, js)
        if lowered:
            _same_frame(ts.image.numpy(), tbs.image.numpy(), w_channel=True)
        else:
            _same_up_to_ulps(ts.image.numpy(), tbs.image.numpy(),
                             w_channel=True)


def test_map_chunks():
    """Leading-axis chunks, outputs concatenated (a tuple or a dict); a
    count that does not divide runs one chunk."""
    calls = []

    def fn(a, b):
        calls.append(a.shape[0])
        return dict(s=a + b, p=a * b)

    a, b = torch.arange(12.0), torch.ones(12)
    out = tren._map_chunks(fn, 3, a, b)
    assert calls == [4, 4, 4] and torch.equal(out["s"], a + b)
    assert torch.equal(out["p"], a)
    calls.clear()
    tren._map_chunks(fn, 5, a, b)
    assert calls == [12]
    tup = tren._map_chunks(lambda x: (x, x[:, None]), 4, a)
    assert torch.equal(tup[0], a) and tup[1].shape == (12, 1)


def test_compact_primary_pass_traces_only_box_hits(monkeypatch):
    """``primary_pass_compact`` hands trace_primary the box-hitting lanes
    only; the other pixels show the env with throughput 1 and zero
    queries."""
    _, tc = _cfgs(compact=True)
    _, tv = _volumes()
    tr = tren.NrcRenderer(tc, tv)
    seen = []
    trace = tren.trace_primary

    def record(s, vol, lights, p, ro, rd, cfg, active=None):
        seen.append(ro.shape[0])
        return trace(s, vol, lights, p, ro, rd, cfg, active)

    monkeypatch.setattr(tren, "trace_primary", record)
    cam = _cams()[1]
    ro, rd, uv = tcam.pixel_rays(cam, W, H)
    n = W * H
    o, d = ro.expand(n, 3), rd.reshape(n, 3)
    hit = ~tint.primary_miss_mask(tv, o, d)
    prim = tr.primary(torch.rand(n), o, d)
    assert seen == [int(hit.sum())] and 0 < seen[0] < n
    miss = ~hit
    assert (prim["primary_color"][miss] == torch.tensor(
        [ENV, ENV, ENV, 1.0])).all()
    assert not prim["did_scatter"][miss].any()
    assert not prim["nrc_pos"][miss].any()
