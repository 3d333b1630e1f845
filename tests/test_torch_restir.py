"""The port's ReSTIR renderer (``nrc_hpm_tpu_torch.models.restir``) and
the masked, 3-argument ``integrator.trace_scene`` against the JAX
package: 48x27 pixels, the 8^3 heterogeneous volume passed to both
renderers explicitly (without one they load the WDAS cloud), 4 path
vertices (the default 8 in one run), frames seeded through
``init_state``.

Tolerances.  The key chain, the frame counter and the pixel info are
bitwise.  The stages draw the same Jenkins-hash uniforms, so they differ
only where an ulp of float math flips a decision (a density test, a
selection ``u < w / wsum``): the stats (stream index, exchange vertex)
must agree on >= 99% of pixels, the reservoir on >= 99% of pixels within
1e-4 + 1e-4|ref| world units, and on the pixels whose stats agree the
image within 1e-3 + 1e-3|ref|.  The relative term is there because a
ReSTIR pixel's radiance reaches ~60 (the HG phase at g = 0.8 peaks at 3.6
and the RIS weight W multiplies it); the absolute 1e-3 is the port's
frame rule.  RNG states are bitwise on >= 99% of lanes.  ``trace_scene``:
rgb within 1e-5 + 1e-5|ref| on >= 99% of lanes (the trackers' rule is
1e-6 on a transmittance; a lane's rgb sums phase-weighted lights), the
state bitwise."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import camera as jcam
from nrc_hpm_tpu import config as jcfg
from nrc_hpm_tpu import integrator as jint
from nrc_hpm_tpu.lights import LightFlags as JLightFlags
from nrc_hpm_tpu.lights import lights_from_scene as jlights
from nrc_hpm_tpu.models import restir as jre
from nrc_hpm_tpu.utils import rng as jrng
from nrc_hpm_tpu.volume import Volume as JVolume
from nrc_hpm_tpu_torch import camera as tcam
from nrc_hpm_tpu_torch import config as tcfg
from nrc_hpm_tpu_torch import integrator as tint
from nrc_hpm_tpu_torch import transmittance as ttr
from nrc_hpm_tpu_torch.lights import LightFlags, lights_from_scene
from nrc_hpm_tpu_torch.models import restir as tre
from nrc_hpm_tpu_torch.utils import rng as trng
from nrc_hpm_tpu_torch.volume import Volume as TVolume

W, H = 48, 27
V = 4
FRAMES = 4
FRAME_RAND = np.array([0.1, 0.35, 0.6, 0.85], np.float32)
# dir + point + env: no preset has both a dir and a point light
MIXED = dict(dir_light_strength=8.0, point_light_strength=64.0,
             hdr_env_map_strength=0.1, density=0.6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _volumes():
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    return (JVolume.from_dense(data, 0.6, 0.8),
            TVolume.from_dense(data, 0.6, 0.8, device="cpu"))


def _cams():
    return (jcam.Camera.reference_camera(W / H),
            tcam.Camera.reference_camera(W / H, device="cpu"))


def _scene(kind):
    """(JAX SceneConfig, port SceneConfig): a preset id or MIXED."""
    if kind == "mixed":
        return jcfg.SceneConfig(**MIXED), tcfg.SceneConfig(**MIXED)
    return jcfg.SceneConfig.preset(kind), tcfg.SceneConfig.preset(kind)


def _cfgs(v=V, mis=True, scene=4):
    js, ts = _scene(scene)
    kw = dict(render_width=W, render_height=H)
    return (jcfg.AppConfig(scene=js, restir=jcfg.RestirConfig(
                path_vertex_count=v, mis_weights=mis), **kw),
            tcfg.AppConfig(scene=ts, restir=tcfg.RestirConfig(
                path_vertex_count=v, mis_weights=mis), **kw))


def _np_state(js) -> dict:
    return {k: np.array(getattr(js, k)) for k in
            ("image", "pixel_info", "stats", "reservoir", "old_reservoirs",
             "frame", "key")}


def _close(got, want, atol, rtol):
    return np.abs(got - want) <= atol + rtol * np.abs(want)


def _same_stats(got, want):
    """Per-pixel agreement of the stats; >= 99% of pixels."""
    agree = (got == want).all(-1)
    assert agree.mean() >= 0.99, f"stats agree on {agree.mean():.4f}"
    return agree


def _same_reservoir(got, want):
    ok = _close(got, want, 1e-4, 1e-4).reshape(got.shape[:2] + (-1,))
    share = ok.all(-1).mean()
    assert share >= 0.99, f"reservoir agrees on {share:.4f} of pixels"


def _same_image(got, want, agree):
    assert got.shape == want.shape and np.isfinite(got).all()
    ok = _close(got, want, 1e-3, 1e-3).all(-1)
    assert ok[agree].all(), (
        f"image off on {(~ok[agree]).sum()} agreeing pixels, max err "
        f"{np.abs(got - want).max(-1)[agree].max():.3e}")


def _same_rng(got, want):
    same = got.view(np.uint32) == want.view(np.uint32)
    assert same.mean() >= 0.99, f"rng states agree on {same.mean():.4f}"


def _same_state(ts, js: dict):
    """The frame rule on a port state against a JAX state's numpy copy."""
    assert np.array_equal(ts.key.numpy(), js["key"].astype(np.int64))
    assert ts.frame == int(js["frame"])
    assert np.array_equal(ts.pixel_info.numpy(), js["pixel_info"])
    agree = _same_stats(ts.stats.numpy(), js["stats"])
    _same_reservoir(ts.reservoir.numpy(), js["reservoir"])
    _same_image(ts.image.numpy(), js["image"], agree)


def _run_both(v=V, mis=True, scene=4, frames=FRAMES):
    """JAX and port renderers from init_state(0): every frame's JAX state
    (numpy, copied before the next step, which donates it) and port
    state."""
    jc, tc = _cfgs(v, mis, scene)
    jv, tv = _volumes()
    # the JAX renderer shows each frame alone
    jr = jre.RestirRenderer(jc, vol=jv)
    tr = tre.RestirRenderer(tc, tv, blend=False)
    jcm, tcm = _cams()
    js, ts = jr.init_state(0), tr.init_state(0)
    out = [(_np_state(js), ts)]
    for _ in range(frames):
        js, ts = jr.step(js, jcm), tr.step(ts, tcm)
        out.append((_np_state(js), ts))
    return out


@pytest.fixture(scope="module")
def runs():
    """{mis_weights: [(JAX state, port state) for init and 4 frames]}."""
    return {mis: _run_both(mis=mis) for mis in (True, False)}


@pytest.mark.parametrize("mis", [True, False], ids=["mis", "uniform"])
def test_restir_frames_match_jax(runs, mis):
    """Frame 0 (temporal reuse a no-op), frame 1, and frames 2-3 with a
    filled ring."""
    seq = runs[mis]
    js0, ts0 = seq[0]
    assert np.array_equal(ts0.key.numpy(), js0["key"].astype(np.int64))
    assert ts0.old_reservoirs.shape == (2, H, W, V, 6)
    for js, ts in seq[1:]:
        _same_state(ts, js)
    img = seq[-1][1].image.numpy()
    scat = seq[-1][1].pixel_info[..., 3].numpy() == 1.0
    assert 0.05 < scat.mean() < 0.99
    # shaded pixels carry light
    assert (img[scat, :3].sum(-1) > 0).mean() > 0.9


def test_restir_border_pixels_are_the_env(runs):
    """Border rays miss the box: the env colour, transmittance 1, no
    scatter; so does every pixel that never scattered."""
    for js, ts in runs[True][1:]:
        img = ts.image.numpy()
        for y, x in ((0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1)):
            assert img[y, x].tolist() == pytest.approx([0.1, 0.1, 0.1, 1.0],
                                                       abs=1e-7)
            assert ts.pixel_info[y, x, 3] == 0.0
        # every pixel that never scattered shows the background exactly
        miss = ts.pixel_info[..., 3].numpy() == 0.0
        assert miss.any() and np.array_equal(img[miss], js["image"][miss])
        assert (img[miss] == np.float32([0.1, 0.1, 0.1, 1.0])).all()


def test_restir_default_eight_vertices_match_jax():
    """``AppConfig()``'s ReSTIR (8 vertices, 3x3, 2 slots, MIS) for four
    frames."""
    seq = _run_both(v=8, frames=FRAMES)
    assert tcfg.AppConfig().restir == tcfg.RestirConfig(8, 3, 2, True)
    for js, ts in seq[1:]:
        _same_state(ts, js)


@pytest.mark.parametrize("scene", ["mixed", 5], ids=["dir-point-env",
                                                     "env-only"])
def test_restir_scenes_match_jax(scene):
    """Two shadow segments a vertex (dir and point), and preset 5, where
    only the fixed-step env term lights a vertex."""
    for js, ts in _run_both(scene=scene, frames=3)[1:]:
        _same_state(ts, js)


def test_env_only_shading_tracks_nothing(monkeypatch, runs):
    """Preset 5: the 3-argument env term ratio-tracks nothing, so the
    shading pass calls no tracker (on the card: launches no K1/K2)."""
    calls = []
    for name in ("pw_profile", "pw_events"):
        fn = getattr(ttr, name)
        monkeypatch.setattr(ttr, name, lambda *a, _fn=fn, _n=name, **k:
                            calls.append(_n) or _fn(*a, **k))
    _, tc = _cfgs(scene=5)
    _, tv = _volumes()
    tr = tre.RestirRenderer(tc, tv, blend=False)
    img = tr.render(_cams()[1], frames=2).numpy()
    assert calls == [] and np.isfinite(img).all()
    _, tc = _cfgs(scene=4)
    tre.RestirRenderer(tc, tv, blend=False).render(_cams()[1], frames=1)
    assert set(calls) == {"pw_profile", "pw_events"}


# --- the stages on the same inputs -------------------------------------------

def _seeds():
    jcm, tcm = _cams()
    _, _, uv = jcam.pixel_rays(jcm, W, H)
    js = jrng.init_state(uv, jnp.asarray(FRAME_RAND))
    _, _, tuv = tcam.pixel_rays(tcm, W, H)
    ts = trng.init_state(tuv, _t(FRAME_RAND))
    assert np.array_equal(np.asarray(js).view(np.uint32),
                          ts.numpy().view(np.uint32))
    return js, ts


@pytest.fixture(scope="module")
def stage_inputs(runs):
    """The inputs of frame 3's stages: the JAX state after frame 2 and
    the JAX stages' outputs in order, as numpy."""
    prev = runs[True][3][0]
    jv, _ = _volumes()
    jl = jlights(jcfg.SceneConfig.preset(4))
    jcm, _ = _cams()
    ro, rd, _ = jcam.pixel_rays(jcm, W, H)
    rs, _ = _seeds()
    li = jax.jit(partial(jre._local_init, n_vertices=V))(
        rs, jv, jl, jnp.broadcast_to(ro, rd.shape), rd,
        jnp.asarray(prev["reservoir"]))
    res, pinfo, stats = (np.array(a) for a in li[:3])
    return dict(prev=prev, res=res, pinfo=pinfo, stats=stats,
                rd=np.array(rd))


def test_local_init_matches_jax(stage_inputs):
    s = stage_inputs
    jv, tv = _volumes()
    jcm, tcm = _cams()
    rs, trs = _seeds()
    ro, rd, _ = jcam.pixel_rays(jcm, W, H)
    want = jax.jit(partial(jre._local_init, n_vertices=V))(
        rs, jv, jlights(jcfg.SceneConfig.preset(4)),
        jnp.broadcast_to(ro, rd.shape), rd, jnp.asarray(s["prev"]["reservoir"]))
    tro, trd, _ = tcam.pixel_rays(tcm, W, H)
    got = tre._local_init(trs, tv, lights_from_scene(
        tcfg.SceneConfig.preset(4), device="cpu"), tro.expand(trd.shape),
        trd, _t(s["prev"]["reservoir"]), V)
    _same_reservoir(got[0].numpy(), np.array(want[0]))
    assert np.array_equal(got[1].numpy(), np.array(want[1]))
    assert np.array_equal(got[2].numpy(), np.array(want[2]))
    _same_rng(got[3].numpy(), np.array(want[3]))
    # misses keep the previous reservoir
    miss = s["pinfo"][..., 3] == 0.0
    corner = got[0].numpy()[0, 0]
    assert miss[0, 0] and np.array_equal(corner,
                                         s["prev"]["reservoir"][0, 0])


@pytest.mark.parametrize("frame", [0, 1, 3])
@pytest.mark.parametrize("weighted", [True, False], ids=["mis", "uniform"])
def test_temporal_reuse_matches_jax(stage_inputs, frame, weighted):
    """Frame 0 splices nothing; at frame 1 only slot 0 is valid; at frame
    3 ((3 - 2) % 2 = 1, (3 - 1) % 2 = 0) the ring is full and the t = 1
    splice reads the slot just written (the reference-side fault)."""
    s = stage_inputs
    jv, _ = _volumes()
    rs, trs = _seeds()
    mis = np.zeros((H, W, 2), np.float32)
    fn = jax.jit(lambda rs, res, old, st, m, pi, fr, g: jre._temporal_reuse(
        rs, res, old, st, m, pi, fr, V, 2, g=g, weighted=weighted))
    want = fn(rs, s["res"], s["prev"]["old_reservoirs"], s["stats"], mis,
              s["pinfo"], jnp.int32(frame), jv.g)
    got = tre._temporal_reuse(trs, _t(s["res"]),
                              _t(s["prev"]["old_reservoirs"]),
                              _t(s["stats"]), _t(mis), _t(s["pinfo"]),
                              frame, V, 2, g=0.8, weighted=weighted)
    _same_reservoir(got[0].numpy(), np.array(want[0]))
    for k in range(2):
        _same_reservoir(got[1][k].numpy(), np.array(want[1][k]))
    _same_stats(got[2].numpy(), np.array(want[2]))
    agree = (got[2].numpy() == np.array(want[2])).all(-1)
    assert _close(got[3].numpy(), np.array(want[3]), 1e-5,
                  1e-5).all(-1)[agree].all()
    _same_rng(got[4].numpy(), np.array(want[4]))
    if frame == 0:
        assert np.array_equal(got[0].numpy(), s["res"])
    else:
        assert not np.array_equal(got[0].numpy(), s["res"])


@pytest.mark.parametrize("weighted", [True, False], ids=["mis", "uniform"])
def test_spatial_reuse_matches_jax(stage_inputs, weighted):
    s = stage_inputs
    jv, _ = _volumes()
    rs, trs = _seeds()
    mis = np.random.RandomState(3).rand(H, W, 2).astype(np.float32)
    fn = jax.jit(lambda rs, res, st, m, pi, g: jre._spatial_reuse(
        rs, res, st, m, pi, V, 3, H, W, g=g, weighted=weighted))
    want = fn(rs, s["res"], s["stats"], mis, s["pinfo"], jv.g)
    got = tre._spatial_reuse(trs, _t(s["res"]), _t(s["stats"]), _t(mis),
                             _t(s["pinfo"]), V, 3, H, W, g=0.8,
                             weighted=weighted)
    _same_reservoir(got[0].numpy(), np.array(want[0]))
    agree = _same_stats(got[1].numpy(), np.array(want[1]))
    assert _close(got[2].numpy(), np.array(want[2]), 1e-5,
                  1e-5).all(-1)[agree].all()
    _same_rng(got[3].numpy(), np.array(want[3]))
    moved = ~np.isclose(got[0].numpy(), s["res"]).all((-1, -2))
    assert moved.any()
    # two scattered pixels that are neighbours only across the wrap
    # (rows 0 and H - 1): neither streams nor splices
    lone = np.zeros_like(s["pinfo"])
    lone[0, 5, 3] = lone[H - 1, 5, 3] = 1.0
    res, st, _, _ = tre._spatial_reuse(trs, _t(s["res"]), _t(s["stats"]),
                                       _t(mis), _t(lone), V, 3, H, W, g=0.8,
                                       weighted=weighted)
    assert torch.equal(res, _t(s["res"])) and torch.equal(st,
                                                          _t(s["stats"]))


@pytest.mark.parametrize("with_mis", [True, False], ids=["W", "no-W"])
def test_shade_matches_jax(runs, with_mis):
    """The shading pass on frame 3's reservoir, stats and pixel info,
    with the RIS weight W from random accumulators (one pixel w_sel 0)
    or without it."""
    prev = runs[True][3][0]
    jv, tv = _volumes()
    rs, trs = _seeds()
    mis = np.random.RandomState(5).rand(H, W, 2).astype(np.float32) + 0.1
    mis[5, 5, 1] = 0.0
    jparams = jint.TraceParams(
        flags=JLightFlags.from_scene(jcfg.SceneConfig.preset(4)))
    tparams = tint.TraceParams(
        flags=LightFlags.from_scene(tcfg.SceneConfig.preset(4)))
    jm = jnp.asarray(mis) if with_mis else None
    want = jax.jit(lambda rs, vol, lights, res, st, pi: jre._shade(
        rs, vol, lights, jparams, res, st, pi, V, mis=jm))(
        rs, jv, jlights(jcfg.SceneConfig.preset(4)), prev["reservoir"],
        prev["stats"], prev["pixel_info"])
    got = tre._shade(trs, tv, lights_from_scene(tcfg.SceneConfig.preset(4),
                                                device="cpu"),
                     tparams, _t(prev["reservoir"]), _t(prev["stats"]),
                     _t(prev["pixel_info"]), V,
                     mis=_t(mis) if with_mis else None)
    agree = np.ones((H, W), bool)
    _same_image(got[0].numpy(), np.array(want[0]), agree)
    _same_rng(got[1].numpy(), np.array(want[1]))


# --- trace_scene: the masked and the 3-argument forms ------------------------

def _scene_inputs(lead, seed=7):
    r = np.random.RandomState(seed)
    pos = r.uniform(-12.0, 12.0, lead + (3,)).astype(np.float32)
    d = r.normal(size=lead + (3,)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    e = r.normal(size=lead + (3,)).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    state = r.rand(*lead).astype(np.float32)
    active = r.rand(*lead) < 0.7
    return pos, d, e, state, active


@pytest.mark.parametrize("env_dir", [True, False], ids=["env-dir", "drawn"])
@pytest.mark.parametrize("lead", [(H, W), (H * W,)], ids=["image", "flat"])
@pytest.mark.parametrize("scene", ["mixed", 4, 5, 1],
                         ids=["dir-point-env", "p4", "p5", "p1"])
def test_trace_scene_masked_matches_jax(scene, lead, env_dir):
    """(H, W) image lanes track their segments one after the other, (N,)
    lanes batch them (pw); masked lanes draw nothing and ride along."""
    jsc, tsc = _scene(scene)
    jv, tv = _volumes()
    pos, d, e, state, active = _scene_inputs(lead)
    jp = jint.TraceParams(flags=JLightFlags.from_scene(jsc))
    tp = tint.TraceParams(flags=LightFlags.from_scene(tsc))
    fn = jax.jit(lambda s, vol, lights, p_, d_, a, e_: jint.trace_scene(
        s, vol, lights, jp, p_, d_, a, env_dir=e_))
    want = fn(state, jv, jlights(jsc), pos, d, active,
              e if env_dir else None)
    got = tint.trace_scene(_t(state), tv, lights_from_scene(tsc,
                                                            device="cpu"),
                           tp, _t(pos), _t(d), _t(active),
                           env_dir=_t(e) if env_dir else None)
    rgb, wrgb = got[0].numpy(), np.array(want[0])
    assert rgb.shape == lead + (3,)
    ok = _close(rgb, wrgb, 1e-5, 1e-5).all(-1)
    assert ok.mean() >= 0.99, f"rgb agrees on {ok.mean():.4f}"
    assert np.array_equal(got[1].numpy().view(np.uint32),
                          np.array(want[1]).view(np.uint32))


@pytest.mark.parametrize("mode", ["pw", "fast", "seq"])
def test_trace_scene_masked_modes_match_jax(mode):
    """The masked (N,) form of the scene phase in each tracking mode."""
    jsc, tsc = _scene("mixed")
    jv, tv = _volumes()
    pos, d, _, state, active = _scene_inputs((512,), seed=9)
    jp = jint.TraceParams(flags=JLightFlags.from_scene(jsc), mode=mode)
    tp = tint.TraceParams(flags=LightFlags.from_scene(tsc), mode=mode)
    want = jax.jit(lambda s, vol, lights, p_, d_, a: jint.trace_scene(
        s, vol, lights, jp, p_, d_, a))(state, jv, jlights(jsc), pos, d,
                                        active)
    got = tint.trace_scene(_t(state), tv, lights_from_scene(tsc,
                                                            device="cpu"),
                           tp, _t(pos), _t(d), _t(active))
    ok = _close(got[0].numpy(), np.array(want[0]), 1e-5, 1e-5).all(-1)
    assert ok.mean() >= 0.99, f"rgb agrees on {ok.mean():.4f}"
    _same_rng(got[1].numpy(), np.array(want[1]))


def test_restir_renderer_api():
    """init_state's buffers and key, render's last frame, and the
    configuration's cloud loaded when no volume is given."""
    _, tc = _cfgs()
    _, tv = _volumes()
    tr = tre.RestirRenderer(tc, tv, width=16, height=9, blend=False)
    st = tr.init_state(7)
    assert st.frame == 0 and st.reservoir.shape == (9, 16, V, 6)
    assert st.stats.shape == (9, 16, 2) and not st.image.any()
    assert st.key.tolist() == [0, 7]
    cam = tcam.Camera.reference_camera(16 / 9, device="cpu")
    a = tr.render(cam, frames=2, seed=1)
    assert torch.equal(a, tr.step(tr.step(tr.init_state(1), cam), cam).image)
    with pytest.raises(FileNotFoundError):
        tre.RestirRenderer(tc, device="cpu", blend=False)
