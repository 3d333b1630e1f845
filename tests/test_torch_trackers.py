"""The port's ``seq`` and ``fast`` trackers, ``get_density``,
``Volume.homogeneous_cube`` and ``trace_fixed`` in each tracking mode
against the JAX package.

Tolerances: the RNG state, the exit/alive/did_scatter flags, the density
samples and the cube's grid are bitwise.  Transmittances and positions
are float results of the same draws: the JAX package's CPU compile
computes ``log``/``log1p`` with its own approximation (it differs from
torch's in the last bit on ~14% of float32 inputs) and contracts
multiply-adds into FMAs, so they agree to a few ulps (transmittance
within 1e-6, track positions within 1e-4 world units).  Whole paths
agree as the port's other path tests hold them: >= 99% of lanes within
1e-3 + 1e-3|ref| in radiance and terminal point.  The analytic cases
are the JAX package's own (``tests/test_transmittance.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import camera as jcam
from nrc_hpm_tpu import integrator as jint
from nrc_hpm_tpu import transmittance as jtr
from nrc_hpm_tpu import volume as jvol
from nrc_hpm_tpu.config import SceneConfig as JSceneConfig
from nrc_hpm_tpu.lights import LightFlags as JLightFlags
from nrc_hpm_tpu.lights import lights_from_scene as jlights
from nrc_hpm_tpu.utils import rng as jrng
from nrc_hpm_tpu_torch import camera as tcam
from nrc_hpm_tpu_torch import integrator as tint
from nrc_hpm_tpu_torch import transmittance as ttr
from nrc_hpm_tpu_torch import volume as tvol
from nrc_hpm_tpu_torch.config import SceneConfig
from nrc_hpm_tpu_torch.lights import LightFlags, lights_from_scene
from nrc_hpm_tpu_torch.utils import rng as trng

N = 1024
W, H = 48, 27


def _volumes(scale=1.0, density_factor=0.6):
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    return (jvol.Volume.from_dense(data * scale, density_factor, 0.8),
            tvol.Volume.from_dense(data * scale, density_factor, 0.8,
                                   device="cpu"))


def _rays(seed):
    r = np.random.RandomState(seed)
    start = r.uniform(-40.0, 40.0, (N, 3)).astype(np.float32)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    end = (start + d * r.uniform(1.0, 80.0, (N, 1))).astype(np.float32)
    state = r.rand(N).astype(np.float32)
    active = r.rand(N) < 0.9
    return start, d, end, state, active


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_get_density_matches_jax():
    jv, tv = _volumes()
    pos = np.random.RandomState(1).uniform(-45.0, 45.0, (4096, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jvol.get_density)(jv, jnp.asarray(pos)))
    got = tvol.get_density(tv, _t(pos)).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    half = np.asarray(jv.sky_size) / 2
    outside = (np.abs(pos) >= half).any(-1)
    assert outside.any() and (got[outside] == 0).all(), "black border"
    assert (got[~outside] > 0).mean() > 0.9


def test_homogeneous_cube_matches_jax():
    jv = jvol.Volume.homogeneous_cube(4, 128.5 / 255, 0.8, 0.3)
    tv = tvol.Volume.homogeneous_cube(4, 128.5 / 255, 0.8, 0.3,
                                      device="cpu")
    assert np.array_equal(tv.grid.numpy(), np.asarray(jv.grid))
    assert np.array_equal(_bits(tv.sky_size.numpy()), _bits(jv.sky_size))
    assert np.array_equal(tv.macro_packed.numpy().view(np.uint32),
                          np.asarray(jv.macro_packed))
    assert (tv.density_factor, tv.g) == (float(jv.density_factor),
                                         float(jv.g))


TRACKERS = ("ratio_track", "ratio_track_fast", "delta_track",
            "delta_track_fast")


@pytest.mark.parametrize("masked", [False, True], ids=["all", "active"])
@pytest.mark.parametrize("name", TRACKERS)
def test_trackers_match_jax(name, masked):
    fast = name.endswith("_fast")
    delta = name.startswith("delta")
    # the delta cases in a thinner medium, so that some flights exit
    jv, tv = _volumes(density_factor=0.05 if delta else 0.6)
    start, d, end, state, active = _rays(3)
    kw_j = dict(segment=8) if fast else {}
    kw_t = dict(kw_j)
    if masked:
        kw_j["active"] = jnp.asarray(active)
        kw_t["active"] = _t(active)
    args = (start * 0.5, d) if delta else (start, end)
    out_j = getattr(jtr, name)(jnp.asarray(state), jv,
                               *map(jnp.asarray, args), **kw_j)
    out_t = getattr(ttr, name)(_t(state), tv, *map(_t, args), **kw_t)
    assert np.array_equal(_bits(out_t[-1].numpy()), _bits(out_j[-1])), \
        "RNG state bitwise"
    if delta:
        (pj, ej, _), (pt, et, _) = out_j, out_t
        assert np.array_equal(et.numpy(), np.asarray(ej)), "exit flags"
        assert 0.02 < et.numpy().mean() < 0.98, "some flights exit"
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                                   atol=1e-4)
    else:
        tj, tt = np.asarray(out_j[0]), out_t[0].numpy()
        assert 0.05 < (tj < 0.999).mean(), "the segments cross the medium"
        np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-6)
        if masked:
            assert np.all(tt[~active] == 1.0), "inactive lanes transmit 1"
    if masked and not fast:
        # masked draws: inactive lanes keep their state
        assert np.array_equal(_bits(out_t[-1].numpy()[~active]),
                              _bits(state[~active]))


def _states(n, salt=0.123):
    uv = torch.stack([torch.linspace(0, 1, n), torch.linspace(1, 0, n)], -1)
    return trng.init_state(uv, torch.tensor([salt, 0.57, 0.31, 0.77]))


@pytest.mark.parametrize("name", ["ratio_track", "ratio_track_fast"])
def test_ratio_trackers_unbiased_homogeneous(name):
    vol = tvol.Volume.homogeneous_cube(4, 128.5 / 255, 0.8, 0.0,
                                       device="cpu")
    sky = vol.sky_host[0]
    n = 20000
    start = torch.tensor([-sky / 2 + 0.2, 0.0, 0.0]).expand(n, 3)
    end = torch.tensor([sky / 2 - 0.2, 0.0, 0.0]).expand(n, 3)
    t, _ = getattr(ttr, name)(_states(n), vol, start, end)
    expect = np.exp(-0.8 * 128 / 255 * (sky - 0.4))
    assert abs(float(t.mean()) - expect) < 0.02 * max(expect, 0.02) + 0.005


@pytest.mark.parametrize("name", ["delta_track", "delta_track_fast"])
def test_delta_trackers_free_path_homogeneous(name):
    vol = tvol.Volume.homogeneous_cube(4, 1.0, 0.15, 0.0, device="cpu")
    sky = vol.sky_host[0]
    n = 40000
    ro = torch.tensor([-sky / 2, 0.0, 0.0]).expand(n, 3)
    rd = torch.tensor([1.0, 0.0, 0.0]).expand(n, 3)
    pos, exited, _ = getattr(ttr, name)(_states(n), vol, ro, rd)
    p_exit = np.exp(-0.15 * sky)
    assert abs(float(exited.float().mean()) - p_exit) < 0.01
    dist = torch.linalg.vector_norm(pos - ro, dim=-1)[~exited]
    mean_trunc = 1 / 0.15 - sky * p_exit / (1 - p_exit)
    assert abs(float(dist.mean()) - mean_trunc) < 0.3


def test_fixed_step_homogeneous_analytic():
    vol = tvol.Volume.homogeneous_cube(4, 1.0, 0.5, 0.0, device="cpu")
    sky = vol.sky_host[0]
    start = torch.tensor([[-sky / 2 + 0.1, 0.0, 0.0]])
    end = torch.tensor([[sky / 2 - 0.1, 0.0, 0.0]])
    t = float(ttr.fixed_step_transmittance(vol, start, end, 64)[0])
    assert abs(t - np.exp(-0.5 * (sky - 0.2))) < 0.02


@pytest.mark.parametrize("name", ["ratio_track", "ratio_track_fast"])
def test_ratio_trackers_vacuum_is_one(name):
    vol = tvol.Volume.homogeneous_cube(4, 0.0, 0.6, 0.0, device="cpu")
    start = torch.zeros(64, 3)
    end = torch.tensor([10.0, 0.0, 0.0]).expand(64, 3)
    t, _ = getattr(ttr, name)(_states(64), vol, start, end)
    assert bool((t == 1.0).all())


def test_trace_params_modes():
    flags = LightFlags.from_scene(SceneConfig.preset(4))
    for mode in tint.MODES:
        p = tint.TraceParams(flags=flags, mode=mode)
        assert callable(p.ratio_track) and callable(p.delta_track)
        assert ("plan_lanes" in p.plan(7)) == (mode == "pw")
    with pytest.raises(ValueError):
        tint.TraceParams(flags=flags, mode="fastest")


@pytest.mark.parametrize("min_lanes", [None, 256],
                         ids=["full-batch", "compacted"])
@pytest.mark.parametrize("scene", [4, 1])
@pytest.mark.parametrize("mode", tint.MODES)
def test_trace_fixed_modes_match_jax(monkeypatch, mode, scene, min_lanes):
    """8 bounces on the pixel rays of a 48x27 frame (misses inactive).
    Scene 4 has a directional light and the env (two shadow segments:
    batched in pw/fast, the reference's order in seq), scene 1 a point
    light.  ``compacted`` lowers COMPACT_MIN_LANES in both packages so
    the JAX package's compacted phases and staged schedules run at this
    size: the dead lanes' RNG advance must follow each mode."""
    if min_lanes is not None:
        for mod in (jint, jtr, ttr):
            monkeypatch.setattr(mod, "COMPACT_MIN_LANES", min_lanes)
    jv, tv = _volumes(scale=0.3)
    fr = np.array([0.3, 0.1, 0.7, 0.9], np.float32)
    jsc = JSceneConfig.preset(scene)
    jp = jint.TraceParams(flags=JLightFlags.from_scene(jsc), mode=mode)
    ro, rd, uv = jcam.pixel_rays(jcam.Camera.reference_camera(W / H), W, H)
    rdf = rd.reshape(-1, 3)
    rob = jnp.broadcast_to(ro, rdf.shape)
    st = jrng.init_state(uv, jnp.asarray(fr)).reshape(-1)

    def jtrace(s, o, d, v):
        act = ~jint.primary_miss_mask(v, o, d)
        return jint.trace_fixed(s, v, jlights(jsc), jp, o, d, 8, active=act)

    want = jax.jit(jtrace)(st, rob, rdf, jv)

    tsc = SceneConfig.preset(scene)
    cam = tcam.Camera.reference_camera(W / H, device="cpu")
    tro, trd, tuv = tcam.pixel_rays(cam, W, H)
    trdf = trd.reshape(-1, 3)
    trob = tro.expand(W * H, 3)
    got = tint.trace_fixed(
        trng.init_state(tuv, _t(fr)).reshape(-1), tv,
        lights_from_scene(tsc, device="cpu"),
        tint.TraceParams(flags=LightFlags.from_scene(tsc), mode=mode),
        trob, trdf, 8, active=~tint.primary_miss_mask(tv, trob, trdf))

    assert np.array_equal(_bits(got["state"].numpy()), _bits(want["state"]))
    for k in ("alive", "did_scatter"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert 0.05 < got["did_scatter"].float().mean() < 0.95
    np.testing.assert_array_equal(got["throughput"].numpy(),
                                  np.asarray(want["throughput"]))
    for k in ("radiance", "terminal_pos"):
        g, w = got[k].numpy(), np.asarray(want[k])
        close = (np.abs(g - w) <= 1e-3 + 1e-3 * np.abs(w)).all(-1)
        assert close.mean() >= 0.99, f"{k}: {close.mean():.4f} of lanes"
