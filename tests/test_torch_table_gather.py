"""Path B against the JAX package: the table lookups of kernels K5
(``table_gather``) and K6 (``small_table_lookup``), the volume's macrocell
lookups, the per-interval coarse profile and the trackers and train paths
at ``coarse != 32``.

The JAX wrappers run ``jnp.take`` on the CPU; the port runs the plain
versions.  Tolerances, and why:
- Lookups, packing, the macro tables and the coarse profile: bitwise (the
  same float32 operations; the profile's prefix sums follow XLA's order).
- ``_map_events``: the telescoping sums over the interval axis run in
  another order, so values move by ulps: ``beyond`` equal on >= 99.9%
  of the events; the selected fields, and t of the events in range,
  within 1e-5 relative + 1e-7 on >= 99.9% of them.
- The trackers and ``trace_fixed``: the new RNG state bitwise; lanes as
  tests/test_torch_transmittance.py and tests/test_torch_train.py hold
  them (>= 99% within 1e-5 transmittance or 1e-3 world units).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import config as jcfg
from nrc_hpm_tpu import integrator as jint
from nrc_hpm_tpu import transmittance as jtr
from nrc_hpm_tpu import volume as jvol
from nrc_hpm_tpu.lights import LightFlags as JLightFlags
from nrc_hpm_tpu.lights import lights_from_scene as jlights
from nrc_hpm_tpu.ops import macro_gather as jmg
from nrc_hpm_tpu.ops import table_gather as jtg
from nrc_hpm_tpu_torch import config as tcfg
from nrc_hpm_tpu_torch import integrator as tint
from nrc_hpm_tpu_torch import transmittance as ttr
from nrc_hpm_tpu_torch import volume as tvol
from nrc_hpm_tpu_torch.lights import LightFlags, lights_from_scene
from nrc_hpm_tpu_torch.ops import macro_gather as tmg
from nrc_hpm_tpu_torch.ops import table_gather as ttg
from nrc_hpm_tpu_torch.utils.procedural import cloud_density

N = 512


@pytest.fixture(scope="module")
def cloud():
    """The procedural cloud: its macro table holds 3,520 words."""
    data = cloud_density(seed=0)
    return (jvol.Volume.from_dense(data, 0.6, 0.8),
            tvol.Volume.from_dense(data, 0.6, 0.8, device="cpu"))


def _small():
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    return (jvol.Volume.from_dense(data, 0.6, 0.8),
            tvol.Volume.from_dense(data, 0.6, 0.8, device="cpu"))


def _u32(a):
    return np.asarray(a).view(np.uint32)


def _idx(n_table, shape, seed):
    return np.random.RandomState(seed).randint(0, n_table, shape).astype(
        np.int32)


@pytest.mark.parametrize("n_table", [3520, 65536])
@pytest.mark.parametrize("dtype", ["float32", "uint32"])
@pytest.mark.parametrize("shape", [(4096,), (65, N)], ids=["1d", "CplusN"])
def test_table_gather_bitwise(n_table, dtype, shape):
    rs = np.random.RandomState(n_table)
    bits = rs.randint(0, 2 ** 32, n_table, dtype=np.uint64).astype(np.uint32)
    table = bits if dtype == "uint32" else \
        rs.normal(size=n_table).astype(np.float32)
    idx = _idx(n_table, shape, 1)
    want = np.asarray(jtg.table_gather(jnp.asarray(table), jnp.asarray(idx)))
    t_table = torch.from_numpy(table.view(np.int32)).view(torch.uint32) \
        if dtype == "uint32" else torch.from_numpy(table)
    got = ttg.table_gather(t_table, torch.from_numpy(idx))
    assert got.dtype == t_table.dtype and tuple(got.shape) == shape
    got = got.view(torch.int32).numpy().view(np.uint32) \
        if dtype == "uint32" else got.numpy()
    assert got.dtype == want.dtype and np.array_equal(got.view(np.uint32),
                                                      want.view(np.uint32))


@pytest.mark.parametrize("n_table", [3520, 8192])
@pytest.mark.parametrize("shape", [(4096,), (65, N)], ids=["1d", "CplusN"])
def test_small_table_lookup_bitwise(n_table, shape):
    table = np.random.RandomState(n_table).uniform(0, 1, n_table).astype(
        np.float32)
    idx = _idx(n_table, shape, 2)
    want = np.asarray(jmg.small_table_lookup(jnp.asarray(table),
                                             jnp.asarray(idx)))
    got = tmg.small_table_lookup(torch.from_numpy(table),
                                 torch.from_numpy(idx)).numpy()
    assert got.shape == shape and np.array_equal(_u32(got), _u32(want))


def test_pack_unpack_bf16_pair_bitwise():
    rs = np.random.RandomState(3)
    a = (rs.normal(size=3000) * 10.0 ** rs.randint(-6, 4, 3000)).astype(
        np.float32)
    b = (rs.normal(size=3000) * 10.0 ** rs.randint(-6, 4, 3000)).astype(
        np.float32)
    want = np.asarray(jtg.pack_bf16_pair(jnp.asarray(a), jnp.asarray(b)))
    got = ttg.pack_bf16_pair(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and np.array_equal(_u32(got.numpy()),
                                                       want)
    for u, v in zip(jtg.unpack_bf16_pair(jnp.asarray(want)),
                    ttg.unpack_bf16_pair(got)):
        assert np.array_equal(_u32(v.numpy()), _u32(u))


def test_volume_macro_tables_bitwise(cloud):
    jv, tv = cloud
    assert tv.macro.shape == tv.macro_min.shape == (3520,)
    assert tv.macro.dtype == tv.macro_min.dtype == torch.float32
    for key in ("macro", "macro_min", "macro_packed"):
        assert np.array_equal(_u32(getattr(tv, key).numpy()),
                              _u32(getattr(jv, key))), key


def _points(jv, n, seed):
    """World points inside the box, on the one-macrocell outside margin,
    and farther out."""
    rs = np.random.RandomState(seed)
    half = np.asarray(jv.sky_size) / 2
    cell = np.asarray(jv.sky_size) / np.asarray(jv.macro_dims)
    inside = rs.uniform(-1, 1, (n, 3)) * half
    margin = np.sign(rs.uniform(-1, 1, (n, 3))) * (
        half + rs.uniform(0, 1.2, (n, 3)) * cell)
    far = rs.uniform(-3, 3, (n, 3)) * half
    return np.concatenate([inside, margin, far]).astype(np.float32)


@pytest.mark.parametrize("fn", ["macro_sigma", "macro_control",
                                "macro_sigma_xyz", "macro_control_xyz",
                                "macro_profile_xyz"])
def test_macro_lookups_bitwise(cloud, fn):
    jv, tv = cloud
    pts = _points(jv, 1000, 4)
    if fn.endswith("_xyz"):
        want = getattr(jvol, fn)(jv, *(jnp.asarray(pts[:, k])
                                       for k in range(3)))
        got = getattr(tvol, fn)(tv, *(torch.from_numpy(pts[:, k].copy())
                                      for k in range(3)))
    else:
        want = getattr(jvol, fn)(jv, jnp.asarray(pts))
        got = getattr(tvol, fn)(tv, torch.from_numpy(pts))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert np.array_equal(_u32(g.numpy()), _u32(w))
    assert (got[-1].numpy() > 0).mean() > 0.005, "the points see the medium"


def _segments(n, seed):
    rs = np.random.RandomState(seed)
    start = rs.uniform(-60, 60, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rs.uniform(0, 150, n).astype(np.float32)
    return start, d, tmax


@pytest.mark.parametrize("C", [16, 32, 64])
def test_coarse_profile_bitwise(cloud, C):
    jv, tv = cloud
    start, d, tmax = _segments(N, C)
    want = jtr._coarse_profile(jv, jnp.asarray(start), jnp.asarray(d),
                               jnp.asarray(tmax), C)
    got = ttr._coarse_profile(tv, torch.from_numpy(start),
                              torch.from_numpy(d), torch.from_numpy(tmax), C)
    for name, g, w in zip(("sigma", "c", "ccum", "rcum", "h"), got, want):
        assert np.array_equal(_u32(g.numpy()), _u32(w)), name
    assert (np.asarray(want[3][-1]) > 0).mean() > 0.05, "lanes see medium"


@pytest.mark.parametrize("n", [3, 16, 64, 65, 300])
def test_prefix_sum_order_matches_jax(n):
    x = np.random.RandomState(n).uniform(0, 1, (n, 256)).astype(np.float32)
    x *= np.random.RandomState(1).uniform(0, 100, (1, 256)).astype(
        np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=0))
    assert np.array_equal(ttr._cumsum0(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("C", [16, 32, 64])
def test_map_events_match(cloud, C):
    jv, _ = cloud
    start, d, tmax = _segments(N, 100 + C)
    prof = jtr._coarse_profile(jv, jnp.asarray(start), jnp.asarray(d),
                               jnp.asarray(tmax), C)
    sigma, c, _, rcum, h = (np.array(a) for a in prof)
    # sorted depths up to 1.2 x each lane's total
    E = (np.sort(np.random.RandomState(C).uniform(0, 1.2, (16, N)), axis=0)
         * rcum[-1]).astype(np.float32)
    want = jtr._map_events(jnp.asarray(E), jnp.asarray(rcum),
                           jnp.asarray(h), (jnp.asarray(c),
                                            jnp.asarray(sigma)))
    got = ttr._map_events(*(torch.from_numpy(a) for a in (E, rcum, h)),
                          (torch.from_numpy(c), torch.from_numpy(sigma)))
    beyond = np.asarray(want[1])
    assert (got[1].numpy() == beyond).mean() >= 0.999
    assert 0.05 < (~beyond).mean() < 0.9
    for g, w in zip(got[2], want[2]):
        w = np.asarray(w)
        assert (np.abs(g.numpy() - w) <= 1e-5 * np.abs(w) + 1e-7).mean() \
            >= 0.999
    tg, tw = got[0].numpy(), np.asarray(want[0])
    ok = np.abs(tg - tw) <= 1e-5 * np.abs(tw) + 1e-7
    assert ok[~beyond].mean() >= 0.999


def _rays(seed):
    r = np.random.RandomState(seed)
    start = r.uniform(-40.0, 40.0, (N, 3)).astype(np.float32)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    end = (start + d * r.uniform(1.0, 80.0, (N, 1))).astype(np.float32)
    state = r.rand(N).astype(np.float32)
    active = r.rand(N) < 0.9
    return start, d, end, state, active


@pytest.mark.parametrize("coarse", [16, 64])
@pytest.mark.parametrize("staged", [False, True])
def test_ratio_track_per_interval_matches_jax(monkeypatch, coarse, staged):
    if staged:
        monkeypatch.setattr(jtr, "COMPACT_MIN_LANES", 64)
        monkeypatch.setattr(ttr, "COMPACT_MIN_LANES", 64)
    jv, tv = _small()
    start, _, end, state, active = _rays(3)
    tj, sj = jtr.ratio_track_pw(jnp.asarray(state), jv, jnp.asarray(start),
                                jnp.asarray(end), segment=8, coarse=coarse,
                                active=jnp.asarray(active))
    tt, st = ttr.ratio_track_pw(torch.from_numpy(state), tv,
                                torch.from_numpy(start),
                                torch.from_numpy(end), segment=8,
                                coarse=coarse,
                                active=torch.from_numpy(active))
    tj, tt = np.asarray(tj), tt.numpy()
    assert np.array_equal(_u32(sj), _u32(st.numpy())), "state bitwise"
    assert 0.05 < (tj < 0.999).mean(), "the segments must cross the medium"
    assert (np.abs(tt - tj) <= 1e-5).mean() >= 0.99
    assert np.all(tt[~active] == 1.0), "inactive lanes transmit fully"


@pytest.mark.parametrize("coarse", [16, 64])
@pytest.mark.parametrize("staged", [False, True])
def test_delta_track_per_interval_matches_jax(monkeypatch, coarse, staged):
    if staged:
        monkeypatch.setattr(jtr, "COMPACT_MIN_LANES", 64)
        monkeypatch.setattr(ttr, "COMPACT_MIN_LANES", 64)
    jv, tv = _small()
    start, d, _, state, active = _rays(5)
    start = start * 0.5
    pj, ej, sj = jtr.delta_track_pw(jnp.asarray(state), jv,
                                    jnp.asarray(start), jnp.asarray(d),
                                    segment=8, coarse=coarse,
                                    active=jnp.asarray(active))
    pt, et, st = ttr.delta_track_pw(torch.from_numpy(state), tv,
                                    torch.from_numpy(start),
                                    torch.from_numpy(d), segment=8,
                                    coarse=coarse,
                                    active=torch.from_numpy(active))
    assert np.array_equal(_u32(sj), _u32(st.numpy())), "state bitwise"
    err = np.abs(pt.numpy() - np.asarray(pj)).max(-1)
    assert (err <= 1e-3).mean() >= 0.99, "collision points within 1e-3"
    assert (et.numpy() == np.asarray(ej)).mean() >= 0.99, "exit flags"
    assert (active & ~np.asarray(ej)).mean() > 0.05, "some lanes collide"


@pytest.mark.parametrize("coarse", [16, 64])
def test_trace_fixed_per_interval_matches_jax(coarse):
    """8 bounces from inside the volume with TraceParams(coarse=...)."""
    jv, tv = _small()
    scene = jcfg.SceneConfig.preset(4)
    jp = jint.TraceParams(flags=JLightFlags.from_scene(scene), coarse=coarse)
    tp = tint.TraceParams(flags=LightFlags.from_scene(
        tcfg.SceneConfig.preset(4)), coarse=coarse)
    rs = np.random.RandomState(9)
    ro = rs.uniform(-20, 20, (256, 3)).astype(np.float32)
    rd = rs.normal(size=(256, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    state = rs.rand(256).astype(np.float32)
    jres = jint.trace_fixed(jnp.asarray(state), jv, jlights(scene), jp,
                            jnp.asarray(ro), jnp.asarray(rd), 8)
    tres = tint.trace_fixed(torch.from_numpy(state), tv,
                            lights_from_scene(tcfg.SceneConfig.preset(4),
                                              device="cpu"), tp,
                            torch.from_numpy(ro), torch.from_numpy(rd), 8)
    assert np.array_equal(_u32(jres["state"]), _u32(tres["state"].numpy()))
    alive = tres["alive"].numpy()
    assert (alive == np.asarray(jres["alive"])).mean() >= 0.99
    for k in ("radiance", "throughput", "terminal_pos"):
        err = np.abs(tres[k].numpy() - np.asarray(jres[k])).reshape(256, -1)
        assert (err.max(-1) <= 1e-3).mean() >= 0.99, k
    assert 0.05 < (~alive).mean() < 0.95, "some lanes die on the way"


def test_fixed_step_transmittance_matches_jax():
    """Within 1e-6: the 16 densities are summed in another order."""
    jv, tv = _small()
    start, _, end, _, _ = _rays(11)
    end[:8] = start[:8]                         # zero-length segments
    want = np.asarray(jtr.fixed_step_transmittance(
        jv, jnp.asarray(start), jnp.asarray(end), 16))
    got = ttr.fixed_step_transmittance(tv, torch.from_numpy(start),
                                       torch.from_numpy(end), 16).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(got[:8] == 1.0) and (got < 0.9).mean() > 0.05
