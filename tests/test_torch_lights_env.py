"""The port's HDR environment maps and dynamic lights against the JAX
package: the inverse-CDF tables, ``HdrEnvMap.from_image``,
``lights_from_scene`` reading a Radiance .hdr file written here, the env
lookup on that map, and ``update_scene`` (the cases of
tests/test_lights_update.py and test_utils_io.py's dynamic-scene test).

Tolerances: the tables are built by the same numpy code, so they and the
loaded image are bitwise.  ``sample_env_map`` is float32 math in another
library: within 1e-6 relative + 1e-7 wherever the two libraries' asin
agree bitwise on the direction's y.  XLA's CPU asin runs through its own
sqrt, which is not correctly rounded, and lands an ulp from torch's on
about a third of the inputs; an ulp of theta moves the lookup by
~1e-7 texels, times the map's contrast between neighbouring texels, so
there every value is held within 3e-5 relative.  Dir-light directions
within 1e-6 (JAX's test tolerance), angles and scalars exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import config as jcfg
from nrc_hpm_tpu import lights as jl
from nrc_hpm_tpu_torch import config as tcfg
from nrc_hpm_tpu_torch import lights as tl


def _image(seed=0, h=8, w=16):
    rs = np.random.RandomState(seed)
    img = rs.gamma(0.5, 2.0, (h, w, 3)).astype(np.float32)
    img[0, :4] = 0.0          # black texels clamp to 1e-12 luminance
    return img


def _write_hdr(path, h=8, w=16, seed=1):
    """A flat (not run-length coded) RGBE file: mantissas >= 64 keep a
    scanline from reading as an RLE header."""
    rs = np.random.RandomState(seed)
    px = np.concatenate([rs.randint(64, 256, (h, w, 3)),
                         rs.randint(120, 136, (h, w, 1))], -1)
    px[0, 0] = (0, 0, 0, 0)   # a zero exponent is black
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                + f"-Y {h} +X {w}\n".encode() + px.astype(np.uint8).tobytes())


def _same_env(t, j):
    for k in ("image", "inv_cdf_x", "inv_cdf_y"):
        a, b = getattr(t, k).numpy(), np.asarray(getattr(j, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert t.strength == float(j.strength)


@pytest.mark.parametrize("seed", [0, 1])
def test_build_inverse_cdfs_bitwise(seed):
    img = _image(seed)
    (tx, ty), (jx, jy) = tl.build_inverse_cdfs(img), \
        jl.build_inverse_cdfs(img)
    assert tx.tobytes() == jx.tobytes() and tx.dtype == jx.dtype
    assert ty.tobytes() == jy.tobytes() and ty.dtype == jy.dtype
    assert (np.diff(tx, axis=1) >= 0).all() and (tx < 1).all()


def test_env_maps_bitwise():
    img = _image()
    _same_env(tl.HdrEnvMap.from_image(img, 0.5, device="cpu"),
              jl.HdrEnvMap.from_image(img, 0.5))
    _same_env(tl.HdrEnvMap.constant_white(0.1, device="cpu"),
              jl.HdrEnvMap.constant_white(0.1))


@pytest.fixture(scope="module")
def hdr_lights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("env") / "sky.hdr")
    _write_hdr(path)
    kw = dict(hdr_env_map_path=path, hdr_env_map_strength=2.0)
    return (tl.lights_from_scene(dataclasses.replace(
                tcfg.SceneConfig.preset(4), **kw), device="cpu"),
            jl.lights_from_scene(dataclasses.replace(
                jcfg.SceneConfig.preset(4), **kw)))


def test_lights_from_scene_reads_the_hdr_file(hdr_lights):
    t, j = hdr_lights
    _same_env(t.env, j.env)
    assert t.env.image.shape == (8, 16, 3) and t.env.image[0, 0].sum() == 0
    assert np.array_equal(t.dir_light.direction.numpy(),
                          np.asarray(j.dir_light.direction))
    assert t.dir_light.strength == float(j.dir_light.strength)
    assert t.point_light.strength == float(j.point_light.strength)


def test_sample_env_map_matches_jax(hdr_lights):
    t, j = hdr_lights
    rs = np.random.RandomState(2)
    d = rs.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = tl.sample_env_map(t.env, torch.from_numpy(d)).numpy()
    want = np.asarray(jl.sample_env_map(j.env, jnp.asarray(d)))
    same_theta = (torch.arcsin(torch.from_numpy(d[:, 1])).numpy()
                  == np.asarray(jnp.arcsin(d[:, 1])))
    assert same_theta.mean() > 0.5
    np.testing.assert_allclose(got[same_theta], want[same_theta],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=1e-7)
    assert got.std() > 0


def _dynamic(scene_id, **light):
    ts = dataclasses.replace(tcfg.SceneConfig.preset(scene_id), dynamic=True)
    js = dataclasses.replace(jcfg.SceneConfig.preset(scene_id), dynamic=True)
    tli = tl.lights_from_scene(ts, device="cpu")
    jli = jl.lights_from_scene(js)
    if light:
        tli = dataclasses.replace(tli, dir_light=tl.DirLight.create(
            **light, device="cpu"))
        jli = dataclasses.replace(jli, dir_light=jl.DirLight.create(**light))
    return ts, js, tli, jli


def _same_dir_light(t, j):
    assert t.zenith == float(j.zenith) and t.azimuth == float(j.azimuth)
    assert t.strength == float(j.strength)
    assert np.array_equal(t.color.numpy(), np.asarray(j.color))
    np.testing.assert_allclose(t.direction.numpy(), np.asarray(j.direction),
                               rtol=0, atol=1e-6)


def test_update_scene3_advances_and_keeps_the_light():
    ts, js, tli, jli = _dynamic(3, zenith=-1.2, azimuth=0.3,
                                color=(0.9, 0.8, 0.7), strength=16.0)
    t = tl.update_scene(tli, ts, delta_time=0.25).dir_light
    j = jl.update_scene(jli, js, delta_time=0.25).dir_light
    _same_dir_light(t, j)
    assert t.azimuth == pytest.approx(0.3 + 0.125)
    np.testing.assert_allclose(t.direction.numpy(),
                               tl.dir_from_angles(-1.2, 0.3 + 0.125),
                               atol=1e-6)
    # the default scene light, twice in a row
    ts, js, tli, jli = _dynamic(3)
    for _ in range(2):
        tli, jli = tl.update_scene(tli, ts, 0.5), jl.update_scene(jli, js, 0.5)
        _same_dir_light(tli.dir_light, jli.dir_light)


def test_update_scene3_wraps_at_the_reference_two_pi():
    ts, js, tli, jli = _dynamic(3, zenith=-1.57, azimuth=6.2, strength=16.0)
    t = tl.update_scene(tli, ts, delta_time=1.0).dir_light
    _same_dir_light(t, jl.update_scene(jli, js, delta_time=1.0).dir_light)
    assert t.azimuth == pytest.approx((6.2 + 0.5) % 6.282)


def test_update_static_and_scene4_are_noops():
    static = tcfg.SceneConfig.preset(3)
    lights = tl.lights_from_scene(static, device="cpu")
    assert tl.update_scene(lights, static, 1.0) is lights
    ts, _, tli, _ = _dynamic(4)
    assert tl.update_scene(tli, ts, 1.0) is tli
