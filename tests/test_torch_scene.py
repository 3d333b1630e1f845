"""Scene math of the port against the JAX package: the procedural cloud,
the volume and its packed macro table, lights, phase sampling.
Integer/table paths bitwise; float paths within a few float32 ulps."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import config as jcfg
from nrc_hpm_tpu import lights as jlights
from nrc_hpm_tpu import sampling as jsamp
from nrc_hpm_tpu import volume as jvol
from nrc_hpm_tpu_torch import config as tcfg
from nrc_hpm_tpu_torch import lights as tlights
from nrc_hpm_tpu_torch import sampling as tsamp
from nrc_hpm_tpu_torch import volume as tvol
from nrc_hpm_tpu_torch.utils.procedural import cloud_density


@pytest.fixture(scope="module")
def cloud():
    return cloud_density(seed=0)


def test_procedural_cloud_properties(cloud):
    """The properties tests/test_vdb.py asserts of the WDAS cloud."""
    assert cloud.shape == (126, 86, 154) and cloud.dtype == np.float32
    assert cloud.max() == 1.0 and cloud.min() == 0.0
    assert (cloud[63] > 0).mean() > 0.3, "dense middle slice"
    assert 0.1 < (cloud > 0).mean() < 0.5, "mostly empty box"
    inside = cloud[cloud > 0]
    assert np.percentile(inside, 90) > 3 * np.percentile(inside, 10), \
        "heterogeneous inside"
    assert np.array_equal(cloud, cloud_density(seed=0)), "seeded"
    assert not np.array_equal(cloud, cloud_density(seed=1))


def test_volume_matches_jax(cloud):
    jv = jvol.Volume.from_dense(cloud, 0.6, 0.8)
    tv = tvol.Volume.from_dense(cloud, 0.6, 0.8, device="cpu")
    assert np.array_equal(tv.grid.numpy(), np.asarray(jv.grid))
    assert np.array_equal(tv.macro_packed.numpy().view(np.uint32),
                          np.asarray(jv.macro_packed)), "packed macro bitwise"
    assert np.array_equal(tv.sky_size.numpy(), np.asarray(jv.sky_size))
    assert tv.sky_host == tuple(np.asarray(jv.sky_size).tolist())
    assert tv.macro_dims == jv.macro_dims == (16, 11, 20)
    rs = np.random.RandomState(0)
    ro = rs.uniform(-90, 90, (2048, 3)).astype(np.float32)
    rd = rs.normal(size=(2048, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ej, xj, hj = jvol.find_entry_exit(jv, jnp.asarray(ro), jnp.asarray(rd))
    et, xt, ht = tvol.find_entry_exit(tv, torch.from_numpy(ro),
                                      torch.from_numpy(rd))
    assert np.array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6,
                               atol=1e-4)
    p = rs.uniform(-60, 60, (3, 4096)).astype(np.float32)
    dj = jvol.get_density_xyz(jv, *map(jnp.asarray, p))
    dt = tvol.get_density_xyz(tv, *map(torch.from_numpy, p))
    assert np.array_equal(dt.numpy(), np.asarray(dj)), "density bitwise"


def _same_fields(t, j):
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            _same_fields(tv, jv)
        else:
            assert tv == jv, f.name


def test_configs_share_fields_and_defaults():
    """Every port config field exists in the JAX config with the same
    default, presets included."""
    _same_fields(tcfg.AppConfig(), jcfg.AppConfig())
    for sid in range(6):
        _same_fields(tcfg.SceneConfig.preset(sid),
                     jcfg.SceneConfig.preset(sid))


@pytest.mark.parametrize("scene_id", range(6))
def test_lights_match(scene_id):
    lj = jlights.lights_from_scene(jcfg.SceneConfig.preset(scene_id))
    lt = tlights.lights_from_scene(tcfg.SceneConfig.preset(scene_id),
                                   device="cpu")
    assert np.array_equal(lt.dir_light.direction.numpy(),
                          np.asarray(lj.dir_light.direction))
    assert lt.dir_light.strength == float(lj.dir_light.strength)
    assert lt.point_light.strength == float(lj.point_light.strength)
    assert lt.env.strength == float(lj.env.strength)
    assert tlights.LightFlags.from_scene(tcfg.SceneConfig.preset(scene_id)) \
        .__dict__ == jlights.LightFlags.from_scene(
            jcfg.SceneConfig.preset(scene_id)).__dict__


def test_env_map_sampling_matches():
    rs = np.random.RandomState(1)
    d = rs.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    img = rs.rand(8, 16, 3).astype(np.float32)
    for jenv, tenv in ((jlights.HdrEnvMap.constant_white(0.1),
                        tlights.HdrEnvMap.constant_white(0.1, device="cpu")),
                       (jlights.HdrEnvMap.from_image(img, 2.0),
                        tlights.HdrEnvMap.from_image(img, 2.0, device="cpu"))):
        want = jlights.sample_env_map(jenv, jnp.asarray(d))
        got = tlights.sample_env_map(tenv, torch.from_numpy(d))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("phase_sampling", [False, True])
def test_new_ray_dir_matches(phase_sampling):
    rs = np.random.RandomState(2)
    d = rs.normal(size=(2048, 3)).astype(np.float32)
    d[:4] = [[-1, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, -1]]
    state = rs.rand(2048).astype(np.float32)
    active = rs.rand(2048) < 0.7
    dj, sj = jsamp.new_ray_dir(jnp.asarray(state), jnp.asarray(d),
                               jnp.float32(0.8), phase_sampling,
                               jnp.asarray(active))
    dt, st = tsamp.new_ray_dir(torch.from_numpy(state), torch.from_numpy(d),
                               0.8, phase_sampling, torch.from_numpy(active))
    assert np.array_equal(st.numpy().view(np.uint32),
                          np.asarray(sj).view(np.uint32)), "state bitwise"
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=2e-5)
    cos = rs.uniform(-1, 1, 1024).astype(np.float32)
    np.testing.assert_allclose(
        tsamp.hg_phase(torch.from_numpy(cos), 0.8).numpy(),
        np.asarray(jsamp.hg_phase(jnp.asarray(cos), jnp.float32(0.8))),
        rtol=2e-6)
    np.testing.assert_allclose(
        tsamp.dir_to_spherical_norm(dt).numpy(),
        np.asarray(jsamp.dir_to_spherical_norm(jnp.asarray(dt.numpy()))),
        rtol=0, atol=1e-6)
