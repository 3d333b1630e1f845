"""The port's RNG, indexed draws and pixel rays against the JAX package:
bitwise for every integer/hash/RNG path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import camera as jcam
from nrc_hpm_tpu import transmittance as jtr
from nrc_hpm_tpu.utils import rng as jrng
from nrc_hpm_tpu_torch import camera as tcam
from nrc_hpm_tpu_torch import transmittance as ttr
from nrc_hpm_tpu_torch.utils import rng as trng


def _u32(n, seed):
    x = np.random.RandomState(seed).randint(0, 2 ** 32, n, dtype=np.uint64)
    edges = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint64)
    return np.concatenate([edges, x]).astype(np.uint32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_hash_u32_bitwise():
    x = _u32(4096, 0)
    want = np.asarray(jrng.hash_u32(jnp.asarray(x)))
    got = trng.hash_u32(torch.from_numpy(x.astype(np.int64))).numpy()
    assert np.array_equal(got.astype(np.uint32), want), \
        "hash_u32 must agree bitwise"


def test_random_family_bitwise():
    rs = np.random.RandomState(1)
    a, b, c, d = (rs.rand(2048).astype(np.float32) for _ in range(4))
    jt = [jnp.asarray(v) for v in (a, b, c, d)]
    tt = [torch.from_numpy(v) for v in (a, b, c, d)]
    pairs = [(jrng.random1(jt[0]), trng.random1(tt[0])),
             (jrng.random2(*jt[:2]), trng.random2(*tt[:2])),
             (jrng.random4(*jt), trng.random4(*tt)),
             (jrng.float_construct(jnp.asarray(_u32(2048, 2))),
              trng.float_construct(torch.from_numpy(
                  _u32(2048, 2).astype(np.int64))))]
    for want, got in pairs:
        assert np.array_equal(_bits(want), _bits(got.numpy())), \
            "random1/2/4 and float_construct must agree bitwise"


def test_init_state_bitwise():
    _, _, uv_j = jcam.pixel_rays(jcam.Camera.reference_camera(48 / 27), 48, 27)
    _, _, uv_t = tcam.pixel_rays(
        tcam.Camera.reference_camera(48 / 27, device="cpu"), 48, 27)
    assert np.array_equal(_bits(uv_j), _bits(uv_t.numpy())), \
        "frag_uv must agree bitwise"
    fr = np.array([0.125, 0.6180339, 0.91, 0.0031], np.float32)
    want = jrng.init_state(uv_j, jnp.asarray(fr))
    got = trng.init_state(uv_t, torch.from_numpy(fr))
    assert np.array_equal(_bits(want), _bits(got.numpy())), \
        "init_state must agree bitwise"


def test_uniform_chain_and_masked_bitwise():
    rs = np.random.RandomState(4)
    s = rs.rand(1024).astype(np.float32)
    sj, st = jnp.asarray(s), torch.from_numpy(s)
    for step in range(8):
        mask = rs.rand(1024) < 0.6
        if step % 2:
            uj, sj = jrng.uniform(sj, 3.0)
            ut, st = trng.uniform(st, 3.0)
        else:
            uj, sj = jrng.masked_uniform(sj, jnp.asarray(mask))
            ut, st = trng.masked_uniform(st, torch.from_numpy(mask))
        assert np.array_equal(_bits(uj), _bits(ut.numpy())), \
            f"sample {step} must agree bitwise"
        assert np.array_equal(_bits(sj), _bits(st.numpy())), \
            f"state {step} must agree bitwise"


@pytest.mark.parametrize("lead", [False, True])
@pytest.mark.parametrize("salt,k0", [(0x9E3779B9, 0), (0x85EBCA6B, 37),
                                     (0x7FEB352D, 120), (0x27D4EB2F, 0)])
def test_indexed_draws_bitwise(lead, salt, k0):
    seed = _u32(512, 5)
    jf = jtr._indexed_draws_lead if lead else jtr._indexed_draws
    tf = ttr._indexed_draws_lead if lead else ttr._indexed_draws
    want = jf(jnp.asarray(seed), jnp.uint32(k0), 16, salt)
    got = tf(torch.from_numpy(seed.view(np.int32)), k0, 16, salt)
    assert np.array_equal(_bits(want), _bits(got.numpy())), \
        "indexed draws must agree bitwise"


def test_track_seed_bitwise():
    s = np.random.RandomState(6).rand(256).astype(np.float32)
    seed_j, state_j = jtr._track_seed(jnp.asarray(s))
    seed_t, state_t = ttr._track_seed(torch.from_numpy(s))
    assert np.array_equal(np.asarray(seed_j), seed_t.numpy().view(np.uint32))
    assert np.array_equal(_bits(state_j), _bits(state_t.numpy()))


def test_pixel_rays_match():
    cj = jcam.Camera.reference_camera(16 / 9)
    ct = tcam.Camera.reference_camera(16 / 9, device="cpu")
    assert np.array_equal(np.asarray(cj.inv_proj_view),
                          ct.inv_proj_view.numpy())
    _, rd_j, _ = jcam.pixel_rays(cj, 64, 36)
    _, rd_t, _ = tcam.pixel_rays(ct, 64, 36)
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), rtol=0,
                               atol=1e-6, err_msg="ray dirs within 1e-6")
