"""The port's NRC input encodings against the JAX package's, for every
(pos_id, dir_id) pair the JAX package accepts.

Tolerances, and why:
- TriangleWave and Identity: bitwise (products by powers of two, floor and
  abs round the same in both).
- Frequency: sin/cos of arguments up to ~2^11 pi differ between the two
  libms by an ulp, so within 2.4e-7 (two ulps of 1.0).
- CompositeEncoding: bitwise for pairs of Identity and TriangleWave;
  within 1e-6 where a hash grid (float32 sums of the trilinear weights),
  OneBlob (erf) or Frequency enters.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import config as jcfg
from nrc_hpm_tpu.models.nrc import encoding as jenc
from nrc_hpm_tpu_torch import config as tcfg
from nrc_hpm_tpu_torch.models.nrc import encoding as tenc
from nrc_hpm_tpu_torch.utils import prng

PAIRS = list(itertools.product(range(4), range(3)))
ENC = dict(n_levels=4, log2_hashmap_size=12)


def _x(n, d, seed):
    """Inputs inside and outside [0, 1]."""
    return np.random.RandomState(seed).uniform(-0.6, 1.6, (n, d)).astype(
        np.float32)


@pytest.mark.parametrize("n_freqs", [4, 12])
def test_triangle_wave_bitwise(n_freqs):
    x = _x(1000, 3, n_freqs)
    want = np.asarray(jenc.triangle_wave_encode(jnp.asarray(x), n_freqs))
    got = tenc.triangle_wave_encode(torch.from_numpy(x), n_freqs).numpy()
    assert got.shape == want.shape == (1000, 3 * n_freqs)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_freqs", [4, 12])
def test_frequency_within_two_ulps(n_freqs):
    x = _x(1000, 3, 10 + n_freqs)
    want = np.asarray(jenc.frequency_encode(jnp.asarray(x), n_freqs))
    got = tenc.frequency_encode(torch.from_numpy(x), n_freqs).numpy()
    assert got.shape == want.shape == (1000, 6 * n_freqs)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    # [sin f0.., cos f0..] per input dim
    np.testing.assert_allclose(got[:, n_freqs], np.cos(x[:, 0] * np.pi),
                               atol=1e-5)


@pytest.mark.parametrize("pos,dir_", PAIRS)
def test_dims_match_jax(pos, dir_):
    jc = jenc.CompositeEncoding(jcfg.EncodingConfig(pos_id=pos, dir_id=dir_))
    tc = tenc.CompositeEncoding(tcfg.EncodingConfig(pos_id=pos, dir_id=dir_))
    assert (tc.raw_dim, tc.out_dim) == (jc.raw_dim, jc.out_dim)
    assert tc.out_dim % 16 == 0
    assert (tc.grid_spec is None) == (jc.grid_spec is None) == (pos != 0)
    if pos:
        assert tc.init_params(prng.prng_key(0)) == {}


@pytest.mark.parametrize("pos,dir_", PAIRS)
def test_composite_call_matches_jax(pos, dir_):
    jc = jenc.CompositeEncoding(jcfg.EncodingConfig(pos_id=pos, dir_id=dir_,
                                                    **ENC))
    tc = tenc.CompositeEncoding(tcfg.EncodingConfig(pos_id=pos, dir_id=dir_,
                                                    **ENC))
    x5 = _x(512, 5, pos * 3 + dir_)
    params = {}
    if pos == 0:
        params = {"hash_table": np.random.RandomState(7).uniform(
            -1, 1, (tc.grid_spec.total_params, 2)).astype(np.float32)}
    want = np.asarray(jc({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x5)))
    got = tc({k: torch.from_numpy(v) for k, v in params.items()},
             torch.from_numpy(x5)).numpy()
    assert got.shape == want.shape == (512, tc.out_dim)
    assert (got[:, tc.raw_dim:] == 1.0).all(), "ones padding"
    if pos in (1, 2) and dir_ in (1, 2):
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_invalid_ids_raise_like_jax():
    for kw in (dict(pos_id=4), dict(dir_id=3)):
        with pytest.raises(ValueError, match="invalid"):
            jenc.CompositeEncoding(jcfg.EncodingConfig(**kw))
        with pytest.raises(ValueError, match="invalid"):
            tenc.CompositeEncoding(tcfg.EncodingConfig(**kw))
