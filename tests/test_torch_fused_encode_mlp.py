"""The plain version of kernel K3 (fused encode + MLP) and the cache's
inference path against the JAX package.

Tolerances: packing and corner indices are integer paths and agree
bitwise; encoded features within 1e-6 (summation order); network outputs
within 1e-2 absolute, the bound tests/test_fused_encode_mlp.py holds the
Pallas kernel to (one bf16 rounding of an activation can flip by one ulp
when float32 sums are taken in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu.config import AppConfig as JAppConfig
from nrc_hpm_tpu.config import EncodingConfig as JEncodingConfig
from nrc_hpm_tpu.models.nrc import encoding as jenc
from nrc_hpm_tpu.models.nrc.cache import NeuralRadianceCache as JCache
from nrc_hpm_tpu.ops.fused_encode_mlp import fused_encode_mlp_infer
from nrc_hpm_tpu_torch.config import AppConfig, EncodingConfig
from nrc_hpm_tpu_torch.models.nrc import encoding as tenc
from nrc_hpm_tpu_torch.models.nrc.cache import NeuralRadianceCache
from nrc_hpm_tpu_torch.ops import fused_encode_mlp as fem
from nrc_hpm_tpu_torch.weights import params_from_jax


def _caches(**enc):
    kw = dict(nn_width=64, nn_depth=3)
    return (JCache(JAppConfig(encoding=JEncodingConfig(**enc), **kw)),
            NeuralRadianceCache(AppConfig(encoding=EncodingConfig(**enc),
                                          **kw)))


def _x5(n, seed):
    return np.random.RandomState(seed).uniform(
        -0.4, 1.4, (n, 5)).astype(np.float32)


def test_pack_table_bf16_bitwise():
    rs = np.random.RandomState(0)
    table = np.concatenate([
        rs.normal(size=(4000, 2)) * 10.0 ** rs.randint(-8, 3, (4000, 1)),
        [[1.0 + 2 ** -8, -(1.0 + 3 * 2 ** -8)], [0.0, -0.0],
         [3.4e38, -1e-40]]]).astype(np.float32)
    want = np.asarray(jenc.pack_table_bf16(jnp.asarray(table)))
    got = tenc.pack_table_bf16(torch.from_numpy(table)).numpy()
    assert np.array_equal(got.view(np.uint32), want), \
        "bf16 packing must agree bitwise"


def test_corner_indices_match():
    """16 levels at 2^12: dense and hashed levels, out-of-range inputs
    (negative corner coordinates wrap as two's complement)."""
    jc, tc = _caches(n_levels=16, log2_hashmap_size=12)
    spec_j, spec_t = jc.encoding.grid_spec, tc.encoding.grid_spec
    assert spec_t.level_offsets == spec_j.level_offsets
    x = _x5(1024, 1)[:, :3]
    idx_j, w_j = jenc._corner_indices(jnp.asarray(x), spec_j)
    idx_t, w_t = tenc._corner_indices(torch.from_numpy(x), spec_t)
    assert np.array_equal(idx_t.reshape(1024, -1).numpy(),
                          np.asarray(idx_j)), "table rows bitwise"
    np.testing.assert_allclose(w_t.reshape(1024, -1).numpy(),
                               np.asarray(w_j), rtol=0, atol=1e-7)


def test_encoding_features_match():
    jc, tc = _caches(n_levels=16, log2_hashmap_size=12)
    state = jc.init_state(jax.random.PRNGKey(0))
    table = np.asarray(state.ema_params["encoding"]["hash_table"]) * 1e4
    x5 = _x5(512, 2)
    want = jc.encoding({}, jnp.asarray(x5), packed={
        "hash_table_packed": jenc.pack_table_bf16(jnp.asarray(table))})
    got = tc.encoding({}, torch.from_numpy(x5),
                      packed=tenc.pack_table_bf16(torch.from_numpy(table)))
    assert got.shape == (512, tc.encoding.out_dim) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6, err_msg="features within 1e-6")


@pytest.mark.parametrize("n", [512, 1000])
def test_plain_matches_pallas_interpret(n):
    jc, _ = _caches(n_levels=8, log2_hashmap_size=12)
    state = jc.init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, state.ema_params)
    table = params["encoding"]["hash_table"] * 1e3
    x5 = _x5(n, 3)
    want = np.asarray(fused_encode_mlp_infer(
        jenc.pack_table_bf16(jnp.asarray(table)),
        [jnp.asarray(w) for w in params["mlp"]["layers"]], jnp.asarray(x5),
        jc.encoding.grid_spec, n_bins=4, blk_r=8, interpret=True))
    got = fem.fused_encode_mlp_infer(
        tenc.pack_table_bf16(torch.from_numpy(table)),
        params_from_jax(params)["mlp"]["layers"], torch.from_numpy(x5),
        tenc.HashGridSpec(n_levels=8, log2_table_size=12))
    assert got.shape == (n, 3)
    assert np.abs(got.numpy() - want).max() <= 1e-2, \
        "K3 plain vs Pallas interpret within 1e-2"


def test_cache_infer_matches_jax():
    jc, tc = _caches(n_levels=16, log2_hashmap_size=12)
    state = jc.init_state(jax.random.PRNGKey(1))
    ema = jax.tree.map(np.asarray, state.ema_params)
    ema["encoding"]["hash_table"] = ema["encoding"]["hash_table"] * 1e3
    state = state.replace(ema_params=jax.tree.map(jnp.asarray, ema))
    x5 = _x5(2048, 4)
    want = np.asarray(jc.infer(state, jnp.asarray(x5)))
    got = tc.infer(tc.state_from_params(params_from_jax(ema)),
                   torch.from_numpy(x5)).numpy()
    err = np.abs(got - want)
    assert err.max() <= 1e-2, "cache.infer within 1e-2"
    assert (err <= 1e-4).mean() >= 0.95, "95% of outputs within 1e-4"


def test_wrapper_rejects_other_devices_and_encodings():
    """Every encoding id of the reference is taken (tests/
    test_torch_encodings.py); other ids raise, and a grid the packed
    table cannot hold is not ported."""
    with pytest.raises(ValueError, match="invalid pos"):
        tenc.CompositeEncoding(EncodingConfig(pos_id=4))
    with pytest.raises(ValueError, match="invalid dir"):
        tenc.CompositeEncoding(EncodingConfig(dir_id=3))
    with pytest.raises(NotImplementedError, match="2 features"):
        tenc.CompositeEncoding(EncodingConfig(n_features_per_level=4))
    spec = tenc.HashGridSpec(n_levels=2, log2_table_size=8)
    with pytest.raises(ValueError, match="unsupported device"):
        fem.fused_encode_mlp_infer(
            torch.zeros(spec.total_params, dtype=torch.int32, device="meta"),
            [torch.zeros((16, 64), device="meta")],
            torch.zeros((4, 5), device="meta"), spec)
