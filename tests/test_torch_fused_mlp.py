"""Kernel K4 (fused MLP inference), the MLP's compute dtypes and the
cache's inference dispatch against the JAX package.

On the CPU the JAX ``fused_mlp_infer`` runs its reference ``mlp_apply``;
the port runs K4's plain version.  Tolerances, and why:
- bf16 network outputs: within 1e-2 absolute (the bound the K3 tests hold
  to): float32 sums in another order can flip one bf16 rounding of an
  activation by an ulp.  Most outputs agree far closer (>= 95% within
  1e-4).
- float32 network outputs: within 1e-5 relative + 1e-6 (float32 sums in
  another order, nothing rounded to bf16).
- A train step: as tests/test_torch_train.py holds whole steps, >= 99% of
  the entries of every leaf within 1e-4 relative + 1e-6, loss within
  1e-4 relative.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import config as jcfg
from nrc_hpm_tpu.models.nrc import cache as jcache
from nrc_hpm_tpu.models.nrc import mlp as jmlp
from nrc_hpm_tpu.ops.fused_mlp import fused_mlp_infer as jfused
from nrc_hpm_tpu_torch import config as tcfg
from nrc_hpm_tpu_torch.models.nrc import cache as tcache
from nrc_hpm_tpu_torch.models.nrc import mlp as tmlp
from nrc_hpm_tpu_torch.ops import fused_mlp as fm
from nrc_hpm_tpu_torch.utils import prng
from nrc_hpm_tpu_torch.weights import params_from_jax, state_from_jax

PAIRS = list(itertools.product(range(4), range(3)))


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _share_close(got, want, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) <= atol + rtol * np.abs(want)).mean())


def _params(in_dim, width, depth, seed):
    rs = np.random.RandomState(seed)
    dims = [in_dim] + [width] * depth + [3]
    return {"layers": [rs.uniform(-1, 1, (a, b)).astype(np.float32)
                       * np.float32(np.sqrt(6.0 / a))
                       for a, b in zip(dims[:-1], dims[1:])]}


@pytest.mark.parametrize("in_dim", [16, 48, 80])
def test_plain_matches_jax_fused_mlp(in_dim):
    """K4's plain version at width 64, depth 6 against the JAX wrapper,
    on features in [-1, 1] (the range of the encodings' outputs)."""
    params = _params(in_dim, 64, 6, in_dim)
    feats = np.random.RandomState(1).uniform(-1, 1, (2048, in_dim)).astype(
        np.float32)
    want = np.asarray(jfused({"layers": [jnp.asarray(w) for w in
                                         params["layers"]]},
                             jnp.asarray(feats)))
    got = fm.fused_mlp_infer(params_from_jax({"encoding": {}, "mlp": params},
                                             device="cpu")["mlp"],
                             torch.from_numpy(feats))
    assert got.shape == want.shape == (2048, 3)
    err = np.abs(got.numpy() - want)
    assert err.max() <= 1e-2
    assert (err <= 1e-4).mean() >= 0.95


def test_float32_mlp_matches_jax():
    params = _params(48, 32, 3, 2)
    feats = np.random.RandomState(3).uniform(-1, 2, (1024, 48)).astype(
        np.float32)
    want = np.asarray(jmlp.mlp_apply(
        {"layers": [jnp.asarray(w) for w in params["layers"]]},
        jnp.asarray(feats), jnp.float32))
    got = tmlp.mlp_apply({"layers": [torch.from_numpy(w) for w in
                                     params["layers"]]},
                         torch.from_numpy(feats), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="mlp_dtype"):
        tmlp.compute_dtype("float16")


def test_kernel_weights_layout():
    """Every layer transposed in one bf16 block, padded with zeros to
    k_in inputs (layer 0) or the padded width, and to the padded width of
    outputs (OUT_PAD for the output layer)."""
    layers = [torch.randn(20, 24), torch.randn(24, 24), torch.randn(24, 3)]
    k_in, width, stream = fm.plan(layers, 20, 3)
    assert (k_in, width, stream) == (32, 32, False)
    block = fm.kernel_weights(layers, k_in, width)
    assert block.dtype == torch.bfloat16
    assert block.shape == (32 * 32 + 32 * 32 + fm.OUT_PAD * 32,)
    for at, rows, w in ((0, 32, layers[0]), (1024, 32, layers[1]),
                        (2048, fm.OUT_PAD, layers[2])):
        m = block[at:at + rows * 32].reshape(rows, 32)
        assert torch.equal(m[:w.shape[1], :w.shape[0]],
                           w.t().to(torch.bfloat16))
        m[:w.shape[1], :w.shape[0]] = 0
        assert not m.any()


def _caches(pos, dir_, mlp_dtype="bfloat16", n_levels=8, **kw):
    kw = {"nn_width": 64, "nn_depth": 3, "mlp_dtype": mlp_dtype, **kw}
    enc = dict(pos_id=pos, dir_id=dir_, n_levels=n_levels,
               log2_hashmap_size=12)
    return (jcache.NeuralRadianceCache(jcfg.AppConfig(
                encoding=jcfg.EncodingConfig(**enc), **kw)),
            tcache.NeuralRadianceCache(tcfg.AppConfig(
                encoding=tcfg.EncodingConfig(**enc), **kw)))


def _infer_pair(pos, dir_, mlp_dtype, seed, **kw):
    jc, tc = _caches(pos, dir_, mlp_dtype, **kw)
    st = jc.init_state(jax.random.PRNGKey(seed))
    ema = _np(st.ema_params)
    if pos == 0:   # unit-scale table: tcnn's 1e-4 init hides the grid
        ema["encoding"]["hash_table"] = np.random.RandomState(seed).uniform(
            -1, 1, ema["encoding"]["hash_table"].shape).astype(np.float32)
    st = st.replace(ema_params=jax.tree.map(jnp.asarray, ema))
    x5 = np.random.RandomState(seed).uniform(-0.2, 1.2, (2048, 5)).astype(
        np.float32)
    want = np.asarray(jc.infer(st, jnp.asarray(x5)))
    got = tc.infer(tc.state_from_params(params_from_jax(ema, device="cpu"),
                                        device="cpu"),
                   torch.from_numpy(x5)).numpy()
    assert got.shape == want.shape == (2048, 3)
    return got, want


@pytest.mark.parametrize("pos,dir_", PAIRS)
def test_cache_infer_bf16_matches_jax(pos, dir_):
    got, want = _infer_pair(pos, dir_, "bfloat16", 10 + 3 * pos + dir_)
    err = np.abs(got - want)
    assert err.max() <= 1e-2
    assert (err <= 1e-4).mean() >= 0.95


@pytest.mark.parametrize("pos,dir_", [(0, 0), (3, 2)])
def test_cache_infer_float32_matches_jax(pos, dir_):
    got, want = _infer_pair(pos, dir_, "float32", 30 + pos)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(nn_width=32), dict(nn_width=128), dict(nn_width=256),
    dict(n_levels=20), dict(nn_width=48, nn_depth=2)], ids=str)
def test_cache_infer_k4_shapes_match_jax(kw):
    """The default encoding at the shapes K3 does not take (the split
    encode, then K4's plain version) against the JAX cache.  Within 1e-2,
    as the width-64 cases; the share of close outputs is taken at 1e-3:
    the JAX CPU product's sum order can differ from call to call under
    load (one run read 91% of a 256-wide net's outputs within 1e-4, others
    99.4%), and an activation's bf16 flip reaches more outputs in a wider
    net."""
    got, want = _infer_pair(0, 0, "bfloat16", 40 + len(str(kw)), **kw)
    err = np.abs(got - want)
    assert err.max() <= 1e-2
    assert (err <= 1e-3).mean() >= 0.95


@pytest.mark.parametrize("pos,dir_,mlp_dtype,route,kw", [
    (0, 0, "bfloat16", "K3", {}), (0, 1, "bfloat16", "K4", {}),
    (3, 2, "bfloat16", "K4", {}), (0, 0, "float32", "plain", {}),
    (2, 0, "float32", "plain", {}),
    (0, 0, "bfloat16", "K4", dict(nn_width=32)),
    (0, 0, "bfloat16", "K4", dict(nn_width=128)),
    (0, 0, "bfloat16", "K4", dict(nn_width=256)),
    (0, 0, "bfloat16", "K4", dict(n_levels=20)),
    (0, 0, "bfloat16", "plain", dict(nn_width=272, nn_depth=1)),
    (3, 2, "bfloat16", "plain", dict(nn_width=300, nn_depth=1))],
    ids=lambda v: str(v) if isinstance(v, dict) else None)
def test_infer_dispatch(monkeypatch, pos, dir_, mlp_dtype, route, kw):
    """bf16: K3 for the default encoding at K3's shapes (width 64, <= 16
    levels), the split encode (K7's packed forward for a hash grid) + K4
    for every other shape up to width 256, the bf16 MLP above it (the JAX
    package's use_fused); float32: the float32 MLP, neither kernel.  The
    route is picked from the shapes before any call."""
    from nrc_hpm_tpu_torch.ops import fused_encode_mlp as fem
    from nrc_hpm_tpu_torch.ops import hash_grid_train as hgt

    calls = []
    for mod, name in ((fem, "fused_encode_mlp_infer"),
                      (fm, "fused_mlp_infer"), (hgt, "hash_grid_train_fwd")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name, **k:
                            calls.append(name) or fn(*a, **k))
    _, tc = _caches(pos, dir_, mlp_dtype, **kw)
    st = tc.init_state(prng.prng_key(0), device="cpu")
    out = tc.infer(st, torch.rand(64, 5))
    assert out.shape == (64, 3) and torch.isfinite(out).all()
    split = ["hash_grid_train_fwd"] if pos == 0 else []
    want = {"K3": ["fused_encode_mlp_infer"],
            "K4": split + ["fused_mlp_infer"],
            "plain": split}[route]
    assert calls == want


@pytest.mark.parametrize("pos,dir_,mlp_dtype", [(3, 2, "bfloat16"),
                                                (2, 1, "float32")])
def test_train_step_non_hash_matches_jax(pos, dir_, mlp_dtype):
    """A state with an empty encoding tree carried by state_from_jax
    after one JAX step (live Adam moments), then one step in both."""
    jc, tc = _caches(pos, dir_, mlp_dtype, log2_train_batch_size=7,
                     train_batch_count=2)
    rs = np.random.RandomState(5)
    x5 = rs.uniform(-0.1, 1.1, (256, 5)).astype(np.float32)
    target = rs.exponential(0.5, (256, 3)).astype(np.float32)
    jst = jc.init_state(jax.random.PRNGKey(6))
    jst = jc.train_step(jst, jnp.asarray(x5[:128]), jnp.asarray(target[:128]))
    tst = state_from_jax(_np(jst), device="cpu")
    assert tst.params["encoding"] == {} and tst.opt_state["mu"]["encoding"] \
        == {} and tst.opt_state["count"] == 1
    jst = jc.train_step(jst, jnp.asarray(x5[128:]), jnp.asarray(target[128:]))
    tst = tc.train_step(tst, torch.from_numpy(x5[128:]),
                        torch.from_numpy(target[128:]))
    assert tst.step == int(jst.step) == 2
    np.testing.assert_allclose(float(tst.loss), float(jst.loss), rtol=1e-4)
    for what in ("params", "ema_params"):
        got = tcache.tree_leaves(getattr(tst, what))
        want = jax.tree.leaves(getattr(jst, what))
        assert len(got) == len(want) == tc.depth + 1
        for g, w in zip(got, want):
            assert _share_close(g.numpy(), np.asarray(w), 1e-4, 1e-6) >= 0.99
