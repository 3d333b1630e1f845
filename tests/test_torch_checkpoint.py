"""The port's cache checkpoints against the JAX package's file format.

A port checkpoint round-trips bitwise; a checkpoint the JAX package's
``save_pytree`` wrote of a JAX ``NrcState`` (after one Adam or SGD step,
so the moments, count and step are not their initial values) loads into
the port equal, bit for bit, to ``weights.state_from_jax`` of the same
state; and structures or shapes that differ raise ValueError, as in
tests/test_utils_io.py::test_checkpoint_rejects_structure_mismatch.
Tolerance: bitwise throughout (the file holds the float32 arrays)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import config as jcfg
from nrc_hpm_tpu.models.nrc.cache import NeuralRadianceCache as JCache
from nrc_hpm_tpu.utils import checkpoint as jck
from nrc_hpm_tpu_torch import config as tcfg
from nrc_hpm_tpu_torch.models.nrc.cache import NeuralRadianceCache as TCache
from nrc_hpm_tpu_torch.models.nrc.cache import tree_leaves
from nrc_hpm_tpu_torch.utils import checkpoint as tck
from nrc_hpm_tpu_torch.utils.prng import prng_key
from nrc_hpm_tpu_torch.weights import state_from_jax

CASES = {
    "adam": dict(),
    "sgd": dict(optimizer="SGD"),
    "freq-tri": dict(pos_id=3, dir_id=2),      # no hash table: {} encoding
}


def _cfgs(case):
    kw = dict(CASES[case])
    enc = dict(n_levels=2, log2_hashmap_size=10, pos_id=kw.pop("pos_id", 0),
               dir_id=kw.pop("dir_id", 0))
    common = dict(nn_width=16, nn_depth=2, **kw)
    return (jcfg.AppConfig(encoding=jcfg.EncodingConfig(**enc), **common),
            tcfg.AppConfig(encoding=tcfg.EncodingConfig(**enc), **common))


def _same_state(a, b):
    assert a.step == b.step and a.opt_state.keys() == b.opt_state.keys()
    if a.opt_state:
        assert a.opt_state["count"] == b.opt_state["count"]
    for ta, tb in zip(*(tree_leaves([s.params, s.ema_params,
                                     {k: v for k, v in s.opt_state.items()
                                      if k != "count"}, s.loss])
                        for s in (a, b))):
        assert ta.dtype == tb.dtype and ta.shape == tb.shape
        assert ta.numpy().tobytes() == tb.numpy().tobytes()


def _port_trained(case):
    _, tc = _cfgs(case)
    cache = TCache(tc)
    st = cache.init_state(prng_key(0), device="cpu")
    rs = np.random.RandomState(1)
    x5 = torch.from_numpy(rs.rand(64, 5).astype(np.float32))
    target = torch.from_numpy(rs.rand(64, 3).astype(np.float32))
    return cache, cache.train_step(st, x5, target)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_round_trip_is_bitwise(tmp_path, case):
    cache, st = _port_trained(case)
    path = str(tmp_path / "ck.npz")
    tck.save_pytree(path, st)
    fresh = cache.init_state(prng_key(5), device="cpu")
    loaded = tck.load_pytree(path, fresh, device="cpu")
    _same_state(loaded, st)
    assert loaded.step == 1 and float(loaded.loss) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_checkpoint_loads_into_the_port(tmp_path, case):
    jc, tc = _cfgs(case)
    jcache = JCache(jc)
    rs = np.random.RandomState(1)
    x5, target = rs.rand(64, 5).astype(np.float32), \
        rs.rand(64, 3).astype(np.float32)
    js = jcache.train_step(jcache.init_state(jax.random.PRNGKey(0)),
                           jnp.asarray(x5), jnp.asarray(target))
    want = state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    path = str(tmp_path / "jax.npz")
    jck.save_pytree(path, js)
    like = TCache(tc).init_state(prng_key(3), device="cpu")
    got = tck.load_pytree(path, like, device="cpu")
    _same_state(got, want)
    assert got.step == 1 and (not got.opt_state
                              or got.opt_state["count"] == 1)


def test_structure_mismatch_raises(tmp_path):
    p = str(tmp_path / "ck.npz")
    tck.save_pytree(p, {"x": torch.zeros(3), "y": torch.ones(3)})
    same = tck.load_pytree(p, {"y": torch.zeros(3), "x": torch.ones(3)},
                           device="cpu")
    assert torch.equal(same["y"], torch.ones(3)) and not same["x"].any()
    with pytest.raises(ValueError, match="different pytree structure"):
        tck.load_pytree(p, {"x": torch.zeros(3), "z": torch.ones(3)},
                        device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tck.load_pytree(p, {"x": torch.zeros(4), "y": torch.ones(3)},
                        device="cpu")


def test_jax_adam_checkpoint_refuses_an_sgd_cache(tmp_path):
    jc, _ = _cfgs("adam")
    p = str(tmp_path / "adam.npz")
    jck.save_pytree(p, JCache(jc).init_state(jax.random.PRNGKey(0)))
    _, sgd = _cfgs("sgd")
    with pytest.raises(ValueError, match="different pytree structure"):
        tck.load_pytree(p, TCache(sgd).init_state(prng_key(0),
                                                  device="cpu"),
                        device="cpu")


def test_lists_tuples_and_numbers_round_trip(tmp_path):
    tree = {"a": [torch.arange(4, dtype=torch.int32), (torch.ones(2, 2),)],
            "b": None, "c": 7}
    p = str(tmp_path / "t.npz")
    tck.save_pytree(p, tree)
    like = {"a": [torch.zeros(4, dtype=torch.int32), (torch.zeros(2, 2),)],
            "b": None, "c": 0}
    got = tck.load_pytree(p, like, device="cpu")
    assert torch.equal(got["a"][0], tree["a"][0])
    assert isinstance(got["a"][1], tuple)
    assert torch.equal(got["a"][1][0], tree["a"][1][0])
    assert got["b"] is None and got["c"] == 7
    # the structure text is JAX's PyTreeDef text of the same tree
    jtree = {"a": [jnp.arange(4), (jnp.ones((2, 2)),)], "b": None, "c": 7}
    assert tck._flatten(tree)[1] == str(jax.tree.flatten(jtree)[1])
