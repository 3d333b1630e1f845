"""The port's threefry key chain (``utils/prng.py``) against ``jax.random``
and the seeded states it makes against the JAX package's: bitwise, since
these are RNG paths and threefry2x32 is portable.

- ``PRNGKey``, ``split``, 32-bit ``bits`` and float32 ``uniform`` (with
  ``minval``/``maxval``) over several seeds and shapes, odd and empty ones
  included;
- ``NeuralRadianceCache.init_state(key)``: the hash table and every MLP
  layer;
- ``NrcRenderer.init_state(seed)`` and ``step``'s frame seeds, frame by
  frame."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import config as jcfg
from nrc_hpm_tpu import renderer as jren
from nrc_hpm_tpu.models.nrc import cache as jcache
from nrc_hpm_tpu.utils import rng as jrng
from nrc_hpm_tpu.volume import Volume as JVolume
from nrc_hpm_tpu_torch import camera as tcam
from nrc_hpm_tpu_torch import config as tcfg
from nrc_hpm_tpu_torch import renderer as tren
from nrc_hpm_tpu_torch.models.nrc import cache as tcache
from nrc_hpm_tpu_torch.utils import prng
from nrc_hpm_tpu_torch.utils import rng as trng
from nrc_hpm_tpu_torch.volume import Volume as TVolume

SEEDS = [0, 1, 7, -3, 2 ** 31 + 5, 123456789]
SHAPES = [(), (0,), (1,), (4,), (7,), (3, 5), (1001, 2)]
RANGES = [(0.0, 1.0), (-1e-4, 1e-4), (-0.3, 0.3), (2.0, 5.0)]


def _same_bits(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return (tuple(got.shape) == want.shape
            and np.array_equal(got.numpy().view(np.int32),
                               want.view(np.int32)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    tkey = prng.prng_key(seed)
    assert np.array_equal(tkey.numpy(), np.asarray(key).astype(np.int64))
    for num in (1, 2, 3, 8):
        assert np.array_equal(prng.split(tkey, num).numpy(),
                              np.asarray(jax.random.split(key, num)).astype(
                                  np.int64))
    # a chain of splits, as the renderer walks it
    for _ in range(4):
        key, sub = jax.random.split(key)
        tkey, tsub = prng.split(tkey)
        assert np.array_equal(tsub.numpy(), np.asarray(sub).astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bits_and_uniform_bitwise(seed, shape):
    key = jax.random.PRNGKey(seed)
    tkey = prng.prng_key(seed)
    assert np.array_equal(prng.random_bits(tkey, shape).numpy(),
                          np.asarray(jax.random.bits(key, shape)).astype(
                              np.int64))
    for lo, hi in RANGES:
        want = jax.random.uniform(key, shape, jnp.float32, minval=lo,
                                  maxval=hi)
        assert _same_bits(prng.uniform(tkey, shape, lo, hi), want), (lo, hi)


def test_fma_rounds_once():
    """fma_f32 rounds a * b + c once: against exact rationals, including
    sums whose float64 rounding would land on a float32 tie."""
    from fractions import Fraction

    rs = np.random.RandomState(0)
    a = rs.rand(4000).astype(np.float32)
    a[:3] = [2.0 ** -23, 1.0 - 2.0 ** -24, 0.5 + 2.0 ** -24]
    for b, c in ((0.7, -1e-3), (2e-4, -1e-4), (3.0, 2.0 ** -30)):
        b, c = float(np.float32(b)), float(np.float32(c))
        got = prng.fma_f32(torch.from_numpy(a), b, c).numpy()
        want = []
        for v in a:
            exact = Fraction(float(v)) * Fraction(b) + Fraction(c)
            lo = np.float32(float(exact))
            # the nearest float32 to the exact value, ties to even
            cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                     np.nextafter(lo, np.float32(np.inf))]
            dist = [abs(Fraction(float(x)) - exact) for x in cands]
            best = min(dist)
            near = [x for x, d in zip(cands, dist) if d == best]
            want.append(near[0] if len(near) == 1 else
                        next(x for x in near
                             if not np.array([x]).view(np.int32)[0] & 1))
        assert np.array_equal(got.view(np.int32),
                              np.array(want, np.float32).view(np.int32))


@pytest.mark.parametrize("enc", [
    dict(n_levels=4, log2_hashmap_size=10),
    dict(n_levels=3, log2_hashmap_size=12, base_resolution=4),
    dict(pos_id=3, dir_id=2)], ids=["grid", "grid-dense", "no-grid"])
@pytest.mark.parametrize("seed", [0, 5])
def test_cache_init_state_bitwise(enc, seed):
    kw = dict(nn_width=32, nn_depth=3)
    jc = jcache.NeuralRadianceCache(jcfg.AppConfig(
        encoding=jcfg.EncodingConfig(**enc), **kw))
    tc = tcache.NeuralRadianceCache(tcfg.AppConfig(
        encoding=tcfg.EncodingConfig(**enc), **kw))
    js = jc.init_state(jax.random.PRNGKey(seed))
    ts = tc.init_state(prng.prng_key(seed), device="cpu")
    for what in ("params", "ema_params"):
        want = jax.tree.leaves(getattr(js, what))
        got = tcache.tree_leaves(getattr(ts, what))
        assert len(got) == len(want) == 4 + ("pos_id" not in enc)
        for g, w in zip(got, want):
            assert _same_bits(g, w)


def test_renderer_frame_seeds_bitwise():
    """init_state(0) splits PRNGKey(0) as the JAX renderer does; each step
    splits the state's key for its frame seed, the first of which is
    [0.10429, 0.34399, 0.13107, 0.81013]."""
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    kw = dict(render_width=16, render_height=9, nn_width=16, nn_depth=1)
    enc = dict(n_levels=2, log2_hashmap_size=8)
    jr = jren.NrcRenderer(
        jcfg.AppConfig(encoding=jcfg.EncodingConfig(**enc), **kw),
        vol=JVolume.from_dense(data, 0.6, 0.8))
    tr = tren.NrcRenderer(
        tcfg.AppConfig(encoding=tcfg.EncodingConfig(**enc), **kw),
        vol=TVolume.from_dense(data, 0.6, 0.8, device="cpu"))
    key = jr.init_state(0).key
    ts = tr.init_state(0)
    assert isinstance(ts.key, torch.Tensor) and ts.key.shape == (2,)
    cam = tcam.Camera.reference_camera(16 / 9, device="cpu")
    for frame in range(3):
        key, sub = jax.random.split(key)
        _, tsub = prng.split(ts.key)
        want = jrng.frame_random(sub)
        got = trng.frame_random(tsub)
        assert _same_bits(got, want), frame
        if frame == 0:
            np.testing.assert_allclose(
                got.numpy(), [0.10429, 0.34399, 0.13107, 0.81013],
                atol=5e-6)
        # a step draws its seed from that split and keeps the other key
        ts = tr.step(ts, cam, train=False)
        assert np.array_equal(ts.key.numpy(),
                              np.asarray(key).astype(np.int64))
