"""The port's online training against the JAX package's, on the CPU.

The JAX side runs as its own tests run it: K7's route there is the XLA
``take`` and the packed backward is ``_level_grad_matmul``.  The port runs
the plain versions of its kernels.  Inputs are numpy arrays from a seed.

Tolerances, and why:
- Losses: values within 1e-6 relative, gradients within 1e-5 relative
  (float32 sums in another order).
- Train encode: features within 1e-6; the table gradient within
  1e-5 * S + 1e-7, S the sum of |w*g| over the terms of an entry (float32
  accumulation in another order; the packed path rounds every term to
  bf16 in both packages, so the terms themselves agree bitwise).
- MLP and table gradients through the whole cache: float32 sums in
  another order can flip one bf16 rounding of a cotangent (2^-8
  relative), so >= 99% of the entries of every leaf within 1e-5 relative
  + 1e-9, and all within 2^-7 of the leaf's largest magnitude.
- Optimizer and EMA from identical gradients: within 1e-6 relative +
  1e-9 (the same float32 operations; pow may differ by an ulp).
- Whole train steps and frames: Adam moves an entry by about lr wherever
  |g| >> eps, so tiny gradient differences show only where |g| ~ eps.
  >= 99% of the entries of every parameter, EMA and moment leaf within
  1e-4 relative + 1e-6; step and count equal; loss within 1e-4 relative.
- trace_fixed: the RNG state bitwise (the port advances dead lanes'
  chains as the JAX package does); radiance, throughput and terminal
  point on >= 99% of lanes within 1e-3, alive equal on >= 99%.
- Frames: did_scatter on >= 99% of pixels and the image within 1e-3 on
  those pixels (as the frozen frame, tests/test_torch_frame.py); ring
  head/tail equal, ring data on >= 99% of rows within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nrc_hpm_tpu import camera as jcam
from nrc_hpm_tpu import config as jcfg
from nrc_hpm_tpu import integrator as jint
from nrc_hpm_tpu import renderer as jren
from nrc_hpm_tpu import transmittance as jtr
from nrc_hpm_tpu.lights import LightFlags as JLightFlags
from nrc_hpm_tpu.lights import lights_from_scene as jlights
from nrc_hpm_tpu.models.nrc import cache as jcache
from nrc_hpm_tpu.models.nrc import encoding as jenc
from nrc_hpm_tpu.utils import rng as jrng
from nrc_hpm_tpu.volume import Volume as JVolume
from nrc_hpm_tpu_torch import camera as tcam
from nrc_hpm_tpu_torch import config as tcfg
from nrc_hpm_tpu_torch import integrator as tint
from nrc_hpm_tpu_torch import renderer as tren
from nrc_hpm_tpu_torch import transmittance as ttr
from nrc_hpm_tpu_torch.lights import LightFlags, lights_from_scene
from nrc_hpm_tpu_torch.models.nrc import cache as tcache
from nrc_hpm_tpu_torch.models.nrc import encoding as tenc
from nrc_hpm_tpu_torch.volume import Volume as TVolume
from nrc_hpm_tpu_torch.weights import params_from_jax, state_from_jax

N = 256


def _np(tree):
    """A copy of a JAX pytree as numpy arrays (JAX steps donate)."""
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _share_close(got, want, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) <= atol + rtol * np.abs(want)).mean())


def _leaves_close(got_tree, want_tree, rtol, atol, share, what):
    got = tcache.tree_leaves(got_tree)
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        s = _share_close(g.detach().numpy(), np.asarray(w), rtol, atol)
        assert s >= share, f"{what} leaf {i}: {s:.5f} of entries close"


def _x5_target(n, seed):
    rs = np.random.RandomState(seed)
    x5 = rs.uniform(-0.1, 1.1, (n, 5)).astype(np.float32)
    target = rs.exponential(0.5, (n, 3)).astype(np.float32)
    return x5, target


# -- losses -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["RelativeL2Luminance", "RelativeL2", "L2",
                                  "L1"])
def test_losses_match(name):
    rs = np.random.RandomState(1)
    pred = rs.normal(0.3, 0.5, (N, 3)).astype(np.float32)
    target = rs.exponential(0.5, (N, 3)).astype(np.float32)
    jloss, jgrad = jax.value_and_grad(jcache.make_loss_fn(name))(
        jnp.asarray(pred), jnp.asarray(target))
    p = _t(pred).requires_grad_(True)
    tloss = tcache.make_loss_fn(name)(p, _t(target))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-9)
    per_j = jcache.make_loss_fn_per_sample(name)(jnp.asarray(pred),
                                                 jnp.asarray(target))
    per_t = tcache.make_loss_fn_per_sample(name)(_t(pred), _t(target))
    np.testing.assert_allclose(per_t.numpy(), np.asarray(per_j), rtol=1e-6)


def test_unknown_loss_and_optimizer_raise():
    with pytest.raises(ValueError, match="unsupported loss"):
        tcache.make_loss_fn("huber")
    with pytest.raises(ValueError, match="unsupported optimizer"):
        tcache.NeuralRadianceCache(tcfg.AppConfig(optimizer="rmsprop"))


# -- the train encode (K7's route and the float32 table) ---------------------

def _spec_pair(**kw):
    return jenc.HashGridSpec(**kw), tenc.HashGridSpec(**kw)


def _term_scale(x, g, spec):
    """S: the sum of |w * g| over every term added into each entry."""
    idx, w = tenc._corner_indices(_t(x), spec)
    v = (w[..., None] * _t(g).reshape(x.shape[0], -1, 1, 2)).abs()
    s = torch.zeros((spec.total_params, 2))
    return s.index_add_(0, idx.reshape(-1), v.reshape(-1, 2)).numpy()


@pytest.mark.parametrize("packed", [True, False])
def test_train_encode_forward_and_table_grad_match(packed):
    """packed: 4 levels, 2^10 tables, base 4 (the JAX
    hash_grid_encode_train); float32: 4 levels at 2^17 against jax.grad of
    hash_grid_encode."""
    kw = dict(n_levels=4, log2_table_size=10, base_resolution=4) if packed \
        else dict(n_levels=4, log2_table_size=17)
    jspec, tspec = _spec_pair(**kw)
    assert tenc.use_train_fast(tspec) == jenc.use_train_fast(jspec) == packed
    rs = np.random.RandomState(2)
    table = rs.uniform(-1, 1, (tspec.total_params, 2)).astype(np.float32)
    x = rs.uniform(-0.1, 1.1, (N, 3)).astype(np.float32)
    g = rs.normal(size=(N, tspec.out_dim)).astype(np.float32)
    jfn = jenc.hash_grid_encode_train if packed else jenc.hash_grid_encode
    want, vjp = jax.vjp(lambda t: jfn(t, jnp.asarray(x), jspec),
                        jnp.asarray(table))
    (want_grad,) = vjp(jnp.asarray(g))

    tfn = tenc.hash_grid_encode_train if packed else tenc.hash_grid_encode
    tt = _t(table).requires_grad_(True)
    got = tfn(tt, _t(x), tspec)
    got.backward(_t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    s = _term_scale(x, g, tspec)
    err = np.abs(tt.grad.numpy() - np.asarray(want_grad))
    assert (err <= 1e-5 * s + 1e-7).all(), f"max err {err.max():.3e}"
    assert (s > 0).sum() > N, "the lookups must touch the table"


def test_composite_encoding_selects_like_jax():
    """train_fast picks the packed path only for grids of <= 2^16 entries
    per level; the features then carry the bf16 table."""
    for log2 in (12, 16, 17, 19):
        enc = tcfg.EncodingConfig(log2_hashmap_size=log2)
        spec = tenc.CompositeEncoding(enc).grid_spec
        jspec = jenc.CompositeEncoding(jcfg.EncodingConfig(
            log2_hashmap_size=log2)).grid_spec
        assert tenc.use_train_fast(spec) == jenc.use_train_fast(jspec)
    rs = np.random.RandomState(3)
    x5 = rs.uniform(0, 1, (64, 5)).astype(np.float32)
    for log2 in (12, 17):
        cfg = tcfg.EncodingConfig(n_levels=4, log2_hashmap_size=log2)
        jc = jenc.CompositeEncoding(jcfg.EncodingConfig(
            n_levels=4, log2_hashmap_size=log2))
        tc = tenc.CompositeEncoding(cfg)
        table = rs.uniform(-1, 1, (tc.grid_spec.total_params, 2)).astype(
            np.float32)
        for fast in (False, True):
            want = jc({"hash_table": jnp.asarray(table)}, jnp.asarray(x5),
                      train_fast=fast)
            got = tc({"hash_table": _t(table)}, _t(x5), train_fast=fast)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=1e-6)


# -- the cache: gradients, optimizer, EMA, steps ------------------------------

def _caches(log2=12, **kw):
    kw = dict(nn_width=16, nn_depth=2, log2_train_batch_size=7,
              train_batch_count=2, **kw)
    enc = dict(n_levels=4, log2_hashmap_size=log2)
    return (jcache.NeuralRadianceCache(jcfg.AppConfig(
                encoding=jcfg.EncodingConfig(**enc), **kw)),
            tcache.NeuralRadianceCache(tcfg.AppConfig(
                encoding=tcfg.EncodingConfig(**enc), **kw)))


def _unit_state(jc, seed):
    """A JAX state with a unit-scale table (tcnn's 1e-4 init hides most
    gradient structure behind the MLP)."""
    st = jc.init_state(jax.random.PRNGKey(seed))
    p = _np(st.params)
    p["encoding"]["hash_table"] = np.random.RandomState(seed).uniform(
        -1, 1, p["encoding"]["hash_table"].shape).astype(np.float32)
    p = jax.tree.map(jnp.asarray, p)
    return st.replace(params=p, ema_params=jax.tree.map(jnp.copy, p),
                      opt_state=jc.optimizer.init(p))


@pytest.mark.parametrize("log2", [12, 17])
def test_loss_and_grads_match(log2):
    jc, tc = _caches(log2)
    st = _unit_state(jc, 4)
    x5, target = _x5_target(N, 5)

    def loss_of(params):
        return jc.loss_fn(jc.apply(params, jnp.asarray(x5),
                                   train_fast=jc.train_fast),
                          jnp.asarray(target))

    jloss, jgrads = jax.value_and_grad(loss_of)(st.params)
    tloss, tgrads = tc.loss_and_grads(
        params_from_jax(_np(st.params), device="cpu"), _t(x5), _t(target))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for g, w in zip(tcache.tree_leaves(tgrads), jax.tree.leaves(jgrads)):
        g, w = g.numpy(), np.asarray(w)
        assert _share_close(g, w, 1e-5, 1e-9) >= 0.99
        assert np.abs(g - w).max() <= 2 ** -7 * np.abs(w).max()


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_optimizer_and_ema_from_identical_grads(opt):
    rs = np.random.RandomState(6)
    shapes = [(40, 2), (16, 16), (16, 3)]

    def tree(scale):
        return {"encoding": {"hash_table": rs.normal(
                    0, scale, shapes[0]).astype(np.float32)},
                "mlp": {"layers": [rs.normal(0, scale, s).astype(np.float32)
                                   for s in shapes[1:]]}}

    params, ema = tree(1.0), tree(1.0)
    jopt = optax.adam(0.01, b1=0.9, b2=0.999, eps=1e-8) if opt == "adam" \
        else optax.sgd(0.01)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = params_from_jax(params, device="cpu")
    tstate = tcache.adam_init(tp) if opt == "adam" else {}
    update = tcache.adam_update if opt == "adam" else tcache.sgd_update
    for _ in range(3):
        g = tree(1e-3)
        g["mlp"]["layers"][0][:4] = 0.0          # untouched rows
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp, tstate = update(params_from_jax(g, device="cpu"), tstate, tp, 0.01)
    _leaves_close(tp, jp, 1e-6, 1e-9, 1.0, "params")
    if opt == "adam":
        assert tstate["count"] == int(jstate[0].count) == 3
        _leaves_close(tstate["mu"], jstate[0].mu, 1e-6, 1e-12, 1.0, "mu")
        _leaves_close(tstate["nu"], jstate[0].nu, 1e-6, 1e-15, 1.0, "nu")
    for step in (0, 1, 7):
        d = 0.99
        t = jnp.float32(step)
        old = 1.0 - jnp.power(d, t)
        new = 1.0 / (1.0 - jnp.power(d, t + 1.0))
        want = jax.tree.map(lambda e, p: (e * d * old + p * (1.0 - d)) * new,
                            jax.tree.map(jnp.asarray, ema), jp)
        got = tcache.ema_update(params_from_jax(ema, device="cpu"), tp, d,
                                step)
        _leaves_close(got, want, 1e-6, 1e-9, 1.0, f"ema step {step}")


def test_adam_update_is_optax_bitwise():
    """Three Adam steps on 65,536 entries whose gradients span six decades
    equal optax's eager steps bit for bit: the square root is the
    correctly rounded one (``cache.sqrt_f32``; torch's vectorized CPU
    sqrt read an ulp off on 0.3% of these entries)."""
    rs = np.random.RandomState(11)
    n = 1 << 16
    p = rs.normal(0, 0.02, n).astype(np.float32)
    jopt = optax.adam(0.01, b1=0.9, b2=0.999, eps=1e-8)
    jp = jnp.asarray(p)
    jstate = jopt.init(jp)
    tp = {"a": _t(p)}
    tstate = tcache.adam_init(tp)
    for _ in range(3):
        g = (rs.normal(0, 1e-3, n)
             * rs.choice([1.0, 1e-3, 1e-6], n)).astype(np.float32)
        upd, jstate = jopt.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp, tstate = tcache.adam_update({"a": _t(g)}, tstate, tp, 0.01)
        assert np.array_equal(tp["a"].numpy().view(np.uint32),
                              np.asarray(jp).view(np.uint32))


@pytest.mark.parametrize("opt,log2", [("Adam", 12), ("Adam", 17),
                                      ("SGD", 12)])
def test_train_step_and_frame_match(opt, log2):
    """One state carried by state_from_jax (after one JAX step, so the
    moments are live), then one train_step and one 2-batch train_frame on
    the same (x5, target) in both packages."""
    jc, tc = _caches(log2, optimizer=opt)
    x5, target = _x5_target(256, 7)
    jst = jc.train_step(_unit_state(jc, 8), jnp.asarray(x5[:128]),
                        jnp.asarray(target[:128]))
    tst = state_from_jax(_np(jst), device="cpu")
    assert tst.step == 1 and tst.opt_state.get("count", 1) == 1
    for fn in ("train_step", "train_frame"):
        jst = getattr(jc, fn)(jst, jnp.asarray(x5), jnp.asarray(target))
        tst = getattr(tc, fn)(tst, _t(x5), _t(target))
        assert tst.step == int(jst.step)
        np.testing.assert_allclose(float(tst.loss), float(jst.loss),
                                   rtol=1e-4)
        _leaves_close(tst.params, jst.params, 1e-4, 1e-6, 0.99, "params")
        _leaves_close(tst.ema_params, jst.ema_params, 1e-4, 1e-6, 0.99,
                      "ema")
        if opt == "Adam":
            assert tst.opt_state["count"] == int(jst.opt_state[0].count)
            _leaves_close(tst.opt_state["mu"], jst.opt_state[0].mu, 1e-4,
                          1e-8, 0.99, "mu")
            _leaves_close(tst.opt_state["nu"], jst.opt_state[0].nu, 1e-4,
                          1e-12, 0.99, "nu")
    assert tst.step == 4


# -- trace_fixed --------------------------------------------------------------

W, H = 48, 27


def _volumes():
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    return (JVolume.from_dense(data, 0.6, 0.8),
            TVolume.from_dense(data, 0.6, 0.8, device="cpu"))


@pytest.mark.parametrize("spp,staged", [(1, False), (2, False), (2, True)])
def test_trace_fixed_matches_jax(monkeypatch, spp, staged):
    """``spp`` chained passes of 8 bounces from inside the volume.  staged
    lowers COMPACT_MIN_LANES in both packages so the JAX package's
    capacities, with their dense fallbacks, pick the schedule."""
    if staged:
        for mod in (jtr, jint, ttr):
            monkeypatch.setattr(mod, "COMPACT_MIN_LANES", 64)
    jv, tv = _volumes()
    scene = jcfg.SceneConfig.preset(4)
    jp = jint.TraceParams(flags=JLightFlags.from_scene(scene))
    tp = tint.TraceParams(flags=LightFlags.from_scene(tcfg.SceneConfig.preset(
        4)))
    rs = np.random.RandomState(9)
    ro = rs.uniform(-20, 20, (N, 3)).astype(np.float32)
    rd = rs.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    state = rs.rand(N).astype(np.float32)
    jstate, tstate = jnp.asarray(state), _t(state)
    jl = jlights(scene)
    tl = lights_from_scene(tcfg.SceneConfig.preset(4), device="cpu")
    for _ in range(spp):
        jres = jint.trace_fixed(jstate, jv, jl, jp, jnp.asarray(ro),
                                jnp.asarray(rd), 8)
        tres = tint.trace_fixed(tstate, tv, tl, tp, _t(ro), _t(rd), 8)
        jstate, tstate = jres["state"], tres["state"]
        assert np.array_equal(np.asarray(jstate).view(np.uint32),
                              tstate.numpy().view(np.uint32)), \
            "RNG state bitwise, dead lanes included"
        alive = tres["alive"].numpy()
        assert (alive == np.asarray(jres["alive"])).mean() >= 0.99
        for k in ("radiance", "throughput", "terminal_pos"):
            err = np.abs(tres[k].numpy() - np.asarray(jres[k]))
            err = err.reshape(N, -1).max(-1)
            assert (err <= 1e-3).mean() >= 0.99, k
    assert 0.05 < (~alive).mean() < 0.95, "some lanes die on the way"


# -- whole frames -------------------------------------------------------------

KW = dict(render_width=W, render_height=H, nn_width=16, nn_depth=2,
          log2_train_batch_size=6, train_batch_count=2, train_ray_length=4)


def _frame_cfgs(**kw):
    enc = dict(n_levels=4, log2_hashmap_size=12)
    return (jcfg.AppConfig(encoding=jcfg.EncodingConfig(**enc), **KW, **kw),
            tcfg.AppConfig(encoding=tcfg.EncodingConfig(**enc), **KW, **kw))


def _scattered(img):
    return np.abs(img[..., :3] - 0.1).max(-1) > 1e-6   # scene 4 env = 0.1


@pytest.mark.parametrize("kw", [
    pytest.param(dict(train_cache_bootstrap=False), id="False"),
    pytest.param(dict(train_cache_bootstrap=True), id="True"),
    pytest.param(dict(primary_ray_length=3), id="primary_ray_length3"),
    pytest.param(dict(primary_ray_prob=0.5), id="primary_ray_prob0.5"),
    pytest.param(dict(train_spp=2), id="train_spp2")])
def test_two_train_frames_match(kw):
    """Two online frames from one state, at the cache bootstrap's two
    settings and at a longer primary path, a random primary continuation
    and two train paths per pixel: beside the frame rule, every pixel
    within 4e-4, the loss within 1e-5 relative and the key bitwise."""
    jc, tc = _frame_cfgs(**kw)
    jv, tv = _volumes()
    jr = jren.NrcRenderer(jc, vol=jv)
    js = jr.init_state(0)
    tr = tren.NrcRenderer(tc, vol=tv)
    assert (tr.train_w, tr.train_h, tr.train_x_dist, tr.train_y_dist) == \
        (jr.train_w, jr.train_h, jr.train_x_dist, jr.train_y_dist)
    ts = tr.init_state(0, nrc=state_from_jax(_np(js.nrc), device="cpu"))
    cam_j = jcam.Camera.reference_camera(W / H)
    cam_t = tcam.Camera.reference_camera(W / H, device="cpu")
    key = js.key
    for frame in range(2):
        key, sub = jax.random.split(key)
        fr = np.asarray(jrng.frame_random(sub))
        js = jr.step(js, cam_j)                      # trains by default
        ts = tr.step(ts, cam_t, frame_random=torch.tensor(fr))
        jimg, timg = np.asarray(js.image), ts.image.numpy()
        assert np.isfinite(timg).all()
        agree = _scattered(jimg) == _scattered(timg)
        assert agree.mean() >= 0.99, f"frame {frame}: did_scatter"
        assert np.abs(timg - jimg).max(-1)[agree].max() <= 1e-3
        assert np.abs(timg - jimg).max() <= 4e-4
        assert float(ts.nrc.loss) == pytest.approx(float(js.nrc.loss),
                                                   rel=1e-5)
        assert np.array_equal(ts.key.numpy(),
                              np.asarray(js.key).astype(np.int64))
        assert ts.nrc.step == int(js.nrc.step) == 2 * (frame + 1)
        assert int(ts.ring.head) == int(js.ring.head)
        assert int(ts.ring.tail) == int(js.ring.tail)
        err = np.abs(ts.ring.data.numpy() - np.asarray(js.ring.data))
        assert (err.max(-1) <= 1e-3).mean() >= 0.99
        _leaves_close(ts.nrc.params, js.nrc.params, 1e-4, 1e-6, 0.99,
                      "params")
        _leaves_close(ts.nrc.ema_params, js.nrc.ema_params, 1e-4, 1e-6,
                      0.99, "ema")
        assert np.isfinite(float(ts.nrc.loss))
    assert int(ts.ring.head) > 0 and int(ts.ring.tail) > 0
