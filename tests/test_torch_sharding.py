"""The port's ShardedNrcRenderer (``nrc_hpm_tpu_torch.parallel.sharding``)
on gloo ranks spawned on the CPU (``tests/torch_sharding_ranks.py``).

Against the JAX package's ShardedNrcRenderer at mesh 4, from one state
(``weights.sharded_state_from_jax`` of the JAX global state): 64x32
pixels, scene preset 4, 4 hash levels at 2^12, a 32x2 MLP, 2 x 64 train
samples, 4-bounce train paths (tests/test_sharding.py's configuration),
on the 8^3 volume of tests/test_torch_frame.py.  A frozen frame under the
port's frame rule (did-scatter equal on >= 99% of pixels, the image
within 1e-3 there); one online frame: the loss within 1e-4 relative, the
parameters and the EMA under test_torch_train.py's online-frame rule
(>= 99% of each leaf's entries within 1e-4 relative), and each rank's
ring head and tail equal to its JAX shard's.  The same online frame at
mesh 3 and height 30: padded rows and weight-0 train lanes.  On the
procedural cloud the compiled JAX frame itself flips stochastic events
against JAX's own eager trace on a few percent of the pixels (ROADMAP.md
§3), so the port is held to JAX on the 8^3 volume, as the frame tests
hold it.

Against itself, on the procedural cloud, tests/test_sharding.py's
assertions with its tolerances: one rank against four after one frame
(the loss within 1e-5 relative, the hash table bitwise, the MLP within
2e-4), the single-device NrcRenderer against the sharded frozen frame
(> 97% of pixels within 1e-4, the mean within 5e-3), height 30 over four
ranks (32 padded rows) and over three ranks with padded train batches
(the first layer's update correlated > 0.95 with the single-device one).
After every online frame the replicas (parameters, EMA, Adam state, loss,
key) are bitwise equal across ranks.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from nrc_hpm_tpu import camera as jcam
from nrc_hpm_tpu import config as jcfg
from nrc_hpm_tpu.parallel.sharding import ShardedNrcRenderer as JSharded
from nrc_hpm_tpu.parallel.sharding import make_mesh
from nrc_hpm_tpu.volume import Volume as JVolume
from nrc_hpm_tpu_torch import camera as tcam
from nrc_hpm_tpu_torch import config as tcfg
from nrc_hpm_tpu_torch.models.nrc.cache import tree_leaves
from nrc_hpm_tpu_torch.parallel import sharding
from nrc_hpm_tpu_torch.renderer import NrcRenderer
from nrc_hpm_tpu_torch.utils.procedural import cloud_density
from nrc_hpm_tpu_torch.volume import Volume as TVolume
from nrc_hpm_tpu_torch.weights import sharded_state_from_jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharding_ranks as tsr  # noqa: E402

W = 64
KW = dict(render_width=W, render_height=32, nn_width=32, nn_depth=2,
          log2_infer_batch_size=11, log2_train_batch_size=6,
          train_batch_count=2, train_ray_length=4)
ENC = dict(n_levels=4, log2_hashmap_size=12)
SEED = 7


def _tcfg(**kw):
    return tcfg.AppConfig(encoding=tcfg.EncodingConfig(**ENC),
                          **{**KW, **kw})


def _np(tree):
    """A copy of a JAX pytree as numpy arrays (JAX steps donate)."""
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _scattered(img):
    return np.abs(img[..., :3] - 0.1).max(-1) > 1e-6   # scene 4 env = 0.1


def _frame_rule(got, want):
    agree = _scattered(got) == _scattered(want)
    assert agree.mean() >= 0.99, f"did_scatter agrees on {agree.mean():.4f}"
    assert np.abs(got - want).max(-1)[agree].max() <= 1e-3


def _leaves_close(got_tree, want_tree, what):
    """>= 99% of each leaf's entries within 1e-4 relative + 1e-6."""
    got, want = tree_leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy().astype(np.float64), np.asarray(w, np.float64)
        share = (np.abs(g - w) <= 1e-6 + 1e-4 * np.abs(w)).mean()
        assert share >= 0.99, f"{what} leaf {i}: {share:.5f} close"


@pytest.fixture(scope="module")
def vol8():
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    return (JVolume.from_dense(data, 0.6, 0.8),
            TVolume.from_dense(data, 0.6, 0.8, device="cpu"))


@pytest.fixture(scope="module")
def cloud():
    return TVolume.from_dense(cloud_density(0), 0.6, 0.8, device="cpu")


def _jax_run(vol, n, height, frozen):
    """The JAX mesh-n renderer's frames from init_state(SEED) (the online
    one, and the frozen one with ``frozen``) and the port's per-rank start
    states."""
    cfg = jcfg.AppConfig(encoding=jcfg.EncodingConfig(**ENC),
                         **{**KW, "render_height": height})
    r = JSharded(cfg, mesh=make_mesh(n), vol=vol)
    cam = jcam.Camera.reference_camera(aspect=W / height)
    start = _np(r.init_state(SEED))
    starts = [sharded_state_from_jax(start, k, n, device="cpu")
              for k in range(n)]
    out = {}
    for train in (False, True)[0 if frozen else 1:]:
        st = r.step(jax.tree.map(jax.numpy.asarray, start), cam,
                    train=train)
        out[train] = dict(image=np.asarray(r.final_image(st)),
                          state=_np(st))
    return starts, out


@pytest.fixture(scope="module")
def jax_runs(vol8):
    """At mesh 4, 64x32: the frozen and the online frame; at mesh 3,
    64x30: the online frame (32 padded rows, 2 weight-0 lanes a batch)."""
    return {4: _jax_run(vol8[0], 4, 32, True),
            3: _jax_run(vol8[0], 3, 30, False)}


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory, jax_runs, vol8, cloud):
    starts = jax_runs[4][0]
    h30 = _tcfg(render_height=30)
    runs = [("jax_frozen", _tcfg(), vol8[1], starts, False),
            ("jax_online", _tcfg(), vol8[1], starts, True),
            ("frozen", _tcfg(), cloud, SEED, False),
            ("online", _tcfg(), cloud, SEED, True),
            ("h30_frozen", h30, cloud, SEED, False),
            ("h30_online", h30, cloud, SEED, True)]
    return tsr.spawn(4, str(tmp_path_factory.mktemp("ranks4")),
                     tsr.step_runs, runs)


@pytest.fixture(scope="module")
def ranks3(tmp_path_factory, jax_runs, vol8, cloud):
    h30 = _tcfg(render_height=30)
    runs = [("jax_online", h30, vol8[1], jax_runs[3][0], True),
            ("h30_online", h30, cloud, SEED, True)]
    return tsr.spawn(3, str(tmp_path_factory.mktemp("ranks3")),
                     tsr.step_runs, runs)


@pytest.fixture(scope="module")
def rank1(cloud):
    """One online frame at 64x32 and at 64x30 on a one-rank group of this
    process (``make_group(1)``), torn down after."""
    group = sharding.make_group(1, device="cpu")
    try:
        return {h: tsr.step_run(group, 0, _tcfg(render_height=h), cloud,
                                SEED, True) for h in (32, 30)}
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def single(cloud):
    """The single-device renderer's frames from init_state(SEED)."""
    out = {}
    for name, cfg, train in (("frozen", _tcfg(), False),
                             ("h30_frozen", _tcfg(render_height=30), False),
                             ("h30_online", _tcfg(render_height=30), True)):
        r = NrcRenderer(cfg, vol=cloud)
        cam = tcam.Camera.reference_camera(aspect=r.width / r.height,
                                           device="cpu")
        st = r.init_state(SEED)
        out[name] = dict(start=st, end=r.step(st, cam, train=train))
    return out


def test_frozen_frame_matches_jax(ranks4, jax_runs):
    want = jax_runs[4][1][False]["image"]
    rows = want.shape[0] // 4
    for k, res in enumerate(ranks4):
        got = res["jax_frozen"]
        assert got["image"].shape == (32, W, 4)
        assert torch.equal(got["local"],
                           got["image"][k * rows:(k + 1) * rows])
        assert torch.equal(got["image"], ranks4[0]["jax_frozen"]["image"])
    _frame_rule(ranks4[0]["jax_frozen"]["image"].numpy(), want)


@pytest.mark.parametrize("world", [4, 3])
def test_online_frame_matches_jax(ranks4, ranks3, jax_runs, world):
    """At 4 ranks 64x32; at 3 ranks 64x30 with padded rows and weight-0
    train lanes."""
    want = jax_runs[world][1][True]
    results = {4: ranks4, 3: ranks3}[world]
    got = results[0]["jax_online"]
    _frame_rule(got["image"].numpy(), want["image"])
    jn = want["state"].nrc
    assert got["nrc"].step == int(jn.step) == 2
    np.testing.assert_allclose(float(got["nrc"].loss), float(jn.loss),
                               rtol=1e-4)
    _leaves_close(got["nrc"].params, jn.params, "params")
    _leaves_close(got["nrc"].ema_params, jn.ema_params, "ema")
    assert got["nrc"].opt_state["count"] == int(jn.opt_state[0].count)


@pytest.mark.parametrize("world", [4, 3])
def test_ring_cursors_match_jax(ranks4, ranks3, jax_runs, world):
    ring = jax_runs[world][1][True]["state"].ring
    cap = ring.data.shape[0] // world
    for k, res in enumerate({4: ranks4, 3: ranks3}[world]):
        got = res["jax_online"]
        assert (got["head"], got["tail"]) == (int(ring.head[k]),
                                              int(ring.tail[k]))
        err = np.abs(got["ring"].numpy() - ring.data[k * cap:(k + 1) * cap])
        assert (err.max(-1) <= 1e-3).mean() >= 0.99
    assert (ring.head + ring.tail > 0).all()


def test_one_rank_matches_four_after_one_frame(ranks4, rank1):
    """tests/test_sharding.py::test_sharded_frame1_global_batch_exact."""
    one, four = rank1[32]["nrc"], ranks4[0]["online"]["nrc"]
    l1, l4 = float(one.loss), float(four.loss)
    assert abs(l1 - l4) <= 1e-5 * max(abs(l1), 1.0), (l1, l4)
    for a, b in zip(tree_leaves(one.params["encoding"]),
                    tree_leaves(four.params["encoding"])):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(one.params["mlp"]),
                    tree_leaves(four.params["mlp"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)
    assert rank1[32]["image"].shape == ranks4[0]["online"]["image"].shape


def test_one_rank_is_the_single_device_frame(rank1, single):
    """At height 30 (1/30 inexact) one rank's online frame equals the
    single-device one bit for bit: its train pixels' re-traced primaries
    are the frame's own (their UVs multiply by the float32 reciprocal, as
    the frame's do and XLA compiles the JAX shard's divisions), and their
    train paths start from the same seeds."""
    got, want = rank1[30], single["h30_online"]["end"]
    assert torch.equal(got["image"], want.image)
    for a, b in zip(tree_leaves([got["nrc"].params, got["nrc"].ema_params,
                                 got["nrc"].loss]),
                    tree_leaves([want.nrc.params, want.nrc.ema_params,
                                 want.nrc.loss])):
        assert torch.equal(a, b)
    assert (got["head"], got["tail"]) == (int(want.ring.head),
                                          int(want.ring.tail))


def _single_vs_sharded(img_a, img_b):
    per_px = np.abs(img_a - img_b).max(axis=-1)
    assert (per_px < 1e-4).mean() > 0.97, (per_px < 1e-4).mean()
    assert abs(img_a.mean() - img_b.mean()) < 5e-3


def test_sharded_matches_single_device_frozen(ranks4, single):
    """tests/test_sharding.py::test_sharded_matches_single_chip_frozen."""
    _single_vs_sharded(single["frozen"]["end"].image.numpy(),
                       ranks4[0]["frozen"]["image"].numpy())


def _corr(a, b, w0):
    da, db = (a - w0).ravel(), (b - w0).ravel()
    return np.dot(da, db) / (np.linalg.norm(da) * np.linalg.norm(db))


def test_non_divisible_dims_pad_and_match_single_device(ranks4, ranks3,
                                                        single):
    """tests/test_sharding.py::test_non_divisible_dims_pad_and_match_
    single_chip: height 30 over 4 ranks pads to 32 rows; 64-pixel
    batches over 3 ranks take 22 lanes a rank, 2 of them at weight 0."""
    got = ranks4[0]["h30_frozen"]
    assert (got["pad_h"], got["local_h"]) == (32, 8)
    assert got["image"].shape == (30, W, 4)
    assert not got["padded_train"]
    _single_vs_sharded(single["h30_frozen"]["end"].image.numpy(),
                       got["image"].numpy())
    # the last rank's rows 30 and 31 trace out-of-frame rays
    assert ranks4[3]["h30_frozen"]["local"].shape == (8, W, 4)
    assert torch.isfinite(ranks4[3]["h30_frozen"]["local"]).all()

    got = ranks3[0]["h30_online"]
    assert got["padded_train"] and got["bs_l"] == 22
    assert (got["pad_h"], got["local_h"]) == (30, 10)
    w0 = single["h30_online"]["start"].nrc.params["mlp"]["layers"][0]
    wa = single["h30_online"]["end"].nrc.params["mlp"]["layers"][0]
    wb = got["nrc"].params["mlp"]["layers"][0]
    corr = _corr(wa.numpy(), wb.numpy(), w0.numpy())
    assert corr > 0.95, corr
    assert np.isfinite(float(got["nrc"].loss))
    assert got["nrc"].step == 2


def _replicated(nrc):
    return tree_leaves([nrc.params, nrc.ema_params, nrc.opt_state["mu"],
                        nrc.opt_state["nu"], nrc.loss])


@pytest.mark.parametrize("world,run", [
    (4, "jax_online"), (4, "online"), (4, "h30_online"), (3, "jax_online"),
    (3, "h30_online")])
def test_replicas_bitwise_equal(ranks4, ranks3, world, run):
    results = {4: ranks4, 3: ranks3}[world]
    first = results[0][run]["nrc"]
    assert first.step == 2
    for res in results[1:]:
        nrc = res[run]["nrc"]
        assert (nrc.step, nrc.opt_state["count"]) == \
            (first.step, first.opt_state["count"])
        for a, b in zip(_replicated(nrc), _replicated(first)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert torch.equal(res[run]["image"], results[0][run]["image"])
        assert torch.equal(res[run]["key"], results[0][run]["key"])


def test_one_rank_group_changes_no_bit(cloud):
    """A train_step on a one-rank group (all-reduce, divide by 1) equals
    the step without a group, with and without weights."""
    from nrc_hpm_tpu_torch.models.nrc.cache import NeuralRadianceCache
    from nrc_hpm_tpu_torch.utils import prng

    cache = NeuralRadianceCache(_tcfg())
    st = cache.init_state(prng.prng_key(3), device="cpu")
    rs = np.random.RandomState(5)
    x5 = torch.from_numpy(rs.uniform(0, 1, (64, 5)).astype(np.float32))
    target = torch.from_numpy(rs.exponential(0.5, (64, 3)).astype(
        np.float32))
    weight = torch.from_numpy((rs.rand(64) < 0.8).astype(np.float32))
    group = sharding.make_group(1, device="cpu")
    try:
        for w in (None, weight):
            a = cache.train_step(st, x5, target, weight=w)
            b = cache.train_step(st, x5, target, group=group, weight=w)
            for x, y in zip(_replicated(a), _replicated(b)):
                assert torch.equal(x, y)
    finally:
        dist.destroy_process_group()


def test_weighted_step_matches_jax():
    """train_step(weight=) against the JAX package's: the weighted sum of
    the per-sample losses over the weight's sum (at least 1)."""
    from nrc_hpm_tpu.models.nrc.cache import NeuralRadianceCache as JCache
    from nrc_hpm_tpu_torch.models.nrc.cache import NeuralRadianceCache
    from nrc_hpm_tpu_torch.weights import state_from_jax

    jc = JCache(jcfg.AppConfig(encoding=jcfg.EncodingConfig(**ENC), **KW))
    tc = NeuralRadianceCache(_tcfg())
    js = jc.init_state(jax.random.PRNGKey(3))
    ts = state_from_jax(_np(js), device="cpu")
    rs = np.random.RandomState(5)
    x5 = rs.uniform(0, 1, (64, 5)).astype(np.float32)
    target = rs.exponential(0.5, (64, 3)).astype(np.float32)
    weight = (rs.rand(64) < 0.7).astype(np.float32)
    jst = jc.train_step(js, jax.numpy.asarray(x5),
                        jax.numpy.asarray(target),
                        weight=jax.numpy.asarray(weight))
    tst = tc.train_step(ts, torch.from_numpy(x5), torch.from_numpy(target),
                        weight=torch.from_numpy(weight))
    np.testing.assert_allclose(float(tst.loss), float(jst.loss), rtol=1e-5)
    _leaves_close(tst.params, jst.params, "params")
    _leaves_close(tst.opt_state["mu"], jst.opt_state[0].mu, "mu")


def test_make_group_refusals(monkeypatch):
    """No group of 2 ranks to join: the error names torchrun; never two
    NCCL ranks on one card."""
    for k in sharding._TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        sharding.make_group(2, device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in dict(RANK="0", WORLD_SIZE="2", MASTER_ADDR="localhost",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="one rank per card"):
        sharding.make_group(2)
    with pytest.raises(ValueError, match="torchrun started 2 ranks"):
        sharding.make_group(4)
    assert not dist.is_initialized()


def test_config_mesh_rays_sizes_the_group(cloud):
    """Without a group the renderer asks make_group for cfg.mesh.rays
    ranks: one here, a one-rank group of this process."""
    cfg = dataclasses.replace(_tcfg(), mesh=tcfg.MeshConfig(rays=1))
    try:
        r = sharding.ShardedNrcRenderer(cfg, vol=cloud)
        assert (r.n, r.rank, r.pad_h, r.local_h) == (1, 0, 32, 32)
        assert r.device.type == "cpu"
    finally:
        dist.destroy_process_group()
    cfg = dataclasses.replace(_tcfg(), mesh=tcfg.MeshConfig(rays=2))
    with pytest.raises(RuntimeError, match="torchrun"):
        sharding.ShardedNrcRenderer(cfg, vol=cloud)
