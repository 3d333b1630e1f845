"""The port's AppConfig against the JAX package's: the reference's 17
positional arguments give the same fields and the same output-directory
name, bad argument lists raise in both, and every field the port keeps
has the JAX default.  All comparisons are exact."""

import dataclasses

import pytest

from nrc_hpm_tpu import config as jcfg
from nrc_hpm_tpu_torch import config as tcfg

NON_DEFAULT = ["L2", "SGD", "0.005", "0.95", "3", "2", "32", "4", "20",
               "12", "2", "5", "0.5", "2", "2", "0.3", "16"]


def _same_fields(port, ref):
    """Every field of the port's dataclass equals the JAX field of the
    same name (nested dataclasses field by field)."""
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(got):
            _same_fields(got, want)
        else:
            assert got == want, f"{type(port).__name__}.{f.name}"


def test_default_argv_matches_jax():
    assert tcfg.DEFAULT_ARGV == jcfg.DEFAULT_ARGV
    port = tcfg.AppConfig.from_argv(tcfg.DEFAULT_ARGV)
    ref = jcfg.AppConfig.from_argv(jcfg.DEFAULT_ARGV)
    _same_fields(port, ref)
    assert port.name() == ref.name()
    # the default argv is the default configuration
    _same_fields(tcfg.AppConfig(), ref)
    assert tcfg.AppConfig().name() == port.name()


def test_non_default_argv_matches_jax():
    port = tcfg.AppConfig.from_argv(NON_DEFAULT)
    ref = jcfg.AppConfig.from_argv(NON_DEFAULT)
    _same_fields(port, ref)
    assert port.name() == ref.name()
    assert (port.encoding.pos_id, port.encoding.dir_id) == (3, 2)
    assert port.infer_batch_size == ref.infer_batch_size == 1 << 20
    assert port.train_subset() == ref.train_subset()
    assert port.train_ring_size == ref.train_ring_size


@pytest.mark.parametrize("argv", [
    NON_DEFAULT[:-1],                           # 16 arguments
    NON_DEFAULT + ["1"],                        # 18 arguments
    NON_DEFAULT[:2] + ["fast"] + NON_DEFAULT[3:],   # not a float
    NON_DEFAULT[:11] + ["7"] + NON_DEFAULT[12:],    # no scene 7
], ids=["short", "long", "bad-float", "bad-scene"])
def test_bad_argv_raises_like_jax(argv):
    with pytest.raises(ValueError):
        jcfg.AppConfig.from_argv(argv)
    with pytest.raises(ValueError):
        tcfg.AppConfig.from_argv(argv)


def test_new_fields_have_jax_defaults():
    for name in ("mlp_dtype", "env_fixed16", "log2_infer_batch_size"):
        assert getattr(tcfg.AppConfig(), name) == \
            getattr(jcfg.AppConfig(), name)
    for name in ("pos_n_frequencies", "dir_n_frequencies"):
        assert getattr(tcfg.EncodingConfig(), name) == \
            getattr(jcfg.EncodingConfig(), name)


# every AppConfig field the two packages share, each off its default
SHARED_KW = dict(
    loss_fn="L1", optimizer="SGD", learning_rate=0.02, ema_decay=0.9,
    encoding=dict(pos_id=2, dir_id=1, n_levels=8, n_features_per_level=4,
                  log2_hashmap_size=14, base_resolution=8,
                  per_level_scale=1.5, pos_n_frequencies=6,
                  dir_n_frequencies=2, oneblob_n_bins=8),
    nn_width=32, nn_depth=3, log2_infer_batch_size=18,
    log2_train_batch_size=10, train_batch_count=2,
    scene=dict(id=3, dir_light_strength=4.0, point_light_strength=2.0,
               hdr_env_map_path="env.hdr", hdr_env_map_strength=0.5,
               density=0.3, dynamic=True, volume_path="v.vdb",
               volume_g=0.5),
    train_ring_buf_size=2.0, train_spp=2, primary_ray_length=2,
    primary_ray_prob=0.5, train_ray_length=16, render_width=640,
    render_height=360,
    restir=dict(path_vertex_count=5, spatial_kernel_size=5,
                temporal_kernel_size=3, mis_weights=False),
    max_track_steps=64, max_primary_bounces=32, mc_path_length=64,
    mlp_dtype="float32", trace_chunks=4, infer_filter=False, compact=True,
    hash_train_fast=False, env_fixed16=True, train_target_clamp=4.0,
    train_cache_bootstrap=True, mesh=dict(rays=2, axis_name="x"))
NESTED = dict(encoding="EncodingConfig", scene="SceneConfig",
              restir="RestirConfig", mesh="MeshConfig")
# the JAX fields the port leaves out: the static TPU compaction capacities
# have nothing to port
NOT_PORTED = {"infer_compact", "infer_compact_frac"}


def _build(mod):
    kw = {k: getattr(mod, NESTED[k])(**v) if k in NESTED else v
          for k, v in SHARED_KW.items()}
    return mod.AppConfig(**kw)


def test_every_shared_field_builds_alike():
    """Both AppConfigs from one keyword dict that sets every field the
    port has to a value off its default: the same fields, the same
    derived sizes and name."""
    names = {f.name for f in dataclasses.fields(tcfg.AppConfig)}
    assert names == set(SHARED_KW)
    assert {f.name for f in dataclasses.fields(jcfg.AppConfig)} - names \
        == NOT_PORTED
    port, ref = _build(tcfg), _build(jcfg)
    _same_fields(port, ref)
    for f in dataclasses.fields(tcfg.AppConfig):
        assert getattr(port, f.name) != getattr(tcfg.AppConfig(), f.name), \
            f"{f.name} is left at its default"
    assert port.name() == ref.name()
    assert port.train_subset() == ref.train_subset()
    assert port.train_ring_size == ref.train_ring_size
    _same_fields(tcfg.RestirConfig(), jcfg.RestirConfig())
    _same_fields(tcfg.MeshConfig(), jcfg.MeshConfig())
