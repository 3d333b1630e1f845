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
