"""The plain versions of kernels K1 (pw_events) and K2 (pw_profile)
against the Pallas kernels in interpret mode and against the XLA
profile/inversion machinery.

Tolerances: the plain versions keep the kernels' operation order, so the
integer outputs and the per-interval fields agree exactly; XLA on the CPU
contracts some multiply-adds into FMAs, so depths and event distances
carry ulp-level differences (the bounds of tests/test_pw_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import transmittance as jtr
from nrc_hpm_tpu.ops.pw_kernels import pw_events, pw_profile
from nrc_hpm_tpu.volume import Volume as JVolume
from nrc_hpm_tpu_torch.ops import pw_kernels as pk
from nrc_hpm_tpu_torch.volume import Volume as TVolume


def _volumes():
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    return (JVolume.from_dense(data, 0.6, 0.8),
            TVolume.from_dense(data, 0.6, 0.8))


def _lanes(n, seed):
    r = np.random.RandomState(seed)
    start = r.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = r.uniform(0.5, 60.0, n).astype(np.float32)
    seed_u = r.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    e_last = r.uniform(0.0, 2.0, n).astype(np.float32)
    return start, d, tmax, seed_u, e_last


def _torch(start, d, tmax, seed_u):
    return (torch.from_numpy(start), torch.from_numpy(d),
            torch.from_numpy(tmax), torch.from_numpy(seed_u.view(np.int32)))


@pytest.mark.parametrize("salt", [pk.SALT_RATIO, pk.SALT_DELTA])
def test_events_plain_matches_pallas_interpret(salt):
    jv, tv = _volumes()
    start, d, tmax, seed_u, e_last = _lanes(256, 3)
    want = pw_events(jv, jnp.asarray(start), jnp.asarray(d),
                     jnp.asarray(tmax), jnp.asarray(seed_u),
                     jnp.asarray(e_last), 5, S=8, salt=salt, interpret=True)
    got = pk.pw_events(tv, *_torch(start, d, tmax, seed_u),
                       torch.from_numpy(e_last), 5, S=8, salt=salt)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert got["lin"].shape == (8, 256) and got["lin"].dtype == np.int32
    for k in ("lin", "c_at", "sres", "ctot"):
        assert np.array_equal(got[k], want[k]), f"{k} must agree exactly"
    np.testing.assert_allclose(got["t"], want["t"], rtol=1e-4, atol=1e-5,
                               err_msg="t within rtol 1e-4, atol 1e-5")
    for k in ("e_new", "rtot"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6,
                                   err_msg=f"{k} within rtol 2e-5")


@pytest.mark.parametrize("want_ctrl", [False, True])
def test_profile_plain_matches_pallas_interpret(want_ctrl):
    jv, tv = _volumes()
    start, d, tmax, seed_u, _ = _lanes(256, 5)
    want = pw_profile(jv, jnp.asarray(start), jnp.asarray(d),
                      jnp.asarray(tmax), jnp.asarray(seed_u),
                      want_ctrl=want_ctrl, interpret=True)
    got = pk.pw_profile(tv, *_torch(start, d, tmax, seed_u),
                        want_ctrl=want_ctrl)
    assert np.array_equal(got["ctot"].numpy(), np.asarray(want["ctot"]))
    assert np.array_equal(got["t_ctrl"].numpy() < 1e37,
                          np.asarray(want["t_ctrl"]) < 1e37), \
        "control collisions must agree"
    np.testing.assert_allclose(got["t_ctrl"].numpy(),
                               np.asarray(want["t_ctrl"]), rtol=1e-4,
                               atol=1e-5, err_msg="t_ctrl within rtol 1e-4")
    np.testing.assert_allclose(got["rtot"].numpy(), np.asarray(want["rtot"]),
                               rtol=2e-5, atol=1e-6,
                               err_msg="rtot within rtol 2e-5")


def test_plain_matches_xla_profile_and_inversion():
    jv, tv = _volumes()
    start, d, tmax, seed_u, _ = _lanes(512, 7)
    n = 512
    got = pk.pw_events(tv, *_torch(start, d, tmax, seed_u),
                       torch.zeros(n), 0, S=8)
    sigma, c, ccum, rcum, h = jtr._coarse_profile(
        jv, jnp.asarray(start), jnp.asarray(d), jnp.asarray(tmax), 32)
    np.testing.assert_allclose(got["rtot"].numpy(), np.asarray(rcum[-1]),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got["ctot"].numpy(), np.asarray(ccum[-1]),
                               rtol=2e-5, atol=1e-6)
    u = jtr._indexed_draws_lead(jnp.asarray(seed_u), jnp.uint32(0), 8,
                                salt=pk.SALT_RATIO)
    E = jnp.cumsum(-jnp.log1p(-u), axis=0)
    t_ref, beyond_ref, (c_ref, s_ref) = jtr._map_events(E, rcum, h,
                                                        (c, sigma))
    t_k = got["t"].numpy()
    assert np.array_equal(t_k < 0, np.asarray(beyond_ref)), \
        "beyond-segment events must agree"
    live = t_k >= 0
    np.testing.assert_allclose(t_k[live], np.asarray(t_ref)[live],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["c_at"].numpy()[live],
                               np.asarray(c_ref)[live], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        got["sres"].numpy()[live],
        np.maximum(np.asarray(s_ref - c_ref), 1e-12)[live], rtol=1e-5,
        atol=1e-7)


def test_events_e_base_continues_stream():
    _, tv = _volumes()
    start, d, tmax, seed_u, _ = _lanes(256, 9)
    lanes = _torch(start, d, tmax, seed_u)
    one = pk.pw_events(tv, *lanes, torch.zeros(256), 0, S=16)
    half = pk.pw_events(tv, *lanes, torch.zeros(256), 0, S=8)
    rest = pk.pw_events(tv, *lanes, half["e_new"], 8, S=8)
    assert torch.equal(rest["e_new"], one["e_new"]), \
        "the event depth is a sequential sum: halves equal the whole"
    assert torch.equal(torch.cat([half["t"], rest["t"]]), one["t"])
