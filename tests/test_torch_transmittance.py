"""The port's piecewise delta/ratio trackers against the JAX package's.

The JAX package on the CPU runs its XLA tracking path; the port runs the
kernel contract (K2 profile + K1 segments) through the plain versions.
Draws are identical (bitwise RNG), so lanes agree up to float
reassociation: XLA contracts some multiply-adds into FMAs, which moves
event depths by ulps.  Tolerances: the new RNG state bitwise; >= 99% of
lanes within 1e-5 (transmittance) or 1e-3 world units (collision point),
and the exit flag equal on >= 99% of lanes.  One case lowers
COMPACT_MIN_LANES in both packages so the staged segment schedule
(RATIO_PLAN / DELTA_PLAN) runs at this small size."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import transmittance as jtr
from nrc_hpm_tpu.volume import Volume as JVolume
from nrc_hpm_tpu_torch import transmittance as ttr
from nrc_hpm_tpu_torch.volume import Volume as TVolume

N = 1024


def _volumes():
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    return (JVolume.from_dense(data, 0.6, 0.8),
            TVolume.from_dense(data, 0.6, 0.8, device="cpu"))


def _rays(seed):
    r = np.random.RandomState(seed)
    start = r.uniform(-40.0, 40.0, (N, 3)).astype(np.float32)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    end = (start + d * r.uniform(1.0, 80.0, (N, 1))).astype(np.float32)
    state = r.rand(N).astype(np.float32)
    active = r.rand(N) < 0.9
    return start, d, end, state, active


def _staged(monkeypatch, staged):
    if staged:
        monkeypatch.setattr(jtr, "COMPACT_MIN_LANES", 64)
        monkeypatch.setattr(ttr, "COMPACT_MIN_LANES", 64)


@pytest.mark.parametrize("staged", [False, True])
def test_ratio_track_pw_matches_jax(monkeypatch, staged):
    _staged(monkeypatch, staged)
    jv, tv = _volumes()
    start, _, end, state, active = _rays(3)
    tj, sj = jtr.ratio_track_pw(jnp.asarray(state), jv, jnp.asarray(start),
                                jnp.asarray(end), segment=8,
                                active=jnp.asarray(active))
    tt, st = ttr.ratio_track_pw(torch.from_numpy(state), tv,
                                torch.from_numpy(start),
                                torch.from_numpy(end), segment=8,
                                active=torch.from_numpy(active))
    tj, tt = np.asarray(tj), tt.numpy()
    assert np.array_equal(np.asarray(sj).view(np.uint32),
                          st.numpy().view(np.uint32)), "state bitwise"
    assert 0.05 < (tj < 0.999).mean(), "the segments must cross the medium"
    close = np.abs(tt - tj) <= 1e-5
    assert close.mean() >= 0.99, f"{close.mean():.4f} of lanes within 1e-5"
    assert np.all(tt[~active] == 1.0), "inactive lanes transmit fully"


@pytest.mark.parametrize("staged", [False, True])
def test_delta_track_pw_matches_jax(monkeypatch, staged):
    _staged(monkeypatch, staged)
    jv, tv = _volumes()
    start, d, _, state, active = _rays(5)
    start = start * 0.5
    pj, ej, sj = jtr.delta_track_pw(jnp.asarray(state), jv,
                                    jnp.asarray(start), jnp.asarray(d),
                                    segment=8, active=jnp.asarray(active))
    pt, et, st = ttr.delta_track_pw(torch.from_numpy(state), tv,
                                    torch.from_numpy(start),
                                    torch.from_numpy(d), segment=8,
                                    active=torch.from_numpy(active))
    assert np.array_equal(np.asarray(sj).view(np.uint32),
                          st.numpy().view(np.uint32)), "state bitwise"
    err = np.abs(pt.numpy() - np.asarray(pj)).max(-1)
    assert (err <= 1e-3).mean() >= 0.99, "collision points within 1e-3"
    assert (et.numpy() == np.asarray(ej)).mean() >= 0.99, "exit flags"
    assert (active & ~np.asarray(ej)).mean() > 0.05, "some lanes collide"
    assert np.array_equal(pt.numpy()[~active], start[~active]), \
        "inactive lanes (zero segment) stay at their origin"


def test_segment_schedules():
    """Single segment length below COMPACT_MIN_LANES, the staged plans
    above it (ratio 8-event segments to event 16, then 16)."""
    single = list(ttr._segments(100, 8, ttr.RATIO_PLAN, 128))
    assert single == [(8, i) for i in range(0, 128, 8)]
    staged = list(ttr._segments(ttr.COMPACT_MIN_LANES, 8, ttr.RATIO_PLAN,
                                128))
    assert staged == [(8, 0), (8, 8)] + [(16, i) for i in range(16, 128, 16)]
    delta = list(ttr._segments(10 ** 6, 8, ttr.DELTA_PLAN, 128))
    assert delta == [(16, i) for i in range(0, 128, 16)]
    assert list(ttr._segments(10 ** 6, 8, ttr.DELTA_PLAN, 40)) == \
        [(16, 0), (16, 16), (16, 32)]
