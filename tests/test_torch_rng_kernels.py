"""The draws of the frame path (``utils/rng.py``) and their kernels'
host side, on the CPU.

A numpy model of ``csrc/rng_kernels.cu`` in native uint32 is the oracle:
the wrappers on CPU tensors (their plain int64 versions) must give its
bits and launch nothing; with the card's branch taken on CPU memory and
the launch functions replaced by the same model, the wrappers must pass
their arguments so that the outputs equal the plain versions bit for bit,
in both layouts and for seeds of any lead shape, and a call with no
lanes launches nothing.  The kernels themselves run only on the card
(``chip_smoke.py``'s draw section)."""

import ctypes

import numpy as np
import pytest
import torch

from nrc_hpm_tpu_torch import integrator
from nrc_hpm_tpu_torch import transmittance as ttr
from nrc_hpm_tpu_torch.ops import _build
from nrc_hpm_tpu_torch.ops import pw_kernels as pk
from nrc_hpm_tpu_torch.utils import rng

WRAPPERS = (rng.init_state, rng.uniform, rng.masked_uniform,
            rng.advance_dead, rng.indexed_draws)
# every salt the trackers draw with
SALTS = (pk.SALT_RATIO, pk.SALT_DELTA, pk.SALT_CTRL, ttr.SALT_RR,
         ttr.SALT_RR0, ttr.SALT_ACCEPT, ttr.SALT_FALLBACK)


# --- the numpy model of the kernels: uint32 arithmetic ---------------------

def _hash(x):
    x = np.array(x, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x = x + (x << np.uint32(10))
        x = x ^ (x >> np.uint32(6))
        x = x + (x << np.uint32(3))
        x = x ^ (x >> np.uint32(11))
        return x + (x << np.uint32(15))


def _float(m):
    bits = (np.asarray(m, np.uint32) & np.uint32(0x7FFFFF)) \
        | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def _random1(x):
    return _float(_hash(np.asarray(x, np.float32).view(np.uint32)))


def _random2(x, y):
    xb = np.asarray(x, np.float32).view(np.uint32)
    yb = np.asarray(y, np.float32).view(np.uint32)
    return _float(_hash(xb ^ _hash(yb)))


def np_uniform(state, maxval):
    s = _random1(state)
    return s * np.float32(maxval), s


def np_masked_uniform(state, active, maxval):
    sample, s = np_uniform(state, maxval)
    return sample, np.where(active, s, state)


def np_advance_dead(state, alive, steps):
    s = np.array(state, np.float32)
    for _ in range(steps):
        s = np.where(alive, s, _random1(s))
    return s


def np_indexed_draws(seed, k0, n, salt, lead):
    k = (np.arange(n, dtype=np.uint64) + k0 + salt) % 2 ** 32
    hk = _hash(k.astype(np.uint32))
    u = _float(_hash(np.asarray(seed).view(np.uint32)[..., None] ^ hk))
    return np.moveaxis(u, -1, 0) if lead else u


def np_init_state(frag_uv, fr):
    fb = np.asarray(fr, np.float32).view(np.uint32)
    r4 = _float(_hash(fb[0] ^ _hash(fb[1]) ^ _hash(fb[2]) ^ _hash(fb[3])))
    return _random2(_random2(frag_uv[..., 0], frag_uv[..., 1]), r4)


class ModelKernels:
    """The launch functions of csrc/rng_kernels.cu, run by the numpy model
    on the CPU memory the wrappers pass (pointers as ints)."""

    @staticmethod
    def _at(ptr, n, ctype=ctypes.c_float):
        return np.ctypeslib.as_array((ctype * n).from_address(ptr))

    def rng_uniform_launch(self, state, maxval, n, sample, new_state,
                           stream):
        out = np_uniform(self._at(state, n), maxval)
        self._at(sample, n)[:], self._at(new_state, n)[:] = out
        return 0

    def rng_masked_uniform_launch(self, state, active, maxval, n, sample,
                                  new_state, stream):
        out = np_masked_uniform(self._at(state, n),
                                self._at(active, n, ctypes.c_bool), maxval)
        self._at(sample, n)[:], self._at(new_state, n)[:] = out
        return 0

    def rng_advance_dead_launch(self, state, alive, steps, n, out, stream):
        self._at(out, n)[:] = np_advance_dead(
            self._at(state, n), self._at(alive, n, ctypes.c_bool), steps)
        return 0

    def rng_indexed_draws_launch(self, seed, k0, salt, lanes, n, lead, out,
                                 stream):
        assert 0 <= k0 < 2 ** 32 and 0 <= salt < 2 ** 32
        u = np_indexed_draws(self._at(seed, lanes, ctypes.c_uint32), k0, n,
                             salt, bool(lead))
        self._at(out, lanes * n)[:] = u.reshape(-1)
        return 0

    def rng_init_state_launch(self, frag_uv, frame_random, n, out, stream):
        uv = self._at(frag_uv, 2 * n).reshape(n, 2)
        self._at(out, n)[:] = np_init_state(uv, self._at(frame_random, 4))
        return 0


@pytest.fixture
def card(monkeypatch):
    """The wrappers' card branch on CPU tensors, launching the model."""
    model = ModelKernels()
    monkeypatch.setattr(_build, "on_card", lambda name, device: True)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: None)
    monkeypatch.setattr(rng, "_kernel", lambda name: getattr(model, name))
    yield
    for w in WRAPPERS:
        w.launches = 0


@pytest.fixture
def no_library(monkeypatch):
    """The card's branch with no library: asking for a launch fails."""
    def fail(name):
        raise AssertionError(f"{name} was asked for")
    monkeypatch.setattr(_build, "on_card", lambda name, device: True)
    monkeypatch.setattr(rng, "_kernel", fail)


def _states(n, seed):
    """0.0, the largest float below 1 (0.99999994), then random bit
    patterns (any float the chain can hold, NaNs and infinities too)."""
    bits = np.random.RandomState(seed).randint(0, 2 ** 32, n, np.uint64)
    s = bits.astype(np.uint32).view(np.float32).copy()
    s[:2] = np.array([0.0, np.nextafter(np.float32(1), np.float32(0))],
                     np.float32)[:n]
    return s


def _masks(n, seed):
    mixed = np.random.RandomState(seed).rand(n) < 0.5
    return {"all": np.ones(n, bool), "none": np.zeros(n, bool),
            "mixed": mixed}


def _bits(t):
    return np.asarray(t, np.float32).view(np.uint32)


def _same(got, want):
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def _cases():
    """(name, wrapper call on torch tensors, the model's outputs)."""
    out = []
    for n in (1, 172, 4099):
        s = _states(n, n)
        for key, m in _masks(n, n + 1).items():
            out.append((f"masked_uniform-{n}-{key}",
                        lambda s=s, m=m: rng.masked_uniform(
                            torch.from_numpy(s), torch.from_numpy(m), 3.0),
                        np_masked_uniform(s, m, 3.0)))
            for steps in (1, 2, 3):
                out.append((f"advance_dead-{n}-{key}-{steps}",
                            lambda s=s, m=m, k=steps: (rng.advance_dead(
                                torch.from_numpy(s), torch.from_numpy(m),
                                k),),
                            (np_advance_dead(s, m, steps),)))
        for maxval in (1.0, 2.5):
            out.append((f"uniform-{n}-{maxval}",
                        lambda s=s, v=maxval: rng.uniform(
                            torch.from_numpy(s), v),
                        np_uniform(s, maxval)))
    rs = np.random.RandomState(7)
    uv = rs.rand(9, 13, 2).astype(np.float32)
    fr = np.array([0.125, 0.6180339, 0.91, 0.0031], np.float32)
    out.append(("init_state-9x13",
                lambda: (rng.init_state(torch.from_numpy(uv),
                                        torch.from_numpy(fr)),),
                (np_init_state(uv, fr),)))
    return out


CASES = _cases()


def _seeds(shape, seed):
    bits = np.random.RandomState(seed).randint(0, 2 ** 32, shape, np.uint64)
    return np.asarray(bits, np.uint64).astype(np.uint32).view(np.int32)


# (lead shape of the seed, events, k0): k0 + k + salt wraps past 2^32 at
# k0 = 2^31 - 1 with the larger salts
DRAWS = [((172,), 8, 0), ((1,), 1, 112), ((3, 5, 7), 16, 2 ** 31 - 1),
         ((), 8, 112), ((65,), 16, 2 ** 31 - 1)]


@pytest.mark.parametrize("name,call,want", CASES,
                         ids=[c[0] for c in CASES])
def test_cpu_draws_are_the_model_and_launch_nothing(name, call, want):
    for got, w in zip(call(), want):
        _same(got, w)
    assert [w.launches for w in WRAPPERS] == [0] * 5


@pytest.mark.parametrize("lead", [False, True])
@pytest.mark.parametrize("shape,n,k0", DRAWS)
def test_cpu_indexed_draws_are_the_model(shape, n, k0, lead):
    seed = _seeds(shape, n)
    for salt in SALTS:
        _same(rng.indexed_draws(torch.from_numpy(seed), k0, n, salt, lead),
              np_indexed_draws(seed, k0, n, salt, lead))
    draws = ttr._indexed_draws_lead if lead else ttr._indexed_draws
    _same(draws(torch.from_numpy(seed), k0, n, SALTS[0]),
          np_indexed_draws(seed, k0, n, SALTS[0], lead))
    assert rng.indexed_draws.launches == 0


@pytest.mark.parametrize("name,call,want", CASES,
                         ids=[c[0] for c in CASES])
def test_card_branch_passes_its_arguments(card, name, call, want):
    """The card's branch with the model in the kernels' place: the
    outputs are the plain versions', bit for bit, from one launch."""
    got = call()
    for g, w in zip(got, want):
        assert g.is_contiguous()
        _same(g, w)
    assert sum(w.launches for w in WRAPPERS) == 1


@pytest.mark.parametrize("lead", [False, True])
@pytest.mark.parametrize("shape,n,k0", DRAWS)
def test_card_branch_indexed_draws(card, shape, n, k0, lead):
    seed = torch.from_numpy(_seeds(shape, n + 1))
    for salt in SALTS:
        got = rng.indexed_draws(seed, k0, n, salt, lead)
        assert got.is_contiguous()
        _same(got, rng.indexed_draws_plain(seed, k0, n, salt, lead).numpy())
    assert rng.indexed_draws.launches == len(SALTS)


def test_card_branch_serves_the_trackers_and_the_bounce_loop(card):
    """``_track_seed``, ``_indexed_draws(_lead)`` and ``_advance_dead``
    reach the wrappers: one launch each."""
    s = _states(300, 3)
    alive = torch.from_numpy(_masks(300, 4)["mixed"])
    seed, state = ttr._track_seed(torch.from_numpy(s))
    assert np.array_equal(seed.numpy().view(np.uint32), _bits(s))
    _same(state, _random1(s))
    _same(ttr._indexed_draws_lead(seed, 5, 8, ttr.SALT_ACCEPT),
          np_indexed_draws(seed.numpy(), 5, 8, ttr.SALT_ACCEPT, True))
    _same(integrator._advance_dead(state, alive, 2),
          np_advance_dead(state.numpy(), alive.numpy(), 2))
    assert [w.launches for w in WRAPPERS] == [0, 1, 0, 1, 1]


def test_no_lanes_launch_nothing(no_library):
    """Empty inputs give empty outputs of the plain versions' shapes; no
    launch, no library (and no step to take: the state as it was)."""
    s = torch.zeros(0)
    m = torch.zeros(0, dtype=torch.bool)
    assert [tuple(t.shape) for t in rng.uniform(s)] == [(0,), (0,)]
    assert [tuple(t.shape) for t in rng.masked_uniform(s, m)] == [(0,), (0,)]
    assert tuple(rng.advance_dead(s, m, 2).shape) == (0,)
    full = torch.rand(8)
    assert rng.advance_dead(full, full > 0.5, 0) is full
    for lead, shape in ((False, (0, 3, 8)), (True, (8, 0, 3))):
        out = rng.indexed_draws(torch.zeros((0, 3), dtype=torch.int32), 0, 8,
                                SALTS[0], lead)
        assert tuple(out.shape) == shape and out.dtype == torch.float32
    assert tuple(rng.indexed_draws(torch.zeros(5, dtype=torch.int32), 0, 0,
                                   SALTS[0]).shape) == (5, 0)
    out = rng.init_state(torch.zeros((0, 2)), torch.rand(4))
    assert tuple(out.shape) == (0,)
    assert [w.launches for w in WRAPPERS] == [0] * 5


@pytest.mark.parametrize("case", ["state-f64", "mask-shape", "mask-dtype",
                                  "seed-i64", "uv-shape", "uv-f64"])
def test_card_branch_rejects_bad_inputs(no_library, case):
    s, m = torch.rand(8), torch.rand(8) > 0.5
    call = {
        "state-f64": lambda: rng.uniform(s.double()),
        "mask-shape": lambda: rng.masked_uniform(s, m[:4]),
        "mask-dtype": lambda: rng.advance_dead(s, m.to(torch.uint8), 1),
        "seed-i64": lambda: rng.indexed_draws(torch.zeros(4,
                                                          dtype=torch.int64),
                                              0, 8, SALTS[0]),
        "uv-shape": lambda: rng.init_state(torch.rand(4, 3), torch.rand(4)),
        "uv-f64": lambda: rng.init_state(torch.rand(4, 2).double(),
                                         torch.rand(4)),
    }[case]
    with pytest.raises(ValueError):
        call()


def test_other_devices_raise():
    s = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rng.uniform(s)
    with pytest.raises(ValueError, match="unsupported device"):
        rng.indexed_draws(torch.zeros(4, dtype=torch.int32, device="meta"),
                          0, 8, SALTS[0])


def test_chip_smoke_draw_cases_rehearsed(card, monkeypatch):
    """chip_smoke.py's draw cases with the model in the kernels' place:
    every case runs, and the wrapper's outputs equal the plain version's
    int32 views, as the card's check compares them."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DRAW_LANES", (1, 172))
    cases = 0
    for label, fn, plain in chip_smoke.draw_cases(
            torch, torch.device("cpu"), torch.Generator().manual_seed(18)):
        for g, w in zip(fn(), plain()):
            assert g.shape == w.shape and torch.equal(
                g.contiguous().view(torch.int32),
                w.contiguous().view(torch.int32)), label
        cases += 1
    assert cases == 2 * (2 + 3 * 4 + 3 * 2 * 3 * 7 + 1)
    assert sum(w.launches for w in WRAPPERS) == cases
