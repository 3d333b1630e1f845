"""The port's self-training ring buffer against the JAX package's: pop,
push and wrap on the same masks and records, including pushes and pops
that run past the end of the buffer.  Every comparison is bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import ring_buffer as jrb
from nrc_hpm_tpu_torch import ring_buffer as trb
from nrc_hpm_tpu_torch.weights import ring_from_jax

CAP = 40


def _same(tring, jring):
    assert np.array_equal(tring.data.numpy(), np.asarray(jring.data))
    assert tring.head.dtype == tring.tail.dtype == torch.int32
    assert int(tring.head) == int(jring.head)
    assert int(tring.tail) == int(jring.tail)


def test_create_matches():
    _same(trb.RingBuffer.create(CAP, device="cpu"), jrb.RingBuffer.create(CAP))
    assert trb.RingBuffer.create(0, device="cpu").capacity == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frames_of_pop_push_wrap_match(seed):
    """Six frames of wrap, pop on ~scat, push on scat, with 32 lanes a
    frame into 40 slots: the cursors pass the capacity and wrap."""
    rs = np.random.RandomState(seed)
    jring = jrb.RingBuffer.create(CAP)
    tring = trb.RingBuffer.create(CAP, device="cpu")
    most = 0
    for _ in range(6):
        jring, tring = jrb.ring_wrap(jring), trb.ring_wrap(tring)
        _same(tring, jring)
        scat = rs.rand(32) < rs.uniform(0.2, 0.8)
        rec = rs.normal(size=(32, 6)).astype(np.float32)
        jpop, jring = jrb.ring_pop(jring, jnp.asarray(~scat))
        tpop, tring = trb.ring_pop(tring, torch.from_numpy(~scat))
        assert np.array_equal(tpop.numpy(), np.asarray(jpop))
        jring = jrb.ring_push(jring, jnp.asarray(scat), jnp.asarray(rec))
        tring = trb.ring_push(tring, torch.from_numpy(scat),
                              torch.from_numpy(rec))
        _same(tring, jring)
        most = max(most, int(tring.head), int(tring.tail))
    assert most > CAP, "some frame ran a cursor past the capacity"


def test_wraparound_slots():
    """A push that starts 3 slots before the end writes the last 3 slots
    and then slots 0.., and the tail wraps the same way."""
    jring = jrb.RingBuffer.create(CAP).replace(head=jnp.int32(CAP - 3),
                                               tail=jnp.int32(CAP - 2))
    tring = ring_from_jax(jring, device="cpu")
    rec = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    jring = jrb.ring_push(jring, jnp.asarray(mask), jnp.asarray(rec))
    tring = trb.ring_push(tring, torch.from_numpy(mask), torch.from_numpy(rec))
    _same(tring, jring)
    assert int(tring.head) == CAP + 3
    assert np.array_equal(tring.data[CAP - 3:].numpy(), rec[[0, 1, 3]])
    assert np.array_equal(tring.data[:3].numpy(), rec[[4, 5, 7]])
    jpop, jring = jrb.ring_pop(jring, jnp.asarray(mask))
    tpop, tring = trb.ring_pop(tring, torch.from_numpy(mask))
    assert np.array_equal(tpop.numpy(), np.asarray(jpop))
    _same(tring, jring)
    _same(trb.ring_wrap(tring), jrb.ring_wrap(jring))
    assert int(trb.ring_wrap(tring).head) == 3
