"""JAX's default PRNG (threefry2x32, partitionable), bit for bit.

Port of the parts of ``jax.random`` the reference's seeded streams use,
as JAX 0.9.0 computes them with ``jax_threefry_partitionable=True`` and
64-bit types off: ``PRNGKey`` (``threefry_seed``), ``split``
(``_threefry_split_foldlike``), 32-bit random bits
(``_threefry_random_bits_partitionable``) and float32 ``uniform``
(``jax._src.random._uniform``).  A key is a (2,) int64 tensor holding two
uint32 words; like every uint32 value of the port it lives in int64,
masked to 32 bits after each op that can carry past bit 31 (PyTorch on
the CPU has no shifts or adds for ``torch.uint32``).  Keys stay on the
CPU; ``uniform`` draws on the device it is given, so a large table is
drawn where it is used.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .rng import M32, u32_to_f32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the seed's low 32 bits, after a zero
    high word (JAX without 64-bit types keeps only those)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & M32


def threefry_2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 block cipher, 20 rounds, on uint32 word pairs
    (x1, x2) under the key (k1, k2); returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & M32, (x2 + ks[1]) & M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & M32
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & M32
    return x[0], x[1]


def iota_2x32_shape(shape, device=None):
    """The flat index of every element of ``shape`` as (high, low) uint32
    words."""
    n = math.prod(shape)
    count = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return count >> 32, count & M32


def _bits(key: torch.Tensor, shape, device=None):
    k1, k2 = (int(k) for k in key.tolist())
    return threefry_2x32(k1, k2, *iota_2x32_shape(shape, device))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys."""
    b1, b2 = _bits(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` of 32 bits, as int64."""
    b1, b2 = _bits(key, tuple(shape), device)
    return b1 ^ b2


def fma_f32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """float32 a * b + c rounded once, as XLA's CPU compile contracts the
    multiply and the add.  The product of two float32 values is exact in
    float64; the sum is rounded to odd there (its exact error, from
    TwoSum, decides the last bit), which makes the final rounding to
    float32 the correct one."""
    s = a.double() * b
    r = s + c
    bb = r - s
    e = (s - (r - bb)) + (c - bb)
    even = (r.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, math.inf, -math.inf).to(r)
    r = torch.where((e != 0) & even, torch.nextafter(r, toward), r)
    return r.float()


def uniform(key: torch.Tensor, shape, minval=0.0, maxval=1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``:
    23 random mantissa bits under exponent 0 give a float in [1, 2); minus
    1, times (maxval - minval) plus minval in one rounding, held at or
    above ``minval``, all in float32."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(key, shape, device)
    floats = u32_to_f32((bits >> 9) | 0x3F800000) - 1.0
    out = fma_f32(floats, float(hi - lo), float(lo))
    return torch.clamp(out, min=float(lo))
