"""Per-ray PRNG matching the reference's shader RNG, bit for bit.

Port of ``nrc_hpm_tpu/utils/rng.py``: Bob Jenkins' one-at-a-time hash on
the IEEE-754 bits of a per-lane float state.  PyTorch on the CPU has no
``<<``, ``>>``, ``+`` or ``%`` for ``torch.uint32``, so every uint32 value
here is an int64 tensor holding [0, 2^32), masked after each op that can
carry past bit 31.
"""

from __future__ import annotations

import torch

from .. import profiler

M32 = 0xFFFFFFFF
_MANTISSA = 0x007FFFFF
_ONE = 0x3F800000


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """One round of Jenkins one-at-a-time on int64-held uint32 values (a
    Python int works too)."""
    x = x & M32
    x = (x + (x << 10)) & M32
    x = x ^ (x >> 6)
    x = (x + (x << 3)) & M32
    x = x ^ (x >> 11)
    x = (x + (x << 15)) & M32
    return x


def f32_bits(f: torch.Tensor) -> torch.Tensor:
    """float32 -> its bit pattern as int64 in [0, 2^32)."""
    return f.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & M32


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64-held uint32 -> int32 with the same bit pattern."""
    return (((x & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def u32_to_f32(x: torch.Tensor) -> torch.Tensor:
    """int64-held uint32 bit pattern -> float32."""
    return u32_to_i32(x).view(torch.float32)


def float_construct(m: torch.Tensor) -> torch.Tensor:
    """uint32 -> float in [0, 1) via the mantissa bits."""
    f = ((m & _MANTISSA) | _ONE).to(torch.int32).view(torch.float32)
    return f - 1.0


def random1(x: torch.Tensor) -> torch.Tensor:
    return float_construct(hash_u32(f32_bits(x)))


def random2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return float_construct(hash_u32(f32_bits(x) ^ hash_u32(f32_bits(y))))


def random4(x, y, z, w) -> torch.Tensor:
    return float_construct(hash_u32(
        f32_bits(x) ^ hash_u32(f32_bits(y)) ^ hash_u32(f32_bits(z))
        ^ hash_u32(f32_bits(w))))


@profiler.region("rng")
def init_state(frag_uv: torch.Tensor, frame_random: torch.Tensor
               ) -> torch.Tensor:
    """InitRandom: (..., 2) pixel UVs and a (4,) frame seed -> (...,)
    float32 per-lane state."""
    r2 = random2(frag_uv[..., 0], frag_uv[..., 1])
    with profiler.sync("rng.init_state"):   # the seed's copy to the card
        fr = frame_random.to(device=frag_uv.device, dtype=torch.float32)
    r4 = random4(fr[0], fr[1], fr[2], fr[3])
    return random2(r2, r4.expand(r2.shape))


@profiler.region("rng")
def uniform(state: torch.Tensor, maxval=1.0):
    """RandFloat: returns (sample, new_state)."""
    new_state = random1(state)
    return new_state * maxval, new_state


@profiler.region("rng")
def masked_uniform(state: torch.Tensor, active: torch.Tensor, maxval=1.0):
    """Draw only on ``active`` lanes; inactive lanes keep their state."""
    sample, new_state = uniform(state, maxval)
    return sample, torch.where(active, new_state, state)


@profiler.region("rng")
def frame_random(key: torch.Tensor) -> torch.Tensor:
    """Per-frame (4,) seed vector in [0, 1): ``jax.random.uniform`` of a
    threefry key (``utils/prng.py``)."""
    from .prng import uniform   # prng imports this module
    return uniform(key, (4,))
