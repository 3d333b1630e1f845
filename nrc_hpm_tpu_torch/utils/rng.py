"""Per-ray PRNG matching the reference's shader RNG, bit for bit.

Port of ``nrc_hpm_tpu/utils/rng.py``: Bob Jenkins' one-at-a-time hash on
the IEEE-754 bits of a per-lane float state.  PyTorch on the CPU has no
``<<``, ``>>``, ``+`` or ``%`` for ``torch.uint32``, so every uint32 value
here is an int64 tensor holding [0, 2^32), masked after each op that can
carry past bit 31.

The draws of the frame path (``uniform``, ``masked_uniform``,
``advance_dead``, ``indexed_draws``, ``init_state``) each take their plain
version (``<name>_plain``, the int64 ops above) for CPU tensors and launch
one kernel of ``csrc/rng_kernels.cu`` for CUDA tensors, which computes the
same bits in native uint32; that file's header says why the kernels were
added and what bounds them.  Other devices raise.  ``<wrapper>.launches``
counts kernel launches; a call with no lanes launches nothing.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import profiler
from ..ops import _build

M32 = 0xFFFFFFFF
_MANTISSA = 0x007FFFFF
_ONE = 0x3F800000
_LIB = "rng_kernels"
_FLAGS = ("-fmad=false",)   # no fast-math contraction: the plain rounding
_P, _F, _LL, _I, _U = (ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_uint)
_ARGTYPES = {
    "rng_uniform_launch": [_P, _F, _LL, _P, _P, _P],
    "rng_masked_uniform_launch": [_P, _P, _F, _LL, _P, _P, _P],
    "rng_advance_dead_launch": [_P, _P, _I, _LL, _P, _P],
    "rng_indexed_draws_launch": [_P, _U, _U, _I, _I, _I, _P, _P],
    "rng_init_state_launch": [_P, _P, _LL, _P, _P],
}


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


# --- the draws of the frame path: plain versions ----------------------------

def init_state_plain(frag_uv: torch.Tensor, fr: torch.Tensor
                     ) -> torch.Tensor:
    """InitRandom with ``fr`` the (4,) float32 frame seed on frag_uv's
    device."""
    r2 = random2(frag_uv[..., 0], frag_uv[..., 1])
    r4 = random4(fr[0], fr[1], fr[2], fr[3])
    return random2(r2, r4.expand(r2.shape))


def uniform_plain(state: torch.Tensor, maxval=1.0):
    new_state = random1(state)
    return new_state * maxval, new_state


def masked_uniform_plain(state: torch.Tensor, active: torch.Tensor,
                         maxval=1.0):
    sample, new_state = uniform_plain(state, maxval)
    return sample, torch.where(active, new_state, state)


def advance_dead_plain(state: torch.Tensor, alive: torch.Tensor,
                       steps: int) -> torch.Tensor:
    for _ in range(steps):
        state = torch.where(alive, state, uniform_plain(state)[1])
    return state


def indexed_draws_plain(seed: torch.Tensor, k0: int, n: int, salt: int,
                        lead: bool = False) -> torch.Tensor:
    ks = torch.arange(n, dtype=torch.int64, device=seed.device) + k0
    hk = hash_u32(ks + salt)
    s64 = seed.to(torch.int64) & M32
    u = float_construct(hash_u32(s64[..., None] ^ hk))
    return torch.movedim(u, -1, 0) if lead else u


# --- the draws of the frame path: wrappers -----------------------------------

@functools.cache
def _kernel(name: str):
    """The launch function ``name`` of csrc/rng_kernels.cu, its argument
    types set once (the library is built at the first call)."""
    fn = getattr(_build.load(_LIB, _FLAGS), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(wrapper, name: str, device, *args) -> None:
    """One launch of ``name`` on the current stream of ``device``."""
    rc = _kernel(name)(*args, _build.stream_ptr(device))
    if rc:
        _build.check(_build.load(_LIB, _FLAGS), _LIB, rc)
    wrapper.launches += 1


def _state(name: str, state: torch.Tensor, mask=None):
    """The float32 state (and a bool mask of its shape on its device),
    contiguous."""
    _build.require(name, state.dtype == torch.float32,
                   f"state must be float32, not {state.dtype}")
    if mask is not None:
        _build.require(name, mask.dtype == torch.bool
                       and mask.shape == state.shape
                       and mask.device == state.device,
                       "the mask must be bool, of the state's shape and on "
                       "its device")
        mask = mask.contiguous()
    return state.contiguous(), mask


@profiler.region("rng")
def init_state(frag_uv: torch.Tensor, frame_random: torch.Tensor
               ) -> torch.Tensor:
    """InitRandom: (..., 2) pixel UVs and a (4,) frame seed -> (...,)
    float32 per-lane state."""
    with profiler.sync("rng.init_state"):   # the seed's copy to the card
        fr = frame_random.to(device=frag_uv.device, dtype=torch.float32)
    if not _build.on_card("init_state", frag_uv.device):
        return init_state_plain(frag_uv, fr)
    _build.require("init_state", frag_uv.dtype == torch.float32
                   and frag_uv.shape[-1:] == (2,) and fr.shape == (4,),
                   "frag_uv must be (..., 2) float32, frame_random (4,)")
    frag_uv, fr = frag_uv.contiguous(), fr.contiguous()
    out = torch.empty(frag_uv.shape[:-1], dtype=torch.float32,
                      device=frag_uv.device)
    if out.numel():
        _launch(init_state, "rng_init_state_launch", out.device,
                frag_uv.data_ptr(), fr.data_ptr(), out.numel(),
                out.data_ptr())
    return out


init_state.launches = 0


@profiler.region("rng")
def uniform(state: torch.Tensor, maxval=1.0):
    """RandFloat: returns (sample, new_state)."""
    if not _build.on_card("uniform", state.device):
        return uniform_plain(state, maxval)
    state, _ = _state("uniform", state)
    sample, new_state = torch.empty_like(state), torch.empty_like(state)
    if state.numel():
        _launch(uniform, "rng_uniform_launch", state.device,
                state.data_ptr(), float(maxval), state.numel(),
                sample.data_ptr(), new_state.data_ptr())
    return sample, new_state


uniform.launches = 0


@profiler.region("rng")
def masked_uniform(state: torch.Tensor, active: torch.Tensor, maxval=1.0):
    """Draw only on ``active`` lanes; inactive lanes keep their state (the
    sample is drawn on every lane)."""
    if not _build.on_card("masked_uniform", state.device):
        return masked_uniform_plain(state, active, maxval)
    state, active = _state("masked_uniform", state, active)
    sample, new_state = torch.empty_like(state), torch.empty_like(state)
    if state.numel():
        _launch(masked_uniform, "rng_masked_uniform_launch", state.device,
                state.data_ptr(), active.data_ptr(), float(maxval),
                state.numel(), sample.data_ptr(), new_state.data_ptr())
    return sample, new_state


masked_uniform.launches = 0


def advance_dead(state: torch.Tensor, alive: torch.Tensor, steps: int
                 ) -> torch.Tensor:
    """Advance the chain of the lanes that are not ``alive`` by ``steps``
    draws; alive lanes keep their state."""
    if not _build.on_card("advance_dead", state.device):
        return advance_dead_plain(state, alive, steps)
    state, alive = _state("advance_dead", state, alive)
    if steps == 0 or state.numel() == 0:
        return state
    out = torch.empty_like(state)
    _launch(advance_dead, "rng_advance_dead_launch", state.device,
            state.data_ptr(), alive.data_ptr(), steps, state.numel(),
            out.data_ptr())
    return out


advance_dead.launches = 0


def indexed_draws(seed: torch.Tensor, k0: int, n: int, salt: int,
                  lead: bool = False) -> torch.Tensor:
    """u_k = floatConstruct(hash(seed ^ hash(salt + k))), k in [k0, k0+n);
    seed (...,) int32 bits -> (..., n) float32, or (n, ...) with ``lead``
    (contiguous on the card)."""
    if not _build.on_card("indexed_draws", seed.device):
        return indexed_draws_plain(seed, k0, n, salt, lead)
    _build.require("indexed_draws", seed.dtype == torch.int32
                   and seed.numel() * n < 2 ** 31,
                   "seed must be int32 and lanes x n below 2^31")
    seed = seed.contiguous()
    shape = (n, *seed.shape) if lead else (*seed.shape, n)
    out = torch.empty(shape, dtype=torch.float32, device=seed.device)
    if out.numel():
        _launch(indexed_draws, "rng_indexed_draws_launch", seed.device,
                seed.data_ptr(), k0 & M32, salt & M32, seed.numel(), n,
                int(lead), out.data_ptr())
    return out


indexed_draws.launches = 0


@profiler.region("rng")
def frame_random(key: torch.Tensor) -> torch.Tensor:
    """Per-frame (4,) seed vector in [0, 1): ``jax.random.uniform`` of a
    threefry key (``utils/prng.py``)."""
    from .prng import uniform   # prng imports this module
    return uniform(key, (4,))
