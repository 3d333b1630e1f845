"""ReSTIR's temporal and spatial reuse on the card: the kernels
``temporal_reuse_kernel`` and ``spatial_reuse_kernel`` of
``csrc/restir_reuse.cu``, one thread a pixel, one launch a stage.

They replace no Pallas kernel (the JAX package leaves the reuse to XLA);
that file's header says why they were added, what bounds them and why
they equal ``models/restir.py``'s plain stages bit for bit.  The stage
functions there (``_temporal_reuse``, ``_spatial_reuse``) launch them for
CUDA tensors and run their plain versions for CPU tensors.  Both wrappers
write into fresh tensors and never into their inputs: the temporal one
returns a new ring.  ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..sampling import hg_constants
from . import _build

MAX_VERTICES = 16   # the kernels' register arrays
_LIB = "restir_reuse"
# nvcc's defaults: the kernels round every float operation explicitly, and
# powf compiles as in PyTorch's pow kernel (csrc/restir_reuse.cu's header)
_FLAGS = ()
_P, _F, _LL, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong, \
    ctypes.c_int
_ARGTYPES = {
    "restir_temporal_reuse_launch": [_P] * 6 + [_LL, _I, _I, _I, _I]
    + [_F] * 3 + [_P] * 6,
    "restir_spatial_reuse_launch": [_P] * 5 + [_I] * 5 + [_F] * 3
    + [_P] * 5,
}


@functools.cache
def _kernel(name: str):
    """The launch function ``name`` of csrc/restir_reuse.cu, its argument
    types set once (the library is built at the first call)."""
    fn = getattr(_build.load(_LIB, _FLAGS), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(wrapper, name: str, device, *args) -> None:
    rc = _kernel(name)(*args, _build.stream_ptr(device))
    if rc:
        _build.check(_build.load(_LIB, _FLAGS), _LIB, rc)
    wrapper.launches += 1


def _check(name: str, reservoir, seeds, stats, mis, pixel_info) -> None:
    """The stages' shared contract: an (H, W, V, 6) float32 reservoir with
    1 <= V <= MAX_VERTICES and the (H, W) seeds, (H, W, 2) stats and
    accumulators and (H, W, 4) pixel info beside it, on its device."""
    _build.require(name, reservoir.ndim == 4 and reservoir.shape[-1] == 6
                   and 1 <= reservoir.shape[2] <= MAX_VERTICES,
                   f"the reservoir must be (H, W, V, 6) with 1 <= V <= "
                   f"{MAX_VERTICES}, not {tuple(reservoir.shape)}")
    hw = tuple(reservoir.shape[:2])
    _build.require(name, 0 < hw[0] * hw[1] < 2 ** 31,
                   f"{hw[0]} x {hw[1]} lanes")
    for key, t, shape in (("reservoir", reservoir, reservoir.shape),
                          ("seeds", seeds, hw), ("stats", stats, hw + (2,)),
                          ("mis", mis, hw + (2,)),
                          ("pixel_info", pixel_info, hw + (4,))):
        _build.require(name, t.dtype == torch.float32
                       and tuple(t.shape) == tuple(shape)
                       and t.device == reservoir.device,
                       f"{key} must be {tuple(shape)} float32 on "
                       f"{reservoir.device}, not {tuple(t.shape)} "
                       f"{t.dtype} on {t.device}")


def _empty(*tensors):
    return [torch.empty_like(t, memory_format=torch.contiguous_format)
            for t in tensors]


def temporal_reuse(seeds, reservoir, old_reservoirs, stats, mis, pixel_info,
                   frame: int, temporal_kernel: int, g: float,
                   weighted: bool):
    """``_temporal_reuse`` on CUDA tensors in one launch: returns the new
    (reservoir, old_reservoirs, stats, mis, seeds)."""
    name = "temporal_reuse"
    _check(name, reservoir, seeds, stats, mis, pixel_info)
    T = temporal_kernel
    _build.require(name, T >= 1 and frame >= 0
                   and tuple(old_reservoirs.shape) == (T,) + tuple(
                       reservoir.shape)
                   and old_reservoirs.dtype == torch.float32
                   and old_reservoirs.device == reservoir.device,
                   f"the ring must be (T, H, W, V, 6) float32 with T = {T} "
                   f">= 1 on the reservoir's device, and frame {frame} >= 0")
    ins = [t.contiguous() for t in (seeds, reservoir, old_reservoirs, stats,
                                    mis, pixel_info)]
    outs = _empty(*ins[1:5], ins[0])
    h, w, v = reservoir.shape[:3]
    _launch(temporal_reuse, "restir_temporal_reuse_launch", reservoir.device,
            *(t.data_ptr() for t in ins), frame, T, v, h * w, int(weighted),
            *hg_constants(g), *(t.data_ptr() for t in outs))
    return tuple(outs)


temporal_reuse.launches = 0


def spatial_reuse(seeds, reservoir, stats, mis, pixel_info,
                  spatial_kernel: int, g: float, weighted: bool):
    """``_spatial_reuse`` on CUDA tensors in one launch: returns the new
    (reservoir, stats, mis, seeds)."""
    name = "spatial_reuse"
    _check(name, reservoir, seeds, stats, mis, pixel_info)
    _build.require(name, spatial_kernel >= 1 and reservoir.shape[0]
                   <= 65535 * 8, f"spatial kernel {spatial_kernel} >= 1 "
                   f"and at most 524,280 rows")
    ins = [t.contiguous() for t in (seeds, reservoir, stats, mis,
                                    pixel_info)]
    outs = _empty(*ins[1:4], ins[0])
    h, w, v = reservoir.shape[:3]
    _launch(spatial_reuse, "restir_spatial_reuse_launch", reservoir.device,
            *(t.data_ptr() for t in ins), h, w, v, spatial_kernel // 2,
            int(weighted), *hg_constants(g), *(t.data_ptr() for t in outs))
    return tuple(outs)


spatial_reuse.launches = 0
