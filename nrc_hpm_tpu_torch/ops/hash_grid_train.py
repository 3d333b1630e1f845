"""Training hash-grid encode: kernel K7 and its table gradient.

Replaces the Pallas kernel ``nrc_hpm_tpu/models/nrc/encoding.py:
_sweep_kernel`` (wrapper ``_grouped_sweep``, the packed-table forward of
``hash_grid_encode_train``) and the matmul backward ``_level_grad_matmul``
with the CUDA kernels of ``csrc/hash_grid_train.cu``; that file's header
says what bounds them on the H100.  Both table formats run on the same
pair: ``packed=True`` reads the bf16-packed (P,) int32 words (the JAX
``hash_grid_encode_train``, grids of <= 2^16 entries per level) and rounds
each gradient term to bf16; ``packed=False`` reads the (P, 2) float32
table (the JAX ``hash_grid_encode``).

``hash_grid_train_fwd`` / ``hash_grid_train_bwd`` take the plain PyTorch
versions for CPU tensors (a gather and trilinear sum; ``index_add_``) and
launch the kernels for CUDA tensors; ``.launches`` counts kernel launches.
Both kernels take any number of levels: they read the level constants
from a small device array (``level_table``).  ``HashGridTrainEncode`` is
the autograd pair; x gets no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..models.nrc.encoding import (HashGridSpec, _corner_indices,
                                   hash_grid_encode_packed, pack_table_bf16)
from . import _build

_LIB = "hash_grid_train"
LEVEL_WORDS = 8   # int32 words of one hash_grid::Level record


def hash_grid_train_fwd_plain(table, x, spec: HashGridSpec, packed: bool
                              ) -> torch.Tensor:
    """(N, 3) positions -> (N, L*2) features, interleaved (level,
    feature), from the packed (P,) words or the (P, 2) float32 table."""
    if packed:
        return hash_grid_encode_packed(table, x, spec)
    idx, weight = _corner_indices(x, spec)                 # (N, L, 8)
    feats = (table[idx] * weight[..., None]).sum(2)        # (N, L, 2)
    return feats.reshape(x.shape[0], -1)


def hash_grid_train_bwd_plain(x, gout, spec: HashGridSpec, packed: bool
                              ) -> torch.Tensor:
    """(P, 2) float32 table gradient: dtable[idx] += w * g over every
    corner lookup, each term rounded to bf16 when ``packed``."""
    idx, weight = _corner_indices(x, spec)
    n, L = idx.shape[:2]
    v = weight[..., None] * gout.reshape(n, L, 1, 2)       # (N, L, 8, 2)
    if packed:
        v = v.to(torch.bfloat16).to(torch.float32)
    dtable = torch.zeros((spec.total_params, 2), dtype=torch.float32,
                         device=x.device)
    return dtable.index_add_(0, idx.reshape(-1), v.reshape(-1, 2))


def _lib():
    lib = _build.load(_LIB)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.hash_grid_train_fwd_launch.argtypes = [P, I, P, I, P, I, P, P]
    lib.hash_grid_train_fwd_launch.restype = I
    lib.hash_grid_train_bwd_launch.argtypes = [P, P, I, I, P, I,
                                               ctypes.c_longlong, P, P]
    lib.hash_grid_train_bwd_launch.restype = I
    return lib


def level_records(spec: HashGridSpec) -> np.ndarray:
    """(L, LEVEL_WORDS) int32: per level the hash_grid::Level record (scale
    as its float32 bits, resolution, dense flag, table rows, row offset,
    three unused words)."""
    rec = np.zeros((spec.n_levels, LEVEL_WORDS), np.int32)
    for lv in range(spec.n_levels):
        rec[lv, 0] = np.float32(spec.level_scale(lv)).view(np.int32)
        rec[lv, 1:5] = (spec.level_resolution(lv), spec.level_is_dense(lv),
                        spec.level_params(lv), spec.level_offsets[lv])
    return rec


@functools.cache
def level_table(spec: HashGridSpec, device: torch.device) -> torch.Tensor:
    """level_records on ``device``, made once per grid and device."""
    return torch.from_numpy(level_records(spec)).to(device)


def _check(name, x, spec: HashGridSpec, tensors: dict):
    _build.require_cuda(name, dict(x=x, **tensors), x.device)
    _build.require(name, x.dtype == torch.float32 and x.ndim == 2
                   and x.shape[1] == 3, "x must be (N, 3) float32")
    _build.require(name, spec.n_dims == 3 and spec.n_features == 2,
                   "3-D, 2-feature grid")


def hash_grid_train_fwd(table, x, spec: HashGridSpec, packed: bool
                        ) -> torch.Tensor:
    """x (N, 3) -> (N, L*2) float32 features.  ``table`` is the (P,)
    int32 pack_table_bf16 words when ``packed``, else (P, 2) float32."""
    name = "hash_grid_train_fwd"
    if not _build.on_card(name, x.device):
        return hash_grid_train_fwd_plain(table, x, spec, packed)
    _check(name, x, spec, dict(table=table))
    want = ((spec.total_params,), torch.int32) if packed \
        else ((spec.total_params, 2), torch.float32)
    _build.require(name, (tuple(table.shape), table.dtype) == want,
                   f"table must be {want[0]} {want[1]}")
    _build.require(name, table.data_ptr() % 16 == 0,
                   "table must be 16-byte aligned (its row pairs load as one)")
    n = x.shape[0]
    out = torch.empty((n, spec.out_dim), dtype=torch.float32,
                      device=x.device)
    if n == 0:
        return out
    lib = _lib()
    rc = lib.hash_grid_train_fwd_launch(
        _build.ptr(x), n, _build.ptr(table), int(packed),
        _build.ptr(level_table(spec, x.device)), spec.n_levels,
        _build.ptr(out), _build.stream_ptr(x.device))
    _build.check(lib, _LIB, rc)
    hash_grid_train_fwd.launches += 1
    return out


def hash_grid_train_bwd(x, gout, spec: HashGridSpec, packed: bool
                        ) -> torch.Tensor:
    """x (N, 3), gout (N, L*2) -> (P, 2) float32 table gradient."""
    name = "hash_grid_train_bwd"
    if not _build.on_card(name, x.device):
        return hash_grid_train_bwd_plain(x, gout, spec, packed)
    _check(name, x, spec, dict(gout=gout))
    _build.require(name, gout.dtype == torch.float32
                   and tuple(gout.shape) == (x.shape[0], spec.out_dim),
                   "gout must be (N, L*2) float32")
    dtable = torch.zeros((spec.total_params, 2), dtype=torch.float32,
                         device=x.device)
    n = x.shape[0]
    if n == 0:
        return dtable
    lib = _lib()
    rc = lib.hash_grid_train_bwd_launch(
        _build.ptr(x), _build.ptr(gout), n, int(packed),
        _build.ptr(level_table(spec, x.device)), spec.n_levels,
        spec.total_params, _build.ptr(dtable), _build.stream_ptr(x.device))
    _build.check(lib, _LIB, rc)
    hash_grid_train_bwd.launches += 1
    return dtable


hash_grid_train_fwd.launches = 0
hash_grid_train_bwd.launches = 0


class HashGridTrainEncode(torch.autograd.Function):
    """features = encode(table, x); the gradient flows to the float32
    (P, 2) ``table`` only.  ``packed`` encodes from the bf16-packed copy
    of the table and rounds each gradient term to bf16."""

    @staticmethod
    def forward(ctx, table, x, spec: HashGridSpec, packed: bool):
        x = x.contiguous()
        ctx.save_for_backward(x)
        ctx.spec, ctx.packed = spec, packed
        src = pack_table_bf16(table) if packed else table.contiguous()
        return hash_grid_train_fwd(src, x, spec, packed)

    @staticmethod
    def backward(ctx, gout):
        (x,) = ctx.saved_tensors
        dtable = hash_grid_train_bwd(x, gout.contiguous(), ctx.spec,
                                     ctx.packed)
        return dtable, None, None, None
