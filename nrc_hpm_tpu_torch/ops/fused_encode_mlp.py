"""Fully fused NRC inference: kernel K3 (``fused_encode_mlp_infer``).

Replaces the Pallas kernel ``nrc_hpm_tpu/ops/fused_encode_mlp.py:_kernel``
(wrapper ``fused_encode_mlp_infer``) with the CUDA kernel of
``csrc/fused_encode_mlp.cu``; that file's header says what bounds it on
the H100 and what its design does about it (the encode into a
shared-memory tile, the MLP on the tensor cores with mma.sync).  Unlike
the TPU kernel, which only served tables up to 2^16 entries per level, it
serves every table size of the default encoding (the reference's 2^19
included).

The wrapper takes the plain PyTorch version for CPU tensors (hash-grid
encode from the packed table, OneBlob, ones padding, bf16 MLP) and
launches the kernel for CUDA tensors; ``fused_encode_mlp_infer.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.nrc.encoding import HashGridSpec, encode_packed
from ..models.nrc.mlp import mlp_apply
from . import _build

WIDTH = 64
OUT_PAD = 8
MAX_LEVELS = 16
MAX_BINS = 8
_LIB = "fused_encode_mlp"


def fused_encode_mlp_plain(packed_table, layers, x5, spec: HashGridSpec,
                           n_bins: int = 4) -> torch.Tensor:
    feats = encode_packed(packed_table, x5, spec, n_bins, layers[0].shape[0])
    return mlp_apply({"layers": layers}, feats)


def swizzle_rows(block: torch.Tensor) -> torch.Tensor:
    """(R, 64) -> (R, 64): each row's 8-value chunk c moved to position
    c ^ (r % 8), the bank-conflict-free order of ``csrc/mlp_mma.cuh``.  The
    map is its own inverse."""
    rows = torch.arange(block.shape[0], device=block.device)[:, None]
    pos = torch.arange(WIDTH // 8, device=block.device)[None, :] ^ (rows % 8)
    return block.reshape(-1, WIDTH // 8, 8)[rows, pos].reshape(-1, WIDTH)


def kernel_weights(layers) -> torch.Tensor:
    """The kernel's bf16 weight block, the image of its shared memory: each
    hidden layer transposed to 64 rows of 64 inputs, one per output (layer
    0's inputs padded with zeros), then the output layer's 8 rows (zero
    rows past out_dim), every row swizzled by ``swizzle_rows`` so that
    ldmatrix reads the mma.sync B fragments straight from it."""
    hidden, w_out = layers[:-1], layers[-1]
    dev = w_out.device
    blocks = []
    for w in hidden:
        m = torch.zeros((WIDTH, WIDTH), dtype=torch.float32, device=dev)
        m[:, :w.shape[0]] = w.t()
        blocks.append(m)
    m = torch.zeros((OUT_PAD, WIDTH), dtype=torch.float32, device=dev)
    m[:w_out.shape[1]] = w_out.t()
    blocks.append(m)
    block = torch.cat(blocks).to(torch.bfloat16)
    return swizzle_rows(block).reshape(-1).contiguous()


def _lib():
    lib = _build.load(_LIB)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_encode_mlp_launch.argtypes = [
        P, I, P, P, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(I),
        ctypes.POINTER(I), ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(I),
        I, I, F, I, I, I, P, P]
    lib.fused_encode_mlp_launch.restype = I
    return lib


def _refusal(spec, n_bins: int, layers, out_dim: int):
    """Why K3 does not take these shapes, or None where it does: a 3-D,
    2-feature grid of <= 16 levels, <= 8 OneBlob bins, a 64-wide MLP whose
    in_dim holds the features within 64, and <= 8 outputs."""
    if not (spec.n_dims == 3 and spec.n_features == 2
            and spec.n_levels <= MAX_LEVELS and n_bins <= MAX_BINS):
        return "3-D, 2-feature grid with <= 16 levels, <= 8 bins"
    in_dim = layers[0].shape[0]
    if not (len(layers) >= 2 and spec.out_dim + 2 * n_bins <= in_dim <= WIDTH
            and layers[0].shape[1] == WIDTH
            and all(w.shape == (WIDTH, WIDTH) for w in layers[1:-1])
            and layers[-1].shape == (WIDTH, out_dim) and out_dim <= OUT_PAD):
        return "MLP must be 64 wide with in_dim <= 64, out_dim <= 8"
    return None


def takes(spec, n_bins: int, layers, out_dim: int) -> bool:
    """The cache's test, made before any launch: the default encoding's
    shapes that K3 serves (the others take the split encode and K4)."""
    return spec is not None and _refusal(spec, n_bins, layers, out_dim) is None


def _check(packed_table, layers, x5, spec, n_bins, out_dim):
    name = "fused_encode_mlp_infer"
    dev = x5.device
    _build.require_cuda(name, dict(x5=x5, packed_table=packed_table), dev)
    for i, w in enumerate(layers):
        _build.require(name, w.device == dev, f"layer {i} is on {w.device}")
    _build.require(name, x5.dtype == torch.float32 and x5.ndim == 2
                   and x5.shape[1] == 5, "x5 must be (N, 5) float32")
    _build.require(name, packed_table.dtype == torch.int32
                   and packed_table.shape == (spec.total_params,),
                   "packed_table must be (total_params,) int32")
    why = _refusal(spec, n_bins, layers, out_dim)
    _build.require(name, why is None, why)


def fused_encode_mlp_infer(packed_table: torch.Tensor, layers, x5,
                           spec: HashGridSpec, n_bins: int = 4,
                           out_dim: int = 3) -> torch.Tensor:
    """x5 (N, 5) raw NRC inputs -> (N, out_dim) cache prediction.
    ``packed_table`` is pack_table_bf16's (P,) int32 words, ``layers`` the
    float32 (in, out) weight list."""
    if not _build.on_card("fused_encode_mlp_infer", x5.device):
        return fused_encode_mlp_plain(packed_table, layers, x5, spec, n_bins)
    _check(packed_table, layers, x5, spec, n_bins, out_dim)
    n = x5.shape[0]
    out = torch.empty((n, out_dim), dtype=torch.float32, device=x5.device)
    if n == 0:
        return out
    weights = kernel_weights(layers)
    L = spec.n_levels

    def arr(ctype, vals):
        return (ctype * L)(*vals)

    lib = _lib()
    rc = lib.fused_encode_mlp_launch(
        _build.ptr(x5), n, _build.ptr(packed_table), _build.ptr(weights),
        arr(ctypes.c_float, [spec.level_scale(lv) for lv in range(L)]),
        arr(ctypes.c_int, [spec.level_resolution(lv) for lv in range(L)]),
        arr(ctypes.c_int, [int(spec.level_is_dense(lv)) for lv in range(L)]),
        arr(ctypes.c_uint, [spec.level_params(lv) for lv in range(L)]),
        arr(ctypes.c_int, spec.level_offsets[:-1]), L, n_bins,
        float(np.float32(1.0 / n_bins * np.sqrt(2.0))), layers[0].shape[0],
        len(layers) - 1, out_dim, _build.ptr(out),
        _build.stream_ptr(x5.device))
    _build.check(lib, _LIB, rc)
    fused_encode_mlp_infer.launches += 1
    return out


fused_encode_mlp_infer.launches = 0
