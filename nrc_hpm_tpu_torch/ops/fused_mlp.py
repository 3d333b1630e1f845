"""Fused NRC MLP inference: kernel K4 (``fused_mlp_infer``).

Replaces the Pallas kernel ``nrc_hpm_tpu/ops/fused_mlp.py:_kernel``
(wrapper ``fused_mlp_infer``) with the CUDA kernel of
``csrc/fused_mlp.cu``; that file's header says what bounds it on the H100
and how its tensor-core design serves every shape.  The cache runs it
after the split encode for every shape the fused encode kernel (K3) does
not take, at hidden widths up to 256 (``use_fused``, the JAX package's
own test); a wider MLP runs ``mlp_apply``.  The TPU kernel padded the
output to 128 lanes; this one writes ``out_dim`` columns.

The wrapper checks the contract (float32 (N, in_dim) features, a chain of
float32 (in, out) layers) on every device, takes the plain PyTorch version
(``fused_mlp_plain``, the bf16 ``mlp_apply``) for CPU tensors and launches
the kernel for CUDA tensors; other devices raise.  The kernel takes every
in_dim and hidden width up to 256 (both padded to multiples of 16 with
zero weights, which leaves the result exact), any depth and up to 8
outputs; ``plan`` picks its design from the shapes before any launch, and
anything else raises ``NotImplementedError`` on the card.
``fused_mlp_infer.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.nrc.mlp import mlp_apply
from . import _build

MAX_DIM = 256
OUT_PAD = 8
_MAX_SMEM = 227 * 1024
_RES_WARPS = 4
_LIB = "fused_mlp"


def fused_mlp_plain(params: dict, feats: torch.Tensor, out_dim: int = 3
                    ) -> torch.Tensor:
    return mlp_apply(params, feats)[:, :out_dim]


def use_fused(width: int) -> bool:
    """The JAX package's shape test for its fused MLP kernel."""
    return width <= MAX_DIM


def pad16(d: int) -> int:
    return (d + 15) // 16 * 16


def row_bytes(k: int) -> int:
    """Shared-memory bytes of one k-value bf16 row (``csrc/mlp_mma.cuh``):
    rows of a multiple of 64 values are XOR-swizzled in place, any other
    row is padded by one 16-byte chunk."""
    return 2 * k if k % 64 == 0 else 2 * k + 16


def plan(layers, in_dim: int, out_dim: int) -> tuple:
    """(k_in, width, stream): in_dim and the hidden width rounded up to
    multiples of 16, and whether the STREAM design runs (widths above 128,
    or the RESIDENT block's weights and warp tiles, laid out as
    ``csrc/fused_mlp.cu`` lays them, beyond one block's shared memory);
    raises NotImplementedError for shapes the kernel does not take."""
    name = "fused_mlp_infer"
    width = layers[0].shape[1]
    if any(w.shape != (width, width) for w in layers[1:-1]):
        raise NotImplementedError(
            f"{name}: the kernel takes one hidden width, not "
            f"{[tuple(w.shape) for w in layers]}")
    if width > MAX_DIM or in_dim > MAX_DIM or out_dim > OUT_PAD:
        raise NotImplementedError(
            f"{name}: the kernel takes in_dim and widths up to {MAX_DIM} "
            f"and up to {OUT_PAD} outputs, not in_dim {in_dim}, width "
            f"{width}, {out_dim} outputs")
    k_in, w = pad16(in_dim), pad16(width)
    depth = len(layers) - 1
    rows = 32 if w <= 64 else 16
    smem = (w * row_bytes(k_in) + (depth - 1) * w * row_bytes(w)
            + OUT_PAD * row_bytes(w) + _RES_WARPS * rows * row_bytes(k_in))
    return k_in, w, w > 128 or smem > _MAX_SMEM


def kernel_weights(layers, k_in: int, width: int) -> torch.Tensor:
    """The kernel's bf16 weight block: each layer transposed (one row of
    inputs per output), zero-padded to k_in inputs (layer 0) or ``width``
    (the others) and to ``width`` outputs (OUT_PAD for the output layer),
    the layers back to back."""
    dev = layers[0].device
    blocks = []
    for i, w in enumerate(layers):
        rows = OUT_PAD if i == len(layers) - 1 else width
        m = torch.zeros((rows, k_in if i == 0 else width),
                        dtype=torch.float32, device=dev)
        m[:w.shape[1], :w.shape[0]] = w.t()
        blocks.append(m.reshape(-1))
    return torch.cat(blocks).to(torch.bfloat16).contiguous()


def _lib():
    lib = _build.load(_LIB)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fused_mlp_launch.argtypes = [P, I, P, I, I, I, I, I, I, P, P]
    lib.fused_mlp_launch.restype = I
    return lib


def _check(layers, feats, out_dim: int) -> None:
    name = "fused_mlp_infer"
    _build.require(name, feats.dtype == torch.float32 and feats.ndim == 2,
                   "feats must be (N, in_dim) float32")
    _build.require(name, len(layers) >= 2, "the MLP needs >= 2 layers")
    prev = feats.shape[1]
    for i, w in enumerate(layers):
        _build.require(name, w.dtype == torch.float32 and w.ndim == 2
                       and w.shape[0] == prev,
                       f"layer {i} must be float32 ({prev}, out)")
        prev = w.shape[1]
    _build.require(name, 1 <= out_dim <= prev,
                   f"out_dim must be in [1, {prev}]")


def fused_mlp_infer(params: dict, feats: torch.Tensor, out_dim: int = 3
                    ) -> torch.Tensor:
    """feats (N, in_dim) float32 -> (N, out_dim) float32 through the bf16
    network ``params["layers"]`` (float32 (in, out) matrices)."""
    name = "fused_mlp_infer"
    layers = params["layers"]
    _check(layers, feats, out_dim)
    if not _build.on_card(name, feats.device):
        return fused_mlp_plain(params, feats, out_dim)
    _build.require_cuda(name, dict(feats=feats), feats.device)
    for i, w in enumerate(layers):
        _build.require(name, w.device == feats.device,
                       f"layer {i} is on {w.device}")
    k_in, width, stream = plan(layers, feats.shape[1], layers[-1].shape[1])
    n = feats.shape[0]
    out = torch.empty((n, out_dim), dtype=torch.float32, device=feats.device)
    if n == 0:
        return out
    weights = kernel_weights(layers, k_in, width)
    lib = _lib()
    rc = lib.fused_mlp_launch(
        _build.ptr(feats), n, _build.ptr(weights), feats.shape[1], k_in,
        width, len(layers) - 1, out_dim, int(stream), _build.ptr(out),
        _build.stream_ptr(feats.device))
    _build.check(lib, _LIB, rc)
    fused_mlp_infer.launches += 1
    return out


fused_mlp_infer.launches = 0
