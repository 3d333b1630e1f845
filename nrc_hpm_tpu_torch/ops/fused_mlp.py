"""Fused NRC MLP inference: kernel K4 (``fused_mlp_infer``).

Replaces the Pallas kernel ``nrc_hpm_tpu/ops/fused_mlp.py:_kernel``
(wrapper ``fused_mlp_infer``) with the CUDA kernel of
``csrc/fused_mlp.cu``; that file's header says what bounds it on the H100
and what the simple design does about it.  The cache runs it after the
split encode for every encoding the fused encode kernel (K3) does not
take.  The TPU kernel padded the output to 128 lanes; this one writes
``out_dim`` columns.

The wrapper checks the contract (float32 (N, in_dim) features, a chain of
float32 (in, out) layers) on every device, takes the plain PyTorch version
(``fused_mlp_plain``, the bf16 ``mlp_apply``) for CPU tensors and launches
the kernel for CUDA tensors; other devices raise.  The kernel takes
widths 16, 32, 64 and 128 (one library each, built at the width's first
launch), ``in_dim`` a multiple of 16 up to 128 and up to 8 outputs;
anything else raises ``NotImplementedError`` on the card.
``fused_mlp_infer.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.nrc.mlp import mlp_apply
from . import _build

WIDTHS = (16, 32, 64, 128)
MAX_IN = 128
OUT_PAD = 8
_MAX_SMEM = 227 * 1024
_LIB = "fused_mlp"


def fused_mlp_plain(params: dict, feats: torch.Tensor, out_dim: int = 3
                    ) -> torch.Tensor:
    return mlp_apply(params, feats)[:, :out_dim]


def kernel_weights(layers) -> torch.Tensor:
    """The kernel's bf16 weight block: every layer row-major, the output
    layer padded to OUT_PAD columns with zeros."""
    *hidden, w_out = layers
    pad = torch.zeros((w_out.shape[0], OUT_PAD), dtype=torch.float32,
                      device=w_out.device)
    pad[:, :w_out.shape[1]] = w_out
    return torch.cat([w.reshape(-1) for w in hidden] + [pad.reshape(-1)]
                     ).to(torch.bfloat16).contiguous()


def build_flags(width: int) -> tuple:
    """nvcc flags of the kernel's library for one hidden width (each
    width is its own build)."""
    return (f"-DK4_WIDTH={width}",)


def _lib(width: int):
    lib = _build.load(_LIB, build_flags(width))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fused_mlp_launch.argtypes = [P, I, P, I, I, I, I, P, P]
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


def _check_kernel(layers, feats, out_dim: int) -> None:
    """The shapes the CUDA kernel takes."""
    name = "fused_mlp_infer"
    dev = feats.device
    _build.require_cuda(name, dict(feats=feats), dev)
    for i, w in enumerate(layers):
        _build.require(name, w.device == dev, f"layer {i} is on {w.device}")
    width = layers[0].shape[1]
    in_dim = feats.shape[1]
    if width not in WIDTHS or any(w.shape != (width, width)
                                  for w in layers[1:-1]):
        raise NotImplementedError(
            f"{name}: the kernel takes hidden widths {WIDTHS}, not "
            f"{[tuple(w.shape) for w in layers]}")
    if in_dim % 16 or in_dim > MAX_IN or layers[-1].shape[1] > OUT_PAD:
        raise NotImplementedError(
            f"{name}: the kernel takes in_dim a multiple of 16 up to "
            f"{MAX_IN} and up to {OUT_PAD} outputs, not ({in_dim}, "
            f"{layers[-1].shape[1]})")
    depth = len(layers) - 1
    smem = 2 * (in_dim * width + (depth - 1) * width * width
                + width * OUT_PAD)
    if smem > _MAX_SMEM:
        raise NotImplementedError(
            f"{name}: {smem} bytes of weights exceed one block's shared "
            f"memory")


def fused_mlp_infer(params: dict, feats: torch.Tensor, out_dim: int = 3
                    ) -> torch.Tensor:
    """feats (N, in_dim) float32 -> (N, out_dim) float32 through the bf16
    network ``params["layers"]`` (float32 (in, out) matrices)."""
    layers = params["layers"]
    _check(layers, feats, out_dim)
    if not _build.on_card("fused_mlp_infer", feats.device):
        return fused_mlp_plain(params, feats, out_dim)
    _check_kernel(layers, feats, out_dim)
    n = feats.shape[0]
    out = torch.empty((n, out_dim), dtype=torch.float32, device=feats.device)
    if n == 0:
        return out
    weights = kernel_weights(layers)
    width = layers[0].shape[1]
    lib = _lib(width)
    rc = lib.fused_mlp_launch(
        _build.ptr(feats), n, _build.ptr(weights), width,
        feats.shape[1], len(layers) - 1, out_dim, _build.ptr(out),
        _build.stream_ptr(feats.device))
    _build.check(lib, _LIB, rc)
    fused_mlp_infer.launches += 1
    return out


fused_mlp_infer.launches = 0
