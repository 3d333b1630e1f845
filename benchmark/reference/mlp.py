"""The NRC MLP, plain: a small bias-free ReLU network (tcnn
FullyFusedMLP), ``depth`` hidden matmuls plus the output projection,
float32 parameters.  In ``bfloat16`` (the configurations' precision) the
operands are bf16 with float32 accumulation and bf16 activations between
layers; in ``float32`` nothing is rounded.  ``float8`` is the control of
the benchmark's comparison, the next precision below bfloat16: every
operand and every backward cotangent rounded to float8 e4m3 with a
per-tensor scale (the tensor's largest magnitude to e4m3's 448), as an
fp8 path with per-tensor scaling computes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prng


def init_mlp(key: torch.Tensor, in_dim: int, width: int, depth: int,
             out_dim: int = 3, device="cuda") -> dict:
    """He-uniform init of the (in, out) layer matrices, one split of the
    threefry ``key`` a layer, as the JAX package draws them (its bound is
    the float32 square root of float32(6 / in))."""
    dims = [in_dim] + [width] * depth + [out_dim]
    keys = prng.split(key, len(dims) - 1)
    layers = []
    for k, (a, b) in zip(keys, zip(dims[:-1], dims[1:])):
        bound = np.sqrt(np.float32(6.0 / a))
        layers.append(prng.uniform(k, (a, b), -bound, bound, device))
    return {"layers": layers}


def compute_dtype(mlp_dtype: str) -> torch.dtype:
    """AppConfig.mlp_dtype -> the MLP's compute dtype."""
    table = {"bfloat16": torch.bfloat16, "float32": torch.float32,
             "float8": torch.float8_e4m3fn}
    if mlp_dtype not in table:
        raise ValueError(f"unsupported mlp_dtype {mlp_dtype!r}; choose from "
                         f"{sorted(table)}")
    return table[mlp_dtype]


def mlp_apply(params: dict, x: torch.Tensor,
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(N, in_dim) -> (N, out_dim) float32.

    bfloat16: bf16 values are multiplied in float32, which is exact, and
    summed in float32.  Differentiable: autograd rounds at the casts, so
    the backward rounds where the JAX transpose of a bf16 dot with float32
    results does (the cotangents of both operands come back as bf16), and
    the ReLU splits the gradient at 0 as ``jnp.maximum`` does.

    float32: full float32 products.  On a GPU that needs TF32 off for
    matrix products (``torch.backends.cuda.matmul.allow_tf32 = False``,
    PyTorch's default); otherwise this raises."""
    layers = params["layers"]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if compute_dtype == torch.float32:
        if x.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise ValueError("the float32 MLP needs full float32 products: "
                             "set torch.backends.cuda.matmul.allow_tf32 = "
                             "False")
        h = x.to(torch.float32)
        for i, w in enumerate(layers):
            h = h @ w
            if i + 1 < len(layers):
                h = torch.maximum(h, zero)
        return h
    if compute_dtype == torch.float8_e4m3fn:
        h = x.to(torch.float32)
        for i, w in enumerate(layers):
            h = _Fp8.apply(h) @ _Fp8.apply(w)
            if i + 1 < len(layers):
                h = torch.maximum(h, zero)
        return _Fp8.apply(h)
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"unsupported compute dtype {compute_dtype}")
    h = x.to(torch.bfloat16)
    for i, w in enumerate(layers):
        h = h.to(torch.float32) @ w.to(torch.bfloat16).to(torch.float32)
        if i + 1 < len(layers):
            h = torch.maximum(h, zero).to(torch.bfloat16)
    return h


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to float8 e4m3 under a per-tensor scale that
    maps its largest magnitude to 448."""
    amax = torch.clamp(t.detach().abs().amax(), min=1e-30)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _Fp8(torch.autograd.Function):
    """Rounds the forward value and the backward cotangent to fp8."""

    @staticmethod
    def forward(ctx, t):
        return round_fp8(t)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g)
