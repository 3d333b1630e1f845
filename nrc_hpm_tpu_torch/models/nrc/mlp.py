"""The NRC MLP: a small bias-free ReLU network (tcnn FullyFusedMLP).

Port of ``nrc_hpm_tpu/models/nrc/mlp.py``: ``depth`` hidden matmuls plus
the output projection, bf16 operands with float32 accumulation, bf16
activations between layers, float32 parameters.  The products stay
``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math

import torch


def init_mlp(generator: torch.Generator, in_dim: int, width: int,
             depth: int, out_dim: int = 3) -> dict:
    """He-uniform init of the (in, out) layer matrices."""
    dims = [in_dim] + [width] * depth + [out_dim]
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        bound = math.sqrt(6.0 / a)
        u = torch.rand((a, b), generator=generator)
        layers.append((u * 2.0 - 1.0) * bound)
    return {"layers": layers}


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(N, in_dim) -> (N, out_dim) float32.  bf16 values are multiplied in
    float32, which is exact, and summed in float32.

    Differentiable: autograd rounds at the casts, so the backward rounds
    where the JAX transpose of a bf16 dot with float32 results does (the
    cotangents of both operands come back as bf16), and the ReLU splits
    the gradient at 0 as ``jnp.maximum`` does."""
    h = x.to(torch.bfloat16)
    layers = params["layers"]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, w in enumerate(layers):
        h = h.to(torch.float32) @ w.to(torch.bfloat16).to(torch.float32)
        if i + 1 < len(layers):
            h = torch.maximum(h, zero).to(torch.bfloat16)
    return h
