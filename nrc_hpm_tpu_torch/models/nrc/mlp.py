"""The NRC MLP: a small bias-free ReLU network (tcnn FullyFusedMLP).

Port of ``nrc_hpm_tpu/models/nrc/mlp.py``: ``depth`` hidden matmuls plus
the output projection, float32 parameters.  In ``bfloat16`` (the default)
the operands are bf16 with float32 accumulation and bf16 activations
between layers; in ``float32`` nothing is rounded.  This is the training
path and the plain version of kernel K4 (``ops/fused_mlp.py``).  The
products stay ``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import prng


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
    table = {"bfloat16": torch.bfloat16, "float32": torch.float32}
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
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"unsupported compute dtype {compute_dtype}")
    h = x.to(torch.bfloat16)
    for i, w in enumerate(layers):
        h = h.to(torch.float32) @ w.to(torch.bfloat16).to(torch.float32)
        if i + 1 < len(layers):
            h = torch.maximum(h, zero).to(torch.bfloat16)
    return h
