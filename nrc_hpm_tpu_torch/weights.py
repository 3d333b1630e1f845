"""Cache parameters from the JAX package's layout.

The JAX cache keeps ``{"encoding": {"hash_table": (P, 2)}, "mlp":
{"layers": [(in, out), ...]}}`` as arrays; ``params_from_jax`` takes the
same tree as numpy arrays (for example ``jax.tree.map(np.asarray,
state.ema_params)`` or a loaded checkpoint) and returns the port's
float32 tensors in the same layout.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(ema_params_np: dict, device="cpu") -> dict:
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32).copy(),
                               device=device)

    return {"encoding": {"hash_table":
                         t(ema_params_np["encoding"]["hash_table"])},
            "mlp": {"layers": [t(w) for w in
                               ema_params_np["mlp"]["layers"]]}}
