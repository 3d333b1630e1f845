"""Cache and ring-buffer state from the JAX package's layout.

The JAX cache keeps ``{"encoding": {"hash_table": (P, 2)}, "mlp":
{"layers": [(in, out), ...]}}`` as arrays (``"encoding": {}`` without a
hash grid); ``params_from_jax`` takes the
same tree as numpy arrays (for example ``jax.tree.map(np.asarray,
state.ema_params)`` or a loaded checkpoint) and returns the port's
float32 tensors in the same layout.  ``state_from_jax`` takes a whole
``NrcState`` mapped to numpy (params, ema_params, the optax state, loss,
step) and ``ring_from_jax`` a ``RingBuffer`` mapped to numpy;
``sharded_state_from_jax`` takes the JAX ``ShardedNrcRenderer``'s global
state mapped to numpy and returns one rank's share of it.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.nrc.cache import NrcState
from .renderer import NrcRenderState
from .ring_buffer import RingBuffer


def _t(a, device, dtype=np.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype), device=device)


def params_from_jax(ema_params_np: dict, device="cuda") -> dict:
    """Any encoding tree: ``{"hash_table": ...}`` or ``{}`` (encodings
    without parameters)."""
    return {"encoding": {k: _t(v, device)
                         for k, v in ema_params_np["encoding"].items()},
            "mlp": {"layers": [_t(w, device) for w in
                               ema_params_np["mlp"]["layers"]]}}


def state_from_jax(nrc_state_np, device="cuda") -> NrcState:
    """The JAX ``NrcState`` (leaves as numpy arrays) -> the port's.  Its
    ``opt_state`` is optax's chain state: ``(ScaleByAdamState(count, mu,
    nu), EmptyState())`` for Adam, empty states for SGD."""
    s = nrc_state_np
    adam = [o for o in s.opt_state if hasattr(o, "mu")]
    opt = {} if not adam else {
        "count": int(adam[0].count),
        "mu": params_from_jax(adam[0].mu, device),
        "nu": params_from_jax(adam[0].nu, device)}
    return NrcState(params=params_from_jax(s.params, device),
                    ema_params=params_from_jax(s.ema_params, device),
                    opt_state=opt, loss=_t(s.loss, device),
                    step=int(s.step))


def ring_from_jax(ring_np, device="cuda") -> RingBuffer:
    return RingBuffer(data=_t(ring_np.data, device),
                      head=_t(ring_np.head, device, np.int32),
                      tail=_t(ring_np.tail, device, np.int32))


def sharded_state_from_jax(state_np, rank: int, n: int, device="cuda"
                           ) -> NrcRenderState:
    """Rank ``rank`` of ``n``'s ``NrcRenderState`` from the JAX sharded
    renderer's global state (leaves as numpy arrays): its rows of the
    (pad_h, W, 4) image, its block of the (n * cap, 6) ring with its
    entries of the (n,) head and tail, the replicated cache and key."""
    s = state_np
    rows = s.image.shape[0] // n
    cap = s.ring.data.shape[0] // n
    ring = RingBuffer(data=_t(s.ring.data[rank * cap:(rank + 1) * cap],
                              device),
                      head=_t(s.ring.head[rank], device, np.int32),
                      tail=_t(s.ring.tail[rank], device, np.int32))
    return NrcRenderState(
        image=_t(s.image[rank * rows:(rank + 1) * rows], device),
        blend_index=int(s.blend_index), ring=ring,
        nrc=state_from_jax(s.nrc, device),
        key=torch.as_tensor(np.asarray(s.key, np.int64)))
