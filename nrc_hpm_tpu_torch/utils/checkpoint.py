"""Checkpoint / resume for the NRC cache state.

Port of ``nrc_hpm_tpu/utils/checkpoint.py`` in its file format: a flat
``.npz`` of ``leaf_<i>`` arrays in the order ``jax.tree.flatten`` gives
the JAX package's tree, and ``__treedef__``, the text of that tree's
``PyTreeDef``.  The port's ``NrcState`` is laid out as the JAX package's
(the correspondence ``weights.state_from_jax`` reads): params,
ema_params, the optax chain state ``(ScaleByAdamState(count, mu, nu),
EmptyState())`` for Adam or ``(EmptyState(), EmptyState())`` for SGD,
loss, step; dicts in sorted key order, count and step as int32.  So a
checkpoint the JAX app wrote loads into the port.  Loading a port-written
file into the JAX package is not a goal and is not tested.  Trees of
dicts, lists and tuples of tensors are saved and loaded the same way.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..models.nrc.cache import NrcState


class _Custom:
    """A custom pytree node of the JAX layout: its name as ``PyTreeDef``
    prints it, and its children."""

    def __init__(self, name: str, children: list):
        self.name, self.children = name, children


def _jax_layout(tree):
    """An ``NrcState`` as the JAX package's pytree; anything else as it
    is."""
    if not isinstance(tree, NrcState):
        return tree
    empty = _Custom("namedtuple[EmptyState]", [])
    o = tree.opt_state
    opt = (_Custom("namedtuple[ScaleByAdamState]",
                   [np.int32(o["count"]), o["mu"], o["nu"]]), empty) \
        if o else (empty, empty)
    return _Custom("NrcState[()]", [tree.params, tree.ema_params, opt,
                                    tree.loss, np.int32(tree.step)])


def _walk(tree, leaves: list) -> str:
    """Append the leaves of ``tree`` to ``leaves`` in flatten order and
    return the ``PyTreeDef`` text of its structure."""
    tree = _jax_layout(tree)
    if isinstance(tree, _Custom):
        inner = [_walk(c, leaves) for c in tree.children]
        return f"CustomNode({tree.name}, [{', '.join(inner)}])"
    if isinstance(tree, dict):
        inner = [f"{k!r}: {_walk(tree[k], leaves)}" for k in sorted(tree)]
        return "{" + ", ".join(inner) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join([_walk(c, leaves) for c in tree]) + "]"
    if isinstance(tree, tuple):
        inner = [_walk(c, leaves) for c in tree]
        return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") + ")"
    if tree is None:
        return "None"
    leaves.append(tree)
    return "*"


def _flatten(tree) -> tuple[list, str]:
    leaves: list = []
    text = _walk(tree, leaves)
    return leaves, f"PyTreeDef({text})"


def _numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of arrays (an ``NrcState`` in the JAX layout) as a flat
    npz keyed by leaf index, with its structure's text."""
    leaves, text = _flatten(tree)
    arrays = {f"leaf_{i}": _numpy(leaf) for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(text.encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _rebuild(like, it, device):
    """``like``'s structure with its leaves taken from ``it`` in flatten
    order: tensors on ``device`` in ``like``'s dtype, Python numbers as
    Python numbers."""
    if isinstance(like, NrcState):
        params = _rebuild(like.params, it, device)
        ema = _rebuild(like.ema_params, it, device)
        opt = {}
        if like.opt_state:
            opt = {"count": int(next(it))}
            opt["mu"] = _rebuild(like.opt_state["mu"], it, device)
            opt["nu"] = _rebuild(like.opt_state["nu"], it, device)
        loss = _rebuild(like.loss, it, device)
        return NrcState(params=params, ema_params=ema, opt_state=opt,
                        loss=loss, step=int(next(it)))
    if isinstance(like, dict):
        vals = {k: _rebuild(like[k], it, device) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(c, it, device) for c in like)
    if like is None:
        return None
    arr = next(it)
    if torch.is_tensor(like):
        return torch.as_tensor(arr, device=device).to(like.dtype)
    return type(like)(arr)


def load_pytree(path: str, like: Any, device="cuda") -> Any:
    """Load arrays saved by ``save_pytree`` (either package's) into the
    structure of ``like``, on ``device``.

    The stored structure text must equal ``like``'s and every leaf's shape
    must match: same-shaped leaves under another structure (for example a
    changed optimizer) raise ``ValueError`` instead of being misassigned."""
    leaves, text = _flatten(like)
    loaded = []
    with np.load(path, allow_pickle=False) as data:
        if "__treedef__" in data:
            stored = bytes(data["__treedef__"].tobytes()).decode()
            if stored != text:
                raise ValueError(
                    f"checkpoint {path} was saved with a different pytree "
                    f"structure than the target:\n  saved:  {stored[:200]}"
                    f"\n  target: {text[:200]}")
        for i, leaf in enumerate(leaves):
            key = f"leaf_{i}"
            if key not in data:
                raise ValueError(f"checkpoint {path} has {len(data) - 1} "
                                 f"leaves, need {len(leaves)}")
            arr = data[key]
            want = tuple(leaf.shape) if torch.is_tensor(leaf) \
                else np.shape(leaf)
            if arr.shape != want:
                raise ValueError(
                    f"checkpoint leaf {i}: shape {arr.shape} != {want}")
            loaded.append(arr)
    return _rebuild(like, iter(loaded), device)
