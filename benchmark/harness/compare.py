"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference works out again.

- ``image_gap``: the L2 norm of the difference of the two images after a
  frame, over the norm of that frame's composite scaled by its blend
  weight: the relative gap of the frame's own contribution.
- ``loss_gap``: the largest relative gap of the optimizer steps' losses.
- ``leaf_gap``: for trees of tensors, the largest over leaves of the gap
  between the program's norm and the reference's (not the norm of their
  difference), over the reference's norm of that leaf or of the median
  leaf, whichever is larger.  Leaves whose reference gradient is under a
  thousandth of the median leaf's are left out (``keep``): they move by
  round-off alone.
"""

from __future__ import annotations

import statistics

import torch

ADAM_B1 = 0.9


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def image_gap(img_p, img_r, out_r, weight: float) -> float:
    num = _norm(img_p.to(img_r.device) - img_r)
    den = weight * _norm(out_r)
    return num / den if den > 0 else float("inf")


def loss_gap(losses_p, losses_r) -> float:
    return max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
               for a, b in zip(losses_p, losses_r))


def leaf_norms(tree) -> list:
    return [_norm(t) for t in leaves(tree)]


def first_grad_norms(opt_state) -> list:
    """Each leaf's norm of the first gradient, from Adam's first moment
    after one step (mu = (1 - b1) g)."""
    return [n / (1.0 - ADAM_B1) for n in leaf_norms(opt_state["mu"])]


def change_norms(after, before) -> list:
    return [_norm(a.to(b.device) - b)
            for a, b in zip(leaves(after), leaves(before))]


def keep_leaves(ref_grad_norms) -> list:
    """Leaves the gaps of norms count: reference gradient at least a
    thousandth of the median leaf's."""
    med = statistics.median(ref_grad_norms)
    return [g >= 1e-3 * med for g in ref_grad_norms]


def leaf_gap(norms_p, norms_r, keep=None) -> float:
    keep = keep or [True] * len(norms_r)
    kept = [r for r, k in zip(norms_r, keep) if k]
    med = statistics.median(kept)
    return max(abs(p - r) / max(r, med)
               for p, r, k in zip(norms_p, norms_r, keep) if k)
