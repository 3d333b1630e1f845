"""Faults planted under the program's side, for the tests that see
``correct`` come out false and for the readings that set the limits'
upper ends: each wraps a method of the side's renderer instance."""

from __future__ import annotations

import dataclasses


def unchanged(side) -> None:
    """An optimizer step that returns its state unchanged."""
    side.renderer.cache.train_step = lambda state, *a, **kw: state


def half_batch(side) -> None:
    """Half of each optimizer step's batch left out, the mean taken over
    the rest."""
    inner = side.renderer.cache.train_step

    def step(state, x5, target, *a, **kw):
        h = x5.shape[0] // 2
        return inner(state, x5[:h], target[:h], *a, **kw)
    side.renderer.cache.train_step = step


def altered(side) -> None:
    """Each frame's image altered where it is produced: 5% brighter."""
    inner = side.renderer.step

    def step(state, *a, **kw):
        out = inner(state, *a, **kw)
        return dataclasses.replace(out, image=out.image * 1.05)
    side.renderer.step = step


def lowp_paths(side) -> None:
    """The reference's paths in bfloat16 (``TraceParams.lowp``): the MC
    cell's control, put in the program's place."""
    r = side.renderer
    r.params = dataclasses.replace(r.params, lowp=True)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}
