"""Milliseconds a frame in the train rays, their 32-bounce paths and the
ring push (`NrcRenderer.train_set` -> `integrator.trace_fixed`): the
benchmark's span around the call, timed by CUDA events recorded at its
entry and its return, with no synchronization."""

LAYER = "train paths"
SOURCE = "program_span"
UNIT = "ms/frame"
MOVES = "rays_per_s"
SPANS = {"train_set": "train_set"}


def read(t):
    ms = t.spans["train_set"]
    return sum(ms) / t.frames if ms else None
