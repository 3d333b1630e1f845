"""Milliseconds a frame in the frame's optimizer steps
(`cache.train_frame`: encode, MLP autograd, Adam, EMA): the benchmark's
span around the call, timed by CUDA events recorded at its entry and its
return, with no synchronization."""

LAYER = "training"
SOURCE = "program_span"
UNIT = "ms/frame"
MOVES = "rays_per_s"
SPANS = {"train_frame": "cache.train_frame"}


def read(t):
    ms = t.spans["train_frame"]
    return sum(ms) / t.frames if ms else None
