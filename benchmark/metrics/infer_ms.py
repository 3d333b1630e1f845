"""Milliseconds a frame in the cache's inference on the scattered pixels
(`NrcRenderer.infer` -> `cache.infer`, K3): the benchmark's span around
the call, timed by CUDA events recorded at its entry and its return, with
no synchronization."""

LAYER = "inference"
SOURCE = "program_span"
UNIT = "ms/frame"
MOVES = "rays_per_s"
SPANS = {"infer": "infer"}


def read(t):
    ms = t.spans["infer"]
    return sum(ms) / t.frames if ms else None
