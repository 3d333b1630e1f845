"""Milliseconds a frame in the primary pass (`NrcRenderer.primary` ->
`integrator.trace_primary`): the benchmark's span around the call, timed
by CUDA events recorded at its entry and its return, with no
synchronization."""

LAYER = "primary trace"
SOURCE = "program_span"
UNIT = "ms/frame"
MOVES = "rays_per_s"
SPANS = {"primary": "primary"}


def read(t):
    ms = t.spans["primary"]
    return sum(ms) / t.frames if ms else None
