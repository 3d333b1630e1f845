"""Milliseconds a frame in the ReSTIR frame's local init (`_local_init`): V
candidate vertices a pixel, each with a random probe direction: the
benchmark's span around the port's stage function, timed by CUDA events
recorded at its entry and its return, with no synchronization."""

LAYER = "ReSTIR local init"
SOURCE = "program_span"
UNIT = "ms/frame"
MOVES = "rays_per_s"
SPANS = {"restir_local": "nrc_hpm_tpu_torch.models.restir._local_init"}


def read(t):
    ms = t.spans["restir_local"]
    return sum(ms) / t.frames if ms else None
