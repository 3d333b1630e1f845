"""Milliseconds a frame in the ReSTIR frame's shading (`_shade`): the K1/K2
shadow tracks and the 8-step transmittance at the V - 1 vertices past the
first: the benchmark's span around the port's stage function, timed by CUDA
events recorded at its entry and its return, with no synchronization."""

LAYER = "ReSTIR shading"
SOURCE = "program_span"
UNIT = "ms/frame"
MOVES = "rays_per_s"
SPANS = {"restir_shade": "nrc_hpm_tpu_torch.models.restir._shade"}


def read(t):
    ms = t.spans["restir_shade"]
    return sum(ms) / t.frames if ms else None
