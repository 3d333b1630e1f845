"""Milliseconds a frame in the ReSTIR frame's spatial reuse
(`_spatial_reuse`): the stream over the K^2 - 1 neighbours x V - 1 suffixes
and the splice: the benchmark's span around the port's stage function, timed
by CUDA events recorded at its entry and its return, with no
synchronization."""

LAYER = "ReSTIR reuse"
SOURCE = "program_span"
UNIT = "ms/frame"
MOVES = "rays_per_s"
SPANS = {"restir_spatial": "nrc_hpm_tpu_torch.models.restir._spatial_reuse"}


def read(t):
    ms = t.spans["restir_spatial"]
    return sum(ms) / t.frames if ms else None
