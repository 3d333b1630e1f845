"""Milliseconds a frame in the ReSTIR frame's temporal reuse
(`_temporal_reuse`): the stream over the ring's T slots x V - 1 suffixes, the
ring's write and the splice: the benchmark's span around the port's stage
function, timed by CUDA events recorded at its entry and its return, with no
synchronization."""

LAYER = "ReSTIR reuse"
SOURCE = "program_span"
UNIT = "ms/frame"
MOVES = "rays_per_s"
SPANS = {"restir_temporal": "nrc_hpm_tpu_torch.models.restir._temporal_reuse"}


def read(t):
    ms = t.spans["restir_temporal"]
    return sum(ms) / t.frames if ms else None
