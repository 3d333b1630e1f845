"""The ReSTIR reuse passes' share of their roofline: the least bytes that
temporal and spatial reuse must move (``rooflines/restir_reuse.py``, at
the sizes of the program's ``restir.temporal`` and ``restir.spatial`` spans
in the traced frames) over the card's bandwidth, over the two stages' time
on the device (the benchmark's spans around ``_temporal_reuse`` and
``_spatial_reuse``, CUDA events at their entry and return).  The bytes
count the work, not the kernels that do it."""

from harness import registry
from harness.peaks import bound_s
from harness.program import traced_frames

LAYER = "ReSTIR reuse"
SOURCE = "program_span"
UNIT = "%"
MOVES = "rays_per_s"
SPANS = {"restir_temporal": "nrc_hpm_tpu_torch.models.restir._temporal_reuse",
         "restir_spatial": "nrc_hpm_tpu_torch.models.restir._spatial_reuse"}


def read(t):
    frames = traced_frames(t)
    ms = t.spans["restir_temporal"] + t.spans["restir_spatial"]
    if frames is None or not ms:
        return None
    r = registry.roofline("restir_reuse", t.base)
    n_bytes = sum(r.cost(s.name, **s.attrs)["n_bytes"] for f in frames
                  for s in f.spans if s.name in r.STAGES)
    return 100.0 * bound_s(n_bytes) / (sum(ms) / 1e3) if n_bytes else None
