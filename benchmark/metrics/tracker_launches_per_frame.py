"""Launches of the trackers' kernels K1 (``pw_events``) and K2
(``pw_profile``) a frame, from the port's own launch counters."""

LAYER = "trackers"
SOURCE = "program_counter"
UNIT = "launches/frame"
MOVES = "rays_per_s"
COUNTERS = {"k1": "nrc_hpm_tpu_torch.ops.pw_kernels.pw_events",
            "k2": "nrc_hpm_tpu_torch.ops.pw_kernels.pw_profile"}


def read(t):
    n = t.counts["k1"] + t.counts["k2"]
    return n / t.frames if n else None
