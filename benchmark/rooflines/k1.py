"""K1, ``pw_events_kernel``: one tracking segment's coarse profile, S event
draws and their inversion on n lanes.

Bytes: per lane the 32 bytes of start/direction/tmax/seed and K1's e_last
read, 16 bytes per event (lin, t, c_at, sres) and e_new/rtot/ctot
written; the packed macro table read once.  Operations (float32): 33
macro lookups (box coordinates, bounds tests, clamp, index, decode: 30
each), 32 profile intervals (point, max/min, two running sums: 14 each)
and S events (hash, log1p, walk, inversion, fine cell: 60 each) a lane,
counted from ``nrc_hpm_tpu_torch/csrc/pw_kernels.cu``.
"""

KERNEL = "pw_events_kernel"
# the traced run records every call of this function of the port
WRAPS = ("nrc_hpm_tpu_torch.transmittance", "pw_events")
LOOKUP_OPS, INTERVAL_OPS, EVENT_OPS = 30, 14, 60


def sizes(vol, start, direction, tmax, seed, e_last, e_base, S=8, *rest,
          **kw):
    """The sizes the cost needs, from one call's arguments."""
    return dict(n=int(tmax.shape[0]), S=int(kw.get("S", S)),
                n_macro=int(vol.macro_packed.numel()))


def cost(n: int, S: int, n_macro: int) -> dict:
    """Bytes and operations of one launch."""
    per_lane = 32 + 4 + 16 * S + 12
    ops = 33 * LOOKUP_OPS + 32 * INTERVAL_OPS + S * EVENT_OPS
    return dict(n_bytes=n * per_lane + 4 * n_macro, f32_ops=n * ops)
