"""Device operations (kernels, copies, sets) a frame: the frame loop's
launch count, which a host-bound frame's time follows."""

LAYER = "frame loop, host"
SOURCE = "device_trace"
UNIT = "ops/frame"
MOVES = "rays_per_s"


def read(t):
    return len(t.device) / t.frames if t.device else None
