"""The share of the traced frames' wall time in which no device operation
ran: 100 x (1 - the union of the device intervals over the wall time)."""

LAYER = "device (H100)"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "rays_per_s"


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.wall_s) if t.device else None
