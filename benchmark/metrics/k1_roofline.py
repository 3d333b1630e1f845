"""K1's share of its roofline: the summed bound of each launch in the
traced frames (``rooflines/k1.py`` at the call's lanes, events and macro
table) over K1's device time in the trace."""

LAYER = "K1 (pw_events_kernel)"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "rays_per_s"
ROOFLINES = ["k1"]


def read(t):
    return t.roofline("k1")
