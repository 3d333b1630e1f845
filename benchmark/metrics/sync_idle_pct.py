"""The share of the traced wall time in which the device sat idle at a
host sync: 100 x the length of the device's idle gaps that hold the end
of a ``nrc.sync`` span (the host's wait, on the profiler's clock), over
the traced frames' wall time."""

import bisect

from harness.program import device_interval, traced_frames
from harness.trace import idle_gaps

LAYER = "frame loop, host"
SOURCE = "program_span"
UNIT = "%"
MOVES = "rays_per_s"


def read(t):
    frames = traced_frames(t)
    if frames is None:
        return None
    ends = sorted(s.end_ns for f in frames for s in f.spans
                  if s.name == "nrc.sync")
    held = 0
    for a, b in idle_gaps(t.device, *device_interval(t)):
        k = bisect.bisect_left(ends, a)
        if k < len(ends) and ends[k] < b:
            held += b - a
    return 100.0 * held / 1e9 / t.wall_s
