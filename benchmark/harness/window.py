"""The measured window: a closed loop of frames and its arithmetic.

A rate is the work of every frame that completed inside the window over
the time from the window's start to the end of the last of them; a tail is
taken over all of those frames.  A frame still running when the window
closes is not counted, and neither is its time.
"""

from __future__ import annotations

import dataclasses
import math
import time


@dataclasses.dataclass
class Window:
    start: float            # host clock at the window's start (s)
    seconds: float          # the window's length
    ends: list              # host clock at the end of each frame run (s)

    @property
    def close(self) -> float:
        return self.start + self.seconds

    @property
    def frame_s(self) -> list:
        """The times of the frames completed inside the window."""
        edges = [self.start] + self.ends
        return [b - a for a, b in zip(edges, edges[1:]) if b <= self.close]

    @property
    def completed(self) -> int:
        return len(self.frame_s)

    def rate(self, work_per_frame: float) -> float:
        """Work of the completed frames per second, from the window's start
        to the end of the last completed frame."""
        n = self.completed
        if n == 0:
            raise RuntimeError("no frame completed inside the window")
        return work_per_frame * n / (self.ends[n - 1] - self.start)


def run_window(frame, seconds: float, clock=time.perf_counter,
               on_frame=None, min_frames: int = 0) -> Window:
    """Call ``frame(i)`` (which returns once its work is done on the
    device) until the window of ``seconds`` has closed and at least
    ``min_frames`` frames have run (those past the close count for
    nothing); ``on_frame(i)``, when given, runs before frame i outside the
    frame's time."""
    ends = []
    start = clock()
    i = 0
    while clock() < start + seconds or i < min_frames:
        if on_frame is not None:
            on_frame(i)
        frame(i)
        ends.append(clock())
        i += 1
    return Window(start=start, seconds=seconds, ends=ends)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all ``values``, linear between the
    closest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

