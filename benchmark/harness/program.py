"""The program's own records of the traced frames.

While a ``torch.profiler`` session records, ``nrc_hpm_tpu_torch.profiler``
keeps each frame's spans, host syncs and regions, stamped with
``time.time_ns()``: the clock the profiler stamps the device's operations
with.  The traced frames' records are those whose ``nrc.frame`` span
overlaps the device interval of the traced run.
"""

from __future__ import annotations


def device_interval(t):
    """(earliest start, latest end) of the device operations in ``t``."""
    return (min(a for _, a, _ in t.device), max(b for _, _, b in t.device))


def traced_frames(t):
    """The program's frames whose ``nrc.frame`` span overlaps the device
    interval of ``t``; None without device operations, where the program
    keeps no frames, or unless exactly ``t.frames`` are found (which
    tests that both sides share one clock)."""
    if not t.device:
        return None
    try:
        from nrc_hpm_tpu_torch import profiler
        frames = profiler.frames()
    except (ImportError, AttributeError):
        return None
    lo, hi = device_interval(t)
    found = [f for f in frames
             if f.root.start_ns < hi and f.root.end_ns > lo]
    return found if len(found) == t.frames else None
