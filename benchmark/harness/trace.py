"""Reading the device trace of ``torch.profiler``: the device operations'
intervals, the union of them (busy time), the benchmark's host spans
(``record_function`` annotations) and the breakdown of the traced frames.
"""

from __future__ import annotations

import collections


def trace_events(prof):
    """(device operations, host annotations): lists of (name, start_ns,
    end_ns), from the profiler's raw events (the device's kernels, copies
    and sets; the benchmark's ``record_function`` spans)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.is_user_annotation():
            if e.device_type() != cuda:
                spans.append(row)
        elif e.device_type() == cuda:
            device.append(row)
    return device, spans


def union_ns(intervals) -> int:
    """Nanoseconds in which at least one interval runs."""
    total, end = 0, float("-inf")
    for a, b in sorted((a, b) for _, a, b in intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return int(total)


def idle_gaps(intervals, lo: int, hi: int):
    """(start, end) of the device's idle gaps inside [lo, hi]."""
    gaps, end = [], lo
    for a, b in sorted((a, b) for _, a, b in intervals):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


def span_at(spans, t: int, default: str) -> str:
    """The innermost host span open at ``t`` (the shortest one that holds
    it), or ``default``."""
    best = None
    for name, a, b in spans:
        if a <= t < b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return default if best is None else best[0]


def breakdown(device, spans, lo: int, hi: int, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    longest idle gaps labelled by the host span they fell in (seconds)."""
    by_name = collections.Counter()
    for name, a, b in device:
        by_name[name] += b - a
    ops = [[name, ns / 1e9] for name, ns in by_name.most_common(top)]
    gaps = sorted(idle_gaps(device, lo, hi), key=lambda g: g[0] - g[1])
    labelled = [[span_at(spans, (a + b) // 2, "frame"), (b - a) / 1e9]
                for a, b in gaps[:top]]
    return {"device_ops": ops, "idle_gaps": labelled}
