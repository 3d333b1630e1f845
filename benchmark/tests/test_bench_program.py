"""The readers of the program's own records (``harness/program.py`` and
the metrics that read it) on a synthetic trace and synthetic frames of
``nrc_hpm_tpu_torch.profiler``: the frames chosen by the device interval,
an idle gap that holds a sync's end, and nothing read where the count of
frames found differs from the traced frames'."""

import pytest

from harness import registry
from harness.cell import Traced
from nrc_hpm_tpu_torch import profiler

READERS = ("host_syncs_per_frame", "sync_idle_pct", "rng_host_ms")


def _frame(start, end, syncs=(), rng_ns=0):
    """A frame over [start, end] with ``nrc.sync`` spans at ``syncs``
    ((start, end) pairs), one sync counted per span."""
    root = profiler.Span(profiler.FRAME, start, end, id=1)
    f = profiler.Frame(root=root)
    for k, (a, b) in enumerate(syncs):
        f.spans.append(profiler.Span(profiler.SYNC, a, b, id=2 + k,
                                     parent=1, attrs={"site": "x"}))
        f.syncs["x"] += 1
    f.spans.append(root)
    if rng_ns:
        f.regions["rng"] = [rng_ns, 10]
    return f


def _traced(device, frames, wall_s=1e-6):
    return Traced(frames=frames, wall_s=wall_s, device=device,
                  busy_s=0.0, spans={}, calls={}, counts={},
                  base=registry.HERE)


def _read(name, t):
    return registry.metric(name).read(t)


def test_frames_are_chosen_by_the_device_interval(monkeypatch):
    kept = [_frame(0, 900, [(10, 20)]),                  # before the trace
            _frame(950, 2500, [(1000, 1100)] * 3, 4_000_000),
            _frame(2600, 5500, [(3000, 3100)], 2_000_000),
            _frame(5100, 6000, [(5200, 5300)] * 5)]      # after the trace
    monkeypatch.setattr(profiler, "frames", lambda: kept)
    t = _traced([("k", 1000, 2000), ("k", 3000, 5000)], frames=2)
    assert _read("host_syncs_per_frame", t) == 2.0
    assert _read("rng_host_ms", t) == 3.0


def test_an_idle_gap_counts_where_it_holds_a_sync_s_end(monkeypatch):
    # device busy [0, 100), [300, 400), [700, 1000): gaps 100-300, 400-700;
    # one sync ends inside an operation, one inside the second gap
    kept = [_frame(0, 1000, [(50, 350), (380, 500)])]
    monkeypatch.setattr(profiler, "frames", lambda: kept)
    t = _traced([("a", 0, 100), ("b", 300, 400), ("c", 700, 1000)],
                frames=1, wall_s=1e-6)
    assert _read("sync_idle_pct", t) == pytest.approx(30.0)
    kept[0] = _frame(0, 1000, [(50, 150), (380, 500)])
    assert _read("sync_idle_pct", t) == pytest.approx(50.0)


def test_nothing_is_read_unless_every_traced_frame_is_found(monkeypatch):
    kept = [_frame(0, 1000, [(50, 150)], 1000)]
    monkeypatch.setattr(profiler, "frames", lambda: kept)
    device = [("a", 0, 100), ("b", 300, 1000)]
    for name in READERS:
        assert _read(name, _traced(device, frames=1)) is not None
        assert _read(name, _traced(device, frames=2)) is None
        assert _read(name, _traced([], frames=1)) is None


def test_a_program_without_frames_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiler, "frames")
    t = _traced([("a", 0, 100)], frames=1)
    for name in READERS:
        assert _read(name, t) is None
