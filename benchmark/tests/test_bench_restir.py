"""The cell ``restir-p4`` (``RestirRenderer`` at 1080p on preset 4) on the
CPU: its parts found by name, a small run correct, its control and the
altered image refused by its limits, the reuse roofline's arithmetic, and
the reference's ReSTIR module free of the port and of JAX."""

import time

import pytest

from conftest import SMALL
from harness import cell, faults, peaks, registry
from harness.cell import Traced
from nrc_hpm_tpu_torch import profiler
from test_bench_harness import FORBIDDEN, _top_level_after

CELL = "restir-p4"
SEED = 2305843009
METRICS = ("restir_local_ms", "restir_temporal_ms", "restir_spatial_ms",
           "restir_shade_ms", "restir_reuse_roofline")


def test_the_cell_s_parts_are_found_by_name():
    bench = registry.load_benchmark()
    w = registry.workload(bench, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("restir-p4-1080p",
                                                       "restir", 1)
    cfg = registry.config(w["config"])
    assert cfg["app"]["render_width"] == 1920 and "restir" not in cfg["app"]
    traffic = registry.traffic(w["traffic"])
    assert traffic["renderer"] == "models.restir.RestirRenderer"
    assert set(registry.checks(CELL)) == {"start.image", "window.image"}
    per_layer = registry.cell_metrics(bench, CELL, "per_layer")
    assert set(METRICS) <= set(per_layer)
    assert registry.cell_metrics(bench, CELL, "end_to_end") == [
        "rays_per_s", "setup_s"]
    assert registry.roofline("restir_reuse").STAGES == (
        "restir.temporal", "restir.spatial")


def _verdict(**kw):
    run = cell.run(CELL, SEED, 0.5, False, "cpu", time.perf_counter(),
                   overrides=SMALL, **kw)
    return cell.verdict(run["numbers"], registry.checks(CELL))


CASES = [("sound", {}),
         ("control", dict(program="reference", fault=faults.lowp_paths)),
         ("altered", dict(fault=faults.altered))]


@pytest.mark.parametrize("case,kw", CASES, ids=[c for c, _ in CASES])
def test_correct_separates_a_sound_run_from_control_and_fault(case, kw):
    correct, rows = _verdict(**kw)
    assert correct == (case == "sound"), rows
    if case != "sound":
        assert all(v > lim for _, v, lim in rows), rows


def test_reuse_roofline_reproduces_the_bound():
    """At 1080p, V = 8, T = 2: 988 and 420 bytes a lane, 0.8715 ms at
    3.35 TB/s."""
    r = registry.roofline("restir_reuse")
    sizes = dict(lanes=1920 * 1080, V=8, T=2, K=3)
    per_lane = [r.cost(s, **sizes)["n_bytes"] / sizes["lanes"]
                for s in r.STAGES]
    assert per_lane == [988, 420]
    n_bytes = sum(r.cost(s, **sizes)["n_bytes"] for s in r.STAGES)
    assert 1e3 * peaks.bound_s(n_bytes) == pytest.approx(0.8715, abs=5e-5)


def _frame(start, end, sizes):
    root = profiler.Span(profiler.FRAME, start, end, id=1)
    f = profiler.Frame(root=root)
    for k, name in enumerate(("restir.local_init", "restir.temporal",
                              "restir.spatial", "restir.shade")):
        f.spans.append(profiler.Span(name, start + k, start + k + 1,
                                     id=2 + k, parent=1, attrs=dict(sizes)))
    f.spans.append(root)
    return f


def test_reuse_roofline_share_from_spans(monkeypatch):
    """Two traced frames at 1080p, the reuse stages 5 + 3 ms each: the
    bound over their time; nothing read where the program kept no ReSTIR
    frame or the stages' spans are empty."""
    sizes = dict(lanes=1920 * 1080, V=8, T=2, K=3, candidates=14)
    kept = [_frame(0, 1000, sizes), _frame(1000, 2000, sizes)]
    monkeypatch.setattr(profiler, "frames", lambda: kept)
    spans = {"restir_temporal": [5.0, 5.0], "restir_spatial": [3.0, 3.0],
             "restir_local": [1.0, 1.0], "restir_shade": [2.0, 4.0]}
    t = Traced(frames=2, wall_s=1.0, device=[("k", 10, 1990)], busy_s=0.5,
               spans=spans, calls={}, counts={}, base=registry.HERE)
    m = registry.metric("restir_reuse_roofline")
    assert m.read(t) == pytest.approx(100 * 0.8715309 / 8.0, rel=1e-6)
    assert registry.metric("restir_temporal_ms").read(t) == 5.0
    assert registry.metric("restir_shade_ms").read(t) == 3.0
    t.frames = 3
    assert m.read(t) is None
    empty = Traced(frames=2, wall_s=1.0, device=[("k", 10, 1990)],
                   busy_s=0.5, spans={k: [] for k in spans}, calls={},
                   counts={}, base=registry.HERE)
    for name in METRICS:
        assert registry.metric(name).read(empty) is None, name


def test_the_reference_s_restir_imports_neither_the_port_nor_jax():
    mods = _top_level_after("import reference.models.restir")
    assert not mods & (FORBIDDEN | {"nrc_hpm_tpu_torch"})
