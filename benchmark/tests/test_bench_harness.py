"""The yardstick's arithmetic and the benchmark's files, on the CPU."""

import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from harness import peaks, registry, trace, window
from harness.cell import Traced

BENCH = registry.HERE
ROOT = registry.ROOT
NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$"


class Clock:
    """A host clock that each frame advances by its own duration."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _window(durations, seconds):
    clock = Clock()
    it = iter(durations)

    def frame(i):
        clock.t += next(it)
    return window.run_window(frame, seconds, clock=clock)


def test_rate_is_over_the_whole_window():
    w = _window([0.5] * 30, 10.0)
    assert w.completed == 20 and len(w.ends) == 20
    assert w.rate(1000) == pytest.approx(1000 * 20 / 10.0)


def test_frame_running_at_the_close_is_not_counted():
    w = _window([3.0, 3.0, 3.0, 3.0], 10.0)
    assert len(w.ends) == 4 and w.completed == 3
    assert w.rate(1) == pytest.approx(3 / 9.0)
    assert w.frame_s == [3.0, 3.0, 3.0]


def test_p95_is_over_all_frames():
    w = _window([0.01 * (i + 1) for i in range(100)] + [100.0], 50.5 + 1e-6)
    assert w.completed == 100
    ms = [1e3 * s for s in w.frame_s]
    assert window.percentile(ms, 95) == pytest.approx(950.5)
    assert window.percentile([5.0], 95) == 5.0


def test_a_stall_moves_rate_and_tail():
    """One stall takes its time from the rate; stalls in more than a
    twentieth of the frames lift the tail."""
    steady = _window([0.05] * 400, 10.0)
    stalled = _window([0.05] * 100 + [2.0] + [0.05] * 300, 10.0)
    assert stalled.rate(1) < steady.rate(1) * 0.85
    p_steady = window.percentile([1e3 * s for s in steady.frame_s], 95)
    p_stalled = window.percentile([1e3 * s for s in stalled.frame_s], 95)
    assert p_steady == pytest.approx(50.0)
    assert p_stalled == pytest.approx(50.0)      # one stall of 161 frames
    many = _window(([0.05] * 9 + [1.0]) * 40, 10.0)
    assert window.percentile([1e3 * s for s in many.frame_s], 95) > 500


def test_window_runs_on_to_its_least_frames_and_counts_none_past_the_close():
    clock = Clock()

    def frame(i):
        clock.t += 3.0
    w = window.run_window(frame, 5.0, clock=clock, min_frames=4)
    assert len(w.ends) == 4 and w.completed == 1


def test_spans_add_no_synchronization():
    """A span times its call (by the host clock on the CPU) and calls
    nothing else around it."""
    from harness.probes import Probes

    class Box:
        def work(self, x):
            return x + 1

    box = Box()
    p = Probes(box, {"work": "work"}, {}, {}, cuda=False)
    p.install()
    assert box.work(1) == 2 and box.work(2) == 3
    p.remove()
    assert len(p.spans["work"]) == 2 and min(p.spans["work"]) >= 0
    assert "work" not in vars(box)


def test_a_state_crosses_sides_by_class_name():
    import dataclasses
    import types

    @dataclasses.dataclass
    class Ring:
        head: int

    @dataclasses.dataclass
    class State:
        ring: Ring
        key: int

    other = types.SimpleNamespace(
        Ring=dataclasses.make_dataclass("Ring", ["head"]),
        State=dataclasses.make_dataclass("State", ["ring", "key"]))
    from harness.sides import convert
    st = convert(State(ring=Ring(head=3), key=5), other)
    assert type(st) is other.State and type(st.ring) is other.Ring
    assert st.ring.head == 3 and st.key == 5


def test_busy_is_the_union_of_device_intervals():
    ops = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 22, 25),
           ("e", 40, 41)]
    assert trace.union_ns(ops) == 15 + 10 + 1
    assert trace.union_ns([]) == 0
    assert trace.idle_gaps(ops, 0, 50) == [(15, 20), (30, 40), (41, 50)]


def test_breakdown_labels_gaps_by_innermost_span():
    ops = [("k1", 0, 10), ("k1", 30, 40), ("k3", 45, 50)]
    spans = [("train_set", 0, 100), ("primary", 12, 35)]
    b = trace.breakdown(ops, spans, 0, 50)
    assert b["device_ops"] == [["k1", 20e-9], ["k3", 5e-9]]
    assert b["idle_gaps"] == [["primary", 20e-9], ["train_set", 5e-9]]


def test_k1_roofline_reproduces_the_bound():
    k1 = registry.roofline("k1")
    c = k1.cost(n=1 << 20, S=16, n_macro=3520)
    assert 1e3 * peaks.bound_s(**c) == pytest.approx(0.095, abs=5e-4)


def test_k3_roofline_reproduces_the_bound():
    k3 = registry.roofline("k3")
    shapes = [(48, 64)] + [(64, 64)] * 5 + [(64, 3)]
    c = k3.cost(n=1 << 20, table_words=7114752, shapes=shapes, levels=16)
    assert 1e3 * peaks.bound_s(**c) == pytest.approx(0.050, abs=5e-4)
    assert c["bf16_ops"] / (1 << 20) == 47488


def _traced(**kw):
    base = dict(frames=2, wall_s=1.0, device=[("x", 0, 10)], busy_s=0.1, spans={}, calls={}, counts={}, base=BENCH)
    base.update(kw)
    return Traced(**base)


def test_frame_mfu_counts_the_mlp_at_app_config():
    from reference.cache import NeuralRadianceCache
    from reference.config import AppConfig
    import torch

    cache = NeuralRadianceCache(AppConfig())
    st = cache.init_state(torch.tensor([0, 1], dtype=torch.int64), "cpu")
    m = registry.metric("frame_mfu_pct")
    n_inf, shapes = m.CALLS["mlp_infer"][1](st, torch.zeros(1000, 5))
    assert n_inf == 1000 and peaks.mlp_ops(shapes) == 47488
    n_tr, _ = m.CALLS["mlp_train"][1](st, torch.zeros(1 << 16, 5), None)
    t = _traced(calls={"mlp_infer": [(n_inf, shapes)],
                       "mlp_train": [(n_tr, shapes)]})
    ops = 47488 * (1000 + 3 * (1 << 16))
    assert m.read(t) == pytest.approx(100 * ops / peaks.BF16_OPS_S)
    assert m.read(_traced(calls={"mlp_infer": [], "mlp_train": []})) is None


def test_rooflines_and_metrics_read_nothing_when_absent():
    t = _traced(device=[], busy_s=0.0, calls={"roofline.k1": []},
                spans={"primary": []}, counts={"k1": 0, "k2": 0})
    for name in ("k1_roofline", "primary_ms", "tracker_launches_per_frame",
                 "device_idle_pct", "device_ops_per_frame"):
        assert registry.metric(name).read(t) is None


def test_k1_roofline_share_from_calls():
    t = _traced(device=[("pw_events_kernel", 0, 200_000)],
                calls={"roofline.k1": [dict(n=1 << 20, S=16,
                                            n_macro=3520)]})
    share = registry.metric("k1_roofline").read(t)
    assert share == pytest.approx(100 * 0.0952 / 0.2, rel=1e-2)


def _digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(folder.rglob("*")) if p.is_file()
        and "__pycache__" not in p.parts}


def test_new_cell_parts_are_found_by_name(tmp_path):
    base = tmp_path / "benchmark"
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns(
        "__pycache__"))
    before = _digest(base)
    (base / "configs" / "nrc-p3-1080p.json").write_text(json.dumps(
        {"source": "x", "app": {"scene": {"id": 3}}, "cloud": {}}))
    (base / "traffic" / "moving.json").write_text(json.dumps(
        {"renderer": "renderer.NrcRenderer", "camera": "orbit",
         "setup": [], "window": {"train": True}}))
    (base / "cameras" / "orbit.py").write_text(
        'def make(camera_mod, device):\n'
        '    return lambda frame: ("orbit", frame)\n')
    (base / "metrics" / "ring_fill.py").write_text(
        'LAYER = "ring"\nSOURCE = "program_counter"\nUNIT = "%"\n'
        'MOVES = "rays_per_s"\n\ndef read(t):\n    return 50.0\n')
    (base / "rooflines" / "k7.py").write_text(
        'KERNEL = "hash_grid_train_fwd_kernel"\n'
        'WRAPS = ("nrc_hpm_tpu_torch.ops.hash_grid_train", '
        '"hash_grid_train_fwd")\n'
        'def sizes(*a, **kw):\n    return dict(n=1)\n'
        'def cost(n):\n    return dict(n_bytes=n)\n')
    assert registry.config("nrc-p3-1080p", base)["app"]["scene"]["id"] == 3
    assert registry.traffic("moving", base)["camera"] == "orbit"
    assert registry.camera("orbit", base).make(None, "cpu")(7) == ("orbit",
                                                                7)
    assert registry.metric("ring_fill", base).read(None) == 50.0
    assert registry.roofline("k7", base).cost(n=3) == {"n_bytes": 3}
    bench = {"per_layer": [{"name": "ring_fill", "workloads": ["p3"]},
                           {"name": "device_idle_pct"}]}
    assert registry.cell_metrics(bench, "p3", "per_layer") == [
        "ring_fill", "device_idle_pct"]
    after = _digest(base)
    assert {k: v for k, v in after.items() if k in before} == before


def test_benchmark_json_follows_the_files():
    import re
    bench = registry.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert re.match(NAME, c["name"]) and c["reduced"] == []
        assert (ROOT / c["file"]).is_file()
        assert registry.config(c["name"])["source"].startswith(
            c["source"].split(" ")[0])
    cells = [w["name"] for w in bench["workloads"]]
    assert cells[0] == "p4-online" and len(set(cells)) == len(cells)
    for w in bench["workloads"]:
        assert w["config"] in names and w["chips"] == 1
        registry.traffic(w["traffic"])
        limits = registry.checks(w["name"])
        assert limits and all(v > 0 for v in limits.values())
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert e2e == {"rays_per_s", "frame_ms_p95", "setup_s"}
    for m in bench["end_to_end"]:
        assert (BENCH / "end_to_end" / f"{m['name']}.py").is_file()
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        mod = registry.metric(m["name"])
        assert (m["layer"], m["source"], m["unit"], m["moves"]) == (
            mod.LAYER, mod.SOURCE, mod.UNIT, mod.MOVES)
        assert m["moves"] == "rays_per_s"
        assert set(m["workloads"]) <= set(cells)
        for r in getattr(mod, "ROOFLINES", []):
            registry.roofline(r)


FORBIDDEN = {"jax", "jaxlib", "flax", "nrc_hpm_tpu"}


def _top_level_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=BENCH, capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONPATH": f"{BENCH}{os.pathsep}{ROOT}"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_neither_the_port_nor_jax():
    mods = _top_level_after(
        "import reference.renderer, reference.cache, reference.integrator")
    assert not mods & (FORBIDDEN | {"nrc_hpm_tpu_torch"})


def test_harness_imports_no_jax():
    mods = _top_level_after(
        "import harness.cell, harness.sides, harness.faults\n"
        "from harness import sides\nsides.modules('nrc_hpm_tpu_torch')\n"
        "import run, control")
    assert "nrc_hpm_tpu_torch" in mods
    assert not mods & FORBIDDEN
    assert not mods & {"bench_torch", "chip_smoke", "quality_torch",
                       "kernel_ab"}


def test_run_without_a_card_fails_and_prints_no_result():
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "p4-online",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert not res.stdout.strip()
