"""quality_torch.py, the port's image-quality studies, on the CPU.

``summarize`` against ``experiments/summarize_run.py`` on the checked-in
convergence runs, every printed number; the golden cache's key changes
with each input (the volume's bytes included), the same inputs do not
render again, and a cut build resumes to the uncut golden bit for bit;
``app_argv`` gives the app the configuration it was asked for; each study
runs end to end at 16x9 with ``device="cpu"`` on a small thin cloud and a
small network (the app's scored frames pooled to an 8x5 golden), and its record has its keys; a failing run fails the study; and
without a card ``main()`` returns 1 before any work.  The scene presets:
``preset_scene`` builds each preset's volume at its own density; the
gate arithmetic by hand; ``gates`` and ``scenes`` at 16x9 with every
section and verdict of their records; a broken gate fails the study and
``main``.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import quality_torch as qt
from nrc_hpm_tpu_torch.config import AppConfig, EncodingConfig, SceneConfig
from nrc_hpm_tpu_torch.reference import generate_golden
from nrc_hpm_tpu_torch.renderer import McRenderer
from nrc_hpm_tpu_torch.utils.exr import read_exr_rgba
from nrc_hpm_tpu_torch.utils.procedural import cloud_density
from nrc_hpm_tpu_torch.volume import Volume

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 16, 9
SMALL_CLOUD = (40, 27, 48)
# a 16x2 MLP on 4 hash levels, 2 x 2^6 train samples of 4 bounces
SMALL = AppConfig(encoding=EncodingConfig(n_levels=4, log2_hashmap_size=12),
                  nn_width=16, nn_depth=2, log2_train_batch_size=6,
                  train_batch_count=2, train_ray_length=4)
SMALL_POINTS = (("16x9 train 2x2^5", W, H, 2, 5, 1, 12),
                ("16x9 train 1x2^6 every 2", W, H, 1, 6, 2, 12),
                ("16x9 train 2x2^5 tables 2^10", W, H, 2, 5, 1, 10))


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """The golden cache and the app's directories under tmp_path."""
    monkeypatch.setattr(qt, "GOLDEN_CACHE", str(tmp_path / "golden_cache"))
    monkeypatch.setattr(qt, "RUN_DIR", str(tmp_path / "quality_run"))
    return tmp_path


def _density(seed=0):
    """A thin small cloud: the plain trackers' time on the CPU follows the
    tracking events."""
    return cloud_density(seed, SMALL_CLOUD) * np.float32(0.2)


def _vol(seed=0):
    return Volume.from_dense(_density(seed), 0.6, 0.8, device="cpu")


# -- summarize ---------------------------------------------------------------

def _script_lines(run, tail_n):
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "experiments", "summarize_run.py"),
         os.path.join(ROOT, "output", run), str(tail_n)],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.split("\n\n")[0].splitlines()


def _lines(s):
    """``s`` printed as summarize_run.py prints its summary."""
    n, t = s["frames"], s["tail_n"]
    return [
        f"frames with comparison: {n}",
        f"NRC beats MC on {s['nrc_wins']}/{n} frames (first win: frame "
        f"{s['first_win']})",
        f"tail({t}) NRC  mse {s['nrc_mse']:.4f}  relBias "
        f"{s['nrc_rel_bias']:+.4f}  cv {s['nrc_cv']:.3f}",
        f"tail({t}) MC   mse {s['mc_mse']:.4f}  relBias "
        f"{s['mc_rel_bias']:+.4f}  cv {s['mc_cv']:.3f}",
        f"tail NRC/MC mse ratio: {s['mse_ratio']:.3f}",
        f"mean frame_time_ms (incl. both renderers + per-frame compares): "
        f"{s['mean_frame_time_ms']:.0f}",
        f"loss: first {s['loss_first']:.3f}  last {s['loss_last']:.3f}"]


def _rows(run):
    with open(os.path.join(ROOT, "output", run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("run,tail_n", [("convergence_r3", 16),
                                        ("convergence_s4_r5", 8)])
def test_summarize_matches_the_script(run, tail_n):
    assert _lines(qt.summarize(_rows(run), tail_n)) == \
        _script_lines(run, tail_n)


def test_summarize_round_5():
    s = qt.summarize(_rows("convergence_s4_r5"), 8)
    assert (s["frames"], s["nrc_wins"], s["first_win"]) == (24, 24, 0)
    got = [round(s[k], n) for k, n in (
        ("nrc_mse", 4), ("nrc_rel_bias", 4), ("nrc_cv", 3), ("mc_mse", 4),
        ("mc_rel_bias", 4), ("mc_cv", 3), ("mse_ratio", 3))]
    assert got == [0.3656, -0.1066, 2.673, 0.6020, -0.0152, 3.080, 0.607]


def test_summarize_without_mc_or_rows():
    rows = [{"frame": i, "nrc": {"mse": 1.0 + i, "rel_bias": 0.0, "cv": 1.0}}
            for i in range(3)]
    s = qt.summarize(rows, 2)
    assert s["nrc_mse"] == 2.5 and s["nrc_wins"] == 0
    assert s["first_win"] is None and s["mc_mse"] is None
    assert s["mse_ratio"] is None and s["mean_frame_time_ms"] is None
    with pytest.raises(ValueError, match="no comparison rows"):
        qt.summarize([{"frame": 0, "loss": 1.0}])


# -- the golden cache ------------------------------------------------------------

def test_golden_key_follows_every_input():
    vol = _vol()
    args = (SMALL, vol, W, H, 4, 8, 7)
    base = qt.golden_key(*args)
    assert qt.golden_key(*args) == base
    flipped = _density().copy()
    flipped[20, 13, 24] = 0.0
    others = {
        "scene": (dataclasses.replace(SMALL, scene=SceneConfig.preset(0)),),
        "env_fixed16": (dataclasses.replace(SMALL, env_fixed16=True),),
        "max_track_steps": (dataclasses.replace(SMALL, max_track_steps=64),),
        "cloud seed": (SMALL, _vol(1)),
        "one voxel": (SMALL, Volume.from_dense(flipped, 0.6, 0.8,
                                               device="cpu")),
        "density factor": (SMALL, Volume.from_dense(_density(), 0.5, 0.8,
                                                    device="cpu")),
        "width": (SMALL, vol, W + 1), "height": (SMALL, vol, W, H + 1),
        "frames": (SMALL, vol, W, H, 5), "path": (SMALL, vol, W, H, 4, 16),
        "seed": (SMALL, vol, W, H, 4, 8, 8)}
    keys = {}
    for name, head in others.items():
        keys[name] = qt.golden_key(*head, *args[len(head):])
        assert keys[name] != base, name
    assert len(set(keys.values())) == len(keys)
    # the hash-table size decides nothing of the MC golden
    tuned = dataclasses.replace(SMALL, encoding=dataclasses.replace(
        SMALL.encoding, log2_hashmap_size=10))
    assert qt.golden_key(tuned, *args[1:]) == base


def test_same_inputs_do_not_render_again(cache, monkeypatch):
    calls = []

    def counted(*a, **kw):
        calls.append(kw["frames"])
        return generate_golden(*a, **kw)

    monkeypatch.setattr(qt, "generate_golden", counted)
    vol = _vol()
    g = qt.golden(SMALL, vol, W, H, 2, 4, device="cpu")
    assert g.image.shape == (H, W, 4) and np.isfinite(g.image).all()
    again = qt.golden(SMALL, vol, W, H, 2, 4, device="cpu")
    assert calls == [2]
    assert again.image.tobytes() == g.image.tobytes()
    qt.golden(SMALL, _vol(1), W, H, 2, 4, device="cpu")
    qt.golden(SMALL, vol, W, H, 3, 4, device="cpu")
    assert calls == [2, 2, 3]
    assert len(os.listdir(qt.GOLDEN_CACHE)) == 3
    # the golden compares a frame of another size by pooling
    big = np.repeat(np.repeat(g.image, 2, axis=0), 2, axis=1)
    res = g.compare(torch.as_tensor(big))
    assert res.mse == pytest.approx(0.0, abs=1e-12)


def test_cut_build_resumes(cache, monkeypatch):
    """A build cut after 2 of 4 frames resumes from its sidecar: 2 more
    frames, the uncut golden bit for bit."""
    vol = _vol()
    whole = generate_golden(SMALL, str(cache / "whole.exr"), vol, frames=4,
                            path_length=4, width=W, height=H, seed=7)

    def cut(*a, **kw):
        generate_golden(*a, **dict(kw, frames=2))
        raise KeyboardInterrupt

    monkeypatch.setattr(qt, "generate_golden", cut)
    with pytest.raises(KeyboardInterrupt):
        qt.golden_file(SMALL, vol, W, H, 4, 4, device="cpu")
    monkeypatch.setattr(qt, "generate_golden", generate_golden)
    steps = []
    step = McRenderer.step
    monkeypatch.setattr(McRenderer, "step", lambda self, s, c: steps.append(
        1) or step(self, s, c))
    path = qt.golden_file(SMALL, vol, W, H, 4, 4, device="cpu")
    assert len(steps) == 2
    assert read_exr_rgba(path).tobytes() == whole.tobytes()


# -- the app's arguments ------------------------------------------------------------

@pytest.mark.parametrize("cfg", [AppConfig(), AppConfig.tpu_tuned(), SMALL,
                                 dataclasses.replace(
                                     SMALL, env_fixed16=True,
                                     train_cache_bootstrap=True,
                                     train_target_clamp=16.0,
                                     primary_ray_prob=0.5)])
def test_app_argv_gives_the_app_its_config(cfg):
    from nrc_hpm_tpu_torch import app

    argv = qt.app_argv(cfg)
    assert app._config(app.build_argparser().parse_args(argv)) == cfg


def test_app_argv_refuses_what_the_app_cannot_run():
    with pytest.raises(ValueError, match="mlp_dtype"):
        qt.app_argv(dataclasses.replace(SMALL, mlp_dtype="float32"))


# -- the studies end to end ------------------------------------------------------

def _finite(rec, keys):
    for k in keys:
        assert isinstance(rec[k], float) and math.isfinite(rec[k]), k


SUMMARY = ("nrc_mse", "nrc_rel_bias", "nrc_cv", "mc_mse", "mc_rel_bias",
           "mc_cv", "mse_ratio", "mean_frame_time_ms", "loss_first",
           "loss_last")


def test_convergence_on_the_cpu(cache):
    rec = qt.convergence(SMALL, frames=2, tail_n=2, golden_size=(8, 5),
                         golden_frames=2, golden_path=8, width=W, height=H,
                         tables=(12, 10), density=_density(), device="cpu")
    assert rec["device"] == "cpu" and rec["study"] == "convergence"
    assert set(rec["runs"]) == {"2e12", "2e10"}
    assert set(rec["kernels_launched"]) == {"golden", "2e12", "2e10"}
    assert not any(rec["kernels_launched"].values())
    assert rec["golden"]["cached"] is False
    for run in rec["runs"].values():
        s = run["summary"]
        assert (s["frames"], s["tail_n"]) == (2, 2)
        _finite(s, SUMMARY)
        assert len(run["rows"]) == 2
        assert all("nrc" in r and "mc" in r for r in run["rows"])
    assert rec["runs"]["2e10"]["log2_hashmap_size"] == 10
    json.dumps(rec)
    # a second run finds the golden in the cache
    again = qt.convergence(SMALL, frames=1, tail_n=1, golden_size=(8, 5),
                           golden_frames=2, golden_path=8, width=W, height=H,
                           tables=(12,), density=_density(), device="cpu")
    assert again["golden"]["cached"] is True
    assert again["golden"]["key"] == rec["golden"]["key"]


def test_interactive_on_the_cpu(cache):
    rec = qt.interactive(SMALL, points=SMALL_POINTS, adopted=SMALL_POINTS[0],
                         timed_frames=1, frames=3, tail_n=2,
                         golden_size=(8, 5), golden_frames=2, golden_path=8,
                         density=_density(), device="cpu")
    assert [p["tag"] for p in rec["points"]] == [p[0] for p in SMALL_POINTS]
    for p in rec["points"]:
        _finite(p, ("ms_per_frame", "fps", "rays_per_s",
                    "compile_plus_first_s", "loss"))
        assert p["compile_cache_status"] in ("cold", "warm")
    assert [p["train_samples"] for p in rec["points"]] == [64, 64, 64]
    assert [p["log2_hashmap_size"] for p in rec["points"]] == [12, 12, 10]
    assert rec["operating_point"] == rec["points"][0]
    q = rec["quality"]
    assert (q["frames"], q["window"]) == (3, [1, 2])
    _finite(q, ("nrc_mse", "nrc_rel_bias", "nrc_cv", "mc_mse",
                "mc_rel_bias"))
    assert 0 <= q["nrc_wins"] <= 3
    assert set(rec["kernels_launched"]) == {p[0] for p in SMALL_POINTS} | {
        "golden", "trace"}
    json.dumps(rec)


def test_restir_on_the_cpu(cache):
    rec = qt.restir(SMALL, width=W, height=H, frames=2, truth_frames=3,
                    density=_density(), device="cpu")
    _finite(rec, ("restir_ms_per_frame", "restir_uniform_ms_per_frame",
                  "mc_ms_per_frame", "restir_first_frame_s",
                  "restir_mse_vs_truth", "restir_mse_vs_truth_uniform",
                  "mc_mse_vs_truth", "mse_ratio_restir_over_mc",
                  "mse_ratio_uniform_over_mc"))
    assert rec["resolution"] == f"{W}x{H}" and rec["truth"]["frames"] == 3
    assert rec["truth"]["path_length"] == 32
    assert set(rec["kernels_launched"]) == {"restir", "restir_uniform", "mc",
                                            "truth"}
    # the MC side is held to the truth's own seed-1 render
    truth = read_exr_rgba(rec["truth"]["file"])
    vol = _vol()
    mc = McRenderer(dataclasses.replace(SMALL, render_width=W,
                                        render_height=H), vol)
    cam = qt.Camera.reference_camera(W / H, device="cpu")
    img = mc.render(cam, 2, seed=1)
    assert rec["mc_mse_vs_truth"] == pytest.approx(qt.mse(img, truth),
                                                   rel=1e-6)


def test_a_failing_run_fails_the_study(cache, monkeypatch):
    from nrc_hpm_tpu_torch import app

    monkeypatch.setattr(app, "main", lambda argv: 1)
    with pytest.raises(RuntimeError, match="returned 1"):
        qt.convergence(SMALL, frames=1, tail_n=1, golden_size=(W, H),
                       golden_frames=1, golden_path=4, width=W, height=H,
                       tables=(12,), density=_density(), device="cpu")


def test_main_without_a_card_returns_1(tmp_path, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    assert qt.main(["all"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err
    assert not (tmp_path / "output_torch").exists()


@pytest.mark.parametrize("fn", [qt.golden, qt.golden_file, qt.convergence,
                                qt.interactive, qt.restir, qt.run_study,
                                qt.gates, qt.scenes, qt.preset_scene],
                         ids=lambda fn: fn.__name__)
def test_studies_default_to_the_card(fn):
    """A caller who names no device gets the GPU, never a CPU run."""
    import inspect

    assert inspect.signature(fn).parameters["device"].default == "cuda"


# -- the scene presets, the golden gates and the scenes study ---------------------

def test_preset_scene_builds_the_preset_volume():
    """Each preset's cloud at its own density and phase g, so presets 3, 4
    and 5 (0.25, 0.6, 1.6) give three golden keys; 0 and 4 share the
    density but not the lights."""
    keys = {}
    for sid, density in ((3, 0.25), (4, 0.6), (5, 1.6), (0, 0.6)):
        cfg, vol = qt.preset_scene(sid, _density(), SMALL, device="cpu")
        assert cfg.scene == SceneConfig.preset(sid)
        assert cfg.nn_width == SMALL.nn_width
        assert vol.density_factor == pytest.approx(density, rel=1e-7)
        assert vol.g == pytest.approx(cfg.scene.volume_g, rel=1e-7)
        keys[sid] = qt.golden_key(cfg, vol, W, H, 4, 8, 0)
    assert len(set(keys.values())) == 4
    # the volume the renderers would read is the preset's, not preset 4's
    _, vol4 = qt.preset_scene(4, _density(), device="cpu")
    _, vol5 = qt.preset_scene(5, _density(), device="cpu")
    assert qt.volume_digest(vol4) != qt.volume_digest(vol5)


def test_gate_band_by_hand():
    """centre = the mean, sigma = the population spread, tol = max(3.5
    sigma, 0.08)."""
    band = qt.gate_band([-0.1, 0.0, 0.1, 0.2])
    # mean 0.05; deviations -0.15 -0.05 0.05 0.15; variance 0.0125
    assert band["centre"] == pytest.approx(0.05, abs=1e-15)
    assert band["sigma"] == pytest.approx(math.sqrt(0.0125), rel=1e-12)
    assert band["tol"] == pytest.approx(3.5 * math.sqrt(0.0125), rel=1e-12)
    narrow = qt.gate_band([0.01, 0.012, 0.011])
    assert narrow["tol"] == 0.08
    assert narrow["centre"] == pytest.approx(0.011, rel=1e-12)


GATE_SMALL = dict(size=(W, H), frames=1, path_length=4, seeds=(1, 2, 3, 4),
                  golden_size=(W, H), golden_frames=2, golden_path=4,
                  long_frames=2)
GATE_KEYS = ("clip", "centre", "sigma", "tol", "raw_min", "raw_max",
             "ms_per_mc_frame")


def test_gates_on_the_cpu(cache):
    """The study at 16x9 on presets 1 (a long-budget preset) and 3 (a
    centred one): every section, every number, the verdicts as the rules
    read the numbers."""
    rec = qt.gates(presets=(1, 3), density=_density(), device="cpu",
                   **GATE_SMALL)
    assert rec["study"] == "gates" and rec["device"] == "cpu"
    assert sorted(rec["presets"]) == ["1", "3"]
    assert set(rec["kernels_launched"]) == {
        "1 golden", "1 calibration", "1 test", "1 long", "3 golden",
        "3 calibration", "3 test"}
    assert rec["mc_frames"] == 2 * (4 + 1) + 2
    _finite(rec, ("ms_per_mc_frame",))
    for sid, p in rec["presets"].items():
        _finite(p, GATE_KEYS)
        assert p["scene"]["id"] == int(sid)
        assert p["golden"]["seed"] == qt.GATE_GOLDEN_SEED
        assert [c["seed"] for c in p["calibration"]] == [1, 2, 3, 4]
        band = qt.gate_band([c["clamped"] for c in p["calibration"]])
        assert (p["centre"], p["sigma"], p["tol"]) == (
            band["centre"], band["sigma"], band["tol"])
        t = p["test"]
        # a seed apart from the calibration's, so the band is a check
        assert t["seed"] == 5 + int(sid)
        assert t["raw_ok"] == (abs(t["raw"]) < qt.GATE_RAW)
        assert t["band_ok"] == (abs(t["clamped"] - p["centre"]) < p["tol"])
        assert (t["raw"], t["clamped"]) not in [
            (c["raw"], c["clamped"]) for c in p["calibration"]]
    assert rec["presets"]["1"]["centred_ok"] is None
    assert rec["presets"]["3"]["centred_ok"] == (
        abs(rec["presets"]["3"]["centre"]) < rec["presets"]["3"]["tol"])
    long = rec["presets"]["1"]["long"]
    assert (long["seed"], long["frames"]) == (18, 2)
    assert long["ok"] == (abs(long["rel_bias"]) < qt.LONG_BOUND)
    assert rec["presets"]["3"]["long"] is None
    assert rec["passed"] == (not rec["failures"])
    json.dumps(rec)


@pytest.mark.parametrize("bounds,failure", [
    (dict(LONG_BOUND=0.0), "long-budget"),
    (dict(GATE_SIGMAS=0.0, GATE_TOL_MIN=0.0), "outside")],
    ids=["long", "band"])
def test_a_broken_gate_fails_the_study(cache, monkeypatch, capsys, bounds,
                                       failure):
    """A long-budget bound, or a band, that nothing meets fails the study,
    and ``main`` writes the record, then returns 1."""
    for name, value in bounds.items():
        monkeypatch.setattr(qt, name, value)
    rec = qt.gates(presets=(1,), density=_density(), device="cpu",
                   **GATE_SMALL)
    assert rec["passed"] is False
    assert any(failure in f for f in rec["failures"])

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(qt, "run_study", lambda *a: rec)
    monkeypatch.chdir(cache)
    assert qt.main(["gates"]) == 1
    with open(cache / "output_torch" / "quality_gates.json") as f:
        assert json.load(f)["failures"] == rec["failures"]
    assert "gates broken in gates" in capsys.readouterr().err


SCENE_SMALL = (("scene0", 0, {}), ("scene5", 5, {}),
               ("scene5_env_fixed16", 5, dict(env_fixed16=True)))


def test_scenes_on_the_cpu(cache):
    """The study at 16x9 for one frame a run: each run at its preset and
    fields against its own golden (scene 5's two share none), the gate
    read on scene 0, the fixed-step golden scored against the
    ratio-tracked one."""
    rec = qt.scenes(runs=SCENE_SMALL, cfg=SMALL,
                    frames=1, tail_n=1, golden_size=(8, 5), golden_frames=2,
                    golden_path=8, width=W, height=H, density=_density(),
                    device="cpu")
    assert rec["study"] == "scenes" and list(rec["runs"]) == [
        r[0] for r in SCENE_SMALL]
    keys = {label: run["golden"]["key"] for label, run in rec["runs"].items()}
    assert len(set(keys.values())) == 3
    for label, sid, fields in SCENE_SMALL:
        run = rec["runs"][label]
        assert (run["scene"], run["fields"]) == (sid, fields)
        _finite(run["summary"], ("nrc_mse", "nrc_rel_bias", "nrc_cv",
                                 "mc_mse", "mc_rel_bias", "mc_cv",
                                 "mse_ratio"))
        assert len(run["rows"]) == 1
        assert {f"{label} golden", f"{label} 2e12"} <= set(
            rec["kernels_launched"])
    ratio = rec["runs"]["scene0"]["summary"]["mse_ratio"]
    assert rec["passed"] == (ratio < 1.0)
    assert set(rec["env_fixed16_golden_rel_bias"]) == {"5"}
    assert math.isfinite(rec["env_fixed16_golden_rel_bias"]["5"])
    json.dumps(rec)


# -- chip_smoke.py's studies phase, rehearsed -------------------------------------

# chip_smoke.py's shape of the phase: one golden, which is also ReSTIR's
# 32-bounce truth
SMALL_GOLDEN = dict(golden_size=(8, 5), golden_frames=2, golden_path=32)
SMALL_SIZES = dict(
    convergence=dict(width=W, height=H, frames=2, tail_n=2, tables=(12,),
                     train=dict(log2_train_batch_size=5,
                                train_batch_count=2), **SMALL_GOLDEN),
    interactive=dict(points=SMALL_POINTS[:2], adopted=SMALL_POINTS[0],
                     timed_frames=1, frames=2, tail_n=1, **SMALL_GOLDEN),
    restir=dict(width=8, height=5, frames=2, truth_frames=2))


def test_studies_phase_on_the_cpu(cache, monkeypatch, capsys):
    """The phase the card runs, on the CPU at 16x9: the launch check is
    the card's (every count 0 here), the gate off."""
    import chip_smoke

    seen = []
    monkeypatch.setattr(chip_smoke, "check_launches",
                        lambda launches, names, label: seen.append(
                            (label, names, launches)))
    monkeypatch.setattr(chip_smoke, "STUDY_MSE_RATIO", None)
    chip_smoke.studies_phase(torch, "cpu", SMALL_SIZES, device="cpu",
                             cfg=SMALL, density=_density())
    out = capsys.readouterr().out
    assert "studies phase:" in out and "gate: ratio < None" in out
    assert all(n == 0 for _, _, launches in seen for n in launches.values())
    kernels = {label: names for label, names, _ in seen}
    online, track = chip_smoke.ONLINE_KERNELS, chip_smoke.TRACK
    # the interactive golden and ReSTIR's truth are the convergence
    # golden, from the cache
    assert kernels == {
        "convergence golden": track, "convergence 2e12": online,
        f"interactive {SMALL_POINTS[0][0]}": online,
        f"interactive {SMALL_POINTS[1][0]}": online,
        "interactive golden": (), "interactive trace": online,
        "restir restir": chip_smoke.RESTIR_KERNELS,
        "restir restir_uniform": chip_smoke.RESTIR_KERNELS,
        "restir mc": track, "restir truth": ()}


def test_studies_phase_gates_the_claim(cache, monkeypatch):
    """With the gate set, a convergence run whose NRC/MC tail MSE ratio
    reaches it fails the phase."""
    import chip_smoke

    summary = dict.fromkeys(chip_smoke.SUMMARY_KEYS, 1.0)
    summary.update(frames=2, tail_n=2, nrc_wins=0, mse_ratio=0.95)
    rec = dict(width=W, height=H, kernels_launched={}, runs={
        "2e12": dict(summary=summary)})
    monkeypatch.setattr(qt, "convergence", lambda **kw: rec)
    monkeypatch.setattr(chip_smoke, "STUDY_MSE_RATIO", 0.9)
    with pytest.raises(AssertionError, match="NRC/MC tail MSE 0.95"):
        chip_smoke.studies_phase(torch, "cpu", SMALL_SIZES, device="cpu")

