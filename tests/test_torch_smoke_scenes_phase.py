"""chip_smoke.py's scenes phase rehearsed on the CPU (the online frames at
a preset, its small frames against the CPU, quality_torch's gates on
every preset), at 32x18 with 4-bounce paths on test_torch_quality.py's
thin cloud and small network."""

import dataclasses

import numpy as np
import torch

import quality_torch as qt
from nrc_hpm_tpu_torch.config import AppConfig, EncodingConfig
from nrc_hpm_tpu_torch.utils.procedural import cloud_density

# a 16x2 MLP on 4 hash levels, 2 x 2^6 train samples of 4 bounces, 4-bounce
# MC, at 32x18 (test_torch_quality.py's SMALL)
SMALL = AppConfig(encoding=EncodingConfig(n_levels=4, log2_hashmap_size=12),
                  nn_width=16, nn_depth=2, log2_train_batch_size=6,
                  train_batch_count=2, train_ray_length=4, mc_path_length=4,
                  render_width=32, render_height=18)
# the gates at 16x9: one frame a run, two seeds, 4 bounces
GATES = dict(size=(16, 9), frames=1, path_length=4, seeds=(1, 2),
             golden_size=(16, 9), golden_frames=2, golden_path=4,
             long_frames=2)


def test_scenes_phase_on_the_cpu(tmp_path, monkeypatch, capsys):
    """chip_smoke.scenes_phase at preset 5 (its profiled frame and its
    env_fixed16 frames) and the gates on every preset, on the CPU at 32x18
    with 4-bounce paths: the launch checks are the card's (every count 0
    here), the card's synchronize, memory counters and profiler
    stubbed."""
    import chip_smoke

    def profile_step(torch, label, step, frame_ms, gpu):
        chip_smoke.zero_launches()
        step()
        return chip_smoke.read_launches(), []

    seen = []
    monkeypatch.setattr(chip_smoke, "check_launches",
                        lambda launches, names, label: seen.append(
                            (label, names, launches)))
    monkeypatch.setattr(chip_smoke, "SCENE_PRESETS", (5,))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "profile_step", profile_step)
    # 16x9 frames of 4 bounces read noise: bounds no reading reaches
    monkeypatch.setattr(qt, "LONG_BOUND", 1e9)
    monkeypatch.setattr(qt, "GATE_RAW", 1e9)
    monkeypatch.setattr(qt, "GATE_TOL_MIN", 1e9)
    monkeypatch.setattr(qt, "GOLDEN_CACHE", str(tmp_path / "golden_cache"))
    # a thin small cloud: the plain trackers' time follows the events
    density = cloud_density(0, (40, 27, 48)) * np.float32(0.2)
    chip_smoke.scenes_phase(torch, torch.device("cpu"), "cpu", cfg=SMALL,
                            density=density, gate_sizes=GATES)
    out = capsys.readouterr().out
    assert all(n == 0 for _, _, launches in seen for n in launches.values())
    kernels = {label: names for label, names, _ in seen}
    online, track = chip_smoke.ONLINE_KERNELS, chip_smoke.TRACK
    frames = [k for k in kernels if k.startswith("online 32x18 preset 5")]
    assert len(frames) == 2 and all(kernels[k] == online for k in frames)
    assert kernels["profiled online frame preset 5"] == online
    gates = {k: v for k, v in kernels.items() if k.startswith("gates ")}
    assert len(gates) == 6 * 3 + 2 and set(gates.values()) == {track}
    assert "small online frame preset 5: loss" in out
    assert "on the same inputs)" in out
    assert "small MC 48x27 preset 5 mode=pw" in out
    assert "preset 5 env_fixed16: K1 0 and K2 0 launches a frame" in out
    for sid in range(6):
        assert f"gates preset {sid}: golden" in out
    assert "scenes phase:" in out
