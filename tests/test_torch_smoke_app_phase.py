"""chip_smoke.py's app phases rehearsed on the CPU: the same functions the
H100 run calls, given ``--platform cpu``, 48x27 and the small positional
arguments of test_torch_app.py, its scratch directory and golden moved
under the test's tmp_path.  It writes the procedural cloud as a VDB and
reads it back bitwise, runs the app with ``--renderer both --profile
--export-exr --checkpoint``, then the frozen reload, and checks the
records, the EXRs, the stage keys and the reloaded state bitwise.  The
launch check is the card's: here every count must be 0, since the
wrappers run their plain versions on CPU tensors.  The ReSTIR app phase
runs ``--renderer restir --export-exr`` from a directory made as
test_torch_app.py makes one and checks its records and its EXR, the
``--mesh 1`` app phase likewise.  The sharding phase runs its one-rank
part at 64x32 on a gloo group of the test's process, and its two-rank
rehearsal spawns two gloo ranks on the CPU."""

import dataclasses

import torch

import chip_smoke
from nrc_hpm_tpu_torch.config import AppConfig
from nrc_hpm_tpu_torch.reference import generate_golden
from nrc_hpm_tpu_torch.utils.procedural import cloud_density
from nrc_hpm_tpu_torch.volume import Volume
from test_torch_app import ARGV, FLAGS, make_scene, run_in


def test_app_phase_on_the_cpu(tmp_path, monkeypatch, capsys):
    golden = tmp_path / "golden"
    monkeypatch.setattr(chip_smoke, "APP_DIR", str(tmp_path / "app_run"))
    monkeypatch.setattr(chip_smoke, "GOLDEN_DIR", str(golden))
    vol = Volume.from_dense(cloud_density(0, (40, 27, 48)), 0.6, 0.8,
                            device="cpu")
    generate_golden(AppConfig(), str(golden / "4" / "0.exr"), vol, frames=2,
                    path_length=8, width=24, height=14, device="cpu")
    seen = []
    monkeypatch.setattr(chip_smoke, "check_launches",
                        lambda launches, names, label: seen.append(
                            (label, launches, names)))
    chip_smoke.app_phase(torch, "cpu", ARGV + FLAGS)
    out = capsys.readouterr().out
    assert "read back bitwise" in out and "reloaded bitwise" in out
    assert [(label, names) for label, _, names in seen] == [
        ("app 48x27 --renderer both", chip_smoke.ONLINE_KERNELS),
        ("app frozen reload", chip_smoke.FROZEN_KERNELS)]
    assert all(n == 0 for _, launches, _ in seen
               for n in launches.values())
    assert "theoretical FPS:" in out


def test_app_restir_phase_on_the_cpu(tmp_path, monkeypatch, capsys):
    root = tmp_path / "app_run"
    root.mkdir()
    run_in(str(root), make_scene)
    monkeypatch.setattr(chip_smoke, "APP_DIR", str(root))
    seen = []
    monkeypatch.setattr(chip_smoke, "check_launches",
                        lambda launches, names, label: seen.append(
                            (label, launches, names)))
    chip_smoke.app_restir_phase(torch, "cpu", ARGV + FLAGS)
    out = capsys.readouterr().out
    assert [(label, names) for label, _, names in seen] == [
        ("app 48x27 --renderer restir", chip_smoke.RESTIR_KERNELS)]
    assert all(n == 0 for n in seen[0][1].values())
    assert "restir.exr (27, 48, 4) finite True" in out


def test_app_mesh_phase_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``app.main --mesh 1`` as the card runs it, on a one-rank gloo
    group here: every frame compared to the golden, a finite EXR."""
    root = tmp_path / "app_run"
    root.mkdir()
    run_in(str(root), make_scene)
    monkeypatch.setattr(chip_smoke, "APP_DIR", str(root))
    seen = []
    monkeypatch.setattr(chip_smoke, "check_launches",
                        lambda launches, names, label: seen.append(
                            (label, launches, names)))
    chip_smoke.app_mesh_phase(torch, "cpu", ARGV + FLAGS)
    out = capsys.readouterr().out
    assert [(label, names) for label, _, names in seen] == [
        ("app 48x27 --mesh 1", chip_smoke.ONLINE_KERNELS)]
    assert all(n == 0 for n in seen[0][1].values())
    assert "nrc.exr (27, 48, 4) finite True" in out


def _shard_cfg():
    return AppConfig(
        render_width=64, render_height=32, nn_width=32, nn_depth=2,
        encoding=dataclasses.replace(AppConfig().encoding, n_levels=4,
                                     log2_hashmap_size=12),
        log2_infer_batch_size=11, log2_train_batch_size=6,
        train_batch_count=2, train_ray_length=4)


def test_sharding_phase_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.sharding_phase's one-rank part at 64x32 on a gloo group
    of this process (the card's synchronize and profiler stubbed: a CPU
    run has neither), its rehearsal recorded, not run."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "profile_step", lambda *a: (
        {k: 0 for k in chip_smoke.kernel_table()},
        [("ncclDevKernel_AllReduce", 0.1, 4)]))
    seen, rehearsed = [], []
    monkeypatch.setattr(chip_smoke, "check_launches",
                        lambda launches, names, label: seen.append(label))
    monkeypatch.setattr(chip_smoke, "rehearsal",
                        lambda *a: rehearsed.append(a))
    vol = Volume.from_dense(cloud_density(0), 0.6, 0.8, device="cpu")
    chip_smoke.sharding_phase(torch, torch.device("cpu"), vol, _shard_cfg(),
                              "cpu")
    out = capsys.readouterr().out
    assert "a one-rank gloo group" in out
    assert "sharded frozen 64x32, 1 rank: 1.000000 of the pixels" in out
    assert seen == ["sharded online 64x32, 1 NCCL rank",
                    "profiled sharded frame"]
    assert "6 all-reduces of" in out and "in turns" in out
    assert len(rehearsed) == 1 and rehearsed[0][3].shape == (32, 64, 4)
    assert not torch.distributed.is_initialized()


def test_sharding_rehearsal_on_the_cpu(tmp_path, monkeypatch, capsys):
    """chip_smoke.rehearsal's two gloo ranks at 64x32 on the CPU: the
    first gathered frame under the JAX tests' rule, replicas bitwise
    equal, no kernel launched (the plain versions on CPU tensors)."""
    from nrc_hpm_tpu_torch.camera import Camera
    from nrc_hpm_tpu_torch.renderer import NrcRenderer

    seen = []
    monkeypatch.setattr(chip_smoke, "check_launches",
                        lambda launches, names, label: seen.append(
                            (label, launches)))
    cfg = _shard_cfg()
    vol = Volume.from_dense(cloud_density(0), 0.6, 0.8, device="cpu")
    r = NrcRenderer(cfg, vol)
    cam = Camera.reference_camera(aspect=2.0, device="cpu")
    frozen = r.step(r.init_state(0), cam, train=False).image
    chip_smoke.rehearsal(torch, torch.device("cpu"), cfg, frozen, "cpu",
                         out_dir=str(tmp_path / "rehearsal"))
    out = capsys.readouterr().out
    assert [label for label, _ in seen] == [
        f"rehearsal 64x32, 2 gloo ranks on cpu, rank {k}" for k in (0, 1)]
    assert all(n == 0 for _, launches in seen for n in launches.values())
    assert "replicas bitwise equal" in out
    assert "gather all_gather of cpu tensors" in out
