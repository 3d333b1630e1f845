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
test_torch_app.py makes one and checks its records and its EXR."""

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
