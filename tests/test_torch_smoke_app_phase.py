"""chip_smoke.py's app phase rehearsed on the CPU: the same function the
H100 run calls, given ``--platform cpu``, 48x27 and the small positional
arguments of test_torch_app.py, its scratch directory and golden moved
under the test's tmp_path.  It writes the procedural cloud as a VDB and
reads it back bitwise, runs the app with ``--renderer both --profile
--export-exr --checkpoint``, then the frozen reload, and checks the
records, the EXRs, the stage keys and the reloaded state bitwise.  The
launch check is the card's: here every count must be 0, since the
wrappers run their plain versions on CPU tensors."""

import torch

import chip_smoke
from nrc_hpm_tpu_torch.config import AppConfig
from nrc_hpm_tpu_torch.reference import generate_golden
from nrc_hpm_tpu_torch.utils.procedural import cloud_density
from nrc_hpm_tpu_torch.volume import Volume
from test_torch_app import ARGV, FLAGS


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
