"""The port stands alone and never falls back silently: it imports no JAX,
its kernel wrappers take the plain path only for CPU tensors (launching
nothing), refuse other devices, and chip_smoke.py refuses to run without
a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from nrc_hpm_tpu_torch.ops import _build
from nrc_hpm_tpu_torch.ops import fused_encode_mlp as fem
from nrc_hpm_tpu_torch.ops import hash_grid_train as hgt
from nrc_hpm_tpu_torch.ops import pw_kernels as pk
from nrc_hpm_tpu_torch.models.nrc.encoding import HashGridSpec
from nrc_hpm_tpu_torch.volume import Volume

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, env_extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    code = ("import sys, nrc_hpm_tpu_torch.renderer, "
            "nrc_hpm_tpu_torch.weights, nrc_hpm_tpu_torch.utils.procedural, "
            "nrc_hpm_tpu_torch.ops.hash_grid_train\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'nrc_hpm_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    res = _run(["-c", code], ROOT, {"PYTHONPATH": ROOT})
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_refuses_without_gpu(tmp_path):
    res = _run([os.path.join(ROOT, "chip_smoke.py")], ROOT,
               {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    # alone, without the rest of the repository
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run(["chip_smoke.py"], str(tmp_path), {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def _lanes(n=64):
    rs = np.random.RandomState(0)
    vol = Volume.from_dense(rs.rand(8, 8, 8).astype(np.float32), 0.6, 0.8)
    start = torch.from_numpy(rs.uniform(-3, 3, (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(
        rs.normal(size=(n, 3)).astype(np.float32)), dim=-1)
    tmax = torch.full((n,), 40.0)
    seed = torch.from_numpy(rs.randint(0, 2 ** 31, n).astype(np.int32))
    return vol, start, d, tmax, seed


def test_cpu_tensors_take_the_plain_path_without_launching():
    wrappers = (pk.pw_events, pk.pw_profile, fem.fused_encode_mlp_infer)
    before = [w.launches for w in wrappers]
    vol, start, d, tmax, seed = _lanes()
    ev = pk.pw_events(vol, start, d, tmax, seed, torch.zeros(64), 0, S=8)
    assert torch.equal(ev["t"], pk.pw_events_plain(
        vol, start, d, tmax, seed, torch.zeros(64), 0, S=8)["t"])
    pk.pw_profile(vol, start, d, tmax, seed, want_ctrl=True)
    spec = HashGridSpec(n_levels=2, log2_table_size=8)
    layers = [torch.randn(16, 64), torch.randn(64, 64), torch.randn(64, 3)]
    out = fem.fused_encode_mlp_infer(
        torch.zeros(spec.total_params, dtype=torch.int32), layers,
        torch.rand(32, 5), spec)
    assert out.shape == (32, 3)
    assert [w.launches for w in wrappers] == before == [0, 0, 0]


def test_train_encode_on_cpu_launches_nothing():
    """The training encode pair, both table formats, forward and
    backward through autograd: plain versions only."""
    wrappers = (hgt.hash_grid_train_fwd, hgt.hash_grid_train_bwd)
    spec = HashGridSpec(n_levels=2, log2_table_size=8)
    x = torch.rand(32, 3)
    for packed in (True, False):
        table = torch.rand(spec.total_params, 2).requires_grad_(True)
        feats = hgt.HashGridTrainEncode.apply(table, x, spec, packed)
        feats.sum().backward()
        assert feats.shape == (32, spec.out_dim)
        assert table.grad.shape == table.shape and table.grad.any()
    assert [w.launches for w in wrappers] == [0, 0]


def test_other_devices_raise():
    vol, start, d, tmax, seed = _lanes(4)
    meta = [t.to("meta") for t in (start, d, tmax, seed)]
    with pytest.raises(ValueError, match="unsupported device"):
        pk.pw_profile(vol, *meta)
    with pytest.raises(ValueError, match="unsupported device"):
        pk.pw_events(vol, *meta, torch.zeros(4, device="meta"), 0)
    spec = HashGridSpec(n_levels=2, log2_table_size=8)
    x = torch.rand(4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hgt.hash_grid_train_fwd(torch.zeros(spec.total_params, 2,
                                            device="meta"), x, spec, False)
    with pytest.raises(ValueError, match="unsupported device"):
        hgt.hash_grid_train_bwd(x, torch.zeros(4, spec.out_dim,
                                               device="meta"), spec, True)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
