"""The port stands alone and never falls back silently: it imports no JAX,
its kernel wrappers take the plain path only for CPU tensors (launching
nothing), refuse other devices, and chip_smoke.py refuses to run without
a GPU."""

import inspect
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
            "nrc_hpm_tpu_torch.ops.hash_grid_train, nrc_hpm_tpu_torch.app, "
            "nrc_hpm_tpu_torch.profiler, nrc_hpm_tpu_torch.camera_path, "
            "nrc_hpm_tpu_torch.utils.vdb, nrc_hpm_tpu_torch.utils.metrics, "
            "nrc_hpm_tpu_torch.utils.checkpoint, "
            "nrc_hpm_tpu_torch.models.restir, nrc_hpm_tpu_torch.models.mesh, "
            "nrc_hpm_tpu_torch.models.raster, nrc_hpm_tpu_torch.utils.png, "
            "nrc_hpm_tpu_torch.utils.texture, "
            "nrc_hpm_tpu_torch.parallel.sharding, "
            "nrc_hpm_tpu_torch.parallel.multihost, "
            "nrc_hpm_tpu_torch.utils.native\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'nrc_hpm_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    res = _run(["-c", code], ROOT, {"PYTHONPATH": ROOT})
    assert res.returncode == 0, res.stdout + res.stderr
    # the test VDB writer, which chip_smoke.py imports on the card's
    # machine: no JAX and no torch
    code = ("import sys, torch_vdb_writer\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'nrc_hpm_tpu', 'nrc_hpm_tpu_torch', "
            "'torch')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    res = _run(["-c", code], ROOT,
               {"PYTHONPATH": os.path.join(ROOT, "tests")})
    assert res.returncode == 0, res.stdout + res.stderr


def test_quality_torch_imports_no_jax():
    """quality_torch.py: no JAX, nothing of the JAX package and nothing of
    experiments/ (it keeps its own copy of what it needs from
    summarize_run.py)."""
    code = ("import sys, quality_torch\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'nrc_hpm_tpu', 'experiments', "
            "'summarize_run', 'interactive_point', 'restir_960')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    res = _run(["-c", code], ROOT, {"PYTHONPATH": ROOT})
    assert res.returncode == 0, res.stdout + res.stderr
    with open(os.path.join(ROOT, "quality_torch.py")) as f:
        lines = [line for line in f if "experiments" in line]
    assert not [line for line in lines
                if "import" in line or "sys.path" in line], lines


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


def test_kernel_ab_refuses_without_gpu(tmp_path):
    res = _run([os.path.join(ROOT, "kernel_ab.py"), str(tmp_path)], ROOT,
               {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ms"' not in res.stdout


def _entry_points():
    from nrc_hpm_tpu_torch import (camera, camera_path, lights, renderer,
                                   ring_buffer, weights)
    from nrc_hpm_tpu_torch.models.mesh import flatten_model
    from nrc_hpm_tpu_torch.models.nrc.cache import NeuralRadianceCache
    from nrc_hpm_tpu_torch.models.raster import ModelRenderer
    from nrc_hpm_tpu_torch.models.restir import RestirRenderer
    from nrc_hpm_tpu_torch.parallel import multihost, sharding
    from nrc_hpm_tpu_torch.reference import GoldenReference, generate_golden
    from nrc_hpm_tpu_torch.utils import checkpoint

    return [Volume.from_dense, Volume.homogeneous_cube,
            GoldenReference, GoldenReference.load, camera.Camera.create,
            camera.Camera.reference_camera, lights.DirLight.create,
            lights.PointLight.create, lights.HdrEnvMap.constant_white,
            lights.HdrEnvMap.from_image, lights.lights_from_scene,
            ring_buffer.RingBuffer.create, NeuralRadianceCache.init_state,
            NeuralRadianceCache.state_from_params, weights.params_from_jax,
            weights.state_from_jax, weights.ring_from_jax,
            Volume.from_vdb, renderer._volume_from_config,
            checkpoint.load_pytree, renderer.NrcRenderer,
            renderer.McRenderer, generate_golden,
            camera_path.CameraPath.player, RestirRenderer, ModelRenderer,
            flatten_model, sharding.make_group, sharding.ShardedNrcRenderer,
            weights.sharded_state_from_jax, multihost.initialize]


@pytest.mark.parametrize("fn", _entry_points(),
                         ids=lambda fn: fn.__qualname__)
def test_entry_points_default_to_the_card(fn):
    """A caller who names no device gets the GPU (or an error where there
    is none), never a silent CPU run."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_app_runs_on_the_card_by_default():
    """The app's --platform defaults to cuda: no silent CPU run."""
    from nrc_hpm_tpu_torch import app

    assert app.build_argparser().get_default("platform") == "cuda"


def test_app_writes_apart_and_keeps_earlier_logs(tmp_path, monkeypatch,
                                                 capsys):
    """The app's runs go to output_torch/<name>/, not the JAX app's
    output/<name>/, and a run whose scene fails to load leaves the logs
    already there as they were."""
    from nrc_hpm_tpu_torch import app
    from nrc_hpm_tpu_torch.config import AppConfig

    monkeypatch.chdir(tmp_path)
    name = AppConfig().name()
    logs = [tmp_path / root / name / f for root in ("output", "output_torch")
            for f in ("log.txt", "metrics.jsonl")]
    for f in logs:
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text("an earlier run\n")
    with pytest.raises(FileNotFoundError):
        app.main(["--platform", "cpu", "--frames", "1", "--width", "8",
                  "--height", "4"])
    assert f"output: {os.path.join('output_torch', name)}" in \
        capsys.readouterr().out
    assert all(f.read_text() == "an earlier run\n" for f in logs)


def _lanes(n=64):
    rs = np.random.RandomState(0)
    vol = Volume.from_dense(rs.rand(8, 8, 8).astype(np.float32), 0.6, 0.8,
                            device="cpu")
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


def test_mlp_and_lookup_kernels_on_cpu_launch_nothing():
    """K4, K5 and K6 take their plain versions for CPU tensors."""
    from nrc_hpm_tpu_torch.ops import fused_mlp as fm
    from nrc_hpm_tpu_torch.ops import macro_gather as mg
    from nrc_hpm_tpu_torch.ops import table_gather as tg

    wrappers = (fm.fused_mlp_infer, tg.table_gather, mg.small_table_lookup)
    before = [w.launches for w in wrappers]
    params = {"layers": [torch.randn(80, 64), torch.randn(64, 64),
                         torch.randn(64, 3)]}
    feats = torch.rand(32, 80)
    assert torch.equal(fm.fused_mlp_infer(params, feats),
                       fm.fused_mlp_plain(params, feats))
    table = torch.rand(3520)
    idx = torch.randint(0, 3520, (65, 16), dtype=torch.int32)
    assert torch.equal(tg.table_gather(table, idx), table[idx])
    assert torch.equal(mg.small_table_lookup(table, idx), table[idx])
    assert [w.launches for w in wrappers] == before == [0, 0, 0]


def test_mlp_and_lookup_kernels_refuse_other_devices():
    from nrc_hpm_tpu_torch.ops import fused_mlp as fm
    from nrc_hpm_tpu_torch.ops import macro_gather as mg
    from nrc_hpm_tpu_torch.ops import table_gather as tg

    layers = [torch.zeros(16, 32, device="meta"),
              torch.zeros(32, 3, device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        fm.fused_mlp_infer({"layers": layers},
                           torch.zeros(4, 16, device="meta"))
    table = torch.zeros(64, device="meta")
    idx = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tg.table_gather(table, idx)
    with pytest.raises(ValueError, match="unsupported device"):
        mg.small_table_lookup(table, idx)


@pytest.mark.parametrize("fn", ["table_gather", "small_table_lookup"])
def test_lookups_count_no_launch_for_empty_indices(monkeypatch, fn):
    """On the card an empty idx launches nothing, so it counts nothing."""
    from nrc_hpm_tpu_torch.ops import macro_gather as mg
    from nrc_hpm_tpu_torch.ops import table_gather as tg

    def no_library():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(_build, "on_card", lambda name, device: True)
    monkeypatch.setattr(tg, "_lib", no_library)
    wrapper = {"table_gather": tg.table_gather,
               "small_table_lookup": mg.small_table_lookup}[fn]
    before = wrapper.launches
    out = wrapper(torch.rand(64), torch.zeros((65, 0), dtype=torch.int32))
    assert out.shape == (65, 0) and out.dtype == torch.float32
    assert wrapper.launches == before


@pytest.mark.parametrize("case", ["feats-f64", "feats-1d", "chain",
                                  "layer-f64", "out-dim", "one-layer"])
def test_fused_mlp_rejects_bad_inputs(case):
    from nrc_hpm_tpu_torch.ops import fused_mlp as fm

    layers = [torch.randn(16, 32), torch.randn(32, 32), torch.randn(32, 3)]
    feats, out_dim = torch.rand(8, 16), 3
    if case == "feats-f64":
        feats = feats.double()
    elif case == "feats-1d":
        feats = feats.reshape(-1)
    elif case == "chain":
        layers[1] = torch.randn(48, 32)
    elif case == "layer-f64":
        layers[2] = layers[2].double()
    elif case == "out-dim":
        out_dim = 4
    else:
        layers = layers[:1]
    with pytest.raises(ValueError, match="fused_mlp_infer"):
        fm.fused_mlp_infer({"layers": layers}, feats, out_dim)


@pytest.mark.parametrize("layers,in_dim,want", [
    # shapes the kernel refused before its tensor-core redesign, now served
    # (the plan: k_in, padded width, STREAM design)
    pytest.param([(16, 48), (48, 48), (48, 3)], 16, (16, 48, False),
                 id="layers0-16-hidden widths"),
    pytest.param([(24, 64), (64, 3)], 24, (32, 64, False),
                 id="layers1-24-multiple of 16"),
    pytest.param([(144, 64), (64, 3)], 144, (144, 64, False),
                 id="layers2-144-multiple of 16"),
    pytest.param([(128, 128)] + [(128, 128)] * 7 + [(128, 3)], 128,
                 (128, 128, True), id="layers4-128-shared memory"),
    pytest.param([(80, 256)] + [(256, 256)] * 5 + [(256, 3)], 80,
                 (80, 256, True), id="width-256"),
    pytest.param([(256, 200), (200, 3)], 256, (256, 208, True),
                 id="in-256-width-200"),
    # and what it still refuses
    pytest.param([(16, 64), (64, 9)], 16, "outputs", id="layers3-16-outputs"),
    pytest.param([(16, 272), (272, 3)], 16, "up to 256", id="width-272"),
    pytest.param([(264, 64), (64, 3)], 264, "up to 256", id="in-264"),
    pytest.param([(16, 64), (64, 32), (32, 3)], 16, "one hidden width",
                 id="mixed-widths"),
])
def test_fused_mlp_kernel_refuses_shapes_it_does_not_take(layers, in_dim,
                                                          want):
    """K4's plan, made from the shapes before any launch: every in_dim and
    hidden width up to 256 (padded to multiples of 16), any depth, the
    STREAM design above width 128 or beyond one block's shared memory;
    more than 8 outputs, wider layers and mixed hidden widths raise
    NotImplementedError (the cache sends widths above 256 to mlp_apply,
    as the JAX package's use_fused does)."""
    from nrc_hpm_tpu_torch.ops import fused_mlp as fm

    ws = [torch.zeros(a, b) for a, b in layers]
    if isinstance(want, str):
        with pytest.raises(NotImplementedError, match=want):
            fm.plan(ws, in_dim, layers[-1][1])
    else:
        assert fm.plan(ws, in_dim, layers[-1][1]) == want


@pytest.mark.parametrize("fn,table,idx,what", [
    ("table_gather", torch.zeros(64, dtype=torch.float64),
     torch.zeros(4, dtype=torch.int32), "table must be"),
    ("table_gather", torch.zeros(65537), torch.zeros(4, dtype=torch.int32),
     "table must be"),
    ("table_gather", torch.zeros(8, 8), torch.zeros(4, dtype=torch.int32),
     "table must be"),
    ("table_gather", torch.zeros(64), torch.zeros(4, dtype=torch.int64),
     "idx must be int32"),
    ("small_table_lookup", torch.zeros(64, dtype=torch.int32),
     torch.zeros(4, dtype=torch.int32), "table must be"),
    ("small_table_lookup", torch.zeros(8193),
     torch.zeros(4, dtype=torch.int32), "table must be"),
    ("small_table_lookup", torch.zeros(64), torch.zeros(4),
     "idx must be int32"),
])
def test_lookups_reject_bad_inputs(fn, table, idx, what):
    from nrc_hpm_tpu_torch.ops import macro_gather as mg
    from nrc_hpm_tpu_torch.ops import table_gather as tg

    wrapper = {"table_gather": tg.table_gather,
               "small_table_lookup": mg.small_table_lookup}[fn]
    with pytest.raises(ValueError, match=what):
        wrapper(table, idx)
