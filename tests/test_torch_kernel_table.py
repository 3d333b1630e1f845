"""The ops layer's table of counted kernel wrappers (``ops.kernel_table``),
the direction of the imports between the package, the scripts at the
repository's root and ``benchmark/``, and the bounds of chip_smoke.py's
kernel lines, which take the card's peaks and K1's and K3's counts from
the benchmark (``benchmark/harness/peaks.py``, ``benchmark/rooflines``)."""

import glob
import importlib
import inspect
import os
import re
import subprocess
import sys
import types

import pytest
import torch

from nrc_hpm_tpu_torch import ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = os.path.join(ROOT, "nrc_hpm_tpu_torch", "ops")
NAMES = ("pw_events", "pw_profile", "fused_encode_mlp", "hash_grid_train_fwd",
         "hash_grid_train_bwd", "fused_mlp", "table_gather",
         "small_table_lookup", "temporal_reuse", "spatial_reuse")
# the scripts at the repository's root, by module name
SCRIPTS = sorted(os.path.basename(p)[:-3]
                 for p in glob.glob(os.path.join(ROOT, "*.py")))


def _cuda_kernels() -> set:
    """The names of the ``*_kernel`` functions of ``csrc/*.cu``."""
    names = set()
    for path in glob.glob(os.path.join(ROOT, "nrc_hpm_tpu_torch", "csrc",
                                       "*.cu")):
        with open(path) as f:
            names |= set(re.findall(r"\b(\w+_kernel)\s*\(", f.read()))
    return names


def test_table_holds_every_counted_wrapper():
    """The table's keys, in order, and every function of ``ops/*.py``
    that counts its launches: all in the table, nothing else there."""
    counted = set()
    for path in glob.glob(os.path.join(OPS, "*.py")):
        name = os.path.basename(path)[:-3]
        if name.startswith("_"):
            continue
        mod = importlib.import_module(f"nrc_hpm_tpu_torch.ops.{name}")
        counted |= {fn for fn in vars(mod).values()
                    if inspect.isfunction(fn) and hasattr(fn, "launches")
                    and fn.__module__ == mod.__name__}
    table = ops.kernel_table()
    assert tuple(table) == NAMES
    assert {w for w, _ in table.values()} == counted


@pytest.mark.parametrize("name", NAMES)
def test_table_entry(name, monkeypatch):
    """The entry is its module's own function, counts its launches as an
    int that ``zero_launches`` resets and ``read_launches`` reads, and
    names a kernel of ``csrc/``."""
    wrapper, symbol = ops.kernel_table()[name]
    module = sys.modules[wrapper.__module__]
    assert module.__name__.startswith("nrc_hpm_tpu_torch.ops.")
    assert getattr(module, wrapper.__name__) is wrapper
    assert type(wrapper.launches) is int
    monkeypatch.setattr(wrapper, "launches", 7)
    assert ops.read_launches()[name] == 7
    ops.zero_launches()
    assert wrapper.launches == 0 and ops.read_launches()[name] == 0
    assert any(k.startswith(symbol) for k in _cuda_kernels()), symbol


@pytest.mark.parametrize("target", ["nrc_hpm_tpu_torch", "quality_torch"])
def test_imports_point_one_way(target):
    """Every module of the package, and the table's lazy imports, load no
    root script and nothing of ``benchmark/``; ``quality_torch`` loads no
    other root script."""
    if target == "nrc_hpm_tpu_torch":
        code = ("import importlib, pkgutil, sys, nrc_hpm_tpu_torch\n"
                "from nrc_hpm_tpu_torch import ops\n"
                "for m in pkgutil.walk_packages(nrc_hpm_tpu_torch.__path__,"
                " 'nrc_hpm_tpu_torch.'):\n"
                "    importlib.import_module(m.name)\n"
                "ops.kernel_table()\n")
        banned = SCRIPTS + ["benchmark"]
    else:
        code = "import sys, quality_torch\n"
        banned = [s for s in SCRIPTS if s != "quality_torch"]
    code += (f"bad = [m for m in sys.modules if m.split('.')[0] in "
             f"{banned!r}]\nprint(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("kernel", ["pw_events", "fused_encode_mlp"])
def test_kernel_line_bounds_are_the_benchmark_s(kernel):
    """K1 (S = 16) and K3 at chip_smoke.py's kernel-line shapes (2^20
    lanes or samples of ``AppConfig()``, the procedural cloud): the
    benchmark's peaks over its rooflines, 0.095 ms set by the bytes and
    0.050 ms set by the operations."""
    import chip_smoke
    from benchmark.harness import peaks
    from benchmark.rooflines import k1, k3
    from nrc_hpm_tpu_torch.config import AppConfig
    from nrc_hpm_tpu_torch.models.nrc.cache import NeuralRadianceCache
    from nrc_hpm_tpu_torch.models.nrc.mlp import init_mlp
    from nrc_hpm_tpu_torch.utils import prng
    from nrc_hpm_tpu_torch.utils.procedural import cloud_density
    from nrc_hpm_tpu_torch.volume import Volume

    cfg = AppConfig()
    if kernel == "pw_events":
        vol = Volume.from_dense(cloud_density(seed=0), cfg.scene.density,
                                cfg.scene.volume_g, device="cpu")
        n_macro = vol.macro_packed.numel()
        got = chip_smoke.pw_bound(chip_smoke.N_LANES, n_macro, 16)
        cost = k1.cost(chip_smoke.N_LANES, 16, n_macro)
        want = ("0.095", "bytes")
    else:
        # k3_inputs' shapes: the packed table, the MLP, the samples
        cache = NeuralRadianceCache(cfg)
        spec = cache.encoding.grid_spec
        layers = init_mlp(prng.prng_key(0), cache.encoding.out_dim,
                          cache.width, cache.depth, cache.N_OUTPUT,
                          "cpu")["layers"]
        packed = torch.empty(spec.total_params, dtype=torch.int32,
                             device="meta")
        x5 = torch.empty((chip_smoke.N_X5, 5), device="meta")
        cost = k3.cost(**k3.sizes(packed, layers, x5, spec))
        got = chip_smoke.k3_bound((packed, layers, x5, spec))
        want = ("0.050", "operations")
    assert got[0] == 1e3 * peaks.bound_s(**cost)
    assert (f"{got[0]:.3f}", got[1]) == want
    assert chip_smoke.HBM_BYTES_S is peaks.HBM_BYTES_S


def test_device_rows_leave_out_span_annotations():
    """chip_smoke.device_rows keeps the device's kernels and copies and
    leaves out CPU rows and the program's spans (``nrc.bounce`` and the
    others), which the profiler also lays on the device's timeline."""
    import chip_smoke

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def row(key, device, us, annotation=False):
        return types.SimpleNamespace(key=key, device_type=device,
                                     self_device_time_total=us, count=2,
                                     is_user_annotation=annotation)

    prof = types.SimpleNamespace(key_averages=lambda: [
        row("pw_events_kernel", cuda, 500.0),
        row("Memcpy DtoD (Device -> Device)", cuda, 40.0),
        row("nrc.bounce", cuda, 9e5, annotation=True),
        row("aten::index", cpu, 700.0), row("idle", cuda, 0.0)])
    assert chip_smoke.device_rows(torch, prof) == [
        ("pw_events_kernel", 0.5, 2),
        ("Memcpy DtoD (Device -> Device)", 0.04, 2)]
