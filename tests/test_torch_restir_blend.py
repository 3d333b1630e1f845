"""The port's ReSTIR renderer under the renderer contract that
``McRenderer`` and ``NrcRenderer`` follow (a key split each frame, the
running blend with weight 1 / ``blend_index``), against the benchmark's
plain copy of it (``benchmark/reference/models/restir.py``), on the CPU
at 32x18, where the port runs its plain draws and trackers too: bit for
bit, with the blend on and off.  Also: the blended image is the running
mean of the unblended frames, and ``reset_accumulation`` clears a
``RestirState``'s image, blend index, ring and frame counter."""

import importlib
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from nrc_hpm_tpu_torch.camera import Camera
from nrc_hpm_tpu_torch.config import AppConfig, RestirConfig
from nrc_hpm_tpu_torch.models import restir
from nrc_hpm_tpu_torch.renderer import reset_accumulation
from nrc_hpm_tpu_torch.utils.procedural import cloud_density
from nrc_hpm_tpu_torch.volume import Volume

W, H = 32, 18
FRAMES = 3
SEED = 2718281828
# a thin cloud: the renderer's work at a few seconds a run
CLOUD = (40, 27, 48)
FIELDS = ("image", "pixel_info", "stats", "reservoir", "old_reservoirs",
          "key")


def _reference():
    """``benchmark/reference`` under a package name of its own (its
    modules import each other relatively), and its ReSTIR module."""
    root = Path(__file__).resolve().parent.parent / "benchmark" / "reference"
    name = "bench_plain_reference"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, root / "__init__.py", submodule_search_locations=[str(root)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.config"), importlib.import_module(
        f"{name}.volume"), importlib.import_module(f"{name}.camera"), \
        importlib.import_module(f"{name}.models.restir")


def _frames(renderer, camera):
    st = renderer.init_state(SEED)
    out = []
    for _ in range(FRAMES):
        st = renderer.step(st, camera)
        out.append(st)
    return out


@pytest.fixture(scope="module")
def dens():
    return cloud_density(0, CLOUD)


@pytest.fixture(scope="module")
def port(dens):
    """{blend: the port's states after each of three frames}."""
    cfg = AppConfig(render_width=W, render_height=H)
    vol = Volume.from_dense(dens, cfg.scene.density, cfg.scene.volume_g,
                            device="cpu")
    cam = Camera.reference_camera(W / H, device="cpu")
    return {blend: _frames(restir.RestirRenderer(cfg, vol, blend=blend), cam)
            for blend in (True, False)}


@pytest.mark.parametrize("blend", [True, False], ids=["blend", "frame"])
def test_port_equals_the_plain_reference(dens, port, blend):
    """Image, reservoir, stats, ring, key, frame and blend index after
    each of three frames; the reference holds the shaders' constants as
    its own defaults, which are ``AppConfig().restir``."""
    rcfg, rvol, rcam, rres = _reference()
    cfg = rcfg.AppConfig(render_width=W, render_height=H)
    vol = rvol.Volume.from_dense(dens, cfg.scene.density, cfg.scene.volume_g,
                                 device="cpu")
    ref = _frames(rres.RestirRenderer(cfg, vol, blend=blend),
                  rcam.Camera.reference_camera(W / H, device="cpu"))
    assert AppConfig().restir == RestirConfig(
        rres.PATH_VERTEX_COUNT, rres.SPATIAL_KERNEL_SIZE,
        rres.TEMPORAL_KERNEL_SIZE, rres.MIS_WEIGHTS)
    for p, r in zip(port[blend], ref):
        for f in FIELDS:
            assert torch.equal(getattr(p, f), getattr(r, f)), f
        assert (p.frame, p.blend_index) == (r.frame, r.blend_index)
    assert port[blend][-1].blend_index == (1 + FRAMES if blend else 1)
    scat = port[blend][-1].pixel_info[..., 3] == 1.0
    assert 0.05 < scat.float().mean() < 0.99


def test_blend_is_the_running_mean_of_the_frames(port):
    """With ``blend`` the image is the mean of the frames ``blend=False``
    shows, and every other field is the same."""
    blended, alone = port[True], port[False]
    for k, (b, a) in enumerate(zip(blended, alone)):
        mean = torch.stack([f.image for f in alone[:k + 1]]).mean(0)
        torch.testing.assert_close(b.image, mean, rtol=1e-6, atol=1e-6)
        for f in FIELDS[1:]:
            assert torch.equal(getattr(b, f), getattr(a, f)), f
        assert b.frame == a.frame == k + 1
    assert not torch.equal(blended[-1].image, alone[-1].image)


def test_reset_accumulation_clears_a_restir_state(port):
    """A camera cut: image zero, blend index 1, the ring zero and frame 0;
    the reservoir, pixel info, stats and key stay."""
    st = port[True][1]
    assert st.old_reservoirs.any() and st.image.any()
    cut = reset_accumulation(st)
    assert isinstance(cut, restir.RestirState)
    assert not cut.image.any() and not cut.old_reservoirs.any()
    assert (cut.blend_index, cut.frame) == (1, 0)
    for f in ("reservoir", "pixel_info", "stats", "key"):
        assert torch.equal(getattr(cut, f), getattr(st, f)), f
