"""ReSTIR's reuse stages (``models/restir.py`` ``_temporal_reuse``,
``_spatial_reuse``) and their kernels' host side, on the CPU.

The kernels (``csrc/restir_reuse.cu``) run only on the card, where
``chip_smoke.py``'s reuse phase holds them to the plain versions bit for
bit.  Here: a frame writes no tensor of the state it steps from (the
contract the kernels keep: they write fresh tensors); CPU tensors take the
plain versions and launch nothing; other devices raise; the wrappers
refuse what the kernels do not take before they build anything; and the
reuse phase itself, rehearsed at a small size with the card's calls
stubbed."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from nrc_hpm_tpu_torch.camera import Camera
from nrc_hpm_tpu_torch.config import AppConfig
from nrc_hpm_tpu_torch.models import restir
from nrc_hpm_tpu_torch.ops import restir_reuse as rr
from nrc_hpm_tpu_torch.utils.procedural import cloud_density
from nrc_hpm_tpu_torch.volume import Volume

W, H = 32, 18
CLOUD = (40, 27, 48)   # a thin cloud: a frame in a second or two


@pytest.fixture(scope="module")
def vol():
    cfg = AppConfig()
    return Volume.from_dense(cloud_density(0, CLOUD), cfg.scene.density,
                             cfg.scene.volume_g, device="cpu")


def _tensors(state):
    return {k: v for k, v in vars(state).items() if torch.is_tensor(v)}


@pytest.mark.parametrize("mis", [True, False], ids=["mis", "uniform"])
def test_step_writes_no_input(vol, mis):
    """Two frames from ``init_state``: every tensor of the state a step
    starts from keeps its bits and its version counter, and the reuse
    stages run on the CPU without a launch."""
    cfg = AppConfig(render_width=W, render_height=H)
    cfg = dataclasses.replace(cfg, restir=dataclasses.replace(
        cfg.restir, mis_weights=mis))
    r = restir.RestirRenderer(cfg, vol)
    cam = Camera.reference_camera(W / H, device="cpu")
    rr.temporal_reuse.launches = rr.spatial_reuse.launches = 0
    state = r.init_state(7)
    for _ in range(2):
        held = {k: (t.clone(), t._version)
                for k, t in _tensors(state).items()}
        new = r.step(state, cam)
        for k, t in _tensors(state).items():
            assert torch.equal(t, held[k][0]) and t._version == held[k][1], k
        assert new.frame == state.frame + 1
        state = new
    assert rr.temporal_reuse.launches == rr.spatial_reuse.launches == 0


def _stage_inputs(v=4, t=2, h=5, w=7, seed=0):
    g = torch.Generator().manual_seed(seed)
    flags = (torch.rand((h, w), generator=g) < 0.6).float()
    pinfo = torch.cat([torch.rand((h, w, 3), generator=g), flags[..., None]],
                      -1)
    return dict(seeds=torch.rand((h, w), generator=g),
                res=torch.randn((h, w, v, 6), generator=g),
                ring=torch.randn((t, h, w, v, 6), generator=g),
                stats=torch.ones((h, w, 2)), mis=torch.zeros((h, w, 2)),
                pinfo=pinfo)


@pytest.mark.parametrize("weighted", [True, False], ids=["mis", "uniform"])
def test_cpu_stages_are_the_plain_versions(weighted):
    s = _stage_inputs()
    h, w = s["seeds"].shape
    rr.temporal_reuse.launches = rr.spatial_reuse.launches = 0
    t_args = (s["seeds"], s["res"], s["ring"], s["stats"], s["mis"],
              s["pinfo"], 3, 4, 2)
    got = restir._temporal_reuse(*t_args, g=0.8, weighted=weighted)
    want = restir._temporal_reuse_plain(*t_args, g=0.8, weighted=weighted)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    s_args = (s["seeds"], s["res"], s["stats"], s["mis"], s["pinfo"], 4, 3,
              h, w)
    got = restir._spatial_reuse(*s_args, g=0.8, weighted=weighted)
    want = restir._spatial_reuse_plain(*s_args, g=0.8, weighted=weighted)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert rr.temporal_reuse.launches == rr.spatial_reuse.launches == 0


def test_other_devices_raise():
    s = {k: v.to("meta") for k, v in _stage_inputs().items()}
    with pytest.raises(ValueError, match="unsupported device"):
        restir._temporal_reuse(s["seeds"], s["res"], s["ring"], s["stats"],
                               s["mis"], s["pinfo"], 1, 4, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        restir._spatial_reuse(s["seeds"], s["res"], s["stats"], s["mis"],
                              s["pinfo"], 4, 3, 5, 7)


def _bad(case):
    """Stage inputs broken as ``case`` says, and the temporal frame."""
    s = _stage_inputs(v=17 if case == "V above 16" else 4)
    if case == "float64 reservoir":
        s["res"] = s["res"].double()
    elif case == "ring of another T":
        s["ring"] = s["ring"][:1]
    elif case == "stats of another shape":
        s["stats"] = s["stats"][:, :3]
    elif case == "no vertices":
        s["res"], s["ring"] = s["res"][:, :, :0], s["ring"][:, :, :, :0]
    return s, -1 if case == "negative frame" else 2


@pytest.mark.parametrize("case", ["V above 16", "float64 reservoir",
                                  "ring of another T",
                                  "stats of another shape", "no vertices",
                                  "negative frame"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case, monkeypatch):
    """Refused before anything is built (no nvcc here: a build would
    raise RuntimeError, not ValueError)."""
    monkeypatch.setattr(rr, "_kernel", None)
    s, frame = _bad(case)
    with pytest.raises(ValueError):
        rr.temporal_reuse(s["seeds"], s["res"], s["ring"], s["stats"],
                          s["mis"], s["pinfo"], frame, 2, 0.8, True)
    if case not in ("ring of another T", "negative frame"):
        with pytest.raises(ValueError):
            rr.spatial_reuse(s["seeds"], s["res"], s["stats"], s["mis"],
                             s["pinfo"], 3, 0.8, True)
    assert rr.temporal_reuse.launches == rr.spatial_reuse.launches == 0


def test_reuse_phase_rehearsed(monkeypatch):
    """chip_smoke.py's reuse phase on the CPU: its 1080p run at 32x18 on
    the 8^3 volume, one small case and the random inputs, with the
    card's synchronization, launch counts and timers stubbed; the stage
    calls it records are held to the plain versions (here the same code,
    so equal), the states it steps from to their bits."""
    small = AppConfig(render_width=32, render_height=18)
    monkeypatch.setattr("nrc_hpm_tpu_torch.config.AppConfig",
                        lambda: small)
    # two frames and one small case run every branch of the phase
    monkeypatch.setattr(chip_smoke, "REUSE_FRAMES", 2)
    monkeypatch.setattr(chip_smoke, "REUSE_SMALL",
                        chip_smoke.REUSE_SMALL[:1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "read_launches",
                        lambda: {k: 1 for k in chip_smoke.REUSE})
    for name in ("device_ms", "back_to_back_ms"):
        monkeypatch.setattr(chip_smoke, name, lambda *a, **k: 1.0)
    monkeypatch.setattr(chip_smoke, "sm_clock", lambda: "stubbed")
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    vol = Volume.from_dense(data, 0.6, 0.8, device="cpu")
    rows = chip_smoke.reuse_phase(torch, torch.device("cpu"), vol, "cpu")
    assert [r["name"] for r in rows] == ["restir.temporal_reuse",
                                         "restir.spatial_reuse"]
    lanes = 32 * 18
    assert [r["bound_ms"] for r in rows] == pytest.approx(
        [1e3 * 4 * lanes * n / chip_smoke.HBM_BYTES_S for n in (247, 105)])
