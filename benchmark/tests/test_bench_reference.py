"""The plain reference is a frozen copy of the port's plain paths: on the
CPU, where the port runs its plain versions too, both give the same bits
from the same seed, cloud and camera (the CPU tests hold the port to the
JAX package)."""

import pytest
import torch

from conftest import SMALL
from harness import registry, sides


@pytest.mark.parametrize("config", ["nrc-p4-1080p", "nrc-p5-1080p"])
def test_reference_frames_equal_the_port_on_the_cpu(config):
    cfg_file = registry.config(config)
    dens = sides.make_cloud(cfg_file)
    out = {}
    for pkg in ("nrc_hpm_tpu_torch", "reference"):
        nrc = sides.build(pkg, cfg_file, registry.traffic("online"), dens,
                          "cpu", SMALL)
        st = nrc.renderer.init_state(123456789012)
        for i in range(2):
            st = nrc.renderer.step(st, nrc.camera(i))
        frozen = nrc.renderer.step(st, nrc.camera(2), train=False)
        mc = sides.build(pkg, cfg_file, registry.traffic("mc"), dens, "cpu",
                         SMALL)
        m = mc.renderer.step(mc.renderer.init_state(7), mc.camera(0))
        out[pkg] = (st, frozen, m)
    (p, pf, pm), (r, rf, rm) = out["nrc_hpm_tpu_torch"], out["reference"]
    assert torch.equal(p.image, r.image) and torch.equal(pf.image, rf.image)
    assert torch.equal(pm.image, rm.image)
    assert torch.equal(p.nrc.loss, r.nrc.loss)
    assert torch.equal(p.nrc.params["encoding"]["hash_table"],
                       r.nrc.params["encoding"]["hash_table"])
    for a, b in zip(p.nrc.ema_params["mlp"]["layers"],
                    r.nrc.ema_params["mlp"]["layers"]):
        assert torch.equal(a, b)
    assert torch.equal(p.ring.data, r.ring.data)
