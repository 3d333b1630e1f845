#!/usr/bin/env python3
"""Time kernels K1 (``pw_events``), K2 (``pw_profile``), K3
(``fused_encode_mlp_infer``), K4 (``fused_mlp_infer``), K7
(``hash_grid_train_fwd``) and K7' (``hash_grid_train_bwd``) of this
checkout against those of another checkout of the port on one GPU.

    git archive <commit> nrc_hpm_tpu_torch | tar -x -C _checkout/other
    python3 kernel_ab.py _checkout/other

The other checkout's ``nrc_hpm_tpu_torch`` package is imported under
another name and builds its own kernels into its own ``_build/``.  Both
take the inputs of ``chip_smoke.py``'s kernel phase (camera rays through
the procedural cloud for K1, S = 16, and K2; a unit-scale 2^19 table and
random inputs for K3; 80 Frequency + TriangleWave features of random
inputs and a seeded 64x6 MLP for K4; random positions, unit-scale tables
and gradients for K7 and K7') and are timed in turns, other, this, this,
other, by their device time in torch.profiler: K1, and K2 with and
without the control draw, on 2^20, 65,536 and 1,024 lanes; K3 on 2^20
samples and on a 1080p online frame's count; K4 on 2^20 samples; K7 and
K7' on 2^14 (one Adam step's batch) and 2^20 random samples at the
float32 2^19 and the packed 2^12 tables, and on the first train batch of
a second online 1080p frame (float32 2^19).  Each result is checked
against this checkout's plain version first.  Prints the card's name and power limit, one line per
shape and a JSON summary; without a CUDA device it exits with code 1.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
# K3 at 2^20 samples and at the 293,441 scattered samples that
# chip_smoke.py's profiled online frame infers
K3_SAMPLES = (1 << 20, 293_441)
# K7' (packed, samples) on random positions: the float32 2^19 table of
# AppConfig() and the packed 2^12 table of AppConfig.tpu_tuned(), each at
# one train batch and at 2^20
K7_CASES = ((False, 1 << 14), (False, 1 << 20), (True, 1 << 14),
            (True, 1 << 20))


def frame_batch(torch, dev, cfg, vol, hgt):
    """(table, x, gout) of the first K7 and K7' launches of the second
    online 1080p frame at ``cfg``, rendered by this checkout: a train batch
    that repeats positions as frames do."""
    from nrc_hpm_tpu_torch.camera import Camera
    from nrc_hpm_tpu_torch.renderer import NrcRenderer

    seen = {"fwd": [], "bwd": []}
    fwd, bwd = hgt.hash_grid_train_fwd, hgt.hash_grid_train_bwd

    def record_fwd(table, x, spec, packed):
        seen["fwd"].append(table.clone())
        return fwd(table, x, spec, packed)

    def record_bwd(x, gout, spec, packed):
        seen["bwd"].append((x.clone(), gout.clone()))
        return bwd(x, gout, spec, packed)

    # the wrappers count on their module's names
    record_fwd.launches = record_bwd.launches = 0
    hgt.hash_grid_train_fwd, hgt.hash_grid_train_bwd = record_fwd, record_bwd
    try:
        r = NrcRenderer(cfg, vol)
        cam = Camera.reference_camera(aspect=r.width / r.height, device=dev)
        state = r.step(r.init_state(seed=0), cam)
        seen["fwd"].clear()
        seen["bwd"].clear()
        r.step(state, cam)
    finally:
        hgt.hash_grid_train_fwd, hgt.hash_grid_train_bwd = fwd, bwd
    return (seen["fwd"][0],) + seen["bwd"][0]


def k4_inputs(torch, dev, cfg, gen):
    """K4's arguments as chip_smoke.py's kernel phase makes them: a seeded
    MLP of ``cfg``'s shape on 2^20 samples of the 80 Frequency(12) +
    TriangleWave(4) features of random inputs."""
    import dataclasses

    import chip_smoke as cs
    from nrc_hpm_tpu_torch.config import EncodingConfig
    from nrc_hpm_tpu_torch.models.nrc.cache import NeuralRadianceCache

    cache = NeuralRadianceCache(dataclasses.replace(
        cfg, encoding=EncodingConfig(pos_id=3, dir_id=2)))
    mlp = cache.init_state(cs.seeded_key(torch, gen), dev).ema_params["mlp"]
    x5 = torch.rand((cs.N_K4, 5), generator=gen).to(dev)
    return mlp, cache.encoding({}, x5)


def import_other(path: str):
    """The package ``path``/nrc_hpm_tpu_torch as ``nrc_other``."""
    pkg = os.path.join(os.path.abspath(path), "nrc_hpm_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "nrc_other", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["nrc_other"] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from nrc_hpm_tpu_torch.config import AppConfig
    from nrc_hpm_tpu_torch.models.nrc.encoding import (CompositeEncoding,
                                                       pack_table_bf16)
    from nrc_hpm_tpu_torch.ops import fused_encode_mlp as fem
    from nrc_hpm_tpu_torch.ops import fused_mlp as fm
    from nrc_hpm_tpu_torch.ops import hash_grid_train as hgt
    from nrc_hpm_tpu_torch.ops import pw_kernels as pk
    from nrc_hpm_tpu_torch.utils.procedural import cloud_density
    from nrc_hpm_tpu_torch.volume import Volume

    import_other(argv[0])
    from nrc_other.ops import fused_encode_mlp as fem_o
    from nrc_other.ops import fused_mlp as fm_o
    from nrc_other.ops import hash_grid_train as hgt_o
    from nrc_other.ops import pw_kernels as pk_o

    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    print(gpu)
    cfg = AppConfig()
    vol = Volume.from_dense(cloud_density(seed=0), cfg.scene.density,
                            cfg.scene.volume_g, device=dev)
    gen = torch.Generator().manual_seed(1)
    start, rd, tmax, seed, e_last = cs.camera_lanes(torch, dev, vol, cfg, gen)
    fargs = cs.k3_inputs(torch, dev, cfg, gen)
    args = (vol, start, rd, tmax, seed, e_last, 0)
    want = pk.pw_events_plain(*args, S=16)
    for label, mod in (("other", pk_o), ("this", pk)):
        cs.compare(torch, f"pw_events {label}", mod.pw_events(*args, S=16),
                   want, **cs.PW_TOL)
    for ctrl in (True, False):
        want = pk.pw_profile_plain(*args[:5], want_ctrl=ctrl)
        for label, mod in (("other", pk_o), ("this", pk)):
            cs.compare(torch, f"pw_profile want_ctrl={ctrl} {label}",
                       mod.pw_profile(*args[:5], want_ctrl=ctrl), want,
                       **cs.PW_TOL)
    want = dict(out=fem.fused_encode_mlp_plain(*fargs))
    for label, mod in (("other", fem_o), ("this", fem)):
        cs.compare(torch, f"fused_encode_mlp {label}",
                   dict(out=mod.fused_encode_mlp_infer(*fargs)), want,
                   **cs.K3_TOL)

    cases = []
    for m in cs.PW_TIME_LANES:
        sub = (vol,) + tuple(a[:m] for a in args[1:6]) + (0,)
        cases.append((f"pw_events {m} lanes", "pw_events",
                      lambda mod, sub=sub: mod.pw_events(*sub, S=16),
                      (pk_o, pk)))
        for ctrl in (True, False):
            cases.append((f"pw_profile want_ctrl={ctrl} {m} lanes",
                          "pw_profile",
                          lambda mod, sub=sub, ctrl=ctrl: mod.pw_profile(
                              *sub[:5], want_ctrl=ctrl), (pk_o, pk)))
    for n in K3_SAMPLES:
        k3 = (fargs[0], fargs[1], fargs[2][:n], fargs[3])
        cases.append((f"fused_encode_mlp {n} samples", "fused_encode_mlp",
                      lambda mod, k3=k3: mod.fused_encode_mlp_infer(*k3),
                      (fem_o, fem)))
    mlp, feats = k4_inputs(torch, dev, cfg, gen)
    want = dict(out=fm.fused_mlp_plain(mlp, feats))
    for label, mod in (("other", fm_o), ("this", fm)):
        cs.compare(torch, f"fused_mlp {label}",
                   dict(out=mod.fused_mlp_infer(mlp, feats)), want,
                   **cs.K4_TOL)
    cases.append((f"fused_mlp {feats.shape[0]} x {feats.shape[1]}, 64x6",
                  "fused_mlp", lambda mod: mod.fused_mlp_infer(mlp, feats),
                  (fm_o, fm)))
    k7 = []
    for packed, n in K7_CASES:
        enc = (AppConfig.tpu_tuned() if packed else cfg).encoding
        spec = CompositeEncoding(enc).grid_spec
        table = (torch.rand((spec.total_params, 2), generator=gen) * 2 - 1
                 ).to(dev)
        x = (torch.rand((n, 3), generator=gen) * 1.2 - 0.1).to(dev)
        g = torch.randn((n, spec.out_dim), generator=gen).to(dev)
        k7.append((packed, enc, f"{n} samples",
                   pack_table_bf16(table) if packed else table,
                   (x, g, spec, packed)))
    table, x, g = frame_batch(torch, dev, cfg, vol, hgt)
    k7.append((False, cfg.encoding, "a frame's batch", table,
               (x, g, CompositeEncoding(cfg.encoding).grid_spec, False)))
    for packed, enc, what, table, bargs in k7:
        x, g, spec, _ = bargs
        n = x.shape[0]
        tag = (f"{'packed' if packed else 'float32'} "
               f"2^{enc.log2_hashmap_size}")
        fargs = (table, x, spec, packed)
        want = dict(out=hgt.hash_grid_train_fwd_plain(*fargs))
        for label, mod in (("other", hgt_o), ("this", hgt)):
            cs.compare(torch, f"hash_grid_train_fwd {tag} n={n} {label}",
                       dict(out=mod.hash_grid_train_fwd(*fargs)), want,
                       **cs.K7_FWD_TOL)
        want = dict(dtable=hgt.hash_grid_train_bwd_plain(*bargs))
        scale = dict(dtable=hgt.hash_grid_train_bwd_plain(x, g.abs(), spec,
                                                          packed))
        for label, mod in (("other", hgt_o), ("this", hgt)):
            cs.compare(torch, f"hash_grid_train_bwd {tag} n={n} {label}",
                       dict(dtable=mod.hash_grid_train_bwd(*bargs)), want,
                       scale=scale, **cs.K7_BWD_TOL)
        cases.append((f"hash_grid_train_fwd {tag} {what}",
                      "hash_grid_train_fwd",
                      lambda mod, fargs=fargs: mod.hash_grid_train_fwd(
                          *fargs), (hgt_o, hgt)))
        cases.append((f"hash_grid_train_bwd {tag} {what}",
                      "hash_grid_train_bwd",
                      lambda mod, bargs=bargs: mod.hash_grid_train_bwd(
                          *bargs), (hgt_o, hgt)))
    out = {}
    for label, name, fn, (other, this) in cases:
        times = {"other": [], "this": []}
        for which, mod in (("other", other), ("this", this),
                           ("this", this), ("other", other)):
            times[which].append(cs.device_ms(torch, lambda: fn(mod), name))
        out[label] = {k: statistics.mean(v) for k, v in times.items()}
        print(f"{label}: other {times['other']} ms, this {times['this']} ms "
              f"(device), on {gpu}, clocks {cs.sm_clock()}")
    print(json.dumps({"gpu": gpu, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
