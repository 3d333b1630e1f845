#!/usr/bin/env python3
"""Time kernels K1 (``pw_events``) and K3 (``fused_encode_mlp_infer``) of
this checkout against those of another checkout of the port on one GPU.

    git archive <commit> nrc_hpm_tpu_torch | tar -x -C _checkout/other
    python3 kernel_ab.py _checkout/other

The other checkout's ``nrc_hpm_tpu_torch`` package is imported under
another name and builds its own kernels into its own ``_build/``.  Both
take the inputs of ``chip_smoke.py``'s kernel phase (camera rays through
the procedural cloud for K1, S = 16; a unit-scale 2^19 table and random
inputs for K3) and are timed in turns, other, this, this, other, by their
device time in torch.profiler: K1 on 2^20, 65,536 and 1,024 lanes, K3 on
2^20 samples and on a 1080p online frame's count.  Each result is checked against this checkout's
plain version first.  Prints the card's name and power limit, one line per
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
    from nrc_hpm_tpu_torch.ops import fused_encode_mlp as fem
    from nrc_hpm_tpu_torch.ops import pw_kernels as pk
    from nrc_hpm_tpu_torch.utils.procedural import cloud_density
    from nrc_hpm_tpu_torch.volume import Volume

    import_other(argv[0])
    from nrc_other.ops import fused_encode_mlp as fem_o
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
    for n in K3_SAMPLES:
        k3 = (fargs[0], fargs[1], fargs[2][:n], fargs[3])
        cases.append((f"fused_encode_mlp {n} samples", "fused_encode_mlp",
                      lambda mod, k3=k3: mod.fused_encode_mlp_infer(*k3),
                      (fem_o, fem)))
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
