#!/usr/bin/env python3
"""Run one cell of the benchmark of ``nrc_hpm_tpu_torch`` on this machine's
NVIDIA GPU and print its result as the last line of standard output:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration and traffic mix, which live in ``configs/`` and
``traffic/``.  With ``--trace 0`` the line holds the cell's end-to-end
metrics (``end_to_end/<name>.py``), with ``--trace 1`` its per-layer
metrics (``metrics/<name>.py``), read from a bounded run of profiled
frames inside the window.  After the window the plain reference
(``reference/``) works the cell's frames out again, and ``correct`` says
whether every number of the comparison lies within its limit
(``checks/<workload>.json``); the numbers and limits end standard error
and the line.  Without a CUDA device, or with fewer than the cell asks
for, it exits with code 1 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse      # noqa: E402
import importlib.util  # noqa: E402
import json          # noqa: E402
import os            # noqa: E402
import subprocess    # noqa: E402
import sys           # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
# the port's kernels build into its own _build/ folder inside the
# checkout; any other build cache goes beside them, at fixed paths
_CACHE = os.path.join(ROOT, "nrc_hpm_tpu_torch", "_build")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
# top-level module names the process must not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "nrc_hpm_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def gpu_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def read_end_to_end(name: str, run: dict) -> float:
    path = os.path.join(HERE, "end_to_end", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_e2e_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return float(mod.read(run))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from harness import cell, registry

    bench = registry.load_benchmark()
    w = registry.workload(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        log(f"{args.workload} needs {w['chips']} CUDA device(s); "
            f"torch sees {torch.cuda.device_count()}")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    log(f"{args.workload} seed {args.seed}: {gpu_line()}, "
        f"torch {torch.__version__}")

    run = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", T_START)
    correct, rows = cell.verdict(run["numbers"],
                                 registry.checks(args.workload))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": w["chips"], "memory_peak_bytes": run["peak_bytes"]}
    line = {"correct": correct, "attempted": len(run["window"].ends),
            "failed": 0}
    if args.trace:
        t = run["traced"]
        if t is None:
            log("the window ended before the traced frames")
            return 1
        metrics = {}
        for name in registry.cell_metrics(bench, args.workload,
                                          "per_layer"):
            mod = registry.metric(name)
            value = mod.read(t)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": mod.UNIT}
        device.update(busy_s=t.busy_s, window_s=t.wall_s)
        line["breakdown"] = t.breakdown()
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {name: {"value": read_end_to_end(name, run),
                          "unit": units[name]}
                   for name in registry.cell_metrics(bench, args.workload,
                                                     "end_to_end")}
    line["metrics"] = metrics
    line["device"] = device
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}

    leftover = forbidden_modules()
    if leftover:
        log(f"the process holds {', '.join(leftover)}")
        return 1
    for k, v, lim in rows:
        log(f"check {k}: {v!r} limit {lim!r} "
            f"{'ok' if v <= lim else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
