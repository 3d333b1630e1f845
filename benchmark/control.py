#!/usr/bin/env python3
"""The readings that set the limits of a cell's comparison, in one
process on the card:

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        [--control] [--fault unchanged|half_batch|altered] [--seconds 3]

For each seed it runs the cell with a short window (long enough to reach
the window frame the reference works out again) and prints the
comparison's numbers as one JSON line.  By default the port is the
program; ``--control`` puts the plain reference in its place, computed in
the next precision below the configuration's, as the traffic's
``control`` says (the MLP in float8 e4m3 for the NRC cells, the path
state in bfloat16 for the MC cell);
``--fault`` plants one of ``harness/faults.py``'s faults under the port.
The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    import torch
    from harness import cell, faults, registry

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = registry.load_benchmark()
    w = registry.workload(bench, args.workload)
    extra = {}
    fault = faults.FAULTS[args.fault] if args.fault else None
    if args.control:
        ctl = registry.traffic(w["traffic"])["control"]
        extra = dict(program="reference",
                     program_overrides=ctl.get("overrides"))
        if "fault" in ctl:
            fault = getattr(faults, ctl["fault"])
    for seed in (int(s) for s in args.seeds.split(",")):
        run = cell.run(args.workload, seed, args.seconds, False, "cuda",
                       time.perf_counter(), fault=fault, **extra)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "fault": args.fault,
                          "setup_s": run["setup_s"],
                          "frames": run["window"].completed,
                          "numbers": run["numbers"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
