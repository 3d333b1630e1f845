"""Finding a cell's parts by name.  ``BENCHMARK.json`` names each cell's
configuration and traffic mix; each lives in a file of its own under the
benchmark's folder, so a later change adds a cell by adding files:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the traffic mix's parameters;
- ``cameras/<camera>.py``: the camera of each frame (``make``);
- ``metrics/<metric>.py``: a per-layer metric's reader;
- ``rooflines/<kernel>.py``: a kernel's operations and bytes;
- ``checks/<workload>.json``: the limits of the cell's comparison.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent       # the benchmark's folder
ROOT = HERE.parent                                  # the checkout's root


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str, base: Path) -> dict:
    path = Path(base) / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def config(name: str, base: Path = HERE) -> dict:
    return _json("configs", name, base)


def traffic(name: str, base: Path = HERE) -> dict:
    return _json("traffic", name, base)


def checks(name: str, base: Path = HERE) -> dict:
    return _json("checks", name, base)


def _module(kind: str, name: str, base: Path):
    path = Path(base) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def camera(name: str, base: Path = HERE):
    """A camera source: ``make(camera_module, device)`` returns the
    function from a frame's index to its ``Camera``."""
    return _module("cameras", name, base)


def metric(name: str, base: Path = HERE):
    """A per-layer metric: LAYER, SOURCE, UNIT, MOVES, ``read(t)`` and the
    probes it needs (SPANS, CALLS, COUNTERS, ROOFLINES)."""
    return _module("metrics", name, base)


def roofline(name: str, base: Path = HERE):
    """A kernel's roofline: KERNEL (its name in the trace), WRAPS (the
    port's function whose calls it counts), ``sizes`` and ``cost``."""
    return _module("rooflines", name, base)


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The names of the ``end_to_end`` or ``per_layer`` metrics that
    ``cell`` reports: those without a ``workloads`` list, and those whose
    list names it."""
    return [m["name"] for m in bench[kind]
            if cell in m.get("workloads", [cell])]
