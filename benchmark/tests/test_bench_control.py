"""The comparison that decides ``correct`` separates a sound run from its
control and from the faults a cell can have, on the CPU at a small size
with the cells' own limits: the port passes; the reference in the next
precision below the configuration's (the control), put in the program's
place, fails; each planted fault fails."""

import json
import time

import pytest

from conftest import SMALL
from harness import cell, faults, registry

SEED = 3141592653

CASES = [
    ("p4-online", None, {}),
    ("p4-online", "control", dict(program="reference", program_overrides={
        "mlp_dtype": "float8"})),
    ("p4-online", "unchanged", dict(fault=faults.unchanged)),
    ("p4-online", "half_batch", dict(fault=faults.half_batch)),
    ("p4-online", "altered", dict(fault=faults.altered)),
    ("p4-frozen", None, {}),
    ("p4-frozen", "control", dict(program="reference", program_overrides={
        "mlp_dtype": "float8"})),
    ("p4-frozen", "altered", dict(fault=faults.altered)),
    ("p4-mc", None, {}),
    ("p4-mc", "control", dict(program="reference",
                              fault=faults.lowp_paths)),
    ("p4-mc", "altered", dict(fault=faults.altered)),
]


# p4-mc is not a cell of BENCHMARK.json: its host-bound rate swings by more
# than any bound allows (PERF.md).  Its traffic, limits, control and faults
# stay, so that the cell comes back as one entry; the tests run it from a
# copy of BENCHMARK.json that names it.
PARKED = [{"name": "p4-mc", "config": "nrc-p4-1080p", "traffic": "mc",
           "chips": 1, "why": "closed loop of MC frames"}]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    bench = registry.load_benchmark()
    bench["workloads"] += [w for w in PARKED if w["name"] not in
                           {c["name"] for c in bench["workloads"]}]
    path = tmp_path_factory.mktemp("root")
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return path


def _verdict(workload, kw, root):
    run = cell.run(workload, SEED, 0.5, False, "cpu", time.perf_counter(),
                   root=root, overrides=SMALL, **kw)
    return cell.verdict(run["numbers"], registry.checks(workload))


@pytest.mark.parametrize("workload,case,kw", CASES,
                         ids=[f"{w}-{c or 'sound'}" for w, c, _ in CASES])
def test_correct_separates_sound_runs_from_control_and_faults(workload, case,
                                                              kw, root):
    correct, rows = _verdict(workload, kw, root)
    assert correct == (case is None), rows


@pytest.mark.card
def test_cell_on_the_card(card):
    """One short run of the first cell on the card, traced: the port is
    correct and every per-layer metric of the cell reads."""
    run = cell.run("p4-online", SEED, 5.0, True, "cuda", time.perf_counter())
    correct, rows = cell.verdict(run["numbers"],
                                 registry.checks("p4-online"))
    assert correct, rows
    bench = registry.load_benchmark()
    for name in registry.cell_metrics(bench, "p4-online", "per_layer"):
        assert registry.metric(name).read(run["traced"]) is not None, name
