"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repository root.  Tests marked ``card`` need an NVIDIA GPU; they decide
inside the test, through the ``card`` fixture, and skip without one."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.dirname(HERE), HERE):
    if path not in sys.path:
        sys.path.insert(0, path)

# the size the CPU tests run a cell at: the configuration's widths and
# depths, a 32x18 frame, 4 x 64 train samples, 2^12 tables, 4 bounces
SMALL = dict(render_width=32, render_height=18, log2_train_batch_size=6,
             train_ray_length=4, mc_path_length=4,
             encoding={"log2_hashmap_size": 12})


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (runs on the card only)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")
    return torch.device("cuda")
