"""The port against the JAX package at scene presets 1 and 2, lit by a
point light in the medium (finite shadow rays; 2 at density 1.0): two
online frames and one MC step at 48x27 on the 8^3 volume built at each
preset's density (``torch_scenes_parity``, which states the
tolerances)."""

import pytest

import torch_scenes_parity as sp

CASES = sp.cases("preset1", "preset2")
FREE = CASES


@pytest.mark.parametrize("case", FREE)
def test_two_online_frames_match(case):
    sp.two_online_frames(case)


@pytest.mark.parametrize("case", CASES)
def test_second_frame_from_jax_state_matches(case):
    sp.two_online_frames(case, anchored=True)


@pytest.mark.parametrize("case", CASES)
def test_mc_step_matches(case):
    sp.mc_step(case)
