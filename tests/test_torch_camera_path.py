"""The port's camera controller and camera-path player against the JAX
package: the cases of tests/test_camera_path.py and
test_utils_io.py::test_camera_controllers, each run through both.

Tolerances: position, view direction and the camera's inverse
projection-view matrix within 1e-6 (relative and absolute; both build
them with the same numpy code), ``changed`` flags equal."""

import json

import numpy as np
import pytest

from nrc_hpm_tpu import camera as jcam
from nrc_hpm_tpu import camera_path as jcp
from nrc_hpm_tpu_torch import camera as tcam
from nrc_hpm_tpu_torch import camera_path as tcp


def _same_camera(t, j):
    for a, b in ((t.pos, j.pos), (t.inv_proj_view, j.inv_proj_view)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def _players(tmp_path, doc, aspect=16 / 9):
    p = tmp_path / "path.json"
    p.write_text(json.dumps(doc))
    return (tcp.CameraPath.load(str(p)).player(aspect, device="cpu"),
            jcp.CameraPath.load(str(p)).player(aspect))


def _play(tmp_path, doc, frames, aspect=16 / 9):
    """Both players over ``frames`` frames: cameras, pos and view within
    1e-6, changed flags equal.  Returns the port's player and flags."""
    tp, jp = _players(tmp_path, doc, aspect)
    _same_camera(tp.camera, jp.camera)
    flags = []
    for f in range(frames):
        (tc, tch), (jc, jch) = tp.update(f), jp.update(f)
        assert tch == jch
        flags.append(tch)
        _same_camera(tc, jc)
        np.testing.assert_allclose(tp.pos, jp.pos, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tp.view, jp.view, rtol=1e-6, atol=1e-6)
    return tp, flags


def test_keys_move_matches_input_cpp_speed(tmp_path):
    tp, flags = _play(tmp_path, {
        "start": {"pos": [64, 0, 0], "view_dir": [-1, 0, 0]},
        "commands": [{"frame": 0, "keys": "W", "frames": 3}]}, 4)
    assert flags == [True, True, True, False]
    np.testing.assert_allclose(tp.pos, [64 - 3 * 20 / 60, 0, 0], atol=1e-5)


def test_shift_multiplies_speed_10x(tmp_path):
    tp, _ = _play(tmp_path, {
        "start": {"pos": [0, 0, 0], "view_dir": [0, 0, 1]},
        "commands": [{"frame": 0, "keys": "W", "shift": True}]}, 1, 1.0)
    np.testing.assert_allclose(tp.pos, [0, 0, 200 / 60], atol=1e-5)


def test_mouse_scaling_matches_reference(tmp_path):
    tp, flags = _play(tmp_path, {
        "start": {"pos": [0, 0, 0], "view_dir": [0, 0, 1]},
        "commands": [{"frame": 0, "mouse": [10, 0]}]}, 1, 1.0)
    assert flags == [True]
    _, (_, want_view) = tcam.camera_rotate(
        tcam.Camera.create(np.zeros(3), np.array([0, 0, 1.0]),
                           device="cpu"),
        np.zeros(3), np.array([0, 0, 1.0]), -0.05, 0.0)
    np.testing.assert_allclose(tp.view, want_view, atol=1e-6)


def test_static_frames_report_unchanged(tmp_path):
    _, flags = _play(tmp_path, {
        "commands": [{"frame": 5, "move": [1, 0, 0]}]}, 6, 1.0)
    assert flags == [False] * 5 + [True]


def test_raw_move_uses_camera_frame(tmp_path):
    start_pos = np.array([1.0, 2.0, 3.0], np.float32)
    view = np.array([0.5, 0.0, 0.5], np.float32)
    tp, _ = _play(tmp_path, {
        "start": {"pos": start_pos.tolist(), "view_dir": view.tolist()},
        "commands": [{"frame": 0, "move": [0.25, -0.5, 1.5]}]}, 1, 1.0)
    vn = view / np.linalg.norm(view)
    _, (want_pos, _) = tcam.camera_move(
        tcam.Camera.create(start_pos, vn, device="cpu"), start_pos, vn,
        [0.25, -0.5, 1.5])
    np.testing.assert_allclose(tp.pos, want_pos, atol=1e-5)


def test_every_command_over_a_path(tmp_path):
    """Keys (with space, C and shift), mouse, raw move, rotate and orbit,
    overlapping and held over several frames, at 30 fps."""
    _, flags = _play(tmp_path, {
        "start": {"pos": [40, 10, -20], "view_dir": [-1, -0.2, 0.5]},
        "fps": 30.0,
        "commands": [
            {"frame": 0, "keys": "W, D", "frames": 3},
            {"frame": 1, "keys": "space", "shift": True},
            {"frame": 2, "keys": "S A C", "frames": 2},
            {"frame": 3, "mouse": [-7, 4], "frames": 2},
            {"frame": 6, "move": [0.5, 0.25, -1.0]},
            {"frame": 7, "rotate": [0.1, -0.05], "frames": 2},
            {"frame": 9, "orbit": {"axis": [0, 1, 0.2], "angle": 0.3},
             "frames": 2}]}, 12)
    assert flags == [True] * 5 + [False] + [True] * 5 + [False]


def test_unknown_key_raises_in_both(tmp_path):
    tp, jp = _players(tmp_path, {"commands": [{"frame": 0, "keys": "Q"}]})
    for p in (tp, jp):
        with pytest.raises(ValueError, match="unknown key"):
            p.update(0)


def test_camera_controllers_match_jax():
    tc = tcam.Camera.reference_camera(device="cpu")
    jc = jcam.Camera.reference_camera()
    t2, (tp, tv) = tcam.camera_move(tc, (64, 0, 0), (-1, 0, 0),
                                    (0.5, 0.2, 1.0))
    j2, (jp, jv) = jcam.camera_move(jc, (64, 0, 0), (-1, 0, 0),
                                    (0.5, 0.2, 1.0))
    _same_camera(t2, j2)
    np.testing.assert_allclose(tp, [63.0, 0.2, -0.5], atol=1e-5)
    t3, (tp3, tv3) = tcam.camera_rotate(t2, tp, tv, 0.3, 0.1)
    j3, (jp3, jv3) = jcam.camera_rotate(j2, jp, jv, 0.3, 0.1)
    _same_camera(t3, j3)
    np.testing.assert_allclose(tv3, jv3, rtol=1e-6, atol=1e-6)
    assert abs(np.linalg.norm(tv3) - 1.0) < 1e-5
    t4, (tp4, tv4) = tcam.camera_rotate_around_origin(t3, tp3, (0, 1, 0),
                                                      0.5)
    j4, (jp4, jv4) = jcam.camera_rotate_around_origin(j3, jp3, (0, 1, 0),
                                                      0.5)
    _same_camera(t4, j4)
    np.testing.assert_allclose(tp4, jp4, rtol=1e-6, atol=1e-6)
    # the orbit keeps the distance to the origin and looks at it
    assert abs(np.linalg.norm(tp4) - np.linalg.norm(tp3)) < 1e-3
    assert np.dot(tv4, -tp4 / np.linalg.norm(tp4)) > 0.999
    assert t4.pos.device == tc.pos.device
