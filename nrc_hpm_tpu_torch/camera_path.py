"""Camera paths from config: the headless form of the reference's
interactive camera controller.

Port of ``nrc_hpm_tpu/camera_path.py``, same JSON schema.  The reference
drives its camera through keyboard and mouse input each frame (WASD moves
at 20 units/s in the camera frame with Y locked to world up, right-drag
mouse-look at 0.005 rad/px, shift = 10x); this module replays a JSON
command script through the same camera helpers (``camera.camera_move`` /
``camera_rotate`` / ``camera_rotate_around_origin``).

Path file schema (JSON)::

    {
      "start": {"pos": [x,y,z], "view_dir": [x,y,z]},   # optional
      "fps": 60.0,                                       # dt = 1/fps
      "commands": [
        # keys move in the camera frame, scaled by 20*dt like Input.cpp
        {"frame": 0,  "keys": "W",  "frames": 30},       # WASD + space/C
        {"frame": 0,  "shift": true, "keys": "W"},       # 10x speed
        # mouse-look: pixels of mouse movement, scaled by -0.005 rad/px
        {"frame": 30, "mouse": [dx, dy], "frames": 10},
        # raw forms (no Input.cpp scaling): explicit deltas per frame
        {"frame": 40, "move": [side, up, front]},
        {"frame": 45, "rotate": [phi, theta]},           # radians
        {"frame": 50, "orbit": {"axis": [0,1,0], "angle": 0.02}}
      ]
    }

``frames`` repeats a command over that many consecutive frames (a held
key / a steady drag).  Any frame on which at least one command applies
reports ``changed=True`` so the app can reset accumulation, mirroring the
reference's ``cam->SetChanged`` (src/Input.cpp:95).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from .camera import (Camera, camera_move, camera_rotate,
                     camera_rotate_around_origin)

_KEY_AXES = {  # key -> (side, up, front) sign
    "W": (0, 0, 1.0), "S": (0, 0, -1.0),
    "D": (1.0, 0, 0), "A": (-1.0, 0, 0),
    "SPACE": (0, 1.0, 0), "C": (0, -1.0, 0),
}


@dataclass
class CameraPath:
    start_pos: np.ndarray
    start_view: np.ndarray
    fps: float = 60.0
    commands: list = field(default_factory=list)

    @staticmethod
    def load(path: str, default_pos=(64.0, 0.0, 0.0),
             default_view=(-1.0, 0.0, 0.0)) -> "CameraPath":
        with open(path) as f:
            doc = json.load(f)
        start = doc.get("start", {})
        return CameraPath(
            start_pos=np.asarray(start.get("pos", default_pos), np.float32),
            start_view=np.asarray(start.get("view_dir", default_view),
                                  np.float32),
            fps=float(doc.get("fps", 60.0)),
            commands=list(doc.get("commands", [])))

    def player(self, aspect: float, device="cuda") -> "CameraPathPlayer":
        return CameraPathPlayer(self, aspect, device)


class CameraPathPlayer:
    """Stateful per-frame camera updater over a CameraPath; its cameras
    live on ``device``."""

    def __init__(self, path: CameraPath, aspect: float, device="cuda"):
        self._path = path
        self._aspect = aspect
        self._device = device
        self.pos = np.asarray(path.start_pos, np.float32)
        self.view = np.asarray(path.start_view, np.float32)
        self.view = self.view / max(np.linalg.norm(self.view), 1e-12)
        self.camera = Camera.create(self.pos, self.view, aspect=aspect,
                                    device=device)

    def _active(self, frame: int):
        for cmd in self._path.commands:
            f0 = int(cmd.get("frame", 0))
            if f0 <= frame < f0 + int(cmd.get("frames", 1)):
                yield cmd

    def update(self, frame: int):
        """Apply all commands active on ``frame``.

        Returns (camera, changed); ``changed`` mirrors the reference's
        cameraChanged flag."""
        dt = 1.0 / self._path.fps
        changed = False
        cam = self.camera
        for cmd in self._active(frame):
            if "keys" in cmd:
                speed = 20.0 * dt * (10.0 if cmd.get("shift") else 1.0)
                move = np.zeros(3, np.float32)
                for key in str(cmd["keys"]).replace(",", " ").split():
                    ax = _KEY_AXES.get(key.upper())
                    if ax is None:
                        raise ValueError(f"unknown key {key!r}")
                    move += np.asarray(ax, np.float32)
                cam, (self.pos, self.view) = camera_move(
                    cam, self.pos, self.view, move * speed)
                changed = True
            if "mouse" in cmd:
                dx, dy = (-0.005 * float(v) for v in cmd["mouse"])
                cam, (self.pos, self.view) = camera_rotate(
                    cam, self.pos, self.view, dx, dy)
                changed = True
            if "move" in cmd:
                cam, (self.pos, self.view) = camera_move(
                    cam, self.pos, self.view,
                    np.asarray(cmd["move"], np.float32))
                changed = True
            if "rotate" in cmd:
                phi, theta = (float(v) for v in cmd["rotate"])
                cam, (self.pos, self.view) = camera_rotate(
                    cam, self.pos, self.view, phi, theta)
                changed = True
            if "orbit" in cmd:
                o = cmd["orbit"]
                cam, (self.pos, self.view) = camera_rotate_around_origin(
                    cam, self.pos, np.asarray(o["axis"], np.float32),
                    float(o["angle"]))
                changed = True
        if changed:
            cam = Camera.create(self.pos, self.view, aspect=self._aspect,
                                device=self._device)
        self.camera = cam
        return cam, changed
