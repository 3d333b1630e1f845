"""Pinhole camera with glm-compatible matrices.

Port of ``nrc_hpm_tpu/camera.py``: glm::perspective (right-handed, [-1, 1]
clip depth) and glm::lookAt built in numpy, per-pixel unprojection
``rd = normalize(invProjView @ (uv*2-1, 0, 1) - pos)``, and the
interactive controller's moves (``camera_move``, ``camera_rotate``,
``camera_rotate_around_origin``) on numpy position and view direction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def perspective(fovy: float, aspect: float, near: float, far: float
                ) -> np.ndarray:
    """glm::perspectiveRH_NO as a row-major matrix acting on column vectors."""
    t = np.tan(0.5 * fovy)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """glm::lookAtRH as a row-major matrix."""
    eye = np.asarray(eye, np.float32)
    f = np.asarray(center, np.float32) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float32))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


@dataclasses.dataclass(frozen=True)
class Camera:
    pos: torch.Tensor            # (3,) float32
    inv_proj_view: torch.Tensor  # (4, 4) float32

    @staticmethod
    def create(pos, view_dir, up=(0.0, 1.0, 0.0), aspect=16.0 / 9.0,
               fovy=np.radians(60.0), near=0.1, far=100.0,
               device="cuda") -> "Camera":
        """Main-loop camera: pos=(64,0,0), dir=(-1,0,0), up=+Y, fov 60 deg."""
        pos = np.asarray(pos, np.float32)
        view_dir = np.asarray(view_dir, np.float32)
        proj = perspective(float(fovy), float(aspect), float(near), float(far))
        view = look_at(pos, pos + view_dir, np.asarray(up, np.float32))
        inv = np.linalg.inv(proj @ view).astype(np.float32)
        return Camera(pos=torch.as_tensor(pos, device=device),
                      inv_proj_view=torch.as_tensor(inv, device=device))

    @staticmethod
    def reference_camera(aspect=16.0 / 9.0, device="cuda") -> "Camera":
        """The fixed golden-image camera (same as the default main camera)."""
        return Camera.create((64.0, 0.0, 0.0), (-1.0, 0.0, 0.0),
                             aspect=aspect, device=device)


def pixel_rays(cam: Camera, width: int, height: int):
    """Per-pixel (origin (3,), dir (H, W, 3), frag_uv (H, W, 2)); frag_uv =
    (x/W, y/H) with x the fast axis, also the RNG seed UV."""
    dev = cam.pos.device
    u = torch.arange(width, dtype=torch.float32, device=dev) * (1.0 / width)
    v = torch.arange(height, dtype=torch.float32, device=dev) * (1.0 / height)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    frag_uv = torch.stack([uu, vv], dim=-1)
    return cam.pos, rays_for_uv(cam, frag_uv), frag_uv


def rays_for_uv(cam: Camera, frag_uv: torch.Tensor) -> torch.Tensor:
    """Unproject (..., 2) UVs to world-space unit directions (full f32)."""
    sc = frag_uv * 2.0 - 1.0
    screen = torch.stack([sc[..., 0], sc[..., 1], torch.zeros_like(sc[..., 0]),
                          torch.ones_like(sc[..., 0])], dim=-1)
    world = screen @ cam.inv_proj_view.T
    rd = world[..., :3] / world[..., 3:4] - cam.pos
    norm = torch.linalg.vector_norm(rd, dim=-1, keepdim=True)
    return rd / torch.clamp(norm, min=1e-20)


def _rotation(axis, angle) -> np.ndarray:
    """Rodrigues' rotation by ``angle`` about ``axis`` (float32)."""
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    c, s = np.cos(angle), np.sin(angle)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]], np.float32)
    return np.eye(3, dtype=np.float32) + s * K + (1 - c) * (K @ K)


def camera_move(cam: Camera, pos, view_dir, move, up=(0.0, 1.0, 0.0)):
    """WASD-style move: ``move`` = (side, up, front) deltas in the camera
    frame, Y locked to world up.  Returns the new Camera (on ``cam``'s
    device) and the updated (pos, view_dir)."""
    pos = np.asarray(pos, np.float32)
    view_dir = np.asarray(view_dir, np.float32)
    up = np.asarray(up, np.float32)
    front = view_dir * np.array([1.0, 0.0, 1.0], np.float32)
    front = front / max(np.linalg.norm(front), 1e-12)
    side = np.cross(view_dir, up)
    side = side / max(np.linalg.norm(side), 1e-12)
    new_pos = pos + front * move[2] + side * move[0] \
        + np.array([0.0, move[1], 0.0], np.float32)
    return (Camera.create(new_pos, view_dir, up, device=cam.pos.device),
            (new_pos, view_dir))


def camera_rotate(cam: Camera, pos, view_dir, phi, theta,
                  up=(0.0, 1.0, 0.0)):
    """Mouse-look: yaw ``phi`` about world up, then pitch ``theta`` about
    the side axis."""
    pos = np.asarray(pos, np.float32)
    v = np.asarray(view_dir, np.float32)
    up = np.asarray(up, np.float32)
    v = _rotation(up, phi) @ v
    v = _rotation(np.cross(v, up), theta) @ v
    v = v / np.linalg.norm(v)
    return Camera.create(pos, v, up, device=cam.pos.device), (pos, v)


def camera_rotate_around_origin(cam: Camera, pos, axis, angle,
                                up=(0.0, 1.0, 0.0)):
    """Orbit the origin by ``angle`` about ``axis`` and look back at it."""
    pos = np.asarray(pos, np.float32)
    new_pos = _rotation(np.asarray(axis, np.float32), angle) @ pos
    view = -new_pos / max(np.linalg.norm(new_pos), 1e-12)
    return (Camera.create(new_pos, view, up, device=cam.pos.device),
            (new_pos, view))
