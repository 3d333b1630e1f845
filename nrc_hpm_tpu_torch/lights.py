"""Light sources: directional sun, point light, HDR environment map.

Port of ``nrc_hpm_tpu/lights.py``.  Every scene preset uses the reference's
constant-white environment (its HDR loader overwrites every texel with
1.0), so env radiance is ``strength``; a real equirect map
(``SceneConfig.hdr_env_map_path``) is sampled bilinearly (wrap in u, clamp
in v) and carries the reference's marginal/conditional inverse CDFs
(``build_inverse_cdfs``, built in numpy as the JAX package builds them;
no shader consumes them).  ``update_scene`` animates the dir light of the
dynamic scene 3.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .sampling import PI


def _rot_x(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def _rot_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def dir_from_angles(zenith: float, azimuth: float) -> np.ndarray:
    """VecFromAngles: Ry(azimuth) Rx(zenith) (0, 1, 0)."""
    return _rot_y(azimuth) @ _rot_x(zenith) @ np.array([0.0, 1.0, 0.0],
                                                       np.float32)


@dataclasses.dataclass(frozen=True)
class DirLight:
    """Scalars are Python floats holding float32 values; the generating
    angles are kept so a dynamic update never recovers them from the
    direction."""

    color: torch.Tensor      # (3,)
    direction: torch.Tensor  # (3,)
    strength: float
    zenith: float
    azimuth: float

    @staticmethod
    def create(zenith=-1.57, azimuth=0.0, color=(1.0, 1.0, 1.0),
               strength=0.0, device="cuda") -> "DirLight":
        return DirLight(
            color=torch.tensor(color, dtype=torch.float32, device=device),
            direction=torch.as_tensor(dir_from_angles(zenith, azimuth),
                                      device=device),
            strength=float(np.float32(strength)),
            zenith=float(np.float32(zenith)),
            azimuth=float(np.float32(azimuth)))


@dataclasses.dataclass(frozen=True)
class PointLight:
    pos: torch.Tensor    # (3,)
    color: torch.Tensor  # (3,)
    strength: float

    @staticmethod
    def create(pos=(0.0, 0.0, 0.0), color=(1.0, 1.0, 1.0), strength=0.0,
               device="cuda") -> "PointLight":
        return PointLight(
            pos=torch.tensor(pos, dtype=torch.float32, device=device),
            color=torch.tensor(color, dtype=torch.float32, device=device),
            strength=float(np.float32(strength)))


@dataclasses.dataclass(frozen=True)
class HdrEnvMap:
    image: torch.Tensor      # (H, W, 3) float32 radiance
    strength: float
    inv_cdf_x: torch.Tensor  # (H, W) conditional inverse CDF of phi
    inv_cdf_y: torch.Tensor  # (H,) marginal inverse CDF of theta

    @staticmethod
    def constant_white(strength: float, device="cuda") -> "HdrEnvMap":
        return HdrEnvMap(
            image=torch.ones((1, 1, 3), dtype=torch.float32, device=device),
            strength=float(np.float32(strength)),
            inv_cdf_x=torch.zeros((1, 1), dtype=torch.float32, device=device),
            inv_cdf_y=torch.zeros((1,), dtype=torch.float32, device=device))

    @staticmethod
    def from_image(image: np.ndarray, strength: float,
                   device="cuda") -> "HdrEnvMap":
        img = np.asarray(image, np.float32)[..., :3]
        cdf_x, cdf_y = build_inverse_cdfs(img)
        return HdrEnvMap(image=torch.as_tensor(img, device=device),
                         strength=float(np.float32(strength)),
                         inv_cdf_x=torch.as_tensor(cdf_x, device=device),
                         inv_cdf_y=torch.as_tensor(cdf_y, device=device))


def build_inverse_cdfs(image: np.ndarray):
    """Hdr4fToCdf: the luminance-weighted marginal inverse CDF over rows
    (theta) and the conditional inverse CDF over columns (phi) per row,
    tabulated at the source resolution."""
    h, w = image.shape[:2]
    lum = image[..., 0] * 0.2126 + image[..., 1] * 0.7152 \
        + image[..., 2] * 0.0722
    lum = np.maximum(lum, 1e-12)
    row_sum = lum.sum(axis=1)
    cdf_y = np.cumsum(row_sum) / row_sum.sum()
    u = (np.arange(h) + 0.5) / h
    inv_cdf_y = np.searchsorted(cdf_y, u).astype(np.float32) / h
    cdf_x = np.cumsum(lum, axis=1) / row_sum[:, None]
    inv_cdf_x = np.zeros((h, w), np.float32)
    ux = (np.arange(w) + 0.5) / w
    for r in range(h):
        inv_cdf_x[r] = np.searchsorted(cdf_x[r], ux).astype(np.float32) / w
    return inv_cdf_x, inv_cdf_y


def sample_env_map(env: HdrEnvMap, d: torch.Tensor) -> torch.Tensor:
    """SampleHdrEnvMap: equirect ``uv = (atan(z,x), asin(y)) * (1/2pi,
    1/pi) + 0.5`` scaled by strength; (..., 3) dirs -> (..., 3) radiance."""
    h, w = env.image.shape[:2]
    if h == 1 and w == 1:
        return (env.image[0, 0] * env.strength).expand(d.shape[:-1] + (3,))
    phi = torch.atan2(d[..., 2], d[..., 0])
    theta = torch.arcsin(torch.clamp(d[..., 1], -1.0, 1.0))
    fx = (phi * (1.0 / (2.0 * PI)) + 0.5) * w - 0.5
    fy = (theta * (1.0 / PI) + 0.5) * h - 0.5
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0w = torch.remainder(x0, w)
    x1w = torch.remainder(x0 + 1, w)
    y0c = torch.clamp(y0, 0, h - 1)
    y1c = torch.clamp(y0 + 1, 0, h - 1)
    img = env.image
    top = img[y0c, x0w] * (1 - tx) + img[y0c, x1w] * tx
    bot = img[y1c, x0w] * (1 - tx) + img[y1c, x1w] * tx
    return (top * (1 - ty) + bot * ty) * env.strength


@dataclasses.dataclass(frozen=True)
class Lights:
    dir_light: DirLight
    point_light: PointLight
    env: HdrEnvMap


@dataclasses.dataclass(frozen=True)
class LightFlags:
    """Static enables: lights with zero strength are skipped."""

    dir_on: bool
    point_on: bool
    env_on: bool

    @staticmethod
    def from_scene(scene) -> "LightFlags":
        return LightFlags(dir_on=scene.dir_light_strength != 0.0,
                          point_on=scene.point_light_strength != 0.0,
                          env_on=scene.hdr_env_map_strength != 0.0)


def lights_from_scene(scene, device="cuda") -> Lights:
    """The light set of a SceneConfig: the constant-white env map, or the
    map read from ``scene.hdr_env_map_path`` (.exr or .hdr)."""
    if scene.hdr_env_map_path:
        from .utils.exr import read_any_hdr
        env = HdrEnvMap.from_image(read_any_hdr(scene.hdr_env_map_path),
                                   scene.hdr_env_map_strength, device)
    else:
        env = HdrEnvMap.constant_white(scene.hdr_env_map_strength, device)
    return Lights(
        dir_light=DirLight.create(strength=scene.dir_light_strength,
                                  device=device),
        point_light=PointLight.create(strength=scene.point_light_strength,
                                      device=device),
        env=env)


def update_scene(lights: Lights, scene, delta_time: float) -> Lights:
    """HpmScene::Update: in a dynamic scene 3 the dir light's azimuth
    advances at 0.5 rad/s, wrapped with ``fmod(.., 2 * 3.141)`` (the
    reference's literal); every other scene, and every static one, is left
    as it is (the reference's scene-4 case is an explicit no-op).  Color,
    strength and zenith are kept, the direction is rebuilt from the
    angles."""
    if not scene.dynamic or scene.id != 3:
        return lights
    dl = lights.dir_light
    new_az = float((dl.azimuth + delta_time * 0.5) % (2.0 * 3.141))
    new_dl = DirLight.create(
        zenith=dl.zenith, azimuth=new_az,
        color=tuple(dl.color.cpu().numpy().tolist()),
        strength=dl.strength, device=dl.color.device)
    return dataclasses.replace(lights, dir_light=new_dl)
