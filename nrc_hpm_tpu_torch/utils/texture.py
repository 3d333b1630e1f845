"""2-D texture sampling and image loading.

Port of ``nrc_hpm_tpu/utils/texture.py``.  A texture is an (H, W, C)
tensor and sampling is a bilinear gather: v = 0 is the top row (images
load top-down), texel centres at (i + 0.5) / N, ``repeat`` wraps with a
floor-mod (negative texel indices too), ``clamp`` clamps to the edge.
``load_image`` reads a texture file into a numpy array.
"""

from __future__ import annotations

import numpy as np
import torch


def _texel_coords(uv, H: int, W: int, wrap: str):
    """The four texel rows/columns around ``uv`` and the bilinear
    fractions: (x0, x1, y0, y1) int64 and (fx, fy) (..., 1)."""
    u = uv[..., 0] * W - 0.5
    v = uv[..., 1] * H - 0.5
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]

    def idx(x, n):
        x = x.to(torch.int64)
        if wrap == "repeat":
            return torch.remainder(x, n)
        return torch.clamp(x, 0, n - 1)

    return (idx(x0, W), idx(x0 + 1, W), idx(y0, H), idx(y0 + 1, H)), (fx, fy)


def _blend(at, coords, fracs):
    (x0, x1, y0, y1), (fx, fy) = coords, fracs
    top = at(y0, x0) * (1 - fx) + at(y0, x1) * fx
    bot = at(y1, x0) * (1 - fx) + at(y1, x1) * fx
    return top * (1 - fy) + bot * fy


def bilinear_sample(tex: torch.Tensor, uv: torch.Tensor,
                    wrap: str = "repeat") -> torch.Tensor:
    """Sample ``tex`` (H, W, C) at ``uv`` (..., 2) in [0, 1]^2 with
    bilinear filtering; wrap 'repeat' or 'clamp'."""
    H, W = tex.shape[0], tex.shape[1]
    flat = tex.reshape(H * W, -1)
    coords, fracs = _texel_coords(uv, H, W, wrap)
    return _blend(lambda yy, xx: flat[yy * W + xx], coords, fracs)


def bilinear_sample_layered(stack: torch.Tensor, uv: torch.Tensor,
                            layer: torch.Tensor, wrap: str = "repeat",
                            scale: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Sample a texture array ``stack`` (T, H, W, C) at ``uv`` (..., 2)
    from per-sample ``layer`` (...,) int: one flat gather space, no
    bleeding across layers.  ``scale`` (T, 2) rescales uv per layer (for
    stacks padded to a common shape from textures of other sizes).
    Negative layers sample layer 0 (callers mask them out)."""
    T, H, W = stack.shape[0], stack.shape[1], stack.shape[2]
    lay = torch.clamp(layer, 0, T - 1).to(torch.int64)
    if scale is not None:
        uv = uv * scale[lay]
    flat = stack.reshape(T * H * W, -1)
    base = lay * (H * W)
    coords, fracs = _texel_coords(uv, H, W, wrap)
    return _blend(lambda yy, xx: flat[base + yy * W + xx], coords, fracs)


def load_image(path: str) -> np.ndarray:
    """An image file as (H, W, 3) float32 in [0, 1] (PNG 8-bit scaled by
    1/255, gray repeated; EXR; NPY)."""
    lower = path.lower()
    if lower.endswith(".png"):
        from .png import read_png
        img = np.asarray(read_png(path), np.float32) / 255.0
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        return img[..., :3]
    if lower.endswith(".exr"):
        from .exr import read_exr_rgba
        return np.asarray(read_exr_rgba(path), np.float32)[..., :3]
    if lower.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)[..., :3]
    raise ValueError(f"unsupported texture format: {path}")
