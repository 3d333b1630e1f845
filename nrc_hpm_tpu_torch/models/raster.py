"""ModelRenderer: the reference's "Model" renderer mode.

Port of ``nrc_hpm_tpu/models/raster.py``.  It renders triangle models by
per-pixel ray/triangle intersection: one Möller-Trumbore test of every
pixel against every triangle, the nearest hit wins (the depth test; a
pixel that hits nothing takes triangle 0's values, as ``argmin`` of an
all-inf row gives, and is masked out), then Lambert shading clamped to
[0.2, 1] from the interpolated vertex normal, the diffuse colour
modulated by the bilinear-sampled texture of textured triangles.
Textures of different sizes share one stack, edge-padded to the largest,
each with its uv scale.  The pixels run in chunks so that the (pixels x
triangles) intermediates stay below ``CHUNK_ELEMS`` elements; the result
is that of one batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..camera import Camera, pixel_rays
from ..utils.texture import bilinear_sample_layered
from .mesh import Model, flatten_model

# (pixels x triangles) elements per chunk of the intersection
CHUNK_ELEMS = 1 << 22


def _intersect(ro, rd, v0, e1, e2):
    """Möller-Trumbore of (N, 3) rays against (F, 3) triangles: the
    nearest hit's (index, t, u, v), t = inf where nothing is hit."""
    h = torch.linalg.cross(rd[:, None, :].expand(-1, e2.shape[0], -1),
                           e2[None].expand(rd.shape[0], -1, -1), dim=-1)
    a = torch.sum(e1[None] * h, dim=-1)
    valid = torch.abs(a) > 1e-9
    f = torch.where(valid, 1.0 / torch.where(valid, a, 1.0), 0.0)
    s = ro[:, None, :] - v0[None]
    u = f * torch.sum(s * h, dim=-1)
    q = torch.linalg.cross(s, e1[None].expand(s.shape[0], -1, -1), dim=-1)
    v = f * torch.sum(rd[:, None, :] * q, dim=-1)
    t = f * torch.sum(e2[None] * q, dim=-1)
    hit = valid & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4)
    t = torch.where(hit, t, torch.inf)
    best = torch.argmin(t, dim=1)
    take = best[:, None]
    return (best, torch.gather(t, 1, take)[:, 0],
            torch.gather(u, 1, take)[:, 0], torch.gather(v, 1, take)[:, 0])


def _render(cam: Camera, tris, tex_stack, width: int, height: int,
            background, light_dir):
    """(H, W, 4) image (rgb, hit mask) and (H, W) depth (inf on a miss)
    of the flat triangles ``tris``, as many pixels at a time as keep an
    intermediate below CHUNK_ELEMS elements."""
    v0, e1, e2, n, uv, col, tex_idx = tris
    _, rd, _ = pixel_rays(cam, width, height)
    rdf = rd.reshape(-1, 3)
    rof = cam.pos.expand(rdf.shape)
    chunk = max(1, CHUNK_ELEMS // max(1, v0.shape[0]))
    parts = [_intersect(rof[i:i + chunk], rdf[i:i + chunk], v0, e1, e2)
             for i in range(0, rdf.shape[0], chunk)]
    best, t, u, v = (torch.cat(p) for p in zip(*parts))

    hit = torch.isfinite(t)
    w0 = 1.0 - u - v
    n_tri = n[best]                                   # (N, 3, 3)
    normal = (w0[:, None] * n_tri[:, 0] + u[:, None] * n_tri[:, 1]
              + v[:, None] * n_tri[:, 2])
    normal = normal / torch.clamp(
        torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=1e-12)
    base = col[best]
    if tex_stack is not None:
        # the hit's uv by the same barycentrics, the triangle's texture
        # bilinear-sampled and modulating the diffuse colour; untextured
        # triangles (tex -1) keep it
        uv_tri = uv[best]                             # (N, 3, 2)
        frag_uv = (w0[:, None] * uv_tri[:, 0] + u[:, None] * uv_tri[:, 1]
                   + v[:, None] * uv_tri[:, 2])
        tid = tex_idx[best]
        stack, scale = tex_stack
        texel = bilinear_sample_layered(stack, frag_uv, tid, wrap="clamp",
                                        scale=scale)
        base = torch.where((tid >= 0)[:, None], base * texel, base)
    lambert = torch.clamp(torch.sum(normal * -light_dir, dim=-1), 0.2, 1.0)
    rgb = base * lambert[:, None]
    out = torch.where(hit[:, None], rgb, background)
    depth = torch.where(hit, t, torch.inf)
    img = torch.cat([out, hit[:, None].to(torch.float32)], dim=-1)
    return img.reshape(height, width, 4), depth.reshape(height, width)


class ModelRenderer:
    """Renders a list of Models with nearest-hit depth resolution on
    ``device``."""

    def __init__(self, width: int, height: int,
                 background=(0.05, 0.05, 0.08),
                 light_dir=(0.3, -0.8, 0.5), device="cuda"):
        self.width = width
        self.height = height
        self.device = torch.device(device)
        self.background = torch.tensor(background, dtype=torch.float32,
                                       device=self.device)
        ld = torch.tensor(light_dir, dtype=torch.float32, device=self.device)
        self.light_dir = ld / torch.linalg.vector_norm(ld)
        self._models = []
        self._tris = None
        self._tex_stack = None

    def add_model(self, model: Model):
        self._models.append(model)
        self._tris = None

    def _flat(self):
        if self._tris is None:
            if not self._models:
                raise ValueError("no models added")
            textures = []
            parts = [flatten_model(m, textures, device=self.device)
                     for m in self._models]
            self._tris = tuple(torch.cat([p[i] for p in parts])
                               for i in range(7))
            self._tex_stack = _texture_stack(textures, self.device) \
                if textures else None
        return self._tris

    def render(self, camera: Camera):
        """-> (H, W, 4) image (.w = hit mask) and (H, W) depth."""
        tris = self._flat()
        return _render(camera, tris, self._tex_stack, self.width,
                       self.height, self.background, self.light_dir)


def _texture_stack(textures, device):
    """The textures edge-padded to a common (T, H, W, 3) stack, and the
    per-layer uv scales (T, 2) that map [0, 1]^2 onto each texture's own
    extent."""
    hmax = max(t.shape[0] for t in textures)
    wmax = max(t.shape[1] for t in textures)
    padded, scales = [], []
    for t in textures:
        t = np.asarray(t, np.float32)
        scales.append([t.shape[1] / wmax, t.shape[0] / hmax])
        if t.shape[:2] != (hmax, wmax):
            t = np.pad(t, ((0, hmax - t.shape[0]), (0, wmax - t.shape[1]),
                           (0, 0)), mode="edge")
        padded.append(t)
    return (torch.as_tensor(np.stack(padded), device=device),
            torch.tensor(scales, dtype=torch.float32, device=device))
