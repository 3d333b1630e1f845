"""Phase function and direction sampling.

Port of ``nrc_hpm_tpu/sampling.py``: the Henyey-Greenstein phase function,
the GLSL column-major axis-angle rotation (which acts as the TRANSPOSE of
Rodrigues, i.e. a rotation by -angle), ``NewRayDir`` with per-lane masked
RNG consumption, and the (theta, phi) NRC direction features.
"""

from __future__ import annotations

import numpy as np
import torch

from . import profiler
from .utils import rng

PI = 3.14159265358979323846


def hg_constants(g: float) -> tuple:
    """hg_phase's scalar terms (1 + g^2, 2 g, 0.5 (1 - g^2)), computed from
    float32 g as in the JAX package (the ReSTIR reuse kernels take the
    same)."""
    g = np.float32(g)
    g2 = g * g
    return float(1.0 + g2), float(2.0 * g), float(0.5 * (1.0 - g2))


def hg_phase(cos_theta: torch.Tensor, g: float) -> torch.Tensor:
    """hg_phase_func; the 0.5 factor bakes in the azimuthal 1/(2 pi)."""
    one_g2, two_g, half_1mg2 = hg_constants(g)
    denom = one_g2 - two_g * cos_theta
    return half_1mg2 / torch.pow(torch.clamp(denom, min=1e-12), 1.5)


def _rotation_apply(axis, angle, v):
    """GLSL rotationMatrix(axis, angle) applied to v: v c - (a x v) s +
    a (a.v)(1 - c)."""
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    s = torch.sin(angle)[..., None]
    c = torch.cos(angle)[..., None]
    dot_av = torch.sum(axis * v, dim=-1, keepdim=True)
    cross_av = torch.linalg.cross(axis, v, dim=-1)
    return v * c - cross_av * s + axis * dot_av * (1.0 - c)


def sample_hg_cos_theta(u: torch.Tensor, g: float) -> torch.Tensor:
    """Exact HG inverse-CDF cosine sampling (isotropic below |g| 1e-3)."""
    if abs(g) < 1e-3:
        return 1.0 - 2.0 * u
    g = np.float32(g)
    sqr_term = float(1.0 - g * g) / (float(1.0 - g) + float(2.0 * g) * u)
    return (float(1.0 + g * g) - sqr_term * sqr_term) / float(2.0 * g)


def new_ray_dir(state, old_dir, g: float, phase_sampling: bool,
                active=None):
    """NewRayDir: rotate away from ``old_dir`` by an HG (or uniform-in-[0,
    pi]) polar angle, then spin uniformly about it.  Two uniforms per
    active lane.  Returns (new_dir, new_state)."""
    if active is None:
        active = torch.ones(state.shape, dtype=torch.bool,
                            device=state.device)
    old_dir = old_dir / torch.linalg.vector_norm(old_dir, dim=-1,
                                                 keepdim=True)
    ox, oy, oz = old_dir.unbind(-1)
    zero = torch.zeros_like(ox)
    cand = torch.where((oz < ox)[..., None],
                       torch.stack([oy, -ox, zero], dim=-1),
                       torch.stack([zero, -oz, oy], dim=-1))
    norm = torch.linalg.vector_norm(cand, dim=-1, keepdim=True)
    fallback = torch.stack([-oy, ox, zero], dim=-1)
    fb_norm = torch.linalg.vector_norm(fallback, dim=-1, keepdim=True)
    with profiler.sync("new_ray_dir"):   # a copy from host memory
        fallback2 = torch.tensor([1.0, 0.0, 0.0], dtype=cand.dtype,
                                 device=cand.device).expand(cand.shape)
    cand = torch.where(norm > 1e-12, cand / torch.clamp(norm, min=1e-12),
                       torch.where(fb_norm > 1e-12,
                                   fallback / torch.clamp(fb_norm, min=1e-12),
                                   fallback2))

    u1, state = rng.masked_uniform(state, active)
    if phase_sampling:
        cos_theta = torch.clamp(sample_hg_cos_theta(u1, g), -1.0, 1.0)
        angle = torch.arccos(cos_theta)
    else:
        angle = u1 * PI
    d = _rotation_apply(cand, angle, old_dir)

    u2, state = rng.masked_uniform(state, active)
    d = _rotation_apply(old_dir, u2 * (2.0 * PI), d)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return d, state


def dir_to_spherical_norm(d: torch.Tensor) -> torch.Tensor:
    """Direction -> (atan2(z, x)/pi + 0.5, acos(clamp(y))/pi)."""
    theta = torch.atan2(d[..., 2], d[..., 0])
    phi = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    return torch.stack([theta / PI + 0.5, phi / PI], dim=-1)
