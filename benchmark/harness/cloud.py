"""A cloud-like density volume generated from a seed.

Stands in for the WDAS sixteenth cloud (``wdas_cloud_sixteenth.vdb``),
which is input data this repository does not ship.  The field has the
cloud's grid shape (126 x 86 x 154), is normalized to max 1.0 with exact
zeros outside the blob (so most macrocells are empty, as in the real
cloud), and is heterogeneous inside: a sum of anisotropic Gaussian blobs,
soft-thresholded and modulated by multi-octave value noise.  Pure numpy: the
benchmark makes it once and hands the same array to the port's
``Volume.from_dense`` and to the reference's.
"""

from __future__ import annotations

import numpy as np

WDAS_SIXTEENTH_SHAPE = (126, 86, 154)


def _value_noise(rs: np.random.RandomState, shape, cells: int
                 ) -> np.ndarray:
    """Trilinear interpolation of a random (cells+1)^3 lattice, in [0, 1]."""
    lat = rs.rand(cells + 1, cells + 1, cells + 1).astype(np.float32)
    axes = [np.linspace(0.0, cells, n, endpoint=False, dtype=np.float32)
            for n in shape]
    i = [np.minimum(a.astype(np.int64), cells - 1) for a in axes]
    f = [a - ii for a, ii in zip(axes, i)]
    f = [fi * fi * (3.0 - 2.0 * fi) for fi in f]   # smoothstep
    ix, iy, iz = np.meshgrid(*i, indexing="ij")
    fx, fy, fz = np.meshgrid(*f, indexing="ij")
    out = np.zeros(shape, np.float32)
    for cx in (0, 1):
        wx = fx if cx else 1.0 - fx
        for cy in (0, 1):
            wy = fy if cy else 1.0 - fy
            for cz in (0, 1):
                wz = fz if cz else 1.0 - fz
                out += wx * wy * wz * lat[ix + cx, iy + cy, iz + cz]
    return out


def cloud_density(seed: int = 0, shape=WDAS_SIXTEENTH_SHAPE,
                  n_blobs: int = 24) -> np.ndarray:
    """Dense float32 [x, y, z] density in [0, 1] with max exactly 1.0."""
    rs = np.random.RandomState(seed)
    shape = tuple(int(s) for s in shape)
    grids = np.meshgrid(*[np.arange(n, dtype=np.float32) for n in shape],
                        indexing="ij", sparse=True)
    center = np.array(shape, np.float32) * 0.5
    field = np.zeros(shape, np.float32)
    for b in range(n_blobs):
        # the first blob is the cloud's core; the rest cluster around it
        spread = 0.0 if b == 0 else 0.22
        c = center + rs.uniform(-spread, spread, 3).astype(np.float32) \
            * np.array(shape, np.float32)
        sig = (0.20 if b == 0 else rs.uniform(0.06, 0.13)) \
            * np.array(shape, np.float32) * rs.uniform(0.8, 1.2, 3)
        amp = 1.0 if b == 0 else rs.uniform(0.4, 0.9)
        q = sum(((g - ci) / si) ** 2 for g, ci, si in zip(grids, c, sig))
        field += (amp * np.exp(-0.5 * q)).astype(np.float32)
    noise = (0.5 * _value_noise(rs, shape, 6)
             + 0.3 * _value_noise(rs, shape, 13)
             + 0.2 * _value_noise(rs, shape, 29))
    dens = np.clip(field * (0.55 + 0.9 * noise) - 0.35, 0.0, None)
    dens = dens / dens.max()
    return dens.astype(np.float32)
