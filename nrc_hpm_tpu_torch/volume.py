"""Heterogeneous participating medium: dense uint8 density grid + box.

Port of ``nrc_hpm_tpu/volume.py``.  The grid is quantized like the
reference's R8 upload (``uint8(value * 255)``, sampled back as ``u8/255``
with nearest filtering and a black border); the world box is centered at
the origin with size ``normalize(extent) * 107.5``.  The macrocell
majorant/control table is built in numpy (``_build_macro``) and packed as
two conservatively rounded bf16 halves of one 32-bit word
(``_pack_macro``); both are copied verbatim from the JAX package.  The
macrocell lookups go through kernel K6 (``macro_sigma`` /
``macro_control`` on the float32 tables) and K5 (``macro_profile_xyz`` on
the packed table).  Coordinates divide by the box size, as the JAX
functions do (its frame passes ``sky_size`` as an array, so XLA does not
rewrite the division into a reciprocal multiply).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.macro_gather import small_table_lookup
from .ops.table_gather import table_gather, unpack_bf16_pair

MAX_RAY_DISTANCE = 100000.0
WORLD_SCALE = 107.5
MACRO_CELL = 8


@dataclasses.dataclass(frozen=True)
class Volume:
    """``grid`` is the uint8 density indexed [x, y, z]; ``macro`` and
    ``macro_min`` are the float32 dilated-max (majorant) and eroded-min
    (control) normalized densities per 8^3 macrocell; ``macro_packed``
    holds bf16(majorant) << 16 | bf16(control) per macrocell as int32 bit
    patterns.  Scalars are Python floats holding float32 values."""

    grid: torch.Tensor          # (X, Y, Z) uint8
    macro: torch.Tensor         # (Mx*My*Mz,) float32
    macro_min: torch.Tensor     # (Mx*My*Mz,) float32
    macro_packed: torch.Tensor  # (Mx*My*Mz,) int32
    sky_size: torch.Tensor      # (3,) float32
    sky_host: tuple             # the same three float32 values on the host
    density_factor: float
    g: float

    @property
    def dims(self):
        return tuple(self.grid.shape)

    @property
    def macro_dims(self):
        return tuple(-(-d // MACRO_CELL) for d in self.grid.shape)

    @property
    def device(self):
        return self.grid.device

    @staticmethod
    def from_dense(data: np.ndarray, density_factor: float, g: float,
                   device="cuda") -> "Volume":
        """Build from a dense [x, y, z] float array in [0, 1]."""
        data = np.asarray(data, np.float32)
        grid = (np.clip(data, 0.0, 1.0) * 255.0).astype(np.uint8)
        norm = grid.astype(np.float32) / 255.0
        extent = np.array(data.shape, np.float32)
        sky_size = (extent / np.linalg.norm(extent) * WORLD_SCALE).astype(
            np.float32)
        macro_max, macro_min = _build_macro(norm)
        packed = _pack_macro(macro_max, macro_min)
        return Volume(
            grid=torch.as_tensor(grid, device=device),
            macro=torch.as_tensor(macro_max, device=device),
            macro_min=torch.as_tensor(macro_min, device=device),
            macro_packed=torch.as_tensor(packed.view(np.int32), device=device),
            sky_size=torch.as_tensor(sky_size, device=device),
            sky_host=tuple(float(v) for v in sky_size),
            density_factor=float(np.float32(density_factor)),
            g=float(np.float32(g)))

    @staticmethod
    def from_vdb(path: str, density_factor: float, g: float,
                 device="cuda") -> "Volume":
        """The first float grid of a .vdb file (``utils/vdb.load_vdb``)."""
        from .utils.vdb import load_vdb
        return Volume.from_dense(load_vdb(path).data, density_factor, g,
                                 device=device)

    @staticmethod
    def homogeneous_cube(n: int, value: float, density_factor: float,
                         g: float, device="cuda") -> "Volume":
        """An n^3 cube of constant density ``value`` (the reference's
        homogeneous test configuration)."""
        return Volume.from_dense(np.full((n, n, n), value, np.float32),
                                 density_factor, g, device=device)

    def to(self, device) -> "Volume":
        return dataclasses.replace(
            self, grid=self.grid.to(device), macro=self.macro.to(device),
            macro_min=self.macro_min.to(device),
            macro_packed=self.macro_packed.to(device),
            sky_size=self.sky_size.to(device))


def sky_uvw(vol: Volume, pos: torch.Tensor) -> torch.Tensor:
    """World position -> [0, 1]^3 texture coordinate."""
    return pos / vol.sky_size + 0.5


def get_density_xyz(vol: Volume, px, py, pz) -> torch.Tensor:
    """density_factor * nearest-sampled density on planar coordinates,
    black outside the box."""
    X, Y, Z = vol.dims
    ux = px / vol.sky_size[0] + 0.5
    uy = py / vol.sky_size[1] + 0.5
    uz = pz / vol.sky_size[2] + 0.5
    inside = ((ux >= 0.0) & (ux < 1.0) & (uy >= 0.0) & (uy < 1.0)
              & (uz >= 0.0) & (uz < 1.0))
    ix = torch.clamp(torch.floor(ux * X).to(torch.int64), 0, X - 1)
    iy = torch.clamp(torch.floor(uy * Y).to(torch.int64), 0, Y - 1)
    iz = torch.clamp(torch.floor(uz * Z).to(torch.int64), 0, Z - 1)
    raw = vol.grid.reshape(-1)[ix * (Y * Z) + iy * Z + iz]
    val = raw.to(torch.float32) * (1.0 / 255.0)
    return torch.where(inside, val, 0.0) * vol.density_factor


def get_density(vol: Volume, pos: torch.Tensor) -> torch.Tensor:
    """get_density_xyz on (..., 3) world positions: nearest sample, the
    u8 value scaled by 1/255, black outside the box (clamp to border)."""
    return get_density_xyz(vol, *pos.unbind(-1))


def _macro_index(vol: Volume, cx, cy, cz) -> torch.Tensor:
    """Macrocell coordinates -> the clamped flat int32 cell index."""
    mx, my, mz = vol.macro_dims
    ix = torch.clamp(torch.floor(cx).to(torch.int32), 0, mx - 1)
    iy = torch.clamp(torch.floor(cy).to(torch.int32), 0, my - 1)
    iz = torch.clamp(torch.floor(cz).to(torch.int32), 0, mz - 1)
    return ix * (my * mz) + iy * mz + iz


def _macro_cells(vol: Volume, px, py, pz):
    """Planar world coordinates -> macrocell coordinates."""
    mx, my, mz = vol.macro_dims
    return ((px / vol.sky_size[0] + 0.5) * mx,
            (py / vol.sky_size[1] + 0.5) * my,
            (pz / vol.sky_size[2] + 0.5) * mz)


def _in_macro_box(vol: Volume, cx, cy, cz, margin: float):
    """Macrocell coordinates inside the grid widened by ``margin`` cells."""
    mx, my, mz = vol.macro_dims
    return ((cx >= -margin) & (cx < mx + margin)
            & (cy >= -margin) & (cy < my + margin)
            & (cz >= -margin) & (cz < mz + margin))


def _macro_lookup_xyz(vol: Volume, table, px, py, pz, margin: float):
    """density_factor * table[cell] on planar coordinates, 0 beyond
    ``margin`` cells outside the box (K6)."""
    cells = _macro_cells(vol, px, py, pz)
    val = small_table_lookup(table, _macro_index(vol, *cells))
    return torch.where(_in_macro_box(vol, *cells, margin), val,
                       0.0) * vol.density_factor


def macro_sigma_xyz(vol: Volume, px, py, pz) -> torch.Tensor:
    """Local majorant on planar coordinates: density_factor * dilated
    macrocell max, with a one-cell margin outside the box (a sample just
    outside must still dominate the in-box part of its interval)."""
    return _macro_lookup_xyz(vol, vol.macro, px, py, pz, margin=1.0)


def macro_control_xyz(vol: Volume, px, py, pz) -> torch.Tensor:
    """Control density on planar coordinates: density_factor * eroded
    macrocell min, strictly inside the box."""
    return _macro_lookup_xyz(vol, vol.macro_min, px, py, pz, margin=0.0)


def macro_sigma(vol: Volume, pos: torch.Tensor) -> torch.Tensor:
    """macro_sigma_xyz on (..., 3) world positions."""
    return macro_sigma_xyz(vol, *pos.unbind(-1))


def macro_control(vol: Volume, pos: torch.Tensor) -> torch.Tensor:
    """macro_control_xyz on (..., 3) world positions."""
    return macro_control_xyz(vol, *pos.unbind(-1))


def macro_profile_xyz(vol: Volume, px, py, pz):
    """(majorant, control) on planar coordinates from ONE lookup of the
    bf16-packed table (K5): the majorant with the one-cell outside margin,
    the control strictly inside, as macro_sigma_xyz / macro_control_xyz
    but at bf16 precision rounded conservatively."""
    cells = _macro_cells(vol, px, py, pz)
    sig, ctl = unpack_bf16_pair(
        table_gather(vol.macro_packed, _macro_index(vol, *cells)))
    ctl = torch.minimum(ctl, sig)
    sig = torch.where(_in_macro_box(vol, *cells, 1.0), sig, 0.0)
    ctl = torch.where(_in_macro_box(vol, *cells, 0.0), ctl, 0.0)
    return sig * vol.density_factor, ctl * vol.density_factor


def find_entry_exit(vol: Volume, ro: torch.Tensor, rd: torch.Tensor):
    """Exact ray/box slab test: (entry, exit, hit) for (..., 3) rays.
    Misses return far-away points and hit False."""
    half = 0.5 * vol.sky_size
    safe_rd = torch.where(torch.abs(rd) < 1e-12, 1e-12, rd)
    inv = 1.0 / safe_rd
    t1 = (-half - ro) * inv
    t2 = (half - ro) * inv
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = (tmax >= torch.clamp(tmin, min=0.0)) & (tmin < MAX_RAY_DISTANCE)
    t_entry = torch.clamp(tmin, min=0.0)
    entry = ro + t_entry[..., None] * rd
    exit_ = ro + tmax[..., None] * rd
    far = ro + (2.0 * MAX_RAY_DISTANCE) * rd
    entry = torch.where(hit[..., None], entry, far)
    exit_ = torch.where(hit[..., None], exit_, far)
    return entry, exit_, hit


# --- numpy helpers copied from nrc_hpm_tpu/volume.py -----------------------

def _shift3(a: np.ndarray, axis: int, border: float):
    """(rolled +1, rolled -1) with ``border`` filling the wrapped edge."""
    p = np.roll(a, 1, axis=axis)
    n = np.roll(a, -1, axis=axis)
    sl_first = [slice(None)] * 3
    sl_first[axis] = slice(0, 1)
    sl_last = [slice(None)] * 3
    sl_last[axis] = slice(-1, None)
    p[tuple(sl_first)] = border
    n[tuple(sl_last)] = border
    return p, n


def _build_macro(norm_grid: np.ndarray):
    """(face-dilated max, face-eroded min) of the normalized density per
    macrocell, flat (Mx*My*Mz,) float32.  The max carries a small safety
    margin on nonzero cells; empty cells stay exact zero majorants."""
    dims = norm_grid.shape
    m = [-(-d // MACRO_CELL) for d in dims]
    pad = [(0, mi * MACRO_CELL - d) for mi, d in zip(m, dims)]
    g = np.pad(norm_grid, pad)
    gmin = np.pad(norm_grid, pad, constant_values=0.0)
    cells = g.reshape(m[0], MACRO_CELL, m[1], MACRO_CELL, m[2], MACRO_CELL)
    cmax = cells.max(axis=(1, 3, 5))
    cmin = gmin.reshape(m[0], MACRO_CELL, m[1], MACRO_CELL,
                        m[2], MACRO_CELL).min(axis=(1, 3, 5))
    for axis in range(3):
        sl_first = [slice(None)] * 3
        sl_first[axis] = slice(0, 1)
        sl_last = [slice(None)] * 3
        sl_last[axis] = slice(-1, None)
        cmin[tuple(sl_first)] = 0.0
        cmin[tuple(sl_last)] = 0.0
    dil = cmax.copy()
    ero = cmin.copy()
    for axis in range(3):
        p, n = _shift3(cmax, axis, 0.0)
        dil = np.maximum(dil, np.maximum(p, n))
        p, n = _shift3(cmin, axis, 0.0)
        ero = np.minimum(ero, np.minimum(p, n))
    dil = np.where(dil > 0.0, dil * (1.0 + 1e-5) + 1e-7, 0.0)
    ero = np.minimum(ero, dil)
    return (dil.reshape(-1).astype(np.float32),
            ero.reshape(-1).astype(np.float32))


def _pack_macro(macro_max: np.ndarray, macro_min: np.ndarray) -> np.ndarray:
    """Pack (majorant, control) as bf16 halves of one uint32, the majorant
    rounded UP and the control DOWN so both bounds survive quantization."""
    up = macro_max.astype(np.float32) * (1.0 + 2.0 ** -7)
    dn = macro_min.astype(np.float32) * (1.0 - 2.0 ** -7)
    hi = (up.view(np.uint32) >> 16).astype(np.uint32)
    lo = (dn.astype(np.float32).view(np.uint32) >> 16).astype(np.uint32)
    packed = (hi << 16) | lo
    s = (packed >> np.uint32(16)).astype(np.uint32) << 16
    c = (packed & np.uint32(0xFFFF)).astype(np.uint32) << 16
    s_f = s.view(np.float32)
    c_f = np.minimum(c.view(np.float32), s_f)
    if not (s_f >= macro_max - 1e-7).all():
        raise ValueError("majorant quantization broke")
    if not (c_f <= macro_min + 1e-7).all():
        raise ValueError("control quantization broke")
    return packed
