"""The tracking event engine's plain versions: K1 (``pw_events``: the
coarse profile, S event draws and their inversion for one tracking
segment) and K2 (``pw_profile``: the profile's totals and the control
collision), in the kernels' operation order (sequential event depth,
telescoping inversion, reciprocal-multiply box coordinates).

Contract: start/direction (N, 3) float32, tmax (N,) float32, seed (N,)
int32 holding uint32 bits.  ``pw_events`` adds e_last (N,) float32 and the
global event base e_base, and returns lin/t/c_at/sres (S, N) (t = -1
beyond the segment, lin = -1 where there is no density) and
e_new/rtot/ctot (N,).  ``pw_profile`` returns rtot/ctot/t_ctrl (N,) with
t_ctrl = 3e38 when the control draw lands beyond the segment (or
want_ctrl is False).
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng

C = 32
SALT_RATIO = 0x9E3779B9
SALT_DELTA = 0x85EBCA6B
SALT_CTRL = 0x165667B1
T_BEYOND = 3.0e38


def _uniform(seed64: torch.Tensor, k: int, salt: int) -> torch.Tensor:
    """float_construct(hash(seed ^ hash(salt + k))) for one event index."""
    return rng.float_construct(rng.hash_u32(seed64 ^ rng.hash_u32(k + salt)))


def _scene(vol):
    """Kernel constants: float32 reciprocal box size and grid dims."""
    inv = np.float32(1.0) / np.asarray(vol.sky_host, np.float32)
    return tuple(float(v) for v in inv), vol.macro_dims, vol.dims


# --- plain PyTorch versions --------------------------------------------------

def _macro_lookup(vol, tbl64, px, py, pz):
    inv, (mx, my, mz), _ = _scene(vol)
    mx, my, mz = float(mx), float(my), float(mz)
    cx = (px * inv[0] + 0.5) * mx
    cy = (py * inv[1] + 0.5) * my
    cz = (pz * inv[2] + 0.5) * mz
    in_strict = ((cx >= 0) & (cx < mx) & (cy >= 0) & (cy < my)
                 & (cz >= 0) & (cz < mz))
    in_ext = ((cx >= -1) & (cx < mx + 1) & (cy >= -1) & (cy < my + 1)
              & (cz >= -1) & (cz < mz + 1))
    ix = torch.clamp(torch.floor(cx), 0.0, mx - 1.0)
    iy = torch.clamp(torch.floor(cy), 0.0, my - 1.0)
    iz = torch.clamp(torch.floor(cz), 0.0, mz - 1.0)
    w = tbl64[(ix * (my * mz) + iy * mz + iz).to(torch.int64)]
    sig = rng.u32_to_f32(w & 0xFFFF0000)
    ctl = torch.minimum(rng.u32_to_f32(w << 16), sig)
    sig = torch.where(in_ext, sig, 0.0) * vol.density_factor
    ctl = torch.where(in_strict, ctl, 0.0) * vol.density_factor
    return sig, ctl


def _profile_plain(vol, start, direction, tmax):
    """(sig (C+1, N), ctl (C+1, N), rcum (C, N), ccum (C, N), h (N,)); row
    C of sig/ctl is zero, as in the kernel."""
    tbl64 = vol.macro_packed.to(torch.int64) & rng.M32
    ox, oy, oz = start.unbind(-1)
    vx, vy, vz = direction.unbind(-1)
    h = tmax * (1.0 / C)
    p_sig, p_ctl = _macro_lookup(vol, tbl64, ox, oy, oz)
    ccum = rcum = torch.zeros_like(h)
    sigs, ctls, rcums, ccums = [], [], [], []
    for i in range(C):
        t_i = float(i + 1) * h
        n_sig, n_ctl = _macro_lookup(vol, tbl64, ox + t_i * vx,
                                     oy + t_i * vy, oz + t_i * vz)
        sig = torch.maximum(p_sig, n_sig)
        ctl = torch.minimum(torch.minimum(p_ctl, n_ctl), sig)
        ccum = ccum + ctl * h
        rcum = rcum + (sig - ctl) * h
        sigs.append(sig)
        ctls.append(ctl)
        rcums.append(rcum)
        ccums.append(ccum)
        p_sig, p_ctl = n_sig, n_ctl
    zero = torch.zeros_like(h)
    return (torch.stack(sigs + [zero]), torch.stack(ctls + [zero]),
            torch.stack(rcums), torch.stack(ccums), h)


def _telescope(E, cum, fields):
    """Sequential telescoping over the C intervals for event depths E
    (S, N): (interval count, e_left, [field at the event interval])."""
    kacc = torch.zeros_like(E)
    e_left = torch.zeros_like(E)
    vals = [f[0].expand_as(E) for f in fields]
    prev = torch.zeros_like(cum[0])
    for c in range(C):
        gef = (E >= cum[c]).to(torch.float32)
        kacc = kacc + gef
        e_left = e_left + gef * (cum[c] - prev)
        vals = [v + gef * (f[c + 1] - f[c]) for v, f in zip(vals, fields)]
        prev = cum[c]
    return kacc, e_left, vals


def pw_events(vol, start, direction, tmax, seed, e_last, e_base: int,
                    S: int = 8, salt: int = SALT_RATIO):
    sig, ctl, rcum, ccum, h = _profile_plain(vol, start, direction, tmax)
    seed64 = seed.to(torch.int64) & rng.M32
    E, Es = e_last, []
    for s in range(S):
        E = E - torch.log1p(-_uniform(seed64, e_base + s, salt))
        Es.append(E)
    E = torch.stack(Es)                                     # (S, N)
    kacc, e_left, (c_at, sig_at) = _telescope(E, rcum, (ctl, sig))
    beyond = E >= rcum[-1]
    sres = torch.clamp(sig_at - c_at, min=1e-12)
    rate_h = sres * h
    t = kacc * h + (E - e_left) * h / torch.clamp(rate_h, min=1e-20)
    t = torch.where(beyond, -1.0, t)
    inv, _, (X, Y, Z) = _scene(vol)
    X, Y, Z = float(X), float(Y), float(Z)
    ux = (start[:, 0] + t * direction[:, 0]) * inv[0] + 0.5
    uy = (start[:, 1] + t * direction[:, 1]) * inv[1] + 0.5
    uz = (start[:, 2] + t * direction[:, 2]) * inv[2] + 0.5
    inside = ((ux >= 0.0) & (ux < 1.0) & (uy >= 0.0) & (uy < 1.0)
              & (uz >= 0.0) & (uz < 1.0))
    gx = torch.clamp(torch.floor(ux * X), 0.0, X - 1.0)
    gy = torch.clamp(torch.floor(uy * Y), 0.0, Y - 1.0)
    gz = torch.clamp(torch.floor(uz * Z), 0.0, Z - 1.0)
    lin = (gx * (Y * Z) + gy * Z + gz).to(torch.int32)
    lin = torch.where(inside & ~beyond, lin, -1)
    return dict(lin=lin, t=t, c_at=c_at, sres=sres, e_new=E[-1],
                rtot=rcum[-1], ctot=ccum[-1])


def pw_profile(vol, start, direction, tmax, seed,
                     want_ctrl: bool = False, salt_ctrl: int = SALT_CTRL):
    sig, ctl, rcum, ccum, h = _profile_plain(vol, start, direction, tmax)
    ctot = ccum[-1]
    if want_ctrl:
        seed64 = seed.to(torch.int64) & rng.M32
        E = -torch.log1p(-_uniform(seed64, 0, salt_ctrl))
        kacc, e_left, (c_at,) = _telescope(E[None], ccum, (ctl,))
        rate_h = torch.clamp(c_at[0] * h, min=1e-20)
        t = kacc[0] * h + (E - e_left[0]) * h / rate_h
        t_ctrl = torch.where(E >= ctot, T_BEYOND, t)
    else:
        t_ctrl = torch.full_like(h, T_BEYOND)
    return dict(rtot=rcum[-1], ctot=ctot, t_ctrl=t_ctrl)
