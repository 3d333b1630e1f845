"""Tracking event engine: kernels K1 (``pw_events``) and K2 (``pw_profile``).

Replaces the Pallas kernels ``nrc_hpm_tpu/ops/pw_kernels.py:_make_kernel``
(wrapper ``pw_events``) and ``:_make_profile_kernel`` (wrapper
``pw_profile``) with the CUDA kernels of ``csrc/pw_kernels.cu``; that file's
header says what bounds them on the H100 and what each design does about
it (K1: one O(S + C) interval walk per lane on a persistent grid, bitwise
the telescoping sums below, its S event records in shared memory; K2: the
same walk with one event, its lookups on integer cell coordinates, on a
persistent grid).

Each wrapper takes its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors; ``<wrapper>.launches`` counts kernel launches.
The plain versions keep the kernel's operation order (sequential event
depth, telescoping inversion, reciprocal-multiply box coordinates), so
they are its oracle on the card and the CPU path of the port.

Contract (as the JAX wrappers): start/direction (N, 3) float32, tmax
(N,) float32, seed (N,) int32 holding uint32 bits.  K1 adds e_last (N,)
float32 and the global event base e_base, and returns lin/t/c_at/sres
(S, N) (t = -1 beyond the segment, lin = -1 where there is no density) and
e_new/rtot/ctot (N,).  K2 returns rtot/ctot/t_ctrl (N,) with t_ctrl = 3e38
when the control draw lands beyond the segment (or want_ctrl is False).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import rng
from . import _build

C = 32
SALT_RATIO = 0x9E3779B9
SALT_DELTA = 0x85EBCA6B
SALT_CTRL = 0x165667B1
T_BEYOND = 3.0e38
_MAX_SMEM = 227 * 1024
_THREADS = 128
_REC_BYTES = 5 * 4 * _THREADS     # K1's shared memory per event: records
_LIB = "pw_kernels"


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


def pw_events_plain(vol, start, direction, tmax, seed, e_last, e_base: int,
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


def pw_profile_plain(vol, start, direction, tmax, seed,
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


# --- kernel wrappers ---------------------------------------------------------

def _lib():
    # -fmad=false keeps the kernels' rounding equal to the plain versions'
    lib = _build.load(_LIB, ("-fmad=false",))
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.pw_events_launch.argtypes = (
        [P] * 6 + [I] + [F] * 3 + [I] * 6 + [F, U, U, I, I] + [P] * 8)
    lib.pw_events_launch.restype = I
    lib.pw_profile_launch.argtypes = (
        [P] * 5 + [I] + [F] * 3 + [I] * 6 + [F, I, U, I] + [P] * 4)
    lib.pw_profile_launch.restype = I
    return lib


def _check_lanes(name, vol, start, direction, tmax, seed, extra=None):
    dev = start.device
    tensors = dict(start=start, direction=direction, tmax=tmax, seed=seed,
                   macro_packed=vol.macro_packed)
    if extra is not None:
        tensors["e_last"] = extra
    _build.require_cuda(name, tensors, dev)
    n = tmax.shape[0]
    _build.require(name, start.shape == (n, 3) and direction.shape == (n, 3)
                   and tmax.shape == (n,) and seed.shape == (n,),
                   "start/direction must be (N, 3), tmax/seed (N,)")
    _build.require(name, start.dtype == direction.dtype == tmax.dtype
                   == torch.float32 and seed.dtype == torch.int32
                   and vol.macro_packed.dtype == torch.int32,
                   "float32 lanes, int32 seed and macro table expected")
    if extra is not None:
        _build.require(name, extra.shape == (n,)
                       and extra.dtype == torch.float32,
                       "e_last must be (N,) float32")
    _build.require(name, vol.macro_packed.numel() * 4 <= _MAX_SMEM,
                   "macro table exceeds one block's shared memory")
    return n


def pw_events(vol, start, direction, tmax, seed, e_last, e_base: int,
              S: int = 8, salt: int = SALT_RATIO):
    """Fused profile + S event draws + inversion for one tracking segment."""
    if not _build.on_card("pw_events", start.device):
        return pw_events_plain(vol, start, direction, tmax, seed, e_last,
                               e_base, S, salt)
    n = _check_lanes("pw_events", vol, start, direction, tmax, seed, e_last)
    words = -(-vol.macro_packed.numel() // 4) * 4
    _build.require("pw_events", 4 * words + _REC_BYTES * S <= _MAX_SMEM,
                   f"S = {S} events' records and the macro table exceed "
                   f"one block's shared memory")
    dev = start.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(lin=torch.empty((S, n), dtype=torch.int32, device=dev),
               t=torch.empty((S, n), **f32), c_at=torch.empty((S, n), **f32),
               sres=torch.empty((S, n), **f32), e_new=torch.empty(n, **f32),
               rtot=torch.empty(n, **f32), ctot=torch.empty(n, **f32))
    if n == 0:
        return out
    inv, (mx, my, mz), (X, Y, Z) = _scene(vol)
    p = _build.ptr
    lib = _lib()
    rc = lib.pw_events_launch(
        p(start), p(direction), p(tmax), p(seed), p(e_last),
        p(vol.macro_packed), vol.macro_packed.numel(), *inv, mx, my, mz,
        X, Y, Z, vol.density_factor, e_base & 0xFFFFFFFF, salt, S, n,
        p(out["lin"]), p(out["t"]), p(out["c_at"]), p(out["sres"]),
        p(out["e_new"]), p(out["rtot"]), p(out["ctot"]),
        _build.stream_ptr(dev))
    _build.check(lib, _LIB, rc)
    pw_events.launches += 1
    return out


pw_events.launches = 0


def pw_profile(vol, start, direction, tmax, seed, want_ctrl: bool = False,
               salt_ctrl: int = SALT_CTRL):
    """Coarse-profile totals (and the control collision) for one track."""
    if not _build.on_card("pw_profile", start.device):
        return pw_profile_plain(vol, start, direction, tmax, seed,
                                want_ctrl, salt_ctrl)
    n = _check_lanes("pw_profile", vol, start, direction, tmax, seed)
    dev = start.device
    out = {k: torch.empty(n, dtype=torch.float32, device=dev)
           for k in ("rtot", "ctot", "t_ctrl")}
    if n == 0:
        return out
    inv, (mx, my, mz), (X, Y, Z) = _scene(vol)
    p = _build.ptr
    lib = _lib()
    rc = lib.pw_profile_launch(
        p(start), p(direction), p(tmax), p(seed), p(vol.macro_packed),
        vol.macro_packed.numel(), *inv, mx, my, mz, X, Y, Z,
        vol.density_factor, int(want_ctrl), salt_ctrl, n, p(out["rtot"]),
        p(out["ctot"]), p(out["t_ctrl"]), _build.stream_ptr(dev))
    _build.check(lib, _LIB, rc)
    pw_profile.launches += 1
    return out


pw_profile.launches = 0
