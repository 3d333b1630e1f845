"""Delta and ratio tracking in three modes, and the fixed-step
transmittance.

Port of the trackers of ``nrc_hpm_tpu/transmittance.py``:

- ``seq`` (``ratio_track`` / ``delta_track``): the reference shaders'
  own control flow, majorant = ``density_factor``, up to ``max_steps``
  iterations with masked per-lane draws from the RNG chain (a lane draws
  exactly as often as its shader thread would, including the fallthrough
  draw of a delta track that does not collide).
- ``fast`` (``ratio_track_fast`` / ``delta_track_fast``): the same
  estimators with segment-batched stateless draws (``_indexed_draws``
  from one ``_track_seed`` per call) against the global majorant.
- ``pw`` (``ratio_track_pw`` / ``delta_track_pw``): piecewise-majorant
  tracking.  At the default ``coarse = 32`` intervals it follows the
  kernel contract the JAX package uses on its kernel path: each track
  opens with ``pw_profile`` (K2) and runs segments of ``pw_events`` (K1),
  with the fine-grid density gather and the ratio/delta fold in torch.
  At any other ``coarse`` it follows the per-interval path:
  ``_coarse_profile`` builds the (C, N) majorant/control profile from the
  packed macro table (K5, through ``volume.macro_profile_xyz``), and each
  segment draws its event depths and inverts them through ``_map_events``.

The ``seq`` and ``fast`` trackers are loops of torch operations; the JAX
package runs them as XLA loops too (no Pallas kernel serves them).

In ``pw`` mode events are drawn statelessly, indexed by a global event
counter, so a lane's values do not depend on which other lanes run with
it: the port compacts the unresolved lanes exactly (``torch.nonzero``)
before every segment instead of the JAX package's static capacities with
dense fallbacks.  The segment LENGTHS do matter (ratio tracking's Russian
roulette draw is indexed by the segment's base event), so the port runs
the JAX schedule: one ``segment`` length below ``COMPACT_MIN_LANES``
lanes, else ``RATIO_PLAN`` / ``DELTA_PLAN``.  ``plan_lanes`` names the
lane count the JAX package would pass for the same call (see
integrator.trace_path).
"""

from __future__ import annotations

import numpy as np
import torch

from . import profiler
from .ops.pw_kernels import (SALT_CTRL, SALT_DELTA, SALT_RATIO, pw_events,
                             pw_profile)
from .utils import rng
from .volume import (Volume, find_entry_exit, get_density,
                     get_density_xyz, macro_profile_xyz)

KERNEL_INTERVALS = 32     # the interval count K1/K2 are built for

COMPACT_MIN_LANES = 32768
# (events per segment, events in stage; None runs to max_steps); the
# capacity fractions of the JAX plans do not change values and are dropped
RATIO_PLAN = ((8, 16), (16, None))
DELTA_PLAN = ((16, 16), (16, None))
RR_EPS = 1.0 / 32.0
SALT_RR = 0x7FEB352D
SALT_RR0 = 0x3C6EF372
SALT_ACCEPT = 0xC2B2AE35
SALT_FALLBACK = 0x27D4EB2F


@profiler.region("rng")
def _track_seed(state):
    """Split one indexed-draw seed (the state's bits, as int32) off the
    chain, which advances one step per track call."""
    seed = state.contiguous().view(torch.int32)
    _, state = rng.uniform(state)
    return seed, state


@profiler.region("rng")
def _indexed_draws(seed, k0: int, n: int, salt: int):
    """u_k = floatConstruct(hash(seed ^ hash(salt + k))), k in [k0, k0+n);
    seed (...,) int32 bits -> (..., n) float32."""
    return rng.indexed_draws(seed, k0, n, salt)


@profiler.region("rng")
def _indexed_draws_lead(seed, k0: int, n: int, salt: int):
    """_indexed_draws with the event axis leading: (n, ...) float32."""
    return rng.indexed_draws(seed, k0, n, salt, lead=True)


def _segments(plan_lanes: int, segment: int, plan, max_steps: int):
    """(segment length, base event) of every segment of the JAX staging."""
    if plan_lanes < COMPACT_MIN_LANES:
        plan = ((segment, None),)
    e0 = 0
    for seg_len, n_events in plan:
        e1 = max_steps if n_events is None else min(e0 + n_events, max_steps)
        for i in range(e0, e1, seg_len):
            yield seg_len, i
        e0 = max(e0, e1)


def fixed_step_transmittance(vol: Volume, start, end, count: int):
    """GetTransmittance: the deterministic ``count``-step Riemann product
    exp(-sum density * step) with samples at the left endpoints i/count."""
    d = end - start
    step = torch.linalg.vector_norm(d, dim=-1) / count
    fracs = torch.arange(count, dtype=torch.float32,
                         device=start.device) / count
    pts = start[..., None, :] + fracs[:, None] * d[..., None, :]
    dens = get_density_xyz(vol, pts[..., 0], pts[..., 1], pts[..., 2])
    trans = torch.exp(-torch.sum(dens, dim=-1) * step)
    return torch.where(step == 0.0, 1.0, trans)


def _inv_majorant(vol: Volume) -> float:
    """1 / density_factor in float32, the seq and fast trackers' step
    scale."""
    return float(np.float32(1.0) / np.float32(vol.density_factor))


# --- seq: the reference shaders' control flow ------------------------------

def ratio_track(state, vol: Volume, start, end, max_steps: int = 128,
                active=None):
    """RatioTrack: residual-ratio transmittance along [start, end] with
    the global majorant; each of up to ``max_steps`` iterations draws one
    uniform on the lanes still tracking.  start/end (..., 3); returns
    (transmittance, new_state)."""
    if active is None:
        active = torch.ones(state.shape, dtype=torch.bool,
                            device=state.device)
    inv_max = _inv_majorant(vol)
    seg = end - start
    tmax = torch.linalg.vector_norm(seg, dim=-1)
    direction = seg / torch.clamp(tmax, min=1e-12)[..., None]
    t = torch.zeros_like(tmax)
    trans = torch.ones_like(tmax)
    done = torch.zeros_like(active)
    for _ in range(max_steps):
        lane = active & ~done
        with profiler.sync("seq.ratio"):
            tracking = bool(lane.any())
        if not tracking:
            break   # the remaining iterations change nothing
        u, state = rng.masked_uniform(state, lane)
        t_new = t - torch.log(1.0 - u) * inv_max
        exited = t_new >= tmax
        dens = get_density(vol, start + t_new[..., None] * direction)
        trans = torch.where(lane & ~exited, trans * (1.0 - dens * inv_max),
                            trans)
        t = torch.where(lane, t_new, t)
        done = done | (lane & exited)
    return trans, state


def delta_track(state, vol: Volume, ro, rd, max_steps: int = 128,
                active=None):
    """DeltaTrack: Woodcock collision sampling from ``ro`` along ``rd`` to
    the box exit, two draws an iteration (free flight, then acceptance
    where the flight stays inside).  Returns (pos, volume_exit,
    new_state): collision lanes get the collision point; the others
    draw once more and get a uniform point on [ro, exit) (the shader's
    fallthrough), ``volume_exit`` only where a flight passed the exit."""
    if active is None:
        active = torch.ones(state.shape, dtype=torch.bool,
                            device=state.device)
    inv_max = _inv_majorant(vol)
    _, exit_pt, _ = find_entry_exit(vol, ro, rd)
    tmax = torch.linalg.vector_norm(exit_pt - ro, dim=-1)
    t = torch.zeros_like(tmax)
    pos = torch.zeros_like(ro)
    hit = torch.zeros_like(active)
    exited = torch.zeros_like(active)
    for _ in range(max_steps):
        lane = active & ~hit & ~exited
        with profiler.sync("seq.delta"):
            tracking = bool(lane.any())
        if not tracking:
            break
        u1, state = rng.masked_uniform(state, lane)
        t = torch.where(lane, t - torch.log(1.0 - u1) * inv_max, t)
        exit_now = lane & (t >= tmax)
        probe = lane & ~exit_now
        u2, state = rng.masked_uniform(state, probe)
        cand = ro + t[..., None] * rd
        hit_now = probe & (get_density(vol, cand) * inv_max > u2)
        pos = torch.where(hit_now[..., None], cand, pos)
        hit = hit | hit_now
        exited = exited | exit_now
    u3, state = rng.masked_uniform(state, active & ~hit)
    fallback = ro + (u3 * tmax)[..., None] * rd
    return torch.where(hit[..., None], pos, fallback), exited, state


# --- fast: segment-batched stateless draws, global majorant ----------------

def _segment_schedule(max_steps: int, segment: int):
    """(segment count, events per segment) of the fast trackers."""
    count = max(1, (max_steps + segment - 1) // segment)
    return count, segment if count > 1 else max_steps


def _free_flights(seed, t_last, i: int, seg_len: int, salt: int,
                  inv_max: float):
    """The distances of segment ``i``'s events: t_last plus the running
    sum of Exp(1) / majorant steps, (..., seg_len)."""
    u = _indexed_draws(seed, i * seg_len, seg_len, salt)
    steps = -torch.log1p(-u) * inv_max
    return t_last[..., None] + torch.movedim(
        _cumsum0(torch.movedim(steps, -1, 0)), 0, -1)


def ratio_track_fast(state, vol: Volume, start, end, max_steps: int = 128,
                     segment: int = 32, active=None):
    """Segment-batched RatioTrack: ``segment`` events a pass, each lane's
    draws indexed by (seed, event); the chain advances once per call on
    every lane.  Inactive lanes transmit 1.  Returns (transmittance,
    new_state)."""
    inv_max = _inv_majorant(vol)
    seg_count, seg_len = _segment_schedule(max_steps, segment)
    seg_vec = end - start
    tmax = torch.linalg.vector_norm(seg_vec, dim=-1)
    direction = seg_vec / torch.clamp(tmax, min=1e-12)[..., None]
    if active is not None:
        tmax = torch.where(active, tmax, 0.0)
    seed, state = _track_seed(state)
    t_last = torch.zeros_like(tmax)
    trans = torch.ones_like(tmax)
    for i in range(seg_count):
        with profiler.sync("fast.ratio"):
            inside = bool((t_last < tmax).any())
        if not inside:
            break   # every lane has left its segment
        t = _free_flights(seed, t_last, i, seg_len, SALT_RATIO, inv_max)
        dens = get_density(vol, start[..., None, :]
                           + t[..., None] * direction[..., None, :])
        factors = torch.where(t < tmax[..., None], 1.0 - dens * inv_max,
                              1.0)
        trans = trans * torch.prod(factors, dim=-1)
        t_last = t[..., -1]
    return trans, state


def delta_track_fast(state, vol: Volume, ro, rd, max_steps: int = 128,
                     segment: int = 32, active=None):
    """Segment-batched DeltaTrack: a pass draws ``segment`` free flights
    and acceptances; a lane resolves at its first accepted or exiting
    event.  Same contract as ``delta_track`` (inactive lanes resolve at
    once as exits at ``ro``); the chain advances once per call on every
    lane."""
    inv_max = _inv_majorant(vol)
    _, exit_pt, _ = find_entry_exit(vol, ro, rd)
    tmax = torch.linalg.vector_norm(exit_pt - ro, dim=-1)
    if active is not None:
        tmax = torch.where(active, tmax, 0.0)
    seg_count, seg_len = _segment_schedule(max_steps, segment)
    seed, state = _track_seed(state)
    t_last = torch.zeros_like(tmax)
    t_hit = torch.zeros_like(tmax)
    resolved = torch.zeros(tmax.shape, dtype=torch.bool, device=tmax.device)
    hit = torch.zeros_like(resolved)
    exited = torch.zeros_like(resolved)
    for i in range(seg_count):
        with profiler.sync("fast.delta"):
            done = bool(resolved.all())
        if done:
            break
        t = _free_flights(seed, t_last, i, seg_len, SALT_DELTA, inv_max)
        u2 = _indexed_draws(seed, i * seg_len, seg_len, SALT_ACCEPT)
        dens = get_density(vol, ro[..., None, :] + t[..., None]
                           * rd[..., None, :])
        cross = t >= tmax[..., None]
        accept = (dens * inv_max > u2) & ~cross
        event = accept | cross
        first = event & (torch.cumsum(event.to(torch.int32), dim=-1) == 1)
        has_event = event.any(dim=-1)
        ev_accept = (first & accept).any(dim=-1)
        ev_t = torch.where(first, t, 0.0).sum(dim=-1)
        new = ~resolved & has_event
        hit = hit | (new & ev_accept)
        exited = exited | (new & ~ev_accept)
        t_hit = torch.where(new & ev_accept, ev_t, t_hit)
        resolved = resolved | has_event
        t_last = t[..., -1]
    u3 = _indexed_draws(seed, 0, 1, SALT_FALLBACK)[..., 0]
    t_final = torch.where(hit, t_hit, u3 * tmax)
    return ro + t_final[..., None] * rd, exited, state


# --- pw: piecewise majorant --------------------------------------------------

def _fine_density(vol: Volume, lin):
    """density_factor/255 * grid[lin], 0 where lin = -1."""
    raw = vol.grid.reshape(-1)[torch.clamp(lin, min=0).to(torch.int64)]
    scale = float(np.float32(vol.density_factor) * np.float32(1.0 / 255.0))
    return torch.where(lin >= 0, raw.to(torch.float32) * scale, 0.0)


# --- the per-interval path (coarse != 32) -----------------------------------

_SCAN_BLOCK = 16


def _cumsum0(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum along dim 0 in the order of the JAX
    package's ``jnp.cumsum`` (XLA's reduce-window rewrite): sequential
    within blocks of 16, the block totals scanned the same way and added
    in front.  (``torch.cumsum`` sums in double on the CPU and in a
    parallel order on the GPU.)"""
    n = x.shape[0]
    if n <= _SCAN_BLOCK:
        out = [x[0]]
        for i in range(1, n):
            out.append(out[-1] + x[i])
        return torch.stack(out)
    nb = -(-n // _SCAN_BLOCK)
    pad = x.new_zeros((nb * _SCAN_BLOCK - n,) + x.shape[1:])
    blocks = torch.cat([x, pad]).reshape(nb, _SCAN_BLOCK, *x.shape[1:])
    local = [blocks[:, 0]]
    for i in range(1, _SCAN_BLOCK):
        local.append(local[-1] + blocks[:, i])
    local = torch.stack(local, dim=1)
    prefix = _cumsum0(local[:, -1])
    out = torch.cat([local[:1], prefix[:-1, None] + local[1:]])
    return out.reshape(nb * _SCAN_BLOCK, *x.shape[1:])[:n]


def _coarse_profile(vol: Volume, start, direction, tmax, C: int):
    """Piecewise-constant majorant/control profile of each lane's segment,
    lane-minor: (sigma (C, N), c (C, N), ccum (C, N), rcum (C, N),
    h (N,)).  sigma is the max of the packed majorant at both ends of an
    interval, c the min of the control (and <= sigma)."""
    h = tmax / C
    ts = torch.arange(C + 1, dtype=torch.float32,
                      device=tmax.device)[:, None] * h[None, :]
    px = start[None, :, 0] + ts * direction[None, :, 0]
    py = start[None, :, 1] + ts * direction[None, :, 1]
    pz = start[None, :, 2] + ts * direction[None, :, 2]
    smax, smin = macro_profile_xyz(vol, px, py, pz)
    sigma = torch.maximum(smax[:-1], smax[1:])
    c = torch.minimum(torch.minimum(smin[:-1], smin[1:]), sigma)
    ccum = _cumsum0(c * h[None, :])
    rcum = _cumsum0((sigma - c) * h[None, :])
    return sigma, c, ccum, rcum, h


def _map_events(E, cum, h, fields):
    """Invert the piecewise-linear cumulative depth ``cum`` (C, N) at
    event depths E (S, N): (t (S, N), beyond (S, N), [each (C, N) field at
    the event's interval]).  Telescoping sums over the indicators
    [E >= cum_c] select the interval, as the JAX package does; they
    materialise one (S, C, N) float32 tensor."""
    C = cum.shape[0]
    ge = (E[:, None, :] >= cum[None]).to(torch.float32)
    k = ge.sum(dim=1)
    beyond = E >= cum[-1][None, :]

    def sel(f):
        d = f[1:] - f[:-1]
        return f[0][None, :] + (ge[:, :C - 1] * d[None]).sum(dim=1)

    cum_left = torch.cat([torch.zeros_like(cum[:1]), cum[:-1]], dim=0)
    t_left = k * h[None, :]
    e_left = sel(cum_left)
    rate_h = torch.clamp(sel(cum) - e_left, min=1e-20)
    t = t_left + (E - e_left) * (h[None, :] / rate_h)
    return t, beyond, [sel(f) for f in fields]


def _segment_events(vol: Volume, prof, seed, start, direction, tmax, e_last,
                    idx, i: int, seg_len: int, salt: int) -> dict:
    """One tracking segment's ``seg_len`` residual events for the lanes
    ``idx``: t (S, n), beyond (S, n), the fine density, the control and
    residual majorant at each event, e_new and rtot (n,).  ``prof`` is
    None on the kernel path (K1 re-profiles), else the per-interval
    (sigma, c, rcum, h, rtot) of every lane."""
    if prof is None:
        ev = pw_events(vol, start[idx], direction[idx], tmax[idx], seed[idx],
                       e_last[idx], i, S=seg_len, salt=salt)
        return dict(t=ev["t"], beyond=ev["t"] < 0.0,
                    dens=_fine_density(vol, ev["lin"]), c_at=ev["c_at"],
                    sres=ev["sres"], e_new=ev["e_new"], rtot=ev["rtot"])
    sigma, c, rcum, h, rtot = prof
    u = _indexed_draws_lead(seed[idx], i, seg_len, salt)
    E = e_last[idx][None, :] + _cumsum0(-torch.log1p(-u))
    t, beyond, (c_at, s_at) = _map_events(E, rcum[:, idx], h[idx],
                                          (c[:, idx], sigma[:, idx]))
    o, d = start[idx], direction[idx]
    dens = get_density_xyz(vol, o[None, :, 0] + t * d[None, :, 0],
                           o[None, :, 1] + t * d[None, :, 1],
                           o[None, :, 2] + t * d[None, :, 2])
    return dict(t=t, beyond=beyond, dens=dens, c_at=c_at,
                sres=torch.clamp(s_at - c_at, min=1e-12), e_new=E[-1],
                rtot=rtot[idx])


def _ratio_rr(seed, i: int, trans, e_new, rtot):
    """Russian roulette after a fold: lanes below RR_EPS survive with
    probability |trans|/RR_EPS (weight reset) or park past rtot."""
    alive = e_new < rtot
    small = alive & (torch.abs(trans) < RR_EPS)
    u_rr = _indexed_draws_lead(seed, i, 1, SALT_RR)[0]
    survive = u_rr * RR_EPS < torch.abs(trans)
    trans = torch.where(small, torch.where(survive, torch.sign(trans) * RR_EPS,
                                           0.0), trans)
    e_new = torch.where(small & ~survive,
                        torch.maximum(rtot, e_new) + 1.0, e_new)
    return trans, e_new


def ratio_track_pw(state, vol: Volume, start, end, max_steps: int = 128,
                   segment: int = 16, active=None,
                   plan_lanes: int | None = None, coarse: int = 32):
    """Residual ratio tracking with the piecewise control/majorant:
    T = exp(-int c) * E[prod over residual events (1 - (d - c)/(sigma - c))].
    start/end (N, 3); ``coarse`` profile intervals; returns
    (transmittance (N,), new_state)."""
    with profiler.span("nrc.track", kind="ratio",
                       lanes=start.shape[0]) as track:
        seg_vec = end - start
        tmax = torch.linalg.vector_norm(seg_vec, dim=-1)
        direction = (seg_vec / torch.clamp(tmax, min=1e-12)[..., None]
                     ).contiguous()
        if active is not None:
            tmax = torch.where(active, tmax, 0.0)
        start = start.contiguous()
        seed, state = _track_seed(state)
        if coarse == KERNEL_INTERVALS:
            tot = pw_profile(vol, start, direction, tmax, seed)
            rtot, ctot, prof = tot["rtot"], tot["ctot"], None
        else:
            sigma, c, ccum, rcum, h = _coarse_profile(vol, start,
                                                      direction, tmax,
                                                      coarse)
            rtot, ctot = rcum[-1], ccum[-1]
            prof = (sigma, c, rcum, h, rtot)
        e_last = torch.zeros_like(tmax)
        # the analytic control factor is folded in up front so the
        # roulette sees the full running transmittance
        trans = torch.exp(-ctot)
        small0 = (trans < RR_EPS) & (e_last < rtot)
        u0 = _indexed_draws_lead(seed, 0, 1, SALT_RR0)[0]
        survive0 = u0 * RR_EPS < trans
        e_last = torch.where(small0 & ~survive0,
                             torch.maximum(rtot, e_last) + 1.0, e_last)
        trans = torch.where(small0, torch.where(survive0, RR_EPS, 0.0),
                            trans)

        lanes = tmax.shape[0] if plan_lanes is None else plan_lanes
        segments = 0
        for seg_len, i in _segments(lanes, segment, RATIO_PLAN, max_steps):
            with profiler.sync("track.ratio"):
                idx = torch.nonzero(e_last < rtot).squeeze(1)
            if idx.numel() == 0:
                break
            segments += 1
            ev = _segment_events(vol, prof, seed, start, direction, tmax,
                                 e_last, idx, i, seg_len, SALT_RATIO)
            factors = torch.where(
                ev["beyond"], 1.0,
                1.0 - torch.clamp(ev["dens"] - ev["c_at"], min=0.0)
                / ev["sres"])
            tr_i = trans[idx] * torch.prod(factors, dim=0)
            tr_i, e_i = _ratio_rr(seed[idx], i, tr_i, ev["e_new"],
                                  ev["rtot"])
            trans = trans.index_put((idx,), tr_i)
            e_last = e_last.index_put((idx,), e_i)
        track.set(segments=segments)
    return trans, state


def delta_track_pw(state, vol: Volume, ro, rd, max_steps: int = 128,
                   segment: int = 16, active=None,
                   plan_lanes: int | None = None, coarse: int = 32):
    """Decomposition delta tracking to the box exit: the control stream's
    first collision is analytic, residual events are tracked, the earlier
    of the two is the collision (K2 and K1 at ``coarse = 32``, else the
    per-interval profile).  Returns (pos, volume_exit, new_state);
    non-collision lanes get a uniform fallback point."""
    with profiler.span("nrc.track", kind="delta",
                       lanes=ro.shape[0]) as track:
        _, exit_pt, _ = find_entry_exit(vol, ro, rd)
        tmax = torch.linalg.vector_norm(exit_pt - ro, dim=-1)
        if active is not None:
            tmax = torch.where(active, tmax, 0.0)
        ro_c, rd_c = ro.contiguous(), rd.contiguous()
        seed, state = _track_seed(state)
        if coarse == KERNEL_INTERVALS:
            tot = pw_profile(vol, ro_c, rd_c, tmax, seed, want_ctrl=True)
            rtot, prof = tot["rtot"], None
            ctrl_hit = tot["t_ctrl"] < 1.0e37
            t_ctrl = torch.where(ctrl_hit, tot["t_ctrl"], torch.inf)
        else:
            sigma, c, ccum, rcum, h = _coarse_profile(vol, ro_c, rd_c,
                                                      tmax, coarse)
            rtot = rcum[-1]
            prof = (sigma, c, rcum, h, rtot)
            # the control stream's collision: one Exp(1) depth through
            # ccum
            e_ctrl = -torch.log1p(
                -_indexed_draws_lead(seed, 0, 1, SALT_CTRL)[0])
            t_c, beyond_c, _ = _map_events(e_ctrl[None, :], ccum, h, ())
            ctrl_hit = ~beyond_c[0] & (e_ctrl < ccum[-1])
            t_ctrl = torch.where(ctrl_hit, t_c[0], torch.inf)

        # lanes with zero residual depth resolve analytically (crossed)
        empty = rtot <= 0.0
        e_last = torch.zeros_like(tmax)
        resolved, crossed = empty, empty
        # the residual stream's collision
        t_res = torch.full_like(tmax, torch.inf)

        lanes = tmax.shape[0] if plan_lanes is None else plan_lanes
        segments = 0
        for seg_len, i in _segments(lanes, segment, DELTA_PLAN, max_steps):
            with profiler.sync("track.delta"):
                idx = torch.nonzero(~resolved).squeeze(1)
            if idx.numel() == 0:
                break
            segments += 1
            ev = _segment_events(vol, prof, seed, ro_c, rd_c, tmax, e_last,
                                 idx, i, seg_len, SALT_DELTA)
            u2 = _indexed_draws_lead(seed[idx], i, seg_len, SALT_ACCEPT)
            beyond = ev["beyond"]
            accept = ~beyond & (torch.clamp(ev["dens"] - ev["c_at"],
                                            min=0.0) / ev["sres"] > u2)
            event = accept | beyond
            first = event & (torch.cumsum(event.to(torch.int32), 0) == 1)
            has_event = event.any(dim=0)
            hit_now = has_event & (first & accept).any(dim=0)
            ev_t = torch.where(first, ev["t"], 0.0).sum(dim=0)
            # only unresolved lanes ran, so every event here is new
            resolved = resolved.index_put((idx,), has_event)
            crossed = crossed.index_put((idx,), has_event & ~hit_now)
            t_res = t_res.index_put((idx,),
                                    torch.where(hit_now, ev_t, torch.inf))
            e_last = e_last.index_put((idx,), ev["e_new"])
        track.set(segments=segments)

        t_star = torch.minimum(t_ctrl, t_res)
        hit = t_star <= tmax
        exited = ~hit & crossed & ~ctrl_hit
        u3 = _indexed_draws(seed, 0, 1, SALT_FALLBACK)[..., 0]
        t_final = torch.where(hit, t_star, u3 * tmax)
    return ro + t_final[..., None] * rd, exited, state
