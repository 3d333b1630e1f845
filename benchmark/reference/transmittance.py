"""Delta and ratio tracking with the piecewise majorant, and the
fixed-step transmittance: the port's ``pw`` trackers at the 32 coarse
intervals kernels K1/K2 serve, with their plain versions (``pw_plain``).

Each track opens with ``pw_profile`` (K2) and runs segments of
``pw_events`` (K1), with the fine-grid density gather and the ratio/delta
fold in torch.  Events are drawn statelessly, indexed by a global event
counter, so a lane's values do not depend on which other lanes run with
it: the unresolved lanes are compacted exactly (``torch.nonzero``) before
every segment.  The segment LENGTHS do matter (ratio tracking's Russian
roulette draw is indexed by the segment's base event): one ``segment``
length below ``COMPACT_MIN_LANES`` lanes, else ``RATIO_PLAN`` /
``DELTA_PLAN``; ``plan_lanes`` names the lane count that sets the
schedule (see integrator.trace_path).
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng
from .pw_plain import SALT_DELTA, SALT_RATIO, pw_events, pw_profile
from .volume import Volume, find_entry_exit, get_density_xyz

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


def _track_seed(state):
    """Split one indexed-draw seed (the state's bits, as int32) off the
    chain, which advances one step per track call."""
    seed = state.contiguous().view(torch.int32)
    _, state = rng.uniform(state)
    return seed, state


def _indexed_draws(seed, k0: int, n: int, salt: int):
    """u_k = floatConstruct(hash(seed ^ hash(salt + k))), k in [k0, k0+n);
    seed (...,) int32 bits -> (..., n) float32."""
    ks = torch.arange(n, dtype=torch.int64, device=seed.device) + k0
    hk = rng.hash_u32(ks + salt)
    s64 = seed.to(torch.int64) & rng.M32
    return rng.float_construct(rng.hash_u32(s64[..., None] ^ hk))


def _indexed_draws_lead(seed, k0: int, n: int, salt: int):
    """_indexed_draws with the event axis leading: (n, ...) float32."""
    return torch.movedim(_indexed_draws(seed, k0, n, salt), -1, 0)


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


def _fine_density(vol: Volume, lin):
    """density_factor/255 * grid[lin], 0 where lin = -1."""
    raw = vol.grid.reshape(-1)[torch.clamp(lin, min=0).to(torch.int64)]
    scale = float(np.float32(vol.density_factor) * np.float32(1.0 / 255.0))
    return torch.where(lin >= 0, raw.to(torch.float32) * scale, 0.0)


def _segment_events(vol: Volume, seed, start, direction, tmax, e_last, idx,
                    i: int, seg_len: int, salt: int) -> dict:
    """One tracking segment's ``seg_len`` residual events for the lanes
    ``idx`` (K1): t (S, n), beyond (S, n), the fine density, the control
    and residual majorant at each event, e_new and rtot (n,)."""
    ev = pw_events(vol, start[idx], direction[idx], tmax[idx], seed[idx],
                   e_last[idx], i, S=seg_len, salt=salt)
    return dict(t=ev["t"], beyond=ev["t"] < 0.0,
                dens=_fine_density(vol, ev["lin"]), c_at=ev["c_at"],
                sres=ev["sres"], e_new=ev["e_new"], rtot=ev["rtot"])


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
                   plan_lanes: int | None = None):
    """Residual ratio tracking with the piecewise control/majorant:
    T = exp(-int c) * E[prod over residual events (1 - (d - c)/(sigma - c))].
    start/end (N, 3); returns (transmittance (N,), new_state)."""
    seg_vec = end - start
    tmax = torch.linalg.vector_norm(seg_vec, dim=-1)
    direction = (seg_vec / torch.clamp(tmax, min=1e-12)[..., None]
                 ).contiguous()
    if active is not None:
        tmax = torch.where(active, tmax, 0.0)
    start = start.contiguous()
    seed, state = _track_seed(state)
    tot = pw_profile(vol, start, direction, tmax, seed)
    rtot, ctot = tot["rtot"], tot["ctot"]
    e_last = torch.zeros_like(tmax)
    # the analytic control factor is folded in up front so the roulette
    # sees the full running transmittance
    trans = torch.exp(-ctot)
    small0 = (trans < RR_EPS) & (e_last < rtot)
    u0 = _indexed_draws_lead(seed, 0, 1, SALT_RR0)[0]
    survive0 = u0 * RR_EPS < trans
    e_last = torch.where(small0 & ~survive0,
                         torch.maximum(rtot, e_last) + 1.0, e_last)
    trans = torch.where(small0, torch.where(survive0, RR_EPS, 0.0), trans)

    lanes = tmax.shape[0] if plan_lanes is None else plan_lanes
    for seg_len, i in _segments(lanes, segment, RATIO_PLAN, max_steps):
        idx = torch.nonzero(e_last < rtot).squeeze(1)
        if idx.numel() == 0:
            break
        ev = _segment_events(vol, seed, start, direction, tmax, e_last, idx,
                             i, seg_len, SALT_RATIO)
        factors = torch.where(
            ev["beyond"], 1.0,
            1.0 - torch.clamp(ev["dens"] - ev["c_at"], min=0.0) / ev["sres"])
        tr_i = trans[idx] * torch.prod(factors, dim=0)
        tr_i, e_i = _ratio_rr(seed[idx], i, tr_i, ev["e_new"], ev["rtot"])
        trans = trans.index_put((idx,), tr_i)
        e_last = e_last.index_put((idx,), e_i)
    return trans, state


def delta_track_pw(state, vol: Volume, ro, rd, max_steps: int = 128,
                   segment: int = 16, active=None,
                   plan_lanes: int | None = None):
    """Decomposition delta tracking to the box exit: the control stream's
    first collision is analytic (K2), residual events are tracked (K1),
    the earlier of the two is the collision.  Returns (pos, volume_exit,
    new_state); non-collision lanes get a uniform fallback point."""
    _, exit_pt, _ = find_entry_exit(vol, ro, rd)
    tmax = torch.linalg.vector_norm(exit_pt - ro, dim=-1)
    if active is not None:
        tmax = torch.where(active, tmax, 0.0)
    ro_c, rd_c = ro.contiguous(), rd.contiguous()
    seed, state = _track_seed(state)
    tot = pw_profile(vol, ro_c, rd_c, tmax, seed, want_ctrl=True)
    rtot = tot["rtot"]
    ctrl_hit = tot["t_ctrl"] < 1.0e37
    t_ctrl = torch.where(ctrl_hit, tot["t_ctrl"], torch.inf)

    # lanes with zero residual depth resolve analytically (crossed)
    empty = rtot <= 0.0
    e_last = torch.zeros_like(tmax)
    resolved, crossed = empty, empty
    t_res = torch.full_like(tmax, torch.inf)   # residual-stream collision

    lanes = tmax.shape[0] if plan_lanes is None else plan_lanes
    for seg_len, i in _segments(lanes, segment, DELTA_PLAN, max_steps):
        idx = torch.nonzero(~resolved).squeeze(1)
        if idx.numel() == 0:
            break
        ev = _segment_events(vol, seed, ro_c, rd_c, tmax, e_last, idx, i,
                             seg_len, SALT_DELTA)
        u2 = _indexed_draws_lead(seed[idx], i, seg_len, SALT_ACCEPT)
        beyond = ev["beyond"]
        accept = ~beyond & (torch.clamp(ev["dens"] - ev["c_at"], min=0.0)
                            / ev["sres"] > u2)
        event = accept | beyond
        first = event & (torch.cumsum(event.to(torch.int32), 0) == 1)
        has_event = event.any(dim=0)
        hit_now = has_event & (first & accept).any(dim=0)
        ev_t = torch.where(first, ev["t"], 0.0).sum(dim=0)
        # only unresolved lanes ran, so every event here is new
        resolved = resolved.index_put((idx,), has_event)
        crossed = crossed.index_put((idx,), has_event & ~hit_now)
        t_res = t_res.index_put((idx,), torch.where(hit_now, ev_t, torch.inf))
        e_last = e_last.index_put((idx,), ev["e_new"])

    t_star = torch.minimum(t_ctrl, t_res)
    hit = t_star <= tmax
    exited = ~hit & crossed & ~ctrl_hit
    u3 = _indexed_draws(seed, 0, 1, SALT_FALLBACK)[..., 0]
    t_final = torch.where(hit, t_star, u3 * tmax)
    return ro + t_final[..., None] * rd, exited, state
