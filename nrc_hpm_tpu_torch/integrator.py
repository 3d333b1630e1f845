"""Volumetric path tracing: direct lighting and the bounce loop.

Port of ``nrc_hpm_tpu/integrator.py``.  ``TraceParams.mode`` picks the
trackers (``transmittance``): ``pw`` (piecewise majorant, the default),
``fast`` (segment-batched, global majorant) or ``seq`` (the reference
shaders' control flow).  ``trace_scene`` is single-scatter direct lighting
from the directional light, the point light and one phase-weighted
environment sample.  In ``pw`` and ``fast`` mode all shadow segments are
concatenated into ONE ratio-tracking call: segment k starts from the
k-times-advanced RNG state, and the environment direction is drawn before
tracking, exactly as the JAX package's batched path.  In ``seq`` mode the
segments are tracked one after the other and the environment direction
is drawn after the other lights' tracks, the reference's order.  With
``env_fixed16`` the environment sample's transmittance is the 16-step
fixed estimator instead, and only the other lights' segments are
ratio-tracked.  ``active`` masks lanes (they are tracked at ``tmax`` 0
and draw no direction), and ``env_dir`` gives the ReSTIR shading pass's
3-argument form (the env term along a stored direction through the
16-step estimator).  Lanes of any other lead shape than (N, 3), such as
that pass's (H, W) pixels, are flattened and tracked segment after
segment, as the JAX package tracks them.  ``coarse`` is the ``pw``
trackers' profile interval count.

``trace_path`` runs each bounce in two phases (delta tracking, then direct
lighting and the new direction) on the lanes alive at that phase,
compacted exactly, so live lanes see the same draws as in JAX.  Because
``pw`` ratio tracking's segment schedule depends on how many lanes the
JAX package passes to the tracker (its compaction capacity, or the full
batch below ``COMPACT_MIN_LANES`` and on overflow), each ``pw`` call is
given that count as ``plan_lanes``.  Where the JAX package runs a phase
on the full batch, every ``pw`` or ``fast`` tracker call advances the RNG
chain of dead lanes too (one step per call, ``_track_seed``); the port
advances them the same way, so the returned ``state`` feeds a second
``trace_fixed`` pass exactly as in JAX.  ``seq`` trackers draw through
masked uniforms, which leave dead lanes as they are.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import profiler, transmittance
from .lights import LightFlags, Lights, sample_env_map
from .sampling import hg_phase, new_ray_dir
from .utils import rng
from .volume import Volume, find_entry_exit


MODES = ("pw", "fast", "seq")


@dataclasses.dataclass(frozen=True)
class TraceParams:
    """Parameters of the tracking integrator."""

    flags: LightFlags
    max_track_steps: int = 128
    # the trackers: "pw" piecewise majorant, "fast" segment-batched global
    # majorant, "seq" the reference shaders' per-step loops
    mode: str = "pw"
    # events per segment of the pw and fast trackers
    segment: int = 8
    # coarse majorant intervals per track call: 32 runs kernels K1/K2,
    # other counts the per-interval profile (K5)
    coarse: int = 32
    # the env in-scatter term through the golden-era 16-step fixed
    # transmittance instead of ratio tracking
    env_fixed16: bool = False
    # compaction capacities of the JAX package, as fractions of the lanes:
    # they select its tracking schedule (see trace_path), not the values
    bounce_compact_frac: float = 0.40
    scene_compact_frac: float = 0.28

    def primary_params(self) -> "TraceParams":
        return dataclasses.replace(self, bounce_compact_frac=0.0,
                                   scene_compact_frac=0.24)

    def second_bounce_params(self) -> "TraceParams":
        return dataclasses.replace(self, scene_compact_frac=0.22)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"tracking mode {self.mode!r} is not one of "
                             f"{MODES}")

    @property
    def ratio_track(self):
        """The mode's ratio tracker: (state, vol, start, end, max_steps)
        -> (transmittance, state); ``pw`` also takes ``plan_lanes``."""
        if self.mode == "pw":
            return functools.partial(transmittance.ratio_track_pw,
                                     segment=self.segment,
                                     coarse=self.coarse)
        if self.mode == "fast":
            return functools.partial(transmittance.ratio_track_fast,
                                     segment=self.segment)
        return transmittance.ratio_track

    @property
    def delta_track(self):
        """The mode's delta tracker: (state, vol, ro, rd, max_steps) ->
        (pos, volume_exit, state); ``pw`` also takes ``plan_lanes``."""
        if self.mode == "pw":
            return functools.partial(transmittance.delta_track_pw,
                                     segment=self.segment,
                                     coarse=self.coarse)
        if self.mode == "fast":
            return functools.partial(transmittance.delta_track_fast,
                                     segment=self.segment)
        return transmittance.delta_track

    def plan(self, lanes: int) -> dict:
        """The tracker's schedule argument: ``pw`` segments follow the
        JAX package's lane count, the other modes take none."""
        return dict(plan_lanes=lanes) if self.mode == "pw" else {}


def trace_scene(state, vol: Volume, lights: Lights, p: TraceParams, pos,
                direction, active=None, env_dir=None,
                plan_lanes: int | None = None):
    """TraceScene(pos, dir): direct lighting at scatter points ``pos``
    (..., 3).  Returns (rgb (..., 3), new_state).

    ``active`` (...,) masks the lanes: inactive ones draw no direction and
    are tracked at ``tmax`` 0, though each tracker call still advances
    their chain (pw, fast).  With ``env_dir`` (..., 3) this is the
    3-argument overload of the ReSTIR shading pass: the env term looks
    along the given direction through the 16-step fixed transmittance
    and draws nothing.

    As in the JAX package, only (N, 3) lanes in ``pw``/``fast`` mode batch
    their shadow segments into one call (the env direction drawn first);
    any other lead shape, such as the ReSTIR pass's (H, W) pixels, is
    flattened and its segments tracked one after the other, the env
    direction drawn after the other lights' tracks.  ``plan_lanes`` (the
    flattened count by default) is the lane count the JAX package's
    tracker sees per segment."""
    lead = pos.shape[:-1]
    batched_form = pos.ndim == 2
    n = pos[..., 0].numel()
    pos, direction = pos.reshape(n, 3), direction.reshape(n, 3)
    state = state.reshape(n)
    if active is not None:
        active = active.reshape(n)
    if env_dir is not None:
        env_dir = env_dir.reshape(n, 3)
    plan_lanes = n if plan_lanes is None else plan_lanes
    total = torch.zeros_like(pos)
    segs = []   # (start, end, weight_fn)
    if p.flags.dir_on:
        dl = lights.dir_light
        to_exit = (-dl.direction / torch.linalg.vector_norm(dl.direction)
                   ).expand(pos.shape)
        _, exit_pt, _ = find_entry_exit(vol, pos, to_exit)
        phase = hg_phase(torch.sum(dl.direction * -direction, dim=-1), vol.g)
        segs.append((pos, exit_pt, lambda tr, ph=phase, dl=dl:
                     (tr * dl.strength * ph)[..., None]))
    if p.flags.point_on:
        pl = lights.point_light
        lpos = pl.pos.expand(pos.shape)
        to_light = lpos - pos
        to_light = to_light / torch.clamp(
            torch.linalg.vector_norm(to_light, dim=-1, keepdim=True),
            min=1e-12)
        phase = hg_phase(torch.sum(to_light * -direction, dim=-1), vol.g)
        segs.append((lpos, pos, lambda tr, ph=phase, pl=pl:
                     pl.color * (pl.strength * tr * ph)[..., None]))
    env_sample = p.flags.env_on and env_dir is None
    batched = (p.mode != "seq" and batched_form
               and len(segs) + int(env_sample) > 1)
    if p.flags.env_on and env_dir is not None:
        _, exit_pt, _ = find_entry_exit(vol, pos, env_dir)
        trans = transmittance.fixed_step_transmittance(vol, pos, exit_pt, 16)
        phase = hg_phase(torch.sum(-direction * env_dir, dim=-1), vol.g)
        total = total + sample_env_map(lights.env, env_dir) * (
            trans * phase)[..., None]
    elif env_sample:
        if not batched:
            # the reference's order: the other lights' tracks draw first
            total, state = _track_each(state, vol, p, segs, total, active,
                                       plan_lanes)
            segs = []
        rand_dir, state = new_ray_dir(state, direction, vol.g,
                                      phase_sampling=False, active=active)
        phase = hg_phase(torch.sum(rand_dir * -direction, dim=-1), vol.g)
        _, exit_pt, _ = find_entry_exit(vol, pos, rand_dir)
        env = sample_env_map(lights.env, rand_dir)
        if p.env_fixed16:
            trans = transmittance.fixed_step_transmittance(vol, pos, exit_pt,
                                                           16)
            total = total + env * (phase * trans)[..., None]
        else:
            segs.append((pos, exit_pt, lambda tr, ph=phase, env=env:
                         env * (ph * tr)[..., None]))
    if not (batched and len(segs) > 1):
        total, state = _track_each(state, vol, p, segs, total, active,
                                   plan_lanes)
        return total.reshape(*lead, 3), state.reshape(lead)

    states = [state]
    for _ in range(len(segs) - 1):
        states.append(rng.uniform(states[-1])[1])
    k = len(segs)
    trans, state_cat = p.ratio_track(
        torch.cat(states), vol, torch.cat([s[0] for s in segs]),
        torch.cat([s[1] for s in segs]), p.max_track_steps,
        active=None if active is None else active.repeat(k),
        **p.plan(k * plan_lanes))
    for j, (_, _, weight) in enumerate(segs):
        total = total + weight(trans[j * n:(j + 1) * n])
    return total, state_cat[(k - 1) * n:]


def _track_each(state, vol: Volume, p: TraceParams, segs, total, active,
                plan_lanes: int):
    """Ratio-track the shadow segments one after the other."""
    for start, end, weight in segs:
        trans, state = p.ratio_track(state, vol, start, end,
                                     p.max_track_steps, active=active,
                                     **p.plan(plan_lanes))
        total = total + weight(trans)
    return total, state


def _jax_lanes(n: int, frac: float, count: int) -> int:
    """Lanes the JAX package hands a tracker for one compacted phase: the
    static capacity when its live count fits, else the full batch."""
    if frac > 0 and n >= transmittance.COMPACT_MIN_LANES:
        cap = max(int(n * frac), 128)
        return cap if count <= cap else n
    return n


@profiler.region("rng")
def _advance_dead(state, alive, steps: int):
    """Advance the RNG chain of the lanes that are not alive by ``steps``
    draws (the JAX package's full-batch phases do so)."""
    return rng.advance_dead(state, alive, steps)


def trace_path(state, vol: Volume, lights: Lights, p: TraceParams, ro, rd,
               *, n_bounces: int, primary_ray_length: int | None = None,
               primary_ray_prob: float = 0.0, active=None,
               path: str = "train"):
    """The shared bounce loop.  ro/rd (N, 3): ray origins and unit
    directions (the first segment starts at the box entry); ``path``
    names the loop in each bounce's span (primary, train or mc).  Returns
    dict with radiance (N, 3), throughput (N,), did_scatter (N,), terminal_pos
    / terminal_dir (N, 3) (the NRC query), alive (N,) (lanes still inside
    the volume when the bounce budget ran out) and state (N,)."""
    n = ro.shape[0]
    dev = ro.device
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    point, _, _ = find_entry_exit(vol, ro, rd)
    direction = rd
    radiance = torch.zeros_like(ro)
    factor = torch.ones(n, dtype=ro.dtype, device=dev)
    scattered = torch.zeros(n, dtype=torch.bool, device=dev)
    alive = active
    unrolled = (primary_ray_length is not None and primary_ray_prob == 0.0
                and n_bounces <= 2
                and n >= transmittance.COMPACT_MIN_LANES)
    # pw and fast trackers advance every lane's chain once per call
    # (seq ones draw through masked uniforms): a full-batch phase of the
    # JAX package advances its dead lanes so
    chained = p.mode != "seq"
    # ratio-tracked shadow segments per scene phase (each advances the
    # chain once)
    n_segs = (int(p.flags.dir_on) + int(p.flags.point_on)
              + int(p.flags.env_on and not p.env_fixed16))

    for i in range(n_bounces):
        with profiler.span("nrc.bounce", i=i, path=path) as bounce:
            p_b = p.second_bounce_params() if unrolled and i > 0 else p
            with profiler.sync("bounce.delta"):
                idx = torch.nonzero(alive).squeeze(1)
            bounce.set(lanes=idx.numel())
            if idx.numel() == 0:
                break
            # delta phase: find the next collision
            plan = _jax_lanes(n, p_b.bounce_compact_frac, idx.numel())
            if plan == n and chained:
                state = _advance_dead(state, alive, 1)
            new_pt, exited, st = p_b.delta_track(
                state[idx], vol, point[idx], direction[idx],
                p_b.max_track_steps, **p_b.plan(plan))
            point = point.index_put((idx,), new_pt)
            alive = alive.index_put((idx,), ~exited)
            state = state.index_put((idx,), st)
            scattered = scattered | alive

            # scene phase: direct light at the collision, then a new
            # direction
            with profiler.sync("bounce.scene"):
                idx = torch.nonzero(alive).squeeze(1)
            plan = _jax_lanes(n, p_b.scene_compact_frac, idx.numel())
            if plan == n and chained:
                state = _advance_dead(state, alive, n_segs)
            if idx.numel() == 0:
                break
            f_i = factor[idx] * 0.5
            light, st = trace_scene(
                state[idx], vol, lights, p_b, point[idx], direction[idx],
                plan_lanes=plan)
            radiance = radiance.index_put(
                (idx,), radiance[idx] + light * f_i[:, None])
            factor = factor.index_put((idx,), f_i)
            new_dir, st = new_ray_dir(st, direction[idx], vol.g,
                                      phase_sampling=True)
            direction = direction.index_put((idx,), new_dir)
            if primary_ray_length is not None and i >= primary_ray_length:
                u, st = rng.uniform(st)
                terminate = (u >= primary_ray_prob) | (i == 128)
                alive = alive.index_put((idx,), ~terminate)
            state = state.index_put((idx,), st)

    return dict(radiance=radiance, throughput=factor, did_scatter=scattered,
                terminal_pos=point, terminal_dir=direction, alive=alive,
                state=state)


def trace_primary(state, vol, lights, p: TraceParams, ro, rd, cfg,
                  active=None):
    """gen_rays TracePath: the short NRC path (``cfg`` gives
    primary_ray_length / primary_ray_prob / max_primary_bounces)."""
    if cfg.primary_ray_prob <= 0.0:
        n = min(cfg.primary_ray_length + 1, cfg.max_primary_bounces)
        prob = 0.0
    else:
        n = cfg.max_primary_bounces
        prob = cfg.primary_ray_prob
    return trace_path(state, vol, lights, p, ro, rd, n_bounces=n,
                      primary_ray_length=cfg.primary_ray_length,
                      primary_ray_prob=prob, active=active, path="primary")


def trace_fixed(state, vol, lights, p: TraceParams, ro, rd, n_bounces: int,
                active=None, path: str = "train"):
    """Train TracePath: up to ``n_bounces`` delta-tracked bounces."""
    return trace_path(state, vol, lights, p, ro, rd, n_bounces=n_bounces,
                      active=active, path=path)


def primary_miss_mask(vol: Volume, ro, rd):
    """Rays that miss the volume box."""
    _, _, hit = find_entry_exit(vol, ro, rd)
    return ~hit
