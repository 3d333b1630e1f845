"""ReSTIR path-reservoir renderer for heterogeneous participating media.

Port of ``nrc_hpm_tpu/models/restir.py``: the reference's four ReSTIR
compute shaders (local init, temporal reuse, spatial reuse, render) as
one ``state -> state`` frame over dense per-pixel reservoir arrays.

Per frame:
  1. ``_local_init``: per pixel, walk ``path_vertex_count`` candidate
     vertices from the volume entry (a uniform step within 10% of the
     distance to the box exit, a phase-sampled direction where the density
     is > 0), storing (position, random probe direction) per vertex;
     pixel info = (env background, did-scatter).
  2. ``_temporal_reuse``: streaming resampling over the
     ``temporal_kernel_size`` previous frames x path suffixes; the chosen
     (slot, vertex) splices that old reservoir's suffix into the current
     path.  Old reservoirs live in a ring indexed by frame % T.
  3. ``_spatial_reuse``: the same stream over the K^2 - 1 neighbours'
     suffixes, spliced from the selected neighbour.
  4. ``_shade``: single-scatter lighting at each reservoir vertex with
     density > 0 through the 3-argument ``trace_scene`` (the stored probe
     direction for the env term; the dir and point lights' shadow
     segments ratio-tracked on all H x W lanes, masked), the HG phase
     factor at the exchange vertex, 8-step fixed transmittance between
     vertices; the background shows where the transmittance stays 1.

With ``mis_weights`` the streams are weighted RIS: each candidate's
weight is the phase reconnection factor the shading pass applies at the
exchange vertex, and the shading scales it by W = wsum / (M * w_sel).
With ``mis_weights=False`` every weight is 1: the shaders' uniform
1/stream splicing, with the same draws.

Two faults of the JAX package are ported as they are, so the two agree:
``_temporal_reuse`` writes the current reservoir into the ring before it
splices, so at t = K - 1 the slot it splices from is the current one
(the pixel's own path) while the weight came from the old bank, which
biases ``mis_weights=True``; and ``_shade`` does not clamp W.

Every stage reseeds from the same per-frame uniform, and only the lanes
a stage masks in draw.  ``frame`` is a host integer, so the ring is
indexed without reading the card back; the frame's host syncs (the
copies to the card of the seed and the probe directions' fallback axis,
and the shadow trackers' compaction) each sit in a ``profiler.sync``.

On the card the two reuse stages are one kernel launch each
(``ops/restir_reuse.py``, ``csrc/restir_reuse.cu``: one thread a pixel
walks its candidates in registers), bit for bit their plain versions
``_temporal_reuse_plain`` and ``_spatial_reuse_plain``, which CPU tensors
take.  No stage writes into its inputs.

As ``McRenderer`` and ``NrcRenderer`` do, ``step`` blends each frame into
a running mean with weight 1 / ``blend_index`` (``blend=False`` keeps only
the latest frame, as the JAX package does); ``frame`` stays the temporal
ring's index.  While ``torch.profiler`` records, ``step`` is an
``nrc.frame`` span holding the spans ``restir.local_init``,
``restir.temporal``, ``restir.spatial`` and ``restir.shade``, each with
the lanes (H x W), ``V``, ``T``, ``K`` and the ``candidates`` it streams a
lane.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import profiler
from ..camera import Camera, pixel_rays
from ..config import AppConfig
from ..integrator import TraceParams, trace_scene
from ..lights import LightFlags, Lights, lights_from_scene, sample_env_map
from ..ops import _build, restir_reuse
from ..renderer import _blend, _volume_from_config
from ..sampling import hg_phase, new_ray_dir
from ..transmittance import fixed_step_transmittance
from ..utils import prng, rng
from ..volume import Volume, find_entry_exit, get_density


@dataclasses.dataclass
class RestirState:
    """All per-run ReSTIR buffers."""

    image: torch.Tensor           # (H, W, 4) rgb + transmittance
    blend_index: int              # the running mean's next frame, from 1
    pixel_info: torch.Tensor      # (H, W, 4) env background + did-scatter
    stats: torch.Tensor           # (H, W, 2) stream index, exchange vertex
    reservoir: torch.Tensor       # (H, W, V, 6) path vertices (pos, dir)
    old_reservoirs: torch.Tensor  # (T, H, W, V, 6) previous-frame ring
    frame: int                    # frame counter: the ring's index
    key: torch.Tensor             # threefry key of the per-frame seeds


class RestirRenderer:
    """Volumetric path-reservoir ReSTIR on ``vol.device``: local init,
    temporal reuse, spatial reuse and shading, one ``step`` per frame,
    blended into a running mean (``blend=False`` keeps only the latest
    frame).  Without ``vol`` it loads the configuration's cloud onto
    ``device``."""

    def __init__(self, cfg: AppConfig, vol: Optional[Volume] = None,
                 lights: Optional[Lights] = None,
                 width: Optional[int] = None, height: Optional[int] = None,
                 device="cuda", blend: bool = True):
        self.cfg = cfg
        self.blend = blend
        self.width = width or cfg.render_width
        self.height = height or cfg.render_height
        self.vol = vol if vol is not None \
            else _volume_from_config(cfg, device)
        self.device = self.vol.device
        self.lights = lights if lights is not None \
            else lights_from_scene(cfg.scene, device=self.device)
        # the default parameters, not the primary pass's
        self.params = TraceParams(flags=LightFlags.from_scene(cfg.scene),
                                  max_track_steps=cfg.max_track_steps,
                                  env_fixed16=cfg.env_fixed16)
        self.n_vertices = cfg.restir.path_vertex_count
        self.spatial_kernel = cfg.restir.spatial_kernel_size
        self.temporal_kernel = cfg.restir.temporal_kernel_size
        self.mis_weights = cfg.restir.mis_weights

    def init_state(self, seed: int = 0) -> RestirState:
        """Zero buffers, frame 0, blend index 1 and the key
        ``PRNGKey(seed)``."""
        h, w, v, t = (self.height, self.width, self.n_vertices,
                      self.temporal_kernel)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32,
                               device=self.device)

        return RestirState(
            image=zeros(h, w, 4), blend_index=1, pixel_info=zeros(h, w, 4),
            stats=zeros(h, w, 2), reservoir=zeros(h, w, v, 6),
            old_reservoirs=zeros(t, h, w, v, 6), frame=0,
            key=prng.prng_key(seed))

    def step(self, state: RestirState, camera: Camera) -> RestirState:
        """One frame, its seed drawn from a split of ``state.key``."""
        with profiler.span(profiler.FRAME):
            out, st = _restir_step(
                state, camera, self.vol, self.lights, params=self.params,
                width=self.width, height=self.height,
                n_vertices=self.n_vertices,
                spatial_kernel=self.spatial_kernel,
                temporal_kernel=self.temporal_kernel,
                mis_weights=self.mis_weights)
            image, blend_index = _blend(state, out, self.blend)
            return dataclasses.replace(st, image=image,
                                       blend_index=blend_index)

    def render(self, camera: Camera, frames: int, seed: int = 0
               ) -> torch.Tensor:
        """``frames`` frames from ``init_state(seed)``; returns the (H, W,
        4) image (with ``blend``, their running mean)."""
        state = self.init_state(seed)
        for _ in range(frames):
            state = self.step(state, camera)
        return state.image


def _normalized(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-12)


# --- stage 1: local candidate generation -----------------------------------

def _local_init(rng_state, vol: Volume, lights: Lights, ro, rd,
                prev_reservoir, n_vertices: int):
    """Walk V candidate vertices from the box entry; each stores (position,
    fresh random probe direction).  Pixels whose ray misses the box keep
    their previous reservoir.  Returns (reservoir, pixel_info, stats,
    rng_state)."""
    cur, _, hit = find_entry_exit(vol, ro, rd)
    cur_dir = rd
    did_scatter = torch.zeros_like(hit)
    verts = []
    for _ in range(n_vertices):
        scat = hit & (get_density(vol, cur) > 0.0)
        did_scatter = did_scatter | scat
        # the direction resampled at scattering vertices
        nd, rng_state = new_ray_dir(rng_state, cur_dir, vol.g,
                                    phase_sampling=True, active=scat)
        cur_dir = torch.where(scat[..., None], nd, cur_dir)
        # the stored probe direction
        probe, rng_state = new_ray_dir(rng_state, cur_dir, vol.g,
                                       phase_sampling=False, active=hit)
        verts.append(torch.cat([cur, probe], dim=-1))
        # the next candidate: a uniform step within 10% of the distance
        # to the exit
        _, exit_pt, _ = find_entry_exit(vol, cur, cur_dir)
        max_dist = torch.linalg.vector_norm(exit_pt - cur, dim=-1) * 0.1
        u, rng_state = rng.masked_uniform(rng_state, hit)
        cur = cur + cur_dir * (u * max_dist)[..., None]

    reservoir = torch.where(hit[..., None, None], torch.stack(verts, dim=-2),
                            prev_reservoir)
    did = (hit & did_scatter).to(torch.float32)
    pixel_info = torch.cat([sample_env_map(lights.env, rd), did[..., None]],
                           dim=-1)
    # (stream index 1, exchange vertex 0)
    stats = torch.stack([torch.ones_like(did), torch.zeros_like(did)],
                        dim=-1)
    return reservoir, pixel_info, stats, rng_state


# --- stage 2: temporal reuse ------------------------------------------------

def _splice_weight(own_res, q, v: int, g: float):
    """Resampling weight of splicing a suffix that starts at ``q`` onto
    the own prefix [0..v-1]: hg_phase of the angle between the prefix's
    incoming direction and the connection direction, the factor the
    shading pass applies at the exchange vertex."""
    r = own_res[..., v - 1, :3]
    if v >= 2:
        last_dir = _normalized(r - own_res[..., v - 2, :3])
    else:
        last_dir = torch.zeros_like(r)
    conn = _normalized(q - r)
    return hg_phase(torch.sum(last_dir * -conn, dim=-1), g)


def _temporal_reuse(rng_state, reservoir, old_reservoirs, stats, mis,
                    pixel_info, frame: int, n_vertices: int,
                    temporal_kernel: int, g: float = 0.0,
                    weighted: bool = False):
    """Streaming RIS over (temporal slot, suffix start vertex) on the
    scattered pixels, then the chosen old suffix spliced in (a no-op on
    frame 0).  Returns (reservoir, old_reservoirs, stats, mis,
    rng_state); ``old_reservoirs`` is a new ring with the current
    reservoir written into slot frame % T where a pixel resampled.  No
    input is written.  CPU tensors take ``_temporal_reuse_plain``, CUDA
    tensors one launch of ``ops.restir_reuse.temporal_reuse``."""
    if not _build.on_card("temporal_reuse", reservoir.device):
        return _temporal_reuse_plain(
            rng_state, reservoir, old_reservoirs, stats, mis, pixel_info,
            frame, n_vertices, temporal_kernel, g=g, weighted=weighted)
    _build.require("temporal_reuse", reservoir.shape[2] == n_vertices,
                   f"the reservoir holds {reservoir.shape[2]} vertices, not "
                   f"{n_vertices}")
    return restir_reuse.temporal_reuse(
        rng_state, reservoir, old_reservoirs, stats, mis, pixel_info, frame,
        temporal_kernel, g, weighted)


def _temporal_reuse_plain(rng_state, reservoir, old_reservoirs, stats, mis,
                          pixel_info, frame: int, n_vertices: int,
                          temporal_kernel: int, g: float = 0.0,
                          weighted: bool = False):
    """``_temporal_reuse`` in PyTorch operations, candidate by candidate
    over the whole image."""
    T = temporal_kernel
    scat = pixel_info[..., 3] == 1.0
    stream = stats[..., 0]
    wsum, w_sel = mis[..., 0], mis[..., 1]
    t_idx = torch.full(scat.shape, -1, dtype=torch.int32, device=scat.device)
    v_idx = torch.zeros_like(t_idx)
    ones = torch.ones_like(wsum)
    for t in range(T):
        if weighted:
            # a floor-mod of the possibly negative frame - (t + 1)
            bank = old_reservoirs[(frame - (t + 1)) % T]
            valid_t = float(frame > t)
        for v in range(1, n_vertices):
            w = _splice_weight(reservoir, bank[..., v, :3], v, g) * valid_t \
                if weighted else ones
            wsum_new = wsum + w
            prob = w / torch.clamp(wsum_new, min=1e-20)
            u, rng_state = rng.masked_uniform(rng_state, scat)
            sel = scat & (u < prob)
            t_idx = torch.where(sel, t, t_idx)
            v_idx = torch.where(sel, v, v_idx)
            w_sel = torch.where(sel, w, w_sel)
            wsum = torch.where(scat, wsum_new, wsum)
            stream = torch.where(scat, stream + 1.0, stream)
    stats = torch.stack([torch.where(scat, stream, stats[..., 0]),
                         torch.where(scat, v_idx.to(torch.float32),
                                     stats[..., 1])], dim=-1)
    mis = torch.stack([wsum, w_sel], dim=-1)

    do = scat & (t_idx >= 0) & (frame > 0)
    t_back = torch.clamp(t_idx, max=frame - 1) + 1
    last_slot = torch.remainder(frame - t_back, T)      # per pixel
    cur_slot = frame % T
    # the current reservoir into the ring (only where a pixel resampled),
    # BEFORE the splice gathers from it
    cur_bank = torch.where(do[..., None, None], reservoir,
                           old_reservoirs[cur_slot])
    old_reservoirs = old_reservoirs.clone()
    old_reservoirs[cur_slot] = cur_bank
    # the suffix [v_idx:] from each pixel's selected slot
    index = last_slot.to(torch.int64)[None, ..., None, None].expand(
        (1,) + reservoir.shape)
    sel_old = torch.gather(old_reservoirs, 0, index)[0]
    vmask = torch.arange(n_vertices, device=v_idx.device) >= v_idx[..., None]
    take = do[..., None] & vmask
    reservoir = torch.where(take[..., None], sel_old, reservoir)
    return reservoir, old_reservoirs, stats, mis, rng_state


# --- stage 3: spatial reuse -------------------------------------------------

def _spatial_reuse(rng_state, reservoir, stats, mis, pixel_info,
                   n_vertices: int, spatial_kernel: int, height: int,
                   width: int, g: float = 0.0, weighted: bool = False):
    """The same stream over the in-bounds scattered neighbours' suffixes
    (neighbour-major: dx, then dy, then the vertex), then the selected
    neighbour's suffix spliced in from the reservoir as it entered the
    stage.  Returns (reservoir, stats, mis, rng_state); no input is
    written.  CPU tensors take ``_spatial_reuse_plain``, CUDA tensors one
    launch of ``ops.restir_reuse.spatial_reuse``."""
    if not _build.on_card("spatial_reuse", reservoir.device):
        return _spatial_reuse_plain(
            rng_state, reservoir, stats, mis, pixel_info, n_vertices,
            spatial_kernel, height, width, g=g, weighted=weighted)
    _build.require("spatial_reuse", tuple(reservoir.shape[:3])
                   == (height, width, n_vertices),
                   f"the reservoir is {tuple(reservoir.shape)}, not "
                   f"({height}, {width}, {n_vertices}, 6)")
    return restir_reuse.spatial_reuse(rng_state, reservoir, stats, mis,
                                      pixel_info, spatial_kernel, g,
                                      weighted)


def _spatial_reuse_plain(rng_state, reservoir, stats, mis, pixel_info,
                         n_vertices: int, spatial_kernel: int, height: int,
                         width: int, g: float = 0.0, weighted: bool = False):
    """``_spatial_reuse`` in PyTorch operations, candidate by candidate
    over the whole image."""
    scat = pixel_info[..., 3] == 1.0
    stream = stats[..., 0]
    wsum, w_sel = mis[..., 0], mis[..., 1]
    k_max = spatial_kernel // 2
    dev = reservoir.device
    yy = torch.arange(height, device=dev)[:, None]
    xx = torch.arange(width, device=dev)[None, :]
    pos_all = reservoir[..., :3]                        # (H, W, V, 3)
    ones = torch.ones_like(wsum)

    sel_dx = torch.zeros(scat.shape, dtype=torch.int32, device=dev)
    sel_dy = torch.zeros_like(sel_dx)
    v_idx = torch.zeros_like(sel_dx)
    found = torch.zeros_like(scat)
    for dx in range(-k_max, k_max + 1):
        for dy in range(-k_max, k_max + 1):
            if dx == 0 and dy == 0:
                continue
            ny, nx = yy + dy, xx + dx
            in_bounds = (ny >= 0) & (ny < height) & (nx >= 0) & (nx < width)
            nb_scat = in_bounds & (
                pixel_info[ny.clamp(0, height - 1), nx.clamp(0, width - 1),
                           3] == 1.0)
            ok = scat & nb_scat
            if weighted:
                # a static shift: the wrapped border rows have ok False
                nb_pos = torch.roll(pos_all, shifts=(-dy, -dx), dims=(0, 1))
            for v in range(1, n_vertices):
                w = _splice_weight(reservoir, nb_pos[..., v, :], v, g) \
                    if weighted else ones
                wsum_new = torch.where(ok, wsum + w, wsum)
                prob = w / torch.clamp(wsum_new, min=1e-20)
                u, rng_state = rng.masked_uniform(rng_state, ok)
                sel = ok & (u < prob)
                sel_dx = torch.where(sel, dx, sel_dx)
                sel_dy = torch.where(sel, dy, sel_dy)
                v_idx = torch.where(sel, v, v_idx)
                w_sel = torch.where(sel, w, w_sel)
                found = found | sel
                wsum = wsum_new
                stream = torch.where(ok, stream + 1.0, stream)
            if weighted:
                del nb_pos
    stats = torch.stack([torch.where(scat, stream, stats[..., 0]),
                         torch.where(found, v_idx.to(torch.float32),
                                     stats[..., 1])], dim=-1)
    mis = torch.stack([wsum, w_sel], dim=-1)

    gy = (yy + sel_dy).clamp(0, height - 1)
    gx = (xx + sel_dx).clamp(0, width - 1)
    nb_res = reservoir[gy, gx]                           # (H, W, V, 6)
    vmask = torch.arange(n_vertices, device=dev) >= v_idx[..., None]
    take = found[..., None] & vmask
    reservoir = torch.where(take[..., None], nb_res, reservoir)
    return reservoir, stats, mis, rng_state


# --- stage 4: shading -------------------------------------------------------

def _shade(rng_state, vol: Volume, lights: Lights, p: TraceParams,
           reservoir, stats, pixel_info, n_vertices: int, mis=None):
    """Single-scatter lighting along the reservoir path with 8-step
    inter-vertex transmittance; the HG phase factor applies at the
    exchange vertex, scaled by W = wsum / (M * w_sel) when ``mis`` is
    given.  Returns ((H, W, 4) rgb + transmittance, rng_state)."""
    scat_px = pixel_info[..., 3] == 1.0
    exchange = stats[..., 1].to(torch.int32)
    if mis is not None:
        wsum, w_sel = mis[..., 0], mis[..., 1]
        m_count = torch.clamp(stats[..., 0] - 1.0, min=1.0)
        ris_w = torch.where(w_sel > 0.0,
                            wsum / (m_count * torch.clamp(w_sel, min=1e-20)),
                            1.0)
    else:
        ris_w = torch.ones_like(stats[..., 0])

    last = reservoir[..., 0, :3]
    last_dir = torch.zeros_like(last)
    light = torch.zeros_like(last)
    trans = torch.ones_like(last[..., 0])
    total_phase = torch.ones_like(trans)
    for i in range(1, n_vertices):
        vp = reservoir[..., i, :3]
        probe = reservoir[..., i, 3:]
        cur_dir = _normalized(vp - last)
        dens = get_density(vol, vp)
        m = scat_px & (dens > 0.0)
        scene, rng_state = trace_scene(rng_state, vol, lights, p, vp,
                                       cur_dir, m, env_dir=probe)
        ph = torch.where(
            exchange == i,
            hg_phase(torch.sum(last_dir * -cur_dir, dim=-1), vol.g) * ris_w,
            1.0)
        total_phase = torch.where(m, total_phase * ph, total_phase)
        s_int = dens[..., None] * scene * total_phase[..., None]
        t_r = fixed_step_transmittance(vol, vp, last, 8)
        light = torch.where(m[..., None], light + trans[..., None] * s_int,
                            light)
        trans = torch.where(m, trans * t_r, trans)
        last = torch.where(m[..., None], vp, last)
        last_dir = torch.where(m[..., None], cur_dir, last_dir)

    # nothing shaded (transmittance 1): the background
    rgb = torch.where((trans == 1.0)[..., None], pixel_info[..., :3], light)
    return torch.cat([rgb, trans[..., None]], dim=-1), rng_state


# --- the frame --------------------------------------------------------------

def _restir_step(state: RestirState, camera: Camera, vol: Volume,
                 lights: Lights, *, params: TraceParams, width: int,
                 height: int, n_vertices: int, spatial_kernel: int,
                 temporal_kernel: int, mis_weights: bool = False):
    """The frame's own (H, W, 4) image and the state after it (its image
    and blend index still the old state's)."""
    key, sub = prng.split(state.key)
    frame_rand = rng.frame_random(sub)
    ro, rd, frag_uv = pixel_rays(camera, width, height)
    ro = ro.expand(rd.shape)
    # every stage reseeds from the same per-frame uniform
    seeds = rng.init_state(frag_uv, frame_rand)
    dims = dict(lanes=height * width, V=n_vertices, T=temporal_kernel,
                K=spatial_kernel)

    with profiler.span("restir.local_init", candidates=n_vertices, **dims):
        reservoir, pixel_info, stats, _ = _local_init(
            seeds, vol, lights, ro, rd, state.reservoir, n_vertices)
    # the per-frame RIS accumulators (wsum, w_sel)
    mis = torch.zeros(stats.shape[:-1] + (2,), dtype=torch.float32,
                      device=stats.device)
    with profiler.span("restir.temporal",
                       candidates=temporal_kernel * (n_vertices - 1),
                       **dims):
        reservoir, old_reservoirs, stats, mis, _ = _temporal_reuse(
            seeds, reservoir, state.old_reservoirs, stats, mis, pixel_info,
            state.frame, n_vertices, temporal_kernel, g=vol.g,
            weighted=mis_weights)
    with profiler.span("restir.spatial",
                       candidates=(spatial_kernel ** 2 - 1)
                       * (n_vertices - 1), **dims):
        reservoir, stats, mis, _ = _spatial_reuse(
            seeds, reservoir, stats, mis, pixel_info, n_vertices,
            spatial_kernel, height, width, g=vol.g, weighted=mis_weights)
    with profiler.span("restir.shade", candidates=n_vertices - 1, **dims):
        image, _ = _shade(seeds, vol, lights, params, reservoir, stats,
                          pixel_info, n_vertices, mis=mis)
    return image, dataclasses.replace(
        state, pixel_info=pixel_info, stats=stats, reservoir=reservoir,
        old_reservoirs=old_reservoirs, frame=state.frame + 1, key=key)
