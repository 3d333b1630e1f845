"""Frame renderers: the Monte-Carlo ground truth and the NRC renderer.

Port of ``nrc_hpm_tpu/renderer.py``.

Both trace the pixels in ``trace_chunks`` chunks, one after the other
(``_map_chunks``).

``McRenderer`` traces one ``path_length``-bounce path per pixel per frame
(``trace_fixed`` from the camera, the pixels whose ray misses the box
inactive; the env map where a pixel's path never scatters) and blends the frames into a running mean; the image's
fourth channel is the frame's did-scatter flag.

``NrcRenderer.step`` renders the NRC frame: pixel rays and the RNG init,
the 2-bounce primary trace with direct lighting (``compact``: only the
rays that hit the box), the 5-float NRC queries, cache inference on the
scattered pixels (every pixel without ``infer_filter``), composite and
temporal blend;
then, when training (the default), the train rays of a strided pixel
grid (scattered pixels continue from their NRC query, the others pop a
stored ray from the ring buffer), ``train_spp`` long ``trace_fixed``
paths per ray, the clamped targets, the ring push and
``train_batch_count`` optimizer steps.

Without a ``vol`` both load the configuration's cloud
(``_volume_from_config``) onto ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import profiler
from .camera import Camera, pixel_rays
from .config import AppConfig
from .integrator import (TraceParams, primary_miss_mask, trace_fixed,
                         trace_primary)
from .lights import LightFlags, Lights, lights_from_scene, sample_env_map
from .models.nrc.cache import NeuralRadianceCache, NrcState
from .ring_buffer import RingBuffer, ring_pop, ring_push, ring_wrap
from .sampling import dir_to_spherical_norm
from .utils import prng, rng
from .volume import Volume, sky_uvw


def _volume_from_config(cfg: AppConfig, device="cuda") -> Volume:
    """The cloud of ``cfg.scene``: ``volume_path`` as given, a relative
    path read from the working directory.  The JAX package also tries the
    upstream checkout; the port reads nothing outside the working
    directory."""
    return Volume.from_vdb(cfg.scene.volume_path, cfg.scene.density,
                           cfg.scene.volume_g, device=device)


@dataclasses.dataclass
class McState:
    image: torch.Tensor          # (H, W, 4): rgb and the did-scatter mean
    blend_index: int
    key: torch.Tensor            # threefry key of the per-frame seeds


class McRenderer:
    """Pure Monte-Carlo renderer on ``vol.device``: per pixel one
    ``path_length``-bounce delta-tracked path per frame, blended into a
    running mean (``blend=False`` keeps only the latest frame).  Without
    ``vol`` it loads the configuration's cloud onto ``device``."""

    def __init__(self, cfg: AppConfig, vol: Optional[Volume] = None,
                 lights: Optional[Lights] = None, width: Optional[int] = None,
                 height: Optional[int] = None,
                 path_length: Optional[int] = None, blend: bool = True,
                 device="cuda"):
        self.cfg = cfg
        self.width = width or cfg.render_width
        self.height = height or cfg.render_height
        self.path_length = path_length or cfg.mc_path_length
        self.blend = blend
        self.vol = vol if vol is not None \
            else _volume_from_config(cfg, device)
        self.device = self.vol.device
        self.lights = lights if lights is not None \
            else lights_from_scene(cfg.scene, device=self.device)
        self.params = TraceParams(flags=LightFlags.from_scene(cfg.scene),
                                  max_track_steps=cfg.max_track_steps,
                                  env_fixed16=cfg.env_fixed16)

    def init_state(self, seed: int = 0) -> McState:
        """A black image and the key ``PRNGKey(seed)``."""
        return McState(
            image=torch.zeros((self.height, self.width, 4),
                              dtype=torch.float32, device=self.device),
            blend_index=1, key=prng.prng_key(seed))

    def step(self, state: McState, camera: Camera) -> McState:
        """One frame, its seed drawn from a split of ``state.key``."""
        with profiler.span(profiler.FRAME):
            H, W = self.height, self.width
            n = H * W
            vol, lights = self.vol, self.lights
            key, sub = prng.split(state.key)
            ro, rd, frag_uv = pixel_rays(camera, W, H)
            rng_state = rng.init_state(frag_uv,
                                       rng.frame_random(sub)).reshape(n)

            def mc_chunk(s, o, d):
                res = trace_fixed(s, vol, lights, self.params, o, d,
                                  self.path_length,
                                  active=~primary_miss_mask(vol, o, d),
                                  path="mc")
                return res["did_scatter"], res["radiance"]

            did_scatter, radiance = _map_chunks(
                mc_chunk, self.cfg.trace_chunks, rng_state, ro.expand(n, 3),
                rd.reshape(n, 3))
            did_scatter = did_scatter.reshape(H, W, 1)
            rgb = torch.where(did_scatter, radiance.reshape(H, W, 3),
                              sample_env_map(lights.env, rd))
            out = torch.cat([rgb, did_scatter.to(torch.float32)], dim=-1)
            image, blend_index = _blend(state, out, self.blend)
            return McState(image=image, blend_index=blend_index, key=key)

    def multi_step(self, state: McState, camera: Camera, n: int) -> McState:
        """``n`` accumulation steps."""
        for _ in range(n):
            state = self.step(state, camera)
        return state

    def render(self, camera: Camera, frames: int, seed: int = 0
               ) -> torch.Tensor:
        """Accumulate ``frames`` frames from ``init_state(seed)``; returns
        the (H, W, 4) image."""
        return self.multi_step(self.init_state(seed), camera, frames).image


def _blend(state, out, blend: bool):
    """(image, blend_index): the running mean with weight 1/blend_index,
    or the new frame with the index kept."""
    if not blend:
        return out, state.blend_index
    bf = np.float32(1.0) / np.float32(state.blend_index)
    image = float(bf) * out + float(np.float32(1.0) - bf) * state.image
    return image, state.blend_index + 1


def primary_pass(rng_state, vol, lights, params: TraceParams,
                 cfg: AppConfig, ro, rd):
    """gen_rays: short path + NRC query export for (N, 3) rays.  Returns
    dict with primary_color (N, 4) = (rgb, throughput), did_scatter,
    nrc_pos, nrc_dir."""
    miss = primary_miss_mask(vol, ro, rd)
    res = trace_primary(rng_state, vol, lights, params, ro, rd, cfg,
                        active=~miss)
    did_scatter = res["did_scatter"] & ~miss
    env_color = sample_env_map(lights.env, rd)
    use_env = ~did_scatter
    rgb = torch.where(use_env[..., None], env_color, res["radiance"])
    w = torch.where(use_env, 1.0, res["throughput"])
    return dict(primary_color=torch.cat([rgb, w[..., None]], dim=-1),
                did_scatter=did_scatter, nrc_pos=res["terminal_pos"],
                nrc_dir=res["terminal_dir"])


def _map_chunks(fn, n_chunks: int, *arrays):
    """``fn`` over ``n_chunks`` leading-axis chunks of ``arrays``, one
    after the other, each chunk's trackers scheduled for its own lane
    count; the outputs (a tuple or a dict of tensors) are concatenated.
    A count that does not divide the lanes runs one chunk, as the JAX
    package does."""
    n = arrays[0].shape[0]
    if n_chunks <= 1 or n % n_chunks:
        return fn(*arrays)
    outs = [fn(*part) for part in zip(*(a.split(n // n_chunks)
                                        for a in arrays))]
    if isinstance(outs[0], dict):
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    return tuple(torch.cat(parts) for parts in zip(*outs))


def primary_pass_compact(rng_state, vol, lights, params: TraceParams,
                         cfg: AppConfig, ro, rd, chunks: int = 1):
    """``primary_pass`` that traces only the rays hitting the volume box
    (``torch.nonzero``, then ``trace_primary`` over ``chunks`` chunks of
    them, then a scatter back; the other lanes' queries are zero).  The
    same contract and values, the trackers scheduled for the compacted
    lane count."""
    n = ro.shape[0]
    with profiler.sync("primary_compact"):
        idx = torch.nonzero(~primary_miss_mask(vol, ro, rd)).squeeze(1)

    def trace_hit(s, o, d):
        res = trace_primary(s, vol, lights, params, o, d, cfg)
        return (res["radiance"], res["throughput"], res["did_scatter"],
                res["terminal_pos"], res["terminal_dir"])

    outs = _map_chunks(trace_hit, chunks, rng_state[idx], ro[idx], rd[idx])
    radiance, thr, did_scatter, nrc_pos, nrc_dir = (
        torch.zeros((n,) + o.shape[1:], dtype=o.dtype,
                    device=o.device).index_put((idx,), o) for o in outs)
    use_env = ~did_scatter
    rgb = torch.where(use_env[..., None], sample_env_map(lights.env, rd),
                      radiance)
    w = torch.where(use_env, 1.0, thr)
    return dict(primary_color=torch.cat([rgb, w[..., None]], dim=-1),
                did_scatter=did_scatter, nrc_pos=nrc_pos, nrc_dir=nrc_dir)


def pack_nrc_inputs(vol: Volume, pos, direction) -> torch.Tensor:
    """(pos, dir) -> the 5-float query: box coordinates and the
    normalized (theta, phi)."""
    return torch.cat([sky_uvw(vol, pos), dir_to_spherical_norm(direction)],
                     dim=-1)


def infer_filtered(cache: NeuralRadianceCache, nrc_state: NrcState, x5,
                   scat, infer_filter: bool = True) -> torch.Tensor:
    """Cache inference on the scattered lanes only; other lanes get zero
    (the reference zero-fills its infer buffers and skips empty batches;
    the composite never reads those lanes).  ``infer_filter=False``
    infers every lane."""
    if not infer_filter:
        return cache.infer(nrc_state, x5)
    out = torch.zeros((x5.shape[0], 3), dtype=torch.float32,
                      device=x5.device)
    with profiler.sync(profiler.FILTER_SITE):
        idx = torch.nonzero(scat).squeeze(1)
    if idx.numel():
        out[idx] = cache.infer(nrc_state, x5[idx])
    return out


def composite_frame(prim: dict, nrc_rgb, height: int, width: int):
    """The (height, width, 4) frame: the primary color plus, on scattered
    pixels, the clamped cache prediction ``nrc_rgb`` (None: left out)
    times the throughput; alpha 1."""
    color = prim["primary_color"].reshape(height, width, 4)
    out_rgb = color[..., :3]
    if nrc_rgb is not None:
        use = prim["did_scatter"].reshape(height, width, 1)
        add = torch.clamp(nrc_rgb.reshape(height, width, 3),
                          min=0.0) * color[..., 3:]
        out_rgb = out_rgb + torch.where(use, add, 0.0)
    return torch.cat([out_rgb, torch.ones_like(out_rgb[..., :1])], dim=-1)


@dataclasses.dataclass
class NrcRenderState:
    image: torch.Tensor          # (H, W, 4) blended output
    blend_index: int
    ring: RingBuffer             # self-training (pos, dir) records
    nrc: NrcState
    key: torch.Tensor            # threefry key of the per-frame seeds


class NrcRenderer:
    """The neural-radiance-cache renderer on ``vol.device``; frames blend
    into a running mean (``blend=False`` keeps only the latest frame).
    ``width``/``height`` override the configuration's render size;
    ``show_nrc=False`` leaves the cache's term out of the composite (and
    skips the inference that would feed it).  Without ``vol`` it loads the
    configuration's cloud onto ``device``."""

    def __init__(self, cfg: AppConfig, vol: Optional[Volume] = None,
                 lights: Optional[Lights] = None,
                 width: Optional[int] = None, height: Optional[int] = None,
                 show_nrc: bool = True, blend: bool = True, device="cuda"):
        self.cfg = cfg
        self.width = width or cfg.render_width
        self.height = height or cfg.render_height
        self.show_nrc = show_nrc
        self.blend = blend
        self.vol = vol if vol is not None \
            else _volume_from_config(cfg, device)
        self.device = self.vol.device
        self.lights = lights if lights is not None \
            else lights_from_scene(cfg.scene, device=self.device)
        self.params = TraceParams(flags=LightFlags.from_scene(cfg.scene),
                                  max_track_steps=cfg.max_track_steps,
                                  env_fixed16=cfg.env_fixed16)
        self.primary_params = self.params.primary_params()
        self.cache = NeuralRadianceCache(cfg)
        # the train grid of this renderer's size
        (self.train_w, self.train_h, self.train_x_dist,
         self.train_y_dist) = dataclasses.replace(
            cfg, render_width=self.width,
            render_height=self.height).train_subset()

    def init_state(self, seed: int = 0, nrc: Optional[NrcState] = None
                   ) -> NrcRenderState:
        """Fresh accumulation; the cache is ``nrc`` or a random init from
        ``seed``, through the JAX package's key chain: ``PRNGKey(seed)``,
        split into the state's key and the cache's."""
        key, sub = prng.split(prng.prng_key(seed))
        if nrc is None:
            nrc = self.cache.init_state(sub, self.device)
        return NrcRenderState(
            image=torch.zeros((self.height, self.width, 4),
                              dtype=torch.float32, device=self.device),
            blend_index=1,
            ring=RingBuffer.create(self.cfg.train_ring_size, self.device),
            nrc=nrc, key=key)

    def step(self, state: NrcRenderState, camera: Camera,
             train: bool = True,
             frame_random: Optional[torch.Tensor] = None) -> NrcRenderState:
        """One frame; ``train=False`` renders with a frozen cache.  The
        frame seed is drawn from a split of ``state.key``, as the JAX
        package draws it; ``frame_random`` (4,) overrides it (the key is
        split all the same)."""
        with profiler.span(profiler.FRAME):
            H, W = self.height, self.width
            n = H * W
            vol = self.vol
            key, sub = prng.split(state.key)
            if frame_random is None:
                frame_random = rng.frame_random(sub)
            ro, rd, frag_uv = pixel_rays(camera, W, H)
            rng_state = rng.init_state(frag_uv, frame_random).reshape(n)
            with profiler.span("nrc.primary"):
                prim = self.primary(rng_state, ro.expand(n, 3),
                                    rd.reshape(n, 3))

            nrc_rgb = None
            if self.show_nrc:
                with profiler.span("nrc.pack"):
                    x5 = pack_nrc_inputs(vol, prim["nrc_pos"],
                                         prim["nrc_dir"])
                with profiler.span("nrc.infer"):
                    nrc_rgb = self.infer(state.nrc, x5, prim["did_scatter"])
            with profiler.span("nrc.composite"):
                image, blend_index = self.composite(state, prim, nrc_rgb)

            with profiler.span("nrc.clear"):
                ring = ring_wrap(state.ring)
            nrc = state.nrc
            if train:
                ring, nrc = self.train(state.nrc, ring, prim, frame_random)
            return dataclasses.replace(state, image=image,
                                       blend_index=blend_index, ring=ring,
                                       nrc=nrc, key=key)

    def primary(self, rng_state, ro, rd) -> dict:
        """The primary pass on (N, 3) pixel rays, as the configuration
        asks: compacted to the box-hitting rays (``compact``) and over
        ``trace_chunks`` chunks."""
        cfg = self.cfg
        if cfg.compact:
            return primary_pass_compact(rng_state, self.vol, self.lights,
                                        self.primary_params, cfg, ro, rd,
                                        chunks=cfg.trace_chunks)
        return _map_chunks(
            lambda s, o, d: primary_pass(s, self.vol, self.lights,
                                         self.primary_params, cfg, o, d),
            cfg.trace_chunks, rng_state, ro, rd)

    def infer(self, nrc: NrcState, x5, scat) -> torch.Tensor:
        """``infer_filtered`` under the configuration's ``infer_filter``."""
        return infer_filtered(self.cache, nrc, x5, scat,
                              self.cfg.infer_filter)

    def composite(self, state: NrcRenderState, prim: dict, nrc_rgb):
        """``composite_frame`` blended into ``state.image``.  Returns
        (image, blend_index)."""
        out = composite_frame(prim, nrc_rgb, self.height, self.width)
        return _blend(state, out, self.blend)

    def train_rays(self, ring: RingBuffer, prim: dict):
        """The train grid's rays: scattered pixels continue from their
        NRC query, the others pop a stored ray.  Returns (scat, ro, rd,
        ring)."""
        dev = self.device
        xs = torch.arange(self.train_w, device=dev) * self.train_x_dist
        ys = torch.arange(self.train_h, device=dev) * self.train_y_dist
        pix = (ys[:, None] * self.width + xs[None, :]).reshape(-1)
        scat = prim["did_scatter"][pix]
        popped, ring = ring_pop(ring, ~scat)
        t_ro = torch.where(scat[:, None], prim["nrc_pos"][pix], popped[:, :3])
        t_rd = torch.where(scat[:, None], prim["nrc_dir"][pix], popped[:, 3:])
        t_rd = t_rd / torch.clamp(
            torch.linalg.vector_norm(t_rd, dim=-1, keepdim=True), min=1e-12)
        return scat, t_ro, t_rd, ring

    def train_targets(self, nrc: NrcState, t_ro, t_rd, frame_random):
        """``path_targets`` of the train rays.  The train RNG streams
        start from the screen UVs of the train grid's corner subwindow
        (the reference does the same).  Divisions by a constant multiply
        by its float32 reciprocal, as the compiled JAX frame does (XLA
        rewrites them so), which keeps the seeds' float bits equal."""
        dev = self.device
        tx = torch.arange(self.train_w, dtype=torch.float32,
                          device=dev) * (1.0 / self.width)
        ty = torch.arange(self.train_h, dtype=torch.float32,
                          device=dev) * (1.0 / self.height)
        uv = torch.stack([tx[None, :].expand(self.train_h, -1),
                          ty[:, None].expand(-1, self.train_w)], dim=-1)
        t_state = rng.init_state(uv.reshape(-1, 2), frame_random)
        return path_targets(self.cache, nrc, self.vol, self.lights,
                            self.params, self.cfg, t_state, t_ro, t_rd)

    def train_set(self, nrc: NrcState, ring: RingBuffer, prim: dict,
                  frame_random) -> tuple:
        """Train rays, their targets and the ring push.  Returns (ring,
        train_x5, target)."""
        scat, t_ro, t_rd, ring = self.train_rays(ring, prim)
        target = self.train_targets(nrc, t_ro, t_rd, frame_random)
        ring = ring_push(ring, scat, torch.cat([t_ro, t_rd], dim=-1))
        return ring, pack_nrc_inputs(self.vol, t_ro, t_rd), target

    def train(self, nrc: NrcState, ring: RingBuffer, prim: dict,
              frame_random) -> tuple:
        """The train set and the frame's optimizer steps.  Returns (ring,
        nrc)."""
        with profiler.span("nrc.train_set"):
            ring, train_x5, target = self.train_set(nrc, ring, prim,
                                                    frame_random)
        with profiler.span("nrc.train_frame"):
            return ring, self.cache.train_frame(nrc, train_x5, target)


def path_targets(cache: NeuralRadianceCache, nrc: NrcState, vol: Volume,
                 lights: Lights, params: TraceParams, cfg: AppConfig,
                 t_state, t_ro, t_rd) -> torch.Tensor:
    """``train_spp`` trace_fixed paths per train ray from the RNG states
    ``t_state``, averaged and clamped to ``train_target_clamp``."""
    target = torch.zeros_like(t_ro)
    for _ in range(cfg.train_spp):
        res = trace_fixed(t_state, vol, lights, params, t_ro, t_rd,
                          cfg.train_ray_length)
        spp_rad = res["radiance"]
        if cfg.train_cache_bootstrap:
            # surviving paths end in the pre-train cache, scaled by their
            # throughput
            boot_x5 = pack_nrc_inputs(vol, res["terminal_pos"],
                                      res["terminal_dir"])
            boot = torch.clamp(cache.infer(nrc, boot_x5), min=0.0)
            spp_rad = spp_rad + torch.where(
                res["alive"][:, None], boot * res["throughput"][:, None],
                0.0)
        target = target + spp_rad
        t_state = res["state"]
    target = target * (1.0 / cfg.train_spp)
    return torch.clamp(target, max=cfg.train_target_clamp)


def reset_accumulation(state):
    """A camera change clears the temporal accumulation (an ``McState``,
    an ``NrcRenderState`` or a ``RestirState``, whose temporal-reuse ring
    and frame counter restart too)."""
    from .models.restir import RestirState
    state = dataclasses.replace(state, image=torch.zeros_like(state.image),
                                blend_index=1)
    if isinstance(state, RestirState):
        state = dataclasses.replace(
            state, old_reservoirs=torch.zeros_like(state.old_reservoirs),
            frame=0)
    return state
