"""Frame renderers: the Monte-Carlo ground truth and the NRC renderer.

Port of ``nrc_hpm_tpu/renderer.py``.

``McRenderer`` traces one ``path_length``-bounce path per pixel per frame
(``trace_fixed`` from the camera, the pixels whose ray misses the box
inactive; the env map where a pixel's path never scatters) and blends the frames into a running mean; the image's
fourth channel is the frame's did-scatter flag.

``NrcRenderer.step`` renders the NRC frame: pixel rays and the RNG init,
the 2-bounce primary trace with direct lighting, the 5-float NRC queries,
cache inference on the scattered pixels, composite and temporal blend;
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
        H, W = self.height, self.width
        n = H * W
        vol, lights = self.vol, self.lights
        key, sub = prng.split(state.key)
        ro, rd, frag_uv = pixel_rays(camera, W, H)
        rng_state = rng.init_state(frag_uv, rng.frame_random(sub)).reshape(n)

        o, d = ro.expand(n, 3), rd.reshape(n, 3)
        res = trace_fixed(rng_state, vol, lights, self.params, o, d,
                          self.path_length,
                          active=~primary_miss_mask(vol, o, d))
        did_scatter = res["did_scatter"].reshape(H, W, 1)
        rgb = torch.where(did_scatter, res["radiance"].reshape(H, W, 3),
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


def pack_nrc_inputs(vol: Volume, pos, direction) -> torch.Tensor:
    """(pos, dir) -> the 5-float query: box coordinates and the
    normalized (theta, phi)."""
    return torch.cat([sky_uvw(vol, pos), dir_to_spherical_norm(direction)],
                     dim=-1)


def infer_filtered(cache: NeuralRadianceCache, nrc_state: NrcState, x5,
                   scat) -> torch.Tensor:
    """Cache inference on the scattered lanes only; other lanes get zero
    (the reference zero-fills its infer buffers and skips empty batches;
    the composite never reads those lanes)."""
    out = torch.zeros((x5.shape[0], 3), dtype=torch.float32,
                      device=x5.device)
    idx = torch.nonzero(scat).squeeze(1)
    if idx.numel():
        out[idx] = cache.infer(nrc_state, x5[idx])
    return out


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
        H, W = self.height, self.width
        n = H * W
        vol = self.vol
        key, sub = prng.split(state.key)
        if frame_random is None:
            frame_random = rng.frame_random(sub)
        ro, rd, frag_uv = pixel_rays(camera, W, H)
        rng_state = rng.init_state(frag_uv, frame_random).reshape(n)
        prim = primary_pass(rng_state, vol, self.lights, self.primary_params,
                            self.cfg, ro.expand(n, 3), rd.reshape(n, 3))

        nrc_rgb = None
        if self.show_nrc:
            x5 = pack_nrc_inputs(vol, prim["nrc_pos"], prim["nrc_dir"])
            nrc_rgb = infer_filtered(self.cache, state.nrc, x5,
                                     prim["did_scatter"])
        image, blend_index = self.composite(state, prim, nrc_rgb)

        ring = ring_wrap(state.ring)
        nrc = state.nrc
        if train:
            ring, nrc = self.train(state.nrc, ring, prim, frame_random)
        return dataclasses.replace(state, image=image,
                                   blend_index=blend_index, ring=ring,
                                   nrc=nrc, key=key)

    def composite(self, state: NrcRenderState, prim: dict, nrc_rgb):
        """The primary color plus, on scattered pixels, the clamped cache
        prediction ``nrc_rgb`` (None: left out) times the throughput,
        blended into ``state.image``.  Returns (image, blend_index)."""
        H, W = self.height, self.width
        color = prim["primary_color"].reshape(H, W, 4)
        out_rgb = color[..., :3]
        if nrc_rgb is not None:
            use = prim["did_scatter"].reshape(H, W, 1)
            add = torch.clamp(nrc_rgb.reshape(H, W, 3),
                              min=0.0) * color[..., 3:]
            out_rgb = out_rgb + torch.where(use, add, 0.0)
        out = torch.cat([out_rgb, torch.ones_like(out_rgb[..., :1])], dim=-1)
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
        """``train_spp`` trace_fixed paths per train ray, averaged and
        clamped.  The train RNG streams start from the screen UVs of the
        train grid's corner subwindow (the reference does the same).
        Divisions by a constant multiply by its float32 reciprocal, as the
        compiled JAX frame does (XLA rewrites them so), which keeps the
        seeds' float bits equal."""
        cfg = self.cfg
        dev = self.device
        tx = torch.arange(self.train_w, dtype=torch.float32,
                          device=dev) * (1.0 / self.width)
        ty = torch.arange(self.train_h, dtype=torch.float32,
                          device=dev) * (1.0 / self.height)
        uv = torch.stack([tx[None, :].expand(self.train_h, -1),
                          ty[:, None].expand(-1, self.train_w)], dim=-1)
        t_state = rng.init_state(uv.reshape(-1, 2), frame_random)
        target = torch.zeros_like(t_ro)
        for _ in range(cfg.train_spp):
            res = trace_fixed(t_state, self.vol, self.lights, self.params,
                              t_ro, t_rd, cfg.train_ray_length)
            spp_rad = res["radiance"]
            if cfg.train_cache_bootstrap:
                # surviving paths end in the pre-train cache, scaled by
                # their throughput
                boot_x5 = pack_nrc_inputs(self.vol, res["terminal_pos"],
                                          res["terminal_dir"])
                boot = torch.clamp(self.cache.infer(nrc, boot_x5), min=0.0)
                spp_rad = spp_rad + torch.where(
                    res["alive"][:, None], boot * res["throughput"][:, None],
                    0.0)
            target = target + spp_rad
            t_state = res["state"]
        target = target * (1.0 / cfg.train_spp)
        return torch.clamp(target, max=cfg.train_target_clamp)

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
        ring, train_x5, target = self.train_set(nrc, ring, prim,
                                                frame_random)
        return ring, self.cache.train_frame(nrc, train_x5, target)


def reset_accumulation(state):
    """A camera change clears the temporal accumulation (an ``McState``
    or an ``NrcRenderState``)."""
    return dataclasses.replace(state, image=torch.zeros_like(state.image),
                               blend_index=1)
