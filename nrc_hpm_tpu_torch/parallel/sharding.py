"""Sharded NRC rendering: image rows split over the ranks of a
``torch.distributed`` process group, the cache replicated.

Port of ``nrc_hpm_tpu/parallel/sharding.py``, where one jitted program
runs over a 1-D device mesh (``shard_map``); here each rank is a process
that drives one device and runs its own shard of the frame, and a
process group takes the mesh's place (``make_group``: NCCL on the card,
gloo on the CPU).  What each rank computes is the JAX shard's:

- Rows: the image is padded to a multiple of the group's size; rank r
  renders the ``local_h`` rows from ``r * local_h``, the padding rows
  tracing harmless out-of-frame rays (v >= 1) that ``final_image`` crops.
- Training: global batch b of the train grid is split into ``_bs_l``
  lanes per rank, rank r taking the sub-range from ``r * _bs_l``; where
  the batch does not divide the group's size, the overhang lanes repeat
  the batch's last pixel at weight 0.  Each rank re-traces its own train
  pixels' primaries from their global screen coordinates (the RNG
  streams are functions of the pixel UV and the frame seed), so no rank
  needs another's pixels.
- Each rank keeps its own ring buffer of ``max(ring_size // n, 1)``
  records.  The cache parameters, the optimizer state and the key are
  replicated: ``cache.train_frame(group=)`` all-reduces the gradients and
  the loss, so every rank applies the same update bit for bit.

The collectives are ``train_frame``'s all-reduces and ``final_image``'s
all-gather; every rank must make each call.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..camera import Camera, rays_for_uv
from ..config import AppConfig
from ..integrator import TraceParams
from ..lights import LightFlags, Lights, lights_from_scene
from ..models.nrc.cache import NeuralRadianceCache
from ..renderer import (NrcRenderState, _blend, _volume_from_config,
                        composite_frame, infer_filtered, pack_nrc_inputs,
                        path_targets, primary_pass, primary_pass_compact)
from ..ring_buffer import RingBuffer, ring_pop, ring_push, ring_wrap
from ..utils import prng, rng
from ..volume import Volume

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _check_cards(ranks: int) -> None:
    """NCCL takes one rank per card: refuse more ranks than cards."""
    cards = torch.cuda.device_count()
    if ranks > cards:
        raise RuntimeError(
            f"{ranks} NCCL ranks on this host but {cards} CUDA device(s): "
            "NCCL takes one rank per card")


def make_group(n: Optional[int] = None, device="cuda"):
    """The process group of ``n`` ranks (None: the group there is) that
    the sharded renderer runs over; the counterpart of ``make_mesh``.

    - The default group where ``torch.distributed`` is initialized (its
      size must be ``n``);
    - else one initialized from the ``torchrun`` environment (``RANK``,
      ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), each rank on
      ``cuda:LOCAL_RANK``;
    - else, for one rank, a group of that one process over an in-process
      store.

    Any other ``n`` raises, naming the ``torchrun`` command that starts
    the ranks.  The backend is NCCL for a CUDA ``device`` and gloo for
    the CPU; NCCL never gets more ranks on a host than it has cards."""
    on_cuda = torch.device(device).type == "cuda"
    backend = "nccl" if on_cuda else "gloo"
    if dist.is_initialized():
        size = dist.get_world_size()
        if n is not None and n != size:
            raise ValueError(f"make_group({n}): the initialized process "
                             f"group has {size} ranks")
        return dist.group.WORLD
    env = os.environ
    if all(k in env for k in _TORCHRUN_ENV):
        size = int(env["WORLD_SIZE"])
        if n is not None and n != size:
            raise ValueError(f"make_group({n}): torchrun started "
                             f"{size} ranks")
        if on_cuda:
            _check_cards(int(env.get("LOCAL_WORLD_SIZE", size)))
            torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
        return dist.group.WORLD
    if n is None or n == 1:
        if on_cuda:
            _check_cards(1)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        return dist.group.WORLD
    raise RuntimeError(
        f"make_group({n}): no process group of {n} ranks; start one "
        f"process per rank, e.g. `torchrun --nproc-per-node {n} -m "
        f"nrc_hpm_tpu_torch.app --mesh {n}`")


def rank_device(device) -> torch.device:
    """``cuda`` without an index is the rank's card, ``cuda:LOCAL_RANK``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


class ShardedNrcRenderer:
    """The NRC renderer of one rank of ``group`` (without one,
    ``make_group(cfg.mesh.rays, device)``): its ``local_h`` image rows and
    its slice of every train batch.  Without ``vol`` it loads the
    configuration's cloud onto ``device`` (``cuda``: ``cuda:LOCAL_RANK``).
    ``show_nrc`` and ``blend`` are ``NrcRenderer``'s."""

    def __init__(self, cfg: AppConfig, group=None,
                 vol: Optional[Volume] = None,
                 lights: Optional[Lights] = None, show_nrc: bool = True,
                 blend: bool = True, device="cuda"):
        self.cfg = cfg
        device = vol.device if vol is not None else rank_device(device)
        self.group = group if group is not None \
            else make_group(cfg.mesh.rays, device)
        self.n = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.width = cfg.render_width
        self.height = cfg.render_height
        self.pad_h = -(-self.height // self.n) * self.n
        self.local_h = self.pad_h // self.n
        self.row0 = self.rank * self.local_h
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
        self.show_nrc = show_nrc
        self.blend = blend
        (self.train_w, self.train_h, self.train_x_dist,
         self.train_y_dist) = cfg.train_subset()
        # global batch _bs_g splits into _bs_l lanes per rank; the
        # overhang lanes train at weight 0
        self._bs_g = self.train_w * self.train_h // cfg.train_batch_count
        self._bs_l = -(-self._bs_g // self.n)
        self._padded_train = self._bs_g % self.n != 0
        self.local_train = self._bs_l * cfg.train_batch_count

    def init_state(self, seed: int = 0) -> NrcRenderState:
        """This rank's black rows and ring, the replicated cache and key:
        ``PRNGKey(seed)`` split into the state's key and the cache's, as
        ``NrcRenderer.init_state`` splits it."""
        key, sub = prng.split(prng.prng_key(seed))
        return NrcRenderState(
            image=torch.zeros((self.local_h, self.width, 4),
                              dtype=torch.float32, device=self.device),
            blend_index=1,
            ring=RingBuffer.create(
                max(self.cfg.train_ring_size // self.n, 1), self.device),
            nrc=self.cache.init_state(sub, self.device), key=key)

    def step(self, state: NrcRenderState, camera: Camera,
             train: bool = True) -> NrcRenderState:
        """One frame of this rank's shard; ``train=False`` renders with a
        frozen cache.  Every rank must step together (training
        all-reduces)."""
        cfg = self.cfg
        W = self.width
        n_local = self.local_h * W
        key, sub = prng.split(state.key)
        # the replicated frame seed: every rank draws the same stream, so
        # the train re-trace reproduces the primaries of other ranks' rows
        frame_rand = rng.frame_random(sub)
        x = torch.arange(W, dtype=torch.float32,
                         device=self.device) * (1.0 / W)
        y = (torch.arange(self.local_h, dtype=torch.float32,
                          device=self.device) + self.row0) \
            * (1.0 / self.height)
        vv, uu = torch.meshgrid(y, x, indexing="ij")
        frag_uv = torch.stack([uu, vv], dim=-1)
        rd = rays_for_uv(camera, frag_uv).reshape(n_local, 3)
        ro = camera.pos.expand(n_local, 3)
        rng_state = rng.init_state(frag_uv, frame_rand).reshape(n_local)
        if cfg.compact:
            prim = primary_pass_compact(rng_state, self.vol, self.lights,
                                        self.primary_params, cfg, ro, rd,
                                        chunks=cfg.trace_chunks)
        else:
            prim = primary_pass(rng_state, self.vol, self.lights,
                                self.primary_params, cfg, ro, rd)
        nrc_rgb = None
        if self.show_nrc:
            x5 = pack_nrc_inputs(self.vol, prim["nrc_pos"], prim["nrc_dir"])
            nrc_rgb = infer_filtered(self.cache, state.nrc, x5,
                                     prim["did_scatter"], cfg.infer_filter)
        out = composite_frame(prim, nrc_rgb, self.local_h, W)
        image, blend_index = _blend(state, out, self.blend)

        ring = ring_wrap(state.ring)
        nrc = state.nrc
        if train:
            ring, nrc = self._train(nrc, ring, camera, frame_rand)
        return dataclasses.replace(state, image=image,
                                   blend_index=blend_index, ring=ring,
                                   nrc=nrc, key=key)

    def _train(self, nrc, ring: RingBuffer, camera: Camera, frame_rand):
        """This rank's slice of the train grid: re-traced primaries, ring
        pop, train paths, ring push and the all-reduced optimizer steps.
        Local batch b holds the rank's sub-range of global batch b, so the
        summed gradient is the single-device batch's, reassociated.
        Returns (ring, nrc)."""
        cfg = self.cfg
        W, H = self.width, self.height
        bs_g, bs_l = self._bs_g, self._bs_l
        j = torch.arange(self.local_train, device=self.device)
        pos_in_batch = self.rank * bs_l + j % bs_l
        valid = pos_in_batch < bs_g
        lin = (j // bs_l) * bs_g + torch.clamp(pos_in_batch, max=bs_g - 1)
        tyg, txg = lin // self.train_w, lin % self.train_w
        px, py = txg * self.train_x_dist, tyg * self.train_y_dist
        # the pixels' primaries again, from their global UVs (divisions by
        # a constant as XLA compiles them: times the float32 reciprocal)
        t_uv = torch.stack([px.float() * (1.0 / W), py.float() * (1.0 / H)],
                           dim=-1)
        t_rd = rays_for_uv(camera, t_uv)
        tprim = primary_pass(rng.init_state(t_uv, frame_rand), self.vol,
                             self.lights, self.primary_params, cfg,
                             camera.pos.expand_as(t_rd), t_rd)
        scat = tprim["did_scatter"]
        popped, ring = ring_pop(ring, ~scat & valid)
        r_ro = torch.where(scat[:, None], tprim["nrc_pos"], popped[:, :3])
        r_rd = torch.where(scat[:, None], tprim["nrc_dir"], popped[:, 3:])
        r_rd = r_rd / torch.clamp(
            torch.linalg.vector_norm(r_rd, dim=-1, keepdim=True), min=1e-12)
        # train-path RNG: the train grid's corner-subwindow UVs
        s_uv = torch.stack([txg.float() * (1.0 / W),
                            tyg.float() * (1.0 / H)], dim=-1)
        target = path_targets(self.cache, nrc, self.vol, self.lights,
                              self.params, cfg,
                              rng.init_state(s_uv, frame_rand), r_ro, r_rd)
        ring = ring_push(ring, scat & valid, torch.cat([r_ro, r_rd], dim=-1))
        weight = valid.float() if self._padded_train else None
        nrc = self.cache.train_frame(nrc, pack_nrc_inputs(self.vol, r_ro,
                                                          r_rd),
                                     target, group=self.group, weight=weight)
        return ring, nrc

    def final_image(self, state: NrcRenderState) -> torch.Tensor:
        """The displayable (height, width, 4) image: every rank's rows
        gathered, the padding rows cropped.  A collective: every rank
        calls it and receives the whole image."""
        rows = [torch.empty_like(state.image) for _ in range(self.n)]
        dist.all_gather(rows, state.image.contiguous(), group=self.group)
        return torch.cat(rows)[:self.height]
