"""Golden-image comparator and golden generation.

Port of ``nrc_hpm_tpu/reference.py``.  ``compare_images`` is the
reference's three-pass GPU reduction (cmp1 -> norm -> cmp2) as one torch
reduction on the image's device: over the pixels whose golden alpha is
nonzero, the mean squared error (channelwise, averaged over RGB), the
golden's and the image's mean RGB, and the image's variance about its own
mean.  Derived metrics: bias = own - ref mean, relBias = bias / ref mean,
relVar = var / ref mean, CV = sqrt(var) / own mean.

``generate_golden`` accumulates ``frames`` frames of ``path_length``-bounce
MC at the fixed reference camera into an EXR, with a resume sidecar
``<out>.progress.json`` (frames done, seed, path length, size and the
post-frame key as two uint32 words) in the JAX package's format, so a run
started by either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .camera import Camera
from .renderer import McRenderer, reset_accumulation
from .utils.exr import read_exr_rgba, write_exr


@dataclasses.dataclass
class CompareResult:
    mse: float
    ref_mean: float
    own_mean: float
    own_var: float
    valid_pixel_count: float

    @property
    def bias(self):
        return self.own_mean - self.ref_mean

    @property
    def rel_bias(self):
        return self.bias / self.ref_mean

    @property
    def rel_var(self):
        return self.own_var / self.ref_mean

    @property
    def cv(self):
        return float(np.sqrt(self.own_var) / self.own_mean)


def _image_tensor(img, device=None) -> torch.Tensor:
    """A float32 tensor of ``img`` on ``device`` (a tensor's own device
    when None, else the CPU)."""
    if torch.is_tensor(img):
        return img.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(img, np.float32), device=device)


def compare_images(ref, own) -> CompareResult:
    """Compare (H, W, 4) images (tensors or arrays), on ``own``'s device
    when it is a tensor; pixels with ref alpha == 0 are excluded."""
    own = _image_tensor(own)
    ref = _image_tensor(ref, own.device)
    valid = ref[..., 3] != 0.0
    count = valid.sum()
    se = ((own[..., :3] - ref[..., :3]) ** 2).mean(dim=-1)
    ref_px = ref[..., :3].mean(dim=-1)
    own_px = own[..., :3].mean(dim=-1)
    mse = torch.where(valid, se, 0.0).sum() / count
    ref_mean = torch.where(valid, ref_px, 0.0).sum() / count
    own_mean = torch.where(valid, own_px, 0.0).sum() / count
    var_px = ((own[..., :3] - own_mean) ** 2).mean(dim=-1)
    own_var = torch.where(valid, var_px, 0.0).sum() / count
    return CompareResult(float(mse), float(ref_mean), float(own_mean),
                         float(own_var), float(count))


class GoldenReference:
    """A golden image and the fixed reference camera (on ``device``);
    compares renderer frames against the golden as the reference's
    CompareNrc / CompareMc do."""

    def __init__(self, image, camera=None, device="cuda"):
        self.image = np.asarray(image, np.float32)
        h, w = self.image.shape[:2]
        self.camera = camera or Camera.reference_camera(aspect=w / h,
                                                        device=device)

    @staticmethod
    def load(scene_id: int, search_paths=("reference",),
             names=("0.exr", "low.exr"), device="cuda"):
        """The first ``<path>/<scene_id>/<name>`` that exists, names in
        order, each through the paths in order (relative paths from the
        working directory).  The JAX package also searches the upstream
        checkout's reference directory; pass it in ``search_paths``."""
        for name in names:
            for base in search_paths:
                p = os.path.join(base, str(scene_id), name)
                if os.path.exists(p):
                    return GoldenReference(read_exr_rgba(p), device=device)
        raise FileNotFoundError(
            f"no golden image for scene {scene_id} in {search_paths}")

    def compare(self, own_image, clip: float | None = None) -> CompareResult:
        """Compare ``own_image`` against the golden.  Where the sizes
        differ the larger image is average-pooled to the smaller one;
        ``clip`` clamps both images' RGB to that radiance first."""
        own = _image_tensor(own_image)
        ref = self.image
        if tuple(own.shape[:2]) != ref.shape[:2]:
            if own.shape[0] * own.shape[1] < ref.shape[0] * ref.shape[1]:
                ref = _downsample(ref, tuple(own.shape[:2]))
            else:
                own = torch.as_tensor(
                    _downsample(own.cpu().numpy(), ref.shape[:2]),
                    device=own.device)
        ref = _image_tensor(ref, own.device)
        if clip is not None:
            ref = torch.cat([torch.clamp(ref[..., :3], max=clip),
                             ref[..., 3:]], dim=-1)
            own = torch.cat([torch.clamp(own[..., :3], max=clip),
                             own[..., 3:]], dim=-1)
        return compare_images(ref, own)

    # The reference re-cameras the renderer (clearing its accumulation),
    # renders ONE fresh frame (training off), compares it and restores the
    # old camera.  Here the caller's state is never written: the frame
    # starts from a reset copy.

    def compare_nrc(self, renderer, state) -> CompareResult:
        tmp = renderer.step(reset_accumulation(state), self.camera,
                            train=False)
        return self.compare(_renderer_image(renderer, tmp))

    def compare_mc(self, renderer, state) -> CompareResult:
        tmp = renderer.step(reset_accumulation(state), self.camera)
        return self.compare(_renderer_image(renderer, tmp))


def _renderer_image(renderer, state) -> torch.Tensor:
    """A renderer's displayable frame (a renderer with ``final_image``
    crops its padding)."""
    fin = getattr(renderer, "final_image", None)
    return fin(state) if fin is not None else state.image


def _downsample(img: np.ndarray, hw) -> np.ndarray:
    """Average-pool (H, W, C) to ``hw``: rows, then columns, of the
    integer-split blocks."""
    h, w = hw
    H, W = img.shape[:2]
    ys = (np.arange(h + 1) * H // h)
    xs = (np.arange(w + 1) * W // w)
    out = np.zeros((h, w, img.shape[2]), np.float32)
    for i in range(h):
        rows = img[ys[i]:ys[i + 1]]
        csum = rows.mean(axis=0)
        for j in range(w):
            out[i, j] = csum[xs[j]:xs[j + 1]].mean(axis=0)
    return out


def generate_golden(cfg, out_path: str, vol, frames: int = 8192,
                    path_length: int = 64, width=None, height=None,
                    seed: int = 0, progress_every: int = 0,
                    resume: bool = False, save_every: int = 0
                    ) -> np.ndarray:
    """Accumulate ``frames`` frames of ``path_length``-bounce MC on ``vol``
    at the fixed reference camera and write the running mean to
    ``out_path`` (EXR) with its sidecar; returns the (H, W, 4) image.

    ``resume`` continues from ``out_path`` and its sidecar when their
    seed, path length and size match: the stored image is the exact
    float32 running mean and the sidecar holds the post-frame key, so the
    resumed run equals the single run bit for bit.  ``save_every`` writes
    both every that many frames; ``progress_every`` prints the count."""
    cfg = dataclasses.replace(
        cfg, render_width=width or cfg.render_width,
        render_height=height or cfg.render_height)
    r = McRenderer(cfg, vol, path_length=path_length, blend=True)
    cam = Camera.reference_camera(
        aspect=cfg.render_width / cfg.render_height, device=r.device)
    state = r.init_state(seed)
    i = 0
    side = out_path + ".progress.json"
    if resume and os.path.exists(out_path) and os.path.exists(side):
        with open(side) as f:
            meta = json.load(f)
        if (meta.get("seed") == seed
                and meta.get("path_length") == path_length
                and meta.get("width") == cfg.render_width
                and meta.get("height") == cfg.render_height
                and "key" in meta):
            i = int(meta["frames_done"])
            state = dataclasses.replace(
                state,
                image=torch.as_tensor(read_exr_rgba(out_path),
                                      device=r.device),
                blend_index=i + 1,
                key=torch.tensor(meta["key"], dtype=torch.int64))
            print(f"golden resume: {i} frames from {out_path}", flush=True)

    def save(img, done, key):
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        write_exr(out_path, img)
        with open(side, "w") as f:
            json.dump(dict(frames_done=done, seed=seed,
                           path_length=path_length,
                           width=cfg.render_width,
                           height=cfg.render_height,
                           key=key.tolist()), f)

    next_report = i + progress_every
    next_save = i + save_every if save_every else frames
    while i < frames:
        state = r.step(state, cam)
        i += 1
        if progress_every and i >= next_report:
            print(f"golden frame {i}/{frames}", flush=True)
            next_report += progress_every
        if save_every and i >= next_save and i < frames:
            save(state.image.cpu().numpy(), i, state.key)
            next_save += save_every
    img = state.image.cpu().numpy()
    save(img, i, state.key)
    return img
