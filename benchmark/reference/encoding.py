"""NRC input encodings: multiresolution hash grid, OneBlob, Identity,
TriangleWave and Frequency.

Port of ``nrc_hpm_tpu/models/nrc/encoding.py`` (Instant-NGP /
tiny-cuda-nn conventions): level scale ``base * 2^(l log2 s) - 1``,
resolution ``ceil(scale) + 1``; a level is DENSE (clamped linear index)
when res^3 fits the table, else corners hash with primes (1, 2654435761,
805459861) modulo the level's table size; trilinear interpolation at
``pos * scale + 0.5``.  Inference reads the bf16-packed table (two
features per 32-bit word).  Training encodes through kernel K7
(``ops/hash_grid_train.py``): from the packed table for grids of <= 2^16
entries per level (``hash_grid_encode_train``), else from the float32
table (``hash_grid_encode``); the gradient reaches the table only.  The
other encodings have no parameters and are plain tensor functions.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import prng, rng
from .config import EncodingConfig

PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    n_levels: int = 16
    n_features: int = 2
    log2_table_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 2.0
    n_dims: int = 3

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    def level_scale(self, level: int) -> float:
        return (math.exp2(level * math.log2(self.per_level_scale))
                * self.base_resolution - 1.0)

    def level_resolution(self, level: int) -> int:
        return int(math.ceil(self.level_scale(level))) + 1

    def level_params(self, level: int) -> int:
        res = self.level_resolution(level)
        n = min(res ** self.n_dims, self.table_size)
        return (n + 7) // 8 * 8  # tcnn rounds up to a multiple of 8

    def level_is_dense(self, level: int) -> bool:
        return self.level_resolution(level) ** self.n_dims <= self.table_size

    @property
    def level_offsets(self) -> tuple:
        offs, total = [], 0
        for lv in range(self.n_levels):
            offs.append(total)
            total += self.level_params(lv)
        return tuple(offs + [total])

    @property
    def total_params(self) -> int:
        return self.level_offsets[-1]

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


def init_hash_grid(key: torch.Tensor, spec: HashGridSpec, device="cuda"
                   ) -> torch.Tensor:
    """tcnn's init: features uniform in [-1e-4, 1e-4], drawn from the
    threefry ``key`` on ``device`` as the JAX package draws them."""
    return prng.uniform(key, (spec.total_params, spec.n_features), -1e-4,
                        1e-4, device)


def pack_table_bf16(table: torch.Tensor) -> torch.Tensor:
    """(P, 2) float32 -> (P,) int32 words bf16(f0) << 16 | bf16(f1)."""
    b = table.to(torch.bfloat16).contiguous().view(torch.int16).to(
        torch.int64) & 0xFFFF
    return rng.u32_to_i32((b[:, 0] << 16) | b[:, 1])


def _corner_indices(x: torch.Tensor, spec: HashGridSpec):
    """(N, 3) positions -> (idx (N, L, 8) int64 table rows, weight (N, L, 8)).
    Corner c has offset bits (c >> 2, c >> 1, c) & 1 per dim."""
    L = spec.n_levels
    dev = x.device
    scale = torch.tensor([spec.level_scale(lv) for lv in range(L)],
                         dtype=torch.float32, device=dev)
    res = torch.tensor([spec.level_resolution(lv) for lv in range(L)],
                       dtype=torch.int64, device=dev)
    dense = torch.tensor([spec.level_is_dense(lv) for lv in range(L)],
                         device=dev)
    params = torch.tensor([spec.level_params(lv) for lv in range(L)],
                          dtype=torch.int64, device=dev)
    offs = torch.tensor(spec.level_offsets[:-1], dtype=torch.int64,
                        device=dev)
    bits = torch.tensor([[(c >> (2 - d)) & 1 for d in range(3)]
                         for c in range(8)], dtype=torch.int64, device=dev)

    weight = lin = hsh = None
    stride = torch.ones_like(res)
    for d in range(spec.n_dims):
        xs = x[:, d:d + 1] * scale + 0.5                   # (N, L)
        x0 = torch.floor(xs)
        w = (xs - x0)[..., None]                           # (N, L, 1)
        cd = x0.to(torch.int64)[..., None] + bits[:, d]    # (N, L, 8)
        wd = torch.where(bits[:, d].bool(), w, 1.0 - w)
        weight = wd if weight is None else weight * wd
        cc = torch.minimum(torch.clamp(cd, min=0), (res - 1)[:, None])
        lin = cc * stride[:, None] if lin is None \
            else lin + cc * stride[:, None]
        stride = stride * res
        # signed corner * prime keeps the two's-complement low 32 bits
        h = (cd * PRIMES[d]) & rng.M32
        hsh = h if hsh is None else hsh ^ h
    idx = torch.where(dense[:, None], lin, hsh % params[:, None])
    return idx + offs[:, None], weight


def hash_grid_encode_packed(packed: torch.Tensor, x: torch.Tensor,
                            spec: HashGridSpec) -> torch.Tensor:
    """(N, 3) positions -> (N, L*2) features from a pack_table_bf16 table,
    interleaved (level, feature)."""
    idx, weight = _corner_indices(x, spec)
    g = packed.to(torch.int64)[idx] & rng.M32              # (N, L, 8)
    f0 = (rng.u32_to_f32(g & 0xFFFF0000) * weight).sum(-1)
    f1 = (rng.u32_to_f32(g << 16) * weight).sum(-1)
    return torch.stack([f0, f1], dim=-1).reshape(x.shape[0], -1)


def hash_grid_encode(table: torch.Tensor, x: torch.Tensor,
                     spec: HashGridSpec) -> torch.Tensor:
    """(N, 3) positions -> (N, L*2) features from the (P, 2) float32
    table, differentiable in the table."""
    return HashGridTrainEncode.apply(table, x, spec, False)


def hash_grid_encode_train(table: torch.Tensor, x: torch.Tensor,
                           spec: HashGridSpec) -> torch.Tensor:
    """hash_grid_encode from the bf16-packed copy of the table (features
    rounded like tcnn's half-precision parameters); each table-gradient
    term is rounded to bf16 and summed in float32."""
    return HashGridTrainEncode.apply(table, x, spec, True)


def hash_grid_train_fwd(table, x, spec: HashGridSpec, packed: bool
                        ) -> torch.Tensor:
    """(N, 3) positions -> (N, L*2) features, interleaved (level,
    feature), from the packed (P,) words or the (P, 2) float32 table."""
    if packed:
        return hash_grid_encode_packed(table, x, spec)
    idx, weight = _corner_indices(x, spec)                 # (N, L, 8)
    feats = (table[idx] * weight[..., None]).sum(2)        # (N, L, 2)
    return feats.reshape(x.shape[0], -1)


def hash_grid_train_bwd(x, gout, spec: HashGridSpec, packed: bool
                        ) -> torch.Tensor:
    """(P, 2) float32 table gradient: dtable[idx] += w * g over every
    corner lookup, each term rounded to bf16 when ``packed``."""
    idx, weight = _corner_indices(x, spec)
    n, L = idx.shape[:2]
    v = weight[..., None] * gout.reshape(n, L, 1, 2)       # (N, L, 8, 2)
    if packed:
        v = v.to(torch.bfloat16).to(torch.float32)
    dtable = torch.zeros((spec.total_params, 2), dtype=torch.float32,
                         device=x.device)
    return dtable.index_add_(0, idx.reshape(-1), v.reshape(-1, 2))


class HashGridTrainEncode(torch.autograd.Function):
    """features = encode(table, x); the gradient flows to the float32
    (P, 2) ``table`` only.  ``packed`` encodes from the bf16-packed copy
    of the table and rounds each gradient term to bf16."""

    @staticmethod
    def forward(ctx, table, x, spec: HashGridSpec, packed: bool):
        ctx.save_for_backward(x)
        ctx.spec, ctx.packed = spec, packed
        src = pack_table_bf16(table) if packed else table
        return hash_grid_train_fwd(src, x, spec, packed)

    @staticmethod
    def backward(ctx, gout):
        (x,) = ctx.saved_tensors
        return (hash_grid_train_bwd(x, gout, ctx.spec, ctx.packed), None,
                None, None)


def use_train_fast(spec: HashGridSpec | None) -> bool:
    """The JAX package's packed training path covers grids whose levels
    hold at most 2^16 entries; bigger grids train the float32 table."""
    return (spec is not None
            and max(spec.level_params(lv)
                    for lv in range(spec.n_levels)) <= (1 << 16))


def one_blob_encode(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """OneBlob: the integral of a Gaussian (sigma = 1/n_bins) centered at
    x over each of n_bins bins.  (N, d) -> (N, d*n_bins)."""
    edges = torch.linspace(0.0, 1.0, n_bins + 1, device=x.device)
    denom = float(np.float32(1.0 / n_bins * np.sqrt(2.0)))
    z_hi = (edges[1:] - x[..., None]) / denom
    z_lo = (edges[:-1] - x[..., None]) / denom
    feats = 0.5 * (torch.erf(z_hi) - torch.erf(z_lo))
    return feats.reshape(x.shape[0], -1)


def triangle_wave_encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """tcnn TriangleWave: |2 (x 2^f - round(x 2^f))| for f < n_freqs.
    (N, d) -> (N, d*n_freqs), frequencies minor."""
    freqs = torch.tensor([2.0 ** f for f in range(n_freqs)],
                         dtype=torch.float32, device=x.device)
    xs = x[..., None] * freqs
    tri = torch.abs(2.0 * (xs - torch.floor(xs + 0.5)))
    return tri.reshape(x.shape[0], -1)


def frequency_encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """NeRF / tcnn Frequency: per input dim [sin(x 2^f pi) for f <
    n_freqs] ++ [cos(x 2^f pi) ...], with the float32 values of 2^f pi.
    (N, d) -> (N, d*2*n_freqs)."""
    freqs = torch.tensor([(2.0 ** f) * math.pi for f in range(n_freqs)],
                         dtype=torch.float32, device=x.device)
    xs = x[..., None] * freqs
    out = torch.cat([torch.sin(xs), torch.cos(xs)], dim=-1)
    return out.reshape(x.shape[0], -1)


def encode_packed(packed: torch.Tensor, x5: torch.Tensor, spec: HashGridSpec,
                  n_bins: int, out_dim: int) -> torch.Tensor:
    """(N, 5) -> (N, out_dim): hash-grid features of the position from the
    packed table ++ OneBlob of (theta, phi), padded with ones."""
    pos_f = hash_grid_encode_packed(packed, x5[:, :3], spec)
    dir_f = one_blob_encode(x5[:, 3:5], n_bins)
    pad = torch.ones((x5.shape[0], out_dim - pos_f.shape[1] - dir_f.shape[1]),
                     dtype=pos_f.dtype, device=x5.device)
    return torch.cat([pos_f, dir_f, pad], dim=-1)


class CompositeEncoding:
    """Position encoding ++ direction encoding of the 5-float NRC input
    (pos x/y/z, theta, phi), padded with ones to a multiple of 16 (tcnn
    composite semantics).  ``grid_spec`` is None without a hash grid."""

    def __init__(self, cfg: EncodingConfig):
        self.cfg = cfg
        self.grid_spec = None
        if cfg.pos_id == 0:
            self.grid_spec = HashGridSpec(
                n_levels=cfg.n_levels, n_features=cfg.n_features_per_level,
                log2_table_size=cfg.log2_hashmap_size,
                base_resolution=cfg.base_resolution,
                per_level_scale=cfg.per_level_scale)
            if self.grid_spec.n_features != 2:
                raise NotImplementedError(
                    "the packed table holds 2 features")
            pos_dim = self.grid_spec.out_dim
        elif cfg.pos_id == 1:
            pos_dim = 3
        elif cfg.pos_id == 2:
            pos_dim = 3 * cfg.pos_n_frequencies
        elif cfg.pos_id == 3:
            pos_dim = 3 * cfg.pos_n_frequencies * 2
        else:
            raise ValueError(f"invalid pos encoding id {cfg.pos_id}")
        if cfg.dir_id == 0:
            dir_dim = 2 * cfg.oneblob_n_bins
        elif cfg.dir_id == 1:
            dir_dim = 2
        elif cfg.dir_id == 2:
            dir_dim = 2 * cfg.dir_n_frequencies
        else:
            raise ValueError(f"invalid dir encoding id {cfg.dir_id}")
        self.raw_dim = pos_dim + dir_dim
        self.out_dim = (self.raw_dim + 15) // 16 * 16

    def init_params(self, key: torch.Tensor, device="cuda") -> dict:
        if self.grid_spec is None:
            return {}
        return {"hash_table": init_hash_grid(key, self.grid_spec, device)}

    def __call__(self, params: dict, x5: torch.Tensor,
                 packed: torch.Tensor | None = None,
                 train_fast: bool = False) -> torch.Tensor:
        """(N, 5) -> (N, out_dim) features.  For the hash grid: with
        ``packed`` (the pack_table_bf16 words) it reads the packed table
        through K7's forward, without gradients; with ``train_fast`` and a
        grid of <= 2^16 entries per level, the differentiable packed path;
        else the float32 table of ``params``."""
        cfg = self.cfg
        pos, direction = x5[:, :3], x5[:, 3:5]
        spec = self.grid_spec
        if cfg.pos_id == 0:
            if packed is not None:
                pos_f = hash_grid_encode_packed(packed, pos, spec)
            elif train_fast and use_train_fast(spec):
                pos_f = hash_grid_encode_train(params["hash_table"], pos,
                                               spec)
            else:
                pos_f = hash_grid_encode(params["hash_table"], pos, spec)
        elif cfg.pos_id == 1:
            pos_f = pos
        elif cfg.pos_id == 2:
            pos_f = triangle_wave_encode(pos, cfg.pos_n_frequencies)
        else:
            pos_f = frequency_encode(pos, cfg.pos_n_frequencies)
        if cfg.dir_id == 0:
            dir_f = one_blob_encode(direction, cfg.oneblob_n_bins)
        elif cfg.dir_id == 1:
            dir_f = direction
        else:
            dir_f = triangle_wave_encode(direction, cfg.dir_n_frequencies)
        pad = torch.ones((x5.shape[0], self.out_dim - self.raw_dim),
                         dtype=pos_f.dtype, device=x5.device)
        return torch.cat([pos_f, dir_f, pad], dim=-1)
