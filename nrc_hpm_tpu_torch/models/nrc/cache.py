"""NeuralRadianceCache: encoding + MLP + online training state.

Port of ``nrc_hpm_tpu/models/nrc/cache.py``.  Inference serves the EMA
parameters.  In bfloat16 the default encoding (hash grid + OneBlob) runs
the fused encode + MLP kernel (K3) where K3 takes its shapes (a 64-wide
MLP, <= 16 levels); every other cache runs the split encode (the hash
grid from the packed table through K7's forward) and then the fused MLP
kernel (K4) up to width 256, the bf16 mlp_apply above it (the JAX
package's ``use_fused``); in float32 the plain MLP runs in float32.
Training takes ``train_batch_count`` optimizer steps per frame: the
forward and the table gradient go through the hash-grid training kernels
(K7, via ``CompositeEncoding``) when there is a hash grid, the MLP
backward through autograd, then Adam (or SGD) and the debiased parameter
EMA as plain tensor functions in optax's operation order.  Adam is dense over every
table row, as optax's is.  The losses are tcnn's, with the denominators
detached.

Parameters are ``{"encoding": {"hash_table": (P, 2)}, "mlp": {"layers":
[(in, out), ...]}}`` float32 tensors (``"encoding": {}`` without a hash
grid); the Adam state is ``{"count": int, "mu": tree, "nu": tree}`` and
SGD's is ``{}``.  Every update builds new tensors, as the JAX package's
does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ...config import AppConfig
from ...ops import fused_encode_mlp, fused_mlp
from ...utils import prng
from .encoding import CompositeEncoding, pack_table_bf16
from .mlp import compute_dtype, init_mlp, mlp_apply

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def tree_map(fn, *trees):
    """fn over the leaves of parameter trees (dicts and lists of
    tensors) of the same structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *leaves) for leaves in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """tcnn relative-L2-luminance coefficients (0.299, 0.587, 0.114)."""
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def make_loss_fn_per_sample(name: str):
    """tcnn loss zoo, per sample (mean over channels -> (B,)); the
    relative losses' denominators carry no gradient, like tcnn's."""
    name = name.lower()

    def rel_l2_luminance(pred, target):
        lum = luminance(pred).detach()
        denom = lum * lum + 0.01
        return torch.mean((pred - target) ** 2 / denom[..., None], dim=-1)

    def rel_l2(pred, target):
        denom = pred.detach() ** 2 + 0.01
        return torch.mean((pred - target) ** 2 / denom, dim=-1)

    def l2(pred, target):
        return torch.mean((pred - target) ** 2, dim=-1)

    def l1(pred, target):
        return torch.mean(torch.abs(pred - target), dim=-1)

    table = {"relativel2luminance": rel_l2_luminance,
             "relativel2": rel_l2, "l2": l2, "l1": l1}
    if name not in table:
        raise ValueError(f"unsupported loss {name!r}; "
                         f"choose from {sorted(table)}")
    return table[name]


def make_loss_fn(name: str):
    """Batch-mean form of make_loss_fn_per_sample (the tcnn loss value)."""
    per = make_loss_fn_per_sample(name)

    def mean_loss(pred, target):
        return torch.mean(per(pred, target))

    return mean_loss


def _f32_pow(base: float, t: int) -> float:
    return float(np.float32(base) ** np.float32(t))


def adam_init(params: dict) -> dict:
    return {"count": 0, "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params)}


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA's and CUDA's
    ``sqrt``: torch's vectorized CPU ``sqrt`` can be an ulp off (AVX-512
    builds), so on the CPU it goes through float64, whose root rounds to
    the correct float32 one."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def adam_update(grads: dict, opt_state: dict, params: dict, lr: float):
    """optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8): returns (params,
    opt_state)."""
    mu = tree_map(lambda g, m: (1 - ADAM_B1) * g + ADAM_B1 * m, grads,
                  opt_state["mu"])
    nu = tree_map(lambda g, v: (1 - ADAM_B2) * (g * g) + ADAM_B2 * v, grads,
                  opt_state["nu"])
    count = opt_state["count"] + 1
    bc1 = float(np.float32(1) - np.float32(_f32_pow(ADAM_B1, count)))
    bc2 = float(np.float32(1) - np.float32(_f32_pow(ADAM_B2, count)))

    def step(p, m, v):
        u = (m / bc1) / (sqrt_f32(v / bc2) + ADAM_EPS)
        return p + (-lr) * u

    return (tree_map(step, params, mu, nu),
            {"count": count, "mu": mu, "nu": nu})


def sgd_update(grads: dict, opt_state: dict, params: dict, lr: float):
    """optax.sgd(lr): p - lr * g."""
    return tree_map(lambda p, g: p + (-lr) * g, params, grads), opt_state


def ema_update(ema: dict, params: dict, decay: float, step: int) -> dict:
    """tcnn's debiased EMA: (e*d*(1 - d^t) + p*(1 - d)) / (1 - d^(t+1))
    with t the number of steps taken before this one."""
    one = np.float32(1)
    old = float(one - np.float32(_f32_pow(decay, step)))
    new = float(one / (one - np.float32(_f32_pow(decay, step + 1))))
    return tree_map(lambda e, p: (e * decay * old + p * (1.0 - decay)) * new,
                    ema, params)


@dataclasses.dataclass
class NrcState:
    """Trainable cache state: the trained and the served (EMA) parameters,
    the optimizer state, the last batch's loss (() float32 tensor) and the
    number of optimizer steps taken."""

    params: dict
    ema_params: dict
    opt_state: dict
    loss: torch.Tensor
    step: int

    def to(self, device) -> "NrcState":
        opt = {k: v if k == "count" else _to(v, device)
               for k, v in self.opt_state.items()}
        return NrcState(params=_to(self.params, device),
                        ema_params=_to(self.ema_params, device),
                        opt_state=opt, loss=self.loss.to(device),
                        step=self.step)


def _to(params: dict, device) -> dict:
    return tree_map(lambda t: t.to(device), params)


class NeuralRadianceCache:
    N_INPUT = 5
    N_OUTPUT = 3

    def __init__(self, cfg: AppConfig):
        self.cfg = cfg
        self.encoding = CompositeEncoding(cfg.encoding)
        self.width = cfg.nn_width
        self.depth = cfg.nn_depth
        self.loss_fn = make_loss_fn(cfg.loss_fn)
        self.loss_per_sample = make_loss_fn_per_sample(cfg.loss_fn)
        opt = cfg.optimizer.lower()
        if opt not in ("adam", "sgd"):
            raise ValueError(f"unsupported optimizer {cfg.optimizer!r}")
        self.optimizer = opt
        self.ema_decay = cfg.ema_decay
        self.compute_dtype = compute_dtype(cfg.mlp_dtype)
        self.train_fast = cfg.hash_train_fast

    def init_state(self, key: torch.Tensor, device="cuda") -> NrcState:
        """Random init from a threefry key (``utils/prng.py``), split into
        the encoding's and the MLP's as the JAX package splits it: hash
        table uniform in [-1e-4, 1e-4], He-uniform MLP."""
        k_enc, k_mlp = prng.split(key)
        params = {
            "encoding": self.encoding.init_params(k_enc, device),
            "mlp": init_mlp(k_mlp, self.encoding.out_dim, self.width,
                            self.depth, self.N_OUTPUT, device),
        }
        return self.state_from_params(params, device)

    def state_from_params(self, params: dict, device="cuda") -> NrcState:
        """A fresh training state whose trained and served parameters are
        copies of ``params``."""
        params = tree_map(lambda t: t.to(device, copy=True), params)
        return NrcState(
            params=params, ema_params=tree_map(torch.clone, params),
            opt_state=adam_init(params) if self.optimizer == "adam" else {},
            loss=torch.zeros((), dtype=torch.float32, device=device),
            step=0)

    # -- forward ------------------------------------------------------------
    def apply(self, params: dict, x5: torch.Tensor,
              packed: torch.Tensor | None = None, train_fast: bool = False,
              fused: bool = False) -> torch.Tensor:
        """Encode, then the MLP: through K4 with ``fused`` in bfloat16 at
        widths K4 serves (the JAX package's ``use_fused``), else mlp_apply
        in the compute dtype (differentiable)."""
        feats = self.encoding(params["encoding"], x5, packed=packed,
                              train_fast=train_fast)
        if (fused and self.compute_dtype == torch.bfloat16
                and fused_mlp.use_fused(self.width)):
            return fused_mlp.fused_mlp_infer(params["mlp"], feats,
                                             self.N_OUTPUT)
        return mlp_apply(params["mlp"], feats, self.compute_dtype)

    def infer(self, state: NrcState, x5: torch.Tensor) -> torch.Tensor:
        """(N, 5) inputs -> (N, 3) predictions with the EMA parameters,
        the hash table packed to bf16 pairs like tcnn's half-precision
        inference parameters.  In bfloat16 the default encoding runs K3
        where K3 takes its shapes; every other cache the split encode and
        K4 (``apply``)."""
        ema = state.ema_params
        enc = self.encoding
        packed = None if enc.grid_spec is None \
            else pack_table_bf16(ema["encoding"]["hash_table"])
        layers = ema["mlp"]["layers"]
        if (self.compute_dtype == torch.bfloat16 and enc.cfg.dir_id == 0
                and fused_encode_mlp.takes(enc.grid_spec,
                                           enc.cfg.oneblob_n_bins, layers,
                                           self.N_OUTPUT)):
            return fused_encode_mlp.fused_encode_mlp_infer(
                packed, layers, x5.contiguous(), enc.grid_spec,
                n_bins=enc.cfg.oneblob_n_bins, out_dim=self.N_OUTPUT)
        return self.apply(ema, x5, packed=packed, fused=True)

    # -- training -----------------------------------------------------------
    def loss_and_grads(self, params: dict, x5: torch.Tensor,
                       target: torch.Tensor, weight=None, inv_tot=None):
        """(loss, gradient tree) of one batch: the mean loss, or with a
        (B,) ``weight`` the weighted sum times ``inv_tot``."""
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        with torch.enable_grad():
            pred = self.apply(live, x5, train_fast=self.train_fast)
            if weight is None:
                loss = self.loss_fn(pred, target)
            else:
                loss = torch.sum(self.loss_per_sample(pred, target)
                                 * weight) * inv_tot
            grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    def train_step(self, state: NrcState, x5: torch.Tensor,
                   target: torch.Tensor, group=None,
                   weight: torch.Tensor | None = None) -> NrcState:
        """One optimizer step on one (batch, 5)/(batch, 3) training
        batch, then the EMA.  With a ``torch.distributed`` process
        ``group`` (the JAX package's ``axis_name``) the gradients and the
        loss are averaged over its ranks, which then apply the same
        update.  ``weight`` (B,) masks the padding lanes of uneven
        shards: the loss is the weighted sum over the weight summed over
        the group, and the gradients are summed, so the update is the
        single-device one over the lanes of weight > 0."""
        inv_tot = None
        if weight is not None:
            tot = torch.sum(weight)
            if group is not None:
                dist.all_reduce(tot, group=group)
            inv_tot = 1.0 / torch.clamp(tot, min=1.0)
        loss, grads = self.loss_and_grads(state.params, x5, target, weight,
                                          inv_tot)
        if group is not None:
            loss, grads = _all_reduce(loss, grads, group,
                                      mean=weight is None)
        update = adam_update if self.optimizer == "adam" else sgd_update
        params, opt_state = update(grads, state.opt_state, state.params,
                                   self.cfg.learning_rate)
        ema = ema_update(state.ema_params, params, self.ema_decay,
                         state.step)
        return NrcState(params=params, ema_params=ema, opt_state=opt_state,
                        loss=loss, step=state.step + 1)

    def train_frame(self, state: NrcState, x5: torch.Tensor,
                    target: torch.Tensor, group=None,
                    weight: torch.Tensor | None = None) -> NrcState:
        """``train_batch_count`` sequential steps over equal slices of the
        frame's training set (and of ``weight``)."""
        n = self.cfg.train_batch_count
        bs = x5.shape[0] // n
        for i in range(n):
            sl = slice(i * bs, (i + 1) * bs)
            state = self.train_step(state, x5[sl], target[sl], group,
                                    None if weight is None else weight[sl])
        return state


def _all_reduce(loss: torch.Tensor, grads: dict, group, mean: bool):
    """The loss and the gradient tree summed over ``group`` in one flat
    all-reduce (every rank receives the same bits), divided by the
    group's size with ``mean`` (JAX's pmean; else its psum)."""
    leaves = tree_leaves(grads)
    flat = torch.cat([g.reshape(-1) for g in leaves] + [loss.reshape(1)])
    dist.all_reduce(flat, group=group)
    if mean:
        flat = flat / dist.get_world_size(group)
    parts = iter(flat.split([g.numel() for g in leaves] + [1]))
    grads = tree_map(lambda g: next(parts).view_as(g), grads)
    return next(parts).reshape(()), grads
