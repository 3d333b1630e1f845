"""The neural radiance cache, plain: encoding + MLP + online training.

A frozen copy of the port's cache with every kernel replaced by its plain
version: inference reads the EMA parameters, the hash table packed to bf16
pairs, through the plain gather and the MLP (``mlp.mlp_apply``); training
takes ``train_batch_count`` Adam steps per frame (the table's gradient by
``index_add_``, the MLP's by autograd), then the debiased parameter EMA,
in optax's operation order.  Single device only.

Parameters are ``{"encoding": {"hash_table": (P, 2)}, "mlp": {"layers":
[(in, out), ...]}}`` float32 tensors; the Adam state is ``{"count": int,
"mu": tree, "nu": tree}``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import prng
from .config import AppConfig
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


class NeuralRadianceCache:
    N_INPUT = 5
    N_OUTPUT = 3

    def __init__(self, cfg: AppConfig):
        self.cfg = cfg
        self.encoding = CompositeEncoding(cfg.encoding)
        self.width = cfg.nn_width
        self.depth = cfg.nn_depth
        self.loss_fn = make_loss_fn(cfg.loss_fn)
        if cfg.optimizer.lower() != "adam":
            raise ValueError(f"unsupported optimizer {cfg.optimizer!r}")
        self.ema_decay = cfg.ema_decay
        self.compute_dtype = compute_dtype(cfg.mlp_dtype)
        self.train_fast = cfg.hash_train_fast

    def init_state(self, key: torch.Tensor, device="cuda") -> NrcState:
        """Random init from a threefry key, split into the encoding's and
        the MLP's: hash table uniform in [-1e-4, 1e-4], He-uniform MLP."""
        k_enc, k_mlp = prng.split(key)
        params = {
            "encoding": self.encoding.init_params(k_enc, device),
            "mlp": init_mlp(k_mlp, self.encoding.out_dim, self.width,
                            self.depth, self.N_OUTPUT, device),
        }
        return NrcState(
            params=params, ema_params=tree_map(torch.clone, params),
            opt_state=adam_init(params),
            loss=torch.zeros((), dtype=torch.float32, device=device),
            step=0)

    def apply(self, params: dict, x5: torch.Tensor,
              packed: torch.Tensor | None = None,
              train_fast: bool = False) -> torch.Tensor:
        """Encode, then the MLP in the compute dtype (differentiable)."""
        feats = self.encoding(params["encoding"], x5, packed=packed,
                              train_fast=train_fast)
        return mlp_apply(params["mlp"], feats, self.compute_dtype)

    def infer(self, state: NrcState, x5: torch.Tensor,
              block: int = 1 << 18) -> torch.Tensor:
        """(N, 5) inputs -> (N, 3) predictions with the EMA parameters,
        the hash table packed to bf16 pairs, in blocks of ``block`` rows."""
        ema = state.ema_params
        packed = None if self.encoding.grid_spec is None \
            else pack_table_bf16(ema["encoding"]["hash_table"])
        with torch.no_grad():
            return torch.cat([self.apply(ema, x5[i:i + block], packed=packed)
                              for i in range(0, x5.shape[0], block)]
                             or [x5.new_zeros((0, self.N_OUTPUT))])

    def loss_and_grads(self, params: dict, x5: torch.Tensor,
                       target: torch.Tensor):
        """(mean loss, gradient tree) of one batch."""
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        with torch.enable_grad():
            pred = self.apply(live, x5, train_fast=self.train_fast)
            loss = self.loss_fn(pred, target)
            grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    def train_step(self, state: NrcState, x5: torch.Tensor,
                   target: torch.Tensor) -> NrcState:
        """One Adam step on one (batch, 5)/(batch, 3) batch, then the
        EMA."""
        loss, grads = self.loss_and_grads(state.params, x5, target)
        params, opt_state = adam_update(grads, state.opt_state,
                                        state.params, self.cfg.learning_rate)
        ema = ema_update(state.ema_params, params, self.ema_decay,
                         state.step)
        return NrcState(params=params, ema_params=ema, opt_state=opt_state,
                        loss=loss, step=state.step + 1)

    def train_frame(self, state: NrcState, x5: torch.Tensor,
                    target: torch.Tensor, steps: int | None = None,
                    record: list | None = None) -> NrcState:
        """The first ``steps`` (all ``train_batch_count`` by default)
        sequential steps over equal slices of the frame's training set;
        each step's state is appended to ``record``."""
        n = self.cfg.train_batch_count
        bs = x5.shape[0] // n
        for i in range(n if steps is None else steps):
            sl = slice(i * bs, (i + 1) * bs)
            state = self.train_step(state, x5[sl], target[sl])
            if record is not None:
                record.append(state)
        return state
