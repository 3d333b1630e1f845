"""The whole frame's share of the card's bf16 peak: the MLP's operations
(a multiply and an add per weight and sample; inference once, each
training sample three times: forward and both backward products) over the
traced frames' wall time.  The samples are counted at the entries of
``cache.infer`` and ``cache.train_frame``, so they count what the inputs
need, whatever implements them."""

from harness.peaks import BF16_OPS_S, mlp_ops

LAYER = "whole frame"
SOURCE = "program_counter"
UNIT = "%"
MOVES = "rays_per_s"


def _infer(state, x5, *a, **kw):
    return x5.shape[0], [tuple(w.shape)
                         for w in state.ema_params["mlp"]["layers"]]


def _train(state, x5, *a, **kw):
    return x5.shape[0], [tuple(w.shape)
                         for w in state.params["mlp"]["layers"]]


CALLS = {"mlp_infer": ("cache.infer", _infer),
         "mlp_train": ("cache.train_frame", _train)}


def read(t):
    ops = (sum(n * mlp_ops(s) for n, s in t.calls["mlp_infer"])
           + 3 * sum(n * mlp_ops(s) for n, s in t.calls["mlp_train"]))
    if not ops or not t.device:
        return None
    return 100.0 * ops / (t.wall_s * BF16_OPS_S)
