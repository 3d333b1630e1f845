"""NeuralRadianceCache: encoding + MLP, serving side.

Port of ``init_state`` and ``infer`` of
``nrc_hpm_tpu/models/nrc/cache.py``: inference serves the EMA parameters
through the fused encode + MLP kernel (K3).  Training (Adam, the EMA
update, the loss zoo) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ...config import AppConfig
from ...ops.fused_encode_mlp import fused_encode_mlp_infer
from .encoding import CompositeEncoding, pack_table_bf16
from .mlp import init_mlp


@dataclasses.dataclass
class NrcState:
    """The served (EMA) cache parameters: {"encoding": {"hash_table":
    (P, 2)}, "mlp": {"layers": [(in, out), ...]}} float32 tensors."""

    ema_params: dict


def _to(params: dict, device) -> dict:
    return {"encoding": {"hash_table":
                         params["encoding"]["hash_table"].to(device)},
            "mlp": {"layers": [w.to(device) for w in params["mlp"]["layers"]]}}


class NeuralRadianceCache:
    N_INPUT = 5
    N_OUTPUT = 3

    def __init__(self, cfg: AppConfig):
        self.cfg = cfg
        self.encoding = CompositeEncoding(cfg.encoding)
        self.width = cfg.nn_width
        self.depth = cfg.nn_depth

    def init_state(self, generator: torch.Generator, device="cpu"
                   ) -> NrcState:
        """Random init from a CPU generator: hash table uniform in
        [-1e-4, 1e-4], He-uniform MLP."""
        params = {
            "encoding": self.encoding.init_params(generator),
            "mlp": init_mlp(generator, self.encoding.out_dim, self.width,
                            self.depth, self.N_OUTPUT),
        }
        return self.state_from_params(params, device)

    def state_from_params(self, params: dict, device="cpu") -> NrcState:
        return NrcState(ema_params=_to(params, device))

    def infer(self, state: NrcState, x5: torch.Tensor) -> torch.Tensor:
        """(N, 5) inputs -> (N, 3) predictions with the EMA parameters,
        the hash table packed to bf16 pairs like tcnn's half-precision
        inference parameters."""
        enc = state.ema_params["encoding"]
        return fused_encode_mlp_infer(
            pack_table_bf16(enc["hash_table"]),
            state.ema_params["mlp"]["layers"], x5.contiguous(),
            self.encoding.grid_spec, n_bins=self.cfg.encoding.oneblob_n_bins,
            out_dim=self.N_OUTPUT)
