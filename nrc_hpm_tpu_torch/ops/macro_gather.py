"""Lookups into a small float32 table: kernel K6 (``small_table_lookup``).

Replaces the Pallas kernel ``nrc_hpm_tpu/ops/macro_gather.py:_kernel``
(wrapper ``small_table_lookup``) with the CUDA kernel
``small_table_lookup_kernel`` of ``csrc/table_gather.cu`` (built with K5),
which stages the table in shared memory; that file's header says what
bounds it on the H100.  It serves the volume's float32 majorant and
control lookups (``volume.macro_sigma`` / ``macro_control`` and their
``_xyz`` forms).

``small_table_lookup`` keeps the JAX contract: table (T,) float32 with
T <= 8,192, idx int32 of any shape, the result is float32 of idx's shape
and bitwise ``table[idx]``.  The contract is checked on every device; CPU
tensors take the plain version, CUDA tensors launch the kernel, other
devices raise.  ``small_table_lookup.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build
from .table_gather import check_lookup, launch_lookup

MAX_ENTRIES = 8192


def small_table_lookup_plain(table: torch.Tensor, idx: torch.Tensor
                             ) -> torch.Tensor:
    return table[idx]


def small_table_lookup(table: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    """table (T,) float32, T <= 8,192; idx int32 of any shape in [0, T)
    -> table[idx] float32."""
    name = "small_table_lookup"
    check_lookup(name, table, idx, (torch.float32,), MAX_ENTRIES)
    if not _build.on_card(name, idx.device):
        return small_table_lookup_plain(table, idx)
    return launch_lookup("small_table_lookup_launch", small_table_lookup,
                         table, idx)


small_table_lookup.launches = 0
