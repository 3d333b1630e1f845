"""Lookups into a table of up to 65,536 words: kernel K5 (``table_gather``).

Replaces the Pallas kernel ``nrc_hpm_tpu/ops/table_gather.py:_kernel``
(wrapper ``table_gather``) with the CUDA kernel ``table_gather_kernel`` of
``csrc/table_gather.cu``; that file's header says what bounds it on the
H100.  The TPU swept the table's rows because it has no vector gather; on
the card it is one load per index.  It serves the coarse profile of the
piecewise trackers at ``coarse != 32`` (``volume.macro_profile_xyz`` on
the bf16-packed macro table).

``table_gather`` keeps the JAX contract: table (T,) float32, int32 or
uint32 with T <= 65,536, idx int32 of any shape, the result has the
table's dtype and idx's shape and is bitwise ``table[idx]``.  The contract
is checked on every device; CPU tensors take the plain version
``table_gather_plain`` and CUDA tensors launch the kernel (uint32 travels
as int32 bits); other devices raise.  ``table_gather.launches`` counts
kernel launches.  ``pack_bf16_pair`` / ``unpack_bf16_pair`` build and read
the packed words (int32 tensors holding the uint32 bits).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import rng
from . import _build

MAX_ENTRIES = 65536
_LIB = "table_gather"
_DTYPES = (torch.float32, torch.int32, torch.uint32)


def table_gather_plain(table: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    return table[idx]


def _lib():
    lib = _build.load(_LIB)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.table_gather_launch, lib.small_table_lookup_launch):
        fn.argtypes = [P, I, P, LL, P, P]
        fn.restype = I
    return lib


def check_lookup(name: str, table, idx, dtypes, max_entries: int) -> None:
    """The contract of both lookup kernels: a 1-D table of a 32-bit dtype
    with 1..max_entries entries, int32 indices on the table's device."""
    _build.require(name, table.ndim == 1 and table.dtype in dtypes
                   and 1 <= table.shape[0] <= max_entries,
                   f"table must be (T,) {'/'.join(map(str, dtypes))} with "
                   f"1 <= T <= {max_entries}, not {tuple(table.shape)} "
                   f"{table.dtype}")
    _build.require(name, idx.dtype == torch.int32, "idx must be int32")
    _build.require(name, idx.device == table.device,
                   f"idx is on {idx.device}, the table on {table.device}")


def launch_lookup(launcher: str, wrapper, table, idx) -> torch.Tensor:
    """Launch ``launcher`` of csrc/table_gather.cu on CUDA tensors and add
    one to ``wrapper.launches`` (nothing is launched for an empty idx); the
    output has the table's dtype and idx's shape."""
    table, idx = table.contiguous(), idx.contiguous()
    out = torch.empty(idx.shape, dtype=table.dtype, device=idx.device)
    if idx.numel() == 0:
        return out
    lib = _lib()
    rc = getattr(lib, launcher)(
        _build.ptr(table), table.shape[0], _build.ptr(idx), idx.numel(),
        _build.ptr(out), _build.stream_ptr(idx.device))
    _build.check(lib, _LIB, rc)
    wrapper.launches += 1
    return out


def table_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (T,) float32/int32/uint32, T <= 65,536; idx int32 of any shape
    in [0, T) -> table[idx] with the table's dtype."""
    name = "table_gather"
    check_lookup(name, table, idx, _DTYPES, MAX_ENTRIES)
    if not _build.on_card(name, idx.device):
        return table_gather_plain(table, idx)
    return launch_lookup("table_gather_launch", table_gather, table, idx)


table_gather.launches = 0


def pack_bf16_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two float32 tensors -> int32 words holding (bf16(a) << 16) |
    bf16(b) (the JAX package's uint32 bits)."""
    ha = a.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    hb = b.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    return rng.u32_to_i32((ha << 16) | hb)


def unpack_bf16_pair(w: torch.Tensor):
    """Inverse of pack_bf16_pair: (a, b) as float32."""
    w64 = w.to(torch.int64) & rng.M32
    return rng.u32_to_f32(w64 & 0xFFFF0000), rng.u32_to_f32(w64 << 16)
