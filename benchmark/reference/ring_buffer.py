"""Self-training ring buffer of (pos, dir) records.

Port of ``nrc_hpm_tpu/ring_buffer.py``: a fixed (capacity, 6) float32
tensor with int32 head (push) and tail (pop) cursors kept on the device.
Slots are assigned by a prefix sum over the train-pixel order, so pops and
pushes land where the JAX package puts them; head and tail wrap modulo the
capacity once per frame.  Unpushed slots hold the default ray
(origin 0, direction normalize(1, 1, 1)).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class RingBuffer:
    data: torch.Tensor   # (capacity, 6): pos xyz, dir xyz
    head: torch.Tensor   # () int32 push cursor
    tail: torch.Tensor   # () int32 pop cursor

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @staticmethod
    def create(capacity: int, device="cuda") -> "RingBuffer":
        d = np.zeros((max(capacity, 1), 6), np.float32)
        d[:, 3:] = 1.0 / np.sqrt(3.0)
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return RingBuffer(data=torch.from_numpy(d).to(device), head=zero,
                          tail=zero.clone())


def _slots(cursor: torch.Tensor, mask: torch.Tensor, cap: int):
    """(cursor + rank of each masked lane) % cap, and the masked count."""
    m = mask.to(torch.int32)
    order = torch.cumsum(m, 0, dtype=torch.int32) - 1
    return (cursor + order) % cap, m.sum(dtype=torch.int32)


def ring_wrap(ring: RingBuffer) -> RingBuffer:
    """head/tail %= capacity, once per frame."""
    cap = ring.capacity
    return dataclasses.replace(ring, head=ring.head % cap,
                               tail=ring.tail % cap)


def ring_pop(ring: RingBuffer, want: torch.Tensor):
    """Pop one record per ``want`` lane (bool (N,)).  Returns (records
    (N, 6), new_ring); lanes with want=False get slot 0's record."""
    slots, count = _slots(ring.tail, want, ring.capacity)
    records = ring.data[torch.where(want, slots, 0)]
    return records, dataclasses.replace(ring, tail=ring.tail + count)


def ring_push(ring: RingBuffer, push: torch.Tensor, records: torch.Tensor
              ) -> RingBuffer:
    """Push ``records[i]`` for every push[i]=True lane, in lane order.
    Masked-off lanes write into one scratch row past the end, so the push
    needs no host sync."""
    cap = ring.capacity
    slots, count = _slots(ring.head, push, cap)
    data = torch.cat([ring.data, ring.data[:1]])
    data[torch.where(push, slots, cap)] = records.to(data.dtype)
    return dataclasses.replace(ring, data=data[:cap], head=ring.head + count)
