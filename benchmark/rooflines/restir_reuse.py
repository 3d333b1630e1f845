"""The ReSTIR frame's reuse passes, temporal and spatial: the least bytes
the two stages must move, whatever kernels do the work.  Not a kernel's
roofline (no ``KERNEL``, no ``WRAPS``): ``metrics/restir_reuse_roofline.py``
reads the sizes from the program's ``restir.temporal`` and
``restir.spatial`` spans (``lanes`` = H x W, ``V`` vertices, ``T`` ring
slots) and the time from the two stages' spans.

Float32 throughout (4 bytes), each distinct element read once and each
output written once, per lane:
- temporal: the reservoir (V x 6) and the whole ring (T x V x 6), the stats
  (2) and the did-scatter flag (1) read; the reservoir, the one ring slot
  that changes (V x 6), the stats and the RIS accumulators (2 each)
  written.  The accumulators start at zero each frame: nothing to read.
- spatial: the reservoir (the neighbours' suffixes are its own elements),
  the stats, the accumulators and the flag read; the reservoir, the stats
  and the accumulators written.
The candidates' weights (the phase factor of each splice) are a few
float32 operations a byte, far below the card's float32 peak, so the bytes
bound the stages.
"""

F32 = 4
STAGES = ("restir.temporal", "restir.spatial")


def cost(stage: str, lanes: int, V: int, T: int, **_) -> dict:
    """Bytes of one stage of one frame."""
    res = 6 * V
    if stage == "restir.temporal":
        per_lane = (res + T * res + 2 + 1) + (res + res + 2 + 2)
    elif stage == "restir.spatial":
        per_lane = (res + 2 + 2 + 1) + (res + 2 + 2)
    else:
        raise ValueError(f"no reuse stage {stage!r}")
    return dict(n_bytes=F32 * lanes * per_lane)
