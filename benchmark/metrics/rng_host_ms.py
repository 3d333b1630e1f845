"""Host milliseconds a frame in the RNG and draw glue: the program's
``rng`` region (``utils/rng.py``'s draws, the trackers' seeds and indexed
draws, the dead lanes' advance), each outermost call's host time summed,
over the traced frames."""

from harness.program import traced_frames

LAYER = "RNG and draw glue"
SOURCE = "program_span"
UNIT = "ms/frame"
MOVES = "rays_per_s"


def read(t):
    frames = traced_frames(t)
    if frames is None:
        return None
    ns = sum(f.regions.get("rng", (0, 0))[0] for f in frames)
    return ns / 1e6 / len(frames)
