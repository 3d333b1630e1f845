"""Host syncs a frame: the program's count of the operations that wait for
the device (``profiler.sync``: the bounce loop's and the ``pw`` trackers'
``torch.nonzero``, the inference filter's, and the copies to the card of
the RNG seed and of ``new_ray_dir``'s fallback axis), summed over the
sites, over the traced frames."""

from harness.program import traced_frames

LAYER = "frame loop, host"
SOURCE = "program_counter"
UNIT = "syncs/frame"
MOVES = "rays_per_s"


def read(t):
    frames = traced_frames(t)
    if frames is None:
        return None
    return sum(sum(f.syncs.values()) for f in frames) / len(frames)
