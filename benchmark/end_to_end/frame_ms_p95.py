"""The 95th percentile of the times of all frames completed in the
window, in milliseconds."""

from harness.window import percentile


def read(run):
    return percentile([1e3 * s for s in run["window"].frame_s], 95.0)
