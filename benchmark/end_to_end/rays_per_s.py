"""Camera rays a second: the frame's pixels times the frames completed in
the window, over the time from the window's start to the end of the last
of them."""


def read(run):
    return run["window"].rate(run["pixels"])
