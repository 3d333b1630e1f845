"""Seconds from the process's start to the window's: imports, the CUDA
context, the cloud, loading the built kernels, and the set-up frames."""


def read(run):
    return run["setup_s"]
