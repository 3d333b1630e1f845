"""The plain reference of the benchmark's comparison: a frozen copy of the
port's plain paths (renderers, trackers, cache, encoding, MLP, Adam), every
kernel replaced by its plain PyTorch version.  It imports nothing of the
port or of JAX, so a later change to the port cannot move it."""
