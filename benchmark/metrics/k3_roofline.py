"""K3's share of its roofline: the summed bound of each launch in the
traced frames (``rooflines/k3.py`` at the call's samples) over K3's device
time in the trace."""

LAYER = "K3 (fused_encode_mlp_kernel)"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "rays_per_s"
ROOFLINES = ["k3"]


def read(t):
    return t.roofline("k3")
