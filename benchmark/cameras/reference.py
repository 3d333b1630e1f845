"""The reference camera (``Camera.reference_camera``) in every frame."""


def make(camera_mod, device):
    """Frame index -> the side's ``Camera``."""
    cam = camera_mod.Camera.reference_camera(device=device)
    return lambda frame: cam
