"""The two sides of a cell: the port under test (``nrc_hpm_tpu_torch``)
and the plain reference (``reference/``), built alike from the cell's
configuration file and traffic mix, with the same cloud, seed and camera.

A configuration file holds ``app`` (every field of ``AppConfig`` it sets,
``encoding`` and ``scene`` as groups) and ``cloud`` (the procedural
field's seed and shape).  The traffic mix names the renderer by its
module and class inside the package (``renderer.NrcRenderer``), the same
on both sides, and the camera by a file of ``cameras/``.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np

from . import cloud, registry


def modules(package: str) -> dict:
    """The config, volume and camera modules of the port
    (``nrc_hpm_tpu_torch``) or of the reference (``reference``)."""
    names = ("config", "volume", "camera")
    return {n: importlib.import_module(f"{package}.{n}") for n in names}


def app_config(config_mod, cfg_file: dict, overrides: dict | None = None):
    """The ``AppConfig`` of ``config_mod`` that the file describes, with
    ``overrides`` (field -> value; ``encoding`` a dict of its fields)
    applied."""
    app = {**cfg_file["app"], **(overrides or {})}
    enc = {**cfg_file["app"]["encoding"], **app.pop("encoding")}
    scene = config_mod.SceneConfig(**app.pop("scene"))
    return config_mod.AppConfig(
        encoding=config_mod.EncodingConfig(**enc), scene=scene, **app)


def make_cloud(cfg_file: dict) -> np.ndarray:
    c = cfg_file["cloud"]
    return cloud.cloud_density(int(c["seed"]), tuple(c["shape"]))


def convert(obj, module):
    """``obj`` with every dataclass in it rebuilt as the class of the same
    name in ``module``: one side's render state in the other side's
    classes, holding the same tensors."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(module, type(obj).__name__)
        return cls(**{f.name: convert(getattr(obj, f.name), module)
                      for f in dataclasses.fields(obj)})
    return obj


@dataclasses.dataclass
class Side:
    """One side's renderer, its module, the camera of each frame and the
    configuration, on ``device``."""

    mods: dict
    module: object
    cfg: object
    renderer: object
    camera: object          # frame index -> Camera

    @property
    def pixels(self) -> int:
        return self.renderer.width * self.renderer.height


def build(package: str, cfg_file: dict, traffic: dict, dens: np.ndarray,
          device, overrides: dict | None = None, base=registry.HERE
          ) -> Side:
    """The side of ``package`` for a cell: the traffic's renderer
    (``"renderer": "<module>.<Class>"``) on the volume of ``dens`` at the
    configuration's density and phase g, and its camera
    (``cameras/<traffic["camera"]>.py``)."""
    mods = modules(package)
    cfg = app_config(mods["config"], cfg_file, overrides)
    vol = mods["volume"].Volume.from_dense(dens, cfg.scene.density,
                                           cfg.scene.volume_g, device=device)
    mod_name, cls = traffic["renderer"].rsplit(".", 1)
    module = importlib.import_module(f"{package}.{mod_name}")
    renderer = getattr(module, cls)(cfg, vol)
    camera = registry.camera(traffic["camera"], base).make(
        mods["camera"], device)
    return Side(mods=mods, module=module, cfg=cfg, renderer=renderer,
                camera=camera)
