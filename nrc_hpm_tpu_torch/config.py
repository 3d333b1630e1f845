"""Configuration dataclasses of the port.

The fields of ``nrc_hpm_tpu/config.py`` that the serving path reads, under
the same names and defaults, and the six scene presets.  Kept as a copy so
the port imports nothing of the JAX package; the training fields come with
the training port.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EncodingConfig:
    """pos_id 0 = HashGrid(16 levels, 2 features, 2^19 table, base 16,
    scale 2.0); dir_id 0 = OneBlob(4 bins).  Other ids are not ported."""

    pos_id: int = 0
    dir_id: int = 0
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 2.0
    oneblob_n_bins: int = 4


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """A scene preset.  Every preset's environment map is constant white,
    so env radiance equals ``hdr_env_map_strength``."""

    id: int = 4
    dir_light_strength: float = 8.0
    point_light_strength: float = 0.0
    hdr_env_map_strength: float = 0.1
    density: float = 0.6
    volume_g: float = 0.8

    @staticmethod
    def preset(scene_id: int) -> "SceneConfig":
        table = {
            0: dict(dir_light_strength=16.0, point_light_strength=0.0,
                    hdr_env_map_strength=0.0, density=0.6),
            1: dict(dir_light_strength=0.0, point_light_strength=64.0,
                    hdr_env_map_strength=0.0, density=0.6),
            2: dict(dir_light_strength=0.0, point_light_strength=128.0,
                    hdr_env_map_strength=0.0, density=1.0),
            3: dict(dir_light_strength=16.0, point_light_strength=0.0,
                    hdr_env_map_strength=0.0, density=0.25),
            4: dict(dir_light_strength=8.0, point_light_strength=0.0,
                    hdr_env_map_strength=0.1, density=0.6),
            5: dict(dir_light_strength=0.0, point_light_strength=0.0,
                    hdr_env_map_strength=1.0, density=1.6),
        }
        if scene_id not in table:
            raise ValueError(f"HpmSceneConfig ID is invalid: {scene_id}")
        return SceneConfig(id=scene_id, **table[scene_id])


@dataclasses.dataclass(frozen=True)
class AppConfig:
    encoding: EncodingConfig = dataclasses.field(
        default_factory=EncodingConfig)
    nn_width: int = 64
    nn_depth: int = 6
    scene: SceneConfig = dataclasses.field(
        default_factory=lambda: SceneConfig.preset(4))
    primary_ray_length: int = 1
    primary_ray_prob: float = 0.0
    render_width: int = 1920
    render_height: int = 1080
    # cap on tracking events per track call (the reference caps its loops
    # at 128) and on primary bounces
    max_track_steps: int = 128
    max_primary_bounces: int = 128
