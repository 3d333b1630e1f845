"""Configuration dataclasses of the port.

The fields of ``nrc_hpm_tpu/config.py`` that the serving and training
paths read or that ``AppConfig.from_argv`` fills, under the same names and
defaults, the six scene presets, the output-directory ``name()`` and the
reference's default argv.  Kept as a copy so the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class EncodingConfig:
    """NN input-encoding selection.

    pos_id: 0 = HashGrid(16 levels, 2 features, 2^19 table, base 16,
            scale 2.0), 1 = Identity, 2 = TriangleWave(pos_n_frequencies),
            3 = Frequency(pos_n_frequencies).
    dir_id: 0 = OneBlob(oneblob_n_bins), 1 = Identity,
            2 = TriangleWave(dir_n_frequencies).
    """

    pos_id: int = 0
    dir_id: int = 0
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 2.0
    pos_n_frequencies: int = 12
    dir_n_frequencies: int = 4
    oneblob_n_bins: int = 4


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """A scene preset.  Every preset's environment map is constant white,
    so env radiance equals ``hdr_env_map_strength``; ``hdr_env_map_path``
    names a real equirect map (.exr or Radiance .hdr) instead.
    ``dynamic`` animates the dir light (``lights.update_scene``); the
    cloud is read from ``volume_path`` (``renderer._volume_from_config``)."""

    id: int = 4
    dir_light_strength: float = 8.0
    point_light_strength: float = 0.0
    hdr_env_map_path: str = ""
    hdr_env_map_strength: float = 0.1
    density: float = 0.6
    dynamic: bool = False
    volume_path: str = "data/volume/wdas_cloud_sixteenth.vdb"
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
    # NN training
    loss_fn: str = "RelativeL2Luminance"
    optimizer: str = "Adam"
    learning_rate: float = 0.01
    ema_decay: float = 0.99
    encoding: EncodingConfig = dataclasses.field(
        default_factory=EncodingConfig)
    nn_width: int = 64
    nn_depth: int = 6
    log2_infer_batch_size: int = 21
    log2_train_batch_size: int = 14
    train_batch_count: int = 4
    scene: SceneConfig = dataclasses.field(
        default_factory=lambda: SceneConfig.preset(4))
    # path tracing
    train_ring_buf_size: float = 1.0
    train_spp: int = 1
    primary_ray_length: int = 1
    primary_ray_prob: float = 0.0
    train_ray_length: int = 32
    render_width: int = 1920
    render_height: int = 1080
    # cap on tracking events per track call (the reference caps its loops
    # at 128) and on primary bounces
    max_track_steps: int = 128
    max_primary_bounces: int = 128
    # MC ground-truth path length (the reference's main loop uses 32; its
    # golden images use 64)
    mc_path_length: int = 32
    # compute dtype of the MLP ("bfloat16" or "float32")
    mlp_dtype: str = "bfloat16"
    # bf16 packed-table forward for grids of <= 2^16 entries per level
    # (encoding.use_train_fast); larger grids train the float32 table
    hash_train_fast: bool = True
    # the env in-scatter term through the 16-step fixed transmittance of
    # the reference's golden era instead of ratio tracking
    # (integrator.TraceParams.env_fixed16)
    env_fixed16: bool = False
    # train-target radiance clamp (the reference hardcodes 8.0)
    train_target_clamp: float = 8.0
    # surviving train paths add the pre-train cache's prediction at their
    # terminal (pos, dir), scaled by the path throughput
    train_cache_bootstrap: bool = False

    @staticmethod
    def tpu_tuned(**overrides) -> "AppConfig":
        """The JAX package's TPU operating point: the defaults with 2^12
        hash tables."""
        enc = overrides.pop("encoding", EncodingConfig(log2_hashmap_size=12))
        return AppConfig(encoding=enc, **overrides)

    @property
    def infer_batch_size(self) -> int:
        """The reference's inference chunk, kept for parity only: the
        port's ``infer_filtered`` runs every scattered lane in one call."""
        return 2 << (self.log2_infer_batch_size - 1)

    @property
    def train_batch_size(self) -> int:
        return 2 << (self.log2_train_batch_size - 1)

    @property
    def train_pixel_count(self) -> int:
        return self.train_batch_count * self.train_batch_size

    def train_subset(self) -> tuple[int, int, int, int]:
        """(train_w, train_h, x_dist, y_dist): the most-square factoring
        of train_pixel_count, the bigger factor along the wider screen
        axis, with integer screen/train strides per axis."""
        n = self.train_pixel_count
        f = int(n ** 0.5)
        while f >= 2:
            if n % f == 0:
                other = n // f
                big, small = max(f, other), min(f, other)
                if self.render_width > self.render_height:
                    tw, th = big, small
                else:
                    tw, th = small, big
                return (tw, th, self.render_width // tw,
                        self.render_height // th)
            f -= 1
        raise ValueError(
            f"Could not find suitable division of trainPixelCount {n}")

    @property
    def train_ring_size(self) -> int:
        """Ring buffer capacity = train_ring_buf_size * train pixel count."""
        return int(self.train_ring_buf_size * self.train_pixel_count)

    def name(self) -> str:
        """The underscore-joined output-directory name of the reference's
        17 experiment parameters."""
        parts = [
            self.loss_fn, self.optimizer,
            f"{self.learning_rate:.6f}", f"{self.ema_decay:.6f}",
            str(self.encoding.pos_id), str(self.encoding.dir_id),
            str(self.nn_width), str(self.nn_depth),
            str(self.log2_infer_batch_size), str(self.log2_train_batch_size),
            str(self.train_batch_count), str(self.scene.id),
            f"{self.train_ring_buf_size:.6f}", str(self.train_spp),
            str(self.primary_ray_length), f"{self.primary_ray_prob:.6f}",
            str(self.train_ray_length),
        ]
        return "_".join(parts)

    @staticmethod
    def from_argv(argv: Sequence[str]) -> "AppConfig":
        """The reference's 17 positional arguments (without the program
        name): loss, optimizer, learning rate, EMA decay, pos_id, dir_id,
        width, depth, log2 infer batch, log2 train batch, train batch
        count, scene id, ring size, train spp, primary ray length and
        probability, train ray length."""
        if len(argv) != 17:
            raise ValueError(
                "Argument count does not match requirements for AppConfig "
                f"(got {len(argv)}, want 17)")
        (loss_fn, optimizer, lr, ema, pos_id, dir_id, width, depth,
         log2_infer, log2_train, tbc, scene_id, ring, spp, prl, prp,
         trl) = argv
        return AppConfig(
            loss_fn=loss_fn, optimizer=optimizer, learning_rate=float(lr),
            ema_decay=float(ema),
            encoding=EncodingConfig(pos_id=int(pos_id), dir_id=int(dir_id)),
            nn_width=int(width), nn_depth=int(depth),
            log2_infer_batch_size=int(log2_infer),
            log2_train_batch_size=int(log2_train),
            train_batch_count=int(tbc),
            scene=SceneConfig.preset(int(scene_id)),
            train_ring_buf_size=float(ring), train_spp=int(spp),
            primary_ray_length=int(prl), primary_ray_prob=float(prp),
            train_ray_length=int(trl))


# The arguments the reference binary runs with when it is given none.
DEFAULT_ARGV = [
    "RelativeL2Luminance", "Adam", "0.01", "0.99",
    "0", "0",
    "64", "6", "21", "14", "4",
    "4",
    "1.0", "1", "1", "0.0", "32",
]
