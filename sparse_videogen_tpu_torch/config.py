"""Static configuration objects (counterpart of sparse_videogen_tpu/config.py).

The port keeps its own copy: the same frozen dataclasses, fields, defaults
and semantics, so that the two packages can be handed configs built from the
same values. Tests build each package's own config and compare results.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class SparseMode(str, enum.Enum):
    DENSE = "dense"
    SVG = "SVG"  # SVG1: spatial/temporal online profiling + static block mask
    SAP = "SAP"  # SVG2: semantic-aware permutation (k-means) + dynamic map


class TextPosition(str, enum.Enum):
    """Where text tokens live inside the self-attention sequence: Wan and
    Cosmos cross-attend their text (NONE), HunyuanVideo appends its 256 text
    tokens (LAST), CogVideoX prepends its 226 (FIRST)."""

    NONE = "none"
    FIRST = "first"
    LAST = "last"


@dataclasses.dataclass(frozen=True)
class VideoLayout:
    """Static token layout of a video DiT self-attention sequence."""

    num_frames: int  # latent frame patches (post patchify)
    frame_size: int  # tokens per latent frame (post patchify)
    context_length: int = 0  # text tokens inside the self-attn sequence
    text_position: TextPosition = TextPosition.NONE
    prompt_length: int = 0  # actual prompt tokens (<= context_length); hyvideo

    @property
    def video_length(self) -> int:
        return self.num_frames * self.frame_size

    @property
    def seq_len(self) -> int:
        return self.context_length + self.video_length

    def __post_init__(self):
        if self.context_length == 0:
            object.__setattr__(self, "text_position", TextPosition.NONE)


@dataclasses.dataclass(frozen=True)
class WarmupSchedule:
    """Dense-attention warm-up: layers with index < first_layers and steps
    with timestep > first_times (0..1000 flow timestep) run dense attention.
    `from_fractions` turns the CLI's --first_layers_fp / --first_times_fp
    into these, as the reference's entry scripts do."""

    first_layers: int = 0
    first_times: float = 1001.0  # timestep > this => dense. 1001 disables.

    @staticmethod
    def from_fractions(first_layers_fp: float, first_times_fp: float, num_layers: int,
                       timesteps) -> "WarmupSchedule":
        num_steps = len(timesteps)
        num_fp_timesteps = math.floor(first_times_fp * num_steps)
        num_fp_layers = math.floor(first_layers_fp * num_layers)
        if num_fp_timesteps > 0:
            first_times = float(timesteps[num_fp_timesteps - 1]) - 1.0
        else:
            first_times = 1001.0
        return WarmupSchedule(first_layers=num_fp_layers, first_times=first_times)

    def is_dense_layer(self, layer_idx: int) -> bool:
        return layer_idx < self.first_layers


@dataclasses.dataclass(frozen=True)
class SVGConfig:
    """SVG1 knobs (the reference's CLI flags)."""

    num_sampled_rows: int = 64
    sample_mse_max_row: int = 10000
    sparsity: float = 0.25
    block_size: int = 128  # block granularity of the sliding-window mask
    profile_block_size: int = 128  # block size of the emulated profiling masks
    profile_multiplier: float = 2.0  # profiling masks' band, in frames


@dataclasses.dataclass(frozen=True)
class SAPConfig:
    """SVG2 / semantic-aware-permutation knobs (the reference's CLI flags,
    plus the JAX package's block sizes and options; see its config.py for
    the measurements behind each default)."""

    num_q_centroids: int = 50
    num_k_centroids: int = 200
    top_p_kmeans: float = 0.9
    min_kc_ratio: float = 0.0
    kmeans_iter_init: int = 50
    kmeans_iter_step: int = 2
    zero_step_kmeans_init: bool = False
    kmeans_metric: str = "euclid"
    block_q: int = 256
    block_kv: int = 1024
    max_runs: int | None = None
    qsplit: int | None = None
    relabel: str = "auto"
    force_density: float | None = None
    block_mode: str = "cluster"
    tile_grain: int | None = None
    tile_order: str = "kmeans"

    @property
    def run_qsplit(self) -> int:
        return 1 if self.qsplit is None else self.qsplit
