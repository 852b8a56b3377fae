"""SVG1 per-head layout transform (counterpart of
sparse_videogen_tpu/core/placement.py::temporal_transpose).

On a video-only sequence the temporal re-layout is a (num_frames,
frame_size) matrix transpose.
"""

from __future__ import annotations

import torch

from sparse_videogen_tpu_torch.config import VideoLayout


def temporal_transpose(x, layout: VideoLayout, *, inverse: bool = False):
    """x (..., S, D) -> x[..., temporal_index_map(layout), :] (inverse: the
    inverse map), as reshape + transpose."""
    nf, fs = layout.num_frames, layout.frame_size
    lead, (S, D) = x.shape[:-2], x.shape[-2:]
    a, b = (fs, nf) if inverse else (nf, fs)
    return x.reshape(*lead, a, b, D).transpose(-3, -2).reshape(*lead, S, D)


def place_heads(x, is_temporal, layout: VideoLayout, *, inverse: bool = False):
    """Per-head select: temporal heads (is_temporal (B, H) bool) get the
    re-layout, spatial heads pass through."""
    return torch.where(is_temporal[..., None, None], temporal_transpose(x, layout, inverse=inverse), x)
