"""SVG1 per-head layout transform (counterpart of
sparse_videogen_tpu/core/placement.py::temporal_transpose).

The temporal re-layout is a (num_frames, frame_size) matrix transpose of
the video tokens; text tokens before them (CogVideoX) or after them
(HunyuanVideo) stay in place.
"""

from __future__ import annotations

import torch

from sparse_videogen_tpu_torch.config import VideoLayout
from sparse_videogen_tpu_torch.core.masks import video_start


def temporal_transpose(x, layout: VideoLayout, *, inverse: bool = False):
    """x (..., S, D) -> x[..., temporal_index_map(layout), :] (inverse: the
    inverse map), as reshape + transpose of the video segment."""
    nf, fs, vid = layout.num_frames, layout.frame_size, layout.video_length
    vs = video_start(layout)
    lead, (S, D) = x.shape[:-2], x.shape[-2:]
    a, b = (fs, nf) if inverse else (nf, fs)
    xv = x[..., vs:vs + vid, :].reshape(*lead, a, b, D).transpose(-3, -2).reshape(*lead, vid, D)
    parts = [p for p in (x[..., :vs, :], xv, x[..., vs + vid:, :]) if p.shape[-2]]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def place_heads(x, is_temporal, layout: VideoLayout, *, inverse: bool = False):
    """Per-head select: temporal heads (is_temporal (B, H) bool) get the
    re-layout, spatial heads pass through."""
    return torch.where(is_temporal[..., None, None], temporal_transpose(x, layout, inverse=inverse), x)
