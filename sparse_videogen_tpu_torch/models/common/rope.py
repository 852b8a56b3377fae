"""3-D rotary embeddings for video DiTs (counterpart of
sparse_videogen_tpu/models/common/rope.py).

The cos/sin tables are built in f64 numpy and stored f32; the rotation runs
in f32 with output in the input dtype. For Wan's D = 128 the (t, h, w) split
is (44, 42, 42).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from sparse_videogen_tpu_torch.ops.rope import rope_apply


def _axis_freqs(n_pos: int, dim: int, theta: float = 10000.0) -> np.ndarray:
    """(n_pos, dim/2) rotation angles, f64."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    return np.outer(np.arange(n_pos, dtype=np.float64), inv)


@lru_cache(maxsize=16)
def nd_rope_cos_sin(sizes: tuple, dims: tuple):
    """cos/sin (prod(sizes), sum(dims)//2) f32 numpy for per-axis rotary dims."""
    n = len(sizes)
    parts = []
    for ax, (sz, dim) in enumerate(zip(sizes, dims)):
        ang = _axis_freqs(sz, dim)
        shape = [1] * n + [dim // 2]
        shape[ax] = sz
        parts.append(np.broadcast_to(ang.reshape(shape), tuple(sizes) + (dim // 2,)))
    ang = np.concatenate(parts, axis=-1).reshape(int(np.prod(sizes)), -1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def wan_rope_cos_sin(f: int, h: int, w: int, head_dim: int):
    """cos/sin (f*h*w, head_dim//2) f32 numpy; split (d-4(d//6), 2(d//6), 2(d//6))."""
    d = head_dim
    dt = d - 4 * (d // 6)
    dh = dw = 2 * (d // 6)
    return nd_rope_cos_sin((f, h, w), (dt, dh, dw))


def apply_rope_interleaved(x, cos, sin):
    """x (B, H, S, D); cos/sin (S, D/2) f32 tensors on x's device.

    out[2i] = x[2i]*cos_i - x[2i+1]*sin_i; out[2i+1] = x[2i]*sin_i + x[2i+1]*cos_i.
    CUDA tensors always go through the Hopper kernel (ops/rope.py)."""
    B, H, S, D = x.shape
    return rope_apply(x.reshape(B * H, S, D).contiguous(), cos, sin).reshape(B, H, S, D)
