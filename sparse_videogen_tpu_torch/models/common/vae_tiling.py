"""Spatially tiled VAE decode (counterpart of
sparse_videogen_tpu/models/common/vae_tiling.py; the reference's
`pipe.vae.enable_tiling()`).

Every tile has the same latent shape (edge tiles slide back instead of
shrinking), and the overlaps blend by weighted accumulation with separable
linear ramps (value += w * tile; weight += w; out = value / weight). A tile
sees zero padding at its borders instead of its neighbours, as in diffusers'
tiling: the ramp hides the seam, so the result is close to the whole
decode, not equal to it.
"""

from __future__ import annotations

import numpy as np
import torch


def _starts(size: int, tile: int, stride: int):
    """Clamped tile starts covering [0, size) with a fixed tile size."""
    if size <= tile:
        return [0]
    s = list(range(0, size - tile, stride))
    s.append(size - tile)
    return s


def _ramp_weight(n: int, ov: int, has_before: bool, has_after: bool):
    """Separable 1-D blend weight of a tile edge: a linear ramp over the
    ov-pixel overlap on sides with a neighbouring tile, 1 elsewhere."""
    w = np.ones((n,), np.float32)
    ov = min(ov, n)
    if ov > 0:
        ramp = (np.arange(1, ov + 1, dtype=np.float32)) / (ov + 1)
        if has_before:
            w[:ov] = ramp
        if has_after:
            w[n - ov:] = ramp[::-1]
    return w


def spatial_tiled_decode(decode_fn, z, *, tile: int = 32, overlap: int = 8, scale: int = 8):
    """Decode latents z (B, C, T, h, w) through decode_fn ((B, C, T, th, tw)
    -> (B, 3, T', th * scale, tw * scale)) tile by tile: tiles of `tile`
    latents a side, `overlap` latents blended between neighbours."""
    B, C, T, h, w = z.shape
    th, tw = min(int(tile), h), min(int(tile), w)
    ys = _starts(h, th, max(th - overlap, 1))
    xs = _starts(w, tw, max(tw - overlap, 1))
    if len(ys) == 1 and len(xs) == 1:
        return decode_fn(z)
    ov_px = overlap * scale
    out = wsum = None
    for yi, y0 in enumerate(ys):
        wy = _ramp_weight(th * scale, ov_px, yi > 0, yi < len(ys) - 1)
        for xi, x0 in enumerate(xs):
            wx = _ramp_weight(tw * scale, ov_px, xi > 0, xi < len(xs) - 1)
            v = decode_fn(z[:, :, :, y0:y0 + th, x0:x0 + tw])
            if out is None:
                out = torch.zeros((B, v.shape[1], v.shape[2], h * scale, w * scale), dtype=v.dtype, device=v.device)
                wsum = torch.zeros((h * scale, w * scale), dtype=torch.float32, device=v.device)
            wt2 = torch.as_tensor(wy[:, None] * wx[None, :], device=v.device)
            rows, cols = slice(y0 * scale, (y0 + th) * scale), slice(x0 * scale, (x0 + tw) * scale)
            out[:, :, :, rows, cols] += v * wt2.to(v.dtype)
            wsum[rows, cols] += wt2
    return out / wsum.to(out.dtype).clamp_min(1e-6)
