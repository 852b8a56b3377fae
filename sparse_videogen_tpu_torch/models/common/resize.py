"""Separable cubic and bilinear resizes with jax.image.resize's rule.

The JAX package resizes images with `jax.image.resize(..., "cubic")` (the
CLIP preprocessing, 480x832 down to 224x224, and the I2V CLI's fit of the
image to the generation's size) and `"bilinear"` (the CogVideoX CLI's fit
of the image to 768x1360). Its weights (jax/_src/image/scale.py,
compute_weight_mat) are:
  - the Keys cubic kernel with a = -0.5, or the triangle max(0, 1 - |x|);
  - antialiasing on: when downsampling, the kernel is widened by 1 / scale;
  - each output sample's weights divided by their sum (taps outside the
    image are dropped, not clamped), and a sample whose sum is below
    1000 * eps(f32) gets none;
  - weight 0 for a sample whose position lies outside the image;
  - an axis whose size does not change is left as it is.
JAX computes the weights in f32 from the inverse scale in / out, divided in
f64 and rounded once to f32 (jax.image.resize hands the scale over as a
Python float; an f32 1 / f32(out / in) is an ulp off and, at 832 -> 1360,
moves bilinear weights by 1.2e-4), and so does this module, step by step: at 832 -> 1264 an f64 computation moves the
sample positions by up to ~1e-4 pixel from JAX's and the output by ~1e-4.
XLA fuses the sample position (j + 0.5) * (1 / scale) - 0.5 into one
multiply-add, rounded once; so is it here (in f64, then rounded to f32),
which brings the weights within ~6e-7 of XLA's (a plain f32 product and
difference, rounded twice, lands an ulp of the position away: ~2e-5).
F.interpolate(mode="bicubic") is another function (a = -0.75, clamped
edges, no antialias), and so is its bilinear mode (no antialias), so this
module builds the weight matrices in numpy and applies them as two f32
matmuls.
"""

from __future__ import annotations

import numpy as np
import torch


F32 = np.float32


def keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel (a = -0.5) at |x|, in x's dtype."""
    out = ((F32(1.5) * x - F32(2.5)) * x) * x + F32(1.0)
    out = np.where(x >= 1.0, ((F32(-0.5) * x + F32(2.5)) * x - F32(4.0)) * x + F32(2.0), out)
    return np.where(x >= 2.0, F32(0.0), out).astype(x.dtype)


def triangle(x: np.ndarray) -> np.ndarray:
    """The linear kernel max(0, 1 - |x|), in x's dtype."""
    return np.maximum(F32(0.0), F32(1.0) - np.abs(x)).astype(x.dtype)


def resize_weights(n_in: int, n_out: int, kernel) -> np.ndarray:
    """(n_in, n_out) f32 weights of `kernel`: output j = sum_i x[i] w[i, j]."""
    inv_scale = F32(n_in / n_out)
    kernel_scale = max(inv_scale, F32(1.0))
    sample = ((np.arange(n_out, dtype=F32) + F32(0.5)).astype(np.float64) * np.float64(inv_scale) - 0.5).astype(F32)
    w = kernel(np.abs(sample[None, :] - np.arange(n_in, dtype=F32)[:, None]) / kernel_scale)
    total = w.sum(axis=0, keepdims=True, dtype=F32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(F32).eps), w / np.where(total != 0, total, F32(1)), F32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, F32(0)).astype(F32)


def cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    return resize_weights(n_in, n_out, keys_cubic)


def _resize(x: torch.Tensor, height: int, width: int, kernel) -> torch.Tensor:
    y = x.float()
    if y.shape[-2] != height:
        wh = torch.as_tensor(resize_weights(y.shape[-2], height, kernel), device=y.device)
        y = torch.einsum("...hw,hk->...kw", y, wh)
    if y.shape[-1] != width:
        ww = torch.as_tensor(resize_weights(y.shape[-1], width, kernel), device=y.device)
        y = y @ ww
    return y


def resize_cubic(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """x (..., H, W) -> (..., height, width) in f32, on x's device."""
    return _resize(x, height, width, keys_cubic)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """jax.image.resize(x, ..., "bilinear"): x (..., H, W) -> (..., height,
    width) in f32, on x's device."""
    return _resize(x, height, width, triangle)
