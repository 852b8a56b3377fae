"""Shared layers with the reference's mixed-precision contract (counterpart of
sparse_videogen_tpu/models/common/layers.py): norms and modulation in f32,
linears in the activation dtype; the quantized linears of utils/quant.py
(int8 W8A8, fp8 weight-only) dispatch on the module type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sparse_videogen_tpu_torch.utils.quant import FP8Linear, Int8Linear, int8_matmul


def quantize_per_token(x):
    """(codes, scales): per-token scales s = max(|x|) / 127 (at least
    1e-8 / 127) in f32 and int8 codes round(x / s) (half to even) clipped to
    +-127, as the JAX package quantizes a linear's input."""
    # max |x| in x's dtype is exact, and x / s promotes x to f32 exactly:
    # the f32 values of the JAX package's computation, in fewer passes
    s = x.abs().amax(-1, keepdim=True).float().clamp_min(1e-8) / 127.0
    return torch.div(x, s).round_().clamp_(-127, 127).to(torch.int8), s


def rescale(y, s, wscale, bias, dtype):
    """The int32 product back to `dtype`: ((y * s) * wscale) cast, then the
    bias added after the cast."""
    y = torch.mul(y, s).mul_(wscale).to(dtype)
    return y if bias is None else y + bias.to(dtype)


def int8_linear(x, wi8, wscale, bias=None):
    """W8A8 as the JAX package computes it: quantize_per_token, the exact
    int32 product with wi8 (N, K), rescale."""
    xi, s = quantize_per_token(x)
    y = int8_matmul(xi.reshape(-1, x.shape[-1]), wi8).reshape(*x.shape[:-1], wi8.shape[0])
    return rescale(y, s, wscale, bias, x.dtype)


def fp8_weight(w8, scale, dtype):
    """e4m3 codes times their scale, both cast to dtype first and the product
    rounded in dtype, as the JAX package upcasts."""
    return w8.to(dtype) * scale.to(dtype)


def linear(mod, x):
    """x @ W^T + b with W and b cast to x.dtype; an Int8Linear runs W8A8
    (int8_linear), an FP8Linear upcasts its codes (fp8_weight)."""
    b = None if mod.bias is None else mod.bias.to(x.dtype)
    if isinstance(mod, Int8Linear):
        return int8_linear(x, mod.wi8, mod.wscale, mod.bias)
    w = fp8_weight(mod.w8, mod.scale, x.dtype) if isinstance(mod, FP8Linear) else mod.weight.to(x.dtype)
    return F.linear(x, w, b)


def linear_slice(mod, x, *, cols=None, rows=None, bias: bool = True):
    """`linear` on a slice of mod's weight: output columns `cols` (a slice;
    the bias and int8 wscale sliced with them) or input rows `rows` (one
    partial product of a concatenated input: the int8 path quantizes x, the
    slice's own input, per token; the scales pass whole). bias=False drops
    the bias (the second part of a row-sliced sum). The fp8 scale is one
    per tensor."""
    cols = slice(None) if cols is None else cols
    rows = slice(None) if rows is None else rows
    b = mod.bias[cols] if bias and mod.bias is not None else None
    if isinstance(mod, Int8Linear):
        return int8_linear(x, mod.wi8[cols, rows], mod.wscale[cols], b)
    if isinstance(mod, FP8Linear):
        w = fp8_weight(mod.w8[cols, rows], mod.scale, x.dtype)
    else:
        w = mod.weight[cols, rows].to(x.dtype)
    return F.linear(x, w, None if b is None else b.to(x.dtype))


def rms_norm(x, weight, eps=1e-5):
    """WanRMSNorm: normalise in f32, cast back, then scale in x.dtype."""
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return n.to(x.dtype) * weight.to(x.dtype)


def layer_norm_f32(x, eps=1e-6, weight=None, bias=None):
    """WanLayerNorm: normalise in f32, return f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def silu(x):
    return F.silu(x)


def mlp_gelu(fc1: torch.nn.Linear, fc2: torch.nn.Linear, x):
    """Linear -> GELU(tanh) -> Linear."""
    return linear(fc2, gelu_tanh(linear(fc1, x)))
