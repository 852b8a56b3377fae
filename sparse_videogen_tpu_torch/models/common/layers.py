"""Shared layers with the reference's mixed-precision contract (counterpart of
sparse_videogen_tpu/models/common/layers.py, unquantised linears only):
norms and modulation in f32, linears in the activation dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(mod: torch.nn.Linear, x):
    """x @ W^T + b with W and b cast to x.dtype."""
    b = None if mod.bias is None else mod.bias.to(x.dtype)
    return F.linear(x, mod.weight.to(x.dtype), b)


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
