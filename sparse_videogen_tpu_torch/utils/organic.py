"""Organic-density synthetic inputs for SAP (counterpart of
sparse_videogen_tpu/utils/organic.py).

With random weights and i.i.d. latents the DiT's q and k are unstructured,
SAP's centroid attention is flat, and its top_p map keeps ~0.87 of the
scores, where real video keeps 0.1-0.3. These make the attention video-like
while every measured computation (k-means, the top_p map, the
permutation, the kernels) stays the real one:

1. `align_self_attn_qk` (Wan) and `align_fused_qkv` (HunyuanVideo's fused
   projections) set every self-attention K projection equal to its Q
   projection, so the logits become a positive-semidefinite kernel: a token
   attends most to tokens whose features resemble its own. `gain` scales
   the q RMS-norm weight (a softmax temperature).
2. `smooth_latents` replaces i.i.d. latent noise with a low-pass field (a
   low-resolution normal field upsampled trilinearly, unit variance):
   nearby tokens get similar features, so k-means finds real clusters.

The density is measured (SAP's density log), not chosen. Both align
functions change the model in place, under no_grad, and return it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_FUSED = ("qkv", "img_qkv", "txt_qkv", "linear1")


@torch.no_grad()
def align_self_attn_qk(model: nn.Module, gain: float = 1.0, key: str = "self_attn") -> nn.Module:
    """Every submodule named `key` with linears `q` and `k` gets k := q
    (weight and bias) and its `norm_q` weight scaled by gain."""
    for name, mod in model.named_modules():
        q, k = getattr(mod, "q", None), getattr(mod, "k", None)
        if name.rsplit(".", 1)[-1] != key or not (isinstance(q, nn.Linear) and isinstance(k, nn.Linear)):
            continue
        k.weight.copy_(q.weight)
        if q.bias is not None:
            k.bias.copy_(q.bias)
        if gain != 1.0 and isinstance(getattr(mod, "norm_q", None), torch.Tensor):
            mod.norm_q.mul_(gain)
    return model


@torch.no_grad()
def align_fused_qkv(model: nn.Module, hidden: int, gain: float = 1.0) -> nn.Module:
    """The fused-projection form: in every linear named qkv, img_qkv, txt_qkv
    (outputs [q | k | v]) or linear1 (outputs [q | k | v | mlp]) the k
    outputs [hidden, 2 hidden) get the q outputs' weight rows and bias, and
    every parameter whose name ends in q_norm is scaled by gain."""
    for mod in model.modules():
        for name, lin in mod.named_children():
            if name in _FUSED and isinstance(lin, nn.Linear):
                lin.weight[hidden:2 * hidden] = lin.weight[:hidden]
                if lin.bias is not None:
                    lin.bias[hidden:2 * hidden] = lin.bias[:hidden]
    if gain != 1.0:
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1].endswith("q_norm"):
                p.mul_(gain)
    return model


def smooth_field(low: torch.Tensor, shape, dtype=torch.bfloat16) -> torch.Tensor:
    """A low-resolution f32 field (B, C, f, h, w) upsampled trilinearly to
    shape (B, C, F, H, W) (half-pixel centres, the edge values held past the
    outer sample centres) and scaled to unit (population) variance."""
    up = F.interpolate(low.float(), size=tuple(shape[2:]), mode="trilinear", align_corners=False)
    return (up / up.std(correction=0).clamp_min(1e-6)).to(dtype)


def smooth_latents(generator: torch.Generator, shape, factors=(3, 6, 6), dtype=torch.bfloat16) -> torch.Tensor:
    """Low-pass latent noise (B, C, F, H, W) on the generator's device: a
    normal field of ceil(F / f_F) x ceil(H / f_H) x ceil(W / f_W) drawn from
    `generator`, through smooth_field."""
    B, C, F_, H, W = shape
    f_f, f_h, f_w = factors
    low_shape = (B, C, max(1, -(-F_ // f_f)), max(1, -(-H // f_h)), max(1, -(-W // f_w)))
    low = torch.randn(low_shape, generator=generator, device=generator.device, dtype=torch.float32)
    return smooth_field(low, shape, dtype)
