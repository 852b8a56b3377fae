"""Wan 2.1 T2V DiT (Wan-AI/Wan2.1-T2V-1.3B; Wan team, "Wan: Open and Advanced
Large-Scale Video Generative Models", 2025) in plain PyTorch, float32, one
video at a time, and the first UniPC step of flow matching with CFG.

The block: AdaLN from six modulation vectors (table + time projection);
self-attention with qk RMSNorm over the whole width and 3-D RoPE on
interleaved pairs (head-dim split t/h/w = d - 4(d//6), 2(d//6), 2(d//6));
cross-attention to the text with qk RMSNorm; LayerNorm with affine before
it; a GELU(tanh) FFN; gated residuals. The self-attention itself is the
caller's `self_attn(layer, q, k, v)`, so that the judge can give it the
pattern (dense or SVG1) and read each layer.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from svgbench.reference import common as C


def grid(cfg: dict) -> tuple:
    """(F', H', W') token grid of the configured video."""
    pt, ph, pw = cfg["patch_size"]
    f = (1 + (cfg["num_frames"] - 1) // 4) // pt
    return f, cfg["height"] // (8 * ph), cfg["width"] // (8 * pw)


def rope_cos_sin(cfg: dict, device):
    d = cfg["dim"] // cfg["num_heads"]
    dims = (d - 4 * (d // 6), 2 * (d // 6), 2 * (d // 6))
    ang = C.rope_angles(grid(cfg), dims)
    return (torch.as_tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(ang), dtype=torch.float32, device=device))


def forward(P: dict, cfg: dict, x, t: float, ctx, self_attn, prec: str = "f32"):
    """x (C, F, H, W) f32 latents, ctx (text_len, text_dim) f32 -> the f32
    velocity (C, F, H, W). P: the parameters by the port's names, f32."""
    d, H = cfg["dim"], cfg["num_heads"]
    D = d // H
    eps = cfg["eps"]
    pt, ph, pw = cfg["patch_size"]
    Cin, F_, Hh, Ww = x.shape
    g = (F_ // pt, Hh // ph, Ww // pw)
    lin = lambda y, name: C.linear(y, P[name + ".weight"], P.get(name + ".bias"), prec)
    st = lambda y: C.store(y, prec)  # where the program keeps a bf16 tensor

    tok = x.reshape(Cin, g[0], pt, g[1], ph, g[2], pw).permute(1, 3, 5, 0, 2, 4, 6).reshape(math.prod(g), -1)
    tok = lin(st(tok), "patch_embedding")
    e = C.timestep_embedding(t, cfg["freq_dim"], x.device)
    # the time embedding and projection are f32 in the program: exact here too
    lin32 = lambda y, name: C.linear(y, P[name + ".weight"], P[name + ".bias"], "f32")
    e = lin32(torch.nn.functional.silu(lin32(e, "time_embedding.fc1")), "time_embedding.fc2")
    e6 = lin32(torch.nn.functional.silu(e), "time_projection").reshape(6, d)
    c = lin(st(C.gelu_tanh(lin(st(ctx), "text_embedding.fc1"))), "text_embedding.fc2")
    cos, sin = rope_cos_sin(cfg, x.device)
    heads = lambda y: y.reshape(y.shape[0], H, D).transpose(0, 1)
    merge = lambda y: y.transpose(0, 1).reshape(-1, d)

    for li in range(cfg["num_layers"]):
        b = f"blocks.{li}."
        m = P[b + "modulation"] + e6
        y = st(C.layer_norm(tok, eps) * (1 + m[1]) + m[0])
        qk = [st(C.rope_interleaved(heads(st(C.rms_norm(lin(y, b + f"self_attn.{n}"), P[b + f"self_attn.norm_{n}"],
                                                          eps))), cos, sin)) for n in "qk"]
        v = heads(lin(y, b + "self_attn.v"))
        o = self_attn(li, qk[0], qk[1], v)
        tok = st(tok + lin(merge(o), b + "self_attn.o") * m[2])
        y = st(C.layer_norm(tok, eps, P[b + "norm3.weight"], P[b + "norm3.bias"]))
        q = heads(st(C.rms_norm(lin(y, b + "cross_attn.q"), P[b + "cross_attn.norm_q"], eps)))
        k = heads(st(C.rms_norm(lin(c, b + "cross_attn.k"), P[b + "cross_attn.norm_k"], eps)))
        o = C.attention(q, k, heads(lin(c, b + "cross_attn.v")), None, prec)
        tok = st(tok + lin(merge(o), b + "cross_attn.o"))
        y = st(C.layer_norm(tok, eps) * (1 + m[4]) + m[3])
        tok = st(tok + lin(st(C.gelu_tanh(lin(y, b + "ffn.fc1"))), b + "ffn.fc2") * m[5])
        del qk, q, k, v, o, y

    hm = P["head_modulation"] + e
    out = lin(st(C.layer_norm(tok, eps) * (1 + hm[1]) + hm[0]), "head_out")
    co = cfg["out_dim"]
    out = out.reshape(*g, pt, ph, pw, co).permute(6, 0, 3, 1, 4, 2, 5)
    return out.reshape(co, g[0] * pt, g[1] * ph, g[2] * pw)


def unipc_first_step(num_steps: int, shift: float, x, v):
    """UniPC (bh2) step 0 of flow matching from sample x with velocity v:
    x0 = x - sigma_0 v, x_1 = (sigma_1 / sigma_0) x - (1 - sigma_1)
    expm1(-h) x0, h = lambda_1 - lambda_0, lambda = log((1 - sigma) /
    sigma). The sigmas are the sampler's: the shifted linear schedule of
    1000 training steps, its endpoints shifted once more when the step
    count is set (as the Wan release computes them)."""
    n_train = 1000
    alphas = np.linspace(1, 1 / n_train, n_train, dtype=np.float64)[::-1]
    base = shift * (1 - alphas) / (1 + (shift - 1) * (1 - alphas))
    s_raw = np.linspace(base[0], base[-1], num_steps + 1, dtype=np.float64)[:-1]
    sig = shift * s_raw / (1 + (shift - 1) * s_raw)
    s0, s1 = sig[0], sig[1]
    lam = lambda s: np.log(1 - s) - np.log(s)
    a = float(np.float32(s1 / s0))
    b = float(np.float32((1 - s1) * np.expm1(-(lam(s1) - lam(s0)))))
    x0 = x - float(np.float32(s0)) * v
    return a * x - b * x0


def timestep0(num_steps: int, shift: float) -> float:
    """The sampler's first timestep (sigma_0 * 1000)."""
    n_train = 1000
    alphas = np.linspace(1, 1 / n_train, n_train, dtype=np.float64)[::-1]
    base = shift * (1 - alphas) / (1 + (shift - 1) * (1 - alphas))
    s = base[0]
    return float(shift * s / (1 + (shift - 1) * s) * n_train)
