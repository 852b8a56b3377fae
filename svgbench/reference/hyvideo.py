"""HunyuanVideo T2V DiT, HYVideo-T/2-cfgdistill (tencent/HunyuanVideo; Kong et
al., "HunyuanVideo: A Systematic Framework For Large Video Generative
Models", 2024), in plain PyTorch, float32, and the first flow-match Euler
step.

The conditioning vector is the timestep MLP plus an MLP of the pooled CLIP-L
state plus the embedded-guidance MLP (sinusoids [cos | sin] of t and of
guidance x 1000). The LLaMA states pass the token refiner: its own timestep
MLP plus an MLP of the masked mean of the text, then pre-LN blocks with
gated self-attention over the text (live rows and columns; column 0 always
attended, as the release does) and a SiLU MLP. Double-stream blocks
modulate, project and qk-RMSNorm (per head) the video and the text with
their own weights, rotate the video's q and k (3-D RoPE, interleaved pairs,
head dims 16/56/56), attend jointly over [video | text] and apply gated
projections and GELU(tanh) MLPs per stream. Single-stream blocks do the
same on one stream with one input projection (qkv and MLP) and one output
projection (attention and MLP). The joint self-attention is the caller's
`self_attn(layer, q, k, v)` (double blocks first).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from svgbench.reference import common as C


def grid(cfg: dict) -> tuple:
    pt, ph, pw = cfg["patch_size"]
    f = (1 + (cfg["num_frames"] - 1) // 4) // pt
    return f, cfg["height"] // (8 * ph), cfg["width"] // (8 * pw)


def _temb(x: float, device):
    """(1, 256) sinusoid [cos | sin], freqs exp(-ln(10000) i / 128), in f64 then f32."""
    half = 128
    freqs = np.exp(-math.log(10000.0) * np.arange(half, dtype=np.float64) / half)
    a = float(x) * freqs
    return torch.as_tensor(np.concatenate([np.cos(a), np.sin(a)])[None], dtype=torch.float32, device=device)


def forward(P: dict, cfg: dict, x, t: float, txt, mask, pooled, guidance: float, self_attn, prec: str = "f32"):
    """x (C, F, H, W) f32; txt (text_len, 4096) f32; mask (text_len,) 1/0;
    pooled (768,) f32 -> the f32 velocity (C, F, H, W)."""
    h, H = cfg["hidden_size"], cfg["heads_num"]
    D = h // H
    eps = cfg["eps"]
    dev = x.device
    lin = lambda y, n: C.linear(y, P[n + ".weight"], P.get(n + ".bias"), prec)
    st = lambda y: C.store(y, prec)  # where the program keeps a bf16 tensor
    mlp = lambda y, n, act=F.silu: lin(st(act(lin(y, n + ".fc1"))), n + ".fc2")
    # the conditioning MLPs run in f32 in the program (from f32 sinusoids): exact here too
    lin32 = lambda y, n: C.linear(y, P[n + ".weight"], P[n + ".bias"], "f32")
    mlp32 = lambda y, n: lin32(F.silu(lin32(y, n + ".fc1")), n + ".fc2")
    heads = lambda y: y.reshape(y.shape[0], H, D).transpose(0, 1)
    merge = lambda y: y.transpose(0, 1).reshape(-1, h)
    mod = lambda y, shift, scale: st(C.layer_norm(y, eps) * (1 + scale) + shift)

    vec = mlp32(_temb(t, dev), "time_in") + mlp32(pooled[None], "vector_in") \
        + mlp32(_temb(guidance, dev), "guidance_in")
    pt, ph, pw = cfg["patch_size"]
    Cin, F_, Hh, Ww = x.shape
    g = (F_ // pt, Hh // ph, Ww // pw)
    img = x.reshape(Cin, g[0], pt, g[1], ph, g[2], pw).permute(1, 3, 5, 0, 2, 4, 6).reshape(math.prod(g), -1)
    img = lin(st(img), "img_in")

    # token refiner
    live = mask.bool()
    m = live.float()[:, None]
    c = mlp32(_temb(t, dev), "txt_in.t_embedder") + mlp32(((txt * m).sum(0) / m.sum().clamp_min(1.0))[None],
                                                         "txt_in.c_embedder")
    tx = lin(st(txt), "txt_in.input_embedder")
    allow = lambda q, k: (live[q] & live[k]) | (k == 0)
    for i in range(cfg["refiner_depth"]):
        b = f"txt_in.blocks.{i}."
        g_msa, g_mlp = lin32(F.silu(c), b + "adaln").chunk(2, dim=-1)
        y = st(C.layer_norm(tx, eps, P[b + "norm1.weight"], P[b + "norm1.bias"]))
        q, k, v = (heads(z) for z in lin(y, b + "qkv").chunk(3, dim=-1))
        tx = tx + lin(merge(C.attention(q, k, v, allow, prec)), b + "proj") * g_msa
        y = st(C.layer_norm(tx, eps, P[b + "norm2.weight"], P[b + "norm2.bias"]))
        tx = tx + mlp(y, b + "mlp") * g_mlp
    tx = st(tx)

    ang = C.rope_angles(g, tuple(cfg["rope_dim_list"]))
    cos = torch.as_tensor(np.cos(ang), dtype=torch.float32, device=dev)
    sin = torch.as_tensor(np.sin(ang), dtype=torch.float32, device=dev)
    n_img = img.shape[0]
    svec = st(F.silu(st(vec)))
    li = 0
    for i in range(cfg["mm_double_blocks_depth"]):
        b = f"double_blocks.{i}."
        qs, ks, vs, mods = [], [], [], {}
        for s, z in (("img", img), ("txt", tx)):
            mods[s] = lin(svec, b + f"{s}_mod").chunk(6, dim=-1)
            q, k, v = (heads(u) for u in lin(mod(z, mods[s][0], mods[s][1]), b + f"{s}_qkv").chunk(3, dim=-1))
            q, k = st(C.rms_norm(q, P[b + f"{s}_q_norm"], eps)), st(C.rms_norm(k, P[b + f"{s}_k_norm"], eps))
            if s == "img":
                q, k = st(C.rope_interleaved(q, cos, sin)), st(C.rope_interleaved(k, cos, sin))
            qs.append(q), ks.append(k), vs.append(v)
        o = merge(self_attn(li, torch.cat(qs, 1), torch.cat(ks, 1), torch.cat(vs, 1)))
        li += 1
        out = []
        for s, z, a in (("img", img, o[:n_img]), ("txt", tx, o[n_img:])):
            g1, s2, c2, g2 = mods[s][2], mods[s][3], mods[s][4], mods[s][5]
            z = st(z + lin(a, b + f"{s}_proj") * g1)
            out.append(st(z + mlp(mod(z, s2, c2), b + f"{s}_mlp", C.gelu_tanh) * g2))
        img, tx = out
        del qs, ks, vs, o
    xx = torch.cat([img, tx])
    for i in range(cfg["mm_single_blocks_depth"]):
        b = f"single_blocks.{i}."
        shift, scale, gate = lin(svec, b + "modulation").chunk(3, dim=-1)
        y = mod(xx, shift, scale)
        y1 = lin(y, b + "linear1")
        q, k, v = (heads(u) for u in y1[:, :3 * h].chunk(3, dim=-1))
        q, k = st(C.rms_norm(q, P[b + "q_norm"], eps)), st(C.rms_norm(k, P[b + "k_norm"], eps))
        q = torch.cat([st(C.rope_interleaved(q[:, :n_img], cos, sin)), q[:, n_img:]], 1)
        k = torch.cat([st(C.rope_interleaved(k[:, :n_img], cos, sin)), k[:, n_img:]], 1)
        o = merge(self_attn(li, q, k, v))
        li += 1
        xx = st(xx + lin(torch.cat([o, st(C.gelu_tanh(y1[:, 3 * h:]))], dim=-1), b + "linear2") * gate)
        del q, k, v, o, y1, y
    shift, scale = lin(svec, "final_adaln").chunk(2, dim=-1)
    out = lin(mod(xx[:n_img], shift, scale), "final_linear")
    co = cfg["out_channels"]
    out = out.reshape(*g, co, pt, ph, pw).permute(3, 0, 4, 1, 5, 2, 6)
    return out.reshape(co, g[0] * pt, g[1] * ph, g[2] * pw)


def euler_first_step(num_steps: int, shift: float, x, v):
    """x_1 = x_0 + (sigma_1 - sigma_0) v, sigmas shift s / (1 + (shift - 1) s)
    over s = linspace(1, 0, num_steps + 1)."""
    s = np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float64)
    s = shift * s / (1 + (shift - 1) * s)
    return x + float(s[1] - s[0]) * v


def timestep0(num_steps: int, shift: float) -> float:
    return float(np.float32(1000.0))
