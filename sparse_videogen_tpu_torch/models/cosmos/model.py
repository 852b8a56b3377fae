"""Cosmos-1.0-Diffusion Text2World DiT, 7B and 14B (counterpart of
sparse_videogen_tpu/models/cosmos/model.py).

The tokens are the video's alone (no text in the self-attention: a
video-only layout, mask kinds none and band_sink). Each block: the learned
position embedding (per-axis T, H, W tables summed and RMS-normalised) added
to the residual, then three AdaLN-LoRA norms (self-attention, cross-attention,
FFN), each a parameter-free f32 LayerNorm modulated by shift and scale and
closed by a gate, where (shift, scale, gate) is a low-rank projection of
silu(the RMS-normed timestep sinusoid) plus the global time embedding.
Self-attention: bias-free q, k, v, a per-head RMSNorm on q and k before a
3-D half-split RoPE (f32; head_dim split [t | h | w] = 44 | 42 | 42 at 128,
NTK-scaled by rope_scale), through the injected runtime (sparse/runtimes.py:
K1 on the card). Cross-attention to the T5 states: q and k RMS-normed, f32
softmax of q k^T / sqrt(D), unmasked. The FFN is exact GELU. The input gets
a zero padding-mask channel (17 channels), patches of (1, 2, 2), and the
output unfolds with the reference's (p_h, p_w, p_t, c) order.

Numerics follow the JAX package: every linear in its input's dtype with the
weights cast to it; the time embedding, AdaLN projections and norms in f32;
the modulation and gates applied in the activation dtype. The AdaLN and time
linears and the norm weights are f32 parameters inside a bf16 model, so
never cast the whole module.

Parameter names are the JAX pytree's paths, the blocks unstacked:
patch_embed, time_embed.{t_fc1, t_fc2, norm}, blocks.<i>.{norm1, norm2,
norm3}.{fc1, fc2}, blocks.<i>.{attn1, attn2}.{q, k, v, o, norm_q, norm_k},
blocks.<i>.{ff1, ff2}, norm_out.{fc1, fc2}, proj_out, pos_embed.{t, h, w}
(io/checkpoint.convert_cosmos_dit maps diffusers' names).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparse_videogen_tpu_torch.models.common import layers as L

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class CosmosConfig:
    in_channels: int = 16
    out_channels: int = 16
    num_attention_heads: int = 32
    attention_head_dim: int = 128
    num_layers: int = 28
    mlp_ratio: float = 4.0
    text_embed_dim: int = 1024
    adaln_lora_dim: int = 256
    max_size: tuple = (128, 240, 240)
    patch_size: tuple = (1, 2, 2)
    rope_scale: tuple = (2.0, 1.0, 1.0)
    concat_padding_mask: bool = True
    extra_pos_embed_type: str | None = "learnable"
    eps: float = 1e-6

    @property
    def hidden_size(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def patch_in_channels(self) -> int:
        return self.in_channels + (1 if self.concat_padding_mask else 0)


COSMOS_7B = CosmosConfig()
COSMOS_14B = CosmosConfig(num_attention_heads=40, num_layers=36, rope_scale=(2.0, 2.0, 2.0))


def timestep_sinusoid(t, dim: int):
    """diffusers Timesteps(flip_sin_to_cos=True, shift 0): (B,) -> (B, dim)
    f32 [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=F32, device=t.device) / half)
    emb = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


def rms_norm(x, w, eps: float = 1e-6):
    """f32 RMS norm times w (f32), cast back to x's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * w.float()).to(x.dtype)


def layer_norm_nw(x, eps: float = 1e-6):
    """f32 LayerNorm without weights, cast back to x's dtype."""
    xf = x.float()
    var, mu = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def rope_3d(cfg: CosmosConfig, grid, fps=None):
    """The 3-D NTK-scaled RoPE tables -> (cos, sin), each (S, head_dim) f32
    (numpy f64, as the JAX package builds them): head_dim split [t | h | w]
    with dim_h = dim_w = head_dim // 6 * 2, theta = 10000 scale^(dim /
    (dim - 2)) per axis, the temporal positions rescaled by 24 / fps when
    fps is given, and the [freqs | freqs] halves of the half-split form."""
    d = cfg.attention_head_dim
    dim_h = dim_w = d // 6 * 2
    dim_t = d - dim_h - dim_w
    T, H, W = grid

    def freqs(dim, scale, positions):
        theta = 10000.0 * scale ** (dim / max(dim - 2, 1))
        return np.outer(positions, 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))

    pos_t = np.arange(T, dtype=np.float64)
    if fps is not None:
        pos_t = pos_t / fps * 24.0
    st, sh, sw = cfg.rope_scale
    em = np.concatenate([
        np.broadcast_to(freqs(dim_t, st, pos_t)[:, None, None, :], (T, H, W, dim_t // 2)),
        np.broadcast_to(freqs(dim_h, sh, np.arange(H, dtype=np.float64))[None, :, None, :], (T, H, W, dim_h // 2)),
        np.broadcast_to(freqs(dim_w, sw, np.arange(W, dtype=np.float64))[None, None, :, :], (T, H, W, dim_w // 2)),
    ], axis=-1).reshape(T * H * W, d // 2)
    em2 = np.concatenate([em, em], axis=-1)
    return np.cos(em2).astype(np.float32), np.sin(em2).astype(np.float32)


def apply_rope_half(x, cos, sin):
    """x (B, H, S, D), rotate_half convention, in f32, cast back."""
    D = x.shape[-1]
    rot = torch.cat([-x[..., D // 2:], x[..., :D // 2]], dim=-1)
    return (x.float() * cos + rot.float() * sin).to(x.dtype)


class AdaLN(nn.Module):
    """The low-rank AdaLN projection: fc2(fc1(silu(embedded))), f32."""

    def __init__(self, h, rank, k, device):
        super().__init__()
        self.fc1 = nn.Linear(h, rank, bias=False, dtype=F32, device=device)
        self.fc2 = nn.Linear(rank, k * h, bias=False, dtype=F32, device=device)


def adaln(m: AdaLN, x, embedded, temb, k: int):
    """-> (modulated x, the gate (k == 3) or None)."""
    e = L.linear(m.fc2, L.linear(m.fc1, F.silu(embedded.float())))
    e = e + temb[..., :e.shape[-1]]
    parts = e.chunk(k, dim=-1)
    h = layer_norm_nw(x)
    h = h * (1.0 + parts[1]).to(h.dtype) + parts[0].to(h.dtype)
    return h, (parts[2].to(x.dtype) if k == 3 else None)


class Attention(nn.Module):
    def __init__(self, h, kv_dim, head_dim, dtype, device):
        super().__init__()
        lin = lambda di, do: nn.Linear(di, do, bias=False, dtype=dtype, device=device)
        self.q, self.k, self.v, self.o = lin(h, h), lin(kv_dim, h), lin(kv_dim, h), lin(h, h)
        self.norm_q = nn.Parameter(torch.ones(head_dim, dtype=F32, device=device))
        self.norm_k = nn.Parameter(torch.ones(head_dim, dtype=F32, device=device))


class CosmosBlock(nn.Module):
    def __init__(self, cfg: CosmosConfig, dtype, device):
        super().__init__()
        h, r = cfg.hidden_size, cfg.adaln_lora_dim
        self.cfg = cfg
        self.norm1, self.norm2, self.norm3 = (AdaLN(h, r, 3, device) for _ in range(3))
        self.attn1 = Attention(h, h, cfg.attention_head_dim, dtype, device)
        self.attn2 = Attention(h, cfg.text_embed_dim, cfg.attention_head_dim, dtype, device)
        mlp = int(h * cfg.mlp_ratio)
        self.ff1 = nn.Linear(h, mlp, bias=False, dtype=dtype, device=device)
        self.ff2 = nn.Linear(mlp, h, bias=False, dtype=dtype, device=device)

    def _heads(self, y):
        B = y.shape[0]
        return y.view(B, -1, self.cfg.num_attention_heads, self.cfg.attention_head_dim).transpose(1, 2)

    def _self_attention(self, x, cos, sin, t, layer_idx, attention, rows, generator):
        p, eps = self.attn1, self.cfg.eps
        q = apply_rope_half(rms_norm(self._heads(L.linear(p.q, x)), p.norm_q, eps), cos, sin)
        k = apply_rope_half(rms_norm(self._heads(L.linear(p.k, x)), p.norm_k, eps), cos, sin)
        v = self._heads(L.linear(p.v, x))
        o = attention(q, k, v, t, layer_idx, rows=rows, generator=generator)
        return L.linear(p.o, o.transpose(1, 2).reshape(x.shape))

    def _cross_attention(self, x, context):
        p, eps = self.attn2, self.cfg.eps
        q = rms_norm(self._heads(L.linear(p.q, x)), p.norm_q, eps)
        k = rms_norm(self._heads(L.linear(p.k, context)), p.norm_k, eps)
        v = self._heads(L.linear(p.v, context))
        s = (q @ k.transpose(-1, -2)).float() * (self.cfg.attention_head_dim ** -0.5)
        o = torch.softmax(s, dim=-1).to(v.dtype) @ v
        return L.linear(p.o, o.transpose(1, 2).reshape(x.shape))

    def forward(self, x, context, embedded, temb, cos, sin, extra_pos, t, layer_idx, attention, rows=None,
                generator=None):
        if extra_pos is not None:
            x = x + extra_pos.to(x.dtype)
        h, gate = adaln(self.norm1, x, embedded, temb, 3)
        x = x + gate * self._self_attention(h, cos, sin, t, layer_idx, attention, rows, generator)
        h, gate = adaln(self.norm2, x, embedded, temb, 3)
        x = x + gate * self._cross_attention(h, context)
        h, gate = adaln(self.norm3, x, embedded, temb, 3)
        return x + gate * L.linear(self.ff2, F.gelu(L.linear(self.ff1, h)))


class TimeEmbed(nn.Module):
    def __init__(self, h, device):
        super().__init__()
        self.t_fc1 = nn.Linear(h, h, bias=False, dtype=F32, device=device)
        self.t_fc2 = nn.Linear(h, 3 * h, bias=False, dtype=F32, device=device)
        self.norm = nn.Parameter(torch.ones(h, dtype=F32, device=device))


class PosEmbed(nn.Module):
    def __init__(self, cfg: CosmosConfig, dtype, device):
        super().__init__()
        mt, mh, mw = (s // p for s, p in zip(cfg.max_size, cfg.patch_size))
        h = cfg.hidden_size
        self.t, self.h, self.w = (nn.Parameter(torch.zeros(n, h, dtype=dtype, device=device)) for n in (mt, mh, mw))


class CosmosModel(nn.Module):
    """Cosmos DiT. Linears and the position tables in `dtype`; the time
    embedding, the AdaLN projections and the norm weights f32."""

    def __init__(self, cfg: CosmosConfig, *, dtype=torch.bfloat16, device="cpu"):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.patch_embed = nn.Linear(cfg.patch_in_channels * math.prod(cfg.patch_size), h, bias=False, dtype=dtype,
                                     device=device)
        self.time_embed = TimeEmbed(h, device)
        self.blocks = nn.ModuleList(CosmosBlock(cfg, dtype, device) for _ in range(cfg.num_layers))
        self.norm_out = AdaLN(h, cfg.adaln_lora_dim, 2, device)
        self.proj_out = nn.Linear(h, math.prod(cfg.patch_size) * cfg.out_channels, dtype=dtype, device=device)
        self.pos_embed = PosEmbed(cfg, dtype, device) if cfg.extra_pos_embed_type else None
        self._rope_cache = {}
        self.requires_grad_(False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator):
        """The JAX package's init_cosmos_params distributions: linear weights
        N(0, 1/d_in), zero biases, unit norms, position tables N(0, 0.02^2)."""
        dev = self.patch_embed.weight.device
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                w = torch.randn(mod.weight.shape, generator=generator, device=dev)
                mod.weight.copy_(w / math.sqrt(mod.in_features))
                if mod.bias is not None:
                    mod.bias.zero_()
        if self.pos_embed is not None:
            for p in (self.pos_embed.t, self.pos_embed.h, self.pos_embed.w):
                p.copy_(torch.randn(p.shape, generator=generator, device=dev) * 0.02)
        return self

    @property
    def device(self):
        return self.patch_embed.weight.device

    def _rope(self, grid, device):
        key = (grid, str(device))
        if key not in self._rope_cache:
            cos, sin = rope_3d(self.cfg, grid)
            self._rope_cache[key] = (torch.as_tensor(cos, device=device), torch.as_tensor(sin, device=device))
        return self._rope_cache[key]

    def _pos(self, grid):
        """The learned position embedding (1, S, h): the tables summed (in
        their dtype) and RMS-normalised in f32."""
        T, H, W = grid
        p = self.pos_embed
        emb = (p.t[:T, None, None, :] + p.h[None, :H, None, :] + p.w[None, None, :W, :]).reshape(1, T * H * W, -1)
        ef = emb.float()
        return (ef / torch.sqrt((ef * ef).mean(-1, keepdim=True) + 1e-6)).to(emb.dtype)

    @torch.no_grad()
    def forward(self, x, t, context, *, attention=None, profile_rows=None, generator=None):
        """x (B, C, F, H, W) latents in the model dtype; t (B,) timesteps
        (EDM's c_noise); context (B, L, text_embed_dim) T5 states. attention:
        a runtime (sparse/runtimes.py); None takes core/attention_ref's dense
        attention (tests). `profile_rows` (num_layers, n_rows) hands the SVG1
        profiler its rows per layer; otherwise the runtime draws them from
        `generator`. The padding-mask channel is zeros and the RoPE runs on
        frame indices (no fps), as the JAX pipeline calls its forward.
        Returns the prediction (B, out_channels, F, H, W) in the model
        dtype."""
        cfg = self.cfg
        B, C, F_, H, W = x.shape
        pt, ph, pw = cfg.patch_size
        grid = (F_ // pt, H // ph, W // pw)
        if cfg.concat_padding_mask:
            x = torch.cat([x, x.new_zeros(B, 1, F_, H, W)], dim=1)
        xp = x.reshape(B, cfg.patch_in_channels, grid[0], pt, grid[1], ph, grid[2], pw)
        hs = L.linear(self.patch_embed, xp.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(B, math.prod(grid), -1))
        cos, sin = self._rope(grid, x.device)
        extra_pos = self._pos(grid) if self.pos_embed is not None else None

        te = self.time_embed
        proj = timestep_sinusoid(t, cfg.hidden_size)
        temb = L.linear(te.t_fc2, F.silu(L.linear(te.t_fc1, proj)))[:, None]
        embedded = rms_norm(proj, te.norm, cfg.eps)[:, None]
        if attention is None:
            from sparse_videogen_tpu_torch.core.attention_ref import dense_attention

            attention = lambda q, k, v, *a, **kw: dense_attention(q, k, v)
        context = context.to(hs.dtype)
        t0 = float(t[0])
        for li, blk in enumerate(self.blocks):
            hs = blk(hs, context, embedded, temb, cos, sin, extra_pos, t0, li, attention,
                     rows=None if profile_rows is None else profile_rows[li], generator=generator)

        h, _ = adaln(self.norm_out, hs, embedded, temb, 2)
        out = L.linear(self.proj_out, h)
        # the reference's (p_h, p_w, p_t, c) unflatten and permute(0, 7, 1, 6, 2, 4, 3, 5)
        out = out.reshape(B, grid[0], grid[1], grid[2], ph, pw, pt, cfg.out_channels).permute(0, 7, 1, 6, 2, 4, 3, 5)
        return out.reshape(B, cfg.out_channels, F_, H, W)

