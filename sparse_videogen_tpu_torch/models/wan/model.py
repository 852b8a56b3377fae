"""Wan 2.1 DiT, T2V and I2V (counterpart of
sparse_videogen_tpu/models/wan/model.py).

Numerics follow the JAX package: patch embedding as a matmul over patches in
conv-weight order (in, kt, kh, kw); f32 time embedding and modulation; f32
LayerNorm + AdaLN; qk-RMSNorm; 3-D interleaved RoPE; an injected
self-attention runtime (sparse/runtimes.py); plain f32-softmax cross-attention
to the text; GELU-tanh FFN; f32 gating. I2V (model_type "i2v") adds the
image embedding `img_emb` (LayerNorm(1e-5), fc1, GELU-tanh, fc2,
LayerNorm(1e-5)) of the CLIP features and, in every block's
cross-attention, k_img / v_img / norm_k_img: a second softmax over the
image tokens whose output is added to the text branch's. The time embedding, projection,
modulation tables and norm weights are f32 parameters inside a bf16 model,
so never cast the whole module.

Public layouts match JAX: latents (B, C, F, H, W), attention (B, H, S, D).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from sparse_videogen_tpu_torch.models.common import layers as L
from sparse_videogen_tpu_torch.models.common.rope import apply_rope_interleaved, wan_rope_cos_sin


@dataclasses.dataclass(frozen=True)
class WanConfig:
    model_type: str = "t2v"  # "t2v" | "i2v"
    patch_size: tuple = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 16
    dim: int = 1536
    ffn_dim: int = 8960
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 12
    num_layers: int = 30
    eps: float = 1e-6
    image_dim: int = 1280  # CLIP features for I2V

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


WAN_1_3B = WanConfig()
WAN_14B = WanConfig(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40)

F32 = torch.float32


def _lin(d_in, d_out, dtype, device):
    return nn.Linear(d_in, d_out, dtype=dtype, device=device)


class _Attention(nn.Module):
    def __init__(self, d, dtype, device, image=False):
        super().__init__()
        self.q, self.k, self.v, self.o = (_lin(d, d, dtype, device) for _ in range(4))
        self.norm_q = nn.Parameter(torch.ones(d, dtype=F32, device=device))
        self.norm_k = nn.Parameter(torch.ones(d, dtype=F32, device=device))
        if image:  # I2V cross-attention: the image tokens' keys and values
            self.k_img, self.v_img = _lin(d, d, dtype, device), _lin(d, d, dtype, device)
            self.norm_k_img = nn.Parameter(torch.ones(d, dtype=F32, device=device))


def _softmax_attention(q, k, v):
    """Plain attention without a mask: f32 softmax of q k^T / sqrt(D), cast to
    v's dtype before the product with v."""
    s = (q @ k.transpose(-1, -2)).float() * (q.shape[-1] ** -0.5)
    return torch.softmax(s, dim=-1).to(v.dtype) @ v


class WanBlock(nn.Module):
    def __init__(self, cfg: WanConfig, dtype, device):
        super().__init__()
        d = cfg.dim
        self.cfg = cfg
        self.modulation = nn.Parameter(torch.zeros(6, d, dtype=F32, device=device))
        self.self_attn = _Attention(d, dtype, device)
        self.cross_attn = _Attention(d, dtype, device, image=cfg.model_type == "i2v")
        self.norm3 = nn.LayerNorm(d, eps=cfg.eps, dtype=F32, device=device)
        self.ffn = nn.ModuleDict({"fc1": _lin(d, cfg.ffn_dim, dtype, device),
                                  "fc2": _lin(cfg.ffn_dim, d, dtype, device)})

    def _self_attention(self, x, cos, sin, t, layer_idx, attention, rows, generator):
        cfg, p = self.cfg, self.self_attn
        B, S, d = x.shape
        H, D = cfg.num_heads, cfg.head_dim
        heads = lambda y: y.view(B, S, H, D).transpose(1, 2)
        q = apply_rope_interleaved(heads(L.rms_norm(L.linear(p.q, x), p.norm_q, cfg.eps)), cos, sin)
        k = apply_rope_interleaved(heads(L.rms_norm(L.linear(p.k, x), p.norm_k, cfg.eps)), cos, sin)
        v = heads(L.linear(p.v, x))
        o = attention(q, k, v, t, layer_idx, rows=rows, generator=generator)
        return L.linear(p.o, o.transpose(1, 2).reshape(B, S, d))

    def _cross_attention(self, x, context, context_img):
        cfg, p = self.cfg, self.cross_attn
        B, S, d = x.shape
        H, D = cfg.num_heads, cfg.head_dim
        heads = lambda y: y.view(B, -1, H, D).transpose(1, 2)
        q = heads(L.rms_norm(L.linear(p.q, x), p.norm_q, cfg.eps))
        k = heads(L.rms_norm(L.linear(p.k, context), p.norm_k, cfg.eps))
        o = _softmax_attention(q, k, heads(L.linear(p.v, context)))
        if context_img is not None:
            k_img = heads(L.rms_norm(L.linear(p.k_img, context_img), p.norm_k_img, cfg.eps))
            o = o + _softmax_attention(q, k_img, heads(L.linear(p.v_img, context_img)))
        return L.linear(p.o, o.transpose(1, 2).reshape(B, S, d))

    def forward(self, x, e6, cos, sin, t, layer_idx, context, attention, rows=None, generator=None,
                context_img=None):
        """WanAttentionBlock.forward; x in the model dtype, e6 (B, 6, dim) f32."""
        eps = self.cfg.eps
        e = self.modulation[None].float() + e6
        y = L.layer_norm_f32(x, eps)
        y = (y * (1 + e[:, 1:2]) + e[:, 0:1]).to(x.dtype)
        y = self._self_attention(y, cos, sin, t, layer_idx, attention, rows, generator)
        x = (x.float() + y.float() * e[:, 2:3]).to(x.dtype)
        y = L.layer_norm_f32(x, eps, self.norm3.weight, self.norm3.bias).to(x.dtype)
        x = x + self._cross_attention(y, context, context_img)
        y = L.layer_norm_f32(x, eps)
        y = (y * (1 + e[:, 4:5]) + e[:, 3:4]).to(x.dtype)
        y = L.mlp_gelu(self.ffn["fc1"], self.ffn["fc2"], y)
        return (x.float() + y.float() * e[:, 5:6]).to(x.dtype)


def sinusoidal_embedding_1d(dim: int, position):
    """(B,) -> (B, dim) f32 [cos | sin]."""
    half = dim // 2
    pos = position.float()
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=F32, device=pos.device) / half)
    sin = pos[:, None] * freqs[None, :]
    return torch.cat([torch.cos(sin), torch.sin(sin)], dim=1)


class WanModel(nn.Module):
    """Wan 2.1 DiT (T2V, or I2V with `img_emb`). Linear weights in `dtype`;
    time embedding, modulation and norm weights f32."""

    def __init__(self, cfg: WanConfig, *, dtype=torch.bfloat16, device="cpu"):
        super().__init__()
        if cfg.model_type not in ("t2v", "i2v"):
            raise ValueError(f"model_type {cfg.model_type!r}: expected 't2v' or 'i2v'")
        self.cfg = cfg
        d = cfg.dim
        patch_in = cfg.in_dim * math.prod(cfg.patch_size)
        self.patch_embedding = _lin(patch_in, d, dtype, device)
        self.text_embedding = nn.ModuleDict({"fc1": _lin(cfg.text_dim, d, dtype, device),
                                             "fc2": _lin(d, d, dtype, device)})
        self.time_embedding = nn.ModuleDict({"fc1": _lin(cfg.freq_dim, d, F32, device),
                                             "fc2": _lin(d, d, F32, device)})
        self.time_projection = _lin(d, 6 * d, F32, device)
        self.head_modulation = nn.Parameter(torch.zeros(2, d, dtype=F32, device=device))
        self.head_out = _lin(d, math.prod(cfg.patch_size) * cfg.out_dim, dtype, device)
        self.blocks = nn.ModuleList(WanBlock(cfg, dtype, device) for _ in range(cfg.num_layers))
        if cfg.model_type == "i2v":
            self.img_emb = nn.ModuleDict({
                "norm1": nn.LayerNorm(cfg.image_dim, eps=1e-5, dtype=F32, device=device),
                "fc1": _lin(cfg.image_dim, d, dtype, device), "fc2": _lin(d, d, dtype, device),
                "norm2": nn.LayerNorm(d, eps=1e-5, dtype=F32, device=device)})
        self._rope_cache = {}
        self.requires_grad_(False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator):
        """JAX init_wan_params' distributions: linear weights N(0, 1/d_in),
        zero biases, modulation tables N(0, 1/dim), unit norm weights (and
        zero LayerNorm biases)."""
        d = self.cfg.dim
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                w = torch.randn(mod.weight.shape, generator=generator, device=mod.weight.device)
                mod.weight.copy_(w / math.sqrt(mod.in_features))
                mod.bias.zero_()
        for blk in self.blocks:
            blk.modulation.copy_(torch.randn(6, d, generator=generator, device=blk.modulation.device) / math.sqrt(d))
        self.head_modulation.copy_(
            torch.randn(2, d, generator=generator, device=self.head_modulation.device) / math.sqrt(d))
        return self

    def _patchify(self, x):
        B, C, F_, H, W = x.shape
        pt, ph, pw = self.cfg.patch_size
        x = x.reshape(B, C, F_ // pt, pt, H // ph, ph, W // pw, pw)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(B, -1, C * pt * ph * pw)
        return L.linear(self.patch_embedding, x)

    def _unpatchify(self, x, grid):
        Fp, Hp, Wp = grid
        pt, ph, pw = self.cfg.patch_size
        c = self.cfg.out_dim
        x = x.reshape(x.shape[0], Fp, Hp, Wp, pt, ph, pw, c).permute(0, 7, 1, 4, 2, 5, 3, 6)
        return x.reshape(x.shape[0], c, Fp * pt, Hp * ph, Wp * pw)

    def _rope(self, grid, device):
        key = (grid, str(device))
        if key not in self._rope_cache:
            cos, sin = wan_rope_cos_sin(*grid, self.cfg.head_dim)
            self._rope_cache[key] = (torch.as_tensor(cos, device=device), torch.as_tensor(sin, device=device))
        return self._rope_cache[key]

    def _image_context(self, clip_fea, dtype):
        """CLIP features (B, 257, image_dim) -> the image tokens (B, 257, dim)."""
        p = self.img_emb
        y = L.layer_norm_f32(clip_fea, 1e-5, p["norm1"].weight, p["norm1"].bias).to(dtype)
        y = L.linear(p["fc2"], L.gelu_tanh(L.linear(p["fc1"], y)))
        return L.layer_norm_f32(y, 1e-5, p["norm2"].weight, p["norm2"].bias).to(dtype)

    @torch.no_grad()
    def forward(self, x, t, context, *, attention, profile_rows=None, generator=None, clip_fea=None):
        """x (B, C, F, H, W) latents (I2V: the noise and the condition's
        channels, in_dim in all); t (B,) timesteps in [0, 1000]; context
        (B, text_len, text_dim); clip_fea (B, 257, image_dim) CLIP features
        (I2V). `profile_rows` (num_layers, n_rows) hands the SVG1 profiler
        its sampled rows per layer; otherwise the runtime draws them from
        `generator`. Returns the f32 noise prediction (B, out_dim, F, H, W)."""
        cfg = self.cfg
        B, C, F_, H, W = x.shape
        pt, ph, pw = cfg.patch_size
        grid = (F_ // pt, H // ph, W // pw)
        tokens = self._patchify(x)

        e = sinusoidal_embedding_1d(cfg.freq_dim, t)
        e = L.linear(self.time_embedding["fc2"], L.silu(L.linear(self.time_embedding["fc1"], e)))
        e6 = L.linear(self.time_projection, L.silu(e)).reshape(B, 6, cfg.dim)
        ctx = L.mlp_gelu(self.text_embedding["fc1"], self.text_embedding["fc2"], context.to(tokens.dtype))
        ctx_img = None if clip_fea is None else self._image_context(clip_fea, tokens.dtype)
        cos, sin = self._rope(grid, x.device)

        t0 = float(t[0])
        for li, blk in enumerate(self.blocks):
            rows = None if profile_rows is None else profile_rows[li]
            tokens = blk(tokens, e6, cos, sin, t0, li, ctx, attention, rows=rows, generator=generator,
                         context_img=ctx_img)

        hm = self.head_modulation[None].float() + e[:, None, :]
        y = L.layer_norm_f32(tokens, cfg.eps)
        y = (y * (1 + hm[:, 1:2]) + hm[:, 0:1]).to(tokens.dtype)
        return self._unpatchify(L.linear(self.head_out, y), grid).float()


def wan_forward(model: WanModel, x, t, context, *, attention, profile_rows=None, generator=None, clip_fea=None):
    """Functional spelling of WanModel.forward, as the JAX package names it."""
    return model(x, t, context, attention=attention, profile_rows=profile_rows, generator=generator,
                 clip_fea=clip_fea)
