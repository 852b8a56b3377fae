"""CogVideoX 1.5 DiT (counterpart of sparse_videogen_tpu/models/cog/model.py).

The joint sequence is [text; video]: the 226 text tokens come FIRST, so the
self-attention runtime sees a text-first layout (mask kind "cog"). Each
block: CogVideoXLayerNormZero (six chunks of a linear of silu(temb): shift,
scale and gate for the video and for the text, one shared affine f32
LayerNorm), joint attention over [text; video] with a per-head affine f32
LayerNorm on q and k and interleaved 3-D RoPE (rope_dims (16, 24, 24) at
D = 64) on the video rows only, and one GELU(tanh) FFN over the
concatenated sequence. The time embedding is the cos-first sinusoid of the
HunyuanVideo port (timestep_embedding) through a 2-layer MLP; the v1.5 I2V
checkpoint adds the ofs embedding (ofs 2.0). The output passes the final
LayerNorm, an AdaLN (shift, scale of silu(temb)) and the projection, then
the temporal patches (p_t = 2) unfold frames-first.

Numerics follow the JAX package: every linear in its input's dtype with the
weights cast to it (so the time/ofs MLPs and proj_out, fed f32, run in
f32), f32 norms and modulation cast back to the activation dtype, the gates
applied in f32 and the residual cast back. Like the JAX init, linears are
stored in the model dtype and norm weights in f32, so never cast the whole
module.

Public layouts match JAX: latents in (B, C, F, H, W); the forward returns
(B, F, C_out, H, W) in f32, frames first, as the reference does.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from sparse_videogen_tpu_torch.models.common import layers as L
from sparse_videogen_tpu_torch.models.common.rope import apply_rope_interleaved, nd_rope_cos_sin
from sparse_videogen_tpu_torch.models.hyvideo.model import _heads, _lin, _mlp2, _run_mlp2, _unheads, timestep_embedding

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class CogConfig:
    num_layers: int = 42
    hidden_size: int = 3072
    heads_num: int = 48
    head_dim: int = 64
    text_len: int = 226
    text_dim: int = 4096  # T5-xxl
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    patch_size_t: int = 2
    time_embed_dim: int = 512
    ofs_embed: bool = False  # v1.5 I2V: extra Timesteps(ofs) conditioning
    ffn_mult: int = 4
    eps: float = 1e-5

    @property
    def rope_dims(self):
        d = self.head_dim
        return (d // 4, 3 * d // 8, 3 * d // 8)  # (16, 24, 24) for d = 64


COG_5B = CogConfig()
# CogVideoX1.5-5B-I2V: image latents concatenated channel-wise (16 noise +
# 16 image), ofs conditioning
COG_1_5_5B_I2V = CogConfig(in_channels=32, ofs_embed=True)


def _ln(d, device):
    return nn.LayerNorm(d, dtype=F32, device=device)


class NormZero(nn.Module):
    """CogVideoXLayerNormZero: (norm video, norm text, gate, text gate)."""

    def __init__(self, cfg: CogConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.lin = _lin(cfg.time_embed_dim, 6 * cfg.hidden_size, dtype, device)
        self.norm = _ln(cfg.hidden_size, device)

    def forward(self, x, enc, silu_temb):
        shift, scale, gate, e_shift, e_scale, e_gate = L.linear(self.lin, silu_temb).chunk(6, dim=-1)
        w, b, eps = self.norm.weight, self.norm.bias, self.cfg.eps
        nx = (L.layer_norm_f32(x, eps, w, b) * (1 + scale[:, None]) + shift[:, None]).to(x.dtype)
        ne = (L.layer_norm_f32(enc, eps, w, b) * (1 + e_scale[:, None]) + e_shift[:, None]).to(enc.dtype)
        return nx, ne, gate[:, None], e_gate[:, None]


class Attention(nn.Module):
    def __init__(self, cfg: CogConfig, dtype, device):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        for name in ("q", "k", "v", "o"):
            setattr(self, name, _lin(h, h, dtype, device))
        self.norm_q = _ln(cfg.head_dim, device)
        self.norm_k = _ln(cfg.head_dim, device)

    def forward(self, nx, ne, cos, sin, t, layer_idx, attention, rows=None, generator=None):
        """Joint attention over [text; video]; returns (video out, text out)."""
        cfg = self.cfg
        x = torch.cat([ne, nx], dim=1)
        tl = ne.shape[1]
        q, k, v = (_heads(L.linear(getattr(self, n), x), cfg.heads_num) for n in ("q", "k", "v"))
        q = L.layer_norm_f32(q, cfg.eps, self.norm_q.weight, self.norm_q.bias).to(x.dtype)
        k = L.layer_norm_f32(k, cfg.eps, self.norm_k.weight, self.norm_k.bias).to(x.dtype)
        # RoPE on the video rows only: rotate a copy of them, then join the text rows back
        q = torch.cat([q[:, :, :tl], apply_rope_interleaved(q[:, :, tl:], cos, sin)], dim=2)
        k = torch.cat([k[:, :, :tl], apply_rope_interleaved(k[:, :, tl:], cos, sin)], dim=2)
        o = L.linear(self.o, _unheads(attention(q, k, v, t, layer_idx, rows=rows, generator=generator)))
        return o[:, tl:], o[:, :tl]


class Block(nn.Module):
    def __init__(self, cfg: CogConfig, dtype, device):
        super().__init__()
        h = cfg.hidden_size
        self.norm1 = NormZero(cfg, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.norm2 = NormZero(cfg, dtype, device)
        self.ffn = _mlp2(h, cfg.ffn_mult * h, h, dtype, device)

    def forward(self, x, enc, silu_temb, cos, sin, t, layer_idx, attention, rows=None, generator=None):
        nx, ne, g, eg = self.norm1(x, enc, silu_temb)
        ax, ae = self.attn(nx, ne, cos, sin, t, layer_idx, attention, rows=rows, generator=generator)
        x = (x + g * ax).to(x.dtype)
        enc = (enc + eg * ae).to(enc.dtype)
        nx, ne, g, eg = self.norm2(x, enc, silu_temb)
        ff = _run_mlp2(self.ffn, torch.cat([ne, nx], dim=1), act=L.gelu_tanh)
        tl = enc.shape[1]
        return (x + g * ff[:, tl:]).to(x.dtype), (enc + eg * ff[:, :tl]).to(enc.dtype)


class CogModel(nn.Module):
    """CogVideoX 1.5 DiT. Linears in `dtype`, norm weights f32."""

    def __init__(self, cfg: CogConfig, *, dtype=torch.bfloat16, device="cpu"):
        super().__init__()
        self.cfg = cfg
        h, ted = cfg.hidden_size, cfg.time_embed_dim
        self.time_emb = _mlp2(h, ted, ted, dtype, device)
        if cfg.ofs_embed:
            self.ofs_emb = _mlp2(ted, ted, ted, dtype, device)
        self.patch_proj = _lin(cfg.in_channels * cfg.patch_size_t * cfg.patch_size**2, h, dtype, device)
        self.text_proj = _lin(cfg.text_dim, h, dtype, device)
        self.blocks = nn.ModuleList(Block(cfg, dtype, device) for _ in range(cfg.num_layers))
        self.norm_final = _ln(h, device)
        self.norm_out = _ln(h, device)
        self.norm_out_lin = _lin(ted, 2 * h, dtype, device)
        self.proj_out = _lin(h, cfg.patch_size_t * cfg.patch_size**2 * cfg.out_channels, dtype, device)
        self._rope_cache = {}
        self.requires_grad_(False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator):
        """JAX init_cog_params' distributions: linear weights N(0, 1/d_in),
        zero biases; LayerNorm weights 1, biases 0 (as constructed)."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                w = torch.randn(mod.weight.shape, generator=generator, device=mod.weight.device)
                mod.weight.copy_(w / math.sqrt(mod.in_features))
                mod.bias.zero_()
        return self

    def _rope(self, grid, device):
        key = (grid, str(device))
        if key not in self._rope_cache:
            cos, sin = nd_rope_cos_sin(grid, self.cfg.rope_dims)
            self._rope_cache[key] = (torch.as_tensor(cos, device=device), torch.as_tensor(sin, device=device))
        return self._rope_cache[key]

    @torch.no_grad()
    def forward(self, x, t, encoder_hidden_states, *, ofs=None, attention, profile_rows=None, generator=None):
        """x (B, C, F, H, W) latents in the model dtype (F a multiple of
        patch_size_t); t (B,) timesteps; encoder_hidden_states (B, text_len,
        text_dim); ofs (B,) (2.0 when None, with ofs_embed). `profile_rows`
        (num_layers, n_rows) hands the SVG1 profiler its rows per layer;
        otherwise the runtime draws them from `generator`. Returns the f32
        prediction (B, F, out_channels, H, W), frames first."""
        cfg = self.cfg
        B, C, F_, H, W = x.shape
        p, pt = cfg.patch_size, cfg.patch_size_t
        grid = (F_ // pt, H // p, W // p)

        temb = _run_mlp2(self.time_emb, timestep_embedding(t, cfg.hidden_size))
        if cfg.ofs_embed:
            ofs = torch.full(t.shape, 2.0, dtype=F32, device=t.device) if ofs is None else ofs
            temb = temb + _run_mlp2(self.ofs_emb, timestep_embedding(ofs, cfg.time_embed_dim))
        silu_temb = L.silu(temb)

        tok = x.reshape(B, C, grid[0], pt, grid[1], p, grid[2], p).permute(0, 2, 4, 6, 1, 3, 5, 7)
        tok = L.linear(self.patch_proj, tok.reshape(B, -1, C * pt * p * p))
        enc = L.linear(self.text_proj, encoder_hidden_states.to(tok.dtype))
        cos, sin = self._rope(grid, x.device)

        t0 = float(t[0])
        for li, blk in enumerate(self.blocks):
            tok, enc = blk(tok, enc, silu_temb, cos, sin, t0, li, attention,
                           rows=None if profile_rows is None else profile_rows[li], generator=generator)

        # the final LayerNorm runs over [text; video] in JAX; it is per token,
        # so normalising the video tokens alone gives the same values
        tok = L.layer_norm_f32(tok, cfg.eps, self.norm_final.weight, self.norm_final.bias).to(tok.dtype)
        shift, scale = L.linear(self.norm_out_lin, silu_temb).chunk(2, dim=-1)
        tok = L.layer_norm_f32(tok, cfg.eps, self.norm_out.weight, self.norm_out.bias).to(tok.dtype)
        tok = L.linear(self.proj_out, tok * (1 + scale[:, None]) + shift[:, None])

        co = cfg.out_channels
        out = tok.reshape(B, grid[0], grid[1], grid[2], co, pt, p, p).permute(0, 1, 5, 4, 2, 6, 3, 7)
        return out.reshape(B, grid[0] * pt, co, H, W).float()


def cog_forward(model: CogModel, x, t, encoder_hidden_states, *, ofs=None, attention, profile_rows=None,
                generator=None):
    """Functional spelling of CogModel.forward, as the JAX package names it."""
    return model(x, t, encoder_hidden_states, ofs=ofs, attention=attention, profile_rows=profile_rows,
                 generator=generator)
