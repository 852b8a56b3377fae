"""HunyuanVideo DiT, HYVideo-T/2 (counterpart of
sparse_videogen_tpu/models/hyvideo/model.py).

20 double-stream blocks (separate image and text streams, joint attention)
and 40 single-stream blocks (one stream, parallel attention and MLP from
linear1/linear2); 3-axis interleaved RoPE on the video tokens only
(rope_dim_list (16, 56, 56)); the conditioning vector is the timestep
embedding plus an MLP of the pooled CLIP state plus the guidance embedding
of the cfg-distilled checkpoint; the LLaMA text states pass a 2-block token
refiner. Token layout: video tokens, then text_len (256) text tokens, so the
self-attention runtime sees a text-last layout (mask kind "hyvideo").

Numerics follow the JAX package: every linear in the activation dtype with
its weights cast to it (the time, vector and guidance MLPs therefore run in
f32 from an f32 sinusoid); f32 LayerNorm and modulation, cast back before a
linear; qk-RMSNorm (WanRMSNorm); the refiner's plain softmax attention over
text_len in f32; the single block's linear1/linear2 as two matmuls each
(column and row slices), whose bf16 partial outputs are added. Like the JAX
init, every linear is stored in the model dtype and the norm weights in
f32, so never cast the whole module.

Public layouts match JAX: latents (B, C, F, H, W), attention (B, H, S, D).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from sparse_videogen_tpu_torch.models.common import layers as L
from sparse_videogen_tpu_torch.models.common.rope import apply_rope_interleaved, nd_rope_cos_sin

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class HyVideoConfig:
    patch_size: tuple = (1, 2, 2)
    in_channels: int = 16
    out_channels: int = 16
    hidden_size: int = 3072
    heads_num: int = 24
    mlp_width_ratio: float = 4.0
    mm_double_blocks_depth: int = 20
    mm_single_blocks_depth: int = 40
    rope_dim_list: tuple = (16, 56, 56)
    text_states_dim: int = 4096  # LLaMA hidden
    text_states_dim_2: int = 768  # CLIP-L pooled
    text_len: int = 256
    guidance_embed: bool = True
    refiner_depth: int = 2
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.heads_num

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_width_ratio)

    @property
    def num_layers(self) -> int:
        return self.mm_double_blocks_depth + self.mm_single_blocks_depth


HYVIDEO_T2 = HyVideoConfig()


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """(B,) -> (B, dim) f32, [cos | sin] (cos first)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=F32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def _lin(d_in, d_out, dtype, device):
    return nn.Linear(d_in, d_out, dtype=dtype, device=device)


def _mlp2(d_in, d_hidden, d_out, dtype, device):
    return nn.ModuleDict({"fc1": _lin(d_in, d_hidden, dtype, device), "fc2": _lin(d_hidden, d_out, dtype, device)})


def _run_mlp2(m, x, act=L.silu):
    return L.linear(m["fc2"], act(L.linear(m["fc1"], x)))


def _heads(x, H):
    B, S, hd = x.shape
    return x.view(B, S, H, hd // H).transpose(1, 2)


def _unheads(x):
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


def _norm_weight(d, device):
    return nn.Parameter(torch.ones(d, dtype=F32, device=device))


class RefinerBlock(nn.Module):
    def __init__(self, h, dtype, device):
        super().__init__()
        self.norm1 = nn.LayerNorm(h, dtype=F32, device=device)
        self.qkv = _lin(h, 3 * h, dtype, device)
        self.proj = _lin(h, h, dtype, device)
        self.norm2 = nn.LayerNorm(h, dtype=F32, device=device)
        self.mlp = _mlp2(h, 4 * h, h, dtype, device)
        self.adaln = _lin(h, 2 * h, dtype, device)


class TokenRefiner(nn.Module):
    """SingleTokenRefiner: c = its own timestep MLP + an MLP of the masked
    mean of the text; pre-LN blocks with gated attention and MLP."""

    def __init__(self, cfg: HyVideoConfig, dtype, device):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.input_embedder = _lin(cfg.text_states_dim, h, dtype, device)
        self.t_embedder = _mlp2(256, h, h, dtype, device)
        self.c_embedder = _mlp2(cfg.text_states_dim, h, h, dtype, device)
        self.blocks = nn.ModuleList(RefinerBlock(h, dtype, device) for _ in range(cfg.refiner_depth))

    def forward(self, txt, t, mask):
        cfg = self.cfg
        t_emb = _run_mlp2(self.t_embedder, timestep_embedding(t, 256))
        if mask is None:
            ctx = txt.mean(1)
            attn_mask = None
        else:
            m = mask.to(txt.dtype)[..., None]
            ctx = (txt * m).sum(1) / m.sum(1).clamp_min(1.0)
            attn_mask = (mask[:, None, :] == 1) & (mask[:, :, None] == 1)
            attn_mask[:, :, 0] = True  # the reference's quirk: column 0 always attended
        c = t_emb + _run_mlp2(self.c_embedder, ctx.to(t_emb.dtype))
        x = L.linear(self.input_embedder, txt)
        H = cfg.heads_num
        for blk in self.blocks:
            g_msa, g_mlp = L.linear(blk.adaln, L.silu(c)).chunk(2, dim=-1)
            y = L.layer_norm_f32(x, cfg.eps, blk.norm1.weight, blk.norm1.bias).to(x.dtype)
            q, k, v = (_heads(z, H) for z in L.linear(blk.qkv, y).chunk(3, dim=-1))
            s = (q @ k.transpose(-1, -2)).float() * (q.shape[-1] ** -0.5)
            if attn_mask is not None:
                s = torch.where(attn_mask[:, None], s, torch.finfo(F32).min)
            a = _unheads(torch.softmax(s, dim=-1).to(v.dtype) @ v)
            x = x + L.linear(blk.proj, a) * g_msa[:, None]
            y = L.layer_norm_f32(x, cfg.eps, blk.norm2.weight, blk.norm2.bias).to(x.dtype)
            x = x + _run_mlp2(blk.mlp, y) * g_mlp[:, None]
        return x


class DoubleBlock(nn.Module):
    """MMDoubleStreamBlock: image and text streams with their own weights,
    one joint attention over [image | text]; RoPE on the image stream."""

    def __init__(self, cfg: HyVideoConfig, dtype, device):
        super().__init__()
        h, mh, hd = cfg.hidden_size, cfg.mlp_hidden, cfg.head_dim
        self.cfg = cfg
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", _lin(h, 6 * h, dtype, device))
            setattr(self, f"{s}_qkv", _lin(h, 3 * h, dtype, device))
            setattr(self, f"{s}_q_norm", _norm_weight(hd, device))
            setattr(self, f"{s}_k_norm", _norm_weight(hd, device))
            setattr(self, f"{s}_proj", _lin(h, h, dtype, device))
            setattr(self, f"{s}_mlp", _mlp2(h, mh, h, dtype, device))

    def _qkv(self, s, x, shift, scale, cos=None, sin=None):
        cfg = self.cfg
        y = _modulate(L.layer_norm_f32(x, cfg.eps), shift, scale).to(x.dtype)
        q, k, v = (_heads(z, cfg.heads_num) for z in L.linear(getattr(self, f"{s}_qkv"), y).chunk(3, dim=-1))
        q = L.rms_norm(q, getattr(self, f"{s}_q_norm"), cfg.eps)
        k = L.rms_norm(k, getattr(self, f"{s}_k_norm"), cfg.eps)
        if cos is not None:
            q, k = apply_rope_interleaved(q, cos, sin), apply_rope_interleaved(k, cos, sin)
        return q, k, v

    def _post(self, s, x, attn, g1, shift2, scale2, g2):
        x = x + L.linear(getattr(self, f"{s}_proj"), attn) * g1[:, None]
        y = _modulate(L.layer_norm_f32(x, self.cfg.eps), shift2, scale2).to(x.dtype)
        return x + _run_mlp2(getattr(self, f"{s}_mlp"), y, act=L.gelu_tanh) * g2[:, None]

    def forward(self, img, txt, vec, cos, sin, t, layer_idx, attention, rows=None, generator=None):
        silu_vec = L.silu(vec)
        i1s, i1c, i1g, i2s, i2c, i2g = L.linear(self.img_mod, silu_vec).chunk(6, dim=-1)
        t1s, t1c, t1g, t2s, t2c, t2g = L.linear(self.txt_mod, silu_vec).chunk(6, dim=-1)
        iq, ik, iv = self._qkv("img", img, i1s, i1c, cos, sin)
        tq, tk, tv = self._qkv("txt", txt, t1s, t1c)
        q, k, v = (torch.cat(p, dim=2) for p in ((iq, tq), (ik, tk), (iv, tv)))
        o = _unheads(attention(q, k, v, t, layer_idx, rows=rows, generator=generator))
        n_img = img.shape[1]
        img = self._post("img", img, o[:, :n_img], i1g, i2s, i2c, i2g)
        txt = self._post("txt", txt, o[:, n_img:], t1g, t2s, t2c, t2g)
        return img, txt


class SingleBlock(nn.Module):
    """MMSingleStreamBlock over [image | text]. linear1's output columns split
    into its qkv and MLP parts and linear2's input rows into its attention
    and MLP parts, so the (S, 3h + mlp) and (S, h + mlp) concatenations
    never exist; the two partial products of linear2 are added in the
    activation dtype, as in the JAX package (layers.linear_slice: under
    int8 each part quantizes its own input per token, and the bias goes
    on the first)."""

    def __init__(self, cfg: HyVideoConfig, dtype, device):
        super().__init__()
        h, mh, hd = cfg.hidden_size, cfg.mlp_hidden, cfg.head_dim
        self.cfg = cfg
        self.modulation = _lin(h, 3 * h, dtype, device)
        self.linear1 = _lin(h, 3 * h + mh, dtype, device)
        self.linear2 = _lin(h + mh, h, dtype, device)
        self.q_norm = _norm_weight(hd, device)
        self.k_norm = _norm_weight(hd, device)

    def forward(self, x, vec, cos, sin, txt_len, t, layer_idx, attention, rows=None, generator=None):
        cfg = self.cfg
        h = cfg.hidden_size
        dt = x.dtype
        ms, mc, mg = L.linear(self.modulation, L.silu(vec)).chunk(3, dim=-1)
        y = _modulate(L.layer_norm_f32(x, cfg.eps), ms, mc).to(dt)
        qkv = L.linear_slice(self.linear1, y, cols=slice(0, 3 * h))
        q, k, v = (_heads(z, cfg.heads_num) for z in qkv.chunk(3, dim=-1))
        q = L.rms_norm(q, self.q_norm, cfg.eps)
        k = L.rms_norm(k, self.k_norm, cfg.eps)
        vid = x.shape[1] - txt_len
        q = torch.cat([apply_rope_interleaved(q[:, :, :vid], cos, sin), q[:, :, vid:]], dim=2)
        k = torch.cat([apply_rope_interleaved(k[:, :, :vid], cos, sin), k[:, :, vid:]], dim=2)
        o = _unheads(attention(q, k, v, t, layer_idx, rows=rows, generator=generator))
        mlp = L.gelu_tanh(L.linear_slice(self.linear1, y, cols=slice(3 * h, None)))
        out = (L.linear_slice(self.linear2, o, rows=slice(0, h))
               + L.linear_slice(self.linear2, mlp, rows=slice(h, None), bias=False))
        return x + out * mg[:, None]


class HyVideoModel(nn.Module):
    """HunyuanVideo T2V DiT. Linears in `dtype`, norm weights f32."""

    def __init__(self, cfg: HyVideoConfig, *, dtype=torch.bfloat16, device="cpu"):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.img_in = _lin(cfg.in_channels * math.prod(cfg.patch_size), h, dtype, device)
        self.time_in = _mlp2(256, h, h, dtype, device)
        self.vector_in = _mlp2(cfg.text_states_dim_2, h, h, dtype, device)
        if cfg.guidance_embed:
            self.guidance_in = _mlp2(256, h, h, dtype, device)
        self.txt_in = TokenRefiner(cfg, dtype, device)
        self.double_blocks = nn.ModuleList(DoubleBlock(cfg, dtype, device) for _ in range(cfg.mm_double_blocks_depth))
        self.single_blocks = nn.ModuleList(SingleBlock(cfg, dtype, device) for _ in range(cfg.mm_single_blocks_depth))
        self.final_adaln = _lin(h, 2 * h, dtype, device)
        self.final_linear = _lin(h, math.prod(cfg.patch_size) * cfg.out_channels, dtype, device)
        self._rope_cache = {}
        self.requires_grad_(False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator):
        """JAX init_hyvideo_params' distributions: linear weights N(0, 1/d_in),
        zero biases; LayerNorm and qk-norm weights 1, biases 0."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                w = torch.randn(mod.weight.shape, generator=generator, device=mod.weight.device)
                mod.weight.copy_(w / math.sqrt(mod.in_features))
                mod.bias.zero_()
        return self

    def _rope(self, grid, device):
        key = (grid, str(device))
        if key not in self._rope_cache:
            cos, sin = nd_rope_cos_sin(grid, tuple(self.cfg.rope_dim_list))
            self._rope_cache[key] = (torch.as_tensor(cos, device=device), torch.as_tensor(sin, device=device))
        return self._rope_cache[key]

    @torch.no_grad()
    def forward(self, x, t, text_states, text_mask, text_states_2, *, guidance=None, attention,
                profile_rows=None, generator=None):
        """x (B, C, F, H, W) latents in the model dtype; t (B,) timesteps;
        text_states (B, text_len, text_states_dim); text_mask (B, text_len)
        1/0; text_states_2 (B, text_states_dim_2); guidance (B,) (x1000),
        required with guidance_embed. `profile_rows` (num_layers, n_rows)
        hands the SVG1 profiler its rows per layer (double blocks first);
        otherwise the runtime draws them from `generator`. Returns the f32
        prediction (B, out_channels, F, H, W)."""
        cfg = self.cfg
        B, C, F_, H, W = x.shape
        pt, ph, pw = cfg.patch_size
        grid = (F_ // pt, H // ph, W // pw)

        t_emb = _run_mlp2(self.time_in, timestep_embedding(t, 256))
        vec = t_emb + _run_mlp2(self.vector_in, text_states_2.to(t_emb.dtype))
        if cfg.guidance_embed:
            if guidance is None:
                raise ValueError("guidance is required with guidance_embed")
            vec = vec + _run_mlp2(self.guidance_in, timestep_embedding(guidance, 256))

        img = x.reshape(B, C, grid[0], pt, grid[1], ph, grid[2], pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
        img = L.linear(self.img_in, img.reshape(B, -1, C * pt * ph * pw))
        txt = self.txt_in(text_states, t, text_mask).to(img.dtype)
        vec = vec.to(img.dtype)
        cos, sin = self._rope(grid, x.device)

        t0 = float(t[0])
        rows = (lambda li: None) if profile_rows is None else (lambda li: profile_rows[li])
        for li, blk in enumerate(self.double_blocks):
            img, txt = blk(img, txt, vec, cos, sin, t0, li, attention, rows=rows(li), generator=generator)
        xx = torch.cat([img, txt], dim=1)
        n_img, txt_len = img.shape[1], txt.shape[1]
        for j, blk in enumerate(self.single_blocks):
            li = cfg.mm_double_blocks_depth + j
            xx = blk(xx, vec, cos, sin, txt_len, t0, li, attention, rows=rows(li), generator=generator)

        shift, scale = L.linear(self.final_adaln, L.silu(vec)).chunk(2, dim=-1)
        img = _modulate(L.layer_norm_f32(xx[:, :n_img], cfg.eps), shift, scale).to(xx.dtype)
        img = L.linear(self.final_linear, img)
        tt, th, tw = grid
        c = cfg.out_channels
        img = img.reshape(B, tt, th, tw, c, pt, ph, pw).permute(0, 4, 1, 5, 2, 6, 3, 7)
        return img.reshape(B, c, tt * pt, th * ph, tw * pw).float()


def hyvideo_forward(model: HyVideoModel, x, t, text_states, text_mask, text_states_2, *, guidance=None, attention,
                    profile_rows=None, generator=None):
    """Functional spelling of HyVideoModel.forward, as the JAX package names it."""
    return model(x, t, text_states, text_mask, text_states_2, guidance=guidance, attention=attention,
                 profile_rows=profile_rows, generator=generator)
