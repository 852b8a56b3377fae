"""Cosmos's continuous causal video tokenizer, CV8x8x8 (counterpart of
sparse_videogen_tpu/models/cosmos/vae.py): 8x time, 8x space, 16 latent
channels.

  patcher: log2(patch_size) levels of a causal 3-D Haar transform (W, then
  H, then T; each axis halved, [low, high] concatenated on channels; time
  pairs front-padded with frame 0 when odd, so T -> (T - 1) / 2 + 1), and
  its exact inverse after the decoder.
  encoder: causal conv_in -> levels of resnets (per-frame GroupNorm(1),
  SiLU, causal 3x3x3 convs), the first level ending in a stride-(2, 2, 2)
  causal conv -> mid (resnet, spatial attention, causal temporal
  attention, resnet) -> GroupNorm(1), SiLU, conv_out; the latents are
  standardised by latents_mean / latents_std.
  decoder: the mirror image; the upsample is nearest, T -> 2T - 1 (every
  frame but the first repeated), then a causal conv; the output is clipped
  to [-1, 1].

A causal conv pads time in front with k - 1 copies of frame 0 and space
with zeros on both sides (the convolution's own padding). GroupNorm(1) is
per frame: f32 statistics over (C, H, W) of each (B, T). The attention is
one head, f32: spatial over each frame's H W tokens with queries in chunks
of attn_q_chunk rows (a 704x1280 bottleneck frame holds 14,080 tokens: the
whole (S, S) matrix is never built), temporal over each position's frames
with a causal mask. Activations are channels-first (B, C, T, H, W) in f32.

The upsample and padding are copies, never F.interpolate or F.pad (the
card's torch gets F.interpolate's nearest mode wrong past 2^31 elements:
ROADMAP.md section 3), and the norm is reductions, not F.group_norm.

Parameter names are the JAX pytree's paths: {encoder, decoder}.{conv_in,
mid.{res1, attn_s, attn_t, res2}, levels.<i>.res.<j>, norm_out, conv_out},
encoder.levels.<i>.down, decoder.levels.<i>.up; a resnet holds norm1, conv1,
norm2, conv2 (and a shortcut linear), an attention norm, q, k, v, o
(io/checkpoint.convert_cosmos_vae maps the tokenizer's names).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from sparse_videogen_tpu_torch.models.cog.vae import time_pad

F32 = torch.float32
_SQRT2 = math.sqrt(2.0)


@dataclasses.dataclass(frozen=True)
class CosmosVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    base_channels: int = 128
    channels_mult: tuple = (2, 4, 4)
    num_res_blocks: int = 2
    patch_size: int = 4  # Haar levels = log2(patch_size)
    spatial_compression: int = 8
    temporal_compression: int = 8
    attn_q_chunk: int = 2048
    latents_mean: tuple | None = None
    latents_std: tuple | None = None

    @property
    def wavelet_levels(self) -> int:
        return int(math.log2(self.patch_size))

    @property
    def conv_spatial_levels(self) -> int:
        return int(math.log2(self.spatial_compression // self.patch_size))

    @property
    def conv_temporal_levels(self) -> int:
        return int(math.log2(self.temporal_compression // self.patch_size))

    def downsample(self, i) -> bool:
        return i < max(self.conv_spatial_levels, self.conv_temporal_levels)

    @property
    def patch_channels(self) -> int:
        return self.in_channels * 8 ** self.wavelet_levels


COSMOS_VAE_CV8x8x8 = CosmosVAEConfig()


# -- the causal Haar patcher --

def _haar_axis(x, axis: int, causal: bool = False):
    """One orthonormal Haar level along `axis` -> (low, high), the axis
    halved; causal front-pads an odd axis with its first slice."""
    if causal and x.shape[axis] % 2 == 1:
        x = torch.cat([x.narrow(axis, 0, 1), x], dim=axis)
    n = x.shape[axis]
    xr = x.unflatten(axis, (n // 2, 2))
    a, b = xr.select(axis + 1, 0), xr.select(axis + 1, 1)
    return (a + b) / _SQRT2, (a - b) / _SQRT2


def _ihaar_axis(lo, hi, axis: int, out_len: int | None = None):
    y = torch.stack([(lo + hi) / _SQRT2, (lo - hi) / _SQRT2], dim=axis + 1).flatten(axis, axis + 1)
    if out_len is not None and y.shape[axis] != out_len:
        y = y.narrow(axis, y.shape[axis] - out_len, out_len)
    return y


def haar_patch3d(x, levels: int):
    """(B, C, T, H, W) -> (B, C 8^levels, (T - 1) / 2^l + 1, H / 2^l, W / 2^l)."""
    for _ in range(levels):
        for axis in (4, 3, 2):
            x = torch.cat(_haar_axis(x, axis, causal=axis == 2), dim=1)
    return x


def haar_unpatch3d(x, levels: int, t_out: int):
    """The exact inverse of haar_patch3d (t_out: the original frame count)."""
    ts = [t_out]
    for _ in range(levels - 1):
        ts.append((ts[-1] - 1) // 2 + 1)
    for lvl in range(levels):
        for axis in (2, 3, 4):
            c = x.shape[1] // 2
            x = _ihaar_axis(x[:, :c], x[:, c:], axis, ts[levels - 1 - lvl] if axis == 2 else None)
    return x


# -- primitives --

def causal_conv3d(m: nn.Conv3d, x, stride=(1, 1, 1)):
    kt, kh, kw = m.weight.shape[2:]
    return F.conv3d(time_pad(x, kt - 1), m.weight.to(x.dtype), m.bias.to(x.dtype), stride=stride,
                    padding=(0, kh // 2, kw // 2))


def group_norm1(m: nn.GroupNorm, x, eps: float = 1e-6):
    """Per-frame GroupNorm(1): f32 statistics over (C, H, W) of each (B, T)."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(1, 3, 4), keepdim=True, correction=0)
    y = (xf - mean).mul_(torch.rsqrt(var + eps))
    shape = (1, -1, 1, 1, 1)
    return y.mul_(m.weight.float().view(shape)).add_(m.bias.float().view(shape)).to(x.dtype)


def resnet_block(m, x):
    h = causal_conv3d(m.conv1, F.silu(group_norm1(m.norm1, x), inplace=True))
    h = causal_conv3d(m.conv2, F.silu(group_norm1(m.norm2, h), inplace=True))
    if m.shortcut is not None:
        x = torch.einsum("bcthw,dc->bdthw", x.float(), m.shortcut.weight.float())
        x = (x + m.shortcut.bias.float()[None, :, None, None, None]).to(h.dtype)
    return h.add_(x)


def _proj(lin: nn.Linear, x):
    return x @ lin.weight.float().T + lin.bias.float()


def spatial_attention(m, x, q_chunk: int):
    """One head over each frame's H W tokens, q_chunk query rows at a time."""
    B, C, T, H, W = x.shape
    tok = group_norm1(m.norm, x).permute(0, 2, 3, 4, 1).reshape(B * T, H * W, C).float()
    q, k, v = _proj(m.q, tok), _proj(m.k, tok), _proj(m.v, tok)
    kt = k.transpose(1, 2)
    out = torch.empty_like(q)
    for s0 in range(0, tok.shape[1], q_chunk):
        a = torch.softmax((q[:, s0:s0 + q_chunk] @ kt) * (1.0 / math.sqrt(C)), dim=-1)
        out[:, s0:s0 + q_chunk] = a @ v
    o = _proj(m.o, out).reshape(B, T, H, W, C).permute(0, 4, 1, 2, 3)
    return x + o.to(x.dtype)


def temporal_attention(m, x):
    """One head over each position's T frames, causal."""
    B, C, T, H, W = x.shape
    tok = group_norm1(m.norm, x).permute(0, 3, 4, 2, 1).reshape(B * H * W, T, C).float()
    q, k, v = _proj(m.q, tok), _proj(m.k, tok), _proj(m.v, tok)
    logits = (q @ k.transpose(1, 2)) / math.sqrt(C)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    a = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
    o = _proj(m.o, a @ v).reshape(B, H, W, T, C).permute(0, 4, 3, 1, 2)
    return x + o.to(x.dtype)


def upsample_causal(x, factor):
    """Nearest upsample as a copy; time T -> 2T - 1 when factor[0] is 2
    (every frame repeated but the first)."""
    ft, fh, fw = factor
    B, C, T, H, W = x.shape
    out = x.new_empty(B, C, T * ft, H * fh, W * fw)
    out.view(B, C, T, ft, H, fh, W, fw).copy_(x[:, :, :, None, :, None, :, None].expand(B, C, T, ft, H, fh, W, fw))
    return out[:, :, 1:] if ft == 2 else out


# -- modules (weight carriers; the functions above run them) --

def _conv(ci, co, device):
    return nn.Conv3d(ci, co, 3, dtype=F32, device=device)


def _gn1(c, device):
    return nn.GroupNorm(1, c, eps=1e-6, dtype=F32, device=device)


class ResnetBlock(nn.Module):
    def __init__(self, ci, co, device):
        super().__init__()
        self.norm1, self.conv1 = _gn1(ci, device), _conv(ci, co, device)
        self.norm2, self.conv2 = _gn1(co, device), _conv(co, co, device)
        self.shortcut = nn.Linear(ci, co, dtype=F32, device=device) if ci != co else None


class Attention(nn.Module):
    def __init__(self, c, device):
        super().__init__()
        self.norm = _gn1(c, device)
        self.q, self.k, self.v, self.o = (nn.Linear(c, c, dtype=F32, device=device) for _ in range(4))


class Mid(nn.Module):
    def __init__(self, c, device):
        super().__init__()
        self.res1, self.attn_s = ResnetBlock(c, c, device), Attention(c, device)
        self.attn_t, self.res2 = Attention(c, device), ResnetBlock(c, c, device)


class Level(nn.Module):
    def __init__(self, resnets, name=None, conv=None):
        super().__init__()
        self.res = nn.ModuleList(resnets)
        self.down = conv if name == "down" else None
        self.up = conv if name == "up" else None


def _chans(cfg: CosmosVAEConfig):
    return [cfg.base_channels] + [cfg.base_channels * m for m in cfg.channels_mult]


class Encoder(nn.Module):
    def __init__(self, cfg: CosmosVAEConfig, device):
        super().__init__()
        chans = _chans(cfg)
        self.conv_in = _conv(cfg.patch_channels, cfg.base_channels, device)
        self.levels = nn.ModuleList()
        ci = cfg.base_channels
        for i, co in enumerate(chans[1:]):
            res = [ResnetBlock(ci if j == 0 else co, co, device) for j in range(cfg.num_res_blocks)]
            ci = co
            self.levels.append(Level(res, "down", _conv(co, co, device) if cfg.downsample(i) else None))
        self.mid = Mid(chans[-1], device)
        self.norm_out = _gn1(chans[-1], device)
        self.conv_out = _conv(chans[-1], cfg.latent_channels, device)


class Decoder(nn.Module):
    def __init__(self, cfg: CosmosVAEConfig, device):
        super().__init__()
        chans = _chans(cfg)
        self.conv_in = _conv(cfg.latent_channels, chans[-1], device)
        self.mid = Mid(chans[-1], device)
        self.levels = nn.ModuleList()
        ci = chans[-1]
        for i in reversed(range(len(cfg.channels_mult))):
            co = chans[i + 1]
            res = [ResnetBlock(ci if j == 0 else co, co, device) for j in range(cfg.num_res_blocks + 1)]
            ci = co
            self.levels.append(Level(res, "up", _conv(co, co, device) if cfg.downsample(i) else None))
        self.norm_out = _gn1(chans[1], device)
        self.conv_out = _conv(chans[1], cfg.patch_channels, device)


def _mid(m: Mid, x, q_chunk: int):
    x = resnet_block(m.res1, x)
    x = spatial_attention(m.attn_s, x, q_chunk)
    x = temporal_attention(m.attn_t, x)
    return resnet_block(m.res2, x)


def encoder_forward(enc: Encoder, cfg: CosmosVAEConfig, x):
    x = causal_conv3d(enc.conv_in, haar_patch3d(x, cfg.wavelet_levels))
    for level in enc.levels:
        for r in level.res:
            x = resnet_block(r, x)
        if level.down is not None:
            x = causal_conv3d(level.down, x, stride=(2, 2, 2))
    x = _mid(enc.mid, x, cfg.attn_q_chunk)
    return causal_conv3d(enc.conv_out, F.silu(group_norm1(enc.norm_out, x), inplace=True))


def decoder_forward(dec: Decoder, cfg: CosmosVAEConfig, z, t_out: int):
    x = _mid(dec.mid, causal_conv3d(dec.conv_in, z), cfg.attn_q_chunk)
    for level in dec.levels:  # deepest -> shallowest
        for r in level.res:
            x = resnet_block(r, x)
        if level.up is not None:
            x = causal_conv3d(level.up, upsample_causal(x, (2, 2, 2)))
    x = causal_conv3d(dec.conv_out, F.silu(group_norm1(dec.norm_out, x), inplace=True))
    return haar_unpatch3d(x, cfg.wavelet_levels, t_out)


class CosmosVAE(nn.Module):
    """Standardised latents (B, 16, T', h, w) -> video (B, 3, 1 + 8 (T' - 1),
    8 h, 8 w) in [-1, 1] (`decode`), and video with 1 + 8k frames -> latents
    (`encode`). f32."""

    def __init__(self, cfg: CosmosVAEConfig = COSMOS_VAE_CV8x8x8, *, device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, device)
        self.decoder = Decoder(cfg, device)
        self.requires_grad_(False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator):
        """The JAX package's init_cosmos_vae_params distributions: conv and
        linear weights N(0, 1 / fan_in), zero biases, unit norms."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv3d, nn.Linear)):
                w = torch.randn(mod.weight.shape, generator=generator, device=mod.weight.device)
                mod.weight.copy_(w / math.sqrt(mod.weight[0].numel()))
                mod.bias.zero_()
        return self

    @property
    def device(self):
        return self.decoder.conv_in.weight.device

    def _stats(self, device):
        c = self.cfg
        mean = torch.zeros(c.latent_channels) if c.latents_mean is None else torch.tensor(c.latents_mean)
        std = torch.ones(c.latent_channels) if c.latents_std is None else torch.tensor(c.latents_std)
        return mean.float().view(1, -1, 1, 1, 1).to(device), std.float().view(1, -1, 1, 1, 1).to(device)

    @torch.no_grad()
    def encode(self, video):
        z = encoder_forward(self.encoder, self.cfg, video.to(self.device).float())
        mean, std = self._stats(z.device)
        return (z - mean) / std

    @torch.no_grad()
    def decode(self, z):
        z = z.to(self.device).float()
        mean, std = self._stats(z.device)
        t_out = (z.shape[2] - 1) * self.cfg.temporal_compression + 1
        return decoder_forward(self.decoder, self.cfg, z * std + mean, t_out).clamp_(-1.0, 1.0)

