"""Wan 2.1 causal 3-D VAE, decoder side (counterpart of
sparse_videogen_tpu/models/wan/vae.py; the encoder waits for Wan I2V).

Activations are channels-first (B, C, T, H, W) and weights keep the
checkpoint's (co, ci, kt, kh, kw) layout; per-frame 2-D convolutions run as
3-D ones with a (1, kh, kw) kernel, so no frame is transposed out. The
whole sequence is decoded at once with the exact non-streaming forms of the
reference's chunked decode:
  - causal conv3d: 2 * (kt // 2) leading zero frames;
  - temporal upsample: frame 0 passes untouched; frames 1.. run a causal
    conv (frame 0 not in their context) whose 2C output channels interleave
    into 2 frames each, slot-major;
  - RMS norm over channels: F.normalize * sqrt(C) * gamma, in f32.
`WanVAE.decode_streamed` is the reference's own per-chunk decode with a
per-conv cache of the last kt - 1 input frames: the same values as
`decode` up to summation order, with memory bounded by the chunk.

Parameter names: conv2, decoder.{conv1, middle.<j>, up.<i>.blocks.<j>,
up.<i>.resample.{conv, time_conv}, head_norm, head_conv}; a residual block
has norm1, conv1, norm2, conv2 (and shortcut), an attention block norm,
to_qkv, proj (io/checkpoint.convert_wan_vae maps the reference's names).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

WAN_LATENT_MEAN = np.array(
    [-0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
     0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921],
    np.float32,
)
WAN_LATENT_STD = np.array(
    [2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
     3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160],
    np.float32,
)
SPATIAL = 8  # pixels per latent, each side


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: tuple = ()
    temporal_downsample: tuple = (False, True, True)

    @property
    def temporal_upsample(self):
        return self.temporal_downsample[::-1]


# -- primitives (modules are weight carriers; these run them) --

def conv3d(m: nn.Module, x, *, t_pad=None):
    """x (B, C, T, H, W); a Conv3d's weight, or a Conv2d's as a (1, kh, kw)
    kernel; spatial 'same' padding and t_pad leading zero frames (by
    default the causal 2 * (kt // 2))."""
    w = m.weight if m.weight.dim() == 5 else m.weight.unsqueeze(2)
    kt, kh, kw = w.shape[2:]
    t_pad = 2 * (kt // 2) if t_pad is None else t_pad
    if t_pad:
        x = F.pad(x, (0, 0, 0, 0, t_pad, 0))
    return F.conv3d(x, w.to(x.dtype), m.bias.to(x.dtype), padding=(0, kh // 2, kw // 2))


def vae_rms_norm(gamma, x, eps=1e-12):
    """F.normalize over channels * sqrt(C) * gamma, in f32."""
    xf = x.float()
    n = torch.linalg.vector_norm(xf, dim=1, keepdim=True)
    y = xf / n.clamp_min(eps) * math.sqrt(x.shape[1])
    return (y * gamma.float().view(1, -1, *([1] * (x.dim() - 2)))).to(x.dtype)


def residual_block(m, x):
    h = conv3d(m.shortcut, x) if m.shortcut is not None else x
    y = conv3d(m.conv1, F.silu(vae_rms_norm(m.norm1, x), inplace=True))
    y = conv3d(m.conv2, F.silu(vae_rms_norm(m.norm2, y), inplace=True))
    return y.add_(h)


def attention_block(m, x):
    """Single-head spatial self-attention per frame."""
    B, C, T, H, W = x.shape
    qkv = conv3d(m.to_qkv, vae_rms_norm(m.norm, x)).view(B, 3, C, T, H * W)
    q, k, v = (qkv[:, i].permute(0, 2, 3, 1).reshape(B * T, H * W, C) for i in range(3))
    s = (q @ k.transpose(1, 2)).float() / math.sqrt(C)
    o = torch.softmax(s, dim=-1).to(v.dtype) @ v
    o = o.view(B, T, H, W, C).permute(0, 4, 1, 2, 3)
    return x + conv3d(m.proj, o)


def nearest2x(x):
    """Nearest 2x in H and W as an expand + reshape copy: F.interpolate's
    CUDA nearest kernel returns wrong values past 2^31 output elements
    (480p x 81 frames at 192 channels is 6.2e9)."""
    B, C, T, H, W = x.shape
    return x[:, :, :, :, None, :, None].expand(B, C, T, H, 2, W, 2).reshape(B, C, T, 2 * H, 2 * W)


def spatial_upsample(m, x):
    """Nearest 2x in H and W, then the 3x3 conv (dim -> dim // 2)."""
    return conv3d(m.conv, nearest2x(x))


def _interleave(y, C):
    """(B, 2C, T, H, W), channel groups slot-major -> (B, C, 2T, H, W)."""
    B, _, T, H, W = y.shape
    return y.view(B, 2, C, T, H, W).permute(0, 2, 3, 1, 4, 5).reshape(B, C, 2 * T, H, W)


def temporal_upsample(m, x):
    if x.shape[2] == 1:
        return x
    return torch.cat([x[:, :, :1], _interleave(conv3d(m.time_conv, x[:, :, 1:]), x.shape[1])], dim=2)


# -- modules --

def _conv3d(ci, co, k, dtype, device):
    return nn.Conv3d(ci, co, k, dtype=dtype, device=device)


def _conv2d(ci, co, k, dtype, device):
    return nn.Conv2d(ci, co, k, dtype=dtype, device=device)


class ResidualBlock(nn.Module):
    def __init__(self, ci, co, dtype, device):
        super().__init__()
        self.norm1 = nn.Parameter(torch.ones(ci, dtype=torch.float32, device=device))
        self.conv1 = _conv3d(ci, co, 3, dtype, device)
        self.norm2 = nn.Parameter(torch.ones(co, dtype=torch.float32, device=device))
        self.conv2 = _conv3d(co, co, 3, dtype, device)
        self.shortcut = _conv3d(ci, co, 1, dtype, device) if ci != co else None


class AttentionBlock(nn.Module):
    def __init__(self, c, dtype, device):
        super().__init__()
        self.norm = nn.Parameter(torch.ones(c, dtype=torch.float32, device=device))
        self.to_qkv = _conv2d(c, 3 * c, 1, dtype, device)
        self.proj = _conv2d(c, c, 1, dtype, device)


class Resample(nn.Module):
    def __init__(self, co, temporal, dtype, device):
        super().__init__()
        self.conv = _conv2d(co, co // 2, 3, dtype, device)
        self.time_conv = _conv3d(co, 2 * co, (3, 1, 1), dtype, device) if temporal else None


class UpStage(nn.Module):
    def __init__(self, blocks, resample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.resample = resample


class Decoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, dtype, device):
        super().__init__()
        dims = [cfg.dim * u for u in (cfg.dim_mult[-1],) + tuple(cfg.dim_mult[::-1])]
        self.conv1 = _conv3d(cfg.z_dim, dims[0], 3, dtype, device)
        self.middle = nn.ModuleList([ResidualBlock(dims[0], dims[0], dtype, device),
                                     AttentionBlock(dims[0], dtype, device),
                                     ResidualBlock(dims[0], dims[0], dtype, device)])
        self.up = nn.ModuleList()
        for i, (ci, co) in enumerate(zip(dims[:-1], dims[1:])):
            cin = ci // 2 if i in (1, 2, 3) else ci  # the resample before halves the channels
            blocks = [ResidualBlock(cin if j == 0 else co, co, dtype, device) for j in range(cfg.num_res_blocks + 1)]
            last = i == len(cfg.dim_mult) - 1
            self.up.append(UpStage(blocks, None if last else Resample(co, cfg.temporal_upsample[i], dtype, device)))
        self.head_norm = nn.Parameter(torch.ones(dims[-1], dtype=torch.float32, device=device))
        self.head_conv = _conv3d(dims[-1], 3, 3, dtype, device)


def _block(m, x):
    return residual_block(m, x) if isinstance(m, ResidualBlock) else attention_block(m, x)


def decoder_forward(dec: Decoder, x):
    x = conv3d(dec.conv1, x)
    for blk in dec.middle:
        x = _block(blk, x)
    for stage in dec.up:
        for blk in stage.blocks:
            x = _block(blk, x)
        if stage.resample is not None:
            if stage.resample.time_conv is not None:
                x = temporal_upsample(stage.resample, x)
            x = spatial_upsample(stage.resample, x)
    x = F.silu(vae_rms_norm(dec.head_norm, x), inplace=True)
    return conv3d(dec.head_conv, x)


# -- the streamed decode --

class _TCache:
    """Per-conv temporal state of a streamed decode, pulled and pushed in the
    decoder's fixed traversal order; None is the stream's start (zero
    history, the whole decode's causal pad)."""

    def __init__(self, old):
        self.old = old
        self.idx = 0
        self.new = []

    def pull(self):
        c = None if self.old is None else self.old[self.idx]
        self.idx += 1
        return c

    def push(self, c):
        self.new.append(c)


def _conv3d_stream(m, x, tc, *, activation=False):
    """Causal conv3d over a chunk with the last kt - 1 input frames carried
    (always exactly kt - 1: short first chunks stay zero-filled on the left);
    the cache holds the input before the SiLU."""
    kt = m.weight.shape[2]
    if kt == 1:
        return conv3d(m, F.silu(x) if activation else x, t_pad=0)
    cache = tc.pull()
    if cache is None:
        cache = x.new_zeros(x.shape[:2] + (kt - 1,) + x.shape[3:])
    xin = torch.cat([cache, x], dim=2)
    tc.push(xin[:, :, -(kt - 1):].clone())
    if activation:
        F.silu(xin, inplace=True)
    return conv3d(m, xin, t_pad=0)


def _res_stream(m, x, tc):
    h = conv3d(m.shortcut, x, t_pad=0) if m.shortcut is not None else x
    y = _conv3d_stream(m.conv1, vae_rms_norm(m.norm1, x), tc, activation=True)
    y = _conv3d_stream(m.conv2, vae_rms_norm(m.norm2, y), tc, activation=True)
    return y.add_(h)


def _temporal_upsample_stream(m, x, tc, first):
    head = x[:, :, :1] if first else x[:, :, :0]
    rest = x[:, :, 1:] if first else x
    if rest.shape[2] == 0:
        tc.pull()
        tc.push(None)  # the stream has not started; the next chunk zero-pads
        return head
    return torch.cat([head, _interleave(_conv3d_stream(m.time_conv, rest, tc), x.shape[1])], dim=2)


def decoder_forward_stream(dec: Decoder, x, tstate, first):
    """One chunk through the decoder; returns (pixels, the new state)."""
    tc = _TCache(tstate)
    x = _conv3d_stream(dec.conv1, x, tc)
    for blk in dec.middle:
        x = _res_stream(blk, x, tc) if isinstance(blk, ResidualBlock) else attention_block(blk, x)
    for stage in dec.up:
        for blk in stage.blocks:
            x = _res_stream(blk, x, tc) if isinstance(blk, ResidualBlock) else attention_block(blk, x)
        if stage.resample is not None:
            if stage.resample.time_conv is not None:
                x = _temporal_upsample_stream(stage.resample, x, tc, first)
            x = spatial_upsample(stage.resample, x)
    x = _conv3d_stream(dec.head_conv, vae_rms_norm(dec.head_norm, x), tc, activation=True)
    return x, tc.new


class WanVAE(nn.Module):
    """Normalised latents (B, z_dim, T, h, w) -> video (B, 3, 1 + 4 (T - 1),
    8 h, 8 w) in [-1, 1]. Weights f32 by default, as the JAX package's."""

    def __init__(self, cfg: WanVAEConfig = WanVAEConfig(), *, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.conv2 = _conv3d(cfg.z_dim, cfg.z_dim, 1, dtype, device)
        self.decoder = Decoder(cfg, dtype, device)
        self.requires_grad_(False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator):
        """The JAX package's init_wan_vae_params distributions: conv weights
        N(0, 1 / fan_in), zero biases, unit norms, and a zero output
        projection in each attention block."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Conv3d)):
                w = torch.randn(mod.weight.shape, generator=generator, device=mod.weight.device)
                mod.weight.copy_(w / math.sqrt(mod.weight[0].numel()))
                mod.bias.zero_()
            elif isinstance(mod, AttentionBlock):
                mod.proj.weight.zero_()
        return self

    def latent_input(self, z):
        """The decoder's input: z * std + mean (zeros and ones for another
        z_dim), then conv2. The tables are f32, so bf16 latents are promoted,
        as in the JAX package."""
        dev, c = self.conv2.weight.device, self.cfg.z_dim
        if c == len(WAN_LATENT_MEAN):
            mean, std = (torch.as_tensor(a, device=dev).view(1, c, 1, 1, 1) for a in (WAN_LATENT_MEAN, WAN_LATENT_STD))
        else:
            mean, std = (torch.full((1, c, 1, 1, 1), v, device=dev) for v in (0.0, 1.0))
        return conv3d(self.conv2, z.to(dev) * std + mean, t_pad=0)

    @torch.no_grad()
    def decode(self, z):
        """The whole sequence at once."""
        return decoder_forward(self.decoder, self.latent_input(z)).clamp_(-1.0, 1.0)

    @torch.no_grad()
    def decode_streamed(self, z, chunk: int = 2):
        """In `chunk`-latent-frame chunks with the per-conv cache."""
        x = self.latent_input(z)
        outs, tstate = [], None
        for s in range(0, x.shape[2], chunk):
            y, tstate = decoder_forward_stream(self.decoder, x[:, :, s:s + chunk], tstate, s == 0)
            outs.append(y.clamp_(-1.0, 1.0))
        return torch.cat(outs, dim=2)
