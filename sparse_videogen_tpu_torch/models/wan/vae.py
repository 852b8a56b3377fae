"""Wan 2.1 causal 3-D VAE, decoder and encoder (counterpart of
sparse_videogen_tpu/models/wan/vae.py).

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
The encoder (Wan I2V's image latents) likewise, whole:
  - spatial downsample: zero pad right and bottom by 1, a stride-2 3x3 conv;
  - temporal downsample: frame 0 passes through; then a stride-2, kernel-3,
    unpadded conv over all frames (windows [0, 2], [2, 4], ...);
  - the 1x1x1 conv1 to 2 z_dim channels; the mean half, (mu - mean) / std.
`WanVAE.decode_streamed` is the reference's own per-chunk decode with a
per-conv cache of the last kt - 1 input frames, and `encode_streamed` its
per-chunk encode (frame 0, then 4 frames a chunk; a temporal downsample
caches its last input frame): the same values as `decode` / `encode` up to
summation order, with memory bounded by the chunk.

Parameter names: conv2, decoder.{conv1, middle.<j>, up.<i>.blocks.<j>,
up.<i>.resample.{conv, time_conv}, head_norm, head_conv}; with the encoder
(WanVAE(encoder=True)) also conv1, encoder.{conv1, down.<i>.blocks.<j>,
down.<i>.resample.{conv, time_conv}, middle.<j>, head_norm, head_conv}; a
residual block has norm1, conv1, norm2, conv2 (and shortcut), an attention
block norm, to_qkv, proj (io/checkpoint.convert_wan_vae maps the
reference's names).
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


def spatial_downsample(m, x):
    """Zero pad right and bottom by 1, then the 3x3 conv with stride 2."""
    w = m.conv.weight.unsqueeze(2)
    return F.conv3d(F.pad(x, (0, 1, 0, 1)), w.to(x.dtype), m.conv.bias.to(x.dtype), stride=(1, 2, 2))


def _time_conv_s2(m, x):
    """The temporal downsample's conv: kernel 3, stride 2, no padding."""
    return F.conv3d(x, m.time_conv.weight.to(x.dtype), m.time_conv.bias.to(x.dtype), stride=(2, 1, 1))


def temporal_downsample(m, x):
    """Frame 0 passes through; then the stride-2 conv over all frames."""
    return torch.cat([x[:, :, :1], _time_conv_s2(m, x)], dim=2)


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


class Downsample(nn.Module):
    def __init__(self, co, temporal, dtype, device):
        super().__init__()
        self.conv = _conv2d(co, co, 3, dtype, device)
        self.time_conv = _conv3d(co, co, (3, 1, 1), dtype, device) if temporal else None


class Stage(nn.Module):
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
            self.up.append(Stage(blocks, None if last else Resample(co, cfg.temporal_upsample[i], dtype, device)))
        self.head_norm = nn.Parameter(torch.ones(dims[-1], dtype=torch.float32, device=device))
        self.head_conv = _conv3d(dims[-1], 3, 3, dtype, device)


class Encoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, dtype, device):
        super().__init__()
        dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
        self.conv1 = _conv3d(3, dims[0], 3, dtype, device)
        self.down = nn.ModuleList()
        for i, (ci, co) in enumerate(zip(dims[:-1], dims[1:])):
            blocks = [ResidualBlock(ci if j == 0 else co, co, dtype, device) for j in range(cfg.num_res_blocks)]
            last = i == len(cfg.dim_mult) - 1
            self.down.append(Stage(blocks, None if last else Downsample(co, cfg.temporal_downsample[i], dtype,
                                                                           device)))
        self.middle = nn.ModuleList([ResidualBlock(dims[-1], dims[-1], dtype, device),
                                     AttentionBlock(dims[-1], dtype, device),
                                     ResidualBlock(dims[-1], dims[-1], dtype, device)])
        self.head_norm = nn.Parameter(torch.ones(dims[-1], dtype=torch.float32, device=device))
        self.head_conv = _conv3d(dims[-1], 2 * cfg.z_dim, 3, dtype, device)


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


def encoder_forward(enc: Encoder, x):
    x = conv3d(enc.conv1, x)
    for stage in enc.down:
        for blk in stage.blocks:
            x = _block(blk, x)
        if stage.resample is not None:
            x = spatial_downsample(stage.resample, x)
            if stage.resample.time_conv is not None:
                x = temporal_downsample(stage.resample, x)
    for blk in enc.middle:
        x = _block(blk, x)
    x = F.silu(vae_rms_norm(enc.head_norm, x), inplace=True)
    return conv3d(enc.head_conv, x)


# -- the streamed decode and encode --

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


def _temporal_downsample_stream(m, x, tc, first):
    """The first chunk's frame passes through; later chunks continue the
    stride-2 conv from the cached last input frame of the chunk before."""
    cache = tc.pull()
    tc.push(x[:, :, -1:].clone())
    if first:
        return x
    return _time_conv_s2(m, torch.cat([cache, x], dim=2))


def encoder_forward_stream(enc: Encoder, x, tstate, first):
    """One chunk through the encoder; returns (features, the new state)."""
    tc = _TCache(tstate)
    x = _conv3d_stream(enc.conv1, x, tc)
    for stage in enc.down:
        for blk in stage.blocks:
            x = _res_stream(blk, x, tc) if isinstance(blk, ResidualBlock) else attention_block(blk, x)
        if stage.resample is not None:
            x = spatial_downsample(stage.resample, x)
            if stage.resample.time_conv is not None:
                x = _temporal_downsample_stream(stage.resample, x, tc, first)
    for blk in enc.middle:
        x = _res_stream(blk, x, tc) if isinstance(blk, ResidualBlock) else attention_block(blk, x)
    x = _conv3d_stream(enc.head_conv, vae_rms_norm(enc.head_norm, x), tc, activation=True)
    return x, tc.new


class WanVAE(nn.Module):
    """Normalised latents (B, z_dim, T, h, w) -> video (B, 3, 1 + 4 (T - 1),
    8 h, 8 w) in [-1, 1], and with `encoder=True` video (B, 3, 1 + 4 k, H, W)
    -> normalised latent means (B, z_dim, 1 + k, H / 8, W / 8). Weights f32
    by default, as the JAX package's."""

    def __init__(self, cfg: WanVAEConfig = WanVAEConfig(), *, dtype=torch.float32, device="cpu",
                 encoder: bool = False):
        super().__init__()
        self.cfg = cfg
        self.conv2 = _conv3d(cfg.z_dim, cfg.z_dim, 1, dtype, device)
        self.decoder = Decoder(cfg, dtype, device)
        # registered after the decoder, so init_random draws the decoder's
        # weights as a decoder-only VAE does
        self.encoder = Encoder(cfg, dtype, device) if encoder else None
        self.conv1 = _conv3d(2 * cfg.z_dim, 2 * cfg.z_dim, 1, dtype, device) if encoder else None
        self.requires_grad_(False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator):
        """The JAX package's init_wan_vae_params distributions: conv weights
        N(0, 1 / fan_in), zero biases, unit norms, and a zero output
        projection in each attention block. The projections are zeroed after
        the draws (modules() visits a block before its proj), so every other
        conv takes the same draws as when proj was drawn too."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Conv3d)):
                w = torch.randn(mod.weight.shape, generator=generator, device=mod.weight.device)
                mod.weight.copy_(w / math.sqrt(mod.weight[0].numel()))
                mod.bias.zero_()
        for mod in self.modules():
            if isinstance(mod, AttentionBlock):
                mod.proj.weight.zero_()
                mod.proj.bias.zero_()
        return self

    def _latent_scale(self):
        """(mean, std) of the latents, (1, z_dim, 1, 1, 1) f32 (zeros and ones
        for another z_dim than the published 16)."""
        dev, c = self.conv2.weight.device, self.cfg.z_dim
        if c == len(WAN_LATENT_MEAN):
            return tuple(torch.as_tensor(a, device=dev).view(1, c, 1, 1, 1) for a in (WAN_LATENT_MEAN, WAN_LATENT_STD))
        return tuple(torch.full((1, c, 1, 1, 1), v, device=dev) for v in (0.0, 1.0))

    def latent_input(self, z):
        """The decoder's input: z * std + mean, then conv2. The tables are
        f32, so bf16 latents are promoted, as in the JAX package."""
        mean, std = self._latent_scale()
        return conv3d(self.conv2, z.to(mean.device) * std + mean, t_pad=0)

    def _latent_output(self, y):
        """The encoder's features -> conv1 (1x1x1), the mean half, normalised."""
        mean, std = self._latent_scale()
        return (conv3d(self.conv1, y, t_pad=0)[:, : self.cfg.z_dim] - mean) / std

    def _encoder(self) -> Encoder:
        if self.encoder is None:
            raise ValueError("this WanVAE was built without its encoder: WanVAE(cfg, encoder=True)")
        return self.encoder

    @torch.no_grad()
    def encode(self, video):
        """The whole sequence at once: video (B, 3, T, H, W) in [-1, 1] ->
        the normalised latent mean (B, z_dim, T', H / 8, W / 8)."""
        enc = self._encoder()
        return self._latent_output(encoder_forward(enc, video.to(self.conv2.weight.device)))

    @torch.no_grad()
    def encode_streamed(self, video):
        """The reference's chunks: frame 0, then 4 frames at a time, with the
        per-conv cache; T must be 1 + 4 k. The same function as `encode`,
        with memory bounded by a chunk of 4 frames."""
        enc = self._encoder()
        T = video.shape[2]
        if (T - 1) % 4:
            raise ValueError(f"encode_streamed takes 1 + 4 k frames, got {T}")
        video = video.to(self.conv2.weight.device)
        outs, tstate = [], None
        for s, e in [(0, 1)] + [(1 + 4 * i, 5 + 4 * i) for i in range((T - 1) // 4)]:
            y, tstate = encoder_forward_stream(enc, video[:, :, s:e], tstate, s == 0)
            outs.append(y)
        return self._latent_output(torch.cat(outs, dim=2))

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
