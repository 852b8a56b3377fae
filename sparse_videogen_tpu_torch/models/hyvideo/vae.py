"""HunyuanVideo's causal 3-D VAE, 884-16c-hy (counterpart of
sparse_videogen_tpu/models/hyvideo/vae.py): 4x time and 8x space
compression, 16 latent channels.

  encoder: conv_in -> 4 down blocks (layers_per_block resnets each; a
  stride-2 spatial downsample in blocks 0-2, temporal too in blocks 1-2) ->
  mid (resnet, frame-causal attention, resnet) -> GroupNorm, SiLU, conv_out
  (2 z channels) -> quant_conv (1x1x1); the latents are the mean half times
  the scaling factor (or a sample, given a generator).
  decoder: latents / scaling factor -> post_quant_conv (1x1x1) -> conv_in
  -> mid -> 4 up blocks (layers_per_block + 1 resnets each; a nearest 2x
  upsample in space in blocks 0-2, in time too in blocks 1-2, where the
  FIRST frame is upsampled in space only, then a conv) -> GroupNorm, SiLU,
  conv_out. No clip: the writer clips.

Every conv is a CausalConv3d: replicate padding, H and W by k // 2 on both
sides and T by k - 1 frames in front, then a valid convolution (strided in
a downsample). Activations are channels-first (B, C, T, H, W) in f32, and
the weights keep the checkpoint's (co, ci, kt, kh, kw) layout (cuDNN's
conv3d on the card). GroupNorm (eps 1e-6) takes f32 statistics over (C/G,
T, H, W). The mid attention is one head over all T H W tokens with a
frame-causal mask, f32, queries in chunks of 4,096 rows, so that no (S, S)
matrix is ever whole (S = 33 x 32 x 32 in a 720p decode tile: 4.4 GB).

A 720p tile's activations pass 2^31 elements (129 x 256 x 256 x 256), where
the card's torch gets F.interpolate's nearest mode wrong (ROADMAP.md
section 3). So the padding, the upsample and the group norm here are
strided copies and reductions (TensorIterator, 64-bit indexing), never
F.pad's replicate mode, F.interpolate or F.group_norm.

Parameter names: {encoder, decoder}.conv_in, encoder.down.<i>.res.<j>,
encoder.down.<i>.ds, decoder.up.<i>.res.<j>, decoder.up.<i>.us,
{encoder, decoder}.mid.{res0, attn.{norm, q, k, v, o}, res1},
{encoder, decoder}.{norm_out, conv_out}, quant_conv, post_quant_conv; a
resnet holds norm1, conv1, norm2, conv2 (and shortcut)
(io/checkpoint.convert_hyvideo_vae maps the reference's names).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class HyVideoVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 16
    norm_num_groups: int = 32
    scaling_factor: float = 0.476986
    time_compression: int = 4
    spatial_compression: int = 8

    @property
    def num_blocks(self) -> int:
        return len(self.block_out_channels)

    def spatial_ds(self, i) -> bool:  # encoder order
        return i < int(math.log2(self.spatial_compression))

    def temporal_ds(self, i) -> bool:
        return i >= (self.num_blocks - 1 - int(math.log2(self.time_compression))) and i != self.num_blocks - 1


# -- primitives --

def replicate_pad(x, pt: int, ph: int, pw: int):
    """Edge padding: pt frames in front, ph rows and pw columns on both sides."""
    if not (pt or ph or pw):
        return x
    B, C, T, H, W = x.shape
    out = x.new_empty(B, C, T + pt, H + 2 * ph, W + 2 * pw)
    out[:, :, pt:, ph:ph + H, pw:pw + W] = x
    body = out[:, :, pt:, ph:ph + H]
    if pw:
        body[..., :pw] = x[..., :1]
        body[..., pw + W:] = x[..., -1:]
    if ph:
        out[:, :, pt:, :ph] = out[:, :, pt:, ph:ph + 1]
        out[:, :, pt:, ph + H:] = out[:, :, pt:, ph + H - 1:ph + H]
    if pt:
        out[:, :, :pt] = out[:, :, pt:pt + 1]
    return out


def causal_conv3d(m: nn.Conv3d, x, stride=(1, 1, 1)):
    kt, kh, kw = m.weight.shape[2:]
    x = replicate_pad(x, kt - 1, kh // 2, kw // 2)
    return F.conv3d(x, m.weight.to(x.dtype), m.bias.to(x.dtype), stride=stride)


def plain_conv3d_1x1(m: nn.Conv3d, x):
    """A 1x1x1 conv as a pointwise f32 matmul."""
    w = m.weight.float()[:, :, 0, 0, 0]
    y = torch.einsum("bcthw,dc->bdthw", x.float(), w)
    return (y + m.bias.float()[None, :, None, None, None]).to(x.dtype)


def group_norm(m: nn.GroupNorm, x, groups: int, eps: float = 1e-6):
    """f32 statistics over (C/G, T, H, W), the affine in f32."""
    B, C = x.shape[:2]
    xf = x.float().reshape(B, groups, -1)
    var, mean = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mean).mul_(torch.rsqrt(var + eps)).view(x.shape)
    shape = (1, C) + (1,) * (x.dim() - 2)
    return y.mul_(m.weight.float().view(shape)).add_(m.bias.float().view(shape)).to(x.dtype)


def resnet_block(m, x, groups: int):
    h = causal_conv3d(m.conv1, F.silu(group_norm(m.norm1, x, groups), inplace=True))
    h = causal_conv3d(m.conv2, F.silu(group_norm(m.norm2, h, groups), inplace=True))
    if m.shortcut is not None:
        x = causal_conv3d(m.shortcut, x)
    return h.add_(x)


def _linear_f32(lin: nn.Linear, x):
    return x @ lin.weight.float().T + lin.bias.float()


def mid_attention(m, x, groups: int, q_chunk: int = 4096):
    """One head over the T H W tokens, frame-causal, f32, q_chunk query rows
    at a time; residual."""
    B, C, T, H, W = x.shape
    S = T * H * W
    hs = group_norm(m.norm, x, groups).reshape(B, C, S).transpose(1, 2).float()
    q, k, v = (_linear_f32(lin, hs) for lin in (m.q, m.k, m.v))
    frame = torch.arange(S, device=x.device) // (H * W)
    out = torch.empty_like(q)
    kt = k.transpose(1, 2)
    for s0 in range(0, S, q_chunk):
        s = (q[:, s0:s0 + q_chunk] @ kt) * C**-0.5
        s.masked_fill_((frame[s0:s0 + q_chunk, None] < frame[None, :])[None], float("-inf"))
        out[:, s0:s0 + q_chunk] = torch.softmax(s, dim=-1) @ v
    o = _linear_f32(m.o, out)
    return x + o.transpose(1, 2).reshape(B, C, T, H, W).to(x.dtype)


def _repeat(x, ft: int, fh: int, fw: int, out=None):
    """Nearest upsample by (ft, fh, fw) as a broadcast copy into `out`."""
    B, C, T, H, W = x.shape
    if out is None:
        out = x.new_empty(B, C, T * ft, H * fh, W * fw)
    out.view(B, C, T, ft, H, fh, W, fw).copy_(x[:, :, :, None, :, None, :, None].expand(B, C, T, ft, H, fh, W, fw))
    return out


def upsample_nearest(x, factor):
    """Nearest upsample; with ft == 2 the first frame in space only."""
    ft, fh, fw = factor
    B, C, T, H, W = x.shape
    if ft == 1 or T == 1:
        return _repeat(x, 1, fh, fw)
    out = x.new_empty(B, C, 1 + (T - 1) * ft, H * fh, W * fw)
    _repeat(x[:, :, :1], 1, fh, fw, out[:, :, :1])
    _repeat(x[:, :, 1:], ft, fh, fw, out[:, :, 1:])
    return out


# -- modules (weight carriers; the functions above run them) --

def _conv(ci, co, k, device):
    return nn.Conv3d(ci, co, k, dtype=F32, device=device)


def _norm(c, groups, device):
    return nn.GroupNorm(groups, c, eps=1e-6, dtype=F32, device=device)


class ResnetBlock(nn.Module):
    def __init__(self, ci, co, groups, device):
        super().__init__()
        self.norm1, self.conv1 = _norm(ci, groups, device), _conv(ci, co, 3, device)
        self.norm2, self.conv2 = _norm(co, groups, device), _conv(co, co, 3, device)
        self.shortcut = _conv(ci, co, 1, device) if ci != co else None


class MidAttention(nn.Module):
    def __init__(self, c, groups, device):
        super().__init__()
        self.norm = _norm(c, groups, device)
        self.q, self.k, self.v, self.o = (nn.Linear(c, c, dtype=F32, device=device) for _ in range(4))


class MidBlock(nn.Module):
    def __init__(self, c, groups, device):
        super().__init__()
        self.res0 = ResnetBlock(c, c, groups, device)
        self.attn = MidAttention(c, groups, device)
        self.res1 = ResnetBlock(c, c, groups, device)


class Stage(nn.Module):
    def __init__(self, resnets, resample_name=None, resample=None):
        super().__init__()
        self.res = nn.ModuleList(resnets)
        self.ds = resample if resample_name == "ds" else None
        self.us = resample if resample_name == "us" else None


class Encoder(nn.Module):
    def __init__(self, cfg: HyVideoVAEConfig, device):
        super().__init__()
        bo, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = _conv(cfg.in_channels, bo[0], 3, device)
        self.down = nn.ModuleList()
        ch = bo[0]
        for i in range(cfg.num_blocks):
            res = [ResnetBlock(ch if j == 0 else bo[i], bo[i], g, device) for j in range(cfg.layers_per_block)]
            ds = _conv(bo[i], bo[i], 3, device) if cfg.spatial_ds(i) or cfg.temporal_ds(i) else None
            self.down.append(Stage(res, "ds", ds))
            ch = bo[i]
        self.mid = MidBlock(bo[-1], g, device)
        self.norm_out = _norm(bo[-1], g, device)
        self.conv_out = _conv(bo[-1], 2 * cfg.latent_channels, 3, device)


class Decoder(nn.Module):
    def __init__(self, cfg: HyVideoVAEConfig, device):
        super().__init__()
        rev, g = tuple(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = _conv(cfg.latent_channels, rev[0], 3, device)
        self.mid = MidBlock(rev[0], g, device)
        self.up = nn.ModuleList()
        ch = rev[0]
        for i in range(cfg.num_blocks):
            res = [ResnetBlock(ch if j == 0 else rev[i], rev[i], g, device) for j in range(cfg.layers_per_block + 1)]
            us = _conv(rev[i], rev[i], 3, device) if cfg.spatial_ds(i) or cfg.temporal_ds(i) else None
            self.up.append(Stage(res, "us", us))
            ch = rev[i]
        self.norm_out = _norm(rev[-1], g, device)
        self.conv_out = _conv(rev[-1], cfg.out_channels, 3, device)


def _factor(cfg: HyVideoVAEConfig, i: int):
    s = 2 if cfg.spatial_ds(i) else 1
    return (2 if cfg.temporal_ds(i) else 1, s, s)


def _mid(m: MidBlock, x, g):
    return resnet_block(m.res1, mid_attention(m.attn, resnet_block(m.res0, x, g), g), g)


def encoder_forward(enc: Encoder, cfg: HyVideoVAEConfig, x):
    g = cfg.norm_num_groups
    x = causal_conv3d(enc.conv_in, x)
    for i, stage in enumerate(enc.down):
        for r in stage.res:
            x = resnet_block(r, x, g)
        if stage.ds is not None:
            x = causal_conv3d(stage.ds, x, stride=_factor(cfg, i))
    x = _mid(enc.mid, x, g)
    return causal_conv3d(enc.conv_out, F.silu(group_norm(enc.norm_out, x, g), inplace=True))


def decoder_forward(dec: Decoder, cfg: HyVideoVAEConfig, z):
    g = cfg.norm_num_groups
    x = _mid(dec.mid, causal_conv3d(dec.conv_in, z), g)
    for i, stage in enumerate(dec.up):
        for r in stage.res:
            x = resnet_block(r, x, g)
        if stage.us is not None:
            x = causal_conv3d(stage.us, upsample_nearest(x, _factor(cfg, i)))
    return causal_conv3d(dec.conv_out, F.silu(group_norm(dec.norm_out, x, g), inplace=True))


class HyVideoVAE(nn.Module):
    """Latents (B, 16, T', h, w) -> video (B, 3, 1 + 4 (T' - 1), 8 h, 8 w)
    in about [-1, 1] (`decode`), and video -> latents (`encode`). f32."""

    def __init__(self, cfg: HyVideoVAEConfig = HyVideoVAEConfig(), *, device="cpu"):
        super().__init__()
        self.cfg = cfg
        z = cfg.latent_channels
        self.encoder = Encoder(cfg, device)
        self.decoder = Decoder(cfg, device)
        self.quant_conv = _conv(2 * z, 2 * z, 1, device)
        self.post_quant_conv = _conv(z, z, 1, device)
        self.requires_grad_(False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator):
        """The JAX package's init_hyvideo_vae_params distributions: conv
        weights N(0, 1 / fan_in), linears N(0, 1 / d_in), zero biases, unit
        norms."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv3d, nn.Linear)):
                w = torch.randn(mod.weight.shape, generator=generator, device=mod.weight.device)
                mod.weight.copy_(w / math.sqrt(mod.weight[0].numel()))
                mod.bias.zero_()
        return self

    @property
    def device(self):
        return self.post_quant_conv.weight.device

    @torch.no_grad()
    def decode(self, z):
        z = plain_conv3d_1x1(self.post_quant_conv, z.to(self.device).float() / self.cfg.scaling_factor)
        return decoder_forward(self.decoder, self.cfg, z)

    @torch.no_grad()
    def encode(self, video, generator: torch.Generator | None = None):
        """The mean latents times the scaling factor; with a generator, a
        sample (log-variance clipped to [-30, 20])."""
        h = encoder_forward(self.encoder, self.cfg, video.to(self.device).float())
        mean, logvar = plain_conv3d_1x1(self.quant_conv, h).chunk(2, dim=1)
        if generator is not None:
            std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
            mean = mean + std * torch.randn(mean.shape, generator=generator, device=mean.device)
        return mean * self.cfg.scaling_factor


def vae_decode(vae: HyVideoVAE, z):
    """Functional spelling of HyVideoVAE.decode, as the JAX package names it."""
    return vae.decode(z)


def vae_encode(vae: HyVideoVAE, video, generator: torch.Generator | None = None):
    """Functional spelling of HyVideoVAE.encode, as the JAX package names it."""
    return vae.encode(video, generator)
