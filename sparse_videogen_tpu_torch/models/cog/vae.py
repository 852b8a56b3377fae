"""CogVideoX's causal-3D VAE, v1.0 and v1.5 (counterpart of
sparse_videogen_tpu/models/cog/vae.py): 4x time and 8x space compression,
16 latent channels.

  encoder: causal conv_in -> 4 down blocks (layers_per_block resnets each;
  a zero-padded (right, bottom) stride-2 per-frame conv in blocks 0-2, after
  a pairwise temporal mean in blocks 0-1 that keeps an odd clip's frame 0
  alone) -> mid (2 resnets) -> GroupNorm, SiLU, conv_out (2 z channels); the
  latents are the mean half (`scale_latents` then maps them into the DiT's
  space: v1.5 divides by 0.7, `invert_scale_latents`).
  decoder: latents / scaling factor -> causal conv_in -> mid -> 4 up blocks
  (layers_per_block + 1 resnets; a nearest 2x upsample and a per-frame 3x3
  conv in blocks 0-2, in time too in blocks 0-1, where an odd clip's frame 0
  is upsampled in space only) -> spatial norm, SiLU, conv_out. Every decoder
  norm is a spatial norm: GroupNorm(f) * conv_y(zq) + conv_b(zq), the raw
  latents zq nearest-resized to f (an odd clip's first latent frame to the
  first frame alone). No clip: the writer clips.

A causal conv pads time in front with k - 1 copies of frame 0 and space
with zeros on both sides. Activations are channels-first (B, C, T, H, W) in
f32; the weights keep the checkpoint's layout (co, ci, k...). GroupNorm
(eps 1e-6) takes f32 statistics over (C/G, T, H, W).

Whole-decode tensors pass 2^31 elements (128 x 81 x 768 x 1360 is 10.8 G),
where the card's torch gets F.interpolate's nearest mode wrong (ROADMAP.md
section 3). So the nearest resizes are broadcast copies, the group norm is
f32 reductions (models/hyvideo/vae.group_norm), the time padding a copy and
the space padding the convolution's own or a zero-filled copy; never
F.interpolate, F.group_norm or F.pad. The spatial norm's 1x1x1 convs are
pointwise, so they run at the latents' resolution and the products
broadcast over the nearest-resize's repeats without building the resized
latents: the same values as the JAX package's resize-then-convolve.

Parameter names are the JAX pytree's paths: {encoder, decoder}.conv_in,
encoder.down.<i>.{res.<j>, ds.conv}, encoder.mid.res.<j>, decoder.mid.res.<j>,
decoder.up.<i>.{res.<j>, us.conv}, {encoder, decoder}.{norm_out, conv_out}; a
resnet holds norm1, conv1, norm2, conv2 (and shortcut); a decoder norm holds
norm, conv_y, conv_b (io/checkpoint.convert_cog_vae maps diffusers' names).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from sparse_videogen_tpu_torch.models.hyvideo.vae import Stage, _repeat, group_norm, plain_conv3d_1x1

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class CogVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: tuple = (128, 256, 256, 512)
    layers_per_block: int = 3
    latent_channels: int = 16
    norm_num_groups: int = 32
    # v1.0 (2b): 1.15258426, invert False; v1.5: 0.7, invert True
    scaling_factor: float = 0.7
    invert_scale_latents: bool = True
    temporal_compression: int = 4
    spatial_compression: int = 8

    @property
    def num_blocks(self) -> int:
        return len(self.block_out_channels)

    @property
    def temporal_levels(self) -> int:
        return int(math.log2(self.temporal_compression))

    def compress_time(self, i) -> bool:
        return i < self.temporal_levels

    def resample_spatial(self, i) -> bool:
        return i != self.num_blocks - 1


# -- primitives --

def time_pad(x, n: int):
    """n copies of frame 0 in front of x (B, C, T, H, W)."""
    if n == 0:
        return x
    B, C, T, H, W = x.shape
    out = x.new_empty(B, C, T + n, H, W)
    out[:, :, n:] = x
    out[:, :, :n] = x[:, :, :1]
    return out


def causal_conv3d(m: nn.Conv3d, x):
    """Time padded in front with frame 0, space zero-padded by k // 2."""
    kt, kh, kw = m.weight.shape[2:]
    return F.conv3d(time_pad(x, kt - 1), m.weight.to(x.dtype), m.bias.to(x.dtype), padding=(0, kh // 2, kw // 2))


def conv2d_frames(m: nn.Conv2d, x, *, stride: int = 1, pad=((1, 1), (1, 1))):
    """A Conv2d on every frame of x (B, C, T, H, W), zero padding `pad`
    ((top, bottom), (left, right))."""
    (pt, pb), (pl, pr) = pad
    w = m.weight.to(x.dtype)[:, :, None]
    if pt == pb and pl == pr:
        return F.conv3d(x, w, m.bias.to(x.dtype), stride=(1, stride, stride), padding=(0, pt, pl))
    B, C, T, H, W = x.shape
    xp = x.new_zeros(B, C, T, H + pt + pb, W + pl + pr)
    xp[..., pt:pt + H, pl:pl + W] = x
    return F.conv3d(xp, w, m.bias.to(x.dtype), stride=(1, stride, stride))


def _parts(T: int, tz: int):
    """The (output frames, latent frames) pairs of the spatial norm's time
    resize: an odd clip longer than one frame maps latent frame 0 to frame 0
    alone and the rest onto the rest."""
    if T > 1 and T % 2 == 1:
        return [((0, 1), (0, 1)), ((1, T), (1, tz))]
    return [((0, T), (0, tz))]


def spatial_norm(m, f, zq, groups: int):
    """GroupNorm(f) * conv_y(zq~) + conv_b(zq~), zq~ = zq nearest-resized to
    f's shape: the 1x1x1 convs on zq, their outputs broadcast over the
    repeats of the resize."""
    B, C, T, H, W = f.shape
    nf = group_norm(m.norm, f, groups)
    y, b = plain_conv3d_1x1(m.conv_y, zq), plain_conv3d_1x1(m.conv_b, zq)
    for (t0, t1), (z0, z1) in _parts(T, zq.shape[2]):
        tz, hz, wz = z1 - z0, zq.shape[3], zq.shape[4]
        ft, fh, fw = (t1 - t0) // tz, H // hz, W // wz
        view = nf[:, :, t0:t1].view(B, C, tz, ft, hz, fh, wz, fw)
        bc = lambda a: a[:, :, z0:z1, None, :, None, :, None]
        view.mul_(bc(y)).add_(bc(b))
    return nf


def resnet_block(m, x, zq, groups: int):
    norm = (lambda n, y: group_norm(n, y, groups)) if zq is None else (lambda n, y: spatial_norm(n, y, zq, groups))
    h = causal_conv3d(m.conv1, F.silu(norm(m.norm1, x), inplace=True))
    h = causal_conv3d(m.conv2, F.silu(norm(m.norm2, h), inplace=True))
    if m.shortcut is not None:
        x = plain_conv3d_1x1(m.shortcut, x)
    return h.add_(x)


def downsample(m, x, compress_time: bool):
    """Pairwise temporal mean (an odd clip's frame 0 kept alone), then the
    right/bottom zero-padded stride-2 per-frame conv."""
    if compress_time:
        T = x.shape[2]
        if T % 2 == 1:
            rest = x[:, :, 1:]
            x = torch.cat([x[:, :, :1], 0.5 * (rest[:, :, ::2] + rest[:, :, 1::2])], dim=2)
        else:
            x = 0.5 * (x[:, :, ::2] + x[:, :, 1::2])
    return conv2d_frames(m.conv, x, stride=2, pad=((0, 1), (0, 1)))


def upsample(m, x, compress_time: bool):
    """Nearest 2x in space; with compress_time 2x in time too (an odd clip's
    frame 0 in space only); then the 3x3 per-frame conv."""
    B, C, T, H, W = x.shape
    if compress_time and T > 1 and T % 2 == 1:
        out = x.new_empty(B, C, 1 + 2 * (T - 1), 2 * H, 2 * W)
        _repeat(x[:, :, :1], 1, 2, 2, out[:, :, :1])
        _repeat(x[:, :, 1:], 2, 2, 2, out[:, :, 1:])
        x = out
    else:
        x = _repeat(x, 2 if compress_time and T > 1 else 1, 2, 2)
    return conv2d_frames(m.conv, x)


# -- modules (weight carriers; the functions above run them) --

def _conv3(ci, co, k, device):
    return nn.Conv3d(ci, co, k, dtype=F32, device=device)


def _gn(c, groups, device):
    return nn.GroupNorm(groups, c, eps=1e-6, dtype=F32, device=device)


class SpatialNorm(nn.Module):
    def __init__(self, c, zc, groups, device):
        super().__init__()
        self.norm = _gn(c, groups, device)
        self.conv_y, self.conv_b = _conv3(zc, c, 1, device), _conv3(zc, c, 1, device)


class ResnetBlock(nn.Module):
    def __init__(self, ci, co, groups, zc, device):
        super().__init__()
        norm = (lambda c: _gn(c, groups, device)) if zc is None else (lambda c: SpatialNorm(c, zc, groups, device))
        self.norm1, self.conv1 = norm(ci), _conv3(ci, co, 3, device)
        self.norm2, self.conv2 = norm(co), _conv3(co, co, 3, device)
        self.shortcut = _conv3(ci, co, 1, device) if ci != co else None


class Resample(nn.Module):
    def __init__(self, c, device):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, dtype=F32, device=device)


class Mid(nn.Module):
    def __init__(self, c, groups, zc, device):
        super().__init__()
        self.res = nn.ModuleList(ResnetBlock(c, c, groups, zc, device) for _ in range(2))


class Encoder(nn.Module):
    def __init__(self, cfg: CogVAEConfig, device):
        super().__init__()
        bo, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = _conv3(cfg.in_channels, bo[0], 3, device)
        self.down = nn.ModuleList()
        ch = bo[0]
        for i in range(cfg.num_blocks):
            res = [ResnetBlock(ch if j == 0 else bo[i], bo[i], g, None, device) for j in range(cfg.layers_per_block)]
            self.down.append(Stage(res, "ds", Resample(bo[i], device) if cfg.resample_spatial(i) else None))
            ch = bo[i]
        self.mid = Mid(bo[-1], g, None, device)
        self.norm_out = _gn(bo[-1], g, device)
        self.conv_out = _conv3(bo[-1], 2 * cfg.latent_channels, 3, device)


class Decoder(nn.Module):
    def __init__(self, cfg: CogVAEConfig, device):
        super().__init__()
        rev, g, z = tuple(reversed(cfg.block_out_channels)), cfg.norm_num_groups, cfg.latent_channels
        self.conv_in = _conv3(z, rev[0], 3, device)
        self.mid = Mid(rev[0], g, z, device)
        self.up = nn.ModuleList()
        ch = rev[0]
        for i in range(cfg.num_blocks):
            res = [ResnetBlock(ch if j == 0 else rev[i], rev[i], g, z, device) for j in range(cfg.layers_per_block + 1)]
            self.up.append(Stage(res, "us", Resample(rev[i], device) if cfg.resample_spatial(i) else None))
            ch = rev[i]
        self.norm_out = SpatialNorm(rev[-1], z, g, device)
        self.conv_out = _conv3(rev[-1], cfg.out_channels, 3, device)


def encoder_forward(enc: Encoder, cfg: CogVAEConfig, x):
    g = cfg.norm_num_groups
    x = causal_conv3d(enc.conv_in, x)
    for i, blk in enumerate(enc.down):
        for r in blk.res:
            x = resnet_block(r, x, None, g)
        if blk.ds is not None:
            x = downsample(blk.ds, x, cfg.compress_time(i))
    for r in enc.mid.res:
        x = resnet_block(r, x, None, g)
    return causal_conv3d(enc.conv_out, F.silu(group_norm(enc.norm_out, x, g), inplace=True))


def decoder_forward(dec: Decoder, cfg: CogVAEConfig, z):
    g = cfg.norm_num_groups
    x = causal_conv3d(dec.conv_in, z)
    for r in dec.mid.res:
        x = resnet_block(r, x, z, g)
    for i, blk in enumerate(dec.up):
        for r in blk.res:
            x = resnet_block(r, x, z, g)
        if blk.us is not None:
            x = upsample(blk.us, x, cfg.compress_time(i))
    return causal_conv3d(dec.conv_out, F.silu(spatial_norm(dec.norm_out, x, z, g), inplace=True))


class CogVAE(nn.Module):
    """Scaled latents (B, 16, T', h, w) -> video (B, 3, 1 + 4 (T' - 1), 8 h,
    8 w) in about [-1, 1] (`decode`), and video -> raw latents, the mean
    (`encode`; `scale_latents` maps them into the DiT's space). f32."""

    def __init__(self, cfg: CogVAEConfig = CogVAEConfig(), *, device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, device)
        self.decoder = Decoder(cfg, device)
        self.requires_grad_(False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator):
        """The JAX package's init_cog_vae_params distributions: conv weights
        N(0, 1 / fan_in), zero biases, unit norms."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv3d, nn.Conv2d)):
                w = torch.randn(mod.weight.shape, generator=generator, device=mod.weight.device)
                mod.weight.copy_(w / math.sqrt(mod.weight[0].numel()))
                mod.bias.zero_()
        return self

    @property
    def device(self):
        return self.decoder.conv_in.weight.device

    @torch.no_grad()
    def encode(self, video, generator: torch.Generator | None = None):
        """video (B, 3, T, H, W) in [-1, 1] -> raw latents: the mean, or with
        a generator a sample (log-variance clipped to [-30, 20])."""
        moments = encoder_forward(self.encoder, self.cfg, video.to(self.device).float())
        mean, logvar = moments.chunk(2, dim=1)
        if generator is not None:
            std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
            mean = mean + std * torch.randn(mean.shape, generator=generator, device=mean.device)
        return mean

    @torch.no_grad()
    def decode(self, z):
        """Scaled latents -> video; divides by the scaling factor, as the
        upstream pipeline's decode_latents does for every CogVideoX."""
        return decoder_forward(self.decoder, self.cfg, z.to(self.device).float() / self.cfg.scaling_factor)


def scale_latents(cfg: CogVAEConfig, raw):
    """Raw encoder latents -> the space the DiT was trained in."""
    return raw / cfg.scaling_factor if cfg.invert_scale_latents else raw * cfg.scaling_factor

