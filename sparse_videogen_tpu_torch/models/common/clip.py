"""CLIP vision tower (ViT-H/14), the Wan I2V image encoder, and CLIP-L's
text tower, HunyuanVideo's second text encoder (counterpart of
sparse_videogen_tpu/models/common/clip.py).

The reference's I2V path feeds the DiT the PENULTIMATE hidden states
(B, 257, 1280) of HF CLIPVisionModel (hidden_states[-2]): the patch
embedding (a linear over (c, kh, kw) patches, no bias), the class token and
the learned positions, pre-LayerNorm, then num_layers - 1 of the pre-LN
blocks and no post-LayerNorm. Numerics follow the JAX package: LayerNorm in
f32, cast back to the activation dtype; the scores q k^T in f32, scaled by
head_dim^-1/2, softmax, cast to v's dtype, then the product with v; exact
GELU ("gelu", ViT-H) or quick_gelu in f32 ("quick_gelu").

Parameter names: patch_proj, cls, pos, pre_ln, blocks.<i>.{ln1, q, k, v,
o, ln2, fc1, fc2}, post_ln (io/checkpoint.convert_clip_vision maps HF's
and wan_orig's names onto these).

The text tower (HF CLIPTextModel, HunyuanVideo's "clipL" with
output_key pooler_output): token and learned position embeddings, the same
pre-LN blocks with quick_gelu and a causal plus padding bias of
finfo(f32).min on the scores, a final LayerNorm; the pooled state is the
final hidden state at each sequence's FIRST argmax id (the end-of-text id,
49407, the highest of the vocabulary; its padding repeats it). Parameter
names: token_embedding, position_embedding, blocks.<i>.{...}, final_ln
(io/checkpoint.convert_clip_text maps HF's names onto these).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from sparse_videogen_tpu_torch.models.common import layers as L
from sparse_videogen_tpu_torch.models.common.resize import resize_cubic


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    ffn_dim: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    eps: float = 1e-5
    hidden_act: str = "gelu"  # ViT-H/14 ("gelu"); ViT-L uses "quick_gelu"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


CLIP_VIT_H_14 = CLIPVisionConfig()

# OpenCLIP normalization
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(img, size: int = 224):
    """(B, 3, H, W) in [-1, 1] -> squash-resized to size x size with the
    cubic rule of jax.image.resize (models/common/resize.py), mapped to
    [0, 1] and CLIP-normalized; f32."""
    x = resize_cubic((img.float() + 1.0) * 0.5, size, size)
    mean = torch.tensor(CLIP_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def layer_norm(m: nn.LayerNorm, x):
    """LayerNorm in f32, returned in x's dtype."""
    return L.layer_norm_f32(x, m.eps, m.weight, m.bias).to(x.dtype)


def quick_gelu(x):
    xf = x.float()
    return (xf * torch.sigmoid(1.702 * xf)).to(x.dtype)


def _act(name, x):
    return quick_gelu(x) if name == "quick_gelu" else F.gelu(x)


class CLIPBlock(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype, device):
        super().__init__()
        d = cfg.dim
        self.cfg = cfg
        self.ln1 = nn.LayerNorm(d, eps=cfg.eps, dtype=torch.float32, device=device)
        self.q, self.k, self.v, self.o = (nn.Linear(d, d, dtype=dtype, device=device) for _ in range(4))
        self.ln2 = nn.LayerNorm(d, eps=cfg.eps, dtype=torch.float32, device=device)
        self.fc1 = nn.Linear(d, cfg.ffn_dim, dtype=dtype, device=device)
        self.fc2 = nn.Linear(cfg.ffn_dim, d, dtype=dtype, device=device)

    def forward(self, x, bias=None):
        """`bias` (f32, broadcast to the scores) is added after the scale."""
        cfg = self.cfg
        B, S, d = x.shape
        H = cfg.num_heads
        heads = lambda y: y.view(B, S, H, d // H).transpose(1, 2)
        h = layer_norm(self.ln1, x)
        q, k, v = heads(L.linear(self.q, h)), heads(L.linear(self.k, h)), heads(L.linear(self.v, h))
        s = (q.float() @ k.float().transpose(-1, -2)) * ((d // H) ** -0.5)
        if bias is not None:
            s = s + bias
        o = torch.softmax(s, dim=-1).to(v.dtype) @ v
        x = x + L.linear(self.o, o.transpose(1, 2).reshape(B, S, d))
        h = layer_norm(self.ln2, x)
        return x + L.linear(self.fc2, _act(cfg.hidden_act, L.linear(self.fc1, h)))


class CLIPVisionModel(nn.Module):
    """CLIP-normalized pixels (B, 3, image_size, image_size) -> hidden
    states (B, 1 + grid^2, dim) in the pixels' dtype (the weights are cast
    to it, as in the JAX package). Linear weights, the class token and the
    positions stored in `dtype` (f32 by default, as the JAX encoder loads
    them); LayerNorms f32."""

    def __init__(self, cfg: CLIPVisionConfig = CLIP_VIT_H_14, *, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.patch_proj = nn.Linear(3 * cfg.patch_size**2, d, bias=False, dtype=dtype, device=device)
        self.cls = nn.Parameter(torch.zeros(1, d, dtype=dtype, device=device))
        self.pos = nn.Parameter(torch.zeros(1 + cfg.grid**2, d, dtype=dtype, device=device))
        self.pre_ln = nn.LayerNorm(d, eps=cfg.eps, dtype=torch.float32, device=device)
        self.blocks = nn.ModuleList(CLIPBlock(cfg, dtype, device) for _ in range(cfg.num_layers))
        self.post_ln = nn.LayerNorm(d, eps=cfg.eps, dtype=torch.float32, device=device)
        self.requires_grad_(False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator):
        """JAX init_clip_vision_params' distributions: linear weights
        N(0, 1/d_in) with zero biases, the patch projection and the class
        token N(0, 0.02^2), the positions N(0, 0.01^2), unit LayerNorms."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear) and mod is not self.patch_proj:
                w = torch.randn(mod.weight.shape, generator=generator, device=mod.weight.device)
                mod.weight.copy_(w / math.sqrt(mod.in_features))
                mod.bias.zero_()
        for p, scale in ((self.patch_proj.weight, 0.02), (self.cls, 0.02), (self.pos, 0.01)):
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * scale)
        return self

    @torch.no_grad()
    def forward(self, pixels, *, penultimate: bool = True):
        """The penultimate hidden states (the I2V clip_fea) by default; the
        last layer's otherwise (like HF last_hidden_state: no post-LN)."""
        cfg = self.cfg
        B, ps, g = pixels.shape[0], cfg.patch_size, cfg.grid
        xp = pixels.reshape(B, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5).reshape(B, g * g, 3 * ps * ps)
        x = L.linear(self.patch_proj, xp)
        x = torch.cat([self.cls.to(x.dtype).expand(B, 1, cfg.dim), x], dim=1) + self.pos.to(x.dtype)[None]
        x = layer_norm(self.pre_ln, x)
        for blk in self.blocks[: cfg.num_layers - 1 if penultimate else cfg.num_layers]:
            x = blk(x)
        return x


def clip_vision_forward(model: CLIPVisionModel, pixels, *, penultimate: bool = True):
    """Functional spelling of CLIPVisionModel.forward, as the JAX package names it."""
    return model(pixels, penultimate=penultimate)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    dim: int = 768
    ffn_dim: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    eps: float = 1e-5

    @property
    def hidden_act(self) -> str:
        return "quick_gelu"


CLIP_L_TEXT = CLIPTextConfig()


class CLIPTextModel(nn.Module):
    """ids (B, L) (and a 1/0 mask) -> (the final hidden states (B, L, dim),
    pooled (B, dim)), in the embeddings' dtype. Linears and embeddings in
    `dtype` (f32 by default, as JAX init_clip_text_params), LayerNorms f32."""

    def __init__(self, cfg: CLIPTextConfig = CLIP_L_TEXT, *, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.dim, dtype=dtype, device=device))
        self.position_embedding = nn.Parameter(torch.zeros(cfg.max_positions, cfg.dim, dtype=dtype, device=device))
        self.blocks = nn.ModuleList(CLIPBlock(cfg, dtype, device) for _ in range(cfg.num_layers))
        self.final_ln = nn.LayerNorm(cfg.dim, eps=cfg.eps, dtype=torch.float32, device=device)
        self.requires_grad_(False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator):
        """JAX init_clip_text_params' distributions: linear weights N(0,
        1/d_in) with zero biases, the token embedding N(0, 0.02^2), the
        positions N(0, 0.01^2), unit LayerNorms."""
        dev = self.token_embedding.device
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                w = torch.randn(mod.weight.shape, generator=generator, device=dev)
                mod.weight.copy_(w / math.sqrt(mod.in_features))
                mod.bias.zero_()
        for p, scale in ((self.token_embedding, 0.02), (self.position_embedding, 0.01)):
            p.copy_(torch.randn(p.shape, generator=generator, device=dev) * scale)
        return self

    @torch.no_grad()
    def forward(self, ids, mask=None):
        dev = self.token_embedding.device
        ids = torch.as_tensor(ids, device=dev).long()
        B, S = ids.shape
        x = self.token_embedding[ids] + self.position_embedding[None, :S]
        allowed = torch.ones(S, S, dtype=torch.bool, device=dev).tril()[None, None]
        if mask is not None:
            allowed = allowed & (torch.as_tensor(mask, device=dev)[:, None, None, :] != 0)
        bias = torch.where(allowed, 0.0, torch.finfo(torch.float32).min).to(torch.float32)
        for blk in self.blocks:
            x = blk(x, bias)
        x = layer_norm(self.final_ln, x)
        return x, x[torch.arange(B, device=dev), ids.argmax(dim=-1)]


def clip_text_encode(model: CLIPTextModel, ids, mask=None):
    """Functional spelling of CLIPTextModel.forward, as the JAX package names it."""
    return model(ids, mask)
