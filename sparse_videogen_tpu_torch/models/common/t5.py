"""UMT5 encoder, Wan 2.1's text encoder (counterpart of
sparse_videogen_tpu/models/common/t5.py).

Pre-norm T5 blocks with a relative position bias per layer (UMT5), a gated
tanh-GELU feed-forward, no 1/sqrt(d) on the scores, f32 softmax with the
per-layer bias and a mask bias of finfo(f32).min. The norm weights are f32,
so the residual stream is f32 whatever the linears' storage dtype, and each
linear runs in f32 on its weights cast up, as the JAX package computes it.
The T5 v1.0 variant (shared bias, ReLU) is not ported.

Parameter names: token_embedding, blocks.<i>.{norm1, q, k, v, o,
rel_embedding, norm2, gate, fc1, fc2}, norm (io/checkpoint.convert_umt5
maps the reference's names onto these).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from sparse_videogen_tpu_torch.models.common import layers as L

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_dist: int = 128
    eps: float = 1e-6


UMT5_XXL = T5Config()


def t5_layer_norm(x, w, eps=1e-6):
    """RMS norm without mean subtraction, the mean square in f32."""
    xf = x.float()
    n = x * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps).to(x.dtype)
    return n * w.to(x.dtype)


def gelu_tanh_exact(x):
    """The reference's handwritten tanh GELU, in f32."""
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (xf + 0.044715 * xf**3)))
    return y.to(x.dtype)


def relative_position_buckets(seq_len: int, num_buckets: int, max_dist: int) -> np.ndarray:
    """Bidirectional bucket ids, (L, L) int32 (numpy, as in the JAX package)."""
    rel_pos = np.arange(seq_len)[None, :] - np.arange(seq_len)[:, None]
    nb = num_buckets // 2
    rel_buckets = (rel_pos > 0).astype(np.int64) * nb
    rel_pos = np.abs(rel_pos)
    max_exact = nb // 2
    with np.errstate(divide="ignore"):
        large = max_exact + (
            np.log(rel_pos / max_exact + 1e-20) / math.log(max_dist / max_exact) * (nb - max_exact)
        ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    rel_buckets += np.where(rel_pos < max_exact, rel_pos, large)
    return rel_buckets.astype(np.int32)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, dtype, device):
        super().__init__()
        self.cfg = cfg
        lin = lambda di, do: nn.Linear(di, do, bias=False, dtype=dtype, device=device)
        self.norm1 = nn.Parameter(torch.ones(cfg.dim, dtype=F32, device=device))
        self.q, self.k, self.v = (lin(cfg.dim, cfg.dim_attn) for _ in range(3))
        self.o = lin(cfg.dim_attn, cfg.dim)
        self.rel_embedding = nn.Parameter(torch.zeros(cfg.num_buckets, cfg.num_heads, dtype=F32, device=device))
        self.norm2 = nn.Parameter(torch.ones(cfg.dim, dtype=F32, device=device))
        self.gate, self.fc1 = lin(cfg.dim, cfg.dim_ffn), lin(cfg.dim, cfg.dim_ffn)
        self.fc2 = lin(cfg.dim_ffn, cfg.dim)

    def forward(self, x, buckets, mask_bias):
        cfg = self.cfg
        B, S, _ = x.shape
        heads = lambda y: y.view(B, S, cfg.num_heads, -1).transpose(1, 2)
        y = t5_layer_norm(x, self.norm1, cfg.eps)
        q, k, v = (heads(L.linear(m, y)) for m in (self.q, self.k, self.v))
        s = (q @ k.transpose(-1, -2)).float()  # no 1/sqrt(d)
        s = s + self.rel_embedding.float()[buckets].permute(2, 0, 1)[None] + mask_bias
        o = torch.softmax(s, dim=-1).to(x.dtype) @ v
        x = x + L.linear(self.o, o.transpose(1, 2).reshape(B, S, cfg.dim_attn))
        y = t5_layer_norm(x, self.norm2, cfg.eps)
        y = L.linear(self.fc1, y) * gelu_tanh_exact(L.linear(self.gate, y))
        return x + L.linear(self.fc2, y)


class T5Encoder(nn.Module):
    """UMT5 encoder: ids (B, L), mask (B, L) 1/0 -> (B, L, dim) states in the
    dtype of the norm weights (f32). token_embedding and the linears are
    stored in `dtype`, the norms and relative biases in f32."""

    def __init__(self, cfg: T5Config = UMT5_XXL, *, dtype=torch.bfloat16, device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.dim, dtype=dtype, device=device))
        self.blocks = nn.ModuleList(T5Block(cfg, dtype, device) for _ in range(cfg.num_layers))
        self.norm = nn.Parameter(torch.ones(cfg.dim, dtype=F32, device=device))
        self._buckets = {}
        self.requires_grad_(False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator):
        """The JAX package's init_t5_params distributions: embeddings N(0, 1);
        q N(0, 1/(dim dim_attn)), k/v/gate/fc1 N(0, 1/dim), o N(0, 1/dim_attn),
        fc2 N(0, 1/dim_ffn); relative biases N(0, 1/(2 buckets heads)); unit
        norms."""
        cfg = self.cfg
        dev = self.norm.device

        def fill(p, std):
            p.copy_(torch.randn(p.shape, generator=generator, device=dev) * std)

        fill(self.token_embedding, 1.0)
        for blk in self.blocks:
            fill(blk.q.weight, (cfg.dim * cfg.dim_attn) ** -0.5)
            for m in (blk.k, blk.v, blk.gate, blk.fc1):
                fill(m.weight, cfg.dim**-0.5)
            fill(blk.o.weight, cfg.dim_attn**-0.5)
            fill(blk.fc2.weight, cfg.dim_ffn**-0.5)
            fill(blk.rel_embedding, (2 * cfg.num_buckets * cfg.num_heads) ** -0.5)
            blk.norm1.fill_(1.0)
            blk.norm2.fill_(1.0)
        self.norm.fill_(1.0)
        return self

    def _bucket_table(self, seq_len: int, device):
        key = (seq_len, str(device))
        if key not in self._buckets:
            table = relative_position_buckets(seq_len, self.cfg.num_buckets, self.cfg.max_dist)
            self._buckets[key] = torch.as_tensor(table, dtype=torch.long, device=device)
        return self._buckets[key]

    @torch.no_grad()
    def forward(self, ids, mask=None):
        dev = self.norm.device
        ids = torch.as_tensor(ids, device=dev).long()
        x = self.token_embedding[ids].float().to(self.norm.dtype)
        buckets = self._bucket_table(ids.shape[1], dev)
        if mask is None:
            mask_bias = torch.zeros(1, 1, 1, ids.shape[1], dtype=F32, device=dev)
        else:
            mask = torch.as_tensor(mask, device=dev)
            mask_bias = torch.where(mask[:, None, None, :] == 0, torch.finfo(F32).min, 0.0).to(F32)
        for blk in self.blocks:
            x = blk(x, buckets, mask_bias)
        return t5_layer_norm(x, self.norm, self.cfg.eps)

