"""LLaMA-3 as a text encoder, HunyuanVideo's primary one (counterpart of
sparse_videogen_tpu/models/common/llama.py).

HunyuanVideo conditions on hidden_states[-(skip + 1)] of a LLaMA-3-8B with
hidden_state_skip_layer 2: the activations after layer N - 2, without the
final norm. So only the num_layers - skip active layers exist here, and the
last `skip` layers are never built.

HF LlamaModel's blocks: RMSNorm pre-norm, GQA attention with the half-split
rotary embedding (theta 500,000), SwiGLU MLP; right padding and a causal
mask. Numerics follow the JAX package, not HF: the residual stream stays in
the weights' dtype; RMSNorm normalises and scales in f32, then casts back;
the rotary tables are built in f64 numpy and applied in f32; the scores q
k^T in f32 scaled by head_dim^-1/2 plus a bias of finfo(f32).min where a
key is masked or in the future, softmax in f32, the probabilities cast to
v's dtype for the product with v; silu(gate) in f32, cast back, times up.
Plain torch (cuBLAS on the card): the JAX package runs this on XLA, not in
a Pallas kernel.

Parameter names: embed, blocks.<i>.{ln1, q, k, v, o, ln2, gate, up, down}
(io/checkpoint.convert_llama maps HF's names onto these).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparse_videogen_tpu_torch.models.common import layers as L

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128320
    dim: int = 4096
    ffn_dim: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    rope_theta: float = 500000.0
    eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


LLAMA3_8B = LlamaConfig()


def rms_norm(x, w, eps):
    """The mean square and the scale in f32, cast back to x's dtype."""
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (n * w.float()).to(x.dtype)


def rope_tables(seq_len: int, head_dim: int, theta: float, device="cpu"):
    """HF's half-split rotary tables (cos, sin), each (L, head_dim) f32,
    computed in f64 numpy."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    freqs = np.outer(np.arange(seq_len, dtype=np.float64), inv)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.as_tensor(np.cos(emb), dtype=F32, device=device),
            torch.as_tensor(np.sin(emb), dtype=F32, device=device))


def apply_rope(x, cos, sin):
    """x (B, L, H, hd), HF's rotate_half, in f32, cast back."""
    hd = x.shape[-1]
    rot = torch.cat([-x[..., hd // 2:], x[..., : hd // 2]], dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return (x.float() * c + rot.float() * s).to(x.dtype)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, kv = cfg.dim, cfg.num_kv_heads * cfg.head_dim
        lin = lambda a, b: nn.Linear(a, b, bias=False, dtype=dtype, device=device)
        self.ln1 = nn.Parameter(torch.ones(d, dtype=F32, device=device))
        self.q, self.k, self.v, self.o = lin(d, d), lin(d, kv), lin(d, kv), lin(d, d)
        self.ln2 = nn.Parameter(torch.ones(d, dtype=F32, device=device))
        self.gate, self.up, self.down = lin(d, cfg.ffn_dim), lin(d, cfg.ffn_dim), lin(cfg.ffn_dim, d)

    def forward(self, x, cos, sin, bias):
        cfg = self.cfg
        B, S, _ = x.shape
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        h = rms_norm(x, self.ln1, cfg.eps)
        q = apply_rope(L.linear(self.q, h).view(B, S, H, hd), cos, sin)
        k = apply_rope(L.linear(self.k, h).view(B, S, KV, hd), cos, sin)
        v = L.linear(self.v, h).view(B, S, KV, hd)
        k, v = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2) for t in (k, v))
        s = (q.transpose(1, 2).float() @ k.float().transpose(-1, -2)) * hd**-0.5 + bias
        o = torch.softmax(s, dim=-1).to(v.dtype) @ v
        x = x + L.linear(self.o, o.transpose(1, 2).reshape(B, S, H * hd))
        h = rms_norm(x, self.ln2, cfg.eps)
        up = L.linear(self.up, h)
        return x + L.linear(self.down, F.silu(L.linear(self.gate, h).float()).to(up.dtype) * up)


class LlamaModel(nn.Module):
    """ids (B, L), mask (B, L) 1/0 -> the hidden states after the last
    active block (B, L, dim), in the weights' dtype. `n_layers` blocks are
    built (default cfg.num_layers; HunyuanVideo's encoder builds
    num_layers - skip). Linears and the embedding in `dtype`, the norm
    weights f32."""

    def __init__(self, cfg: LlamaConfig = LLAMA3_8B, *, n_layers: int | None = None, dtype=torch.bfloat16,
                 device="cpu"):
        super().__init__()
        self.cfg = cfg
        n = cfg.num_layers if n_layers is None else n_layers
        self.embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.dim, dtype=dtype, device=device))
        self.blocks = nn.ModuleList(LlamaBlock(cfg, dtype, device) for _ in range(n))
        self.requires_grad_(False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator):
        """The JAX package's init_llama_params distributions: the embedding
        N(0, 0.02^2), each linear N(0, 1/d_in), unit norms."""
        dev = self.embed.device
        self.embed.copy_(torch.randn(self.embed.shape, generator=generator, device=dev) * 0.02)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                w = torch.randn(mod.weight.shape, generator=generator, device=dev)
                mod.weight.copy_(w / math.sqrt(mod.in_features))
        return self

    @torch.no_grad()
    def forward(self, ids, mask, *, inputs_embeds=None):
        """`inputs_embeds` (B, L, dim) replaces the embedding lookup (Llava's
        image splice, models/common/llava.py)."""
        dev = self.embed.device
        mask = torch.as_tensor(mask, device=dev)
        S = mask.shape[1]
        x = self.embed[torch.as_tensor(ids, device=dev).long()] if inputs_embeds is None else inputs_embeds.to(dev)
        cos, sin = rope_tables(S, self.cfg.head_dim, self.cfg.rope_theta, dev)
        causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
        allowed = causal[None, None] & (mask[:, None, None, :] != 0)
        bias = torch.where(allowed, 0.0, torch.finfo(F32).min).to(F32)
        for blk in self.blocks:
            x = blk(x, cos, sin, bias)
        return x


def llama_encode(model: LlamaModel, ids, mask, *, inputs_embeds=None):
    """Functional spelling of LlamaModel.forward, as the JAX package names it."""
    return model(ids, mask, inputs_embeds=inputs_embeds)
