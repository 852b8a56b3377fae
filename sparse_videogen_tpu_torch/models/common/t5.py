"""T5 encoders (counterpart of sparse_videogen_tpu/models/common/t5.py):
UMT5 (Wan 2.1's text encoder), T5 v1.1 (CogVideoX's, gated GELU) and T5
v1.0 (Cosmos's t5-11b, ReLU).

Pre-norm T5 blocks, no 1/sqrt(d) on the scores, f32 softmax with the
relative position bias and a mask bias of finfo(f32).min. UMT5 has a bias
table per layer (`shared_rel_bias` False); T5 v1.0 and v1.1 have one, block
0's in HF's names, that serves every layer (`shared_rel_bias` True: the
encoder's `rel_embedding`). The feed-forward is gated, fc1(x) *
act(gate(x)) (UMT5, v1.1), or plain, act(fc1(x)) (v1.0), with act the tanh
GELU or ReLU. The norm weights are f32, so the residual stream is f32
whatever the linears' storage dtype, and each linear runs in f32 on its
weights cast up, as the JAX package computes it.

Parameter names: token_embedding, [rel_embedding,] blocks.<i>.{norm1, q, k,
v, o, [rel_embedding,] norm2, [gate,] fc1, fc2}, norm
(io/checkpoint.convert_umt5 and convert_t5_hf map the reference's names onto
these).
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
    # UMT5: gated tanh-GELU FFN, a relative bias per layer; T5 v1.0: ReLU,
    # not gated, block 0's bias shared; T5 v1.1: gated tanh-GELU, shared
    gated_ffn: bool = True
    shared_rel_bias: bool = False
    ffn_act: str = "gelu_tanh"  # "gelu_tanh" | "relu"


UMT5_XXL = T5Config()
# t5-11b's encoder, Cosmos's text encoder (the JAX package's T5_11B)
T5_11B = T5Config(vocab_size=32128, dim=1024, dim_attn=16384, dim_ffn=65536, num_heads=128, num_layers=24,
                  gated_ffn=False, shared_rel_bias=True, ffn_act="relu")
# google/t5-v1_1-xxl's encoder, CogVideoX's text encoder (HF's config.json)
T5_V1_1_XXL = T5Config(vocab_size=32128, dim=4096, dim_attn=4096, dim_ffn=10240, num_heads=64, num_layers=24,
                       gated_ffn=True, shared_rel_bias=True, ffn_act="gelu_tanh")
# HF T5Config.feed_forward_proj -> (gated_ffn, ffn_act); "gated-gelu" is
# HF's gelu_new, the tanh GELU
_FFN_PROJ = {"relu": (False, "relu"), "gated-gelu": (True, "gelu_tanh"), "gated-relu": (True, "relu")}


def t5_config_from_dict(c: dict) -> T5Config:
    """A T5Config from a config.json's dict, in the package's own names
    (exactly as the JAX package reads them: other keys ignored, missing ones
    UMT5's) or in HF's T5Config / UMT5Config names (d_model present; a
    missing key takes HF's default): d_model -> dim, num_heads * d_kv ->
    dim_attn, d_ff -> dim_ffn, relative_attention_num_buckets ->
    num_buckets, relative_attention_max_distance -> max_dist,
    layer_norm_epsilon -> eps, feed_forward_proj -> (gated_ffn, ffn_act),
    model_type "t5" -> shared_rel_bias True, "umt5" -> False. A
    feed_forward_proj this encoder cannot compute raises ValueError."""
    if "d_model" not in c:
        fields = {f.name for f in dataclasses.fields(T5Config)}
        return T5Config(**{k: v for k, v in c.items() if k in fields})
    proj = c.get("feed_forward_proj", "relu")
    if proj not in _FFN_PROJ:
        raise ValueError(f"T5 feed_forward_proj {proj!r}: the port computes {sorted(_FFN_PROJ)}")
    model_type = c.get("model_type", "t5")
    if model_type not in ("t5", "umt5"):
        raise ValueError(f"T5 config model_type {model_type!r}: expected 't5' or 'umt5'")
    gated, act = _FFN_PROJ[proj]
    heads = c.get("num_heads", 8)
    return T5Config(vocab_size=c.get("vocab_size", 32128), dim=c["d_model"], dim_attn=heads * c.get("d_kv", 64),
                    dim_ffn=c.get("d_ff", 2048), num_heads=heads, num_layers=c.get("num_layers", 6),
                    num_buckets=c.get("relative_attention_num_buckets", 32),
                    max_dist=c.get("relative_attention_max_distance", 128), eps=c.get("layer_norm_epsilon", 1e-6),
                    gated_ffn=gated, shared_rel_bias=model_type == "t5", ffn_act=act)


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


def _rel_table(cfg: T5Config, device):
    return nn.Parameter(torch.zeros(cfg.num_buckets, cfg.num_heads, dtype=F32, device=device))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, dtype, device):
        super().__init__()
        if cfg.ffn_act not in ("gelu_tanh", "relu"):
            raise ValueError(f"T5 ffn_act {cfg.ffn_act!r}: expected 'gelu_tanh' or 'relu'")
        self.cfg = cfg
        lin = lambda di, do: nn.Linear(di, do, bias=False, dtype=dtype, device=device)
        self.norm1 = nn.Parameter(torch.ones(cfg.dim, dtype=F32, device=device))
        self.q, self.k, self.v = (lin(cfg.dim, cfg.dim_attn) for _ in range(3))
        self.o = lin(cfg.dim_attn, cfg.dim)
        self.rel_embedding = None if cfg.shared_rel_bias else _rel_table(cfg, device)
        self.norm2 = nn.Parameter(torch.ones(cfg.dim, dtype=F32, device=device))
        self.gate = lin(cfg.dim, cfg.dim_ffn) if cfg.gated_ffn else None
        self.fc1 = lin(cfg.dim, cfg.dim_ffn)
        self.fc2 = lin(cfg.dim_ffn, cfg.dim)

    def forward(self, x, bias, mask_bias):
        """bias: the (H, L, L) relative bias this layer adds (its own table's
        under UMT5, the shared one's under T5)."""
        cfg = self.cfg
        B, S, _ = x.shape
        heads = lambda y: y.view(B, S, cfg.num_heads, -1).transpose(1, 2)
        y = t5_layer_norm(x, self.norm1, cfg.eps)
        q, k, v = (heads(L.linear(m, y)) for m in (self.q, self.k, self.v))
        s = (q @ k.transpose(-1, -2)).float()  # no 1/sqrt(d)
        s = s + bias[None] + mask_bias
        o = torch.softmax(s, dim=-1).to(x.dtype) @ v
        x = x + L.linear(self.o, o.transpose(1, 2).reshape(B, S, cfg.dim_attn))
        y = t5_layer_norm(x, self.norm2, cfg.eps)
        act = gelu_tanh_exact if cfg.ffn_act == "gelu_tanh" else torch.relu
        if cfg.gated_ffn:
            y = L.linear(self.fc1, y) * act(L.linear(self.gate, y))
        else:
            y = act(L.linear(self.fc1, y))
        return x + L.linear(self.fc2, y)


class T5Encoder(nn.Module):
    """T5 / UMT5 encoder: ids (B, L), mask (B, L) 1/0 -> (B, L, dim) states
    in the dtype of the norm weights (f32). token_embedding and the linears
    are stored in `dtype`, the norms and relative biases in f32."""

    def __init__(self, cfg: T5Config = UMT5_XXL, *, dtype=torch.bfloat16, device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.dim, dtype=dtype, device=device))
        self.rel_embedding = _rel_table(cfg, device) if cfg.shared_rel_bias else None
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

        rel_std = (2 * cfg.num_buckets * cfg.num_heads) ** -0.5
        fill(self.token_embedding, 1.0)
        for blk in self.blocks:
            fill(blk.q.weight, (cfg.dim * cfg.dim_attn) ** -0.5)
            for m in (blk.k, blk.v, blk.gate, blk.fc1):
                if m is not None:
                    fill(m.weight, cfg.dim**-0.5)
            fill(blk.o.weight, cfg.dim_attn**-0.5)
            fill(blk.fc2.weight, cfg.dim_ffn**-0.5)
            if blk.rel_embedding is not None:
                fill(blk.rel_embedding, rel_std)
            blk.norm1.fill_(1.0)
            blk.norm2.fill_(1.0)
        if self.rel_embedding is not None:
            fill(self.rel_embedding, rel_std)
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
        bias_of = lambda table: table.float()[buckets].permute(2, 0, 1)
        shared = None if self.rel_embedding is None else bias_of(self.rel_embedding)
        for blk in self.blocks:
            x = blk(x, shared if shared is not None else bias_of(blk.rel_embedding), mask_bias)
        return t5_layer_norm(x, self.norm, self.cfg.eps)

