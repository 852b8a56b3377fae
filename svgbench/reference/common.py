"""Plain PyTorch building blocks of the references, in float32 or, for the
control, in float8.

No kernel, cache or batching trick of the program: a linear is one matmul,
attention is softmax(q k^T / sqrt(D)) v over blocks of query rows with the
mask as a boolean predicate of positions. TF32 is off while a reference
runs (`exact_matmul`), so an f32 product is an f32 product on the card.

Precisions (`prec`):
- "f32": the reference;
- "fp8": the control: the program's precision one step down. Every operand
  of a matrix product is rounded to float8 e4m3 (`lowp`), and so is every
  tensor that the program keeps in bf16 between its operations (`store`:
  linear and attention outputs, norm and modulation outputs, the residual
  stream); products accumulate, and norms, softmax and modulation compute,
  in f32, as the program's do;
- "fp8mm": only the operands of the products in float8 (a float8-GEMM
  variant of the program, with everything else exact), read beside the
  control.
One per-tensor scale maps a tensor's largest magnitude to e4m3's 448.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

F8_MAX = 448.0  # largest finite float8 e4m3fn
PRECS = ("f32", "fp8", "fp8mm")


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().float().clamp_min(1e-30) / F8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def lowp(x: torch.Tensor, prec: str) -> torch.Tensor:
    """A matmul operand in the precision `prec`."""
    if prec not in PRECS:
        raise ValueError(f"precision {prec!r}: one of {PRECS}")
    return x if prec == "f32" else _e4m3(x)


def store(x: torch.Tensor, prec: str) -> torch.Tensor:
    """A tensor that the program keeps in its serving dtype between operations."""
    return _e4m3(x) if prec == "fp8" else x


@contextlib.contextmanager
def exact_matmul():
    """float32 matmuls without TF32 (restored afterwards)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def mm(a, b, prec):
    return lowp(a, prec) @ lowp(b, prec)


def linear(x, w, b, prec):
    y = mm(x, w.t(), prec)
    return store(y if b is None else y + b, prec)


def layer_norm(x, eps, weight=None, bias=None):
    y = F.layer_norm(x, x.shape[-1:], eps=eps)
    return y if weight is None else y * weight + bias


def rms_norm(x, weight, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * weight


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def timestep_embedding(t: float, dim: int, device, max_period: float = 10000.0):
    """(1, dim) sinusoid [cos | sin] of a scalar timestep, freqs
    max_period^(-i / (dim/2))."""
    half = dim // 2
    freqs = torch.pow(max_period, -torch.arange(half, dtype=torch.float32, device=device) / half)
    a = torch.tensor([float(t)], device=device)[:, None] * freqs[None]
    return torch.cat([torch.cos(a), torch.sin(a)], dim=1)


def rope_angles(sizes: tuple, dims: tuple, theta: float = 10000.0):
    """(prod(sizes), sum(dims)/2) float64 rotation angles of a 3-D grid:
    axis a gives position * theta^(-2i / dims[a]) for i < dims[a] / 2, the
    axes concatenated in order (frame, height, width)."""
    import numpy as np

    parts = []
    for ax, (sz, dim) in enumerate(zip(sizes, dims)):
        inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        ang = np.outer(np.arange(sz, dtype=np.float64), inv)
        shape = [1] * len(sizes) + [dim // 2]
        shape[ax] = sz
        parts.append(np.broadcast_to(ang.reshape(shape), tuple(sizes) + (dim // 2,)))
    return np.concatenate(parts, axis=-1).reshape(math.prod(sizes), -1)


def rope_interleaved(x, cos, sin):
    """x (..., S, D), pairs (2i, 2i+1) rotated by angle i: cos/sin (S, D/2)."""
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1).flatten(-2)


def attention(q, k, v, allow=None, prec: str = "f32", rows: torch.Tensor | None = None, block: int = 1024,
              keys=None):
    """softmax(q k^T / sqrt(D)) v for q (H, Sq, D), k, v (H, Skv, D), f32.
    allow(q_pos (n, 1), k_pos (1, m)) -> (n, m) bool, or None for no mask;
    the query positions are rows (default: 0..Sq-1). keys(q_pos) -> the
    key positions a block of queries may attend (a superset of what allow
    allows; None: all keys), so that a banded mask need not score every
    pair. A row that the mask leaves empty is an error."""
    H, Sq, D = q.shape
    pos = torch.arange(Sq, device=q.device) if rows is None else rows
    all_keys = torch.arange(k.shape[1], device=q.device)
    out = torch.empty_like(q)
    kq, vq, qq = lowp(k, prec), lowp(v, prec), lowp(q, prec)
    for s0 in range(0, Sq, block):
        kpos = all_keys if keys is None else keys(pos[s0:s0 + block])
        kb, vb = (kq, vq) if keys is None else (kq[:, kpos], vq[:, kpos])
        s = (qq[:, s0:s0 + block] @ kb.transpose(1, 2)) * (D**-0.5)
        if allow is not None:
            m = allow(pos[s0:s0 + block, None], kpos[None, :])
            if not bool(m.any(-1).all()):
                raise ValueError("a query row attends no key")
            s.masked_fill_(~m[None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[:, s0:s0 + block] = lowp(p, prec) @ vb
        del s, p
    return store(out, prec)
