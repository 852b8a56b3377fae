"""Row LayerNorm with an affine epilogue in f32: the DiT blocks' LayerNorm +
AdaLN modulation (and Wan's norm3 with its weight and bias) in one pass.

`layernorm_mod` launches the Hopper kernel (csrc/layernorm_mod.cu) for CUDA
tensors and the plain version for CPU tensors; `layernorm_mod_plain` is the
plain version, the kernel's oracle on the card, and the eager expression
the models ran before the kernel:
bf16(((x - mu) * rsqrt(var + eps)) * mul + add), mu and var the f32 mean
and the mean of (x - mu)^2 over the last axis. No TPU kernel corresponds:
the JAX package leaves this to XLA.
"""

from __future__ import annotations

import torch

from sparse_videogen_tpu_torch import _kernels

MAX_D = 8192  # 8 warps a row, 4 16-byte loads a thread (csrc/layernorm_mod.cu)


def layernorm_mod_plain(x, mul, add, eps: float):
    """x (B, S, d); mul, add f32 (d,) or (B, d). The f32 LayerNorm of
    models/common/layers.layer_norm_f32, times mul, plus add, cast to
    x.dtype."""
    _kernels.plain_call("layernorm_mod")
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if mul.dim() == 2:
        mul, add = mul[:, None], add[:, None]
    return (y * mul + add).to(x.dtype)


def _vector_stride(name, t, x):
    """The batch stride of an f32 (d,) or (B, d) vector the kernel reads (0
    for one vector); raises on anything it cannot read."""
    if t.dtype != torch.float32 or t.device != x.device:
        raise ValueError(f"{name}: need f32 on {x.device}, got {t.dtype} on {t.device}")
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        raise ValueError(f"{name}: need a unit last stride and 16-byte alignment")
    if t.dim() == 1 or t.shape[0] == 1:
        return 0
    if t.stride(0) % 4:
        raise ValueError(f"{name}: batch stride {t.stride(0)} is not a multiple of 4")
    return t.stride(0)


def kernel_args(x, mul, add):
    """(x's batch stride, mul's, add's) in elements as the kernel takes them
    (0 where one row or vector serves every batch), for x bf16 (B, S, d) and
    mul, add of layernorm_mod's shapes; raises ValueError on what the kernel
    cannot read: d not a multiple of 8 or above MAX_D, rows of d that are
    not contiguous, a batch stride that breaks 16-byte alignment, 2^31 rows
    or more, vectors that are not f32 with a unit last stride."""
    B, S, d = x.shape
    if x.dtype != torch.bfloat16 or d % 8 or d > MAX_D:
        raise ValueError(f"x: need bf16 with d % 8 == 0 and d <= {MAX_D}, got {x.dtype} d={d}")
    if x.stride(2) != 1 or (S > 1 and x.stride(1) != d) or (B > 1 and x.stride(0) % 8) or x.data_ptr() % 16:
        raise ValueError(f"x: need rows of d contiguous, a batch stride that is a multiple of 8 and 16-byte "
                         f"alignment, got strides {x.stride()}")
    if B * S >= 2 ** 31:
        raise ValueError(f"x: {B * S} rows, the kernel takes fewer than 2^31")
    return (x.stride(0) if B > 1 else 0), _vector_stride("mul", mul, x), _vector_stride("add", add, x)


def layernorm_mod(x, mul, add, eps: float):
    """x (B, S, d) with d % 8 == 0 and d <= MAX_D; mul, add f32 (d,) or
    (B, d). CUDA tensors launch the kernel (x bf16, rows of d
    contiguous, any batch stride that keeps them 16-byte aligned: a slice
    x[:, :n] of a longer sequence needs no copy) and raise on anything else
    (kernel_args); CPU tensors run the plain version. Returns a contiguous
    (B, S, d) tensor of x's dtype."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, d), got {tuple(x.shape)}")
    B, S, d = x.shape
    for name, t in (("mul", mul), ("add", add)):
        if tuple(t.shape) not in ((d,), (B, d)):
            raise ValueError(f"{name}: need ({d},) or ({B}, {d}), got {tuple(t.shape)}")
    if x.device.type == "cpu":
        return layernorm_mod_plain(x, mul, add, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x_stride, m_stride, a_stride = kernel_args(x, mul, add)
    out = torch.empty(B, S, d, dtype=x.dtype, device=x.device)
    err = _kernels.lib().svt_layernorm_mod(x.data_ptr(), mul.data_ptr(), add.data_ptr(), out.data_ptr(), B, S,
                                           x_stride, m_stride, a_stride, d, float(eps),
                                           torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(err, "layernorm_mod")
    _kernels.launched("layernorm_mod")
    return out
