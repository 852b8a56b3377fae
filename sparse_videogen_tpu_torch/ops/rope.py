"""Interleaved RoPE (counterpart of sparse_videogen_tpu/ops/rope_pallas.py).

`rope_apply` launches the Hopper kernel (csrc/rope.cu) for CUDA tensors and
the plain version for CPU tensors; `rope_plain` is the plain version, the
kernel's oracle on the card. Both read (S, D/2) f32 cos/sin tables directly:
the TPU's expanded lane tables and flat-row view have no counterpart here.
"""

from __future__ import annotations

import torch

from sparse_videogen_tpu_torch import _kernels


def rope_plain(x, cos, sin):
    """x (..., S, D); cos/sin (S, D/2). out[2i] = x0*c - x1*s,
    out[2i+1] = x0*s + x1*c, in f32, returned in x.dtype."""
    _kernels.plain_call("rope")
    return rotate_interleaved(x, cos, sin)


def rotate_interleaved(x, cos, sin):
    """rope_plain's arithmetic, uncounted (the plain version of
    ops/qk_norm_rope.py rotates with it too)."""
    xf = x.float()
    x0, x1 = xf[..., 0::2], xf[..., 1::2]
    o0 = x0 * cos - x1 * sin
    o1 = x0 * sin + x1 * cos
    return torch.stack([o0, o1], dim=-1).reshape(x.shape).to(x.dtype)


def rope_apply(x, cos, sin):
    """x (BH, S, D); cos/sin (S, D/2) f32 on x's device. CUDA tensors launch
    the kernel (bf16, contiguous, D % 8 == 0) and raise on anything else."""
    if x.dim() != 3 or x.shape[2] % 2:
        raise ValueError(f"x must be (BH, S, D) with D even, got {tuple(x.shape)}")
    BH, S, D = x.shape
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or tuple(t.shape) != (S, D // 2) or t.device != x.device:
            raise ValueError(f"{name}: need f32 ({S}, {D // 2}) on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if x.device.type == "cpu":
        return rope_plain(x, cos, sin)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or D % 8:
        raise ValueError(f"x: need contiguous bf16 with D % 8 == 0, got {x.dtype} D={D}")
    if not (cos.is_contiguous() and sin.is_contiguous()):
        raise ValueError("cos/sin must be contiguous")
    out = torch.empty_like(x)
    err = _kernels.lib().svt_rope(x.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
                                  BH, S, D, torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(err, "rope")
    _kernels.launched("rope")
    return out
