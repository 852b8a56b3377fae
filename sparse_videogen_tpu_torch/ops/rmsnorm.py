"""Row RMSNorm (counterpart of sparse_videogen_tpu/ops/rmsnorm_pallas.py, K6).

`rms_norm_kernel` launches the Triton kernel (csrc/rmsnorm_triton.py) for
CUDA tensors and the plain version for CPU tensors; `rms_norm_plain` is the
plain version, the kernel's oracle on the card, with the semantics of
models/common/layers.rms_norm (WanRMSNorm). Like the JAX package, the models
do not call the kernel: their qk-norms and block norms stay plain PyTorch
(whether to wire it in is a question for a later, measured change).

Triton is imported, and the kernel compiled, at the first launch, never at
import: hosts without a card import this module. Triton's cache goes to
build/triton/ at the root of the checkout (ignored by git).
"""

from __future__ import annotations

import importlib.util
import os

import torch

from sparse_videogen_tpu_torch import _kernels

TRITON_CACHE = os.path.join(os.path.dirname(_kernels.BUILD_ROOT), "triton")
_SOURCE = os.path.join(_kernels.CSRC, "rmsnorm_triton.py")
_MODULE = None


def rms_norm_plain(x, weight, eps: float = 1e-5):
    """x (..., d), weight (d,): f32 mean of squares, times rsqrt(ms + eps),
    cast to x.dtype, times weight cast to x.dtype."""
    _kernels.plain_call("rmsnorm")
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return n.to(x.dtype) * weight.to(x.dtype)


def _triton_kernel():
    """The @triton.jit function, loaded from its source file on first use."""
    global _MODULE
    if _MODULE is None:
        os.makedirs(TRITON_CACHE, exist_ok=True)
        os.environ.setdefault("TRITON_CACHE_DIR", TRITON_CACHE)
        spec = importlib.util.spec_from_file_location("svt_rmsnorm_triton", _SOURCE)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULE = mod
    return _MODULE.rmsnorm_kernel


def _blocks(d: int):
    """(BLOCK_D, BLOCK_ROWS, num_warps): whole rows of d padded to a power
    of two, ~8K elements a program."""
    block_d = 1 << (d - 1).bit_length()
    block_rows = max(1, 8192 // block_d)
    return block_d, block_rows, 8 if block_d * block_rows >= 8192 else 4


def rms_norm_kernel(x, weight, eps: float = 1e-5):
    """x (..., d) with d <= 16384, weight (d,). CUDA tensors launch the Triton
    kernel (bf16, f16 or f32, contiguous) and raise on anything else; CPU
    tensors run the plain version."""
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"weight must be ({d},), got {tuple(weight.shape)}")
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32) or not x.is_contiguous() or d > 16384:
        raise ValueError(f"x: need contiguous bf16/f16/f32 with d <= 16384, got {x.dtype} d={d}")
    if weight.device != x.device or not weight.is_contiguous():
        raise ValueError(f"weight: need a contiguous tensor on {x.device}")
    kernel = _triton_kernel()
    n_rows = x.numel() // d
    out = torch.empty_like(x)
    block_d, block_rows, warps = _blocks(d)
    kernel[(-(-n_rows // block_rows),)](x, weight, out, n_rows, d, eps, BLOCK_ROWS=block_rows, BLOCK_D=block_d,
                                        num_warps=warps)
    _kernels.launched("rmsnorm")
    return out
