"""Low-precision linears and the per-head pseudo-quantization experiment
(counterpart of sparse_videogen_tpu/utils/quant.py).

- `pseudo_quantize_absmax_perhead` and `random_orthogonal`: the reference's
  accuracy experiment on q/k/v (symmetric per-head absmax, an optional
  random rotation).
- fp8 weight-only storage (`FP8Linear`): e4m3 weights and one f32 scale a
  linear, upcast to the activation dtype before the matmul, which stays in
  bf16 (the JAX package has no fp8 tensor-core path either).
- int8 W8A8 (`Int8Linear`): per-output-channel int8 weights, dynamic
  per-token int8 activations, an int8 x int8 -> int32 product
  (`int8_matmul`: torch._int_mm, cuBLASLt on the card, as the JAX package
  leaves its int8 dot to XLA) and the f32 rescale (models/common/layers.py).

`quantize_linears_int8` / `quantize_linears_fp8` swap the qualifying
nn.Linears of a module tree. The size rule is the JAX walker's: a weight
counts its stacked size, so a linear inside an nn.ModuleList of L blocks
counts L x its elements (JAX stacks the blocks' weights). Unlike the JAX
walker, only linears qualify: its rule also takes a stacked LayerNorm weight
of enough elements (Wan 14B's norm3, (40, 5120)), which its forward then
cannot read (ROADMAP.md section 3); "embeddings and norms untouched" is what
it means to do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0


def pseudo_quantize_absmax_perhead(x, n_bits: int = 8):
    """x (B, H, S, D) -> fake-quantized x (same dtype): symmetric absmax over
    each (B, H) head, codes in [-2^(n-1), 2^(n-1) - 1], round half to even."""
    maxq = 2 ** (n_bits - 1) - 1
    xf = x.float()
    scale = xf.abs().amax(dim=(2, 3), keepdim=True).clamp_min(1e-8) / maxq
    q = torch.round(xf / scale).clamp(-maxq - 1, maxq)
    return (q * scale).to(x.dtype)


def random_orthogonal(dim: int, generator: torch.Generator | None = None, *, matrix=None):
    """A random rotation (Hadamard stand-in): Q of the QR of a standard
    normal (dim, dim) f32 matrix drawn from `generator`, or of `matrix`."""
    a = torch.randn(dim, dim, generator=generator) if matrix is None else torch.as_tensor(matrix, dtype=torch.float32)
    return torch.linalg.qr(a)[0]


class FP8Linear(nn.Module):
    """An nn.Linear stored as e4m3 `w8` (out, in) and its f32 `scale`."""

    def __init__(self, w8, scale, bias):
        super().__init__()
        self.out_features, self.in_features = w8.shape
        self.register_buffer("w8", w8)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)


class Int8Linear(nn.Module):
    """An nn.Linear stored as int8 `wi8` (out, in), contiguous, and its f32
    per-output-channel `wscale` (out,)."""

    def __init__(self, wi8, wscale, bias):
        super().__init__()
        self.out_features, self.in_features = wi8.shape
        self.register_buffer("wi8", wi8)
        self.register_buffer("wscale", wscale)
        self.register_buffer("bias", bias)


def fp8_quantize_linear(lin: nn.Linear, dtype=torch.float8_e4m3fn) -> FP8Linear:
    """One per-tensor absmax scale (the JAX package's per layer of the stack):
    scale = max(|w|, 1e-12) / 448, w8 = w / scale rounded to e4m3 (nearest, ties
    to even)."""
    w = lin.weight.detach().float()
    scale = w.abs().amax().clamp_min(1e-12) / E4M3_MAX
    return FP8Linear((w / scale).to(dtype), scale, None if lin.bias is None else lin.bias.detach().clone())


def int8_quantize_linear(lin: nn.Linear) -> Int8Linear:
    """Per-output-channel scales max(|w_row|, 1e-12) / 127 and codes
    round(w / scale) clipped to +-127."""
    w = lin.weight.detach().float()
    scale = w.abs().amax(dim=1).clamp_min(1e-12) / 127.0
    wi8 = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8).contiguous()
    return Int8Linear(wi8, scale, None if lin.bias is None else lin.bias.detach().clone())


def _walk(module: nn.Module, fn, min_size: int, stack: int = 1):
    """Swap the qualifying nn.Linears under `module` for fn(linear); `stack`
    is the product of the lengths of the ModuleLists above it."""
    stack *= len(module) if isinstance(module, nn.ModuleList) else 1
    for name, child in module.named_children():
        if isinstance(child, nn.Linear):
            if child.weight.is_floating_point() and stack * child.weight.numel() >= min_size:
                setattr(module, name, fn(child))
        else:
            _walk(child, fn, min_size, stack)
    return module


def quantize_linears_int8(module: nn.Module, *, min_size: int = 1 << 16) -> nn.Module:
    """Swap, in place, every nn.Linear whose stacked weight size is at least
    `min_size` for an Int8Linear (W8A8). Returns the module."""
    return _walk(module, int8_quantize_linear, min_size)


def quantize_linears_fp8(module: nn.Module, *, min_size: int = 1 << 16, dtype=torch.float8_e4m3fn) -> nn.Module:
    """Swap, in place, every nn.Linear whose stacked weight size is at least
    `min_size` for an FP8Linear (e4m3 weight-only). Returns the module."""
    return _walk(module, lambda lin: fp8_quantize_linear(lin, dtype), min_size)


PAD_ROWS = 32  # torch._int_mm on CUDA takes more than 16 rows: fewer are padded to this many


def int8_matmul(xi, wi8):
    """xi (M, K) int8 @ wi8 (N, K)^T -> (M, N) int32, exact. torch._int_mm
    (cuBLASLt on the card) on wi8.t(), the layout it takes without a copy;
    16 rows or fewer are padded with zero rows (their sums stay exact) and
    dropped. On the card K and N must be multiples of 8: other shapes
    raise."""
    M, K = xi.shape
    N = wi8.shape[0]
    if xi.is_cuda and (K % 8 or N % 8):
        raise ValueError(f"int8 GEMM on CUDA needs K and N multiples of 8, got K={K}, N={N}")
    if M <= 16:
        return torch._int_mm(F.pad(xi, (0, 0, 0, PAD_ROWS - M)), wi8.t())[:M]
    return torch._int_mm(xi.contiguous(), wi8.t())
