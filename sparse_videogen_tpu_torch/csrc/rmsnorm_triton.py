"""Row RMSNorm in Triton for Hopper (K6; replaces the TPU kernel
sparse_videogen_tpu/ops/rmsnorm_pallas.py::_kernel).

Loaded by ops/rmsnorm.py only when it launches the kernel (this module
imports triton, which hosts without a card need not have). WanRMSNorm
semantics: the f32 mean of squares, times rsqrt(ms + eps), cast to the
output dtype, then times the weight cast to that dtype (the product taken in
f32 and rounded once, as PyTorch's bf16 multiply does).

What bounds it on the H100: bytes, one read of x and one write of the
output (the weight is negligible). A one-pass row reduction is a
bandwidth-bound stream that Triton serves as well as CUDA would: each
program holds BLOCK_ROWS whole rows in registers (BLOCK_D, the row width
padded to a power of two, masked), reduces them once and writes them once.
"""

import triton
import triton.language as tl


@triton.jit
def rmsnorm_kernel(x_ptr, w_ptr, o_ptr, n_rows, d, eps, BLOCK_ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_ROWS + tl.arange(0, BLOCK_ROWS)
    cols = tl.arange(0, BLOCK_D)
    cmask = cols < d
    mask = (rows < n_rows)[:, None] & cmask[None, :]
    offs = rows.to(tl.int64)[:, None] * d + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    ms = tl.sum(x * x, axis=1) / d
    n = (x * tl.rsqrt(ms + eps)[:, None]).to(o_ptr.dtype.element_ty)
    w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(o_ptr.dtype.element_ty)
    out = (n.to(tl.float32) * w.to(tl.float32)).to(o_ptr.dtype.element_ty)
    tl.store(o_ptr + offs, out, mask=mask)
