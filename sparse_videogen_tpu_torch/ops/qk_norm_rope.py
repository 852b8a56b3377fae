"""q/k RMSNorm + interleaved RoPE, written in the attention's head layout:
the `model.qk` prologue of the Wan and HunyuanVideo blocks in one pass.

`qk_norm_rope` launches the Hopper kernel (csrc/qk_norm_rope.cu) for CUDA
tensors and the plain version for CPU tensors; `qk_norm_rope_plain` is the
plain version, the kernel's oracle on the card, and the eager chain the
models ran before the kernel: `rms_norm` (WanRMSNorm) over the weight's
length, the head view, the interleaved rotation of ops/rope.py on the rows
the tables cover. The norm group is the weight's length: the whole token
(Wan) or one head (HunyuanVideo). No TPU kernel corresponds to the norm (the
JAX package leaves it to XLA); the rotation is K2's (ops/rope.py, which
CogVideoX still calls).
"""

from __future__ import annotations

import torch

from sparse_videogen_tpu_torch import _kernels
from sparse_videogen_tpu_torch.ops.rope import rotate_interleaved

MAX_D = 8192  # 8 warps a token, at most 6 16-byte loads a thread (csrc/qk_norm_rope.cu)


def rms_norm(x, weight, eps=1e-5):
    """WanRMSNorm: normalise in f32, cast back, then scale in x.dtype."""
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return n.to(x.dtype) * weight.to(x.dtype)


def _heads(x, H):
    B, S, d = x.shape
    return x.view(B, S, H, d // H).transpose(1, 2)


def qk_norm_rope_plain(x, weight, eps: float, heads: int, cos=None, sin=None, *, out=None, r0: int = 0):
    """x (B, S, d); weight (d,) or (d / heads,). rms_norm over the token (a
    (d,) weight) or each head, the (B, heads, S, D) head view, the rotation
    of its rows [0, n) by cos/sin (n, D/2) (rows past n unrotated), all in
    x's dtype as the models' eager chain computed them. Returns that tensor,
    or writes it into rows [r0, r0 + S) of `out` and returns `out`."""
    _kernels.plain_call("qk_norm_rope")
    B, S, d = x.shape
    if weight.shape[0] == d:
        y = _heads(rms_norm(x, weight, eps), heads)
    else:
        y = rms_norm(_heads(x, heads), weight, eps)
    if cos is not None:
        n = cos.shape[0]
        r = rotate_interleaved(y[:, :, :n].reshape(B * heads, n, -1).contiguous(), cos, sin).view(B, heads, n, -1)
        y = r if n == S else torch.cat([r, y[:, :, n:]], dim=2)
    if out is None:
        return y
    out[:, :, r0:r0 + S] = y
    return out


def check_args(x, weight, heads, cos, sin, out, r0):
    """Raise ValueError where the shapes do not fit together (either path):
    x (B, S, d) with d a multiple of heads; weight (d,) or (D,), D = d /
    heads; cos and sin both or neither, each (n, D / 2) with n <= S; out
    (B, heads, S_out, D) of x's dtype and device with 0 <= r0 and r0 + S <=
    S_out."""
    if x.dim() != 3 or heads <= 0 or x.shape[2] % heads:
        raise ValueError(f"x must be (B, S, d) with d a multiple of heads={heads}, got {tuple(x.shape)}")
    B, S, d = x.shape
    D = d // heads
    if weight.dim() != 1 or weight.shape[0] not in (d, D):
        raise ValueError(f"weight: need ({d},) or ({D},), got {tuple(weight.shape)}")
    if (cos is None) != (sin is None):
        raise ValueError("cos and sin come together")
    if cos is not None:
        for name, t in (("cos", cos), ("sin", sin)):
            if t.dim() != 2 or t.shape[1] != D // 2 or t.shape[0] > S or t.shape != cos.shape:
                raise ValueError(f"{name}: need (n <= {S}, {D // 2}), got {tuple(t.shape)}")
    if out is not None:
        if (out.dim() != 4 or tuple(out.shape[:2]) != (B, heads) or out.shape[3] != D or r0 < 0
                or r0 + S > out.shape[2] or out.dtype != x.dtype or out.device != x.device):
            raise ValueError(f"out: need ({B}, {heads}, >= {r0} + {S}, {D}) {x.dtype} on {x.device}, got "
                             f"{tuple(out.shape)} {out.dtype} on {out.device}")
    elif r0:
        raise ValueError("r0 needs out")


def kernel_args(x, weight, cos, sin, out):
    """(x's batch stride, x's token stride, the tables' rows) in elements as
    the kernel takes them (the batch stride 0 for one batch), for arguments
    that passed check_args; raises ValueError on what the kernel cannot
    read: x not bf16, d not a multiple of 8 or above MAX_D, a non-unit last
    stride, token or batch strides that break 16-byte alignment, 2^31 tokens
    or more; a head of D % 8 != 0, or a per-head weight with 32 % (D / 8) !=
    0; a weight or tables not f32, contiguous, 16-byte aligned and on x's
    device; out not contiguous."""
    B, S, d = x.shape
    if x.dtype != torch.bfloat16 or d % 8 or d > MAX_D:
        raise ValueError(f"x: need bf16 with d % 8 == 0 and d <= {MAX_D}, got {x.dtype} d={d}")
    if (x.stride(2) != 1 or (S > 1 and x.stride(1) % 8) or (B > 1 and x.stride(0) % 8) or x.data_ptr() % 16):
        raise ValueError(f"x: need a unit last stride, token and batch strides that are multiples of 8 and 16-byte "
                         f"alignment, got strides {x.stride()}")
    if B * S >= 2 ** 31:
        raise ValueError(f"x: {B * S} tokens, the kernel takes fewer than 2^31")
    D = out.shape[3]
    if D % 8 or (weight.shape[0] == D != d and 32 % (D // 8)):
        raise ValueError(f"head dim {D}: need D % 8 == 0, and 32 % (D / 8) == 0 for a per-head norm")
    for name, t in (("weight", weight), ("cos", cos), ("sin", sin)):
        if t is not None and (t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous()
                              or t.data_ptr() % 16):
            raise ValueError(f"{name}: need contiguous 16-byte aligned f32 on {x.device}, got {t.dtype} on "
                             f"{t.device}")
    if not out.is_contiguous():
        raise ValueError("out: need a contiguous (B, H, S_out, D) tensor")
    return (x.stride(0) if B > 1 else 0), (x.stride(1) if S > 1 else d), (0 if cos is None else cos.shape[0])


def qk_norm_rope(x, weight, eps: float, heads: int, cos=None, sin=None, *, out=None, r0: int = 0):
    """x (B, S, d), a q or k projection's output (any token and batch
    stride); weight f32 (d,) to normalise each token, or (d / heads,) each
    head; cos/sin f32 (n, D/2) to rotate the tokens [0, n) (None: no RoPE).
    CUDA tensors launch the kernel and raise on anything it cannot read
    (kernel_args); CPU tensors run the plain version. Returns the
    (B, heads, S, D) result: on the card a new contiguous tensor, or rows
    [r0, r0 + S) of `out` (a contiguous (B, heads, S_out, D) buffer, so two
    streams join without a copy), and `out` returned."""
    check_args(x, weight, heads, cos, sin, out, r0)
    if x.device.type == "cpu":
        return qk_norm_rope_plain(x, weight, eps, heads, cos, sin, out=out, r0=r0)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, S, d = x.shape
    if out is None:
        out = torch.empty(B, heads, S, d // heads, dtype=x.dtype, device=x.device)
    x_bstride, x_sstride, n_rope = kernel_args(x, weight, cos, sin, out)
    err = _kernels.lib().svt_qk_norm_rope(
        x.data_ptr(), weight.data_ptr(), None if cos is None else cos.data_ptr(),
        None if sin is None else sin.data_ptr(), out.data_ptr(), B, S, x_bstride, x_sstride, d, weight.shape[0], heads,
        n_rope, out.shape[2], r0, float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(err, "qk_norm_rope")
    _kernels.launched("qk_norm_rope")
    return out
