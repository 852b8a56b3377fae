"""Dense attention with q-split sub-tiles (counterpart of the TPU probe
kernel scripts/bench_qsplit.py::_kernel, K7; entry `dense_attn`).

`dense_attn` launches the Hopper kernel (csrc/dense_qsplit.cu) for CUDA
tensors and the plain version for CPU tensors; `dense_attn_plain` is the
plain version, the kernel's oracle on the card. Numerics are the TPU
kernel's: q scaled by D^-1/2 in f32 and rounded to q's dtype, natural-exp
online softmax in f32 per bkv chunk, P rounded to v's dtype for PV, the
output divided by max(l, 1e-20). K and V are separate tensors (the TPU
packed them into one [K|V] row).

On the card K7 runs the attention kernels' Hopper CTA body
(csrc/hopper_attn.cuh): a CTA owns bq = 128 q rows as two consumer
warpgroups of 64, the probe's independent sub-tiles. qsplit = 1 runs them
on K1's schedule, qsplit = 2 in ping-pong (FA3's schedule). Those two pairs
are KERNEL_CONFIGS; `unfit` says why any other pair is not compiled.
"""

from __future__ import annotations

import math

import torch

from sparse_videogen_tpu_torch import _kernels

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
BQ = BK = 128  # q rows a CTA (two 64-row wgmma warpgroups); K/V tokens a tile
KERNEL_CONFIGS = ((128, 1), (128, 2))
SMEM_LIMIT = 232448  # bytes of shared memory a CTA can use on the H100
REGS_PER_SM = 65536
CONSUMER_REGS = 232  # registers a consumer thread holds (setmaxnreg): O (D / 2 a row pair), S (64), P, state


def unfit(bq: int, qsplit: int, D: int = 128) -> str | None:
    """None when the kernel takes (bq, qsplit) at head dim D, else every reason it does not."""
    if (bq, qsplit) in KERNEL_CONFIGS and D in (64, 128):
        return None
    reasons = []
    smem = bq * D * 2 + 2 * 2 * BK * D * 2  # the q tile, then two stages of a K and a V tile
    if smem > SMEM_LIMIT:
        reasons.append(f"shared memory: the q tile and 2 K/V stages take {smem} B > {SMEM_LIMIT} B")
    wgs = max(bq // 64, 1)
    if 128 * 24 + wgs * 128 * CONSUMER_REGS > REGS_PER_SM:
        reasons.append(f"registers: {bq} rows are {wgs} consumer warpgroups of 64 (wgmma's M), each thread holding "
                       f"~{CONSUMER_REGS} registers (its f32 O and S tiles alone take {D // 2 + 64}); with the "
                       f"producer that exceeds the SM's {REGS_PER_SM}")
    if qsplit not in (1, 2):
        reasons.append(f"qsplit: the sub-tiles are the CTA's two consumer warpgroups, run on K1's schedule (1) or in "
                       f"ping-pong (2); {qsplit} is neither")
    if not reasons:
        reasons.append(f"not compiled: a CTA owns {BQ} q rows, two 64-row warpgroups; qsplit 1 runs them on K1's "
                       f"schedule, 2 in ping-pong (compiled (bq, qsplit): {KERNEL_CONFIGS})")
    return "; ".join(reasons)


def _check(q, k, v, bq, bkv, qsplit):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be (BH, S, D) of one shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    S = q.shape[1]
    if S % bq or S % bkv or bq % qsplit or (bq // qsplit) % 8:
        raise ValueError(f"S={S} bq={bq} bkv={bkv} qsplit={qsplit}: need S % bq == S % bkv == 0 and "
                         f"(bq / qsplit) % 8 == 0")


def dense_attn_plain(q, k, v, *, bq: int, bkv: int, qsplit: int = 1):
    """Plain PyTorch version: every q row at once (rows are independent, so
    the q blocks and sub-tiles of the kernels change nothing), a loop over
    the bkv-token chunks of K/V with the online softmax."""
    _check(q, k, v, bq, bkv, qsplit)
    _kernels.plain_call("dense_qsplit")
    BH, S, D = q.shape
    q_s = (q.float() * D ** -0.5).to(q.dtype).float()
    acc = torch.zeros(BH, S, D, device=q.device)
    m = torch.full((BH, S, 1), NEG_INF, device=q.device)
    l = torch.zeros(BH, S, 1, device=q.device)
    for c in range(S // bkv):
        kb, vb = k[:, c * bkv:(c + 1) * bkv], v[:, c * bkv:(c + 1) * bkv]
        s = q_s @ kb.float().transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vb.float()
        m = m_new
        del s, p
    return (acc / l.clamp_min(1e-20)).to(q.dtype)


def dense_attn(q, k, v, *, bq: int, bkv: int, qsplit: int = 1):
    """q, k, v (BH, S, D); S % bq == S % bkv == 0. Returns (BH, S, D) in q's
    dtype. CUDA tensors launch the Hopper kernel (bf16, contiguous, D in {64,
    128}, S % 64 == 0, (bq, qsplit) in KERNEL_CONFIGS) and raise on anything
    else; CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return dense_attn_plain(q, k, v, bq=bq, bkv=bkv, qsplit=qsplit)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, bq, bkv, qsplit)
    BH, S, D = q.shape
    reason = unfit(bq, qsplit, D)
    if reason is not None:
        raise ValueError(f"dense_attn kernel cannot take bq={bq}, qsplit={qsplit}, D={D}: {reason}")
    if S % BK:
        raise ValueError(f"S={S} must be a multiple of {BK}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"{name}: need contiguous, 16-byte aligned bf16 on {q.device}, got {t.dtype} on "
                             f"{t.device}")
    out = torch.empty_like(q)
    err = _kernels.lib().svt_dense_qsplit(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S, D, bq,
                                          qsplit, 1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(err, "dense_qsplit")
    _kernels.launched("dense_qsplit")
    return out
