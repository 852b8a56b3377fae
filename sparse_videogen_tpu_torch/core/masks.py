"""SVG1 mask math (counterpart of sparse_videogen_tpu/core/masks.py):
sparsity calibration, profiling-mask predicates and the block-level
execution mask. Block masks depend only on static shapes and are numpy;
the profiling predicates evaluate on torch tensors of positions. Only
video-only layouts (Wan) are ported: sparse/svg1.make_svg1_plan rejects a
layout with text tokens in the sequence.
"""

from __future__ import annotations

import math

import numpy as np

from sparse_videogen_tpu_torch.config import VideoLayout


def sparsity_to_width(sparsity: float, context_length: int, num_frame: int, frame_size: int) -> float:
    """Convert a target sparsity into a sliding-window width in frames."""
    seq_len = context_length + num_frame * frame_size
    total = seq_len**2
    adj = (sparsity * total - 2 * seq_len * context_length) / total
    width = seq_len * (1 - math.sqrt(1 - adj))
    return width / frame_size


def temporal_index_map(layout: VideoLayout) -> np.ndarray:
    """(seq_len,) int32 gather indices of the token-major ("temporal")
    layout of a video-only sequence: destination p*nf + f holds source
    f*fs + p."""
    nf, fs = layout.num_frames, layout.frame_size
    o = np.arange(layout.seq_len, dtype=np.int32)
    return (o % nf) * fs + o // nf


def inverse_permutation(g: np.ndarray) -> np.ndarray:
    inv = np.empty_like(g)
    inv[g] = np.arange(len(g), dtype=g.dtype)
    return inv


def profile_mask_predicate(layout: VideoLayout, mask_name: str, multiplier: float, *, block: int = 128):
    """fn(q_idx, k_idx) -> bool for the emulated profiling masks of a
    video-only sequence ("spatial": block band in frame-major order;
    "temporal": the same band through the token-major permutation), plus the
    first-frame sink. q_idx, k_idx: broadcastable int tensors of positions."""
    nf, fs = layout.num_frames, layout.frame_size
    thres = int(multiplier * fs) // block

    def pred(q_idx, k_idx):
        qv, kv = q_idx, k_idx
        if mask_name == "temporal":
            qv = (qv % fs) * nf + qv // fs
            kv = (kv % fs) * nf + kv // fs
        return (abs(qv // block - kv // block) < thres) | (kv < fs)

    return pred


def execution_mask_block(layout: VideoLayout, multiplier: float, *, block_q: int = 128,
                         block_kv: int = 128) -> np.ndarray:
    """(n_q, n_k) block mask of the shared SVG1 execution mask of a
    video-only sequence: a block is active iff the band |q - kv| <= W
    (W = multiplier * frame_size rounded up to 128) holds for its closest
    token pair, or its first column is in the first-frame sink."""
    n_q = -(-layout.seq_len // block_q)
    n_k = -(-layout.seq_len // block_kv)
    two_frame = math.ceil(multiplier * layout.frame_size / 128) * 128
    qi = np.arange(n_q) * block_q
    ki = np.arange(n_k) * block_kv
    q_lo, q_hi = qi[:, None], (qi + block_q - 1)[:, None]
    k_lo, k_hi = ki[None, :], (ki + block_kv - 1)[None, :]
    gap = np.maximum(np.maximum(k_lo - q_hi, q_lo - k_hi), 0)
    return (gap <= two_frame) | (k_lo < layout.frame_size)
