"""SVG1 mask math (counterpart of sparse_videogen_tpu/core/masks.py):
sparsity calibration, profiling-mask predicates and the block-level
execution mask. Block masks depend only on static shapes and are numpy;
the profiling predicates evaluate on torch tensors of positions.

Each layout fixes the mask family the JAX package selects with its flags:
- video only (Wan, TextPosition.NONE): first-frame sink, band rounded up
  to 128 with <=;
- text last (HunyuanVideo, TextPosition.LAST) and text first (CogVideoX,
  TextPosition.FIRST): no sink, band rounded down with a strict <, text rows
  and columns fully attended. The video segment starts at `video_start`.
"""

from __future__ import annotations

import math

import numpy as np

from sparse_videogen_tpu_torch.config import TextPosition, VideoLayout


def video_start(layout: VideoLayout) -> int:
    """First video token: after the text when it comes first, else 0."""
    return layout.context_length if layout.text_position == TextPosition.FIRST else 0


def sparsity_to_width(sparsity: float, context_length: int, num_frame: int, frame_size: int) -> float:
    """Convert a target sparsity into a sliding-window width in frames."""
    seq_len = context_length + num_frame * frame_size
    total = seq_len**2
    adj = (sparsity * total - 2 * seq_len * context_length) / total
    width = seq_len * (1 - math.sqrt(1 - adj))
    return width / frame_size


def temporal_index_map(layout: VideoLayout) -> np.ndarray:
    """(seq_len,) int32 gather indices of the token-major ("temporal")
    layout: on the video tokens destination vstart + p*nf + f holds source
    vstart + f*fs + p; text tokens stay in place."""
    nf, fs, vid = layout.num_frames, layout.frame_size, layout.video_length
    vs = video_start(layout)
    g = np.arange(layout.seq_len, dtype=np.int32)
    o = np.arange(vid, dtype=np.int32)
    g[vs:vs + vid] = vs + (o % nf) * fs + o // nf
    return g


def inverse_permutation(g: np.ndarray) -> np.ndarray:
    inv = np.empty_like(g)
    inv[g] = np.arange(len(g), dtype=g.dtype)
    return inv


def profile_mask_predicate(layout: VideoLayout, mask_name: str, multiplier: float, *, block: int = 128):
    """fn(q_idx, k_idx) -> bool for the emulated profiling masks ("spatial":
    block band in frame-major order over video-relative positions;
    "temporal": the same band through the token-major permutation). Video
    only: plus the first-frame sink. Text last or first: no sink, and text
    rows and columns are fully attended. q_idx, k_idx: broadcastable int
    tensors of positions."""
    nf, fs, vid = layout.num_frames, layout.frame_size, layout.video_length
    vs = video_start(layout)
    thres = int(multiplier * fs) // block
    text = layout.context_length > 0

    def pred(q_idx, k_idx):
        qv, kv = q_idx - vs, k_idx - vs
        if mask_name == "temporal":
            qv = (qv % fs) * nf + qv // fs
            kv = (kv % fs) * nf + kv // fs
        m = abs(qv // block - kv // block) < thres
        if text:
            q_text = (q_idx < vs) | (q_idx >= vs + vid)
            k_text = (k_idx < vs) | (k_idx >= vs + vid)
            return m | q_text | k_text
        return m | (kv < fs)

    return pred


def execution_mask_block(layout: VideoLayout, multiplier: float, *, block_q: int = 128,
                         block_kv: int = 128) -> np.ndarray:
    """(n_q, n_k) block mask of the shared SVG1 execution mask: a block is
    active iff the band holds for its closest token pair. Video only: band
    |q - kv| <= W, W = multiplier * frame_size rounded up to 128, or the
    block's first column in the first-frame sink. Text last or first: band
    |q - kv| < W rounded down, or the block touches a text column or a text
    row (the static superset any prompt length can reach; the kernel's
    hyvideo/cog predicate masks exactly inside it)."""
    fs, vid, ctx = layout.frame_size, layout.video_length, layout.context_length
    n_q = -(-layout.seq_len // block_q)
    n_k = -(-layout.seq_len // block_kv)
    qi = np.arange(n_q) * block_q
    ki = np.arange(n_k) * block_kv
    q_lo, q_hi = qi[:, None], (qi + block_q - 1)[:, None]
    k_lo, k_hi = ki[None, :], (ki + block_kv - 1)[None, :]
    gap = np.maximum(np.maximum(k_lo - q_hi, q_lo - k_hi), 0)
    if ctx:
        band = gap < math.floor(multiplier * fs / 128) * 128
        if layout.text_position == TextPosition.FIRST:
            return band | (k_lo < ctx) | (q_lo < ctx)
        return band | (k_hi >= vid) | (q_hi >= vid)
    band = math.ceil(multiplier * fs / 128) * 128
    return (gap <= band) | (k_lo < fs)


def execution_mask_block_perm(layout: VideoLayout, multiplier: float, *, block_q: int = 128,
                              block_kv: int = 128) -> np.ndarray:
    """(n_q, n_k) block skeleton of the temporal band+sink mask in the
    original token order (placement-free SVG1, video only): the band
    |p(q) - p(k)| <= W, W = multiplier * frame_size rounded up to 128, with
    the permuted positions p(x) = (x % fs) * F + x // fs, and the sink
    p(k) < fs. The p-sets of a block are not intervals, so each q block's
    allowed columns are computed exactly (numpy, once per plan)."""
    seq, fs, nf = layout.video_length, layout.frame_size, layout.num_frames
    w = math.ceil(multiplier * fs / 128) * 128
    x = np.arange(seq)
    p = (x % fs) * nf + x // fs
    sink = p < fs
    n_q = -(-seq // block_q)
    n_k = -(-seq // block_kv)
    out = np.zeros((n_q, n_k), bool)
    pad = n_k * block_kv - seq
    for b in range(n_q):
        pq = p[b * block_q:(b + 1) * block_q][:, None]
        allowed = (np.abs(pq - p[None, :]) <= w).any(axis=0) | sink
        out[b] = np.concatenate([allowed, np.zeros(pad, bool)]).reshape(n_k, block_kv).any(axis=1)
    return out

