"""The benchmark's own count of a denoising step's work (the yardstick of
step_mfu and attn_roofline): model FLOPs and the attention's bytes, from the
configuration's shapes and the pattern the traffic runs. Padding is never
counted; work that depends on the inputs is counted as these inputs need it.

- A linear: 2 x its weights x the tokens it sees x the batch.
- Attention: 4 D a (query, key) pair that the pattern allows (2 D for q k^T
  and 2 D for p v), per head and batch item: every pair for dense, the
  execution mask's pairs for SVG1.
- The attention's bytes: q, k, v read and o written once, bf16.
"""

from __future__ import annotations

import numpy as np

from svgbench.reference.svg1 import Layout, band_frames

BF16 = 2


def band_pairs(layout: Layout, width: float) -> int:
    """Pairs among the live tokens that SVG1's execution mask allows
    (svgbench/reference/svg1.py): the same count for a spatial and a temporal
    head, the temporal one being the same band on the token-major order."""
    S, fs, vid = layout.seq, layout.fs, layout.vid
    q = np.arange(S, dtype=np.int64)
    if layout.text == 0:
        w = int(np.ceil(width * fs / 128) * 128)
        lo, hi = np.maximum(q - w, 0), np.minimum(q + w, S - 1)
        band = hi - lo + 1
        # sink columns [0, fs) outside the band
        sink_out = np.minimum(lo, fs) + np.maximum(fs - 1 - hi, 0)
        return int((band + sink_out).sum())
    w = int(np.floor(width * fs / 128) * 128)
    real = vid + layout.prompt
    # video rows: the band (|q-k| < w) over the video columns, plus the live text columns
    qv = q[:vid]
    lo, hi = np.maximum(qv - (w - 1), 0), np.minimum(qv + (w - 1), vid - 1)
    video_rows = int((hi - lo + 1).sum()) + vid * layout.prompt
    text_rows = layout.prompt * real  # live text rows see every live token
    return video_rows + text_rows


def dense_pairs(layout: Layout) -> int:
    """Every pair among the live tokens (the padding text is not counted)."""
    return (layout.vid + layout.prompt if layout.text else layout.seq) ** 2


def attention_pairs(layout: Layout, pattern: str, sparsity: float, dense_layers: int, layers: int) -> int:
    """Self-attention pairs of one forward, per head and batch item, summed
    over the layers: the first `dense_layers` dense, the rest by `pattern`."""
    if pattern == "dense":
        return layers * dense_pairs(layout)
    if pattern == "SVG":
        return dense_layers * dense_pairs(layout) + (layers - dense_layers) * band_pairs(
            layout, band_frames(sparsity, layout))
    raise ValueError(f"no count for pattern {pattern!r}")
