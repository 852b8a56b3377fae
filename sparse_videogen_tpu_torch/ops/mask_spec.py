"""Elementwise execution-mask predicates (counterpart of
sparse_videogen_tpu/ops/mask_spec.py).

The chunked metadata (ops/metadata.py) is the block skeleton; inside each
visited chunk the attention evaluates the exact token-level predicate below.
`apply_mask_spec` takes torch tensors (or numpy arrays) of positions;
`full_block_allowed` is scalar interval math on numpy, used when the metadata
is built. The chunked-CSR Hopper kernel implements the kinds "none",
"band_sink", "hyvideo" and "cog", the run-list kernel "none" and
"band_sink"; band_sink_perm is exact here and in the plain attention.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    kind: str = "none"  # none | band_sink | band_sink_perm | hyvideo | cog
    band_width: int = 0  # strict <. For the reference's <= W pass W + 1.
    sink_size: int = 0  # band_sink[_perm]: kv < sink_size always attended
    video_len: int = 0  # hyvideo: static video token count
    # band_sink_perm: band + sink at permuted positions
    # p(x) = (x % frame_size) * num_frames + x // frame_size
    frame_size: int = 0
    num_frames: int = 0


def apply_mask_spec(spec: MaskSpec, qpos, kpos, aux):
    """qpos, kpos: broadcastable int tensors of positions; aux[2]/aux[3] are
    global q/k offsets, aux[0] the prompt scalar of hyvideo/cog.

    Returns a bool tensor (True = attend), or None when kind == "none".
    """
    if spec.kind == "none":
        return None
    if aux is not None:
        qpos = qpos + int(aux[2])
        kpos = kpos + int(aux[3])
    if spec.kind == "band_sink_perm":
        fs = spec.frame_size
        pq = (qpos % fs) * spec.num_frames + qpos // fs
        pk = (kpos % fs) * spec.num_frames + kpos // fs
        return (abs(pq - pk) < spec.band_width) | (pk < spec.sink_size)
    band = abs(qpos - kpos) < spec.band_width
    if spec.kind == "band_sink":
        return band | (kpos < spec.sink_size)
    if spec.kind == "cog":
        plen = int(aux[0])
        return band | (kpos < plen) | (qpos < plen)
    if spec.kind == "hyvideo":
        real = int(aux[0])  # video_len + prompt_length
        vid = spec.video_len
        real_pair = (qpos < real) & (kpos < real)
        fake_pair = (qpos >= real) & (kpos >= real)
        text_col = (kpos >= vid) & (kpos < real)
        text_row = (qpos >= vid) & (qpos < real)
        return (real_pair & (band | text_col | text_row)) | fake_pair
    raise ValueError(f"unknown mask kind {spec.kind}")


def full_block_allowed(spec: MaskSpec, q0, q1, k0, k1, aux):
    """Conservative test: does EVERY (q, k) pair in the inclusive rectangle
    [q0, q1] x [k0, k1] attend under `spec`? (numpy; false negatives only
    cost speed, never correctness.)"""
    if aux is not None:
        q0 = q0 + aux[2]
        q1 = q1 + aux[2]
        k0 = k0 + aux[3]
        k1 = k1 + aux[3]
    if spec.kind == "band_sink_perm":
        fs, F = spec.frame_size, spec.num_frames

        def p_hull(x0, x1):
            f0, s0 = x0 // fs, x0 % fs
            f1, s1 = x1 // fs, x1 % fs
            same = f0 == f1
            pmin = np.where(same, s0 * F + f0, f0)
            pmax = np.where(same, s1 * F + f0, (fs - 1) * F + f1)
            return pmin, pmax

        pq0, pq1 = p_hull(q0, q1)
        pk0, pk1 = p_hull(k0, k1)
        band_all = (pq1 - pk0 < spec.band_width) & (pk1 - pq0 < spec.band_width)
        return band_all | (pk1 < spec.sink_size)
    band_all = (q1 - k0 < spec.band_width) & (k1 - q0 < spec.band_width)
    if spec.kind == "band_sink":
        return band_all | (k1 < spec.sink_size)
    if spec.kind == "cog":
        plen = aux[0]
        return band_all | (k1 < plen) | (q1 < plen)
    if spec.kind == "hyvideo":
        real = aux[0]
        vid = spec.video_len
        real_all = (q1 < real) & (k1 < real)
        fake_all = (q0 >= real) & (k0 >= real)
        text_col_all = (k0 >= vid) & (k1 < real)
        text_row_all = (q0 >= vid) & (q1 < real)
        return (real_all & (band_all | text_col_all | text_row_all)) | fake_all
    raise ValueError(f"unknown mask kind {spec.kind}")

