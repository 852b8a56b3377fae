"""Chunked CSR metadata for the block-sparse attention kernel (counterpart of
the numpy functions in sparse_videogen_tpu/ops/metadata.py; bit-identical).

Per (row r, q-block i) the kernel reads an int32 vector
    meta[r, i, :] = [n_cheap * N_CHEAP_SCALE + n, idx_0, win_0, idx_1, win_1, ...]
where chunk c starts at token idx_c * SUB, spans block_kv tokens, and its
live columns are [lo, hi) with win = lo * ENTRY_SCALE + hi. Rows R are 1
(mask shared across heads: dense, SVG1) or B*H.

The metadata depends only on static shapes, so it is built once on the host
in numpy and copied to the device by the runtime.
"""

from __future__ import annotations

import numpy as np

from sparse_videogen_tpu_torch.ops.mask_spec import full_block_allowed

SUB = 128  # sub-block granularity (alignment of chunk starts)
# > max block_kv: hi can equal block_kv and must round-trip through the packing
ENTRY_SCALE = 2048
ENTRY_STRIDE = 2
# meta[..., 0] packs n_cheap * N_CHEAP_SCALE + n_total
N_CHEAP_SCALE = 4096


def pack_window(lo, hi):
    return lo * ENTRY_SCALE + hi


def meta_row_len(cap: int) -> int:
    return 1 + ENTRY_STRIDE * cap


def classify_cheap_np(meta, spec, aux, *, block_q: int, block_kv: int, seq_q: int | None = None):
    """Reorder each row's entries cheap-first and pack the counts into entry 0.

    A chunk is cheap when every (q, k) pair of [q-block rows] x [its window]
    is allowed by `spec` (full_block_allowed); the kernel then skips the
    token-level predicate for it. q blocks fully inside padding (>= seq_q)
    are cheap unconditionally. Returns a new array.
    """
    meta = np.asarray(meta).copy()
    if spec is None or getattr(spec, "kind", "none") == "none":
        return meta
    R, nQ, row_len = meta.shape
    cap = (row_len - 1) // ENTRY_STRIDE
    n = meta[..., 0] % N_CHEAP_SCALE
    idx = meta[..., 1::2][..., :cap]
    win = meta[..., 2::2][..., :cap]
    lo = win // ENTRY_SCALE
    hi = win % ENTRY_SCALE
    k0 = idx * SUB + lo
    k1 = idx * SUB + hi - 1
    q0 = (np.arange(nQ, dtype=np.int64) * block_q)[None, :, None]
    q1 = q0 + block_q - 1
    if seq_q is not None:
        pad_block = q0 >= seq_q
        q1 = np.minimum(q1, seq_q - 1)
    else:
        pad_block = np.zeros_like(q0, bool)
    aux = None if aux is None else np.asarray(aux)
    cheap = np.asarray(full_block_allowed(spec, q0, np.maximum(q1, q0), k0, k1, aux))
    cheap = (cheap | pad_block) & (hi > lo)
    e = np.arange(cap)[None, None, :]
    valid = e < n[..., None]
    key = np.where(~valid, 2, np.where(cheap, 0, 1)).astype(np.int8)
    order = np.argsort(key, axis=-1, kind="stable")
    out = meta.copy()
    out[..., 1::2][..., :cap] = np.take_along_axis(idx, order, axis=-1)
    out[..., 2::2][..., :cap] = np.take_along_axis(win, order, axis=-1)
    n_cheap = np.sum(cheap & valid, axis=-1)
    out[..., 0] = n_cheap * N_CHEAP_SCALE + n
    return out


def chunk_meta_np(mask: np.ndarray, counts: np.ndarray, *, block_kv: int, cap: int | None = None) -> np.ndarray:
    """Metadata from a sub-block mask.

    mask: (R, nQ, nsub) bool over 128-token sub-blocks; counts: (R, nsub)
    valid tokens per sub-block (0..128). Runs of consecutive visited
    sub-blocks break after a partial sub-block and are cut into chunks of
    block_kv tokens; a chunk start is clamped to nsub - block_kv/SUB so the
    chunk stays inside the array (then lo > 0). Returns (R, nQ, 1 + 2*cap).
    """
    R, nQ, nsub = mask.shape
    assert block_kv < ENTRY_SCALE, (block_kv, ENTRY_SCALE)
    C = block_kv // SUB
    rows = []
    max_n = 0
    for r in range(R):
        for i in range(nQ):
            entries = []
            j = 0
            while j < nsub:
                if not (mask[r, i, j] and counts[r, j] > 0):
                    j += 1
                    continue
                start = j
                span = 0
                valid = 0
                while j < nsub and span < C and mask[r, i, j] and counts[r, j] > 0:
                    valid += int(counts[r, j])
                    partial = counts[r, j] < SUB
                    span += 1
                    j += 1
                    if partial:
                        break
                idx = min(start, nsub - C)
                lo = (start - idx) * SUB
                entries.append((idx, pack_window(lo, lo + valid)))
            rows.append(entries)
            max_n = max(max_n, len(entries))
    if cap is None:
        cap = max_n
    meta = np.zeros((R, nQ, meta_row_len(cap)), np.int32)
    it = iter(rows)
    for r in range(R):
        for i in range(nQ):
            entries = next(it)[:cap]
            meta[r, i, 0] = len(entries)
            for e, (idx, win) in enumerate(entries):
                meta[r, i, 1 + 2 * e] = idx
                meta[r, i, 2 + 2 * e] = win
    return meta


def dense_meta(seq_q: int, seq_kv: int, *, block_q: int, block_kv: int) -> np.ndarray:
    """Metadata visiting every kv token (dense attention), R=1."""
    nQ = -(-seq_q // block_q)
    nsub = -(-seq_kv // SUB)
    counts = np.minimum(SUB, seq_kv - np.arange(nsub) * SUB).astype(np.int32)[None]
    return chunk_meta_np(np.ones((1, nQ, nsub), bool), counts, block_kv=block_kv)


def kv_counts_for_seq(seq_real: int, seq_pad: int | None = None) -> np.ndarray:
    """Per-sub-block valid counts for a real length inside a padded buffer."""
    nsub = -(-(seq_pad or seq_real) // SUB)
    return np.clip(seq_real - np.arange(nsub) * SUB, 0, SUB).astype(np.int32)[None]


def decode_meta(meta, *, block_kv: int, seq_kv: int):
    """Metadata -> per-row boolean token mask (R, nQ, seq_kv) (tests only)."""
    meta = np.asarray(meta)
    R, nQ, _ = meta.shape
    out = np.zeros((R, nQ, seq_kv), bool)
    for r in range(R):
        for i in range(nQ):
            n = meta[r, i, 0] % N_CHEAP_SCALE
            for e in range(n):
                idx = meta[r, i, 1 + 2 * e]
                win = meta[r, i, 2 + 2 * e]
                lo, hi = win // ENTRY_SCALE, win % ENTRY_SCALE
                base = idx * SUB
                out[r, i, base + lo : base + hi] = True
    return out
