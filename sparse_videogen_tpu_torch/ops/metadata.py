"""Block-sparse attention metadata (counterpart of
sparse_videogen_tpu/ops/metadata.py; bit-identical): chunked CSR for the
dense/SVG1 kernel, run lists for SAP's.

Chunked CSR: per (row r, q-block i) the kernel reads an int32 vector
    meta[r, i, :] = [n_cheap * N_CHEAP_SCALE + n, idx_0, win_0, idx_1, win_1, ...]
where chunk c starts at token idx_c * SUB, spans block_kv tokens, and its
live columns are [lo, hi) with win = lo * ENTRY_SCALE + hi. Rows R are 1
(mask shared across heads: dense, SVG1) or B*H.

The dense/SVG1 metadata depends only on static shapes, so it is built once
on the host in numpy and copied to the device by the runtime; SAP's tile
mode builds its rows at every call on the device (`chunk_meta`,
`tile_meta`).

Slab metadata (the Hopper kernel's temporal heads of placement-free SVG1,
`slab_meta_np`): per q slab j, the K/V slab runs
    row[j] = [n, a_0, b_0, a_1, b_1]
of band_sink_perm's band + sink skeleton on the permuted positions, where a
slab is n_s = 128 // F slots x all F frames (`slab_geometry`). The plain
version and the JAX package read the chunked CSR above instead.

Run lists (SAP): per (row r, q-block i)
    meta[r, i, :] = [n_chunks, a_0, b_0, a_1, b_1, ...]
lists the maximal token runs [a, b) of the cluster-sorted, unpadded K/V that
the row visits (adjacent selected clusters merge); n_chunks counts the
block_kv-token chunks the kernel walks them in. They change every step, so
`run_meta` builds them on the device with tensor ops; `run_meta_np` is the
numpy oracle the tests hold it to.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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


def _compact(flags, vals, cap: int):
    """The entries of `vals` (..., n, E) where `flags` (..., n) holds, in
    order, into (..., cap, E) (zeros past them), and their count capped at
    cap: a cumsum and one scatter on flags' device (JAX's stable argsort of
    the flags, the same entries)."""
    *lead, n = flags.shape
    slot = flags.long().cumsum(-1) - 1
    slot = torch.where(flags & (slot < cap), slot, cap)  # cap: a dump slot, dropped
    out = vals.new_zeros(*lead, cap + 1, vals.shape[-1])
    out.scatter_(-2, slot[..., None].expand(*lead, n, vals.shape[-1]), vals)
    return out[..., :cap, :], flags.sum(-1).clamp_max(cap)


def _pack_rows(n, entries):
    """(n (..,), entries (.., cap, 2)) -> (.., 1 + 2 cap) int32 metadata rows."""
    return torch.cat([n[..., None], entries.flatten(-2)], dim=-1).to(torch.int32).contiguous()


def chunk_meta(mask, counts, *, block_kv: int, cap: int):
    """chunk_meta_np on mask's device (counterpart of chunk_meta_jnp, the
    same integers): mask (R, nQ, nsub) bool, counts (R, nsub) valid tokens
    per sub-block. Runs of visited sub-blocks break after a partial one and
    are cut into block_kv-token chunks from their origin; each row keeps its
    first `cap` chunks. Tensor ops only (no copy to the host), for metadata
    that changes at every call (SAP's tile mode). Returns (R, nQ, 1 + 2*cap)
    int32."""
    R, nQ, nsub = mask.shape
    C = block_kv // SUB
    if block_kv % SUB or block_kv >= ENTRY_SCALE or nsub < C:
        raise ValueError(f"block_kv={block_kv}, nsub={nsub}")
    counts = counts.long()
    full = counts >= SUB
    v = mask & (counts > 0)[:, None, :]
    prev_v = F.pad(v[..., :-1], (1, 0))
    prev_full = F.pad(full[..., :-1], (1, 0))[:, None, :]
    run_start = v & (~prev_v | ~prev_full)
    j = torch.arange(nsub, device=mask.device)
    origin = torch.where(run_start, j, -1).cummax(dim=-1).values
    chunk_start = v & ((j - origin) % C == 0)
    # the chunk at j holds counts[j + k] while sub-block j + k is in its run
    # (runs break after a partial sub-block, so the window is a prefix)
    valid = torch.where(v, counts[:, None, :], 0)
    for k in range(1, C):
        same = F.pad(v[..., k:], (0, k)) & (F.pad(origin[..., k:], (0, k), value=-2) == origin)
        valid = valid + torch.where(same, F.pad(counts[:, k:], (0, k))[:, None, :], 0)
    idx = j.clamp_max(nsub - C)
    lo = (j - idx) * SUB
    vals = torch.stack([idx.expand_as(valid), pack_window(lo, lo + valid)], dim=-1)
    entries, n = _compact(chunk_start, vals, cap)
    return _pack_rows(n, entries)


def tile_meta(sel, *, block_kv: int, n_tokens: int, nsub: int, cap: int):
    """Chunked-CSR rows for uniform tiles on sel's device (counterpart of
    tile_meta_jnp; equal to chunk_meta on the mask repeated to sub-blocks):
    tile t holds tokens [t * block_kv, min((t + 1) * block_kv, n_tokens)) of
    a K/V array of nsub sub-blocks, so each selected tile is one chunk.
    sel (R, NR, T) bool. Returns (R, NR, 1 + 2*cap) int32."""
    C = block_kv // SUB
    t = torch.arange(sel.shape[-1], device=sel.device)
    idx = (t * C).clamp_max(nsub - C)
    lo = (t * C - idx) * SUB
    hi = lo + (n_tokens - t * block_kv).clamp(0, block_kv)
    vals = torch.stack([idx, pack_window(lo, hi)], dim=-1).expand(*sel.shape, 2)
    entries, n = _compact(sel, vals, cap)
    return _pack_rows(n, entries)


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


def run_meta_row_len(cap: int) -> int:
    return 1 + 2 * cap


def _run_chunks(a, b, block_kv):
    """Chunks of run [a, b): its SUB-aligned base walks in block_kv steps."""
    base = (a // SUB) * SUB
    return -(-(b - base) // block_kv)


def run_meta(sel, starts, sizes, *, block_kv: int, cap: int):
    """Run-list metadata on sel's device (counterpart of run_meta_jnp).

    sel (R, NR, C) bool: per metadata row, the clusters it visits; starts
    (R, C): each cluster's first token in the cluster-sorted K/V (exclusive
    cumsum of sizes); sizes (R, C): cluster sizes (empty clusters allowed,
    and they break runs). Rows with more than `cap` runs keep the first
    `cap` (cap = C is always exact). Returns (R, NR, 1 + 2*cap) int32.
    """
    R, NR, C = sel.shape
    if block_kv % SUB:
        raise ValueError(f"block_kv={block_kv} must be a multiple of {SUB}")
    starts = starts.long()
    ends = starts + sizes.long()
    sel = sel & (sizes > 0)[:, None, :]
    no = torch.zeros_like(sel[..., :1])
    run_start = sel & ~torch.cat([no, sel[..., :-1]], dim=-1)
    run_end = sel & ~torch.cat([sel[..., 1:], no], dim=-1)
    origin = torch.where(run_start, starts[:, None, :], -1).cummax(dim=-1).values
    # run ends to the front, in cluster order (the keys are distinct)
    cap_eff = min(cap, C)
    iota = torch.arange(C, device=sel.device)
    key = torch.where(run_end, iota, C + iota)
    order = torch.argsort(key, dim=-1)[..., :cap_eff]
    is_run = key.gather(-1, order) < C
    a = torch.where(is_run, origin.gather(-1, order), 0)
    b = torch.where(is_run, ends[:, None, :].expand(R, NR, C).gather(-1, order), 0)
    n = torch.where(is_run, _run_chunks(a, b, block_kv), 0).sum(-1)
    entries = torch.stack([a, b], dim=-1).reshape(R, NR, 2 * cap_eff)
    if cap_eff < cap:
        entries = torch.nn.functional.pad(entries, (0, 2 * (cap - cap_eff)))
    return torch.cat([n[..., None], entries], dim=-1).to(torch.int32)


def run_meta_np(sel, starts, sizes, *, block_kv: int, cap: int | None = None):
    """Numpy oracle of run_meta (tests)."""
    sel = np.asarray(sel)
    starts = np.asarray(starts)
    sizes = np.asarray(sizes)
    R, NR, C = sel.shape
    rows = []
    max_runs = 0
    for r in range(R):
        for i in range(NR):
            runs = []
            c = 0
            while c < C:
                # zero-size clusters break runs (as in run_meta)
                if sel[r, i, c] and sizes[r, c] > 0:
                    a = int(starts[r, c])
                    b = int(starts[r, c] + sizes[r, c])
                    c += 1
                    while c < C and sel[r, i, c] and sizes[r, c] > 0:
                        b = int(starts[r, c] + sizes[r, c])
                        c += 1
                    runs.append((a, b))
                else:
                    c += 1
            rows.append(runs)
            max_runs = max(max_runs, len(runs))
    if cap is None:
        cap = max(max_runs, 1)
    meta = np.zeros((R, NR, run_meta_row_len(cap)), np.int32)
    it = iter(rows)
    for r in range(R):
        for i in range(NR):
            runs = next(it)[:cap]
            meta[r, i, 0] = sum(_run_chunks(a, b, block_kv) for a, b in runs)
            for e, (a, b) in enumerate(runs):
                meta[r, i, 1 + 2 * e] = a
                meta[r, i, 2 + 2 * e] = b
    return meta


def decode_run_meta(meta, *, seq_kv: int):
    """Run-list metadata -> per-row boolean token mask (R, NR, seq_kv) (tests only)."""
    meta = np.asarray(meta)
    R, NR, L = meta.shape
    out = np.zeros((R, NR, seq_kv), bool)
    for r in range(R):
        for i in range(NR):
            for e in range((L - 1) // 2):
                out[r, i, meta[r, i, 1 + 2 * e]:meta[r, i, 2 + 2 * e]] = True
    return out


SLAB_META_LEN = 5  # (n, a_0, b_0, a_1, b_1): at most the sink's run and the band's


def slab_geometry(frame_size: int, num_frames: int):
    """(n_s, P, n_slabs) of band_sink_perm's slabs: n_s = 128 // F slots of
    all F frames a slab, P = n_s * F of its 128 rows live, n_slabs =
    ceil(frame_size / n_s) slabs over the video (the last may run past slot
    frame_size - 1). Slab j holds the permuted positions [j * P, j * P + P),
    p = slot * F + frame."""
    if not 1 <= num_frames <= SUB:
        raise ValueError(f"a slab holds all frames of a slot: num_frames must be in [1, {SUB}], got {num_frames}")
    n_s = SUB // num_frames
    return n_s, n_s * num_frames, -(-frame_size // n_s)


def slab_meta_np(spec) -> np.ndarray:
    """(n_slabs, SLAB_META_LEN) int32 for a band_sink_perm MaskSpec: q slab
    j visits K/V slab i iff execution_mask_block's band + sink skeleton, on
    the permuted positions at slab granularity, holds: the gap between their
    p-intervals (clipped to the video's S = frame_size * num_frames) is below
    band_width, or slab i starts in the sink (p < sink_size). A row lists
    those slabs as runs [a, b) in ascending order."""
    _, P, n = slab_geometry(spec.frame_size, spec.num_frames)
    S = spec.frame_size * spec.num_frames
    lo = np.arange(n, dtype=np.int64) * P
    hi = np.minimum(lo + P, S) - 1
    gap = np.maximum(np.maximum(lo[None, :] - hi[:, None], lo[:, None] - hi[None, :]), 0)
    bm = (gap < spec.band_width) | (lo[None, :] < spec.sink_size)
    edges = np.diff(np.pad(bm.astype(np.int8), ((0, 0), (1, 1))), axis=1)
    out = np.zeros((n, SLAB_META_LEN), np.int32)
    for j in range(n):
        a, b = np.flatnonzero(edges[j] == 1), np.flatnonzero(edges[j] == -1)
        if len(a) > (SLAB_META_LEN - 1) // 2:
            raise AssertionError(f"slab {j}: {len(a)} runs; a band and a sink make at most 2")
        out[j, 0] = len(a)
        out[j, 1:1 + 2 * len(a)] = np.stack([a, b], 1).reshape(-1)
    return out


def slab_visits_np(spec, meta=None) -> np.ndarray:
    """(n_slabs,) int64: the K/V tokens each q slab's row of `meta`
    (slab_meta_np(spec) by default) visits (its slabs' live rows, the weight
    of its work item)."""
    _, P, n = slab_geometry(spec.frame_size, spec.num_frames)
    live = np.minimum(P, spec.frame_size * spec.num_frames - np.arange(n, dtype=np.int64) * P)
    meta = slab_meta_np(spec) if meta is None else meta
    return np.array([sum(int(live[a:b].sum()) for a, b in meta[j, 1:1 + 2 * meta[j, 0]].reshape(-1, 2))
                     for j in range(n)], np.int64)
