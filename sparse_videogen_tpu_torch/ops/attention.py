"""Block-sparse flash attention (counterpart of sparse_videogen_tpu/ops/attention.py).

Two metadata formats, one kernel each, sharing one Hopper CTA body
(csrc/hopper_attn.cuh: 128 q rows a CTA, a TMA ring of 128-token K/V
tiles, wgmma, warp-specialised; the mask predicates of csrc/mask_pred.cuh)
and running the (head, 128-row q tile) items heaviest first:
- chunked CSR (`block_sparse_attention_kv`, csrc/block_sparse_attn.cu):
  dense and SVG1 attention; only the metadata and the MaskSpec differ; its
  items ordered by `work_order`;
- run lists (`block_sparse_attention_runs`, csrc/runs_attn.cu): SAP's
  attention over unpadded cluster-sorted K/V (ops/metadata.py run_meta);
  its items ordered by `runs_work_order`, its chunks walked as
  `runs_tile_walk` models.
K and V arrive as separate (BH, Skv, D) tensors; the TPU's packed [K|V]
layout and its scheduling knobs (nbuf, unroll, qsplit, pair, expand,
fast_mask, mxu_lsum) have no counterpart here.

Each wrapper launches its Hopper kernel for CUDA tensors and its plain
version for CPU tensors; the `*_plain` functions are the plain versions
themselves, the kernels' oracles on the card.

`return_stats=True` (both formats) also returns each row's softmax stats
(m, l), (BH, Sq) f32 each, for the ring merge (parallel/ring.py,
parallel/ring_sap.py): m the running max of the scaled scores in natural-log
units, NEG_INF for a row that saw no live column, l the row sum of
exp(score - m). The chunked-CSR format also takes placement-free SVG1's dual
per-head spec: a pair (band_sink, band_sink_perm) of MaskSpecs, aux[4 + bh]
picking the head's (0 spatial, 1 temporal). On the card a temporal head
runs in slot slabs on permuted positions (ops/metadata.py slab_meta_np; its
items ordered by `dual_work_order`, its walk modelled by `slab_tile_walk`),
so its metadata rows feed only the plain version: the kernel attends every
pair band_sink_perm allows among the video's tokens, and the wrapper
refuses rows under which the plain version would not (`dual_meta_faults`;
SVG1's dual metadata, sparse/svg1.py sparse_meta_dual, passes).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from sparse_videogen_tpu_torch import _kernels
from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec, apply_mask_spec
from sparse_videogen_tpu_torch.ops.metadata import (ENTRY_SCALE, N_CHEAP_SCALE, SUB, _run_chunks, slab_geometry,
                                                     slab_meta_np, slab_visits_np)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
LOG2E = 1.4426950408889634
BQ = 128  # q rows per CTA of both kernels; divides every block_q they accept
# mask kinds each Hopper kernel evaluates, as the kernels number them
# (csrc/mask_pred.cuh: KIND_BAND_SINK, KIND_HYVIDEO, KIND_COG,
# KIND_BAND_SINK_PERM; 0 runs no predicate). band_sink_perm stands for the
# dual pair, whose kernel runs band_sink or band_sink_perm by aux[4 + bh].
_KERNEL_MASKS = {"none": 0, "band_sink": 1, "hyvideo": 2, "cog": 3, "band_sink_perm": 4}
_RUNS_KERNEL_MASKS = ("none", "band_sink")


def _check(q, k, v, meta, block_q, block_kv, *, packed_windows=True):
    BH, Sq, D = q.shape
    if k.shape != v.shape or k.shape[0] != BH or k.shape[2] != D:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    Skv = k.shape[1]
    if (Sq % block_q or Skv % SUB or Skv < block_kv or block_kv % SUB
            or (packed_windows and block_kv >= ENTRY_SCALE)):
        raise ValueError(f"Sq={Sq} block_q={block_q} Skv={Skv} block_kv={block_kv}")
    if meta.dim() != 3 or meta.shape[1] != Sq // block_q or meta.shape[0] not in (1, BH):
        raise ValueError(f"meta {tuple(meta.shape)} for BH={BH}, nQ={Sq // block_q}")


def mask_kind(mask_spec) -> str:
    """The kind a MaskSpec, or a dual (spatial, temporal) pair, runs as:
    a pair runs as band_sink_perm (the kernel's dual instance)."""
    return "band_sink_perm" if isinstance(mask_spec, tuple) else mask_spec.kind


def _dual_spec(pair):
    """A dual (spatial band_sink, temporal band_sink_perm) pair, checked: the
    kernel takes one band width and sink size for both."""
    sp, tp = pair
    if (sp.kind, tp.kind) != ("band_sink", "band_sink_perm") or (sp.band_width, sp.sink_size) != (
            tp.band_width, tp.sink_size):
        raise ValueError(f"dual spec needs (band_sink, band_sink_perm) with one band and sink: {pair}")
    return sp, tp


def _check_kernel_args(q, k, v, meta, aux, mask_spec, block_q, kinds=tuple(_KERNEL_MASKS)):
    """What the Hopper kernels take; returns aux on the device ((4 + BH,)
    with a dual spec)."""
    D = q.shape[2]
    if isinstance(mask_spec, tuple):
        if "band_sink_perm" not in kinds:
            raise NotImplementedError("the run-list kernel takes no dual spec")
        mask_spec = _dual_spec(mask_spec)[1]
        if mask_spec.frame_size <= 8:
            raise ValueError(f"the band_sink_perm kernel takes frame_size > 8, got {mask_spec.frame_size}")
        slab_geometry(mask_spec.frame_size, mask_spec.num_frames)  # num_frames <= 128
        video = mask_spec.frame_size * mask_spec.num_frames
        if video > min(q.shape[1], k.shape[1]):
            raise ValueError(f"the dual kernel's q and k/v hold the video's {video} tokens: Sq={q.shape[1]}, "
                             f"Skv={k.shape[1]}")
        if aux is None or aux.numel() < 4 + q.shape[0]:
            raise ValueError(f"a dual spec needs aux of 4 + BH = {4 + q.shape[0]} entries")
    elif mask_spec.kind == "band_sink_perm":
        raise NotImplementedError("band_sink_perm runs in the kernel as the dual pair (band_sink, band_sink_perm)")
    if mask_spec.kind not in kinds:
        raise NotImplementedError(f"mask kind {mask_spec.kind!r} has no Hopper kernel yet (ROADMAP.md)")
    if D not in (64, 128) or block_q % BQ:
        raise ValueError(f"kernel takes D in (64, 128) and block_q % {BQ} == 0; got D={D}, block_q={block_q}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"{name}: need contiguous 16-byte aligned bf16 on {q.device}, got {t.dtype} on "
                             f"{t.device}")
    aux = torch.zeros(4, dtype=torch.int32, device=q.device) if aux is None else aux
    for name, t in (("meta", meta), ("aux", aux)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name}: need contiguous int32 on {q.device}, got {t.dtype} on {t.device}")
    if aux.numel() < 4:
        raise ValueError(f"aux needs 4 entries, got {aux.numel()}")
    return aux


def _predicate(mask_spec, qpos, kpos, aux_h, heads):
    """apply_mask_spec for the plain versions; a dual spec selects each
    head's (the slice `heads` of the batch*head axis) by aux[4 + bh]."""
    if not isinstance(mask_spec, tuple):
        return apply_mask_spec(mask_spec, qpos, kpos, aux_h)
    sp, tp = _dual_spec(mask_spec)
    flags = torch.tensor(aux_h[4:], device=qpos.device)[heads][:, None, None]
    return torch.where(flags == 1, apply_mask_spec(tp, qpos, kpos, aux_h), apply_mask_spec(sp, qpos, kpos, aux_h))


def _stats(m, l):
    """The kernels' (m, l) from the online softmax state of a q block: m in
    natural-log units where a column was live, the NEG_INF sentinel kept."""
    return torch.where(m > 0.5 * NEG_INF, m / LOG2E, m)[..., 0], l[..., 0]


def _online_softmax_step(state, s, vb):
    """One chunk of the kernels' online softmax (exp2 domain, P rounded to
    v's dtype for PV, the row sum from the f32 P); s holds NEG_INF where a
    column is not live."""
    acc, m, l = state
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    alpha = torch.exp2(m - m_new)
    m_safe = torch.where(m_new > 0.5 * NEG_INF, m_new, 0.0)
    p = torch.exp2(s - m_safe)
    l = l * alpha + p.sum(-1, keepdim=True)
    acc = acc * alpha + p.to(vb.dtype).float() @ vb.float()
    return acc, m_new, l


def block_sparse_attention_kv_plain(q, k, v, meta, aux=None, *, block_q: int, block_kv: int,
                                    mask_spec: MaskSpec = MaskSpec(), scale: float | None = None,
                                    return_stats: bool = False):
    """Plain PyTorch version: a loop over q blocks that walks each metadata
    row's chunks with the kernel's online softmax (no S x S matrix).
    Returns out, or (out, m, l) with return_stats."""
    _check(q, k, v, meta, block_q, block_kv)
    _kernels.plain_call("block_sparse_attn")
    BH, Sq, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    meta_h = meta.cpu().numpy()
    aux_h = None if aux is None else [int(a) for a in torch.as_tensor(aux).cpu()]
    R = meta_h.shape[0]
    q_s = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    out = torch.empty_like(q)
    m_all = torch.empty(BH, Sq, device=q.device)
    l_all = torch.empty(BH, Sq, device=q.device)
    col = torch.arange(block_kv, device=q.device)
    for r in range(R):
        heads = slice(None) if R == 1 else slice(r, r + 1)
        for i in range(Sq // block_q):
            qb = q_s[heads, i * block_q:(i + 1) * block_q]
            acc = torch.zeros_like(qb)
            m = torch.full(qb.shape[:-1] + (1,), NEG_INF, device=q.device)
            l = torch.zeros_like(m)
            qpos = (i * block_q + torch.arange(block_q, device=q.device))[:, None]
            e0 = int(meta_h[r, i, 0])
            n, n_cheap = e0 % N_CHEAP_SCALE, e0 // N_CHEAP_SCALE
            for c in range(n):
                idx, win = int(meta_h[r, i, 1 + 2 * c]), int(meta_h[r, i, 2 + 2 * c])
                lo, hi = win // ENTRY_SCALE, win % ENTRY_SCALE
                kb = k[heads, idx * SUB: idx * SUB + block_kv].float()
                vb = v[heads, idx * SUB: idx * SUB + block_kv]
                s = qb @ kb.transpose(-1, -2)
                allowed = ((col >= lo) & (col < hi))[None, :]
                if c >= n_cheap:
                    pred = _predicate(mask_spec, qpos, idx * SUB + col[None, :], aux_h, heads)
                    if pred is not None:
                        allowed = allowed & pred
                s = torch.where(allowed, s, NEG_INF)
                acc, m, l = _online_softmax_step((acc, m, l), s, vb)
            rows = slice(i * block_q, (i + 1) * block_q)
            out[heads, rows] = (acc / l.clamp_min(1e-20)).to(q.dtype)
            m_all[heads, rows], l_all[heads, rows] = _stats(m, l)
    return (out, m_all, l_all) if return_stats else out


def _order_items(meta, n_heads, seq_q, block_q, per_block):
    """(order, weight) of the work items (head h, 128-row q tile t), item
    h * (seq_q // BQ) + t, from per_block (R, nQ), the tokens each metadata
    row visits."""
    tiles = torch.arange(seq_q // BQ, device=meta.device) * BQ // block_q
    weight = per_block[:, tiles].expand(n_heads, -1).reshape(-1)
    order = torch.sort(-weight, stable=True).indices.to(torch.int32)
    return order, weight


def _check_order_args(meta, n_heads, seq_q, block_q):
    if block_q % BQ or seq_q % block_q or meta.shape[1] != seq_q // block_q or meta.shape[0] not in (1, n_heads):
        raise ValueError(f"meta {tuple(meta.shape)} for {n_heads} heads, seq_q {seq_q}, block_q {block_q}")


def _csr_visits(meta):
    """(R, nQ) int64: the tokens each chunked-CSR row visits (the sum of its
    chunks' hi - lo)."""
    m = meta.long()
    cap = (m.shape[2] - 1) // 2
    win = m[..., 2:2 + 2 * cap:2]
    live = torch.arange(cap, device=m.device) < (m[..., :1] % N_CHEAP_SCALE)
    return ((win % ENTRY_SCALE - win // ENTRY_SCALE) * live).sum(-1)


def csr_tile_stats(meta):
    """(live tokens, loaded 128-token tiles) per chunked-CSR row, (R, nQ)
    int64 each: a chunk with live columns [lo, hi) loads the tiles from
    floor128(lo) to ceil128(hi) of its span (csrc/hopper_attn.cuh's walk).
    Plain tensor ops on meta's device."""
    m = meta.long()
    cap = (m.shape[2] - 1) // 2
    win = m[..., 2:2 + 2 * cap:2]
    lo, hi = win // ENTRY_SCALE, win % ENTRY_SCALE
    live = torch.arange(cap, device=m.device) < (m[..., :1] % N_CHEAP_SCALE)
    tiles = torch.where(live & (hi > lo), -(-hi // SUB) - lo // SUB, 0)
    return ((hi - lo) * live).sum(-1), tiles.sum(-1)


def work_order(meta, n_heads: int, seq_q: int, block_q: int):
    """The chunked-CSR kernel's work items (head h, 128-row q tile t), item
    h * (seq_q // BQ) + t, heaviest first: returns (order, weight), order
    an int32 permutation of the items by descending weight (ties in item
    order), weight (items,) int64 the tokens each item's metadata row
    visits (the sum of its chunks' hi - lo). Plain tensor ops on meta's
    device: no copy to the host."""
    _check_order_args(meta, n_heads, seq_q, block_q)
    return _order_items(meta, n_heads, seq_q, block_q, _csr_visits(meta))


def dual_work_order(meta, flags, spec, n_heads: int, seq_q: int, block_q: int):
    """The dual kernel's work items, item h * n_items + t: a spatial head's
    (flags[h] == 0) 128-row q tiles t < seq_q // BQ weighted as work_order
    does, a temporal head's (1) q slabs t < n_slabs (slab_geometry of the
    band_sink_perm `spec`) weighted by the tokens their slab rows visit,
    n_items = max(seq_q // BQ, n_slabs). Returns (order, n_items): order an
    int32 permutation of all n_heads * n_items items by descending weight
    (ties in item order), the items past a head's count (weight -1) last;
    the kernel skips them. Plain tensor ops on meta's device."""
    _check_order_args(meta, n_heads, seq_q, block_q)
    n_t = seq_q // BQ
    visits = _slab_state(spec, str(meta.device))[2]
    n_items = max(n_t, len(visits))
    tiles = torch.arange(n_t, device=meta.device) * BQ // block_q
    spatial = torch.nn.functional.pad(_csr_visits(meta)[:, tiles].expand(n_heads, -1), (0, n_items - n_t), value=-1)
    temporal = torch.nn.functional.pad(visits, (0, n_items - len(visits)), value=-1)
    weight = torch.where(flags.reshape(-1, 1) == 1, temporal[None], spatial)
    return torch.sort(-weight.reshape(-1), stable=True).indices.to(torch.int32), n_items


@functools.lru_cache(maxsize=8)
def _slab_state(spec, device: str):
    """(slab_meta_np(spec), and on `device` the slab metadata and
    slab_visits_np), made once per (spec, device): a copy from the host at
    every call would wait for the device."""
    meta = slab_meta_np(spec)
    return meta, torch.as_tensor(meta, device=device), torch.as_tensor(slab_visits_np(spec, meta), device=device)


@functools.lru_cache(maxsize=8)
def _dual_cover(spec, block_q: int, n_q: int, device: str):
    """What a temporal head's chunked-CSR rows must hold for the plain
    version to attend the pairs the dual kernel does, for q block i < n_q of
    block_q rows of a band_sink_perm `spec` (S = frame_size * num_frames):
    (need, full, real) on `device`. need and full are (n_q, S + 1) int32
    prefix sums over the K/V tokens of the columns that some real q row of
    the block may attend (need) and that all of them may (full); real (n_q,)
    bool marks the blocks holding a q row of the video."""
    fs, F, w = spec.frame_size, spec.num_frames, spec.band_width
    S = fs * F
    pk = (np.arange(S) % fs) * F + np.arange(S) // fs
    sink = pk < spec.sink_size
    need = np.zeros((n_q, S + 1), np.int32)
    full = np.zeros((n_q, S + 1), np.int32)
    real = np.zeros(n_q, bool)
    for i in range(min(n_q, -(-S // block_q))):
        x = np.arange(i * block_q, min((i + 1) * block_q, S))
        pq = np.sort((x % fs) * F + x // fs)
        at = np.searchsorted(pq, pk)
        near = np.minimum(np.abs(pk - pq[np.maximum(at - 1, 0)]), np.abs(pq[np.minimum(at, len(pq) - 1)] - pk))
        need[i, 1:] = np.cumsum(sink | (near < w))
        full[i, 1:] = np.cumsum(sink | ((pk - pq[0] < w) & (pq[-1] - pk < w)))
        real[i] = True
    return tuple(torch.as_tensor(a, device=device) for a in (need, full, real))


def dual_meta_faults(meta, flags, spec, block_q: int):
    """(len(flags),) bool: the temporal heads (flags[h] == 1) whose chunked-
    CSR rows in `meta` (R, nQ, L) would make the plain version attend other
    pairs than the dual kernel, which reads a temporal head's band_sink_perm
    from its slab metadata: every pair the `spec` allows among the video's S
    tokens. For each q block that holds a q row of the video, a temporal
    head's row must visit no K/V token past the video, in windows that do
    not overlap, covering every token some real q row of the block may
    attend; its first n_cheap (unmasked) windows may hold only tokens that
    all of them may. SVG1's dual metadata (sparse_meta_dual) is such. Plain
    tensor ops on meta's device."""
    need, full, real = _dual_cover(spec, block_q, meta.shape[1], str(meta.device))
    S = spec.frame_size * spec.num_frames
    m = meta.long()
    cap = (m.shape[2] - 1) // 2
    chunk = torch.arange(cap, device=m.device)
    live = chunk < m[..., :1] % N_CHEAP_SCALE
    cheap = live & (chunk < m[..., :1] // N_CHEAP_SCALE)
    start, win = m[..., 1:1 + 2 * cap:2] * SUB, m[..., 2:2 + 2 * cap:2]
    a, b = start + win // ENTRY_SCALE, start + win % ENTRY_SCALE
    i = torch.arange(m.shape[1], device=m.device)[:, None]
    ac, bc = a.clamp(0, S), b.clamp(0, S)
    bad = ((b > S) | (b < a)).logical_and(live).any(-1)
    bad |= (cheap & (full[i, bc] - full[i, ac] != b - a)).any(-1)
    bad |= ((need[i, bc] - need[i, ac]) * live).sum(-1) != need[:, S]
    first = torch.where(live, a, S + 1).sort(-1)
    ends = b.gather(-1, first.indices)
    bad |= (first.values[..., 1:] < ends[..., :-1]).logical_and(live[..., 1:]).any(-1)
    rows = (bad & real).any(-1)
    return (flags == 1) & (rows if rows.numel() > 1 else rows.expand(len(flags)))


def _band_sink_tile(spec, qlo, qhi, klo, khi) -> int:
    """csrc/mask_pred.cuh mask_tile<KIND_BAND_SINK> over [qlo, qhi] x [klo,
    khi]: 2 (TILE_ALL), 0 (TILE_NONE) or 1 (TILE_SOME)."""
    bw, sink = spec.band_width, spec.sink_size
    if (qhi - klo < bw and khi - qlo < bw) or khi < sink:
        return 2
    if (klo - qhi >= bw or qlo - khi >= bw) and klo >= sink:
        return 0
    return 1


def slab_tile_walk(spec, slab_q: int):
    """A model of the dual kernel's walk over a temporal head's q slab
    `slab_q` (csrc/block_sparse_attn.cu SlabChunks, then the MODE_SLAB tile
    loop of csrc/hopper_attn.cuh) for a band_sink_perm `spec`: one (slab,
    hi, (cls_0, cls_1)) per K/V slab loaded, in the kernel's order, with its
    live rows [0, hi) (permuted positions slab * P + [0, hi)) and each
    consumer warpgroup's class of the pair (rows [slab_q * P + 64 wg, + 64)):
    2 TILE_ALL (the window alone), 1 TILE_SOME (the predicate per pair), 0
    TILE_NONE (skipped); a slab of fewer than 64 live rows is never TILE_ALL."""
    _, P, _ = slab_geometry(spec.frame_size, spec.num_frames)
    S = spec.frame_size * spec.num_frames
    row = _slab_state(spec, "cpu")[0][slab_q]
    tiles = []
    for a, b in row[1:1 + 2 * row[0]].reshape(-1, 2):
        for slab in range(int(a), int(b)):
            hi = min(P, S - slab * P)
            q0 = slab_q * P
            cls = tuple(_band_sink_tile(spec, q0 + 64 * wg, q0 + 64 * wg + 63, slab * P, slab * P + hi - 1)
                        for wg in (0, 1))
            tiles.append((slab, hi, tuple(1 if (c == 2 and hi < 64) else c for c in cls)))
    return tiles


def slab_tile_stats(spec) -> dict:
    """What slab_tile_walk counts over one temporal head: K/V slabs loaded,
    and the (warpgroup, slab) pairs of each class."""
    _, _, n = slab_geometry(spec.frame_size, spec.num_frames)
    st = {"loaded": 0, "TILE_ALL": 0, "TILE_SOME": 0, "TILE_NONE": 0}
    for j in range(n):
        for _, _, cls in slab_tile_walk(spec, j):
            st["loaded"] += 1
            for c in cls:
                st[("TILE_NONE", "TILE_SOME", "TILE_ALL")[c]] += 1
    return st


def runs_work_order(meta, n_heads: int, seq_q: int, block_q: int):
    """work_order for the run-list kernel: each item's weight is the tokens
    its run-list row visits, the sum of b - a over its entries (unused
    entries are (0, 0)), or 0 where the row's chunk count n is 0 (SAP's q
    blocks without a token keep their runs but n = 0). Plain tensor ops on
    meta's device."""
    _check_order_args(meta, n_heads, seq_q, block_q)
    live, _ = runs_tile_stats(meta)
    return _order_items(meta, n_heads, seq_q, block_q, live)


def _cached_order(meta, n_heads: int, seq_q: int, block_q: int, build=work_order):
    """build(...)'s order, made once per metadata tensor (and again if it is
    written in place): the runtimes hold theirs for the whole run, SAP's
    metadata is new at every layer."""
    return _meta_cached(meta, (build.__name__, n_heads, seq_q, block_q),
                        lambda: build(meta, n_heads, seq_q, block_q)[0])


def _meta_cached(t, key, make):
    """make()'s result, kept on tensor `t` under `key` and t's version."""
    key = (t._version,) + key
    cached = getattr(t, "_svt_cached", None)
    if cached is None or cached[0] != key:
        cached = (key, make())
        t._svt_cached = cached
    return cached[1]


def _refuse(faults, offsets, who: str = "temporal heads") -> None:
    """Raise if a temporal head's rows were flagged (faults, bool per head
    or row) or the offsets aux[2:4] (int) are not 0: one wait for the
    device."""
    bad = offsets.ne(0).any()
    if faults is not None:
        bad = bad | faults.any()
    if bool(bad.item()):
        if offsets.ne(0).any():
            raise ValueError(f"the dual kernel takes no global offsets: aux[2:4] = {offsets.tolist()}")
        raise ValueError(f"{who} {faults.nonzero()[:, 0].tolist()}: their metadata rows do not cover "
                         f"exactly the pairs band_sink_perm allows among the video's tokens, which the dual "
                         f"kernel attends (ops/attention.py dual_meta_faults)")


def _dual_key(aux, n_heads: int, seq_q: int, block_q: int, spec):
    return ("dual", n_heads, seq_q, block_q, spec, id(aux), aux._version)


def _dual_order(meta, aux, spec, n_heads: int, seq_q: int, block_q: int):
    """dual_work_order's (order, n_items), once per metadata tensor and aux
    tensor (kept with it, so that its id stays its own) and their versions,
    after a check that costs one wait for the device: aux[2:4] must be 0
    and no temporal head may have rows that dual_meta_faults rejects."""
    def make():
        flags = aux[4:4 + n_heads]
        _refuse(dual_meta_faults(meta, flags, spec, block_q), aux[2:4])
        return dual_work_order(meta, flags, spec, n_heads, seq_q, block_q), aux

    return _meta_cached(meta, _dual_key(aux, n_heads, seq_q, block_q, spec), make)[0]


def dual_rows(stack, flags, spec, block_q: int, aux=None):
    """(meta, aux) for block_sparse_attention_kv with the dual pair from a
    (2, nQ, L) class stack (SVG1's sparse_meta_dual) and the heads' classes
    `flags` (BH,) int32: head h takes row stack[flags[h]], aux is aux[:4]
    (zeros if None) with the flags appended. The stack's temporal rows and
    aux's offsets are checked once per tensor, as the wrapper checks them,
    and the pair comes out with its work order made, so that new flags at
    every layer cost no wait for the device. `spec` is the pair's
    band_sink_perm MaskSpec."""
    aux4 = torch.zeros(4, dtype=torch.int32, device=stack.device) if aux is None else \
        torch.as_tensor(aux, dtype=torch.int32, device=stack.device)[:4]
    meta = torch.where(flags[:, None, None] == 1, stack[1][None], stack[0][None]).contiguous()
    aux_bh = torch.cat([aux4, flags])
    ones = torch.ones(1, dtype=torch.int32, device=stack.device)
    _meta_cached(stack, ("dual_stack", spec, block_q),
                 lambda: _refuse(dual_meta_faults(stack[1:], ones, spec, block_q), aux4.new_zeros(2),
                                 who="the class stack's temporal rows"))
    if aux is not None:
        _meta_cached(aux, ("dual_offsets",), lambda: _refuse(None, aux4[2:4]))
    n_heads, seq_q = len(flags), stack.shape[1] * block_q
    _meta_cached(meta, _dual_key(aux_bh, n_heads, seq_q, block_q, spec),
                 lambda: (dual_work_order(meta, flags, spec, n_heads, seq_q, block_q), aux_bh))
    return meta, aux_bh


def _stats_out(q, return_stats):
    """(m, l) outputs of a stats launch and their pointers (null without)."""
    if not return_stats:
        return None, None, None, None
    m = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    return m, l, m.data_ptr(), l.data_ptr()


def block_sparse_attention_kv(q, k, v, meta, aux=None, *, block_q: int = 512, block_kv: int = 512,
                              mask_spec: MaskSpec = MaskSpec(), scale: float | None = None,
                              return_stats: bool = False):
    """q (BH, Sq, D) with Sq % block_q == 0; k, v (BH, Skv, D) with
    Skv % 128 == 0; meta (R, Sq // block_q, 1 + 2*cap) int32, R in {1, BH};
    aux (4,) int32 or None ((4 + BH,) with a dual spec). mask_spec: a
    MaskSpec or a dual (band_sink, band_sink_perm) pair. Returns (BH, Sq, D)
    in q's dtype, or (out, m, l) with return_stats.

    CUDA tensors launch the Hopper kernel (bf16, D in {64, 128}, block_q %
    128 == 0, mask kinds none/band_sink/hyvideo/cog and the dual pair) and
    raise on anything else; CPU tensors run the plain version. With the
    dual pair the kernel takes num_frames <= 128 and the video's
    frame_size * num_frames tokens at the front of q and k/v and no offsets
    (aux[2:4] == 0), reads a temporal head's band_sink_perm from its slab
    metadata, refuses a temporal head whose `meta` rows would make the plain
    version attend other pairs (dual_meta_faults: checked once per meta and
    aux tensor, with one wait for the device) and writes its q rows past the
    video as 0 (m = NEG_INF, l = 0)."""
    if q.device.type == "cpu":
        return block_sparse_attention_kv_plain(q, k, v, meta, aux, block_q=block_q, block_kv=block_kv,
                                               mask_spec=mask_spec, scale=scale, return_stats=return_stats)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, meta, block_q, block_kv)
    BH, Sq, D = q.shape
    aux = _check_kernel_args(q, k, v, meta, aux, mask_spec, block_q)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    kind = mask_kind(mask_spec)
    spec = mask_spec[1] if isinstance(mask_spec, tuple) else mask_spec
    if kind == "band_sink_perm":
        order, n_items = _dual_order(meta, aux, spec, BH, Sq, block_q)
        slab_ptr = _slab_state(spec, str(q.device))[1].data_ptr()
    else:
        order, n_items, slab_ptr = _cached_order(meta, BH, Sq, block_q), Sq // BQ, None
    out = torch.empty_like(q)
    m, l, m_ptr, l_ptr = _stats_out(q, return_stats)
    err = _kernels.lib().svt_block_sparse_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), meta.data_ptr(), slab_ptr, aux.data_ptr(),
        order.data_ptr(), BH, Sq, k.shape[1], D, meta.shape[0], meta.shape[1], meta.shape[2], block_q,
        _KERNEL_MASKS[kind], spec.band_width, spec.sink_size, spec.video_len, spec.frame_size, spec.num_frames,
        n_items, scale * LOG2E, m_ptr, l_ptr, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _kernels.check(err, "block_sparse_attn")
    _kernels.launched("block_sparse_attn", f"block_sparse_attn[{kind}]",
                      *(("block_sparse_attn[stats]",) if return_stats else ()))
    return (out, m, l) if return_stats else out


def run_chunks(meta_row, block_kv: int):
    """The chunks of one run-list metadata row, as (first token, last token
    + 1) pairs, in the kernel's order: full chunks (all block_kv tokens live)
    first, then edge chunks, each in walk order. Chunk k of run [a, b) covers
    [max(a, base + k*block_kv), min(b, base + (k+1)*block_kv)), base =
    floor128(a); the row's count n stops the walk (ops/metadata.py)."""
    n = int(meta_row[0])
    cap = (len(meta_row) - 1) // 2
    full, edge = [], []
    for e in range(cap):
        if len(full) + len(edge) >= n:
            break
        a, b = int(meta_row[1 + 2 * e]), int(meta_row[2 + 2 * e])
        base = (a // SUB) * SUB
        for kc in range(_run_chunks(a, b, block_kv)):
            if len(full) + len(edge) >= n:
                break
            s0 = base + kc * block_kv
            lo, hi = max(a, s0), min(b, s0 + block_kv)
            (full if (lo, hi) == (s0, s0 + block_kv) else edge).append((lo, hi))
    return full + edge


def runs_tile_walk(meta_row, block_kv: int):
    """A model of the run-list kernel's walk over one metadata row
    (csrc/runs_attn.cu RunChunks, then the tile loop of csrc/hopper_attn.cuh):
    two passes over the runs, full chunks then edge chunks, stopping after
    the row's n chunks; chunk k of run [a, b) starts at s0 = floor128(a) +
    k * block_kv with live columns [lo, hi) relative to s0, and is loaded in
    128-token tiles from s0 + (lo & ~127) while below s0 + hi. Returns one
    (tile start, first live token, last live token + 1) per loaded tile, in
    the order the kernel loads them, as token positions in the permuted K/V."""
    n = int(meta_row[0])
    cap = (len(meta_row) - 1) // 2
    tiles = []
    for full_pass in (True, False):
        c = 0
        for e in range(cap):
            if c >= n:
                break
            a, b = int(meta_row[1 + 2 * e]), int(meta_row[2 + 2 * e])
            base = a & ~(SUB - 1)
            for kc in range(-(-(b - base) // block_kv)):
                if c >= n:
                    break
                c += 1
                s0 = base + kc * block_kv
                lo, hi = max(a - s0, 0), min(b - s0, block_kv)
                if (lo == 0 and hi == block_kv) != full_pass:
                    continue
                for t0 in range(lo & ~(SUB - 1), hi, SUB):
                    tiles.append((s0 + t0, s0 + max(t0, lo), s0 + min(t0 + SUB, hi)))
    return tiles


def runs_tile_stats(meta):
    """(live tokens, loaded 128-token tiles) per run-list metadata row, (R,
    nQ) int64 each, as runs_tile_walk counts them when n is 0 or the chunk
    count of every listed run (run_meta's, SAP's): a run [a, b) loads the
    tiles from floor128(a) to ceil128(b) once each. Plain tensor ops on
    meta's device."""
    m = meta.long()
    cap = (m.shape[2] - 1) // 2
    a, b = m[..., 1:1 + 2 * cap:2], m[..., 2:2 + 2 * cap:2]
    walked = m[..., 0] > 0
    tiles = torch.where(b > a, -(-b // SUB) - a // SUB, 0)
    return (b - a).sum(-1) * walked, tiles.sum(-1) * walked


def block_sparse_attention_runs_plain(q, k, v, meta, aux=None, *, block_q: int, block_kv: int,
                                      mask_spec: MaskSpec = MaskSpec(), scale: float | None = None,
                                      return_stats: bool = False):
    """Plain PyTorch version of the run-list attention: a loop over q blocks
    that walks each row's chunks (run_chunks) with the kernel's online
    softmax; with a MaskSpec every chunk also applies its predicate.
    Returns out, or (out, m, l) with return_stats."""
    _check(q, k, v, meta, block_q, block_kv, packed_windows=False)
    _kernels.plain_call("block_sparse_attn_runs")
    BH, Sq, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    meta_h = meta.cpu().numpy()
    aux_h = None if aux is None else [int(a) for a in torch.as_tensor(aux).cpu()]
    R = meta_h.shape[0]
    q_s = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    out = torch.empty_like(q)
    m_all = torch.empty(BH, Sq, device=q.device)
    l_all = torch.empty(BH, Sq, device=q.device)
    for r in range(R):
        heads = slice(None) if R == 1 else slice(r, r + 1)
        for i in range(Sq // block_q):
            qb = q_s[heads, i * block_q:(i + 1) * block_q]
            state = (torch.zeros_like(qb), torch.full(qb.shape[:-1] + (1,), NEG_INF, device=q.device),
                     torch.zeros(qb.shape[:-1] + (1,), device=q.device))
            qpos = (i * block_q + torch.arange(block_q, device=q.device))[:, None]
            for lo, hi in run_chunks(meta_h[r, i], block_kv):
                s = qb @ k[heads, lo:hi].float().transpose(-1, -2)
                pred = apply_mask_spec(mask_spec, qpos, torch.arange(lo, hi, device=q.device)[None, :], aux_h)
                if pred is not None:
                    s = torch.where(pred, s, NEG_INF)
                state = _online_softmax_step(state, s, v[heads, lo:hi])
            acc, m, l = state
            rows = slice(i * block_q, (i + 1) * block_q)
            out[heads, rows] = (acc / l.clamp_min(1e-20)).to(q.dtype)
            m_all[heads, rows], l_all[heads, rows] = _stats(m, l)
    return (out, m_all, l_all) if return_stats else out


def block_sparse_attention_runs(q, k, v, meta, aux=None, *, block_q: int, block_kv: int,
                                mask_spec: MaskSpec = MaskSpec(), scale: float | None = None,
                                return_stats: bool = False):
    """q (BH, Sq, D) with Sq % block_q == 0; k, v (BH, Skv, D) with
    Skv % 128 == 0 and Skv >= block_kv, block_kv % 128 == 0; meta (R,
    Sq // block_q, 1 + 2*cap) int32 run lists, R in {1, BH}; aux (4,) int32
    or None. Returns (BH, Sq, D) in q's dtype, a row with n == 0 is 0; or
    (out, m, l) with return_stats.

    CUDA tensors launch the Hopper kernel (bf16, D in {64, 128}, block_q %
    128 == 0, mask kinds none/band_sink) and raise on anything else; CPU
    tensors run the plain version."""
    if q.device.type == "cpu":
        return block_sparse_attention_runs_plain(q, k, v, meta, aux, block_q=block_q, block_kv=block_kv,
                                                 mask_spec=mask_spec, scale=scale, return_stats=return_stats)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, meta, block_q, block_kv, packed_windows=False)
    BH, Sq, D = q.shape
    aux = _check_kernel_args(q, k, v, meta, aux, mask_spec, block_q, _RUNS_KERNEL_MASKS)
    order = _cached_order(meta, BH, Sq, block_q, runs_work_order)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty_like(q)
    m, l, m_ptr, l_ptr = _stats_out(q, return_stats)
    err = _kernels.lib().svt_block_sparse_attn_runs(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), meta.data_ptr(), aux.data_ptr(), order.data_ptr(),
        BH, Sq, k.shape[1], D, meta.shape[0], meta.shape[1], meta.shape[2], block_q, block_kv,
        _KERNEL_MASKS[mask_spec.kind], mask_spec.band_width, mask_spec.sink_size,
        scale * LOG2E, m_ptr, l_ptr, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _kernels.check(err, "block_sparse_attn_runs")
    _kernels.launched("block_sparse_attn_runs", *(("block_sparse_attn_runs[stats]",) if return_stats else ()))
    return (out, m, l) if return_stats else out
