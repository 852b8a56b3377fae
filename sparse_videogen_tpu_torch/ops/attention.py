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
picking the head's (0 spatial, 1 temporal).
"""

from __future__ import annotations

import math

import torch

from sparse_videogen_tpu_torch import _kernels
from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec, apply_mask_spec
from sparse_videogen_tpu_torch.ops.metadata import ENTRY_SCALE, N_CHEAP_SCALE, SUB, _run_chunks

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


def work_order(meta, n_heads: int, seq_q: int, block_q: int):
    """The chunked-CSR kernel's work items (head h, 128-row q tile t), item
    h * (seq_q // BQ) + t, heaviest first: returns (order, weight), order
    an int32 permutation of the items by descending weight (ties in item
    order), weight (items,) int64 the tokens each item's metadata row
    visits (the sum of its chunks' hi - lo). Plain tensor ops on meta's
    device: no copy to the host."""
    _check_order_args(meta, n_heads, seq_q, block_q)
    m = meta.long()
    cap = (m.shape[2] - 1) // 2
    win = m[..., 2:2 + 2 * cap:2]
    live = torch.arange(cap, device=m.device) < (m[..., :1] % N_CHEAP_SCALE)
    per_block = ((win % ENTRY_SCALE - win // ENTRY_SCALE) * live).sum(-1)  # (R, nQ)
    return _order_items(m, n_heads, seq_q, block_q, per_block)


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
    key = (build.__name__, meta._version, n_heads, seq_q, block_q)
    cached = getattr(meta, "_svt_work_order", None)
    if cached is None or cached[0] != key:
        cached = (key, build(meta, n_heads, seq_q, block_q)[0])
        meta._svt_work_order = cached
    return cached[1]


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
    raise on anything else; CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return block_sparse_attention_kv_plain(q, k, v, meta, aux, block_q=block_q, block_kv=block_kv,
                                               mask_spec=mask_spec, scale=scale, return_stats=return_stats)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, meta, block_q, block_kv)
    BH, Sq, D = q.shape
    aux = _check_kernel_args(q, k, v, meta, aux, mask_spec, block_q)
    order = _cached_order(meta, BH, Sq, block_q)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    kind = mask_kind(mask_spec)
    spec = mask_spec[1] if isinstance(mask_spec, tuple) else mask_spec
    out = torch.empty_like(q)
    m, l, m_ptr, l_ptr = _stats_out(q, return_stats)
    err = _kernels.lib().svt_block_sparse_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), meta.data_ptr(), aux.data_ptr(), order.data_ptr(),
        BH, Sq, k.shape[1], D, meta.shape[0], meta.shape[1], meta.shape[2], block_q,
        _KERNEL_MASKS[kind], spec.band_width, spec.sink_size, spec.video_len, spec.frame_size, spec.num_frames,
        scale * LOG2E, m_ptr, l_ptr, torch.cuda.current_stream(q.device).cuda_stream,
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
