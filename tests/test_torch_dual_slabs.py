"""The dual kernel's slab walk for placement-free SVG1's temporal heads, on
the CPU: the slab metadata (ops/metadata.py slab_meta_np), its tile classes
(ops/attention.py slab_tile_walk, the model of csrc/hopper_attn.cuh's
MODE_SLAB loop), the work order of both head classes, and attention computed
along the modelled walk against the plain dual attention.

A slab is n_s = 128 // F slots x all F frames; the layouts cover F = 21 (n_s
= 6, 126 of 128 rows) with frame_size a multiple of n_s and not, and F = 16,
which divides 128. Attention runs in f32, where the walk and the plain
version differ by summation order only: atol 1e-5 on outputs of size ~1.
"""

import numpy as np
import pytest
import torch

from sparse_videogen_tpu_torch.config import SVGConfig, VideoLayout
from sparse_videogen_tpu_torch.ops import metadata as MD
from sparse_videogen_tpu_torch.ops.attention import (LOG2E, NEG_INF, _check_kernel_args, _online_softmax_step,
                                                     block_sparse_attention_kv_plain, dual_meta_faults,
                                                     dual_work_order, slab_tile_stats, slab_tile_walk)
from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec, apply_mask_spec
from sparse_videogen_tpu_torch.sparse.svg1 import make_svg1_plan

# (num_frames, frame_size): F = 21 with fs % 6 == 2 and == 0; F = 16 (P = 128)
LAYOUTS = [(21, 20), (21, 18), (16, 24)]


def _spec(F, fs, band_width, sink=None):
    return MaskSpec(kind="band_sink_perm", band_width=band_width, sink_size=fs if sink is None else sink,
                    frame_size=fs, num_frames=F)


def _perm(x, F, fs):
    return (x % fs) * F + x // fs


def _token(p, F, fs):
    return (p % F) * fs + p // F


@pytest.mark.parametrize("F,fs", LAYOUTS, ids=[f"{f}x{s}" for f, s in LAYOUTS])
@pytest.mark.parametrize("band_width", [1, 129, 300])
def test_slab_meta_covers_every_allowed_pair(F, fs, band_width):
    """Every (q, k) pair band_sink_perm allows lies in a (q slab, K/V slab)
    pair the slab metadata visits; runs are sorted and disjoint; the rows
    of a slab are the permuted positions [j P, j P + P)."""
    spec = _spec(F, fs, band_width)
    n_s, P, n = MD.slab_geometry(fs, F)
    assert (n_s, P, n) == (128 // F, (128 // F) * F, -(-fs // (128 // F)))
    S = F * fs
    x = np.arange(S)
    allowed = apply_mask_spec(spec, torch.as_tensor(x)[:, None], torch.as_tensor(x)[None, :], None).numpy()
    meta = MD.slab_meta_np(spec)
    assert meta.shape == (n, MD.SLAB_META_LEN) and meta.dtype == np.int32
    visits = np.zeros((n, n), bool)
    for j in range(n):
        runs = meta[j, 1:1 + 2 * meta[j, 0]].reshape(-1, 2)
        assert (runs[:, 0] < runs[:, 1]).all() and (runs[1:, 0] > runs[:-1, 1]).all()
        for a, b in runs:
            visits[j, a:b] = True
    slab = _perm(x, F, fs) // P
    assert np.array_equal(_token(_perm(x, F, fs), F, fs), x)
    assert not (allowed & ~visits[slab[:, None], slab[None, :]]).any()
    live = np.minimum(P, S - np.arange(n) * P)
    assert MD.slab_visits_np(spec).tolist() == [int((visits[j] * live).sum()) for j in range(n)]


@pytest.mark.parametrize("F,fs", LAYOUTS, ids=[f"{f}x{s}" for f, s in LAYOUTS])
def test_slab_tile_classes_are_exact(F, fs):
    """For each (warpgroup, K/V slab) of the walk: TILE_ALL allows every pair
    of its live rows and columns (so the kernel applies only the window),
    TILE_NONE none; the live columns end at the video's last slot."""
    spec = _spec(F, fs, 200)
    _, P, n = MD.slab_geometry(fs, F)
    S = F * fs
    seen = set()
    for j in range(n):
        for slab, hi, cls in slab_tile_walk(spec, j):
            assert hi == min(P, S - slab * P)
            kp = slab * P + np.arange(hi)
            for wg, c in enumerate(cls):
                qp = j * P + 64 * wg + np.arange(64)
                qp = qp[(qp < min(j * P + P, S))]
                if len(qp) == 0:
                    continue
                ok = apply_mask_spec(spec, torch.as_tensor(_token(qp, F, fs))[:, None],
                                     torch.as_tensor(_token(kp, F, fs))[None, :], None).numpy()
                if c == 2:
                    assert ok.all()
                if c == 0:
                    assert not ok.any()
                seen.add(c)
    assert seen == {0, 1, 2} or seen == {1, 2}
    st = slab_tile_stats(spec)
    assert st["TILE_ALL"] + st["TILE_SOME"] + st["TILE_NONE"] == 2 * st["loaded"] and st["TILE_ALL"] > 0


def _slab_walk_attention(q, k, v, spec, scale):
    """One temporal head (S, D) f32 along slab_tile_walk: per q slab and
    warpgroup, each loaded K/V slab in order with the kernel's online
    softmax, the window [0, hi), the predicate on TILE_SOME, TILE_NONE
    skipped. Returns (S, D): the video's rows."""
    F, fs = spec.num_frames, spec.frame_size
    _, P, n = MD.slab_geometry(fs, F)
    S = F * fs
    out = torch.zeros_like(q)
    qs = (q * (scale * LOG2E)).to(q.dtype)
    for j in range(n):
        tiles = slab_tile_walk(spec, j)
        for wg in (0, 1):
            qp = j * P + 64 * wg + torch.arange(64)
            qp = qp[(64 * wg + torch.arange(64) < P) & (qp < S)]
            if len(qp) == 0:
                continue
            qt = _token(qp, F, fs)
            state = (torch.zeros(len(qp), q.shape[1]), torch.full((len(qp), 1), NEG_INF), torch.zeros(len(qp), 1))
            for slab, hi, cls in tiles:
                if cls[wg] == 0:
                    continue
                kt = _token(slab * P + torch.arange(hi), F, fs)
                s = qs[qt] @ k[kt].T
                if cls[wg] == 1:
                    s = torch.where(apply_mask_spec(spec, qt[:, None], kt[None, :], None), s, NEG_INF)
                state = _online_softmax_step(state, s, v[kt])
            acc, _, l = state
            out[qt] = acc / l.clamp_min(1e-20)
    return out


@pytest.mark.parametrize("F,fs", LAYOUTS[:2], ids=[f"{f}x{s}" for f, s in LAYOUTS[:2]])
def test_slab_walk_reproduces_the_plain_dual_attention(F, fs):
    """A temporal head computed along the modelled slab walk equals the plain
    dual attention (block_sparse_attention_kv_plain on SVG1's dual metadata,
    the JAX-equal sparse_meta_dual) on the video's rows; the spatial head
    beside it keeps its metadata row. f32, atol 1e-5."""
    lay = VideoLayout(num_frames=F, frame_size=fs)
    plan = make_svg1_plan(lay, SVGConfig(sparsity=0.3), block_q=128, block_kv=256, inplace_temporal=True)
    S, Sp = lay.seq_len, plan.seq_pad_kv
    spec = plan.mask_spec_dual[1]
    rng = np.random.default_rng(F + fs)
    q, k, v = (torch.zeros(2, Sp, 32) for _ in range(3))
    for x in (q, k, v):
        x[:, :S] = torch.as_tensor(rng.standard_normal((2, S, 32)), dtype=torch.float32)
    dual = torch.as_tensor(plan.sparse_meta_dual())
    flags = torch.tensor([0, 1], dtype=torch.int32)
    meta = torch.stack([dual[0], dual[1]])
    aux = torch.cat([torch.zeros(4, dtype=torch.int32), flags])
    ref = block_sparse_attention_kv_plain(q, k, v, meta, aux, block_q=128, block_kv=256, mask_spec=plan.mask_spec_dual)
    ours = _slab_walk_attention(q[1, :S], k[1, :S], v[1, :S], spec, 32 ** -0.5)
    torch.testing.assert_close(ours, ref[1, :S], atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_slabs_first", [True, False], ids=["slabs_gt_tiles", "tiles_gt_slabs"])
def test_dual_work_order(n_slabs_first):
    """dual_work_order: a permutation of every head's n_items items, item h *
    n_items + t; a spatial head's tiles weighted by its metadata row's
    tokens, a temporal head's slabs by slab_visits_np, the items past a
    head's count last, heaviest first and ties in item order."""
    F, fs, sq = (50, 12, 640) if n_slabs_first else (21, 12, 1024)  # 6 slabs, 5 tiles; 2 slabs, 8 tiles
    spec = _spec(F, fs, 150)
    _, _, n_slabs = MD.slab_geometry(fs, F)
    S = F * fs
    mask = np.ones((1, sq // 128, sq // MD.SUB), bool)
    mask[0, 1] = False
    meta = torch.as_tensor(MD.chunk_meta_np(mask, MD.kv_counts_for_seq(S, sq), block_kv=256))
    flags = torch.tensor([1, 0, 1], dtype=torch.int32)
    order, n_items = dual_work_order(meta, flags, spec, 3, sq, 128)
    n_t = sq // 128
    assert n_items == max(n_t, n_slabs) and (n_slabs > n_t) == n_slabs_first
    assert order.dtype == torch.int32 and sorted(order.tolist()) == list(range(3 * n_items))
    tokens = MD.decode_meta(meta.numpy(), block_kv=256, seq_kv=sq).sum(-1)[0]
    visits = MD.slab_visits_np(spec)
    weight = []
    for h, f in enumerate(flags.tolist()):
        w = visits if f else tokens
        weight += list(w) + [-1] * (n_items - len(w))
    w = np.array(weight)[order.numpy()]
    assert (w[:-1] >= w[1:]).all() and (w >= 0).sum() == 2 * n_slabs + n_t
    ties = w[:-1] == w[1:]
    assert (order.numpy()[:-1][ties] < order.numpy()[1:][ties]).all()


def test_dual_kernel_args_refuse_what_slabs_cannot_hold():
    """The dual spec's kernel checks (run on CPU tensors here): more than
    128 frames (a slab holds all frames of a slot), a q or k/v shorter than
    the video, and an aux without the heads' classes raise."""
    def pair(F, fs):
        return (MaskSpec(kind="band_sink", band_width=129, sink_size=fs), _spec(F, fs, 129))

    q = torch.zeros(2, 1024, 64, dtype=torch.bfloat16)
    meta = torch.zeros(2, 8, 3, dtype=torch.int32)
    aux = torch.zeros(6, dtype=torch.int32)
    assert _check_kernel_args(q, q, q, meta, aux, pair(21, 48), 128).tolist() == [0] * 6
    with pytest.raises(ValueError, match="num_frames"):
        _check_kernel_args(q, q, q, meta, aux, pair(129, 9), 128)
    with pytest.raises(ValueError, match="video"):
        _check_kernel_args(q, q, q, meta, aux, pair(21, 49), 128)
    with pytest.raises(ValueError, match="4 \\+ BH"):
        _check_kernel_args(q, q, q, meta, aux[:5], pair(21, 48), 128)


FAULTS = ["none", "dense", "empty_q_block", "hole", "kv_tail", "past_video", "cheap_not_full", "overlap"]


@pytest.mark.parametrize("fault", FAULTS)
def test_dual_meta_faults(fault):
    """dual_meta_faults flags a temporal head whose rows would make the plain
    version attend other pairs than the slab kernel: a q block with no
    window, a needed sub-block or the tail of the video left out, a window
    past the video, an unmasked (n_cheap) window that not every q row of
    the block may attend in full, two windows over one token. The mask's
    block skeleton and dense masked rows pass, and along them the plain
    version equals the slab walk (f32, atol 1e-5). A spatial head (flag 0)
    with the same rows is never flagged."""
    F, fs, bq, bkv = 21, 20, 128, 256  # S = 420 in 512 padded tokens
    spec = _spec(F, fs, 129)
    S, Sp = F * fs, 512
    x = torch.arange(S)
    allowed = torch.zeros(Sp, Sp, dtype=torch.bool)
    allowed[:S, :S] = apply_mask_spec(spec, x[:, None], x[None, :], None)
    skel = allowed.reshape(Sp // bq, bq, Sp // 128, 128).any(3).any(1).numpy()
    counts = MD.kv_counts_for_seq(S, Sp)
    if fault == "dense":
        skel[:] = True
    if fault == "empty_q_block":
        skel[1] = False
    if fault == "hole":
        skel[0, np.flatnonzero(skel[0])[-1]] = False
    if fault == "kv_tail":
        skel[:] = True
        counts = MD.kv_counts_for_seq(S - 50, Sp)
    if fault == "past_video":
        skel[:] = True
        counts = MD.kv_counts_for_seq(Sp, Sp)
    meta = MD.chunk_meta_np(skel[None], counts, block_kv=bkv)
    meta = np.pad(meta, ((0, 0), (0, 0), (0, 2)))
    n = int(meta[0, 0, 0])
    if fault == "cheap_not_full":
        meta[0, 0, 0] = n + n * MD.N_CHEAP_SCALE
    if fault == "overlap":
        meta[0, 0, 0] = n + 1
        meta[0, 0, 1 + 2 * n:3 + 2 * n] = meta[0, 0, 1:3]
    meta = torch.as_tensor(np.concatenate([meta, meta]))
    got = dual_meta_faults(meta, torch.tensor([1, 0], dtype=torch.int32), spec, bq)
    assert got.tolist() == [fault not in ("none", "dense"), False]
    if fault in ("none", "dense"):
        rng = np.random.default_rng(3)
        q, k, v = (torch.zeros(2, Sp, 32) for _ in range(3))
        for t in (q, k, v):
            t[:, :S] = torch.as_tensor(rng.standard_normal((2, S, 32)), dtype=torch.float32)
        aux = torch.tensor([0, 0, 0, 0, 1, 1], dtype=torch.int32)
        ref = block_sparse_attention_kv_plain(q, k, v, meta, aux, block_q=bq, block_kv=bkv,
                                              mask_spec=(MaskSpec("band_sink", 129, fs), spec))
        ours = _slab_walk_attention(q[0, :S], k[0, :S], v[0, :S], spec, 32 ** -0.5)
        torch.testing.assert_close(ours, ref[0, :S], atol=1e-5, rtol=0)


@pytest.mark.parametrize("F,fs,block_q", [(21, 20, 128), (21, 18, 512), (16, 24, 128), (21, 1560, 512)],
                         ids=["21x20", "21x18", "16x24", "wan480p"])
def test_svg1_dual_meta_passes_the_dual_check(F, fs, block_q):
    """The rows SVG1Runtime hands the dual kernel (sparse_meta_dual, each half
    classified cheap-first under its spec) pass dual_meta_faults in every
    temporal head, Wan 2.1 480p (21 x 1560) included, and _dual_order
    checks once per meta and aux tensor: a new aux checks again, aux[2:4]
    offsets and a temporal head's q block with no window raise."""
    from sparse_videogen_tpu_torch.ops.attention import _dual_order
    from sparse_videogen_tpu_torch.sparse.runtimes import SVG1Runtime

    lay = VideoLayout(num_frames=F, frame_size=fs)
    plan = make_svg1_plan(lay, SVGConfig(), block_q=block_q, inplace_temporal=True)
    rt = SVG1Runtime(plan, device="cpu")
    spec = plan.mask_spec_dual[1]
    sq = -(-lay.seq_len // block_q) * block_q
    flags = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    meta = torch.where(flags[:, None, None] == 1, rt.sparse_meta[1][None], rt.sparse_meta[0][None]).contiguous()
    assert not dual_meta_faults(meta, flags, spec, block_q).any()
    aux = torch.cat([rt.aux[:4], flags])
    order, n_items = _dual_order(meta, aux, spec, 4, sq, block_q)
    assert _dual_order(meta, aux, spec, 4, sq, block_q)[0] is order
    assert _dual_order(meta, aux.clone(), spec, 4, sq, block_q)[0] is not order
    with pytest.raises(ValueError, match="offsets"):
        _dual_order(meta, torch.tensor([0, 0, 1, 0, 0, 1, 1, 0], dtype=torch.int32), spec, 4, sq, block_q)
    holed = meta.clone()
    holed[1, 0, 0] = 0
    with pytest.raises(ValueError, match=r"temporal heads \[1\]"):
        _dual_order(holed, aux, spec, 4, sq, block_q)


def _first_design_tile_stats(meta, spec, block_q, seq_q):
    """The walk of the dual kernel's first design over one temporal head, in
    original token order: 128-row q tiles over its chunked-CSR rows `meta`
    (nQ, L), each masked chunk's 128-token K/V tiles classified per 64-row
    warpgroup on conservative p-hulls (exact within a frame; across frames
    [f0, (fs - 1) F + f1]), the n_cheap chunks the window alone. Returns the
    tiles loaded and the (warpgroup, tile) pairs of each class."""
    fs, F, w, sink = spec.frame_size, spec.num_frames, spec.band_width, spec.sink_size

    def hull(x0, x1):
        f0, f1 = x0 // fs, x1 // fs
        return ((x0 - f0 * fs) * F + f0, (x1 - f1 * fs) * F + f1) if f0 == f1 else (f0, (fs - 1) * F + f1)

    st = {"loaded": 0, "TILE_ALL": 0, "TILE_SOME": 0, "TILE_NONE": 0}
    for t in range(seq_q // 128):
        row = meta[t * 128 // block_q]
        n, n_cheap = int(row[0]) % MD.N_CHEAP_SCALE, int(row[0]) // MD.N_CHEAP_SCALE
        hulls = [hull(t * 128 + 64 * wg, t * 128 + 64 * wg + 63) for wg in (0, 1)]
        for c in range(n):
            win, s0 = int(row[2 + 2 * c]), int(row[1 + 2 * c]) * MD.SUB
            lo, hi = win // MD.ENTRY_SCALE, win % MD.ENTRY_SCALE
            for t0 in range(lo & ~(MD.SUB - 1), hi, MD.SUB):
                st["loaded"] += 1
                pk0, pk1 = hull(s0 + max(t0, lo), s0 + min(t0 + MD.SUB, hi) - 1)
                for pq0, pq1 in hulls:
                    if c < n_cheap or (pq1 - pk0 < w and pk1 - pq0 < w) or pk1 < sink:
                        st["TILE_ALL"] += 1
                    elif (pk0 - pq1 >= w or pq0 - pk1 >= w) and pk0 >= sink:
                        st["TILE_NONE"] += 1
                    else:
                        st["TILE_SOME"] += 1
    return st


def test_slab_walk_against_the_first_design():
    """Why a temporal head runs in slabs, on Wan 2.1 480p (21 x 1560, SVG1's
    defaults, block_q 512): the first design (128-token tiles in original
    order, on SVG1's dual rows) loads 46,332 tiles and runs the per-pair
    predicate on 43,533 (warpgroup, tile) pairs; the slab walk loads 20,469
    slabs and runs it on 1,732, TILE_ALL on the rest."""
    from sparse_videogen_tpu_torch.sparse.runtimes import SVG1Runtime

    plan = make_svg1_plan(VideoLayout(num_frames=21, frame_size=1560), SVGConfig(), block_q=512,
                          inplace_temporal=True)
    meta = SVG1Runtime(plan, device="cpu").sparse_meta[1].numpy()
    spec = plan.mask_spec_dual[1]
    assert _first_design_tile_stats(meta, spec, 512, 32768) == {
        "loaded": 46332, "TILE_ALL": 17630, "TILE_SOME": 43533, "TILE_NONE": 31501}
    assert slab_tile_stats(spec) == {"loaded": 20469, "TILE_ALL": 39206, "TILE_SOME": 1732, "TILE_NONE": 0}


def test_dual_rows_check_the_stack_once():
    """dual_rows, SVG1's in-place path to the dual kernel: head h takes row
    stack[flags[h]] and aux is aux[:4] with the flags; the stack and aux are
    checked once per tensor and the rows come out with the kernel's work
    order made (the wrapper's _dual_order finds it without a check, even
    for new flags); a stack whose temporal rows have a hole, and aux
    offsets, raise."""
    from sparse_videogen_tpu_torch.ops import attention as A
    from sparse_videogen_tpu_torch.sparse.runtimes import SVG1Runtime

    plan = make_svg1_plan(VideoLayout(num_frames=21, frame_size=20), SVGConfig(), block_q=128,
                          inplace_temporal=True)
    rt = SVG1Runtime(plan, device="cpu")
    spec, stack = plan.mask_spec_dual[1], rt.sparse_meta
    sq = stack.shape[1] * 128
    checks = []
    real = A.dual_meta_faults
    try:
        A.dual_meta_faults = lambda *a: checks.append(1) or real(*a)
        for flags in ([0, 1, 1], [1, 0, 1]):
            flags = torch.tensor(flags, dtype=torch.int32)
            meta, aux = A.dual_rows(stack, flags, spec, 128, rt.aux)
            assert torch.equal(meta, stack[flags.long()]) and aux.tolist() == rt.aux.tolist() + flags.tolist()
            order = A._dual_order(meta, aux, spec, 3, sq, 128)
            assert torch.equal(order[0], dual_work_order(meta, flags, spec, 3, sq, 128)[0])
        assert len(checks) == 1
    finally:
        A.dual_meta_faults = real
    holed = stack.clone()
    holed[1, 0, 0] = 0
    with pytest.raises(ValueError, match="class stack's temporal rows"):
        A.dual_rows(holed, torch.tensor([0, 1], dtype=torch.int32), spec, 128)
    with pytest.raises(ValueError, match="offsets"):
        A.dual_rows(stack, torch.tensor([0, 1], dtype=torch.int32), spec, 128,
                    torch.tensor([0, 0, 0, 3], dtype=torch.int32))
