"""The Hopper kernels of the torch port against their plain PyTorch versions.

The `gpu`-marked tests need a CUDA device and skip without one; on the card
they run with `python -m pytest tests/test_torch_kernels.py -m gpu
--noconftest` (tests/conftest.py imports JAX, which the card's machine
lacks; this file imports none). The CPU tests check the
wrappers' dispatch and argument checks.
"""

import numpy as np
import pytest
import torch

from sparse_videogen_tpu_torch import _kernels
from sparse_videogen_tpu_torch.models.common.rope import wan_rope_cos_sin
from sparse_videogen_tpu_torch.ops import metadata as MD
from sparse_videogen_tpu_torch.ops.attention import (
    block_sparse_attention_kv,
    block_sparse_attention_kv_plain,
    block_sparse_attention_runs,
    block_sparse_attention_runs_plain,
    run_chunks,
    runs_tile_stats,
    runs_tile_walk,
    runs_work_order,
    work_order,
)
from sparse_videogen_tpu_torch.ops.kmeans import (
    VARIANTS,
    kmeans_assign_update,
    kmeans_assign_update_plain,
    kmeans_variant_pass,
    kmeans_variant_pass_plain,
)
from sparse_videogen_tpu_torch.ops.dense_qsplit import KERNEL_CONFIGS, dense_attn, dense_attn_plain
from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec
from sparse_videogen_tpu_torch.ops.rmsnorm import rms_norm_kernel, rms_norm_plain
from sparse_videogen_tpu_torch.ops.rope import rope_apply, rope_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on the card")
    return torch.device("cuda")


def test_cpu_tensor_runs_plain_and_bad_shapes_raise():
    q = torch.zeros(1, 256, 64)
    kv = torch.zeros(1, 256, 64)
    meta = torch.as_tensor(MD.dense_meta(256, 256, block_q=128, block_kv=128))
    _kernels.KIND_LAUNCHES["block_sparse_attn[none]"] += 1
    _kernels.reset_counts()
    assert not _kernels.KIND_LAUNCHES
    block_sparse_attention_kv(q, kv, kv, meta, block_q=128, block_kv=128)
    assert _kernels.PLAIN_CALLS["block_sparse_attn"] == 1 and _kernels.LAUNCHES["block_sparse_attn"] == 0
    assert not _kernels.KIND_LAUNCHES
    with pytest.raises(ValueError):  # Sq not a multiple of block_q
        block_sparse_attention_kv(q[:, :200], kv, kv, meta, block_q=128, block_kv=128)
    with pytest.raises(ValueError):  # metadata rows do not match the q blocks
        block_sparse_attention_kv(q, kv, kv, meta[:, :1], block_q=128, block_kv=128)


@pytest.mark.parametrize("R", [1, 3])
def test_work_order_is_heaviest_first_permutation(R):
    """K1's work items (head, 128-row q tile), item h * (Sq // 128) + t:
    work_order returns a permutation of all of them by descending weight,
    ties in item order, and each weight is the tokens its metadata row
    visits (decode_meta's live columns)."""
    rng = np.random.default_rng(R)
    BH, S, sq, skv, bq, bkv = 3, 1000, 1024, 1024, 256, 512
    mask = rng.random((R, sq // bq, skv // MD.SUB)) < 0.5
    mask[0, 1] = False
    meta = MD.chunk_meta_np(mask, np.repeat(MD.kv_counts_for_seq(S, skv), R, axis=0), block_kv=bkv)
    order, weight = work_order(torch.as_tensor(meta), BH, sq, bq)
    assert order.dtype == torch.int32 and sorted(order.tolist()) == list(range(BH * sq // 128))
    tokens = MD.decode_meta(meta, block_kv=bkv, seq_kv=skv).sum(-1)  # (R, nQ)
    h, t = np.divmod(np.arange(BH * sq // 128), sq // 128)
    assert weight.tolist() == tokens[0 if R == 1 else h, t * 128 // bq].tolist()
    w = weight[order.long()]
    assert bool((w[:-1] >= w[1:]).all())
    ties = (w[:-1] == w[1:])
    assert bool((order[:-1][ties] < order[1:][ties]).all())
    empty = weight.reshape(BH, -1)[:, 2:4] if R == 1 else weight.reshape(BH, -1)[0, 2:4]  # q block 1 of row 0
    assert not empty.any()


def test_kernel_args_need_block_q_multiple_of_cta_rows():
    """Both attention kernels take 128 q rows a CTA (one CTA body): their
    check and both work-order builders raise on block_q % 128 != 0."""
    from sparse_videogen_tpu_torch.ops.attention import _KERNEL_MASKS, _RUNS_KERNEL_MASKS, BQ, _check_kernel_args

    q = torch.zeros(1, 384, 64, dtype=torch.bfloat16)
    meta = torch.as_tensor(MD.dense_meta(384, 384, block_q=192, block_kv=128))
    for kinds in (tuple(_KERNEL_MASKS), _RUNS_KERNEL_MASKS):
        with pytest.raises(ValueError, match="block_q % 128"):
            _check_kernel_args(q, q, q, meta, None, MaskSpec(), 192, kinds)
    for order in (work_order, runs_work_order):
        with pytest.raises(ValueError):
            order(meta, 1, 384, 192)
    assert BQ == 128
    assert _check_kernel_args(q, q, q, meta, None, MaskSpec(), 128, _RUNS_KERNEL_MASKS).tolist() == [0, 0, 0, 0]
    assert _check_kernel_args(q, q, q, meta, None, MaskSpec(), 128).tolist() == [0, 0, 0, 0]


def test_ptxas_report_reads_the_attention_entries():
    """chip_smoke's build phase reads registers and spills of every K1, K3,
    K7 and K5-assign instance from nvcc's -Xptxas -v log (K7's MODE in
    `kind`); other entries (K5's scan, a RoPE kernel) are not reported."""
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110bsa_kernelILi64ELi3EEEvPKi' for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN12_GLOBAL__N_110bsa_kernelILi64ELi3EEEvPKi\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers, 960 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_Z9rope_kernPKf' for 'sm_90a'\n"
           "ptxas info    : Used 30 registers, 380 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111runs_kernelILi128EEEvPKi' for 'sm_90a'\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Used 166 registers, 16 bytes smem, 400 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112dense_kernelILi128ELi3EEEv14CUtensorMap_st' "
           "for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 5 barriers, 912 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118kmeans_scan_kernelEPiS0_S0_Pfii' for 'sm_90a'\n"
           "ptxas info    : Used 24 registers, 256 bytes smem, 392 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120kmeans_assign_kernelILi64EEEv14CUtensorMap_st' "
           "for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 3 barriers, 400 bytes cmem[0]\n")
    assert _kernels.ptxas_report(log) == [
        {"kernel": "bsa_kernel", "D": 64, "kind": 3, "registers": 168, "spill_stores": 0, "spill_loads": 0,
         "static_smem": 0},
        {"kernel": "runs_kernel", "D": 128, "kind": None, "registers": 166, "spill_stores": 8, "spill_loads": 4,
         "static_smem": 16},
        {"kernel": "dense_kernel", "D": 128, "kind": 3, "registers": 168, "spill_stores": 0, "spill_loads": 0,
         "static_smem": 0},
        {"kernel": "kmeans_assign_kernel", "D": 64, "kind": None, "registers": 168, "spill_stores": 0,
         "spill_loads": 0, "static_smem": 0}]


def _run_list_case(rng, BH, C, S, Sq, bq, bkv, p=0.5):
    """Run lists over random cluster sizes (one empty cluster), per head, each
    cluster selected with probability p, with q block 1 visiting nothing."""
    sizes = np.zeros((BH, C), np.int32)
    for b in range(BH):
        w = rng.random(C)
        w[rng.integers(0, C)] = 0.0
        sizes[b] = np.floor(w / w.sum() * S)
        sizes[b, np.argmax(sizes[b])] += S - sizes[b].sum()
    starts = np.concatenate([np.zeros((BH, 1), np.int32), np.cumsum(sizes, axis=1)[:, :-1]], axis=1)
    sel = rng.random((BH, Sq // bq, C)) < p
    sel[:, 1] = False
    return MD.run_meta_np(sel, starts, sizes, block_kv=bkv, cap=C)


# short runs (< 128 tokens) that share 128-token tiles and start mid-tile,
# a run of one token, runs across a tile edge and a chunk edge
_SHORT_RUNS = [(5, 40), (60, 100), (130, 131), (250, 400), (509, 515), (1000, 1300), (1400, 1408)]


def _runs_row(runs, bkv, cap):
    row = np.zeros(MD.run_meta_row_len(cap), np.int32)
    row[0] = sum(MD._run_chunks(a, b, bkv) for a, b in runs)
    row[1:1 + 2 * len(runs)] = np.asarray(runs).reshape(-1)
    return row


@pytest.mark.parametrize("R", [1, 3])
def test_runs_work_order_is_heaviest_first_permutation(R):
    """The run-list kernel's work items (head, 128-row q tile): a permutation
    of all of them by descending weight, ties in item order; each weight is
    the tokens its row's chunks cover (run_chunks), 0 for a row with runs
    but n = 0 (SAP's q blocks without a token); R == 1 gives every head
    the same weights; shapes that do not match raise."""
    rng = np.random.default_rng(40 + R)
    BH, C, S, sq, bq, bkv = 3, 9, 1500, 1024, 256, 512
    meta = _run_list_case(rng, R, C, S, sq, bq, bkv)
    meta[0, 2, 0] = 0
    assert meta[0, 2, 1:].any()
    order, weight = runs_work_order(torch.as_tensor(meta), BH, sq, bq)
    assert order.dtype == torch.int32 and sorted(order.tolist()) == list(range(BH * sq // 128))
    tokens = np.asarray([[sum(hi - lo for lo, hi in run_chunks(meta[r, i], bkv)) for i in range(sq // bq)]
                         for r in range(R)])
    h, t = np.divmod(np.arange(BH * sq // 128), sq // 128)
    assert weight.tolist() == tokens[0 if R == 1 else h, t * 128 // bq].tolist()
    assert weight.reshape(BH, -1)[0, 4:6].tolist() == [0, 0]
    if R == 1:
        assert bool((weight.reshape(BH, -1) == weight.reshape(BH, -1)[:1]).all())
    w = weight[order.long()]
    assert bool((w[:-1] >= w[1:]).all())
    ties = w[:-1] == w[1:]
    assert bool((order[:-1][ties] < order[1:][ties]).all())
    m = torch.as_tensor(meta)
    bad = [(m, BH, sq, 192), (m[:, :2], BH, sq, bq), (m, BH, sq + 128, bq)] + ([(m, 2, sq, bq)] if R > 1 else [])
    for args in bad:
        with pytest.raises(ValueError):
            runs_work_order(*args)


def _check_tile_walk(row, bkv):
    """runs_tile_walk against run_chunks on one row: the tiles' live tokens,
    in walk order, are the chunks' tokens in theirs (full chunks first), each
    token once; every tile starts on a multiple of 128, holds a live token
    and covers its live span; runs_tile_stats counts the same."""
    tiles = runs_tile_walk(row, bkv)
    walked = [tok for _, lo, hi in tiles for tok in range(lo, hi)]
    listed = [tok for lo, hi in run_chunks(row, bkv) for tok in range(lo, hi)]
    assert walked == listed and len(set(walked)) == len(walked)
    assert all(t0 % MD.SUB == 0 and t0 <= lo < hi <= t0 + MD.SUB for t0, lo, hi in tiles)
    live, loaded = runs_tile_stats(torch.as_tensor(row)[None, None])
    assert (int(live), int(loaded)) == (len(walked), len(tiles))
    return tiles


@pytest.mark.parametrize("bkv", [128, 256, 1024])
def test_runs_tile_walk_covers_run_chunks(bkv):
    """The model of the kernel's walk on random run lists (per head, with an
    empty q block) and on short runs that share tiles."""
    rng = np.random.default_rng(bkv)
    meta = _run_list_case(rng, 2, 23, 3000, 1024, 256, bkv)
    for row in meta.reshape(-1, meta.shape[-1]):
        _check_tile_walk(row, bkv)
    assert runs_tile_walk(meta[0, 1], bkv) == []
    tiles = _check_tile_walk(_runs_row(_SHORT_RUNS, bkv, len(_SHORT_RUNS) + 2), bkv)
    # the short runs touch tile 0 twice (5-40, 60-100), tile 384 twice (250-400 ends and 509-515 starts there)
    starts = [t0 for t0, _, _ in tiles]
    assert starts.count(0) == 2 and starts.count(384) == 2
    live, loaded = runs_tile_stats(torch.as_tensor(meta))
    assert live.shape == loaded.shape == meta.shape[:2] and not live[:, 1].any() and not loaded[:, 1].any()


def test_runs_and_kmeans_cpu_tensors_run_plain():
    rng = np.random.default_rng(0)
    meta = torch.as_tensor(_run_list_case(rng, 2, 5, 300, 256, 128, 256))
    q, k = torch.zeros(2, 256, 64), torch.zeros(2, 384, 64)
    _kernels.reset_counts()
    out = block_sparse_attention_runs(q, k, k, meta, block_q=128, block_kv=256)
    labels, sums, counts = kmeans_assign_update(torch.randn(2, 40, 8), torch.randn(2, 3, 8))
    kmeans_variant_pass(torch.randn(2, 40, 8), torch.randn(2, 300, 8), "D")
    assert _kernels.PLAIN_CALLS["block_sparse_attn_runs"] == 1 and _kernels.PLAIN_CALLS["kmeans_wide"] == 1
    assert _kernels.PLAIN_CALLS["kmeans_variants"] == 1
    assert not any(_kernels.LAUNCHES.values())
    assert out.shape == q.shape and labels.shape == (2, 40) and sums.shape == (2, 3, 8) and counts.sum() == 80
    with pytest.raises(ValueError):  # block_kv not a multiple of 128
        block_sparse_attention_runs(q, k, k, meta, block_q=128, block_kv=192)


def _runs_gpu_case(case, rng):
    """(meta, BH, Sq, S, block_q, block_kv) of a run-list case; q block 1
    visits nothing in each."""
    if case == "random":  # per-head lists over 11 random clusters
        BH, C, S, Sq, bq, bkv = 3, 11, 1900, 1024, 256, 512
        return _run_list_case(rng, BH, C, S, Sq, bq, bkv), BH, Sq, S, bq, bkv
    if case == "short_runs":  # 60 clusters of ~32 tokens: short runs that share 128-token tiles
        BH, S, Sq, bq, bkv = 2, 1900, 1024, 256, 256
        meta = _run_list_case(rng, BH, 60, S, Sq, bq, bkv, p=0.3)
        meta[1, 0] = _runs_row(_SHORT_RUNS, bkv, 60)
        return meta, BH, Sq, S, bq, bkv
    if case == "shared_meta":  # R == 1: one list for all 3 heads
        S, Sq, bq, bkv = 1900, 1024, 256, 512
        return _run_list_case(rng, 1, 11, S, Sq, bq, bkv), 3, Sq, S, bq, bkv
    if case == "block_q_512":
        BH, S, Sq, bq, bkv = 2, 1900, 1536, 512, 1024
        return _run_list_case(rng, BH, 11, S, Sq, bq, bkv), BH, Sq, S, bq, bkv
    if case == "long_rows":  # q block 0 visits all 8000 tokens: 63 tiles, the ring wraps many times
        BH, S, Sq, bq, bkv = 2, 8000, 512, 256, 1024
        meta = _run_list_case(rng, BH, 4, S, Sq, bq, bkv)
        meta[:, 0] = _runs_row([(0, S)], bkv, 4)
        return meta, BH, Sq, S, bq, bkv
    # heavy_row: q block 3 of head 1 visits every cluster, the rest ~10% of them
    BH, C, S, Sq, bq, bkv = 2, 30, 4000, 1024, 128, 512
    meta = _run_list_case(rng, BH, C, S, Sq, bq, bkv, p=0.1)
    meta[1, 3] = _runs_row([(0, S)], bkv, C)
    return meta, BH, Sq, S, bq, bkv


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "short_runs", "shared_meta", "block_q_512", "long_rows", "heavy_row"])
@pytest.mark.parametrize("spec", [MaskSpec(), MaskSpec(kind="band_sink", band_width=300, sink_size=200)],
                         ids=["none", "band_sink"])
@pytest.mark.parametrize("D_", [64, 128])
def test_runs_kernel_matches_plain(cuda, spec, D_, case):
    """The run-list kernel (mask none) and its MaskSpec path (band_sink)
    against the plain version on the card, bf16, aux offsets, an empty q
    block (exactly 0), and each case of _runs_gpu_case: random per-head
    lists, short runs sharing tiles, R == 1, block_q 512, rows that wrap the
    ring many times, one heavy row among light ones. Same tolerance and
    reason as the chunked kernel's: atol 2e-2. block_q 64 raises."""
    rng = np.random.default_rng(12)
    meta_np, BH, Sq, S, bq, bkv = _runs_gpu_case(case, rng)
    meta = torch.as_tensor(meta_np, device=cuda)
    skv = -(-S // MD.SUB) * MD.SUB
    q, k, v = (torch.randn(BH, n, D_, device=cuda).to(torch.bfloat16) for n in (Sq, skv, skv))
    aux = torch.as_tensor(np.asarray([0, 0, 5, 9], np.int32), device=cuda)
    kw = dict(block_q=bq, block_kv=bkv, mask_spec=spec)
    _kernels.reset_counts()
    out = block_sparse_attention_runs(q, k, v, meta, aux, **kw)
    assert _kernels.LAUNCHES["block_sparse_attn_runs"] == 1 and _kernels.PLAIN_CALLS["block_sparse_attn_runs"] == 0
    ref = block_sparse_attention_runs_plain(q, k, v, meta, aux, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    assert torch.all(out[:, bq:2 * bq] == 0)
    if case == "random":  # a CUDA call the kernel cannot take raises, never falls back
        meta64 = torch.as_tensor(_run_list_case(rng, BH, 11, S, Sq, 64, bkv), device=cuda)
        with pytest.raises(ValueError, match="block_q % 128"):
            block_sparse_attention_runs(q, k, v, meta64, aux, block_q=64, block_kv=bkv, mask_spec=spec)


def _check_labels_and_sums(x, c, out, ref_labels):
    """Labels equal the plain version's wherever its best-to-second distance
    gap exceeds 1e-3 x |best distance| (the f32 products sum in another
    order, so nearer ties may flip) and on >= 99.9% of the tokens; the counts
    are those of the kernel's own labels and the f32 sums equal their plain
    segment sums to 1e-5 relative to the largest |sum|."""
    labels, sums, counts = out
    cf = c.float()
    dist = (cf * cf).sum(-1)[:, None, :] - 2.0 * x.float() @ cf.transpose(1, 2)
    top2 = dist.topk(2, dim=-1, largest=False).values
    clear = (top2[..., 1] - top2[..., 0]) > 1e-3 * top2[..., 0].abs()
    assert torch.equal(labels[clear], ref_labels[clear])
    assert (labels == ref_labels).float().mean().item() >= 0.999
    onehot = torch.nn.functional.one_hot(labels.long(), c.shape[1]).float()
    seg = onehot.transpose(1, 2) @ x.float()
    assert torch.equal(counts, onehot.sum(1))
    assert (sums - seg).abs().max().item() <= 1e-5 * seg.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("K", [50, 200, 257, 300, 1000])
@pytest.mark.parametrize("D_", [64, 128])
def test_kmeans_kernel_matches_plain_and_is_deterministic(cuda, K, D_):
    """K5 on the card (csrc/kmeans_lloyd.cu) at every K: 50 and 200, the
    480p SAP config's; 300 and 1000, the 720p one's; 257, one past two
    128-centroid tiles. N = 5000 is a multiple of neither the 256-token item
    nor the 1024-token sort chunk. Two launches give the same bits; labels,
    counts and sums as _check_labels_and_sums states."""
    gen = torch.Generator(device=cuda).manual_seed(K + D_)
    B, N = 3, 5000
    x = torch.randn(B, N, D_, generator=gen, device=cuda).to(torch.bfloat16)
    c = x[:, torch.randperm(N, generator=gen, device=cuda)[:K]]
    _kernels.reset_counts()
    out = kmeans_assign_update(x, c)
    again = kmeans_assign_update(x, c)
    assert _kernels.LAUNCHES["kmeans_wide"] == 2 and not any(_kernels.PLAIN_CALLS.values())
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    _check_labels_and_sums(x, c, out, kmeans_assign_update_plain(x, c)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("D_", [64, 128])
def test_kmeans_kernel_one_large_cluster(cuda, D_):
    """K5 with 3000 of 5000 tokens copies of centroid 0 (cluster 0 spans 24
    segments of 128 tokens in the sorted update, the rest hold a few tokens
    each), K = 300: the same bits twice, and labels, counts and sums as
    _check_labels_and_sums states."""
    gen = torch.Generator(device=cuda).manual_seed(11 + D_)
    B, N, K = 2, 5000, 300
    x = torch.randn(B, N, D_, generator=gen, device=cuda).to(torch.bfloat16)
    x[:, :3000] = x[:, 3000:3001]
    c = x[:, 3000:3000 + K].clone()
    _kernels.reset_counts()
    out = kmeans_assign_update(x, c)
    again = kmeans_assign_update(x, c)
    assert _kernels.LAUNCHES["kmeans_wide"] == 2 and not any(_kernels.PLAIN_CALLS.values())
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    assert bool((out[2][:, 0] >= 3001).all())
    _check_labels_and_sums(x, c, out, kmeans_assign_update_plain(x, c)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("D_", [64, 128])
def test_kmeans_variant_kernels_match_plain(cuda, variant, D_):
    """The probe's variants on K5's kernels at K = 300, with the last two
    centroids copies of the first two (exact ties). Same bits twice. A, B, C:
    as K5 against the plain version, and B, C equal to A, and A to K5's own
    pass, bit for bit; E: A's labels, sums and counts 0; D: labels 0, and the
    counts and sums of A's labels spread over the identical centroids (counts
    exactly, sums to 1e-5)."""
    gen = torch.Generator(device=cuda).manual_seed(7 + D_)
    B, N, K = 3, 5000, 300
    x = torch.randn(B, N, D_, generator=gen, device=cuda).to(torch.bfloat16)
    c = torch.randn(B, K, D_, generator=gen, device=cuda).to(torch.bfloat16)
    c[:, K - 2:] = c[:, :2]
    _kernels.reset_counts()
    out = kmeans_variant_pass(x, c, variant)
    again = kmeans_variant_pass(x, c, variant)
    assert _kernels.LAUNCHES["kmeans_variants"] == 2 and not any(_kernels.PLAIN_CALLS.values())
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    a_out = kmeans_variant_pass(x, c, "A")
    assert all(torch.equal(a, b) for a, b in zip(a_out, kmeans_assign_update(x, c)))
    ref_labels = kmeans_variant_pass_plain(x, c, "A")[0]
    if variant in ("A", "B", "C"):
        _check_labels_and_sums(x, c, out, ref_labels)
        for a, b in zip(out, a_out):
            assert torch.equal(a, b)
    elif variant == "E":
        assert torch.equal(out[0], a_out[0]) and not out[1].any() and not out[2].any()
    else:
        tie = (c[:, :, None] == c[:, None, :]).all(-1).float()
        multi = torch.nn.functional.one_hot(a_out[0].long(), K).float() @ tie
        want = multi.transpose(1, 2) @ x.float()
        assert not out[0].any() and torch.equal(out[2], multi.sum(1)) and out[2].sum() > B * N
        assert (out[1] - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [MaskSpec(), MaskSpec(kind="band_sink", band_width=300, sink_size=200)],
                         ids=["none", "band_sink"])
@pytest.mark.parametrize("D_", [64, 128])
def test_attention_kernel_matches_plain(cuda, spec, D_):
    """The Hopper kernel against the plain version on the card, bf16, with a
    sequence tail, per-head metadata and an empty q block. Both accumulate in
    f32 and round P to bf16 for PV; they rescale P at other points (64-token
    sub-tiles vs whole chunks): atol 2e-2 on bf16 outputs of size ~1."""
    rng = np.random.default_rng(11)
    S, sq, skv, bq, bkv = 1000, 1024, 1024, 256, 512
    mask = rng.random((2, sq // bq, skv // MD.SUB)) < 0.6
    mask[1, 0] = False
    meta = MD.chunk_meta_np(mask, np.repeat(MD.kv_counts_for_seq(S, skv), 2, axis=0), block_kv=bkv)
    meta = MD.classify_cheap_np(meta, spec, np.zeros(4, np.int32), block_q=bq, block_kv=bkv, seq_q=S)
    t = lambda a: torch.as_tensor(a, device=cuda)
    q, k, v = (torch.randn(2, n, D_, device=cuda).to(torch.bfloat16) for n in (sq, skv, skv))
    aux = t(np.asarray([0, 0, 3, 1], np.int32))
    kw = dict(block_q=bq, block_kv=bkv, mask_spec=spec)
    _kernels.reset_counts()
    out = block_sparse_attention_kv(q, k, v, t(meta), aux, **kw)
    assert _kernels.LAUNCHES["block_sparse_attn"] == 1 and _kernels.PLAIN_CALLS["block_sparse_attn"] == 0
    assert _kernels.KIND_LAUNCHES == {f"block_sparse_attn[{spec.kind}]": 1}
    ref = block_sparse_attention_kv_plain(q, k, v, t(meta), aux, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[:, :S].float(), ref[:, :S].float(), atol=2e-2, rtol=0)
    assert torch.all(out[1, :bq] == 0)


_EDGE_SPECS = {
    "none": (MaskSpec(), [0, 0, 3, 1]),
    "band_sink": (MaskSpec(kind="band_sink", band_width=300, sink_size=200), [0, 0, 3, 1]),
    "hyvideo": (MaskSpec(kind="hyvideo", band_width=300, video_len=800), [900, 0, 0, 0]),
    "cog": (MaskSpec(kind="cog", band_width=300), [50, 0, 0, 0]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", list(_EDGE_SPECS))
@pytest.mark.parametrize("D_", [64, 128])
def test_attention_kernel_edges(cuda, kind, D_):
    """K1's tile edges on the card, each kind at D = 64 and 128, per-head
    metadata (R = BH = 2), bf16: head 0's first q block visits one chunk
    clamped to the end of the array (lo = 256 > 0) whose window ends inside
    a 128-token tile (hi = 488, the sequence tail at S = 1000); head 1's
    third q block visits nothing and must output exactly 0; the rest is
    random, cheap-first per the kind. Same tolerance as the other kinds:
    atol 2e-2."""
    spec, aux_l = _EDGE_SPECS[kind]
    rng = np.random.default_rng(21)
    S, sq, skv, bq, bkv = 1000, 1024, 1024, 256, 512
    mask = rng.random((2, sq // bq, skv // MD.SUB)) < 0.6
    mask[0, 0] = False
    mask[0, 0, 6:] = True
    mask[1, 2] = False
    meta = MD.chunk_meta_np(mask, np.repeat(MD.kv_counts_for_seq(S, skv), 2, axis=0), block_kv=bkv)
    aux = np.asarray(aux_l, np.int32)
    meta = MD.classify_cheap_np(meta, spec, aux, block_q=bq, block_kv=bkv, seq_q=S)
    assert meta[0, 0, 0] % MD.N_CHEAP_SCALE == 1 and meta[0, 0, 1] == 4 and meta[0, 0, 2] == MD.pack_window(256, 488)
    t = lambda a: torch.as_tensor(a, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(D_)
    q, k, v = (torch.randn(2, n, D_, generator=g, device=cuda).to(torch.bfloat16) for n in (sq, skv, skv))
    kw = dict(block_q=bq, block_kv=bkv, mask_spec=spec)
    _kernels.reset_counts()
    out = block_sparse_attention_kv(q, k, v, t(meta), t(aux), **kw)
    assert _kernels.LAUNCHES["block_sparse_attn"] == 1 and _kernels.KIND_LAUNCHES == {f"block_sparse_attn[{kind}]": 1}
    ref = block_sparse_attention_kv_plain(q, k, v, t(meta), t(aux), **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[:, :S].float(), ref[:, :S].float(), atol=2e-2, rtol=0)
    assert torch.all(out[1, 2 * bq:3 * bq] == 0)
    with pytest.raises(ValueError, match="block_q % 128"):  # a CUDA call the kernel cannot take raises
        block_sparse_attention_kv(q, k, v, t(MD.dense_meta(sq, skv, block_q=64, block_kv=bkv)), t(aux),
                                  block_q=64, block_kv=bkv, mask_spec=spec)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["dense", "svg1"])
@pytest.mark.parametrize("D_", [64, 128])
def test_attention_kernel_hyvideo_matches_plain(cuda, which, D_):
    """K1's hyvideo kind on the card: a text-last layout (3 frames x 160
    tokens + 8 text tokens, prompt 3: real, fake and padded rows), the
    runtime's cheap-first metadata and aux, dense (band 1 << 24) and SVG1
    (floor band); same tolerance and reason as the other kinds: atol 2e-2."""
    from sparse_videogen_tpu_torch.config import SVGConfig, TextPosition, VideoLayout
    from sparse_videogen_tpu_torch.sparse.runtimes import SVG1Runtime
    from sparse_videogen_tpu_torch.sparse.svg1 import make_svg1_plan

    lay = VideoLayout(num_frames=3, frame_size=160, context_length=8, text_position=TextPosition.LAST)
    plan = make_svg1_plan(lay, SVGConfig(sparsity=0.6), block_q=128, block_kv=256)
    rt = SVG1Runtime(plan, device=cuda, prompt_length=3)
    meta, spec, bq = ((rt.dense_meta, plan.dense_mask_spec, plan.dense_block_q) if which == "dense"
                      else (rt.sparse_meta, plan.mask_spec, plan.block_q))
    q = torch.randn(3, plan.seq_pad_q, D_, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(3, plan.seq_pad_kv, D_, device=cuda).to(torch.bfloat16) for _ in range(2))
    kw = dict(block_q=bq, block_kv=plan.block_kv, mask_spec=spec)
    _kernels.reset_counts()
    out = block_sparse_attention_kv(q, k, v, meta, rt.aux, **kw)
    assert _kernels.LAUNCHES["block_sparse_attn"] == 1 and _kernels.PLAIN_CALLS["block_sparse_attn"] == 0
    assert _kernels.KIND_LAUNCHES == {f"block_sparse_attn[{spec.kind}]": 1}
    ref = block_sparse_attention_kv_plain(q, k, v, meta, rt.aux, **kw)
    torch.cuda.synchronize()
    S = lay.seq_len
    torch.testing.assert_close(out[:, :S].float(), ref[:, :S].float(), atol=2e-2, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["dense", "svg1"])
@pytest.mark.parametrize("D_", [64, 128])
def test_attention_kernel_cog_matches_plain(cuda, which, D_):
    """K1's cog kind on the card: a text-first layout (16 text tokens, then
    3 frames x 160 tokens) with a prompt of 5 of them, so the text rows and
    columns past the prompt fall to the band; the runtime's cheap-first
    metadata and aux, dense (mask none) and SVG1 (floor band); same
    tolerance and reason as the other kinds: atol 2e-2."""
    from sparse_videogen_tpu_torch.config import SVGConfig, TextPosition, VideoLayout
    from sparse_videogen_tpu_torch.sparse.runtimes import SVG1Runtime
    from sparse_videogen_tpu_torch.sparse.svg1 import make_svg1_plan

    lay = VideoLayout(num_frames=3, frame_size=160, context_length=16, text_position=TextPosition.FIRST)
    plan = make_svg1_plan(lay, SVGConfig(sparsity=0.6), block_q=128, block_kv=256)
    rt = SVG1Runtime(plan, device=cuda, prompt_length=5)
    meta, spec, bq = ((rt.dense_meta, plan.dense_mask_spec, plan.dense_block_q) if which == "dense"
                      else (rt.sparse_meta, plan.mask_spec, plan.block_q))
    q = torch.randn(3, -(-lay.seq_len // bq) * bq, D_, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(3, plan.seq_pad_kv, D_, device=cuda).to(torch.bfloat16) for _ in range(2))
    kw = dict(block_q=bq, block_kv=plan.block_kv, mask_spec=spec)
    _kernels.reset_counts()
    out = block_sparse_attention_kv(q, k, v, meta, rt.aux, **kw)
    assert _kernels.LAUNCHES["block_sparse_attn"] == 1 and _kernels.PLAIN_CALLS["block_sparse_attn"] == 0
    assert _kernels.KIND_LAUNCHES == {f"block_sparse_attn[{spec.kind}]": 1}
    ref = block_sparse_attention_kv_plain(q, k, v, meta, rt.aux, **kw)
    torch.cuda.synchronize()
    S = lay.seq_len
    torch.testing.assert_close(out[:, :S].float(), ref[:, :S].float(), atol=2e-2, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("bq,qsplit", KERNEL_CONFIGS)
@pytest.mark.parametrize("D_", [64, 128])
def test_dense_qsplit_kernel_matches_plain(cuda, bq, qsplit, D_):
    """K7 on the card against its plain version, bf16, S = 1024, bkv 256, for
    each compiled (bq, qsplit) (qsplit 2: the ping-pong schedule): both
    round q_s and P to bf16; the kernel rescales P per 128-token tile, the
    plain version per bkv chunk: atol 2e-2."""
    g = torch.Generator(device=cuda).manual_seed(bq + qsplit + D_)
    q, k, v = (torch.randn(2, 1024, D_, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    _kernels.reset_counts()
    out = dense_attn(q, k, v, bq=bq, bkv=256, qsplit=qsplit)
    assert _kernels.LAUNCHES["dense_qsplit"] == 1 and _kernels.PLAIN_CALLS["dense_qsplit"] == 0
    ref = dense_attn_plain(q, k, v, bq=bq, bkv=256, qsplit=qsplit)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    with pytest.raises(ValueError):  # a configuration the kernel does not take raises, never falls back
        dense_attn(q, k, v, bq=512, bkv=256, qsplit=4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1000, 128), (3, 77, 1536), (40, 3072)], ids=["qk", "block", "hidden"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    """K6 (Triton) on the card: the mean of squares sums in another order and
    rsqrt may differ in its last f32 bit, so the cast may round to the
    neighbouring value: |diff| <= 2^-6 |plain| + 1e-6 in bf16 (two roundings,
    one ulp each), 1e-5 relative in f32."""
    g = torch.Generator(device=cuda).manual_seed(shape[-1])
    x = (torch.randn(shape, generator=g, device=cuda) * 3).to(dtype)
    w = torch.rand(shape[-1], generator=g, device=cuda) + 0.5
    _kernels.reset_counts()
    out = rms_norm_kernel(x, w, 1e-6)
    assert _kernels.LAUNCHES["rmsnorm"] == 1 and _kernels.PLAIN_CALLS["rmsnorm"] == 0
    ref = rms_norm_plain(x, w, 1e-6)
    torch.cuda.synchronize()
    rtol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-5
    assert bool(((out.float() - ref.float()).abs() <= rtol * ref.float().abs() + 1e-6).all())


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
def test_rope_kernel_matches_plain(cuda, D):
    """Kernel and plain version evaluate the same f32 products and sums (no
    FMA contraction) and round once to bf16: equal bit for bit."""
    cos, sin = (torch.as_tensor(a, device=cuda) for a in wan_rope_cos_sin(5, 6, 7, D))
    x = torch.randn(6, cos.shape[0], D, device=cuda).to(torch.bfloat16)
    _kernels.reset_counts()
    out = rope_apply(x, cos, sin)
    assert _kernels.LAUNCHES["rope"] == 1
    torch.testing.assert_close(out, rope_plain(x, cos, sin), atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["dense", "SVG", "SAP"])
def test_small_wan_forward_kernels_vs_plain(cuda, pattern):
    """A small bf16 Wan forward at batch 1 (head views that are not
    contiguous on their own): kernels on the card against the plain versions
    on the CPU, same weights, inputs and profiler rows. SAP runs at full
    density (top_p 1.0, min_kc_ratio 1.0): the two devices' k-means may
    split near-ties differently, and full density makes the output
    independent of the clustering. CPU and GPU matmuls round bf16 at other
    places over 4 blocks: rel L2 error <= 3e-2."""
    from sparse_videogen_tpu_torch.config import SAPConfig
    from sparse_videogen_tpu_torch.models.wan.model import WanConfig, WanModel
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime, wan_layout

    cfg = WanConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=4, freq_dim=64, text_dim=64, text_len=16)
    gen = torch.Generator().manual_seed(0)
    cpu = WanModel(cfg, dtype=torch.bfloat16).init_random(gen)
    gpu = WanModel(cfg, dtype=torch.bfloat16, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    lay = wan_layout(cfg, 96, 128, 9)
    x = torch.randn(1, 16, lay.num_frames, 12, 16, generator=gen).to(torch.bfloat16)
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen).to(torch.bfloat16)
    t = torch.full((1,), 500.0)
    rows = torch.randint(0, lay.seq_len, (cfg.num_layers, 64), generator=gen)
    outs = []
    for model, dev in ((gpu, cuda), (cpu, torch.device("cpu"))):
        sap = SAPConfig(num_q_centroids=8, num_k_centroids=12, kmeans_iter_init=8, top_p_kmeans=1.0, min_kc_ratio=1.0)
        rt = make_wan_runtime(lay, device=dev, pattern=pattern, sap=sap)
        outs.append(model(x.to(dev), t.to(dev), ctx.to(dev), attention=rt, profile_rows=rows,
                          generator=torch.Generator(device=dev).manual_seed(0)).cpu())
    assert ((outs[0] - outs[1]).norm() / outs[1].norm()).item() <= 3e-2

