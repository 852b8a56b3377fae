"""The Hopper kernels' new instances against their plain versions on the
card: K1's dual per-head spec (placement-free SVG1), the (m, l) stats of K1,
K3 and K4 (`return_stats`), and the dense ring on the thread communicator
against single-device K1.

The `gpu`-marked tests need a CUDA device and skip without one; on the card
they run with `python -m pytest tests/test_torch_kernels_stats.py -m gpu
--noconftest` (this file imports no JAX). bf16 on the card: o to atol 2e-2
(the kernels and the plain versions round P to bf16 at other places), m to
1e-3 (the same bf16 q, k; other summation orders), l to 1e-4 relative.
"""

import numpy as np
import pytest
import torch

from sparse_videogen_tpu_torch import _kernels
from sparse_videogen_tpu_torch.ops import metadata as MD
from sparse_videogen_tpu_torch.ops.attention import (NEG_INF, block_sparse_attention_kv,
                                                     block_sparse_attention_kv_plain, block_sparse_attention_runs,
                                                     block_sparse_attention_runs_plain)
from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec, apply_mask_spec


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on the card")
    return torch.device("cuda")


FS, NF = 320, 6  # S = 1920, frames not a multiple of a 128-token tile
S = FS * NF
DUAL = (MaskSpec(kind="band_sink", band_width=700, sink_size=FS),
        MaskSpec(kind="band_sink_perm", band_width=700, sink_size=FS, frame_size=FS, num_frames=NF))


def _check(got, ref):
    (o, m, l), (ro, rm, rl) = got, ref
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=0)
    dead = rm <= 0.5 * NEG_INF
    assert torch.equal(m <= 0.5 * NEG_INF, dead) and bool((l[dead] == 0).all())
    torch.testing.assert_close(m[~dead], rm[~dead], atol=1e-3, rtol=0)
    assert ((l - rl).abs().max() / rl.abs().max()).item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["none", "band_sink", "hyvideo", "cog", "dual"])
@pytest.mark.parametrize("D_", [64, 128])
def test_chunked_stats_and_dual_match_plain(cuda, kind, D_):
    """K1 with the stats in every kind and with the dual spec (heads 1, 2
    temporal), a q block that sees nothing, a kv tail of padding, aux
    offsets: (o, m, l) against the plain version; o equals o without the
    stats bit for bit; the dual spec counts as band_sink_perm. The dual
    kernel's temporal heads attend every pair band_sink_perm allows (their
    slab metadata), so their plain metadata rows are the exact block
    skeleton of the mask; the spatial heads keep the rows above."""
    gen = torch.Generator(device=cuda).manual_seed(D_)
    BH, bq = 4, 128
    Sp = -(-S // 128) * 128
    q, k, v = (torch.randn(BH, Sp, D_, generator=gen, device=cuda).to(torch.bfloat16) for _ in range(3))
    bm = np.ones((1, Sp // bq, Sp // 128), bool)
    bm[0, 1] = False
    meta = torch.as_tensor(MD.chunk_meta_np(bm, MD.kv_counts_for_seq(S - 50, Sp), block_kv=256), device=cuda)
    if kind == "dual":
        x = torch.arange(S)
        allowed = apply_mask_spec(DUAL[1], x[:, None], x[None, :], None).reshape(S // bq, bq, S // 128, 128)
        skel = MD.chunk_meta_np(allowed.any(3).any(1).numpy()[None], MD.kv_counts_for_seq(S, Sp), block_kv=256)
        L = max(skel.shape[-1], meta.shape[-1])
        rows = [np.pad(m, ((0, 0), (0, 0), (0, L - m.shape[-1]))) for m in (meta.cpu().numpy(), skel)]
        meta = torch.as_tensor(np.concatenate([rows[0], rows[1], rows[1], rows[0]]), device=cuda)
    spec = {"none": MaskSpec(), "band_sink": DUAL[0], "hyvideo": MaskSpec("hyvideo", 512, video_len=1700),
            "cog": MaskSpec("cog", 512), "dual": DUAL}[kind]
    head = [1700 if kind == "hyvideo" else 100, 0, 3 if kind == "band_sink" else 0, 0]
    aux = torch.tensor(head + ([0, 1, 1, 0] if kind == "dual" else []), dtype=torch.int32, device=cuda)
    kw = dict(block_q=bq, block_kv=256, mask_spec=spec)
    _kernels.reset_counts()
    got = block_sparse_attention_kv(q, k, v, meta, aux, return_stats=True, **kw)
    o = block_sparse_attention_kv(q, k, v, meta, aux, **kw)
    key = "band_sink_perm" if kind == "dual" else kind
    assert _kernels.KIND_LAUNCHES[f"block_sparse_attn[{key}]"] == 2
    assert _kernels.KIND_LAUNCHES["block_sparse_attn[stats]"] == 1 and not any(_kernels.PLAIN_CALLS.values())
    assert torch.equal(o, got[0])
    _check(got, block_sparse_attention_kv_plain(q, k, v, meta, aux, return_stats=True, **kw))


@pytest.mark.gpu
def test_dual_refuses_temporal_rows_with_a_hole(cuda):
    """The dual kernel reads a temporal head's mask from its slab metadata,
    so the wrapper refuses, before any launch, a temporal head whose rows
    would make the plain version attend other pairs: a q block that sees
    nothing and a kv tail left out (the rows above). The same rows on
    spatial heads run, and non-zero aux[2:4] offsets raise."""
    Sp = -(-S // 128) * 128
    q, k, v = (torch.randn(4, Sp, 64, device=cuda).to(torch.bfloat16) for _ in range(3))
    bm = np.ones((1, Sp // 128, Sp // 128), bool)
    bm[0, 1] = False
    meta = torch.as_tensor(MD.chunk_meta_np(bm, MD.kv_counts_for_seq(S - 50, Sp), block_kv=256), device=cuda)
    kw = dict(block_q=128, block_kv=256, mask_spec=DUAL)
    _kernels.reset_counts()
    with pytest.raises(ValueError, match=r"temporal heads \[1, 2\]"):
        block_sparse_attention_kv(q, k, v, meta, torch.tensor([100, 0, 0, 0, 0, 1, 1, 0], dtype=torch.int32,
                                                              device=cuda), **kw)
    assert not any(_kernels.KIND_LAUNCHES.values())
    with pytest.raises(ValueError, match="offsets"):
        block_sparse_attention_kv(q, k, v, meta, torch.tensor([100, 0, 0, 5, 0, 0, 0, 0], dtype=torch.int32,
                                                              device=cuda), **kw)
    block_sparse_attention_kv(q, k, v, meta, torch.tensor([100, 0, 0, 0, 0, 0, 0, 0], dtype=torch.int32,
                                                          device=cuda), **kw)
    assert _kernels.KIND_LAUNCHES["block_sparse_attn[band_sink_perm]"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [MaskSpec(), MaskSpec(kind="band_sink", band_width=300, sink_size=200)],
                         ids=["none", "band_sink"])
@pytest.mark.parametrize("D_", [64, 128])
def test_runs_stats_match_plain(cuda, spec, D_):
    """K3 (mask none) and K4 (band_sink) with the stats on random run lists,
    an empty q block: (o, m, l) against the plain version, o bit for bit
    the kernel's without stats."""
    rng = np.random.default_rng(D_)
    BH, C, Skv_real, bq, bkv = 3, 9, 1500, 128, 256
    sizes = np.tile(rng.multinomial(Skv_real, np.ones(C) / C).astype(np.int32), (BH, 1))
    starts = (np.cumsum(sizes, axis=1) - sizes).astype(np.int32)
    sel = rng.random((BH, 4, C)) < 0.4
    sel[:, 1] = False
    meta = torch.as_tensor(MD.run_meta_np(sel, starts, sizes, block_kv=bkv, cap=C), device=cuda)
    Skv = -(-Skv_real // 128) * 128
    q, k, v = (torch.randn(BH, n, D_, device=cuda).to(torch.bfloat16) for n in (4 * bq, Skv, Skv))
    aux = torch.tensor([0, 0, 5, 9], dtype=torch.int32, device=cuda)
    kw = dict(block_q=bq, block_kv=bkv, mask_spec=spec)
    got = block_sparse_attention_runs(q, k, v, meta, aux, return_stats=True, **kw)
    assert torch.equal(got[0], block_sparse_attention_runs(q, k, v, meta, aux, **kw))
    _check(got, block_sparse_attention_runs_plain(q, k, v, meta, aux, return_stats=True, **kw))


@pytest.mark.gpu
def test_dense_ring_threads_match_single_device(cuda):
    """RingDenseRuntime with 2 ranks as threads on the card against the
    single-device dense runtime (K1), bf16: atol 2e-2 (each rotation's output
    rounds to bf16 before the f32 merge)."""
    from sparse_videogen_tpu_torch.config import VideoLayout
    from sparse_videogen_tpu_torch.parallel.comm import ThreadRanks
    from sparse_videogen_tpu_torch.parallel.ring_runtime import RingDenseRuntime
    from sparse_videogen_tpu_torch.sparse.runtimes import DenseRuntime
    from sparse_videogen_tpu_torch.sparse.svg1 import make_svg1_plan

    plan = make_svg1_plan(VideoLayout(num_frames=NF, frame_size=FS), block_q=256, block_kv=512)
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 2, S, 128, generator=gen, device=cuda).to(torch.bfloat16) for _ in range(3))
    _kernels.reset_counts()
    out = RingDenseRuntime(plan, ThreadRanks(2), device=cuda)(q, k, v, 900.0, 0)
    assert _kernels.KIND_LAUNCHES["block_sparse_attn[stats]"] == 4
    ref = DenseRuntime(plan, device=cuda)(q, k, v, 900.0, 0)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
