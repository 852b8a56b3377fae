"""The (m, l) softmax stats of the port's attention (`return_stats=True`)
against the JAX package's.

The plain versions (what a CPU tensor runs) of the chunked-CSR attention
(K1: every mask kind, and placement-free SVG1's dual per-head spec) and of
the run-list attention (K3: mask none; K4: its MaskSpec path) are held to the
JAX Pallas kernels in interpret mode on the same f32 inputs and metadata,
with a q block that sees no live column (m keeps the NEG_INF sentinel, l is
0, o is 0). Both run the same online softmax over the same chunks and differ
by f32 summation order and, for K4 (the JAX kernel runs in the natural exp
domain, the port in exp2 with m divided by log2 e), by a rounding of m:
o and m to atol 1e-5, l to rtol 1e-5, sentinels equal.

The Hopper kernels' stats against these plain versions: chip_smoke.py and
tests/test_torch_kernels.py (gpu).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu.ops import attention as JA
from sparse_videogen_tpu.ops import mask_spec as JMS
from sparse_videogen_tpu.ops import metadata as JMD
from sparse_videogen_tpu_torch.ops import metadata as MD
from sparse_videogen_tpu_torch.ops.attention import (NEG_INF, block_sparse_attention_kv,
                                                     block_sparse_attention_runs)
from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec

ATOL, RTOL_L = 1e-5, 1e-5
BH, D, S, BQ = 2, 64, 512, 128
FS, NF = 64, 8  # the dual spec's frames: S = NF * FS
t = lambda a: torch.from_numpy(np.ascontiguousarray(a))

KINDS = {
    "none": (MaskSpec(), [0, 0, 0, 0]),
    "band_sink": (MaskSpec(kind="band_sink", band_width=150, sink_size=64), [0, 0, 3, 5]),
    "hyvideo": (MaskSpec(kind="hyvideo", band_width=128, video_len=400), [440, 0, 0, 0]),
    "cog": (MaskSpec(kind="cog", band_width=128), [60, 0, 0, 0]),
    "dual": ((MaskSpec(kind="band_sink", band_width=150, sink_size=FS),
              MaskSpec(kind="band_sink_perm", band_width=150, sink_size=FS, frame_size=FS, num_frames=NF)),
             [0, 0, 0, 0, 0, 1]),
}


def _jspec(spec):
    return tuple(_jspec(s) for s in spec) if isinstance(spec, tuple) else JMS.MaskSpec(**vars(spec))


def _check(ours, ref, dead):
    """ours, ref: (o, m, l); dead: the q rows that see no live column."""
    o, m, l = (x.numpy() for x in ours)
    ro, rm, rl = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(o, ro, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(m <= 0.5 * NEG_INF, rm <= 0.5 * NEG_INF)
    assert np.all(m[:, dead] == NEG_INF) and np.all(l[:, dead] == 0) and np.all(o[:, dead] == 0)
    live = rm > 0.5 * NEG_INF
    np.testing.assert_allclose(m[live], rm[live], atol=ATOL, rtol=0)
    np.testing.assert_allclose(l, rl, rtol=RTOL_L, atol=0)


@pytest.mark.parametrize("kind", list(KINDS))
def test_chunked_stats_match_jax(kind):
    spec, aux = KINDS[kind]
    rng = np.random.default_rng(len(kind))
    q = rng.standard_normal((BH, S, D)).astype(np.float32) * 2
    k, v = (rng.standard_normal((BH, S, D)).astype(np.float32) for _ in range(2))
    mask = rng.random((1, S // BQ, S // MD.SUB)) < 0.7
    mask[:, 1] = False  # q block 1 visits nothing
    meta = MD.chunk_meta_np(mask, MD.kv_counts_for_seq(S - 40, S), block_kv=256)
    aux = np.asarray(aux, np.int32)
    kw = dict(block_q=BQ, block_kv=256)
    ours = block_sparse_attention_kv(t(q), t(k), t(v), t(meta), t(aux), mask_spec=spec, return_stats=True, **kw)
    ref = JA.block_sparse_attention_kv(jnp.asarray(q), JA.pack_kv(jnp.asarray(k), jnp.asarray(v)),
                                       jnp.asarray(meta), jnp.asarray(aux), mask_spec=_jspec(spec),
                                       return_stats=True, **kw)
    _check(ours, ref, slice(BQ, 2 * BQ))
    o_only = block_sparse_attention_kv(t(q), t(k), t(v), t(meta), t(aux), mask_spec=spec, **kw)
    assert torch.equal(o_only, ours[0])


@pytest.mark.parametrize("mask", ["none", "band_sink"])
def test_runs_stats_match_jax(mask):
    """K3 (mask none: JAX's expand kernel) and K4 (band_sink: its in-loop
    walk), run lists over 9 clusters with an empty one, aux offsets."""
    rng = np.random.default_rng(11)
    C, Skv_real, bkv = 9, 900, 256
    w = rng.random(C)
    w[4] = 0.0
    sizes = np.floor(w / w.sum() * Skv_real).astype(np.int32)
    sizes[np.argmax(sizes)] += Skv_real - sizes.sum()
    sizes = np.tile(sizes, (BH, 1))
    starts = np.concatenate([np.zeros((BH, 1), np.int32), np.cumsum(sizes, axis=1)[:, :-1]], axis=1).astype(np.int32)
    sel = rng.random((BH, S // BQ, C)) < 0.45
    sel[:, 1] = False
    meta = JMD.run_meta_np(sel, starts, sizes, block_kv=bkv, cap=C)
    Skv = -(-Skv_real // 128) * 128
    q = rng.standard_normal((BH, S, D)).astype(np.float32) * 2
    k, v = (rng.standard_normal((BH, Skv, D)).astype(np.float32) for _ in range(2))
    spec = MaskSpec() if mask == "none" else MaskSpec(kind="band_sink", band_width=300, sink_size=100)
    aux = np.asarray([0, 0, 40, 7], np.int32)
    kw = dict(block_q=BQ, block_kv=bkv)
    ours = block_sparse_attention_runs(t(q), t(k), t(v), t(meta), t(aux), mask_spec=spec, return_stats=True, **kw)
    ref = JA.block_sparse_attention_runs(jnp.asarray(q), JA.pack_kv(jnp.asarray(k), jnp.asarray(v)),
                                         jnp.asarray(meta), jnp.asarray(aux), mask_spec=_jspec(spec),
                                         return_stats=True, **kw)
    _check(ours, ref, slice(BQ, 2 * BQ))


def test_dual_spec_and_stats_dispatch_on_cpu():
    """CPU tensors run the plain versions, with or without the stats (o the
    same either way); a pair that is not (band_sink, band_sink_perm) with
    one band and sink raises."""
    from sparse_videogen_tpu_torch import _kernels

    rng = np.random.default_rng(3)
    q, k, v = (t(rng.standard_normal((BH, S, D)).astype(np.float32)) for _ in range(3))
    meta = t(MD.dense_meta(S, S, block_q=BQ, block_kv=256))
    spec, aux = KINDS["dual"]
    aux = t(np.asarray(aux, np.int32))
    _kernels.reset_counts()
    o, m, l = block_sparse_attention_kv(q, k, v, meta, aux, block_q=BQ, block_kv=256, mask_spec=spec,
                                        return_stats=True)
    assert torch.equal(o, block_sparse_attention_kv(q, k, v, meta, aux, block_q=BQ, block_kv=256, mask_spec=spec))
    assert m.shape == l.shape == (BH, S) and _kernels.PLAIN_CALLS["block_sparse_attn"] == 2
    assert _kernels.LAUNCHES["block_sparse_attn"] == 0 and not _kernels.KIND_LAUNCHES
    bad = (spec[0], MaskSpec(kind="band_sink_perm", band_width=151, sink_size=FS, frame_size=FS, num_frames=NF))
    with pytest.raises(ValueError):
        block_sparse_attention_kv(q, k, v, meta, aux, block_q=BQ, block_kv=256, mask_spec=bad)
