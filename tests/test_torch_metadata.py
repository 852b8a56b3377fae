"""Metadata and mask predicates of the torch port against the JAX package.

The port's numpy metadata functions must produce the SAME int32 arrays as the JAX
package's (the Hopper kernel reads them), so every comparison here is exact.
"""

import numpy as np
import pytest
import torch

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.ops import mask_spec as JMS
from sparse_videogen_tpu.ops import metadata as JMD
from sparse_videogen_tpu.sparse import runtimes as JRT
from sparse_videogen_tpu.sparse import svg1 as JS1
from sparse_videogen_tpu_torch import config as TC
from sparse_videogen_tpu_torch.ops import mask_spec as TMS
from sparse_videogen_tpu_torch.ops import metadata as TMD
from sparse_videogen_tpu_torch.sparse import runtimes as TRT
from sparse_videogen_tpu_torch.sparse import svg1 as TS1

SPECS = [
    TMS.MaskSpec(),
    TMS.MaskSpec(kind="band_sink", band_width=257, sink_size=100),
    TMS.MaskSpec(kind="band_sink_perm", band_width=129, sink_size=64, frame_size=64, num_frames=5),
    TMS.MaskSpec(kind="hyvideo", band_width=256, video_len=320),
    TMS.MaskSpec(kind="cog", band_width=128),
]
AUX = np.asarray([350, 0, 7, 3], np.int32)  # aux[0] prompt scalar, aux[2:4] global offsets


def _jspec(spec):
    return JMS.MaskSpec(**{f: getattr(spec, f) for f in spec.__dataclass_fields__})


@pytest.mark.parametrize("bkv", [128, 256, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_meta_np_equal(seed, bkv):
    rng = np.random.default_rng(seed)
    R, nQ, nsub = 2, 5, 9
    mask = rng.random((R, nQ, nsub)) < 0.5
    counts = rng.integers(0, 129, size=(R, nsub)).astype(np.int32)
    counts[:, ::3] = 128  # long runs too, not only partial sub-blocks
    np.testing.assert_array_equal(
        TMD.chunk_meta_np(mask, counts, block_kv=bkv), JMD.chunk_meta_np(mask, counts, block_kv=bkv))
    # a cap shorter than the longest row truncates identically
    np.testing.assert_array_equal(
        TMD.chunk_meta_np(mask, counts, block_kv=bkv, cap=2), JMD.chunk_meta_np(mask, counts, block_kv=bkv, cap=2))


@pytest.mark.parametrize("seq_real,seq_pad", [(300, None), (300, 512), (384, 384), (1, 128)])
def test_kv_counts_and_dense_meta_equal(seq_real, seq_pad):
    np.testing.assert_array_equal(TMD.kv_counts_for_seq(seq_real, seq_pad), JMD.kv_counts_for_seq(seq_real, seq_pad))
    for bq, bkv in ((128, 128), (256, 256), (128, 512)):
        sk = max(seq_pad or seq_real, bkv)
        np.testing.assert_array_equal(TMD.dense_meta(seq_real, sk, block_q=bq, block_kv=bkv),
                                      JMD.dense_meta(seq_real, sk, block_q=bq, block_kv=bkv))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.kind)
def test_classify_cheap_equal(spec):
    rng = np.random.default_rng(3)
    S, bq, bkv = 640, 128, 256
    mask = rng.random((1, S // bq, S // 128)) < 0.7
    meta = TMD.chunk_meta_np(mask, TMD.kv_counts_for_seq(S - 37, S), block_kv=bkv)
    for seq_q in (None, S - 200):
        ours = TMD.classify_cheap_np(meta, spec, AUX, block_q=bq, block_kv=bkv, seq_q=seq_q)
        ref = JMD.classify_cheap_np(meta, _jspec(spec), AUX, block_q=bq, block_kv=bkv, seq_q=seq_q)
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(TMD.decode_meta(ours, block_kv=bkv, seq_kv=S),
                                      JMD.decode_meta(ref, block_kv=bkv, seq_kv=S))


@pytest.mark.parametrize("spec", SPECS[1:], ids=lambda s: s.kind)
def test_apply_mask_spec_and_full_block_allowed_equal(spec):
    qpos = torch.arange(0, 420)[:, None]
    kpos = torch.arange(0, 400)[None, :]
    ours = TMS.apply_mask_spec(spec, qpos, kpos, torch.as_tensor(AUX)).numpy()
    ref = np.asarray(JMS.apply_mask_spec(_jspec(spec), qpos.numpy(), kpos.numpy(), AUX))
    np.testing.assert_array_equal(ours, ref)
    rng = np.random.default_rng(4)
    q0 = rng.integers(0, 400, (64, 1))
    k0 = rng.integers(0, 400, (1, 64))
    q1, k1 = q0 + rng.integers(0, 200, q0.shape), k0 + rng.integers(0, 200, k0.shape)
    np.testing.assert_array_equal(TMS.full_block_allowed(spec, q0, q1, k0, k1, AUX),
                                  np.asarray(JMS.full_block_allowed(_jspec(spec), q0, q1, k0, k1, AUX)))
    assert TMS.apply_mask_spec(TMS.MaskSpec(), qpos, kpos, None) is None


# (num_frames, frame_size); each package builds its own VideoLayout from them
LAYOUTS = [
    (3, 100),  # S = 300: not a multiple of 128
    (4, 96),  # S = 384: block_kv clamped to 384
    (5, 200),  # S = 1000
    (2, 60),  # S = 120: one padded sub-block, block_kv clamped to 128
    (6, 1560),  # S = 9360: default block_q 1024, dense block_q 2048
]


@pytest.mark.parametrize("lay", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}+0")
@pytest.mark.parametrize("bq", [None, 128])
def test_svg1_plan_metadata_equal(lay, bq):
    ours = TS1.make_svg1_plan(TC.VideoLayout(*lay), TC.SVGConfig(sparsity=0.3), block_q=bq, block_kv=512)
    ref = JS1.make_svg1_plan(JC.VideoLayout(*lay), JC.SVGConfig(sparsity=0.3), block_q=bq, block_kv=512)
    assert (ours.block_q, ours.block_kv, ours.seq_pad_q, ours.seq_pad_kv, ours.multiplier) == (
        ref.block_q, ref.block_kv, ref.seq_pad_q, ref.seq_pad_kv, ref.multiplier)
    assert ours.dense_block_q == ref.dense_exec[0]
    assert ours.mask_spec == TMS.MaskSpec(**vars(ref.mask_spec))
    assert ours.dense_mask_spec == TMS.MaskSpec(**vars(ref.dense_mask_spec))
    np.testing.assert_array_equal(ours.default_aux(), np.asarray(ref.default_aux()))
    np.testing.assert_array_equal(ours.sparse_meta(), np.asarray(ref.sparse_meta()))
    np.testing.assert_array_equal(ours.dense_meta(), np.asarray(ref.dense_meta()))
    # the runtimes' cheap-first metadata (what the kernel is launched with)
    for (spec_o, meta_o, bq_o), (spec_r, meta_r, bq_r) in (
        ((ours.mask_spec, ours.sparse_meta(), ours.block_q), (ref.mask_spec, ref.sparse_meta(), ref.block_q)),
        ((ours.dense_mask_spec, ours.dense_meta(), ours.dense_block_q),
         (ref.dense_mask_spec, ref.dense_meta(), ref.dense_exec[0])),
    ):
        np.testing.assert_array_equal(TRT._classified(meta_o, spec_o, ours, None, bq_o),
                                      np.asarray(JRT._classified(meta_r, spec_r, ref, None, bq_r)))


@pytest.mark.parametrize("pos", [JC.TextPosition.LAST, JC.TextPosition.FIRST])
def test_svg1_plan_rejects_text_in_sequence(pos):
    """A layout with text tokens never silently gets Wan's band+sink mask:
    text last (HunyuanVideo) gets the hyvideo plan and text first (CogVideoX)
    the cog plan, as in the JAX package."""
    kw = dict(num_frames=2, frame_size=60, context_length=40)
    ref = JS1.make_svg1_plan(JC.VideoLayout(text_position=pos, **kw), JC.SVGConfig(sparsity=0.3))
    lay = TC.VideoLayout(text_position=TC.TextPosition(pos.value), **kw)
    ours = TS1.make_svg1_plan(lay, TC.SVGConfig(sparsity=0.3))
    assert ours.mask_kind == ref.mask_kind == ("hyvideo" if pos == JC.TextPosition.LAST else "cog")
    assert ours.mask_spec == TMS.MaskSpec(**vars(ref.mask_spec))
    np.testing.assert_array_equal(ours.default_aux(), np.asarray(ref.default_aux()))
