"""Block-sparse attention of the torch port against the JAX package.

The port's plain version (what a CPU tensor runs) is held against the JAX
Pallas kernel in interpret mode on the same f32 inputs and metadata. Both
run the same online softmax in the exp2 domain over the same chunks, so they
differ only by f32 summation order: atol 1e-5 on outputs of size ~1.

The Hopper kernel against the plain version: tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu.ops import attention as JA
from sparse_videogen_tpu.ops import mask_spec as JMS
from sparse_videogen_tpu_torch.ops import metadata as MD
from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_kv
from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec

ATOL = 1e-5
BH, D = 3, 64


def _inputs(rng, sq, skv, dtype=np.float32):
    q = rng.standard_normal((BH, sq, D)).astype(dtype) * 2
    k = rng.standard_normal((BH, skv, D)).astype(dtype)
    v = rng.standard_normal((BH, skv, D)).astype(dtype)
    return q, k, v


def _jax(q, k, v, meta, aux, bq, bkv, spec):
    jspec = JMS.MaskSpec(**vars(spec))
    out = JA.block_sparse_attention_kv(jnp.asarray(q), JA.pack_kv(jnp.asarray(k), jnp.asarray(v)),
                                       jnp.asarray(meta), None if aux is None else jnp.asarray(aux),
                                       block_q=bq, block_kv=bkv, mask_spec=jspec)
    return np.asarray(out)


def _ours(q, k, v, meta, aux, bq, bkv, spec):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return block_sparse_attention_kv(t(q), t(k), t(v), t(meta), None if aux is None else t(aux),
                                     block_q=bq, block_kv=bkv, mask_spec=spec).numpy()


CASES = {
    # dense metadata over a sequence tail: S = 300 real tokens in 384/512 buffers
    "dense_tail": dict(seq=300, sq=384, skv=512, bq=128, bkv=256, spec=MaskSpec(), cheap=False, shared=True),
    # SVG1's band+sink predicate with cheap-first (classified) metadata
    "band_sink_cheap": dict(seq=512, sq=512, skv=512, bq=128, bkv=256,
                            spec=MaskSpec(kind="band_sink", band_width=129, sink_size=64), cheap=True, shared=True),
    # per-head rows (R == BH), random sub-block mask, global offsets in aux
    "band_sink_per_head": dict(seq=640, sq=640, skv=640, bq=128, bkv=384,
                               spec=MaskSpec(kind="band_sink", band_width=200, sink_size=32), cheap=False,
                               shared=False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax(name):
    c = CASES[name]
    rng = np.random.default_rng(len(name))
    q, k, v = _inputs(rng, c["sq"], c["skv"])
    R = 1 if c["shared"] else BH
    nq, nsub = c["sq"] // c["bq"], c["skv"] // MD.SUB
    mask = np.ones((R, nq, nsub), bool) if name == "dense_tail" else rng.random((R, nq, nsub)) < 0.6
    counts = np.repeat(MD.kv_counts_for_seq(c["seq"], c["skv"]), R, axis=0)
    meta = MD.chunk_meta_np(mask, counts, block_kv=c["bkv"])
    aux = np.asarray([0, 0, 5, 2], np.int32) if name == "band_sink_per_head" else None
    if c["cheap"]:
        meta = MD.classify_cheap_np(meta, c["spec"], np.zeros(4, np.int32), block_q=c["bq"], block_kv=c["bkv"],
                                    seq_q=c["seq"])
        assert (meta[..., 0] // MD.N_CHEAP_SCALE).sum() > 0  # the cheap loop is exercised
    args = (meta, aux, c["bq"], c["bkv"], c["spec"])
    ours, ref = _ours(q, k, v, *args), _jax(q, k, v, *args)
    np.testing.assert_allclose(ours[:, :c["seq"]], ref[:, :c["seq"]], atol=ATOL, rtol=0)


def test_masked_rows_output_zero():
    """A q block with no chunk, and rows whose every visited column fails the
    predicate, output exactly 0 in both packages."""
    rng = np.random.default_rng(7)
    S, bq, bkv = 384, 128, 128
    q, k, v = _inputs(rng, S, S)
    mask = np.zeros((1, 3, 3), bool)  # q block 0 visits no chunk
    mask[0, 1, 1] = True  # q block 1: its diagonal sub-block, where the band is live
    mask[0, 2, 0] = True  # q block 2: only kv sub-block 0, which the band excludes
    spec = MaskSpec(kind="band_sink", band_width=2, sink_size=0)
    meta = MD.chunk_meta_np(mask, MD.kv_counts_for_seq(S), block_kv=bkv)
    args = (meta, None, bq, bkv, spec)
    ours, ref = _ours(q, k, v, *args), _jax(q, k, v, *args)
    for out in (ours, ref):
        assert np.all(out[:, :128] == 0) and np.all(out[:, 256:] == 0)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    assert np.abs(ours[:, 128:256]).max() > 0.1
