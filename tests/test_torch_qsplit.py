"""K7 (dense attention with q-split sub-tiles) of the torch port against the
JAX package's TPU probe kernel.

The port's plain version (what a CPU tensor runs) is held against
scripts/bench_qsplit.py::_kernel run through pl.pallas_call in interpret
mode with dense_attn's specs (bench_qsplit.py:91-105), built here; K and V
packed into [K|V] rows for the JAX side. Both run the same natural-exp
online softmax over the same bkv chunks. The Hopper kernel against the plain
version: tests/test_torch_kernels.py.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sparse_videogen_tpu_torch import _kernels
from sparse_videogen_tpu_torch.ops.dense_qsplit import KERNEL_CONFIGS, dense_attn, dense_attn_plain, unfit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench_qsplit():
    spec = importlib.util.spec_from_file_location("bench_qsplit", os.path.join(ROOT, "scripts", "bench_qsplit.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_dense_attn(q, k, v, *, bq, bkv, qsplit, nbuf=2):
    """bench_qsplit.dense_attn's pallas_call, in interpret mode."""
    kern_fn = _bench_qsplit()._kernel
    kv = jnp.concatenate([jnp.asarray(k), jnp.asarray(v)], axis=-1)
    BH, S, D = q.shape
    kern = functools.partial(kern_fn, bq=bq, bkv=bkv, D=D, nkv=S // bkv, nbuf=nbuf, qsplit=qsplit, scale=D ** -0.5)
    out = pl.pallas_call(
        kern,
        grid=(BH, S // bq),
        in_specs=[
            pl.BlockSpec((1, bq, D), lambda b, i: (b, i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((1, bq, D), lambda b, i: (b, i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((BH, S, D), q.dtype),
        scratch_shapes=[pltpu.VMEM((nbuf, bkv, 2 * D), kv.dtype), pltpu.SemaphoreType.DMA((nbuf,))],
        interpret=True,
    )(jnp.asarray(q), kv)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_probe_kernel(dtype):
    """(1, 512, 128), bq 256, bkv 128, qsplit 2. f32: the same arithmetic in
    another summation order, atol 1e-5 on outputs of size ~1. bf16: both
    round q_s and P to bf16, but XLA:CPU and PyTorch round the bf16 products'
    sums at other places: atol 2e-2 (a few bf16 ulps at |out| ~ 1)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 512, 128)).astype(np.float32) * sc for sc in (2.0, 1.0, 1.0))
    jd = getattr(jnp, dtype)
    ref = _jax_dense_attn(*(jnp.asarray(a).astype(jd) for a in (q, k, v)), bq=256, bkv=128, qsplit=2)
    td = getattr(torch, dtype)
    _kernels.reset_counts()
    ours = dense_attn(*(torch.from_numpy(a).to(td) for a in (q, k, v)), bq=256, bkv=128, qsplit=2)
    assert _kernels.PLAIN_CALLS["dense_qsplit"] == 1 and not any(_kernels.LAUNCHES.values())
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=1e-5 if dtype == "float32" else 2e-2, rtol=0)
    # and both are softmax attention
    s = (q[0].astype(np.float64) @ k[0].astype(np.float64).T) / np.sqrt(128)
    p = np.exp(s - s.max(-1, keepdims=True))
    exact = (p / p.sum(-1, keepdims=True)) @ v[0]
    assert np.abs(ref[0] - exact).max() <= (1e-4 if dtype == "float32" else 5e-2)


@pytest.mark.parametrize("bq,qsplit", [(64, 1), (128, 2)])
def test_plain_is_independent_of_q_tiling(bq, qsplit):
    """Rows are independent: the plain version's q blocks and sub-tiles do
    not change its result (f32, exact), and the chunk size only moves f32
    roundings."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 256, 64, generator=g) for _ in range(3))
    ref = dense_attn_plain(q, k, v, bq=256, bkv=128, qsplit=1)
    torch.testing.assert_close(dense_attn_plain(q, k, v, bq=bq, bkv=128, qsplit=qsplit), ref, atol=0, rtol=0)
    torch.testing.assert_close(dense_attn_plain(q, k, v, bq=bq, bkv=64, qsplit=qsplit), ref, atol=1e-5, rtol=0)


def test_shapes_and_configs():
    q = torch.zeros(1, 384, 64)
    with pytest.raises(ValueError):  # S not a multiple of bq
        dense_attn(q, q, q, bq=256, bkv=128)
    with pytest.raises(ValueError):  # q, k, v of different shapes
        dense_attn(q, q[:, :256], q[:, :256], bq=128, bkv=128)
    assert all(unfit(bq, qs) is None for bq, qs in KERNEL_CONFIGS)
    # the TPU probe's configurations: none fits a Hopper CTA, each for a stated reason
    for bq, qs in ((512, 1), (512, 2), (512, 4), (1024, 4), (2048, 8), (4096, 8)):
        assert unfit(bq, qs) is not None
    assert "shared memory" in unfit(1024, 4) and "registers" in unfit(512, 2)
