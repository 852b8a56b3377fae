"""Interleaved 3-D RoPE of the torch port against the JAX package.

The cos/sin tables are built by the same f64 numpy code and must be equal.
The rotation runs in f32 in both packages; the JAX Pallas kernel evaluates
x*cos + rot*sin_signed from lane tables where the plain versions evaluate
x0*c - x1*s, so they agree to f32 rounding: atol 1e-6 on |x| ~ 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu.models.common import rope as JR
from sparse_videogen_tpu.ops import rope_pallas as JRP
from sparse_videogen_tpu_torch import _kernels
from sparse_videogen_tpu_torch.models.common import rope as TR
from sparse_videogen_tpu_torch.ops.rope import rope_apply

ATOL = 1e-6


@pytest.mark.parametrize("grid,D", [((3, 4, 6), 64), ((2, 5, 4), 128), ((21, 30, 52), 128)])
def test_tables_equal(grid, D):
    for ours, ref in zip(TR.wan_rope_cos_sin(*grid, D), JR.wan_rope_cos_sin(*grid, D)):
        assert ours.dtype == np.float32 and ours.shape == (int(np.prod(grid)), D // 2)
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("D", [64, 128])
def test_rope_matches_jax(D):
    """apply_rope_interleaved (jnp path) and the Pallas kernel (interpret):
    rope_apply_pallas at D=64 (flat-row view) and _rope_direct at D=128."""
    grid = (3, 4, 6) if D == 64 else (2, 5, 4)
    cos, sin = TR.wan_rope_cos_sin(*grid, D)
    S = cos.shape[0]
    x = np.random.default_rng(D).standard_normal((2, 3, S, D)).astype(np.float32)
    ours = TR.apply_rope_interleaved(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin)).numpy()
    ref = np.asarray(JR.apply_rope_interleaved(jnp.asarray(x), cos, sin))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    cos2, sin2 = JRP.expand_cos_sin(cos, sin)
    xf = jnp.asarray(x.reshape(6, S, D))
    entry = JRP.rope_apply_pallas if D < 128 else JRP._rope_direct
    pallas = np.asarray(entry(xf, jnp.asarray(cos2), jnp.asarray(sin2), interpret=True)).reshape(x.shape)
    np.testing.assert_allclose(ours, pallas, atol=ATOL, rtol=0)


def test_cpu_runs_plain_bf16_and_rejects_bad_input():
    """bf16 in, bf16 out, computed in f32 (JAX's contract: output in the
    input dtype); the CPU wrapper takes the plain version."""
    cos, sin = (torch.from_numpy(a) for a in TR.wan_rope_cos_sin(2, 2, 2, 64))
    x = torch.randn(4, 8, 64).to(torch.bfloat16)
    _kernels.reset_counts()
    out = rope_apply(x, cos, sin)
    assert out.dtype == torch.bfloat16 and _kernels.PLAIN_CALLS["rope"] == 1 and _kernels.LAUNCHES["rope"] == 0
    ref = np.asarray(JR.apply_rope_interleaved(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)[None],
                                               cos.numpy(), sin.numpy()))[0]
    # one f32 rounding apart before the bf16 cast: at most one bf16 ulp
    np.testing.assert_allclose(out.float().numpy(), ref.astype(np.float32), atol=0, rtol=2.0**-7)
    with pytest.raises(ValueError):
        rope_apply(x, cos[:4], sin[:4])
