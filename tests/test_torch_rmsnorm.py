"""K6 (row RMSNorm) of the torch port against the JAX package's Pallas kernel
(sparse_videogen_tpu/ops/rmsnorm_pallas.py, interpret mode).

The port's plain version (what a CPU tensor runs) computes WanRMSNorm: the
f32 mean of squares, rsqrt, cast to the input dtype, then the weight in that
dtype. The Triton kernel against the plain version: tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu.ops.rmsnorm_pallas import rms_norm_pallas
from sparse_videogen_tpu_torch import _kernels
from sparse_videogen_tpu_torch.models.common.layers import rms_norm
from sparse_videogen_tpu_torch.ops.rmsnorm import rms_norm_kernel, rms_norm_plain


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(300, 128), (2, 37, 256)], ids=["rows", "batched"])
def test_plain_matches_pallas(shape, dtype):
    """f32: the same f32 arithmetic, the mean summed in another order: rtol
    1e-6. bf16: the f32 normalised value may round to the neighbouring bf16
    and the weight product rounds again: at most one bf16 ulp of the result
    (rtol 2^-7), on all but a few entries exact."""
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    ref = np.asarray(rms_norm_pallas(jnp.asarray(x).astype(getattr(jnp, dtype)), jnp.asarray(w), 1e-6,
                                     block_rows=64, interpret=True), np.float32)
    _kernels.reset_counts()
    ours = rms_norm_kernel(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w), 1e-6)
    assert _kernels.PLAIN_CALLS["rmsnorm"] == 1 and not any(_kernels.LAUNCHES.values())
    assert ours.dtype == getattr(torch, dtype) and ours.shape == shape
    ours = ours.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(ours, ref, rtol=2.0 ** -7, atol=0)
        assert (ours == ref).mean() >= 0.99


def test_plain_is_the_models_rms_norm():
    x = torch.randn(4, 9, 128).to(torch.bfloat16)
    w = torch.rand(128) + 0.5
    torch.testing.assert_close(rms_norm_plain(x, w, 1e-6), rms_norm(x, w, 1e-6), atol=0, rtol=0)
    with pytest.raises(ValueError):
        rms_norm_kernel(x, w[:64])
