"""The cosine and dot k-means metrics of the torch port (core/kmeans.py
batch_kmeans(metric=)) against the JAX package's: labels and sizes equal on
clustered inputs without near-ties, centroids within 1e-5 (f32 sums in
another order), and SAP in cluster mode with each metric equal to JAX's
within rel L2 1e-5. Neither metric runs in a kernel, in either package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.core import kmeans as JK
from sparse_videogen_tpu.sparse import svg2 as J2
from sparse_videogen_tpu_torch import _kernels
from sparse_videogen_tpu_torch.config import SAPConfig, VideoLayout
from sparse_videogen_tpu_torch.core import kmeans as TK
from sparse_videogen_tpu_torch.sparse import svg2 as T2
from tests.test_torch_sap_tile import clustered, jax_draws, jax_layout, rel_l2, t


@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("iters", [0, 1, 5])
def test_batch_kmeans_metric_matches_jax(metric, iters):
    rng = np.random.default_rng(iters)
    B, N, D, K = 3, 500, 32, 7
    x = clustered(rng, B, N, D, n_centers=K, spread=0.2)
    init = x[:, rng.choice(N, K, replace=False)]
    ref = JK.batch_kmeans(jnp.asarray(x), K, iters, jnp.asarray(init), metric=metric)
    _kernels.reset_counts()
    ours = TK.batch_kmeans(t(x), K, iters, t(init), metric=metric)
    assert _kernels.PLAIN_CALLS["kmeans_wide"] == 0  # the fused pass is Euclid's alone
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]), atol=1e-5, rtol=0)
    if iters:
        np.testing.assert_allclose(np.linalg.norm(ours[1].numpy(), axis=-1), 1.0, atol=1e-5)


def test_unknown_metric_raises():
    x = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="metric"):
        TK.batch_kmeans(x, 2, 1, x[:, :2], metric="manhattan")


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_sap_with_metric_matches_jax(metric):
    """The cluster-mode sparse branch with kmeans_metric cosine or dot, cold
    with JAX's draws: f32 output within rel L2 1e-5, densities equal."""
    lay = VideoLayout(num_frames=3, frame_size=128)
    cfg = SAPConfig(num_q_centroids=5, num_k_centroids=9, top_p_kmeans=0.7, kmeans_iter_init=6, block_q=128,
                    block_kv=256, kmeans_metric=metric)
    jcfg = JC.SAPConfig(**dataclasses.asdict(cfg))
    H, D, S = 2, 64, lay.seq_len
    rng = np.random.default_rng(11)
    q, k, v = (clustered(rng, H, S, D)[None] for _ in range(3))
    key = jax.random.PRNGKey(4)
    jo, js = J2.sap_sparse_attention(*(jnp.asarray(a) for a in (q, k, v)), J2.init_sap_state(H, D, jcfg), key,
                                     layout=jax_layout(lay), cfg=jcfg)
    to, ts = T2.sap_sparse_attention(t(q), t(k), t(v), T2.init_sap_state(H, D, cfg), layout=lay, cfg=cfg,
                                     init_idx=jax_draws(key, H, S, cfg))
    assert rel_l2(to.numpy(), jo) <= 1e-5
    np.testing.assert_allclose(ts.last_density.numpy(), np.asarray(js.last_density), rtol=1e-6)
