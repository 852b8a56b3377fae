"""SAP's force_density in the torch port against the JAX package: the
dynamic map pinned to the first ceil(f KC) key clusters (tile mode: key
tiles) of every query cluster, in cluster mode (run lists, K3) and tile
mode (chunked CSR, K1 kind none), at f = 0.25 and 1.0. One cold sparse
branch per case, JAX's k-means draws handed to the port, the same numpy
inputs to both (JAX's Pallas kernels in interpret mode, the port's plain
versions). Each side's map (the argument of density_calculation) and
kernel metadata are caught where the kernel is called: the map, the
per-head density and the metadata must be equal; the f32 outputs within
the SAP parity files' tolerances (atol 1e-5 as tests/test_torch_sap.py,
rel L2 1e-5 as tests/test_torch_sap_tile.py)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.sparse import svg2 as J2
from sparse_videogen_tpu_torch import _kernels
from sparse_videogen_tpu_torch.config import SAPConfig, VideoLayout
from sparse_videogen_tpu_torch.sparse import svg2 as T2

t = lambda a: torch.from_numpy(np.array(a))


def clustered(rng, BH, S, D, n_centers=6, spread=0.3):
    centers = rng.standard_normal((BH, n_centers, D))
    pick = rng.integers(0, n_centers, (BH, S))
    x = np.take_along_axis(centers, pick[..., None], axis=1) + spread * rng.standard_normal((BH, S, D))
    return x.astype(np.float32)


def _spy(monkeypatch, module, name, caught, on_jax=False):
    """Wrap module.name so that its positional arguments land in
    caught[name] (JAX's under jit: a host callback when the program runs)."""
    fn = getattr(module, name)

    def spy(*args, **kw):
        if on_jax:
            jax.debug.callback(lambda *xs: caught.__setitem__(name, [np.asarray(x) for x in xs]), *args)
        else:
            caught[name] = args
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("force", [0.25, 1.0])
@pytest.mark.parametrize("mode", ["cluster", "tile"])
def test_force_density_matches_jax(monkeypatch, mode, force):
    lay = VideoLayout(num_frames=4, frame_size=200)
    cfg = SAPConfig(num_q_centroids=6, num_k_centroids=10, top_p_kmeans=0.6, kmeans_iter_init=6, block_q=128,
                    block_kv=128, block_mode=mode, force_density=force)
    T2.check_sap_config(cfg, lay)  # no longer refused
    jcfg = JC.SAPConfig(**dataclasses.asdict(cfg))
    jlay = JC.VideoLayout(num_frames=4, frame_size=200)
    H, D, S = 2, 64, lay.seq_len
    rng = np.random.default_rng(int(100 * force))
    q, k, v = (clustered(rng, H, S, D)[None] for _ in range(3))
    key = jax.random.PRNGKey(3)
    kernel = "block_sparse_attention_kv" if mode == "tile" else "block_sparse_attention_runs"

    jax_caught, port_caught = {}, {}
    _spy(monkeypatch, J2, "density_calculation", jax_caught, on_jax=True)
    _spy(monkeypatch, J2, kernel, jax_caught, on_jax=True)
    # a jit of its own, so that this program is traced with the spies in place
    jax_sap = jax.jit(J2.sap_sparse_attention.__wrapped__, static_argnames=("layout", "cfg"))
    jo, js = jax_sap(*(jnp.asarray(a) for a in (q, k, v)), J2.init_sap_state(H, D, jcfg), key, layout=jlay, cfg=jcfg)
    jax.block_until_ready(jo)
    _spy(monkeypatch, T2, "density_calculation", port_caught)
    _spy(monkeypatch, T2, kernel, port_caught)
    rq, rk = jax.random.split(key)
    draws = (t(jax.random.randint(rq, (H, cfg.num_q_centroids), 0, S)),
             t(jax.random.randint(rk, (H, cfg.num_k_centroids), 0, S)))
    _kernels.reset_counts()
    to, ts = T2.sap_sparse_attention(t(q), t(k), t(v), T2.init_sap_state(H, D, cfg), layout=lay, cfg=cfg,
                                     init_idx=draws)
    assert _kernels.PLAIN_CALLS["block_sparse_attn" if mode == "tile" else "block_sparse_attn_runs"] == 1

    KC = cfg.num_k_centroids if mode == "cluster" else -(-S // cfg.block_kv)
    jmap, tmap = jax_caught["density_calculation"][0], port_caught["density_calculation"][0].numpy()
    want = np.broadcast_to(np.arange(KC) < math.ceil(force * KC), jmap.shape)
    np.testing.assert_array_equal(jmap, want)
    np.testing.assert_array_equal(tmap, jmap)
    np.testing.assert_array_equal(ts.last_density.numpy(), np.asarray(js.last_density))
    if force == 1.0:
        np.testing.assert_array_equal(ts.last_density.numpy(), np.ones(H, np.float32))
    else:
        assert float(ts.last_density.max()) < 0.5
    # the kernels' arguments: (qp, kv, meta) in JAX, (q, k, v, meta) in the port
    np.testing.assert_array_equal(port_caught[kernel][3].numpy(), jax_caught[kernel][2])
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    rel = np.linalg.norm(to.numpy().astype(np.float64) - np.asarray(jo, np.float64)) / np.linalg.norm(
        np.asarray(jo, np.float64))
    assert rel <= 1e-5
