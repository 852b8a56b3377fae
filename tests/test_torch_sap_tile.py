"""SAP's tile mode of the torch port against the JAX package: the tile
pieces (tile_sizes, tile_centroids, tile_quantize), the PC1 orders
(pc1_order, seriate_labels, pc1_relabel, token_pc1_keys), the chunked-CSR
builders on the device (chunk_meta, tile_meta against chunk_meta_jnp and
tile_meta_jnp), the tile-mode sparse branch on video-only layouts (tile
grain equal to block_kv, and below it) and on a text-last layout, and a
2-step Wan pipeline in tile mode. The same numpy inputs go to both packages
(JAX's Pallas kernels in interpret mode, the port's plain versions).
Integer maps, labels and metadata must be equal; f32 attention within rel
L2 1e-5, the pipeline within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.ops import metadata as JMD
from sparse_videogen_tpu.sparse import svg2 as J2
from sparse_videogen_tpu_torch import _kernels
from sparse_videogen_tpu_torch.config import SAPConfig, SVGConfig, TextPosition, VideoLayout
from sparse_videogen_tpu_torch.ops import metadata as TMD
from sparse_videogen_tpu_torch.sparse import svg2 as T2

t = lambda a: torch.from_numpy(np.array(a))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def clustered(rng, BH, S, D, n_centers=6, spread=0.3):
    """Tokens around n_centers random centers (k-means and the top-p maps
    then have structure; random Gaussians give flat maps)."""
    centers = rng.standard_normal((BH, n_centers, D))
    pick = rng.integers(0, n_centers, (BH, S))
    x = np.take_along_axis(centers, pick[..., None], axis=1) + spread * rng.standard_normal((BH, S, D))
    return x.astype(np.float32)


def jax_layout(lay: VideoLayout):
    kw = dataclasses.asdict(lay)
    kw["text_position"] = JC.TextPosition(lay.text_position.value)
    return JC.VideoLayout(**kw)


def jax_draws(key, BH, N, cfg):
    """The cold-start token indices sap_cluster draws from `key` over N tokens."""
    rq, rk = jax.random.split(key)
    return (t(jax.random.randint(rq, (BH, cfg.num_q_centroids), 0, N)),
            t(jax.random.randint(rk, (BH, cfg.num_k_centroids), 0, N)))


def test_tile_pieces_match_jax():
    """tile_sizes exact; tile_quantize's labels, sizes, perm and rank exact on
    labels with many ties (the stable sort of lax.sort_key_val); tile
    centroids within 1e-6 (f32 sums in another order)."""
    rng = np.random.default_rng(0)
    BH, S, D, grain = 3, 300, 16, 64
    n_tiles = -(-S // grain)
    x = rng.standard_normal((BH, S, D)).astype(np.float32)
    lab = rng.integers(0, 7, (BH, S)).astype(np.int32)
    np.testing.assert_array_equal(T2.tile_sizes(S, grain, n_tiles, BH).numpy(),
                                  np.asarray(J2.tile_sizes(S, grain, n_tiles, BH)))
    ref = J2.tile_quantize(jnp.asarray(x), jnp.asarray(lab), grain, n_tiles)
    ours = T2.tile_quantize(t(x), t(lab), grain, n_tiles)
    for i in (0, 1, 3, 4):
        np.testing.assert_array_equal(ours[i].numpy(), np.asarray(ref[i]))
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(ref[2]), rtol=1e-6, atol=1e-6)


def test_pc1_orders_match_jax():
    """pc1_order, seriate_labels and pc1_relabel exact on centroids whose PC1
    keys are well separated (sizes include an empty cluster)."""
    rng = np.random.default_rng(1)
    BH, C, D, N = 2, 9, 16, 200
    axis = rng.standard_normal((BH, 1, D))
    cent = (np.linspace(-4, 4, C)[None, :, None] * axis + 0.05 * rng.standard_normal((BH, C, D))).astype(np.float32)
    cent = cent[:, rng.permutation(C)]
    sizes = rng.integers(1, 40, (BH, C)).astype(np.int32)
    sizes[:, 2] = 0
    lab = rng.integers(0, C, (BH, N)).astype(np.int32)
    dyn = rng.random((BH, 5, C)) < 0.5
    for a, b in zip(T2.pc1_order(t(cent), t(sizes)), J2.pc1_order(jnp.asarray(cent), jnp.asarray(sizes))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(T2.seriate_labels(t(lab), t(cent), t(sizes), C).numpy(),
                                  np.asarray(J2.seriate_labels(jnp.asarray(lab), jnp.asarray(cent),
                                                               jnp.asarray(sizes), C)))
    ours = T2.pc1_relabel(t(dyn), t(lab), t(sizes), t(cent))
    ref = J2.pc1_relabel(jnp.asarray(dyn), jnp.asarray(lab), jnp.asarray(sizes), jnp.asarray(cent))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_token_pc1_keys_match_jax():
    """The keys within 1e-5 of the largest (f32 products summed in another
    order); on tokens spread along one axis the keys' sort orders are equal."""
    rng = np.random.default_rng(2)
    BH, S, D = 2, 256, 32
    axis = rng.standard_normal((BH, 1, D))
    x = (np.linspace(-3, 3, S)[None, :, None] * axis + 0.01 * rng.standard_normal((BH, S, D))).astype(np.float32)
    x = np.take_along_axis(x, rng.permuted(np.tile(np.arange(S), (BH, 1)), axis=1)[..., None], axis=1)
    ours = T2.token_pc1_keys(t(x)).numpy()
    ref = np.asarray(J2.token_pc1_keys(jnp.asarray(x)))
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_array_equal(np.argsort(ours, axis=-1, kind="stable"), np.argsort(ref, axis=-1, kind="stable"))


@pytest.mark.parametrize("block_kv", [128, 256, 512])
def test_chunk_and_tile_meta_match_jax(block_kv):
    """chunk_meta equals chunk_meta_jnp (and the port's chunk_meta_np) on
    random masks with partial and empty sub-blocks and a capped row; tile_meta
    equals tile_meta_jnp and chunk_meta on the mask repeated to sub-blocks."""
    rng = np.random.default_rng(block_kv)
    R, nQ, nsub = 3, 4, 13
    mask = rng.random((R, nQ, nsub)) < 0.6
    counts = np.where(rng.random((R, nsub)) < 0.7, 128, rng.integers(0, 128, (R, nsub))).astype(np.int32)
    for cap in (nsub, 3):
        ours = TMD.chunk_meta(t(mask), t(counts), block_kv=block_kv, cap=cap).numpy()
        np.testing.assert_array_equal(ours, np.asarray(JMD.chunk_meta_jnp(jnp.asarray(mask), jnp.asarray(counts),
                                                                          block_kv=block_kv, cap=cap)))
        np.testing.assert_array_equal(ours, TMD.chunk_meta_np(mask, counts, block_kv=block_kv, cap=cap))
    T, C = 6, block_kv // 128
    n_tok = (T - 1) * block_kv + 77
    nsub = -(-n_tok // 128)
    sel = rng.random((R, nQ, T)) < 0.5
    kw = dict(block_kv=block_kv, n_tokens=n_tok, nsub=nsub, cap=T)
    ours = TMD.tile_meta(t(sel), **kw).numpy()
    np.testing.assert_array_equal(ours, np.asarray(JMD.tile_meta_jnp(jnp.asarray(sel), **kw)))
    sub = np.repeat(sel, C, axis=-1)[..., :nsub]
    np.testing.assert_array_equal(ours, TMD.chunk_meta(t(sub), t(np.repeat(TMD.kv_counts_for_seq(n_tok), R, 0)),
                                                       block_kv=block_kv, cap=T).numpy())


TEXT_LAST = dict(context_length=24, text_position=TextPosition.LAST, prompt_length=10)
TILE_CASES = {
    "grain_eq_bkv": (dict(num_frames=4, frame_size=200), dict(block_q=128, block_kv=128)),
    "grain_lt_bkv": (dict(num_frames=4, frame_size=200), dict(block_q=128, block_kv=256, tile_grain=128)),
    "pc1_keys": (dict(num_frames=4, frame_size=200), dict(block_q=128, block_kv=128, tile_order="pc1")),
    "text_last": (dict(num_frames=4, frame_size=200, **TEXT_LAST), dict(block_q=128, block_kv=128)),
    "text_last_grain_lt_bkv": (dict(num_frames=4, frame_size=200, **TEXT_LAST),
                               dict(block_q=128, block_kv=256, tile_grain=128)),
}


@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tile_sap_matches_jax(case):
    """The tile-mode sparse branch cold (JAX's draws handed in) and then warm:
    outputs within rel L2 1e-5 (f32), densities within 1e-6 and below 1 (the
    map is sparse), the bf16 centroids equal; the kernel arguments go to the
    chunked-CSR attention with mask kind none."""
    lay_kw, cfg_kw = TILE_CASES[case]
    lay = VideoLayout(**lay_kw)
    cfg = SAPConfig(num_q_centroids=6, num_k_centroids=10, top_p_kmeans=0.6, kmeans_iter_init=6,
                    kmeans_iter_step=2, block_mode="tile", **cfg_kw)
    jlay, jcfg = jax_layout(lay), JC.SAPConfig(**dataclasses.asdict(cfg))
    H, D, S = 2, 64, lay.seq_len
    rng = np.random.default_rng(len(case))
    q, k, v = (clustered(rng, H, S, D)[None] for _ in range(3))
    key = jax.random.PRNGKey(7)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jo1, js1 = J2.sap_sparse_attention(jq, jk, jv, J2.init_sap_state(H, D, jcfg), key, layout=jlay, cfg=jcfg)
    jo2, js2 = J2.sap_sparse_attention(jq, jk, jv, js1, key, layout=jlay, cfg=jcfg)
    _kernels.reset_counts()
    to1, ts1 = T2.sap_sparse_attention(t(q), t(k), t(v), T2.init_sap_state(H, D, cfg), layout=lay, cfg=cfg,
                                       init_idx=jax_draws(key, H, lay.video_length, cfg))
    to2, ts2 = T2.sap_sparse_attention(t(q), t(k), t(v), ts1, layout=lay, cfg=cfg)
    assert _kernels.PLAIN_CALLS["block_sparse_attn"] == 2 and _kernels.PLAIN_CALLS["block_sparse_attn_runs"] == 0
    for ours, ref in ((to1, jo1), (to2, jo2)):
        assert rel_l2(ours.numpy(), ref) <= 1e-5
    for ts, js in ((ts1, js1), (ts2, js2)):
        np.testing.assert_allclose(ts.last_density.numpy(), np.asarray(js.last_density), rtol=1e-6)
        assert float(ts.last_density.max()) < 1.0
        if cfg.tile_order == "kmeans":
            np.testing.assert_array_equal(ts.k_centroids.float().numpy(), np.asarray(js.k_centroids, np.float32))


def test_tile_prepare_metadata_layout():
    """The text-last tile layout: q rows are the video tiles, then the prompt
    and the padding block_q-aligned; no chunk is emitted for the K/V padding
    between the prompt and the padding tokens, and every chunk's window lies
    in [0, block_kv]; pos maps every token to a distinct q row."""
    lay = VideoLayout(num_frames=4, frame_size=200, **TEXT_LAST)
    cfg = SAPConfig(num_q_centroids=6, num_k_centroids=10, kmeans_iter_init=3, block_mode="tile", block_q=128,
                    block_kv=128)
    H, D = 2, 64
    x = torch.randn(1, H, lay.seq_len, D, generator=torch.Generator().manual_seed(0))
    a = T2.sap_prepare(x, x, x, T2.init_sap_state(H, D, cfg), layout=lay, cfg=cfg,
                       generator=torch.Generator().manual_seed(1))
    vl, pl_, ul = lay.video_length, 10, 14
    n_qc = -(-vl // 128)
    assert a.kernel == "csr" and a.q.shape[1] == (n_qc + 2) * 128 and a.meta.shape[1] == n_qc + 2
    assert sorted(a.pos[0].tolist()) == sorted(set(a.pos[0].tolist())) and len(set(a.pos[0].tolist())) == lay.seq_len
    dec = TMD.decode_meta(a.meta.numpy(), block_kv=128, seq_kv=a.k.shape[1])
    live = np.zeros(a.k.shape[1], bool)
    live[:vl] = True
    text0 = n_qc * 128
    live[text0:text0 + pl_] = True
    live[text0 + 128:text0 + 128 + ul] = True
    assert not (dec & ~live).any()  # padding columns never visited
    assert dec[:, n_qc, text0:text0 + pl_].all() and not dec[:, n_qc, text0 + 128:].any()  # prompt q
    assert dec[:, n_qc + 1, text0 + 128:text0 + 128 + ul].all() and not dec[:, n_qc + 1, :text0 + 128].any()


def test_wan_pipeline_tile_matches_jax():
    """A tiny Wan over 2 UniPC steps in tile mode (layer 0 dense warm-up,
    layer 1 tile SAP: cold at step 0 with JAX's draws, warm at step 1),
    cond and uncond as separate batch-1 forwards: f32 latents within rel L2
    1e-4 of JAX's."""
    from sparse_videogen_tpu.pipelines import wan as JPW
    from sparse_videogen_tpu_torch.pipelines import wan as TPW
    from tests.test_torch_sap import _tiny_wan

    jcfg, params, model = _tiny_wan()
    steps, seed, H_LAT, W_LAT, NF = 2, 0, 16, 16, 9
    sap_kw = dict(num_q_centroids=4, num_k_centroids=8, top_p_kmeans=0.7, kmeans_iter_init=8, block_q=128,
                  block_kv=128, block_mode="tile")
    sap = SAPConfig(**sap_kw)
    kw = dict(height=8 * H_LAT, width=8 * W_LAT, num_frames=NF, num_inference_steps=steps, guidance_scale=5.0,
              flow_shift=3.0, pattern="SAP", first_layers_fp=0.5, first_times_fp=0.0)
    rng = np.random.default_rng(3)
    ctx, ctx_null = (rng.standard_normal((1, jcfg.text_len, jcfg.text_dim)).astype(np.float32) for _ in range(2))
    ref = np.asarray(JPW.WanPipeline(jcfg, params, dtype=jnp.float32).generate_latents(
        jnp.asarray(ctx), jnp.asarray(ctx_null), seed=seed, sap=JC.SAPConfig(**sap_kw), **kw))
    key, nkey = jax.random.split(jax.random.PRNGKey(seed))
    lay = JPW.wan_layout(jcfg, kw["height"], kw["width"], NF)
    lat0 = np.array(jax.random.normal(nkey, (1, 16, lay.num_frames, H_LAT, W_LAT), jnp.float32))
    draws = [[{li: jax_draws(jax.random.fold_in(jax.random.fold_in(key, i), li), jcfg.num_heads, lay.seq_len, sap)
               for li in range(jcfg.num_layers)}] * 2 for i in range(steps)]
    _kernels.reset_counts()
    ours = TPW.WanPipeline(model)._denoise(t(ctx), t(ctx_null), t(lat0), kmeans_init=draws, svg=SVGConfig(),
                                           sap=sap, **kw).numpy()
    # 2 steps x 2 streams: layer 0 dense, layer 1 tile SAP; both on the chunked-CSR attention
    assert _kernels.PLAIN_CALLS["block_sparse_attn"] == 8 and _kernels.PLAIN_CALLS["block_sparse_attn_runs"] == 0
    assert np.isfinite(ours).all() and rel_l2(ours, ref) <= 1e-4
