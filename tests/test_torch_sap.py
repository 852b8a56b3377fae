"""SAP (SVG2, cluster mode on video-only layouts) of the torch port against the JAX package.

Each stage gets the same numpy inputs in both packages: the dynamic map, the
block-aligned permutation, the run-list metadata, the KV relabel, the
run-list attention (JAX Pallas in interpret mode; the port's plain version),
the whole sparse branch cold and warm, the runtime's warm-up routing and the
Wan pipeline over 2 steps with JAX's k-means draws handed in. Integer outputs
must be equal; float outputs differ by f32 summation order only, with the
tolerance stated per test.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.core import dynamic_map as JDM
from sparse_videogen_tpu.core import permute as JP
from sparse_videogen_tpu.ops import attention as JA
from sparse_videogen_tpu.ops import mask_spec as JMS
from sparse_videogen_tpu.ops import metadata as JMD
from sparse_videogen_tpu.sparse import svg2 as J2
from sparse_videogen_tpu_torch import _kernels
from sparse_videogen_tpu_torch.cli import wan_t2v as TCLI
from sparse_videogen_tpu_torch.config import SAPConfig, SVGConfig, TextPosition, VideoLayout, WarmupSchedule
from sparse_videogen_tpu_torch.core import dynamic_map as TDM
from sparse_videogen_tpu_torch.core import permute as TP
from sparse_videogen_tpu_torch.io.from_jax import sap_state_from_numpy
from sparse_videogen_tpu_torch.ops import metadata as TMD
from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_runs
from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec
from sparse_videogen_tpu_torch.sparse import svg2 as T2
from sparse_videogen_tpu_torch.sparse.runtimes import SAPRuntime
from sparse_videogen_tpu_torch.sparse.svg1 import make_svg1_plan

t = lambda a: torch.from_numpy(np.array(a))


def _random_clusters(rng, BH, C, S):
    """Cluster sizes summing to S with one forced empty cluster, and their
    exclusive starts (the layout of tests/test_runs_meta.py)."""
    w = rng.random(C)
    w[rng.integers(0, C)] = 0.0
    sizes = np.floor(w / w.sum() * S).astype(np.int32)
    sizes[np.argmax(sizes)] += S - sizes.sum()
    sizes = np.tile(sizes, (BH, 1))
    starts = np.concatenate([np.zeros((BH, 1), np.int32), np.cumsum(sizes, axis=1)[:, :-1]], axis=1)
    return sizes, starts.astype(np.int32)


@pytest.mark.parametrize("top_p,min_kc", [(0.5, 0.0), (0.9, 0.0), (0.9, 0.3)])
def test_dynamic_map_matches_jax(top_p, min_kc):
    """The keep-mask is equal except in rows where JAX's cumulative mass lies
    within 1e-6 of top_p (f32 cumsums in another order may cross it on the
    other side); density agrees to 1e-6."""
    rng = np.random.default_rng(int(10 * top_p + 100 * min_kc))
    B, H, QC, KC, D = 1, 4, 6, 16, 32
    qc = rng.standard_normal((B, H, QC, D)).astype(np.float32)
    kc = rng.standard_normal((B, H, KC, D)).astype(np.float32)
    qs = rng.integers(1, 60, (B, H, QC)).astype(np.int32)
    ks = rng.integers(0, 60, (B, H, KC)).astype(np.int32)
    ks[..., 3] = 0  # an empty cluster carries no mass
    ref = np.asarray(JDM.identify_dynamic_map(*(jnp.asarray(a) for a in (qc, kc, qs, ks)), top_p, min_kc))
    ours = TDM.identify_dynamic_map(t(qc), t(kc), t(qs), t(ks), top_p, min_kc).numpy()
    probs = np.asarray(JDM.weighted_softmax(jnp.einsum("bhqd,bhkd->bhqk", qc, kc) * D ** -0.5, ks[..., None, :]))
    cum = np.cumsum(-np.sort(-probs, axis=-1), axis=-1)
    clear = ~np.any(np.abs(cum - top_p) < 1e-6, axis=-1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(ours[clear], ref[clear])
    np.testing.assert_allclose(TDM.density_calculation(t(ref), t(qs), t(ks)).numpy(),
                               np.asarray(JDM.density_calculation(jnp.asarray(ref), qs, ks)), rtol=1e-6)


@pytest.mark.parametrize("seed,block", [(0, 4), (1, 16), (2, 128)])
def test_padded_permutation_matches_jax(seed, block):
    """Every map equal, with empty clusters (C > the labels drawn)."""
    rng = np.random.default_rng(seed)
    B, N, C = 2, 300, 11
    labels = rng.integers(0, C - 3, (B, N)).astype(np.int32)
    sizes = np.stack([np.bincount(labels[b], minlength=C) for b in range(B)]).astype(np.int32)
    s_pad = TP.padded_seq_len(N, C, block)
    assert s_pad == JP.padded_seq_len(N, C, block)
    ref = JP.padded_permutation(jnp.asarray(labels), jnp.asarray(sizes), n_clusters=C, block=block, s_pad=s_pad)
    ours = TP.padded_permutation(t(labels), t(sizes), n_clusters=C, block=block, s_pad=s_pad)
    assert set(ours) == set(ref)
    for name in ref:
        np.testing.assert_array_equal(ours[name].numpy(), np.asarray(ref[name]), err_msg=name)
    x = rng.standard_normal((B, N, 5)).astype(np.float32)
    y = TP.gather_padded(t(x), ours["src"])
    np.testing.assert_array_equal(TP.ungather_padded(y, ours["pos"]).numpy(), x)


@pytest.mark.parametrize("seed,bkv,cap", [(0, 256, None), (1, 512, None), (2, 128, 2), (3, 256, 1)])
def test_run_meta_matches_jax(seed, bkv, cap):
    """run_meta (torch), run_meta_np and the JAX package's run_meta_jnp and
    run_meta_np are equal: merged adjacent clusters, empty clusters breaking
    runs, and a cap that truncates rows to their first runs."""
    rng = np.random.default_rng(seed)
    BH, NR, C, S = 3, 5, 13, 1500
    sizes, starts = _random_clusters(rng, BH, C, S)
    sel = rng.random((BH, NR, C)) < 0.5
    sel[:, 0, :] = False  # a row with no run
    sel[:, 1, 2:6] = True  # adjacent clusters merge into one run
    cap = cap or C
    ours = TMD.run_meta(t(sel), t(starts), t(sizes), block_kv=bkv, cap=cap).numpy()
    ref = np.asarray(JMD.run_meta_jnp(jnp.asarray(sel), jnp.asarray(starts), jnp.asarray(sizes), block_kv=bkv,
                                      cap=cap))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(TMD.run_meta_np(sel, starts, sizes, block_kv=bkv, cap=cap), ref)
    np.testing.assert_array_equal(JMD.run_meta_np(sel, starts, sizes, block_kv=bkv, cap=cap), ref)
    np.testing.assert_array_equal(TMD.decode_run_meta(ours, seq_kv=S), JMD.decode_run_meta(ref, seq_kv=S))
    assert ours[:, 0, 0].sum() == 0 and TMD.run_meta_row_len(cap) == ours.shape[-1]
    if cap < C:
        full = TMD.run_meta_np(sel, starts, sizes, block_kv=bkv)
        assert full.shape[-1] > ours.shape[-1]  # rows were truncated


def test_popularity_relabel_matches_jax_with_ties():
    """Tied popularity (integer counts) keeps the old order among the tied
    clusters in both packages (stable sorts)."""
    rng = np.random.default_rng(5)
    BH, QC, KC, D, N = 2, 4, 10, 8, 200
    dyn = np.zeros((BH, QC, KC), bool)
    dyn[:, :, ::3] = True  # four clusters tied at the top
    dyn[:, :2, 1] = True
    dyn[1, :, 7] = True
    klab = rng.integers(0, KC, (BH, N)).astype(np.int32)
    ksz = np.stack([np.bincount(klab[b], minlength=KC) for b in range(BH)]).astype(np.int32)
    kcent = rng.standard_normal((BH, KC, D)).astype(np.float32)
    ref = J2.popularity_relabel(jnp.asarray(dyn), jnp.asarray(klab), jnp.asarray(ksz), jnp.asarray(kcent))
    ours = T2.popularity_relabel(t(dyn), t(klab), t(ksz), t(kcent))
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("mask", ["none", "band_sink"])
def test_runs_attention_plain_matches_jax(mask):
    """The plain run-list attention against the JAX kernel (mask none: its
    expand kernel, exp2 domain; band_sink: its in-loop walk, exp domain),
    f32, with a row whose run list is empty (output exactly 0) and aux
    offsets: atol 1e-5 on outputs of size ~1."""
    rng = np.random.default_rng(7)
    BH, C, S, bq, Sq, D, bkv = 2, 9, 1100, 128, 384, 64, 256
    sizes, starts = _random_clusters(rng, BH, C, S)
    sel = rng.random((BH, Sq // bq, C)) < 0.45
    sel[:, 1, :] = False
    Skv = -(-S // 128) * 128
    meta = JMD.run_meta_np(sel, starts, sizes, block_kv=bkv, cap=C)
    q, k, v = (rng.standard_normal((BH, n, D)).astype(np.float32) for n in (Sq, Skv, Skv))
    spec = MaskSpec() if mask == "none" else MaskSpec(kind="band_sink", band_width=300, sink_size=100)
    aux = np.asarray([0, 0, 40, 7], np.int32)
    ref = np.asarray(JA.block_sparse_attention_runs(
        jnp.asarray(q), JA.pack_kv(jnp.asarray(k), jnp.asarray(v)), jnp.asarray(meta), jnp.asarray(aux),
        block_q=bq, block_kv=bkv, mask_spec=JMS.MaskSpec(**vars(spec))))
    _kernels.reset_counts()
    ours = block_sparse_attention_runs(t(q), t(k), t(v), t(meta), t(aux), block_q=bq, block_kv=bkv,
                                       mask_spec=spec).numpy()
    assert _kernels.PLAIN_CALLS["block_sparse_attn_runs"] == 1
    assert np.all(ours[:, bq:2 * bq] == 0) and np.all(ref[:, bq:2 * bq] == 0)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


# the port's configs; the JAX package gets its own, built from the same values
LAYOUT = VideoLayout(num_frames=3, frame_size=100)
SAP_CFG = SAPConfig(num_q_centroids=6, num_k_centroids=12, kmeans_iter_init=8, kmeans_iter_step=2, block_q=128,
                    block_kv=256)
JLAYOUT, JSAP_CFG = JC.VideoLayout(num_frames=3, frame_size=100), JC.SAPConfig(**dataclasses.asdict(SAP_CFG))


def _qkv(seed, H=2, D=64, S=300):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, H, S, D)).astype(np.float32) for _ in range(3)]


def _jax_draws(key, H, S, cfg):
    """The cold-start token indices sap_cluster draws from `key`."""
    rq, rk = jax.random.split(key)
    return (t(jax.random.randint(rq, (H, cfg.num_q_centroids), 0, S)),
            t(jax.random.randint(rk, (H, cfg.num_k_centroids), 0, S)))


def test_sap_sparse_attention_matches_jax():
    """Cold (JAX's draws handed in), then warm from the carried state, and
    warm from JAX's own state converted by sap_state_from_numpy: bf16
    centroids and densities equal, f32 outputs within atol 1e-5."""
    q, k, v = _qkv(0)
    H, S, D = q.shape[1], q.shape[2], q.shape[3]
    key = jax.random.PRNGKey(5)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jo1, js1 = J2.sap_sparse_attention(jq, jk, jv, J2.init_sap_state(H, D, JSAP_CFG), key, layout=JLAYOUT,
                                       cfg=JSAP_CFG)
    jo2, js2 = J2.sap_sparse_attention(jq, jk, jv, js1, key, layout=JLAYOUT, cfg=JSAP_CFG)
    tq, tk, tv = t(q), t(k), t(v)
    to1, ts1 = T2.sap_sparse_attention(tq, tk, tv, T2.init_sap_state(H, D, SAP_CFG), layout=LAYOUT, cfg=SAP_CFG,
                                       init_idx=_jax_draws(key, H, S, SAP_CFG))
    to2, ts2 = T2.sap_sparse_attention(tq, tk, tv, ts1, layout=LAYOUT, cfg=SAP_CFG)
    to3, _ = T2.sap_sparse_attention(tq, tk, tv, sap_state_from_numpy(jax.tree.map(np.asarray, js1)), layout=LAYOUT,
                                     cfg=SAP_CFG)
    for ts, js in ((ts1, js1), (ts2, js2)):
        assert ts.initialized and ts.q_centroids.dtype == torch.bfloat16
        np.testing.assert_array_equal(ts.q_centroids.float().numpy(), np.asarray(js.q_centroids, np.float32))
        np.testing.assert_array_equal(ts.k_centroids.float().numpy(), np.asarray(js.k_centroids, np.float32))
        np.testing.assert_allclose(ts.last_density.numpy(), np.asarray(js.last_density), rtol=1e-6)
    for ours, ref in ((to1, jo1), (to2, jo2), (to3, jo2)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("nf,fs,qc,kc,bq", [(3, 48, 23, 38, 64), (5, 37, 2, 33, 64), (4, 90, 14, 9, 128)])
def test_sap_full_density_equals_dense(nf, fs, qc, kc, bq):
    """top_p 1.0 with min_kc_ratio 1.0 selects every cluster pair, so the
    whole SAP path must reproduce dense attention (any clustering, empty
    clusters included): max abs error <= 3e-5 x the output scale, f32."""
    layout = VideoLayout(num_frames=nf, frame_size=fs)
    S, H, D = nf * fs, 2, 64
    cfg = SAPConfig(num_q_centroids=qc, num_k_centroids=kc, top_p_kmeans=1.0, min_kc_ratio=1.0,
                    kmeans_iter_init=3, block_q=bq, block_kv=128)
    gen = torch.Generator().manual_seed(nf * fs)
    q, k, v = (torch.randn(1, H, S, D, generator=gen) for _ in range(3))
    out, state = T2.sap_sparse_attention(q, k, v, T2.init_sap_state(H, D, cfg), layout=layout, cfg=cfg,
                                         generator=gen)
    warm, _ = T2.sap_sparse_attention(q, k, v, state, layout=layout, cfg=cfg)
    ref = torch.softmax((q.double() @ k.double().transpose(-1, -2)) * D ** -0.5, dim=-1) @ v.double()
    for o in (out, warm):
        assert (o.double() - ref).abs().max() <= 3e-5 * ref.abs().max()
    assert torch.allclose(state.last_density, torch.ones(H))


@pytest.mark.parametrize("zero_step", [False, True])
def test_sap_runtime_warmup_routing(zero_step):
    """Layers below first_layers and steps above first_times run the dense
    kernel path; with zero_step_kmeans_init they also cluster, so the first
    sparse call starts warm (no draw); otherwise it starts cold."""
    cfg = SAPConfig(num_q_centroids=4, num_k_centroids=6, kmeans_iter_init=3, zero_step_kmeans_init=zero_step,
                    block_q=128, block_kv=256)
    plan = make_svg1_plan(LAYOUT, block_q=128, block_kv=256)
    rt = SAPRuntime(plan, cfg, WarmupSchedule(first_layers=1, first_times=900.0), device="cpu")
    q, k, v = (t(a) for a in _qkv(1))
    _kernels.reset_counts()
    rt(q, k, v, 500.0, 0)  # layer 0: dense warm-up layer
    rt(q, k, v, 950.0, 1)  # t > first_times: dense warm-up step
    assert _kernels.PLAIN_CALLS["block_sparse_attn"] == 2 and _kernels.PLAIN_CALLS["block_sparse_attn_runs"] == 0
    assert all(rt.states[li].initialized == zero_step for li in (0, 1))
    assert _kernels.PLAIN_CALLS["kmeans_wide"] == (2 * 2 * 3 if zero_step else 0)
    assert not rt.states[1].last_density.any()  # dense steps log no density
    _kernels.reset_counts()
    gen = torch.Generator().manual_seed(0)
    out = rt(q, k, v, 500.0, 1, generator=gen)  # sparse
    assert _kernels.PLAIN_CALLS["block_sparse_attn_runs"] == 1 and _kernels.PLAIN_CALLS["block_sparse_attn"] == 0
    # warm: kmeans_iter_step (2) passes for q and for k; cold: kmeans_iter_init (3)
    assert _kernels.PLAIN_CALLS["kmeans_wide"] == 2 * (cfg.kmeans_iter_step if zero_step else cfg.kmeans_iter_init)
    assert rt.states[1].initialized and rt.states[1].last_density.gt(0).all() and out.shape == q.shape


def _tiny_wan():
    from sparse_videogen_tpu.models.wan import model as JWM
    from sparse_videogen_tpu_torch.io.from_jax import wan_params_from_numpy
    from sparse_videogen_tpu_torch.models.wan import model as TWM

    kw = dict(dim=128, ffn_dim=256, num_heads=2, num_layers=2, freq_dim=32, text_dim=48, text_len=8)
    jcfg, tcfg = JWM.WanConfig(**kw), TWM.WanConfig(**kw)
    tree = JWM.init_wan_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree)
    model = TWM.WanModel(tcfg, dtype=torch.float32)
    model.load_state_dict(wan_params_from_numpy(params, tcfg))
    return jcfg, params, model


def test_generate_latents_sap_matches_jax(tmp_path):
    """The slice: 2 UniPC steps, cond and uncond as separate batch-1
    forwards with their own k-means states, layer 0 in dense warm-up, layer 1
    cold at step 0 (JAX's draws handed in) and warm at step 1; f32 latents
    within rel L2 error 1e-5 and the same density log."""
    from sparse_videogen_tpu.pipelines import wan as JPW
    from sparse_videogen_tpu_torch.pipelines import wan as TPW

    jcfg, params, model = _tiny_wan()
    steps, seed, H_LAT, W_LAT, NF = 2, 0, 10, 16, 9
    sap_kw = dict(num_q_centroids=4, num_k_centroids=8, kmeans_iter_init=8, block_q=128, block_kv=256)
    sap = SAPConfig(**sap_kw)
    kw = dict(height=8 * H_LAT, width=8 * W_LAT, num_frames=NF, num_inference_steps=steps, guidance_scale=5.0,
              flow_shift=3.0, pattern="SAP", first_layers_fp=0.5, first_times_fp=0.0)
    rng = np.random.default_rng(3)
    ctx, ctx_null = (rng.standard_normal((1, jcfg.text_len, jcfg.text_dim)).astype(np.float32) for _ in range(2))
    jlog, tlog = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    ref = np.asarray(JPW.WanPipeline(jcfg, params, dtype=jnp.float32).generate_latents(
        jnp.asarray(ctx), jnp.asarray(ctx_null), seed=seed, logging_file=str(jlog), sap=JC.SAPConfig(**sap_kw), **kw))
    key, nkey = jax.random.split(jax.random.PRNGKey(seed))
    lay = JPW.wan_layout(jcfg, kw["height"], kw["width"], NF)
    lat0 = np.array(jax.random.normal(nkey, (1, 16, lay.num_frames, H_LAT, W_LAT), jnp.float32))
    # sap_cluster's draws: split(fold_in(fold_in(key, step), layer)), the same for both streams
    draws = [[{li: _jax_draws(jax.random.fold_in(jax.random.fold_in(key, i), li), jcfg.num_heads, lay.seq_len, sap)
               for li in range(jcfg.num_layers)}] * 2 for i in range(steps)]
    ours = TPW.WanPipeline(model)._denoise(t(ctx), t(ctx_null), t(lat0), kmeans_init=draws, logging_file=str(tlog),
                                           svg=SVGConfig(), sap=sap, **kw).numpy()
    assert np.isfinite(ours).all()
    assert np.linalg.norm(ours - ref) / np.linalg.norm(ref) <= 1e-5
    jrows, trows = ([json.loads(line) for line in open(p)] for p in (jlog, tlog))
    assert [(r["timestep"], r["layer"]) for r in trows] == [(r["timestep"], r["layer"]) for r in jrows]
    assert len(trows) == steps  # layer 1 at each step; layer 0 is dense
    np.testing.assert_allclose([r["density"] for r in trows], [r["density"] for r in jrows], rtol=1e-6)


def test_cli_smoke_sap_cpu(tmp_path):
    out, log = tmp_path / "lat.npz", tmp_path / "density.jsonl"
    TCLI.main(["--smoke", "--pattern", "SAP", "--device", "cpu", "--num_inference_steps", "2",
               "--output_file", str(out), "--logging_file", str(log)])
    lat = np.load(out)["latents"]
    assert lat.shape == (1, 16, 3, 12, 16) and np.isfinite(lat).all()
    rows = [json.loads(line) for line in open(log)]
    assert len(rows) == 2 * 4 and all(0 < r["avg_density"] <= 1 for r in rows)  # 2 steps x 4 layers


def test_sap_state_from_numpy():
    """Single and layer-stacked JAX states (bf16 centroids) convert exactly."""
    H, D, L = 3, 16, 2
    one = J2.init_sap_state(H, D, JSAP_CFG)
    rng = np.random.default_rng(0)
    one = J2.SAPState(jnp.asarray(rng.standard_normal(one.q_centroids.shape), jnp.bfloat16),
                      jnp.asarray(rng.standard_normal(one.k_centroids.shape), jnp.bfloat16),
                      jnp.ones((), bool), jnp.asarray(rng.random(H), jnp.float32))
    st = sap_state_from_numpy(jax.tree.map(np.asarray, one))
    assert isinstance(st, T2.SAPState) and st.initialized is True and st.q_centroids.dtype == torch.bfloat16
    np.testing.assert_array_equal(st.k_centroids.float().numpy(), np.asarray(one.k_centroids, np.float32))
    np.testing.assert_array_equal(st.last_density.numpy(), np.asarray(one.last_density))
    stacked = jax.tree.map(lambda a: np.stack([np.asarray(a)] * L), one)
    states = sap_state_from_numpy(stacked)
    assert sorted(states) == list(range(L))
    np.testing.assert_array_equal(states[1].q_centroids.float().numpy(), np.asarray(one.q_centroids, np.float32))


@pytest.mark.parametrize("change", [
    dict(cfg=dict(force_density=0.25)),
    dict(layout=dict(context_length=16, text_position=TextPosition.FIRST)),
], ids=["force_density", "text_first"])
def test_unported_sap_options_raise(change):
    """What SAP still refuses: a text-first layout (CogVideoX runs SVG1 or
    dense only). force_density, refused before, now runs: the map keeps the
    first ceil(0.25 x 2) = 1 of 2 key clusters (its parity with JAX:
    tests/test_torch_sap_force_density.py)."""
    cfg = SAPConfig(**{**dict(num_q_centroids=2, num_k_centroids=2), **change.get("cfg", {})})
    layout = VideoLayout(num_frames=2, frame_size=64, **change.get("layout", {}))
    q = torch.zeros(1, 1, layout.seq_len, 64)
    if cfg.force_density is not None:
        x = torch.randn(1, 1, layout.seq_len, 64, generator=torch.Generator().manual_seed(0))
        out, state = T2.sap_sparse_attention(x, x, x, T2.init_sap_state(1, 64, cfg), layout=layout, cfg=cfg,
                                             generator=torch.Generator().manual_seed(0))
        assert out.shape == x.shape and 0.0 < float(state.last_density) < 1.0
        return
    with pytest.raises(NotImplementedError):
        T2.sap_sparse_attention(q, q, q, T2.init_sap_state(1, 64, cfg), layout=layout, cfg=cfg)
