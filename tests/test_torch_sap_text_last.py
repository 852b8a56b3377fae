"""SAP on text-last layouts (HunyuanVideo) of the torch port against the JAX
package: the prompt and padding clusters (_extend_text_dyn,
_extend_text_clusters), the cluster-mode sparse branch on text-last layouts
(a prompt shorter than the text, and one that fills it, which leaves the
padding cluster empty), SAPRuntime's dense warm-up (K1's hyvideo kind), a
2-step HunyuanVideo SAP pipeline in cluster and tile mode, and the
HunyuanVideo CLI's SAP smoke. Integer maps exact; f32 attention within rel
L2 1e-5, the pipeline within 1e-4.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.models.hyvideo import model as JHM
from sparse_videogen_tpu.pipelines import hyvideo as JPH
from sparse_videogen_tpu.sparse import runtimes as JRT
from sparse_videogen_tpu.sparse import svg1 as JS1
from sparse_videogen_tpu.sparse import svg2 as J2
from sparse_videogen_tpu_torch import _kernels
from sparse_videogen_tpu_torch.cli import hyvideo_t2v as TCLI
from sparse_videogen_tpu_torch.config import SAPConfig, TextPosition, VideoLayout, WarmupSchedule
from sparse_videogen_tpu_torch.pipelines import hyvideo as TPH
from sparse_videogen_tpu_torch.sparse import svg1 as TS1
from sparse_videogen_tpu_torch.sparse import svg2 as T2
from sparse_videogen_tpu_torch.sparse.runtimes import SAPRuntime
from tests.test_torch_hyvideo import CFG_KW, H_LAT, JCFG, NUM_FRAMES, PROMPT, W_LAT, _text, model, params  # noqa: F401
from tests.test_torch_sap_tile import clustered, jax_draws, jax_layout, rel_l2, t


def _layout(prompt_length, context_length=16, num_frames=3, frame_size=128):
    return VideoLayout(num_frames=num_frames, frame_size=frame_size, context_length=context_length,
                       text_position=TextPosition.LAST, prompt_length=prompt_length)


@pytest.mark.parametrize("prompt_length", [0, 5, 16], ids=["no_prompt", "prompt_5_of_16", "prompt_fills"])
def test_extend_text_clusters_match_jax(prompt_length):
    """The map, labels and sizes with the prompt (C) and padding (C + 1)
    clusters equal JAX's, and _extend_text_dyn equals their map part."""
    lay = _layout(prompt_length)
    rng = np.random.default_rng(prompt_length)
    BH, QC, KC, vl = 2, 5, 7, lay.video_length
    dyn = rng.random((BH, QC, KC)) < 0.5
    qlab, klab = rng.integers(0, QC, (BH, vl)).astype(np.int32), rng.integers(0, KC, (BH, vl)).astype(np.int32)
    qsz = np.stack([np.bincount(r, minlength=QC) for r in qlab]).astype(np.int32)
    ksz = np.stack([np.bincount(r, minlength=KC) for r in klab]).astype(np.int32)
    ours = T2._extend_text_clusters(t(dyn), t(qlab), t(qsz), t(klab), t(ksz), lay)
    ref = J2._extend_text_clusters(*(jnp.asarray(a) for a in (dyn, qlab, qsz, klab, ksz)), jax_layout(lay))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(T2._extend_text_dyn(t(dyn), lay, QC, KC).numpy(), np.asarray(ref[0]))


@pytest.mark.parametrize("prompt_length", [10, 16], ids=["prompt_10_of_16", "prompt_fills"])
def test_text_last_cluster_sap_matches_jax(prompt_length):
    """The cluster-mode sparse branch on a text-last layout, cold (JAX's
    draws over the video tokens) then warm: f32 outputs within rel L2 1e-5,
    densities and bf16 centroids equal; the run lists go to the run-list
    attention."""
    lay = _layout(prompt_length)
    cfg = SAPConfig(num_q_centroids=5, num_k_centroids=9, top_p_kmeans=0.7, kmeans_iter_init=6, block_q=128,
                    block_kv=256)
    jlay, jcfg = jax_layout(lay), JC.SAPConfig(**dataclasses.asdict(cfg))
    H, D, S = 2, 64, lay.seq_len
    rng = np.random.default_rng(prompt_length)
    q, k, v = (clustered(rng, H, S, D)[None] for _ in range(3))
    key = jax.random.PRNGKey(3)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jo1, js1 = J2.sap_sparse_attention(jq, jk, jv, J2.init_sap_state(H, D, jcfg), key, layout=jlay, cfg=jcfg)
    jo2, js2 = J2.sap_sparse_attention(jq, jk, jv, js1, key, layout=jlay, cfg=jcfg)
    _kernels.reset_counts()
    to1, ts1 = T2.sap_sparse_attention(t(q), t(k), t(v), T2.init_sap_state(H, D, cfg), layout=lay, cfg=cfg,
                                       init_idx=jax_draws(key, H, lay.video_length, cfg))
    to2, ts2 = T2.sap_sparse_attention(t(q), t(k), t(v), ts1, layout=lay, cfg=cfg)
    assert _kernels.PLAIN_CALLS["block_sparse_attn_runs"] == 2 and _kernels.PLAIN_CALLS["block_sparse_attn"] == 0
    for ours, ref in ((to1, jo1), (to2, jo2)):
        assert rel_l2(ours.numpy(), ref) <= 1e-5
    for ts, js in ((ts1, js1), (ts2, js2)):
        np.testing.assert_allclose(ts.last_density.numpy(), np.asarray(js.last_density), rtol=1e-6)
        np.testing.assert_array_equal(ts.q_centroids.float().numpy(), np.asarray(js.q_centroids, np.float32))


def test_sap_runtime_hyvideo_warmup_matches_jax():
    """SAPRuntime's dense warm-up on a text-last layout runs the plan's
    hyvideo kind with aux[0] = video + context_length (the JAX runtime's
    None prompt length), and equals the JAX runtime's warm-up output; with
    zero_step_kmeans_init it also clusters the video tokens."""
    lay = _layout(5, context_length=8)
    cfg = SAPConfig(num_q_centroids=4, num_k_centroids=6, kmeans_iter_init=3, zero_step_kmeans_init=True,
                    block_q=128, block_kv=256)
    jcfg = JC.SAPConfig(**dataclasses.asdict(cfg))
    warm = WarmupSchedule(first_layers=1)
    plan = TS1.make_svg1_plan(lay, warmup=warm)
    rt = SAPRuntime(plan, cfg, warm, device="cpu")
    assert plan.dense_mask_spec.kind == "hyvideo" and int(rt.aux[0]) == lay.video_length + lay.context_length
    jplan = JS1.make_svg1_plan(jax_layout(lay), warmup=JC.WarmupSchedule(first_layers=1))
    jrt = JRT.SAPRuntime(jplan, jcfg, JC.WarmupSchedule(first_layers=1))
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 2, lay.seq_len, 64)).astype(np.float32) for _ in range(3))
    key = jax.random.PRNGKey(1)
    ref, jstate = jrt(*(jnp.asarray(a) for a in (q, k, v)), 500.0, key, 0,
                      J2.init_sap_state(2, 64, jcfg), jrt.consts())
    rt.kmeans_init = {0: jax_draws(key, 2, lay.video_length, cfg)}
    _kernels.reset_counts()
    ours = rt(t(q), t(k), t(v), 500.0, 0)
    assert _kernels.PLAIN_CALLS["block_sparse_attn"] == 1 and rt.states[0].initialized
    assert rel_l2(ours.numpy(), ref) <= 1e-5
    # the f32 means sum in another order: the bf16 centroids within an ulp
    np.testing.assert_allclose(rt.states[0].k_centroids.float().numpy(), np.asarray(jstate.k_centroids, np.float32),
                               rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("mode", ["cluster", "tile"])
def test_hyvideo_sap_pipeline_matches_jax(params, model, mode, tmp_path):  # noqa: F811
    """2 Euler steps of the tiny HunyuanVideo (layer 0 dense warm-up, layers
    1-3 SAP: cold at step 0 with JAX's draws, warm at step 1), one forward a
    step, prompt 5 of 8 text tokens: f32 latents within rel L2 1e-4 of
    JAX's (the guidance embedding's ulp, tests/test_torch_hyvideo.py), the
    same density log. The carried bf16 centroids may differ by an ulp (f32
    means summed in another order); the warm step's 8 Lloyd iterations reach
    the same fixed point from both, where 2 leave near-boundary tokens in
    other clusters (tile mode then cuts other tiles: 4e-4 measured)."""
    steps, seed = 2, 0
    sap_kw = dict(num_q_centroids=4, num_k_centroids=8, top_p_kmeans=0.7, kmeans_iter_init=6, kmeans_iter_step=8,
                  block_mode=mode,
                  block_q=128, block_kv=128 if mode == "tile" else 256)
    sap = SAPConfig(**sap_kw)
    kw = dict(height=8 * H_LAT, width=8 * W_LAT, num_frames=NUM_FRAMES, num_inference_steps=steps,
              embedded_guidance_scale=6.0, flow_shift=7.0, pattern="SAP", first_layers_fp=0.25, first_times_fp=0.0)
    text, mask, pooled = _text(np.random.default_rng(5))
    jlog, tlog = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    ref = JPH.HyVideoPipeline(JCFG, params, dtype=jnp.float32).generate_latents(
        jnp.asarray(text), jnp.asarray(mask), jnp.asarray(pooled), prompt_length=PROMPT, seed=seed,
        sap=JC.SAPConfig(**sap_kw), logging_file=str(jlog), **kw)
    key, nkey = jax.random.split(jax.random.PRNGKey(seed))
    lat0 = np.array(jax.random.normal(nkey, (1, 16, 3, H_LAT, W_LAT), jnp.float32))
    vl = 3 * (H_LAT // 2) * (W_LAT // 2)
    n_layers = CFG_KW["mm_double_blocks_depth"] + CFG_KW["mm_single_blocks_depth"]
    draws = [{li: jax_draws(jax.random.fold_in(jax.random.fold_in(key, i), li), CFG_KW["heads_num"], vl, sap)
              for li in range(n_layers)} for i in range(steps)]
    f = torch.from_numpy
    _kernels.reset_counts()
    ours = TPH.HyVideoPipeline(model)._denoise(f(text), f(mask), f(pooled), f(lat0), prompt_length=PROMPT, sap=sap,
                                               svg=TPH.SVGConfig(), kmeans_init=draws, logging_file=str(tlog),
                                               **kw).numpy()
    sparse = steps * (n_layers - 1)
    kernel = "block_sparse_attn" if mode == "tile" else "block_sparse_attn_runs"
    assert _kernels.PLAIN_CALLS[kernel] == sparse + (steps if mode == "tile" else 0)
    assert np.isfinite(ours).all() and rel_l2(ours, ref) <= 1e-4
    jrows, trows = ([json.loads(line) for line in open(p)] for p in (jlog, tlog))
    assert [(r["timestep"], r["layer"]) for r in trows] == [(r["timestep"], r["layer"]) for r in jrows]
    assert len(trows) == sparse
    np.testing.assert_allclose([r["density"] for r in trows], [r["density"] for r in jrows], rtol=1e-5)


@pytest.mark.parametrize("mode", ["cluster", "tile"])
def test_cli_smoke_sap_cpu(tmp_path, mode):
    """hyvideo_t2v --smoke --pattern SAP in each mode: finite latents and one
    density line a sparse (step, layer)."""
    out, log = tmp_path / "lat.npz", tmp_path / "density.jsonl"
    TCLI.main(["--smoke", "--pattern", "SAP", "--sap_block_mode", mode, "--device", "cpu",
               "--num_inference_steps", "2", "--output_file", str(out), "--logging_file", str(log)])
    lat = np.load(out)["latents"]
    assert lat.shape == (1, 16, 3, 12, 16) and np.isfinite(lat).all()
    rows = [json.loads(line) for line in open(log)]
    assert len(rows) == 2 * 4 and all(0 < r["avg_density"] <= 1 for r in rows)  # 2 steps x 4 blocks
