"""The quality leg of the port against the JAX package.

1. tests/test_quality_structured.py on the port: q/k/v built with known
   per-head structure (spatial heads attend a locality band, temporal heads
   the same site across frames, SAP's keys drawn from separated centers).
   The port's profiler picks JAX's masks, its sparse output stays close to
   dense, the inverted choice is detected, and SAP forms real clusters.
2. tests/test_quality_gate.py's pipeline (its model config and inputs,
   f32, 4 steps) through both packages on the same weights
   (io/from_jax.wan_params_from_numpy), the port handed JAX's noise,
   profiler rows and k-means draws: the latents of each pattern, and
   PSNR(dense, SVG1), PSNR(dense, SAP), agree within stated tolerances.
3. scripts/quality.py --smoke --device cpu runs and writes its JSON.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.core.profiler import best_mask_idx as j_best_mask_idx
from sparse_videogen_tpu.core.profiler import sample_mse as j_sample_mse
from sparse_videogen_tpu.sparse import svg2 as J2
from sparse_videogen_tpu.sparse.svg1 import make_svg1_plan as j_make_svg1_plan
from sparse_videogen_tpu.utils.metric import psnr as j_psnr
from sparse_videogen_tpu_torch import config as TC
from sparse_videogen_tpu_torch.core.masks import profile_mask_predicate
from sparse_videogen_tpu_torch.core.profiler import best_mask_idx, sample_mse
from sparse_videogen_tpu_torch.sparse import svg2 as T2
from sparse_videogen_tpu_torch.sparse.svg1 import make_svg1_plan, svg1_sparse_impl, to_device_meta
from sparse_videogen_tpu_torch.utils.metric import psnr
from tests.test_quality_structured import D, LAYOUT, S, structured_qkv

TLAYOUT = TC.VideoLayout(num_frames=LAYOUT.num_frames, frame_size=LAYOUT.frame_size)
SVG_KW = dict(sparsity=0.35, num_sampled_rows=48, profile_multiplier=2.0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _dense(q, k, v):
    return torch.softmax((q.double() @ k.double().transpose(-1, -2)) * D ** -0.5, dim=-1) @ v.double()


@pytest.fixture(scope="module")
def qkv():
    return [_t(a) for a in structured_qkv()]


@pytest.fixture(scope="module")
def plan():
    return make_svg1_plan(TLAYOUT, TC.SVGConfig(**SVG_KW), TC.WarmupSchedule(), block_q=128, block_kv=256)


def _ints(key, shape, hi):
    return torch.as_tensor(np.array(jax.random.randint(key, shape, 0, hi)))


def _rows():
    """The rows JAX's sample_mse draws from PRNGKey(0) (48 of S)."""
    return _ints(jax.random.PRNGKey(0), (48,), S)


def test_profiler_selects_constructed_families(qkv, plan):
    """The port's picks equal JAX's best_mask_idx on the same q/k/v and rows:
    spatial heads mask 0, temporal heads mask 1; the MSEs agree to 1e-4 rel."""
    q, k, v = qkv
    jplan = j_make_svg1_plan(LAYOUT, JC.SVGConfig(**SVG_KW), JC.WarmupSchedule(), block_q=128, block_kv=256)
    jm = j_sample_mse(*(jnp.asarray(x.numpy()) for x in qkv), jplan.profile_preds(), jax.random.PRNGKey(0),
                      num_sampled_rows=48, sample_mse_max_row=S)
    mses = sample_mse(q, k, v, plan.profile_preds(), _rows())
    best = best_mask_idx(mses)
    np.testing.assert_array_equal(best.numpy(), np.asarray(j_best_mask_idx(jm)))
    assert best[0].tolist() == [0, 0, 1, 1]
    np.testing.assert_allclose(mses.numpy(), np.asarray(jm), rtol=1e-4)


def test_sparse_close_to_dense_and_inversion_detected(qkv, plan):
    """The port's SVG1 output within 0.12 rel L2 of dense (JAX's gate); the
    band mask forced on a temporal head is > 5x worse (the test fails if
    the classes were ever swapped)."""
    q, k, v = qkv
    meta = to_device_meta(plan.sparse_meta(), "cpu")
    aux = torch.as_tensor(plan.default_aux())
    sparse = svg1_sparse_impl(q, k, v, _rows(), meta, plan, aux)
    err = _rel(sparse.numpy(), _dense(q, k, v).numpy())
    assert err < 0.12, err
    pred = profile_mask_predicate(TLAYOUT, "spatial", 2.0)
    m = pred(torch.arange(S)[:, None], torch.arange(S)[None, :])
    tq, tk, tv = q[:, 2:3].double(), k[:, 2:3].double(), v[:, 2:3].double()
    s = (tq @ tk.transpose(-1, -2)) * D ** -0.5
    wrong = torch.softmax(s.masked_fill(~m, float("-inf")), dim=-1) @ tv
    err_wrong = _rel(wrong.numpy(), _dense(tq, tk, tv).numpy())
    assert err_wrong > 5 * err, (err_wrong, err)


def test_sap_forms_real_clusters_and_matches_dense():
    """JAX's SAP input (6 separated key clusters, queries on 3), JAX's
    k-means draws handed in: the key clusters' sizes equal JAX's, at least 5
    of them non-empty; every q cluster non-empty (8 centroids share 3 blobs,
    so the borders inside a blob are near-ties, where the two packages' f32
    distances may send a token either way); the output within 0.05 rel L2
    of dense (JAX's gate) and within 1e-5 (max abs) of JAX's."""
    rng = np.random.default_rng(3)
    C = 6
    centers = rng.standard_normal((C, D)) * 4.0
    k = centers[rng.integers(0, C, S)] + 0.3 * rng.standard_normal((S, D))
    q = centers[rng.integers(0, 3, S)] + 0.3 * rng.standard_normal((S, D))
    v = rng.standard_normal((S, D))
    q, k, v = (a.astype(np.float32)[None, None] for a in (q, k, v))
    kw = dict(num_q_centroids=8, num_k_centroids=12, top_p_kmeans=0.95, kmeans_iter_init=20, block_q=128,
              block_kv=128)
    jcfg, cfg = JC.SAPConfig(**kw), TC.SAPConfig(**kw)
    key = jax.random.PRNGKey(0)
    rq, rk = jax.random.split(key)
    draws = (_ints(rq, (1, 8), S), _ints(rk, (1, 12), S))
    (_, _, jqsz), (_, _, jksz), _ = J2.sap_cluster(jnp.asarray(q[0]), jnp.asarray(k[0]),
                                                   J2.init_sap_state(1, D, jcfg, dtype=jnp.float32), jcfg, key)
    (_, _, qsz), (_, _, ksz), _ = T2.sap_cluster(_t(q[0]), _t(k[0]), T2.init_sap_state(1, D, cfg), cfg,
                                                 init_idx=draws)
    np.testing.assert_array_equal(ksz.numpy(), np.asarray(jksz))
    assert int(qsz.sum()) == int(jqsz.sum()) == S and int((qsz > 0).sum()) == int((jqsz > 0).sum()) == 8
    assert int((ksz[0] > 0).sum()) >= C - 1
    key1 = jax.random.PRNGKey(1)
    jout, _ = J2.sap_sparse_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                      J2.init_sap_state(1, D, jcfg, jnp.float32), key1, layout=LAYOUT, cfg=jcfg)
    r1q, r1k = jax.random.split(key1)
    draws1 = (_ints(r1q, (1, 8), S), _ints(r1k, (1, 12), S))
    out, _ = T2.sap_sparse_attention(_t(q), _t(k), _t(v), T2.init_sap_state(1, D, cfg), layout=TLAYOUT, cfg=cfg,
                                     init_idx=draws1)
    assert _rel(out.numpy(), _dense(_t(q), _t(k), _t(v)).numpy()) < 0.05
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5, rtol=0)


# tests/test_quality_gate.py's model and run
GATE_CFG = dict(dim=96, ffn_dim=192, num_heads=4, num_layers=3, freq_dim=32, text_dim=48, text_len=8)
GATE_RUN = dict(height=96, width=128, num_frames=9, num_inference_steps=4, guidance_scale=5.0, flow_shift=3.0,
                first_times_fp=0.25, first_layers_fp=0.0)
SEED = 11
SVG_GATE = dict(sparsity=0.3, num_sampled_rows=16)
SAP_GATE = dict(num_q_centroids=4, num_k_centroids=6, top_p_kmeans=0.85, kmeans_iter_init=6, kmeans_iter_step=2)
# f32 on both sides, 4 steps x 3 layers x CFG 5.0, the same draws: the
# latents within 1e-5 rel L2 (summation order only), the PSNRs within 1e-3 dB
LAT_TOL, PSNR_TOL_DB = 1e-5, 1e-3


def test_quality_gate_pipeline_matches_jax():
    from sparse_videogen_tpu.models.wan import model as JWM
    from sparse_videogen_tpu.pipelines import wan as JPW
    from sparse_videogen_tpu_torch.io.from_jax import wan_params_from_numpy
    from sparse_videogen_tpu_torch.models.wan import model as TWM
    from sparse_videogen_tpu_torch.pipelines import wan as TPW

    jcfg, tcfg = JWM.WanConfig(**GATE_CFG), TWM.WanConfig(**GATE_CFG)
    params = jax.tree.map(np.asarray, JWM.init_wan_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32))
    model = TWM.WanModel(tcfg, dtype=torch.float32)
    model.load_state_dict(wan_params_from_numpy(params, tcfg))
    rng = np.random.default_rng(7)
    ctx = rng.standard_normal((1, jcfg.text_len, jcfg.text_dim)).astype(np.float32)
    jpipe = JPW.WanPipeline(jcfg, jax.tree.map(jnp.asarray, params), dtype=jnp.float32)

    key, nkey = jax.random.split(jax.random.PRNGKey(SEED))
    lay = JPW.wan_layout(jcfg, GATE_RUN["height"], GATE_RUN["width"], GATE_RUN["num_frames"])
    lat0 = np.array(jax.random.normal(nkey, (1, 16, lay.num_frames, 12, 16), jnp.float32))
    steps, n_layers, H = GATE_RUN["num_inference_steps"], jcfg.num_layers, jcfg.num_heads
    rows = [torch.stack([_ints(jax.random.fold_in(jax.random.fold_in(key, i), li), (16,), lay.seq_len)
                         for li in range(n_layers)]) for i in range(steps)]

    def draws(i, li):
        rq, rk = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, i), li))
        return _ints(rq, (H, 4), lay.seq_len), _ints(rk, (H, 6), lay.seq_len)

    kmeans_init = [[{li: draws(i, li) for li in range(n_layers)}] * 2 for i in range(steps)]
    runs = {"dense": ({}, {}), "SVG": ({"svg": JC.SVGConfig(**SVG_GATE)}, {"svg": TC.SVGConfig(**SVG_GATE),
                                                                            "profile_rows": rows}),
            "SAP": ({"sap": JC.SAPConfig(**SAP_GATE)}, {"sap": TC.SAPConfig(**SAP_GATE), "kmeans_init": kmeans_init})}
    ours, ref = {}, {}
    for pattern, (jkw, tkw) in runs.items():
        ref[pattern] = np.asarray(jpipe.generate_latents(jnp.asarray(ctx), jnp.asarray(ctx * 0), pattern=pattern,
                                                         seed=SEED, **GATE_RUN, **jkw))
        tkw = {"svg": TC.SVGConfig(), **tkw}
        ours[pattern] = TPW.WanPipeline(model)._denoise(_t(ctx), _t(ctx * 0), _t(lat0), pattern=pattern,
                                                        **GATE_RUN, **tkw).numpy()
        assert np.isfinite(ours[pattern]).all()
        assert _rel(ours[pattern], ref[pattern]) <= LAT_TOL, (pattern, _rel(ours[pattern], ref[pattern]))
    for pattern in ("SVG", "SAP"):
        mo, mj = float(np.abs(ours["dense"]).max()), float(np.abs(ref["dense"]).max())
        p_ours, p_ref = psnr(ours[pattern], ours["dense"], mo), j_psnr(ref[pattern], ref["dense"], mj)
        assert abs(p_ours - p_ref) <= PSNR_TOL_DB, (pattern, p_ours, p_ref)
        assert 20 < p_ours < 200, (pattern, p_ours)


def test_quality_script_smoke(tmp_path):
    from sparse_videogen_tpu_torch.scripts import quality as Q

    out = tmp_path / "q.json"
    Q.main(["--smoke", "--device", "cpu", "--workers", "1", "--out", str(out)])
    rep = json.loads(out.read_text())
    assert set(rep["metrics"]) == {"svg1", "sap_cluster", "sap_tile", "dense_int8"}
    for name, m in rep["metrics"].items():
        for key in ("latent_psnr_db", "latent_ssim", "pixel_psnr_db", "pixel_ssim", "lpips_rf"):
            assert np.isfinite(m[key]), (name, key)
    assert all(0 < rep["metrics"][name]["density"] <= 1 for name in ("sap_cluster", "sap_tile"))
    assert set(rep["gate"]) >= {"svg1_pass", "sap_pass", "int8_pass", "min_psnr_db", "sap_min_psnr_db"}
    assert "not_measured" not in rep  # every leg of the JAX script runs
    assert rep["config"]["pixel_frames"] == [9, 96, 160, 3] and len(rep["seconds"]["dense"]["per_step_s"]) == 8
    assert len(rep["source"]["source_sha256_16"]) == 16


def test_quality_script_needs_a_card_without_device_cpu(tmp_path):
    """No fallback: the default --device cuda fails on a host without one."""
    from sparse_videogen_tpu_torch.scripts import quality as Q

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Q.main(["--smoke", "--out", str(tmp_path / "q.json")])
