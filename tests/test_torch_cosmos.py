"""Cosmos Text2World in the port (core/attention_ref.py,
models/cosmos/model.py, schedulers/edm_euler.py, pipelines/cosmos.py,
io/checkpoint.convert_cosmos_dit, io/from_jax.cosmos_params_from_numpy)
against the JAX package on the same numpy weights and inputs.

The pipeline runs one forward a step on the CFG batch of 2 (cond, uncond),
so SAP's k-means states cover 2 x heads; the port starts from JAX's noise
and takes JAX's SVG1 rows and k-means draws (fold_in(fold_in(key, step),
layer)), handed to CosmosPipeline._denoise.

Tolerances: configs, converters, RoPE tables and EDM timesteps exact;
sigmas within 1e-12; attention references rel L2 1e-6; the f32 forward rel
L2 1e-5 with the reference attention, 1e-4 through the runtimes (XLA's and
torch's f32 exp of the sinusoid's frequencies may differ by an ulp); the f32
pipelines rel L2 1e-4 and the SAP densities within 1e-6."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.core import attention_ref as JAR
from sparse_videogen_tpu.io import checkpoint as JCK
from sparse_videogen_tpu.models.cosmos import model as JCM
from sparse_videogen_tpu.pipelines import cosmos as JPC
from sparse_videogen_tpu.schedulers import edm_euler as JEDM
from sparse_videogen_tpu.sparse import runtimes as JRT
from sparse_videogen_tpu.sparse.svg1 import make_svg1_plan as j_plan
from sparse_videogen_tpu_torch.config import SAPConfig, SVGConfig, WarmupSchedule
from sparse_videogen_tpu_torch.core import attention_ref as TAR
from sparse_videogen_tpu_torch.io import checkpoint as TCK
from sparse_videogen_tpu_torch.io.from_jax import cosmos_params_from_numpy
from sparse_videogen_tpu_torch.models.cosmos import model as TCM
from sparse_videogen_tpu_torch.pipelines import cosmos as TPC
from sparse_videogen_tpu_torch.schedulers import EDMEuler
from tests.test_checkpoint import make_sd_cosmos

CFG_KW = dict(num_attention_heads=2, attention_head_dim=64, num_layers=2, text_embed_dim=48, adaln_lora_dim=16,
              max_size=(8, 16, 16))
JCFG, TCFG = JCM.CosmosConfig(**CFG_KW), TCM.CosmosConfig(**CFG_KW)
H_LAT = W_LAT = 16
NUM_FRAMES = 17  # 3 latent frames: S = 3 x 64 = 192
SVG_KW = dict(num_sampled_rows=16, sparsity=0.25)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(0)
    tree = JCM.init_cosmos_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + 0.05 * rng.standard_normal(a.shape)).astype(
        np.float32), tree)


@pytest.fixture(scope="module")
def model(params):
    m = TCM.CosmosModel(TCFG, dtype=torch.float32)
    m.load_state_dict(cosmos_params_from_numpy(params, TCFG))
    return m


def test_attention_references_match_jax():
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 3, 40, 16)).astype(np.float32) for _ in range(3))
    f = torch.from_numpy
    assert rel_err(TAR.dense_attention(f(q), f(k), f(v)), JAR.dense_attention(q, k, v)) <= 1e-6
    mask = rng.random((2, 3, 40, 40)) < 0.3
    mask[0, 0, 5] = False  # a row with no allowed column gives 0
    ours = TAR.masked_attention(f(q), f(k), f(v), torch.from_numpy(mask))
    assert rel_err(ours, JAR.masked_attention(q, k, v, mask)) <= 1e-6 and not ours[0, 0, 5].any()
    qs, ks = np.array([[[10, 20, 10]]] * 2), np.array([[[15, 25]]] * 2)
    dmap = rng.random((2, 1, 3, 2)) < 0.6
    dmap[..., 0] = True
    one = lambda x: x[:, :1]
    ref = JAR.dynamic_block_sparse_ref(one(q), one(k), one(v), dmap, qs, ks)
    out = TAR.dynamic_block_sparse_ref(f(one(q)), f(one(k)), f(one(v)), torch.from_numpy(dmap), torch.from_numpy(qs),
                                       torch.from_numpy(ks))
    assert rel_err(out, ref) <= 1e-6


def test_configs_and_rope_tables():
    assert dataclasses.asdict(TCM.COSMOS_7B) == dataclasses.asdict(JCM.COSMOS_7B)
    assert dataclasses.asdict(TCM.COSMOS_14B) == dataclasses.asdict(JCM.COSMOS_14B)
    assert TCM.COSMOS_7B.patch_in_channels == 17
    for cfg_t, cfg_j in ((TCM.COSMOS_7B, JCM.COSMOS_7B), (TCM.COSMOS_14B, JCM.COSMOS_14B)):
        for fps in (None, 30):
            ours = TCM.rope_3d(cfg_t, (4, 6, 10), fps)
            ref = JCM.rope_3d(cfg_j, (4, 6, 10), fps)
            for a, b in zip(ours, ref):
                np.testing.assert_array_equal(a, np.asarray(b))


def test_edm_euler_matches_jax():
    """Karras sigmas (f64) within 1e-12, c_noise timesteps exact, and the
    Euler step on the same f32 inputs."""
    for n in (3, 35):
        ours, ref = EDMEuler(n), JEDM.EDMEuler(n)
        np.testing.assert_allclose(ours.sigmas, ref.sigmas, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(ours.timesteps, ref.timesteps)
    rng = np.random.default_rng(2)
    x, out = (rng.standard_normal((1, 4, 2, 3, 3)).astype(np.float32) for _ in range(2))
    sch, jsch = EDMEuler(5), JEDM.EDMEuler(5)
    ref, _ = jsch.step(1, jnp.asarray(x), jnp.asarray(out))
    got, _ = sch.step(1, torch.from_numpy(x), torch.from_numpy(out))
    assert rel_err(got, ref) <= 1e-6


def test_warmup_offset_on_c_noise_timesteps():
    """The JAX reference's WarmupSchedule.from_fractions takes first_times =
    timesteps[n - 1] - 1.0, an offset for a 0-1000 scale; on Cosmos's
    c_noise timesteps a 35-step run takes 20 dense steps at first_times_fp
    0.075 (the fraction says 2) and 25 at 0.3 (the fraction says 10). The
    port reproduces it (ROADMAP.md section 3)."""
    ts = EDMEuler(35).timesteps
    for fp, dense in ((0.075, 20), (0.3, 25)):
        w = WarmupSchedule.from_fractions(0.025, fp, 28, ts)
        jw = JC.WarmupSchedule.from_fractions(0.025, fp, 28, JEDM.EDMEuler(35).timesteps)
        assert w.first_times == jw.first_times and int((ts > w.first_times).sum()) == dense


def test_convert_cosmos_dit_matches_jax():
    """diffusers' CosmosTransformer3DModel names (make_sd_cosmos): the port's
    convert_cosmos_dit equals JAX's carried over, bit for bit."""
    kw = dict(num_attention_heads=2, attention_head_dim=32, num_layers=2, text_embed_dim=24, adaln_lora_dim=8,
              max_size=(4, 8, 8))
    jcfg, tcfg = JCM.CosmosConfig(**kw), TCM.CosmosConfig(**kw)
    sd = make_sd_cosmos(jcfg)
    ref = cosmos_params_from_numpy(jax.tree.map(np.asarray, JCK.convert_cosmos_dit(sd, jcfg, dtype=jnp.float32)),
                                   tcfg)
    ours = TCK.convert_cosmos_dit({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    TCM.CosmosModel(tcfg, dtype=torch.float32).load_state_dict(ours)


def _layouts():
    return (JPC.cosmos_layout(JCFG, 8 * H_LAT, 8 * W_LAT, NUM_FRAMES),
            TPC.cosmos_layout(TCFG, 8 * H_LAT, 8 * W_LAT, NUM_FRAMES))


def layer_rows(key, seq):
    n = min(SVG_KW["num_sampled_rows"], seq)
    draw = lambda li: np.asarray(jax.random.randint(jax.random.fold_in(key, li), (n,), 0, min(10000, seq)))
    return torch.as_tensor(np.stack([draw(li) for li in range(TCFG.num_layers)]))


@pytest.mark.parametrize("pattern", ["reference", "dense", "SVG"])
def test_forward_matches_jax(params, model, pattern):
    """One forward over a CFG batch of 2 with c_noise timesteps: the
    reference attention (rel L2 1e-5), or the runtimes with layer 0 dense
    and layer 1 on the pattern (rel L2 1e-4)."""
    jl, tl = _layouts()
    assert (tl.num_frames, tl.frame_size) == (jl.num_frames, jl.frame_size) == (3, 64)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 3, H_LAT, W_LAT)).astype(np.float32)
    t = np.asarray([0.6, 0.6], np.float32)
    ctx = rng.standard_normal((2, 24, JCFG.text_embed_dim)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    f = torch.from_numpy
    if pattern == "reference":
        ref, _ = JCM.cosmos_forward(params, JCFG, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
        assert rel_err(model(f(x), f(t), f(ctx)), ref) <= 1e-5
        return
    warm = dict(first_layers=1)
    jplan = j_plan(jl, JC.SVGConfig(**SVG_KW), JC.WarmupSchedule(**warm))
    jrt = (JRT.DenseRuntime if pattern == "dense" else JRT.SVG1Runtime)(jplan)
    ref, _ = JCM.cosmos_forward(params, JCFG, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), attention=jrt,
                                attn_states=jnp.zeros((JCFG.num_layers, 0), jnp.int32), attn_consts=jrt.consts(),
                                rng=key)
    trt = TPC.make_cosmos_runtime(tl, device="cpu", pattern=pattern, warmup=WarmupSchedule(**warm),
                                  svg=SVGConfig(**SVG_KW))
    ours = model(f(x), f(t), f(ctx), attention=trt, profile_rows=layer_rows(key, tl.seq_len))
    assert rel_err(ours, ref) <= 1e-4


def _draws(key, BH, S, cfg):
    rq, rk = jax.random.split(key)
    return (torch.as_tensor(np.array(jax.random.randint(rq, (BH, cfg.num_q_centroids), 0, S))),
            torch.as_tensor(np.array(jax.random.randint(rk, (BH, cfg.num_k_centroids), 0, S))))


SAP_KW = dict(num_q_centroids=4, num_k_centroids=8, top_p_kmeans=0.7, kmeans_iter_init=8)


@pytest.mark.parametrize("pattern", ["dense", "SAP"])
def test_pipeline_matches_jax(params, model, tmp_path, pattern):
    """4 EDM steps over the CFG batch, from JAX's noise: first_times_fp 0.25
    makes steps 0 and 1 dense (the c_noise offset), steps 2 and 3 run the
    pattern (SAP: cold with JAX's draws, then warm, on 2 x heads), layer 0
    dense (first_layers_fp 0.5). f32 latents within rel L2 1e-4; SAP's
    density log as JAX's. SVG1 and SAP's tile mode run through the CLI test
    (tests/test_torch_cosmos_cli.py)."""
    steps, seed = 4, 0
    sap_kw = SAP_KW
    kw = dict(height=8 * H_LAT, width=8 * W_LAT, num_frames=NUM_FRAMES, num_inference_steps=steps,
              guidance_scale=7.0, pattern=pattern, first_layers_fp=0.5, first_times_fp=0.25)
    rng = np.random.default_rng(5)
    ctx, ctx_null = (rng.standard_normal((1, 24, JCFG.text_embed_dim)).astype(np.float32) for _ in range(2))
    jlog, tlog = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    ref = np.asarray(JPC.CosmosPipeline(JCFG, params, dtype=jnp.float32).generate_latents(
        jnp.asarray(ctx), jnp.asarray(ctx_null), seed=seed, svg=JC.SVGConfig(**SVG_KW), sap=JC.SAPConfig(**sap_kw),
        logging_file=str(jlog), **kw))
    key, nkey = jax.random.split(jax.random.PRNGKey(seed))
    lay = _layouts()[1]
    lat0 = np.array(jax.random.normal(nkey, (1, 16, 3, H_LAT, W_LAT), jnp.float32)) * JEDM.EDMEuler(
        steps).init_noise_sigma
    step_keys = [jax.random.fold_in(key, i) for i in range(steps)]
    sap = SAPConfig(**sap_kw)
    f = torch.from_numpy
    ours = TPC.CosmosPipeline(model)._denoise(
        f(ctx), f(ctx_null), f(lat0.astype(np.float32)), svg=SVGConfig(**SVG_KW), sap=sap, logging_file=str(tlog),
        profile_rows=[layer_rows(k, lay.seq_len) for k in step_keys],
        kmeans_init=[{li: _draws(jax.random.fold_in(k, li), 2 * TCFG.num_attention_heads, lay.seq_len, sap)
                      for li in range(TCFG.num_layers)} for k in step_keys], **kw).numpy()
    assert ours.shape == (1, 16, 3, H_LAT, W_LAT) and np.isfinite(ours).all()
    assert rel_err(ours, ref) <= 1e-4
    if pattern == "SAP":
        jrows, trows = ([json.loads(line) for line in open(p)] for p in (jlog, tlog))
        assert [(r["timestep"], r["layer"]) for r in trows] == [(r["timestep"], r["layer"]) for r in jrows]
        assert len(trows) == 2 and len(trows[0]["density"]) == 2 * TCFG.num_attention_heads
        np.testing.assert_allclose([r["density"] for r in trows], [r["density"] for r in jrows], rtol=1e-6)


def test_generate_latents_draws_noise_times_sigma(model):
    """generate_latents: noise from torch.Generator(seed) times the first
    sigma (80), the JAX pipeline's scale; deterministic."""
    ctx = torch.zeros(1, 8, TCFG.text_embed_dim)
    kw = dict(height=8 * H_LAT, width=8 * W_LAT, num_frames=9, num_inference_steps=1, seed=3)
    pipe = TPC.CosmosPipeline(model)
    a = pipe.generate_latents(ctx, ctx, **kw)
    b = pipe.generate_latents(ctx, ctx, **kw)
    assert torch.equal(a, b) and a.shape == (1, 16, 2, H_LAT, W_LAT) and torch.isfinite(a).all()
