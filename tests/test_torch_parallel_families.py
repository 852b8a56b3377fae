"""The mesh paths of the HunyuanVideo, CogVideoX and Cosmos pipelines of the
torch port against the JAX pipelines with a mesh (conftest's virtual CPU
devices), and one CLI under torchrun with --ulysses_degree.

The port's ranks are threads (parallel/comm.ThreadRanks): the ring
(rp = 2) for dense, on HunyuanVideo's text-last layout with the live prompt
length, on CogVideoX's text-first one, and Cosmos's SAP ring; Ulysses
(sp = 2) for SVG1 and SAP. Each runs the tiny f32 models of the families'
own tests (tests/test_torch_{hyvideo,cog,cosmos}.py) from JAX's initial
noise, with JAX's profiler rows and JAX's k-means draws (under Ulysses, the
draw at B*H/sp rows each shard makes from its replicated key): latents
within rel L2 1e-4, as those tests hold the single-device pipelines.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.models.cog import model as JCOG
from sparse_videogen_tpu.models.cosmos import model as JCOS
from sparse_videogen_tpu.models.hyvideo import model as JHM
from sparse_videogen_tpu.parallel import make_mesh as jax_make_mesh
from sparse_videogen_tpu.pipelines import cog as JPCOG
from sparse_videogen_tpu.pipelines import cosmos as JPCOS
from sparse_videogen_tpu.pipelines import hyvideo as JPH
from sparse_videogen_tpu.schedulers import edm_euler as JEDM
from sparse_videogen_tpu_torch import config as TC
from sparse_videogen_tpu_torch.io.from_jax import cog_params_from_numpy, cosmos_params_from_numpy, \
    hyvideo_params_from_numpy
from sparse_videogen_tpu_torch.models.cosmos import model as TCOS
from sparse_videogen_tpu_torch.parallel.comm import ThreadRanks
from sparse_videogen_tpu_torch.parallel.ring_runtime import RingDenseRuntime, RingSAPRuntime
from sparse_videogen_tpu_torch.parallel.ulysses import UlyssesRuntime
from sparse_videogen_tpu_torch.pipelines import cog as TPCOG
from sparse_videogen_tpu_torch.pipelines import cosmos as TPCOS
from sparse_videogen_tpu_torch.pipelines import hyvideo as TPH
from tests import test_torch_cog as COG
from tests import test_torch_cosmos as COS
from tests import test_torch_hyvideo as HY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"ring": (dict(rp=2), dict(rp=2, sp=1)), "ulysses": (dict(sp=2), dict(sp=2))}
f = torch.from_numpy


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _perturbed(tree, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + 0.05 * rng.standard_normal(a.shape)).astype(
        np.float32), tree)


def _meshes(name):
    tkw, jkw = MESHES[name]
    return ThreadRanks(**tkw), jax_make_mesh(2, **jkw)


def _draws(key, rows, n_tokens, cfg):
    rq, rk = jax.random.split(key)
    return (f(np.array(jax.random.randint(rq, (rows, cfg.num_q_centroids), 0, n_tokens))),
            f(np.array(jax.random.randint(rk, (rows, cfg.num_k_centroids), 0, n_tokens))))


@pytest.mark.parametrize("mesh,pattern", [("ring", "dense"), ("ulysses", "SVG"), ("ulysses", "SAP")])
def test_hyvideo_pipeline_on_a_mesh_matches_jax(mesh, pattern):
    """HunyuanVideo, 2 Euler steps (layer 0 dense warm-up), prompt 5 of 8
    text tokens: the ring runs dense on the text-last layout with the live
    prompt length; Ulysses runs SVG1 and SAP (cold with JAX's per-shard
    draws at step 0, warm at step 1)."""
    params = _perturbed(JHM.init_hyvideo_params(jax.random.PRNGKey(0), HY.JCFG, dtype=jnp.float32))
    model = hyvideo_params_from_numpy(params, HY.TCFG)
    ranks, jmesh = _meshes(mesh)
    steps, seed = 2, 0
    sap_kw = dict(num_q_centroids=4, num_k_centroids=8, top_p_kmeans=0.7, kmeans_iter_init=6, kmeans_iter_step=8,
                  block_q=128, block_kv=256)
    kw = dict(height=8 * HY.H_LAT, width=8 * HY.W_LAT, num_frames=HY.NUM_FRAMES, num_inference_steps=steps,
              embedded_guidance_scale=6.0, flow_shift=7.0, pattern=pattern, first_layers_fp=0.25,
              first_times_fp=0.0)
    text, mask, pooled = HY._text(np.random.default_rng(3))
    ref = JPH.HyVideoPipeline(HY.JCFG, params, dtype=jnp.float32).generate_latents(
        jnp.asarray(text), jnp.asarray(mask), jnp.asarray(pooled), prompt_length=HY.PROMPT, seed=seed,
        svg=JC.SVGConfig(**HY.SVG_KW), sap=JC.SAPConfig(**sap_kw), mesh=jmesh, **kw)
    key, nkey = jax.random.split(jax.random.PRNGKey(seed))
    lat0 = np.array(jax.random.normal(nkey, (1, 16, 3, HY.H_LAT, HY.W_LAT), jnp.float32))
    vl = 3 * (HY.H_LAT // 2) * (HY.W_LAT // 2)
    n_layers = HY.TCFG.num_layers
    rows = [HY.layer_rows(jax.random.fold_in(key, i), n_layers, vl + HY.JCFG.text_len) for i in range(steps)]
    sap = TC.SAPConfig(**sap_kw)
    draws = [{li: _draws(jax.random.fold_in(jax.random.fold_in(key, i), li), HY.CFG_KW["heads_num"] // 2, vl, sap)
              for li in range(n_layers)} for i in range(steps)]
    ours = TPH.HyVideoPipeline(model)._denoise(f(text), f(mask), f(pooled), f(lat0), prompt_length=HY.PROMPT,
                                               svg=TC.SVGConfig(**HY.SVG_KW), sap=sap, profile_rows=rows,
                                               kmeans_init=draws if pattern == "SAP" else None, mesh=ranks,
                                               **kw).numpy()
    lay = TPH.hyvideo_layout(HY.TCFG, kw["height"], kw["width"], kw["num_frames"])
    rt = TPH.make_hyvideo_runtime(lay, device="cpu", prompt_length=HY.PROMPT, pattern=pattern, sap=sap, mesh=ranks)
    assert isinstance(rt, RingDenseRuntime if mesh == "ring" else UlyssesRuntime)
    assert np.isfinite(ours).all() and rel_err(ours, ref) <= 1e-4


@pytest.mark.parametrize("mesh,pattern", [("ring", "dense"), ("ulysses", "SVG")])
def test_cog_pipeline_on_a_mesh_matches_jax(mesh, pattern):
    """CogVideoX I2V, 2 DDIM steps over the CFG pair (step 0 and layer 0
    dense), the whole text live, through parallelize_runtime: the ring on
    the text-first layout (dense), Ulysses for SVG1."""
    params = _perturbed(JCOG.init_cog_params(jax.random.PRNGKey(0), COG.JCFG, dtype=jnp.float32))
    model = cog_params_from_numpy(params, COG.TCFG)
    ranks, jmesh = _meshes(mesh)
    steps, seed = 2, 0
    kw = dict(height=8 * COG.H_LAT, width=8 * COG.W_LAT, num_frames=COG.NUM_FRAMES, num_inference_steps=steps,
              guidance_scale=6.0, pattern=pattern, first_layers_fp=0.5, first_times_fp=0.5)
    rng = np.random.default_rng(3)
    ctx, ctx_null = (rng.standard_normal((1, COG.JCFG.text_len, COG.JCFG.text_dim)).astype(np.float32)
                     for _ in range(2))
    img = rng.standard_normal((1, 16, 1, COG.H_LAT, COG.W_LAT)).astype(np.float32)
    ref = JPCOG.CogPipeline(COG.JCFG, params, dtype=jnp.float32).generate_latents(
        jnp.asarray(ctx), jnp.asarray(ctx_null), jnp.asarray(img), seed=seed, svg=JC.SVGConfig(**COG.SVG_KW),
        mesh=jmesh, **kw)
    key, nkey = jax.random.split(jax.random.PRNGKey(seed))
    lat0 = np.array(jax.random.normal(nkey, (1, 16, 6, COG.H_LAT, COG.W_LAT), jnp.float32))
    seq = 3 * (COG.H_LAT // 2) * (COG.W_LAT // 2) + COG.JCFG.text_len
    rows = [COG.layer_rows(jax.random.fold_in(key, i), COG.TCFG.num_layers, seq) for i in range(steps)]
    ours = TPCOG.CogPipeline(model)._denoise(f(ctx), f(ctx_null), f(img), f(lat0), svg=TC.SVGConfig(**COG.SVG_KW),
                                             use_dynamic_cfg=False, profile_rows=rows, mesh=ranks, **kw).numpy()
    assert np.isfinite(ours).all() and rel_err(ours, ref) <= 1e-4


@pytest.mark.parametrize("mesh", ["ring", "ulysses"])
def test_cosmos_sap_on_a_mesh_matches_jax(mesh):
    """Cosmos, 4 EDM steps over the CFG batch (steps 0-1 and layer 0
    dense), SAP through parallelize_runtime: the SAP ring (global token
    draws over 2 x heads) and Ulysses (per-shard draws at 2 x heads / 2
    rows), cold at step 2 and warm at step 3."""
    params = _perturbed(JCOS.init_cosmos_params(jax.random.PRNGKey(0), COS.JCFG, dtype=jnp.float32))
    model = TCOS.CosmosModel(COS.TCFG, dtype=torch.float32)
    model.load_state_dict(cosmos_params_from_numpy(params, COS.TCFG))
    ranks, jmesh = _meshes(mesh)
    steps, seed = 4, 0
    kw = dict(height=8 * COS.H_LAT, width=8 * COS.W_LAT, num_frames=COS.NUM_FRAMES, num_inference_steps=steps,
              guidance_scale=7.0, pattern="SAP", first_layers_fp=0.5, first_times_fp=0.25)
    rng = np.random.default_rng(5)
    ctx, ctx_null = (rng.standard_normal((1, 24, COS.JCFG.text_embed_dim)).astype(np.float32) for _ in range(2))
    ref = np.asarray(JPCOS.CosmosPipeline(COS.JCFG, params, dtype=jnp.float32).generate_latents(
        jnp.asarray(ctx), jnp.asarray(ctx_null), seed=seed, svg=JC.SVGConfig(**COS.SVG_KW),
        sap=JC.SAPConfig(**COS.SAP_KW), mesh=jmesh, **kw))
    key, nkey = jax.random.split(jax.random.PRNGKey(seed))
    lay = COS._layouts()[1]
    lat0 = np.array(jax.random.normal(nkey, (1, 16, 3, COS.H_LAT, COS.W_LAT)), np.float32) * JEDM.EDMEuler(
        steps).init_noise_sigma
    sap = TC.SAPConfig(**COS.SAP_KW)
    bh = 2 * COS.TCFG.num_attention_heads // (2 if mesh == "ulysses" else 1)
    step_keys = [jax.random.fold_in(key, i) for i in range(steps)]
    ours = TPCOS.CosmosPipeline(model)._denoise(
        f(ctx), f(ctx_null), f(lat0.astype(np.float32)), svg=TC.SVGConfig(**COS.SVG_KW), sap=sap, mesh=ranks,
        profile_rows=[COS.layer_rows(k, lay.seq_len) for k in step_keys],
        kmeans_init=[{li: _draws(jax.random.fold_in(k, li), bh, lay.seq_len, sap) for li in range(COS.TCFG.num_layers)}
                     for k in step_keys], **kw).numpy()
    assert isinstance(TPCOS.make_cosmos_runtime(lay, device="cpu", pattern="SAP", sap=sap, mesh=ranks),
                      RingSAPRuntime if mesh == "ring" else UlyssesRuntime)
    assert np.isfinite(ours).all() and rel_err(ours, ref) <= 1e-4


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_ulysses_degree_2_gloo(tmp_path):
    """The Wan T2V CLI's --smoke run (SVG1, int8 linears) with
    --ulysses_degree 2 under torchrun (gloo, 2 processes) against the same
    run on one device: equal latents, since the profiler rows are drawn
    once from the same generator and each head's work is the same."""
    outs = []
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    args = ["-m", "sparse_videogen_tpu_torch.cli.wan_t2v", "--smoke", "--pattern", "SVG", "--quant", "int8",
            "--device", "cpu"]
    for name, launch in (("uly", [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
                                  "2", "--master_addr", "127.0.0.1", "--master_port", str(_free_port())]),
                         ("one", [sys.executable])):
        out = str(tmp_path / f"{name}.npz")
        extra = ["--ulysses_degree", "2"] if name == "uly" else []
        subprocess.run(launch + args + extra + ["--output_file", out], cwd=ROOT, env=env, check=True, timeout=300,
                       capture_output=True)
        outs.append(np.load(out)["latents"])
    assert outs[0].shape == (1, 16, 3, 12, 16) and np.isfinite(outs[0]).all()
    np.testing.assert_array_equal(outs[0], outs[1])
