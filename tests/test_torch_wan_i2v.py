"""Wan 2.1 I2V in the torch port against the JAX package: the DiT's image
branch (img_emb, k_img / v_img / norm_k_img and the second softmax over the
image tokens), build_i2v_condition, the I2V checkpoint conversion and the
pipeline with clip_fea and latent_cond (dense and SVG1 over 2 steps, SAP
over 1), from the same numpy weights and inputs; JAX's initial noise, SVG1
profiler rows and SAP k-means draws are handed to the port. The JAX Pallas
kernels run in interpret mode, the port's plain versions on the CPU.
Tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.io import checkpoint as JCK
from sparse_videogen_tpu.models.wan import model as JWM
from sparse_videogen_tpu.pipelines import wan as JPW
from sparse_videogen_tpu_torch import config as TC
from sparse_videogen_tpu_torch.io import checkpoint as TCK
from sparse_videogen_tpu_torch.io.from_jax import wan_params_from_numpy
from sparse_videogen_tpu_torch.models.wan import model as TWM
from sparse_videogen_tpu_torch.pipelines import wan as TPW
from tests.test_checkpoint import make_sd_diffusers, make_sd_wan_orig
from tests.test_torch_sap import _jax_draws
from tests.test_torch_wan import bf16_tree, layer_rows, rel_err

CFG_KW = dict(model_type="i2v", in_dim=36, dim=128, ffn_dim=256, num_heads=2, num_layers=2, freq_dim=32,
              text_dim=48, text_len=8, image_dim=40)
JCFG, TCFG = JWM.WanConfig(**CFG_KW), TWM.WanConfig(**CFG_KW)
# latents (B, 16, 3, 10, 16) -> token grid (3, 5, 8): S = 120, head_dim 64; 257 CLIP tokens
H_LAT, W_LAT, NUM_FRAMES, N_CLIP = 10, 16, 9, 257
SVG_KW = dict(sparsity=0.25, num_sampled_rows=32)
SVG, JSVG = TC.SVGConfig(**SVG_KW), JC.SVGConfig(**SVG_KW)
t = lambda a: torch.from_numpy(np.array(a))


def _leaf(rng, path, shape):
    """init_wan_params' scales from numpy (JAX's init compiles for seconds),
    every leaf perturbed so that no zero bias or unit norm weight hides a
    layout slip: linear weights N(0, 1/d_in), modulation tables N(0, 1/dim),
    norm weights 1 + 0.05 N(0, 1), biases 0.05 N(0, 1)."""
    name = jax.tree_util.keystr(path)
    r = rng.standard_normal(shape)
    if name.endswith("['w']") and len(shape) >= 2 and "norm" not in name:
        return (r / np.sqrt(shape[-2])).astype(np.float32)
    if "modulation" in name:
        return (r / np.sqrt(shape[-1])).astype(np.float32)
    base = 1.0 if "norm" in name and not name.endswith("['b']") else 0.0
    return (base + 0.05 * r).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    """Numpy weights in the structure of JAX's I2V init (f32)."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: JWM.init_wan_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32))
    return jax.tree_util.tree_map_with_path(lambda path, s: _leaf(rng, path, s.shape), shapes)


@pytest.fixture(scope="module")
def model(params):
    m = TWM.WanModel(TCFG, dtype=torch.float32, device="cpu")
    m.load_state_dict(wan_params_from_numpy(params, TCFG))
    return m


def inputs(seed, batch):
    """x (batch, in_dim, ...) = noise + condition channels, text, CLIP features."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, JCFG.in_dim, 3, H_LAT, W_LAT)).astype(np.float32)
    ctx = rng.standard_normal((batch, JCFG.text_len, JCFG.text_dim)).astype(np.float32)
    clip = rng.standard_normal((batch, N_CLIP, JCFG.image_dim)).astype(np.float32)
    return x, ctx, clip


def test_i2v_model_builds_and_converts(params, model):
    """WanModel(model_type="i2v") holds img_emb and each block's image
    branch, f32 norms in a bf16 model; every key of JAX's tree lands."""
    sd = model.state_dict()
    assert set(sd) == set(wan_params_from_numpy(params, TCFG))
    assert {"img_emb.fc1.weight", "img_emb.norm2.bias", "blocks.1.cross_attn.k_img.weight",
            "blocks.1.cross_attn.norm_k_img"} <= set(sd)
    np.testing.assert_array_equal(sd["blocks.1.cross_attn.v_img.weight"].numpy(),
                                  params["blocks"]["cross_attn"]["v_img"]["w"][1].T)
    bf = TWM.WanModel(TCFG, dtype=torch.bfloat16).init_random(torch.Generator().manual_seed(0))
    assert bf.img_emb["norm1"].weight.dtype == torch.float32 and bf.img_emb["fc1"].weight.dtype == torch.bfloat16
    assert bf.blocks[0].cross_attn.norm_k_img.dtype == torch.float32
    with pytest.raises(ValueError, match="model_type"):
        TWM.WanModel(TWM.WanConfig(model_type="v2v", dim=128, num_heads=2, num_layers=1))


@pytest.mark.parametrize("pattern", ["dense", "SVG"])
def test_i2v_forward_matches_jax(params, model, pattern):
    """One forward with clip_fea, layer 0 in dense warm-up and layer 1 on the
    pattern. f32 over 2 blocks: rel L2 error <= 1e-5."""
    lay = JPW.wan_layout(JCFG, 8 * H_LAT, 8 * W_LAT, NUM_FRAMES)
    x, ctx, clip = inputs(1, 2)
    tt = np.asarray([700.0, 700.0], np.float32)
    key = jax.random.PRNGKey(2)
    jrt = JPW.make_wan_runtime(lay, pattern=pattern, warmup=JC.WarmupSchedule(first_layers=1), svg=JSVG)
    ref, _ = JWM.wan_forward(params, JCFG, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(ctx),
                             clip_fea=jnp.asarray(clip), attention=jrt, rng=key)
    trt = TPW.make_wan_runtime(TPW.wan_layout(TCFG, 8 * H_LAT, 8 * W_LAT, NUM_FRAMES), device="cpu", pattern=pattern,
                               warmup=TC.WarmupSchedule(first_layers=1), svg=SVG)
    ours = TWM.wan_forward(model, t(x), t(tt), t(ctx), clip_fea=t(clip), attention=trt,
                           profile_rows=layer_rows(key, JCFG.num_layers, lay.seq_len))
    assert ours.shape == (2, 16, 3, H_LAT, W_LAT)
    assert rel_err(ours.numpy(), ref) <= 1e-5
    # the image branch moves the output
    plain = TWM.wan_forward(model, t(x), t(tt), t(ctx), attention=trt,
                            profile_rows=layer_rows(key, JCFG.num_layers, lay.seq_len))
    assert rel_err(plain.numpy(), ref) > 1e-3


def test_i2v_forward_bf16_matches_jax(params):
    """The card's working type: the same bf16 weights on both sides, dense.
    bf16 keeps 8 bits and the frameworks round at other places: rel L2
    error <= 5e-2."""
    lay = JPW.wan_layout(JCFG, 8 * H_LAT, 8 * W_LAT, NUM_FRAMES)
    jparams = bf16_tree(params, jax.eval_shape(lambda: JWM.init_wan_params(jax.random.PRNGKey(0), JCFG,
                                                                             dtype=jnp.bfloat16)))
    x, ctx, clip = inputs(4, 1)
    tt = np.asarray([500.0], np.float32)
    jrt = JPW.make_wan_runtime(lay, pattern="dense", svg=JSVG)
    ref, _ = JWM.wan_forward(jparams, JCFG, jnp.asarray(x, jnp.bfloat16), jnp.asarray(tt),
                             jnp.asarray(ctx, jnp.bfloat16), clip_fea=jnp.asarray(clip, jnp.bfloat16), attention=jrt)
    m = TWM.WanModel(TCFG, dtype=torch.bfloat16)
    m.load_state_dict(wan_params_from_numpy(params, TCFG))
    trt = TPW.make_wan_runtime(TPW.wan_layout(TCFG, 8 * H_LAT, 8 * W_LAT, NUM_FRAMES), device="cpu", pattern="dense")
    ours = m(t(x).to(torch.bfloat16), t(tt), t(ctx).to(torch.bfloat16), clip_fea=t(clip).to(torch.bfloat16),
             attention=trt)
    assert rel_err(ours.float().numpy(), np.asarray(ref, np.float32)) <= 5e-2


def test_build_i2v_condition_equals_jax():
    """The first-frame mask and the latents: exact."""
    lat = np.random.default_rng(0).standard_normal((2, 16, 5, 4, 6)).astype(np.float32)
    ref = np.asarray(JPW.build_i2v_condition(jnp.asarray(lat)))
    ours = TPW.build_i2v_condition(t(lat))
    assert ours.shape == (2, 20, 5, 4, 6)
    np.testing.assert_array_equal(ours.numpy(), ref)


def _i2v_sd(cfg, naming):
    """tests/test_checkpoint.py's Wan state dicts with the I2V keys added in
    the same naming (random values)."""
    rng = np.random.default_rng(3)
    d, di = cfg.dim, cfg.image_dim
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    if naming == "wan_orig":
        sd = make_sd_wan_orig(cfg)
        for i in range(cfg.num_layers):
            b = f"blocks.{i}.cross_attn"
            sd.update({f"{b}.k_img.weight": r(d, d), f"{b}.k_img.bias": r(d), f"{b}.v_img.weight": r(d, d),
                       f"{b}.v_img.bias": r(d), f"{b}.norm_k_img.weight": r(d)})
        names = ("img_emb.proj.0", "img_emb.proj.1", "img_emb.proj.3", "img_emb.proj.4")
    else:
        sd = make_sd_diffusers(cfg)
        for i in range(cfg.num_layers):
            b = f"blocks.{i}.attn2"
            sd.update({f"{b}.add_k_proj.weight": r(d, d), f"{b}.add_k_proj.bias": r(d),
                       f"{b}.add_v_proj.weight": r(d, d), f"{b}.add_v_proj.bias": r(d),
                       f"{b}.norm_added_k.weight": r(d)})
        p = "condition_embedder.image_embedder"
        names = (f"{p}.norm1", f"{p}.ff.net.0.proj", f"{p}.ff.net.2", f"{p}.norm2")
    for name, shape_w, shape_b in zip(names, ((di,), (d, di), (d, d), (d,)), ((di,), (d,), (d,), (d,))):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = r(*shape_w), r(*shape_b)
    return sd


@pytest.mark.parametrize("naming", ["wan_orig", "diffusers"])
def test_convert_i2v_checkpoint_equals_jax(naming):
    """An I2V checkpoint in either naming converts to the weights JAX's
    convert_wan_dit gives (after the layout change): equal."""
    cfg_kw = dict(CFG_KW, dim=32, ffn_dim=64, num_heads=4, text_dim=24, image_dim=20)
    jcfg, tcfg = JWM.WanConfig(**cfg_kw), TWM.WanConfig(**cfg_kw)
    sd = _i2v_sd(jcfg, naming)
    ref = wan_params_from_numpy(jax.tree.map(np.asarray, JCK.convert_wan_dit(sd, jcfg, dtype=jnp.float32)), tcfg)
    ours = TCK.convert_wan_dit({k: t(v) for k, v in sd.items()}, tcfg)
    m = TWM.WanModel(tcfg, dtype=torch.float32)
    m.load_state_dict(ours)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert torch.equal(ours[k].reshape(v.shape).float(), v.float()), k


def _pipeline_kw(pattern, steps):
    return dict(height=8 * H_LAT, width=8 * W_LAT, num_frames=NUM_FRAMES, num_inference_steps=steps,
                guidance_scale=5.0, flow_shift=3.0, pattern=pattern, first_layers_fp=0.5,
                first_times_fp=0.34 if pattern != "SAP" else 0.0)


@pytest.mark.parametrize("pattern", ["dense", "SVG"])
def test_generate_latents_i2v_matches_jax(params, model, pattern):
    """2 UniPC steps with batched CFG (clip_fea and latent_cond duplicated),
    one warm-up layer and one dense warm-up step, from JAX's initial noise
    and with JAX's profiler rows: f32 latents within rel L2 1e-5."""
    steps, seed = 2, 0
    kw = _pipeline_kw(pattern, steps)
    rng = np.random.default_rng(3)
    ctx, ctx_null = (rng.standard_normal((1, JCFG.text_len, JCFG.text_dim)).astype(np.float32) for _ in range(2))
    clip = rng.standard_normal((1, N_CLIP, JCFG.image_dim)).astype(np.float32)
    img_lat = (0.5 * rng.standard_normal((1, 16, 3, H_LAT, W_LAT))).astype(np.float32)
    jcond = JPW.build_i2v_condition(jnp.asarray(img_lat))
    ref = JPW.WanPipeline(JCFG, params, dtype=jnp.float32).generate_latents(
        jnp.asarray(ctx), jnp.asarray(ctx_null), seed=seed, svg=JSVG, clip_fea=jnp.asarray(clip), latent_cond=jcond,
        **kw)
    key, nkey = jax.random.split(jax.random.PRNGKey(seed))
    lay = JPW.wan_layout(JCFG, kw["height"], kw["width"], NUM_FRAMES)
    lat0 = np.array(jax.random.normal(nkey, (1, 16, lay.num_frames, H_LAT, W_LAT), jnp.float32))
    rows = [layer_rows(jax.random.fold_in(key, i), JCFG.num_layers, lay.seq_len) for i in range(steps)]
    ours = TPW.WanPipeline(model)._denoise(t(ctx), t(ctx_null), t(lat0), profile_rows=rows, svg=SVG, clip_fea=t(clip),
                                           latent_cond=TPW.build_i2v_condition(t(img_lat)), **kw)
    assert np.isfinite(ours.numpy()).all() and ours.shape == (1, 16, 3, H_LAT, W_LAT)
    assert rel_err(ours.numpy(), ref) <= 1e-5


def test_generate_latents_i2v_sap_matches_jax(params, model):
    """One SAP step: cond and uncond as separate batch-1 forwards, each with
    clip_fea and latent_cond; layer 0 dense, layer 1 cold with JAX's k-means
    draws handed in: f32 latents within rel L2 1e-5."""
    sap_kw = dict(num_q_centroids=4, num_k_centroids=8, kmeans_iter_init=8, block_q=128, block_kv=256)
    kw = _pipeline_kw("SAP", 1)
    rng = np.random.default_rng(6)
    ctx, ctx_null = (rng.standard_normal((1, JCFG.text_len, JCFG.text_dim)).astype(np.float32) for _ in range(2))
    clip = rng.standard_normal((1, N_CLIP, JCFG.image_dim)).astype(np.float32)
    img_lat = (0.5 * rng.standard_normal((1, 16, 3, H_LAT, W_LAT))).astype(np.float32)
    ref = JPW.WanPipeline(JCFG, params, dtype=jnp.float32).generate_latents(
        jnp.asarray(ctx), jnp.asarray(ctx_null), seed=0, sap=JC.SAPConfig(**sap_kw), clip_fea=jnp.asarray(clip),
        latent_cond=JPW.build_i2v_condition(jnp.asarray(img_lat)), **kw)
    key, nkey = jax.random.split(jax.random.PRNGKey(0))
    lay = JPW.wan_layout(JCFG, kw["height"], kw["width"], NUM_FRAMES)
    lat0 = np.array(jax.random.normal(nkey, (1, 16, lay.num_frames, H_LAT, W_LAT), jnp.float32))
    sap = TC.SAPConfig(**sap_kw)
    draws = [[{li: _jax_draws(jax.random.fold_in(jax.random.fold_in(key, 0), li), JCFG.num_heads, lay.seq_len, sap)
               for li in range(JCFG.num_layers)}] * 2]
    ours = TPW.WanPipeline(model)._denoise(t(ctx), t(ctx_null), t(lat0), kmeans_init=draws, svg=SVG, sap=sap,
                                           clip_fea=t(clip), latent_cond=TPW.build_i2v_condition(t(img_lat)), **kw)
    assert np.isfinite(ours.numpy()).all()
    assert rel_err(ours.numpy(), ref) <= 1e-5
