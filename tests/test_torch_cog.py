"""CogVideoX 1.5 I2V slice of the torch port against the JAX package.

Text-first SVG1 machinery (masks, placement, plan metadata: exact, at small
layouts and at the real 768x1360x81 one), K1's cog kind at D = 64 (the
port's plain version against the JAX Pallas kernel in interpret mode), the
CogVideoX DDIM sampler, the DiT forward, a 2-step I2V pipeline with CFG and
the CLI. Each package builds its own config from the same values; both run
the same f32 weights (the JAX pytree, through
io/from_jax.cog_params_from_numpy), JAX's initial noise and the SVG1
profiler rows the JAX package draws. Tolerances are stated per test.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.core import masks as JM
from sparse_videogen_tpu.core import placement as JP
from sparse_videogen_tpu.models.cog import model as JCM
from sparse_videogen_tpu.ops import attention as JA
from sparse_videogen_tpu.ops import mask_spec as JMS
from sparse_videogen_tpu.pipelines import cog as JPC
from sparse_videogen_tpu.schedulers import ddim_cog as JD
from sparse_videogen_tpu.sparse import runtimes as JRT
from sparse_videogen_tpu.sparse import svg1 as JS1
from sparse_videogen_tpu_torch import config as TC
from sparse_videogen_tpu_torch.cli import cog_i2v as TCLI
from sparse_videogen_tpu_torch.core import masks as TM
from sparse_videogen_tpu_torch.core import placement as TP
from sparse_videogen_tpu_torch.io.from_jax import cog_params_from_numpy
from sparse_videogen_tpu_torch.models.cog import model as TCM
from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_kv
from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec
from sparse_videogen_tpu_torch.pipelines import cog as TPC
from sparse_videogen_tpu_torch.schedulers import ddim_cog as TD
from sparse_videogen_tpu_torch.sparse import runtimes as TRT
from sparse_videogen_tpu_torch.sparse import svg1 as TS1

# text-first layouts (num_frames, frame_size, text_len): partial sub-blocks, several chunks
LAYOUTS = [(3, 160, 8), (3, 256, 16), (4, 256, 226), (2, 224, 16)]
LAYOUT_IDS = [f"{t}+{f}x{fs}" for f, fs, t in LAYOUTS]


def _layouts(f, fs, text_len):
    kw = dict(num_frames=f, frame_size=fs, context_length=text_len)
    return (JC.VideoLayout(text_position=JC.TextPosition.FIRST, **kw),
            TC.VideoLayout(text_position=TC.TextPosition.FIRST, **kw))


@pytest.mark.parametrize("lay", LAYOUTS, ids=LAYOUT_IDS)
def test_text_first_masks_and_placement_equal(lay):
    """Profiling predicates (video-relative band, text rows/columns fully
    attended, no sink), the execution block mask (floor band, strict <,
    every row visits the text columns and the text rows visit everything),
    the index map with the video segment starting after the text, and the
    temporal re-layout with the text fixed: equal to the JAX package's."""
    jl, tl = _layouts(*lay)
    qi, ki = np.arange(jl.seq_len)[:, None], np.arange(jl.seq_len)[None, :]
    for name in ("spatial", "temporal"):
        for mul in (0.7, 1.5):
            ours = TM.profile_mask_predicate(tl, name, mul)(torch.as_tensor(qi), torch.as_tensor(ki))
            ref = JM.profile_mask_predicate(jl, name, mul, first_frame_sink=False)(qi, ki)
            np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    for mul in (0.4, 1.3):
        for bq, bkv in ((128, 128), (256, 128)):
            ours = TM.execution_mask_block(tl, mul, block_q=bq, block_kv=bkv)
            np.testing.assert_array_equal(ours, JM.execution_mask_block(
                jl, mul, block_q=bq, block_kv=bkv, first_frame_sink=False, round_mode="floor"))
            assert ours[:, 0].all() and ours[0].all()
    g = TM.temporal_index_map(tl)
    np.testing.assert_array_equal(g, JM.temporal_index_map(jl))
    np.testing.assert_array_equal(g[:lay[2]], np.arange(lay[2]))
    x = np.random.default_rng(0).standard_normal((2, 3, jl.seq_len, 8)).astype(np.float32)
    for inverse in (False, True):
        ours = TP.temporal_transpose(torch.from_numpy(x), tl, inverse=inverse).numpy()
        np.testing.assert_array_equal(ours, np.asarray(JP.temporal_transpose(jnp.asarray(x), jl, inverse=inverse)))
        np.testing.assert_array_equal(ours[..., :lay[2], :], x[..., :lay[2], :])


def _plans_equal(ours, ref):
    assert ours.mask_kind == ref.mask_kind == "cog"
    assert (ours.block_q, ours.block_kv, ours.seq_pad_q, ours.seq_pad_kv, ours.multiplier) == (
        ref.block_q, ref.block_kv, ref.seq_pad_q, ref.seq_pad_kv, ref.multiplier)
    assert ours.dense_block_q == ref.dense_exec[0]
    assert ours.mask_spec == MaskSpec(**vars(ref.mask_spec)) and ours.mask_spec.band_width > 0
    assert ours.dense_mask_spec == MaskSpec(**vars(ref.dense_mask_spec)) == MaskSpec()


def _runtime_meta_equal(ours, ref, pl):
    """The runtimes' cheap-first metadata and aux: integer-equal."""
    np.testing.assert_array_equal(ours.default_aux(pl), np.asarray(ref.default_aux(pl)))
    rt = TRT.SVG1Runtime(ours, device="cpu", prompt_length=pl)
    consts = JRT.SVG1Runtime(ref, prompt_length=pl).consts()
    for name in ("dense_meta", "sparse_meta", "aux"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(), np.asarray(consts[name]))
    return rt


@pytest.mark.parametrize("lay", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("bq", [None, 128])
def test_cog_plan_metadata_equal(lay, bq):
    """The cog plan: mask spec (floor band, strict <), the unmasked dense
    spec, aux = [prompt_length, 0, 0, 0], the dense path's block_q, the
    plain and the runtimes' cheap-first metadata at the whole text and at a
    shorter prompt: integer-equal."""
    jl, tl = _layouts(*lay)
    ours = TS1.make_svg1_plan(tl, TC.SVGConfig(sparsity=0.6), block_q=bq, block_kv=256)
    ref = JS1.make_svg1_plan(jl, JC.SVGConfig(sparsity=0.6), block_q=bq, block_kv=256)
    _plans_equal(ours, ref)
    np.testing.assert_array_equal(ours.sparse_meta(), np.asarray(ref.sparse_meta()))
    np.testing.assert_array_equal(ours.dense_meta(), np.asarray(ref.dense_meta()))
    for pl in (None, 3, lay[2]):
        rt = _runtime_meta_equal(ours, ref, pl)
        if pl == lay[2] and bq == 128:  # a text-first mask has chunks that need the predicate
            e0 = rt.sparse_meta[..., 0].numpy()
            assert (e0 // 4096 < e0 % 4096).any()


def test_real_layout_plan_equal():
    """COG_1_5_5B_I2V at 768x1360x81 (the slice's own layout): 11 x 4080
    video tokens after 226 text tokens (S = 45,106), SVG1 band 5,760 tokens,
    dense block_q 2048; the runtimes' metadata equal to JAX's."""
    lay = TPC.cog_layout(TCM.COG_1_5_5B_I2V, 768, 1360, 81)
    jlay = JPC.cog_layout(JCM.COG_1_5_5B_I2V, 768, 1360, 81)
    assert (lay.num_frames, lay.frame_size, lay.context_length, lay.seq_len) == (
        jlay.num_frames, jlay.frame_size, jlay.context_length, jlay.seq_len) == (11, 4080, 226, 45106)
    svg = dict(num_sampled_rows=32, sparsity=0.25)
    ours = TS1.make_svg1_plan(lay, TC.SVGConfig(**svg))
    ref = JS1.make_svg1_plan(jlay, JC.SVGConfig(**svg))
    _plans_equal(ours, ref)
    assert ours.mask_spec.band_width == 5760 and ours.dense_block_q == 2048
    _runtime_meta_equal(ours, ref, 226)


@pytest.mark.parametrize("which", ["dense", "svg1"])
def test_k1_cog_plain_matches_jax(which):
    """K1 at D = 64: the cog kind (SVG1) and the unmasked dense path, the
    port's plain version (what a CPU tensor runs) against the JAX kernel in
    interpret mode, on the runtime's cheap-first metadata and aux with the
    whole text live. f32, the same exp2 online softmax over the same
    chunks: atol 1e-5 on outputs of size ~1."""
    jl, tl = _layouts(3, 160, 16)
    plan = TS1.make_svg1_plan(tl, TC.SVGConfig(sparsity=0.6), block_q=128, block_kv=256)
    rt = TRT.SVG1Runtime(plan, device="cpu", prompt_length=16)
    meta, spec, bq = ((rt.dense_meta, plan.dense_mask_spec, plan.dense_block_q) if which == "dense"
                      else (rt.sparse_meta, plan.mask_spec, plan.block_q))
    rng = np.random.default_rng(4)
    BH, D = 2, 64
    sq = -(-tl.seq_len // bq) * bq
    q = np.zeros((BH, sq, D), np.float32)
    k, v = (np.zeros((BH, plan.seq_pad_kv, D), np.float32) for _ in range(2))
    for a, sc in ((q, 2.0), (k, 1.0), (v, 1.0)):
        a[:, :tl.seq_len] = rng.standard_normal((BH, tl.seq_len, D)) * sc
    kw = dict(block_q=bq, block_kv=plan.block_kv)
    ours = block_sparse_attention_kv(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), meta, rt.aux,
                                     mask_spec=spec, **kw).numpy()
    ref = np.asarray(JA.block_sparse_attention_kv(jnp.asarray(q), JA.pack_kv(jnp.asarray(k), jnp.asarray(v)),
                                                  jnp.asarray(meta.numpy()), jnp.asarray(rt.aux.numpy()),
                                                  mask_spec=JMS.MaskSpec(**vars(spec)), **kw))
    S = tl.seq_len
    np.testing.assert_allclose(ours[:, :S], ref[:, :S], atol=1e-5, rtol=0)


def test_cog_ddim_matches_jax():
    """The f64 tables and integer timesteps are equal; the f32 v-prediction
    steps agree to 1e-6; the dynamic CFG scale is the same float."""
    for n in (2, 5, 50):
        ours, ref = TD.CogDDIM(n), JD.CogDDIM(n)
        np.testing.assert_array_equal(ours.alphas_cumprod, ref.alphas_cumprod)
        np.testing.assert_array_equal(ours.timesteps, ref.timesteps)
        assert ours.timesteps.dtype == ref.timesteps.dtype
        rng = np.random.default_rng(n)
        x = rng.standard_normal((1, 4, 2, 3, 3)).astype(np.float32)
        xo, xr = torch.from_numpy(x), jnp.asarray(x)
        for i in range(min(n, 5)):
            v = rng.standard_normal(x.shape).astype(np.float32)
            xo, _ = ours.step(i, xo, torch.from_numpy(v))
            xr, _ = ref.step(i, xr, jnp.asarray(v))
            np.testing.assert_allclose(xo.numpy(), np.asarray(xr), atol=1e-6, rtol=1e-6)
        for t in ours.timesteps[:3]:
            assert TD.dynamic_cfg_scale(6.0, float(t), n) == JD.dynamic_cfg_scale(6.0, float(t), n)


CFG_KW = dict(num_layers=2, hidden_size=128, heads_num=2, head_dim=64, text_len=16, text_dim=32, in_channels=32,
              ofs_embed=True)
JCFG, TCFG = JCM.CogConfig(**CFG_KW), TCM.CogConfig(**CFG_KW)
# 17 frames -> 5 latent frames, padded to 6 at the front -> 3 patch frames; latents (16, 32) -> 8 x 16
# tokens: frame_size 128, 384 video tokens after 16 text tokens
H_LAT, W_LAT, NUM_FRAMES = 16, 32, 17
SVG_KW = dict(sparsity=0.9, num_sampled_rows=32)  # a band of 128 tokens past the text


@pytest.fixture(scope="module")
def params():
    """JAX init (f32) with every leaf perturbed, so zero biases and unit norm
    weights cannot hide a layout slip in the conversion."""
    tree = JCM.init_cog_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def model(params):
    return cog_params_from_numpy(params, TCFG)


def layer_rows(key, n_layers, seq):
    """The rows JAX's SVG1 profiler draws in each layer of one forward."""
    n = min(SVG_KW["num_sampled_rows"], seq)
    draw = lambda li: np.asarray(jax.random.randint(jax.random.fold_in(key, li), (n,), 0, min(10000, seq)))
    return torch.as_tensor(np.stack([draw(li) for li in range(n_layers)]))


def test_param_conversion_layout(params, model):
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["blocks.1.ffn.fc2.weight"].numpy(), params["blocks"]["ffn"]["fc2"]["w"][1].T)
    np.testing.assert_array_equal(sd["blocks.0.attn.norm_k.bias"].numpy(), params["blocks"]["attn"]["norm_k"]["b"][0])
    np.testing.assert_array_equal(sd["blocks.1.norm2.norm.weight"].numpy(), params["blocks"]["norm2"]["norm"]["w"][1])
    np.testing.assert_array_equal(sd["ofs_emb.fc2.bias"].numpy(), params["ofs_emb"]["fc2"]["b"])
    # every JAX weight has a home, and the model holds nothing else
    assert sum(v.numel() for v in sd.values()) == sum(a.size for a in jax.tree.leaves(params))
    bf = TCM.CogModel(TCFG, dtype=torch.bfloat16)
    assert bf.blocks[0].attn.norm_q.weight.dtype == torch.float32
    assert bf.blocks[0].ffn["fc1"].weight.dtype == torch.bfloat16


@pytest.mark.parametrize("pattern", ["dense", "SVG"])
def test_cog_forward_matches_jax(params, model, pattern):
    """One forward over a CFG-sized batch of 2, layer 0 in dense warm-up and
    layer 1 on the pattern, the whole text live. f32 over 2 layers: rel L2
    error <= 1e-4 (the order of f32 sums, and XLA's and torch's f32 exp of
    the sinusoid's frequencies may differ by an ulp)."""
    jl, tl = _layouts(3, (H_LAT // 2) * (W_LAT // 2), JCFG.text_len)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 6, H_LAT, W_LAT)).astype(np.float32)
    text = rng.standard_normal((2, JCFG.text_len, JCFG.text_dim)).astype(np.float32)
    t = np.asarray([700.0, 700.0], np.float32)
    key = jax.random.PRNGKey(2)
    jplan = JS1.make_svg1_plan(jl, JC.SVGConfig(**SVG_KW), JC.WarmupSchedule(first_layers=1))
    jrt = (JRT.DenseRuntime if pattern == "dense" else JRT.SVG1Runtime)(jplan, prompt_length=JCFG.text_len)
    ref, _ = JCM.cog_forward(params, JCFG, jnp.asarray(x), jnp.asarray(t), jnp.asarray(text), attention=jrt,
                             rng=key)
    trt = TPC.make_cog_runtime(tl, device="cpu", pattern=pattern, warmup=TC.WarmupSchedule(first_layers=1),
                               svg=TC.SVGConfig(**SVG_KW))
    assert trt.plan.mask_spec.band_width == 128
    ours = TCM.cog_forward(model, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(text), attention=trt,
                           profile_rows=layer_rows(key, TCFG.num_layers, tl.seq_len))
    assert ours.dtype == torch.float32 and ours.shape == (2, 6, 16, H_LAT, W_LAT)
    err = np.linalg.norm(ours.numpy() - np.asarray(ref)) / np.linalg.norm(np.asarray(ref))
    assert err <= 1e-4


@pytest.mark.parametrize("pattern", ["SVG", "dense"])
def test_generate_latents_matches_jax(params, model, pattern):
    """The slice: 2 DDIM steps over the CFG pair (step 0 a dense warm-up,
    first_times_fp 0.5; layer 0 dense, first_layers_fp 0.5), the image
    latents in padded latent frame 0, the front padding dropped, from JAX's
    initial noise and with JAX's profiler rows. f32: rel L2 error <= 1e-4."""
    steps, seed = 2, 0
    kw = dict(height=8 * H_LAT, width=8 * W_LAT, num_frames=NUM_FRAMES, num_inference_steps=steps,
              guidance_scale=6.0, pattern=pattern, first_layers_fp=0.5, first_times_fp=0.5)
    rng = np.random.default_rng(3)
    ctx, ctx_null = (rng.standard_normal((1, JCFG.text_len, JCFG.text_dim)).astype(np.float32) for _ in range(2))
    img = rng.standard_normal((1, 16, 1, H_LAT, W_LAT)).astype(np.float32)
    ref = JPC.CogPipeline(JCFG, params, dtype=jnp.float32).generate_latents(
        jnp.asarray(ctx), jnp.asarray(ctx_null), jnp.asarray(img), seed=seed, svg=JC.SVGConfig(**SVG_KW), **kw)
    key, nkey = jax.random.split(jax.random.PRNGKey(seed))
    lat0 = np.array(jax.random.normal(nkey, (1, 16, 6, H_LAT, W_LAT), jnp.float32))
    seq = 3 * (H_LAT // 2) * (W_LAT // 2) + JCFG.text_len
    rows = [layer_rows(jax.random.fold_in(key, i), TCFG.num_layers, seq) for i in range(steps)]
    f = torch.from_numpy
    ours = TPC.CogPipeline(model)._denoise(f(ctx), f(ctx_null), f(img), f(lat0), svg=TC.SVGConfig(**SVG_KW),
                                           use_dynamic_cfg=False, profile_rows=rows, **kw)
    assert ours.shape == (1, 16, 5, H_LAT, W_LAT) and np.isfinite(ours.numpy()).all()
    err = np.linalg.norm(ours.numpy() - np.asarray(ref)) / np.linalg.norm(np.asarray(ref))
    assert err <= 1e-4


CFG_V1 = dict(CFG_KW, ofs_embed=False)


def test_generate_latents_v1_dynamic_cfg_matches_jax():
    """CogVideoX v1.0 (no ofs embedding) with dynamic CFG, the case no other
    test holds: 3 DDIM steps over the CFG pair (step 0 a dense warm-up, layer
    0 dense), dense and SVG1 from the same f32 weights, JAX's noise and
    profiler rows. f32: rel L2 error <= 1e-4 (as the v1.5 slice; measured
    3.6e-6)."""
    jcfg, tcfg = JCM.CogConfig(**CFG_V1), TCM.CogConfig(**CFG_V1)
    tree = JCM.init_cog_params(jax.random.PRNGKey(4), jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree)
    model = cog_params_from_numpy(params, tcfg)
    assert not any(k.startswith("ofs_emb") for k in model.state_dict())
    steps, seed = 3, 1
    ctx, ctx_null = (rng.standard_normal((1, jcfg.text_len, jcfg.text_dim)).astype(np.float32) for _ in range(2))
    img = rng.standard_normal((1, 16, 1, H_LAT, W_LAT)).astype(np.float32)
    key, nkey = jax.random.split(jax.random.PRNGKey(seed))
    lat0 = np.array(jax.random.normal(nkey, (1, 16, 6, H_LAT, W_LAT), jnp.float32))
    seq = 3 * (H_LAT // 2) * (W_LAT // 2) + jcfg.text_len
    rows = [layer_rows(jax.random.fold_in(key, i), tcfg.num_layers, seq) for i in range(steps)]
    f = torch.from_numpy
    for pattern in ("dense", "SVG"):
        kw = dict(height=8 * H_LAT, width=8 * W_LAT, num_frames=NUM_FRAMES, num_inference_steps=steps,
                  guidance_scale=6.0, pattern=pattern, first_layers_fp=0.5, first_times_fp=0.34)
        ref = JPC.CogPipeline(jcfg, params, dtype=jnp.float32).generate_latents(
            jnp.asarray(ctx), jnp.asarray(ctx_null), jnp.asarray(img), seed=seed, svg=JC.SVGConfig(**SVG_KW),
            use_dynamic_cfg=True, **kw)
        ours = TPC.CogPipeline(model)._denoise(f(ctx), f(ctx_null), f(img), f(lat0), svg=TC.SVGConfig(**SVG_KW),
                                               use_dynamic_cfg=True, profile_rows=rows, **kw)
        assert ours.shape == (1, 16, 5, H_LAT, W_LAT) and np.isfinite(ours.numpy()).all()
        err = np.linalg.norm(ours.numpy() - np.asarray(ref)) / np.linalg.norm(np.asarray(ref))
        assert err <= 1e-4


def test_generate_latents_bf16_step_matches_jax(params, model):
    """One DDIM step of the bf16 pipeline (the card's working type), SVG1
    over the CFG pair with no warm-up, the same bf16 weights on both sides
    (JAX's bf16 layout: the norms and the time path f32), JAX's noise and
    profiler rows. bf16 keeps 8 bits and the two frameworks round at other
    places (each matmul's sums, where an elementwise result is cast), over 2
    layers, and CFG at 6.0 multiplies the cond - uncond difference: the
    step's update (latents - noise) within rel L2 1e-1 of JAX's (measured
    3.7e-2; 5.9e-3 at guidance 1.0)."""
    kw = dict(height=8 * H_LAT, width=8 * W_LAT, num_frames=NUM_FRAMES, num_inference_steps=1,
              guidance_scale=6.0, pattern="SVG", first_layers_fp=0.0, first_times_fp=0.0)
    rng = np.random.default_rng(7)
    ctx, ctx_null = (rng.standard_normal((1, JCFG.text_len, JCFG.text_dim)).astype(np.float32) for _ in range(2))
    img = rng.standard_normal((1, 16, 1, H_LAT, W_LAT)).astype(np.float32)
    layout = JCM.init_cog_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.bfloat16)
    jparams = jax.tree.map(lambda a, ref: np.asarray(a).astype(ref.dtype), params, layout)
    ref = JPC.CogPipeline(JCFG, jparams, dtype=jnp.bfloat16).generate_latents(
        jnp.asarray(ctx), jnp.asarray(ctx_null), jnp.asarray(img), seed=0, svg=JC.SVGConfig(**SVG_KW), **kw)
    key, nkey = jax.random.split(jax.random.PRNGKey(0))
    lat0 = np.array(jax.random.normal(nkey, (1, 16, 6, H_LAT, W_LAT), jnp.float32))
    seq = 3 * (H_LAT // 2) * (W_LAT // 2) + JCFG.text_len
    bf = TCM.CogModel(TCFG, dtype=torch.bfloat16)
    bf.load_state_dict(model.state_dict())
    f = torch.from_numpy
    ours = TPC.CogPipeline(bf)._denoise(f(ctx), f(ctx_null), f(img), f(lat0), svg=TC.SVGConfig(**SVG_KW),
                                        use_dynamic_cfg=False,
                                        profile_rows=[layer_rows(jax.random.fold_in(key, 0), TCFG.num_layers, seq)],
                                        **kw)
    ours, ref = ours.float().numpy(), np.asarray(ref, np.float32)
    lat0 = lat0[:, :, 1:]  # the front padding frame is dropped
    err = np.linalg.norm((ours - lat0) - (ref - lat0)) / np.linalg.norm(ref - lat0)
    assert np.isfinite(ours).all()
    assert err <= 1e-1


@pytest.mark.parametrize("extra", [[], ["--version", "v1", "--pattern", "dense"], ["--image_path", "npy"]],
                         ids=["svg", "v1_dense", "image_npy"])
def test_cli_smoke_cpu(tmp_path, extra):
    """The CLI's smoke (96x128x17 -> 5 latent frames of 12 x 16) writes finite
    latents; v1 runs dynamic CFG without the ofs embedding; --image_path
    takes VAE latents as .npy."""
    if extra[-1:] == ["npy"]:
        np.save(tmp_path / "img.npy", np.ones((1, 16, 1, 12, 16), np.float32))
        extra = ["--image_path", str(tmp_path / "img.npy")]
    out = tmp_path / "lat.npz"
    TCLI.main(["--smoke", "--device", "cpu", "--num_step", "2", "--output_path", str(out)] + extra)
    lat = np.load(out)["latents"]
    assert lat.shape == (1, 16, 5, 12, 16) and np.isfinite(lat).all()


@pytest.mark.parametrize("argv,exc", [
    (["--device", "cuda:99"], RuntimeError),
    (["--device", "cpu", "--pattern", "SAP"], SystemExit),
    (["--device", "cpu", "--dit_fsdp", "--ring_degree", "2"], RuntimeError),
], ids=["no_card_no_fallback", "sap", "parallel"])
def test_cli_refuses_what_is_not_ported(tmp_path, argv, exc):
    """No fallback to the CPU; --pattern SAP is not one of the JAX CLI's
    choices, so argparse exits (2), as the JAX CLI does; FSDP over a ring of
    ranks outside torchrun raises naming torchrun (--ring_degree,
    --ulysses_degree and --dit_fsdp run under torchrun,
    tests/test_torch_parallel_families.py, tests/test_torch_sharding.py)."""
    if argv[1].startswith("cuda") and torch.cuda.is_available():
        pytest.skip("this host has a card: nothing to refuse")
    with pytest.raises(exc, match="torchrun" if "--dit_fsdp" in argv else None) as info:
        TCLI.main(["--smoke", "--output_path", str(tmp_path / "x.npz")] + argv)
    if exc is SystemExit:
        assert info.value.code == 2


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    """A tiny CogVideoX checkpoint (chip_smoke.write_tiny_cog_checkpoint: T5
    v1.1 and its config.json in HF's names, the DiT and VAE in diffusers')."""
    import chip_smoke

    d = tmp_path_factory.mktemp("cog_ckpt")
    chip_smoke.write_tiny_cog_checkpoint(str(d), "a cat walks on the grass")
    return str(d)


@pytest.mark.parametrize("case", ["model_dir", "pixel_image", "video", "vae_tiling"])
def test_cli_runs_what_it_refused_before(tmp_path, tiny_dir, case):
    """The paths the CLI refused before the VAE and T5 were ported run:
    --model_dir (T5, DiT, VAE; .npy image latents, latents to an .npz), a
    pixel --image_path (JPEG -> bilinear resize -> VAE encode), a video
    output (the VAE decode to a .y4m at 8 fps) and the VAE tiling flags (a
    tiled decode)."""
    from sparse_videogen_tpu_torch.io.native import read_y4m

    image = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "1", "image.jpg")
    base = ["--device", "cpu", "--prompt", "a cat walks on the grass", "--height", "96", "--width", "128",
            "--num_frames", "9", "--num_step", "2"]
    if case in ("model_dir", "pixel_image"):
        if case == "model_dir":
            np.save(tmp_path / "img.npy", np.ones((1, 16, 1, 12, 16), np.float32))
        img = str(tmp_path / "img.npy") if case == "model_dir" else image
        # the checkpoint has a VAE: an .npz name becomes the video's .y4m
        argv = base + ["--model_dir", tiny_dir, "--image_path", img, "--output_path", str(tmp_path / "v.npz")]
    else:
        argv = ["--smoke", "--output_path", str(tmp_path / "v.y4m")] + base
    if case == "vae_tiling":
        argv += ["--vae_tiling", "on", "--vae_tile", "8", "--vae_tile_overlap", "2"]
    TCLI.main(argv)
    frames, fps = read_y4m(str(tmp_path / "v.y4m"))
    assert frames.shape == (9, 96, 128, 3) and fps == 8 and frames.std() > 0


def test_cli_flags_are_the_jax_cli():
    """The port's parser declares the JAX CLI's flags by name, default and
    choices, plus --device (default cuda)."""
    from sparse_videogen_tpu.cli.cog_i2v import build_parser

    spec = lambda p: {a.dest: (sorted(a.option_strings), a.default, a.choices) for a in p._actions if a.dest != "help"}
    ours, ref = spec(TCLI.build_parser()), spec(build_parser())
    assert set(ours) - set(ref) == {"device"} and ours.pop("device")[1] == "cuda"
    assert ours == ref
