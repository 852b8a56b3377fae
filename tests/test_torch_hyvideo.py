"""HunyuanVideo T2V slice of the torch port against the JAX package.

Text-last SVG1 machinery (masks, placement, plan metadata: exact), K1's
hyvideo kind (the port's plain version against the JAX Pallas kernel in
interpret mode), the DiT forward, FlowMatchEuler, a 2-step pipeline and the
CLI. Each package builds its own config from the same values; both run the
same f32 weights (the JAX pytree, through io/from_jax.hyvideo_params_from_
numpy) and the SVG1 profiler rows the JAX package draws. Tolerances are
stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.core import masks as JM
from sparse_videogen_tpu.core import placement as JP
from sparse_videogen_tpu.models.hyvideo import model as JHM
from sparse_videogen_tpu.ops import attention as JA
from sparse_videogen_tpu.ops import mask_spec as JMS
from sparse_videogen_tpu.pipelines import hyvideo as JPH
from sparse_videogen_tpu.schedulers import FlowMatchEuler as JEuler
from sparse_videogen_tpu.sparse import runtimes as JRT
from sparse_videogen_tpu.sparse import svg1 as JS1
from sparse_videogen_tpu_torch import config as TC
from sparse_videogen_tpu_torch.cli import hyvideo_t2v as TCLI
from sparse_videogen_tpu_torch.core import masks as TM
from sparse_videogen_tpu_torch.core import placement as TP
from sparse_videogen_tpu_torch.io.from_jax import hyvideo_params_from_numpy
from sparse_videogen_tpu_torch.models.hyvideo import model as THM
from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_kv
from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec
from sparse_videogen_tpu_torch.pipelines import hyvideo as TPH
from sparse_videogen_tpu_torch.schedulers import FlowMatchEuler as TEuler
from sparse_videogen_tpu_torch.sparse import runtimes as TRT
from sparse_videogen_tpu_torch.sparse import svg1 as TS1
from sparse_videogen_tpu_torch.sparse.svg2 import check_sap_config

# text-last layouts (num_frames, frame_size, text_len): partial sub-blocks, several chunks
LAYOUTS = [(3, 160, 8), (3, 256, 8), (4, 128, 16), (3, 224, 16)]
LAYOUT_IDS = [f"{f}x{fs}+{t}" for f, fs, t in LAYOUTS]


def _layouts(f, fs, text_len, prompt_length=0):
    kw = dict(num_frames=f, frame_size=fs, context_length=text_len, prompt_length=prompt_length)
    return (JC.VideoLayout(text_position=JC.TextPosition.LAST, **kw),
            TC.VideoLayout(text_position=TC.TextPosition.LAST, **kw))


@pytest.mark.parametrize("lay", LAYOUTS, ids=LAYOUT_IDS)
def test_text_last_masks_and_placement_equal(lay):
    """Profiling predicates (text rows/columns fully attended, no sink), the
    execution block mask (floor band, strict <, text rows/columns) and the
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
            np.testing.assert_array_equal(
                TM.execution_mask_block(tl, mul, block_q=bq, block_kv=bkv),
                JM.execution_mask_block(jl, mul, block_q=bq, block_kv=bkv, first_frame_sink=False, round_mode="floor"))
    g = TM.temporal_index_map(tl)
    np.testing.assert_array_equal(g, JM.temporal_index_map(jl))
    x = np.random.default_rng(0).standard_normal((2, 3, jl.seq_len, 8)).astype(np.float32)
    for inverse in (False, True):
        ours = TP.temporal_transpose(torch.from_numpy(x), tl, inverse=inverse).numpy()
        np.testing.assert_array_equal(ours, np.asarray(JP.temporal_transpose(jnp.asarray(x), jl, inverse=inverse)))
    np.testing.assert_array_equal(TP.temporal_transpose(torch.from_numpy(x), tl).numpy()[..., jl.video_length:, :],
                                  x[..., jl.video_length:, :])


@pytest.mark.parametrize("lay", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("bq", [None, 128])
def test_hyvideo_plan_metadata_equal(lay, bq):
    """The hyvideo plan: mask specs (floor band; band 1 << 24 for dense),
    aux = [video_len + prompt_length, 0, 0, 0], the dense path's block_q
    (block_q: the dense spec is masked), and the runtimes' cheap-first
    metadata at a prompt shorter than the text: integer-equal."""
    jl, tl = _layouts(*lay)
    ours = TS1.make_svg1_plan(tl, TC.SVGConfig(sparsity=0.6), block_q=bq, block_kv=256)
    ref = JS1.make_svg1_plan(jl, JC.SVGConfig(sparsity=0.6), block_q=bq, block_kv=256)
    assert ours.mask_kind == ref.mask_kind == "hyvideo"
    assert (ours.block_q, ours.block_kv, ours.seq_pad_q, ours.seq_pad_kv, ours.multiplier) == (
        ref.block_q, ref.block_kv, ref.seq_pad_q, ref.seq_pad_kv, ref.multiplier)
    assert ours.dense_block_q == ref.dense_exec[0] == ours.block_q
    assert ours.mask_spec == MaskSpec(**vars(ref.mask_spec)) and ours.mask_spec.band_width > 0
    assert ours.dense_mask_spec == MaskSpec(**vars(ref.dense_mask_spec))
    np.testing.assert_array_equal(ours.sparse_meta(), np.asarray(ref.sparse_meta()))
    np.testing.assert_array_equal(ours.dense_meta(), np.asarray(ref.dense_meta()))
    for pl in (None, 3, lay[2]):
        np.testing.assert_array_equal(ours.default_aux(pl), np.asarray(ref.default_aux(pl)))
        for spec_o, meta_o, bq_o, spec_r, meta_r, bq_r in (
            (ours.mask_spec, ours.sparse_meta(), ours.block_q, ref.mask_spec, ref.sparse_meta(), ref.block_q),
            (ours.dense_mask_spec, ours.dense_meta(), ours.dense_block_q,
             ref.dense_mask_spec, ref.dense_meta(), ref.dense_exec[0])):
            mine = TRT._classified(meta_o, spec_o, ours, pl, bq_o)
            np.testing.assert_array_equal(mine, np.asarray(JRT._classified(meta_r, spec_r, ref, pl, bq_r)))
        rt = TRT.SVG1Runtime(ours, device="cpu", prompt_length=pl)
        consts = JRT.SVG1Runtime(ref, prompt_length=pl).consts()
        for name in ("dense_meta", "sparse_meta", "aux"):
            np.testing.assert_array_equal(getattr(rt, name).numpy(), np.asarray(consts[name]))
        if pl == 3 and bq == 128:  # fake text tokens: the dense metadata runs both loops (cheap, then masked)
            e0 = rt.dense_meta[..., 0].numpy()
            assert (e0 // 4096).sum() > 0 and (e0 // 4096 < e0 % 4096).any()


@pytest.mark.parametrize("which", ["dense", "svg1"])
def test_k1_hyvideo_plain_matches_jax(which):
    """K1's hyvideo kind: the port's plain version (what a CPU tensor runs)
    against the JAX kernel in interpret mode, on the runtime's cheap-first
    metadata and aux with a prompt of 3 of 8 text tokens, so real, fake and
    padded rows all occur. f32, the same exp2 online softmax over the same
    chunks: atol 1e-5 on outputs of size ~1."""
    jl, tl = _layouts(3, 160, 8)
    plan = TS1.make_svg1_plan(tl, TC.SVGConfig(sparsity=0.6), block_q=128, block_kv=256)
    rt = TRT.SVG1Runtime(plan, device="cpu", prompt_length=3)
    meta, spec, bq = ((rt.dense_meta, plan.dense_mask_spec, plan.dense_block_q) if which == "dense"
                      else (rt.sparse_meta, plan.mask_spec, plan.block_q))
    rng = np.random.default_rng(4)
    BH, D = 2, 64
    q = np.zeros((BH, plan.seq_pad_q, D), np.float32)
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
    # the fake text rows see only the fake columns: their output is a mix of those v rows
    real = int(rt.aux[0])
    assert np.abs(ours[:, real:S]).max() > 0.05


CFG_KW = dict(hidden_size=128, heads_num=2, mm_double_blocks_depth=2, mm_single_blocks_depth=2,
              rope_dim_list=(16, 24, 24), text_states_dim=32, text_states_dim_2=24, text_len=8, mlp_width_ratio=2.0)
JCFG, TCFG = JHM.HyVideoConfig(**CFG_KW), THM.HyVideoConfig(**CFG_KW)
# latents (1, 16, 3, 16, 32) -> token grid (3, 8, 16): frame_size 128, 384 video + 8 text tokens, head_dim 64
H_LAT, W_LAT, NUM_FRAMES, PROMPT = 16, 32, 9, 5
SVG_KW = dict(sparsity=0.6, num_sampled_rows=32, profile_multiplier=1.5)


@pytest.fixture(scope="module")
def params():
    """JAX init (f32) with every leaf perturbed, so zero biases and unit norm
    weights cannot hide a layout slip in the conversion."""
    tree = JHM.init_hyvideo_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def model(params):
    return hyvideo_params_from_numpy(params, TCFG)


def _text(rng):
    text = rng.standard_normal((1, JCFG.text_len, JCFG.text_states_dim)).astype(np.float32)
    mask = np.zeros((1, JCFG.text_len), np.int32)
    mask[0, :PROMPT] = 1
    pooled = rng.standard_normal((1, JCFG.text_states_dim_2)).astype(np.float32)
    return text, mask, pooled


def layer_rows(key, n_layers, seq):
    """The rows JAX's SVG1 profiler draws in each layer of one forward."""
    n = min(SVG_KW["num_sampled_rows"], seq)
    draw = lambda li: np.asarray(jax.random.randint(jax.random.fold_in(key, li), (n,), 0, min(10000, seq)))
    return torch.as_tensor(np.stack([draw(li) for li in range(n_layers)]))


def test_param_conversion_layout(params, model):
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["single_blocks.1.linear2.weight"].numpy(),
                                  params["single_blocks"]["linear2"]["w"][1].T)
    np.testing.assert_array_equal(sd["double_blocks.0.txt_k_norm"].numpy(), params["double_blocks"]["txt_k_norm"][0])
    np.testing.assert_array_equal(sd["txt_in.blocks.1.norm2.bias"].numpy(), params["txt_in"]["blocks"]["norm2"]["b"][1])
    np.testing.assert_array_equal(sd["guidance_in.fc2.bias"].numpy(), params["guidance_in"]["fc2"]["b"])
    # every JAX weight has a home, and the model holds nothing else
    assert sum(v.numel() for v in sd.values()) == sum(a.size for a in jax.tree.leaves(params))
    bf = THM.HyVideoModel(TCFG, dtype=torch.bfloat16)
    assert bf.double_blocks[0].img_q_norm.dtype == torch.float32
    assert bf.txt_in.blocks[0].norm1.weight.dtype == torch.float32
    assert bf.single_blocks[0].linear1.weight.dtype == torch.bfloat16


@pytest.mark.parametrize("pattern", ["dense", "SVG"])
def test_hyvideo_forward_matches_jax(params, model, pattern):
    """One forward, layer 0 in dense warm-up and layers 1-3 on the pattern,
    prompt of 5 of 8 text tokens. f32 over 4 blocks: rel L2 error <= 1e-4
    (measured 2.4e-5). Beyond the order of f32 sums, XLA's and torch's f32
    exp of the sinusoid's frequencies differ by an ulp, and the guidance
    embedding's argument (6000 x freq) turns that into 2.4e-4 of its
    entries."""
    jl, tl = _layouts(3, 128, 8, PROMPT)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 16, 3, H_LAT, W_LAT)).astype(np.float32)
    text, mask, pooled = _text(rng)
    t, g = np.asarray([700.0], np.float32), np.asarray([6000.0], np.float32)
    key = jax.random.PRNGKey(2)
    jplan = JS1.make_svg1_plan(jl, JC.SVGConfig(**SVG_KW), JC.WarmupSchedule(first_layers=1))
    jrt = (JRT.DenseRuntime if pattern == "dense" else JRT.SVG1Runtime)(jplan, prompt_length=PROMPT)
    ref, _ = JHM.hyvideo_forward(params, JCFG, jnp.asarray(x), jnp.asarray(t), jnp.asarray(text), jnp.asarray(mask),
                                 jnp.asarray(pooled), guidance=jnp.asarray(g), attention=jrt, rng=key)
    trt = TPH.make_hyvideo_runtime(tl, device="cpu", prompt_length=PROMPT, pattern=pattern,
                                   warmup=TC.WarmupSchedule(first_layers=1), svg=TC.SVGConfig(**SVG_KW))
    f = torch.from_numpy
    ours = THM.hyvideo_forward(model, f(x), f(t), f(text), f(mask), f(pooled), guidance=f(g), attention=trt,
                               profile_rows=layer_rows(key, TCFG.num_layers, tl.seq_len))
    assert ours.dtype == torch.float32 and ours.shape == x.shape
    err = np.linalg.norm(ours.numpy() - np.asarray(ref)) / np.linalg.norm(np.asarray(ref))
    assert err <= 1e-4


def test_flow_match_euler_matches_jax():
    """The same f64 sigma tables and f32 timesteps (equal); the f32 steps agree to 1e-6."""
    for n, shift in ((3, 7.0), (10, 7.0), (4, 1.0)):
        ours, ref = TEuler(n, shift=shift), JEuler(n, shift=shift)
        np.testing.assert_array_equal(ours.sigmas, ref.sigmas)
        np.testing.assert_array_equal(ours.timesteps, ref.timesteps)
        rng = np.random.default_rng(n)
        x = rng.standard_normal((1, 4, 2, 3, 3)).astype(np.float32)
        xo, xr = torch.from_numpy(x), jnp.asarray(x)
        for i in range(n):
            v = rng.standard_normal(x.shape).astype(np.float32)
            xo, _ = ours.step(i, xo, torch.from_numpy(v))
            xr, _ = ref.step(i, xr, jnp.asarray(v))
            np.testing.assert_allclose(xo.numpy(), np.asarray(xr), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("pattern", ["SVG", "dense"])
def test_generate_latents_matches_jax(params, model, pattern):
    """The slice: 2 Euler steps (step 0 a dense warm-up, first_times_fp 0.5;
    layer 0 dense, first_layers_fp 0.25), embedded guidance, from JAX's
    initial noise and with JAX's profiler rows. f32: rel L2 error <= 1e-4
    (measured 1.5e-5; the guidance embedding's reason as in the forward)."""
    steps, seed = 2, 0
    kw = dict(height=8 * H_LAT, width=8 * W_LAT, num_frames=NUM_FRAMES, num_inference_steps=steps,
              embedded_guidance_scale=6.0, flow_shift=7.0, pattern=pattern, first_layers_fp=0.25,
              first_times_fp=0.5)
    text, mask, pooled = _text(np.random.default_rng(3))
    ref = JPH.HyVideoPipeline(JCFG, params, dtype=jnp.float32).generate_latents(
        jnp.asarray(text), jnp.asarray(mask), jnp.asarray(pooled), prompt_length=PROMPT, seed=seed,
        svg=JC.SVGConfig(**SVG_KW), **kw)
    key, nkey = jax.random.split(jax.random.PRNGKey(seed))
    lat0 = np.array(jax.random.normal(nkey, (1, 16, 3, H_LAT, W_LAT), jnp.float32))
    seq = 3 * (H_LAT // 2) * (W_LAT // 2) + JCFG.text_len
    rows = [layer_rows(jax.random.fold_in(key, i), TCFG.num_layers, seq) for i in range(steps)]
    f = torch.from_numpy
    ours = TPH.HyVideoPipeline(model)._denoise(f(text), f(mask), f(pooled), f(lat0), prompt_length=PROMPT,
                                               svg=TC.SVGConfig(**SVG_KW), profile_rows=rows, **kw)
    assert np.isfinite(ours.numpy()).all()
    err = np.linalg.norm(ours.numpy() - np.asarray(ref)) / np.linalg.norm(np.asarray(ref))
    assert err <= 1e-4


def test_generate_latents_bf16_step_matches_jax(params, model):
    """One Euler step of the bf16 pipeline (the card's working type), SVG1
    with no warm-up, embedded guidance, the same bf16 weights on both sides
    (JAX's bf16 layout: norms and the time path f32), JAX's noise and
    profiler rows. bf16 keeps 8 bits and the two frameworks round at other
    places (each matmul's sums, where an elementwise result is cast), over 4
    blocks: the step's update (latents - noise) within rel L2 5e-2 of JAX's
    (measured 1.0e-2)."""
    kw = dict(height=8 * H_LAT, width=8 * W_LAT, num_frames=NUM_FRAMES, num_inference_steps=1,
              embedded_guidance_scale=6.0, flow_shift=7.0, pattern="SVG", first_layers_fp=0.0, first_times_fp=0.0)
    text, mask, pooled = _text(np.random.default_rng(6))
    layout = JHM.init_hyvideo_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.bfloat16)
    jparams = jax.tree.map(lambda a, ref: np.asarray(a).astype(ref.dtype), params, layout)
    ref = JPH.HyVideoPipeline(JCFG, jparams, dtype=jnp.bfloat16).generate_latents(
        jnp.asarray(text), jnp.asarray(mask), jnp.asarray(pooled), prompt_length=PROMPT, seed=0,
        svg=JC.SVGConfig(**SVG_KW), **kw)
    key, nkey = jax.random.split(jax.random.PRNGKey(0))
    lat0 = np.array(jax.random.normal(nkey, (1, 16, 3, H_LAT, W_LAT), jnp.float32))
    seq = 3 * (H_LAT // 2) * (W_LAT // 2) + JCFG.text_len
    bf = THM.HyVideoModel(TCFG, dtype=torch.bfloat16)
    bf.load_state_dict(model.state_dict())
    f = torch.from_numpy
    ours = TPH.HyVideoPipeline(bf)._denoise(f(text), f(mask), f(pooled), f(lat0), prompt_length=PROMPT,
                                            svg=TC.SVGConfig(**SVG_KW),
                                            profile_rows=[layer_rows(jax.random.fold_in(key, 0), TCFG.num_layers, seq)],
                                            **kw)
    ours, ref = ours.float().numpy(), np.asarray(ref, np.float32)
    err = np.linalg.norm((ours - lat0) - (ref - lat0)) / np.linalg.norm(ref - lat0)
    assert np.isfinite(ours).all()
    assert err <= 5e-2


def test_cli_smoke_cpu(tmp_path):
    out = tmp_path / "lat.npz"
    TCLI.main(["--smoke", "--pattern", "SVG", "--device", "cpu", "--num_inference_steps", "2",
               "--output_file", str(out)])
    lat = np.load(out)["latents"]
    assert lat.shape == (1, 16, 3, 12, 16) and np.isfinite(lat).all()


@pytest.mark.parametrize("argv,exc,match", [
    (["--device", "cuda:99"], RuntimeError, None),
    (["--device", "cpu", "--dit_fsdp"], NotImplementedError, "ROADMAP"),
    (["--device", "cpu", "--pattern", "SVG", "--ring_degree", "2"], RuntimeError, "torchrun"),
    (["--device", "cpu", "--quant", "int8", "--dit_fsdp"], NotImplementedError, "ROADMAP"),
    (["--device", "cpu", "--ulysses_degree", "2"], RuntimeError, "torchrun"),
], ids=["no_card_no_fallback", "model_dir", "video", "sap", "parallel"])
def test_cli_refuses_what_is_not_ported(tmp_path, argv, exc, match):
    """No fallback to the CPU; FSDP raises; the parallel flags need torchrun's
    process group and do not fall back to one device without it. The ids
    `model_dir` and `video` named --model_dir and a video name, which run
    now (tests/test_torch_hyvideo_cli.py): they hold --dit_fsdp and
    --ring_degree 2 with SVG; `sap` held --quant int8, which runs now
    (tests/test_torch_hyvideo_quant.py), and holds it beside --dit_fsdp."""
    if argv[1].startswith("cuda") and torch.cuda.is_available():
        pytest.skip("this host has a card: nothing to refuse")
    with pytest.raises(exc, match=match):
        TCLI.main(["--smoke", "--output_file", str(tmp_path / "x.npz")] + argv)


@pytest.mark.parametrize("cli", ["hyvideo_t2v", "wan_t2v"])
def test_cli_flags_are_the_jax_clis(cli):
    """The port's parsers declare the JAX CLIs' flags by name, default and
    choices, plus --device (default cuda)."""
    import importlib

    spec = lambda p: {a.dest: (sorted(a.option_strings), a.default, a.choices) for a in p._actions if a.dest != "help"}
    ours = spec(importlib.import_module(f"sparse_videogen_tpu_torch.cli.{cli}").build_parser())
    ref = spec(importlib.import_module(f"sparse_videogen_tpu.cli.{cli}").build_parser())
    assert set(ours) - set(ref) == {"device"} and ours.pop("device")[1] == "cuda"
    assert ours == ref


def test_sap_on_text_last_raises():
    """SAP refuses a text-first layout (CogVideoX runs SVG1 or dense only);
    text-last SAP runs (tests/test_torch_sap_text_last.py), so the name
    keeps only the CogVideoX case."""
    text_first = TC.VideoLayout(num_frames=2, frame_size=64, context_length=8, text_position=TC.TextPosition.FIRST)
    with pytest.raises(NotImplementedError, match="CogVideoX"):
        check_sap_config(TC.SAPConfig(), text_first)
    with pytest.raises(NotImplementedError, match="CogVideoX"):
        TRT.SAPRuntime(TS1.make_svg1_plan(text_first), TC.SAPConfig(), TC.WarmupSchedule(), device="cpu")
