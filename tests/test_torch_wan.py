"""Wan 2.1 T2V slice of the torch port against the JAX package.

Both packages run the same f32 parameters (the JAX pytree, converted by
io/from_jax.wan_params_from_numpy), the same inputs, and the SVG1 profiler
rows the JAX package draws, handed to the port. The JAX Pallas kernels run
in interpret mode, the port's plain versions on the CPU. Differences are
f32 summation order only; tolerances are stated per test.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.models.wan import model as JWM
from sparse_videogen_tpu.pipelines import wan as JPW
from sparse_videogen_tpu.schedulers import FlowUniPC as JUniPC
from sparse_videogen_tpu_torch import config as TC
from sparse_videogen_tpu_torch.cli import wan_t2v as TCLI
from sparse_videogen_tpu_torch.io.from_jax import wan_params_from_numpy
from sparse_videogen_tpu_torch.models.wan import model as TWM
from sparse_videogen_tpu_torch.pipelines import wan as TPW
from sparse_videogen_tpu_torch.schedulers import FlowUniPC as TUniPC

CFG_KW = dict(dim=128, ffn_dim=256, num_heads=2, num_layers=2, freq_dim=32, text_dim=48, text_len=8)
JCFG, TCFG = JWM.WanConfig(**CFG_KW), TWM.WanConfig(**CFG_KW)
# latents (B, 16, 3, 10, 16) -> token grid (3, 5, 8): S = 120, frame_size 40, head_dim 64
H_LAT, W_LAT, NUM_FRAMES = 10, 16, 9
# each package gets its own SVGConfig with these values
SVG_KW = dict(sparsity=0.25, num_sampled_rows=32)
SVG, JSVG = TC.SVGConfig(**SVG_KW), JC.SVGConfig(**SVG_KW)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def params():
    """JAX init (f32) with every leaf perturbed, so zero biases and unit norm
    weights cannot hide a layout slip in the conversion."""
    tree = JWM.init_wan_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def model(params):
    m = TWM.WanModel(TCFG, dtype=torch.float32, device="cpu")
    m.load_state_dict(wan_params_from_numpy(params, TCFG))
    return m


def layer_rows(key, n_layers, seq):
    """The rows JAX's SVG1 profiler draws in each layer of one forward."""
    n = min(SVG.num_sampled_rows, seq)
    mx = min(SVG.sample_mse_max_row, seq)
    return torch.as_tensor(np.stack([np.asarray(jax.random.randint(jax.random.fold_in(key, li), (n,), 0, mx))
                                     for li in range(n_layers)]))


def test_param_conversion_layout(params, model):
    sd = model.state_dict()
    assert set(sd) == set(wan_params_from_numpy(params, TCFG))
    np.testing.assert_array_equal(sd["blocks.1.ffn.fc1.weight"].numpy(), params["blocks"]["ffn"]["fc1"]["w"][1].T)
    np.testing.assert_array_equal(sd["blocks.0.self_attn.norm_q"].numpy(), params["blocks"]["self_attn"]["norm_q"][0])
    # the time path, modulation tables and norms stay f32 in a bf16 model
    bf = TWM.WanModel(TCFG, dtype=torch.bfloat16)
    assert bf.time_projection.weight.dtype == torch.float32 and bf.blocks[0].modulation.dtype == torch.float32
    assert bf.blocks[0].self_attn.q.weight.dtype == torch.bfloat16 and bf.head_out.weight.dtype == torch.bfloat16


@pytest.mark.parametrize("pattern", ["dense", "SVG"])
def test_wan_forward_matches_jax(params, model, pattern):
    """One forward with layer 0 in dense warm-up and layer 1 on the pattern.
    f32 over 2 blocks: rel L2 error <= 1e-5 (measured ~4e-7 on the CPU)."""
    lay = JPW.wan_layout(JCFG, 8 * H_LAT, 8 * W_LAT, NUM_FRAMES)
    tlay = TPW.wan_layout(TCFG, 8 * H_LAT, 8 * W_LAT, NUM_FRAMES)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, lay.num_frames, H_LAT, W_LAT)).astype(np.float32)
    ctx = rng.standard_normal((2, JCFG.text_len, JCFG.text_dim)).astype(np.float32)
    t = np.asarray([700.0, 700.0], np.float32)
    key = jax.random.PRNGKey(2)
    jrt = JPW.make_wan_runtime(lay, pattern=pattern, warmup=JC.WarmupSchedule(first_layers=1), svg=JSVG)
    ref, _ = JWM.wan_forward(params, JCFG, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), attention=jrt, rng=key)
    trt = TPW.make_wan_runtime(tlay, device="cpu", pattern=pattern, warmup=TC.WarmupSchedule(first_layers=1), svg=SVG)
    ours = TWM.wan_forward(model, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), attention=trt,
                           profile_rows=layer_rows(key, JCFG.num_layers, lay.seq_len))
    assert ours.dtype == torch.float32 and ours.shape == x.shape
    assert rel_err(ours.numpy(), ref) <= 1e-5


def test_unipc_tables_and_step_match_jax():
    """Same f64 numpy tables (equal); the f32 steps agree to 1e-6."""
    for n, shift in ((4, 3.0), (7, 5.0)):
        ours, ref = TUniPC(n, shift=shift), JUniPC(n, shift=shift)
        np.testing.assert_array_equal(ours.sigmas, ref.sigmas)
        np.testing.assert_array_equal(ours.timesteps, ref.timesteps)
        assert ours.pred_order == ref.pred_order
        for tab in ("pred_coeffs", "corr_coeffs"):
            for k, a in getattr(ref, tab).items():
                np.testing.assert_array_equal(getattr(ours, tab)[k], a)
        rng = np.random.default_rng(n)
        x = rng.standard_normal((1, 4, 2, 3, 3)).astype(np.float32)
        xo, so = torch.from_numpy(x), ours.init_state(torch.from_numpy(x))
        xr, sr = jnp.asarray(x), ref.init_state(jnp.asarray(x))
        for i in range(n):
            v = rng.standard_normal(x.shape).astype(np.float32)
            xo, so = ours.step(i, xo, torch.from_numpy(v), so)
            xr, sr = ref.step(i, xr, jnp.asarray(v), sr)
            np.testing.assert_allclose(xo.numpy(), np.asarray(xr), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("pattern", ["SVG", "dense"])
def test_generate_latents_matches_jax(params, model, pattern):
    """The slice: 3 UniPC steps with batched CFG, one warm-up layer and one
    dense warm-up step, from JAX's initial noise and with JAX's profiler rows.
    f32, 3 steps x 2 blocks x CFG 5.0: rel L2 error <= 1e-5 (measured ~1e-6 on the CPU)."""
    steps, seed = 3, 0
    kw = dict(height=8 * H_LAT, width=8 * W_LAT, num_frames=NUM_FRAMES, num_inference_steps=steps,
              guidance_scale=5.0, flow_shift=3.0, pattern=pattern, first_layers_fp=0.5, first_times_fp=0.34)
    rng = np.random.default_rng(3)
    ctx, ctx_null = (rng.standard_normal((1, JCFG.text_len, JCFG.text_dim)).astype(np.float32) for _ in range(2))
    ref = JPW.WanPipeline(JCFG, params, dtype=jnp.float32).generate_latents(
        jnp.asarray(ctx), jnp.asarray(ctx_null), seed=seed, svg=JSVG, **kw)
    # generate_latents' own draws: noise from split(PRNGKey(seed))[1], rows
    # from fold_in(fold_in(key, step), layer)
    key, nkey = jax.random.split(jax.random.PRNGKey(seed))
    lay = JPW.wan_layout(JCFG, kw["height"], kw["width"], NUM_FRAMES)
    lat0 = np.array(jax.random.normal(nkey, (1, 16, lay.num_frames, H_LAT, W_LAT), jnp.float32))
    rows = [layer_rows(jax.random.fold_in(key, i), JCFG.num_layers, lay.seq_len) for i in range(steps)]
    ours = TPW.WanPipeline(model)._denoise(torch.from_numpy(ctx), torch.from_numpy(ctx_null),
                                           torch.from_numpy(lat0), profile_rows=rows, svg=SVG, **kw)
    assert np.isfinite(ours.numpy()).all()
    assert rel_err(ours.numpy(), ref) <= 1e-5


def bf16_tree(tree, layout):
    """tree's f32 values in the dtype of each leaf of `layout` (a JAX init in
    bf16: linears bf16, the time path f32), rounded to nearest even as torch's
    load_state_dict rounds them into a bf16 model."""
    return jax.tree.map(lambda a, ref: np.asarray(a).astype(ref.dtype), tree, layout)


def test_generate_latents_bf16_step_matches_jax(params):
    """One UniPC step of the bf16 pipeline (the card's working type), SVG1
    with batched CFG and no warm-up, the same bf16 weights on both sides,
    JAX's noise and profiler rows. bf16 keeps 8 bits and the two frameworks
    round at other places (each matmul's sums, where an elementwise result is
    cast), over 2 blocks: the step's update (latents - noise) within rel L2
    5e-2 of JAX's (measured 1.7e-2)."""
    pattern = "SVG"
    kw = dict(height=8 * H_LAT, width=8 * W_LAT, num_frames=NUM_FRAMES, num_inference_steps=1,
              guidance_scale=5.0, flow_shift=3.0, pattern=pattern, first_layers_fp=0.0, first_times_fp=0.0)
    rng = np.random.default_rng(5)
    ctx, ctx_null = (rng.standard_normal((1, JCFG.text_len, JCFG.text_dim)).astype(np.float32) for _ in range(2))
    jparams = bf16_tree(params, JWM.init_wan_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.bfloat16))
    ref = JPW.WanPipeline(JCFG, jparams, dtype=jnp.bfloat16).generate_latents(
        jnp.asarray(ctx), jnp.asarray(ctx_null), seed=0, svg=JSVG, **kw)
    key, nkey = jax.random.split(jax.random.PRNGKey(0))
    lay = JPW.wan_layout(JCFG, kw["height"], kw["width"], NUM_FRAMES)
    lat0 = np.array(jax.random.normal(nkey, (1, 16, lay.num_frames, H_LAT, W_LAT), jnp.float32))
    model = TWM.WanModel(TCFG, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(wan_params_from_numpy(params, TCFG))
    ours = TPW.WanPipeline(model)._denoise(torch.from_numpy(ctx), torch.from_numpy(ctx_null), torch.from_numpy(lat0),
                                           profile_rows=[layer_rows(jax.random.fold_in(key, 0), JCFG.num_layers,
                                                                    lay.seq_len)], svg=SVG, **kw)
    ours, ref = ours.float().numpy(), np.asarray(ref, np.float32)
    assert np.isfinite(ours).all()
    assert rel_err(ours - lat0, ref - lat0) <= 5e-2


def test_cli_smoke_cpu(tmp_path):
    out = tmp_path / "lat.npz"
    TCLI.main(["--smoke", "--pattern", "SVG", "--device", "cpu", "--num_inference_steps", "2",
               "--output_file", str(out)])
    lat = np.load(out)["latents"]
    assert lat.shape == (1, 16, 3, 12, 16) and np.isfinite(lat).all()


@pytest.mark.parametrize("argv,exc", [
    (["--smoke", "--device", "cuda:99"], RuntimeError),
    (["--device", "cpu", "--model_dir", "/nonexistent"], FileNotFoundError),
    (["--smoke", "--device", "cpu", "--output_file", "video.mp4"], ImportError),
    (["--smoke", "--device", "cpu", "--dp", "2"], NotImplementedError),
], ids=["no_card_no_fallback", "model_dir", "video", "sap"])
def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, argv, exc):
    """No fallback to the CPU; a checkpoint dir that does not exist is refused,
    not replaced by random weights; .mp4 on a host without PIL (the card's)
    raises ImportError naming .y4m; data parallelism (--dp) is not ported
    (the id `sap` named SAP's tile mode, then int8 linears, which run now)."""
    if "cuda:99" in argv and torch.cuda.is_available():
        pytest.skip("this host has a card: nothing to refuse")
    monkeypatch.setitem(sys.modules, "PIL", None)
    argv = [str(tmp_path / a) if a.endswith(".mp4") else a for a in argv]
    with pytest.raises(exc, match=r"\.y4m" if exc is ImportError else None):
        TCLI.main(["--output_file", str(tmp_path / "x.npz")] + argv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    """The mixed-precision contract of models/common/layers.py: norms in f32,
    rms_norm cast back before the weight, linear weights cast to x.dtype.
    Elementwise maths agree to f32 rounding before the cast to `dtype`: one
    ulp of it (rtol 2^-7 in bf16, 1e-5 in f32); JAX evaluates gelu/silu in
    bf16 itself, so bf16 also allows atol 1e-2 near zero."""
    from sparse_videogen_tpu.models.common import layers as JL
    from sparse_videogen_tpu_torch.models.common import layers as TL

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    bf = dtype == "bfloat16"
    tol = dict(rtol=2.0**-7 if bf else 1e-5, atol=1e-2 if bf else 1e-6)
    f = lambda a: np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a.detach().float().numpy()
    np.testing.assert_allclose(f(TL.rms_norm(tx, torch.from_numpy(w), 1e-6)), f(JL.rms_norm(jx, w, 1e-6)), **tol)
    np.testing.assert_allclose(f(TL.layer_norm_f32(tx, 1e-6, torch.from_numpy(w), torch.from_numpy(b))),
                               f(JL.layer_norm_f32(jx, 1e-6, w, b)), rtol=1e-5, atol=1e-5)
    assert TL.layer_norm_f32(tx).dtype == torch.float32 and TL.rms_norm(tx, torch.from_numpy(w)).dtype == tx.dtype
    np.testing.assert_allclose(f(TL.gelu_tanh(tx)), f(JL.gelu_tanh(jx)), **tol)
    np.testing.assert_allclose(f(TL.silu(tx)), f(JL.silu(jx)), **tol)
    lin = torch.nn.Linear(64, 32)
    y = TL.linear(lin, tx)
    assert y.dtype == tx.dtype
    ref = JL.linear({"w": lin.weight.detach().numpy().T, "b": lin.bias.detach().numpy()}, jx)
    # bf16 matmuls round their sums at other places: two ulps
    np.testing.assert_allclose(f(y), f(ref), rtol=2.0**-6 if bf else 1e-5, atol=2e-2 if bf else 1e-5)
