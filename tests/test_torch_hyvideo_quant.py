"""HunyuanVideo's quantized blocks and its T2V CLI's --quant of the torch
port against the JAX package.

The blocks bypass layers.linear in one place, the single block's linear1
and linear2 (column and row slices, JAX's _col_slice / _row_slice): linear1's
columns slice the int8 wscale with them, linear2's two row slices each
quantize their own input per token, and the bias goes on the first part.
The modulation linears run on 1-2 rows (the int8 GEMM pads them). f32
throughout: the blocks within rel L2 1e-5. The CLI runs: fp8 within 1e-4;
int8 within 3e-2 (measured 5.4e-3 on the CPU), since W8A8's activation
codes are a step function and an ulp of difference in a linear's f32 input
flips one now and then, which this random model amplifies over the steps
(tests/test_torch_fm_dpm.py measures it).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_videogen_tpu.pipelines.hyvideo as JPH
import sparse_videogen_tpu_torch.models.hyvideo.model as THM
from sparse_videogen_tpu.cli import hyvideo_t2v as JCLI
from sparse_videogen_tpu.models.common.rope import nd_rope_cos_sin as jax_rope
from sparse_videogen_tpu.models.hyvideo import model as JHM
from sparse_videogen_tpu.utils import quant as JQ
from sparse_videogen_tpu_torch.cli import hyvideo_t2v as TCLI
from sparse_videogen_tpu_torch.io.from_jax import hyvideo_params_from_numpy
from sparse_videogen_tpu_torch.models.common.rope import nd_rope_cos_sin
from sparse_videogen_tpu_torch.pipelines import hyvideo as TPH
from sparse_videogen_tpu_torch.utils import quant as TQ
from sparse_videogen_tpu_torch.utils.quant import FP8Linear, Int8Linear

CFG_KW = dict(hidden_size=128, heads_num=2, mm_double_blocks_depth=2, mm_single_blocks_depth=2,
              rope_dim_list=(16, 24, 24), text_states_dim=32, text_states_dim_2=24, text_len=8, mlp_width_ratio=2.0)
JCFG, TCFG = JHM.HyVideoConfig(**CFG_KW), THM.HyVideoConfig(**CFG_KW)
GRID = (2, 4, 6)  # 48 video tokens


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def params():
    tree = JHM.init_hyvideo_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree)


def _attn_torch(q, k, v, t, layer_idx, rows=None, generator=None):
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.softmax(s, dim=-1) @ v


def _attn_jax(q, k, v, t, rng, layer_idx, state):
    s = (q @ jnp.swapaxes(k, -1, -2)) * q.shape[-1] ** -0.5
    return jax.nn.softmax(s, axis=-1) @ v, state


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_blocks_match_jax(params, kind, batch):
    """Layer 1 of the double and of the single blocks, every linear quantized
    (min_size 1), against JAX's blocks on the same quantized params and the
    same plain attention: rel L2 <= 1e-5 (measured 1.4e-7 int8, 4.6e-7
    fp8). The modulation linears see `batch` rows."""
    jfn, tfn = {"int8": (JQ.quantize_linears_int8, TQ.quantize_linears_int8),
                "fp8": (JQ.quantize_linears_fp8, TQ.quantize_linears_fp8)}[kind]
    model = hyvideo_params_from_numpy(params, TCFG)
    tfn(model.double_blocks, min_size=1)
    tfn(model.single_blocks, min_size=1)
    assert isinstance(model.single_blocks[1].linear2, (Int8Linear, FP8Linear))
    rng = np.random.default_rng(batch)
    h = CFG_KW["hidden_size"]
    img = rng.standard_normal((batch, int(np.prod(GRID)), h)).astype(np.float32)
    txt = rng.standard_normal((batch, CFG_KW["text_len"], h)).astype(np.float32)
    vec = rng.standard_normal((batch, h)).astype(np.float32)
    cos, sin = nd_rope_cos_sin(GRID, CFG_KW["rope_dim_list"])
    jcos, jsin = (jnp.asarray(a) for a in jax_rope(GRID, CFG_KW["rope_dim_list"]))
    f = torch.from_numpy
    tol = 1e-5

    jd = jax.tree.map(lambda a: a[1], jfn(params["double_blocks"], min_size=1))
    ji, jt, _ = jax.jit(lambda p, i, t_, v: JHM._double_block(p, JCFG, i, t_, v, jcos, jsin, 500.0, None, 1,
                                                               _attn_jax, None, None))(
        jd, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(vec))
    ti, tt = model.double_blocks[1](f(img), f(txt), f(vec), torch.as_tensor(cos), torch.as_tensor(sin), 500.0, 1,
                                    _attn_torch)
    assert rel_err(ti.numpy(), ji) <= tol and rel_err(tt.numpy(), jt) <= tol

    xx = np.concatenate([img, txt], axis=1)
    js = jax.tree.map(lambda a: a[1], jfn(params["single_blocks"], min_size=1))
    jo, _ = jax.jit(lambda p, x, v: JHM._single_block(p, JCFG, x, v, jcos, jsin, CFG_KW["text_len"], 500.0, None,
                                                       3, _attn_jax, None))(js, jnp.asarray(xx), jnp.asarray(vec))
    to = model.single_blocks[1](f(xx), f(vec), torch.as_tensor(cos), torch.as_tensor(sin), CFG_KW["text_len"], 500.0,
                                3, _attn_torch)
    assert rel_err(to.numpy(), jo) <= tol


def test_linear2_row_slices_quantize_each_input():
    """int8 linear2 as two row slices: each part's per-token scale comes
    from its own input, not one over [o | mlp], and the bias is added once:
    an input whose second part is 1000x the first gives the first part's
    codes their own scale (with one scale they would round to 0)."""
    lin = torch.nn.Linear(8, 4)
    q = TQ.int8_quantize_linear(lin)
    from sparse_videogen_tpu_torch.models.common.layers import linear_slice

    o = torch.full((1, 3, 4), 1e-3)
    mlp = torch.full((1, 3, 4), 1.0)
    parts = linear_slice(q, o, rows=slice(0, 4)) + linear_slice(q, mlp, rows=slice(4, None), bias=False)
    w = q.wi8.float() * q.wscale[:, None]
    ref = o @ w[:, :4].T + mlp @ w[:, 4:].T + lin.bias
    np.testing.assert_allclose(parts.numpy(), ref.detach().numpy(), rtol=1e-5, atol=1e-7)


@pytest.fixture
def smoke_from_jax(monkeypatch):
    """Both CLIs' --smoke runs in f32 on the JAX package's weights
    (init_hyvideo_params at the CLI's seed), the port from JAX's noise and
    profiler rows; the final latents and the port's quantized linears."""
    got = {}
    init = JHM.init_hyvideo_params
    monkeypatch.setattr(JHM, "init_hyvideo_params", lambda rng, cfg, dtype=None: init(rng, cfg, dtype=jnp.float32))

    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), JHM.HyVideoConfig(**TCLI.SMOKE_CFG),
                                         dtype=jnp.float32))
    sd = hyvideo_params_from_numpy(tree, THM.HyVideoConfig(**TCLI.SMOKE_CFG)).state_dict()
    model_cls = THM.HyVideoModel

    def f32_model(cfg, dtype=None, device="cpu"):
        m = model_cls(cfg, dtype=torch.float32, device=device)
        m.load_state_dict(sd)
        m.init_random = lambda gen: m  # the weights are JAX's, as loaded
        return m

    monkeypatch.setattr(THM, "HyVideoModel", f32_model)

    def port_generate(self, text, mask, pooled, *, seed, height, width, num_frames, num_inference_steps, svg, **kw):
        key, nkey = jax.random.split(jax.random.PRNGKey(seed))
        cfg = self.model.cfg
        lay = TPH.hyvideo_layout(cfg, height, width, num_frames)
        lat0 = np.array(jax.random.normal(nkey, (1, 16, lay.num_frames, height // 8, width // 8), jnp.float32))
        n, top = min(svg.num_sampled_rows, lay.seq_len), min(svg.sample_mse_max_row, lay.seq_len)
        rows = [torch.as_tensor(np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(jax.random.fold_in(key, i), li), (n,), 0, top)) for li in range(cfg.num_layers)]))
                for i in range(num_inference_steps)]
        got["quantized"] = sum(isinstance(m, (Int8Linear, FP8Linear)) for m in self.model.modules())
        kw.pop("image_latents", None)
        got["port"] = self._denoise(text, mask, pooled, torch.from_numpy(lat0), height=height, width=width,
                                    num_frames=num_frames, num_inference_steps=num_inference_steps, svg=svg,
                                    profile_rows=rows, **kw)
        return got["port"]

    jax_generate = JPH.HyVideoPipeline.generate_latents

    def jax_generate_kept(self, *a, **kw):
        got["jax"] = jax_generate(self, *a, **kw)
        return got["jax"]

    monkeypatch.setattr(TPH.HyVideoPipeline, "generate_latents", port_generate)
    monkeypatch.setattr(JPH.HyVideoPipeline, "generate_latents", jax_generate_kept)
    monkeypatch.setattr(JPH, "HyVideoPipeline", functools.partial(JPH.HyVideoPipeline, dtype=jnp.float32))
    return got


@pytest.mark.parametrize("quant", ["fp8", "int8"])
def test_cli_quant_matches_jax(tmp_path, smoke_from_jax, quant):
    """hyvideo_t2v --smoke --quant fp8|int8 (SVG1, 2 steps) against the JAX
    CLI, f32 DiTs on JAX's weights: latents within rel L2 1e-4 (fp8) and
    3e-2 (int8, tests/test_torch_fm_dpm.py); the 10 linears of each double
    block and the 3 of each single block are swapped (2 + 2 blocks)."""
    args = ["--smoke", "--pattern", "SVG", "--num_inference_steps", "2", "--quant", quant]
    TCLI.main(args + ["--device", "cpu", "--output_file", str(tmp_path / "port.npz")])
    JCLI.main(args + ["--output_file", str(tmp_path / "jax.npz")])
    ours, ref = smoke_from_jax["port"].numpy(), np.asarray(smoke_from_jax["jax"], np.float32)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    assert rel_err(ours, ref) <= (3e-2 if quant == "int8" else 1e-4)
    assert smoke_from_jax["quantized"] == 2 * 10 + 2 * 3
