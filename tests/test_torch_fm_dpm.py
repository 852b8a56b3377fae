"""FlowDPM (DPM-Solver++ for flow matching) of the torch port against the
JAX package's, and the Wan T2V CLI with --sampler dpm++ and the
quantization flags against the JAX CLI.

The tables are the same f64 numpy code: equal bit for bit. The f32 steps
agree to 1e-6. The CLI runs take the --smoke path of both packages (the
tiny checkpoint of the other CLI tests is too narrow for the quantizers'
min_size, 65,536 stacked elements) with the JAX package's f32 weights, noise
and profiler rows handed to the port and both DiTs in f32: latents within
rel L2 1e-4, as the other CLI tests hold, except under int8. W8A8 rounds
every activation to a code per token, a step function: where the two
frameworks' f32 activations differ by an ulp (sums in another order) a code
flips now and then, and this random model amplifies the flips. A relative
perturbation of 1e-6 of its input moves one int8 forward of the port by
4.5e-3 (the float forward by 9.4e-7; measured on the CPU), and one int8
forward of the port and JAX's on the same input differ by 2.8e-3. The int8
run is held to rel L2 3e-2 (measured 9.7e-3); tests/test_torch_quant.py
holds the codes, the int32 products and one linear exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_videogen_tpu.pipelines as JP
import sparse_videogen_tpu_torch.models.wan.model as TWM
from sparse_videogen_tpu.cli import wan_t2v as JCLI
from sparse_videogen_tpu.models.wan import model as JWM
from sparse_videogen_tpu.pipelines import wan as JPW
from sparse_videogen_tpu.schedulers import FlowDPM as JDPM
from sparse_videogen_tpu_torch.cli import wan_t2v as TCLI
from sparse_videogen_tpu_torch.io.from_jax import wan_params_from_numpy
from sparse_videogen_tpu_torch.pipelines import wan as TPW
from sparse_videogen_tpu_torch.schedulers import FlowDPM as TDPM
from sparse_videogen_tpu_torch.utils.quant import FP8Linear, Int8Linear
from tests.test_torch_prompt_to_video import _jax_draws


@pytest.mark.parametrize("shift", [3.0, 5.0])
@pytest.mark.parametrize("n", [1, 2, 5, 50])
def test_tables_equal_jax(n, shift):
    """sigmas, timesteps and the c_x / c_m0 / c_m1 tables equal JAX's; the
    last step is first order (c_m1 = 0) with c_x = 0 (sigma 0)."""
    ours, ref = TDPM(n, shift=shift), JDPM(n, shift=shift)
    for name in ("sigmas", "timesteps", "_cx", "_cm0", "_cm1"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
    assert ours._cm1[-1] == 0.0 and ours._cx[-1] == 0.0 and ours._cm1[0] == 0.0


def test_steps_match_jax():
    """Seven f32 steps from the same noise and velocities: within 1e-6."""
    for n, shift in ((4, 3.0), (7, 5.0)):
        ours, ref = TDPM(n, shift=shift), JDPM(n, shift=shift)
        rng = np.random.default_rng(n)
        x = rng.standard_normal((1, 4, 2, 3, 3)).astype(np.float32)
        xo, so = torch.from_numpy(x), ours.init_state(torch.from_numpy(x))
        xr, sr = jnp.asarray(x), ref.init_state(jnp.asarray(x))
        for i in range(n):
            v = rng.standard_normal(x.shape).astype(np.float32)
            xo, so = ours.step(i, xo, torch.from_numpy(v), so)
            xr, sr = ref.step(i, xr, jnp.asarray(v), sr)
            np.testing.assert_allclose(xo.numpy(), np.asarray(xr), atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(so.numpy(), np.asarray(sr), atol=1e-6, rtol=1e-6)


@pytest.fixture
def smoke_from_jax(monkeypatch):
    """Both CLIs' --smoke runs in f32 on the JAX package's weights
    (init_wan_params at the CLI's seed), the port handed JAX's noise and
    profiler rows; both sides' final latents and the port's quantized
    linears are collected."""
    got = {}
    init = JWM.init_wan_params
    monkeypatch.setattr(JWM, "init_wan_params", lambda rng, cfg, dtype=None: init(rng, cfg, dtype=jnp.float32))
    monkeypatch.setattr(JP, "WanPipeline", functools.partial(JP.WanPipeline, dtype=jnp.float32))
    model_cls = TWM.WanModel

    def f32_model(cfg, dtype=None, device="cpu"):
        m = model_cls(cfg, dtype=torch.float32, device=device)
        tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), JWM.WanConfig(**TCLI.SMOKE_CFG),
                                             dtype=jnp.float32))
        m.load_state_dict(wan_params_from_numpy(tree, cfg))
        m.init_random = lambda gen: m  # the weights are JAX's, as loaded
        return m

    monkeypatch.setattr(TWM, "WanModel", f32_model)

    def port_generate(self, ctx, ctx_null, *, seed, height, width, num_frames, num_inference_steps, svg, mesh,
                      **kw):
        lat0, rows = _jax_draws(seed, self.model.cfg, svg, height, width, num_frames, num_inference_steps)
        got["quantized"] = sum(isinstance(m, (Int8Linear, FP8Linear)) for m in self.model.modules())
        got["port"] = self._denoise(ctx, ctx_null, lat0, height=height, width=width, num_frames=num_frames,
                                    num_inference_steps=num_inference_steps, svg=svg, profile_rows=rows, **kw)
        return got["port"]

    jax_generate = JPW.WanPipeline.generate_latents

    def jax_generate_kept(self, *a, **kw):
        got["jax"] = jax_generate(self, *a, **kw)
        return got["jax"]

    monkeypatch.setattr(TPW.WanPipeline, "generate_latents", port_generate)
    monkeypatch.setattr(JPW.WanPipeline, "generate_latents", jax_generate_kept)
    return got


@pytest.mark.parametrize("flags", [["--sampler", "dpm++"], ["--quant", "int8"], ["--quant", "fp8"],
                                   ["--use_fp8", "--sampler", "dpm++", "--pattern", "dense"]],
                         ids=["dpm++", "int8", "fp8", "use_fp8_dpm++"])
def test_wan_cli_matches_jax(tmp_path, smoke_from_jax, flags):
    """--sampler dpm++, --quant int8|fp8 and --use_fp8 (fp8 without --quant)
    in the port's Wan T2V CLI against the JAX CLI's, f32 DiTs on JAX's
    weights, 3 steps (SVG1 unless stated): latents within rel L2 1e-4 (int8:
    3e-2, see the module docstring); the quantized runs swap the 10 linears
    of each of the 4 blocks."""
    args = ["--smoke", "--pattern", "SVG", "--num_inference_steps", "3"] + flags
    TCLI.main(args + ["--device", "cpu", "--output_file", str(tmp_path / "port.npz")])
    JCLI.main(args + ["--output_file", str(tmp_path / "jax.npz")])
    ours, ref = smoke_from_jax["port"].numpy(), np.asarray(smoke_from_jax["jax"], np.float32)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    assert np.linalg.norm(ours - ref) / np.linalg.norm(ref) <= (3e-2 if "int8" in flags else 1e-4)
    assert smoke_from_jax["quantized"] == (0 if flags == ["--sampler", "dpm++"] else 40)
