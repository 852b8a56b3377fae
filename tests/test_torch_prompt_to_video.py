"""Prompt -> video through the port's CLI (cli/wan_t2v.py --model_dir) and
the JAX package's, on the same synthetic checkpoint dir (the builders of
tests/test_prompt_to_video.py: transformer/umt5/vae safetensors in the
reference's names, config.json files, a synthetic spiece.model), at
96x128x9 and 2 steps. The port starts from the JAX package's initial noise
and SVG1 profiler rows (handed to WanPipeline._denoise), so the two runs
see the same inputs end to end: tokenizer, UMT5, DiT, UniPC, VAE, writer.

The CLIs run the DiT in bf16. The frameworks round bf16 at other places,
and this checkpoint's DiT has unit-normal weights (outputs in the
hundreds), so with guidance 5.0 two bf16 steps move the latents by ~3%
between them. The comparison of frames within 2 uint8 levels is therefore
made with both DiTs in f32 (patched in at the CLIs' model builders); the
bf16 run is held to its own stated tolerance."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_videogen_tpu.io.checkpoint as JCK
import sparse_videogen_tpu.pipelines as JP
import sparse_videogen_tpu_torch.models.wan.model as TWM
from sparse_videogen_tpu.cli import wan_t2v as JCLI
from sparse_videogen_tpu.io import native as JNATIVE
from sparse_videogen_tpu.pipelines import wan as JPW
from sparse_videogen_tpu_torch.cli import wan_t2v as TCLI
from sparse_videogen_tpu_torch.io import checkpoint as TCK
from sparse_videogen_tpu_torch.io.from_jax import wan_params_from_numpy
from sparse_videogen_tpu_torch.io.native import read_y4m
from sparse_videogen_tpu_torch.pipelines import wan as TPW
from tests.test_checkpoint import make_sd_diffusers, make_sd_wan_orig
from tests.test_prompt_to_video import CFG as JCFG
from tests.test_prompt_to_video import model_dir  # noqa: F401  (the module-scoped fixture)

ARGS = ["--prompt", "a cat on the grass.", "--height", "96", "--width", "128", "--num_frames", "9",
        "--num_inference_steps", "2"]


def _jax_draws(seed, model_cfg, svg, height, width, num_frames, steps):
    """The initial noise and SVG1 profiler rows of the JAX generate_latents:
    noise from split(PRNGKey(seed))[1], rows from fold_in(fold_in(key,
    step), layer)."""
    key, nkey = jax.random.split(jax.random.PRNGKey(seed))
    lay = TPW.wan_layout(model_cfg, height, width, num_frames)
    lat0 = np.array(jax.random.normal(nkey, (1, model_cfg.out_dim, lay.num_frames, height // 8, width // 8),
                                      jnp.float32))
    n, mx = min(svg.num_sampled_rows, lay.seq_len), min(svg.sample_mse_max_row, lay.seq_len)
    rows = [torch.as_tensor(np.stack([np.asarray(jax.random.randint(jax.random.fold_in(jax.random.fold_in(key, i), li),
                                                                    (n,), 0, mx))
                                      for li in range(model_cfg.num_layers)])) for i in range(steps)]
    return torch.from_numpy(lat0), rows


@pytest.fixture
def jax_inputs(monkeypatch):
    """Hand the port's generate_latents the JAX package's draws; collect both
    sides' final latents."""
    latents = {}

    def port_generate(self, ctx, ctx_null, *, seed, height, width, num_frames, num_inference_steps, svg,
                      sampler, mesh, **kw):
        lat0, rows = _jax_draws(seed, self.model.cfg, svg, height, width, num_frames, num_inference_steps)
        latents["port"] = self._denoise(ctx, ctx_null, lat0, height=height, width=width, num_frames=num_frames,
                                        num_inference_steps=num_inference_steps, svg=svg, profile_rows=rows, **kw)
        return latents["port"]

    jax_generate = JPW.WanPipeline.generate_latents

    def jax_generate_kept(self, *a, **kw):
        latents["jax"] = jax_generate(self, *a, **kw)
        return latents["jax"]

    monkeypatch.setattr(TPW.WanPipeline, "generate_latents", port_generate)
    monkeypatch.setattr(JPW.WanPipeline, "generate_latents", jax_generate_kept)
    monkeypatch.setattr(JNATIVE, "_LIB", None)  # JAX's pure-Python .y4m writer, the port's math
    return latents


def _f32_dits(monkeypatch):
    convert = JCK.convert_wan_dit
    monkeypatch.setattr(JCK, "convert_wan_dit", lambda sd, cfg, dtype=None: convert(sd, cfg, dtype=jnp.float32))
    monkeypatch.setattr(JP, "WanPipeline", functools.partial(JP.WanPipeline, dtype=jnp.float32))
    model = TWM.WanModel
    monkeypatch.setattr(TWM, "WanModel", lambda cfg, dtype=None, device="cpu": model(cfg, dtype=torch.float32,
                                                                                    device=device))


@pytest.mark.parametrize("pattern,dtype", [("SVG", "float32"), ("dense", "float32"), ("SVG", "bfloat16")])
def test_cli_video_matches_jax(model_dir, tmp_path, monkeypatch, jax_inputs, pattern, dtype):  # noqa: F811
    """f32 DiTs: the .y4m frames within 2 uint8 levels, mean under 0.5 (a
    1e-6 latent difference crosses a truncation boundary now and then; the
    4:2:0 read-back spreads a chroma step over 3 channels). bf16 (the CLIs'
    own): latents within rel L2 5e-2 (measured 3.1e-2 on the CPU; the same
    bound as the bf16 pipeline step of tests/test_torch_wan.py) and frames
    within 4 levels on average (measured 1.9)."""
    if dtype == "float32":
        _f32_dits(monkeypatch)
    args = ARGS + ["--model_dir", model_dir, "--pattern", pattern]
    TCLI.main(args + ["--device", "cpu", "--output_file", str(tmp_path / "port.npz")])  # an .npz name -> .y4m
    JCLI.main(args + ["--output_file", str(tmp_path / "jax.y4m")])
    ours, fps = read_y4m(str(tmp_path / "port.y4m"))
    ref, _ = read_y4m(str(tmp_path / "jax.y4m"))
    assert fps == 16 and ours.shape == ref.shape == (5, 48, 64, 3)  # this VAE upsamples 4x
    diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    lat, jlat = jax_inputs["port"].float().numpy(), np.asarray(jax_inputs["jax"], np.float32)
    rel = np.linalg.norm(lat - jlat) / np.linalg.norm(jlat)
    if dtype == "float32":
        assert rel <= 1e-5
        assert diff.max() <= 2 and diff.mean() < 0.5
    else:
        assert rel <= 5e-2
        assert diff.mean() < 4.0


def test_converted_cache_gives_the_same_bytes(model_dir, tmp_path):  # noqa: F811
    """--converted_cache: the first run converts and saves the DiT's
    state_dict (io/safetensors.save_file), the second loads it; both videos
    are the same bytes."""
    cache = str(tmp_path / "cache")
    for i in range(2):
        TCLI.main(ARGS + ["--model_dir", model_dir, "--converted_cache", cache, "--pattern", "dense",
                          "--num_inference_steps", "1", "--device", "cpu",
                          "--output_file", str(tmp_path / f"c{i}.y4m")])
    assert os.path.isfile(os.path.join(cache, "wan_dit", "params.safetensors"))
    assert (tmp_path / "c0.y4m").read_bytes() == (tmp_path / "c1.y4m").read_bytes()


def test_prompt_source_and_latents_without_vae(model_dir, tmp_path):  # noqa: F811
    """--prompt_source picks a line of a prompt list; a model_dir without
    vae/ writes latents to the .npz."""
    d = tmp_path / "novae"
    d.mkdir()
    for name in ("transformer", "umt5", "spiece.model"):
        os.symlink(os.path.join(model_dir, name), d / name)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a dog\na cat on the grass.\n")
    out = tmp_path / "lat.npz"
    TCLI.main(["--model_dir", str(d), "--prompt_source", "T2V_Wan_VBench", "--prompt", str(prompts),
               "--prompt_idx", "1", "--height", "96", "--width", "128", "--num_frames", "9",
               "--num_inference_steps", "1", "--device", "cpu", "--output_file", str(out)])
    lat = np.load(out)["latents"]
    assert lat.shape == (1, 16, 3, 12, 16) and np.isfinite(lat).all()


@pytest.mark.parametrize("naming", ["wan_orig", "diffusers"])
def test_convert_wan_dit_equals_jax_conversion(tmp_path, naming):
    """The reference's DiT names (wan_orig and diffusers) -> WanModel: the
    same bf16/f32 weights as JAX's convert_wan_dit after the layout change;
    config.json in either naming gives the same config."""
    import dataclasses
    import json

    sd = make_sd_wan_orig(JCFG) if naming == "wan_orig" else make_sd_diffusers(JCFG)
    tcfg = TWM.WanConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(TWM.WanConfig)})
    jtree = jax.tree.map(lambda a: np.asarray(a, np.float32), JCK.convert_wan_dit(sd, JCFG))
    ref = TWM.WanModel(tcfg)
    ref.load_state_dict(wan_params_from_numpy(jtree, tcfg))
    ours = TWM.WanModel(tcfg)
    ours.load_state_dict(TCK.convert_wan_dit({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg))
    want = ref.state_dict()
    for name, t in ours.state_dict().items():
        assert torch.equal(t, want[name]), name
    keys = (dict(dim=32, ffn_dim=64, num_heads=4, num_layers=2, freq_dim=16, text_dim=16, text_len=8)
            if naming == "wan_orig" else
            dict(num_attention_heads=4, attention_head_dim=8, ffn_dim=64, num_layers=2, freq_dim=16, text_dim=16,
                 text_len=8, in_channels=16, out_channels=16, patch_size=[1, 2, 2]))
    (tmp_path / "config.json").write_text(json.dumps(keys))
    assert TCK.wan_config_from_json(str(tmp_path)) == tcfg
    assert dataclasses.asdict(JCK.wan_config_from_json(str(tmp_path))) == \
        dict(dataclasses.asdict(JCFG), qk_norm=True, cross_attn_norm=True, image_dim=1280)
