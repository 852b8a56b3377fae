"""Image + prompt -> video through the port's CLI (cli/wan_i2v.py) and the
JAX package's, on one synthetic checkpoint dir (chip_smoke.write_tiny_checkpoint
with i2v: an I2V transformer, UMT5, the VAE with its encoder, a CLIP vision
tower in HF's names, a spiece.model) and a small JPEG that PIL writes: the
JAX CLI reads it through PIL, the port through io/image.py. The 48x80 image
fits to 480x816 at 480p; 5 frames, 2 dense steps. The port starts from the
JAX package's initial noise (handed to WanPipeline._denoise), so both runs
see the same inputs end to end: image reader, cubic resizes, CLIP, UMT5,
VAE encode, condition, DiT, UniPC, VAE decode, writer. Both DiTs run in f32
(patched in where the CLIs build them), as tests/test_torch_prompt_to_video.py
does; the parser is held to the JAX CLI's flags."""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import sparse_videogen_tpu.io.checkpoint as JCK
import sparse_videogen_tpu.pipelines as JP
import sparse_videogen_tpu_torch.models.wan.model as TWM
from sparse_videogen_tpu.cli import wan_i2v as JCLI
from sparse_videogen_tpu.io import native as JNATIVE
from sparse_videogen_tpu.pipelines import wan as JPW
from sparse_videogen_tpu_torch.cli import wan_i2v as TCLI
from sparse_videogen_tpu_torch.io.native import read_y4m
from sparse_videogen_tpu_torch.pipelines import wan as TPW

PROMPT = "a cat on the grass."


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wan_i2v_ckpt")
    chip_smoke.write_tiny_checkpoint(str(d), PROMPT, i2v=True)
    src = np.asarray(Image.open(chip_smoke.os.path.join(chip_smoke.ROOT, "examples", "1", "image.jpg")))
    Image.fromarray(src[200:248, 300:380]).save(d / "image.jpg", quality=90)
    return str(d)


def _actions(parser):
    return {a.dest: (sorted(a.option_strings), a.default, a.choices) for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    """The JAX CLI's flags by name, default and choices, plus --device."""
    ours, ref = _actions(TCLI.build_parser()), _actions(JCLI.build_parser())
    assert set(ours) - set(ref) == {"device"}
    for dest, spec in ref.items():
        assert ours[dest] == spec, dest
    assert TCLI._fit_resolution(480, 832, "720p") == JCLI._fit_resolution(480, 832, "720p") == (720, 1264)
    assert TCLI._fit_resolution(48, 80, "480p") == JCLI._fit_resolution(48, 80, "480p") == (480, 816)


@pytest.fixture
def jax_noise(monkeypatch):
    """Hand the port's generate_latents the JAX package's initial noise
    (split(PRNGKey(seed))[1]); keep both sides' final latents."""
    latents = {}

    def port_generate(self, ctx, ctx_null, *, seed, height, width, num_frames, mesh, **kw):
        _, nkey = jax.random.split(jax.random.PRNGKey(seed))
        lay = TPW.wan_layout(self.model.cfg, height, width, num_frames)
        lat0 = np.array(jax.random.normal(nkey, (1, 16, lay.num_frames, height // 8, width // 8), jnp.float32))
        latents["port"] = self._denoise(ctx, ctx_null, torch.from_numpy(lat0), height=height, width=width,
                                        num_frames=num_frames, **kw)
        return latents["port"]

    jax_generate = JPW.WanPipeline.generate_latents

    def jax_generate_kept(self, *a, **kw):
        latents["jax"] = jax_generate(self, *a, **kw)
        return latents["jax"]

    monkeypatch.setattr(TPW.WanPipeline, "generate_latents", port_generate)
    monkeypatch.setattr(JPW.WanPipeline, "generate_latents", jax_generate_kept)
    monkeypatch.setattr(JNATIVE, "_LIB", None)  # JAX's pure-Python .y4m writer, the port's math
    convert = JCK.convert_wan_dit
    monkeypatch.setattr(JCK, "convert_wan_dit", lambda sd, cfg, dtype=None: convert(sd, cfg, dtype=jnp.float32))
    monkeypatch.setattr(JP, "WanPipeline", functools.partial(JP.WanPipeline, dtype=jnp.float32))
    model = TWM.WanModel
    monkeypatch.setattr(TWM, "WanModel", lambda cfg, dtype=None, device="cpu": model(cfg, dtype=torch.float32,
                                                                                    device=device))
    return latents


def test_cli_image_to_video_matches_jax(model_dir, tmp_path, jax_noise):
    """f32 DiTs: latents within rel L2 1e-4 (measured 1.7e-5: CLIP, UMT5 and
    the VAE encode differ by f32 summation order, and the CLIs cast the text
    states and CLIP features to bf16, where a difference at a rounding
    boundary moves a value by a bf16 ulp); the .y4m frames within 4 uint8
    levels, mean under 0.05 (measured max 3, mean 0.003: the random VAE
    decoder amplifies the latent difference)."""
    args = ["--model_dir", model_dir, "--image_path", chip_smoke.os.path.join(model_dir, "image.jpg"),
            "--prompt", PROMPT, "--resolution", "480p", "--num_frames", "5", "--num_inference_steps", "2",
            "--vae_tiling", "off"]
    TCLI.main(args + ["--device", "cpu", "--output_file", str(tmp_path / "port.npz")])  # .npz -> .y4m
    JCLI.main(args + ["--output_file", str(tmp_path / "jax.y4m")])
    ours, fps = read_y4m(str(tmp_path / "port.y4m"))
    ref, _ = read_y4m(str(tmp_path / "jax.y4m"))
    assert fps == 16 and ours.shape == ref.shape == (5, 480, 816, 3)
    lat, jlat = jax_noise["port"].float().numpy(), np.asarray(jax_noise["jax"], np.float32)
    assert lat.shape == (1, 16, 2, 60, 102)
    assert np.linalg.norm(lat - jlat) / np.linalg.norm(jlat) <= 1e-4
    diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 4 and diff.mean() < 0.05


def test_cli_smoke_cpu(tmp_path):
    out = tmp_path / "lat.npz"
    TCLI.main(["--smoke", "--pattern", "SVG", "--device", "cpu", "--num_inference_steps", "2",
               "--output_file", str(out)])
    lat = np.load(out)["latents"]
    assert lat.shape == (1, 16, 3, 12, 16) and np.isfinite(lat).all()


@pytest.mark.parametrize("argv,exc,match", [
    (["--smoke", "--device", "cuda:99"], RuntimeError, None),
    (["--smoke", "--device", "cpu", "--dp", "2"], NotImplementedError, "--dp"),
    (["--smoke", "--device", "cpu", "--dit_fsdp"], NotImplementedError, "--dit_fsdp"),
    (["--device", "cpu", "--model_dir", "MODEL_DIR"], ValueError, "--image_path"),
    (["--device", "cpu", "--model_dir", "MODEL_DIR", "--image_path", "NOT_AN_IMAGE"], ValueError, r"\.npy"),
], ids=["no_card_no_fallback", "dp", "sap_tile", "no_image", "unreadable_image"])
def test_cli_refuses(model_dir, tmp_path, monkeypatch, argv, exc, match):
    """No fallback to the CPU; unported flags raise (the id `sap_tile` named
    SAP's tile mode, then --ulysses_degree, which run now: it holds
    --dit_fsdp); an I2V run needs an image, and an image it cannot read
    raises naming .npy."""
    if "cuda:99" in argv and torch.cuda.is_available():
        pytest.skip("this host has a card: nothing to refuse")
    monkeypatch.setitem(sys.modules, "PIL", None)
    bad = tmp_path / "image.bmp"
    bad.write_bytes(b"BM" + bytes(64))
    argv = [model_dir if a == "MODEL_DIR" else str(bad) if a == "NOT_AN_IMAGE" else a for a in argv]
    with pytest.raises(exc, match=match):
        TCLI.main(["--output_file", str(tmp_path / "x.npz")] + argv)


@pytest.mark.parametrize("res", ["480p", "720p"])
@pytest.mark.parametrize("run", ["svg", "dense", "sap"])
def test_i2v_presets_are_the_reference_scripts(res, run):
    """presets.I2V_PRESETS["14B-i2v-<res>-<run>"] holds what
    scripts/wan/wan_i2v_<res>_<run>.sh passes the CLI (parsed by the port's
    parser; the JAX CLI's flow shift by resolution and the fit of the
    script's default image), at WAN_14B_I2V's widths."""
    import os
    import re
    import shlex

    from sparse_videogen_tpu_torch.io.image import load_image
    from sparse_videogen_tpu_torch.presets import I2V_PRESETS, WAN_14B_I2V

    text = open(os.path.join(chip_smoke.ROOT, "scripts", "wan", f"wan_i2v_{res}_{run}.sh")).read()
    cmd = re.search(r"sparse_videogen_tpu\.cli\.wan_i2v \$MODEL_ARG(.*?)\n\n?$", text.replace("\\\n", " "),
                    re.S).group(1)
    cmd = re.sub(r'"\$\{\w+:-([^}]*)\}"', lambda m: shlex.quote(m.group(1)), cmd)
    args = TCLI.build_parser().parse_args(shlex.split(cmd))
    preset = I2V_PRESETS[f"14B-i2v-{res}-{run}"]
    img = load_image(os.path.join(chip_smoke.ROOT, args.image_path))
    assert (preset.height, preset.width) == TCLI._fit_resolution(img.shape[2], img.shape[3], args.resolution)
    assert preset.num_frames == args.num_frames and preset.flow_shift == (5.0 if res == "720p" else 3.0)
    assert (preset.first_layers_fp, preset.first_times_fp) == (args.first_layers_fp, args.first_times_fp)
    assert args.pattern == {"svg": "SVG", "dense": "dense", "sap": "SAP"}[run]
    kw = preset.generate_kwargs()
    assert kw["svg"].sparsity == args.sparsity and kw["svg"].num_sampled_rows == args.num_sampled_rows
    if run == "sap":
        sap = preset.sap
        assert (sap.num_q_centroids, sap.num_k_centroids, sap.top_p_kmeans, sap.min_kc_ratio, sap.kmeans_iter_init,
                sap.kmeans_iter_step) == (args.num_q_centroids, args.num_k_centroids, args.top_p_kmeans,
                                          args.min_kc_ratio, args.kmeans_iter_init, args.kmeans_iter_step)
    m = preset.model
    assert (m.model_type, m.dim, m.num_heads, m.ffn_dim, m.num_layers, m.in_dim, m.image_dim) == (
        "i2v", 5120, 40, 13824, 40, 36, 1280) and m == WAN_14B_I2V


def test_projection_arithmetic():
    """scripts/profile_wan.project_steps: a layer-step is a run's last step
    over its layers (the median over runs of a pattern); the preset's
    warm-up makes whole dense steps and dense layers."""
    from sparse_videogen_tpu_torch.presets import I2V_PRESETS
    from sparse_videogen_tpu_torch.scripts.profile_wan import project_steps

    runs = [{"pattern": "SVG", "per_step_s": [9.0, 0.3]}, {"pattern": "dense", "per_step_s": [9.0, 0.6]},
            {"pattern": "SVG", "per_step_s": [9.0, 0.3]}]
    out = project_steps(runs, I2V_PRESETS["14B-i2v-480p-svg"], layers=3)
    # 50 steps: floor(0.03 * 50) = 1 dense step; floor(0.3 * 40) = 12 dense layers a step
    dense_ls = 1 * 40 + 49 * 12
    assert out["dense_s"] == pytest.approx(50 * 40 * 0.2)
    assert out["SVG_s"] == pytest.approx(dense_ls * 0.2 + (50 * 40 - dense_ls) * 0.1)
    assert project_steps(runs[:1], I2V_PRESETS["14B-i2v-480p-svg"], layers=3) == {}
