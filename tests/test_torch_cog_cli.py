"""CogVideoX 1.5 I2V through the port's CLI and the JAX package's, from an
image and a prompt to a video (cli/cog_i2v.py --model_dir), on the
synthetic checkpoint of chip_smoke.write_tiny_cog_checkpoint (T5 v1.1 in
HF's weight names, its config.json in the package's names, which the JAX
CLI reads; the DiT and VAE in diffusers' names; a spiece.model), with
examples/1/image.jpg (PIL for the JAX CLI, io/image.py for the port)
resized bilinearly to 96x128, 9 frames, 2 DDIM steps. The port starts from
the JAX package's initial noise and SVG1 rows (handed to
CogPipeline._denoise), so both see the same inputs end to end: tokenizer,
T5, resize, VAE encode, DiT, DDIM, tiled VAE decode, writer. The DiTs and
T5 run in f32 (patched in where the CLIs build them): latents within rel L2
1e-4, the .y4m frames within 4 uint8 levels."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sparse_videogen_tpu.io.checkpoint as JCK
import sparse_videogen_tpu_torch.models.cog.model as TCM
from sparse_videogen_tpu.cli import cog_i2v as JCLI
from sparse_videogen_tpu.io import native as JNATIVE
from sparse_videogen_tpu.pipelines import cog as JPC
from sparse_videogen_tpu_torch.cli import cog_i2v as TCLI
from sparse_videogen_tpu_torch.io import encoders as TENC
from sparse_videogen_tpu_torch.io.native import read_y4m
from sparse_videogen_tpu_torch.pipelines import cog as TPC

PROMPT = "a cat walks on the grass"
IMAGE = os.path.join(chip_smoke.ROOT, "examples", "1", "image.jpg")
ARGS = ["--prompt", PROMPT, "--height", "96", "--width", "128", "--num_frames", "9", "--num_step", "2",
        "--image_path", IMAGE, "--vae_tiling", "on", "--vae_tile", "8", "--vae_tile_overlap", "2"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("cog_cli")
    chip_smoke.write_tiny_cog_checkpoint(str(d), PROMPT, t5_names="package")
    return str(d)


@pytest.fixture
def jax_inputs(monkeypatch):
    """The port's generate_latents runs _denoise from the JAX package's
    initial noise and SVG1 rows; both sides' latents are kept; DiTs and T5
    in f32."""
    latents = {}

    def port_generate(self, ctx, ctx_null, img, *, seed, height, width, num_frames, num_inference_steps, svg,
                      **kw):
        key, nkey = jax.random.split(jax.random.PRNGKey(seed))
        cfg = self.model.cfg
        f_lat, extra = TPC.latent_frames(cfg, num_frames)
        lay = TPC.cog_layout(cfg, height, width, num_frames)
        lat0 = np.array(jax.random.normal(nkey, (1, 16, f_lat + extra, height // 8, width // 8), jnp.float32))
        n, top = min(svg.num_sampled_rows, lay.seq_len), min(svg.sample_mse_max_row, lay.seq_len)
        rows = [torch.as_tensor(np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(jax.random.fold_in(key, i), li), (n,), 0, top)) for li in range(cfg.num_layers)]))
                for i in range(num_inference_steps)]
        latents["port"] = self._denoise(ctx, ctx_null, img, torch.from_numpy(lat0), height=height, width=width,
                                        num_frames=num_frames, num_inference_steps=num_inference_steps, svg=svg,
                                        profile_rows=rows, **kw)
        return latents["port"]

    jax_generate = JPC.CogPipeline.generate_latents

    def jax_generate_kept(self, *a, **kw):
        latents["jax"] = jax_generate(self, *a, **kw)
        return latents["jax"]

    monkeypatch.setattr(TPC.CogPipeline, "generate_latents", port_generate)
    monkeypatch.setattr(JPC.CogPipeline, "generate_latents", jax_generate_kept)
    monkeypatch.setattr(JPC, "CogPipeline", functools.partial(JPC.CogPipeline, dtype=jnp.float32))
    monkeypatch.setattr(JNATIVE, "_LIB", None)  # JAX's pure-Python .y4m writer, the port's math
    for name in ("convert_cog_dit", "convert_t5_hf"):
        convert = getattr(JCK, name)
        monkeypatch.setattr(JCK, name, functools.partial(lambda c, sd, cfg, dtype=None: c(sd, cfg, dtype=jnp.float32),
                                                         convert))
    model = TCM.CogModel
    monkeypatch.setattr(TCM, "CogModel", lambda cfg, dtype=None, device="cpu": model(cfg, dtype=torch.float32,
                                                                                    device=device))
    from_dir = TENC.T5TextEncoder.from_dir.__func__
    monkeypatch.setattr(TENC.T5TextEncoder, "from_dir",
                        classmethod(lambda c, d, **kw: from_dir(c, d, **dict(kw, dtype=torch.float32))))
    return latents


def test_image_to_video_matches_jax(ckpt, tmp_path, jax_inputs):
    """SVG1 (the CLI's default pattern); both write a .y4m at 8 fps."""
    TCLI.main(ARGS + ["--model_dir", ckpt, "--device", "cpu", "--output_path", str(tmp_path / "port.npz")])
    JCLI.main(ARGS + ["--model_dir", ckpt, "--output_path", str(tmp_path / "jax.y4m")])
    ours, fps = read_y4m(str(tmp_path / "port.y4m"))
    ref, _ = read_y4m(str(tmp_path / "jax.y4m"))
    assert fps == 8 and ours.shape == ref.shape == (9, 96, 128, 3)
    lat, jlat = jax_inputs["port"].float().numpy(), np.asarray(jax_inputs["jax"], np.float32)
    err = np.linalg.norm(lat - jlat) / np.linalg.norm(jlat)
    assert np.isfinite(lat).all() and err <= 1e-4, err
    assert np.abs(ours.astype(np.int32) - ref.astype(np.int32)).max() <= 4


@pytest.mark.parametrize("argv,exc,match", [
    (["--model_dir", "CKPT"], ValueError, "--image_path"),
    (["--model_dir", "CKPT", "--image_path", IMAGE, "--smoke"], None, None),
], ids=["no_image", "smoke_ignores_the_image"])
def test_cli_image_rules(ckpt, tmp_path, argv, exc, match):
    """A checkpoint run needs an image; --smoke ignores a pixel image, as the
    JAX smoke ignores --image_path."""
    argv = [ckpt if a == "CKPT" else a for a in argv] + ["--device", "cpu", "--num_step", "1", "--output_path",
                                                         str(tmp_path / "x.npz")]
    if exc is None:
        TCLI.main(argv)
        assert np.isfinite(np.load(tmp_path / "x.npz")["latents"]).all()
    else:
        with pytest.raises(exc, match=match):
            TCLI.main(argv)
