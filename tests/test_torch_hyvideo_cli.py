"""HunyuanVideo through the port's CLIs and the JAX package's, from a
prompt (cli/hyvideo_t2v.py --model_dir) and from an image and a prompt
(cli/hyvideo_i2v.py --model_dir, a Llava text encoder), on the synthetic
checkpoints of chip_smoke.write_tiny_hyvideo_checkpoint (the reference's
names; tokenizer.json files that `tokenizers` reads for the JAX CLI and
io/tokenizer.py for the port; a small JPEG that PIL writes, read by PIL for
the JAX CLI and io/image.py for the port), at 64x64x5 and 2 steps. The port
starts from the JAX package's initial noise and SVG1 profiler rows (handed
to HyVideoPipeline._denoise), so both runs see the same inputs end to end:
tokenizers, text encoders, image resize, VAE encode, DiT, Euler, VAE
decode, writer. The DiTs and the text encoders run in f32 (patched in where
the CLIs build them): latents within rel L2 1e-4, the .y4m frames within 3
uint8 levels, as the Wan I2V CLI test holds them.

Also: the repair of --zero_step_kmeans_init (both HunyuanVideo CLIs hand
their pipeline the same SAPConfig; the Wan CLIs keep passing the flag),
the presets of the reference's scripts, the I2V parser and its refusals."""

import dataclasses
import functools
import os
import re
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import sparse_videogen_tpu.io.checkpoint as JCK
import sparse_videogen_tpu_torch.models.hyvideo.model as THM
from sparse_videogen_tpu.cli import hyvideo_i2v as JI2V
from sparse_videogen_tpu.cli import hyvideo_t2v as JT2V
from sparse_videogen_tpu.cli import wan_t2v as JWAN
from sparse_videogen_tpu.io import encoders as JENC
from sparse_videogen_tpu.io import native as JNATIVE
from sparse_videogen_tpu.pipelines import hyvideo as JPH
from sparse_videogen_tpu.pipelines import wan as JPW
from sparse_videogen_tpu_torch.cli import hyvideo_i2v as TI2V
from sparse_videogen_tpu_torch.cli import hyvideo_t2v as TT2V
from sparse_videogen_tpu_torch.cli import wan_t2v as TWAN
from sparse_videogen_tpu_torch.io import encoders as TENC
from sparse_videogen_tpu_torch.io.native import read_y4m
from sparse_videogen_tpu_torch.pipelines import hyvideo as TPH
from sparse_videogen_tpu_torch.pipelines import wan as TPW

PROMPT = "a cat walks on the grass"
ARGS = ["--prompt", PROMPT, "--height", "64", "--width", "64", "--num_frames", "5", "--num_inference_steps", "2"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("hy_cli")
    chip_smoke.write_tiny_hyvideo_checkpoint(str(d / "t2v"), PROMPT)
    chip_smoke.write_tiny_hyvideo_checkpoint(str(d / "i2v"), PROMPT, i2v=True)
    src = np.asarray(Image.open(os.path.join(chip_smoke.ROOT, "examples", "1", "image.jpg")))
    Image.fromarray(src[200:248, 300:380]).save(d / "image.jpg", quality=90)
    return str(d / "t2v"), str(d / "i2v"), str(d / "image.jpg")


def _f32_from_dir(monkeypatch, cls, dtype):
    from_dir = cls.from_dir.__func__
    monkeypatch.setattr(cls, "from_dir", classmethod(lambda c, d, **kw: from_dir(c, d, **dict(kw, dtype=dtype))))


@pytest.fixture
def jax_inputs(monkeypatch):
    """The port's generate_latents runs _denoise from the JAX package's
    initial noise (split(PRNGKey(seed))[1]) and SVG1 rows (fold_in(fold_in(
    key, step), layer)); both sides' final latents are kept; DiTs and text
    encoders in f32."""
    latents = {}

    def port_generate(self, text, mask, pooled, *, seed, height, width, num_frames, num_inference_steps, svg,
                      image_latents=None, **kw):
        key, nkey = jax.random.split(jax.random.PRNGKey(seed))
        cfg = self.model.cfg
        lay = TPH.hyvideo_layout(cfg, height, width, num_frames)
        lat0 = np.array(jax.random.normal(nkey, (1, 16, lay.num_frames, height // 8, width // 8), jnp.float32))
        n, top = min(svg.num_sampled_rows, lay.seq_len), min(svg.sample_mse_max_row, lay.seq_len)
        rows = [torch.as_tensor(np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(jax.random.fold_in(key, i), li), (n,), 0, top)) for li in range(cfg.num_layers)]))
                for i in range(num_inference_steps)]
        cond = None if image_latents is None else TPH.i2v_condition(cfg, image_latents, lay.num_frames)
        latents["port"] = self._denoise(text, mask, pooled, torch.from_numpy(lat0), height=height, width=width,
                                        num_frames=num_frames, num_inference_steps=num_inference_steps, svg=svg,
                                        profile_rows=rows, cond=cond, **kw)
        return latents["port"]

    jax_generate = JPH.HyVideoPipeline.generate_latents

    def jax_generate_kept(self, *a, **kw):
        latents["jax"] = jax_generate(self, *a, **kw)
        return latents["jax"]

    monkeypatch.setattr(TPH.HyVideoPipeline, "generate_latents", port_generate)
    monkeypatch.setattr(JPH.HyVideoPipeline, "generate_latents", jax_generate_kept)
    monkeypatch.setattr(JPH, "HyVideoPipeline", functools.partial(JPH.HyVideoPipeline, dtype=jnp.float32))
    monkeypatch.setattr(JNATIVE, "_LIB", None)  # JAX's pure-Python .y4m writer, the port's math
    convert = JCK.convert_hyvideo_dit
    monkeypatch.setattr(JCK, "convert_hyvideo_dit", lambda sd, cfg, dtype=None: convert(sd, cfg, dtype=jnp.float32))
    model = THM.HyVideoModel
    monkeypatch.setattr(THM, "HyVideoModel", lambda cfg, dtype=None, device="cpu": model(cfg, dtype=torch.float32,
                                                                                        device=device))
    for cls in (JENC.HyVideoTextEncoders, JENC.LlavaImageTextEncoder):
        _f32_from_dir(monkeypatch, cls, jnp.float32)
    for cls in (TENC.HyVideoTextEncoders, TENC.LlavaImageTextEncoder):
        _f32_from_dir(monkeypatch, cls, torch.float32)
    return latents


def _compare(tmp_path, latents, shape):
    ours, fps = read_y4m(str(tmp_path / "port.y4m"))
    ref, _ = read_y4m(str(tmp_path / "jax.y4m"))
    assert fps == 24 and ours.shape == ref.shape == shape
    lat, jlat = latents["port"].float().numpy(), np.asarray(latents["jax"], np.float32)
    err = np.linalg.norm(lat - jlat) / np.linalg.norm(jlat)
    assert np.isfinite(lat).all() and err <= 1e-4, err
    diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 3, diff.max()


def test_t2v_prompt_to_video_matches_jax(dirs, tmp_path, jax_inputs):
    """The prompt through each package's tokenizer.json reader, LLaMA (3
    layers, 1 active: skip 2) in the template and CLIP-L; the DiT with SVG1;
    the VAE; the writer."""
    args = ARGS + ["--model_dir", dirs[0], "--pattern", "SVG"]
    TT2V.main(args + ["--device", "cpu", "--output_file", str(tmp_path / "port.npz")])  # .npz -> .y4m
    JT2V.main(args + ["--output_file", str(tmp_path / "jax.y4m")])
    _compare(tmp_path, jax_inputs, (5, 64, 64, 3))


def test_i2v_image_to_video_matches_jax(dirs, tmp_path, jax_inputs):
    """The 48x80 JPEG resized to 64x64 (cubic), the prompt and the image
    through Llava (4 image tokens spliced), the VAE encode of the image, the
    latent_concat DiT (in_channels 33), dense (the CLI's default)."""
    args = ARGS + ["--model_dir", dirs[1], "--image_path", dirs[2]]
    TI2V.main(args + ["--device", "cpu", "--output_file", str(tmp_path / "port.y4m")])
    JI2V.main(args + ["--output_file", str(tmp_path / "jax.y4m")])
    _compare(tmp_path, jax_inputs, (5, 64, 64, 3))


class _Stop(Exception):
    pass


@pytest.mark.parametrize("cli", ["hyvideo_t2v", "wan_t2v"])
@pytest.mark.parametrize("mode", ["cluster", "tile"])
def test_sap_config_is_the_jax_clis(monkeypatch, tmp_path, cli, mode):
    """--smoke --pattern SAP --zero_step_kmeans_init: the SAPConfig each CLI
    hands its pipeline (captured, no denoising) is the JAX CLI's. The JAX
    HunyuanVideo CLI drops the flag, so zero_step_kmeans_init stays False
    there; the Wan CLIs pass it."""
    got = {}

    def capture(side):
        def generate(self, *a, sap, **kw):
            got[side] = sap
            raise _Stop
        return generate

    jmod, tmod = {"hyvideo_t2v": (JPH, TPH), "wan_t2v": (JPW, TPW)}[cli]
    jcls = jmod.HyVideoPipeline if cli == "hyvideo_t2v" else jmod.WanPipeline
    tcls = tmod.HyVideoPipeline if cli == "hyvideo_t2v" else tmod.WanPipeline
    monkeypatch.setattr(jcls, "generate_latents", capture("jax"))
    monkeypatch.setattr(tcls, "generate_latents", capture("port"))
    argv = ["--smoke", "--pattern", "SAP", "--zero_step_kmeans_init", "--sap_block_mode", mode, "--num_frames", "5",
            "--output_file", str(tmp_path / "x.npz")]
    jcli, tcli = {"hyvideo_t2v": (JT2V, TT2V), "wan_t2v": (JWAN, TWAN)}[cli]
    with pytest.raises(_Stop):
        jcli.main(argv)
    with pytest.raises(_Stop):
        tcli.main(argv + ["--device", "cpu"])
    assert dataclasses.asdict(got["port"]) == dataclasses.asdict(got["jax"])
    assert got["port"].zero_step_kmeans_init == (cli == "wan_t2v")


def _script_args(parser, path, module):
    text = open(os.path.join(chip_smoke.ROOT, path)).read().replace("\\\n", " ")
    cmd = re.search(rf"sparse_videogen_tpu\.cli\.{module} \$MODEL_ARG(.*?)\n", text, re.S).group(1)
    cmd = re.sub(r'"\$\{\w+:-([^}]*)\}"', lambda m: shlex.quote(m.group(1)), cmd)
    return parser.parse_args(shlex.split(cmd))


def test_hyvideo_sap_preset_is_the_script_through_the_jax_cli():
    """presets["hyvideo-720p-sap"] is what scripts/hyvideo/hyvideo_t2v_720p_sap.sh
    runs through the JAX CLI: its --zero_step_kmeans_init dropped."""
    from sparse_videogen_tpu_torch.cli._common import sap_config
    from sparse_videogen_tpu_torch.presets import HY_PRESETS

    args = _script_args(TT2V.build_parser(), "scripts/hyvideo/hyvideo_t2v_720p_sap.sh", "hyvideo_t2v")
    assert args.zero_step_kmeans_init and args.pattern == "SAP"
    preset = HY_PRESETS["hyvideo-720p-sap"]
    assert preset.sap == sap_config(args, pass_zero_step=False)
    assert (preset.first_layers_fp, preset.first_times_fp, preset.flow_shift) == (
        args.first_layers_fp, args.first_times_fp, args.flow_shift)


@pytest.mark.parametrize("run", ["svg", "dense"])
def test_i2v_presets_are_the_cli_defaults(run):
    """presets["hyvideo-i2v-720p-<run>"]: the I2V CLI's defaults (--pattern
    sparse for svg), at HYVIDEO_T2's widths with in_channels 33."""
    from sparse_videogen_tpu_torch.models.hyvideo.model import HYVIDEO_T2
    from sparse_videogen_tpu_torch.presets import HY_PRESETS

    args = TI2V.build_parser().parse_args(["--pattern", "sparse" if run == "svg" else "dense"])
    p = HY_PRESETS[f"hyvideo-i2v-720p-{run}"]
    kw = p.generate_kwargs()
    assert (p.height, p.width, p.num_frames, p.flow_shift, p.first_layers_fp, p.first_times_fp) == (
        args.height, args.width, args.num_frames, args.flow_shift, args.first_layers_fp, args.first_times_fp)
    assert kw["embedded_guidance_scale"] == args.embedded_guidance_scale == 1.0
    assert p.pattern == ("SVG" if args.pattern == "sparse" else "dense")
    assert (kw["svg"].sparsity, kw["svg"].num_sampled_rows) == (args.sparsity, args.num_sampled_rows)
    assert p.model == dataclasses.replace(HYVIDEO_T2, in_channels=33)


def test_i2v_parser_matches_jax():
    """The JAX I2V CLI's flags by name, default and choices, plus --device."""
    spec = lambda p: {a.dest: (sorted(a.option_strings), a.default, a.choices) for a in p._actions if a.dest != "help"}
    ours, ref = spec(TI2V.build_parser()), spec(JI2V.build_parser())
    assert set(ours) - set(ref) == {"device"} and ours.pop("device")[1] == "cuda"
    assert ours == ref


@pytest.mark.parametrize("argv,exc,match", [
    (["--smoke", "--device", "cuda:99"], RuntimeError, None),
    (["--smoke", "--device", "cpu", "--dit_fsdp", "--ring_degree", "2"], RuntimeError, "torchrun"),
    (["--device", "cpu", "--model_dir", "I2V"], ValueError, "--image_path"),
    (["--device", "cpu", "--model_dir", "T2V", "--image_path", "IMG"], ValueError, "in_channels 33"),
], ids=["no_card_no_fallback", "parallel", "no_image", "t2v_transformer"])
def test_i2v_refuses(dirs, tmp_path, argv, exc, match):
    """No fallback to the CPU; FSDP over a ring of ranks outside torchrun
    raises naming torchrun (the ring, Ulysses and FSDP run under torchrun);
    an I2V run needs an image and a latent_concat transformer."""
    if "cuda:99" in argv and torch.cuda.is_available():
        pytest.skip("this host has a card: nothing to refuse")
    sub = {"T2V": dirs[0], "I2V": dirs[1], "IMG": dirs[2]}
    with pytest.raises(exc, match=match):
        TI2V.main(["--output_file", str(tmp_path / "x.npz")] + [sub.get(a, a) for a in argv])


@pytest.mark.parametrize("cli", [TT2V, TI2V])
def test_smoke_to_video(tmp_path, cli):
    """--smoke with a video name decodes through the tiny random VAE."""
    cli.main(["--smoke", "--device", "cpu", "--num_inference_steps", "2", "--output_file", str(tmp_path / "v.y4m")])
    frames, fps = read_y4m(str(tmp_path / "v.y4m"))
    assert frames.shape == (9, 96, 128, 3) and fps == 24 and frames.std() > 0
