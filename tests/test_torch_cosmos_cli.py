"""Cosmos Text2World through the port's CLI and the JAX package's, from a
prompt to a video (cli/cosmos_t2v.py --model_dir), on the synthetic
checkpoint of chip_smoke.write_tiny_cosmos_checkpoint (T5 v1.0 in HF's
weight names, its config.json in the package's names, which the JAX CLI
reads; the DiT in diffusers' names; the tokenizer's VAE; a spiece.model),
at 128x128x17 and 2 EDM steps, for dense, SVG1 and SAP in both block modes.
The port starts from the JAX package's initial noise, SVG1 rows and
k-means draws (handed to CosmosPipeline._denoise), so both see the same
inputs end to end: tokenizer, T5 (masked), DiT, EDM Euler, tiled VAE decode,
writer. The DiTs and T5 run in f32 (patched in where the CLIs build them):
latents within rel L2 1e-4, the .y4m frames within 4 uint8 levels. Also the
parser against JAX's (names, defaults, choices) and the smoke to a video."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sparse_videogen_tpu.io.checkpoint as JCK
import sparse_videogen_tpu_torch.models.cosmos.model as TCM
from sparse_videogen_tpu.cli import cosmos_t2v as JCLI
from sparse_videogen_tpu.io import native as JNATIVE
from sparse_videogen_tpu.pipelines import cosmos as JPC
from sparse_videogen_tpu_torch.cli import cosmos_t2v as TCLI
from sparse_videogen_tpu_torch.io import encoders as TENC
from sparse_videogen_tpu_torch.io.native import read_y4m
from sparse_videogen_tpu_torch.pipelines import cosmos as TPC
from sparse_videogen_tpu_torch.schedulers import EDMEuler

PROMPT = "a cat walks on the grass"
ARGS = ["--prompt", PROMPT, "--height", "128", "--width", "128", "--num_frames", "17", "--num_inference_steps", "2",
        "--num_q_centroids", "4", "--num_k_centroids", "8", "--kmeans_iter_init", "8", "--vae_tiling", "on",
        "--vae_tile", "8", "--vae_tile_overlap", "2"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("cosmos_cli")
    chip_smoke.write_tiny_cosmos_checkpoint(str(d), PROMPT, t5_names="package")
    return str(d)


@pytest.fixture
def jax_inputs(monkeypatch):
    """The port's generate_latents runs _denoise from the JAX package's
    initial noise (times the first sigma), SVG1 rows and k-means draws of
    the 2 x heads (fold_in(fold_in(key, step), layer)); both sides' latents
    are kept; DiTs and T5 in f32."""
    latents = {}

    def port_generate(self, ctx, ctx_null, *, seed, height, width, num_frames, num_inference_steps, svg, sap,
                      fps=None, **kw):
        key, nkey = jax.random.split(jax.random.PRNGKey(seed))
        cfg = self.model.cfg
        lay = TPC.cosmos_layout(cfg, height, width, num_frames)
        lat0 = np.array(jax.random.normal(nkey, (1, 16, lay.num_frames, height // 8, width // 8), jnp.float32))
        lat0 = lat0 * EDMEuler(num_inference_steps).init_noise_sigma
        n, top = min(svg.num_sampled_rows, lay.seq_len), min(svg.sample_mse_max_row, lay.seq_len)
        keys = [jax.random.fold_in(key, i) for i in range(num_inference_steps)]
        rows = [torch.as_tensor(np.stack([np.asarray(jax.random.randint(jax.random.fold_in(k, li), (n,), 0, top))
                                          for li in range(cfg.num_layers)])) for k in keys]

        def draws(k):
            rq, rk = jax.random.split(k)
            bh = 2 * cfg.num_attention_heads
            return (torch.as_tensor(np.array(jax.random.randint(rq, (bh, sap.num_q_centroids), 0, lay.seq_len))),
                    torch.as_tensor(np.array(jax.random.randint(rk, (bh, sap.num_k_centroids), 0, lay.seq_len))))

        init = [{li: draws(jax.random.fold_in(k, li)) for li in range(cfg.num_layers)} for k in keys]
        latents["port"] = self._denoise(ctx, ctx_null, torch.from_numpy(lat0.astype(np.float32)), height=height,
                                        width=width, num_frames=num_frames, num_inference_steps=num_inference_steps,
                                        svg=svg, sap=sap, profile_rows=rows, kmeans_init=init, **kw)
        return latents["port"]

    jax_generate = JPC.CosmosPipeline.generate_latents

    def jax_generate_kept(self, *a, **kw):
        latents["jax"] = jax_generate(self, *a, **kw)
        return latents["jax"]

    monkeypatch.setattr(TPC.CosmosPipeline, "generate_latents", port_generate)
    monkeypatch.setattr(JPC.CosmosPipeline, "generate_latents", jax_generate_kept)
    monkeypatch.setattr(JPC, "CosmosPipeline", functools.partial(JPC.CosmosPipeline, dtype=jnp.float32))
    monkeypatch.setattr(JNATIVE, "_LIB", None)  # JAX's pure-Python .y4m writer, the port's math
    for name in ("convert_cosmos_dit", "convert_t5_hf"):
        convert = getattr(JCK, name)
        monkeypatch.setattr(JCK, name, functools.partial(lambda c, sd, cfg, dtype=None: c(sd, cfg, dtype=jnp.float32),
                                                         convert))
    model = TCM.CosmosModel
    monkeypatch.setattr(TCM, "CosmosModel", lambda cfg, dtype=None, device="cpu": model(cfg, dtype=torch.float32,
                                                                                        device=device))
    from_dir = TENC.T5TextEncoder.from_dir.__func__
    monkeypatch.setattr(TENC.T5TextEncoder, "from_dir",
                        classmethod(lambda c, d, **kw: from_dir(c, d, **dict(kw, dtype=torch.float32))))
    return latents


@pytest.mark.parametrize("pattern", ["dense", "SVG", "SAP", "SAP-tile"])
def test_prompt_to_video_matches_jax(ckpt, tmp_path, jax_inputs, pattern):
    """The CLI's default warm-up fractions (first_times_fp 0.075 dense nothing
    at 2 steps); SAP on the 2 x heads of the CFG batch, tile mode at
    block_q = block_kv = 512; both write a .y4m at --fps 30."""
    pat = ["--pattern", "SAP", "--sap_block_mode", "tile"] if pattern == "SAP-tile" else ["--pattern", pattern]
    args = ARGS + pat + ["--model_dir", ckpt]
    TCLI.main(args + ["--device", "cpu", "--output_file", str(tmp_path / "port.npz")])
    JCLI.main(args + ["--output_file", str(tmp_path / "jax.y4m")])
    ours, fps = read_y4m(str(tmp_path / "port.y4m"))
    ref, _ = read_y4m(str(tmp_path / "jax.y4m"))
    assert fps == 30 and ours.shape == ref.shape == (17, 128, 128, 3)
    lat, jlat = jax_inputs["port"].float().numpy(), np.asarray(jax_inputs["jax"], np.float32)
    err = np.linalg.norm(lat - jlat) / np.linalg.norm(jlat)
    assert np.isfinite(lat).all() and err <= 1e-4, err
    assert np.abs(ours.astype(np.int32) - ref.astype(np.int32)).max() <= 4


def test_parser_matches_jax():
    """The JAX CLI's flags by name, default and choices, plus --device."""
    spec = lambda p: {a.dest: (sorted(a.option_strings), a.default, a.choices) for a in p._actions if a.dest != "help"}
    ours, ref = spec(TCLI.build_parser()), spec(JCLI.build_parser())
    assert set(ours) - set(ref) == {"device"} and ours.pop("device")[1] == "cuda"
    assert ours == ref


def test_presets_are_the_reference_scripts():
    """cosmos-704p-{dense,svg,sap} hold scripts/cosmos/cosmos_t2v_*.sh's
    settings as the JAX CLI parses them."""
    import os
    import re
    import shlex

    from sparse_videogen_tpu_torch.presets import COSMOS_PRESETS

    for run in ("dense", "svg", "sap"):
        path = os.path.join(chip_smoke.ROOT, "scripts", "cosmos", f"cosmos_t2v_{run}.sh")
        text = open(path).read().replace("\\\n", " ")
        cmd = re.search(r"sparse_videogen_tpu\.cli\.cosmos_t2v \$MODEL_ARG(.*?)\n", text, re.S).group(1)
        cmd = re.sub(r'"\$\{\w+:-([^}]*)\}"', lambda m: shlex.quote(m.group(1)), cmd)
        a = JCLI.build_parser().parse_args(shlex.split(cmd))
        p = COSMOS_PRESETS[f"cosmos-704p-{run}"]
        assert (p.height, p.width, p.num_frames, p.pattern) == (a.height, a.width, a.num_frames, a.pattern)
        assert (p.first_layers_fp, p.first_times_fp) == (a.first_layers_fp, a.first_times_fp)
        kw = p.generate_kwargs()
        assert (kw["guidance_scale"], kw["fps"]) == (a.guidance_scale, a.fps) and a.num_inference_steps == 35
        if run == "svg":
            assert (p.svg.sparsity, p.svg.num_sampled_rows) == (a.sparsity, a.num_sampled_rows)
        if run == "sap":
            s = p.sap
            assert (s.num_q_centroids, s.num_k_centroids, s.top_p_kmeans, s.min_kc_ratio, s.kmeans_iter_init,
                    s.kmeans_iter_step) == (a.num_q_centroids, a.num_k_centroids, a.top_p_kmeans, a.min_kc_ratio,
                                            a.kmeans_iter_init, a.kmeans_iter_step)
    assert COSMOS_PRESETS["cosmos-704p-sap-tile"].sap.block_q == COSMOS_PRESETS["cosmos-704p-sap-tile"].sap.block_kv \
        == 512


@pytest.mark.parametrize("argv,exc", [(["--device", "cuda:99"], RuntimeError),
                                      (["--device", "cpu", "--dit_fsdp"], NotImplementedError)],
                         ids=["no_card_no_fallback", "parallel"])
def test_cli_refuses(tmp_path, argv, exc):
    if "cuda:99" in argv and torch.cuda.is_available():
        pytest.skip("this host has a card: nothing to refuse")
    with pytest.raises(exc):
        TCLI.main(["--smoke", "--output_file", str(tmp_path / "x.npz")] + argv)


def test_smoke_to_video_and_prompt_source(tmp_path):
    """--smoke with a video name decodes through the tiny random tokenizer;
    --prompt_source reads the prompt list's line (the reference's
    dataloader)."""
    (tmp_path / "prompts.txt").write_text("first prompt\nsecond prompt\n")
    TCLI.main(["--smoke", "--device", "cpu", "--num_inference_steps", "1", "--prompt_source", "T2V_Hyv_Web", "--prompt",
               str(tmp_path / "prompts.txt"), "--prompt_idx", "1", "--output_file", str(tmp_path / "v.y4m")])
    frames, fps = read_y4m(str(tmp_path / "v.y4m"))
    assert frames.shape == (17, 128, 128, 3) and fps == 30 and frames.std() > 0
