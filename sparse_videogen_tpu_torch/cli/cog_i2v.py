"""CogVideoX 1.5 I2V generation CLI (counterpart of
sparse_videogen_tpu/cli/cog_i2v.py).

The flags are the JAX CLI's, by name, default and choices, plus `--device`
(default cuda; never falls back to the CPU). `--pattern` is SVG or dense, as
in the JAX CLI (the reference runs CogVideoX with no other).

With `--model_dir` (or a local dir as `--model_id`) it runs from an image
and a prompt to a video:
  - the prompt and `--negative_prompt` through T5 v1.1 XXL (text_encoder/:
    HF's safetensors, config.json in HF's or the package's names; the
    tokenizer's spiece.model or tokenizer.json in model_dir or a subdir) at
    the DiT's 226 tokens, the states unmasked and cast to bf16, as the JAX
    CLI hands them over; the encoder is freed;
  - the CogVideoX VAE from vae/ (diffusers' names; config.json read as the
    JAX package reads it);
  - the image: a JPEG or PNG read by io/image.py (no PIL), resized to
    --height x --width with jax.image.resize's bilinear rule
    (models/common/resize.py), encoded (the mean) and scaled
    (`scale_latents`: v1.5 divides by 0.7); an `.npy` holds the latents
    (1, 16, 1, height/8, width/8) instead;
  - the DiT from transformer/ (diffusers' names, bf16), loaded last;
  - the denoise loop (pipelines/cog.py) with dense or SVG1 attention;
  - the VAE decode (`--vae_tiling`: auto tiles a latent frame above 64x64;
    the CogVideoX VAE has no streamed decode, so `--vae_stream_chunk`
    warns and decodes the whole sequence) and the writer at 8 fps: `.y4m`,
    or `.mp4` where PIL is installed; an `.npz` name becomes `.y4m`. Without
    vae/ the latents go to the `.npz` (and a pixel image raises).
`--smoke` (or no checkpoint) takes the JAX CLI's random-weight path: its
tiny CogVideoX (2 layers, hidden 128, 2 heads of 64, 16 text tokens; the ofs
embedding for --version v1.5, dynamic CFG for v1) at most 96x128x17 and 3
steps, random text states and image latents from --seed (or the latents of
an `.npy` --image_path; a pixel image is ignored, as the JAX smoke ignores
it), latents to an `.npz` or, with another name, decoded by the JAX CLI's
tiny random VAE to a video. `--ulysses_degree M` (both patterns
head-sharded) and `--ring_degree N` (dense only) run under torchrun, one
process a rank; rank 0 writes. `--dit_fsdp` raises NotImplementedError
(ROADMAP.md).

Usage:
  python -m sparse_videogen_tpu_torch.cli.cog_i2v --model_dir DIR --image_path examples/1/image.jpg \\
      --prompt "..." --output_path out.y4m
  python -m sparse_videogen_tpu_torch.cli.cog_i2v --smoke --pattern SVG --device cuda --output_path out.npz
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from sparse_videogen_tpu_torch.cli._common import (add_device, add_model_id, add_vae_tiling_flags, encode_t5_prompts,
                                                   make_vae_decoder, resolve_device, resolve_model_dir, skip_existing,
                                                   video_name)
from sparse_videogen_tpu_torch.cli._parallel import add_parallel_flags, close_mesh, make_cli_mesh

logger = logging.getLogger("sparse_videogen_tpu_torch")

# the JAX CLI's --smoke model (ofs_embed follows --version) and its tiny VAE (seed 1)
SMOKE_CFG = dict(num_layers=2, hidden_size=128, heads_num=2, head_dim=64, text_len=16, text_dim=32, in_channels=32)
SMOKE_VAE_CFG = dict(block_out_channels=(16, 16, 16, 16), layers_per_block=1, norm_num_groups=4)
FPS = 8  # the reference's sample_image fps


def build_parser():
    p = argparse.ArgumentParser("cog_i2v")
    p.add_argument("--version", type=str, default="v1.5", choices=["v1", "v1.5"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image_path", type=str, default=None,
                   help="conditioning image; .npy = precomputed VAE latents (1,16,1,h,w)")
    p.add_argument("--prompt", type=str, default="A cat walks on the grass, realistic")
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--pattern", type=str, default="SVG", choices=["SVG", "dense"])
    p.add_argument("--num_step", type=int, default=50)
    p.add_argument("--first_layers_fp", type=float, default=0.025)
    p.add_argument("--first_times_fp", type=float, default=0.2)
    p.add_argument("--num_sampled_rows", type=int, default=32)
    p.add_argument("--sparsity", type=float, default=0.25)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--width", type=int, default=1360)
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--guidance_scale", type=float, default=6.0)
    p.add_argument("--model_dir", type=str, default=None)
    add_model_id(p, "THUDM/CogVideoX1.5-5B-I2V")
    add_vae_tiling_flags(p)
    p.add_argument("--output_path", type=str, default="output_cog.npz")
    p.add_argument("--skip_existing", action="store_true",
                   help="skip generation when the output file exists (batch resume)")
    p.add_argument("--smoke", action="store_true", help="tiny random-weight run (no checkpoints needed)")
    add_parallel_flags(p)
    return add_device(p)


def load_vae(model_dir: str, device):
    """vae/ -> a CogVAE, or None without the dir."""
    from sparse_videogen_tpu_torch.io.checkpoint import cog_vae_config_from_json, convert_cog_vae
    from sparse_videogen_tpu_torch.io.safetensors import load_dir
    from sparse_videogen_tpu_torch.models.cog.vae import CogVAE, CogVAEConfig

    vae_dir = os.path.join(model_dir, "vae")
    if not os.path.isdir(vae_dir):
        logger.warning(f"no {vae_dir}: saving latents instead of video")
        return None
    cfg = cog_vae_config_from_json(vae_dir) or CogVAEConfig()
    vae = CogVAE(cfg, device=device)
    vae.load_state_dict(convert_cog_vae(load_dir(vae_dir), cfg))
    return vae


def image_latents(path: str, vae, height: int, width: int, device):
    """--image_path -> the DiT's image latents (1, 16, 1, height/8, width/8):
    an .npy as it is; a JPEG or PNG resized bilinearly to height x width,
    encoded (the mean) and scaled."""
    import torch

    if path.endswith(".npy"):
        return torch.as_tensor(np.load(path), dtype=torch.float32)
    if vae is None:
        raise ValueError("pixel-image conditioning needs the CogVideoX VAE under <model_dir>/vae; otherwise pass "
                         "precomputed latents as .npy (1, 16, 1, H/8, W/8)")
    from sparse_videogen_tpu_torch.io.image import load_image
    from sparse_videogen_tpu_torch.models.cog.vae import scale_latents
    from sparse_videogen_tpu_torch.models.common.resize import resize_bilinear

    img = resize_bilinear(load_image(path).to(device), height, width)
    return scale_latents(vae.cfg, vae.encode(img[:, :, None]))


def load_dit(model_dir: str, device):
    """transformer/ -> a bf16 CogModel (cfg from its config.json, else
    COG_1_5_5B_I2V)."""
    import torch

    from sparse_videogen_tpu_torch.io.checkpoint import cog_config_from_json, convert_cog_dit
    from sparse_videogen_tpu_torch.io.safetensors import load_dir
    from sparse_videogen_tpu_torch.models.cog.model import COG_1_5_5B_I2V, CogModel

    tdir = os.path.join(model_dir, "transformer")
    cfg = cog_config_from_json(tdir) or COG_1_5_5B_I2V
    model = CogModel(cfg, dtype=torch.bfloat16, device=device)
    model.load_state_dict(convert_cog_dit(load_dir(tdir), cfg))
    return model


def _from_checkpoint(args, device):
    """--model_dir: the prompts through T5, the VAE and the image latents,
    the DiT last. Returns (model, ctx, ctx_null, image latents, vae)."""
    from sparse_videogen_tpu_torch.io.checkpoint import cog_config_from_json
    from sparse_videogen_tpu_torch.models.cog.model import COG_1_5_5B_I2V
    from sparse_videogen_tpu_torch.models.common.t5 import T5_V1_1_XXL

    if args.image_path is None:
        raise ValueError("--image_path is required for I2V (a JPEG, a PNG or latents as .npy)")
    text_len = (cog_config_from_json(os.path.join(args.model_dir, "transformer")) or COG_1_5_5B_I2V).text_len
    logger.info("encoding the prompts with T5")
    ctx, ctx_null = encode_t5_prompts(args.model_dir, [args.prompt, args.negative_prompt], text_len=text_len,
                                      default_cfg=T5_V1_1_XXL, mask_output=False, device=device)
    vae = load_vae(args.model_dir, device)
    img = image_latents(args.image_path, vae, args.height, args.width, device)
    return load_dit(args.model_dir, device), ctx, ctx_null, img, vae


def _smoke(args, device):
    """The JAX CLI's random-weight path at its reduced size."""
    import torch

    from sparse_videogen_tpu_torch.models.cog.model import CogConfig, CogModel
    from sparse_videogen_tpu_torch.models.cog.vae import CogVAE, CogVAEConfig

    logger.warning("no --model_dir: running smoke generation with random weights")
    cfg = CogConfig(**SMOKE_CFG, ofs_embed=args.version == "v1.5")
    model = CogModel(cfg, dtype=torch.bfloat16, device=device).init_random(
        torch.Generator(device=device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    ctx = torch.as_tensor(rng.standard_normal((1, cfg.text_len, cfg.text_dim)), dtype=torch.float32)
    ctx_null = torch.zeros_like(ctx)
    args.height, args.width = min(args.height, 96), min(args.width, 128)
    args.num_frames = min(args.num_frames, 17)
    args.num_step = min(args.num_step, 3)
    shape = (1, cfg.out_channels, 1, args.height // 8, args.width // 8)
    if args.image_path is not None and args.image_path.endswith(".npy"):
        img = torch.as_tensor(np.load(args.image_path), dtype=torch.float32)
        if tuple(img.shape) != shape:
            raise ValueError(f"--image_path latents must be {shape} at this run's size, got {tuple(img.shape)}")
    else:
        img = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
    vae = None
    if not args.output_path.endswith(".npz"):
        vae = CogVAE(CogVAEConfig(**SMOKE_VAE_CFG), device=device).init_random(
            torch.Generator(device=device).manual_seed(1))
    return model, ctx, ctx_null, img, vae


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    if args.skip_existing and skip_existing(args.output_path):
        return
    from sparse_videogen_tpu_torch.config import SVGConfig
    from sparse_videogen_tpu_torch.pipelines import CogPipeline
    from sparse_videogen_tpu_torch.pipelines.wan import export_video

    mesh, device = make_cli_mesh(args, resolve_device(args.device))
    args.model_dir = resolve_model_dir(args, logger)
    if args.smoke or args.model_dir is None:
        model, ctx, ctx_null, img, vae = _smoke(args, device)
    else:
        model, ctx, ctx_null, img, vae = _from_checkpoint(args, device)

    lat = CogPipeline(model).generate_latents(
        ctx, ctx_null, img, height=args.height, width=args.width, num_frames=args.num_frames,
        num_inference_steps=args.num_step, guidance_scale=args.guidance_scale,
        use_dynamic_cfg=args.version == "v1", pattern=args.pattern,
        first_layers_fp=args.first_layers_fp, first_times_fp=args.first_times_fp,
        svg=SVGConfig(num_sampled_rows=args.num_sampled_rows, sparsity=args.sparsity), seed=args.seed, mesh=mesh,
    )
    if close_mesh(mesh) != 0:
        return
    if vae is not None:
        video = make_vae_decoder(args, vae, logger)(lat)
        out = video_name(args.output_path)
        export_video(video, out, fps=FPS)
        logger.info(f"saved video {tuple(video.shape)} -> {out}")
    else:
        np.savez(args.output_path, latents=lat.cpu().numpy())
        logger.info(f"saved latents {tuple(lat.shape)} -> {args.output_path}")


if __name__ == "__main__":
    main()
