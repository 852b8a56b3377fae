"""CogVideoX 1.5 I2V generation CLI (counterpart of
sparse_videogen_tpu/cli/cog_i2v.py).

The flags are the JAX CLI's, by name and default, plus `--device` (default
cuda; never falls back to the CPU). `--pattern` also takes SAP, only to
raise NotImplementedError: the reference runs CogVideoX with SVG1 or dense.

What runs today is the random-weight path that the JAX CLI takes without
`--model_dir` (`--smoke`, or no checkpoint): the JAX CLI's tiny CogVideoX
(2 layers, hidden 128, 2 heads of 64, 16 text tokens; ofs embedding for
--version v1.5, dynamic CFG for v1) at a reduced size (at most 96x128x17,
3 steps), random text states and image latents from --seed (or the image
latents of `--image_path x.npy`, (1, 16, 1, height/8, width/8) at the
reduced size), denoised with dense or SVG1 attention, latents written to an
`.npz`. Checkpoints (`--model_dir`), the T5 text encoder, a pixel image
(the CogVideoX VAE encode), a video output (the VAE decode), the VAE tiling
flags and parallelism raise NotImplementedError (ROADMAP.md).

Usage:
  python -m sparse_videogen_tpu_torch.cli.cog_i2v --smoke --pattern SVG \\
      --device cuda --output_path out.npz
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from sparse_videogen_tpu_torch.cli._common import add_device, add_model_id, add_vae_tiling_flags, resolve_device

logger = logging.getLogger("sparse_videogen_tpu_torch")

# the JAX CLI's --smoke model (ofs_embed follows --version)
SMOKE_CFG = dict(num_layers=2, hidden_size=128, heads_num=2, head_dim=64, text_len=16, text_dim=32, in_channels=32)
VAE_TILING_DEFAULTS = dict(vae_tiling="auto", vae_tile=32, vae_tile_overlap=8, vae_stream_chunk=0)


def build_parser():
    p = argparse.ArgumentParser("cog_i2v")
    p.add_argument("--version", type=str, default="v1.5", choices=["v1", "v1.5"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image_path", type=str, default=None,
                   help="conditioning image; .npy = precomputed VAE latents (1,16,1,h,w)")
    p.add_argument("--prompt", type=str, default="A cat walks on the grass, realistic")
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--pattern", type=str, default="SVG", choices=["SVG", "dense", "SAP"])
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
    p.add_argument("--ulysses_degree", type=int, default=1)
    p.add_argument("--ring_degree", type=int, default=1)
    p.add_argument("--dit_fsdp", action="store_true")
    return add_device(p)


def _unported(args) -> str | None:
    if args.model_dir or (args.model_id and os.path.isdir(args.model_id)):
        return "--model_dir (checkpoint conversion, the T5 text encoder, the CogVideoX VAE)"
    if args.pattern == "SAP":
        return "--pattern SAP on CogVideoX (a text-first SAP layout; the reference runs it with SVG or dense only)"
    if args.image_path is not None and not args.image_path.endswith(".npy"):
        return "a pixel --image_path (the CogVideoX VAE encode); pass VAE latents as .npy"
    if not args.output_path.endswith(".npz"):
        return "video output (the CogVideoX VAE decode); write latents to a .npz"
    if any(getattr(args, k) != v for k, v in VAE_TILING_DEFAULTS.items()):
        return "the VAE tiling flags (the CogVideoX VAE decode)"
    if args.ulysses_degree * args.ring_degree > 1 or args.dit_fsdp:
        return "multi-device parallelism"
    return None


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    if args.skip_existing and os.path.exists(args.output_path):
        print(f"output {args.output_path} exists; skipping generation")
        return
    missing = _unported(args)
    if missing is not None:
        raise NotImplementedError(f"{missing} is not ported to the torch package yet (ROADMAP.md)")

    import torch

    from sparse_videogen_tpu_torch.config import SVGConfig
    from sparse_videogen_tpu_torch.models.cog.model import CogConfig, CogModel
    from sparse_videogen_tpu_torch.pipelines import CogPipeline

    device = resolve_device(args.device)
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
    if args.image_path is None:
        img = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
    else:
        img = torch.as_tensor(np.load(args.image_path), dtype=torch.float32)
        if tuple(img.shape) != shape:
            raise ValueError(f"--image_path latents must be {shape} at this run's size, got {tuple(img.shape)}")

    lat = CogPipeline(model).generate_latents(
        ctx, ctx_null, img, height=args.height, width=args.width, num_frames=args.num_frames,
        num_inference_steps=args.num_step, guidance_scale=args.guidance_scale,
        use_dynamic_cfg=args.version == "v1", pattern=args.pattern,
        first_layers_fp=args.first_layers_fp, first_times_fp=args.first_times_fp,
        svg=SVGConfig(num_sampled_rows=args.num_sampled_rows, sparsity=args.sparsity), seed=args.seed,
    )
    np.savez(args.output_path, latents=lat.cpu().numpy())
    logger.info(f"saved latents {tuple(lat.shape)} -> {args.output_path}")


if __name__ == "__main__":
    main()
