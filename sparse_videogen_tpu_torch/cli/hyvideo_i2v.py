"""HunyuanVideo I2V generation CLI (counterpart of
sparse_videogen_tpu/cli/hyvideo_i2v.py).

The flags are the JAX CLI's, by name and default, plus `--device` (default
cuda; never falls back to the CPU). The community HunyuanVideo-I2V
checkpoint conditions by latent_concat (in_channels 33 = 16 noise + 16
first-frame VAE latents + 1 mask), with FlowMatch Euler at shift 7.0 and
embedded guidance 1.0; `--pattern sparse` is SVG1, `dense` dense.

With `--model_dir` (or a local dir as `--model_id`): the image
(`--image_path`: a baseline JPEG or a PNG through io/image.py, resized to
--height x --width with jax.image.resize's cubic rule,
models/common/resize.py; or a .npy of (1, 16, 1, h, w) VAE latents); the
prompt through Llava with the image spliced in where text_encoder/'s
config.json has a vision_config (io/encoders.LlavaImageTextEncoder at its
defaults), else through the LLaMA template and CLIP-L
(io/encoders.HyVideoTextEncoders); the encoders freed; the VAE from vae/
encodes the image (its mean latents); the I2V DiT from transformer/ last;
the denoise loop; the VAE decode (`--vae_tiling`) and the writer (`.y4m`,
or `.mp4` through the port's own JPEG encoder, no PIL; an `.npz` name
becomes `.y4m`). `--smoke`
(or no checkpoint) takes the JAX CLI's random-weight path: a tiny I2V
HunyuanVideo, random text states and image latents, latents to an `.npz`
or, with another name, decoded by a tiny random VAE. `--ulysses_degree M`
(both patterns head-sharded) and `--ring_degree N` (dense only) run under
torchrun, as cli/hyvideo_t2v.py does; rank 0 writes. `--dit_fsdp` shards
the DiT's weights over every torchrun rank (FSDP, parallel/sharding.py), as
any grid of more than one rank does.

Usage:
  python -m sparse_videogen_tpu_torch.cli.hyvideo_i2v --model_dir DIR --image_path examples/1/image.jpg \\
      --prompt "..." --output_file out.y4m
  python -m sparse_videogen_tpu_torch.cli.hyvideo_i2v --smoke --pattern sparse --device cuda --output_file out.npz
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from sparse_videogen_tpu_torch.cli._common import (add_device, add_model_id, add_vae_tiling_flags, prints_time_log,
                                                   resolve_device, resolve_model_dir)
from sparse_videogen_tpu_torch.cli._parallel import (add_parallel_flags, close_mesh, make_cli_mesh,
                                                     shard_cli_model)
from sparse_videogen_tpu_torch.utils.logging import logger
from sparse_videogen_tpu_torch.utils.seed import seed_everything
from sparse_videogen_tpu_torch.cli.hyvideo_t2v import (SMOKE_CFG, SMOKE_PROMPT_LENGTH, free_cuda, load_dit,
                                                       load_vae_decoder, skip_existing, smoke_vae_decoder,
                                                       write_output)



def build_parser():
    p = argparse.ArgumentParser("hyvideo_i2v")
    p.add_argument("--prompt", type=str, default="A cat walks on the grass, realistic")
    p.add_argument("--negative_prompt", type=str, default=None,
                   help="accepted for parity; embedded guidance runs no uncond pass, so it is unused")
    p.add_argument("--resolution", type=str, default=None, choices=["480p", "720p"],
                   help="accepted for parity (output naming); --height/--width set the size")
    p.add_argument("--logging_file", type=str, default=None)
    p.add_argument("--image_path", type=str, default=None,
                   help="conditioning image (baseline JPEG or PNG); .npy = VAE latents (1, 16, 1, h, w)")
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--prompt_source", type=str, default="prompt", choices=["prompt", "I2V_VBench", "I2V_Wan_Web"])
    p.add_argument("--prompt_idx", type=int, default=0)
    p.add_argument("--model_dir", type=str, default=None)
    add_model_id(p, "hunyuanvideo-community/HunyuanVideo-I2V")
    add_vae_tiling_flags(p)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--num_frames", type=int, default=129)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--embedded_guidance_scale", type=float, default=1.0)
    p.add_argument("--flow_shift", type=float, default=7.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output_file", type=str, default="output_hy_i2v.npz")
    p.add_argument("--skip_existing", action="store_true")
    p.add_argument("--pattern", type=str, default="dense", choices=["dense", "sparse"])
    p.add_argument("--first_layers_fp", type=float, default=0.025)
    p.add_argument("--first_times_fp", type=float, default=0.15)
    p.add_argument("--num_sampled_rows", type=int, default=64)
    p.add_argument("--sparsity", type=float, default=0.25)
    p.add_argument("--smoke", action="store_true", help="tiny random-weight run (no checkpoints needed)")
    add_parallel_flags(p)
    return add_device(p)


def is_llava_dir(model_dir: str) -> bool:
    """text_encoder/config.json has a vision_config: a Llava checkpoint."""
    cj = os.path.join(model_dir, "text_encoder", "config.json")
    if not os.path.isfile(cj):
        return False
    with open(cj) as f:
        return "vision_config" in json.load(f)


def _load_checkpoint(args, device):
    """--model_dir: the image, the prompt (Llava with the image, or the
    text-only encoders), the VAE encode of the image, the I2V DiT last.
    Returns (model, text, mask, pooled, image latents, vae_decode)."""
    import torch

    from sparse_videogen_tpu_torch.io.checkpoint import dataclass_from_json
    from sparse_videogen_tpu_torch.io.encoders import HyVideoTextEncoders, LlavaImageTextEncoder
    from sparse_videogen_tpu_torch.io.image import load_image
    from sparse_videogen_tpu_torch.models.common.resize import resize_cubic
    from sparse_videogen_tpu_torch.models.hyvideo.model import HyVideoConfig

    cfg = dataclass_from_json(os.path.join(args.model_dir, "transformer"), HyVideoConfig)
    if cfg is None or cfg.in_channels != 2 * cfg.out_channels + 1:
        raise ValueError(f"{args.model_dir}/transformer: expected a HunyuanVideo-I2V latent_concat transformer "
                         "(a config.json with in_channels 33)")
    if not args.image_path:
        raise ValueError("--image_path is required for I2V with --model_dir")
    img_px = None
    if not args.image_path.endswith(".npy"):
        img_px = resize_cubic(load_image(args.image_path).to(device), args.height, args.width)

    if is_llava_dir(args.model_dir) and img_px is not None:
        logger.info("encoding the prompt and the image with Llava")
        enc = LlavaImageTextEncoder.from_dir(args.model_dir, text_len=cfg.text_len, device=device)
        text, mask, pooled = enc([args.prompt], img_px)
    else:
        logger.info("encoding the prompt with the LLaMA template and CLIP-L")
        enc = HyVideoTextEncoders.from_dir(args.model_dir, text_len=cfg.text_len, device=device)
        text, mask, pooled = enc([args.prompt])
    del enc
    free_cuda(device)

    vae, vae_decode = load_vae_decoder(args, args.model_dir, device)
    if vae is None:
        raise ValueError(f"{args.model_dir}/vae: I2V needs the VAE")
    if img_px is None:
        img_lat = torch.as_tensor(np.load(args.image_path), dtype=torch.float32, device=device)
    else:
        img_lat = vae.encode(img_px[:, :, None])
    free_cuda(device)
    return load_dit(args.model_dir, device, cfg), text, mask, pooled, img_lat, vae_decode


@prints_time_log
def main(argv=None):
    args = build_parser().parse_args(argv)
    seed_everything(args.seed)
    if args.skip_existing and skip_existing(args):
        return
    import torch

    from sparse_videogen_tpu_torch.config import SVGConfig
    from sparse_videogen_tpu_torch.models.hyvideo.model import HyVideoConfig, HyVideoModel
    from sparse_videogen_tpu_torch.pipelines import HyVideoPipeline

    mesh, device = make_cli_mesh(args, resolve_device(args.device))
    if args.prompt_source != "prompt":
        from sparse_videogen_tpu_torch.utils.dataloader import load_prompt_or_image

        args.prompt, args.image_path = load_prompt_or_image(args.prompt_source, args.prompt_idx, args.prompt,
                                                            args.image_path)
    vae_decode = None
    args.model_dir = resolve_model_dir(args, logger)
    if args.smoke or args.model_dir is None:
        logger.warning("no --model_dir: running smoke generation with random weights")
        cfg = HyVideoConfig(**dict(SMOKE_CFG, in_channels=33))
        model = HyVideoModel(cfg, dtype=torch.bfloat16, device=device).init_random(
            torch.Generator(device=device).manual_seed(args.seed))
        rng = np.random.default_rng(args.seed)
        text = torch.as_tensor(rng.standard_normal((1, cfg.text_len, cfg.text_states_dim)), dtype=torch.float32)
        mask = torch.ones(1, cfg.text_len, dtype=torch.int32)
        mask[0, SMOKE_PROMPT_LENGTH:] = 0
        pooled = torch.as_tensor(rng.standard_normal((1, cfg.text_states_dim_2)), dtype=torch.float32)
        args.height, args.width = min(args.height, 96), min(args.width, 128)
        args.num_frames = min(args.num_frames, 9)
        args.num_inference_steps = min(args.num_inference_steps, 3)
        img_lat = torch.as_tensor(rng.standard_normal((1, 16, 1, args.height // 8, args.width // 8)) * 0.1,
                                  dtype=torch.float32)
        if not args.output_file.endswith(".npz"):
            vae_decode = smoke_vae_decoder(args, device)
    else:
        model, text, mask, pooled, img_lat, vae_decode = _load_checkpoint(args, device)

    model = shard_cli_model(mesh, model)
    lat = HyVideoPipeline(model).generate_latents(
        text, mask, pooled, prompt_length=int(mask[0].sum()),
        height=args.height, width=args.width, num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps, embedded_guidance_scale=args.embedded_guidance_scale,
        flow_shift=args.flow_shift, pattern="SVG" if args.pattern == "sparse" else "dense",
        first_layers_fp=args.first_layers_fp, first_times_fp=args.first_times_fp,
        svg=SVGConfig(num_sampled_rows=args.num_sampled_rows, sparsity=args.sparsity, profile_multiplier=1.5),
        seed=args.seed, image_latents=img_lat, mesh=mesh,
    )
    if close_mesh(mesh) == 0:
        write_output(args, lat, vae_decode)


if __name__ == "__main__":
    main()
