"""Cosmos Text2World generation CLI (counterpart of
sparse_videogen_tpu/cli/cosmos_t2v.py).

The flags are the JAX CLI's, by name, default and choices, plus `--device`
(default cuda; never falls back to the CPU).

With `--model_dir` (or a local dir as `--model_id`) it runs from a prompt
(or `--prompt_source`'s line) to a video:
  - the prompt and `--negative_prompt` through t5-11b's encoder
    (text_encoder/: HF's safetensors, config.json in HF's or the package's
    names, else T5_11B; the tokenizer in model_dir or a subdir) at 512
    tokens, the states zeroed past each prompt's tokens and cast to bf16,
    as the JAX CLI hands them over; the encoder is freed;
  - the CV8x8x8 VAE from vae/ when it exists (the tokenizer's names);
    without it the latents go to the `.npz`;
  - the DiT from transformer/ (diffusers' names, bf16; config.json in the
    package's names, else COSMOS_7B or COSMOS_14B by --model_size), loaded
    last;
  - the EDM Euler loop (pipelines/cosmos.py) with dense, SVG1 or SAP
    attention (`--sap_block_mode tile`: block_q = block_kv = 512, the JAX
    CLI's tile settings); `--logging_file` gets SAP's densities;
  - the VAE decode (`--vae_tiling`; no streamed decode, so
    `--vae_stream_chunk` warns) and the writer at --fps: `.y4m`, or `.mp4`
    (the port's own JPEG encoder, no PIL); an `.npz` name becomes `.y4m`.
`--smoke` (or no checkpoint) takes the JAX CLI's random-weight path: a tiny
Cosmos (2 layers, 2 heads of 64, text 64 wide) at most 128x128x17 and 3
steps, random text states (24 tokens) from --seed, the centroids capped at
8 / 12 and the cold k-means at 8 iterations, latents to an `.npz` or, with
another name, decoded by the JAX CLI's tiny random VAE (seed 1) to a
video. `--ulysses_degree M` (every pattern head-sharded) and
`--ring_degree N` (dense and SAP cluster mode) run under torchrun, one
process a rank; rank 0 writes. `--dit_fsdp` shards the DiT's weights
over every torchrun rank (FSDP, parallel/sharding.py), as any grid of more
than one rank does.

Usage:
  python -m sparse_videogen_tpu_torch.cli.cosmos_t2v --model_dir DIR --prompt "..." --output_file out.y4m
  python -m sparse_videogen_tpu_torch.cli.cosmos_t2v --smoke --pattern SAP --sap_block_mode tile \\
      --device cuda --output_file out.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from sparse_videogen_tpu_torch.cli._common import (add_device, add_model_id, add_vae_tiling_flags, encode_t5_prompts,
                                                   make_vae_decoder, resolve_device, resolve_model_dir, sap_config,
                                                   skip_existing, video_name)
from sparse_videogen_tpu_torch.cli._parallel import (add_parallel_flags, close_mesh, make_cli_mesh,
                                                     shard_cli_model)
from sparse_videogen_tpu_torch.utils.logging import logger
from sparse_videogen_tpu_torch.utils.seed import seed_everything


# the JAX CLI's --smoke model, its text length and its tiny VAE (seed 1)
SMOKE_CFG = dict(num_attention_heads=2, attention_head_dim=64, num_layers=2, text_embed_dim=64, adaln_lora_dim=16,
                 max_size=(8, 16, 16))
SMOKE_TEXT_LEN = 24
SMOKE_VAE_CFG = dict(base_channels=16, channels_mult=(1, 2), num_res_blocks=1)
TEXT_LEN = 512


def build_parser():
    p = argparse.ArgumentParser("cosmos_t2v")
    p.add_argument("--prompt", type=str, default="A cat walks on the grass, realistic")
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--prompt_source", type=str, default="prompt",
                   help='with a non-"prompt" source, --prompt is the prompt-list .txt and --prompt_idx its line')
    p.add_argument("--prompt_idx", type=int, default=0)
    p.add_argument("--logging_file", type=str, default=None, help="JSONL density telemetry for SAP")
    p.add_argument("--model_dir", type=str, default=None)
    add_model_id(p, "nvidia/Cosmos-1.0-Diffusion-14B-Text2World")
    add_vae_tiling_flags(p)
    p.add_argument("--model_size", type=str, default="7B", choices=["7B", "14B"])
    p.add_argument("--height", type=int, default=704)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--num_frames", type=int, default=121)
    p.add_argument("--num_inference_steps", type=int, default=35)
    p.add_argument("--guidance_scale", type=float, default=7.0)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output_file", type=str, default="output_cosmos.npz")
    p.add_argument("--skip_existing", action="store_true",
                   help="skip generation when the output file exists (batch resume)")
    p.add_argument("--pattern", type=str, default="dense", choices=["SVG", "dense", "SAP"])
    p.add_argument("--first_layers_fp", type=float, default=0.025)
    p.add_argument("--first_times_fp", type=float, default=0.075)
    p.add_argument("--num_sampled_rows", type=int, default=64)
    p.add_argument("--sample_mse_max_row", type=int, default=10000)
    p.add_argument("--sparsity", type=float, default=0.25)
    p.add_argument("--num_q_centroids", type=int, default=50)
    p.add_argument("--num_k_centroids", type=int, default=200)
    p.add_argument("--top_p_kmeans", type=float, default=0.9)
    p.add_argument("--min_kc_ratio", type=float, default=0.0)
    p.add_argument("--kmeans_iter_init", type=int, default=50)
    p.add_argument("--kmeans_iter_step", type=int, default=2)
    p.add_argument("--sap_block_mode", type=str, default="cluster", choices=["cluster", "tile"],
                   help="SAP granularity: 'cluster' (variable-size cluster blocks) or 'tile' (fixed 512-token tiles "
                        "of the k-means order)")
    p.add_argument("--smoke", action="store_true", help="tiny random-weight run (no checkpoints needed)")
    add_parallel_flags(p)
    return add_device(p)


def load_vae(model_dir: str, device):
    """vae/ -> a CosmosVAE, or None without the dir."""
    from sparse_videogen_tpu_torch.io.checkpoint import convert_cosmos_vae, dataclass_from_json
    from sparse_videogen_tpu_torch.io.safetensors import load_dir
    from sparse_videogen_tpu_torch.models.cosmos.vae import COSMOS_VAE_CV8x8x8, CosmosVAE, CosmosVAEConfig

    vae_dir = os.path.join(model_dir, "vae")
    if not os.path.isdir(vae_dir):
        logger.warning(f"no {vae_dir}: saving latents instead of video")
        return None
    cfg = dataclass_from_json(vae_dir, CosmosVAEConfig) or COSMOS_VAE_CV8x8x8
    vae = CosmosVAE(cfg, device=device)
    vae.load_state_dict(convert_cosmos_vae(load_dir(vae_dir), cfg))
    return vae


def load_dit(model_dir: str, model_size: str, device):
    """transformer/ -> a bf16 CosmosModel."""
    import torch

    from sparse_videogen_tpu_torch.io.checkpoint import convert_cosmos_dit, dataclass_from_json
    from sparse_videogen_tpu_torch.io.safetensors import load_dir
    from sparse_videogen_tpu_torch.models.cosmos.model import COSMOS_7B, COSMOS_14B, CosmosConfig, CosmosModel

    tdir = os.path.join(model_dir, "transformer")
    cfg = dataclass_from_json(tdir, CosmosConfig) or (COSMOS_7B if model_size == "7B" else COSMOS_14B)
    model = CosmosModel(cfg, dtype=torch.bfloat16, device=device)
    model.load_state_dict(convert_cosmos_dit(load_dir(tdir), cfg))
    return model


def _smoke(args, device):
    import torch

    from sparse_videogen_tpu_torch.models.cosmos.model import CosmosConfig, CosmosModel
    from sparse_videogen_tpu_torch.models.cosmos.vae import CosmosVAE, CosmosVAEConfig

    logger.warning("no --model_dir: running smoke generation with random weights")
    cfg = CosmosConfig(**SMOKE_CFG)
    model = CosmosModel(cfg, dtype=torch.bfloat16, device=device).init_random(
        torch.Generator(device=device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    ctx = torch.as_tensor(rng.standard_normal((1, SMOKE_TEXT_LEN, cfg.text_embed_dim)), dtype=torch.bfloat16)
    ctx_null = torch.zeros_like(ctx)
    args.height, args.width = min(args.height, 128), min(args.width, 128)
    args.num_frames = min(args.num_frames, 17)
    args.num_inference_steps = min(args.num_inference_steps, 3)
    args.num_q_centroids = min(args.num_q_centroids, 8)
    args.num_k_centroids = min(args.num_k_centroids, 12)
    args.kmeans_iter_init = min(args.kmeans_iter_init, 8)
    vae = None
    if not args.output_file.endswith(".npz"):
        vcfg = CosmosVAEConfig(**SMOKE_VAE_CFG, latent_channels=cfg.out_channels)
        vae = CosmosVAE(vcfg, device=device).init_random(torch.Generator(device=device).manual_seed(1))
    return model, ctx, ctx_null, vae


def main(argv=None):
    args = build_parser().parse_args(argv)
    seed_everything(args.seed)
    if args.skip_existing and skip_existing(args.output_file):
        return
    from sparse_videogen_tpu_torch.config import SVGConfig
    from sparse_videogen_tpu_torch.pipelines import CosmosPipeline
    from sparse_videogen_tpu_torch.pipelines.wan import export_video

    mesh, device = make_cli_mesh(args, resolve_device(args.device))
    if args.prompt_source != "prompt":
        from sparse_videogen_tpu_torch.utils.dataloader import load_prompt_or_image

        args.prompt, _ = load_prompt_or_image(args.prompt_source, args.prompt_idx, args.prompt, None)
    args.model_dir = resolve_model_dir(args, logger)
    if args.smoke or args.model_dir is None:
        model, ctx, ctx_null, vae = _smoke(args, device)
    else:
        from sparse_videogen_tpu_torch.models.common.t5 import T5_11B

        logger.info("encoding the prompts with T5")
        ctx, ctx_null = encode_t5_prompts(args.model_dir, [args.prompt, args.negative_prompt], text_len=TEXT_LEN,
                                          default_cfg=T5_11B, mask_output=True, device=device)
        vae = load_vae(args.model_dir, device)
        model = load_dit(args.model_dir, args.model_size, device)

    model = shard_cli_model(mesh, model)
    lat = CosmosPipeline(model).generate_latents(
        ctx, ctx_null, height=args.height, width=args.width, num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps, guidance_scale=args.guidance_scale, fps=args.fps,
        pattern=args.pattern, first_layers_fp=args.first_layers_fp, first_times_fp=args.first_times_fp,
        svg=SVGConfig(num_sampled_rows=args.num_sampled_rows, sample_mse_max_row=args.sample_mse_max_row,
                      sparsity=args.sparsity),
        sap=sap_config(args, pass_zero_step=False), seed=args.seed,
        logging_file=args.logging_file if mesh is None or mesh.rank == 0 else None, mesh=mesh,
    )
    if close_mesh(mesh) != 0:
        return
    if vae is not None:
        video = make_vae_decoder(args, vae, logger)(lat)
        out = video_name(args.output_file)
        export_video(video, out, fps=args.fps)
        logger.info(f"saved video {tuple(video.shape)} -> {out}")
    else:
        np.savez(args.output_file, latents=lat.cpu().numpy())
        logger.info(f"saved latents {tuple(lat.shape)} -> {args.output_file}")


if __name__ == "__main__":
    main()
