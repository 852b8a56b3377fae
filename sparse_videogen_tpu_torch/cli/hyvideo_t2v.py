"""HunyuanVideo T2V generation CLI (counterpart of
sparse_videogen_tpu/cli/hyvideo_t2v.py).

The flags are the JAX CLI's, by name and default, plus `--device` (default
cuda; never falls back to the CPU).

What runs today is the random-weight path that the JAX CLI takes without
`--model_dir` (`--smoke`, or no checkpoint): a tiny HunyuanVideo at a
reduced size with random text states (prompt length 10 of 16), denoised
with dense, SVG1 or SAP attention (`--sap_block_mode cluster` or `tile`; the
smoke caps the centroids at 8 / 12 and the cold k-means at 8 iterations, as
the JAX CLI does), latents written to an `.npz`. Checkpoints
(`--model_dir`), the LLaMA/CLIP text encoders, the VAE decode to a video,
quantization and parallelism raise NotImplementedError (ROADMAP.md).

Usage:
  python -m sparse_videogen_tpu_torch.cli.hyvideo_t2v --smoke --pattern SAP \\
      --sap_block_mode tile --device cuda --output_file out.npz
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from sparse_videogen_tpu_torch.cli._common import add_device, add_model_id, add_vae_tiling_flags, resolve_device

logger = logging.getLogger("sparse_videogen_tpu_torch")

# the JAX CLI's --smoke model, and its prompt length (mask[:10])
SMOKE_CFG = dict(hidden_size=256, heads_num=4, mm_double_blocks_depth=2, mm_single_blocks_depth=2,
                 rope_dim_list=(16, 24, 24), text_states_dim=64, text_states_dim_2=32, text_len=16)
SMOKE_PROMPT_LENGTH = 10


def build_parser():
    p = argparse.ArgumentParser("hyvideo_t2v")
    p.add_argument("--prompt", type=str, default="A cat walks on the grass, realistic")
    p.add_argument("--negative_prompt", type=str, default=None,
                   help="accepted for parity; embedded guidance runs no uncond pass, so it is unused")
    p.add_argument("--prompt_source", type=str, default="prompt")
    p.add_argument("--prompt_idx", type=int, default=0)
    p.add_argument("--resolution", type=str, default=None, choices=["480p", "720p"],
                   help="preset for --height/--width (480p=480x720, 720p=720x1280); explicit --height/--width win")
    p.add_argument("--model_dir", type=str, default=None)
    add_model_id(p, "tencent/HunyuanVideo")
    add_vae_tiling_flags(p)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--logging_file", type=str, default=None)
    p.add_argument("--num_frames", type=int, default=129)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--embedded_guidance_scale", type=float, default=6.0)
    p.add_argument("--flow_shift", type=float, default=7.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output_file", type=str, default="output_hy.npz")
    p.add_argument("--skip_existing", action="store_true")
    p.add_argument("--pattern", type=str, default="SVG", choices=["SVG", "dense", "SAP"])
    p.add_argument("--first_layers_fp", type=float, default=0.025)
    p.add_argument("--first_times_fp", type=float, default=0.15)
    p.add_argument("--num_sampled_rows", type=int, default=64)
    p.add_argument("--sample_mse_max_row", type=int, default=10000)
    p.add_argument("--sparsity", type=float, default=0.25)
    p.add_argument("--num_q_centroids", type=int, default=400)
    p.add_argument("--num_k_centroids", type=int, default=1000)
    p.add_argument("--top_p_kmeans", type=float, default=0.9)
    p.add_argument("--min_kc_ratio", type=float, default=0.0)
    p.add_argument("--kmeans_iter_init", type=int, default=50)
    p.add_argument("--kmeans_iter_step", type=int, default=2)
    p.add_argument("--sap_block_mode", type=str, default="cluster", choices=["cluster", "tile"])
    p.add_argument("--zero_step_kmeans_init", action="store_true")
    p.add_argument("--smoke", action="store_true", help="tiny random-weight run (no checkpoints needed)")
    p.add_argument("--use_fp8", action="store_true")
    p.add_argument("--quant", choices=["none", "fp8", "int8"], default=None)
    p.add_argument("--ulysses_degree", type=int, default=1)
    p.add_argument("--ring_degree", type=int, default=1)
    p.add_argument("--dit_fsdp", action="store_true")
    return add_device(p)


def _unported(args) -> str | None:
    if args.model_dir or (args.model_id and os.path.isdir(args.model_id)):
        return "--model_dir (checkpoint conversion, LLaMA/CLIP text encoders, HunyuanVideo VAE)"
    if not args.output_file.endswith(".npz"):
        return "video output (the HunyuanVideo VAE decode); write latents to a .npz"
    if args.quant not in (None, "none") or args.use_fp8:
        return "--quant / --use_fp8"
    if args.ulysses_degree * args.ring_degree > 1 or args.dit_fsdp:
        return "multi-device parallelism"
    if args.prompt_source != "prompt":
        return "--prompt_source (prompts need the text encoders)"
    return None


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    if args.skip_existing and os.path.exists(args.output_file):
        print(f"output {args.output_file} exists; skipping generation")
        return
    missing = _unported(args)
    if missing is not None:
        raise NotImplementedError(f"{missing} is not ported to the torch package yet (ROADMAP.md)")

    import torch

    from sparse_videogen_tpu_torch.cli._common import sap_config
    from sparse_videogen_tpu_torch.config import SVGConfig
    from sparse_videogen_tpu_torch.models.hyvideo.model import HyVideoConfig, HyVideoModel
    from sparse_videogen_tpu_torch.pipelines import HyVideoPipeline

    device = resolve_device(args.device)
    if args.height is None or args.width is None:
        ph, pw = (480, 720) if args.resolution == "480p" else (720, 1280)
        args.height = ph if args.height is None else args.height
        args.width = pw if args.width is None else args.width

    logger.warning("no --model_dir: running smoke generation with random weights")
    cfg = HyVideoConfig(**SMOKE_CFG)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = HyVideoModel(cfg, dtype=torch.bfloat16, device=device).init_random(gen)
    rng = np.random.default_rng(args.seed)
    text = torch.as_tensor(rng.standard_normal((1, cfg.text_len, cfg.text_states_dim)), dtype=torch.float32)
    mask = torch.ones(1, cfg.text_len, dtype=torch.int32)
    mask[0, SMOKE_PROMPT_LENGTH:] = 0
    pooled = torch.as_tensor(rng.standard_normal((1, cfg.text_states_dim_2)), dtype=torch.float32)
    args.height, args.width = min(args.height, 96), min(args.width, 128)
    args.num_frames = min(args.num_frames, 9)
    args.num_inference_steps = min(args.num_inference_steps, 3)
    args.num_q_centroids = min(args.num_q_centroids, 8)
    args.num_k_centroids = min(args.num_k_centroids, 12)
    args.kmeans_iter_init = min(args.kmeans_iter_init, 8)

    lat = HyVideoPipeline(model).generate_latents(
        text, mask, pooled, prompt_length=int(mask[0].sum()),
        height=args.height, width=args.width, num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps, embedded_guidance_scale=args.embedded_guidance_scale,
        flow_shift=args.flow_shift, pattern=args.pattern,
        first_layers_fp=args.first_layers_fp, first_times_fp=args.first_times_fp,
        svg=SVGConfig(num_sampled_rows=args.num_sampled_rows, sample_mse_max_row=args.sample_mse_max_row,
                      sparsity=args.sparsity, profile_multiplier=1.5),
        sap=sap_config(args), seed=args.seed, logging_file=args.logging_file,
    )
    np.savez(args.output_file, latents=lat.cpu().numpy())
    logger.info(f"saved latents {tuple(lat.shape)} -> {args.output_file}")


if __name__ == "__main__":
    main()
