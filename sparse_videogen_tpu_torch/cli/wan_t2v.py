"""Wan 2.1 T2V generation CLI (counterpart of sparse_videogen_tpu/cli/wan_t2v.py).

The flags are the JAX CLI's, by name and default (the port declares its own
parser), plus `--device`, since PyTorch needs one named. There is no
fallback to the CPU: `--device cuda` on a host without a card fails.

With `--model_dir` (or a local dir as `--model_id`) it runs the whole main
path: the prompt (or a line of `--prompt_source`) and the negative prompt
through the UMT5 tokenizer and encoder (freed before the DiT runs), the Wan
DiT from `transformer/` (diffusers or wan_orig names; `--converted_cache`
keeps the converted weights), the denoise loop with dense, SVG1 or SAP
(`--sap_block_mode cluster` or `tile`) attention, the Wan VAE decode from `vae/` (`--vae_tiling`,
`--vae_stream_chunk`) and the video writer: `.y4m`, or `.mp4` where PIL is
installed; an `.npz` name becomes `.y4m`. Without `vae/` the latents go to
the `.npz`. `--smoke` (or no checkpoint) takes the JAX CLI's random-weight
path at a reduced size, and a video name decodes through a tiny random VAE.
`--sampler dpm++` takes FlowDPM for FlowUniPC. `--quant int8` runs the
blocks' linears W8A8 (int8 weights and per-token activations, an int8
GEMM), `--quant fp8` (or `--use_fp8`) stores them as e4m3 upcast to bf16.
`--ring_degree N` runs dense or SAP attention token-sharded over N ranks
and `--ulysses_degree M` every pattern head-sharded over M (both: USP),
one process a rank under torchrun (gloo with `--device cpu`, NCCL on
cards); rank 0 writes (SAP's ring runs cluster mode only, as the JAX
package's). --dp and --dit_fsdp are not ported and raise.

Usage:
  python -m sparse_videogen_tpu_torch.cli.wan_t2v --model_dir DIR \
      --prompt "a cat on the grass." --output_file out.y4m
  python -m sparse_videogen_tpu_torch.cli.wan_t2v --smoke --pattern SAP \
      --device cuda --output_file out.npz
  torchrun --nproc_per_node 2 -m sparse_videogen_tpu_torch.cli.wan_t2v --smoke \
      --pattern dense --ring_degree 2 --device cpu --output_file out.npz
  torchrun --nproc_per_node 2 -m sparse_videogen_tpu_torch.cli.wan_t2v --smoke \
      --pattern SVG --ulysses_degree 2 --quant int8 --output_file out.npz
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from sparse_videogen_tpu_torch.cli._common import (add_device, add_model_id, add_vae_tiling_flags, make_vae_decoder,
                                                   quantize_blocks, resolve_device, resolve_model_dir, sap_config)
from sparse_videogen_tpu_torch.cli._parallel import add_parallel_flags, close_mesh, make_cli_mesh

logger = logging.getLogger("sparse_videogen_tpu_torch")

# the JAX CLI's --smoke model and video decoder (cli/wan_t2v.py there)
SMOKE_CFG = dict(dim=256, ffn_dim=512, num_heads=4, num_layers=4, freq_dim=64, text_dim=64, text_len=16)
SMOKE_VAE_CFG = dict(dim=16, dim_mult=(1, 2, 2, 2), num_res_blocks=1)
# the reference's negative prompt (wan_t2v_inference.py:108-110)
DEFAULT_NEG_PROMPT = (
    "Bright tones, overexposed, static, blurred details, subtitles, "
    "style, works, paintings, images, static, overall gray, worst "
    "quality, low quality, JPEG compression residue, ugly, incomplete, "
    "extra fingers, poorly drawn hands, poorly drawn faces, deformed, "
    "disfigured, misshapen limbs, fused fingers, still picture, messy "
    "background, three legs, many people in the background, walking "
    "backwards"
)


def build_parser():
    p = argparse.ArgumentParser("wan_t2v")
    p.add_argument("--prompt", type=str, default="A cat walks on the grass, realistic")
    p.add_argument("--neg_prompt", "--negative_prompt", dest="neg_prompt", type=str, default="")
    p.add_argument("--prompt_source", type=str, default="prompt")
    p.add_argument("--prompt_idx", type=int, default=0)
    p.add_argument("--model_dir", type=str, default=None)
    add_model_id(p, "Wan-AI/Wan2.1-T2V-14B-Diffusers")
    add_vae_tiling_flags(p)
    p.add_argument("--model_size", type=str, default="1.3B", choices=["1.3B", "14B"])
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=5.0)
    p.add_argument("--flow_shift", type=float, default=None, help="default 5.0 for 720p, 3.0 otherwise")
    p.add_argument("--sampler", type=str, default="unipc", choices=["unipc", "dpm++"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output_file", type=str, default="output.npz")
    p.add_argument("--skip_existing", action="store_true")
    p.add_argument("--converted_cache", type=str, default=None)
    p.add_argument("--pattern", type=str, default="SVG", choices=["SVG", "dense", "SAP"])
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
    p.add_argument("--sap_block_mode", type=str, default="cluster", choices=["cluster", "tile"])
    p.add_argument("--zero_step_kmeans_init", action="store_true")
    p.add_argument("--logging_file", type=str, default=None, help="JSONL density telemetry for SAP")
    add_parallel_flags(p, dp=True)
    p.add_argument("--smoke", action="store_true", help="tiny random-weight run (no checkpoints needed)")
    p.add_argument("--use_fp8", action="store_true", help="fp8 (e4m3) block-linear weights; --quant fp8")
    p.add_argument("--quant", choices=["none", "fp8", "int8"], default=None,
                   help="block-linear quantization: fp8 = e4m3 weight-only storage, int8 = W8A8 int8 matmuls")
    return add_device(p)


def _load_checkpoint(args, device):
    """--model_dir: the DiT (converted, or from --converted_cache), the text
    states of the prompt and the negative prompt (UMT5, freed before the DiT
    runs) and the VAE decoder (None without vae/)."""
    import torch

    from sparse_videogen_tpu_torch.io.checkpoint import (convert_wan_dit, convert_wan_vae, dataclass_from_json,
                                                         wan_config_from_json)
    from sparse_videogen_tpu_torch.io.encoders import UMT5Encoder
    from sparse_videogen_tpu_torch.io.safetensors import load_dir, load_file, save_file
    from sparse_videogen_tpu_torch.models.wan.model import WAN_1_3B, WAN_14B, WanModel
    from sparse_videogen_tpu_torch.models.wan.vae import WanVAE, WanVAEConfig

    tdir = os.path.join(args.model_dir, "transformer")
    cfg = wan_config_from_json(tdir) or (WAN_1_3B if args.model_size == "1.3B" else WAN_14B)
    cache = os.path.join(args.converted_cache, "wan_dit") if args.converted_cache else None
    cached = os.path.join(cache, "params.safetensors") if cache else None
    if cached and os.path.isfile(cached):
        logger.info(f"loading converted params from cache {cache}")
        sd = load_file(cached)
    else:
        sd = convert_wan_dit(load_dir(tdir), cfg)
    model = WanModel(cfg, dtype=torch.bfloat16, device=device)
    model.load_state_dict(sd)
    if cached and not os.path.isfile(cached):
        os.makedirs(cache, exist_ok=True)
        save_file(model.state_dict(), cached)
        logger.info(f"cached converted params -> {cache}")
    del sd

    logger.info("encoding prompts with UMT5")
    t5 = UMT5Encoder.from_dir(args.model_dir, text_len=cfg.text_len, device=device)
    ctx = t5([args.prompt]).to(torch.bfloat16)
    ctx_null = t5([args.neg_prompt]).to(torch.bfloat16)
    del t5  # free the encoder (~11 GB for UMT5-XXL) before the DiT runs
    if device.type == "cuda":
        torch.cuda.empty_cache()

    vae_dir = os.path.join(args.model_dir, "vae")
    if not os.path.isdir(vae_dir):
        logger.warning(f"no {vae_dir}: saving latents instead of video")
        return model, ctx, ctx_null, None
    vae_cfg = dataclass_from_json(vae_dir, WanVAEConfig) or WanVAEConfig()
    vae = WanVAE(vae_cfg, device=device)
    vae.load_state_dict(convert_wan_vae(load_dir(vae_dir), vae_cfg))
    return model, ctx, ctx_null, make_vae_decoder(args, vae, logger)


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    if args.skip_existing:
        out = args.output_file
        for path in (out, out[: -len(".npz")] + ".y4m" if out.endswith(".npz") else out):
            if os.path.exists(path):
                print(f"output {path} exists; skipping generation")
                return
    import torch

    from sparse_videogen_tpu_torch.config import SVGConfig
    from sparse_videogen_tpu_torch.models.wan.model import WanConfig, WanModel
    from sparse_videogen_tpu_torch.pipelines import WanPipeline

    mesh, device = make_cli_mesh(args, resolve_device(args.device))
    rank = 0 if mesh is None else mesh.rank
    if args.prompt_source != "prompt":
        # --prompt is the prompt list and --prompt_idx picks the entry
        from sparse_videogen_tpu_torch.utils.dataloader import load_prompt_or_image

        args.prompt, _ = load_prompt_or_image(args.prompt_source, args.prompt_idx, args.prompt, None)
    if args.flow_shift is None:
        args.flow_shift = 5.0 if args.height >= 720 else 3.0
    if not args.neg_prompt:
        args.neg_prompt = DEFAULT_NEG_PROMPT

    vae_decode = None
    args.model_dir = resolve_model_dir(args, logger)
    if args.smoke or args.model_dir is None:
        logger.warning("no --model_dir: running smoke generation with random weights")
        cfg = WanConfig(**SMOKE_CFG)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model = WanModel(cfg, dtype=torch.bfloat16, device=device).init_random(gen)
        rng = np.random.default_rng(args.seed)
        ctx = torch.as_tensor(rng.standard_normal((1, cfg.text_len, cfg.text_dim)), dtype=torch.bfloat16,
                              device=device)
        ctx_null = torch.zeros_like(ctx)
        args.height, args.width = min(args.height, 96), min(args.width, 128)
        args.num_frames = min(args.num_frames, 9)
        args.num_inference_steps = min(args.num_inference_steps, 4)
        args.num_q_centroids = min(args.num_q_centroids, 8)
        args.num_k_centroids = min(args.num_k_centroids, 12)
        args.kmeans_iter_init = min(args.kmeans_iter_init, 8)
        if not args.output_file.endswith(".npz"):
            # a video name: decode through a tiny random VAE, so the smoke run
            # goes through pixels and the container too
            from sparse_videogen_tpu_torch.models.wan.vae import WanVAE, WanVAEConfig

            vae = WanVAE(WanVAEConfig(**SMOKE_VAE_CFG), device=device)
            vae.init_random(torch.Generator(device=device).manual_seed(1))
            vae_decode = make_vae_decoder(args, vae, logger)
    else:
        model, ctx, ctx_null, vae_decode = _load_checkpoint(args, device)
    quantize_blocks(args, model.blocks, logger=logger)

    lat = WanPipeline(model).generate_latents(
        ctx, ctx_null,
        height=args.height, width=args.width, num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale, flow_shift=args.flow_shift,
        sampler=args.sampler, pattern=args.pattern,
        first_layers_fp=args.first_layers_fp, first_times_fp=args.first_times_fp,
        svg=SVGConfig(num_sampled_rows=args.num_sampled_rows,
                      sample_mse_max_row=args.sample_mse_max_row,
                      sparsity=args.sparsity),
        sap=sap_config(args),
        seed=args.seed,
        logging_file=args.logging_file if rank == 0 else None,
        mesh=mesh,
    )
    if close_mesh(mesh) != 0:
        return
    if vae_decode is not None:
        from sparse_videogen_tpu_torch.pipelines.wan import export_video

        video = vae_decode(lat)
        out = args.output_file
        if out.endswith(".npz"):
            out = out[: -len(".npz")] + ".y4m"
        export_video(video, out, fps=16)
        logger.info(f"saved video {tuple(video.shape)} -> {out}")
    else:
        np.savez(args.output_file, latents=lat.cpu().numpy())
        logger.info(f"saved latents {tuple(lat.shape)} -> {args.output_file}")


if __name__ == "__main__":
    main()
