"""HunyuanVideo T2V generation CLI (counterpart of
sparse_videogen_tpu/cli/hyvideo_t2v.py).

The flags are the JAX CLI's, by name and default, plus `--device` (default
cuda; never falls back to the CPU).

With `--model_dir` (or a local dir as `--model_id`) it runs from a prompt
to a video: the prompt (or `--prompt_source`'s line) through the LLaMA-3
template and CLIP-L (text_encoder/, text_encoder_2/: io/encoders.
HyVideoTextEncoders, their tokenizer.json files read by io/tokenizer.
HFTokenizerLite), the encoders freed; the VAE from vae/ (without it the
latents go to an .npz); the DiT from transformer/ (loaded last, in bf16);
the denoise loop with dense, SVG1 or SAP attention (`--sap_block_mode
cluster` or `tile`); the VAE decode (`--vae_tiling`; the HunyuanVideo VAE
has no streamed decode, so `--vae_stream_chunk` warns and decodes the whole
sequence); the writer: `.y4m`, or `.mp4` (the port's own JPEG encoder, no
PIL); an `.npz` name becomes `.y4m`. `--smoke` (or no checkpoint) takes the JAX CLI's
random-weight path: a tiny HunyuanVideo with random text states (prompt
length 10 of 16), the centroids capped at 8 / 12 and the cold k-means at 8
iterations, latents to an `.npz`, or, with another name, decoded by a tiny
random VAE to a video. As in the JAX CLI, SAP's config drops
`--zero_step_kmeans_init`. `--quant int8|fp8` (or `--use_fp8`) quantizes the
double and single blocks' linears (utils/quant.py). `--ulysses_degree M`
(every pattern head-sharded) and `--ring_degree N` (dense only, on the
text-last layout) run under torchrun, one process a rank; rank 0 writes.
`--dit_fsdp` shards the DiT's weights over every torchrun rank (FSDP,
parallel/sharding.py), as any grid of more than one rank does.

Usage:
  python -m sparse_videogen_tpu_torch.cli.hyvideo_t2v --model_dir DIR --prompt "..." --output_file out.y4m
  python -m sparse_videogen_tpu_torch.cli.hyvideo_t2v --smoke --pattern SAP \\
      --sap_block_mode tile --device cuda --output_file out.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from sparse_videogen_tpu_torch.cli._common import (add_device, add_model_id, add_vae_tiling_flags, make_vae_decoder,
                                                   prints_time_log, quantize_blocks, resolve_device, resolve_model_dir)
from sparse_videogen_tpu_torch.cli._parallel import (add_parallel_flags, close_mesh, make_cli_mesh,
                                                     shard_cli_model)
from sparse_videogen_tpu_torch.utils.logging import logger
from sparse_videogen_tpu_torch.utils.seed import seed_everything


# the JAX CLI's --smoke model, and its prompt length (mask[:10])
SMOKE_CFG = dict(hidden_size=256, heads_num=4, mm_double_blocks_depth=2, mm_single_blocks_depth=2,
                 rope_dim_list=(16, 24, 24), text_states_dim=64, text_states_dim_2=32, text_len=16)
SMOKE_PROMPT_LENGTH = 10
# the JAX CLIs' tiny random VAE for a smoke run with a video name (seed 1)
SMOKE_VAE_CFG = dict(block_out_channels=(16, 16, 16, 16), layers_per_block=1, norm_num_groups=4)


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
    p.add_argument("--use_fp8", action="store_true", help="fp8 (e4m3) block-linear weights; --quant fp8")
    p.add_argument("--quant", choices=["none", "fp8", "int8"], default=None,
                   help="block-linear quantization: fp8 = e4m3 weight-only storage, int8 = W8A8 int8 matmuls")
    add_parallel_flags(p)
    return add_device(p)


def skip_existing(args) -> bool:
    """--skip_existing: the output, or the .y4m an .npz name becomes, exists."""
    out = args.output_file
    for path in (out, out[: -len(".npz")] + ".y4m" if out.endswith(".npz") else out):
        if os.path.exists(path):
            print(f"output {path} exists; skipping generation")
            return True
    return False


def smoke_vae_decoder(args, device):
    """The tiny random HunyuanVideo VAE of a smoke run with a video name."""
    import torch

    from sparse_videogen_tpu_torch.models.hyvideo.vae import HyVideoVAE, HyVideoVAEConfig

    vae = HyVideoVAE(HyVideoVAEConfig(**SMOKE_VAE_CFG), device=device).init_random(
        torch.Generator(device=device).manual_seed(1))
    return make_vae_decoder(args, vae, logger)


def load_vae_decoder(args, model_dir, device):
    """vae/ -> (the HyVideoVAE, its decoder as the CLI's flags build it), or
    (None, None) without the dir."""
    from sparse_videogen_tpu_torch.io.checkpoint import convert_hyvideo_vae, dataclass_from_json
    from sparse_videogen_tpu_torch.io.safetensors import load_dir
    from sparse_videogen_tpu_torch.models.hyvideo.vae import HyVideoVAE, HyVideoVAEConfig

    vae_dir = os.path.join(model_dir, "vae")
    if not os.path.isdir(vae_dir):
        logger.warning(f"no {vae_dir}: saving latents instead of video")
        return None, None
    vcfg = dataclass_from_json(vae_dir, HyVideoVAEConfig) or HyVideoVAEConfig()
    vae = HyVideoVAE(vcfg, device=device)
    vae.load_state_dict(convert_hyvideo_vae(load_dir(vae_dir), vcfg))
    return vae, make_vae_decoder(args, vae, logger)


def load_dit(model_dir, device, cfg=None):
    """transformer/ -> a bf16 HyVideoModel (cfg from its config.json, else HYVIDEO_T2)."""
    import torch

    from sparse_videogen_tpu_torch.io.checkpoint import convert_hyvideo_dit, dataclass_from_json
    from sparse_videogen_tpu_torch.io.safetensors import load_dir
    from sparse_videogen_tpu_torch.models.hyvideo.model import HYVIDEO_T2, HyVideoConfig, HyVideoModel

    tdir = os.path.join(model_dir, "transformer")
    cfg = cfg or dataclass_from_json(tdir, HyVideoConfig) or HYVIDEO_T2
    model = HyVideoModel(cfg, dtype=torch.bfloat16, device=device)
    model.load_state_dict(convert_hyvideo_dit(load_dir(tdir), cfg))
    return model


def free_cuda(device):
    import torch

    if device.type == "cuda":
        torch.cuda.empty_cache()


def _load_checkpoint(args, device):
    """--model_dir: the prompt through HyVideoTextEncoders (then freed), the
    VAE decoder, the DiT last. Returns (model, text, mask, pooled, vae_decode)."""
    from sparse_videogen_tpu_torch.io.checkpoint import dataclass_from_json
    from sparse_videogen_tpu_torch.io.encoders import HyVideoTextEncoders
    from sparse_videogen_tpu_torch.models.hyvideo.model import HYVIDEO_T2, HyVideoConfig

    cfg = dataclass_from_json(os.path.join(args.model_dir, "transformer"), HyVideoConfig) or HYVIDEO_T2
    logger.info("encoding the prompt with the LLaMA template and CLIP-L")
    enc = HyVideoTextEncoders.from_dir(args.model_dir, text_len=cfg.text_len, device=device)
    text, mask, pooled = enc([args.prompt])
    del enc
    free_cuda(device)
    _, vae_decode = load_vae_decoder(args, args.model_dir, device)
    return load_dit(args.model_dir, device, cfg), text, mask, pooled, vae_decode


def write_output(args, lat, vae_decode):
    """The video through vae_decode (an .npz name becomes .y4m), else the latents."""
    if vae_decode is not None:
        from sparse_videogen_tpu_torch.pipelines.wan import export_video

        video = vae_decode(lat)
        out = args.output_file
        if out.endswith(".npz"):
            out = out[: -len(".npz")] + ".y4m"
        export_video(video, out, fps=24)
        logger.info(f"saved video {tuple(video.shape)} -> {out}")
    else:
        np.savez(args.output_file, latents=lat.cpu().numpy())
        logger.info(f"saved latents {tuple(lat.shape)} -> {args.output_file}")


@prints_time_log
def main(argv=None):
    args = build_parser().parse_args(argv)
    seed_everything(args.seed)
    if args.skip_existing and skip_existing(args):
        return
    import torch

    from sparse_videogen_tpu_torch.cli._common import sap_config
    from sparse_videogen_tpu_torch.config import SVGConfig
    from sparse_videogen_tpu_torch.models.hyvideo.model import HyVideoConfig, HyVideoModel
    from sparse_videogen_tpu_torch.pipelines import HyVideoPipeline

    mesh, device = make_cli_mesh(args, resolve_device(args.device))
    if args.prompt_source != "prompt":
        from sparse_videogen_tpu_torch.utils.dataloader import load_prompt_or_image

        args.prompt, _ = load_prompt_or_image(args.prompt_source, args.prompt_idx, args.prompt, None)
    if args.height is None or args.width is None:
        ph, pw = (480, 720) if args.resolution == "480p" else (720, 1280)
        args.height = ph if args.height is None else args.height
        args.width = pw if args.width is None else args.width

    vae_decode = None
    args.model_dir = resolve_model_dir(args, logger)
    if args.smoke or args.model_dir is None:
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
        if not args.output_file.endswith(".npz"):
            vae_decode = smoke_vae_decoder(args, device)
    else:
        model, text, mask, pooled, vae_decode = _load_checkpoint(args, device)
    quantize_blocks(args, model.double_blocks, model.single_blocks, logger=logger)

    model = shard_cli_model(mesh, model)
    lat = HyVideoPipeline(model).generate_latents(
        text, mask, pooled, prompt_length=int(mask[0].sum()),
        height=args.height, width=args.width, num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps, embedded_guidance_scale=args.embedded_guidance_scale,
        flow_shift=args.flow_shift, pattern=args.pattern,
        first_layers_fp=args.first_layers_fp, first_times_fp=args.first_times_fp,
        svg=SVGConfig(num_sampled_rows=args.num_sampled_rows, sample_mse_max_row=args.sample_mse_max_row,
                      sparsity=args.sparsity, profile_multiplier=1.5),
        sap=sap_config(args, pass_zero_step=False), seed=args.seed,
        logging_file=args.logging_file if mesh is None or mesh.rank == 0 else None, mesh=mesh,
    )
    if close_mesh(mesh) == 0:
        write_output(args, lat, vae_decode)


if __name__ == "__main__":
    main()
