"""Wan 2.1 I2V generation CLI (counterpart of sparse_videogen_tpu/cli/wan_i2v.py).

The flags are the JAX CLI's, by name and default (the port declares its own
parser), plus `--device`. There is no fallback to the CPU: `--device cuda`
on a host without a card fails.

With `--model_dir` (or a local dir as `--model_id`) it runs the whole I2V
path: the image (`--image_path`: a baseline JPEG or a PNG through
io/image.py, or a (3, H, W) .npy in [-1, 1]) fitted to the resolution's
area at its aspect ratio; the prompt and the negative prompt through the
UMT5 tokenizer and encoder; the image through the CLIP ViT-H/14 vision
tower from `image_encoder/` (its penultimate states); the VAE encode of
[image, zeros...] from `vae/` (whole, or streamed in the reference's
chunks where the whole encode would not fit on the card) and the condition
(build_i2v_condition); the Wan I2V DiT from `transformer/`; the denoise
loop with dense, SVG1 or SAP (`--sap_block_mode cluster` or `tile`) attention; the VAE decode
(`--vae_tiling`, `--vae_stream_chunk`) to a `.y4m`. Each encoder is freed
before the DiT runs. Both resizes (to CLIP's 224x224 and to the fitted
size) follow jax.image.resize's cubic rule (models/common/resize.py).
`--smoke` (or no checkpoint) takes the JAX CLI's random-weight path at a
reduced size (random CLIP features and image latents) and writes the
latents to the .npz. `--ring_degree N` (dense or SAP attention
token-sharded over N ranks) and `--ulysses_degree M` (every pattern
head-sharded over M) run under torchrun, as cli/wan_t2v.py does; rank 0
writes (SAP's ring in cluster mode only). --dp and --dit_fsdp are not
ported and raise.

Usage:
  python -m sparse_videogen_tpu_torch.cli.wan_i2v --model_dir DIR \
      --image_path examples/1/image.jpg --prompt "..." --resolution 480p --output_file out.y4m
  python -m sparse_videogen_tpu_torch.cli.wan_i2v --smoke --pattern SVG --device cpu --output_file out.npz
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from sparse_videogen_tpu_torch.cli._common import (add_device, add_model_id, add_vae_tiling_flags, make_vae_decoder,
                                                   resolve_device, resolve_model_dir, sap_config)
from sparse_videogen_tpu_torch.cli._parallel import add_parallel_flags, close_mesh, make_cli_mesh

logger = logging.getLogger("sparse_videogen_tpu_torch")

# the JAX CLI's --smoke model (cli/wan_i2v.py there)
SMOKE_CFG = dict(model_type="i2v", in_dim=36, dim=256, ffn_dim=512, num_heads=4, num_layers=4, freq_dim=64,
                 text_dim=64, text_len=16, image_dim=48)
# the whole VAE encode's peak device memory, in f32 activations of its first
# stage (frames x H x W x dim): chip_smoke.py's i2v phase prints the
# measured peak beside this estimate
ENCODE_PEAK_ACTIVATIONS = 5


def build_parser():
    p = argparse.ArgumentParser("wan_i2v")
    p.add_argument("--prompt", type=str, default="A cat walks on the grass, realistic")
    p.add_argument("--neg_prompt", "--negative_prompt", dest="neg_prompt", type=str, default="")
    p.add_argument("--data_path", type=str, default=None, help="VBench I2V data suite dir (reference --data_path)")
    p.add_argument("--attention_backend", type=str, default="flexattn", choices=["flashinfer", "flexattn"],
                   help="reference-parity flag; both map to the port's one attention kernel")
    p.add_argument("--logging_file", type=str, default=None, help="JSONL density telemetry for SAP")
    p.add_argument("--image_path", type=str, default=None,
                   help="conditioning image (baseline JPEG or PNG); .npy = (3, H, W) array in [-1, 1]")
    p.add_argument("--prompt_source", type=str, default="prompt", choices=["prompt", "I2V_VBench", "I2V_Wan_Web"])
    p.add_argument("--prompt_idx", type=int, default=0)
    p.add_argument("--model_dir", type=str, default=None,
                   help="dir with transformer/ image_encoder/ vae/ and the UMT5 dir and tokenizer")
    add_model_id(p, "Wan-AI/Wan2.1-I2V-14B-720P-Diffusers")
    add_vae_tiling_flags(p)
    p.add_argument("--resolution", type=str, default="720p", choices=["480p", "720p"])
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output_file", type=str, default="output_i2v.npz")
    p.add_argument("--skip_existing", action="store_true")
    p.add_argument("--pattern", type=str, default="dense", choices=["SVG", "dense", "SAP"])
    p.add_argument("--first_layers_fp", type=float, default=0.3)
    p.add_argument("--first_times_fp", type=float, default=0.03)
    p.add_argument("--num_sampled_rows", type=int, default=64)
    p.add_argument("--sample_mse_max_row", type=int, default=10000)
    p.add_argument("--sparsity", type=float, default=0.25)
    p.add_argument("--num_q_centroids", type=int, default=50)
    p.add_argument("--num_k_centroids", type=int, default=200)
    p.add_argument("--top_p_kmeans", type=float, default=0.9)
    p.add_argument("--min_kc_ratio", type=float, default=0.0)
    p.add_argument("--kmeans_iter_init", type=int, default=0)
    p.add_argument("--kmeans_iter_step", type=int, default=0)
    p.add_argument("--sap_block_mode", type=str, default="cluster", choices=["cluster", "tile"])
    p.add_argument("--zero_step_kmeans_init", action="store_true")
    p.add_argument("--smoke", action="store_true", help="tiny random-weight run (no checkpoints needed)")
    add_parallel_flags(p, dp=True)
    return add_device(p)


def _fit_resolution(h, w, resolution, mod=16):
    """Aspect-preserving area fit (the reference's wan_i2v_inference.py)."""
    max_area = 720 * 1280 if resolution == "720p" else 480 * 832
    ar = h / w
    H = int(round(np.sqrt(max_area * ar))) // mod * mod
    W = int(round(np.sqrt(max_area / ar))) // mod * mod
    return H, W


def encode_mode(vae_cfg, video_shape, device) -> tuple[str, int]:
    """"whole", or "streamed" on a card where the whole encode's estimated
    peak (ENCODE_PEAK_ACTIVATIONS f32 activations of the first stage)
    exceeds the free memory; and that estimate in bytes."""
    import torch

    _, _, T, H, W = video_shape
    need = ENCODE_PEAK_ACTIVATIONS * T * H * W * vae_cfg.dim * 4
    streamed = device.type == "cuda" and need > torch.cuda.mem_get_info(device)[0]
    return ("streamed" if streamed else "whole"), need


def encode_image_video(vae, video, device):
    """The VAE encode of [image, zeros...], whole or streamed (frame 0, then
    4 frames a chunk; the same function) as encode_mode picks."""
    which, need = encode_mode(vae.cfg, video.shape, device)
    logger.info(f"VAE encode: {which} ({tuple(video.shape[2:])}; the whole encode's estimated peak "
                f"{need / 2**30:.1f} GiB)")
    return vae.encode_streamed(video) if which == "streamed" else vae.encode(video)


def _load_checkpoint(args, device):
    """--model_dir: the text states (UMT5), the CLIP features, the image
    latents (the VAE encode), each encoder freed after its use, then the I2V
    DiT and the VAE decoder. Returns (model, ctx, ctx_null, clip_fea,
    img_lat, (H, W), vae_decode)."""
    import torch

    from sparse_videogen_tpu_torch.io.checkpoint import (convert_wan_dit, convert_wan_vae, dataclass_from_json,
                                                         wan_config_from_json)
    from sparse_videogen_tpu_torch.io.encoders import CLIPImageEncoder, UMT5Encoder
    from sparse_videogen_tpu_torch.io.image import load_image
    from sparse_videogen_tpu_torch.io.safetensors import load_dir
    from sparse_videogen_tpu_torch.models.common.resize import resize_cubic
    from sparse_videogen_tpu_torch.models.wan.model import WanModel
    from sparse_videogen_tpu_torch.models.wan.vae import WanVAE, WanVAEConfig

    if not args.image_path:
        raise ValueError("--image_path is required for I2V with --model_dir")
    img = load_image(args.image_path)
    H, W = _fit_resolution(img.shape[2], img.shape[3], args.resolution)
    logger.info(f"image {tuple(img.shape[2:])} -> {H}x{W} ({args.resolution})")

    tdir = os.path.join(args.model_dir, "transformer")
    cfg = wan_config_from_json(tdir)
    if cfg is None or cfg.model_type != "i2v":
        raise ValueError(f"{tdir}: expected an I2V transformer (a config.json with image_dim)")

    logger.info("encoding prompts with UMT5")
    t5 = UMT5Encoder.from_dir(args.model_dir, text_len=cfg.text_len, device=device)
    ctx = t5([args.prompt]).to(torch.bfloat16)
    ctx_null = t5([args.neg_prompt]).to(torch.bfloat16)
    del t5

    logger.info("encoding the image with CLIP")
    clip = CLIPImageEncoder.from_dir(args.model_dir, device=device)
    clip_fea = clip(img).to(torch.bfloat16)
    del clip

    vae_dir = os.path.join(args.model_dir, "vae")
    vae_cfg = dataclass_from_json(vae_dir, WanVAEConfig) or WanVAEConfig()
    vae = WanVAE(vae_cfg, device=device, encoder=True)
    vae.load_state_dict(convert_wan_vae(load_dir(vae_dir), vae_cfg, encoder=True))
    img_r = resize_cubic(img.to(device), H, W)
    video = torch.cat([img_r[:, :, None], img_r.new_zeros(1, 3, args.num_frames - 1, H, W)], dim=2)
    img_lat = encode_image_video(vae, video, device)
    vae.encoder = vae.conv1 = None  # the decoder stays for the video
    del video
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the DiT last: the encoders' activations had the card to themselves
    model = WanModel(cfg, dtype=torch.bfloat16, device=device)
    model.load_state_dict(convert_wan_dit(load_dir(tdir), cfg))
    return model, ctx, ctx_null, clip_fea, img_lat, (H, W), make_vae_decoder(args, vae, logger)


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
    from sparse_videogen_tpu_torch.pipelines.wan import VAE_TEMPORAL, build_i2v_condition

    mesh, device = make_cli_mesh(args, resolve_device(args.device))
    rank = 0 if mesh is None else mesh.rank
    if args.prompt_source != "prompt":
        from sparse_videogen_tpu_torch.utils.dataloader import load_prompt_or_image

        args.prompt, args.image_path = load_prompt_or_image(args.prompt_source, args.prompt_idx, args.prompt,
                                                            args.image_path)
    flow_shift = 5.0 if args.resolution == "720p" else 3.0

    vae_decode = None
    args.model_dir = resolve_model_dir(args, logger)
    if args.smoke or args.model_dir is None:
        logger.warning("no --model_dir: running smoke generation with random weights")
        cfg = WanConfig(**SMOKE_CFG)
        model = WanModel(cfg, dtype=torch.bfloat16, device=device).init_random(
            torch.Generator(device=device).manual_seed(args.seed))
        rng = np.random.default_rng(args.seed)
        bf16 = dict(dtype=torch.bfloat16, device=device)
        ctx = torch.as_tensor(rng.standard_normal((1, cfg.text_len, cfg.text_dim)), **bf16)
        ctx_null = torch.zeros_like(ctx)
        H, W = 96, 128
        args.num_frames = min(args.num_frames, 9)
        args.num_inference_steps = min(args.num_inference_steps, 4)
        args.num_q_centroids = min(args.num_q_centroids, 8)
        args.num_k_centroids = min(args.num_k_centroids, 12)
        args.kmeans_iter_init = min(args.kmeans_iter_init, 8)
        clip_fea = torch.as_tensor(rng.standard_normal((1, 257, cfg.image_dim)), **bf16)
        f_lat = 1 + (args.num_frames - 1) // VAE_TEMPORAL
        img_lat = torch.as_tensor(rng.standard_normal((1, 16, f_lat, H // 8, W // 8)) * 0.1, dtype=torch.float32,
                                  device=device)
    else:
        model, ctx, ctx_null, clip_fea, img_lat, (H, W), vae_decode = _load_checkpoint(args, device)

    lat = WanPipeline(model).generate_latents(
        ctx, ctx_null,
        height=H, width=W, num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale, flow_shift=flow_shift,
        pattern=args.pattern,
        first_layers_fp=args.first_layers_fp, first_times_fp=args.first_times_fp,
        svg=SVGConfig(num_sampled_rows=args.num_sampled_rows, sample_mse_max_row=args.sample_mse_max_row,
                      sparsity=args.sparsity),
        sap=sap_config(args),
        seed=args.seed,
        logging_file=args.logging_file if rank == 0 else None,
        mesh=mesh,
        clip_fea=clip_fea,
        latent_cond=build_i2v_condition(img_lat),
    )
    if close_mesh(mesh) != 0:
        return
    if vae_decode is not None:
        from sparse_videogen_tpu_torch.pipelines.wan import export_video

        video = vae_decode(lat)
        out = args.output_file
        if not out.endswith(".y4m"):
            out = os.path.splitext(out)[0] + ".y4m"
        export_video(video, out, fps=16)
        logger.info(f"saved video {tuple(video.shape)} -> {out}")
    else:
        np.savez(args.output_file, latents=lat.cpu().numpy())
        logger.info(f"saved latents {tuple(lat.shape)} -> {args.output_file}")


if __name__ == "__main__":
    main()
