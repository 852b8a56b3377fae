"""Wan 2.1 T2V generation CLI (counterpart of sparse_videogen_tpu/cli/wan_t2v.py).

The flags are the JAX CLI's own (`build_parser`), plus `--device`, since
PyTorch needs one named. There is no fallback to the CPU: `--device cuda` on
a host without a card fails.

What runs today is the random-weight path that the JAX CLI takes without
`--model_dir` (`--smoke`, or no checkpoint): a tiny Wan at a reduced size,
denoised with dense, SVG1 or SAP (cluster mode) attention, latents written
to an `.npz`; `--logging_file` takes SAP's density log.
Checkpoints (`--model_dir`), the UMT5 text encoder and the VAE decode to a
video are not ported yet (ROADMAP.md) and raise NotImplementedError.

Usage:
  python -m sparse_videogen_tpu_torch.cli.wan_t2v --smoke --pattern SAP \
      --device cuda --output_file out.npz
"""

from __future__ import annotations

import logging
import os

import numpy as np

from sparse_videogen_tpu.cli.wan_t2v import build_parser as _jax_parser

logger = logging.getLogger("sparse_videogen_tpu_torch")

# the JAX CLI's --smoke model (cli/wan_t2v.py there)
SMOKE_CFG = dict(dim=256, ffn_dim=512, num_heads=4, num_layers=4, freq_dim=64, text_dim=64, text_len=16)


def build_parser():
    p = _jax_parser()
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu); never falls back")
    return p


def _unported(args) -> str | None:
    if args.model_dir or (args.model_id and os.path.isdir(args.model_id)):
        return "--model_dir (checkpoint conversion, UMT5, Wan VAE)"
    if not args.output_file.endswith(".npz"):
        return "video output (the Wan VAE decode); write latents to a .npz"
    if args.quant not in (None, "none") or args.use_fp8:
        return "--quant / --use_fp8"
    if args.dp * args.ulysses_degree * args.ring_degree > 1 or args.dit_fsdp:
        return "multi-device parallelism"
    if args.prompt_source != "prompt":
        return "--prompt_source (prompts need the UMT5 encoder)"
    if args.sap_block_mode != "cluster":
        return f"--sap_block_mode {args.sap_block_mode} (SAP tile mode)"
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

    from sparse_videogen_tpu_torch.config import SAPConfig, SVGConfig
    from sparse_videogen_tpu_torch.models.wan.model import WanConfig, WanModel
    from sparse_videogen_tpu_torch.pipelines import WanPipeline

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")
    if args.flow_shift is None:
        args.flow_shift = 5.0 if args.height >= 720 else 3.0

    logger.warning("no --model_dir: running smoke generation with random weights")
    cfg = WanConfig(**SMOKE_CFG)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = WanModel(cfg, dtype=torch.bfloat16, device=device).init_random(gen)
    rng = np.random.default_rng(args.seed)
    ctx = torch.as_tensor(rng.standard_normal((1, cfg.text_len, cfg.text_dim)), dtype=torch.bfloat16, device=device)
    ctx_null = torch.zeros_like(ctx)
    args.height, args.width = min(args.height, 96), min(args.width, 128)
    args.num_frames = min(args.num_frames, 9)
    args.num_inference_steps = min(args.num_inference_steps, 4)
    args.num_q_centroids = min(args.num_q_centroids, 8)
    args.num_k_centroids = min(args.num_k_centroids, 12)
    args.kmeans_iter_init = min(args.kmeans_iter_init, 8)

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
        sap=SAPConfig(num_q_centroids=args.num_q_centroids, num_k_centroids=args.num_k_centroids,
                      top_p_kmeans=args.top_p_kmeans, min_kc_ratio=args.min_kc_ratio,
                      kmeans_iter_init=args.kmeans_iter_init, kmeans_iter_step=args.kmeans_iter_step,
                      zero_step_kmeans_init=args.zero_step_kmeans_init),
        seed=args.seed,
        logging_file=args.logging_file,
    )
    np.savez(args.output_file, latents=lat.cpu().numpy())
    logger.info(f"saved latents {tuple(lat.shape)} -> {args.output_file}")


if __name__ == "__main__":
    main()
