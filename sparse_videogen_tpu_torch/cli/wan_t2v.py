"""Wan 2.1 T2V generation CLI (counterpart of sparse_videogen_tpu/cli/wan_t2v.py).

The flags are the JAX CLI's, by name and default (the port declares its own
parser), plus `--device`, since PyTorch needs one named. There is no
fallback to the CPU: `--device cuda` on a host without a card fails.

What runs today is the random-weight path that the JAX CLI takes without
`--model_dir` (`--smoke`, or no checkpoint): a tiny Wan at a reduced size,
denoised with dense, SVG1 or SAP (cluster mode) attention, latents written
to an `.npz`; `--logging_file` takes SAP's density log. `--ring_degree N`
runs dense or SAP attention token-sharded over N ranks, one process a rank
under torchrun (gloo with `--device cpu`, NCCL on cards); rank 0 writes the
outputs. The other parallel flags (--dp, --ulysses_degree, --dit_fsdp) raise.
Checkpoints (`--model_dir`), the UMT5 text encoder and the VAE decode to a
video are not ported yet (ROADMAP.md) and raise NotImplementedError.

Usage:
  python -m sparse_videogen_tpu_torch.cli.wan_t2v --smoke --pattern SAP \
      --device cuda --output_file out.npz
  torchrun --nproc_per_node 2 -m sparse_videogen_tpu_torch.cli.wan_t2v --smoke \
      --pattern dense --ring_degree 2 --device cpu --output_file out.npz
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from sparse_videogen_tpu_torch.cli._common import add_device, add_model_id, add_vae_tiling_flags, resolve_device

logger = logging.getLogger("sparse_videogen_tpu_torch")

# the JAX CLI's --smoke model (cli/wan_t2v.py there)
SMOKE_CFG = dict(dim=256, ffn_dim=512, num_heads=4, num_layers=4, freq_dim=64, text_dim=64, text_len=16)


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
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--ulysses_degree", type=int, default=1)
    p.add_argument("--ring_degree", type=int, default=1)
    p.add_argument("--dit_fsdp", action="store_true")
    p.add_argument("--smoke", action="store_true", help="tiny random-weight run (no checkpoints needed)")
    p.add_argument("--use_fp8", action="store_true")
    p.add_argument("--quant", choices=["none", "fp8", "int8"], default=None)
    return add_device(p)


def _unported(args) -> str | None:
    if args.model_dir or (args.model_id and os.path.isdir(args.model_id)):
        return "--model_dir (checkpoint conversion, UMT5, Wan VAE)"
    if not args.output_file.endswith(".npz"):
        return "video output (the Wan VAE decode); write latents to a .npz"
    if args.quant not in (None, "none") or args.use_fp8:
        return "--quant / --use_fp8"
    if args.dp * args.ulysses_degree > 1 or args.dit_fsdp:
        return "--dp / --ulysses_degree / --dit_fsdp (data, Ulysses and FSDP parallelism)"
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

    device = resolve_device(args.device)
    mesh, rank = None, 0
    if args.ring_degree > 1:
        from sparse_videogen_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(args.ring_degree, device_type=device.type)
        rank = mesh.comm.rank
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
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
        logging_file=args.logging_file if rank == 0 else None,
        mesh=mesh,
    )
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    if rank == 0:
        np.savez(args.output_file, latents=lat.cpu().numpy())
        logger.info(f"saved latents {tuple(lat.shape)} -> {args.output_file}")


if __name__ == "__main__":
    main()
