"""Flag groups and helpers the CLIs share (the JAX package's cli/_common.py:
its flags by name and default, `resolve_model_dir` and `make_vae_decoder`),
plus `--device`. A flag whose path a CLI has not ported raises
NotImplementedError there."""

from __future__ import annotations

import os


def add_model_id(p, default: str):
    p.add_argument("--model_id", type=str, default=None,
                   help=f"HF repo id (reference default {default}; no downloads) or a local checkpoint dir "
                        "(used as --model_dir)")
    return p


def resolve_model_dir(args, logger=None):
    """Fold --model_id into --model_dir: a local dir is used; a repo id cannot
    be downloaded here, so it is noted and the run takes the smoke path."""
    if getattr(args, "model_dir", None):
        return args.model_dir
    mid = getattr(args, "model_id", None)
    if mid and os.path.isdir(mid):
        if logger is not None:
            logger.info(f"--model_id is a local dir; using it as --model_dir: {mid}")
        return mid
    if mid and logger is not None and not getattr(args, "smoke", False):
        logger.warning(f"--model_id {mid!r} is an HF repo id and nothing is downloaded: convert the checkpoint "
                       "locally and pass --model_dir. Falling back to smoke generation.")
    return None


def add_vae_tiling_flags(p):
    p.add_argument("--vae_tiling", type=str, default="auto", choices=["auto", "on", "off"],
                   help="auto tiles when a latent frame exceeds 64x64")
    p.add_argument("--vae_tile", type=int, default=32, help="latent tile edge (pixels = 8x)")
    p.add_argument("--vae_tile_overlap", type=int, default=8, help="latent overlap blended between adjacent tiles")
    p.add_argument("--vae_stream_chunk", type=int, default=0,
                   help="decode in N-latent-frame streamed chunks with a per-conv cache (0 = whole sequence)")
    return p


def make_vae_decoder(args, vae, logger):
    """latents -> video through `vae` (models/wan/vae.WanVAE or
    models/hyvideo/vae.HyVideoVAE), honouring --vae_tiling (auto: tiles
    when a latent frame exceeds 64x64), --vae_tile, --vae_tile_overlap and
    --vae_stream_chunk (the Wan VAE's streamed decode, composes with tiling;
    a VAE without one warns and decodes the whole sequence, as the JAX
    CLIs do)."""
    from sparse_videogen_tpu_torch.models.common.vae_tiling import spatial_tiled_decode

    mode, tile, overlap, stream = args.vae_tiling, args.vae_tile, args.vae_tile_overlap, args.vae_stream_chunk
    if stream and not hasattr(vae, "decode_streamed"):
        logger.warning(f"--vae_stream_chunk: {type(vae).__name__} has no streamed decode; decoding the whole sequence")
        stream = 0
    scale = getattr(vae.cfg, "spatial_compression", 8)

    def run(z):
        return vae.decode_streamed(z, chunk=stream) if stream else vae.decode(z)

    def decode(z):
        h, w = z.shape[-2], z.shape[-1]
        if mode == "on" or (mode == "auto" and h * w > 64 * 64):
            logger.info(f"VAE decode: spatial tiling (latent {h}x{w}, tile={tile}, overlap={overlap}"
                        + (f", streamed chunk={stream}" if stream else "") + ")")
            return spatial_tiled_decode(run, z, tile=tile, overlap=overlap, scale=scale)
        return run(z)

    return decode


def sap_config(args, *, pass_zero_step: bool = True):
    """SAPConfig from the SAP flags, as the JAX CLIs build it: tile mode
    (--sap_block_mode tile) takes presets.tile_variant's block sizes, which
    are also its tile grain; cluster mode keeps SAPConfig's block sizes.
    With pass_zero_step False, --zero_step_kmeans_init is dropped and stays
    False, as the JAX HunyuanVideo CLI builds its SAPConfig (the Wan CLIs
    pass it)."""
    from sparse_videogen_tpu_torch.config import SAPConfig
    from sparse_videogen_tpu_torch.presets import tile_variant

    sap = SAPConfig(num_q_centroids=args.num_q_centroids, num_k_centroids=args.num_k_centroids,
                    top_p_kmeans=args.top_p_kmeans, min_kc_ratio=args.min_kc_ratio,
                    kmeans_iter_init=args.kmeans_iter_init, kmeans_iter_step=args.kmeans_iter_step,
                    zero_step_kmeans_init=pass_zero_step and args.zero_step_kmeans_init)
    return tile_variant(sap) if args.sap_block_mode == "tile" else sap


def video_name(path: str) -> str:
    """The file a video goes to: an .npz name becomes .y4m."""
    return path[: -len(".npz")] + ".y4m" if path.endswith(".npz") else path


def skip_existing(path: str) -> bool:
    """--skip_existing: the output, or the .y4m an .npz name becomes, exists."""
    for p in {path, video_name(path)}:
        if os.path.exists(p):
            print(f"output {p} exists; skipping generation")
            return True
    return False


def encode_t5_prompts(model_dir: str, prompts, *, text_len: int, default_cfg, mask_output: bool, device):
    """The prompts through a T5 encoder in HF's names (text_encoder/ of
    model_dir: io/encoders.T5TextEncoder, freed after) -> bf16 states (1,
    text_len, dim) each, as the JAX CLIs hand them to the DiT."""
    import torch

    from sparse_videogen_tpu_torch.io.encoders import T5TextEncoder

    enc = T5TextEncoder.from_dir(model_dir, text_len=text_len, default_cfg=default_cfg, mask_output=mask_output,
                                 device=device)
    out = [enc([p]).to(torch.bfloat16) for p in prompts]
    del enc
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def quantize_blocks(args, *block_lists, logger) -> None:
    """--quant fp8|int8 (or --use_fp8 without --quant): swap the linears of
    the given block lists (utils/quant.py, JAX's min_size over the stacked
    size) in place, and log the JAX CLIs' line."""
    quant = args.quant or ("fp8" if args.use_fp8 else "none")
    if quant == "none":
        return
    from sparse_videogen_tpu_torch.utils.quant import quantize_linears_fp8, quantize_linears_int8

    qfn = quantize_linears_int8 if quant == "int8" else quantize_linears_fp8
    for blocks in block_lists:
        qfn(blocks)
    logger.info(f"{quant}: block linears quantized "
                f"({'W8A8 int8 matmuls' if quant == 'int8' else 'e4m3 + per-layer scales'})")


def add_device(p):
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu); never falls back")
    return p


def resolve_device(name: str):
    """torch.device(name); a CUDA device without a card raises."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device
