"""Flag groups the CLIs share (the JAX package's cli/_common.py flags, by
name and default). Only the flags are declared here: what they drive beyond
the random-weight smoke path is not ported yet, and each CLI raises
NotImplementedError when such a flag is set."""

from __future__ import annotations


def add_model_id(p, default: str):
    p.add_argument("--model_id", type=str, default=None,
                   help=f"HF repo id (reference default {default}; no downloads) or a local checkpoint dir "
                        "(used as --model_dir)")
    return p


def add_vae_tiling_flags(p):
    p.add_argument("--vae_tiling", type=str, default="auto", choices=["auto", "on", "off"])
    p.add_argument("--vae_tile", type=int, default=32, help="latent tile edge (pixels = 8x)")
    p.add_argument("--vae_tile_overlap", type=int, default=8, help="latent overlap blended between adjacent tiles")
    p.add_argument("--vae_stream_chunk", type=int, default=0,
                   help="decode in N-latent-frame streamed chunks (0 = whole sequence)")
    return p


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
