"""Dense against sparse quality of the port on one card (counterpart of the
JAX package's scripts/quality_evidence.py, its recipe through the port's
public WanPipeline.generate_latents).

Wan 2.1 1.3B at full width and depth in bf16, 720x1280x81, 8 UniPC steps
(guidance 5.0, flow shift 3.0: the pipeline's defaults), from i.i.d.
latents of seed 0 and text states (1, 512, 4096) drawn from two fixed
seeds. The checkpoint is structured-synthetic: random weights from seed 0,
then every self-attention's K := Q and its q norm x 4.0
(utils/organic.align_self_attn_qk), so the profiler and k-means face real
decisions. Patterns, all from the same noise: dense (the oracle); SVG1 at
sparsity 0.25 with 64 sampled rows, first_layers_fp 0.025, first_times_fp
0.075; SAP in cluster mode and in tile mode (sap_cluster, sap_tile) at QC
300, KC 125, top_p 0.9, min_kc_ratio 0.10, block_q = block_kv = 512 (tile
mode's tile grain), 50 cold / 1 warm k-means iterations, first_layers_fp
0.03, first_times_fp 0.2 (the JAX script's values, its --sap_block_mode
both); dense_int8: dense on a copy of the model whose block linears are
int8 W8A8 (utils/quant.quantize_linears_int8, as the JAX script quantizes
params["blocks"]).

Latent metrics as the JAX script computes them: PSNR with max_val the
dense latents' max |x|, SSIM per latent frame with the channels folded
into the width (max_val twice that). SAP's density is the mean of its
density log (cond stream, every sparse layer-step). Pixel metrics: each
latent decoded by a random Wan VAE (seed 1) through the CLI's default
decoder (--vae_tiling auto: tiled at 720p; cuDNN TF32 as torch leaves it,
on), then video_metrics (PSNR, SSIM) and lpips_rf on [0, 1] frames. Only
the latent PSNRs are gated: SVG1 and dense_int8 >= 35 dB and each SAP
mode >= 24 dB; a miss exits 1.

    python -m sparse_videogen_tpu_torch.scripts.quality --out QUALITY_torch.json
    python -m sparse_videogen_tpu_torch.scripts.quality --smoke --device cpu --out q.json

--smoke: a tiny model (dim 128, 2 heads, 2 layers) at 96x160x9 and a tiny
VAE. There is no fallback to the CPU: --device cuda (the default) fails
without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STEPS = 8
SIZE = (720, 1280, 81)
SMOKE_SIZE = (96, 160, 9)
GAIN = 4.0
# seeds, fixed once: the model, the cond and uncond text states, the VAE, the noise
MODEL_SEED, CTX_SEED, CTX_NULL_SEED, VAE_SEED, NOISE_SEED = 0, 2, 3, 1, 0
MIN_PSNR, SAP_MIN_PSNR = 35.0, 24.0


def recipe(smoke: bool = False):
    """(WanConfig, (height, width, frames), {name: generate_latents kwargs})."""
    from sparse_videogen_tpu_torch.config import SAPConfig, SVGConfig
    from sparse_videogen_tpu_torch.models.wan.model import WAN_1_3B

    cfg = WAN_1_3B
    size = SIZE
    sap = SAPConfig(num_q_centroids=300, num_k_centroids=125, top_p_kmeans=0.9, min_kc_ratio=0.10, block_q=512,
                    block_kv=512, kmeans_iter_init=50, kmeans_iter_step=1, block_mode="cluster")
    if smoke:
        cfg = dataclasses.replace(cfg, dim=128, ffn_dim=256, num_heads=2, num_layers=2, text_len=16, text_dim=64)
        size = SMOKE_SIZE
        sap = dataclasses.replace(sap, num_q_centroids=8, num_k_centroids=12, block_q=128, kmeans_iter_init=4)
    patterns = {
        "dense": dict(pattern="dense", first_layers_fp=0.0, first_times_fp=0.0),
        "svg1": dict(pattern="SVG", svg=SVGConfig(sparsity=0.25, num_sampled_rows=64), first_layers_fp=0.025,
                     first_times_fp=0.075),
        "sap_cluster": dict(pattern="SAP", sap=sap, first_layers_fp=0.03, first_times_fp=0.2),
        "sap_tile": dict(pattern="SAP", sap=dataclasses.replace(sap, block_mode="tile"), first_layers_fp=0.03,
                         first_times_fp=0.2),
        "dense_int8": dict(pattern="dense", first_layers_fp=0.0, first_times_fp=0.0, quant="int8"),
    }
    return cfg, size, patterns


def make_inputs(cfg, device):
    """The structured-synthetic bf16 model and the (cond, uncond) text states."""
    import torch

    from sparse_videogen_tpu_torch.models.wan.model import WanModel
    from sparse_videogen_tpu_torch.utils.organic import align_self_attn_qk

    model = WanModel(cfg, dtype=torch.bfloat16, device=device)
    model.init_random(torch.Generator(device=device).manual_seed(MODEL_SEED))
    align_self_attn_qk(model, gain=GAIN)
    ctx = [torch.randn(1, cfg.text_len, cfg.text_dim, generator=torch.Generator(device=device).manual_seed(s),
                       device=device).to(torch.bfloat16) for s in (CTX_SEED, CTX_NULL_SEED)]
    return model, ctx[0], ctx[1]


def generate(model, ctx, ctx_null, size, kw, *, callback=None, logging_file=None):
    """One pattern's STEPS-step generation through WanPipeline.generate_latents;
    kw's "quant": "int8" runs it on a copy of the model with int8 block
    linears."""
    import copy

    from sparse_videogen_tpu_torch.pipelines import WanPipeline
    from sparse_videogen_tpu_torch.utils.quant import quantize_linears_int8

    kw = dict(kw)
    if kw.pop("quant", None) == "int8":
        model = copy.deepcopy(model)
        quantize_linears_int8(model.blocks)
    h, w, f = size
    return WanPipeline(model).generate_latents(ctx, ctx_null, height=h, width=w, num_frames=f,
                                               num_inference_steps=STEPS, seed=NOISE_SEED, callback=callback,
                                               logging_file=logging_file, **kw)


def frames_of(x):
    """(1, C, F, H, W) latents -> (F, H, W*C) frames for SSIM."""
    _, C, Fl, Hl, Wl = x.shape
    return x[0].transpose(1, 2, 3, 0).reshape(Fl, Hl, Wl * C)


def latent_metrics(dense: np.ndarray, x: np.ndarray) -> dict:
    """PSNR (max_val = max |dense|) and the mean SSIM of the latent frames
    (max_val twice that), as the JAX script computes them."""
    from sparse_videogen_tpu_torch.utils.metric import psnr, ssim

    max_val = float(np.max(np.abs(dense)))
    fd, fx = frames_of(dense), frames_of(x)
    return {"latent_psnr_db": psnr(dense, x, max_val=max_val),
            "latent_ssim": float(np.mean([ssim(fd[t], fx[t], max_val=2 * max_val) for t in range(fd.shape[0])]))}


def density_mean(path: str) -> float:
    with open(path) as f:
        return float(np.mean([json.loads(line)["avg_density"] for line in f]))


def to_frames(video) -> np.ndarray:
    """(1, 3, T, H, W) in [-1, 1] -> (T, H, W, 3) float32 in [0, 1], as the
    metric CLI's load_video maps a [-1, 1] array."""
    v = video[0].float().cpu().numpy().transpose(1, 2, 3, 0)
    return np.clip((v + 1.0) / 2.0, 0.0, 1.0)


def source_hash() -> str:
    """sha256 (16 hex digits) over the port's sources, path and bytes, in
    path order: the tree a result came from, where no git is at hand."""
    h = hashlib.sha256()
    pkg = os.path.join(REPO, "sparse_videogen_tpu_torch")
    for root, _, files in sorted(os.walk(pkg)):
        for name in sorted(files):
            if name.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, name)
                h.update(os.path.relpath(path, REPO).encode() + b"\0")
                with open(path, "rb") as f:
                    h.update(f.read())
    return h.hexdigest()[:16]


def git_commit() -> str | None:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True, text=True, timeout=30)
    except OSError:
        return None
    return out.stdout.strip() or None


def card() -> str | None:
    """nvidia-smi's name and power limit of the first card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except OSError:
        return None
    return (out.stdout.strip().splitlines() or [None])[0]


def build_parser():
    from sparse_videogen_tpu_torch.cli._common import add_device

    p = argparse.ArgumentParser("quality")
    p.add_argument("--workers", type=int, default=min(8, os.cpu_count() or 1),
                   help="processes for the pixel SSIM (scipy, on the host)")
    p.add_argument("--commit", type=str, default=None, help="the commit to record (default: git rev-parse HEAD)")
    p.add_argument("--out", default=os.path.join(REPO, "QUALITY_torch.json"))
    p.add_argument("--smoke", action="store_true", help="tiny model and shapes (path validation)")
    return add_device(p)


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from sparse_videogen_tpu_torch.cli._common import make_vae_decoder, resolve_device
    from sparse_videogen_tpu_torch.cli.wan_t2v import SMOKE_VAE_CFG
    from sparse_videogen_tpu_torch.cli.wan_t2v import build_parser as cli_parser
    from sparse_videogen_tpu_torch.models.wan.vae import WanVAE, WanVAEConfig
    from sparse_videogen_tpu_torch.utils.metric import video_metrics
    from sparse_videogen_tpu_torch.utils.perceptual import lpips_rf

    device = resolve_device(args.device)
    cuda = device.type == "cuda"

    def log(msg):
        print(f"[quality] {msg}", file=sys.stderr, flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg, size, patterns = recipe(args.smoke)
    model, ctx, ctx_null = make_inputs(cfg, device)
    report = {
        "config": {"model": "wan_1.3B" + (" (smoke: dim 128, 2 heads, 2 layers)" if args.smoke else ""),
                   "height": size[0], "width": size[1], "frames": size[2], "steps": STEPS, "dtype": "bfloat16",
                   "checkpoint": f"structured-synthetic (random weights, seed {MODEL_SEED}; K:=Q, gain {GAIN})",
                   "seeds": {"model": MODEL_SEED, "ctx": CTX_SEED, "ctx_null": CTX_NULL_SEED, "vae": VAE_SEED,
                             "noise": NOISE_SEED},
                   "patterns": {k: {n: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
                                    for n, v in kw.items()} for k, kw in patterns.items()}},
        "device": {"torch": torch.__version__, "cuda": torch.version.cuda,
                   "name": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "nvidia_smi": card() if cuda else None},
        "source": {"commit": args.commit or git_commit(), "source_sha256_16": source_hash()},
        "metrics": {},
    }
    lat, seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, kw in patterns.items():
            marks = []
            dlog = os.path.join(tmp, f"{name}.jsonl")

            def on_step(i, x):
                sync()
                marks.append(time.perf_counter())

            sync()
            t0 = time.perf_counter()
            out = generate(model, ctx, ctx_null, size, kw, callback=on_step,
                           logging_file=dlog if kw["pattern"] == "SAP" else None)
            steps = np.diff([t0] + marks)
            lat[name] = out.float().cpu().numpy()
            seconds[name] = {"per_step_s": [float(s) for s in steps], "total_s": float(marks[-1] - t0)}
            if kw["pattern"] == "SAP":
                seconds[name]["density_mean"] = density_mean(dlog)
            log(f"{name}: {seconds[name]['total_s']:.2f} s, per step {[round(float(s), 3) for s in steps]}")
    report["config"]["latent_max_abs"] = float(np.max(np.abs(lat["dense"])))
    report["seconds"] = seconds
    for name in patterns:
        if name == "dense":
            continue
        m = latent_metrics(lat["dense"], lat[name])
        if "density_mean" in seconds[name]:
            m["density"] = seconds[name]["density_mean"]
        report["metrics"][name] = m
        log(f"dense vs {name}: latent PSNR {m['latent_psnr_db']:.3f} dB, SSIM {m['latent_ssim']:.5f}")

    del model
    if cuda:
        torch.cuda.empty_cache()
    vae = WanVAE(WanVAEConfig(**SMOKE_VAE_CFG) if args.smoke else WanVAEConfig(), device=device)
    vae.init_random(torch.Generator(device=device).manual_seed(VAE_SEED))
    decode = make_vae_decoder(cli_parser().parse_args([]), vae, logging.getLogger("sparse_videogen_tpu_torch"))
    px = {}
    with torch.no_grad():
        for name, x in lat.items():
            sync()
            t0 = time.perf_counter()
            px[name] = to_frames(decode(torch.as_tensor(x, device=device)))
            seconds[name]["decode_s"] = time.perf_counter() - t0
    del vae
    for name in patterns:
        if name == "dense":
            continue
        t0 = time.perf_counter()
        _, mean = video_metrics(px["dense"], px[name], workers=args.workers)
        t_ssim = time.perf_counter() - t0
        t0 = time.perf_counter()
        lp = lpips_rf(px["dense"], px[name], device=device)
        report["metrics"][name].update(pixel_psnr_db=mean["psnr"], pixel_ssim=mean["ssim"], pixel_mse=mean["mse"],
                                       lpips_rf=lp)
        seconds[name].update(pixel_metrics_s=t_ssim, lpips_rf_s=time.perf_counter() - t0)
        log(f"dense vs {name}: pixel PSNR {mean['psnr']:.3f} dB, SSIM {mean['ssim']:.5f}, lpips_rf {lp:.5f} "
            f"({t_ssim:.1f} s for the frame metrics, {args.workers} processes)")
    report["config"]["pixel_frames"] = list(px["dense"].shape)

    svg_db = report["metrics"]["svg1"]["latent_psnr_db"]
    int8_db = report["metrics"]["dense_int8"]["latent_psnr_db"]
    sap_dbs = [m["latent_psnr_db"] for name, m in report["metrics"].items() if name.startswith("sap")]
    report["gate"] = {"min_psnr_db": MIN_PSNR, "sap_min_psnr_db": SAP_MIN_PSNR,
                      "svg1_pass": bool(svg_db >= MIN_PSNR), "sap_pass": bool(min(sap_dbs) >= SAP_MIN_PSNR),
                      "int8_pass": bool(int8_db >= MIN_PSNR),
                      "sap_block_mode": "both", "pixel": "not gated (the VAE's weights are random)"}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    gate = report["gate"]
    if not args.smoke and not (gate["svg1_pass"] and gate["sap_pass"] and gate["int8_pass"]):
        sys.exit(1)


if __name__ == "__main__":
    main()
