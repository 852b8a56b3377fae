"""Video quality metrics: per-frame MSE / PSNR / SSIM / perceptual (+ JSONL)
(counterpart of sparse_videogen_tpu/utils/metric.py, the same numpy and
scipy code, so the same floats bit for bit).

The always-available perceptual column is `lpips_rf` (utils/perceptual.py);
true LPIPS(alex) is reported when local weights are supplied
(utils/lpips_alex.py: $SVT_LPIPS_WEIGHTS or <repo>/weights/lpips_alex.npz).

    python -m sparse_videogen_tpu_torch.utils.metric a.y4m b.y4m [--output_jsonl out.jsonl] [--device cpu]
    python -m sparse_videogen_tpu_torch.utils.metric DIR   # mean of DIR/*.jsonl

The perceptual convolutions run on `--device` (default cuda, never falls
back); the JAX CLI's optional `lpips`-package column is not carried over.
"""

from __future__ import annotations

import json

import numpy as np


def mse(a, b):
    return float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))


def psnr(a, b, max_val: float = 1.0):
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val**2 / m))


def _gaussian_kernel(size=11, sigma=1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    k = np.outer(g, g)
    return k / k.sum()


def ssim(a, b, max_val: float = 1.0):
    """Single-channel or RGB (H, W[, C]) SSIM, gaussian window 11x1.5."""
    from scipy.signal import convolve2d

    if a.ndim == 3:
        return float(np.mean([ssim(a[..., c], b[..., c], max_val) for c in range(a.shape[-1])]))
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    k = _gaussian_kernel()
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    mu_a = convolve2d(a, k, mode="valid")
    mu_b = convolve2d(b, k, mode="valid")
    s_aa = convolve2d(a * a, k, mode="valid") - mu_a**2
    s_bb = convolve2d(b * b, k, mode="valid") - mu_b**2
    s_ab = convolve2d(a * b, k, mode="valid") - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * s_ab + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (s_aa + s_bb + c2)
    return float(np.mean(num / den))


def _frame_metrics(args):
    t, a, b, max_val = args
    return {"frame": t, "mse": mse(a, b), "psnr": psnr(a, b, max_val), "ssim": ssim(a, b, max_val)}


def video_metrics(video_a, video_b, *, max_val: float = 1.0, workers: int = 1):
    """(T, H, W, C) videos -> list of per-frame metric dicts + means.
    workers > 1 computes the frames in that many processes (scipy's
    convolve2d holds the GIL; a 720p frame takes seconds), with the same
    floats."""
    assert video_a.shape == video_b.shape, (video_a.shape, video_b.shape)
    jobs = ((t, video_a[t], video_b[t], max_val) for t in range(video_a.shape[0]))
    if workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            frames = list(ex.map(_frame_metrics, jobs))
    else:
        frames = [_frame_metrics(j) for j in jobs]
    mean = {
        k: float(np.mean([f[k] for f in frames])) for k in ("mse", "psnr", "ssim")
    }
    return frames, mean


def write_jsonl(path: str, frames, mean):
    with open(path, "w") as f:
        for fr in frames:
            f.write(json.dumps(fr) + "\n")
        f.write(json.dumps({"mean": mean}) + "\n")


def metrics_mean(dir_path: str) -> dict:
    """Mean of per-video metric JSONLs in a directory (the reference's
    svg/utils/metrics_get_mean.py over metric.py outputs)."""
    import glob
    import os

    means = []
    for p in sorted(glob.glob(os.path.join(dir_path, "*.jsonl"))):
        with open(p) as f:
            for line in f:
                d = json.loads(line)
                if "mean" in d:
                    means.append(d["mean"])
    if not means:
        return {}
    keys = means[0].keys()
    return {k: float(np.mean([m[k] for m in means])) for k in keys}


def main(argv=None):
    """CLI: compare two videos (.y4m or .npz/.npy), print + optionally write
    JSONL. With one directory argument, aggregate means instead."""
    import argparse
    import os
    import sys

    from sparse_videogen_tpu_torch.cli._common import add_device, resolve_device
    from sparse_videogen_tpu_torch.io.native import load_video

    p = argparse.ArgumentParser("metric")
    p.add_argument("video_a")
    p.add_argument("video_b", nargs="?", default=None)
    p.add_argument("--output_jsonl", default=None)
    add_device(p)
    args = p.parse_args(argv)

    if args.video_b is None:
        assert os.path.isdir(args.video_a), "single arg must be a JSONL dir"
        print(json.dumps(metrics_mean(args.video_a)))
        return

    device = resolve_device(args.device)
    a = load_video(args.video_a)
    b = load_video(args.video_b)
    t = min(a.shape[0], b.shape[0])
    frames, mean = video_metrics(a[:t], b[:t])
    if a.shape[-1] == 3:
        from sparse_videogen_tpu_torch.utils.lpips_alex import load_lpips_weights, lpips_alex
        from sparse_videogen_tpu_torch.utils.perceptual import lpips_rf

        mean["lpips_rf"] = lpips_rf(a[:t], b[:t], device=device)
        try:
            w = load_lpips_weights()
            if w is not None:
                mean["lpips"] = lpips_alex(a[:t], b[:t], w, device=device)
        except Exception as e:  # bad $SVT_LPIPS_WEIGHTS must not kill the CLI
            print(f"[metric] lpips weights unusable ({e}); reporting lpips_rf only", file=sys.stderr)
    print(json.dumps({"mean": mean}))
    if args.output_jsonl:
        write_jsonl(args.output_jsonl, frames, mean)


if __name__ == "__main__":
    main()
