"""Row RMSNorm bandwidth on one GPU: the Triton kernel (K6), its plain
PyTorch version and torch.nn.functional.rms_norm (counterpart of
scripts/bench_rmsnorm_pallas.py).

    python -m sparse_videogen_tpu_torch.scripts.bench_rmsnorm [--iters 20]

Shapes: the JAX probe's Wan 1.3B 480p block norm (75,600 x 1536) and its
qk-norm rows (12 x 75,600 x 128), plus HunyuanVideo 720p x 129's qk-norm
rows (24 heads x 119,056 tokens x 128). bf16 x, f32 weight, eps 1e-6. GB/s
counts one read of x and one write of the output (the weight is
negligible). F.rms_norm is a yardstick only: it multiplies by the weight
before rounding to bf16, so its bits differ from WanRMSNorm's (cast, then
weight). Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from sparse_videogen_tpu_torch.ops.rmsnorm import rms_norm_kernel, rms_norm_plain
from sparse_videogen_tpu_torch.scripts.timing import cuda_ms, device_line

SHAPES = {"wan-block-norm": (75600, 1536), "wan-qk-norm": (12 * 75600, 128), "hyvideo-qk-norm": (24 * 119056, 128)}
EPS = 1e-6


def make_inputs(shape, *, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
    w = torch.rand(shape[-1], generator=g, device=device) + 0.5
    return x, w


def probe(inputs, *, iters, warmup):
    """inputs {name: (x, w)} -> rows {name, shape, kernel_ms, plain_ms,
    library_ms, and GB/s of each}. Launches the kernel warmup + iters times
    a shape."""
    rows = []
    for name, (x, w) in inputs.items():
        gb = 2 * x.numel() * x.element_size() / 1e9
        wb = w.to(x.dtype)
        times = {"kernel_ms": cuda_ms(lambda: rms_norm_kernel(x, w, EPS), iters, warmup),
                 "plain_ms": cuda_ms(lambda: rms_norm_plain(x, w, EPS), iters, warmup),
                 "library_ms": cuda_ms(lambda: F.rms_norm(x, (x.shape[-1],), wb, EPS), iters, warmup)}
        rows.append({"name": name, "shape": tuple(x.shape), **times,
                     **{k.replace("_ms", "_gbs"): gb / (t * 1e-3) for k, t in times.items()}})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=2)
    args = ap.parse_args(argv)
    print(device_line("bench_rmsnorm"), flush=True)
    dev = torch.device("cuda", 0)
    rows = probe({n: make_inputs(s, seed=i, device=dev) for i, (n, s) in enumerate(SHAPES.items())},
                 iters=args.iters, warmup=args.warmup)
    for r in rows:
        print(f"{r['name']} {r['shape']} bf16: kernel {r['kernel_ms']:.4f} ms ({r['kernel_gbs']:.1f} GB/s), plain "
              f"{r['plain_ms']:.4f} ms ({r['plain_gbs']:.1f} GB/s), F.rms_norm {r['library_ms']:.4f} ms "
              f"({r['library_gbs']:.1f} GB/s; other rounding)", flush=True)
    return rows


if __name__ == "__main__":
    main()
