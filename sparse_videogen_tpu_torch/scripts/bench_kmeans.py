"""Time K5, the k-means Lloyd pass (ops/kmeans.kmeans_assign_update), on one
GPU at the SAP configurations' shapes, and split its device time by launch.

    python -m sparse_videogen_tpu_torch.scripts.bench_kmeans [--iters 10] [--out km.json]

Cases: Wan 2.1 14B 720p (40 heads, 75,600 tokens, D = 128; K = 300, the q
clusters, and 1000, the k clusters) and Wan 2.1 1.3B 480p (12 heads of one
CFG stream, 32,760 tokens; K = 50 and 200), bf16 tokens from a seed and
centroids drawn from them. For each: ms per pass by CUDA events (mean over
--iters after a warm-up), the bound (x . c^T over the bf16 tensor-core peak,
or the bytes read and written once over the memory rate, the larger), and
one torch.profiler run of --iters passes giving each kernel's device ms per
pass (the split between the pass's launches). Uses only the public wrapper,
so the same file runs against an older tree. Prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import collections
import json

import torch

from sparse_videogen_tpu_torch.core.kmeans import init_centroids
from sparse_videogen_tpu_torch.ops.kmeans import kmeans_assign_update
from sparse_videogen_tpu_torch.scripts.timing import cuda_ms, device_line

# (B, N, D, K, seed): the 14B 720p SAP config's QC 300 / KC 1000, the 1.3B 480p CLI defaults' QC 50 / KC 200
CASES = ((40, 75600, 128, 1000, 6), (40, 75600, 128, 300, 6), (12, 32760, 128, 200, 4), (12, 32760, 128, 50, 4))
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def bound_ms(B, N, D, K) -> float:
    """x . c^T (2 B N K D FLOPs) against x and c read, labels, sums, counts written once."""
    flops = 2.0 * B * N * K * D
    nbytes = B * N * D * 2 + B * K * D * 2 + B * N * 4 + B * K * D * 4 + B * K * 4
    return 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def split(fn, iters):
    """{kernel name: device ms per pass} over `iters` passes of fn under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = collections.defaultdict(float)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            per[e.name()] += (e.end_ns() - e.start_ns()) / 1e6 / iters
    if not per:
        raise RuntimeError("torch.profiler recorded no device activity")
    return dict(per)


def bench(dev, iters):
    rows = []
    xs = {}
    for B, N, D, K, seed in CASES:
        if (B, N, D, seed) not in xs:
            xs.clear()
            torch.cuda.empty_cache()
            gen = torch.Generator(device=dev).manual_seed(seed)
            xs[(B, N, D, seed)] = (torch.randn(B, N, D, generator=gen, device=dev).to(torch.bfloat16), gen)
        x, gen = xs[(B, N, D, seed)]
        c = init_centroids(x, K, gen)
        fn = lambda: kmeans_assign_update(x, c)
        ms = cuda_ms(fn, iters, 1)
        kernels = split(fn, iters)
        rows.append({"B": B, "N": N, "D": D, "K": K, "ms": ms, "bound_ms": bound_ms(B, N, D, K), "kernels_ms": kernels})
        print(f"kmeans (B={B}, N={N}, D={D}, K={K}) bf16: {ms:.4f} ms a pass, bound {rows[-1]['bound_ms']:.4f} ms "
              f"({100 * rows[-1]['bound_ms'] / ms:.1f}%); by launch: "
              + ", ".join(f"{n} {t:.4f} ms ({100 * t / sum(kernels.values()):.1f}%)"
                          for n, t in sorted(kernels.items(), key=lambda kv: -kv[1])), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    args = ap.parse_args(argv)
    line = device_line("bench_kmeans")
    print(line, flush=True)
    rows = bench(torch.device("cuda", 0), args.iters)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": line, "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
