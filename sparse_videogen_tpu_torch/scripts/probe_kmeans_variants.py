"""Time the five variants of the wide-K k-means pass on one GPU (counterpart of
scripts/probe_kmeans_variants.py, which chose the TPU kernel's wide branch).

    python -m sparse_videogen_tpu_torch.scripts.probe_kmeans_variants [--iters 20]

The JAX probe's data: 12 centers (x 2.5) with 0.35 noise from numpy seed 0,
the same 75,600 tokens of width 128 in all 40 heads (Wan 2.1 14B at 720p),
bf16, and random normal centroids, K = 300 then 125. Each variant
(ops/kmeans.py: A argmin, B two-min, C two-min with product counts, D
multi-hot without labels, E assign only) runs on K5's kernels
(csrc/kmeans_lloyd.cu, the variant a template parameter of the assign; A is
K5's pass); ms per pass by CUDA events over --iters runs after --warmup; B
and C must equal A (labels, sums and counts, bit for bit).
Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from sparse_videogen_tpu_torch.ops.kmeans import VARIANTS, kmeans_variant_pass
from sparse_videogen_tpu_torch.scripts.timing import cuda_ms, device_line

SHAPE = (40, 75600, 128)
KS = (300, 125)


def make_inputs(B, N, D, ks, seed, device):
    """x (B, N, D) bf16 and {K: centroids (B, K, D) bf16}, drawn in the JAX probe's order."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((12, D)) * 2.5
    assign = rng.integers(0, 12, N)
    base = centers[assign] + 0.35 * rng.standard_normal((N, D))
    x = torch.as_tensor(base, dtype=torch.float32, device=device).to(torch.bfloat16).expand(B, N, D).contiguous()
    cents = {K: torch.as_tensor(rng.standard_normal((B, K, D)), dtype=torch.float32, device=device).to(torch.bfloat16)
             for K in ks}
    return x, cents


def probe(x, cents, *, iters, warmup):
    """Every variant at every K: rows {K, variant, ms, exact_match (B, C vs A)}.
    Launches each variant 1 + warmup + iters times."""
    rows = []
    for K, c in cents.items():
        ref = None
        for v in VARIANTS:
            out = kmeans_variant_pass(x, c, v)
            ms = cuda_ms(lambda: kmeans_variant_pass(x, c, v), iters, warmup)
            match = None
            if v == "A":
                ref = out
            elif v in ("B", "C"):
                match = all(torch.equal(a, b) for a, b in zip(out, ref))
            rows.append({"K": K, "variant": v, "ms": ms, "exact_match": match})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=2)
    args = ap.parse_args(argv)
    print(device_line("probe_kmeans_variants"), flush=True)
    x, cents = make_inputs(*SHAPE, KS, seed=0, device=torch.device("cuda", 0))
    rows = probe(x, cents, iters=args.iters, warmup=args.warmup)
    for r in rows:
        tag = "" if r["exact_match"] is None else ("  exact-match" if r["exact_match"] else "  MISMATCH")
        print(f"K={r['K']:4d} {r['variant']}: {r['ms']:.4f} ms/pass{tag}", flush=True)
    return rows


if __name__ == "__main__":
    main()
