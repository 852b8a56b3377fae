"""The fused f32 LayerNorm + AdaLN modulation on one GPU: the kernel
(csrc/layernorm_mod.cu) beside its plain version, the eager expression the
models ran before it, at the shapes of the benchmark's cells.

    python -m sparse_videogen_tpu_torch.scripts.bench_layernorm_mod [--iters 20] [--out f.json]

Shapes: Wan 2.1 1.3B 480p x 81 on the CFG pair (2 x 32,760 x 1536; the
modulation vectors rows of the (B, 6, d) table, and norm3's (d,) weight and
bias), HunyuanVideo 720p x 129's video stream (118,800 x 3072), its text
stream (256 x 3072) and the final layer's video slice of [video | text]
(119,056 tokens), Wan 14B 720p x 81 on the CFG pair (2 x 75,600 x 5120).
bf16 x, f32 vectors, eps 1e-6. GB/s and the bound count one bf16 read of x
and one bf16 write of the output (the vectors are a row each); the bound is
those bytes at 3.35 TB/s. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json

import torch

from sparse_videogen_tpu_torch.ops.layernorm_mod import layernorm_mod, layernorm_mod_plain
from sparse_videogen_tpu_torch.scripts.timing import cuda_ms, device_line

# name -> (B, S, d, S of the sequence x is sliced from, vectors "Bd" (rows of a (B, 6, d) table) or "d")
SHAPES = {"wan-480p-cfg": (2, 32760, 1536, 32760, "Bd"), "wan-480p-norm3": (2, 32760, 1536, 32760, "d"),
          "hyvideo-720p-img": (1, 118800, 3072, 118800, "Bd"), "hyvideo-720p-txt": (1, 256, 3072, 256, "Bd"),
          "hyvideo-720p-final": (1, 118800, 3072, 119056, "Bd"), "wan14b-720p-cfg": (2, 75600, 5120, 75600, "Bd")}
EPS = 1e-6
HBM_BYTES_S = 3.35e12


def make_inputs(shape, *, seed, device):
    """(x, mul, add) of one SHAPES entry: x a (B, S, d) view of the longer
    sequence, the vectors as the models pass them."""
    B, S, d, S_full, vec = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(B, S_full, d, generator=g, device=device) * 2 + 0.3).to(torch.bfloat16)[:, :S]
    if vec == "d":
        return x, torch.rand(d, generator=g, device=device) + 0.5, torch.randn(d, generator=g, device=device)
    e = torch.randn(B, 6, d, generator=g, device=device) * 0.5
    return x, 1 + e[:, 1], e[:, 0]


def mismatch(out, ref, x, mul, add, eps=EPS):
    """(elements beyond tolerance, share of elements that differ) of the
    kernel's output against the plain version's. Both sum the row's mean
    and variance in their own order over up to 5120 elements, so their mu
    and rstd may differ in the last bits: one bf16 ulp of the plain output
    (an f32 result rounds to the neighbouring bf16), and, where y mul + add
    cancels to near 0, the f32 gap that row statistics 2^-18 apart leave,
    2^-18 |mul| (1 + |y|)."""
    mul, add = (t if t.dim() == 1 else t[:, None] for t in (mul, add))
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(((xf - mu) ** 2).mean(-1, keepdim=True) + eps)
    floor = y.abs_().add_(1).mul_(mul.abs()).mul_(2.0 ** -18)
    del xf, mu, y
    r = ref.float()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r.abs().clamp_min(2.0 ** -126))[1] - 8)
    gap = (out.float() - r).abs_()
    bad = int((gap > torch.maximum(ulp, floor)).sum())
    return bad, (gap > 0).float().mean().item()


def probe(inputs, *, iters, warmup):
    """inputs {name: (x, mul, add)} -> rows {name, shape, kernel_ms,
    plain_ms, bound_ms, kernel_gbs, plain_gbs, bound_share}. Launches the
    kernel warmup + iters times a shape."""
    rows = []
    for name, (x, mul, add) in inputs.items():
        nbytes = 2 * x.numel() * x.element_size()
        times = {"kernel_ms": cuda_ms(lambda: layernorm_mod(x, mul, add, EPS), iters, warmup),
                 "plain_ms": cuda_ms(lambda: layernorm_mod_plain(x, mul, add, EPS), iters, warmup)}
        bound_ms = nbytes / HBM_BYTES_S * 1e3
        rows.append({"name": name, "shape": tuple(x.shape), **times, "bound_ms": bound_ms, "bytes": nbytes,
                     **{k.replace("_ms", "_gbs"): nbytes / 1e9 / (t * 1e-3) for k, t in times.items()},
                     "bound_share": bound_ms / times["kernel_ms"]})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--out", default=None, help="write the rows and the device line as JSON here")
    args = ap.parse_args(argv)
    device = device_line("bench_layernorm_mod")
    print(device, flush=True)
    dev = torch.device("cuda", 0)
    rows = []
    for i, (name, shape) in enumerate(SHAPES.items()):
        rows += probe({name: make_inputs(shape, seed=i, device=dev)}, iters=args.iters, warmup=args.warmup)
        torch.cuda.empty_cache()
        r = rows[-1]
        print(f"{r['name']} {r['shape']} bf16: kernel {r['kernel_ms']:.4f} ms ({r['kernel_gbs']:.1f} GB/s, "
              f"{100 * r['bound_share']:.1f}% of the bound {r['bound_ms']:.4f} ms), eager {r['plain_ms']:.4f} ms "
              f"({r['plain_gbs']:.1f} GB/s)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": device, "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
