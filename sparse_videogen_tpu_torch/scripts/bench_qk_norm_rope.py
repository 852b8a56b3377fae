"""The fused q/k RMSNorm + RoPE on one GPU: the kernel (csrc/qk_norm_rope.cu)
beside the eager chain the models ran before it (the f32 RMSNorm, the head
view made contiguous, K2) and the bytes bound, at the shapes of the
benchmark's cells.

    python -m sparse_videogen_tpu_torch.scripts.bench_qk_norm_rope [--iters 20] [--out f.json]

Shapes: Wan 2.1 1.3B 480p x 81 self-attention q on the CFG pair (2 x 32,760
x 1536, 12 heads, the token's norm), Wan 14B 720p x 81 (75,600 x 5120, 40
heads, one CFG stream), HunyuanVideo 720p x 129's single block (119,056 x
3072 of a fused qkv's column view, a head's norm, RoPE on the 118,800
video rows) and its double block's video and text streams written into one
joined (1, 24, 119,056, 128) buffer. bf16 x, f32 weight and tables, eps
1e-6. GB/s and the bound count one bf16 read of x, one bf16 write of the
output and one f32 read of the cos/sin rows; the bound is those bytes at
3.35 TB/s. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json

import torch

from sparse_videogen_tpu_torch.models.common.rope import apply_rope_interleaved
from sparse_videogen_tpu_torch.ops.qk_norm_rope import _heads, qk_norm_rope, qk_norm_rope_plain, rms_norm
from sparse_videogen_tpu_torch.scripts.timing import cuda_ms, device_line

# name -> (B, S, d, heads, norm group "token" or "head", x's token stride, tables' rows, row of x's first token
# in the tables, S_out, r0): x a (B, S, d) column view of rows of the stride; out (B, heads, S_out, D)
SHAPES = {"wan-480p-self": (2, 32760, 1536, 12, "token", 1536, 32760, 0, 32760, 0),
          "wan14b-720p-self": (1, 75600, 5120, 40, "token", 5120, 75600, 0, 75600, 0),
          "hyvideo-720p-single": (1, 119056, 3072, 24, "head", 9216, 118800, 0, 119056, 0),
          "hyvideo-720p-double-img": (1, 118800, 3072, 24, "head", 9216, 118800, 0, 119056, 0),
          "hyvideo-720p-double-txt": (1, 256, 3072, 24, "head", 9216, 0, 0, 119056, 118800)}
EPS = 1e-6
HBM_BYTES_S = 3.35e12


def make_inputs(shape, *, seed, device):
    """(x, weight, cos, sin, out, r0) of one SHAPES entry: x a column view
    of a wider projection, the tables' rows from the row of x's first token
    (a sequence shard's slice of whole tables), `out` None for a new tensor."""
    B, S, d, H, group, stride, n_rope, row0, S_out, r0 = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(B, S, stride, generator=g, device=device) * 2 + 0.3).to(torch.bfloat16)[:, :, :d]
    D = d // H
    w = torch.rand(d if group == "token" else D, generator=g, device=device) + 0.5
    cos = sin = None
    if n_rope:
        ang = torch.rand(row0 + n_rope, D // 2, generator=g, device=device) * 6.3
        cos, sin = ang.cos()[row0:], ang.sin()[row0:]
    out = None if (S_out, r0) == (S, 0) else torch.zeros(B, H, S_out, D, dtype=torch.bfloat16, device=device)
    return x, w, cos, sin, out, r0


def eager_chain(x, weight, heads, cos, sin, out, r0):
    """What the models ran before the kernel: the f32 RMSNorm, the head view,
    K2 on the roped rows made contiguous, a cat with the unroped rows, and
    a copy into the joined buffer."""
    B, S, d = x.shape
    y = _heads(rms_norm(x, weight, EPS), heads) if weight.shape[0] == d else rms_norm(_heads(x, heads), weight, EPS)
    if cos is not None:
        n = cos.shape[0]
        r = apply_rope_interleaved(y[:, :, :n], cos, sin)
        y = r if n == S else torch.cat([r, y[:, :, n:]], dim=2)
    if out is None:
        return y.contiguous()
    out[:, :, r0:r0 + S] = y
    return out


def mismatch(got, ref, x, weight, heads, cos, sin, r0):
    """(elements beyond tolerance, share of elements that differ, largest
    gap in ulps of the plain output) of the kernel's rows [r0, r0 + S)
    against the plain version's. The two sum a group's squares in their own
    order, so the f32 normalised value n may round to the neighbouring
    bf16: the tolerance is that one ulp of n carried through the weight
    product and the rotation, plus one ulp of each rounding after it (one
    bf16 ulp of the output where the rotation does not cancel)."""
    B, S, d = x.shape
    got, ref = got[:, :, r0:r0 + S].float(), ref[:, :, r0:r0 + S].float()

    def ulp(t):
        return torch.ldexp(torch.ones_like(t), torch.frexp(t.abs().clamp_min(2.0 ** -126))[1] - 8)

    xh = _heads(x, heads).float()
    if weight.shape[0] == d:
        ss = (x.float() ** 2).mean(-1)[:, None, :, None]
        wb = weight.to(torch.bfloat16).float().view(heads, 1, -1)
    else:
        ss = (xh ** 2).mean(-1, keepdim=True)
        wb = weight.to(torch.bfloat16).float()
    n = (xh * torch.rsqrt(ss + EPS)).to(torch.bfloat16).float()
    y = (n * wb).to(torch.bfloat16).float()
    tol_y = ulp(n) * wb.abs() + ulp(y)
    del xh, ss, n
    tol = tol_y
    if cos is not None:
        m = cos.shape[0]
        c, s = cos.abs(), sin.abs()
        t0, t1 = tol_y[:, :, :m, 0::2], tol_y[:, :, :m, 1::2]
        rot = torch.stack([t0 * c + t1 * s, t0 * s + t1 * c], dim=-1).flatten(-2)
        tol = torch.cat([rot, tol_y[:, :, m:]], dim=2)
    tol = tol + ulp(ref)
    gap = (got - ref).abs_()
    bad = int((gap > tol).sum())
    return bad, (gap > 0).float().mean().item(), (gap / ulp(ref)).max().item()


def probe(name, heads, inputs, *, iters, warmup):
    """One shape's row {name, shape, heads, kernel_ms, eager_ms, plain_ms,
    bound_ms, *_gbs, bound_share}, inputs as make_inputs gives them.
    Launches the kernel warmup + iters times."""
    x, w, cos, sin, out, r0 = inputs
    nbytes = 2 * 2 * x.numel() + (0 if cos is None else 2 * cos.numel() * 4)
    times = {"kernel_ms": cuda_ms(lambda: qk_norm_rope(x, w, EPS, heads, cos, sin, out=out, r0=r0), iters, warmup),
             "eager_ms": cuda_ms(lambda: eager_chain(x, w, heads, cos, sin, out, r0), iters, warmup),
             "plain_ms": cuda_ms(lambda: qk_norm_rope_plain(x, w, EPS, heads, cos, sin, out=out, r0=r0), iters,
                                 warmup)}
    bound_ms = nbytes / HBM_BYTES_S * 1e3
    return {"name": name, "shape": tuple(x.shape), "heads": heads, **times, "bound_ms": bound_ms, "bytes": nbytes,
            **{k.replace("_ms", "_gbs"): nbytes / 1e9 / (t * 1e-3) for k, t in times.items()},
            "bound_share": bound_ms / times["kernel_ms"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--out", default=None, help="write the rows and the device line as JSON here")
    args = ap.parse_args(argv)
    device = device_line("bench_qk_norm_rope")
    print(device, flush=True)
    dev = torch.device("cuda", 0)
    rows = []
    for i, (name, shape) in enumerate(SHAPES.items()):
        r = probe(name, shape[3], make_inputs(shape, seed=i, device=dev), iters=args.iters, warmup=args.warmup)
        rows.append(r)
        torch.cuda.empty_cache()
        print(f"{r['name']} {r['shape']} bf16, {r['heads']} heads: kernel {r['kernel_ms']:.4f} ms "
              f"({r['kernel_gbs']:.1f} GB/s, {100 * r['bound_share']:.1f}% of the bound {r['bound_ms']:.4f} ms), "
              f"eager {r['eager_ms']:.4f} ms ({r['eager_gbs']:.1f} GB/s), plain {r['plain_ms']:.4f} ms", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": device, "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
