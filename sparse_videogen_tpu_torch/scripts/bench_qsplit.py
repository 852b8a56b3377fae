"""Dense attention on one GPU: the Hopper kernel K7 (ops/dense_qsplit.py) per
(bq, qsplit), with K1's dense path and F.scaled_dot_product_attention as
yardsticks (counterpart of scripts/bench_qsplit.py).

    python -m sparse_videogen_tpu_torch.scripts.bench_qsplit [--iters 5]

The JAX probe's shape, (12, 32768, 128) bf16, and its (bq, bkv, nbuf,
qsplit) list: each entry that a Hopper CTA cannot hold is printed with the
reason (ops/dense_qsplit.unfit: a CTA owns 128 q rows as two 64-row wgmma
warpgroups; more rows take more registers than an SM has, and from 512 rows
the q tile and the K/V ring exceed shared memory), then every (bq, qsplit)
pair the kernel compiles runs at bkv 1024 (the list's): qsplit 1 runs the two
warpgroups on K1's schedule, qsplit 2 in ping-pong (FA3's schedule). TFLOP/s
counts 4 * BH * S^2 * D. The question: does overlapping one warpgroup's
softmax with the other's products beat K1's schedule. Prints the card's name
and power limit first.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from sparse_videogen_tpu_torch.ops import metadata as MD
from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_kv
from sparse_videogen_tpu_torch.ops.dense_qsplit import KERNEL_CONFIGS, dense_attn, unfit
from sparse_videogen_tpu_torch.scripts.timing import cuda_ms, device_line

SHAPE = (12, 32768, 128)
# scripts/bench_qsplit.py's (bq, bkv, nbuf, qsplit) list
TPU_CONFIGS = ((512, 1024, 2, 1), (512, 1024, 2, 2), (512, 1024, 2, 4), (1024, 1024, 2, 4), (1024, 1024, 2, 8),
               (2048, 1024, 2, 4), (2048, 1024, 2, 8), (4096, 1024, 2, 8), (2048, 1024, 3, 4))
BKV = 1024
K1_BLOCK_Q, K1_BLOCK_KV = 2048, 1024  # K1's dense path at this length (SVG1Plan.dense_block_q)


def make_inputs(shape, *, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=device).to(torch.bfloat16) for _ in range(3))


def flops(shape) -> float:
    BH, S, D = shape
    return 4.0 * BH * S * S * D


def probe(q, k, v, *, iters, warmup):
    """Rows {bq, qsplit, ms, tflops} for every compiled pair, then the
    yardsticks K1 dense and SDPA. Launches K7 warmup + iters times a pair."""
    fl = flops(q.shape)
    rows = []
    for bq, qs in KERNEL_CONFIGS:
        ms = cuda_ms(lambda: dense_attn(q, k, v, bq=bq, bkv=BKV, qsplit=qs), iters, warmup)
        rows.append({"name": f"dense_qsplit bq={bq} qsplit={qs}", "bq": bq, "qsplit": qs, "ms": ms,
                     "tflops": fl / (ms * 1e-3) / 1e12})
    S = q.shape[1]
    meta = torch.as_tensor(MD.dense_meta(S, S, block_q=K1_BLOCK_Q, block_kv=K1_BLOCK_KV), device=q.device)
    yard = {"K1 dense (bsa_kernel)": lambda: block_sparse_attention_kv(q, k, v, meta, block_q=K1_BLOCK_Q,
                                                                      block_kv=K1_BLOCK_KV),
            "F.scaled_dot_product_attention": lambda: F.scaled_dot_product_attention(q[None], k[None], v[None])}
    for name, fn in yard.items():
        ms = cuda_ms(fn, iters, warmup)
        rows.append({"name": name, "bq": None, "qsplit": None, "ms": ms, "tflops": fl / (ms * 1e-3) / 1e12})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=1)
    args = ap.parse_args(argv)
    print(device_line("bench_qsplit"), flush=True)
    for bq, bkv, nbuf, qs in TPU_CONFIGS:
        print(f"bq={bq} bkv={bkv} nbuf={nbuf} qsplit={qs}: does not fit a Hopper CTA: {unfit(bq, qs, SHAPE[2])}",
              flush=True)
    q, k, v = make_inputs(SHAPE, seed=0, device=torch.device("cuda", 0))
    rows = probe(q, k, v, iters=args.iters, warmup=args.warmup)
    for r in rows:
        print(f"{r['name']} {SHAPE} bf16: {r['ms']:.3f} ms, {r['tflops']:.1f} TFLOP/s", flush=True)
    return rows


if __name__ == "__main__":
    main()
