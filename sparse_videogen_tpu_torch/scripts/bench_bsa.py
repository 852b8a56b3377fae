"""K1 (the chunked-CSR block-sparse attention) and K3 (the run-list
attention) at the shapes chip_smoke.py checks them, timed on one GPU.

    python -m sparse_videogen_tpu_torch.scripts.bench_bsa [--iters 3] [--out bsa.json]

Cases, each on the metadata of the pipeline's own runtime and random bf16
q, k, v from a seed:
- Wan 2.1 1.3B 480x832x81 (S = 32,760, D = 128): K1 dense (mask none) and
  SVG1 (band_sink) on all 24 (batch, head) rows of the CFG pair, and dense
  on the 4 rows chip_smoke.py checks;
- HunyuanVideo 720x1280x129 (S = 119,056, prompt 32, 24 heads, D = 128):
  K1 hyvideo dense and SVG1;
- CogVideoX 1.5 768x1360x81 (S = 45,106, 96 rows, D = 64): K1 none (dense)
  and cog (SVG1);
- K3 on the run lists SAP's own front half builds at Wan 480p (the first
  and last 2 of 12 heads, as chip_smoke.py times it).
Each K1 case prints its time, the pairs its mask allows (over the real
tokens), TFLOP/s on them, the bound (4 D FLOPs a pair over 989 TFLOP/s, or
q, k, v and the output once over 3.35 TB/s, the larger) and, for the
unmasked cases, F.scaled_dot_product_attention's time on the same rows.
The script uses only the port's public wrappers and runtimes, so it times
another checkout's kernels when run from that checkout. Prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch
import torch.nn.functional as F

from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_kv, block_sparse_attention_runs
from sparse_videogen_tpu_torch.ops.mask_spec import apply_mask_spec
from sparse_videogen_tpu_torch.scripts.timing import cuda_ms, device_line

PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
HY_PROMPT = 32  # chip_smoke.py's live HunyuanVideo prompt


def allowed_pairs(spec, aux, S: int, dev, rows: int = 2048) -> int:
    """(q, k) pairs of an S-token sequence that the mask kind allows, per head."""
    if spec.kind == "none":
        return S * S
    aux_h = [int(a) for a in aux.cpu()]
    k = torch.arange(S, device=dev)[None, :]
    return sum(int(apply_mask_spec(spec, torch.arange(r0, min(S, r0 + rows), device=dev)[:, None], k, aux_h).sum())
               for r0 in range(0, S, rows))


def _qkv(BH, S, D, s_pad_q, s_pad_kv, gen, dev):
    def rand(s_pad, scale):
        x = torch.zeros(BH, s_pad, D, device=dev, dtype=torch.bfloat16)
        x[:, :S] = (torch.randn(BH, S, D, generator=gen, device=dev) * scale).to(torch.bfloat16)
        return x

    return rand(s_pad_q, 2.0), rand(s_pad_kv, 1.0), rand(s_pad_kv, 1.0)


def k1_cases(dev):
    """(name, BH, S, runtime, dense?) for every K1 case."""
    from sparse_videogen_tpu_torch.pipelines.cog import cog_layout, make_cog_runtime
    from sparse_videogen_tpu_torch.pipelines.hyvideo import hyvideo_layout, make_hyvideo_runtime
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime, wan_layout
    from sparse_videogen_tpu_torch.presets import COG_768P_SVG, HY_720P_SVG, T2V_480P

    run = T2V_480P
    lay = wan_layout(run.model, run.height, run.width, run.num_frames)
    wan = make_wan_runtime(lay, device=dev, pattern="SVG", svg=run.generate_kwargs()["svg"])
    run = HY_720P_SVG
    lay = dataclasses.replace(hyvideo_layout(run.model, run.height, run.width, run.num_frames), prompt_length=HY_PROMPT)
    hy = make_hyvideo_runtime(lay, device=dev, prompt_length=HY_PROMPT, pattern="SVG", svg=run.generate_kwargs()["svg"])
    run = COG_768P_SVG
    lay = cog_layout(run.model, run.height, run.width, run.num_frames)
    cog = make_cog_runtime(lay, device=dev, pattern="SVG", svg=run.generate_kwargs()["svg"])
    return [("wan480p_dense_4rows", 4, wan, True), ("wan480p_dense", 24, wan, True), ("wan480p_svg1", 24, wan, False),
            ("hyvideo_dense", 24, hy, True), ("hyvideo_svg1", 24, hy, False),
            ("cog_none_d64", 96, cog, True), ("cog_svg1_d64", 96, cog, False)]


def bench_k1(name, BH, rt, dense, *, iters, dev):
    plan = rt.plan
    meta, spec, bq = ((rt.dense_meta, plan.dense_mask_spec, plan.dense_block_q) if dense
                      else (rt.sparse_meta, plan.mask_spec, plan.block_q))
    S, D = plan.layout.seq_len, (64 if name.startswith("cog") else 128)
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = _qkv(BH, S, D, -(-S // bq) * bq, plan.seq_pad_kv, gen, dev)
    kw = dict(block_q=bq, block_kv=plan.block_kv, mask_spec=spec)
    ms = cuda_ms(lambda: block_sparse_attention_kv(q, k, v, meta, rt.aux, **kw), iters, 1)
    pairs = allowed_pairs(spec, rt.aux, S, dev)
    flops = 4.0 * D * pairs * BH
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, 4 * BH * S * D * 2 / PEAK_BYTES
    row = {"case": name, "kind": spec.kind, "BH": BH, "S": S, "D": D, "block_q": bq, "block_kv": plan.block_kv,
           "ms": ms, "allowed_pairs_per_head": pairs, "tflops": flops / (ms * 1e-3) / 1e12,
           "bound_ms": 1e3 * max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "sdpa_ms": None}
    if spec.kind == "none":
        row["sdpa_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q[None, :, :S], k[None, :, :S],
                                                                        v[None, :, :S]), iters, 1)
    del q, k, v
    torch.cuda.empty_cache()
    return row


def bench_k3(*, iters, dev):
    """K3 on the run lists of SAP's front half at Wan 1.3B 480p (12 heads of
    one CFG stream), timed on the first and last 2 heads."""
    from sparse_videogen_tpu_torch.pipelines.wan import wan_layout
    from sparse_videogen_tpu_torch.presets import PRESETS
    from sparse_videogen_tpu_torch.sparse import svg2

    run = PRESETS["1.3B-480p"]
    lay = wan_layout(run.model, run.height, run.width, run.num_frames)
    H, S, D, sap = run.model.num_heads, lay.seq_len, run.model.head_dim, run.sap
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = ((torch.randn(1, H, S, D, generator=gen, device=dev) * sc).to(torch.bfloat16) for sc in (2.0, 1.0, 1.0))
    a = svg2.sap_prepare(q, k, v, svg2.init_sap_state(H, D, sap, device=dev), layout=lay, cfg=sap, generator=gen)
    heads = torch.tensor([0, 1, H - 2, H - 1], device=dev)
    qs, ks, vs, metas = (x.index_select(0, heads).contiguous() for x in (a.q, a.k, a.v, a.meta))
    ms = cuda_ms(lambda: block_sparse_attention_runs(qs, ks, vs, metas, block_q=sap.block_q, block_kv=sap.block_kv),
                 iters, 1)
    return {"case": "k3_runs_480p_4heads", "kind": "none", "BH": 4, "S": S, "D": D, "ms": ms}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    args = ap.parse_args(argv)
    line = device_line("bench_bsa")
    print(line, flush=True)
    dev = torch.device("cuda", 0)
    rows = []
    for name, BH, rt, dense in k1_cases(dev):
        rows.append(bench_k1(name, BH, rt, dense, iters=args.iters, dev=dev))
        r = rows[-1]
        print(f"K1 {name} ({r['kind']}, BH={BH}, S={r['S']}, D={r['D']}, block_q {r['block_q']}): {r['ms']:.3f} ms, "
              f"{r['tflops']:.1f} TFLOP/s on {r['allowed_pairs_per_head'] / r['S'] ** 2:.4f} of S x S; bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']})"
              + ("" if r["sdpa_ms"] is None else f"; SDPA {r['sdpa_ms']:.3f} ms"), flush=True)
    rows.append(bench_k3(iters=args.iters, dev=dev))
    print(f"K3 {rows[-1]['case']}: {rows[-1]['ms']:.3f} ms", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": line, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
