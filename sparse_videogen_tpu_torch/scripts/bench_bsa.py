"""K1 (the chunked-CSR block-sparse attention) and K3/K4 (the run-list
attention) at the shapes chip_smoke.py checks them, timed on one GPU.

    python -m sparse_videogen_tpu_torch.scripts.bench_bsa [--iters 3] [--out bsa.json]
    python -m sparse_videogen_tpu_torch.scripts.bench_bsa --cases k3_organic

Cases, each on the metadata of the pipeline's own runtime and random bf16
q, k, v from a seed:
- Wan 2.1 1.3B 480x832x81 (S = 32,760, D = 128): K1 dense (mask none) and
  SVG1 (band_sink) on all 24 (batch, head) rows of the CFG pair, and dense
  on the 4 rows chip_smoke.py checks;
- HunyuanVideo 720x1280x129 (S = 119,056, prompt 32, 24 heads, D = 128):
  K1 hyvideo dense and SVG1;
- CogVideoX 1.5 768x1360x81 (S = 45,106, 96 rows, D = 64): K1 none (dense)
  and cog (SVG1);
- K3 (mask none) and K4 (its band_sink MaskSpec path, SVG1's band and
  sink) on the run lists SAP's own front half builds at Wan 1.3B 480p (the
  first and last 2 of 12 heads, as chip_smoke.py times them); K3 on those
  of Wan 14B 720p (QC 300, KC 1000) on the first and last of 40 heads and
  on the first alone.
Each K1 case prints its time, the pairs its mask allows (over the real
tokens), TFLOP/s on them, the bound (4 D FLOPs a pair over 989 TFLOP/s, or
q, k, v and the output once over 3.35 TB/s, the larger) and, for the
unmasked cases, F.scaled_dot_product_attention's time on the same rows.
Each K3/K4 case prints its time, TFLOP/s on the visited pairs (every q row
of a q block that visits a run, padding included), the bound on the pairs
the real q rows need, the share of the loaded 128-token K/V tile columns
that are live, and the yardstick: one F.scaled_dot_product_attention call
with the run lists (and K4's predicate) as a bf16 attn_mask on the same
heads (at 720p on one head: its mask is ~23 GB).
--cases k3_organic (or all) times K3 at the benchmark's SAP cell setting:
the run lists SAP builds in one forward of Wan 2.1 14B at 720p (QC 300, KC
1000, block_q 256, block_kv 1024) on organic inputs as the cell builds them
(k := q and norm_q x 3.5 in every self-attention, low-pass latents with
factors (3, 6, 6); 2 blocks, one CFG stream, cold k-means), all 40 heads of
each layer. It prints K3's time, TFLOP/s on the allowed pairs (real q rows
x live keys) and on the visited ones (every q row of a walked q block x
live keys), and the K rows staged per live key: by the 128-token tiles of
the chunk walk (K4's; K3's before its packed stages) and by packed stages
of 8, 16 and 32-token boxes (ops/attention.py runs_packed_stats, inline).
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
from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec, apply_mask_spec
from sparse_videogen_tpu_torch.scripts.timing import cuda_ms, device_line

PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
HY_PROMPT = 32  # chip_smoke.py's live HunyuanVideo prompt
MASK_BYTES = 24e9  # the largest bf16 attn_mask the run-list yardstick builds (one 720p head: ~23 GB)


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


def runs_bias(metas, pos, spec, Sq: int, Skv: int, block_q: int, dtype):
    """The run lists as an additive attn_mask (1, h, Sq, Skv): 0 where a q
    row's block visits a column (and spec's predicate allows it at the
    padded q and permuted k positions, as the kernel evaluates it), -inf
    elsewhere; and the pairs it allows over the real q rows (pos, (h, n)
    padded positions of each head's real tokens)."""
    dev = metas.device
    h, m = metas.shape[0], metas.long()
    diff = torch.zeros(h, m.shape[1], Skv + 1, device=dev)
    diff.scatter_add_(2, m[..., 1::2], torch.ones_like(m[..., 1::2], dtype=diff.dtype))
    diff.scatter_add_(2, m[..., 2::2], -torch.ones_like(m[..., 2::2], dtype=diff.dtype))
    visited = (diff.cumsum(-1)[..., :Skv] > 0) & (m[..., :1] > 0)  # (h, nQ, Skv); n == 0 walks nothing
    del diff
    real = torch.zeros(h, Sq, dtype=torch.bool, device=dev).scatter_(1, pos.long(), True)
    bias = torch.zeros(1, h, Sq, Skv, dtype=dtype, device=dev)
    k = torch.arange(Skv, device=dev)[None, :]
    pairs = 0
    for r0 in range(0, Sq, 2048):
        qi = torch.arange(r0, min(Sq, r0 + 2048), device=dev)
        ok = visited[:, qi // block_q]
        pred = apply_mask_spec(spec, qi[:, None], k, None)
        if pred is not None:
            ok &= pred[None]
        bias[0, :, r0:r0 + len(qi)].masked_fill_(~ok, float("-inf"))
        pairs += int((ok & real[:, r0:r0 + len(qi), None]).sum())
    return bias, pairs


def bench_runs(preset, head_sets, kinds, *, iters, dev):
    """K3 (and K4 where kinds has band_sink) on the run lists of SAP's front
    half at a preset (one CFG stream, random q, k, v from seed 5), timed on
    each set of heads, each beside its masked-SDPA yardstick."""
    from sparse_videogen_tpu_torch.pipelines.wan import wan_layout
    from sparse_videogen_tpu_torch.presets import PRESETS
    from sparse_videogen_tpu_torch.sparse import svg2
    from sparse_videogen_tpu_torch.sparse.svg1 import make_svg1_plan

    run = PRESETS[preset]
    lay = wan_layout(run.model, run.height, run.width, run.num_frames)
    H, S, D, sap = run.model.num_heads, lay.seq_len, run.model.head_dim, run.sap
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = ((torch.randn(1, H, S, D, generator=gen, device=dev) * sc).to(torch.bfloat16) for sc in (2.0, 1.0, 1.0))
    a = svg2.sap_prepare(q, k, v, svg2.init_sap_state(H, D, sap, device=dev), layout=lay, cfg=sap, generator=gen)
    del q, k, v
    specs = {"none": MaskSpec(), "band_sink": make_svg1_plan(lay).mask_spec}
    rows = []
    for heads_l in head_sets:
        heads = torch.tensor(heads_l, device=dev)
        qs, ks, vs, metas, pos = (x.index_select(0, heads).contiguous() for x in (a.q, a.k, a.v, a.meta, a.pos))
        Sq, Skv = qs.shape[1], ks.shape[1]
        # runs_tile_stats, inline: the script also times checkouts that predate it
        m = metas.long()
        a_, b_ = m[..., 1::2], m[..., 2::2]
        walked = m[..., :1] > 0
        per_block = ((b_ - a_) * walked).sum(-1)
        tiles = (torch.where(b_ > a_, -(-b_ // 128) - a_ // 128, 0) * walked).sum(-1)
        visited = int(per_block.sum()) * sap.block_q
        real_rows = torch.zeros_like(per_block).scatter_add_(1, pos.long() // sap.block_q, torch.ones_like(pos.long()))
        for kind in kinds:
            kw = dict(block_q=sap.block_q, block_kv=sap.block_kv, mask_spec=specs[kind])
            ms = cuda_ms(lambda: block_sparse_attention_runs(qs, ks, vs, metas, **kw), iters, 1)
            pairs, sdpa_ms = int((per_block * real_rows).sum()), None
            if len(heads_l) * Sq * Skv * 2 <= MASK_BYTES:  # the yardstick's attn_mask fits
                bias, pairs = runs_bias(metas, pos, specs[kind], Sq, Skv, sap.block_q, qs.dtype)
                sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs[None], ks[None], vs[None],
                                                                         attn_mask=bias), iters, 1)
                del bias
                torch.cuda.empty_cache()
            elif kind != "none":
                raise ValueError(f"{kind}: its pairs need the attn_mask, which does not fit")
            t_ops, t_bytes = 4.0 * D * pairs / PEAK_BF16_FLOPS, 4 * qs.numel() * 2 / PEAK_BYTES
            rows.append({"case": f"k{3 if kind == 'none' else 4}_runs_{preset}_{len(heads_l)}heads", "kind": kind,
                         "heads": heads_l, "S": S, "Sq": Sq, "Skv": Skv, "D": D, "block_q": sap.block_q,
                         "block_kv": sap.block_kv, "ms": ms, "visited_pairs": visited, "needed_pairs": pairs,
                         "tflops_visited": 4.0 * D * visited / (ms * 1e-3) / 1e12,
                         "bound_ms": 1e3 * max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                         "live_column_share": int(per_block.sum()) / max(128 * int(tiles.sum()), 1),
                         "density": a.density.mean().item(), "sdpa_ms": sdpa_ms})
            r = rows[-1]
            print(f"{r['case'].split('_')[0].upper()} {r['case']} ({kind}, heads {heads_l}, Sq {Sq}, Skv {Skv}, D {D}, "
                  f"block_q {sap.block_q}, block_kv {sap.block_kv}): {ms:.3f} ms, {r['tflops_visited']:.1f} TFLOP/s "
                  f"on {visited} visited pairs; bound {r['bound_ms']:.3f} ms ({r['bound_by']}, {pairs} pairs of the "
                  f"real q rows); live column share {r['live_column_share']:.4f}; SDPA with the run lists as an "
                  f"attn_mask " + ("not run (its mask exceeds MASK_BYTES)" if sdpa_ms is None else f"{sdpa_ms:.3f} ms"),
                  flush=True)
        del qs, ks, vs, metas, pos
    del a
    torch.cuda.empty_cache()
    return rows


ORGANIC_GAIN, ORGANIC_SMOOTH = 3.5, (3, 6, 6)  # the benchmark's SAP traffic (svgbench/traffic/sap.json)


def organic_run_lists(dev, layers: int = 2, seed: int = 7):
    """SAP's kernel arguments (SAPKernelArgs) of each layer of one forward of
    Wan 2.1 14B at 720p (the 14B-720p-sap preset) on organic inputs: random
    bf16 weights with k := q and norm_q x ORGANIC_GAIN in every
    self-attention, low-pass latents (ORGANIC_SMOOTH), a random (1, 512,
    4096) context, `layers` blocks, one CFG stream, cold k-means."""
    from sparse_videogen_tpu_torch.models.wan.model import WanModel
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime, wan_layout
    from sparse_videogen_tpu_torch.presets import PRESETS
    from sparse_videogen_tpu_torch.sparse import svg2
    from sparse_videogen_tpu_torch.utils.organic import align_self_attn_qk, smooth_latents

    run = PRESETS["14B-720p-sap"]
    cfg = dataclasses.replace(run.model, num_layers=layers)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = WanModel(cfg, dtype=torch.bfloat16, device=dev).init_random(gen)
    align_self_attn_qk(model, gain=ORGANIC_GAIN)
    lay = wan_layout(cfg, run.height, run.width, run.num_frames)
    x = smooth_latents(gen, (1, cfg.out_dim, lay.num_frames, run.height // 8, run.width // 8), ORGANIC_SMOOTH)
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen, device=dev).to(torch.bfloat16)
    rt = make_wan_runtime(lay, device=dev, pattern="SAP", sap=run.sap)
    rt.states = {}
    prepare, args = svg2.sap_prepare, []

    def recording(*a, **kw):
        args.append(prepare(*a, **kw))
        return args[-1]

    svg2.sap_prepare = recording
    try:
        with torch.no_grad():
            model(x, torch.full((1,), 900.0, device=dev), ctx, attention=rt, generator=gen)
    finally:
        svg2.sap_prepare = prepare
    del model
    torch.cuda.empty_cache()
    return args, run.sap


def staged_rows(meta, box: int | None):
    """K rows staged over the walked q blocks of run-list metadata: the
    chunk walk's 128-token tiles (box None) or packed 128-row stages of
    `box`-token boxes (runs_tile_stats / runs_packed_stats, inline: the
    script also times checkouts that predate them)."""
    m = meta.long()
    a, b = m[..., 1::2], m[..., 2::2]
    walked = m[..., 0] > 0
    if box is None:
        tiles = torch.where(b > a, -(-b // 128) - a // 128, 0).sum(-1)
    else:
        tiles = -(-torch.where(b > a, -(-(b - a) // box), 0).sum(-1) // (128 // box))
    return 128 * int((tiles * walked).sum())


def bench_k3_organic(*, iters, dev):
    """K3 on every layer's run lists of organic_run_lists, all heads a call."""
    args, sap = organic_run_lists(dev)
    rows = []
    for layer, a in enumerate(args):
        m = a.meta.long()
        walked = m[..., :1] > 0
        per_block = ((m[..., 2::2] - m[..., 1::2]) * walked).sum(-1)
        real_rows = torch.zeros_like(per_block).scatter_add_(1, a.pos.long() // sap.block_q,
                                                             torch.ones_like(a.pos.long()))
        live = int(per_block.sum())
        allowed, visited = int((per_block * real_rows).sum()), live * sap.block_q
        kw = dict(block_q=sap.block_q, block_kv=sap.block_kv)
        ms = cuda_ms(lambda: block_sparse_attention_runs(a.q, a.k, a.v, a.meta, **kw), iters, 1)
        D = a.q.shape[-1]
        shares = {"tiles128": staged_rows(a.meta, None) / live,
                  **{f"packed{g}": staged_rows(a.meta, g) / live for g in (8, 16, 32)}}
        rows.append({"case": f"k3_organic_14B-720p_layer{layer}", "BH": a.q.shape[0], "Sq": a.q.shape[1],
                     "Skv": a.k.shape[1], "D": D, "block_q": sap.block_q, "block_kv": sap.block_kv, "ms": ms,
                     "density": a.density.mean().item(), "allowed_pairs": allowed, "visited_pairs": visited,
                     "tflops_allowed": 4.0 * D * allowed / (ms * 1e-3) / 1e12,
                     "tflops_visited": 4.0 * D * visited / (ms * 1e-3) / 1e12,
                     "bound_ms": 1e3 * 4.0 * D * allowed / PEAK_BF16_FLOPS, "staged_per_live": shares})
        r = rows[-1]
        print(f"K3 {r['case']} (BH {r['BH']}, Sq {r['Sq']}, Skv {r['Skv']}, density {r['density']:.4f}): "
              f"{ms:.3f} ms, {r['tflops_allowed']:.1f} TFLOP/s on {allowed} allowed pairs, "
              f"{r['tflops_visited']:.1f} on {visited} visited; bound {r['bound_ms']:.3f} ms; K rows staged a live "
              f"key: " + ", ".join(f"{k} {v:.4f}" for k, v in shares.items()), flush=True)
    del args
    torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    ap.add_argument("--cases", choices=("all", "k3_organic"), default="all")
    args = ap.parse_args(argv)
    line = device_line("bench_bsa")
    print(line, flush=True)
    dev = torch.device("cuda", 0)
    rows = bench_k3_organic(iters=args.iters, dev=dev)
    if args.cases == "k3_organic":
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"device": line, "rows": rows}, f, indent=1)
        return
    for name, BH, rt, dense in k1_cases(dev):
        rows.append(bench_k1(name, BH, rt, dense, iters=args.iters, dev=dev))
        r = rows[-1]
        print(f"K1 {name} ({r['kind']}, BH={BH}, S={r['S']}, D={r['D']}, block_q {r['block_q']}): {r['ms']:.3f} ms, "
              f"{r['tflops']:.1f} TFLOP/s on {r['allowed_pairs_per_head'] / r['S'] ** 2:.4f} of S x S; bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']})"
              + ("" if r["sdpa_ms"] is None else f"; SDPA {r['sdpa_ms']:.3f} ms"), flush=True)
    rows += bench_runs("1.3B-480p", [[0, 1, 10, 11]], ("none", "band_sink"), iters=args.iters, dev=dev)
    rows += bench_runs("14B-720p-sap", [[0, 39], [0]], ("none",), iters=args.iters, dev=dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": line, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
