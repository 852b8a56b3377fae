"""Drive the torch port of the Wan 2.1 T2V dense/SVG1/SAP paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and the exit code
is non-zero:
  1. device  - needs torch.cuda; prints torch/CUDA versions, the card, its
               capability and `nvidia-smi` name and power limit.
  2. build   - compiles sparse_videogen_tpu_torch/csrc/*.cu with nvcc (sm_90a).
  3. kernels - each Hopper kernel against its plain PyTorch version at the
               slices' shapes (bf16), with the tolerance stated, and both
               timed with CUDA events: RoPE, the chunked-CSR attention (dense
               and SVG1 metadata), k-means (K = 50 and 200, and two runs
               giving the same bits), the run-list attention on the run
               lists of SAP's own front half (mask none, and band_sink for
               its MaskSpec path); then one full-width layer of SAP at full
               density against the dense kernel.
  4. slice   - WanPipeline.generate_latents with Wan 2.1 1.3B at full width
               and depth (random weights from a seed), 480x832x81, 4 UniPC
               steps: SVG1 with batched CFG, then SAP (cluster mode, the
               CLI's defaults) with cond and uncond as separate forwards;
               each path's kernel launch counts are read around its run and
               held to what the configuration implies. Then one forward of a
               small Wan with the kernels (on the card) against the plain
               versions (on the CPU), dense, SVG1 and SAP.
  5. cli     - the port's CLI in --smoke mode for SVG, dense and SAP.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

HEIGHT, WIDTH, NUM_FRAMES, STEPS = 480, 832, 81, 4
# CLI defaults (cli/wan_t2v.py)
SPARSITY, FIRST_LAYERS_FP, FIRST_TIMES_FP, FLOW_SHIFT, GUIDANCE = 0.25, 0.025, 0.075, 3.0, 5.0
CHECK_HEADS = 2  # first and last heads held against the plain attention (the plain version is slow)
TIMED_ITERS = 5
# the run-list and chunked attention kernels against their plain versions:
# both accumulate in f32 with P rounded to bf16 for PV; they differ in the
# order of sums and in where the running max rescales P (64-token sub-tiles
# vs whole chunks), which moves bf16 roundings of P
ATTN_TOL_ABS, ATTN_TOL_REL = 2e-2, 1e-2


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = TIMED_ITERS) -> float:
    """Mean milliseconds of fn() over `iters` runs after one warm-up, by CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def err_stats(out: torch.Tensor, ref: torch.Tensor):
    d = (out.float() - ref.float()).abs()
    return d.max().item(), (d.mean() / ref.float().abs().mean().clamp_min(1e-12)).item()


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"device {torch.cuda.get_device_name(0)} capability {torch.cuda.get_device_capability(0)} "
                  f"count {torch.cuda.device_count()}")
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from sparse_videogen_tpu_torch import _kernels

    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.lib()
    log("build", f"{os.path.relpath(path, ROOT)}: built and loaded in {time.perf_counter() - t0:.2f} s")
    with open(os.path.join(os.path.dirname(path), "ptxas.log")) as f:
        for line in f:
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log("build", "ptxas: " + line.strip())


def slice_layout():
    from sparse_videogen_tpu_torch.models.wan.model import WAN_1_3B
    from sparse_videogen_tpu_torch.pipelines.wan import wan_layout

    return wan_layout(WAN_1_3B, HEIGHT, WIDTH, NUM_FRAMES)


def phase_rope(dev):
    from sparse_videogen_tpu_torch import _kernels
    from sparse_videogen_tpu_torch.models.common.rope import wan_rope_cos_sin
    from sparse_videogen_tpu_torch.ops.rope import rope_apply, rope_plain

    lay = slice_layout()
    BH, S, D = 2 * 12, lay.seq_len, 128
    cos, sin = (torch.as_tensor(a, device=dev) for a in wan_rope_cos_sin(lay.num_frames, HEIGHT // 16, WIDTH // 16, D))
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(BH, S, D, generator=gen, device=dev).to(torch.bfloat16)
    out = rope_apply(x, cos, sin)
    ref = rope_plain(x, cos, sin)
    torch.cuda.synchronize()
    max_abs, mean_rel = err_stats(out, ref)
    # both evaluate the same f32 products and sums (no FMA contraction) and
    # round once to bf16, so they agree bit for bit
    tol = 0.0
    log("kernels", f"rope (BH={BH}, S={S}, D={D}) bf16: max_abs_err {max_abs:.3e} (tol {tol:.3e}), "
                   f"mean_rel_err {mean_rel:.3e}")
    if not (max_abs <= tol):
        raise AssertionError(f"rope kernel disagrees with its plain version: {max_abs} > {tol}")
    ms = cuda_ms(lambda: rope_apply(x, cos, sin))
    plain_ms = cuda_ms(lambda: rope_plain(x, cos, sin))
    gbs = (2 * x.numel() * 2 + 2 * cos.numel() * 4) / (ms * 1e-3) / 1e9
    log("kernels", f"rope kernel {ms:.4f} ms ({gbs:.1f} GB/s), plain {plain_ms:.4f} ms")
    return {"name": "rope", "route": "cuda", "source": "sparse_videogen_tpu_torch/csrc/rope.cu",
            "replaces": "sparse_videogen_tpu/ops/rope_pallas.py:48", "max_abs_err": max_abs,
            "ms": ms, "plain_ms": plain_ms}


def _visited_pairs(meta_np, block_q, seq_q):
    """q x kv pairs the metadata visits (over real q rows), for FLOP counts."""
    from sparse_videogen_tpu_torch.ops.metadata import ENTRY_SCALE, N_CHEAP_SCALE

    total = 0
    for i in range(meta_np.shape[1]):
        n = int(meta_np[0, i, 0]) % N_CHEAP_SCALE
        win = meta_np[0, i, 2:2 + 2 * n:2]
        rows = min(block_q, seq_q - i * block_q)
        total += max(rows, 0) * int(np.sum(win % ENTRY_SCALE - win // ENTRY_SCALE))
    return total


def phase_attention(dev):
    """Kernel A at the slice's width (B=2 CFG pair x 12 heads) on the
    metadata and mask scalars of the pipeline's own runtime; the first and
    last CHECK_HEADS heads are held against the plain version."""
    from sparse_videogen_tpu_torch.config import SVGConfig
    from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_kv, block_sparse_attention_kv_plain
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime

    lay = slice_layout()
    rt = make_wan_runtime(lay, device=dev, pattern="SVG", svg=SVGConfig(sparsity=SPARSITY))
    plan = rt.plan
    S, D, BH = lay.seq_len, 128, 2 * 12
    heads = torch.tensor(list(range(CHECK_HEADS)) + list(range(BH - CHECK_HEADS, BH)), device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = {
        "dense": (rt.dense_meta, plan.dense_mask_spec, plan.dense_block_q),
        "svg1": (rt.sparse_meta, plan.mask_spec, plan.block_q),
    }
    entry = None
    for name, (meta, spec, bq) in cases.items():
        def rand(s_pad, scale):
            x = torch.zeros(BH, s_pad, D, device=dev, dtype=torch.bfloat16)
            x[:, :S] = (torch.randn(BH, S, D, generator=gen, device=dev) * scale).to(torch.bfloat16)
            return x

        q, k, v = rand(-(-S // bq) * bq, 2.0), rand(plan.seq_pad_kv, 1.0), rand(plan.seq_pad_kv, 1.0)
        kw = dict(block_q=bq, block_kv=plan.block_kv, mask_spec=spec)
        out = block_sparse_attention_kv(q, k, v, meta, rt.aux, **kw)
        qs, ks, vs = (x.index_select(0, heads) for x in (q, k, v))
        ref = block_sparse_attention_kv_plain(qs, ks, vs, meta, rt.aux, **kw)
        torch.cuda.synchronize()
        max_abs, mean_rel = err_stats(out.index_select(0, heads)[:, :S], ref[:, :S])
        tol_abs, tol_rel = ATTN_TOL_ABS, ATTN_TOL_REL
        log("kernels", f"attention {name} (mask {spec.kind}, BH={BH}, heads {heads.tolist()} checked, S={S} "
                       f"padded q {q.shape[1]} kv {k.shape[1]}, D={D}, block_q {bq}, block_kv {plan.block_kv}, "
                       f"meta {tuple(meta.shape)}): max_abs_err {max_abs:.3e} (tol {tol_abs}), "
                       f"mean_rel_err {mean_rel:.3e} (tol {tol_rel})")
        if not (max_abs <= tol_abs and mean_rel <= tol_rel):
            raise AssertionError(f"attention kernel ({name}) disagrees with its plain version")
        pairs = _visited_pairs(meta.cpu().numpy(), bq, S)
        ms = cuda_ms(lambda: block_sparse_attention_kv(qs, ks, vs, meta, rt.aux, **kw))
        plain_ms = cuda_ms(lambda: block_sparse_attention_kv_plain(qs, ks, vs, meta, rt.aux, **kw), iters=1)
        ms_all = cuda_ms(lambda: block_sparse_attention_kv(q, k, v, meta, rt.aux, **kw))
        log("kernels", f"attention {name} on the {len(heads)} checked heads: kernel {ms:.3f} ms "
                       f"({4 * D * pairs * len(heads) / (ms * 1e-3) / 1e12:.1f} TFLOP/s on {pairs / S / S:.3f} "
                       f"of the S x S pairs), plain {plain_ms:.3f} ms; all BH={BH}: kernel {ms_all:.3f} ms "
                       f"({4 * D * pairs * BH / (ms_all * 1e-3) / 1e12:.1f} TFLOP/s)")
        del q, k, v, qs, ks, vs, out, ref
        if name == "svg1":
            entry = {"name": "block_sparse_attn", "route": "cuda",
                     "source": "sparse_videogen_tpu_torch/csrc/block_sparse_attn.cu",
                     "replaces": "sparse_videogen_tpu/ops/attention.py:62", "max_abs_err": max_abs,
                     "ms": ms, "plain_ms": plain_ms}
    return entry


def phase_kmeans(dev):
    """K5 at the SAP slice's shape (12 heads of one CFG stream, S tokens,
    D = 128, bf16), K = 50 and 200 centroids drawn from the tokens."""
    import torch.nn.functional as F

    from sparse_videogen_tpu_torch.core.kmeans import init_centroids
    from sparse_videogen_tpu_torch.ops.kmeans import kmeans_assign_update, kmeans_assign_update_plain

    lay = slice_layout()
    B, N, D = 12, lay.seq_len, 128
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(B, N, D, generator=gen, device=dev).to(torch.bfloat16)
    entry = None
    for K in (50, 200):
        c = init_centroids(x, K, gen)
        labels, sums, counts = kmeans_assign_update(x, c)
        again = kmeans_assign_update(x, c)
        ref_labels, ref_sums, ref_counts = kmeans_assign_update_plain(x, c)
        torch.cuda.synchronize()
        same_bits = all(torch.equal(a, b) for a, b in zip((labels, sums, counts), again))
        # labels: the f32 products sum in another order than the plain
        # version's, so near-ties may flip; they must agree wherever the
        # plain best-to-second gap exceeds 1e-3 x |best distance|, and on
        # >= 99.9% of the tokens; counts move by at most one per flip each way
        cf = c.float()
        top2 = ((cf * cf).sum(-1)[:, None, :] - 2.0 * torch.bmm(x.float(), cf.transpose(1, 2))).topk(
            2, dim=-1, largest=False).values
        clear = (top2[..., 1] - top2[..., 0]) > 1e-3 * top2[..., 0].abs()
        eq = labels == ref_labels
        flips = int((~eq).sum())
        count_moves = int((counts - ref_counts).abs().sum())
        # sums: against the plain segment sums of the kernel's own labels
        # (f32 sums of the same bf16 tokens in another order): <= 1e-5 of
        # the largest |sum|; and against the plain version's own sums over
        # the clusters no flipped token touches
        seg = torch.bmm(F.one_hot(labels.long(), K).float().transpose(1, 2), x.float())
        seg_rel = ((sums - seg).abs().max() / seg.abs().max()).item()
        touched = torch.zeros(B, K + 1, dtype=torch.bool, device=dev)  # column K: tokens that did not flip
        for lab in (labels, ref_labels):
            touched.scatter_(1, torch.where(eq, K, lab).long(), True)
        max_abs = (sums - ref_sums).abs().amax(-1).masked_fill(touched[:, :K], 0).max().item()
        ok = (same_bits and bool(eq[clear].all()) and eq.float().mean().item() >= 0.999
              and count_moves <= 2 * flips and seg_rel <= 1e-5)
        log("kernels", f"kmeans (B={B}, N={N}, D={D}, K={K}) bf16: two runs same bits {same_bits}; labels equal "
                       f"{eq.float().mean().item():.6f} ({flips} flips, all {int(clear.sum())} clear-gap tokens "
                       f"equal {bool(eq[clear].all())}, tol 0.999); count moves {count_moves} (tol {2 * flips}); "
                       f"sums vs plain segment sums of the kernel labels rel {seg_rel:.3e} (tol 1e-5); sums vs "
                       f"plain on untouched clusters max_abs_err {max_abs:.3e}")
        if not ok:
            raise AssertionError(f"kmeans kernel (K={K}) disagrees with its plain version or is not deterministic")
        ms = cuda_ms(lambda: kmeans_assign_update(x, c))
        plain_ms = cuda_ms(lambda: kmeans_assign_update_plain(x, c))
        tflops = 2 * B * N * K * D / (ms * 1e-3) / 1e12
        log("kernels", f"kmeans K={K}: kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s on x.c^T, "
                       f"{B * N * D * 2 / (ms * 1e-3) / 1e9:.1f} GB/s of x), plain {plain_ms:.4f} ms")
        entry = {"name": "kmeans", "route": "cuda", "source": "sparse_videogen_tpu_torch/csrc/kmeans.cu",
                 "replaces": "sparse_videogen_tpu/ops/kmeans_pallas.py:31", "max_abs_err": max_abs,
                 "ms": ms, "plain_ms": plain_ms}
    del x
    return entry


def _run_pairs(meta, block_q):
    """q x kv pairs a run-list metadata visits (every q row of a visited block)."""
    m = meta.cpu().numpy().astype(np.int64)
    a, b = m[..., 1::2], m[..., 2::2]
    return int(((b - a).sum(-1) * (m[..., 0] > 0)).sum()) * block_q


def phase_sap_attention(dev):
    """The run-list kernel on the inputs SAP's own front half builds (k-means,
    dynamic map, relabel, permutations, run lists) from random full-width
    q, k, v of one CFG stream (12 heads, S tokens, D = 128), at the CLI's SAP
    configuration; the first and last CHECK_HEADS heads are held against the
    plain version, for mask none and for the band_sink MaskSpec path. Then
    one full-width layer of SAP at full density against the dense kernel."""
    from sparse_videogen_tpu_torch.config import SAPConfig
    from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_runs, block_sparse_attention_runs_plain
    from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime
    from sparse_videogen_tpu_torch.sparse import svg2
    from sparse_videogen_tpu_torch.sparse.svg1 import make_svg1_plan

    lay = slice_layout()
    H, S, D = 12, lay.seq_len, 128
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = ((torch.randn(1, H, S, D, generator=gen, device=dev) * sc).to(torch.bfloat16) for sc in (2.0, 1.0, 1.0))
    sap = SAPConfig()
    state0 = svg2.init_sap_state(H, D, sap, device=dev)
    a = svg2.sap_prepare(q, k, v, state0, layout=lay, cfg=sap, generator=gen)
    heads = torch.tensor(list(range(CHECK_HEADS)) + list(range(H - CHECK_HEADS, H)), device=dev)
    qs, ks, vs, metas = (x.index_select(0, heads).contiguous() for x in (a.q, a.k, a.v, a.meta))
    pairs = _run_pairs(a.meta, sap.block_q)
    log("kernels", f"SAP front half (QC {sap.num_q_centroids}, KC {sap.num_k_centroids}, "
                   f"{sap.kmeans_iter_init} k-means iterations, top_p {sap.top_p_kmeans}): density "
                   f"{a.density.mean().item():.4f} (random weights: the centroid attention is flat); q padded "
                   f"{S} -> {a.q.shape[1]} rows, meta {tuple(a.meta.shape)}, visited pairs {pairs / H / S / S:.3f} "
                   f"of S x S per head (incl. padded q rows)")
    band = make_svg1_plan(lay).mask_spec
    entry = None
    for name, spec in (("none", MaskSpec()), ("band_sink", band)):
        kw = dict(block_q=sap.block_q, block_kv=sap.block_kv, mask_spec=spec)
        out = block_sparse_attention_runs(a.q, a.k, a.v, a.meta, **kw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        ref = block_sparse_attention_runs_plain(qs, ks, vs, metas, **kw)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)  # one run: the plain version is slow
        max_abs, mean_rel = err_stats(out.index_select(0, heads), ref)
        log("kernels", f"runs attention, mask {spec.kind} (H={H}, heads {heads.tolist()} checked, q rows "
                       f"{a.q.shape[1]}, kv {a.k.shape[1]}, D={D}, block_q {sap.block_q}, block_kv {sap.block_kv}): "
                       f"max_abs_err {max_abs:.3e} (tol {ATTN_TOL_ABS}), mean_rel_err {mean_rel:.3e} "
                       f"(tol {ATTN_TOL_REL})")
        if not (max_abs <= ATTN_TOL_ABS and mean_rel <= ATTN_TOL_REL):
            raise AssertionError(f"run-list attention kernel ({spec.kind}) disagrees with its plain version")
        ms = cuda_ms(lambda: block_sparse_attention_runs(qs, ks, vs, metas, **kw))
        ms_all = cuda_ms(lambda: block_sparse_attention_runs(a.q, a.k, a.v, a.meta, **kw))
        sub_pairs = _run_pairs(metas, sap.block_q)
        log("kernels", f"runs attention {spec.kind} on the {len(heads)} checked heads: kernel {ms:.3f} ms "
                       f"({4 * D * sub_pairs / (ms * 1e-3) / 1e12:.1f} TFLOP/s on the visited pairs), plain "
                       f"{plain_ms:.3f} ms (one run); all H={H}: kernel {ms_all:.3f} ms "
                       f"({4 * D * pairs / (ms_all * 1e-3) / 1e12:.1f} TFLOP/s)")
        if spec.kind == "none":
            entry = {"name": "block_sparse_attn_runs", "route": "cuda",
                     "source": "sparse_videogen_tpu_torch/csrc/runs_attn.cu",
                     "replaces": "sparse_videogen_tpu/ops/attention.py:720", "max_abs_err": max_abs,
                     "ms": ms, "plain_ms": plain_ms}
        del out, ref
    # every cluster pair selected: SAP must reproduce dense attention
    full = SAPConfig(top_p_kmeans=1.0, min_kc_ratio=1.0)
    out, st = svg2.sap_sparse_attention(q, k, v, svg2.init_sap_state(H, D, full, device=dev), layout=lay, cfg=full,
                                        generator=gen)
    dense = make_wan_runtime(lay, device=dev, pattern="dense")(q, k, v, 999.0, 0)
    torch.cuda.synchronize()
    max_abs, mean_rel = err_stats(out, dense)
    log("kernels", f"SAP at full density (top_p 1.0, min_kc_ratio 1.0; density {st.last_density.mean().item():.4f}) "
                   f"vs the dense kernel, one full-width layer: max_abs_err {max_abs:.3e} (tol {ATTN_TOL_ABS}), "
                   f"mean_rel_err {mean_rel:.3e} (tol {ATTN_TOL_REL})")
    if not (max_abs <= ATTN_TOL_ABS and mean_rel <= ATTN_TOL_REL):
        raise AssertionError("SAP at full density disagrees with dense attention")
    del q, k, v, a, qs, ks, vs, out, dense
    torch.cuda.empty_cache()
    return entry


def expected_launches(pattern, n_layers, sap, warmup, timesteps):
    """Kernel launches one generation implies. Per forward and layer: RoPE on
    q and on k; a dense warm-up layer runs the chunked-CSR kernel (so does
    every SVG1 layer: its sparse path uses the same kernel), a sparse SAP
    layer the run-list kernel. SAP runs the two CFG streams as separate
    forwards, and its k-means launches once per Lloyd iteration for q and for
    k: kmeans_iter_init at a layer's first clustering in a stream,
    kmeans_iter_step after (warm-up layers cluster only with
    zero_step_kmeans_init)."""
    want = {"block_sparse_attn": 0, "rope": 0, "block_sparse_attn_runs": 0, "kmeans": 0}
    streams = 2 if pattern == "SAP" else 1
    for _ in range(streams):
        initialized = [False] * n_layers
        for t in timesteps:
            for li in range(n_layers):
                want["rope"] += 2
                dense = li < warmup.first_layers or float(t) > warmup.first_times
                if pattern != "SAP":
                    want["block_sparse_attn"] += 1
                    continue
                want["block_sparse_attn" if dense else "block_sparse_attn_runs"] += 1
                if not dense or sap.zero_step_kmeans_init:
                    want["kmeans"] += 2 * (sap.kmeans_iter_step if initialized[li] else sap.kmeans_iter_init)
                    initialized[li] = True
    return want


def phase_slice(dev):
    """Full-size Wan 2.1 1.3B, SVG1 then SAP; returns each kernel's launches
    from the path that runs it (RoPE and the chunked kernel: SVG1)."""
    import json as _json

    from sparse_videogen_tpu_torch import _kernels
    from sparse_videogen_tpu_torch.config import SAPConfig, SVGConfig, WarmupSchedule
    from sparse_videogen_tpu_torch.models.wan.model import WAN_1_3B, WanModel
    from sparse_videogen_tpu_torch.pipelines import WanPipeline
    from sparse_videogen_tpu_torch.schedulers import FlowUniPC

    cfg = WAN_1_3B
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = WanModel(cfg, dtype=torch.bfloat16, device=dev).init_random(gen)
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen, device=dev).to(torch.bfloat16)
    ctx_null = torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen, device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log("slice", f"Wan 2.1 1.3B: dim {cfg.dim}, {cfg.num_layers} layers, {cfg.num_heads} heads, "
                 f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s")
    lay = slice_layout()
    sap = SAPConfig()  # the CLI's SAP defaults: cluster mode, QC 50, KC 200, 50 + 2 iterations, top_p 0.9
    timesteps = FlowUniPC(STEPS, shift=FLOW_SHIFT).timesteps
    warmup = WarmupSchedule.from_fractions(FIRST_LAYERS_FP, FIRST_TIMES_FP, cfg.num_layers, timesteps)
    counts = {}
    for pattern in ("SVG", "SAP"):
        events = []

        def on_step(i, lat):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

        with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
            dlog = os.path.join(tmp, "density.jsonl")
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            _kernels.reset_counts()
            start.record()
            t0 = time.perf_counter()
            lat = WanPipeline(model).generate_latents(
                ctx, ctx_null, height=HEIGHT, width=WIDTH, num_frames=NUM_FRAMES, num_inference_steps=STEPS,
                guidance_scale=GUIDANCE, flow_shift=FLOW_SHIFT, pattern=pattern,
                first_layers_fp=FIRST_LAYERS_FP, first_times_fp=FIRST_TIMES_FP,
                svg=SVGConfig(sparsity=SPARSITY), sap=sap, seed=0, callback=on_step,
                logging_file=dlog if pattern == "SAP" else None,
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_CALLS)
            dens = [_json.loads(line)["avg_density"] for line in open(dlog)] if pattern == "SAP" else []
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = [start.elapsed_time(events[0]) / 1e3] + [
            events[i - 1].elapsed_time(events[i]) / 1e3 for i in range(1, len(events))]
        finite = bool(torch.isfinite(lat).all())
        how = "cond and uncond as separate batch-1 forwards" if pattern == "SAP" else "CFG batch 2"
        log("slice", f"{HEIGHT}x{WIDTH}x{NUM_FRAMES} (S={lay.seq_len} = {lay.num_frames}x{lay.frame_size}), "
                     f"{pattern}, {STEPS} steps, {how}: per-step s {[round(s, 4) for s in steps]}, "
                     f"total {wall:.2f} s, peak memory {peak:.2f} GiB")
        if dens:
            log("slice", f"SAP density (cond stream, {len(dens)} logged layer-steps): mean {np.mean(dens):.4f}, "
                         f"min {min(dens):.4f}, max {max(dens):.4f} (random weights)")
        want = expected_launches(pattern, cfg.num_layers, sap, warmup, timesteps)
        log("slice", f"{pattern} launches {launches} (expected {want}), plain-version calls {plain}, "
                     f"latents {tuple(lat.shape)} finite {finite}, std {lat.std().item():.4f}")
        if launches != want:
            raise AssertionError(f"{pattern}: kernel launches {launches} != expected {want}")
        if any(plain.values()):
            raise AssertionError(f"{pattern}: the main path called a plain version: {plain}")
        if not finite or tuple(lat.shape) != (1, 16, lay.num_frames, HEIGHT // 8, WIDTH // 8):
            raise AssertionError(f"{pattern}: slice latents are not finite or have the wrong shape")
        for name, n in launches.items():
            if n and name not in counts:
                counts[name] = n
        del lat
    del model
    torch.cuda.empty_cache()
    return counts


def phase_small_reference(dev):
    """One forward of the CLI's small Wan, kernels on the card vs plain
    versions on the CPU, same weights and inputs: dense, SVG1, and SAP at
    full density (the two devices' k-means may split near-ties differently;
    at full density the output does not depend on the clustering)."""
    from sparse_videogen_tpu_torch.cli.wan_t2v import SMOKE_CFG
    from sparse_videogen_tpu_torch.config import SAPConfig
    from sparse_videogen_tpu_torch.models.wan.model import WanConfig, WanModel
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime, wan_layout

    cfg = WanConfig(**SMOKE_CFG)
    gen = torch.Generator().manual_seed(3)
    cpu_model = WanModel(cfg, dtype=torch.bfloat16, device="cpu").init_random(gen)
    gpu_model = WanModel(cfg, dtype=torch.bfloat16, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    lay = wan_layout(cfg, 96, 128, 9)
    rows = torch.randint(0, lay.seq_len, (cfg.num_layers, 64), generator=gen)
    sap = SAPConfig(num_q_centroids=8, num_k_centroids=12, kmeans_iter_init=8, top_p_kmeans=1.0, min_kc_ratio=1.0)
    for pattern in ("dense", "SVG", "SAP"):
        B = 1 if pattern == "SAP" else 2
        x = torch.randn(B, 16, lay.num_frames, 12, 16, generator=gen).to(torch.bfloat16)
        ctx = torch.randn(B, cfg.text_len, cfg.text_dim, generator=gen).to(torch.bfloat16)
        t = torch.full((B,), 900.0)
        outs = []
        for model, d in ((gpu_model, dev), (cpu_model, torch.device("cpu"))):
            rt = make_wan_runtime(lay, device=d, pattern=pattern, sap=sap)
            outs.append(model(x.to(d), t.to(d), ctx.to(d), attention=rt, profile_rows=rows,
                              generator=torch.Generator(device=d).manual_seed(0)).cpu())
        rel = ((outs[0] - outs[1]).norm() / outs[1].norm()).item()
        # bf16 model: CPU and GPU matmuls round at other places; 4 layers
        log("slice", f"small Wan forward, {pattern}: kernels on the card vs plain on the CPU, "
                     f"rel L2 err {rel:.3e} (tol 3e-2)")
        if not rel <= 3e-2:
            raise AssertionError(f"small forward ({pattern}) disagrees with the CPU reference: {rel}")


def phase_cli():
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        for pattern in ("SVG", "dense", "SAP"):
            out = os.path.join(tmp, f"smoke_{pattern}.npz")
            cmd = [sys.executable, "-m", "sparse_videogen_tpu_torch.cli.wan_t2v", "--smoke", "--pattern", pattern,
                   "--device", "cuda", "--output_file", out]
            t0 = time.perf_counter()
            subprocess.run(cmd, cwd=ROOT, check=True, timeout=600)
            lat = np.load(out)["latents"]
            finite = bool(np.isfinite(lat).all())
            log("cli", f"--smoke --pattern {pattern}: {os.path.basename(out)} exists, latents {lat.shape} "
                       f"finite {finite} ({time.perf_counter() - t0:.1f} s)")
            if not finite:
                raise AssertionError(f"CLI smoke ({pattern}) wrote non-finite latents")


def main():
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kernels = {"rope": phase_rope(dev), "block_sparse_attn": phase_attention(dev),
               "block_sparse_attn_runs": phase_sap_attention(dev), "kmeans": phase_kmeans(dev)}
    launches = phase_slice(dev)
    phase_small_reference(dev)
    phase_cli()
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
