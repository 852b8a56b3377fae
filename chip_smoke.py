"""Drive the torch port of the Wan 2.1 T2V dense/SVG1 path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and the exit code
is non-zero:
  1. device  - needs torch.cuda; prints torch/CUDA versions, the card, its
               capability and `nvidia-smi` name and power limit.
  2. build   - compiles sparse_videogen_tpu_torch/csrc/*.cu with nvcc (sm_90a).
  3. kernels - each Hopper kernel against its plain PyTorch version at the
               slice's shapes (bf16), with the tolerance stated, and both
               timed with CUDA events.
  4. slice   - WanPipeline.generate_latents with Wan 2.1 1.3B at full width
               and depth (random weights from a seed), 480x832x81, SVG1,
               4 UniPC steps, batched CFG; kernel launch counts are read
               around the run. Then one forward of a small Wan with the
               kernels (on the card) against the plain versions (on the CPU).
  5. cli     - the port's CLI in --smoke mode for SVG and dense.
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
        # both accumulate in f32 with P rounded to bf16 for PV; they differ in
        # the order of sums and in where the running max rescales P (64-token
        # sub-tiles vs whole chunks), which moves bf16 roundings of P
        tol_abs, tol_rel = 2e-2, 1e-2
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


def phase_slice(dev):
    from sparse_videogen_tpu_torch.config import SVGConfig
    from sparse_videogen_tpu_torch import _kernels
    from sparse_videogen_tpu_torch.models.wan.model import WAN_1_3B, WanModel
    from sparse_videogen_tpu_torch.pipelines import WanPipeline

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
    events = []

    def on_step(i, lat):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    _kernels.reset_counts()
    start.record()
    t0 = time.perf_counter()
    lat = WanPipeline(model).generate_latents(
        ctx, ctx_null, height=HEIGHT, width=WIDTH, num_frames=NUM_FRAMES, num_inference_steps=STEPS,
        guidance_scale=GUIDANCE, flow_shift=FLOW_SHIFT, pattern="SVG",
        first_layers_fp=FIRST_LAYERS_FP, first_times_fp=FIRST_TIMES_FP,
        svg=SVGConfig(sparsity=SPARSITY), seed=0, callback=on_step,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = [start.elapsed_time(events[0]) / 1e3] + [
        events[i - 1].elapsed_time(events[i]) / 1e3 for i in range(1, len(events))]
    finite = bool(torch.isfinite(lat).all())
    log("slice", f"{HEIGHT}x{WIDTH}x{NUM_FRAMES} (S={lay.seq_len} = {lay.num_frames}x{lay.frame_size}), SVG1, "
                 f"{STEPS} steps, CFG batch 2: per-step s {[round(s, 4) for s in steps]}, "
                 f"total {wall:.2f} s, peak memory {peak:.2f} GiB")
    log("slice", f"launches {launches}, plain-version calls {plain}, latents {tuple(lat.shape)} "
                 f"finite {finite}, std {lat.std().item():.4f}")
    want = {"block_sparse_attn": cfg.num_layers * STEPS, "rope": 2 * cfg.num_layers * STEPS}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != expected {want}")
    if any(plain.values()):
        raise AssertionError(f"the main path called a plain version: {plain}")
    if not finite or tuple(lat.shape) != (1, 16, lay.num_frames, HEIGHT // 8, WIDTH // 8):
        raise AssertionError("slice latents are not finite or have the wrong shape")
    del model
    torch.cuda.empty_cache()
    return launches


def phase_small_reference(dev):
    """One forward of the CLI's small Wan, kernels on the card vs plain
    versions on the CPU, same weights and inputs, dense and SVG1."""
    from sparse_videogen_tpu_torch.cli.wan_t2v import SMOKE_CFG
    from sparse_videogen_tpu_torch.models.wan.model import WanConfig, WanModel
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime, wan_layout

    cfg = WanConfig(**SMOKE_CFG)
    gen = torch.Generator().manual_seed(3)
    cpu_model = WanModel(cfg, dtype=torch.bfloat16, device="cpu").init_random(gen)
    gpu_model = WanModel(cfg, dtype=torch.bfloat16, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    lay = wan_layout(cfg, 96, 128, 9)
    x = torch.randn(2, 16, lay.num_frames, 12, 16, generator=gen).to(torch.bfloat16)
    ctx = torch.randn(2, cfg.text_len, cfg.text_dim, generator=gen).to(torch.bfloat16)
    t = torch.full((2,), 900.0)
    rows = torch.randint(0, lay.seq_len, (cfg.num_layers, 64), generator=gen)
    for pattern in ("dense", "SVG"):
        outs = []
        for model, d in ((gpu_model, dev), (cpu_model, torch.device("cpu"))):
            rt = make_wan_runtime(lay, device=d, pattern=pattern)
            outs.append(model(x.to(d), t.to(d), ctx.to(d), attention=rt, profile_rows=rows).cpu())
        rel = ((outs[0] - outs[1]).norm() / outs[1].norm()).item()
        # bf16 model: CPU and GPU matmuls round at other places; 4 layers
        log("slice", f"small Wan forward, {pattern}: kernels on the card vs plain on the CPU, "
                     f"rel L2 err {rel:.3e} (tol 3e-2)")
        if not rel <= 3e-2:
            raise AssertionError(f"small forward ({pattern}) disagrees with the CPU reference: {rel}")


def phase_cli():
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        for pattern in ("SVG", "dense"):
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
    kernels = {"rope": phase_rope(dev), "block_sparse_attn": phase_attention(dev)}
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
