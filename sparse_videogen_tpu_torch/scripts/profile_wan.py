"""Per-step time and per-kernel breakdown of Wan 2.1 T2V (1.3B or 14B) or I2V (14B) on one GPU.

    python -m sparse_videogen_tpu_torch.scripts.profile_wan [--runs SVG,dense,SAP,SAP,dense,SVG]
    python -m sparse_videogen_tpu_torch.scripts.profile_wan --preset 14B-720p-sap --layers 4 \
        --steps 5 --runs SAP,dense,dense,SAP
    python -m sparse_videogen_tpu_torch.scripts.profile_wan --organic 4.0 --runs SAP
    python -m sparse_videogen_tpu_torch.scripts.profile_wan --preset 14B-720p-sap --layers 4 \
        --sap_block_mode tile --organic 3.5 --runs SAP,dense,dense,SAP
    python -m sparse_videogen_tpu_torch.scripts.profile_wan --inplace_temporal --runs SVG,SVG
    python -m sparse_videogen_tpu_torch.scripts.profile_wan --preset 14B-i2v-720p-svg --layers 2 \
        --steps 3 --runs SVG,dense,dense,SVG

--preset picks the model and its generation settings (presets.PRESETS):
1.3B-480p, Wan 2.1 1.3B with the CLI's sparsity, SAP (QC 50 / KC 200) and
warm-up; 14B-720p-sap, Wan 2.1 14B with the reference's Wan 720p SAP run
(QC 300 / KC 1000, min_kc_ratio 0.10, first_times_fp 0.2, first_layers_fp
0.03, flow shift 5.0); 14B-i2v-{480p,720p}-{svg,dense,sap}, Wan 2.1 I2V
14B with the reference's I2V runs (presets.I2V_PRESETS), given random CLIP
features (1, 257, 1280) and the condition of random image latents
(build_i2v_condition). Random bf16 weights from --seed at the model's full
width, --layers of its blocks (default: all), and a random (1, 512, 4096)
context (UMT5-XXL's shape). Dense and SVG1 batch CFG; SAP runs cond and
uncond as separate batch-1 forwards. --sap_block_mode (default: the
preset's, cluster) picks SAP's mode; tile takes the CLIs' tile settings
(presets.tile_variant: block_q = block_kv = 512). --organic GAIN (default off) gives SAP
an organic density instead of random weights' ~0.87 (utils/organic.py):
every self-attention's K projection := its Q projection, norm_q x GAIN, and
low-pass latents (smooth_latents) in both parts. --inplace_temporal runs
every SVG entry placement-free (SVG1Plan.inplace_temporal: the temporal heads
stay in place under K1's dual per-head spec); a measurement switch, the CLI
has no such flag. Two parts:

  [time]    WanPipeline.generate_latents for --steps UniPC steps, once per
            entry of --runs (alternate the patterns to see drift), after one
            1-step warm-up generation per pattern; seconds per step from CUDA
            events recorded by the step callback. SAP's first sparse step
            includes its cold k-means (kmeans_iter_init iterations).
  [profile] one denoising step's forwards per pattern (without the UniPC
            update, at the second timestep; SAP's k-means warm, its states
            made by one forward before) under torch.profiler: device time by
            category of kernel name, launches, and the device idle share =
            1 - (union of device-activity intervals) / (their span). For SAP,
            one more step's forwards outside the profiler record its density
            and the share of the loaded 128-token K/V tile columns that its
            metadata keeps live (ops/attention.py runs_tile_stats, or
            csr_tile_stats in tile mode).

--out writes the same numbers as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile
import time

import torch

from sparse_videogen_tpu_torch.presets import PRESETS

# (category, substrings of the kernel name); first match wins, the rest is elementwise
CATEGORIES = (
    ("K1 attention (bsa_kernel)", ("bsa_kernel", "bsa_stats_kernel", "bsa_dual_kernel")),
    ("K2 RoPE (rope_kernel)", ("rope_kernel",)),
    ("K3 run-list attention (runs_kernel)", ("runs_kernel", "runs_stats_kernel")),
    ("K5 k-means (kmeans_*_kernel)", ("kmeans_",)),  # K5's kernels (K8's variants run on them)
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce_kernel",)),
    ("copy/memset/cat", ("copy", "Memcpy", "Memset", "CatArray")),
    ("sort/scan/gather/scatter (SAP index maps)", ("sort", "Sort", "scan", "Scan", "gather", "scatter", "index",
                                                   "Index")),
)


def category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "elementwise"


def breakdown(events):
    """events: (name, start_ns, end_ns) of device activity -> per-category
    {ms, launches}, total device ms, busy (union) ms, span ms."""
    cats: dict[str, dict] = {}
    for name, s, e in events:
        c = cats.setdefault(category(name), {"ms": 0.0, "launches": 0})
        c["ms"] += (e - s) / 1e6
        c["launches"] += 1
    busy, cur_s, cur_e = 0, None, None
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += 0 if cur_e is None else cur_e - cur_s
    span = max(e for _, _, e in events) - min(s for _, s, _ in events)
    return cats, sum(c["ms"] for c in cats.values()), busy / 1e6, span / 1e6


def time_generation(generate):
    """Runs generate(callback) once with the kernel counters set to 0 just
    before it and read just after; the step callback records a CUDA event a
    step. Returns (its output, {per_step_s, wall_s, peak_gib, launches,
    kind_launches, plain_calls}); the first step includes the set-up."""
    from sparse_videogen_tpu_torch import _kernels

    events = []

    def on_step(i, lat):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    start = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counts()
    start.record()
    t0 = time.perf_counter()
    out = generate(on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = [start.elapsed_time(events[0]) / 1e3] + [
        events[i - 1].elapsed_time(events[i]) / 1e3 for i in range(1, len(events))]
    return out, {"per_step_s": steps, "wall_s": wall, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "launches": dict(_kernels.LAUNCHES), "kind_launches": dict(_kernels.KIND_LAUNCHES),
                 "plain_calls": dict(_kernels.PLAIN_CALLS)}


def profile_forward(label, forward):
    """forward() once to warm up, then once under torch.profiler with the
    kernel counters set to 0; prints the device time by category, the idle
    share and the launches under `label` ("<pattern> <what>"), and returns
    them."""
    from sparse_videogen_tpu_torch import _kernels

    forward()
    torch.cuda.synchronize()
    _kernels.reset_counts()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    with prof:
        forward()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev_events = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        raise RuntimeError("torch.profiler recorded no device activity")
    cats, total, busy, span = breakdown(dev_events)
    idle = 1 - busy / span
    print(f"[profile] {label}: host wall {wall} s (profiler on), {len(dev_events)} device events, device time "
          f"{total} ms, busy (union) {busy} ms of span {span} ms -> idle share {idle}; launch counters "
          f"{dict(_kernels.LAUNCHES)}", flush=True)
    pattern = label.split()[0]
    for cat, c in sorted(cats.items(), key=lambda kv: -kv[1]["ms"]):
        print(f"[profile] {pattern} {cat}: {c['ms']} ms ({100 * c['ms'] / total:.1f}%), {c['launches']} launches",
              flush=True)
    return {"host_wall_s": wall, "device_ms": total, "busy_ms": busy, "span_ms": span, "idle_share": idle,
            "categories": cats, "launches": dict(_kernels.LAUNCHES)}


def sap_run_list_stats(forward):
    """forward() once (outside the profiler), recording every sparse SAP
    layer's metadata: the live tokens and loaded 128-token tile columns of
    its run lists (runs_tile_stats; cluster mode) or chunked-CSR rows
    (csr_tile_stats; tile mode), and SAP's density."""
    from sparse_videogen_tpu_torch.ops.attention import csr_tile_stats, runs_tile_stats
    from sparse_videogen_tpu_torch.sparse import svg2

    prepare, live, loaded, dens = svg2.sap_prepare, [], [], []

    def recording(*args, **kw):
        a = prepare(*args, **kw)
        n_live, n_tiles = (csr_tile_stats if a.kernel == "csr" else runs_tile_stats)(a.meta)
        live.append(n_live.sum())
        loaded.append(128 * n_tiles.sum())
        dens.append(a.density.mean())
        return a

    svg2.sap_prepare = recording
    try:
        forward()
    finally:
        svg2.sap_prepare = prepare
    if not dens:
        raise AssertionError("the SAP forward ran no sparse layer")
    out = {"layers": len(dens), "density_mean": torch.stack(dens).mean().item(),
           "live_columns": int(sum(live)), "loaded_columns": int(sum(loaded))}
    out["live_column_share"] = out["live_columns"] / out["loaded_columns"]
    print(f"[profile] SAP metadata over {out['layers']} sparse layer calls: density {out['density_mean']}, "
          f"{out['live_columns']} live of {out['loaded_columns']} loaded 128-token tile columns, live share "
          f"{out['live_column_share']}", flush=True)
    return out


PROJECTED_STEPS = 50  # the CLIs' default step count


def project_steps(runs, run_cfg, layers, timesteps=None) -> dict:
    """The DiT's seconds for a PROJECTED_STEPS-step generation at the model's full
    depth, from the timed runs at `layers` blocks: a layer-step's seconds are
    a run's last step (steady state; it includes the few per-step
    operations outside the blocks) over `layers`, the median over the runs
    of a pattern; the preset's warm-up (first_layers_fp, first_times_fp at
    PROJECTED_STEPS steps of `timesteps`, by default FlowUniPC's) makes that
    many layer-steps dense. Printed and returned per sparse pattern, with
    dense; {} without a dense run."""
    from sparse_videogen_tpu_torch.config import WarmupSchedule
    from sparse_videogen_tpu_torch.schedulers import FlowUniPC

    per_layer = {}
    for r in runs:
        per_layer.setdefault(r["pattern"], []).append(r["per_step_s"][-1] / layers)
    per_layer = {p: sorted(v)[len(v) // 2] for p, v in per_layer.items()}
    if "dense" not in per_layer:
        return {}
    steps, full = PROJECTED_STEPS, run_cfg.model.num_layers
    ts = FlowUniPC(steps, shift=run_cfg.flow_shift).timesteps if timesteps is None else timesteps
    warm = WarmupSchedule.from_fractions(run_cfg.first_layers_fp, run_cfg.first_times_fp, full, ts)
    n_dense_steps = sum(float(t) > warm.first_times for t in ts)
    out = {"steps": steps, "layers": full, "from_layers": layers, "dense_s": steps * full * per_layer["dense"]}
    for p, s in per_layer.items():
        if p != "dense":
            dense_ls = n_dense_steps * full + (steps - n_dense_steps) * warm.first_layers
            out[f"{p}_s"] = dense_ls * per_layer["dense"] + (steps * full - dense_ls) * s
    print(f"[projection] the DiT for {steps} steps at {full} layers, from the last step of each run at {layers} "
          f"layers (s a layer-step {per_layer}; {n_dense_steps} dense warm-up steps, {warm.first_layers} dense "
          f"layers a step): " + ", ".join(f"{k} {v}" for k, v in out.items() if k.endswith("_s")), flush=True)
    return out


def i2v_inputs(cfg, lat_shape, gen, dev) -> dict:
    """generate_latents' I2V arguments for an I2V model (none for T2V):
    random CLIP features (1, 257, image_dim) and the condition
    (build_i2v_condition) of random image latents of `lat_shape`."""
    from sparse_videogen_tpu_torch.pipelines.wan import build_i2v_condition

    if cfg.model_type != "i2v":
        return {}
    clip_fea = torch.randn(1, 257, cfg.image_dim, generator=gen, device=dev).to(torch.bfloat16)
    img_lat = torch.randn(1, *lat_shape, generator=gen, device=dev)
    return {"clip_fea": clip_fea, "latent_cond": build_i2v_condition(img_lat)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=tuple(PRESETS), default="1.3B-480p")
    ap.add_argument("--layers", type=int, default=None, help="blocks to keep (default: the model's depth)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--runs", default="SVG,dense,SAP,SAP,dense,SVG")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    ap.add_argument("--organic", type=float, default=None, metavar="GAIN",
                    help="K := Q with norm_q x GAIN and smooth latents (utils/organic.py); default off")
    ap.add_argument("--inplace_temporal", action="store_true", help="run SVG1 placement-free (K1's dual spec)")
    ap.add_argument("--sap_block_mode", choices=("cluster", "tile"), default=None,
                    help="SAP's mode (default: the preset's); tile takes block_q = block_kv = 512")
    args = ap.parse_args(argv)

    from sparse_videogen_tpu_torch.config import WarmupSchedule
    from sparse_videogen_tpu_torch.models.wan.model import WanModel
    from sparse_videogen_tpu_torch.presets import tile_variant
    from sparse_videogen_tpu_torch.pipelines import WanPipeline
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime, wan_layout
    from sparse_videogen_tpu_torch.schedulers import FlowUniPC
    from sparse_videogen_tpu_torch.utils.organic import align_self_attn_qk, smooth_latents

    if not torch.cuda.is_available():
        raise RuntimeError("profile_wan needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    run_cfg = PRESETS[args.preset]
    if args.sap_block_mode is not None and args.sap_block_mode != run_cfg.sap.block_mode:
        run_cfg = dataclasses.replace(run_cfg, sap=tile_variant(run_cfg.sap) if args.sap_block_mode == "tile" else
                                      dataclasses.replace(run_cfg.sap, block_mode="cluster"))
    svg, sap = run_cfg.generate_kwargs()["svg"], run_cfg.sap
    cfg = dataclasses.replace(run_cfg.model, num_layers=args.layers or run_cfg.model.num_layers)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = WanModel(cfg, dtype=torch.bfloat16, device=dev).init_random(gen)
    if args.organic is not None:
        align_self_attn_qk(model, gain=args.organic)
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen, device=dev).to(torch.bfloat16)
    ctx_null = torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen, device=dev).to(torch.bfloat16)
    pipe = WanPipeline(model)
    gen_kw = dict(run_cfg.generate_kwargs(), seed=args.seed, inplace_temporal=args.inplace_temporal)
    lay = wan_layout(cfg, run_cfg.height, run_cfg.width, run_cfg.num_frames)
    lat_shape = (cfg.out_dim, lay.num_frames, run_cfg.height // 8, run_cfg.width // 8)
    if args.organic is not None:
        gen_kw["latents"] = smooth_latents(gen, (1, *lat_shape), dtype=torch.float32)
    cond = i2v_inputs(cfg, lat_shape, gen, dev)
    gen_kw.update(cond)
    print(f"[config] {args.preset}: Wan 2.1 {cfg.model_type} dim {cfg.dim}, {cfg.num_layers} layers, "
          f"{cfg.num_heads} heads, S = {lay.seq_len} ({lay.num_frames}x{lay.frame_size}); "
          f"{run_cfg.height}x{run_cfg.width}x{run_cfg.num_frames}, {args.steps} steps; SAP QC {sap.num_q_centroids} "
          f"KC {sap.num_k_centroids} min_kc_ratio {sap.min_kc_ratio} {sap.block_mode} mode; "
          + ("random weights" if args.organic is None else f"organic, gain {args.organic}")
          + ("; SVG1 in place (dual spec)" if args.inplace_temporal else ""), flush=True)
    runs = args.runs.split(",")
    for pattern in dict.fromkeys(runs):
        pipe.generate_latents(ctx, ctx_null, num_inference_steps=1, pattern=pattern, **gen_kw)
    result = {"device": smi, "preset": args.preset, "sap_block_mode": sap.block_mode, "layers": cfg.num_layers,
              "organic_gain": args.organic,
              "inplace_temporal": args.inplace_temporal, "time": [], "profile": {}}
    tmp = tempfile.TemporaryDirectory()
    dlog = os.path.join(tmp.name, "density.jsonl")  # SAP's density log of the cond stream

    for pattern in runs:
        _, run = time_generation(lambda on_step: pipe.generate_latents(
            ctx, ctx_null, num_inference_steps=args.steps, pattern=pattern, callback=on_step,
            logging_file=dlog if pattern == "SAP" else None, **gen_kw))
        run["pattern"] = pattern
        if pattern == "SAP":
            with open(dlog) as f:
                dens = [json.loads(line)["avg_density"] for line in f]
            run["density_mean"] = sum(dens) / len(dens)
        print(f"[time] {pattern}: per-step s {run['per_step_s']} wall {run['wall_s']} s (the first step includes "
              f"set-up)" + (f"; SAP density mean {run['density_mean']} (cond stream)" if pattern == "SAP" else ""),
              flush=True)
        result["time"].append(run)
    result["projection"] = project_steps(result["time"], run_cfg, cfg.num_layers)

    sch = FlowUniPC(args.steps, shift=run_cfg.flow_shift)
    warmup = WarmupSchedule.from_fractions(run_cfg.first_layers_fp, run_cfg.first_times_fp, cfg.num_layers,
                                           sch.timesteps)
    ctx_pair = torch.cat([ctx, ctx_null])
    if args.organic is None:
        x = torch.randn(2, *lat_shape, generator=gen, device=dev).to(torch.bfloat16)
    else:
        x = smooth_latents(gen, (2, *lat_shape))
    t = torch.full((2,), float(sch.timesteps[1]), device=dev)
    clip2 = None if not cond else torch.cat([cond["clip_fea"]] * 2)
    if cond:
        x = torch.cat([x, torch.cat([cond["latent_cond"]] * 2).to(x.dtype)], dim=1)
    for pattern in dict.fromkeys(runs):
        rt = make_wan_runtime(lay, device=dev, pattern=pattern, warmup=warmup, svg=svg, sap=sap,
                              inplace_temporal=args.inplace_temporal)
        if pattern != "dense" and rt.is_dense(0, float(t[0])):
            raise AssertionError(f"the profiled {pattern} forward would run dense (warm-up)")
        states = [{}, {}]  # SAP: the k-means states of the cond and uncond streams

        def step_forwards():
            if pattern != "SAP":
                return model(x, t, ctx_pair, attention=rt, generator=gen, clip_fea=clip2)
            for s in range(2):  # SAP: one batch-1 forward per CFG stream, each with its own states
                rt.states = states[s]
                model(x[s:s + 1], t[:1], ctx_pair[s:s + 1], attention=rt, generator=gen,
                      clip_fea=None if clip2 is None else clip2[s:s + 1])

        result["profile"][pattern] = profile_forward(f"{pattern} step forwards", step_forwards)
        if pattern == "SAP":
            result["profile"][pattern]["run_lists"] = sap_run_list_stats(step_forwards)
    tmp.cleanup()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
