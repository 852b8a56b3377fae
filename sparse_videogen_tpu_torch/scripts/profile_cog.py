"""Per-step time and per-kernel breakdown of CogVideoX 1.5 I2V on one GPU.

    python -m sparse_videogen_tpu_torch.scripts.profile_cog [--layers 4 --steps 5 \\
        --runs SVG,dense,dense,SVG --out cog.json]

COG_1_5_5B_I2V at its full width (hidden 3072, 48 heads, D = 64, FFN
12288, in_channels 32, ofs embedding) and --layers of its 42 blocks,
random bf16 weights from --seed, random T5 states of the real shape
(1, 226, 4096) for the prompt and the negative prompt and random image
latents (1, 16, 1, 96, 170), at 768x1360x81 (21 latent frames padded to
22: 11 x 4080 video tokens after 226 text tokens, S = 45,106) with the
reference's run (presets.COG_PRESETS: DDIM, guidance 6.0, CFG batch 2; SVG1
sparsity 0.25 with 32 sampled rows, first_times_fp 0.2, first_layers_fp
0.025; dense). Two parts, as scripts/profile_hyvideo.py:

  [time]    CogPipeline.generate_latents for --steps DDIM steps, once per
            entry of --runs (alternate the patterns to see drift), after one
            1-step warm-up generation per pattern; seconds per step from CUDA
            events recorded by the step callback (SVG1's dense warm-up steps,
            t > first_times, are reported apart), peak memory.
  [profile] one forward per pattern at the last timestep (past SVG1's
            dense warm-up steps) under torch.profiler: device time by
            category of kernel name (profile_wan's categories), launches,
            and the device idle share.

--out writes the same numbers as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from sparse_videogen_tpu_torch.presets import COG_PRESETS
from sparse_videogen_tpu_torch.scripts.profile_wan import profile_forward, time_generation
from sparse_videogen_tpu_torch.scripts.timing import device_line

RUNS = {"SVG": COG_PRESETS["cog-768p-svg"], "dense": COG_PRESETS["cog-768p-dense"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4, help="blocks to keep (of 42)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--runs", default="SVG,dense,dense,SVG")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args(argv)

    from sparse_videogen_tpu_torch.config import WarmupSchedule
    from sparse_videogen_tpu_torch.models.cog.model import CogModel
    from sparse_videogen_tpu_torch.pipelines import CogPipeline
    from sparse_videogen_tpu_torch.pipelines.cog import cog_layout, latent_frames, make_cog_runtime
    from sparse_videogen_tpu_torch.schedulers import CogDDIM

    smi = device_line("profile_cog")
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    base = RUNS["SVG"]
    cfg = dataclasses.replace(base.model, num_layers=args.layers)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    model = CogModel(cfg, dtype=torch.bfloat16, device=dev).init_random(gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    ctx, ctx_null = (torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen, device=dev).to(torch.bfloat16)
                     for _ in range(2))
    h_lat, w_lat = base.height // 8, base.width // 8
    img = torch.randn(1, cfg.out_channels, 1, h_lat, w_lat, generator=gen, device=dev)
    pipe = CogPipeline(model)
    lay = cog_layout(cfg, base.height, base.width, base.num_frames)
    print(f"[config] CogVideoX hidden {cfg.hidden_size}, {args.layers} layers ({n_params / 1e9:.3f} B params, init "
          f"{time.perf_counter() - t0:.1f} s), {cfg.heads_num} heads of {cfg.head_dim}; {base.height}x{base.width}x"
          f"{base.num_frames} (S = {lay.seq_len} = {cfg.text_len} + {lay.num_frames} x {lay.frame_size}), "
          f"{args.steps} steps, CFG batch 2", flush=True)
    runs = args.runs.split(",")
    timesteps = CogDDIM(args.steps).timesteps

    def generate(pattern, steps, callback=None):
        return pipe.generate_latents(ctx, ctx_null, img, num_inference_steps=steps, seed=args.seed,
                                     callback=callback, **RUNS[pattern].generate_kwargs())

    for pattern in dict.fromkeys(runs):
        generate(pattern, 1)
    result = {"device": smi, "layers": args.layers, "steps": args.steps, "params": n_params, "time": [],
              "profile": {}}
    for pattern in runs:
        lat, run = time_generation(lambda on_step: generate(pattern, args.steps, on_step))
        run_kw = RUNS[pattern].generate_kwargs()
        warm = WarmupSchedule.from_fractions(run_kw["first_layers_fp"], run_kw["first_times_fp"], cfg.num_layers,
                                             timesteps)
        dense_steps = [i for i, t in enumerate(timesteps) if pattern == "SVG" and float(t) > warm.first_times]
        run.update(pattern=pattern, dense_warmup_steps=dense_steps, finite=bool(torch.isfinite(lat).all()),
                   latents=list(lat.shape))
        print(f"[time] {pattern}: per-step s {run['per_step_s']} (dense warm-up steps {dense_steps}, "
              f"{warm.first_layers} dense layers) wall {run['wall_s']} s, peak {run['peak_gib']} GiB, latents "
              f"{run['latents']} finite {run['finite']}", flush=True)
        if not run["finite"] or run["latents"] != [1, 16, latent_frames(cfg, base.num_frames)[0], h_lat, w_lat]:
            raise AssertionError(f"{pattern}: latents are not finite or of the wrong shape")
        result["time"].append(run)

    x = torch.randn(2, cfg.in_channels, lay.num_frames * cfg.patch_size_t, h_lat, w_lat, generator=gen,
                    device=dev).to(torch.bfloat16)
    ctx2 = torch.cat([ctx, ctx_null])
    t = torch.full((2,), float(timesteps[-1]), device=dev)
    for pattern in dict.fromkeys(runs):
        run_kw = RUNS[pattern].generate_kwargs()
        warmup = WarmupSchedule.from_fractions(run_kw["first_layers_fp"], run_kw["first_times_fp"], cfg.num_layers,
                                               timesteps)
        rt = make_cog_runtime(lay, device=dev, pattern=pattern, warmup=warmup, svg=run_kw["svg"])
        if pattern != "dense" and rt.is_dense(cfg.num_layers - 1, float(t[0])):
            raise AssertionError(f"the profiled {pattern} forward would run dense (warm-up)")

        def forward():
            return model(x, t, ctx2, attention=rt, generator=gen)

        result["profile"][pattern] = profile_forward(f"{pattern} forward (CFG batch 2)", forward)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
