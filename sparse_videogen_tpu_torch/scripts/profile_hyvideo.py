"""Per-step time and per-kernel breakdown of HunyuanVideo T2V on one GPU.

    python -m sparse_videogen_tpu_torch.scripts.profile_hyvideo [--double 2 --single 2 --steps 4 \\
        --runs SVG,dense,dense,SVG --out hy.json]
    python -m sparse_videogen_tpu_torch.scripts.profile_hyvideo --runs SAP,dense,dense,SAP \\
        --sap_block_mode tile --organic 3.5
    python -m sparse_videogen_tpu_torch.scripts.profile_hyvideo --i2v --runs SVG,dense,dense,SVG

HYVIDEO_T2 at its full width (hidden 3072, 24 heads, D = 128, MLP 12288),
--double of its 20 double-stream and --single of its 40 single-stream
blocks, random bf16 weights from --seed, random text states of the real
shapes ((1, 256, 4096) LLaMA, (1, 768) CLIP pooled) with a live prompt of
--prompt tokens, at 720x1280x129 (S = 119,056) with the reference's 720p
runs (presets.HY_PRESETS: SVG1 sparsity 0.25, first_times_fp 0.1, flow shift
7.0; dense; SAP at QC 400 / KC 1000 (zero_step_kmeans_init off, as the
JAX CLI runs the script), in
--sap_block_mode cluster or tile). --i2v runs the I2V CLI's presets
instead (hyvideo-i2v-720p-svg / -dense: in_channels 33, embedded guidance
1.0, first_times_fp 0.15) with random image latents as the latent_concat
condition; I2V has no SAP run. --organic GAIN (default 3.5, the JAX
package's scripts/bench_hyvideo.py; 0 turns it off) makes the attention
video-like for every run of the call, so that SAP's density is organic
(utils/organic.py): in every block the fused projections' k rows := their q
rows, the q norms x GAIN, and low-pass latents (smooth_latents); random
weights alone keep ~0.87 of the scores. Two parts, as
scripts/profile_wan.py:

  [time]    HyVideoPipeline.generate_latents for --steps Euler steps, once per
            entry of --runs (alternate the patterns to see drift), after one
            1-step warm-up generation per pattern; seconds per step from CUDA
            events recorded by the step callback.
  [profile] one forward per pattern at the second timestep (past SVG1's
            dense warm-up steps; SAP's k-means warm from the warm-up
            forward) under torch.profiler: device time by category of kernel
            name (profile_wan's categories), launches, and the device idle
            share; for SAP one more forward records its density and live
            column share (profile_wan.sap_run_list_stats).

--out writes the same numbers as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from sparse_videogen_tpu_torch.presets import HY_PRESETS
from sparse_videogen_tpu_torch.scripts.profile_wan import profile_forward, sap_run_list_stats, time_generation
from sparse_videogen_tpu_torch.scripts.timing import device_line

RUNS = {"SVG": HY_PRESETS["hyvideo-720p-svg"], "dense": HY_PRESETS["hyvideo-720p-dense"],
        "SAP": HY_PRESETS["hyvideo-720p-sap"]}
I2V_RUNS = {"SVG": HY_PRESETS["hyvideo-i2v-720p-svg"], "dense": HY_PRESETS["hyvideo-i2v-720p-dense"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--double", type=int, default=2, help="double-stream blocks to keep (of 20)")
    ap.add_argument("--single", type=int, default=2, help="single-stream blocks to keep (of 40)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--runs", default="SVG,dense,dense,SVG")
    ap.add_argument("--prompt", type=int, default=32, help="live prompt tokens of the 256")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sap_block_mode", choices=("cluster", "tile"), default="cluster")
    ap.add_argument("--organic", type=float, default=3.5, metavar="GAIN",
                    help="k := q in the fused projections, q norms x GAIN, smooth latents; 0 = random weights")
    ap.add_argument("--i2v", action="store_true", help="the I2V CLI's presets, random image latents")
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args(argv)

    from sparse_videogen_tpu_torch.config import WarmupSchedule
    from sparse_videogen_tpu_torch.models.hyvideo.model import HyVideoModel
    from sparse_videogen_tpu_torch.pipelines import HyVideoPipeline
    from sparse_videogen_tpu_torch.pipelines.hyvideo import hyvideo_layout, i2v_condition, make_hyvideo_runtime
    from sparse_videogen_tpu_torch.schedulers import FlowMatchEuler
    from sparse_videogen_tpu_torch.utils.organic import align_fused_qkv, smooth_latents

    runs_cfg = dict(RUNS, SAP=RUNS["SAP"] if args.sap_block_mode == "cluster" else HY_PRESETS["hyvideo-720p-sap-tile"])
    if args.i2v:
        runs_cfg = I2V_RUNS

    smi = device_line("profile_hyvideo")
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    base = runs_cfg["SVG"]
    cfg = dataclasses.replace(base.model, mm_double_blocks_depth=args.double, mm_single_blocks_depth=args.single)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = HyVideoModel(cfg, dtype=torch.bfloat16, device=dev).init_random(gen)
    if args.organic:
        align_fused_qkv(model, cfg.hidden_size, gain=args.organic)
    text = torch.randn(1, cfg.text_len, cfg.text_states_dim, generator=gen, device=dev).to(torch.bfloat16)
    mask = torch.zeros(1, cfg.text_len, dtype=torch.int32, device=dev)
    mask[0, :args.prompt] = 1
    pooled = torch.randn(1, cfg.text_states_dim_2, generator=gen, device=dev).to(torch.bfloat16)
    pipe = HyVideoPipeline(model)
    lay = hyvideo_layout(cfg, base.height, base.width, base.num_frames)
    lat_shape = (cfg.out_channels, lay.num_frames, base.height // 8, base.width // 8)
    print(f"[config] HunyuanVideo{' I2V' if args.i2v else ''} hidden {cfg.hidden_size}, {args.double}+{args.single} "
          f"blocks, {cfg.heads_num} heads; "
          f"{base.height}x{base.width}x{base.num_frames} (S = {lay.seq_len}), prompt {args.prompt}, {args.steps} steps; "
          f"SAP {args.sap_block_mode} mode; " + (f"organic, gain {args.organic}" if args.organic else "random weights"),
          flush=True)
    runs = args.runs.split(",")
    dlog = "profile_hyvideo_density.jsonl" if args.out is None else args.out + ".density.jsonl"

    lat0 = smooth_latents(gen, (1, *lat_shape), dtype=torch.float32) if args.organic else None
    img_lat = (0.1 * torch.randn(1, cfg.out_channels, 1, *lat_shape[2:], generator=gen, device=dev)
               if args.i2v else None)

    def generate(pattern, steps, callback=None, logging_file=None):
        kw = runs_cfg[pattern].generate_kwargs()
        return pipe.generate_latents(text, mask, pooled, prompt_length=args.prompt, num_inference_steps=steps,
                                     seed=args.seed, callback=callback, logging_file=logging_file, latents=lat0,
                                     image_latents=img_lat, **kw)

    for pattern in dict.fromkeys(runs):
        generate(pattern, 1)
    result = {"device": smi, "i2v": args.i2v, "double": args.double, "single": args.single, "prompt": args.prompt,
              "sap_block_mode": args.sap_block_mode, "organic_gain": args.organic, "time": [], "profile": {}}
    for pattern in runs:
        _, run = time_generation(lambda on_step: generate(pattern, args.steps, on_step,
                                                          dlog if pattern == "SAP" else None))
        run["pattern"] = pattern
        if pattern == "SAP":
            with open(dlog) as f:
                dens = [json.loads(line)["avg_density"] for line in f]
            run["density_mean"] = sum(dens) / len(dens)
        print(f"[time] {pattern}: per-step s {run['per_step_s']} wall {run['wall_s']} s, peak {run['peak_gib']} GiB"
              + (f"; SAP density mean {run['density_mean']}" if pattern == "SAP" else ""), flush=True)
        result["time"].append(run)

    x = smooth_latents(gen, (1, *lat_shape)) if args.organic else torch.randn(
        1, *lat_shape, generator=gen, device=dev).to(torch.bfloat16)
    if args.i2v:
        x = torch.cat([x.float(), i2v_condition(cfg, img_lat, lay.num_frames)], dim=1).to(torch.bfloat16)
    guidance = torch.full((1,), base.embedded_guidance_scale * 1000.0, device=dev)
    for pattern in dict.fromkeys(runs):
        run_cfg = runs_cfg[pattern]
        sch = FlowMatchEuler(args.steps, shift=run_cfg.flow_shift)
        warmup = WarmupSchedule.from_fractions(run_cfg.first_layers_fp, run_cfg.first_times_fp, cfg.num_layers,
                                               sch.timesteps)
        t = torch.full((1,), float(sch.timesteps[min(1, args.steps - 1)]), device=dev)
        rt = make_hyvideo_runtime(dataclasses.replace(lay, prompt_length=args.prompt), device=dev,
                                  prompt_length=args.prompt, pattern=pattern, warmup=warmup,
                                  svg=run_cfg.generate_kwargs()["svg"], sap=run_cfg.sap)
        if pattern != "dense" and rt.is_dense(cfg.num_layers - 1, float(t[0])):
            raise AssertionError(f"the profiled {pattern} forward would run dense (warm-up)")

        def forward():
            return model(x, t, text, mask, pooled, guidance=guidance, attention=rt, generator=gen)

        result["profile"][pattern] = profile_forward(f"{pattern} forward", forward)
        if pattern == "SAP":
            result["profile"][pattern]["run_lists"] = sap_run_list_stats(forward)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
