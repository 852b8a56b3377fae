"""The stages of a HunyuanVideo generation on one GPU, each timed with CUDA
events beside its peak memory, and a 50-step video projected from them.

    python -m sparse_videogen_tpu_torch.scripts.hyvideo_stages [--double 2 --single 2 --steps 3 --out st.json]

All at the published widths with random weights from --seed:
  [text]  LLaMA-3-8B (30 of its 32 layers, bf16) on crop_start 95 +
          text_len 256 = 351 tokens, and CLIP-L's text tower (bf16) on 77,
          each warm (the mean of 5 calls after one);
  [dit]   HYVIDEO_T2 with --double of its 20 double and --single of its 40
          single blocks at 720x1280x129 (S = 118,800 + 256 text), --steps
          Euler steps of the reference's SVG1 run (presets hyvideo-720p-svg)
          and of the dense run, after a 1-step warm-up generation each;
  [vae]   the full-width VAE (128/256/512/512, f32) decoding all 33 latent
          frames of a 720p video through the CLI's default tiled decoder (28
          tiles of 32 x 32 latents, overlap 8), with cuDNN's TF32 off and
          on (the CLI leaves torch's default, on), and encoding one 720p
          frame (the I2V image), TF32 off and on; the decode's FLOPs
          counted on the meta device (torch.utils.flop_counter);
  [projection] a 50-step 720p video: the encoders, the DiT at 60 blocks
          (profile_wan.project_steps on Euler's 50 timesteps: the preset's
          warm-up steps and layers dense; a block-step is a run's last step
          over its blocks) and the TF32 decode.
The card's name and power limit head the output (nvidia-smi); --out writes
the numbers as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging

import torch

from sparse_videogen_tpu_torch.scripts.timing import cuda_ms, device_line

CROP_TEXT_TOKENS = 95 + 256
CLIP_TOKENS = 77


def timed_once(fn):
    """(fn()'s result, ms between two CUDA events, peak GiB since a reset)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), torch.cuda.max_memory_allocated() / 2**30


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--double", type=int, default=2)
    ap.add_argument("--single", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--prompt", type=int, default=32, help="live prompt tokens of the 256")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from sparse_videogen_tpu_torch.cli._common import make_vae_decoder
    from sparse_videogen_tpu_torch.cli.hyvideo_t2v import build_parser
    from sparse_videogen_tpu_torch.models.common.clip import CLIP_L_TEXT, CLIPTextModel
    from sparse_videogen_tpu_torch.models.common.llama import LLAMA3_8B, LlamaModel
    from sparse_videogen_tpu_torch.models.hyvideo.model import HyVideoModel
    from sparse_videogen_tpu_torch.models.hyvideo.vae import HyVideoVAE, HyVideoVAEConfig
    from sparse_videogen_tpu_torch.pipelines import HyVideoPipeline
    from sparse_videogen_tpu_torch.pipelines.hyvideo import hyvideo_layout
    from sparse_videogen_tpu_torch.presets import HY_720P_DENSE, HY_720P_SVG
    from sparse_videogen_tpu_torch.schedulers import FlowMatchEuler
    from sparse_videogen_tpu_torch.scripts.profile_wan import project_steps, time_generation
    from torch.utils.flop_counter import FlopCounterMode

    smi = device_line("hyvideo_stages")
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    result = {"device": smi, "double": args.double, "single": args.single, "steps": args.steps}

    # the text encoders, warm
    llama = LlamaModel(LLAMA3_8B, n_layers=LLAMA3_8B.num_layers - 2, device=dev).init_random(gen)
    ids = torch.randint(0, LLAMA3_8B.vocab_size, (1, CROP_TEXT_TOKENS), generator=gen, device=dev)
    mask = torch.zeros(1, CROP_TEXT_TOKENS, dtype=torch.int32, device=dev)
    mask[0, :95 + args.prompt] = 1
    _, _, llama_gib = timed_once(lambda: llama(ids, mask))
    llama_ms = cuda_ms(lambda: llama(ids, mask), iters=5, warmup=1)
    n_llama = sum(p.numel() for p in llama.parameters())
    flops = 2 * (n_llama - llama.embed.numel()) * CROP_TEXT_TOKENS
    bound_ms = max(n_llama * 2 / 3.35e12, flops / 989e12) * 1e3
    del llama
    torch.cuda.empty_cache()
    clip = CLIPTextModel(CLIP_L_TEXT, dtype=torch.bfloat16, device=dev).init_random(gen)
    cids = torch.randint(0, CLIP_L_TEXT.vocab_size - 1, (1, CLIP_TOKENS), generator=gen, device=dev)
    clip_ms = cuda_ms(lambda: clip(cids), iters=5, warmup=1)
    del clip
    result["text"] = {"llama_ms": llama_ms, "llama_peak_gib": llama_gib, "llama_params": n_llama,
                      "llama_tflop": flops / 1e12, "llama_bound_ms": bound_ms, "clip_ms": clip_ms}
    print(f"[text] LLaMA-3-8B 30 of 32 layers, bf16, {CROP_TEXT_TOKENS} tokens: {llama_ms:.2f} ms (peak "
          f"{llama_gib:.2f} GiB; {flops / 1e12:.2f} TFLOP, {n_llama * 2 / 2**30:.2f} GiB of weights: bound "
          f"{bound_ms:.2f} ms); CLIP-L text, {CLIP_TOKENS} tokens: {clip_ms:.2f} ms", flush=True)

    # the DiT's step times, projected to 50 steps at 60 blocks
    cfg = dataclasses.replace(HY_720P_SVG.model, mm_double_blocks_depth=args.double, mm_single_blocks_depth=args.single)
    model = HyVideoModel(cfg, dtype=torch.bfloat16, device=dev).init_random(gen)
    text = torch.randn(1, cfg.text_len, cfg.text_states_dim, generator=gen, device=dev).to(torch.bfloat16)
    tmask = torch.zeros(1, cfg.text_len, dtype=torch.int32, device=dev)
    tmask[0, :args.prompt] = 1
    pooled = torch.randn(1, cfg.text_states_dim_2, generator=gen, device=dev).to(torch.bfloat16)
    runs = []
    for run in (HY_720P_SVG, HY_720P_DENSE):
        def generate(steps, callback=None, run=run):
            return HyVideoPipeline(model).generate_latents(text, tmask, pooled, prompt_length=args.prompt,
                                                           num_inference_steps=steps, seed=args.seed,
                                                           callback=callback, **run.generate_kwargs())
        generate(1)
        lat, r = time_generation(lambda on_step: generate(args.steps, on_step))
        r["pattern"] = run.pattern
        runs.append(r)
        print(f"[dit] {run.pattern}: per-step s {r['per_step_s']}, peak {r['peak_gib']:.2f} GiB", flush=True)
    del model
    torch.cuda.empty_cache()
    lay = hyvideo_layout(cfg, HY_720P_SVG.height, HY_720P_SVG.width, HY_720P_SVG.num_frames)
    proj = project_steps(runs, HY_720P_SVG, args.double + args.single,
                         timesteps=FlowMatchEuler(50, shift=HY_720P_SVG.flow_shift).timesteps)
    result["dit"] = {"runs": [{k: v for k, v in r.items() if k != "latents"} for r in runs], "projection": proj}

    # the VAE: all 33 latent frames of a 720p video, tiled; one frame's encode
    vae = HyVideoVAE(HyVideoVAEConfig(), device=dev).init_random(gen)
    decode = make_vae_decoder(build_parser().parse_args([]), vae, logging.getLogger("hyvideo_stages"))
    z = torch.randn(1, 16, lay.num_frames, HY_720P_SVG.height // 8, HY_720P_SVG.width // 8, generator=gen, device=dev)
    img = torch.rand(1, 3, 1, HY_720P_SVG.height, HY_720P_SVG.width, generator=gen, device=dev) * 2 - 1
    meta_vae = HyVideoVAE(HyVideoVAEConfig(), device="meta")
    with FlopCounterMode(display=False) as counter:
        make_vae_decoder(build_parser().parse_args([]), meta_vae, logging.getLogger("hyvideo_stages"))(
            torch.empty(tuple(z.shape), device="meta"))
    dec_tflop = counter.get_total_flops() / 1e12
    result["vae"] = {"decode_tflop": dec_tflop}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        video, ms, gib = timed_once(lambda: decode(z))
        _, enc_ms, enc_gib = timed_once(lambda: vae.encode(img))
        finite = bool(torch.isfinite(video).all())
        key = "tf32" if tf32 else "f32"
        result["vae"][key] = {"decode_ms": ms, "decode_tflops": dec_tflop / ms * 1e3, "decode_peak_gib": gib,
                              "encode_1frame_ms": enc_ms,
                              "encode_peak_gib": enc_gib, "finite": finite, "shape": list(video.shape)}
        print(f"[vae] cuDNN TF32 {tf32}: decode {lay.num_frames} latent frames tiled -> {tuple(video.shape)} "
              f"{ms / 1e3:.2f} s ({dec_tflop:.0f} TFLOP of convolutions and matmuls, {dec_tflop / ms * 1e3:.1f} "
              f"TFLOP/s), peak {gib:.2f} GiB, finite {finite}; encode one 720p frame {enc_ms:.1f} ms, peak "
              f"{enc_gib:.2f} GiB", flush=True)
        del video
        if not finite:
            raise AssertionError("the VAE decode is not finite")
    torch.backends.cudnn.allow_tf32 = False

    enc_s = (llama_ms + clip_ms) / 1e3
    dec_s = result["vae"]["tf32"]["decode_ms"] / 1e3
    if proj:
        total = {p[:-2]: enc_s + proj[p] + dec_s for p in proj if p.endswith("_s")}
        result["projection_s"] = total
        print(f"[projection] a 50-step 720x1280x129 HunyuanVideo T2V video: " + ", ".join(
            f"{p} {s:.1f} s" for p, s in total.items()) + f" (encoders {enc_s:.3f} s, the TF32 decode {dec_s:.1f} s)",
            flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
