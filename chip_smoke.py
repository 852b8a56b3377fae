"""Drive the torch port's main paths once on one NVIDIA GPU: Wan 2.1 T2V
dense/SVG1/SAP (cluster and tile mode), FSDP-sharded, and from a prompt to
a video, the prompt extender on a Qwen2.5-7B-wide LM, Wan
2.1 I2V 14B from an image and a prompt to a video, HunyuanVideo T2V
dense/SVG1/SAP (both modes) and from a prompt, and from an image and a
prompt, to a video, CogVideoX 1.5 I2V dense/SVG1 and from an image and a
prompt to a video, Cosmos T2V dense/SVG1/SAP (both modes) from a prompt to
a video, and the probe entries of K6 and K8.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and the exit code
is non-zero:
  1. device  - needs torch.cuda; prints torch/CUDA versions, the card, its
               capability and `nvidia-smi` name and power limit.
  2. build   - compiles sparse_videogen_tpu_torch/csrc/*.cu with nvcc (sm_90a)
               and prints ptxas' registers, spills and shared memory of
               every K1 (bsa_kernel<D, KIND>), K3/K4 (runs_kernel<D>) and K7
               (dense_kernel<D, MODE>) instance, all on the CTA body of
               csrc/hopper_attn.cuh, and of K5's assign kernel with K8's
               variants (kmeans_assign_kernel<D, V>); an instance that is
               missing or spills fails the phase.
  3. kernels - each Hopper kernel against its plain PyTorch version at the
               slices' shapes (bf16), with the tolerance stated, and both
               timed with CUDA events: RoPE, the chunked-CSR attention (dense
               and SVG1 metadata), the run-list attention on the run lists of
               SAP's own front half at 480p (mask none, and band_sink for its
               MaskSpec path, each beside F.scaled_dot_product_attention
               with the run lists, and the predicate, as an attn_mask) and
               one full-width layer of SAP at full density against the
               dense kernel, and the share of the loaded 128-token K/V
               tile columns that the run lists keep live; k-means at the
               480p SAP shape (12
               heads, 32,760 tokens, K = 50 and 200) and at Wan 2.1 14B 720p's
               (40 heads, 75,600 tokens, K = 300 and 1000) and the five probe
               variants (K = 300 and 125), each twice for the same bits; then
               the run-list attention on the run lists of the 720p SAP
               config's own front half (QC 300, KC 1000). K1's hyvideo kind at
               HunyuanVideo 720p x 129 (S = 119,056, 24 heads) on the
               pipeline runtime's dense and SVG1 metadata; K6 (Triton RMSNorm)
               on its probe's shapes; K7 (q-split dense attention) at (12,
               32768, 128) and (12, 32768, 64) for every (bq, qsplit) it
               compiles; K1 at D = 64,
               its cog kind and its unmasked dense path, at CogVideoX 768 x
               1360 x 81 (S = 45,106, 96 rows) on the pipeline runtime's
               metadata (the cog kind beside SDPA with its mask as an (S, S)
               attn_mask), and K2 at D = 64 on CogVideoX's video rows. The
               run-list attention's band_sink check also counts the pairs its
               predicate allows (K4's bound). Each entry of the kernels line
               carries its bound (bytes or operations over the H100's peaks)
               and, where one PyTorch call computes the same function, that
               call's time. SAP's tile mode and text-last layouts (phase
               "sap kernels"): K1 with kind none on the chunked-CSR metadata
               tile mode builds on the device, at Wan 1.3B 480p and 14B 720p
               (QC 300, KC 1000), against its plain version (720p: on
               CHECK_BLOCKS q blocks of each checked head) and beside SDPA
               with the tile mask as an attn_mask on one head; HunyuanVideo
               720p's SAP front half (hyvideo-720p-sap) in cluster mode (K3
               on run lists with the prompt and padding clusters) and tile
               mode (K1 on the grain-aligned text-last metadata), each
               against its plain version on sampled and every text q block.
               Cosmos 704x1280x121 (S = 16 x 3,520 = 56,320, a frame size
               that is not a multiple of 128; phase_cosmos_attention): K1's
               kinds none and band_sink on the pipeline runtime's metadata
               (64 rows of the CFG batch), 2 rows held to the plain version
               on CHECK_BLOCKS q blocks (keep_blocks: the predicate sees the
               real positions), timed beside the bound and SDPA (with the
               band_sink predicate as a 6.3 GB attn_mask); K3 on the run
               lists of cosmos-704p-sap's own front half (QC 300, KC 1000).
  4. slice   - WanPipeline.generate_latents with random weights from a seed:
               Wan 2.1 1.3B at full width and depth, 480x832x81, STEPS UniPC
               steps, SVG1 with batched CFG, then SAP (cluster mode, the CLI's
               defaults) with cond and uncond as separate forwards; the K8
               probe's entry (probe_kmeans_variants.probe) on its own data;
               Wan 2.1 14B at full width and LAYERS_14B layers, 720x1280x81,
               5 UniPC steps, SAP at the reference's 720p config;
               HunyuanVideo (HYVIDEO_T2 at full width, HY_DOUBLE + HY_SINGLE
               blocks) through HyVideoPipeline.generate_latents at
               720x1280x129, SVG1 for HY_STEPS_SVG steps (one dense warm-up
               step) and dense for HY_STEPS_DENSE, prompt HY_PROMPT of 256
               text tokens, then the hyvideo-720p-sap run (QC 400, KC 1000)
               in cluster and in tile mode for HY_STEPS_SAP steps (one
               dense warm-up step, K1's hyvideo kind, that also clusters),
               with SAP's density; the K6 and K7 probe entries on their own
               data;
               CogVideoX 1.5 5B I2V (COG_1_5_5B_I2V at full width, COG_LAYERS
               layers) through CogPipeline.generate_latents at 768x1360x81,
               SVG1 then dense for COG_STEPS DDIM steps (CFG batch 2).
               The Wan 1.3B slice also runs SVG1 in place (placement-free,
               K1's dual per-head spec) from the same seed and weights and
               holds its latents to the placement run's, and SAP in tile
               mode (--sap_block_mode tile: K1 with kind none).
               Each path's kernel launch counts, and K1's launches by mask
               kind, are read around its run and held to what the
               configuration implies. Then one forward of a
               small Wan, a small HunyuanVideo and a small CogVideoX with the
               kernels (on the card) against the plain versions (on the CPU).
               The phases inplace_svg1 and stats (in the kernels phase) and
               ring (after the slices):
               inplace_svg1: K1's dual spec on 4 heads of Wan 1.3B 480p
                 (both classes) against its plain version, timed beside its
                 bound, masked SDPA and the placement path, and at block_q
                 1024, 512 and 128 with the dual metadata's visited
                 sub-blocks; a temporal head's loaded slabs and their
                 TILE_ALL / TILE_SOME / TILE_NONE classes (slab_tile_walk's
                 model); rows with a hole refused before the launch;
               stats: the (m, l) stats of K1 (each kind, D = 64 and 128, and
                 the dual spec), K3 and K4 against the plain versions, o with
                 stats bit for bit o without;
               ring: the thread communicator with RING_N ranks on the card,
                 the dense ring on Wan 1.3B 480p q/k/v against single-device
                 K1 (time per rotation, merge), the SAP ring against
                 single-device SAP on the same labels, and Wan 1.3B forwards
                 of RING_LAYERS layers through RingDenseRuntime and
                 RingSAPRuntime (their stats kernels' launches counted).
               quant (after the slices): the CLIs' --quant, Wan 2.1 1.3B at
                 full width and QUANT_LAYERS layers, 480x832x81, dense and
                 SVG1 in bf16, int8 W8A8 and fp8 weight-only, each held to
                 its launches and within QUANT_LATENT_TOL of bf16, with its
                 s a warm step and peak GiB; the block linears' device ms by
                 part (the per-token quantize, the int8 GEMM, the rescale;
                 fp8's upcast) and one int8 forward's ops by device time;
                 the int8 GEMM at fc1's shape beside bf16 F.linear with both
                 bounds; HunyuanVideo 720p (2 + 2 blocks) one dense step in
                 each.
               dpm: --sampler dpm++, Wan 1.3B (QUANT_LAYERS layers, 480p) for
                 DPM_STEPS SVG1 steps, and the small Wan on the card against
                 the CPU.
               ulysses: ThreadRanks on the card: Wan 1.3B (ULYSSES_LAYERS
                 layers, 480p) dense, SVG1 and SAP over ULYSSES_SP head ranks
                 against one device (dense bit for bit, the runtime on
                 full-width q/k/v too), USP (ring 2 x heads 2) dense on
                 HunyuanVideo 720p, the dense ring on CogVideoX 768p and
                 Cosmos 704p (2 layers), launches held to the ranks' share,
                 the s a step beside one device's.
               fsdp: FSDP weight sharding (parallel/sharding.py) on Wan 2.1
                 14B T2V at its published widths, FSDP_LAYERS of 40 layers,
                 480x832x81: one dense and one SVG1 step unsharded, then
                 sharded over the thread-rank grids FSDP_GRIDS (dp 2; dp 2
                 x sp 2), latents bit for bit the unsharded ones; each
                 rank's resident bytes against the whole model's, the full
                 40-layer tree's as the rule shards it, a block's
                 all-gather ms, the s a step and the K1 / qk_norm_rope launches.
               prompt_extend (beside the build: the LM launches no kernel
                 of the port): TorchQwenPromptExpander on the port's causal
                 LM at Qwen2.5-7B-Instruct's published widths (QWEN25_7B,
                 random bf16 weights, ~15 GB) and a Qwen2-style tokenizer
                 file the phase writes: PE_NEW_TOKENS greedy tokens, twice,
                 the same ids; ms a token and peak GiB; PE_CHECK_LAYERS
                 layers' logits on the card against the same weights' f32
                 logits on the CPU (PE_LOGIT_TOL).
               timer: utils/timer.time_logging around K1 within TIMER_TOL of
                 the phase's own CUDA events.
               p2v (after the slices): Wan 2.1 T2V from a prompt to a
                 video at full width (phase_prompt_to_video): the port's
                 tokenizer on a spiece.model this script writes, UMT5-XXL
                 (random bf16 weights), Wan 2.1 1.3B 480x832x81 for
                 P2V_STEPS SVG1 steps, the Wan VAE (dim 96, random) through
                 the CLI's default decoder (12 tiles), a .y4m read back,
                 and an .mp4 encoded on the card (PIL blocked) whose
                 sha256 must equal the CPU's encode of the same frames,
                 read back by the port's decoder (check_mp4, in a thread
                 from the end of i2v: frames, fps, PSNR);
                 each stage timed with its peak memory, K1 and the fused norms held to
                 the configuration's launches with no plain-version call;
                 then the decode in each mode (whole, streamed by 1 and 2
                 latent frames, on the first DECODE_MODE_FRAMES latent
                 frames; whole and streamed held to each other) and
                 with cuDNN's TF32 on, and dense steps, for the projection
                 of a CLI_STEPS-step generation. A small UMT5 and Wan VAE on
                 the card against the CPU (UMT5_TOL, VAE_TOL); a small I2V
                 Wan with clip_fea, a small CLIP (CLIP_TOL) and a small VAE
                 encoder (whole and streamed, VAE_TOL) likewise.
               i2v (after p2v): Wan 2.1 I2V from an image to a video at
                 the 14B width (phase_i2v): examples/1/image.jpg decoded by
                 io/image.py on the host, CLIP ViT-H/14 at its full depth
                 (random f32), random text states of UMT5-XXL's shape, the
                 Wan VAE encode (dim 96) whole and streamed, held to each
                 other (VAE_TOL), build_i2v_condition, LAYERS_I2V of the 40
                 layers at 480x832x81 for I2V_STEPS SVG1 steps (one dense
                 warm-up layer) with K1 by kind and the fused norms held to
                 expected_launches and no plain-version call, the tiled
                 decode and the .y4m read back; each stage timed with its
                 peak memory; dense steps and the projection of a
                 CLI_STEPS-step generation at 40 layers.
               hy_p2v (after i2v): HunyuanVideo T2V from a prompt to a
                 video at full width (phase_hy_p2v): the port's
                 tokenizer.json reader on LLaMA-3-style and CLIP-style files
                 this script writes (the template's special tokens held to
                 their ids), LLaMA-3-8B (30 of 32 layers) and CLIP-L (random
                 bf16) through HyVideoTextEncoders at 95 + 256 = 351 tokens,
                 HYVIDEO_T2 (HY_DOUBLE + HY_SINGLE blocks) at 720x1280x129
                 for HY_P2V_STEPS SVG1 steps, the full-width VAE through the
                 CLI's default tiled decoder on the first HY_DECODE_FRAMES
                 latent frames, a .y4m read back; K1 and the fused norms held to
                 expected_launches with no plain-version call; each stage
                 timed with its peak memory.
               hy_i2v (after hy_p2v): HunyuanVideo I2V (phase_hy_i2v):
                 examples/1/image.jpg resized to 720x1280 (cubic), the
                 full-width VAE encode of it, Llava at full width (CLIP
                 ViT-L/14-336, the projector, hy_p2v's LLaMA-3-8B) with
                 LLAVA_INTERLEAVE, the in_channels 33 DiT for HY_I2V_STEPS
                 dense steps, launches held likewise. A small LLaMA, CLIP
                 text tower, Llava and HunyuanVideo VAE (decode whole and
                 tiled, encode) on the card against the CPU (TEXT_TOL,
                 VAE_TOL) join the small references.
               cog_i2v (after hy_i2v): CogVideoX from an image and a prompt
                 to a video (phase_cog_i2v): a spiece.model this script
                 writes, T5 v1.1 XXL (random bf16) at 226 tokens,
                 examples/1/image.jpg resized bilinearly to 768x1360, the
                 full-width VAE encode (f32 and TF32), COG_1_5_5B_I2V at
                 COG_LAYERS layers for COG_I2V_STEPS SVG1 steps, the CLI's
                 tiled decode of COG_DECODE_FRAMES latent frames, a .y4m at
                 8 fps read back; K1 by kind and K2 held to
                 expected_launches, no plain version; stages timed with
                 their peak memory.
               cosmos (after cog_i2v): Cosmos from a prompt to a video
                 (phase_cosmos): t5-11b's encoder (random bf16, 4.9 B
                 parameters) at 512 tokens, masked; COSMOS_7B at full width,
                 COSMOS_LAYERS of 28 layers, 704x1280x121: dense, SVG1, and
                 SAP cluster and tile (cosmos-704p-sap, organic at
                 COSMOS_SAP_GAIN) for a few EDM steps each, through
                 drive_pipeline (K1 none / band_sink, K3, K5 held to the
                 configuration; Cosmos's RoPE is plain torch); the dense
                 steps a 35-step run takes (WarmupSchedule's c_noise
                 offset), SAP's density, the s a step by pattern and the
                 35-step, 28-layer projection; the CV8x8x8 VAE's tiled
                 decode of COSMOS_DECODE_FRAMES latent frames, a .y4m at
                 30 fps read back. Small T5 v1.0 / v1.1, CogVideoX and
                 Cosmos VAEs (f32) and a small Cosmos (bf16: dense, SVG1,
                 SAP at full density) on the card against the CPU join the
                 small references.
               quality (after cosmos): scripts/quality.py's recipe without the
                 decode: Wan 2.1 1.3B structured-synthetic (K := Q, gain
                 4.0) at 720x1280x81, 8 steps, dense, SVG1, SAP cluster and
                 SAP tile (QC 300, KC 125) from one noise, and dense with
                 int8 W8A8 block linears, launches held to the
                 configuration; latent PSNR / SSIM against dense, SAP's
                 densities; SVG1 and dense_int8 >= 35 dB and each SAP mode
                 >= 24 dB or the run fails.
  5. cli     - (started before the quality phase, checked after the small
               references) the port's CLIs, all started together: --smoke for Wan T2V
               and I2V and HunyuanVideo for SVG, dense, SAP and SAP with
               --sap_block_mode tile, HunyuanVideo I2V for sparse and dense,
               CogVideoX for SVG and dense; the Wan and HunyuanVideo T2V
               smokes with a video name (their tiny VAEs, a .y4m); the Wan
               T2V CLI on a checkpoint dir written by write_tiny_checkpoint
               (the port's safetensors writer, the reference's names) from a
               prompt to a .y4m, and the Wan I2V CLI on an I2V one (the
               VAE's encoder, a CLIP tower in HF's names) from
               examples/1/image.jpg and a prompt to a .y4m; the HunyuanVideo
               T2V and I2V CLIs likewise on write_tiny_hyvideo_checkpoint's
               dirs (tokenizer.json files written by hand; a Llava text
               encoder for I2V); Cosmos --smoke for SVG, dense, SAP and
               SAP-tile, the CogVideoX and Cosmos smokes with a video name,
               and cog_i2v / cosmos_t2v on write_tiny_cog_checkpoint /
               write_tiny_cosmos_checkpoint's dirs (T5 and its config.json
               in HF's names; CogVideoX from examples/1/image.jpg), to a
               .y4m each.
Each group of phases prints its seconds on a [time] line, and the whole
run's seconds are printed before the two JSON lines.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import json
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# the Wan 1.3B slice's steps (2: a cold SAP step, then a warm one); 5 steps:
# first_times_fp 0.2 gives the 720p run one dense warm-up step
STEPS, STEPS_14B = 2, 5
# Wan 2.1 14B keeps its full width (dim 5120, 40 heads, FFN 13824) and the
# first LAYERS_14B of its 40 blocks: the smoke's time limit, not the card's
# memory, bounds the depth (PERF.md section 4)
LAYERS_14B = 2
CHECK_HEADS = 2  # first and last heads held against the plain attention (the plain version is slow)
# at 720p and more the plain attention holds the checked heads on this many
# q blocks spread over each (and every text block): q blocks are independent
CHECK_BLOCKS = 24
KMEANS_CHUNK = 8  # heads per plain k-means call: (8, 75,600, 1000) f32 distances are 2.4 GB
TIMED_ITERS = 5
# the run-list and chunked attention kernels against their plain versions:
# both accumulate in f32 with P rounded to bf16 for PV; they differ in the
# order of sums and in where the running max rescales P (64-token sub-tiles
# vs whole chunks), which moves bf16 roundings of P
ATTN_TOL_ABS, ATTN_TOL_REL = 2e-2, 1e-2
# masked SDPA (a yardstick) against the chunked kernel: SDPA does not round
# q * scale to bf16 before QK^T as the kernel does, which moves every logit
# by up to 2^-9 of itself; rows that attend few columns (HunyuanVideo's
# fake text rows) average that over few values
SDPA_TOL_ABS = 5e-2
# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor-core FLOP/s,
# f32 FLOP/s outside the tensor cores, HBM3 bytes/s; a kernel's bound is the
# larger of its operations over the peak and its bytes (each input read once,
# each output written once) over the memory rate
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
PEAK_TF32_FLOPS = 495e12  # tensor cores on f32 inputs, where TF32 is allowed
# HunyuanVideo: HYVIDEO_T2's full width, the first HY_DOUBLE of its 20 double
# and HY_SINGLE of its 40 single blocks (the time limit bounds the depth,
# PERF.md section 4); the SVG1 run takes HY_STEPS_SVG steps with
# first_times_fp HY_WARMUP_FP, one dense warm-up step as the presets' 0.1
# gives of 10; a live prompt of HY_PROMPT of the 256 text tokens
HY_DOUBLE, HY_SINGLE = 2, 2
HY_STEPS_SVG, HY_STEPS_DENSE, HY_WARMUP_FP = 5, 2, 0.2
# the hyvideo-720p-sap runs (cluster and tile): first_times_fp HY_WARMUP_FP
# makes step 0 of HY_STEPS_SAP a dense warm-up step (which does not
# cluster: the JAX CLI drops zero_step_kmeans_init), step 1 clusters cold,
# the rest warm; at the organic gain of the JAX package's
# scripts/bench_hyvideo.py (random weights keep ~0.87 of the scores)
HY_STEPS_SAP = 5
HY_SAP_GAIN = 3.5
HY_PROMPT = 32
# CogVideoX: COG_1_5_5B_I2V's full width, the first COG_LAYERS of its 42
# layers (PERF.md section 4); COG_STEPS DDIM steps make first_times_fp 0.2
# one dense warm-up step
COG_LAYERS, COG_STEPS = 4, 5
# SVG1 in place against placement over a whole generation (30 bf16 layers of
# random weights, STEPS steps): the two paths visit a temporal head's
# columns in other orders and tiles, so P and the outputs round to bf16 at
# other places, and the random model carries those differences forward
INPLACE_LATENT_TOL = 5e-2
# the (m, l) stats of the Hopper kernels against their plain versions: m
# from the same bf16 q, k in f32 (the wgmma and torch sum the D products in
# other orders; |m| is tens), l a sum of f32 exponentials (ex2.approx against
# torch's exp2, other order)
STATS_TOL_M, STATS_TOL_L_REL = 1e-3, 1e-4
# ring attention: how many ranks the thread communicator runs on the card
RING_N = 2
RING_LAYERS = 2
# --quant on the card: Wan 1.3B at full width and QUANT_LAYERS of its 30
# layers, QUANT_STEPS steps (the first includes the set-up, the rest are
# warm); each quantized run's latents within QUANT_LATENT_TOL rel L2 of the
# bf16 run's: e4m3 keeps 3 mantissa bits (a weight off by up to 2^-4 of
# itself), W8A8 a step of 1/127 of a token's (a channel's) largest value;
# a wrong scale, layout or slice moves them by O(1)
QUANT_LAYERS, QUANT_STEPS, QUANT_LATENT_TOL = 2, 3, 0.1
# the int8 GEMM at Wan 1.3B's fc1 on the CFG pair at 480p: 2 x 32,760 tokens, 1,536 -> 8,960
INT8_FC1 = (65520, 1536, 8960)
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core operations a second (H100 SXM data sheet)
DPM_STEPS = 3
# Ulysses over ULYSSES_SP head ranks (threads on the card) on Wan 1.3B,
# ULYSSES_LAYERS layers: SVG1 and SAP within ULYSSES_TOL rel L2 of one
# device on the same rows and draws (batched matmuls of another head count
# may round otherwise); the ring on the other families within
# RING_FAMILY_TOL, the ring forward's bound (each rotation's output rounds to
# bf16 before the f32 merge)
ULYSSES_SP, ULYSSES_LAYERS, ULYSSES_TOL, RING_FAMILY_TOL = 2, 2, 1e-2, 3e-2
# the model's own kernels (K2 RoPE, the fused LayerNorm + modulation, the fused q/k RMSNorm + RoPE): one launch a
# site a forward on any mesh, as the activations are whole on every rank (the attention alone is split over head or
# data ranks)
MODEL_KERNELS = ("rope", "layernorm_mod", "qk_norm_rope")
# FSDP (parallel/sharding.py): Wan 2.1 14B T2V at its published widths and
# FSDP_LAYERS of its 40 layers, 480x832x81, over the thread-rank grids
# FSDP_GRIDS (dp, rp, sp); the latents held bit for bit to the unsharded
# model's; a block's all-gather timed over FSDP_GATHER_ITERS
FSDP_LAYERS, FSDP_GRIDS, FSDP_GATHER_ITERS = 4, ((2, 1, 1), (2, 1, 2)), 5
# the prompt extender on the port's LM at Qwen2.5-7B-Instruct's published
# widths (config.json of Qwen/Qwen2.5-7B-Instruct: hidden 3584, 28 layers, 28
# heads, 4 KV heads, FFN 18944, vocab 152064, rope theta 1e6, q/k/v biases,
# an untied head): PE_NEW_TOKENS greedy tokens, twice; the logits of
# PE_CHECK_LAYERS of its layers on the card (bf16 weights and activations)
# within PE_LOGIT_TOL rel L2 of the same weights' f32 logits on the CPU
QWEN25_7B = dict(vocab_size=152064, dim=3584, ffn_dim=18944, num_layers=28, num_heads=28, num_kv_heads=4,
                 rope_theta=1e6)
PE_NEW_TOKENS, PE_CHECK_LAYERS, PE_LOGIT_TOL = 16, 2, 3e-2
QWEN25_REGULAR_TOKENS = 151643  # Qwen2.5's BPE tokens; <|endoftext|>, <|im_start|>, <|im_end|> follow
# utils/timer.time_logging around K1 within TIMER_TOL of the phase's own CUDA events
TIMER_ITERS, TIMER_TOL = 5, 0.05
# prompt -> video (Wan 2.1 1.3B 480x832x81): P2V_STEPS UniPC steps, projected
# to the CLI's CLI_STEPS; the small UMT5 and VAE on the card against the CPU
# in f32 with TF32 off: UMT5 differs by summation order; cuDNN may pick FFT or
# Winograd convolutions, whose f32 rounding departs from a direct sum by ~1e-5
P2V_STEPS, CLI_STEPS = 2, 50
# the decode modes (whole, streamed by 1 and 2) are held to each other on the
# first DECODE_MODE_FRAMES of the 21 latent frames (the smoke's time limit)
DECODE_MODE_FRAMES = 5
UMT5_TOL, VAE_TOL = 1e-5, 1e-4
# .mp4 on the card's host, with PIL blocked: the p2v video through
# export_video (the JPEGs encoded on the card) and the same uint8 frames
# encoded on the CPU must give the same file; read back by the port's own
# decoder in MP4_READ_WORKERS processes (half the host's cores: the later
# phases drive the card from the other half), its frames at least MP4_MIN_PSNR dB
# from the uint8 frames they encode (a sanity bound for quality 95 at 4:4:4;
# the .y4m's frames are printed beside them, but the .y4m is 4:2:0 and
# truncates: on the random VAE's noise-like frames it lies far below 30 dB)
MP4_MIN_PSNR, MP4_READ_WORKERS = 30.0, max(1, (os.cpu_count() or 2) // 2)
# image -> video (Wan 2.1 I2V 14B at 480x832x81): its full width and the first
# LAYERS_I2V of its 40 layers, so that first_layers_fp 0.3 gives one dense
# warm-up layer beside three SVG1 layers (both of K1's kinds run); the
# smoke's time limit, not the card's memory, bounds the depth. I2V_STEPS
# SVG1 steps (the last one warm), then 2 dense for the projection. A small
# CLIP on the card against the CPU in f32 (TF32 off): summation order only
LAYERS_I2V, I2V_STEPS = 4, 3
CLIP_TOL = 1e-5
# HunyuanVideo from a prompt (hy_p2v) and from an image (hy_i2v): HY_DOUBLE +
# HY_SINGLE blocks at 720x1280x129, HY_P2V_STEPS SVG1 and HY_I2V_STEPS dense
# steps; the full-width VAE decodes the first HY_DECODE_FRAMES of the 33
# latent frames (17 frames) with the CLI's numerics (cuDNN TF32 on); Llava
# keeps every LLAVA_INTERLEAVE-th image patch: at the CLI's default
# interleave 1 its 576 patches do not fit the 256 text positions (ROADMAP.md
# section 3). The small LLaMA, CLIP text tower and Llava on the card against
# the CPU in f32 (TF32 off): summation order only
HY_P2V_STEPS, HY_I2V_STEPS, HY_DECODE_FRAMES = 2, 2, 5
LLAVA_INTERLEAVE = 4
TEXT_TOL = 1e-5
# CogVideoX from an image to a video (cog_i2v): COG_LAYERS layers of the DiT
# for COG_I2V_STEPS SVG1 steps; the full-width VAE decodes the first
# COG_DECODE_FRAMES of the 21 latent frames (9 frames)
COG_I2V_STEPS, COG_DECODE_FRAMES = 3, 3
# Cosmos from a prompt to a video (cosmos): COSMOS_7B's full width and the
# first COSMOS_LAYERS of its 28 layers at 704x1280x121; COSMOS_STEPS EDM
# steps (first_times_fp 0.3 makes the first two dense, the last two sparse:
# SAP clusters cold, then warm) and COSMOS_STEPS_DENSE dense steps; SAP at the
# organic gain of the other SAP phases; the VAE decodes the first
# COSMOS_DECODE_FRAMES of the 16 latent frames (9 frames)
COSMOS_LAYERS, COSMOS_STEPS, COSMOS_STEPS_DENSE, COSMOS_DECODE_FRAMES = 2, 4, 2, 2
COSMOS_SAP_GAIN = 3.5


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


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: {bound_ms, bound_by}."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attention_bound(pairs: int, q) -> dict:
    """Attention over `pairs` (q, k) pairs summed over heads, D = q.shape[-1]:
    4 D FLOPs a pair (QK^T and PV); q, k, v read and the output written once."""
    return bound(4.0 * q.shape[-1] * pairs, 4 * q.numel() * q.element_size())


def event_ms(fn) -> float:
    """Milliseconds of one fn() by CUDA events (for the slow plain versions)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


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
        text = f.read()
    for line in text.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line or "setmaxnreg" in line:
            log("build", "ptxas: " + line.strip())
    # the Hopper kernels' instances (the attention body's dynamic shared
    # memory from the library): K1 (bsa_kernel<D, KIND>; with the (m, l)
    # stats bsa_stats_kernel<D, KIND>; the dual per-head spec
    # bsa_dual_kernel<D, MODE>, MODE 0 or 4 with the stats), K3/K4
    # (runs_kernel<D>, runs_stats_kernel<D>), K7 (dense_kernel<D, MODE>: MODE 1 is qsplit 1, 3 the
    # ping-pong) and K5's assign with K8's variants (kmeans_assign_kernel<D, V>,
    # V 0 = A, K5's own, 1 = B and C, 3 = D, 4 = E) must not spill
    rows = _kernels.ptxas_report(text)
    for r in rows:
        if r["kernel"] == "dense_kernel":
            tag, dyn = f", mode {r['kind']}", _kernels.lib().svt_dense_qsplit_smem(r["D"], 2 if r["kind"] & 2 else 1)
        else:
            tag = f", kind {r['kind']}" if r["kind"] else ""
            dyn = _kernels.lib().svt_block_sparse_attn_smem(r["D"]) if r["kernel"] != "kmeans_assign_kernel" else None
        log("build", f"{r['kernel']}<D={r['D']}{tag}>: {r['registers']} registers, spill stores {r['spill_stores']} B, "
                     f"spill loads {r['spill_loads']} B, static smem {r['static_smem']} B"
                     + ("" if dyn is None else f", dynamic smem {dyn} B"))
    for kernel, want in (("bsa_kernel", 6), ("bsa_stats_kernel", 6), ("bsa_dual_kernel", 4), ("runs_kernel", 2),
                         ("runs_stats_kernel", 2), ("dense_kernel", 4), ("kmeans_assign_kernel", 8)):
        got = [r for r in rows if r["kernel"] == kernel]
        if len(got) != want or any(r["spill_stores"] or r["spill_loads"] for r in got):
            raise AssertionError(f"{kernel} instances: expected {want} without spills, got {got}")
        # K3/K4 (packed stages and the chunk walk in one instance) within the launch bound beside K1's
        if kernel.startswith("runs") and any(r["registers"] > 168 for r in got):
            raise AssertionError(f"{kernel} instances: more than 168 registers: {got}")


def slice_layout(preset="1.3B-480p"):
    from sparse_videogen_tpu_torch.pipelines.wan import wan_layout
    from sparse_videogen_tpu_torch.presets import PRESETS

    run = PRESETS[preset]
    return wan_layout(run.model, run.height, run.width, run.num_frames)


def phase_rope(dev, preset="1.3B-480p"):
    """K2 at a preset's layout and heads (a CFG pair), against its plain version."""
    from sparse_videogen_tpu_torch.models.common.rope import wan_rope_cos_sin
    from sparse_videogen_tpu_torch.ops.rope import rope_apply, rope_plain
    from sparse_videogen_tpu_torch.presets import PRESETS

    run = PRESETS[preset]
    lay = slice_layout(preset)
    BH, S, D = 2 * run.model.num_heads, lay.seq_len, 128
    cos, sin = (torch.as_tensor(a, device=dev)
                for a in wan_rope_cos_sin(lay.num_frames, run.height // 16, run.width // 16, D))
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
    # 6 f32 operations a rotated pair, outside the tensor cores; x read, the
    # output written, the cos/sin tables read once
    return {"name": "rope", "route": "cuda", "source": "sparse_videogen_tpu_torch/csrc/rope.cu",
            "replaces": "sparse_videogen_tpu/ops/rope_pallas.py:48", "max_abs_err": max_abs,
            "ms": ms, "plain_ms": plain_ms,
            **bound(3.0 * x.numel(), 2 * x.numel() * 2 + 2 * cos.numel() * 4, PEAK_F32_FLOPS), "library_ms": None}


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


def phase_attention(dev, preset="1.3B-480p"):
    """Kernel A at a preset's width (a CFG pair of its heads) on the metadata
    and mask scalars of the pipeline's own runtime; the first and last
    CHECK_HEADS heads are held against the plain version."""
    from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_kv, block_sparse_attention_kv_plain
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime
    from sparse_videogen_tpu_torch.presets import PRESETS

    run = PRESETS[preset]
    lay = slice_layout(preset)
    rt = make_wan_runtime(lay, device=dev, pattern="SVG", svg=run.generate_kwargs()["svg"])
    plan = rt.plan
    S, D, BH = lay.seq_len, 128, 2 * run.model.num_heads
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
        if name == "dense":
            # the same function as one PyTorch call (a yardstick only): SDPA on the real tokens
            sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qs[None, :, :S], ks[None, :, :S], vs[None, :, :S]))
            b = attention_bound(len(heads) * S * S, qs[:, :S])
            log("kernels", f"attention dense on the {len(heads)} checked heads: F.scaled_dot_product_attention "
                           f"{sdpa_ms:.3f} ms; bound {b['bound_ms']:.3f} ms ({b['bound_by']})")
            entry = {"name": "block_sparse_attn", "route": "cuda",
                     "source": "sparse_videogen_tpu_torch/csrc/block_sparse_attn.cu",
                     "body": "sparse_videogen_tpu_torch/csrc/hopper_attn.cuh",
                     "replaces": "sparse_videogen_tpu/ops/attention.py:62", "max_abs_err": max_abs,
                     "ms": ms, "plain_ms": plain_ms, **b, "library_ms": sdpa_ms}
        del q, k, v, qs, ks, vs, out, ref
    return entry


def _onehot(labels, K):
    return torch.zeros(*labels.shape, K, device=labels.device).scatter_(-1, labels.long()[..., None], 1.0)


def check_kmeans(x, c, out, again, plain, *, sums_and_counts=True):
    """A k-means kernel's (labels, sums, counts) against its plain version,
    run on KMEANS_CHUNK heads at a time. Two runs must give the same bits.
    Labels: the f32 products sum in another order than the plain version's,
    so near-ties may flip; they must agree wherever the plain best-to-second
    gap exceeds 1e-3 x |best distance|, and on >= 99.9% of the tokens; counts
    move by at most one per flip each way. Sums: against the plain segment
    sums of the kernel's own labels (f32 sums of the same bf16 tokens in
    another order), <= 1e-5 of the largest |sum|; and against the plain
    version's own sums over the clusters no flipped token touches (reported
    as max_abs_err). sums_and_counts=False (variant E): both must be 0.
    Returns (ok, stats)."""
    labels, sums, counts = out
    B, N, _ = x.shape
    K = c.shape[1]
    st = {"same_bits": all(torch.equal(u, w) for u, w in zip(out, again)), "flips": 0, "clear": 0,
          "clear_equal": True, "count_moves": 0, "seg_err": 0.0, "seg_max": 0.0, "max_abs": 0.0}
    for h in range(0, B, KMEANS_CHUNK):
        hs = slice(h, h + KMEANS_CHUNK)
        xs, cs, lab = x[hs], c[hs], labels[hs]
        ref_labels, ref_sums, ref_counts = plain(xs, cs)
        cf = cs.float()
        top2 = ((cf * cf).sum(-1)[:, None, :] - 2.0 * torch.bmm(xs.float(), cf.transpose(1, 2))).topk(
            2, dim=-1, largest=False).values
        clear = (top2[..., 1] - top2[..., 0]) > 1e-3 * top2[..., 0].abs()
        eq = lab == ref_labels
        st["flips"] += int((~eq).sum())
        st["clear"] += int(clear.sum())
        st["clear_equal"] &= bool(eq[clear].all())
        if not sums_and_counts:
            continue
        st["count_moves"] += int((counts[hs] - ref_counts).abs().sum())
        seg = torch.bmm(_onehot(lab, K).transpose(1, 2), xs.float())
        st["seg_err"] = max(st["seg_err"], (sums[hs] - seg).abs().max().item())
        st["seg_max"] = max(st["seg_max"], seg.abs().max().item())
        touched = torch.zeros(xs.shape[0], K + 1, dtype=torch.bool, device=x.device)  # column K: tokens that did not flip
        for lb in (lab, ref_labels):
            touched.scatter_(1, torch.where(eq, K, lb).long(), True)
        st["max_abs"] = max(st["max_abs"], (sums[hs] - ref_sums).abs().amax(-1).masked_fill(touched[:, :K], 0).max().item())
        del ref_labels, ref_sums, ref_counts, top2, seg
    st["equal_frac"] = 1.0 - st["flips"] / (B * N)
    st["seg_rel"] = st["seg_err"] / max(st["seg_max"], 1e-30)
    ok = st["same_bits"] and st["clear_equal"] and st["equal_frac"] >= 0.999
    if sums_and_counts:
        ok = ok and st["count_moves"] <= 2 * st["flips"] and st["seg_rel"] <= 1e-5
    else:
        ok = ok and not sums.any() and not counts.any()
    return ok, st


def _kmeans_log(name, st):
    return (f"{name}: two runs same bits {st['same_bits']}; labels equal {st['equal_frac']:.6f} ({st['flips']} flips, "
            f"all {st['clear']} clear-gap tokens equal {st['clear_equal']}, tol 0.999); count moves "
            f"{st['count_moves']} (tol {2 * st['flips']}); sums vs plain segment sums of the kernel labels rel "
            f"{st['seg_rel']:.3e} (tol 1e-5); sums vs plain on untouched clusters max_abs_err {st['max_abs']:.3e}")


def _chunked(plain):
    """The plain version over all heads, KMEANS_CHUNK at a time (for timing)."""
    return lambda x, c: [plain(x[h:h + KMEANS_CHUNK], c[h:h + KMEANS_CHUNK]) for h in range(0, x.shape[0], KMEANS_CHUNK)]


def kmeans_bound(B, N, K, D) -> dict:
    """One Lloyd pass: x . c^T (2 B N K D tensor-core FLOPs; the argmin and
    the sums' B N D adds are small beside it); x and c read, labels, sums
    and counts written once."""
    return bound(2.0 * B * N * K * D, B * N * D * 2 + B * K * D * 2 + B * N * 4 + B * K * D * 4 + B * K * 4)


def phase_kmeans(dev):
    """K5 at the SAP slices' shapes (D = 128, bf16, centroids drawn from the
    tokens): Wan 2.1 1.3B 480p's (12 heads of one CFG stream, 32,760 tokens,
    K = 50 and 200) and Wan 2.1 14B 720p's (40 heads, 75,600 tokens, K = 300,
    the q clusters, and 1000, the k clusters), each under check_kmeans'
    criteria and each launch counted. The plain version runs KMEANS_CHUNK
    heads at a time (all 40 at once would hold ~26 GB of f32 distances and
    one-hots)."""
    from sparse_videogen_tpu_torch import _kernels
    from sparse_videogen_tpu_torch.core.kmeans import init_centroids
    from sparse_videogen_tpu_torch.ops.kmeans import kmeans_assign_update, kmeans_assign_update_plain

    times, worst = {}, 0.0
    for preset, B, ks, seed in (("1.3B-480p", 12, (50, 200), 4), ("14B-720p-sap", 40, (300, 1000), 6)):
        N, D = slice_layout(preset).seq_len, 128
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(B, N, D, generator=gen, device=dev).to(torch.bfloat16)
        for K in ks:
            c = init_centroids(x, K, gen)
            n0 = _kernels.LAUNCHES["kmeans_wide"]
            out = kmeans_assign_update(x, c)
            if _kernels.LAUNCHES["kmeans_wide"] != n0 + 1:
                raise AssertionError(f"K={K} did not launch the k-means kernel")
            ok, st = check_kmeans(x, c, out, kmeans_assign_update(x, c), kmeans_assign_update_plain)
            torch.cuda.synchronize()
            log("kernels", _kmeans_log(f"kmeans_wide (K5; B={B}, N={N}, D={D}, K={K}) bf16", st))
            if not ok:
                raise AssertionError(f"kmeans kernel (K={K}) disagrees with its plain version or is not deterministic")
            ms = cuda_ms(lambda: kmeans_assign_update(x, c))
            plain_ms = cuda_ms(lambda: _chunked(kmeans_assign_update_plain)(x, c), iters=2)
            log("kernels", f"kmeans_wide K={K}: kernel {ms:.4f} ms ({2 * B * N * K * D / (ms * 1e-3) / 1e12:.1f} "
                           f"TFLOP/s on x.c^T, {B * N * D * 2 / (ms * 1e-3) / 1e9:.1f} GB/s of x), plain "
                           f"{plain_ms:.4f} ms ({KMEANS_CHUNK} heads a call)")
            times[K] = (ms, plain_ms)
            worst = max(worst, st["max_abs"])
        del x
        torch.cuda.empty_cache()
    ms, plain_ms = times[1000]
    return {"name": "kmeans_wide", "route": "cuda", "source": "sparse_videogen_tpu_torch/csrc/kmeans_lloyd.cu",
            "replaces": "sparse_videogen_tpu/ops/kmeans_pallas.py:31", "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, **kmeans_bound(B, N, 1000, D), "library_ms": None, "K": 1000,
            "ms_by_K": {k: t[0] for k, t in times.items()}}


# Variant D: the tokens whose tie set may differ from the plain one (ulp-scale
# ties the two f32 products round apart). This data gave 4 at K = 125 and 0
# at K = 300 on the H100 (PERF.md, K8); twice the larger bounds a kernel that
# drops ties between distinct centroids, which the copies test cannot see.
D_DIFFER_TOL = 8


def phase_variants(dev):
    """The five probe variants (K8) on the probe's own data (40 heads,
    75,600 tokens, D = 128), K = 300 and 125, with the last two centroids
    copies of the first two so that tokens tie exactly. A, B, C and E against
    their plain versions under phase_kmeans' criteria (E: sums and counts 0),
    B and C equal to A, and A to K5's own pass (kmeans_assign_update), bit
    for bit: all run on K5's kernels (csrc/kmeans_lloyd.cu), the variant a
    template parameter of the assign. D (no labels; multi-hot dist <= min):
    every token counts in its A cluster and that centroid's copies (exact
    ties are the same distances on the card), and its counts are those of
    the kernel's own tie lists. Against the plain version: the probe's tight
    clusters also tie tokens between distinct centroids, exactly or to an
    ulp, so each token's tie set must equal the plain one but where the
    distances that differ lie within the f32 rounding bound of the two
    products (2 D 2^-24 (|c_k|^2 + 2 |x| |c_k|)) of the plain minimum, and
    at most D_DIFFER_TOL tokens differ; and the sums agree to 1e-5 of the
    largest |sum| on the clusters whose counts agree."""
    from sparse_videogen_tpu_torch.ops.kmeans import (VARIANTS, _lloyd_pass, kmeans_assign_update,
                                                      kmeans_variant_pass, kmeans_variant_pass_plain)
    from sparse_videogen_tpu_torch.scripts.probe_kmeans_variants import KS, SHAPE, make_inputs

    x, cents = make_inputs(*SHAPE, KS, seed=0, device=dev)
    B, N, D = x.shape
    times, worst = {}, 0.0
    for K, c in cents.items():
        c = c.clone()
        c[:, K - 2:] = c[:, :2]
        outs = {}
        for v in VARIANTS:
            plain = lambda xs, cs, v=v: kmeans_variant_pass_plain(xs, cs, v)
            out = outs[v] = kmeans_variant_pass(x, c, v)
            again = kmeans_variant_pass(x, c, v)
            if v == "D":
                same = all(torch.equal(u, w) for u, w in zip(out, again))
                ties = _lloyd_pass(x, c, "D")[0]  # the kernel's tie lists (B, N, 4), -1 padded
                moves, differ, exact, err, smax, covers, own, near = 0, 0, 0, 0.0, 0.0, True, True, 0.0
                for h in range(0, B, KMEANS_CHUNK):
                    hs = slice(h, h + KMEANS_CHUNK)
                    _, ref_sums, ref_counts = plain(x[hs], c[hs])
                    tie = (c[hs, :, None] == c[hs, None, :]).all(-1).float()  # (b, K, K): identical centroids
                    covers &= bool((out[2][hs] >= torch.bmm(_onehot(outs["A"][0][hs], K), tie).sum(1)).all())
                    kset = torch.zeros(*ties[hs].shape[:2], K + 1, dtype=torch.bool, device=dev)
                    kset = kset.scatter_(2, torch.where(ties[hs] < 0, K, ties[hs]).long(), True)[..., :K]
                    own &= bool(torch.equal(out[2][hs], kset.sum(1).float()))
                    xf, cf = x[hs].float(), c[hs].float()
                    csq = (cf * cf).sum(-1)[:, None, :]
                    dist = csq - 2.0 * torch.bmm(xf, cf.transpose(1, 2))
                    gap = dist - dist.amin(-1, keepdim=True)
                    mismatch = (gap <= 0) != kset
                    bound = 2 * D * 2.0 ** -24 * (csq + 2 * xf.norm(dim=-1, keepdim=True) * csq.sqrt())
                    near = max(near, (gap / bound).masked_fill(~mismatch, 0).max().item())
                    differ += int(mismatch.any(-1).sum())
                    first = torch.bmm(_onehot(dist.argmin(-1), K), tie)  # (b, N, K): the plain minimum's copies
                    exact += int(((gap <= 0) & (first == 0)).any(-1).sum())
                    moves += int((out[2][hs] - ref_counts).abs().sum())
                    same_n = out[2][hs] == ref_counts
                    err = max(err, (out[1][hs] - ref_sums).abs().amax(-1).masked_fill(~same_n, 0).max().item())
                    smax = max(smax, ref_sums.abs().max().item())
                    del kset, xf, dist, gap, mismatch, bound, first
                ok = (same and not out[0].any() and covers and own and differ <= D_DIFFER_TOL and near <= 1.0
                      and err <= 1e-5 * smax)
                log("kernels", f"kmeans_variants D (K={K}): same bits {same}; every token in its A cluster and the "
                               f"copies of that centroid {covers}; counts those of its tie lists {own}; tokens whose "
                               f"tie set differs from the plain one {differ} (tol {D_DIFFER_TOL}; count moves {moves}; tokens "
                               f"the plain version ties exactly to a distinct centroid {exact}), their differing "
                               f"distances at most {near:.3e} of the f32 rounding bound from the minimum (tol 1); sums "
                               f"vs plain on the clusters of equal counts max_abs_err {err:.3e} (tol {1e-5 * smax:.3e})")
            else:
                ok, st = check_kmeans(x, c, out, again, plain, sums_and_counts=v != "E")
                if v in ("B", "C"):
                    ok = ok and all(torch.equal(u, w) for u, w in zip(out, outs["A"]))
                if v == "A":
                    ok = ok and all(torch.equal(u, w) for u, w in zip(out, kmeans_assign_update(x, c)))
                log("kernels", _kmeans_log(f"kmeans_variants {v} (B={B}, N={N}, D={D}, K={K})", st)
                    + {"A": "; equal to K5's pass bit for bit", "B": "; equal to A bit for bit",
                       "C": "; equal to A bit for bit"}.get(v, "") * ok)
                err = st["max_abs"]
            torch.cuda.synchronize()
            if not ok:
                raise AssertionError(f"k-means variant {v} (K={K}) disagrees with its plain version")
            worst = max(worst, err)
            times[f"{v}@{K}"] = (cuda_ms(lambda: kmeans_variant_pass(x, c, v)),
                                 cuda_ms(lambda: _chunked(plain)(x, c), iters=2))
            log("kernels", f"kmeans_variants {v} K={K}: kernel {times[f'{v}@{K}'][0]:.4f} ms, plain "
                           f"{times[f'{v}@{K}'][1]:.4f} ms ({KMEANS_CHUNK} heads a call)")
        del outs
    ms, plain_ms = times["C@300"]  # the variant the TPU kernel's wide branch ships
    del x
    torch.cuda.empty_cache()
    return {"name": "kmeans_variants", "route": "cuda", "source": "sparse_videogen_tpu_torch/csrc/kmeans_lloyd.cu",
            "replaces": "scripts/probe_kmeans_variants.py:31", "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **kmeans_bound(B, N, 300, D), "library_ms": None, "variant_ms": {k: t[0] for k, t in times.items()}}


def _run_pairs(meta, block_q, rows=None):
    """q x kv pairs a run-list metadata visits: every q row of a visited
    block, or, with rows (R, nQ) the real tokens of each q block, those."""
    m = meta.cpu().numpy().astype(np.int64)
    a, b = m[..., 1::2], m[..., 2::2]
    per_block = (b - a).sum(-1) * (m[..., 0] > 0)
    return int(per_block.sum()) * block_q if rows is None else int((per_block * rows.cpu().numpy()).sum())


def _band_sink_run_pairs(meta, pos, block_q, spec) -> int:
    """(q, k) pairs the band_sink predicate allows inside run-list metadata,
    over the real q rows: meta (R, nQ, L) run lists, pos (R, n) the padded
    positions of each row's real q tokens. A row q sees |[a, b) & ([q - w + 1,
    q + w - 1] | [0, sink))| tokens of a run [a, b), w the band width."""
    m = meta.cpu().numpy().astype(np.int64)
    w, sink = spec.band_width, spec.sink_size
    total = 0
    for r, rows in enumerate(pos.cpu().numpy().astype(np.int64)):
        a, b = m[r, rows // block_q, 1::2], m[r, rows // block_q, 2::2]
        q = rows[:, None]
        lo = np.maximum(a, q - w + 1)
        band = np.clip(np.minimum(b, q + w) - lo, 0, None)
        in_sink = np.clip(np.minimum(b, sink) - a, 0, None)
        both = np.clip(np.minimum(np.minimum(b, sink), q + w) - lo, 0, None)
        total += int((band + in_sink - both).sum())
    return total


def runs_masked_sdpa(name, spec, metas, pos, block_q, checked, kernel_out):
    """The library yardstick of K3 (mask none) and K4 (band_sink): one
    F.scaled_dot_product_attention call on the checked heads' permuted q, k,
    v with a bf16 attn_mask per head, 0 where the run lists (metas, (h, nQ,
    L)) visit a column and, for band_sink, the predicate allows it at the
    padded q and permuted k positions (as the kernel evaluates it), -inf
    elsewhere. Its output is held to the kernel's on the real q rows (pos,
    (h, n) padded positions) that see a column. Returns its time (ms)."""
    from sparse_videogen_tpu_torch.ops.mask_spec import apply_mask_spec

    qs, ks, vs = checked
    h, Sq, Skv = qs.shape[0], qs.shape[1], ks.shape[1]
    m = metas.long()
    diff = torch.zeros(h, m.shape[1], Skv + 1, device=qs.device)
    diff.scatter_add_(2, m[..., 1::2], torch.ones_like(m[..., 1::2], dtype=diff.dtype))
    diff.scatter_add_(2, m[..., 2::2], -torch.ones_like(m[..., 2::2], dtype=diff.dtype))
    visited = diff.cumsum(-1)[..., :Skv] > 0  # (h, nQ, Skv)
    del diff
    bias = torch.zeros(1, h, Sq, Skv, dtype=qs.dtype, device=qs.device)
    sees = torch.zeros(h, Sq, dtype=torch.bool, device=qs.device)
    k = torch.arange(Skv, device=qs.device)[None, :]
    for r0 in range(0, Sq, 2048):
        q = torch.arange(r0, min(Sq, r0 + 2048), device=qs.device)[:, None]
        ok = visited[:, q[:, 0] // block_q]
        pred = apply_mask_spec(spec, q, k, None)
        if pred is not None:
            ok &= pred[None]
        bias[0, :, r0:r0 + q.shape[0]].masked_fill_(~ok, float("-inf"))
        sees[:, r0:r0 + q.shape[0]] = ok.any(-1)
    del visited
    rows = torch.zeros(h, Sq, dtype=torch.bool, device=qs.device).scatter_(1, pos.long(), True) & sees

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qs[None], ks[None], vs[None], attn_mask=bias)[0]

    max_abs, mean_rel = err_stats(sdpa()[rows], kernel_out[rows])
    ms = cuda_ms(sdpa)
    log("kernels", f"runs attention {name}: F.scaled_dot_product_attention with the run lists"
                   f"{' and the band_sink predicate' if pred is not None else ''} as a ({h}, {Sq}, {Skv}) "
                   f"attn_mask on the checked heads: {ms:.3f} ms; its output vs the kernel's on the {int(rows.sum())} "
                   f"real q rows that see a column: max_abs_err {max_abs:.3e} (tol {SDPA_TOL_ABS}), mean_rel_err "
                   f"{mean_rel:.3e} (tol {ATTN_TOL_REL})")
    if not (max_abs <= SDPA_TOL_ABS and mean_rel <= ATTN_TOL_REL):
        raise AssertionError(f"masked SDPA (the {name} yardstick) disagrees with the run-list kernel")
    del bias
    torch.cuda.empty_cache()
    return ms


def live_column_share(meta, block_kv, n_walk=8) -> dict:
    """How much of the K/V the run-list kernels stage is live: K4's 128-token
    tiles (runs_tile_stats over every row, held to its walk model
    runs_tile_walk) and K3's packed 128-row stages (runs_packed_stats, held
    to runs_packed_walk), each model on the n_walk rows that load most
    tiles."""
    from sparse_videogen_tpu_torch.ops.attention import (runs_packed_stats, runs_packed_walk, runs_tile_stats,
                                                         runs_tile_walk)

    live, loaded = runs_tile_stats(meta)
    _, stages = runs_packed_stats(meta)
    m = meta.cpu().numpy()
    walked = live > 0
    runs = torch.as_tensor((m[..., 2::2] > m[..., 1::2]).sum(-1)).to(live.device)
    rows = torch.argsort(loaded.reshape(-1), descending=True)[:n_walk].tolist()
    for i in rows:
        r, b = divmod(i, m.shape[1])
        tiles = runs_tile_walk(m[r, b], block_kv)
        if (sum(hi - lo for _, lo, hi in tiles), len(tiles)) != (int(live[r, b]), int(loaded[r, b])):
            raise AssertionError(f"runs_tile_stats disagrees with runs_tile_walk on row ({r}, {b})")
        packed = runs_packed_walk(m[r, b], block_kv)
        if (sum(n for st in packed for _, n in st), len(packed)) != (int(live[r, b]), int(stages[r, b])):
            raise AssertionError(f"runs_packed_stats disagrees with runs_packed_walk on row ({r}, {b})")
    n_rows = max(int(walked.sum()), 1)
    return {"live": int(live.sum()), "loaded": 128 * int(loaded.sum()),
            "share": int(live.sum()) / max(128 * int(loaded.sum()), 1), "tiles_per_row": int(loaded.sum()) / n_rows,
            "packed": 128 * int(stages.sum()), "packed_share": int(live.sum()) / max(128 * int(stages.sum()), 1),
            "runs_per_row": int(runs[walked].sum()) / n_rows, "rows_walked": len(rows)}


def phase_sap_attention(dev, preset="1.3B-480p", all_checks=True):
    """The run-list kernel on the inputs SAP's own front half builds (k-means,
    dynamic map, relabel, permutations, run lists) from random full-width
    q, k, v of one CFG stream at a preset's model and SAP configuration
    (1.3B-480p: 12 heads, the CLI's SAP; 14B-720p-sap: 40 heads, the
    reference's 720p SAP, QC 300, KC 1000: run lists of up to 2 KC entries).
    q blocks that hold no token must have empty run lists. all_checks: the
    first and last CHECK_HEADS heads against the plain version (one run: it
    is slow) with mask none and the band_sink MaskSpec path, then one layer of
    SAP at full density against the dense kernel; else mask none on
    CHECK_BLOCKS q blocks of the first and last head (the plain version
    takes ~15 s a whole head at 720p)."""
    from sparse_videogen_tpu_torch.config import SAPConfig
    from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_runs, block_sparse_attention_runs_plain
    from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime
    from sparse_videogen_tpu_torch.sparse import svg2
    from sparse_videogen_tpu_torch.sparse.svg1 import make_svg1_plan

    run, lay, H, D = preset_geometry(preset)
    S = lay.seq_len
    sap = run.sap
    n_check = CHECK_HEADS if all_checks else 1
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = ((torch.randn(1, H, S, D, generator=gen, device=dev) * sc).to(torch.bfloat16) for sc in (2.0, 1.0, 1.0))
    state0 = svg2.init_sap_state(H, D, sap, device=dev)
    a = svg2.sap_prepare(q, k, v, state0, layout=lay, cfg=sap, generator=gen)
    heads = torch.tensor(list(range(n_check)) + list(range(H - n_check, H)), device=dev)
    qs, ks, vs, metas = (x.index_select(0, heads).contiguous() for x in (a.q, a.k, a.v, a.meta))
    pairs = _run_pairs(a.meta, sap.block_q)
    n_q = a.meta.shape[1]
    live = torch.zeros(H, n_q, dtype=torch.bool, device=dev).scatter_(1, (a.pos // sap.block_q).long(), True)
    empty_ok = not bool(a.meta[..., 0][~live].any())
    log("kernels", f"SAP front half, {preset} {run.height}x{run.width}x{run.num_frames} (QC {sap.num_q_centroids}, "
                   f"KC {sap.num_k_centroids}, min_kc_ratio {sap.min_kc_ratio}, {sap.kmeans_iter_init} k-means "
                   f"iterations, top_p {sap.top_p_kmeans}): density {a.density.mean().item():.4f} (random weights: the "
                   f"centroid attention is flat); q padded {S} -> {a.q.shape[1]} rows, meta {tuple(a.meta.shape)}, "
                   f"{int((~live).sum())} of {H * n_q} q blocks hold no token, their run lists empty {empty_ok}; "
                   f"visited pairs {pairs / H / S / S:.3f} of S x S per head (incl. padded q rows)")
    if not empty_ok or a.meta.shape[-1] != 1 + 2 * sap.num_k_centroids:
        raise AssertionError("SAP front half: a q block without tokens has runs, or the run lists are cut")
    share = live_column_share(a.meta, sap.block_kv)
    log("kernels", f"SAP run lists ({preset}): {share['live']} live of {share['loaded']} loaded 128-token tile "
                   f"columns, live share {share['share']:.4f}; {share['tiles_per_row']:.1f} tiles a walked row, "
                   f"{share['runs_per_row']:.1f} runs; K3 stages {share['packed']} packed rows, live share "
                   f"{share['packed_share']:.4f} (runs_tile_walk and runs_packed_walk on {share['rows_walked']} rows "
                   f"agree)")
    specs = (("none", MaskSpec()), ("band_sink", make_svg1_plan(lay).mask_spec)) if all_checks else (
        ("none", MaskSpec()),)
    entry = None
    for name, spec in specs:
        kw = dict(block_q=sap.block_q, block_kv=sap.block_kv, mask_spec=spec)
        out = block_sparse_attention_runs(a.q, a.k, a.v, a.meta, **kw)
        if all_checks:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            ref = block_sparse_attention_runs_plain(qs, ks, vs, metas, **kw)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)  # one run: the plain version is slow
            max_abs, mean_rel = err_stats(out.index_select(0, heads), ref)
            blocks = n_q
        else:  # CHECK_BLOCKS q blocks of each checked head (~15 s a whole head at 720p)
            blocks = sample_blocks(a.meta, CHECK_BLOCKS, 0, dev)
            ref, rows, plain_ms = plain_on_blocks(block_sparse_attention_runs_plain, a, heads, blocks, sap.block_q,
                                                  sap.block_kv)
            max_abs, mean_rel = err_stats(out.index_select(0, heads)[:, rows], ref)
            blocks = len(blocks)
        log("kernels", f"runs attention, mask {spec.kind} ({preset}, H={H}, heads {heads.tolist()} on {blocks} of "
                       f"{n_q} q blocks checked, q rows "
                       f"{a.q.shape[1]}, kv {a.k.shape[1]}, D={D}, block_q {sap.block_q}, block_kv {sap.block_kv}): "
                       f"max_abs_err {max_abs:.3e} (tol {ATTN_TOL_ABS}), mean_rel_err {mean_rel:.3e} "
                       f"(tol {ATTN_TOL_REL})")
        if not (max_abs <= ATTN_TOL_ABS and mean_rel <= ATTN_TOL_REL):
            raise AssertionError(f"run-list attention kernel ({spec.kind}, {preset}) disagrees with its plain version")
        ms = cuda_ms(lambda: block_sparse_attention_runs(qs, ks, vs, metas, **kw))
        ms_all = cuda_ms(lambda: block_sparse_attention_runs(a.q, a.k, a.v, a.meta, **kw), iters=2)
        sub_pairs = _run_pairs(metas, sap.block_q)
        log("kernels", f"runs attention {spec.kind} ({preset}) on the {len(heads)} checked heads: kernel {ms:.3f} ms "
                       f"({4 * D * sub_pairs / (ms * 1e-3) / 1e12:.1f} TFLOP/s on the visited pairs), plain "
                       f"{plain_ms:.3f} ms (one run); all H={H}: kernel {ms_all:.3f} ms "
                       f"({4 * D * pairs / (ms_all * 1e-3) / 1e12:.1f} TFLOP/s)")
        lib_ms = runs_masked_sdpa(f"{spec.kind} ({preset})", spec, metas, a.pos.index_select(0, heads), sap.block_q,
                                  (qs, ks, vs), out.index_select(0, heads)) if all_checks else None
        if spec.kind == "band_sink":
            # K4: the pairs the band_sink predicate allows inside the run lists, real q rows only
            k4_pairs = _band_sink_run_pairs(metas, a.pos.index_select(0, heads), sap.block_q, spec)
            b = attention_bound(k4_pairs, qs)
            log("kernels", f"runs attention band_sink (K4's MaskSpec path, {preset}), checked heads: "
                           f"{k4_pairs} pairs allowed by the predicate inside the run lists "
                           f"({k4_pairs / len(heads) / S / S:.4f} of S x S a head, real q rows only); bound "
                           f"{b['bound_ms']:.3f} ms ({b['bound_by']})")
            entry.update(band_sink_ms=ms, band_sink_bound_ms=b["bound_ms"], band_sink_library_ms=lib_ms)
        if spec.kind == "none":
            # the work this data needs: the real q tokens of each block times its runs' tokens
            rows = torch.zeros(H, n_q, device=dev).scatter_add_(1, (a.pos // sap.block_q).long(),
                                                                torch.ones_like(a.pos, dtype=torch.float32))
            b = attention_bound(_run_pairs(metas, sap.block_q, rows.index_select(0, heads)), qs)
            log("kernels", f"runs attention none ({preset}), checked heads: bound {b['bound_ms']:.3f} ms "
                           f"({b['bound_by']}, real q rows only)")
            entry = {"name": "block_sparse_attn_runs", "route": "cuda",
                     "source": "sparse_videogen_tpu_torch/csrc/runs_attn.cu",
                     "body": "sparse_videogen_tpu_torch/csrc/hopper_attn.cuh",
                     "replaces": "sparse_videogen_tpu/ops/attention.py:720", "max_abs_err": max_abs,
                     "ms": ms, "plain_ms": plain_ms, **b, "library_ms": lib_ms, "live_column_share": share["share"]}
        del out, ref
    if all_checks:
        # every cluster pair selected: SAP must reproduce dense attention
        full = SAPConfig(top_p_kmeans=1.0, min_kc_ratio=1.0)
        out, st = svg2.sap_sparse_attention(q, k, v, svg2.init_sap_state(H, D, full, device=dev), layout=lay,
                                            cfg=full, generator=gen)
        dense = make_wan_runtime(lay, device=dev, pattern="dense")(q, k, v, 999.0, 0)
        torch.cuda.synchronize()
        max_abs, mean_rel = err_stats(out, dense)
        log("kernels", f"SAP at full density (top_p 1.0, min_kc_ratio 1.0; density {st.last_density.mean().item():.4f}) "
                       f"vs the dense kernel, one full-width layer: max_abs_err {max_abs:.3e} (tol {ATTN_TOL_ABS}), "
                       f"mean_rel_err {mean_rel:.3e} (tol {ATTN_TOL_REL})")
        if not (max_abs <= ATTN_TOL_ABS and mean_rel <= ATTN_TOL_REL):
            raise AssertionError("SAP at full density disagrees with dense attention")
        del out, dense
    del q, k, v, a, qs, ks, vs
    torch.cuda.empty_cache()
    return entry


def csr_as_runs(meta):
    """Chunked-CSR rows (R, nQ, 1 + 2 cap) as run-list rows of token windows:
    chunk c becomes [idx_c * 128 + lo_c, idx_c * 128 + hi_c), the chunks past
    the row's count (0, 0); the first entry keeps the count."""
    from sparse_videogen_tpu_torch.ops.metadata import ENTRY_SCALE, N_CHEAP_SCALE, SUB

    m = meta.long()
    cap = (m.shape[2] - 1) // 2
    live = torch.arange(cap, device=m.device) < (m[..., :1] % N_CHEAP_SCALE)
    start, win = m[..., 1::2] * SUB, m[..., 2::2]
    a, b = (torch.where(live, start + w, 0) for w in (win // ENTRY_SCALE, win % ENTRY_SCALE))
    return torch.cat([m[..., :1] % N_CHEAP_SCALE, torch.stack([a, b], -1).flatten(-2)], -1).to(torch.int32)


def real_rows(pos, n_q, block_q):
    """(R, nQ) f32: the real q tokens of each q block (pos (R, n) their rows)."""
    return torch.zeros(pos.shape[0], n_q, device=pos.device).scatter_add_(
        1, (pos // block_q).long(), torch.ones_like(pos, dtype=torch.float32))


def plain_on_blocks(plain, a, heads, blocks, block_q, block_kv):
    """The plain version (`plain`, of the run-list or chunked-CSR format) on
    the q blocks `blocks` of the heads `heads` of a SAPKernelArgs only (q
    blocks are independent), timed by CUDA events: (its output (h,
    len(blocks) * block_q, D), the q rows it covers, ms). Mask kind none
    only: a predicate would see the gathered rows' positions."""
    rows = (blocks[:, None] * block_q + torch.arange(block_q, device=blocks.device)).reshape(-1)
    qs = a.q.index_select(0, heads)[:, rows].contiguous()
    ks, vs = (x.index_select(0, heads) for x in (a.k, a.v))
    ms_ = a.meta.index_select(0, heads)[:, blocks].contiguous()
    out = []
    ms = event_ms(lambda: out.append(plain(qs, ks, vs, ms_, block_q=block_q, block_kv=block_kv)))
    return out[0], rows, ms


def sample_blocks(meta, n_video, extra, dev):
    """Up to n_video q blocks spread over the video blocks (those before
    `extra` blocks at the end, the text ones) and the extra ones."""
    n = meta.shape[1]
    video = torch.linspace(0, n - extra - 1, min(n_video, n - extra), device=dev).round().long()
    return torch.cat([video, torch.arange(n - extra, n, device=dev)]).unique()


def phase_sap_tile_attention(dev, preset="1.3B-480p", check_blocks=None):
    """K1 (mask kind none) on the chunked-CSR metadata SAP's tile mode builds
    on the device (k-means, PC1 seriation, one key sort a side, tile
    centroids, the tile map, tile_meta) from random full-width q, k, v of one
    CFG stream at a preset's model with its SAP run in tile mode
    (presets.tile_variant: block_q = block_kv = 512): the first and last
    head against the plain version (on check_blocks q blocks spread over
    each, or all of them: the plain version takes ~6 s a head at 720p). The
    entry's numbers are on the first head alone, the same inputs for each:
    the kernel, the plain version (on the checked blocks), the bound (the
    real q rows of each block times its live columns) and
    F.scaled_dot_product_attention with the tile mask as an attn_mask (the
    K3 rows' yardstick); every head is timed beside its bound as well."""
    from sparse_videogen_tpu_torch.ops.attention import (block_sparse_attention_kv, block_sparse_attention_kv_plain,
                                                         csr_tile_stats)
    from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec
    from sparse_videogen_tpu_torch.presets import PRESETS, tile_variant
    from sparse_videogen_tpu_torch.sparse import svg2

    lay = slice_layout(preset)
    run = PRESETS[preset]
    H, S, D = run.model.num_heads, lay.seq_len, run.model.head_dim
    sap = tile_variant(run.sap)
    bq, bkv = sap.block_q, sap.block_kv
    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v = ((torch.randn(1, H, S, D, generator=gen, device=dev) * sc).to(torch.bfloat16) for sc in (2.0, 1.0, 1.0))
    t0 = time.perf_counter()
    a = svg2.sap_prepare(q, k, v, svg2.init_sap_state(H, D, sap, device=dev), layout=lay, cfg=sap, generator=gen)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    kw = dict(block_q=bq, block_kv=bkv)
    out = block_sparse_attention_kv(a.q, a.k, a.v, a.meta, **kw)
    blocks = torch.arange(a.meta.shape[1], device=dev) if check_blocks is None else sample_blocks(
        a.meta, check_blocks, 0, dev)
    checks = []
    for h in (0, H - 1):  # the first head's plain run is the entry's plain time
        ref, rows, plain_h = plain_on_blocks(block_sparse_attention_kv_plain, a, torch.tensor([h], device=dev),
                                             blocks, bq, bkv)
        checks.append((err_stats(out[h:h + 1, rows], ref), plain_h))
    max_abs, mean_rel = (max(c[0][i] for c in checks) for i in (0, 1))
    plain_ms = checks[0][1]
    live, tiles = csr_tile_stats(a.meta)
    per_block = live * real_rows(a.pos, a.meta.shape[1], bq)
    b_all, b = attention_bound(int(per_block.sum()), q), attention_bound(int(per_block[0].sum()), q[:, :1])
    log("kernels", f"SAP tile front half, {preset} {run.height}x{run.width}x{run.num_frames} (QC {sap.num_q_centroids}, "
                   f"KC {sap.num_k_centroids} seriated, tiles of {bq} q / {bkv} kv, {prep_s:.2f} s cold): density "
                   f"{a.density.mean().item():.4f}; q {tuple(a.q.shape)}, kv {tuple(a.k.shape)}, meta "
                   f"{tuple(a.meta.shape)}; live share of the loaded 128-token tile columns "
                   f"{int(live.sum()) / max(128 * int(tiles.sum()), 1):.4f}")
    log("kernels", f"attention none on SAP tile metadata ({preset}, heads [0, {H - 1}], {len(blocks)} of "
                   f"{a.meta.shape[1]} q blocks checked): max_abs_err {max_abs:.3e} (tol {ATTN_TOL_ABS}), "
                   f"mean_rel_err {mean_rel:.3e} (tol {ATTN_TOL_REL})")
    if not (max_abs <= ATTN_TOL_ABS and mean_rel <= ATTN_TOL_REL):
        raise AssertionError(f"K1 on SAP tile metadata ({preset}) disagrees with its plain version")
    ms_all = cuda_ms(lambda: block_sparse_attention_kv(a.q, a.k, a.v, a.meta, **kw))
    one = [x[:1].contiguous() for x in (a.q, a.k, a.v, a.meta, a.pos)]
    ms = cuda_ms(lambda: block_sparse_attention_kv(*one[:4], **kw))
    lib_ms = runs_masked_sdpa(f"none on SAP tile metadata ({preset})", MaskSpec(), csr_as_runs(one[3]), one[4], bq,
                              one[:3], out[:1])
    pairs = int(per_block.sum())
    log("kernels", f"attention none on SAP tile metadata ({preset}): all {H} heads, kernel {ms_all:.3f} ms "
                   f"({4 * D * pairs / (ms_all * 1e-3) / 1e12:.1f} TFLOP/s on the {pairs / H / S / S:.4f} of S x S a "
                   f"head the real rows visit; bound {b_all['bound_ms']:.3f} ms, {b_all['bound_by']}); head 0, "
                   f"kernel {ms:.3f} ms, bound {b['bound_ms']:.3f} ms, masked SDPA {lib_ms:.3f} ms, plain "
                   f"{plain_ms:.3f} ms (its {len(blocks)} checked blocks, one run)")
    del q, k, v, a, out, ref, one
    torch.cuda.empty_cache()
    return {"name": "block_sparse_attn[none, SAP tile]", "route": "cuda",
            "source": "sparse_videogen_tpu_torch/csrc/block_sparse_attn.cu",
            "replaces": "sparse_videogen_tpu/ops/attention.py:62", "preset": preset, "heads": 1,
            "plain_blocks": len(blocks), "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": lib_ms, "all_heads_ms": ms_all, "all_heads_bound_ms": b_all["bound_ms"]}


def phase_hyvideo_sap_attention(dev):
    """HunyuanVideo 720p x 129 (S = 119,056: 118,800 video + 256 text
    tokens last, prompt HY_PROMPT; 24 heads, D = 128), the hyvideo-720p-sap
    run's front half on random q, k, v in both modes: cluster mode's run
    lists (QC 400 + 2, KC 1000 + 2 text clusters) on K3, tile mode's
    text-last chunked-CSR metadata (block_q = block_kv = 512) on K1 with mask
    kind none. Each against its plain version on the first and last head, on
    a sample of video q blocks and every text q block (the plain version
    takes minutes over a whole head at this length); every head timed beside
    its bound. Returns {mode: (ms, plain_ms, bound, max_abs)}."""
    from sparse_videogen_tpu_torch.ops.attention import (block_sparse_attention_kv, block_sparse_attention_kv_plain,
                                                         block_sparse_attention_runs,
                                                         block_sparse_attention_runs_plain, csr_tile_stats,
                                                         runs_tile_stats)
    from sparse_videogen_tpu_torch.presets import HY_PRESETS
    from sparse_videogen_tpu_torch.sparse import svg2

    lay = hy_layout()
    H, D, S = HY_PRESETS["hyvideo-720p-sap"].model.heads_num, 128, lay.seq_len
    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v = ((torch.randn(1, H, S, D, generator=gen, device=dev) * sc).to(torch.bfloat16) for sc in (2.0, 1.0, 1.0))
    heads = torch.tensor([0, H - 1], device=dev)
    out_modes = {}
    for mode, name in (("cluster", "hyvideo-720p-sap"), ("tile", "hyvideo-720p-sap-tile")):
        sap = HY_PRESETS[name].sap
        bq, bkv = sap.block_q, sap.block_kv
        t0 = time.perf_counter()
        a = svg2.sap_prepare(q, k, v, svg2.init_sap_state(H, D, sap, device=dev), layout=lay, cfg=sap,
                             generator=gen)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        kw = dict(block_q=bq, block_kv=bkv)
        kernel, plain, stats = ((block_sparse_attention_kv, block_sparse_attention_kv_plain, csr_tile_stats)
                                if a.kernel == "csr" else
                                (block_sparse_attention_runs, block_sparse_attention_runs_plain, runs_tile_stats))
        out = kernel(a.q, a.k, a.v, a.meta, **kw)
        # the text q blocks: tile mode's are the last ones; cluster mode's
        # are the blocks of the prompt and padding tokens' rows
        text_blocks = torch.unique(a.pos[:, lay.video_length:] // bq)
        blocks = torch.cat([sample_blocks(a.meta, CHECK_BLOCKS, 0, dev), text_blocks]).unique()
        ref, rows, plain_ms = plain_on_blocks(plain, a, heads, blocks, bq, bkv)
        max_abs, mean_rel = err_stats(out.index_select(0, heads)[:, rows], ref)
        live, tiles = stats(a.meta)
        pairs = int((live * real_rows(a.pos, a.meta.shape[1], bq)).sum())
        b = attention_bound(pairs, q)
        ms = cuda_ms(lambda: kernel(a.q, a.k, a.v, a.meta, **kw), iters=2)
        what = "K3 on the text-last run lists" if a.kernel == "runs" else "K1 (none) on the text-last tile metadata"
        log("kernels", f"HunyuanVideo SAP {mode} front half (QC {sap.num_q_centroids}, KC {sap.num_k_centroids}, "
                       f"block_q {bq}, block_kv {bkv}, prompt {HY_PROMPT} of 256; {prep_s:.2f} s cold): density "
                       f"{a.density.mean().item():.4f}; q {tuple(a.q.shape)}, kv {tuple(a.k.shape)}, meta "
                       f"{tuple(a.meta.shape)}; live share {int(live.sum()) / max(128 * int(tiles.sum()), 1):.4f}")
        log("kernels", f"{what}: heads {heads.tolist()}, {len(blocks)} q blocks ({len(text_blocks)} holding text) "
                       f"checked: max_abs_err {max_abs:.3e} (tol {ATTN_TOL_ABS}), mean_rel_err {mean_rel:.3e} (tol "
                       f"{ATTN_TOL_REL}); plain {plain_ms:.1f} ms on them (one run); all {H} heads: kernel {ms:.3f} "
                       f"ms ({4 * D * pairs / (ms * 1e-3) / 1e12:.1f} TFLOP/s on the real rows' visited pairs, "
                       f"{pairs / H / S / S:.4f} of S x S a head; bound {b['bound_ms']:.3f} ms, {b['bound_by']})")
        if not (max_abs <= ATTN_TOL_ABS and mean_rel <= ATTN_TOL_REL):
            raise AssertionError(f"{what} disagrees with its plain version")
        out_modes[mode] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_abs, **b)
        del a, out, ref
        torch.cuda.empty_cache()
    del q, k, v
    torch.cuda.empty_cache()
    return out_modes


def norm_sites(cfg) -> int:
    """The fused LayerNorm + modulation's launches in one forward of the
    model of `cfg`: a launch a `model.norm` site, Wan 3 a block + the head,
    HunyuanVideo 4 a double block, 1 a single block + the final layer;
    CogVideoX and Cosmos keep their norms eager (0)."""
    from sparse_videogen_tpu_torch.models.hyvideo.model import HyVideoConfig
    from sparse_videogen_tpu_torch.models.wan.model import WanConfig

    if isinstance(cfg, WanConfig):
        return 3 * cfg.num_layers + 1
    if isinstance(cfg, HyVideoConfig):
        return 4 * cfg.mm_double_blocks_depth + cfg.mm_single_blocks_depth + 1
    return 0


def qk_sites(cfg) -> int:
    """The fused q/k RMSNorm + RoPE's launches in one forward of the model of
    `cfg`: a launch a `model.qk` site, Wan 4 a block (self-attention q and
    k, cross-attention q and k; 5 in I2V, with k_img), HunyuanVideo 4 a
    double block (each stream's q and k into the joined buffers) and 2 a
    single block; CogVideoX and Cosmos keep their q/k norms eager (0)."""
    from sparse_videogen_tpu_torch.models.hyvideo.model import HyVideoConfig
    from sparse_videogen_tpu_torch.models.wan.model import WanConfig

    if isinstance(cfg, WanConfig):
        return (5 if cfg.model_type == "i2v" else 4) * cfg.num_layers
    if isinstance(cfg, HyVideoConfig):
        return 4 * cfg.mm_double_blocks_depth + 2 * cfg.mm_single_blocks_depth
    return 0


def model_sites(cfg) -> dict:
    """expected_launches' (and drive_pipeline's) model arguments for the
    model of `cfg`: Wan and HunyuanVideo launch the fused norms a forward
    (norm_sites, qk_sites) and rotate inside the q/k kernel, so no K2;
    CogVideoX keeps the defaults (K2 on q and k a layer)."""
    if not qk_sites(cfg):
        return {}
    return {"rope": False, "norms": norm_sites(cfg), "qk": qk_sites(cfg)}


def expected_launches(pattern, n_layers, warmup, timesteps, kinds, sap=None, sap_streams=2, rope=True, norms=0,
                      qk=0):
    """Kernel launches one generation implies, and the chunked-CSR kernel's
    launches by mask kind. Per forward and layer: RoPE on q and on k; a
    dense layer (the dense pattern, or a warm-up layer) runs the chunked-CSR
    kernel with the dense mask kind kinds[0], an SVG1 layer the same kernel
    with the sparse kind kinds[1], a sparse SAP layer the run-list kernel
    (cluster mode) or the chunked-CSR kernel with kind none (tile mode).
    SAP runs sap_streams forwards a step (Wan: the two CFG streams;
    HunyuanVideo: 1), and its k-means kernel launches once per Lloyd
    iteration for q and for k: kmeans_iter_init at a layer's first
    clustering in a stream, kmeans_iter_step after (warm-up layers cluster
    only with zero_step_kmeans_init; tile_order pc1 never clusters a sparse
    layer). rope False: the model's RoPE is not K2 (Cosmos's half-split
    RoPE runs in plain torch, as the JAX package runs it on XLA; Wan and
    HunyuanVideo rotate inside the fused q/k kernel). norms: the fused
    LayerNorm + modulation's launches a forward (norm_sites); qk: the fused
    q/k RMSNorm + RoPE's (qk_sites)."""
    from sparse_videogen_tpu_torch import _kernels

    want = {name: 0 for name in _kernels.KERNELS}
    want_kinds = collections.Counter()
    streams = sap_streams if pattern == "SAP" else 1
    tile = sap is not None and sap.block_mode == "tile"
    for _ in range(streams):
        initialized = [False] * n_layers
        for t in timesteps:
            want["layernorm_mod"] += norms
            want["qk_norm_rope"] += qk
            for li in range(n_layers):
                want["rope"] += 2 if rope else 0
                dense = pattern == "dense" or li < warmup.first_layers or float(t) > warmup.first_times
                if dense or pattern == "SVG":
                    want["block_sparse_attn"] += 1
                    want_kinds[f"block_sparse_attn[{kinds[0] if dense else kinds[1]}]"] += 1
                elif tile:
                    want["block_sparse_attn"] += 1
                    want_kinds["block_sparse_attn[none]"] += 1
                else:
                    want["block_sparse_attn_runs"] += 1
                pc1 = tile and sap.tile_order == "pc1" and not dense
                if pattern == "SAP" and (not dense or sap.zero_step_kmeans_init) and not pc1:
                    iters = sap.kmeans_iter_step if initialized[li] else sap.kmeans_iter_init
                    want["kmeans_wide"] += 2 * iters
                    initialized[li] = True
    return want, want_kinds


def drive_pipeline(name, desc, kw, pattern, timesteps, n_layers, generate, shape, kinds, sap=None, sap_streams=2,
                   rope=True, norms=0, qk=0):
    """One generation through a pipeline's entry point, generate(callback),
    timed by the profile scripts' time_generation (the kernel counters set
    to 0 just before it and read just after), and held to what the
    configuration implies: the launches and the chunked-CSR kernel's
    launches by mask kind (expected_launches), no plain-version call, and
    finite latents of `shape`. `kw` holds the run's first_layers_fp and
    first_times_fp. Returns time_generation's record, the latents under
    "latents"."""
    from sparse_videogen_tpu_torch.config import WarmupSchedule
    from sparse_videogen_tpu_torch.scripts.profile_wan import time_generation

    warmup = WarmupSchedule.from_fractions(kw["first_layers_fp"], kw["first_times_fp"], n_layers, timesteps)
    want, want_kinds = expected_launches(pattern, n_layers, warmup, timesteps, kinds, sap, sap_streams, rope, norms, qk)
    lat, r = time_generation(generate)
    finite = bool(torch.isfinite(lat).all())
    log("slice", f"{name}, {desc}, {pattern}, {len(timesteps)} steps ({warmup.first_layers} warm-up layers, steps "
                 f"with t > {warmup.first_times} dense): per-step s {[round(x, 4) for x in r['per_step_s']]}, total "
                 f"{r['wall_s']:.2f} s, peak memory {r['peak_gib']:.2f} GiB")
    log("slice", f"{name} {pattern} launches {r['launches']} (expected {want}), chunked-CSR launches by mask kind "
                 f"{r['kind_launches']} (expected {dict(want_kinds)}), plain-version calls {r['plain_calls']}, "
                 f"latents {tuple(lat.shape)} finite {finite}, std {lat.float().std().item():.4f}")
    if r["launches"] != want:
        raise AssertionError(f"{name} {pattern}: kernel launches {r['launches']} != expected {want}")
    if collections.Counter(r["kind_launches"]) != want_kinds:
        raise AssertionError(f"{name} {pattern}: launches by mask kind {r['kind_launches']} != expected {want_kinds}")
    if any(r["plain_calls"].values()):
        raise AssertionError(f"{name} {pattern}: the main path called a plain version: {r['plain_calls']}")
    if not finite or tuple(lat.shape) != tuple(shape):
        raise AssertionError(f"{name} {pattern}: latents are not finite or not of shape {shape}")
    r["latents"] = lat
    return r


def drive(model, run, pattern, steps, inplace_temporal=False, sampler="unipc"):
    """Wan: one WanPipeline.generate_latents run through drive_pipeline (K1
    dense: kind none; SVG1: band_sink, or with inplace_temporal the dual
    spec, kind band_sink_perm), then SAP's density log. Returns
    drive_pipeline's record."""
    from sparse_videogen_tpu_torch.pipelines import WanPipeline
    from sparse_videogen_tpu_torch.pipelines.wan import make_sampler, wan_layout

    cfg = model.cfg
    dev = model.patch_embedding.weight.device
    gen = torch.Generator(device=dev).manual_seed(1)
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen, device=dev).to(torch.bfloat16)
    ctx_null = torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen, device=dev).to(torch.bfloat16)
    lay = wan_layout(cfg, run.height, run.width, run.num_frames)
    timesteps = make_sampler(sampler, steps, run.flow_shift).timesteps
    name = f"Wan dim {cfg.dim} x {cfg.num_layers} layers" + (", SVG1 in place" if inplace_temporal else "") + (
        f", SAP {run.sap.block_mode} mode" if pattern == "SAP" else "") + (f", {sampler}" if sampler != "unipc" else "")
    how = "cond and uncond as separate batch-1 forwards" if pattern == "SAP" else "CFG batch 2"
    desc = f"{run.height}x{run.width}x{run.num_frames} (S={lay.seq_len} = {lay.num_frames}x{lay.frame_size}), {how}"
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        dlog = os.path.join(tmp, "density.jsonl")
        r = drive_pipeline(name, desc, run.generate_kwargs(), pattern, timesteps, cfg.num_layers,
                           lambda on_step: WanPipeline(model).generate_latents(
                               ctx, ctx_null, num_inference_steps=steps, pattern=pattern, seed=0, callback=on_step,
                               logging_file=dlog if pattern == "SAP" else None, inplace_temporal=inplace_temporal,
                               sampler=sampler, **run.generate_kwargs()),
                           (1, 16, lay.num_frames, run.height // 8, run.width // 8),
                           ("none", "band_sink_perm" if inplace_temporal else "band_sink"), sap=run.sap,
                           **model_sites(cfg))
        dens = [json.loads(line)["avg_density"] for line in open(dlog)] if pattern == "SAP" else []
    if dens:
        log("slice", f"{name} SAP density (cond stream, {len(dens)} logged layer-steps): mean {np.mean(dens):.4f}, "
                     f"min {min(dens):.4f}, max {max(dens):.4f} (random weights)")
    return r


def _new_model(cfg, dev):
    from sparse_videogen_tpu_torch.models.wan.model import WanModel

    t0 = time.perf_counter()
    model = WanModel(cfg, dtype=torch.bfloat16, device=dev).init_random(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log("slice", f"Wan dim {cfg.dim}: {cfg.num_layers} layers, {cfg.num_heads} heads, FFN {cfg.ffn_dim}, "
                 f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s")
    return model


def phase_slice(dev):
    """Full-size Wan 2.1 1.3B, SVG1, SVG1 in place (placement-free: K1's dual
    per-head spec) from the same seed and weights, then SAP in cluster mode
    and in tile mode (the CLI's --sap_block_mode tile: block_q = block_kv =
    512, K1 with kind none in its sparse layers); returns each kernel's
    launches from the path that runs it first (the chunked kernel and the
    fused norms: SVG1; the dual spec: SVG1 in place; K1's kind none: SAP
    tile; K2 runs on no Wan path: phase_cog_slice counts it). The
    in-place latents are held to the placement run's (INPLACE_LATENT_TOL)."""
    from sparse_videogen_tpu_torch.presets import T2V_480P, tile_variant

    model = _new_model(T2V_480P.model, dev)
    tile = dataclasses.replace(T2V_480P, sap=tile_variant(T2V_480P.sap))
    counts, lat = {}, {}
    for pattern, inplace, run in (("SVG", False, T2V_480P), ("SVG", True, T2V_480P), ("SAP", False, T2V_480P),
                                  ("SAP", False, tile)):
        r = drive(model, run, pattern, STEPS, inplace_temporal=inplace)
        lat[(pattern, inplace)] = r["latents"]
        for name, n in r["launches"].items():
            if n and name not in counts:
                counts[name] = n
        for name, n in r["kind_launches"].items():
            counts.setdefault(name, n)
    a, b = lat[("SVG", True)].float(), lat[("SVG", False)].float()
    rel = ((a - b).norm() / b.norm()).item()
    log("slice", f"Wan 1.3B SVG1 in place vs placement, same seed and weights, {STEPS} steps: latents rel L2 "
                 f"{rel:.3e} (tol {INPLACE_LATENT_TOL})")
    if not rel <= INPLACE_LATENT_TOL:
        raise AssertionError(f"in-place SVG1 latents disagree with the placement path's: {rel}")
    del model
    torch.cuda.empty_cache()
    return counts


def phase_probe(dev):
    """The K8 probe's entry (probe_kmeans_variants.probe) on its own data:
    every variant at K = 300 and 125, B and C equal to A; the variant kernel
    launches counted around it."""
    from sparse_videogen_tpu_torch import _kernels
    from sparse_videogen_tpu_torch.ops.kmeans import VARIANTS
    from sparse_videogen_tpu_torch.scripts import probe_kmeans_variants as probe

    x, cents = probe.make_inputs(*probe.SHAPE, probe.KS, seed=0, device=dev)
    iters, warmup = 5, 1
    _kernels.reset_counts()
    rows = probe.probe(x, cents, iters=iters, warmup=warmup)
    torch.cuda.synchronize()
    launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_CALLS)
    want = len(cents) * len(VARIANTS) * (1 + warmup + iters)
    log("slice", f"K8 probe {tuple(x.shape)} bf16: " + ", ".join(
        f"K={r['K']} {r['variant']} {r['ms']:.4f} ms" + ("" if r["exact_match"] is None else
                                                        f" (= A: {r['exact_match']})") for r in rows)
        + f"; kmeans_variants launches {launches['kmeans_variants']} (expected {want}), plain-version calls {plain}")
    if launches["kmeans_variants"] != want or any(plain.values()):
        raise AssertionError("K8 probe: wrong launch count or a plain-version call")
    if not all(r["exact_match"] for r in rows if r["exact_match"] is not None):
        raise AssertionError("K8 probe: B or C differs from A")
    del x, cents
    torch.cuda.empty_cache()
    return {"kmeans_variants": launches["kmeans_variants"]}


def phase_slice_14b(dev):
    """Wan 2.1 14B at full width (dim 5120, 40 heads, FFN 13824, D = 128) and
    LAYERS_14B layers, 720x1280x81 (S = 75,600), 5 UniPC steps, SAP at the
    reference's 720p config (QC 300, KC 1000, min_kc_ratio 0.10, top_p 0.9,
    first_times_fp 0.2: step 0 is a dense warm-up step on K1); cond and uncond
    as separate batch-1 forwards."""
    import dataclasses

    from sparse_videogen_tpu_torch.presets import T2V_720P_SAP

    model = _new_model(dataclasses.replace(T2V_720P_SAP.model, num_layers=LAYERS_14B), dev)
    launches = drive(model, T2V_720P_SAP, "SAP", STEPS_14B)["launches"]
    del model
    torch.cuda.empty_cache()
    return {name: n for name, n in launches.items() if n}


def phase_quality(dev):
    """The quality leg (scripts/quality.py's recipe, latents only): Wan 2.1
    1.3B at full width and depth, structured-synthetic (K := Q, gain 4.0),
    720x1280x81 (S = 75,600), 8 UniPC steps, dense, SVG1 and SAP in cluster
    and in tile mode (QC 300, KC 125, block_q = block_kv = 512) from the same
    noise, and dense with int8 W8A8 block linears (dense_int8), each through
    drive_pipeline (its K1, K3, K5 and fused-norm launches held to
    expected_launches); latent PSNR and SSIM against dense, SAP's density,
    each pattern's seconds a step; SVG1 and dense_int8 >= 35 dB and each SAP
    mode >= 24 dB, a miss fails the phase. main runs the CLI runs beside it on the
    same card, so its seconds a step are taken beside them and are labelled
    so (scripts/quality.py times the recipe alone)."""
    from sparse_videogen_tpu_torch.pipelines.wan import wan_layout
    from sparse_videogen_tpu_torch.schedulers import FlowUniPC
    from sparse_videogen_tpu_torch.scripts import quality as Q

    cfg, (h, w, f), patterns = Q.recipe()
    model, ctx, ctx_null = Q.make_inputs(cfg, dev)
    lay = wan_layout(cfg, h, w, f)
    timesteps = FlowUniPC(Q.STEPS, shift=3.0).timesteps
    shape = (1, 16, lay.num_frames, h // 8, w // 8)
    desc = f"{h}x{w}x{f} (S={lay.seq_len}), structured-synthetic (K := Q, gain {Q.GAIN}), beside the CLI runs"
    lat, per_step, density = {}, {}, {}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        for name, kw in patterns.items():
            dlog = os.path.join(tmp, f"{name}.jsonl") if kw["pattern"] == "SAP" else None
            r = drive_pipeline("quality", desc, kw, kw["pattern"], timesteps, cfg.num_layers,
                               lambda cb, kw=kw, dlog=dlog: Q.generate(model, ctx, ctx_null, (h, w, f), kw, callback=cb,
                                                                       logging_file=dlog),
                               shape, ("none", "band_sink"), sap=kw.get("sap"), **model_sites(cfg))
            lat[name] = r["latents"].float().cpu().numpy()
            per_step[name] = r["per_step_s"]
            if dlog:
                density[name] = Q.density_mean(dlog)
    del model
    torch.cuda.empty_cache()
    metrics = {name: Q.latent_metrics(lat["dense"], lat[name]) for name in patterns if name != "dense"}
    for name, m in metrics.items():
        log("quality", f"dense vs {name}: latent PSNR {m['latent_psnr_db']:.3f} dB, SSIM {m['latent_ssim']:.5f}, "
                       f"s a step beside the CLI runs {[round(x, 4) for x in per_step[name]]}"
                       + (f", SAP density {density[name]:.4f}" if name in density else ""))
    log("quality", f"dense s a step beside the CLI runs {[round(x, 4) for x in per_step['dense']]}; latent max |x| "
                   f"{np.abs(lat['dense']).max():.4f}")
    svg_db, int8_db = metrics["svg1"]["latent_psnr_db"], metrics["dense_int8"]["latent_psnr_db"]
    sap_db = {name: metrics[name]["latent_psnr_db"] for name in density}
    if not (svg_db >= Q.MIN_PSNR and int8_db >= Q.MIN_PSNR and set(sap_db) == {"sap_cluster", "sap_tile"}
            and min(sap_db.values()) >= Q.SAP_MIN_PSNR):
        raise AssertionError(f"quality gate missed: SVG1 {svg_db:.3f} dB, dense_int8 {int8_db:.3f} dB (gate "
                             f"{Q.MIN_PSNR}), SAP {sap_db} dB (gate {Q.SAP_MIN_PSNR})")


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

def hy_layout():
    """HunyuanVideo 720x1280x129's token layout with the live prompt HY_PROMPT."""
    from sparse_videogen_tpu_torch.pipelines.hyvideo import hyvideo_layout
    from sparse_videogen_tpu_torch.presets import HY_720P_SVG as run

    lay = hyvideo_layout(run.model, run.height, run.width, run.num_frames)
    return dataclasses.replace(lay, prompt_length=HY_PROMPT)


def hyvideo_pairs(spec, real: int, S: int) -> int:
    """(q, k) pairs of the real sequence that the hyvideo predicate allows
    (the work this data needs), per head: a real text row sees every real
    column; a video row its band inside the video plus the real text; a fake
    row the fake columns."""
    vid, bw = spec.video_len, spec.band_width
    qv = np.arange(vid, dtype=np.int64)
    band = np.minimum(vid, qv + bw) - np.maximum(0, qv - bw + 1)
    return int(band.sum()) + vid * (real - vid) + (real - vid) * real + (S - real) ** 2


def phase_hyvideo_attention(dev):
    """K1's hyvideo kind at HunyuanVideo 720p x 129 (S = 119,056: 33 x 3600
    video + 256 text tokens, prompt HY_PROMPT; 24 heads, D = 128) on the
    metadata and aux of the pipeline's own runtime: dense (band 1 << 24) and
    SVG1 (floor band, cheap-first metadata), the first and last head against
    the plain version (one run: it is slow at this length); SVG1 also beside
    masked_sdpa (the predicate as an (S, S) attn_mask, 28 GB)."""
    from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_kv, block_sparse_attention_kv_plain
    from sparse_videogen_tpu_torch.pipelines.hyvideo import make_hyvideo_runtime
    from sparse_videogen_tpu_torch.presets import HY_720P_SVG as run

    lay = hy_layout()
    rt = make_hyvideo_runtime(lay, device=dev, prompt_length=HY_PROMPT, pattern="SVG", svg=run.generate_kwargs()["svg"])
    plan = rt.plan
    S, D, BH = lay.seq_len, run.model.head_dim, run.model.heads_num
    real = int(rt.aux[0])
    heads = torch.tensor([0, BH - 1], device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    cases = {"dense": (rt.dense_meta, plan.dense_mask_spec, plan.dense_block_q),
             "svg1": (rt.sparse_meta, plan.mask_spec, plan.block_q)}
    entry, times = None, {}
    for name, (meta, spec, bq) in cases.items():
        def rand(s_pad, scale):
            x = torch.zeros(BH, s_pad, D, device=dev, dtype=torch.bfloat16)
            x[:, :S] = (torch.randn(BH, S, D, generator=gen, device=dev) * scale).to(torch.bfloat16)
            return x

        q, k, v = rand(-(-S // bq) * bq, 2.0), rand(plan.seq_pad_kv, 1.0), rand(plan.seq_pad_kv, 1.0)
        kw = dict(block_q=bq, block_kv=plan.block_kv, mask_spec=spec)
        out = block_sparse_attention_kv(q, k, v, meta, rt.aux, **kw)
        qs, ks, vs = (x.index_select(0, heads) for x in (q, k, v))
        ref = None

        def plain():
            nonlocal ref
            ref = block_sparse_attention_kv_plain(qs, ks, vs, meta, rt.aux, **kw)

        plain_ms = event_ms(plain)
        max_abs, mean_rel = err_stats(out.index_select(0, heads)[:, :S], ref[:, :S])
        n_cheap = int((meta[..., 0] // 4096).sum())
        log("kernels", f"attention hyvideo {name} (band {spec.band_width}, video {spec.video_len}, real {real} of "
                       f"S={S}; BH={BH}, heads {heads.tolist()} checked, block_q {bq}, block_kv {plan.block_kv}, "
                       f"meta {tuple(meta.shape)}, {n_cheap} cheap chunks): max_abs_err {max_abs:.3e} "
                       f"(tol {ATTN_TOL_ABS}), mean_rel_err {mean_rel:.3e} (tol {ATTN_TOL_REL})")
        if not (max_abs <= ATTN_TOL_ABS and mean_rel <= ATTN_TOL_REL):
            raise AssertionError(f"attention kernel (hyvideo {name}) disagrees with its plain version")
        fake = ref[:, real:S].float().abs().amax().item()
        if not fake > 0:
            raise AssertionError("hyvideo: the fake text rows output nothing")
        pairs = hyvideo_pairs(spec, real, S)
        b = attention_bound(len(heads) * pairs, qs[:, :S])
        ms = times[name] = cuda_ms(lambda: block_sparse_attention_kv(qs, ks, vs, meta, rt.aux, **kw))
        ms_all = cuda_ms(lambda: block_sparse_attention_kv(q, k, v, meta, rt.aux, **kw), iters=2)
        log("kernels", f"attention hyvideo {name} on the {len(heads)} checked heads: kernel {ms:.3f} ms "
                       f"({4 * D * pairs * len(heads) / (ms * 1e-3) / 1e12:.1f} TFLOP/s on the {pairs / S / S:.4f} "
                       f"of the S x S pairs the mask allows; bound {b['bound_ms']:.3f} ms, {b['bound_by']}), plain "
                       f"{plain_ms:.3f} ms (one run); all BH={BH}: kernel {ms_all:.3f} ms "
                       f"({4 * D * pairs * BH / (ms_all * 1e-3) / 1e12:.1f} TFLOP/s)")
        if name == "svg1":
            sdpa_ms, sdpa_all_ms = masked_sdpa("hyvideo svg1", spec, rt.aux, pairs, (q, k, v), (qs, ks, vs),
                                               out.index_select(0, heads)[:, :S])
            entry = {"name": "block_sparse_attn[hyvideo]", "route": "cuda",
                     "source": "sparse_videogen_tpu_torch/csrc/block_sparse_attn.cu",
                     "replaces": "sparse_videogen_tpu/ops/attention.py:62", "max_abs_err": max_abs, "ms": ms,
                     "plain_ms": plain_ms, **b, "library_ms": sdpa_ms, "library_all_rows_ms": sdpa_all_ms,
                     "dense_ms": times["dense"], "S": S}
        del q, k, v, qs, ks, vs, out, ref
    torch.cuda.empty_cache()
    return entry


def phase_rmsnorm(dev):
    """K6 (Triton) against its plain version on the probe's shapes, bf16:
    the mean of squares sums in another order and rsqrt may differ in its
    last f32 bit, so the cast may round to the neighbouring bf16 and the
    weight product rounds again: |diff| <= 2^-6 |plain| + 1e-6 (two roundings
    of one ulp each). Timed beside the plain version and F.rms_norm (other
    rounding) at every shape; the entry is HunyuanVideo's qk-norm shape."""
    import torch.nn.functional as F

    from sparse_videogen_tpu_torch.ops.rmsnorm import rms_norm_kernel, rms_norm_plain
    from sparse_videogen_tpu_torch.scripts import bench_rmsnorm as probe

    worst, entry = 0.0, None
    for i, (name, shape) in enumerate(probe.SHAPES.items()):
        x, w = probe.make_inputs(shape, seed=i, device=dev)
        out = rms_norm_kernel(x, w, probe.EPS)
        ref = rms_norm_plain(x, w, probe.EPS)
        torch.cuda.synchronize()
        d = (out.float() - ref.float()).abs()
        ok = bool((d <= 2.0 ** -6 * ref.float().abs() + 1e-6).all())
        exact = (d == 0).float().mean().item()
        worst = max(worst, d.max().item())
        ms = cuda_ms(lambda: rms_norm_kernel(x, w, probe.EPS), iters=20)
        plain_ms = cuda_ms(lambda: rms_norm_plain(x, w, probe.EPS), iters=20)
        wb = w.to(x.dtype)
        lib_ms = cuda_ms(lambda: F.rms_norm(x, (shape[-1],), wb, probe.EPS), iters=20)
        b = bound(3.0 * x.numel(), 2 * x.numel() * 2 + w.numel() * 4, PEAK_F32_FLOPS)
        gb = 2 * x.numel() * 2 / 1e9
        log("kernels", f"rmsnorm {name} {tuple(shape)} bf16: max_abs_err {d.max().item():.3e} (tol 2^-6 |plain| + "
                       f"1e-6: {ok}), {exact:.6f} of the entries equal; kernel {ms:.4f} ms ({gb / ms * 1e3:.1f} "
                       f"GB/s), plain {plain_ms:.4f} ms ({gb / plain_ms * 1e3:.1f} GB/s), F.rms_norm {lib_ms:.4f} ms "
                       f"({gb / lib_ms * 1e3:.1f} GB/s); bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        if not ok:
            raise AssertionError(f"rmsnorm kernel disagrees with its plain version at {shape}")
        if name == "hyvideo-qk-norm":
            entry = {"name": "rmsnorm", "route": "triton", "source": "sparse_videogen_tpu_torch/csrc/rmsnorm_triton.py",
                     "replaces": "sparse_videogen_tpu/ops/rmsnorm_pallas.py:33", "ms": ms, "plain_ms": plain_ms,
                     **b, "library_ms": lib_ms, "shape": list(shape)}
        del x, w, out, ref, d
    entry["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return entry


def phase_layernorm_mod(dev):
    """The fused LayerNorm + modulation (csrc/layernorm_mod.cu) against its
    plain version at every shape of scripts/bench_layernorm_mod.py (Wan's
    CFG pair with the modulation table's rows and with norm3's (d,) vectors,
    HunyuanVideo's video and text streams and its final layer's slice of
    [video | text], Wan 14B's d = 5120): every element within
    bench_layernorm_mod.mismatch's tolerance (one bf16 ulp, or where the
    modulation cancels to near 0 the gap of row statistics 2^-18 apart),
    under 0.1% of them different; then the probe's times, the bound one
    bf16 read and one write at 3.35 TB/s. The entry is Wan 1.3B's block
    shape."""
    from sparse_videogen_tpu_torch.ops.layernorm_mod import layernorm_mod, layernorm_mod_plain
    from sparse_videogen_tpu_torch.scripts import bench_layernorm_mod as probe

    entry = None
    for i, (name, shape) in enumerate(probe.SHAPES.items()):
        x, mul, add = probe.make_inputs(shape, seed=i, device=dev)
        out = layernorm_mod(x, mul, add, probe.EPS)
        ref = layernorm_mod_plain(x, mul, add, probe.EPS)
        bad, share = probe.mismatch(out, ref, x, mul, add)
        del out, ref
        r = probe.probe({name: (x, mul, add)}, iters=10, warmup=1)[0]
        log("kernels", f"layernorm_mod {name} {r['shape']} bf16: {bad} elements beyond tolerance, {share:.2e} "
                       f"differ; kernel {r['kernel_ms']:.4f} ms ({r['kernel_gbs']:.1f} GB/s, "
                       f"{100 * r['bound_share']:.1f}% of the bound {r['bound_ms']:.4f} ms), plain "
                       f"{r['plain_ms']:.4f} ms ({r['plain_gbs']:.1f} GB/s)")
        if bad or share >= 1e-3:
            raise AssertionError(f"layernorm_mod disagrees with its plain version at {name}: {bad}, {share}")
        if name == "wan-480p-cfg":
            entry = {"name": "layernorm_mod", "route": "cuda",
                     "source": "sparse_videogen_tpu_torch/csrc/layernorm_mod.cu", "replaces": None,
                     "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                     **bound(10.0 * x.numel(), r["bytes"], PEAK_F32_FLOPS), "library_ms": None,
                     "shape": list(r["shape"])}
        del x, mul, add
        torch.cuda.empty_cache()
    return entry


def phase_qk_norm_rope(dev):
    """The fused q/k RMSNorm + RoPE (csrc/qk_norm_rope.cu) against its plain
    version at every shape of scripts/bench_qk_norm_rope.py (Wan 1.3B's CFG
    pair and Wan 14B's self-attention, each token's norm; HunyuanVideo's
    single block and its double block's two streams written into one joined
    buffer, each head's norm, x a column view of the fused qkv) and on a
    sequence shard (the second half of Wan 1.3B's tokens with the tables'
    row slice): every element within bench_qk_norm_rope.mismatch's
    tolerance (one ulp of the normalised value carried through the weight
    and the rotation: one bf16 ulp of the output where the rotation does not
    cancel), under 0.1% of them different; then the probe's times beside
    the eager chain the models ran before it (the f32 norm, the head copy,
    K2) and the bytes bound. The entry is Wan 1.3B's self-attention shape."""
    from sparse_videogen_tpu_torch.ops.qk_norm_rope import qk_norm_rope, qk_norm_rope_plain
    from sparse_videogen_tpu_torch.scripts import bench_qk_norm_rope as probe

    shapes = dict(probe.SHAPES, **{"wan-480p-shard": (2, 16380, 1536, 12, "token", 1536, 16380, 16380, 16380, 0)})
    entry = None
    for i, (name, shape) in enumerate(shapes.items()):
        x, w, cos, sin, out, r0 = probe.make_inputs(shape, seed=i, device=dev)
        H = shape[3]
        got = qk_norm_rope(x, w, probe.EPS, H, cos, sin, out=out, r0=r0)
        ref = qk_norm_rope_plain(x, w, probe.EPS, H, cos, sin, out=None if out is None else torch.zeros_like(out),
                                 r0=r0)
        bad, share, ulps = probe.mismatch(got, ref, x, w, H, cos, sin, r0)
        del got, ref
        r = probe.probe(name, H, (x, w, cos, sin, out, r0), iters=10, warmup=1)
        log("kernels", f"qk_norm_rope {name} {r['shape']} bf16, {H} heads: {bad} elements beyond tolerance, "
                       f"{share:.2e} differ (at most {ulps:.1f} ulps of the plain output); kernel "
                       f"{r['kernel_ms']:.4f} ms ({r['kernel_gbs']:.1f} GB/s, {100 * r['bound_share']:.1f}% of the "
                       f"bound {r['bound_ms']:.4f} ms), eager chain {r['eager_ms']:.4f} ms, plain "
                       f"{r['plain_ms']:.4f} ms")
        if bad or share >= 1e-3:
            raise AssertionError(f"qk_norm_rope disagrees with its plain version at {name}: {bad}, {share}")
        if name == "wan-480p-self":
            entry = {"name": "qk_norm_rope", "route": "cuda",
                     "source": "sparse_videogen_tpu_torch/csrc/qk_norm_rope.cu", "replaces": None,
                     "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "eager_ms": r["eager_ms"],
                     **bound(8.0 * x.numel(), r["bytes"], PEAK_F32_FLOPS), "library_ms": None,
                     "shape": list(r["shape"])}
        del x, w, cos, sin, out
        torch.cuda.empty_cache()
    return entry


def phase_qsplit(dev):
    """K7 at the probe's shape (12, 32768, 128) bf16, bkv 1024, and at head
    dim 64 (12, 32768, 64), against its plain version (one run a shape: it
    is the same function at every (bq, qsplit)) for every (bq, qsplit) the
    kernel compiles; both round q_s and P to bf16, the kernel rescales P per
    128-token tile, the plain version per bkv chunk: the attention
    tolerances. F.scaled_dot_product_attention is timed beside each shape.
    The entry is the fastest pair at D = 128."""
    from sparse_videogen_tpu_torch.ops.dense_qsplit import KERNEL_CONFIGS, dense_attn, dense_attn_plain
    from sparse_videogen_tpu_torch.scripts import bench_qsplit as probe

    entry, worst = None, 0.0
    for shape in (probe.SHAPE, probe.SHAPE[:2] + (64,)):
        q, k, v = probe.make_inputs(shape, seed=0, device=dev)
        ref = None

        def plain():
            nonlocal ref
            ref = dense_attn_plain(q, k, v, bq=256, bkv=probe.BKV)

        plain_ms = event_ms(plain)
        fl = probe.flops(q.shape)
        times = {}
        for bq, qs in KERNEL_CONFIGS:
            out = dense_attn(q, k, v, bq=bq, bkv=probe.BKV, qsplit=qs)
            torch.cuda.synchronize()
            max_abs, mean_rel = err_stats(out, ref)
            ms = cuda_ms(lambda: dense_attn(q, k, v, bq=bq, bkv=probe.BKV, qsplit=qs))
            log("kernels", f"dense_qsplit bq={bq} qsplit={qs} {tuple(q.shape)} bf16: max_abs_err {max_abs:.3e} (tol "
                           f"{ATTN_TOL_ABS}), mean_rel_err {mean_rel:.3e} (tol {ATTN_TOL_REL}); kernel {ms:.3f} ms "
                           f"({fl / (ms * 1e-3) / 1e12:.1f} TFLOP/s)")
            if not (max_abs <= ATTN_TOL_ABS and mean_rel <= ATTN_TOL_REL):
                raise AssertionError(f"dense_qsplit kernel (bq={bq}, qsplit={qs}, {tuple(q.shape)}) disagrees with its "
                                     f"plain version")
            times[f"{bq}/{qs}"] = ms
            worst = max(worst, max_abs)
            del out
        sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q[None], k[None], v[None]))
        b = attention_bound(q.shape[0] * q.shape[1] ** 2, q)
        best = min(times, key=times.get)
        log("kernels", f"dense_qsplit {tuple(q.shape)}: plain {plain_ms:.3f} ms (one run), "
                       f"F.scaled_dot_product_attention {sdpa_ms:.3f} ms ({fl / (sdpa_ms * 1e-3) / 1e12:.1f} TFLOP/s); "
                       f"bound {b['bound_ms']:.3f} ms ({b['bound_by']}); fastest bq/qsplit {best}")
        if entry is None:
            entry = {"name": "dense_qsplit", "route": "cuda", "source": "sparse_videogen_tpu_torch/csrc/dense_qsplit.cu",
                     "replaces": "scripts/bench_qsplit.py:28", "ms": times[best], "plain_ms": plain_ms, **b,
                     "library_ms": sdpa_ms, "config": best, "ms_by_config": times}
        else:
            entry["d64"] = {"ms_by_config": times, "plain_ms": plain_ms, "library_ms": sdpa_ms, **b}
        del q, k, v, ref
        torch.cuda.empty_cache()
    entry["max_abs_err"] = worst
    return entry


def drive_hyvideo(model, run, steps, latents=None):
    """HunyuanVideo: one HyVideoPipeline.generate_latents run through
    drive_pipeline (K1 dense and SVG1 both run the hyvideo kind: the dense
    spec keeps the real/fake text split; SAP: one forward a step, the
    hyvideo kind in its warm-up, K3 or K1's none in its sparse steps), from
    `latents` when given, then SAP's density log."""
    from sparse_videogen_tpu_torch.pipelines import HyVideoPipeline
    from sparse_videogen_tpu_torch.schedulers import FlowMatchEuler

    cfg = model.cfg
    dev = model.img_in.weight.device
    gen = torch.Generator(device=dev).manual_seed(1)
    text = torch.randn(1, cfg.text_len, cfg.text_states_dim, generator=gen, device=dev).to(torch.bfloat16)
    mask = torch.zeros(1, cfg.text_len, dtype=torch.int32, device=dev)
    mask[0, :HY_PROMPT] = 1
    pooled = torch.randn(1, cfg.text_states_dim_2, generator=gen, device=dev).to(torch.bfloat16)
    lay = hy_layout()
    name = f"HunyuanVideo hidden {cfg.hidden_size} x {cfg.mm_double_blocks_depth}+{cfg.mm_single_blocks_depth} blocks"
    if run.pattern == "SAP":
        name += f", SAP {run.sap.block_mode} mode"
    desc = (f"{run.height}x{run.width}x{run.num_frames} (S={lay.seq_len} = {lay.num_frames}x{lay.frame_size} + "
            f"{cfg.text_len} text, prompt {HY_PROMPT}), Euler, embedded guidance")
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        dlog = os.path.join(tmp, "density.jsonl") if run.pattern == "SAP" else None
        r = drive_pipeline(name, desc, run.generate_kwargs(), run.pattern,
                           FlowMatchEuler(steps, shift=run.flow_shift).timesteps, cfg.num_layers,
                           lambda on_step: HyVideoPipeline(model).generate_latents(
                               text, mask, pooled, prompt_length=HY_PROMPT, num_inference_steps=steps, seed=0,
                               callback=on_step, logging_file=dlog, latents=latents, **run.generate_kwargs()),
                           (1, 16, lay.num_frames, run.height // 8, run.width // 8), ("hyvideo", "hyvideo"),
                           sap=run.sap, sap_streams=1, **model_sites(cfg))
        dens = [json.loads(line)["avg_density"] for line in open(dlog)] if dlog else []
    if dens:
        log("slice", f"{name} density ({len(dens)} logged layer-steps): mean {np.mean(dens):.4f}, min "
                     f"{min(dens):.4f}, max {max(dens):.4f}" + ("" if latents is None else
                                                               f" (organic, gain {HY_SAP_GAIN})"))
        r["density_mean"] = float(np.mean(dens))
    return r


def phase_hyvideo_slice(dev):
    """HunyuanVideo at HYVIDEO_T2's full width (hidden 3072, 24 heads, D =
    128, MLP 12288, text (1, 256, 4096), pooled (1, 768)) with HY_DOUBLE +
    HY_SINGLE blocks, 720x1280x129: SVG1 for HY_STEPS_SVG steps (first_times_fp
    HY_WARMUP_FP: one dense warm-up step), dense for
    HY_STEPS_DENSE, then the hyvideo-720p-sap run in cluster and in tile mode
    for HY_STEPS_SAP steps (first_times_fp HY_WARMUP_FP: one dense warm-up step,
    which does not cluster: the JAX CLI drops zero_step_kmeans_init; the
    first sparse step clusters cold, the rest warm) on the
    same model made organic (utils/organic.align_fused_qkv at HY_SAP_GAIN,
    smooth latents), as profile_hyvideo runs it. Returns the SVG1 run's
    hyvideo-kind launches and each SAP run's record."""
    from sparse_videogen_tpu_torch.models.hyvideo.model import HYVIDEO_T2, HyVideoModel
    from sparse_videogen_tpu_torch.presets import HY_720P_DENSE, HY_720P_SVG, HY_PRESETS
    from sparse_videogen_tpu_torch.utils.organic import align_fused_qkv, smooth_latents

    cfg = dataclasses.replace(HYVIDEO_T2, mm_double_blocks_depth=HY_DOUBLE, mm_single_blocks_depth=HY_SINGLE)
    t0 = time.perf_counter()
    model = HyVideoModel(cfg, dtype=torch.bfloat16, device=dev).init_random(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log("slice", f"HunyuanVideo hidden {cfg.hidden_size}: {HY_DOUBLE} double + {HY_SINGLE} single blocks, "
                 f"{cfg.heads_num} heads, MLP {cfg.mlp_hidden}, {sum(p.numel() for p in model.parameters()) / 1e9:.3f} "
                 f"B params, init {time.perf_counter() - t0:.1f} s")
    r = drive_hyvideo(model, dataclasses.replace(HY_720P_SVG, first_times_fp=HY_WARMUP_FP), HY_STEPS_SVG)
    drive_hyvideo(model, HY_720P_DENSE, HY_STEPS_DENSE)
    align_fused_qkv(model, cfg.hidden_size, gain=HY_SAP_GAIN)
    run = HY_PRESETS["hyvideo-720p-sap"]
    lat = smooth_latents(torch.Generator(device=dev).manual_seed(2),
                         (1, cfg.out_channels, hy_layout().num_frames, run.height // 8, run.width // 8),
                         dtype=torch.float32)
    sap = {mode: drive_hyvideo(model, dataclasses.replace(HY_PRESETS[name], first_times_fp=HY_WARMUP_FP), HY_STEPS_SAP,
                               latents=lat)
           for mode, name in (("cluster", "hyvideo-720p-sap"), ("tile", "hyvideo-720p-sap-tile"))}
    del model
    torch.cuda.empty_cache()
    return r["kind_launches"]["block_sparse_attn[hyvideo]"], sap


def phase_kernel_probes(dev):
    """The K6 and K7 probe entries (scripts/bench_rmsnorm.py and
    scripts/bench_qsplit.py) on their own data, each kernel's launches
    counted around its probe."""
    from sparse_videogen_tpu_torch import _kernels
    from sparse_videogen_tpu_torch.ops.dense_qsplit import KERNEL_CONFIGS
    from sparse_videogen_tpu_torch.scripts import bench_qsplit, bench_rmsnorm

    iters, warmup = 5, 1
    counts = {}
    inputs = {n: bench_rmsnorm.make_inputs(s, seed=i, device=dev)
              for i, (n, s) in enumerate(bench_rmsnorm.SHAPES.items())}
    _kernels.reset_counts()
    rows = bench_rmsnorm.probe(inputs, iters=iters, warmup=warmup)
    torch.cuda.synchronize()
    counts["rmsnorm"] = _kernels.LAUNCHES["rmsnorm"]
    want = len(inputs) * (iters + warmup)
    log("slice", "K6 probe (bench_rmsnorm): " + ", ".join(
        f"{r['name']} kernel {r['kernel_gbs']:.1f} / plain {r['plain_gbs']:.1f} / F.rms_norm {r['library_gbs']:.1f} "
        f"GB/s" for r in rows) + f"; rmsnorm launches {counts['rmsnorm']} (expected {want})")
    if counts["rmsnorm"] != want:
        raise AssertionError("K6 probe: wrong launch count")
    del inputs
    q, k, v = bench_qsplit.make_inputs(bench_qsplit.SHAPE, seed=0, device=dev)
    _kernels.reset_counts()
    rows = bench_qsplit.probe(q, k, v, iters=iters, warmup=warmup)
    torch.cuda.synchronize()
    counts["dense_qsplit"] = _kernels.LAUNCHES["dense_qsplit"]
    want = len(KERNEL_CONFIGS) * (iters + warmup)
    log("slice", f"K7 probe (bench_qsplit) {bench_qsplit.SHAPE} bf16: " + ", ".join(
        f"{r['name']} {r['ms']:.3f} ms ({r['tflops']:.1f} TFLOP/s)" for r in rows)
        + f"; dense_qsplit launches {counts['dense_qsplit']} (expected {want})")
    if counts["dense_qsplit"] != want:
        raise AssertionError("K7 probe: wrong launch count")
    del q, k, v
    torch.cuda.empty_cache()
    return counts


def phase_small_hyvideo_reference(dev):
    """One forward of the CLI's small HunyuanVideo, kernels on the card vs
    plain versions on the CPU, same weights, inputs and profiler rows: dense
    and SVG1 (prompt 10 of 16 text tokens)."""
    from sparse_videogen_tpu_torch.cli.hyvideo_t2v import SMOKE_CFG, SMOKE_PROMPT_LENGTH
    from sparse_videogen_tpu_torch.config import SVGConfig
    from sparse_videogen_tpu_torch.models.hyvideo.model import HyVideoConfig, HyVideoModel
    from sparse_videogen_tpu_torch.pipelines.hyvideo import hyvideo_layout, make_hyvideo_runtime

    cfg = HyVideoConfig(**SMOKE_CFG)
    gen = torch.Generator().manual_seed(4)
    cpu_model = HyVideoModel(cfg, dtype=torch.bfloat16, device="cpu").init_random(gen)
    gpu_model = HyVideoModel(cfg, dtype=torch.bfloat16, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    lay = hyvideo_layout(cfg, 96, 128, 9)
    rows = torch.randint(0, lay.seq_len, (cfg.num_layers, 64), generator=gen)
    x = torch.randn(1, 16, lay.num_frames, 12, 16, generator=gen).to(torch.bfloat16)
    text = torch.randn(1, cfg.text_len, cfg.text_states_dim, generator=gen).to(torch.bfloat16)
    mask = torch.zeros(1, cfg.text_len, dtype=torch.int32)
    mask[0, :SMOKE_PROMPT_LENGTH] = 1
    pooled = torch.randn(1, cfg.text_states_dim_2, generator=gen).to(torch.bfloat16)
    t, g = torch.full((1,), 900.0), torch.full((1,), 6000.0)
    for pattern in ("dense", "SVG"):
        outs = []
        for model, d in ((gpu_model, dev), (cpu_model, torch.device("cpu"))):
            rt = make_hyvideo_runtime(lay, device=d, prompt_length=SMOKE_PROMPT_LENGTH, pattern=pattern,
                                      svg=SVGConfig(profile_multiplier=1.5))
            outs.append(model(x.to(d), t.to(d), text.to(d), mask.to(d), pooled.to(d), guidance=g.to(d), attention=rt,
                              profile_rows=rows).cpu())
        rel = ((outs[0] - outs[1]).norm() / outs[1].norm()).item()
        # bf16 model: CPU and GPU matmuls round at other places; 4 blocks
        log("slice", f"small HunyuanVideo forward, {pattern}: kernels on the card vs plain on the CPU, "
                     f"rel L2 err {rel:.3e} (tol 3e-2)")
        if not rel <= 3e-2:
            raise AssertionError(f"small HunyuanVideo forward ({pattern}) disagrees with the CPU reference: {rel}")


def cog_run_layout():
    """CogVideoX 768x1360x81's token layout (COG_1_5_5B_I2V: S = 45,106, the 226 text tokens first)."""
    from sparse_videogen_tpu_torch.pipelines.cog import cog_layout
    from sparse_videogen_tpu_torch.presets import COG_768P_SVG as run

    return cog_layout(run.model, run.height, run.width, run.num_frames)


def cog_pairs(spec, plen: int, S: int) -> int:
    """(q, k) pairs of the sequence that the cog predicate allows (the work
    this data needs), per head: a prompt row sees every column; any other
    row the prompt columns and its band |q - k| < w past them."""
    q = np.arange(plen, S, dtype=np.int64)
    band = np.minimum(S, q + spec.band_width) - np.maximum(plen, q - spec.band_width + 1)
    return plen * S + (S - plen) * plen + int(band.sum())


def mask_bias(spec, aux, S: int, dev, rows: int = 1024):
    """A mask kind's predicate (ops/mask_spec.py apply_mask_spec) over an
    S-token sequence as an additive bf16 attn_mask for
    F.scaled_dot_product_attention: 0 where it allows a pair, -inf
    elsewhere, built a slab of rows at a time in an (S, S rounded up to 8)
    buffer so that SDPA takes it without a padded copy. Returns it and the
    pairs it allows. A yardstick only: the port never builds an S x S mask."""
    from sparse_videogen_tpu_torch.ops.mask_spec import apply_mask_spec

    aux_h = [int(a) for a in aux.cpu()]
    bias = torch.empty(S, -(-S // 8) * 8, dtype=torch.bfloat16, device=dev)[:, :S]
    k = torch.arange(S, device=dev)[None, :]
    allowed = 0
    for r0 in range(0, S, rows):
        q = torch.arange(r0, min(S, r0 + rows), device=dev)[:, None]
        ok = apply_mask_spec(spec, q, k, aux_h)
        allowed += int(ok.sum())
        bias[r0:r0 + q.shape[0]] = torch.where(ok, 0.0, float("-inf"))
    return bias, allowed


def masked_sdpa(name, spec, aux, pairs, rows, checked, kernel_out):
    """The library yardstick of K1's masked kinds: one
    F.scaled_dot_product_attention call with the kind's predicate as its
    attn_mask (mask_bias). Holds mask_bias to `pairs` allowed pairs and
    SDPA's output on the `checked` (q, k, v) rows to the kernel's
    (kernel_out), then times it there and on all `rows`; returns both
    times (ms)."""
    S, D, BH = kernel_out.shape[1], rows[0].shape[-1], rows[0].shape[0]
    bias, allowed = mask_bias(spec, aux, S, kernel_out.device)
    if allowed != pairs:
        raise AssertionError(f"{name}: the mask allows {allowed} pairs, the pair count says {pairs}")

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(q[None, :, :S], k[None, :, :S], v[None, :, :S],
                                                                attn_mask=bias)[0]

    max_abs, mean_rel = err_stats(sdpa(*checked), kernel_out)
    ms = cuda_ms(lambda: sdpa(*checked))
    ms_all = cuda_ms(lambda: sdpa(*rows), iters=2)
    log("kernels", f"attention {name}: F.scaled_dot_product_attention with the {spec.kind} predicate as an ({S}, {S}) "
                   f"bf16 attn_mask: {len(checked[0])} checked rows {ms:.3f} ms, all BH={BH} {ms_all:.3f} ms "
                   f"({4 * D * pairs * BH / (ms_all * 1e-3) / 1e12:.1f} TFLOP/s on the allowed pairs); its output vs "
                   f"the kernel's on the checked rows: max_abs_err {max_abs:.3e} (tol {SDPA_TOL_ABS}), mean_rel_err "
                   f"{mean_rel:.3e} (tol {ATTN_TOL_REL})")
    if not (max_abs <= SDPA_TOL_ABS and mean_rel <= ATTN_TOL_REL):
        raise AssertionError(f"masked SDPA (the {name} yardstick) disagrees with the kernel")
    del bias
    return ms, ms_all


def phase_cog_attention(dev):
    """K1 at D = 64 on CogVideoX 768x1360x81 (S = 45,106: 226 text tokens,
    then 11 x 4080 video tokens; 2 x 48 = 96 (batch, head) rows of the CFG
    pair) on the metadata and aux of the pipeline's own runtime: the cog
    kind (SVG1: floor band 5,760, text rows and columns [0, 226) fully
    attended) and the unmasked dense path (kind none, block_q 2048). The
    first and last rows against the plain version (one run), then both timed
    on those 2 rows and on all 96, beside their bounds. The yardstick is
    F.scaled_dot_product_attention: unmasked for the dense path (all 96
    rows), and for the cog kind masked_sdpa (the predicate as an (S, S)
    attn_mask, 4 GB) on the 2 checked rows and on all 96."""
    from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_kv, block_sparse_attention_kv_plain
    from sparse_videogen_tpu_torch.pipelines.cog import make_cog_runtime
    from sparse_videogen_tpu_torch.presets import COG_768P_SVG as run

    lay = cog_run_layout()
    rt = make_cog_runtime(lay, device=dev, pattern="SVG", svg=run.generate_kwargs()["svg"])
    plan = rt.plan
    S, D, BH = lay.seq_len, run.model.head_dim, 2 * run.model.heads_num
    plen = int(rt.aux[0])
    heads = torch.tensor([0, BH - 1], device=dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    cases = {"dense": (rt.dense_meta, plan.dense_mask_spec, plan.dense_block_q),
             "cog": (rt.sparse_meta, plan.mask_spec, plan.block_q)}
    res = {}
    for name, (meta, spec, bq) in cases.items():
        def rand(s_pad, scale):
            x = torch.zeros(BH, s_pad, D, device=dev, dtype=torch.bfloat16)
            x[:, :S] = (torch.randn(BH, S, D, generator=gen, device=dev) * scale).to(torch.bfloat16)
            return x

        q, k, v = rand(-(-S // bq) * bq, 2.0), rand(plan.seq_pad_kv, 1.0), rand(plan.seq_pad_kv, 1.0)
        kw = dict(block_q=bq, block_kv=plan.block_kv, mask_spec=spec)
        out = block_sparse_attention_kv(q, k, v, meta, rt.aux, **kw)
        qs, ks, vs = (x.index_select(0, heads) for x in (q, k, v))
        ref = None

        def plain():
            nonlocal ref
            ref = block_sparse_attention_kv_plain(qs, ks, vs, meta, rt.aux, **kw)

        plain_ms = event_ms(plain)
        max_abs, mean_rel = err_stats(out.index_select(0, heads)[:, :S], ref[:, :S])
        n_cheap = int((meta[..., 0] // 4096).sum())
        log("kernels", f"attention D=64 {name} (mask {spec.kind}, band {spec.band_width}, prompt {plen} text tokens "
                       f"first, S={S}; BH={BH}, rows {heads.tolist()} checked, block_q {bq}, block_kv "
                       f"{plan.block_kv}, meta {tuple(meta.shape)}, {n_cheap} cheap chunks): max_abs_err "
                       f"{max_abs:.3e} (tol {ATTN_TOL_ABS}), mean_rel_err {mean_rel:.3e} (tol {ATTN_TOL_REL})")
        if not (max_abs <= ATTN_TOL_ABS and mean_rel <= ATTN_TOL_REL):
            raise AssertionError(f"attention kernel (D=64 {name}) disagrees with its plain version")
        pairs = S * S if spec.kind == "none" else cog_pairs(spec, plen, S)
        b = attention_bound(len(heads) * pairs, qs[:, :S])
        b_all = attention_bound(BH * pairs, q[:, :S])
        ms = cuda_ms(lambda: block_sparse_attention_kv(qs, ks, vs, meta, rt.aux, **kw))
        ms_all = cuda_ms(lambda: block_sparse_attention_kv(q, k, v, meta, rt.aux, **kw), iters=2)
        log("kernels", f"attention D=64 {name} on the {len(heads)} checked rows: kernel {ms:.3f} ms "
                       f"({4 * D * pairs * len(heads) / (ms * 1e-3) / 1e12:.1f} TFLOP/s on the {pairs / S / S:.4f} "
                       f"of the S x S pairs the mask allows; bound {b['bound_ms']:.3f} ms, {b['bound_by']}), plain "
                       f"{plain_ms:.3f} ms (one run); all BH={BH}: kernel {ms_all:.3f} ms "
                       f"({4 * D * pairs * BH / (ms_all * 1e-3) / 1e12:.1f} TFLOP/s, "
                       f"{4 * D * pairs * BH / 1e12:.2f} TFLOP; bound {b_all['bound_ms']:.3f} ms, {b_all['bound_by']})")
        res[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, ms_all=ms_all, bound_all_ms=b_all["bound_ms"],
                         pairs=pairs, **b)
        if name == "dense":
            sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q[None, :, :S], k[None, :, :S], v[None, :, :S]), iters=2)
            log("kernels", f"attention D=64 dense, all BH={BH}: F.scaled_dot_product_attention {sdpa_ms:.3f} ms "
                           f"({4 * D * S * S * BH / (sdpa_ms * 1e-3) / 1e12:.1f} TFLOP/s)")
            res[name]["sdpa_ms"] = sdpa_ms
        else:
            sdpa_ms, sdpa_all_ms = masked_sdpa("D=64 cog", spec, rt.aux, pairs, (q, k, v), (qs, ks, vs),
                                               out.index_select(0, heads)[:, :S])
            res[name].update(sdpa_ms=sdpa_ms, sdpa_all_ms=sdpa_all_ms)
        del q, k, v, qs, ks, vs, out, ref
    torch.cuda.empty_cache()
    c, d = res["cog"], res["dense"]
    return {"name": "block_sparse_attn[cog]", "route": "cuda",
            "source": "sparse_videogen_tpu_torch/csrc/block_sparse_attn.cu",
            "replaces": "sparse_videogen_tpu/ops/attention.py:62",
            "max_abs_err": max(c["max_abs_err"], d["max_abs_err"]), "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": c["sdpa_ms"], "S": S, "D": D,
            "ms_all_rows": c["ms_all"], "bound_all_rows_ms": c["bound_all_ms"], "library_all_rows_ms": c["sdpa_all_ms"],
            "dense_d64": {"ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
                          "ms_all_rows": d["ms_all"], "bound_all_rows_ms": d["bound_all_ms"],
                          "sdpa_all_rows_ms": d["sdpa_ms"]}}


def phase_cog_rope(dev):
    """K2 at D = 64 on CogVideoX's video rows (96 (batch, head) rows x 44,880
    tokens, the (11, 48, 85) grid's tables with rope_dims (16, 24, 24))
    against its plain version: bit for bit, as at D = 128. Then the model's
    whole route for one of q and k (copy, K2, cat), to show what the copies
    around the kernel cost."""
    from sparse_videogen_tpu_torch.models.common.rope import apply_rope_interleaved, nd_rope_cos_sin
    from sparse_videogen_tpu_torch.ops.rope import rope_apply, rope_plain
    from sparse_videogen_tpu_torch.presets import COG_768P_SVG as run

    lay, cfg = cog_run_layout(), run.model
    grid = (lay.num_frames, run.height // 16, run.width // 16)
    cos, sin = (torch.as_tensor(a, device=dev) for a in nd_rope_cos_sin(grid, cfg.rope_dims))
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(2 * cfg.heads_num, lay.video_length, cfg.head_dim, generator=gen, device=dev).to(torch.bfloat16)
    out, ref = rope_apply(x, cos, sin), rope_plain(x, cos, sin)
    torch.cuda.synchronize()
    max_abs, _ = err_stats(out, ref)
    ms = cuda_ms(lambda: rope_apply(x, cos, sin))
    plain_ms = cuda_ms(lambda: rope_plain(x, cos, sin))
    nbytes = 2 * x.numel() * 2 + 2 * cos.numel() * 4
    b = bound(3.0 * x.numel(), nbytes, PEAK_F32_FLOPS)
    log("kernels", f"rope D=64 {tuple(x.shape)} bf16 (grid {grid}): max_abs_err {max_abs:.3e} (tol 0); kernel {ms:.4f} "
                   f"ms ({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s), plain {plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms "
                   f"({b['bound_by']})")
    if not max_abs == 0.0:
        raise AssertionError(f"rope kernel at D=64 disagrees with its plain version: {max_abs}")
    del x, out, ref
    # the model's route (models/cog/model.py Attention): the video rows of a (B, H, S, D) view of the qk-norm
    # output are copied contiguous, rotated, and joined back to the text rows
    y = torch.randn(2, lay.seq_len, cfg.heads_num, cfg.head_dim, generator=gen, device=dev).to(torch.bfloat16)
    y = y.transpose(1, 2)
    tl = lay.context_length
    route_ms = cuda_ms(lambda: torch.cat([y[:, :, :tl], apply_rope_interleaved(y[:, :, tl:], cos, sin)], dim=2))
    log("kernels", f"rope D=64, the model's route on one (2, 48, {lay.seq_len}, 64) q or k (copy of the video rows, "
                   f"K2, cat with the text rows): {route_ms:.4f} ms, of which K2 {ms:.4f} ms: the copies "
                   f"{route_ms - ms:.4f} ms a tensor, two tensors a layer")
    del y
    return {"shape": [2 * cfg.heads_num, lay.video_length, cfg.head_dim], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "route_ms": route_ms}


def preset_geometry(preset):
    """(run, layout, heads of one CFG stream, head dim) of a Wan or Cosmos preset."""
    from sparse_videogen_tpu_torch.pipelines.cosmos import cosmos_layout
    from sparse_videogen_tpu_torch.presets import COSMOS_PRESETS, PRESETS

    if preset in COSMOS_PRESETS:
        run = COSMOS_PRESETS[preset]
        m = run.model
        return run, cosmos_layout(m, run.height, run.width, run.num_frames), m.num_attention_heads, m.attention_head_dim
    run = PRESETS[preset]
    return run, slice_layout(preset), run.model.num_heads, run.model.head_dim


def spec_pairs(spec, aux, S: int, dev, rows: int = 2048) -> int:
    """(q, k) pairs of an S-token sequence that a mask kind's predicate
    allows, per head (the work this data needs), counted a slab of rows at a
    time."""
    from sparse_videogen_tpu_torch.ops.mask_spec import apply_mask_spec

    aux_h = [int(a) for a in aux.cpu()]
    k = torch.arange(S, device=dev)[None, :]
    return sum(int(apply_mask_spec(spec, torch.arange(r0, min(S, r0 + rows), device=dev)[:, None], k, aux_h).sum())
               for r0 in range(0, S, rows))


def keep_blocks(meta, blocks):
    """meta with every q block's chunk count set to 0 but those of `blocks`:
    the plain version walks the kept blocks alone (q blocks are independent)
    and sees the real q positions, which a mask predicate needs."""
    kept = torch.zeros(meta.shape[1], dtype=torch.bool, device=meta.device)
    kept[blocks] = True
    out = meta.clone()
    out[:, ~kept, 0] = 0
    return out


def phase_cosmos_attention(dev):
    """K1 on Cosmos 704x1280x121's layout (COSMOS_7B: S = 16 x 3,520 =
    56,320, a frame size that is not a multiple of 128; 2 x 32 = 64 rows of
    the CFG batch, D = 128) on the metadata and aux of the pipeline's own
    runtime (cosmos-704p-svg): the dense path (kind none) and SVG1's
    band_sink kind. The first and last rows against the plain version on
    CHECK_BLOCKS q blocks spread over each (keep_blocks), then both timed on
    those 2 rows and on all 64, beside their bounds and
    F.scaled_dot_product_attention (unmasked for the dense path; with the
    band_sink predicate as an (S, S) attn_mask, 6.3 GB, for SVG1)."""
    from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_kv, block_sparse_attention_kv_plain
    from sparse_videogen_tpu_torch.pipelines.cosmos import make_cosmos_runtime

    run, lay, H, D = preset_geometry("cosmos-704p-svg")
    rt = make_cosmos_runtime(lay, device=dev, pattern="SVG", svg=run.svg)
    plan = rt.plan
    S, BH = lay.seq_len, 2 * H
    heads = torch.tensor([0, BH - 1], device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = {"dense": (rt.dense_meta, plan.dense_mask_spec, plan.dense_block_q),
             "svg1": (rt.sparse_meta, plan.mask_spec, plan.block_q)}
    res = {}
    for name, (meta, spec, bq) in cases.items():
        def rand(s_pad, scale):
            x = torch.zeros(BH, s_pad, D, device=dev, dtype=torch.bfloat16)
            x[:, :S] = (torch.randn(BH, S, D, generator=gen, device=dev) * scale).to(torch.bfloat16)
            return x

        q, k, v = rand(-(-S // bq) * bq, 2.0), rand(plan.seq_pad_kv, 1.0), rand(plan.seq_pad_kv, 1.0)
        kw = dict(block_q=bq, block_kv=plan.block_kv, mask_spec=spec)
        out = block_sparse_attention_kv(q, k, v, meta, rt.aux, **kw)
        qs, ks, vs = (x.index_select(0, heads) for x in (q, k, v))
        n_q = meta.shape[1]
        blocks = torch.linspace(0, n_q - 1, min(CHECK_BLOCKS, n_q), device=dev).round().long().unique()
        rows = (blocks[:, None] * bq + torch.arange(bq, device=dev)).reshape(-1)
        rows = rows[rows < S]
        ref = []
        plain_ms = event_ms(lambda: ref.append(block_sparse_attention_kv_plain(qs, ks, vs, keep_blocks(meta, blocks),
                                                                               rt.aux, **kw)))
        max_abs, mean_rel = err_stats(out.index_select(0, heads)[:, rows], ref[0][:, rows])
        log("kernels", f"attention {name} on Cosmos 704x1280x121 (mask {spec.kind}, S={S} = {lay.num_frames} x "
                       f"{lay.frame_size}, BH={BH}, rows {heads.tolist()} on {len(blocks)} of {n_q} q blocks "
                       f"checked, D={D}, block_q {bq}, block_kv {plan.block_kv}, meta {tuple(meta.shape)}): "
                       f"max_abs_err {max_abs:.3e} (tol {ATTN_TOL_ABS}), mean_rel_err {mean_rel:.3e} "
                       f"(tol {ATTN_TOL_REL})")
        if not (max_abs <= ATTN_TOL_ABS and mean_rel <= ATTN_TOL_REL):
            raise AssertionError(f"attention kernel (Cosmos {name}) disagrees with its plain version")
        pairs = S * S if spec.kind == "none" else spec_pairs(spec, rt.aux, S, dev)
        b = attention_bound(len(heads) * pairs, qs[:, :S])
        b_all = attention_bound(BH * pairs, q[:, :S])
        ms = cuda_ms(lambda: block_sparse_attention_kv(qs, ks, vs, meta, rt.aux, **kw))
        ms_all = cuda_ms(lambda: block_sparse_attention_kv(q, k, v, meta, rt.aux, **kw), iters=2)
        log("kernels", f"attention {name} (Cosmos) on the {len(heads)} checked rows: kernel {ms:.3f} ms "
                       f"({4 * D * pairs * len(heads) / (ms * 1e-3) / 1e12:.1f} TFLOP/s on the {pairs / S / S:.4f} of "
                       f"the S x S pairs the mask allows; bound {b['bound_ms']:.3f} ms, {b['bound_by']}), plain "
                       f"{plain_ms:.3f} ms on the checked blocks (one run); all BH={BH}: kernel {ms_all:.3f} ms "
                       f"({4 * D * pairs * BH / (ms_all * 1e-3) / 1e12:.1f} TFLOP/s; bound {b_all['bound_ms']:.3f} "
                       f"ms, {b_all['bound_by']})")
        res[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, ms_all=ms_all, bound_all_ms=b_all["bound_ms"],
                         **b)
        if name == "dense":
            res[name]["sdpa_ms"] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qs[None, :, :S], ks[None, :, :S], vs[None, :, :S]))
            res[name]["sdpa_all_ms"] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q[None, :, :S], k[None, :, :S], v[None, :, :S]), iters=2)
            log("kernels", f"attention dense (Cosmos): F.scaled_dot_product_attention {res[name]['sdpa_ms']:.3f} ms "
                           f"on the checked rows, {res[name]['sdpa_all_ms']:.3f} ms on all BH={BH}")
        else:
            sdpa_ms, sdpa_all_ms = masked_sdpa("Cosmos band_sink", spec, rt.aux, pairs, (q, k, v), (qs, ks, vs),
                                               out.index_select(0, heads)[:, :S])
            res[name].update(sdpa_ms=sdpa_ms, sdpa_all_ms=sdpa_all_ms)
        del q, k, v, qs, ks, vs, out, ref
        torch.cuda.empty_cache()
    s, d = res["svg1"], res["dense"]
    return {"name": "block_sparse_attn[cosmos]", "route": "cuda",
            "source": "sparse_videogen_tpu_torch/csrc/block_sparse_attn.cu",
            "replaces": "sparse_videogen_tpu/ops/attention.py:62",
            "max_abs_err": max(s["max_abs_err"], d["max_abs_err"]), "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"], "library_ms": s["sdpa_ms"], "S": S, "D": D,
            "kind": "band_sink", "ms_all_rows": s["ms_all"], "bound_all_rows_ms": s["bound_all_ms"],
            "library_all_rows_ms": s["sdpa_all_ms"],
            "dense": {"ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"], "library_ms": d["sdpa_ms"],
                      "ms_all_rows": d["ms_all"], "bound_all_rows_ms": d["bound_all_ms"],
                      "library_all_rows_ms": d["sdpa_all_ms"]}}


def drive_cog(model, run, steps):
    """CogVideoX: one CogPipeline.generate_latents run (a CFG batch of 2 a
    forward) through drive_pipeline (K1 dense: kind none; SVG1: cog)."""
    from sparse_videogen_tpu_torch.pipelines import CogPipeline
    from sparse_videogen_tpu_torch.pipelines.cog import latent_frames
    from sparse_videogen_tpu_torch.schedulers import CogDDIM

    cfg = model.cfg
    dev = model.patch_proj.weight.device
    gen = torch.Generator(device=dev).manual_seed(1)
    ctx, ctx_null = (torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen, device=dev).to(torch.bfloat16)
                     for _ in range(2))
    shape = (1, cfg.out_channels, latent_frames(cfg, run.num_frames)[0], run.height // 8, run.width // 8)
    img = torch.randn(1, cfg.out_channels, 1, *shape[3:], generator=gen, device=dev)
    lay = cog_run_layout()
    desc = (f"{run.height}x{run.width}x{run.num_frames} (S={lay.seq_len} = {cfg.text_len} text + "
            f"{lay.num_frames}x{lay.frame_size}), DDIM, CFG batch 2")
    return drive_pipeline(f"CogVideoX hidden {cfg.hidden_size} x {cfg.num_layers} layers", desc,
                          run.generate_kwargs(), run.pattern, CogDDIM(steps).timesteps, cfg.num_layers,
                          lambda on_step: CogPipeline(model).generate_latents(
                              ctx, ctx_null, img, num_inference_steps=steps, seed=0, callback=on_step,
                              **run.generate_kwargs()), shape, ("none", "cog"))


def phase_cog_slice(dev):
    """CogVideoX 1.5 5B I2V at COG_1_5_5B_I2V's full width (hidden 3072, 48
    heads of 64, FFN 12288, T5 states (1, 226, 4096), image latents (1, 16,
    1, 96, 170)) with COG_LAYERS of its 42 layers, 768x1360x81: SVG1 then
    dense for COG_STEPS DDIM steps each (first_times_fp 0.2: step 0 of the
    SVG1 run is dense). Returns the SVG1 run's cog-kind K1 launches and its
    K2 launches (the one model path that runs K2)."""
    from sparse_videogen_tpu_torch.models.cog.model import CogModel
    from sparse_videogen_tpu_torch.presets import COG_768P_DENSE, COG_768P_SVG

    cfg = dataclasses.replace(COG_768P_SVG.model, num_layers=COG_LAYERS)
    t0 = time.perf_counter()
    model = CogModel(cfg, dtype=torch.bfloat16, device=dev).init_random(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log("slice", f"CogVideoX hidden {cfg.hidden_size}: {cfg.num_layers} layers, {cfg.heads_num} heads of "
                 f"{cfg.head_dim}, {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, init "
                 f"{time.perf_counter() - t0:.1f} s")
    r = drive_cog(model, COG_768P_SVG, COG_STEPS)
    drive_cog(model, COG_768P_DENSE, COG_STEPS)
    del model
    torch.cuda.empty_cache()
    return r["kind_launches"]["block_sparse_attn[cog]"], r["launches"]["rope"]


def phase_small_cog_reference(dev):
    """One forward of the CLI's small CogVideoX (ofs on) over a CFG batch of
    2, kernels on the card vs plain versions on the CPU, same weights,
    inputs and profiler rows: dense and SVG1 (the cog kind at D = 64)."""
    from sparse_videogen_tpu_torch.cli.cog_i2v import SMOKE_CFG
    from sparse_videogen_tpu_torch.models.cog.model import CogConfig, CogModel
    from sparse_videogen_tpu_torch.pipelines.cog import cog_layout, make_cog_runtime

    cfg = CogConfig(**SMOKE_CFG, ofs_embed=True)
    gen = torch.Generator().manual_seed(5)
    cpu_model = CogModel(cfg, dtype=torch.bfloat16, device="cpu").init_random(gen)
    gpu_model = CogModel(cfg, dtype=torch.bfloat16, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    lay = cog_layout(cfg, 96, 128, 17)
    rows = torch.randint(0, lay.seq_len, (cfg.num_layers, 32), generator=gen)
    x = torch.randn(2, cfg.in_channels, lay.num_frames * cfg.patch_size_t, 12, 16, generator=gen).to(torch.bfloat16)
    text = torch.randn(2, cfg.text_len, cfg.text_dim, generator=gen).to(torch.bfloat16)
    t = torch.full((2,), 900.0)
    for pattern in ("dense", "SVG"):
        outs = []
        for model, d in ((gpu_model, dev), (cpu_model, torch.device("cpu"))):
            rt = make_cog_runtime(lay, device=d, pattern=pattern)
            outs.append(model(x.to(d), t.to(d), text.to(d), attention=rt, profile_rows=rows).cpu())
        rel = ((outs[0] - outs[1]).norm() / outs[1].norm()).item()
        # bf16 model: CPU and GPU matmuls round at other places; 2 layers
        log("slice", f"small CogVideoX forward, {pattern}: kernels on the card vs plain on the CPU, "
                     f"rel L2 err {rel:.3e} (tol 3e-2)")
        if not rel <= 3e-2:
            raise AssertionError(f"small CogVideoX forward ({pattern}) disagrees with the CPU reference: {rel}")



def dual_heads(flags, S, D, dev, seed):
    """q, k, v of len(flags) heads at S real tokens (q padded to a multiple
    of 1024, k/v to the plan's 128-multiple), bf16 from a seed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    H = len(flags)

    def rand(s_pad, scale):
        x = torch.zeros(H, s_pad, D, device=dev, dtype=torch.bfloat16)
        x[:, :S] = (torch.randn(H, S, D, generator=gen, device=dev) * scale).to(torch.bfloat16)
        return x

    return rand(-(-S // 1024) * 1024, 2.0), rand(-(-S // 128) * 128, 1.0), rand(-(-S // 128) * 128, 1.0)


def phase_inplace_svg1(dev):
    """K1's dual per-head spec (placement-free SVG1) on 4 heads of Wan 1.3B
    480x832x81 (S = 32,760 = 21 x 1560), two spatial (band_sink) and two
    temporal (band_sink_perm), on the dual metadata of the pipeline's own
    runtime (block_q 512, each half classified cheap-first under its spec):
    against the plain version, then timed beside its bound (4 D FLOPs an
    allowed pair), masked SDPA (each class's predicate as an (S, S) attn_mask)
    and the placement path on the same heads (place_heads, K1 band_sink,
    inverse). The dual metadata's visited 128-token sub-blocks per q block,
    and the kernel's time, at block_q 1024, 512 and 128. Returns the
    kernels-line entry."""
    from sparse_videogen_tpu_torch.core import masks as core_masks
    from sparse_videogen_tpu_torch.core.placement import place_heads
    from sparse_videogen_tpu_torch.ops.attention import (block_sparse_attention_kv, block_sparse_attention_kv_plain,
                                                         slab_tile_stats)
    from sparse_videogen_tpu_torch.pipelines.wan import BLOCK_KV, BLOCK_Q
    from sparse_videogen_tpu_torch.presets import T2V_480P
    from sparse_videogen_tpu_torch.sparse.runtimes import SVG1Runtime
    from sparse_videogen_tpu_torch.sparse.svg1 import make_svg1_plan

    lay = slice_layout()
    svg = T2V_480P.generate_kwargs()["svg"]
    S, D = lay.seq_len, 128
    flags = torch.tensor([0, 1, 0, 1], dtype=torch.int32, device=dev)
    H = len(flags)
    q, k, v = dual_heads(flags.tolist(), S, D, dev, seed=7)
    entry, times = None, {}
    for bq in (BLOCK_Q, 1024, 128):
        plan = make_svg1_plan(lay, svg, block_q=bq, block_kv=BLOCK_KV, inplace_temporal=True)
        rt = SVG1Runtime(plan, device=dev)
        spec_pair = plan.mask_spec_dual
        visited = [fn(lay, plan.multiplier, block_q=bq, block_kv=128).sum(1).mean()
                   for fn in (core_masks.execution_mask_block, core_masks.execution_mask_block_perm)]
        meta = torch.where(flags[:, None, None] == 1, rt.sparse_meta[1][None], rt.sparse_meta[0][None]).contiguous()
        aux = torch.cat([rt.aux, flags])
        qb = q[:, :-(-S // bq) * bq].contiguous()
        kw = dict(block_q=bq, block_kv=plan.block_kv, mask_spec=spec_pair)
        ms = cuda_ms(lambda: block_sparse_attention_kv(qb, k, v, meta, aux, **kw))
        times[bq] = ms
        log("kernels", f"dual spec (SVG1 in place), block_q {bq}: visited 128-token sub-blocks a q block: spatial "
                       f"{visited[0]:.1f}, temporal {visited[1]:.1f} of {k.shape[1] // 128}; meta "
                       f"{tuple(rt.sparse_meta.shape)}, n_cheap of the rows: spatial "
                       f"{int((rt.sparse_meta[0, :, 0] // 4096).sum())}, temporal "
                       f"{int((rt.sparse_meta[1, :, 0] // 4096).sum())}; kernel on {H} heads {ms:.3f} ms")
        if bq != BLOCK_Q:
            continue
        log("kernels", f"dual spec, a temporal head's walk (slab_tile_walk's model): {slab_tile_stats(spec_pair[1])}, "
                       f"(warpgroup, slab) pairs by class; the first design's 128-token tiles: "
                       f"tests/test_torch_dual_slabs.py::test_slab_walk_against_the_first_design")
        holed = meta.clone()
        holed[1, 1, 0] = 0  # a temporal head's q block with no window
        try:
            block_sparse_attention_kv(qb, k, v, holed, aux, **kw)
            raise AssertionError("the dual kernel ran a temporal head whose rows have a hole")
        except ValueError as e:
            log("kernels", f"dual spec: a temporal head's rows with a hole are refused before the launch: {e}")
        out = block_sparse_attention_kv(qb, k, v, meta, aux, **kw)
        plain_ms = event_ms(lambda: block_sparse_attention_kv_plain(qb, k, v, meta, aux, **kw))
        ref = block_sparse_attention_kv_plain(qb, k, v, meta, aux, **kw)
        torch.cuda.synchronize()
        max_abs, mean_rel = err_stats(out[:, :S], ref[:, :S])
        log("kernels", f"dual spec, block_q {bq} (heads {flags.tolist()}: 1 = band_sink_perm), S={S}, D={D}: "
                       f"max_abs_err {max_abs:.3e} (tol {ATTN_TOL_ABS}), mean_rel_err {mean_rel:.3e} "
                       f"(tol {ATTN_TOL_REL})")
        if not (max_abs <= ATTN_TOL_ABS and mean_rel <= ATTN_TOL_REL):
            raise AssertionError("K1's dual spec disagrees with its plain version")
        # the yardsticks: masked SDPA a class (its predicate as an attn_mask), and placement
        pairs, lib_ms = 0, 0.0
        for cls, spec in enumerate(spec_pair):
            idx = (flags == cls).nonzero()[:, 0]
            bias, allowed = mask_bias(spec, rt.aux, S, dev)
            pairs += allowed * len(idx)
            qs, ks, vs = (x.index_select(0, idx)[None, :, :S] for x in (qb, k, v))
            sd = lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias)
            s_abs, s_rel = err_stats(sd()[0], out.index_select(0, idx)[:, :S])
            if not (s_abs <= SDPA_TOL_ABS and s_rel <= ATTN_TOL_REL):
                raise AssertionError(f"masked SDPA ({spec.kind}) disagrees with the dual kernel: {s_abs} {s_rel}")
            lib_ms += cuda_ms(sd, iters=2)
            log("kernels", f"dual spec: {spec.kind} allows {allowed} of {S * S} pairs a head "
                           f"({allowed / S / S:.4f}); masked SDPA vs the kernel on those heads max_abs_err "
                           f"{s_abs:.3e}, mean_rel_err {s_rel:.3e}")
            del bias
        is_t = flags.bool()[None]
        place_plan = make_svg1_plan(lay, svg, block_q=bq, block_kv=BLOCK_KV)
        place_rt = SVG1Runtime(place_plan, device=dev)

        def placement():
            qp, kp, vp = (place_heads(x[None, :, :S], is_t, lay)[0] for x in (q, k, v))
            qp = torch.nn.functional.pad(qp, (0, 0, 0, qb.shape[1] - S)).contiguous()
            kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, k.shape[1] - S)).contiguous() for x in (kp, vp))
            o = block_sparse_attention_kv(qp, kp, vp, place_rt.sparse_meta, place_rt.aux, block_q=bq,
                                          block_kv=place_plan.block_kv, mask_spec=place_plan.mask_spec)
            return place_heads(o[None, :, :S], is_t, lay, inverse=True)

        p_abs, p_rel = err_stats(placement()[0], out[:, :S])
        place_ms = cuda_ms(placement)
        b = attention_bound(pairs, qb[:, :S])
        log("kernels", f"dual spec, block_q {bq}, {H} heads: kernel {ms:.3f} ms ({4 * D * pairs / (ms * 1e-3) / 1e12:.1f} "
                       f"TFLOP/s on the allowed pairs), plain {plain_ms:.3f} ms (one run), bound {b['bound_ms']:.3f} "
                       f"ms ({b['bound_by']}), masked SDPA {lib_ms:.3f} ms; the placement path on the same heads "
                       f"(place_heads, K1 band_sink, inverse) {place_ms:.3f} ms, its output vs the dual kernel's "
                       f"max_abs_err {p_abs:.3e} (tol {ATTN_TOL_ABS}), mean_rel_err {p_rel:.3e}")
        if not (p_abs <= ATTN_TOL_ABS and p_rel <= ATTN_TOL_REL):
            raise AssertionError("in-place attention disagrees with the placement path on the same heads")
        entry = {"name": "block_sparse_attn[band_sink_perm]", "route": "cuda",
                 "source": "sparse_videogen_tpu_torch/csrc/block_sparse_attn.cu",
                 "body": "sparse_videogen_tpu_torch/csrc/hopper_attn.cuh",
                 "replaces": "sparse_videogen_tpu/ops/attention.py:269", "max_abs_err": max_abs, "ms": ms,
                 "plain_ms": plain_ms, **b, "library_ms": lib_ms, "block_q_ms": dict(times), "placement_ms": place_ms}
        del out, ref
    entry["block_q_ms"] = times
    log("kernels", f"dual spec kernel ms on {H} heads by block_q: {times}")
    del q, k, v
    torch.cuda.empty_cache()
    return entry


def check_stats(name, got, ref, o_plain_bits=None):
    """(o, m, l) of a kernel against its plain version: o to ATTN_TOL, m to
    STATS_TOL_M where live, the NEG_INF sentinels at the same rows, l to
    STATS_TOL_L_REL of its scale. Returns o's max_abs_err."""
    (o, m, l), (ro, rm, rl) = got, ref
    o_abs, o_rel = err_stats(o, ro)
    dead, rdead = m <= -1e37, rm <= -1e37
    live = ~rdead
    m_abs = (m - rm).abs()[live].max().item() if bool(live.any()) else 0.0
    l_rel = ((l - rl).abs().max() / rl.abs().max().clamp_min(1e-30)).item()
    ok = (o_abs <= ATTN_TOL_ABS and o_rel <= ATTN_TOL_REL and bool(torch.equal(dead, rdead))
          and m_abs <= STATS_TOL_M and l_rel <= STATS_TOL_L_REL and bool((l[dead] == 0).all()))
    log("kernels", f"stats {name}: o max_abs_err {o_abs:.3e} (tol {ATTN_TOL_ABS}); m max_abs_err {m_abs:.3e} "
                   f"(tol {STATS_TOL_M}); l max_rel_err {l_rel:.3e} (tol {STATS_TOL_L_REL}); rows without a live "
                   f"column {int(dead.sum())} (plain {int(rdead.sum())})")
    if not ok:
        raise AssertionError(f"stats of {name} disagree with the plain version")
    return o_abs


def phase_stats(dev):
    """The (m, l) softmax stats (return_stats) of K1, every kind at D = 64
    and 128 and the dual spec, of K3 (mask none) and of K4 (band_sink)
    against the plain versions, with a q block that sees no live column; o
    with the stats equals o without, bit for bit. Shapes: 4 heads of 8,192
    tokens (8 frames of 1,024) for K1's kinds; the run lists of SAP's own
    front half at Wan 1.3B 480p (12 heads) for K3/K4, which are timed there
    with and without the stats. Returns the kernels-line entry of the run-list
    stats instance."""
    from sparse_videogen_tpu_torch.config import VideoLayout
    from sparse_videogen_tpu_torch.ops import metadata as MD
    from sparse_videogen_tpu_torch.ops.attention import (block_sparse_attention_kv, block_sparse_attention_kv_plain,
                                                         block_sparse_attention_runs,
                                                         block_sparse_attention_runs_plain)
    from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec
    from sparse_videogen_tpu_torch.presets import T2V_480P
    from sparse_videogen_tpu_torch.sparse import svg2
    from sparse_videogen_tpu_torch.sparse.svg1 import make_svg1_plan

    lay = VideoLayout(num_frames=8, frame_size=1024)
    S, bq, bkv = lay.seq_len, 512, 1024
    plan = make_svg1_plan(lay, block_q=bq, block_kv=bkv, inplace_temporal=True)
    bm = np.ones((1, S // bq, S // 128), bool)
    bm[0, 1] = False  # q block 1 sees no column
    dense = torch.as_tensor(MD.chunk_meta_np(bm, MD.kv_counts_for_seq(S - 100, S), block_kv=bkv), device=dev)
    flags = torch.tensor([0, 1, 1, 0], dtype=torch.int32, device=dev)
    z = torch.zeros(4, dtype=torch.int32, device=dev)
    kinds = {"none": (MaskSpec(), z), "band_sink": (plan.mask_spec, z),
             "hyvideo": (MaskSpec("hyvideo", 2048, video_len=7000), torch.tensor([7100, 0, 0, 0], device=dev,
                                                                                  dtype=torch.int32)),
             "cog": (MaskSpec("cog", 2048), torch.tensor([226, 0, 0, 0], device=dev, dtype=torch.int32)),
             "dual": (plan.mask_spec_dual, torch.cat([z, flags]))}
    # the dual kernel's temporal heads attend every pair band_sink_perm
    # allows: their plain rows are SVG1's dual metadata (it covers them all),
    # the spatial heads keep the rows above
    temporal = plan.sparse_meta_dual()[1:]
    L = max(temporal.shape[-1], dense.shape[-1])
    rows = [np.pad(m, ((0, 0), (0, 0), (0, L - m.shape[-1]))) for m in (dense.cpu().numpy(), temporal)]
    dual_meta = torch.as_tensor(np.concatenate([rows[int(f)] for f in flags.tolist()]), device=dev)
    for D in (64, 128):
        gen = torch.Generator(device=dev).manual_seed(D)
        q, k, v = ((torch.randn(4, S, D, generator=gen, device=dev) * sc).to(torch.bfloat16) for sc in (2.0, 1, 1))
        for kind, (spec, aux) in kinds.items():
            kw = dict(block_q=bq, block_kv=bkv, mask_spec=spec)
            meta = dual_meta if kind == "dual" else dense
            got = block_sparse_attention_kv(q, k, v, meta, aux, return_stats=True, **kw)
            same = torch.equal(got[0], block_sparse_attention_kv(q, k, v, meta, aux, **kw))
            check_stats(f"K1 {kind} D={D} (4 heads, S={S})", got,
                        block_sparse_attention_kv_plain(q, k, v, meta, aux, return_stats=True, **kw))
            if not same:
                raise AssertionError(f"K1 {kind} D={D}: o with the stats differs from o without")
        del q, k, v
    log("kernels", "stats: K1 o with the stats equals o without, bit for bit, for every kind at D = 64 and 128")

    # K3 / K4 on SAP's own run lists (Wan 1.3B 480p, one CFG stream)
    slay = slice_layout()
    H, S, D = T2V_480P.model.num_heads, slay.seq_len, 128
    sap = T2V_480P.sap
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = ((torch.randn(1, H, S, D, generator=gen, device=dev) * sc).to(torch.bfloat16) for sc in (2.0, 1, 1))
    a = svg2.sap_prepare(q, k, v, svg2.init_sap_state(H, D, sap, device=dev), layout=slay, cfg=sap, generator=gen)
    heads = torch.tensor([0, H - 1], device=dev)
    qs, ks, vs, ms_ = (x.index_select(0, heads).contiguous() for x in (a.q, a.k, a.v, a.meta))
    entry = None
    for name, spec in (("K3 (mask none)", MaskSpec()), ("K4 (band_sink)", make_svg1_plan(slay).mask_spec)):
        kw = dict(block_q=sap.block_q, block_kv=sap.block_kv, mask_spec=spec)
        got = block_sparse_attention_runs(a.q, a.k, a.v, a.meta, return_stats=True, **kw)
        same = torch.equal(got[0], block_sparse_attention_runs(a.q, a.k, a.v, a.meta, **kw))
        plain_ms = event_ms(lambda: block_sparse_attention_runs_plain(qs, ks, vs, ms_, return_stats=True, **kw))
        ref = block_sparse_attention_runs_plain(qs, ks, vs, ms_, return_stats=True, **kw)
        o_abs = check_stats(f"{name} on SAP's 480p run lists (heads {heads.tolist()} of {H})",
                            tuple(x.index_select(0, heads) for x in got), ref)
        if not same:
            raise AssertionError(f"{name}: o with the stats differs from o without")
        t_all = cuda_ms(lambda: block_sparse_attention_runs(a.q, a.k, a.v, a.meta, return_stats=True, **kw))
        t_all_nostats = cuda_ms(lambda: block_sparse_attention_runs(a.q, a.k, a.v, a.meta, **kw))
        t_stats = cuda_ms(lambda: block_sparse_attention_runs(qs, ks, vs, ms_, return_stats=True, **kw))
        t_nostats = cuda_ms(lambda: block_sparse_attention_runs(qs, ks, vs, ms_, **kw))
        b = attention_bound(_run_pairs(ms_, sap.block_q), qs)
        lib_ms = runs_masked_sdpa(f"{name} stats", spec, ms_, a.pos.index_select(0, heads), sap.block_q,
                                  (qs, ks, vs), got[0].index_select(0, heads))
        log("kernels", f"stats {name} on the 2 checked heads: with stats {t_stats:.3f} ms, without {t_nostats:.3f} "
                       f"ms, plain (one run) {plain_ms:.3f} ms, bound on the visited pairs {b['bound_ms']:.3f} ms "
                       f"({b['bound_by']}), masked SDPA {lib_ms:.3f} ms; all {H} heads: with stats {t_all:.3f} ms, "
                       f"without {t_all_nostats:.3f} ms; o with the stats equals o without: {same}")
        row = {"max_abs_err": o_abs, "ms": t_stats, "plain_ms": plain_ms, **b, "library_ms": lib_ms,
               "no_stats_ms": t_nostats, "all_heads_ms": t_all, "all_heads_no_stats_ms": t_all_nostats}
        if entry is None:
            entry = {"name": "block_sparse_attn_runs[stats]", "route": "cuda",
                     "source": "sparse_videogen_tpu_torch/csrc/runs_attn.cu",
                     "body": "sparse_videogen_tpu_torch/csrc/hopper_attn.cuh",
                     "replaces": "sparse_videogen_tpu/ops/attention.py:1093", **row}
        else:
            entry["k4"] = {"replaces": "sparse_videogen_tpu/ops/attention.py:715", **row}
    del q, k, v, a, got, ref
    torch.cuda.empty_cache()
    return entry


def phase_ring(dev):
    """Ring (context-parallel) attention with RING_N ranks as threads of this
    process on the card (parallel/comm.py ThreadRanks: NCCL takes one rank a
    device): the thread communicator's collectives; the dense ring
    (RingDenseRuntime) on full-width Wan 1.3B 480p q, k, v (the CFG pair, 24
    rows, S = 32,760) against single-device K1, with its time per rotation
    and the merge's; the SAP ring (ring_sap.sap_ring_attention) against
    single-device SAP on the same labels (warm centroids, assignment only:
    kmeans_iter_step 0), and at the CLI's SAP config (2 warm iterations) with
    the share of labels that agree; then a forward of Wan 1.3B (full width,
    RING_LAYERS layers) through RingDenseRuntime and through RingSAPRuntime,
    each against the single-device runtime, with the stats kernels' launches
    counted around it. Returns the kernels-line entry of K1's stats instance
    and the two forwards' launches."""
    import dataclasses

    from sparse_videogen_tpu_torch import _kernels
    from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_kv, block_sparse_attention_kv_plain
    from sparse_videogen_tpu_torch.parallel.comm import ThreadRanks
    from sparse_videogen_tpu_torch.parallel.ring import merge_init, merge_partial
    from sparse_videogen_tpu_torch.parallel.ring_runtime import RingDenseRuntime, RingSAPRuntime
    from sparse_videogen_tpu_torch.parallel.ring_sap import sap_ring_attention
    from sparse_videogen_tpu_torch.pipelines.wan import BLOCK_KV, BLOCK_Q
    from sparse_videogen_tpu_torch.presets import T2V_480P
    from sparse_videogen_tpu_torch.sparse import svg2
    from sparse_videogen_tpu_torch.sparse.runtimes import DenseRuntime, SAPRuntime
    from sparse_videogen_tpu_torch.sparse.svg1 import make_svg1_plan

    n = RING_N
    ranks = ThreadRanks(n)

    def collectives(comm):
        x = torch.full((3,), float(comm.rank + 1), device=dev)
        return comm.rotate(x), comm.all_reduce_sum(x), torch.stack(comm.all_gather(x))

    res = ranks.run(collectives)
    ok = all(float(r[0][0]) == (i - 1) % n + 1 and float(r[1][0]) == n * (n + 1) / 2
             and r[2][:, 0].tolist() == [j + 1.0 for j in range(n)] for i, r in enumerate(res))
    log("ring", f"thread communicator, {n} ranks on the card: rotate, all_reduce_sum, all_gather agree {ok}")
    if not ok:
        raise AssertionError("the thread communicator's collectives are wrong")

    lay = slice_layout()
    cfgm = T2V_480P.model
    plan = make_svg1_plan(lay, T2V_480P.generate_kwargs()["svg"], block_q=BLOCK_Q, block_kv=BLOCK_KV)
    B, H, S, D = 2, cfgm.num_heads, lay.seq_len, cfgm.head_dim
    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v = ((torch.randn(B, H, S, D, generator=gen, device=dev) * sc).to(torch.bfloat16) for sc in (2.0, 1, 1))
    ring = RingDenseRuntime(plan, ranks, device=dev)
    single = DenseRuntime(plan, device=dev)
    out, ref = ring(q, k, v, 900.0, 0), single(q, k, v, 900.0, 0)
    max_abs, mean_rel = err_stats(out, ref)
    ring_ms, single_ms = cuda_ms(lambda: ring(q, k, v, 900.0, 0), iters=3), cuda_ms(lambda: single(q, k, v, 900.0, 0),
                                                                                     iters=3)
    # one rotation of rank 0 (its own shard, then its neighbour's) and one merge, alone
    Sl = ring.shard
    qpad = torch.nn.functional.pad(q, (0, 0, 0, Sl * n - S))
    kpad, vpad = (torch.nn.functional.pad(x, (0, 0, 0, Sl * n - S)) for x in (k, v))
    q0 = qpad[:, :, :Sl].reshape(B * H, Sl, D).contiguous()
    kv_src = [(kpad[:, :, j * Sl:(j + 1) * Sl].reshape(B * H, Sl, D).contiguous(),
               vpad[:, :, j * Sl:(j + 1) * Sl].reshape(B * H, Sl, D).contiguous()) for j in range(n)]
    kw = dict(block_q=plan.block_q, block_kv=ring.block_kv, mask_spec=plan.dense_mask_spec)
    rot = lambda j, stats=True: block_sparse_attention_kv(q0, *kv_src[j], ring.meta_all[0, j][None],
                                                          ring.aux_all[0, j], return_stats=stats, **kw)
    rot_ms = [cuda_ms(lambda: rot(j)) for j in range(n)]
    rot_nostats_ms = cuda_ms(lambda: rot(0, False))
    o_r, m_r, l_r = rot(1)
    st = merge_init((B * H, Sl), D, dev)
    merge_ms = cuda_ms(lambda: merge_partial(st, o_r, m_r, l_r))
    log("ring", f"dense ring, {n} ranks (threads), Wan 1.3B 480p q/k/v (B={B}, H={H}, S={S} padded to {Sl * n}, "
                f"D={D}, block_q {plan.block_q}, block_kv {ring.block_kv}): vs single-device K1 max_abs_err "
                f"{max_abs:.3e} (tol {ATTN_TOL_ABS}), mean_rel_err {mean_rel:.3e} (tol {ATTN_TOL_REL}); ring "
                f"{ring_ms:.3f} ms, single device {single_ms:.3f} ms; rank 0's rotations (K1 with stats, "
                f"{B * H} x {Sl} q rows against a {Sl}-token shard) {[round(x, 4) for x in rot_ms]} ms, without "
                f"stats {rot_nostats_ms:.4f} ms; one merge {merge_ms:.4f} ms")
    if not (max_abs <= ATTN_TOL_ABS and mean_rel <= ATTN_TOL_REL):
        raise AssertionError("the dense ring disagrees with single-device K1")
    # K1 stats entry: rank 0's rotation against its neighbour's shard, at the ring's shapes
    heads = torch.tensor([0, B * H - 1], device=dev)
    sub = lambda x: x.index_select(0, heads).contiguous()
    got = rot(1)
    plain_kw = dict(kw)
    args = (sub(q0), sub(kv_src[1][0]), sub(kv_src[1][1]), ring.meta_all[0, 1][None], ring.aux_all[0, 1])
    plain_ms = event_ms(lambda: block_sparse_attention_kv_plain(*args, return_stats=True, **plain_kw))
    o_abs = check_stats(f"K1 none (the dense ring's rotation, rows {heads.tolist()} of {B * H})",
                        tuple(x.index_select(0, heads) for x in got),
                        block_sparse_attention_kv_plain(*args, return_stats=True, **plain_kw))
    real = min(Sl, S - Sl)  # real kv tokens in shard 1
    b = attention_bound(B * H * min(Sl, S) * real, q0)
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q0[None], kv_src[1][0][None, :, :real], kv_src[1][1][None, :, :real]))
    entry = {"name": "block_sparse_attn[stats]", "route": "cuda",
             "source": "sparse_videogen_tpu_torch/csrc/block_sparse_attn.cu",
             "body": "sparse_videogen_tpu_torch/csrc/hopper_attn.cuh",
             "replaces": "sparse_videogen_tpu/ops/attention.py:406", "max_abs_err": o_abs, "ms": rot_ms[1],
             "plain_ms": plain_ms, **b, "library_ms": lib_ms, "no_stats_ms": rot_nostats_ms, "merge_ms": merge_ms,
             "ring_ms": ring_ms, "single_device_ms": single_ms}
    del out, ref, qpad, kpad, vpad, q0, kv_src, got, o_r, m_r, l_r, st

    # SAP ring against single-device SAP (one CFG stream)
    sap = T2V_480P.sap
    qs, ks, vs = (x[:1] for x in (q, k, v))
    warm = svg2.sap_prepare(qs, ks, vs, svg2.init_sap_state(H, D, sap, device=dev), layout=lay, cfg=sap,
                            generator=gen).state
    Sl = S // n
    part = lambda x, r: x[:, :, r * Sl:(r + 1) * Sl]
    for iters in (0, sap.kmeans_iter_step):
        cfg = dataclasses.replace(sap, kmeans_iter_step=iters)
        ref_out, ref_state = svg2.sap_sparse_attention(qs, ks, vs, warm, layout=lay, cfg=cfg)
        run = lambda: ranks.run(lambda c: sap_ring_attention(part(qs, c.rank), part(ks, c.rank), part(vs, c.rank),
                                                             warm, c, layout=lay, cfg=cfg))
        res = run()
        out = torch.cat([r[0] for r in res], dim=2)
        ring_ms = cuda_ms(lambda: run(), iters=2)
        single_ms = cuda_ms(lambda: svg2.sap_sparse_attention(qs, ks, vs, warm, layout=lay, cfg=cfg), iters=2)
        max_abs, mean_rel = err_stats(out, ref_out)
        cent = (res[0][1].k_centroids.float() - ref_state.k_centroids.float()).abs().max().item()
        # the labels of the last iteration, from both sides' pre-update centroids
        agree = None
        if iters:
            from sparse_videogen_tpu_torch.ops.kmeans import kmeans_assign_update

            prev = dataclasses.replace(cfg, kmeans_iter_step=iters - 1)
            _, st_single = svg2.sap_sparse_attention(qs, ks, vs, warm, layout=lay, cfg=prev)
            st_ring = ranks.run(lambda c: sap_ring_attention(part(qs, c.rank), part(ks, c.rank), part(vs, c.rank),
                                                             warm, c, layout=lay, cfg=prev))[0][1]
            kf = ks.reshape(H, S, D)
            la = kmeans_assign_update(kf, st_single.k_centroids.to(kf.dtype))[0]
            lb = kmeans_assign_update(kf, st_ring.k_centroids.to(kf.dtype))[0]
            agree = (la == lb).float().mean().item()
        log("ring", f"SAP ring, {n} ranks, Wan 1.3B 480p one stream (H={H}, S={S}, QC {cfg.num_q_centroids}, KC "
                    f"{cfg.num_k_centroids}), warm centroids, kmeans_iter_step {iters}: vs single-device SAP "
                    f"max_abs_err {max_abs:.3e}, mean_rel_err {mean_rel:.3e}; k centroids max diff {cent:.3e}"
                    + ("" if agree is None else f"; k labels of the last iteration agree on {agree:.6f}")
                    + f"; ring {ring_ms:.3f} ms, single device {single_ms:.3f} ms")
        if iters == 0 and not (max_abs <= ATTN_TOL_ABS and mean_rel <= ATTN_TOL_REL):
            raise AssertionError("the SAP ring disagrees with single-device SAP on the same labels")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("the SAP ring output is not finite")
    del q, k, v, qs, ks, vs, out, ref_out
    torch.cuda.empty_cache()

    # Wan 1.3B forwards through the ring runtimes
    model = _new_model(dataclasses.replace(cfgm, num_layers=RING_LAYERS), dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    launches = {}
    for pattern, batch in (("dense", 2), ("SAP", 1)):
        x = torch.randn(batch, 16, lay.num_frames, T2V_480P.height // 8, T2V_480P.width // 8, generator=gen,
                        device=dev).to(torch.bfloat16)
        ctx = torch.randn(batch, cfgm.text_len, cfgm.text_dim, generator=gen, device=dev).to(torch.bfloat16)
        t = torch.full((batch,), 500.0, device=dev)
        if pattern == "dense":
            rts = (RingDenseRuntime(plan, ranks, device=dev), DenseRuntime(plan, device=dev))
        else:
            from sparse_videogen_tpu_torch.config import WarmupSchedule

            w = WarmupSchedule(first_layers=0, first_times=1000.0)
            rts = (RingSAPRuntime(plan, sap, w, ranks, device=dev), SAPRuntime(plan, sap, w, device=dev))
            idx = [tuple(torch.randint(0, S, (H, c), generator=gen, device=dev)
                         for c in (sap.num_q_centroids, sap.num_k_centroids)) for _ in range(RING_LAYERS)]
            for rt in rts:
                rt.kmeans_init = idx
        outs = []
        for i, rt in enumerate(rts):
            torch.cuda.synchronize()
            _kernels.reset_counts()
            outs.append(model(x, t, ctx, attention=rt, generator=torch.Generator(device=dev).manual_seed(0)).float())
            torch.cuda.synchronize()
            if i == 0:
                got_l, got_k, plain = dict(_kernels.LAUNCHES), dict(_kernels.KIND_LAUNCHES), dict(_kernels.PLAIN_CALLS)
        rel = ((outs[0] - outs[1]).norm() / outs[1].norm()).item()
        key = "block_sparse_attn[stats]" if pattern == "dense" else "block_sparse_attn_runs[stats]"
        want = RING_LAYERS * n * n
        log("ring", f"Wan 1.3B forward ({RING_LAYERS} layers, full width, batch {batch}) through the {pattern} ring "
                    f"runtime, {n} ranks: vs the single-device runtime rel L2 {rel:.3e} (tol 3e-2); {key} launches "
                    f"{got_k.get(key, 0)} (expected {want}), launches {got_l}, plain-version calls {plain}")
        if got_k.get(key, 0) != want or any(plain.values()) or not rel <= 3e-2:
            raise AssertionError(f"the {pattern} ring forward: wrong launches, a plain call, or output off: {rel}")
        launches[key] = got_k[key]
    del model
    torch.cuda.empty_cache()
    return entry, launches


# ---------------------------------------------------------------------------
# quantized linears, the DPM++ sampler, Ulysses, USP and the ring on every family
# ---------------------------------------------------------------------------


def _quantized(model, quant):
    """A copy of `model` whose block linears (Wan's blocks, HunyuanVideo's
    double and single blocks: the CLIs' --quant subtree) are int8 W8A8 or
    fp8 weight-only; "none" returns the model itself."""
    import copy

    from sparse_videogen_tpu_torch.utils.quant import quantize_linears_fp8, quantize_linears_int8

    if quant == "none":
        return model
    qfn = quantize_linears_int8 if quant == "int8" else quantize_linears_fp8
    model = copy.deepcopy(model)
    for name in ("blocks", "double_blocks", "single_blocks"):
        if hasattr(model, name):
            qfn(getattr(model, name))
    return model


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def quant_linear_ms(block, tokens: int, text_tokens: int, dev) -> dict:
    """Device ms of one Wan block's 10 linears on a forward's inputs (the CFG
    pair: `tokens` rows, the cross-attention's k / v on `text_tokens`), by
    CUDA events: bf16 F.linear; int8 W8A8 whole and in its parts (the
    per-token quantize, the int8 GEMM, the rescale); fp8 whole and its
    upcast of the weights."""
    from sparse_videogen_tpu_torch.models.common import layers as L
    from sparse_videogen_tpu_torch.utils.quant import fp8_quantize_linear, int8_matmul, int8_quantize_linear

    lins = [(block.self_attn.q, tokens), (block.self_attn.k, tokens), (block.self_attn.v, tokens),
            (block.self_attn.o, tokens), (block.cross_attn.q, tokens), (block.cross_attn.k, text_tokens),
            (block.cross_attn.v, text_tokens), (block.cross_attn.o, tokens), (block.ffn["fc1"], tokens),
            (block.ffn["fc2"], tokens)]
    ms = collections.Counter()
    gen = torch.Generator(device=dev).manual_seed(12)
    for lin, m in lins:
        x = torch.randn(m, lin.in_features, generator=gen, device=dev).to(torch.bfloat16)
        q8, f8 = int8_quantize_linear(lin), fp8_quantize_linear(lin)
        xi, s = L.quantize_per_token(x)
        y = int8_matmul(xi, q8.wi8)
        ms["bf16"] += cuda_ms(lambda: L.linear(lin, x))
        ms["int8"] += cuda_ms(lambda: L.linear(q8, x))
        ms["int8 quantize"] += cuda_ms(lambda: L.quantize_per_token(x))
        ms["int8 GEMM"] += cuda_ms(lambda: int8_matmul(xi, q8.wi8))
        ms["int8 rescale"] += cuda_ms(lambda: L.rescale(y, s, q8.wscale, q8.bias, x.dtype))
        ms["fp8"] += cuda_ms(lambda: L.linear(f8, x))
        ms["fp8 upcast"] += cuda_ms(lambda: L.fp8_weight(f8.w8, f8.scale, x.dtype))
        del x, xi, s, y, q8, f8
    return dict(ms)


def profile_top_ops(forward, n: int = 12) -> list:
    """forward() once under torch.profiler: the n ops with the most device
    time (self), as (name, ms, calls)."""
    forward()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    dev_ms = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3
    rows = sorted(((e.key, dev_ms(e), e.count) for e in prof.key_averages()), key=lambda r: -r[1])
    return [r for r in rows if r[1] > 0][:n]


def int8_gemm_entry(dev) -> dict:
    """The int8 GEMM (torch._int_mm, cuBLASLt) at Wan 1.3B's fc1 on the CFG
    pair at 480p beside bf16 F.linear at the same shape, each with its bound:
    the operations over the int8 (bf16) tensor-core peak and the bytes (x
    and W read once, the int32 (bf16) output written once) over 3.35 TB/s."""
    from sparse_videogen_tpu_torch.utils.quant import int8_matmul

    M, K, N = INT8_FC1
    gen = torch.Generator(device=dev).manual_seed(13)
    xi = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
    wi = torch.randint(-127, 128, (N, K), generator=gen, device=dev, dtype=torch.int8)
    x, w = (torch.randn(r, K, generator=gen, device=dev).to(torch.bfloat16) for r in (M, N))
    y = int8_matmul(xi[:64], wi)
    exact = torch.equal(y.cpu().long(), xi[:64].cpu().long() @ wi.cpu().long().T)
    i8_ms = cuda_ms(lambda: int8_matmul(xi, wi))
    bf_ms = cuda_ms(lambda: torch.nn.functional.linear(x, w))
    ops = 2.0 * M * K * N
    i8 = bound(ops, M * K + N * K + 4 * M * N, PEAK_INT8_OPS)
    bf = bound(ops, 2 * (M * K + N * K) + 2 * M * N)
    log("quant", f"int8 GEMM (torch._int_mm) ({M} x {K}) @ ({K} x {N}): {i8_ms:.4f} ms ({ops / i8_ms / 1e9:.1f} TOPS; "
                 f"bound {i8['bound_ms']:.4f} ms, {i8['bound_by']}), bf16 F.linear {bf_ms:.4f} ms "
                 f"({ops / bf_ms / 1e9:.1f} TFLOP/s; bound {bf['bound_ms']:.4f} ms, {bf['bound_by']}); int8 / bf16 "
                 f"{i8_ms / bf_ms:.3f}; 64 rows exact against int64 on the host {exact}")
    if not exact:
        raise AssertionError("the int8 GEMM's int32 sums are not exact")
    del xi, wi, x, w
    return {"int8_ms": i8_ms, "bf16_ms": bf_ms, "int8_bound": i8, "bf16_bound": bf}


def phase_quant(dev):
    """The CLIs' --quant on the card: Wan 2.1 1.3B at full width and
    QUANT_LAYERS of its 30 layers, 480x832x81, dense and SVG1, each with the
    block linears in bf16, int8 W8A8 (torch._int_mm) and fp8 weight-only,
    QUANT_STEPS UniPC steps each through drive_pipeline (launches held to
    the configuration, no plain version, finite latents); per run its s a
    warm step and peak GiB, its latents against the bf16 run's
    (QUANT_LATENT_TOL); the block linears' device ms of one forward by part
    (quant_linear_ms) and the ops with the most device time of one int8
    forward (torch.profiler); the int8 GEMM at fc1's shape beside bf16
    F.linear with their bounds. Then HunyuanVideo at HYVIDEO_T2's full
    width, HY_DOUBLE + HY_SINGLE blocks, 720x1280x129: one dense step in
    bf16, int8 and fp8 (the modulation linears run on one row), held
    likewise."""
    from sparse_videogen_tpu_torch.models.hyvideo.model import HYVIDEO_T2, HyVideoModel
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime
    from sparse_videogen_tpu_torch.presets import HY_720P_DENSE, T2V_480P

    gemm = int8_gemm_entry(dev)
    cfg = dataclasses.replace(T2V_480P.model, num_layers=QUANT_LAYERS)
    base = _new_model(cfg, dev)
    lay = slice_layout()
    ms = quant_linear_ms(base.blocks[0], 2 * lay.seq_len, 2 * cfg.text_len, dev)
    per_forward = {k: v * cfg.num_layers for k, v in ms.items()}
    log("quant", f"Wan 1.3B block linears, one forward ({cfg.num_layers} layers, CFG pair, {2 * lay.seq_len} rows): "
                 + ", ".join(f"{k} {v:.3f} ms" for k, v in per_forward.items())
                 + f"; int8 glue (quantize + rescale) {per_forward['int8 quantize'] + per_forward['int8 rescale']:.3f}"
                 f" ms against the GEMM's saving over bf16 {per_forward['bf16'] - per_forward['int8 GEMM']:.3f} ms")
    out = {"gemm": gemm, "linears_ms": per_forward, "wan": {}, "hyvideo": {}}
    for pattern in ("dense", "SVG"):
        lat = {}
        for quant in ("none", "int8", "fp8"):
            model = _quantized(base, quant)
            r = drive(model, T2V_480P, pattern, QUANT_STEPS)
            lat[quant] = r["latents"]
            out["wan"][(pattern, quant)] = {"per_step_s": r["per_step_s"], "peak_gib": r["peak_gib"]}
            if quant == "int8" and pattern == "dense":
                x = torch.randn(2, 16, lay.num_frames, 60, 104, device=dev).to(torch.bfloat16)
                ctx = torch.randn(2, cfg.text_len, cfg.text_dim, device=dev).to(torch.bfloat16)
                t = torch.full((2,), 500.0, device=dev)
                rt = make_wan_runtime(lay, device=dev, pattern="dense")
                top = profile_top_ops(lambda: model(x, t, ctx, attention=rt))
                log("quant", "one int8 dense forward, device ms by op (torch.profiler, self time): "
                             + ", ".join(f"{name} {v:.3f} ({c})" for name, v, c in top))
                out["top_ops_int8"] = top
                del x, ctx
            if model is not base:
                del model
        for quant in ("int8", "fp8"):
            rel = rel_l2(lat[quant], lat["none"])
            warm = lambda q: out["wan"][(pattern, q)]["per_step_s"][1:]
            log("quant", f"Wan 1.3B {pattern}, {quant} against bf16: latents rel L2 {rel:.3e} (tol "
                         f"{QUANT_LATENT_TOL}); warm s a step {[round(x, 4) for x in warm(quant)]} against "
                         f"{[round(x, 4) for x in warm('none')]}; peak {out['wan'][(pattern, quant)]['peak_gib']:.2f} "
                         f"against {out['wan'][(pattern, 'none')]['peak_gib']:.2f} GiB")
            out["wan"][(pattern, quant)]["rel_l2"] = rel
            if not rel <= QUANT_LATENT_TOL:
                raise AssertionError(f"Wan {pattern} {quant}: latents off the bf16 run's by {rel}")
    del base
    torch.cuda.empty_cache()

    hcfg = dataclasses.replace(HYVIDEO_T2, mm_double_blocks_depth=HY_DOUBLE, mm_single_blocks_depth=HY_SINGLE)
    hbase = HyVideoModel(hcfg, dtype=torch.bfloat16, device=dev).init_random(torch.Generator(device=dev).manual_seed(0))
    lat = {}
    for quant in ("none", "int8", "fp8"):
        model = _quantized(hbase, quant)
        r = drive_hyvideo(model, HY_720P_DENSE, 1)
        lat[quant] = r["latents"]
        out["hyvideo"][quant] = {"s": r["per_step_s"][0], "peak_gib": r["peak_gib"]}
        if model is not hbase:
            del model
    for quant in ("int8", "fp8"):
        rel = rel_l2(lat[quant], lat["none"])
        out["hyvideo"][quant]["rel_l2"] = rel
        log("quant", f"HunyuanVideo {HY_DOUBLE}+{HY_SINGLE} blocks 720p, one dense step, {quant} against bf16: "
                     f"latents rel L2 {rel:.3e} (tol {QUANT_LATENT_TOL}); s {out['hyvideo'][quant]['s']:.4f} against "
                     f"{out['hyvideo']['none']['s']:.4f}; peak {out['hyvideo'][quant]['peak_gib']:.2f} against "
                     f"{out['hyvideo']['none']['peak_gib']:.2f} GiB")
        if not rel <= QUANT_LATENT_TOL:
            raise AssertionError(f"HunyuanVideo {quant}: latents off the bf16 run's by {rel}")
    del hbase
    torch.cuda.empty_cache()
    return out


def phase_dpm(dev):
    """--sampler dpm++ on the card: Wan 2.1 1.3B at full width, QUANT_LAYERS
    layers, 480x832x81, DPM_STEPS FlowDPM steps of SVG1 through
    drive_pipeline (launches held, finite latents); then the CLI's small Wan
    (bf16) for DPM_STEPS dense steps from the same latents on the card and
    on the CPU, held within the small references' 3e-2 rel L2."""
    from sparse_videogen_tpu_torch.cli.wan_t2v import SMOKE_CFG
    from sparse_videogen_tpu_torch.models.wan.model import WanConfig, WanModel
    from sparse_videogen_tpu_torch.pipelines import WanPipeline
    from sparse_videogen_tpu_torch.presets import T2V_480P

    model = _new_model(dataclasses.replace(T2V_480P.model, num_layers=QUANT_LAYERS), dev)
    r = drive(model, T2V_480P, "SVG", DPM_STEPS, sampler="dpm++")
    del model
    torch.cuda.empty_cache()
    cfg = WanConfig(**SMOKE_CFG)
    gen = torch.Generator().manual_seed(6)
    cpu_model = WanModel(cfg, dtype=torch.bfloat16, device="cpu").init_random(gen)
    gpu_model = WanModel(cfg, dtype=torch.bfloat16, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen).to(torch.bfloat16)
    lat0 = torch.randn(1, 16, 3, 12, 16, generator=gen)
    outs = [WanPipeline(m).generate_latents(ctx, torch.zeros_like(ctx), height=96, width=128, num_frames=9,
                                            num_inference_steps=DPM_STEPS, sampler="dpm++", pattern="dense",
                                            latents=lat0).cpu()
            for m in (gpu_model, cpu_model)]
    rel = rel_l2(outs[0], outs[1])
    log("dpm", f"Wan 1.3B {QUANT_LAYERS} layers SVG1, {DPM_STEPS} dpm++ steps: s a step "
               f"{[round(x, 4) for x in r['per_step_s']]}; the small Wan, {DPM_STEPS} dpm++ dense steps, card vs CPU: "
               f"latents rel L2 {rel:.3e} (tol 3e-2)")
    if not rel <= 3e-2:
        raise AssertionError(f"dpm++ on the card disagrees with the CPU: {rel}")
    return r


def _timed_run(fn):
    """(fn()'s output, its seconds by CUDA events, the kernel counters around it)."""
    from sparse_videogen_tpu_torch import _kernels

    torch.cuda.synchronize()
    _kernels.reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    counts = {**_kernels.LAUNCHES, **{k: v for k, v in _kernels.KIND_LAUNCHES.items() if "stats" in k}}
    plain = dict(_kernels.PLAIN_CALLS)
    if any(plain.values()):
        raise AssertionError(f"a plain version ran on the card: {plain}")
    return out, start.elapsed_time(end) / 1e3, counts


def phase_ulysses(dev):
    """Ulysses, USP and the ring on every family, the ranks as threads of
    this process on the card (parallel/comm.ThreadRanks; NCCL takes one rank
    a device): Wan 2.1 1.3B at full width, ULYSSES_LAYERS layers, 480x832x81,
    one step each of dense, SVG1 and SAP (cluster) over ULYSSES_SP head
    ranks against one device (the same profiler rows, the same k-means
    draws: the head-local draw tiled over the heads), dense held bit for bit
    (K1 runs each head alone) and its runtime output on full-width q, k, v
    too; USP (ring 2 x heads 2) dense on HunyuanVideo 720p 2 + 2 blocks
    (text last, the live prompt); the dense ring (2 ranks) on CogVideoX
    768x1360x81 and Cosmos 704x1280x121, 2 layers each. Each run's attention
    launches are held to the ranks' share of the work and the s a step is
    printed beside one device's (the ranks share one card: a figure, not a
    speed-up)."""
    from sparse_videogen_tpu_torch.models.cog.model import CogModel
    from sparse_videogen_tpu_torch.models.cosmos.model import CosmosModel
    from sparse_videogen_tpu_torch.models.hyvideo.model import HYVIDEO_T2, HyVideoModel
    from sparse_videogen_tpu_torch.parallel.comm import ThreadRanks
    from sparse_videogen_tpu_torch.parallel.ulysses import UlyssesRuntime
    from sparse_videogen_tpu_torch.pipelines import CogPipeline, CosmosPipeline, HyVideoPipeline, WanPipeline
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime
    from sparse_videogen_tpu_torch.presets import COG_768P_DENSE, COSMOS_PRESETS, HY_720P_DENSE, T2V_480P

    sp = ULYSSES_SP
    lay = slice_layout()
    cfg = dataclasses.replace(T2V_480P.model, num_layers=ULYSSES_LAYERS)
    H, D = cfg.num_heads, cfg.head_dim
    model = _new_model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    # the runtime alone: dense over sp head ranks equals one device bit for bit
    q, k, v = (torch.randn(2, H, lay.seq_len, D, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    one = make_wan_runtime(lay, device=dev, pattern="dense")
    uly = make_wan_runtime(lay, device=dev, pattern="dense", mesh=ThreadRanks(sp=sp))
    same = torch.equal(uly(q, k, v, 500.0, 0), one(q, k, v, 500.0, 0))
    log("ulysses", f"dense runtime over {sp} head ranks (threads), Wan 1.3B 480p q/k/v (2, {H}, {lay.seq_len}, {D}): "
                   f"equal to one device bit for bit {same}")
    if not same or not isinstance(uly, UlyssesRuntime):
        raise AssertionError("Ulysses dense attention is not one device's, bit for bit")
    del q, k, v
    run = T2V_480P
    ctx, ctx_null = (torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen, device=dev).to(torch.bfloat16)
                     for _ in range(2))
    lat0 = torch.randn(1, 16, lay.num_frames, run.height // 8, run.width // 8, generator=gen, device=dev)
    rows = [torch.randint(0, lay.seq_len, (cfg.num_layers, 64), generator=gen, device=dev)]
    sap = run.sap
    local = [[{li: tuple(torch.randint(0, lay.seq_len, (H // sp, c), generator=gen, device=dev)
                         for c in (sap.num_q_centroids, sap.num_k_centroids)) for li in range(cfg.num_layers)}
              for _ in range(2)]]
    tiled = [[{li: tuple(x.repeat(sp, 1) for x in d) for li, d in s.items()} for s in local[0]]]
    kw = dict(run.generate_kwargs(), first_layers_fp=0.0, first_times_fp=0.0)
    for pattern in ("dense", "SVG", "SAP"):
        res = []
        for mesh, init in ((None, tiled), (ThreadRanks(sp=sp), local)):
            res.append(_timed_run(lambda: WanPipeline(model)._denoise(
                ctx, ctx_null, lat0, num_inference_steps=1, pattern=pattern, profile_rows=rows,
                kmeans_init=init if pattern == "SAP" else None, mesh=mesh, generator=torch.Generator(device=dev),
                **kw)))
        (a, ta, la), (b, tb, lb) = res
        rel = rel_l2(b, a)
        attn = {n: c for n, c in la.items() if n not in MODEL_KERNELS and c}
        want = {n: sp * c for n, c in attn.items()}
        got = {n: lb.get(n, 0) for n in attn}
        ok = (torch.equal(a, b) if pattern == "dense" else rel <= ULYSSES_TOL) and got == want \
            and all(lb.get(n) == la.get(n) for n in MODEL_KERNELS)
        log("ulysses", f"Wan 1.3B {cfg.num_layers} layers, {pattern}, one step over {sp} head ranks against one "
                       f"device: latents rel L2 {rel:.3e} ({'bit for bit' if pattern == 'dense' else f'tol {ULYSSES_TOL}'}"
                       f"; equal {torch.equal(a, b)}); attention launches {got} (expected {want}), the model's "
                       f"{ {n: lb.get(n) for n in MODEL_KERNELS} } (one device { {n: la.get(n) for n in MODEL_KERNELS} }); "
                       f"s {tb:.4f} against {ta:.4f} (x{tb / ta:.3f})")
        if not ok:
            raise AssertionError(f"Wan Ulysses {pattern}: latents or launches off")
    del model
    torch.cuda.empty_cache()

    def against_one(label, make_pipe, steps_kw, mesh, n_layers, tol=RING_FAMILY_TOL):
        make_pipe().generate_latents(**steps_kw)  # the layout's first run (metadata, launch set-up), untimed
        (a, ta, la), (b, tb, lb) = (_timed_run(lambda m=m: make_pipe().generate_latents(mesh=m, **steps_kw))
                                    for m in (None, mesh))
        rel = rel_l2(b, a)
        rotations = mesh.rp * mesh.sp * mesh.rp * n_layers
        got = lb.get("block_sparse_attn[stats]", 0)
        log("ulysses", f"{label}: latents rel L2 {rel:.3e} (tol {tol}); K1 stats launches {got} (expected "
                       f"{rotations}); s {tb:.4f} against {ta:.4f} one device (x{tb / ta:.3f})")
        if not (rel <= tol and got == rotations and torch.isfinite(b).all()):
            raise AssertionError(f"{label}: latents or launches off")

    hcfg = dataclasses.replace(HYVIDEO_T2, mm_double_blocks_depth=HY_DOUBLE, mm_single_blocks_depth=HY_SINGLE)
    hmodel = HyVideoModel(hcfg, dtype=torch.bfloat16, device=dev).init_random(torch.Generator(device=dev).manual_seed(0))
    text = torch.randn(1, hcfg.text_len, hcfg.text_states_dim, generator=gen, device=dev).to(torch.bfloat16)
    mask = torch.zeros(1, hcfg.text_len, dtype=torch.int32, device=dev)
    mask[0, :HY_PROMPT] = 1
    pooled = torch.randn(1, hcfg.text_states_dim_2, generator=gen, device=dev).to(torch.bfloat16)
    against_one(f"HunyuanVideo {HY_DOUBLE}+{HY_SINGLE} blocks 720p, dense, one step, USP ring 2 x heads 2",
                lambda: HyVideoPipeline(hmodel),
                dict(text_states=text, text_mask=mask, text_pooled=pooled, prompt_length=HY_PROMPT,
                     num_inference_steps=1, seed=0, **HY_720P_DENSE.generate_kwargs()),
                ThreadRanks(2, 2), hcfg.num_layers)
    del hmodel
    torch.cuda.empty_cache()

    ccfg = dataclasses.replace(COG_768P_DENSE.model, num_layers=2)
    cmodel = CogModel(ccfg, dtype=torch.bfloat16, device=dev).init_random(torch.Generator(device=dev).manual_seed(0))
    cctx = torch.randn(1, ccfg.text_len, ccfg.text_dim, generator=gen, device=dev).to(torch.bfloat16)
    img = torch.randn(1, ccfg.out_channels, 1, COG_768P_DENSE.height // 8, COG_768P_DENSE.width // 8, generator=gen,
                      device=dev)
    against_one("CogVideoX 2 layers 768x1360x81, dense, one step, ring 2", lambda: CogPipeline(cmodel),
                dict(context=cctx, context_null=cctx, image_latents=img, num_inference_steps=1, seed=0,
                     **COG_768P_DENSE.generate_kwargs()), ThreadRanks(2), ccfg.num_layers)
    del cmodel
    torch.cuda.empty_cache()

    crun = COSMOS_PRESETS["cosmos-704p-dense"]
    kcfg = dataclasses.replace(crun.model, num_layers=2)
    kmodel = CosmosModel(kcfg, dtype=torch.bfloat16, device=dev).init_random(torch.Generator(device=dev).manual_seed(0))
    kctx = torch.randn(1, 512, kcfg.text_embed_dim, generator=gen, device=dev).to(torch.bfloat16)
    against_one("Cosmos 2 layers 704x1280x121, dense, one step, ring 2", lambda: CosmosPipeline(kmodel),
                dict(context=kctx, context_null=kctx, num_inference_steps=1, seed=0,
                     **dict(crun.generate_kwargs(), first_layers_fp=0.0, first_times_fp=0.0)),
                ThreadRanks(2), kcfg.num_layers)
    del kmodel
    torch.cuda.empty_cache()


def phase_fsdp(dev):
    """FSDP weight sharding (parallel/sharding.py) on Wan 2.1 14B T2V at its
    published widths (dim 5120, 40 heads of 128, FFN 13824), FSDP_LAYERS of
    its 40 layers, 480x832x81: one dense step and one SVG1 step (CFG batch
    2; the same profiler rows) unsharded, then sharded over the thread-rank
    grids FSDP_GRIDS (dp 2; dp 2 x sp 2, Ulysses within each dp slice; the
    same seed's weights), each held bit for bit to the unsharded latents.
    Prints each rank's resident parameter bytes against the unsharded
    bytes, the same for the full 40-layer tree as the rule shards it (meta
    device, bytes only), a block's all-gather ms (CUDA events) and each
    step's s, and the K1 / qk_norm_rope launches of every run. Returns the launches of
    the dp 2 x sp 2 run."""
    from sparse_videogen_tpu_torch.models.wan.model import WAN_14B, WanModel
    from sparse_videogen_tpu_torch.parallel.comm import ThreadRanks
    from sparse_videogen_tpu_torch.parallel.sharding import plan_bytes, shard_params
    from sparse_videogen_tpu_torch.pipelines import WanPipeline
    from sparse_videogen_tpu_torch.presets import T2V_480P

    cfg = dataclasses.replace(WAN_14B, num_layers=FSDP_LAYERS)
    run = dataclasses.replace(T2V_480P, model=cfg)
    lay = slice_layout()
    gen = torch.Generator(device=dev).manual_seed(18)
    ctx, ctx_null = (torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen, device=dev).to(torch.bfloat16)
                     for _ in range(2))
    lat0 = torch.randn(1, 16, lay.num_frames, run.height // 8, run.width // 8, generator=gen, device=dev)
    rows = [torch.randint(0, lay.seq_len, (cfg.num_layers, 64), generator=gen, device=dev)]
    kw = dict(run.generate_kwargs(), first_layers_fp=0.0, first_times_fp=0.0)
    gib = lambda b: f"{b / 2**30:.3f} GiB"  # noqa: E731
    for grid in FSDP_GRIDS:
        full = plan_bytes(WanModel(WAN_14B, device="meta"), grid)
        log("fsdp", f"Wan 14B, all 40 layers, grid dp x rp x sp {grid}: {gib(full['total'])} of parameters, "
                    f"{gib(full['sharded'])} of them sharded; a rank keeps {gib(full['per_rank'])} "
                    f"({full['per_rank'] / full['total']:.4f} of the whole; 1/{grid[0] * grid[1] * grid[2]} of the "
                    "sharded part plus the replicated rest)")

    def steps(model, mesh):
        out = {}
        for pattern in ("dense", "SVG"):
            out[pattern] = _timed_run(lambda: WanPipeline(model)._denoise(
                ctx, ctx_null, lat0, num_inference_steps=1, pattern=pattern, profile_rows=rows, mesh=mesh,
                generator=torch.Generator(device=dev), **kw))
        return out

    model = _new_model(cfg, dev)
    steps(model, None)  # the layout's first run (metadata, launch set-up), untimed
    ref = steps(model, None)
    whole = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    for pattern, (_, s_, counts) in ref.items():
        log("fsdp", f"unsharded, {pattern}: s {s_:.4f} a step; launches K1 {counts.get('block_sparse_attn')}, "
                    f"qk_norm_rope {counts.get('qk_norm_rope')}")
    del model
    torch.cuda.empty_cache()
    launches = {}
    for dp, rp, sp in FSDP_GRIDS:
        mesh = ThreadRanks(rp, sp, dp=dp)
        model = shard_params(_new_model(cfg, dev), mesh)
        torch.cuda.synchronize()
        resident = [model.resident_bytes(g) for g in mesh.local_ranks]
        nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
        sharded = sum(nbytes(t) for t in model.shards[0].values())
        block = model.units["blocks.0."]
        block_bytes = sum(nbytes(model.shards[0][n]) * model.plan[n][2] for n in block)
        model.gather(block)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(FSDP_GATHER_ITERS):
            model.gather(block)
        end.record()
        torch.cuda.synchronize()
        gather_ms = start.elapsed_time(end) / FSDP_GATHER_ITERS
        log("fsdp", f"grid dp {dp} x rp {rp} x sp {sp} ({mesh.size} thread ranks on the card): {len(model.plan)} "
                    f"tensors sharded; resident bytes a rank {[gib(b) for b in resident]} against {gib(whole)} "
                    f"unsharded ({resident[0] / whole:.4f}; the slices alone {gib(sharded)} a rank); a block's "
                    f"all-gather of {len(block)} tensors, {gib(block_bytes)}: {gather_ms:.3f} ms "
                    f"({block_bytes / gather_ms / 1e6:.1f} GB/s)")
        got = steps(model, mesh)
        for pattern, (lat, s_, counts) in got.items():
            want_lat, want_s, want_counts = ref[pattern]
            same = torch.equal(lat, want_lat)
            # attention runs once where the grid has no head axis, else on every rank (each dp slice its heads)
            attn = {n: c * (dp * sp if sp > 1 else 1) for n, c in want_counts.items() if n not in MODEL_KERNELS and c}
            ok_launch = {n: counts.get(n, 0) for n in attn} == attn and all(
                counts.get(n) == want_counts.get(n) for n in MODEL_KERNELS)
            diff = (lat.float() - want_lat.float()).abs().max().item()
            log("fsdp", f"grid ({dp}, {rp}, {sp}), {pattern}: latents equal to the unsharded ones bit for bit "
                        f"{same} (max |diff| {diff:.3e}); s {s_:.4f} a step against {want_s:.4f} unsharded "
                        f"(x{s_ / want_s:.3f}); launches K1 {counts.get('block_sparse_attn')} (expected "
                        f"{attn.get('block_sparse_attn')}), qk_norm_rope {counts.get('qk_norm_rope')}")
            if not (same and ok_launch and torch.isfinite(lat).all()):
                raise AssertionError(f"FSDP grid {(dp, rp, sp)} {pattern}: latents or launches off")
            launches = counts
        del model
        torch.cuda.empty_cache()
    return launches


def phase_prompt_extend(dev):
    """The prompt extender (utils/prompt_extend.TorchQwenPromptExpander) on
    the port's causal LM at Qwen2.5-7B-Instruct's published widths
    (QWEN25_7B; random bf16 weights from a seed, ~15 GB on the card) and a
    Qwen2-style ByteLevel-BPE tokenizer.json with the ChatML specials that
    the phase writes (bpe_tokenizer_files, style "qwen"): PE_NEW_TOKENS
    greedy tokens through the expander twice (the same PromptOutput) and
    through llama_greedy_generate twice (the same ids), ms a generated token
    and peak GiB; then PE_CHECK_LAYERS of the 28 layers: the logits of the
    chat prompt on the card against the same weights' f32 logits on the CPU
    (PE_LOGIT_TOL)."""
    from sparse_videogen_tpu_torch.models.common.llama import LlamaConfig, LlamaModel, llama_greedy_generate
    from sparse_videogen_tpu_torch.models.common.llama import llama_lm_logits
    from sparse_videogen_tpu_torch.utils.prompt_extend import LM_EN_SYS_PROMPT, TorchQwenPromptExpander

    prompt = "A cat walks on the grass, realistic"
    cfg = LlamaConfig(**QWEN25_7B)
    with tempfile.TemporaryDirectory() as tmp:
        chat = TorchQwenPromptExpander._TMPL.format(system=LM_EN_SYS_PROMPT, user=prompt)
        ids = bpe_tokenizer_files(tmp, [chat], "qwen", vocab_size=QWEN25_REGULAR_TOKENS)
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(dict(QWEN25_7B, eos_token_id=ids["<|im_end|>"]), f)
        t0 = time.perf_counter()
        model = LlamaModel(cfg, dtype=torch.bfloat16, device=dev, qkv_bias=True, lm=True).init_random(
            torch.Generator(device=dev).manual_seed(25))
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        log("prompt_extend", f"LM at Qwen2.5-7B widths: {n_params / 1e9:.3f} B params, "
                             f"{n_params * 2 / 2**30:.2f} GiB bf16, init {time.perf_counter() - t0:.1f} s")
        expander = TorchQwenPromptExpander(tmp, max_new_tokens=PE_NEW_TOKENS, device=dev, model=model)
        prompt_ids = expander.tokenizer.encode(chat)
        torch.cuda.reset_peak_memory_stats()
        outs = [expander(prompt, tar_lang="en", seed=0) for _ in range(2)]
        gens, secs = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gens.append(llama_greedy_generate(model, prompt_ids, max_new_tokens=PE_NEW_TOKENS, eos_id=expander.eos_id))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms_tok = [1e3 * s_ / max(len(g), 1) for s_, g in zip(secs, gens)]
        # one step re-encodes the prefix: every weight read once, 2 x params FLOPs a token
        tokens = len(prompt_ids) + (len(gens[0]) - 1) / 2
        b = bound(2 * n_params * tokens, 2 * n_params)
        log("prompt_extend", f"a step's bound: {b['bound_ms']:.3f} ms ({b['bound_by']}: {2 * n_params / 1e9:.2f} GB of "
                             f"weights, {2 * n_params * tokens / 1e12:.2f} TFLOP over {tokens:.0f} tokens on average)")
        log("prompt_extend", f"{len(prompt_ids)} prompt tokens, {len(gens[0])} generated (no KV cache: each step "
                             f"re-encodes the prefix): ms a token {ms_tok[0]:.2f} / {ms_tok[1]:.2f}; peak "
                             f"{peak:.2f} GiB; ids {gens[0]}; the same ids twice {gens[0] == gens[1]}; the "
                             f"expander's output twice equal {outs[0] == outs[1]}, status {outs[0].status}: "
                             f"{outs[0].prompt[:80]!r}")
        if not (gens[0] == gens[1] and outs[0] == outs[1] and outs[0].status and outs[0].prompt
                and len(gens[0]) == PE_NEW_TOKENS):
            raise AssertionError(f"prompt extension is not deterministic or failed: {outs[0].message}")
        del model, expander
        torch.cuda.empty_cache()
    small = dataclasses.replace(cfg, num_layers=PE_CHECK_LAYERS)
    card = LlamaModel(small, dtype=torch.bfloat16, device=dev, qkv_bias=True, lm=True).init_random(
        torch.Generator(device=dev).manual_seed(26))
    cpu = LlamaModel(small, dtype=torch.float32, device="cpu", qkv_bias=True, lm=True)
    cpu.load_state_dict({k: v.float().cpu() for k, v in card.state_dict().items()})
    arr = torch.tensor([prompt_ids])
    got = llama_lm_logits(card, arr.to(dev), torch.ones_like(arr).to(dev)).cpu()
    want = llama_lm_logits(cpu, arr, torch.ones_like(arr))
    rel = rel_l2(got, want)
    agree = (got[0].argmax(-1) == want[0].argmax(-1)).float().mean().item()
    log("prompt_extend", f"{PE_CHECK_LAYERS} of 28 layers, the chat prompt's logits {tuple(got.shape)}: card (bf16) "
                         f"against the CPU (f32, the same weights) rel L2 {rel:.3e} (tol {PE_LOGIT_TOL}); argmax "
                         f"agrees at {agree:.3f} of the positions")
    if not (rel <= PE_LOGIT_TOL and torch.isfinite(got).all()):
        raise AssertionError(f"LM logits on the card off the f32 CPU logits: {rel}")
    del card, cpu
    torch.cuda.empty_cache()
    return {"ms_per_token": ms_tok, "peak_gib": peak}


def phase_timer(dev):
    """utils/timer.time_logging (TIME_BENCH=1: CUDA events read after a
    synchronize) around K1, the dense runtime on Wan 1.3B 480p q / k / v,
    TIMER_ITERS calls, within TIMER_TOL of the phase's own CUDA events
    around the same calls."""
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime
    from sparse_videogen_tpu_torch.utils import timer as T

    lay = slice_layout()
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(2, 12, lay.seq_len, 128, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    rt = make_wan_runtime(lay, device=dev, pattern="dense")
    rt(q, k, v, 500.0, 0)
    old = os.environ.get("TIME_BENCH")
    os.environ["TIME_BENCH"] = "1"
    try:
        T.print_operator_log_data(clear=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(TIMER_ITERS):
            with T.time_logging("K1 dense"):
                rt(q, k, v, 500.0, 0)
        end.record()
        torch.cuda.synchronize()
        secs, counts = T.get_log()
    finally:
        T.print_operator_log_data(clear=True)
        if old is None:
            os.environ.pop("TIME_BENCH")
        else:
            os.environ["TIME_BENCH"] = old
    ours, theirs = 1e3 * secs["K1 dense"] / counts["K1 dense"], start.elapsed_time(end) / TIMER_ITERS
    dev_rel = abs(ours - theirs) / theirs
    log("timer", f"time_logging around K1 (dense, (2, 12, {lay.seq_len}, 128)): {ours:.3f} ms a call over "
                 f"{counts['K1 dense']} calls against the phase's CUDA events {theirs:.3f} ms ({dev_rel:.4f} apart, "
                 f"tol {TIMER_TOL})")
    if not dev_rel <= TIMER_TOL:
        raise AssertionError(f"utils/timer off the CUDA events: {ours} against {theirs}")


# ---------------------------------------------------------------------------
# prompt -> video: the tokenizer, UMT5, the DiT, the Wan VAE and the writer
# ---------------------------------------------------------------------------


def write_spiece(path: str, pieces, unk_id: int) -> None:
    """A sentencepiece ModelProto in the protobuf wire format, by hand:
    pieces [(piece, score, type)] as field 1 (piece 1, score 2 as a float,
    type 3), trainer_spec (field 2) with unk_id (field 40)."""
    def varint(n):
        out = bytearray()
        while True:
            b, n = n & 0x7F, n >> 7
            out.append(b | (0x80 if n else 0))
            if not n:
                return bytes(out)

    def field(num, wire, payload):
        return varint(num << 3 | wire) + (varint(len(payload)) + payload if wire == 2 else payload)

    msg = b"".join(field(1, 2, field(1, 2, p.encode()) + field(2, 5, struct.pack("<f", s)) + field(3, 0, varint(t)))
                   for p, s, t in pieces)
    msg += field(2, 2, field(40, 0, varint(unk_id)))
    with open(os.path.join(path, "spiece.model"), "wb") as f:
        f.write(msg)


def synthetic_vocab(texts):
    """<pad>, </s>, <unk> (id 2), "▁", "▁" + every word of `texts` and every
    character of them: a Unigram vocabulary that covers the texts."""
    words = sorted({w for t in texts for w in t.split()})
    chars = sorted({c for t in texts for c in t if not c.isspace()})
    return ([("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2), ("▁", -2.0, 1)]
            + [("▁" + w, -1.0 - 0.01 * len(w), 1) for w in words] + [(c, -3.0, 1) for c in chars])


def _randn(g, *shape, fan_in=None):
    return torch.randn(shape, generator=g) / np.sqrt(fan_in or shape[-1])


def reference_wan_sd(cfg, g) -> dict:
    """A Wan DiT state dict in the reference's (wan_orig) names; an I2V
    config adds the image branch (drawn after the T2V weights)."""
    d, sd = cfg.dim, {}

    def lin(key, di, do):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _randn(g, do, di), 0.1 * torch.randn(do, generator=g)

    sd["patch_embedding.weight"] = _randn(g, d, cfg.in_dim, *cfg.patch_size, fan_in=cfg.in_dim * 4)
    sd["patch_embedding.bias"] = torch.zeros(d)
    lin("text_embedding.0", cfg.text_dim, d)
    lin("text_embedding.2", d, d)
    lin("time_embedding.0", cfg.freq_dim, d)
    lin("time_embedding.2", d, d)
    lin("time_projection.1", d, 6 * d)
    sd["head.modulation"] = _randn(g, 1, 2, d)
    lin("head.head", d, 4 * cfg.out_dim)
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        sd[f"{b}.modulation"] = _randn(g, 1, 6, d)
        for att in ("self_attn", "cross_attn"):
            for nm in "qkvo":
                lin(f"{b}.{att}.{nm}", d, d)
            sd[f"{b}.{att}.norm_q.weight"], sd[f"{b}.{att}.norm_k.weight"] = torch.ones(d), torch.ones(d)
        sd[f"{b}.norm3.weight"], sd[f"{b}.norm3.bias"] = torch.ones(d), torch.zeros(d)
        lin(f"{b}.ffn.0", d, cfg.ffn_dim)
        lin(f"{b}.ffn.2", cfg.ffn_dim, d)
    if cfg.model_type == "i2v":
        for i in range(cfg.num_layers):
            b = f"blocks.{i}.cross_attn"
            lin(f"{b}.k_img", d, d)
            lin(f"{b}.v_img", d, d)
            sd[f"{b}.norm_k_img.weight"] = torch.ones(d)
        for key, n in (("img_emb.proj.0", cfg.image_dim), ("img_emb.proj.4", d)):
            sd[f"{key}.weight"], sd[f"{key}.bias"] = torch.ones(n), torch.zeros(n)
        lin("img_emb.proj.1", cfg.image_dim, d)
        lin("img_emb.proj.3", d, d)
    return sd


def reference_umt5_sd(cfg, g) -> dict:
    """A UMT5 encoder state dict in the reference's (wan_orig t5.py) names."""
    sd = {"token_embedding.weight": torch.randn(cfg.vocab_size, cfg.dim, generator=g),
          "norm.weight": torch.ones(cfg.dim)}
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        for nm in "qkv":
            sd[f"{b}.attn.{nm}.weight"] = _randn(g, cfg.dim_attn, cfg.dim)
        sd[f"{b}.attn.o.weight"] = _randn(g, cfg.dim, cfg.dim_attn)
        sd[f"{b}.norm1.weight"], sd[f"{b}.norm2.weight"] = torch.ones(cfg.dim), torch.ones(cfg.dim)
        sd[f"{b}.pos_embedding.embedding.weight"] = 0.1 * torch.randn(cfg.num_buckets, cfg.num_heads, generator=g)
        sd[f"{b}.ffn.gate.0.weight"] = _randn(g, cfg.dim_ffn, cfg.dim)
        sd[f"{b}.ffn.fc1.weight"] = _randn(g, cfg.dim_ffn, cfg.dim)
        sd[f"{b}.ffn.fc2.weight"] = _randn(g, cfg.dim, cfg.dim_ffn)
    return sd


def _vae_sd_writers(sd, g):
    """conv(key, co, ci, *k) and res(prefix, ci, co) writing the reference's
    Wan VAE names into sd."""
    def conv(key, co, ci, *k):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _randn(g, co, ci, *k, fan_in=ci * int(np.prod(k))), torch.zeros(co)

    def res(prefix, ci, co):
        sd[f"{prefix}.residual.0.gamma"] = torch.ones(ci, 1, 1, 1)
        conv(f"{prefix}.residual.2", co, ci, 3, 3, 3)
        sd[f"{prefix}.residual.3.gamma"] = torch.ones(co, 1, 1, 1)
        conv(f"{prefix}.residual.6", co, co, 3, 3, 3)
        if ci != co:
            conv(f"{prefix}.shortcut", co, ci, 1, 1, 1)

    def middle(side, c):
        res(f"{side}.middle.0", c, c)
        sd[f"{side}.middle.1.norm.gamma"] = torch.ones(c, 1, 1)
        conv(f"{side}.middle.1.to_qkv", 3 * c, c, 1, 1)
        conv(f"{side}.middle.1.proj", c, c, 1, 1)
        res(f"{side}.middle.2", c, c)

    return conv, res, middle


def reference_vae_encoder_sd(cfg, g) -> dict:
    """The encoder side (and conv1) of a Wan VAE state dict in the
    reference's names: encoder.downsamples is one flat list, each stage's
    residual blocks ending in a resample (a stride-2 conv, and a time_conv
    where the stage downsamples in time)."""
    sd = {}
    conv, res, middle = _vae_sd_writers(sd, g)
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    conv("encoder.conv1", dims[0], 3, 3, 3, 3)
    idx = 0
    for i, (ci, co) in enumerate(zip(dims[:-1], dims[1:])):
        for j in range(cfg.num_res_blocks):
            res(f"encoder.downsamples.{idx}", ci if j == 0 else co, co)
            idx += 1
        if i != len(cfg.dim_mult) - 1:
            conv(f"encoder.downsamples.{idx}.resample.1", co, co, 3, 3)
            if cfg.temporal_downsample[i]:
                conv(f"encoder.downsamples.{idx}.time_conv", co, co, 3, 1, 1)
            idx += 1
    middle("encoder", dims[-1])
    sd["encoder.head.0.gamma"] = torch.ones(dims[-1], 1, 1, 1)
    conv("encoder.head.2", 2 * cfg.z_dim, dims[-1], 3, 3, 3)
    conv("conv1", 2 * cfg.z_dim, 2 * cfg.z_dim, 1, 1, 1)
    return sd


def reference_clip_vision_sd(cfg, g) -> dict:
    """A CLIP vision tower state dict in HF CLIPVisionModel's names."""
    d, v = cfg.dim, "vision_model."
    sd = {f"{v}embeddings.patch_embedding.weight": 0.02 * torch.randn(d, 3, cfg.patch_size, cfg.patch_size,
                                                                      generator=g),
          f"{v}embeddings.class_embedding": 0.02 * torch.randn(d, generator=g),
          f"{v}embeddings.position_embedding.weight": 0.01 * torch.randn(1 + cfg.grid**2, d, generator=g)}
    for ln in ("pre_layrnorm", "post_layernorm"):
        sd[f"{v}{ln}.weight"], sd[f"{v}{ln}.bias"] = torch.ones(d), torch.zeros(d)
    for i in range(cfg.num_layers):
        b = f"{v}encoder.layers.{i}"
        for nm, di, do in (("self_attn.q_proj", d, d), ("self_attn.k_proj", d, d), ("self_attn.v_proj", d, d),
                           ("self_attn.out_proj", d, d), ("mlp.fc1", d, cfg.ffn_dim), ("mlp.fc2", cfg.ffn_dim, d)):
            sd[f"{b}.{nm}.weight"], sd[f"{b}.{nm}.bias"] = _randn(g, do, di), torch.zeros(do)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{b}.{ln}.weight"], sd[f"{b}.{ln}.bias"] = torch.ones(d), torch.zeros(d)
    return sd


def reference_vae_decoder_sd(cfg, g) -> dict:
    """The decoder side (and conv2) of a Wan VAE state dict in the
    reference's (wan_orig vae.py) names: decoder.upsamples is one flat list
    of residual blocks, each stage's ending in a resample."""
    sd = {}
    conv, res, middle = _vae_sd_writers(sd, g)
    dims = [cfg.dim * u for u in (cfg.dim_mult[-1],) + tuple(cfg.dim_mult[::-1])]
    conv("conv2", cfg.z_dim, cfg.z_dim, 1, 1, 1)
    conv("decoder.conv1", dims[0], cfg.z_dim, 3, 3, 3)
    middle("decoder", dims[0])
    idx = 0
    for i, (ci, co) in enumerate(zip(dims[:-1], dims[1:])):
        for j in range(cfg.num_res_blocks + 1):
            res(f"decoder.upsamples.{idx}", (ci // 2 if i in (1, 2, 3) else ci) if j == 0 else co, co)
            idx += 1
        if i != len(cfg.dim_mult) - 1:
            conv(f"decoder.upsamples.{idx}.resample.1", co // 2, co, 3, 3)
            if cfg.temporal_upsample[i]:
                conv(f"decoder.upsamples.{idx}.time_conv", 2 * co, co, 3, 1, 1)
            idx += 1
    sd["decoder.head.0.gamma"] = torch.ones(dims[-1], 1, 1, 1)
    conv("decoder.head.2", 3, dims[-1], 3, 3, 3)
    return sd


# the tiny checkpoint's CLIP vision tower (HF CLIPVisionConfig keys): the I2V
# smoke model's image_dim, 16 tokens of 4 x 4 patches + the class token
TINY_CLIP = dict(image_size=56, patch_size=14, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
                 num_attention_heads=4, hidden_act="gelu")


def write_tiny_checkpoint(path: str, prompt: str, i2v: bool = False) -> None:
    """A checkpoint dir as the CLIs' --model_dir reads it, written with the
    port's safetensors writer: transformer/ (a Wan T2V, or with `i2v` a Wan
    I2V, of the smoke model's widths, head_dim 64 as the kernels take it, 2
    layers), umt5/ (2 layers), vae/ (the smoke VAE's config, decoder and
    encoder), image_encoder/ (a small CLIP vision tower in HF's names, HF's
    config.json with vision_config), their config.json files and a
    spiece.model covering `prompt`."""
    from sparse_videogen_tpu_torch.cli import wan_i2v, wan_t2v
    from sparse_videogen_tpu_torch.io.encoders import clip_config_from_hf
    from sparse_videogen_tpu_torch.io.safetensors import save_file
    from sparse_videogen_tpu_torch.models.common.t5 import T5Config
    from sparse_videogen_tpu_torch.models.wan.model import WanConfig
    from sparse_videogen_tpu_torch.models.wan.vae import WanVAEConfig

    g = torch.Generator().manual_seed(5)
    pieces = synthetic_vocab([prompt, wan_t2v.DEFAULT_NEG_PROMPT])
    dit = dict(wan_i2v.SMOKE_CFG if i2v else wan_t2v.SMOKE_CFG, num_layers=2)
    t5 = dict(vocab_size=len(pieces), dim=dit["text_dim"], dim_attn=dit["text_dim"], dim_ffn=128, num_heads=2,
              num_layers=2, num_buckets=8)
    vae = dict(wan_t2v.SMOKE_VAE_CFG, dim_mult=list(wan_t2v.SMOKE_VAE_CFG["dim_mult"]))
    vae_cfg = WanVAEConfig(**wan_t2v.SMOKE_VAE_CFG)
    subs = [("transformer", reference_wan_sd(WanConfig(**dit), g), dit),
            ("umt5", reference_umt5_sd(T5Config(**t5), g), t5),
            ("vae", reference_vae_decoder_sd(vae_cfg, g), vae)]
    subs[2][1].update(reference_vae_encoder_sd(vae_cfg, g))
    clip = {"vision_config": TINY_CLIP}
    subs.append(("image_encoder", reference_clip_vision_sd(clip_config_from_hf(clip), g), clip))
    for sub, sd, cfg in subs:
        os.makedirs(os.path.join(path, sub))
        save_file(sd, os.path.join(path, sub, "model.safetensors"))
        with open(os.path.join(path, sub, "config.json"), "w") as f:
            json.dump(cfg, f)
    write_spiece(path, pieces, unk_id=2)


# ---------------------------------------------------------------------------
# HunyuanVideo checkpoints: tokenizer.json files and state dicts in the
# reference's names, written by hand
# ---------------------------------------------------------------------------

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*"
                  r"|\s*[\r\n]+|\s+(?!\S)|\s+")
CLIP_PATTERN = r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
LLAMA3_SPECIALS = ("<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>")
CLIP_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
# Qwen2's pre-tokenizer pattern and chat specials
QWEN_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                r"|\s+(?!\S)|\s+")
QWEN_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")


def bpe_tokenizer_files(path: str, texts, style: str, vocab_size: int | None = None) -> dict:
    """Write tokenizer.json and tokenizer_config.json in LLaMA-3's structure
    (style "llama": a Split by LLaMA-3's pattern then ByteLevel, a BPE with
    ignore_merges, the template's special tokens as added tokens, a
    TemplateProcessing that prepends <|begin_of_text|>; the pad id falls
    back to <|end_of_text|>) or CLIP's ("clip": NFC, whitespace runs to " "
    and lowercase, a Split keeping CLIP's pattern, ByteLevel, a BPE with
    the </w> suffix and <|endoftext|> as unk, RobertaProcessing; pad
    <|endoftext|>, the highest id, as in CLIP) or Qwen2's ("qwen": NFC, a
    Split by Qwen2's pattern then ByteLevel, a BPE, the ChatML specials
    <|endoftext|>, <|im_start|>, <|im_end|> right after the vocabulary, as
    in Qwen2.5 (tokenizers numbers an added token that way), a ByteLevel
    post-processor; eos <|im_end|>, pad <|endoftext|>). The
    vocabulary is GPT-2's 256 byte characters (and their </w> forms) plus
    every pre-token of `texts`, each built by merges from the left, and with
    `vocab_size` filler tokens (" w<i>", no merge reaches them) up to that
    many, so that every id below it decodes. Returns {special: id}."""
    from sparse_videogen_tpu_torch.io.tokenizer import byte_to_unicode, make_normalizer, make_pre_tokenizer

    clip, qwen = style == "clip", style == "qwen"
    specials = CLIP_SPECIALS if clip else QWEN_SPECIALS if qwen else LLAMA3_SPECIALS
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": False}
    if clip:
        normalizer = {"type": "Sequence", "normalizers": [
            {"type": "NFC"}, {"type": "Replace", "pattern": {"Regex": r"\s+"}, "content": " "}, {"type": "Lowercase"}]}
        split = {"type": "Split", "pattern": {"Regex": CLIP_PATTERN}, "behavior": "Removed", "invert": True}
    else:
        normalizer = {"type": "NFC"} if qwen else None
        split = {"type": "Split", "pattern": {"Regex": QWEN_PATTERN if qwen else LLAMA3_PATTERN},
                 "behavior": "Isolated", "invert": False}
    pre = {"type": "Sequence", "pretokenizers": [split, byte_level]}
    norm, pre_tok = make_normalizer(normalizer), make_pre_tokenizer(pre)
    suffix = "</w>" if clip else ""
    alphabet = [byte_to_unicode()[b] for b in range(256)]
    vocab = {c: i for i, c in enumerate(alphabet + ([c + suffix for c in alphabet] if clip else []))}
    merges, seen = [], set()
    pieces = list(texts)
    for sp in specials:  # the special tokens are cut out before the rest is pre-tokenized
        pieces = [q for p in pieces for q in p.split(sp)]
    for text in pieces:
        for word in pre_tok([norm(text)]) if text else []:
            syms = list(word)
            syms[-1] += suffix
            cur = syms[0]
            for sym in syms[1:]:
                if (cur, sym) not in seen:
                    seen.add((cur, sym))
                    merges.append([cur, sym])
                cur += sym
                vocab.setdefault(cur, len(vocab))
    for i in range(len(vocab), vocab_size or 0):
        vocab.setdefault(f"{byte_to_unicode()[32]}w{i}", len(vocab))
    ids = {sp: len(vocab) + i for i, sp in enumerate(specials)}
    added = [{"id": ids[sp], "content": sp, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": clip, "special": True} for sp in specials]
    if qwen:
        post = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False, "use_regex": False}
        config = {"eos_token": "<|im_end|>", "pad_token": "<|endoftext|>"}
    elif clip:
        vocab.update(ids)
        post = {"type": "RobertaProcessing", "sep": ["<|endoftext|>", ids["<|endoftext|>"]],
                "cls": ["<|startoftext|>", ids["<|startoftext|>"]], "trim_offsets": False, "add_prefix_space": False}
        config = {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>", "pad_token": "<|endoftext|>"}
    else:
        bos = {"SpecialToken": {"id": "<|begin_of_text|>", "type_id": 0}}
        post = {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False, "use_regex": True},
            {"type": "TemplateProcessing", "single": [bos, {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [bos, {"Sequence": {"id": "A", "type_id": 0}}, bos, {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {"<|begin_of_text|>": {"id": "<|begin_of_text|>", "ids": [ids["<|begin_of_text|>"]],
                                                      "tokens": ["<|begin_of_text|>"]}}}]}
        config = {"bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>"}
    model = {"type": "BPE", "dropout": None, "unk_token": "<|endoftext|>" if clip else None,
             "continuing_subword_prefix": "" if clip else None, "end_of_word_suffix": suffix or None,
             "fuse_unk": False, "byte_fallback": False, "ignore_merges": style == "llama", "vocab": vocab,
             "merges": merges}
    tj = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added, "normalizer": normalizer,
          "pre_tokenizer": pre, "post_processor": post,
          "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True},
          "model": model}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(tj, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)
    return ids


def reference_llama_sd(cfg, g, prefix="model.") -> dict:
    """An HF LlamaModel state dict (all cfg.num_layers layers, the final norm)."""
    d, kv = cfg.dim, cfg.num_kv_heads * cfg.head_dim
    sd = {f"{prefix}embed_tokens.weight": 0.02 * torch.randn(cfg.vocab_size, d, generator=g),
          f"{prefix}norm.weight": torch.ones(d)}
    for i in range(cfg.num_layers):
        b = f"{prefix}layers.{i}"
        for nm, do, di in (("self_attn.q_proj", d, d), ("self_attn.k_proj", kv, d), ("self_attn.v_proj", kv, d),
                           ("self_attn.o_proj", d, d), ("mlp.gate_proj", cfg.ffn_dim, d),
                           ("mlp.up_proj", cfg.ffn_dim, d), ("mlp.down_proj", d, cfg.ffn_dim)):
            sd[f"{b}.{nm}.weight"] = _randn(g, do, di)
        sd[f"{b}.input_layernorm.weight"] = 1 + 0.1 * torch.randn(d, generator=g)
        sd[f"{b}.post_attention_layernorm.weight"] = 1 + 0.1 * torch.randn(d, generator=g)
    return sd


def reference_clip_text_sd(cfg, g) -> dict:
    """An HF CLIPTextModel state dict (text_model.*)."""
    d, t = cfg.dim, "text_model."
    sd = {f"{t}embeddings.token_embedding.weight": 0.02 * torch.randn(cfg.vocab_size, d, generator=g),
          f"{t}embeddings.position_embedding.weight": 0.01 * torch.randn(cfg.max_positions, d, generator=g),
          f"{t}final_layer_norm.weight": torch.ones(d), f"{t}final_layer_norm.bias": torch.zeros(d)}
    for i in range(cfg.num_layers):
        b = f"{t}encoder.layers.{i}"
        for nm, di, do in (("self_attn.q_proj", d, d), ("self_attn.k_proj", d, d), ("self_attn.v_proj", d, d),
                           ("self_attn.out_proj", d, d), ("mlp.fc1", d, cfg.ffn_dim), ("mlp.fc2", cfg.ffn_dim, d)):
            sd[f"{b}.{nm}.weight"], sd[f"{b}.{nm}.bias"] = _randn(g, do, di), 0.1 * torch.randn(do, generator=g)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{b}.{ln}.weight"], sd[f"{b}.{ln}.bias"] = torch.ones(d), torch.zeros(d)
    return sd


def reference_hyvideo_dit_sd(cfg, g) -> dict:
    """A HunyuanVideo DiT state dict in hyvideo_orig's names (fused q|k|v)."""
    h, sd = cfg.hidden_size, {}
    mlp = cfg.mlp_hidden

    def lin(key, di, do):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _randn(g, do, di), 0.1 * torch.randn(do, generator=g)

    def ln(key, n):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = torch.ones(n), torch.zeros(n)

    sd["img_in.proj.weight"] = _randn(g, h, cfg.in_channels, *cfg.patch_size, fan_in=cfg.in_channels * 4)
    sd["img_in.proj.bias"] = torch.zeros(h)
    for key in ("time_in", "guidance_in", "txt_in.t_embedder"):
        lin(f"{key}.mlp.0", 256, h)
        lin(f"{key}.mlp.2", h, h)
    lin("vector_in.in_layer", cfg.text_states_dim_2, h)
    lin("vector_in.out_layer", h, h)
    lin("txt_in.input_embedder", cfg.text_states_dim, h)
    lin("txt_in.c_embedder.linear_1", cfg.text_states_dim, h)
    lin("txt_in.c_embedder.linear_2", h, h)
    for i in range(cfg.refiner_depth):
        b = f"txt_in.individual_token_refiner.blocks.{i}"
        ln(f"{b}.norm1", h)
        ln(f"{b}.norm2", h)
        lin(f"{b}.self_attn_qkv", h, 3 * h)
        lin(f"{b}.self_attn_proj", h, h)
        lin(f"{b}.mlp.fc1", h, 4 * h)
        lin(f"{b}.mlp.fc2", 4 * h, h)
        lin(f"{b}.adaLN_modulation.1", h, 2 * h)
    for i in range(cfg.mm_double_blocks_depth):
        for s in ("img", "txt"):
            b = f"double_blocks.{i}.{s}"
            lin(f"{b}_mod.linear", h, 6 * h)
            lin(f"{b}_attn_qkv", h, 3 * h)
            lin(f"{b}_attn_proj", h, h)
            lin(f"{b}_mlp.fc1", h, mlp)
            lin(f"{b}_mlp.fc2", mlp, h)
            sd[f"{b}_attn_q_norm.weight"], sd[f"{b}_attn_k_norm.weight"] = torch.ones(cfg.head_dim), torch.ones(
                cfg.head_dim)
    for i in range(cfg.mm_single_blocks_depth):
        b = f"single_blocks.{i}"
        lin(f"{b}.modulation.linear", h, 3 * h)
        lin(f"{b}.linear1", h, 3 * h + mlp)
        lin(f"{b}.linear2", h + mlp, h)
        sd[f"{b}.q_norm.weight"], sd[f"{b}.k_norm.weight"] = torch.ones(cfg.head_dim), torch.ones(cfg.head_dim)
    lin("final_layer.adaLN_modulation.1", h, 2 * h)
    lin("final_layer.linear", h, cfg.out_channels * 4)
    return sd


def reference_hyvideo_vae_sd(cfg, g) -> dict:
    """An AutoencoderKLCausal3D state dict in hyvideo_orig's names."""
    sd = {}

    def conv(key, co, ci, k):
        sd[f"{key}.weight"] = _randn(g, co, ci, k, k, k, fan_in=ci * k**3)
        sd[f"{key}.bias"] = 0.01 * torch.randn(co, generator=g)

    def gn(key, c):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = 1 + 0.1 * torch.randn(c, generator=g), torch.zeros(c)

    def res(prefix, ci, co):
        gn(f"{prefix}.norm1", ci)
        conv(f"{prefix}.conv1.conv", co, ci, 3)
        gn(f"{prefix}.norm2", co)
        conv(f"{prefix}.conv2.conv", co, co, 3)
        if ci != co:
            conv(f"{prefix}.conv_shortcut.conv", co, ci, 1)

    def mid(prefix, c):
        res(f"{prefix}.resnets.0", c, c)
        gn(f"{prefix}.attentions.0.group_norm", c)
        for nm in ("to_q", "to_k", "to_v", "to_out.0"):
            sd[f"{prefix}.attentions.0.{nm}.weight"] = _randn(g, c, c)
            sd[f"{prefix}.attentions.0.{nm}.bias"] = torch.zeros(c)
        res(f"{prefix}.resnets.1", c, c)

    bo, z = cfg.block_out_channels, cfg.latent_channels
    conv("encoder.conv_in.conv", bo[0], cfg.in_channels, 3)
    ch = bo[0]
    for i in range(cfg.num_blocks):
        for j in range(cfg.layers_per_block):
            res(f"encoder.down_blocks.{i}.resnets.{j}", ch if j == 0 else bo[i], bo[i])
        if cfg.spatial_ds(i) or cfg.temporal_ds(i):
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv.conv", bo[i], bo[i], 3)
        ch = bo[i]
    mid("encoder.mid_block", bo[-1])
    gn("encoder.conv_norm_out", bo[-1])
    conv("encoder.conv_out.conv", 2 * z, bo[-1], 3)
    rev = tuple(reversed(bo))
    conv("decoder.conv_in.conv", rev[0], z, 3)
    mid("decoder.mid_block", rev[0])
    ch = rev[0]
    for i in range(cfg.num_blocks):
        for j in range(cfg.layers_per_block + 1):
            res(f"decoder.up_blocks.{i}.resnets.{j}", ch if j == 0 else rev[i], rev[i])
        if cfg.spatial_ds(i) or cfg.temporal_ds(i):
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv.conv", rev[i], rev[i], 3)
        ch = rev[i]
    gn("decoder.conv_norm_out", rev[-1])
    conv("decoder.conv_out.conv", cfg.out_channels, rev[-1], 3)
    conv("quant_conv", 2 * z, 2 * z, 1)
    conv("post_quant_conv", z, z, 1)
    return sd


# the tiny HunyuanVideo checkpoint: the JAX package's test widths (head_dim
# 64, as the card's kernels take it), a LLaMA and a CLIP text tower of its
# text widths, a Llava's vision tower for I2V (grid 2: 4 image tokens)
TINY_HY_DIT = dict(hidden_size=64, heads_num=1, mm_double_blocks_depth=1, mm_single_blocks_depth=1,
                   rope_dim_list=(16, 24, 24), text_states_dim=32, text_states_dim_2=24, text_len=12)
TINY_LLAMA = dict(dim=32, ffn_dim=48, num_layers=3, num_heads=4, num_kv_heads=2)
TINY_CLIP_TEXT = dict(dim=24, ffn_dim=48, num_layers=2, num_heads=4, max_positions=77)
TINY_LLAVA_VISION = dict(image_size=28, patch_size=14, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4, hidden_act="quick_gelu")
TINY_HY_VAE = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, latent_channels=16, norm_num_groups=4)


def write_tiny_hyvideo_checkpoint(path: str, prompt: str, i2v: bool = False) -> None:
    """A HunyuanVideo checkpoint dir as the CLIs' --model_dir reads it,
    written with the port's safetensors writer: transformer/ (TINY_HY_DIT;
    with `i2v` in_channels 33), text_encoder/ (a LLaMA in HF's names, or
    with `i2v` a Llava in HF's new-style names, its vision tower
    TINY_LLAVA_VISION), text_encoder_2/ (a CLIP text tower), vae/
    (TINY_HY_VAE), each with its config.json; the two tokenizer.json files
    (bpe_tokenizer_files) cover `prompt` and the video template."""
    from sparse_videogen_tpu_torch.io.encoders import PROMPT_TEMPLATE_ENCODE_VIDEO, clip_config_from_hf
    from sparse_videogen_tpu_torch.io.safetensors import save_file
    from sparse_videogen_tpu_torch.models.common.clip import CLIPTextConfig
    from sparse_videogen_tpu_torch.models.common.llama import LlamaConfig
    from sparse_videogen_tpu_torch.models.hyvideo.model import HyVideoConfig
    from sparse_videogen_tpu_torch.models.hyvideo.vae import HyVideoVAEConfig

    g = torch.Generator().manual_seed(7)
    texts = [PROMPT_TEMPLATE_ENCODE_VIDEO.format(prompt), "<image>\n" + prompt]
    llama_ids = bpe_tokenizer_files(os.path.join(path, "text_encoder"), texts, "llama")
    clip_ids = bpe_tokenizer_files(os.path.join(path, "text_encoder_2"), [prompt], "clip")
    llama = dict(TINY_LLAMA, vocab_size=max(llama_ids.values()) + 1)
    clip = dict(TINY_CLIP_TEXT, vocab_size=max(clip_ids.values()) + 1)
    dit = dict(TINY_HY_DIT, in_channels=33 if i2v else 16)
    lcfg = LlamaConfig(**llama)
    if i2v:
        vcfg = clip_config_from_hf({"vision_config": TINY_LLAVA_VISION})
        text_sd = {f"model.vision_tower.{k}": v for k, v in reference_clip_vision_sd(vcfg, g).items()}
        text_sd.update({f"model.language_model.{k}": v for k, v in reference_llama_sd(lcfg, g, prefix="").items()})
        for j, (di, do) in enumerate(((vcfg.dim, lcfg.dim), (lcfg.dim, lcfg.dim)), 1):
            text_sd[f"model.multi_modal_projector.linear_{j}.weight"] = _randn(g, do, di)
            text_sd[f"model.multi_modal_projector.linear_{j}.bias"] = torch.zeros(do)
        text_cfg = {"text_config": {"vocab_size": lcfg.vocab_size, "hidden_size": lcfg.dim,
                                    "intermediate_size": lcfg.ffn_dim, "num_hidden_layers": lcfg.num_layers,
                                    "num_attention_heads": lcfg.num_heads,
                                    "num_key_value_heads": lcfg.num_kv_heads},
                    "vision_config": TINY_LLAVA_VISION}
    else:
        text_sd, text_cfg = reference_llama_sd(lcfg, g), llama
    vae = dict(TINY_HY_VAE, block_out_channels=list(TINY_HY_VAE["block_out_channels"]))
    subs = [("transformer", reference_hyvideo_dit_sd(HyVideoConfig(**dit), g), dit),
            ("text_encoder", text_sd, text_cfg),
            ("text_encoder_2", reference_clip_text_sd(CLIPTextConfig(**clip), g), clip),
            ("vae", reference_hyvideo_vae_sd(HyVideoVAEConfig(**TINY_HY_VAE), g), vae)]
    for sub, sd, cfg in subs:
        os.makedirs(os.path.join(path, sub), exist_ok=True)
        save_file(sd, os.path.join(path, sub, "model.safetensors"))
        with open(os.path.join(path, sub, "config.json"), "w") as f:
            json.dump(cfg, f)


def reference_t5_hf_sd(cfg, g) -> dict:
    """An HF T5EncoderModel state dict (T5 v1.0's wi, or v1.1's wi_0 / wi_1;
    the relative bias in block 0 alone)."""
    d, da, dff = cfg.dim, cfg.dim_attn, cfg.dim_ffn
    sd = {"shared.weight": _randn(g, cfg.vocab_size, d, fan_in=1), "encoder.final_layer_norm.weight": 1 + 0.1 * _randn(
        g, d, fan_in=1)}
    for i in range(cfg.num_layers):
        b = f"encoder.block.{i}.layer"
        for nm in "qkv":
            sd[f"{b}.0.SelfAttention.{nm}.weight"] = _randn(g, da, d)
        sd[f"{b}.0.SelfAttention.o.weight"] = _randn(g, d, da)
        for j in range(2):
            sd[f"{b}.{j}.layer_norm.weight"] = 1 + 0.1 * _randn(g, d, fan_in=1)
        ff = f"{b}.1.DenseReluDense"
        for nm in (("wi_0", "wi_1") if cfg.gated_ffn else ("wi",)):
            sd[f"{ff}.{nm}.weight"] = _randn(g, dff, d)
        sd[f"{ff}.wo.weight"] = _randn(g, d, dff)
    sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = _randn(
        g, cfg.num_buckets, cfg.num_heads, fan_in=1)
    return sd


def t5_hf_config(cfg) -> dict:
    """cfg in HF's T5Config names."""
    return {"model_type": "t5", "d_model": cfg.dim, "d_kv": cfg.dim_attn // cfg.num_heads, "num_heads": cfg.num_heads,
            "d_ff": cfg.dim_ffn, "num_layers": cfg.num_layers, "vocab_size": cfg.vocab_size,
            "relative_attention_num_buckets": cfg.num_buckets, "relative_attention_max_distance": cfg.max_dist,
            "layer_norm_epsilon": cfg.eps, "feed_forward_proj": "gated-gelu" if cfg.gated_ffn else "relu"}


def reference_cog_dit_sd(cfg, g) -> dict:
    """A diffusers CogVideoXTransformer3DModel state dict (v1.5: a Linear
    patch_embed.proj)."""
    sd, h, ted = {}, cfg.hidden_size, cfg.time_embed_dim

    def lin(key, di, do):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _randn(g, do, di), 0.02 * _randn(g, do, fan_in=1)

    def ln(key, d):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = 1 + 0.1 * _randn(g, d, fan_in=1), 0.1 * _randn(g, d, fan_in=1)

    lin("time_embedding.linear_1", h, ted)
    lin("time_embedding.linear_2", ted, ted)
    if cfg.ofs_embed:
        lin("ofs_embedding.linear_1", ted, ted)
        lin("ofs_embedding.linear_2", ted, ted)
    lin("patch_embed.proj", cfg.in_channels * cfg.patch_size_t * cfg.patch_size ** 2, h)
    lin("patch_embed.text_proj", cfg.text_dim, h)
    for i in range(cfg.num_layers):
        b = f"transformer_blocks.{i}"
        for n in ("norm1", "norm2"):
            lin(f"{b}.{n}.linear", ted, 6 * h)
            ln(f"{b}.{n}.norm", h)
        for nm in ("to_q", "to_k", "to_v", "to_out.0"):
            lin(f"{b}.attn1.{nm}", h, h)
        ln(f"{b}.attn1.norm_q", cfg.head_dim)
        ln(f"{b}.attn1.norm_k", cfg.head_dim)
        lin(f"{b}.ff.net.0.proj", h, cfg.ffn_mult * h)
        lin(f"{b}.ff.net.2", cfg.ffn_mult * h, h)
    ln("norm_final", h)
    ln("norm_out.norm", h)
    lin("norm_out.linear", ted, 2 * h)
    lin("proj_out", h, cfg.patch_size_t * cfg.patch_size ** 2 * cfg.out_channels)
    return sd


def reference_cog_vae_sd(cfg, g) -> dict:
    """A diffusers AutoencoderKLCogVideoX state dict."""
    sd, z = {}, cfg.latent_channels

    def c3(key, co, ci, k=3):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _randn(g, co, ci, k, k, k, fan_in=ci * k ** 3), torch.zeros(co)

    def c2(key, c):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _randn(g, c, c, 3, 3, fan_in=9 * c), torch.zeros(c)

    def gn(key, c):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = 1 + 0.1 * _randn(g, c, fan_in=1), 0.1 * _randn(g, c, fan_in=1)

    def sn(key, c):
        gn(f"{key}.norm_layer", c)
        c3(f"{key}.conv_y.conv", c, z, 1)
        c3(f"{key}.conv_b.conv", c, z, 1)

    def res(prefix, ci, co, spatial):
        norm = sn if spatial else gn
        norm(f"{prefix}.norm1", ci)
        c3(f"{prefix}.conv1.conv", co, ci)
        norm(f"{prefix}.norm2", co)
        c3(f"{prefix}.conv2.conv", co, co)
        if ci != co:
            c3(f"{prefix}.conv_shortcut", co, ci, 1)

    bo, rev = cfg.block_out_channels, tuple(reversed(cfg.block_out_channels))
    c3("encoder.conv_in.conv", bo[0], cfg.in_channels)
    ch = bo[0]
    for i in range(cfg.num_blocks):
        for j in range(cfg.layers_per_block):
            res(f"encoder.down_blocks.{i}.resnets.{j}", ch if j == 0 else bo[i], bo[i], False)
        ch = bo[i]
        if cfg.resample_spatial(i):
            c2(f"encoder.down_blocks.{i}.downsamplers.0.conv", bo[i])
    for j in range(2):
        res(f"encoder.mid_block.resnets.{j}", bo[-1], bo[-1], False)
    gn("encoder.norm_out", bo[-1])
    c3("encoder.conv_out.conv", 2 * z, bo[-1])
    c3("decoder.conv_in.conv", rev[0], z)
    for j in range(2):
        res(f"decoder.mid_block.resnets.{j}", rev[0], rev[0], True)
    ch = rev[0]
    for i in range(cfg.num_blocks):
        for j in range(cfg.layers_per_block + 1):
            res(f"decoder.up_blocks.{i}.resnets.{j}", ch if j == 0 else rev[i], rev[i], True)
        ch = rev[i]
        if cfg.resample_spatial(i):
            c2(f"decoder.up_blocks.{i}.upsamplers.0.conv", rev[i])
    sn("decoder.norm_out", rev[-1])
    c3("decoder.conv_out.conv", cfg.out_channels, rev[-1])
    return sd


def reference_cosmos_dit_sd(cfg, g) -> dict:
    """A diffusers CosmosTransformer3DModel state dict."""
    sd, h, r = {}, cfg.hidden_size, cfg.adaln_lora_dim

    def lin(key, di, do, bias=False):
        sd[f"{key}.weight"] = _randn(g, do, di)
        if bias:
            sd[f"{key}.bias"] = 0.02 * _randn(g, do, fan_in=1)

    mlp = int(h * cfg.mlp_ratio)
    lin("patch_embed.proj", cfg.patch_in_channels * int(np.prod(cfg.patch_size)), h)
    lin("time_embed.t_embedder.linear_1", h, h)
    lin("time_embed.t_embedder.linear_2", h, 3 * h)
    sd["time_embed.norm.weight"] = 1 + 0.1 * _randn(g, h, fan_in=1)
    for i in range(cfg.num_layers):
        b = f"transformer_blocks.{i}"
        for n in ("norm1", "norm2", "norm3"):
            lin(f"{b}.{n}.linear_1", h, r)
            lin(f"{b}.{n}.linear_2", r, 3 * h)
        for a, kv in (("attn1", h), ("attn2", cfg.text_embed_dim)):
            lin(f"{b}.{a}.to_q", h, h)
            lin(f"{b}.{a}.to_k", kv, h)
            lin(f"{b}.{a}.to_v", kv, h)
            lin(f"{b}.{a}.to_out.0", h, h)
            for nm in ("norm_q", "norm_k"):
                sd[f"{b}.{a}.{nm}.weight"] = 1 + 0.1 * _randn(g, cfg.attention_head_dim, fan_in=1)
        lin(f"{b}.ff.net.0.proj", h, mlp)
        lin(f"{b}.ff.net.2", mlp, h)
    lin("norm_out.linear_1", h, r)
    lin("norm_out.linear_2", r, 2 * h)
    lin("proj_out", h, int(np.prod(cfg.patch_size)) * cfg.out_channels, bias=True)
    for ax, n, p in zip("thw", cfg.max_size, cfg.patch_size):
        sd[f"learnable_pos_embed.pos_emb_{ax}"] = 0.02 * _randn(g, n // p, h, fan_in=1)
    return sd


def reference_cosmos_vae_sd(cfg, g) -> dict:
    """A Cosmos tokenizer (CV8x8x8) state dict in Cosmos-Tokenizer's names (a
    CausalConv3d's conv as `.conv3d`; attention projections 1x1x1 convs)."""
    sd = {}

    def conv(key, ci, co, k=3):
        sd[f"{key}.conv3d.weight"] = _randn(g, co, ci, k, k, k, fan_in=ci * k ** 3)
        sd[f"{key}.conv3d.bias"] = torch.zeros(co)

    def norm(key, c):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = 1 + 0.1 * _randn(g, c, fan_in=1), 0.1 * _randn(g, c, fan_in=1)

    def res(key, ci, co):
        norm(f"{key}.norm1", ci)
        conv(f"{key}.conv1", ci, co)
        norm(f"{key}.norm2", co)
        conv(f"{key}.conv2", co, co)
        if ci != co:
            conv(f"{key}.nin_shortcut", ci, co, 1)

    def attn(key, c):
        norm(f"{key}.norm", c)
        for nm in ("q", "k", "v", "proj_out"):
            sd[f"{key}.{nm}.weight"], sd[f"{key}.{nm}.bias"] = _randn(g, c, c, 1, 1, 1, fan_in=c), torch.zeros(c)

    chans = [cfg.base_channels] + [cfg.base_channels * m for m in cfg.channels_mult]
    cz = chans[-1]
    conv("encoder.conv_in", cfg.patch_channels, cfg.base_channels)
    ci = cfg.base_channels
    for i, co in enumerate(chans[1:]):
        for j in range(cfg.num_res_blocks):
            res(f"encoder.down.{i}.block.{j}", ci, co)
            ci = co
        if cfg.downsample(i):
            conv(f"encoder.down.{i}.downsample", co, co)
    for side in ("encoder", "decoder"):
        res(f"{side}.mid.block_1", cz, cz)
        attn(f"{side}.mid.attn_1", cz)
        attn(f"{side}.mid.attn_2", cz)
        res(f"{side}.mid.block_2", cz, cz)
    norm("encoder.norm_out", cz)
    conv("encoder.conv_out", cz, cfg.latent_channels)
    conv("decoder.conv_in", cfg.latent_channels, cz)
    ci = cz
    for i in reversed(range(len(cfg.channels_mult))):
        co = chans[i + 1]
        for j in range(cfg.num_res_blocks + 1):
            res(f"decoder.up.{i}.block.{j}", ci, co)
            ci = co
        if cfg.downsample(i):
            conv(f"decoder.up.{i}.upsample", co, co)
    norm("decoder.norm_out", chans[1])
    conv("decoder.conv_out", chans[1], cfg.patch_channels)
    return sd


# the tiny CogVideoX and Cosmos checkpoints: the CLIs' smoke widths (head_dim
# 64, as the kernels take it), T5 encoders of 2 layers
TINY_COG_T5 = dict(dim=32, dim_attn=32, dim_ffn=48, num_heads=2, num_layers=2, num_buckets=8, max_dist=16,
                   gated_ffn=True, shared_rel_bias=True, ffn_act="gelu_tanh")
TINY_COSMOS_T5 = dict(dim=64, dim_attn=64, dim_ffn=96, num_heads=2, num_layers=2, num_buckets=8, max_dist=16,
                      gated_ffn=False, shared_rel_bias=True, ffn_act="relu")


def _write_subdirs(path, subs):
    from sparse_videogen_tpu_torch.io.safetensors import save_file

    for sub, sd, cfg in subs:
        os.makedirs(os.path.join(path, sub), exist_ok=True)
        save_file(sd, os.path.join(path, sub, "model.safetensors"))
        with open(os.path.join(path, sub, "config.json"), "w") as f:
            json.dump(cfg, f)


def _t5_sub(cfg_kw, texts, g, t5_names):
    """(pieces, the text_encoder/ entry): T5 in HF's names, its config.json in
    HF's names (t5_names "hf") or the package's ("package")."""
    from sparse_videogen_tpu_torch.models.common.t5 import T5Config

    pieces = synthetic_vocab(texts)
    cfg = T5Config(vocab_size=len(pieces), **cfg_kw)
    js = t5_hf_config(cfg) if t5_names == "hf" else dataclasses.asdict(cfg)
    return pieces, ("text_encoder", reference_t5_hf_sd(cfg, g), js)


def write_tiny_cog_checkpoint(path: str, prompt: str, t5_names: str = "hf") -> None:
    """A CogVideoX 1.5 I2V checkpoint dir as cli/cog_i2v.py --model_dir reads
    it, in the reference's names: transformer/ (the CLI's smoke widths, the
    ofs embedding, diffusers' config.json), text_encoder/ (a 2-layer T5 v1.1,
    gated GELU, d_model 32), vae/ (the smoke VAE's widths, diffusers'
    config.json, invert_scale_latents), spiece.model covering `prompt`."""
    from sparse_videogen_tpu_torch.cli.cog_i2v import SMOKE_CFG, SMOKE_VAE_CFG
    from sparse_videogen_tpu_torch.models.cog.model import CogConfig
    from sparse_videogen_tpu_torch.models.cog.vae import CogVAEConfig

    g = torch.Generator().manual_seed(9)
    dit = CogConfig(**dict(SMOKE_CFG, time_embed_dim=64, text_dim=TINY_COG_T5["dim"]), ofs_embed=True)
    dit_js = {"num_attention_heads": dit.heads_num, "attention_head_dim": dit.head_dim, "num_layers": dit.num_layers,
              "max_text_seq_length": dit.text_len, "text_embed_dim": dit.text_dim, "in_channels": dit.in_channels,
              "out_channels": dit.out_channels, "patch_size": dit.patch_size, "patch_size_t": dit.patch_size_t,
              "time_embed_dim": dit.time_embed_dim, "ofs_embed_dim": dit.time_embed_dim}
    vae = CogVAEConfig(**SMOKE_VAE_CFG)
    vae_js = dict(SMOKE_VAE_CFG, block_out_channels=list(vae.block_out_channels), latent_channels=16,
                  scaling_factor=0.7, invert_scale_latents=True)
    pieces, t5 = _t5_sub(TINY_COG_T5, [prompt], g, t5_names)
    _write_subdirs(path, [("transformer", reference_cog_dit_sd(dit, g), dit_js), t5,
                          ("vae", reference_cog_vae_sd(vae, g), vae_js)])
    write_spiece(path, pieces, unk_id=2)


def write_tiny_cosmos_checkpoint(path: str, prompt: str, t5_names: str = "hf") -> None:
    """A Cosmos Text2World checkpoint dir as cli/cosmos_t2v.py --model_dir
    reads it: transformer/ (the CLI's smoke widths, the package's
    config.json names as the JAX CLI reads them; diffusers' weight names),
    text_encoder/ (a 2-layer T5 v1.0, ReLU, d_model 64), vae/ (the smoke
    tokenizer's widths, Cosmos-Tokenizer's names), spiece.model covering
    `prompt`."""
    from sparse_videogen_tpu_torch.cli.cosmos_t2v import SMOKE_CFG, SMOKE_VAE_CFG
    from sparse_videogen_tpu_torch.models.cosmos.model import CosmosConfig
    from sparse_videogen_tpu_torch.models.cosmos.vae import CosmosVAEConfig

    g = torch.Generator().manual_seed(10)
    dit = CosmosConfig(**SMOKE_CFG)
    vae = CosmosVAEConfig(**SMOKE_VAE_CFG)
    pieces, t5 = _t5_sub(TINY_COSMOS_T5, [prompt], g, t5_names)
    _write_subdirs(path, [("transformer", reference_cosmos_dit_sd(dit, g), dict(SMOKE_CFG, max_size=list(
        dit.max_size))), t5, ("vae", reference_cosmos_vae_sd(vae, g), dict(SMOKE_VAE_CFG, channels_mult=list(
        vae.channels_mult)))])
    write_spiece(path, pieces, unk_id=2)


def _timed(stages: dict, name: str, fn):
    """fn() between two CUDA events, the peak device memory reset before it;
    records (ms, peak GiB) under `name` and returns fn's result."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    stages[name] = (start.elapsed_time(end), torch.cuda.max_memory_allocated() / 2**30)
    return out


def meta_flops(fn) -> float:
    """The FLOPs of the convolutions and matmuls fn() issues
    (torch.utils.flop_counter), fn built on the meta device: no memory, no
    compute."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _steps(model, run, ctx, ctx_null, pattern, steps, callback=None, **extra):
    """WanPipeline.generate_latents of `run` (a preset; `extra`: I2V's
    clip_fea and latent_cond) with per-step CUDA events; returns (latents,
    [s a step]: the first includes the set-up)."""
    from sparse_videogen_tpu_torch.pipelines import WanPipeline

    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()

    def on_step(i, lat):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    lat = WanPipeline(model).generate_latents(ctx, ctx_null, num_inference_steps=steps, pattern=pattern, seed=0,
                                              callback=on_step, **run.generate_kwargs(), **extra)
    torch.cuda.synchronize()
    return lat, [events[i].elapsed_time(events[i + 1]) / 1e3 for i in range(steps)]


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def export_mp4(video, path: str) -> dict:
    """export_video(video, path) to an .mp4 on this host with PIL blocked
    (the JPEGs encoded on the video's device); returns the file's bytes,
    the encoder's seconds by stage and the whole export's seconds."""
    from sparse_videogen_tpu_torch.pipelines.wan import export_video

    stages = {}
    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if k == "PIL" or k.startswith("PIL.")}
    sys.modules["PIL"] = None  # an import of PIL now raises ImportError
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export_video(video, path, fps=16, stages=stages)
        total = time.perf_counter() - t0
    finally:
        del sys.modules["PIL"]
        sys.modules.update(saved)
    with open(path, "rb") as f:
        data = f.read()
    stages["container and file"] = total - sum(stages.values())
    return {"bytes": data, "stages": stages, "seconds": total}


def check_mp4(card: dict, frames_u8: np.ndarray, y4m_frames: np.ndarray, shape: tuple, fps: int) -> None:
    """The card's .mp4 (export_mp4's result) against the same uint8 frames
    encoded on the CPU (sha256 equal), then read back by read_mp4_mjpeg
    (io/image.decode_jpeg) in MP4_READ_WORKERS processes: the frames' shape
    and fps, and their PSNR against the uint8 frames (MP4_MIN_PSNR) and
    against the .y4m frames."""
    import hashlib
    import importlib.util

    from sparse_videogen_tpu_torch.io.mp4 import read_mp4_mjpeg, write_mp4

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path, cpu_path = os.path.join(tmp, "p2v.mp4"), os.path.join(tmp, "p2v_cpu.mp4")
        with open(path, "wb") as f:
            f.write(card["bytes"])
        cpu_stages = {}
        t0 = time.perf_counter()
        write_mp4(cpu_path, torch.from_numpy(frames_u8), fps=fps, stages=cpu_stages)
        cpu_s = time.perf_counter() - t0
        with open(cpu_path, "rb") as f:
            sha_card, sha_cpu = hashlib.sha256(card["bytes"]).hexdigest(), hashlib.sha256(f.read()).hexdigest()
        t0 = time.perf_counter()
        back, back_fps = read_mp4_mjpeg(path, workers=MP4_READ_WORKERS)
        read_s = time.perf_counter() - t0
    to_u8, to_y4m, y4m_u8 = psnr_u8(back, frames_u8), psnr_u8(back, y4m_frames), psnr_u8(y4m_frames, frames_u8)
    fmt = lambda st: ", ".join(f"{k} {v:.3f} s" for k, v in st.items())  # noqa: E731
    log("p2v", f".mp4 (PIL blocked; installed on this host: {importlib.util.find_spec('PIL') is not None}): "
               f"{len(card['bytes'])} bytes; encoded on the card in {card['seconds']:.3f} s ({fmt(card['stages'])}); "
               f"on the CPU in {cpu_s:.3f} s ({fmt(cpu_stages)}); sha256 card {sha_card} cpu {sha_cpu}; "
               f"read back in {read_s:.3f} s ({MP4_READ_WORKERS} processes): frames {back.shape} at {back_fps} fps, "
               f"PSNR {to_u8:.3f} dB against the uint8 frames (gate {MP4_MIN_PSNR}), {to_y4m:.3f} dB against the "
               f".y4m frames (the .y4m's own against the uint8 frames: {y4m_u8:.3f} dB)")
    if sha_card != sha_cpu:
        raise AssertionError("the .mp4 encoded on the card differs from the CPU's encode of the same frames")
    if back.shape != shape or back_fps != fps:
        raise AssertionError(f"the .mp4 read back: frames {back.shape} at {back_fps} fps, expected {shape} at {fps}")
    if not to_u8 >= MP4_MIN_PSNR:
        raise AssertionError(f"the .mp4's frames are {to_u8:.3f} dB from the uint8 frames (gate {MP4_MIN_PSNR})")


def phase_prompt_to_video(dev):
    """Wan 2.1 T2V from a prompt to a video at full width: the port's
    tokenizer on a synthetic spiece.model (this script's protobuf writer);
    UMT5-XXL (UMT5_XXL: 24 layers, dim 4096, 64 heads, FFN 10,240; random
    bf16 weights from a seed) through io/encoders.UMT5Encoder on the prompt
    and the negative prompt at text_len 512, then freed; Wan 2.1 1.3B
    (presets.T2V_480P, random weights) for P2V_STEPS UniPC steps of SVG1 at
    480x832x81; the Wan VAE (WanVAEConfig(): dim 96, f32, random) through
    the CLI's default decoder (--vae_tiling auto: 12 tiles of 32x32 latents,
    overlap 8); export_video to a .y4m, read back, and to an .mp4 (the
    JPEGs encoded on the card; the returned check_mp4 call holds it to the
    CPU's encode and reads it back, main runs it in a thread). Each stage
    is timed with
    CUDA events beside its peak memory. The kernel counters are set to 0
    before the tokenizer and read after the writer: K1 and the fused norms launch as the
    configuration implies, no plain version runs, and the frames are (81,
    480, 832, 3). Then the decode alone in each mode (whole, streamed by 1
    and 2 latent frames, tiled; a mode that does not fit in the card's
    memory is reported as such), the tiled decode with cuDNN's TF32 on (the
    CLI leaves torch's default, on), and P2V_STEPS dense steps, for the
    projection of a whole generation to the CLI's CLI_STEPS steps."""
    import logging

    from sparse_videogen_tpu_torch import _kernels
    from sparse_videogen_tpu_torch.cli._common import make_vae_decoder
    from sparse_videogen_tpu_torch.cli.wan_t2v import DEFAULT_NEG_PROMPT, build_parser
    from sparse_videogen_tpu_torch.config import WarmupSchedule
    from sparse_videogen_tpu_torch.io.encoders import UMT5Encoder
    from sparse_videogen_tpu_torch.io.native import read_y4m
    from sparse_videogen_tpu_torch.io.tokenizer import T5TokenizerLite
    from sparse_videogen_tpu_torch.models.common.t5 import UMT5_XXL, T5Encoder
    from sparse_videogen_tpu_torch.models.wan.vae import WanVAE, WanVAEConfig, decoder_forward
    from sparse_videogen_tpu_torch.pipelines.wan import export_video, video_uint8, wan_layout
    from sparse_videogen_tpu_torch.presets import T2V_480P
    from sparse_videogen_tpu_torch.schedulers import FlowUniPC

    run, cfg, stages = T2V_480P, T2V_480P.model, {}
    args = build_parser().parse_args([])  # the CLI's defaults: prompt, VAE tiling auto, tile 32, overlap 8
    lay = wan_layout(cfg, run.height, run.width, run.num_frames)
    timesteps = FlowUniPC(P2V_STEPS, shift=run.flow_shift).timesteps
    kw = run.generate_kwargs()
    warmup = WarmupSchedule.from_fractions(kw["first_layers_fp"], kw["first_times_fp"], cfg.num_layers, timesteps)
    want, want_kinds = expected_launches("SVG", cfg.num_layers, warmup, timesteps, ("none", "band_sink"),
                                         **model_sites(cfg))
    log("p2v", f"cuDNN TF32 {torch.backends.cudnn.allow_tf32}, matmul TF32 {torch.backends.cuda.matmul.allow_tf32} "
               "(this script turns both off; the VAE and UMT5 run true f32)")
    _kernels.reset_counts()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        t0 = time.perf_counter()
        write_spiece(tmp, synthetic_vocab([args.prompt, DEFAULT_NEG_PROMPT]), unk_id=2)
        tok = T5TokenizerLite.from_dir(tmp)
        ids, mask = tok([args.prompt, DEFAULT_NEG_PROMPT], seq_len=cfg.text_len)
        log("p2v", f"tokenizer: {len(tok.model.vocab)} pieces, prompt {int(mask[0].sum())} and negative prompt "
                   f"{int(mask[1].sum())} of {cfg.text_len} tokens, unk {int((ids == 2).sum())}, "
                   f"{time.perf_counter() - t0:.3f} s on the host")
        if (ids == 2).any() or ids[0, int(mask[0].sum()) - 1] != tok.eos_id:
            raise AssertionError("tokenizer: an unknown piece or no </s> at the end of the prompt")
        t5 = _timed(stages, "umt5 set-up", lambda: T5Encoder(UMT5_XXL, dtype=torch.bfloat16, device=dev).init_random(
            torch.Generator(device=dev).manual_seed(0)))
        enc = UMT5Encoder(t5, tok, text_len=cfg.text_len)
        ctx = _timed(stages, "umt5 encode prompt", lambda: enc([args.prompt])).to(torch.bfloat16)
        ctx_null = _timed(stages, "umt5 encode negative prompt", lambda: enc([DEFAULT_NEG_PROMPT])).to(torch.bfloat16)
        n_t5 = sum(p.numel() for p in t5.parameters())
        live = int(mask[0].sum())
        log("p2v", f"UMT5-XXL {n_t5 / 1e9:.3f} B params bf16 ({n_t5 * 2 / 2**30:.2f} GiB): states "
                   f"{tuple(ctx.shape)}, finite {bool(torch.isfinite(ctx).all())}, rows past the prompt zero "
                   f"{bool((ctx[0, live:] == 0).all())}, std {ctx[0, :live].float().std().item():.4f}")
        if tuple(ctx.shape) != (1, cfg.text_len, cfg.text_dim) or not torch.isfinite(ctx).all() or \
                not (ctx[0, live:] == 0).all():
            raise AssertionError("UMT5: text states of the wrong shape, not finite, or not zero past the prompt")
        del enc, t5
        torch.cuda.empty_cache()

        model = _new_model(cfg, dev)
        lat, svg_steps = _timed(stages, f"DiT {P2V_STEPS} steps SVG1",
                                lambda: _steps(model, run, ctx, ctx_null, "SVG", P2V_STEPS))
        vae = WanVAE(WanVAEConfig(), device=dev).init_random(torch.Generator(device=dev).manual_seed(0))
        decode = make_vae_decoder(args, vae, logging.getLogger("chip_smoke"))
        video = _timed(stages, "VAE decode (CLI default: tiled)", lambda: decode(lat))
        path = os.path.join(tmp, "p2v.y4m")
        t0 = time.perf_counter()
        export_video(video, path, fps=16)
        frames, fps = read_y4m(path)
        export_s = time.perf_counter() - t0
        mp4 = export_mp4(video, os.path.join(tmp, "p2v.mp4"))
    torch.cuda.synchronize()
    launches, kinds, plain = dict(_kernels.LAUNCHES), dict(_kernels.KIND_LAUNCHES), dict(_kernels.PLAIN_CALLS)
    for name, (ms, gib) in stages.items():
        log("p2v", f"{name}: {ms:.1f} ms, peak {gib:.2f} GiB")
    log("p2v", f"SVG1 s a step {[round(s, 4) for s in svg_steps]} (the first includes the set-up); export + read "
               f"back {export_s:.2f} s on the host; frames {frames.shape} at {fps} fps, mean {frames.mean():.2f}")
    log("p2v", f"launches {launches} (expected {want}), by mask kind {kinds} (expected {dict(want_kinds)}), "
               f"plain-version calls {plain}")
    if launches != want or collections.Counter(kinds) != want_kinds or any(plain.values()):
        raise AssertionError("prompt -> video: the kernels did not launch as the configuration implies, or a plain "
                             "version ran")
    if frames.shape != (run.num_frames, run.height, run.width, 3) or tuple(video.shape) != (
            1, 3, run.num_frames, run.height, run.width):
        raise AssertionError(f"prompt -> video: video {tuple(video.shape)}, frames {frames.shape}")
    # the .mp4's CPU encode and read-back wait for main to run them beside later phases
    check = functools.partial(check_mp4, mp4, video_uint8(video).cpu().numpy(), frames, frames.shape, 16)

    # the decode alone, in each mode, on the first DECODE_MODE_FRAMES latent
    # frames (the pre-clip output checked in the whole decode); whole and
    # streamed are the same function up to summation order, and the decoder
    # is causal in time, so the tiled video's first frames are comparable
    part = lat[:, :, :DECODE_MODE_FRAMES]
    n_pix = 1 + (part.shape[2] - 1) * 4
    modes = {"whole": lambda: decoder_forward(vae.decoder, vae.latent_input(part)),
             "streamed, chunk 1": lambda: vae.decode_streamed(part, chunk=1),
             "streamed, chunk 2": lambda: vae.decode_streamed(part, chunk=2)}
    decoded = {}
    for name, fn in modes.items():
        try:
            out = _timed(stages, f"VAE decode {name}", fn)
        except torch.cuda.OutOfMemoryError as e:
            torch.cuda.empty_cache()
            log("p2v", f"VAE decode {name}: does not fit in the card's memory ({str(e).splitlines()[0]})")
            continue
        if name == "whole":
            finite = bool(torch.isfinite(out).all())
            log("p2v", f"VAE decoder output before the clip: finite {finite}, |max| {out.abs().max().item():.3f}")
            if not finite:
                raise AssertionError("the VAE decoder's output is not finite")
            out = out.clamp_(-1.0, 1.0)
        decoded[name] = out
        ms, gib = stages[f"VAE decode {name}"]
        log("p2v", f"VAE decode {name} ({part.shape[2]} of {lat.shape[2]} latent frames): {ms / 1e3:.3f} s, peak "
                   f"{gib:.2f} GiB")
    ref_name = next(iter(decoded))
    for name, out in decoded.items():
        if name == ref_name:
            continue
        rel = ((out - decoded[ref_name]).norm() / decoded[ref_name].norm()).item()
        log("p2v", f"VAE decode {name} against {ref_name}: rel L2 {rel:.3e} (tol {VAE_TOL})")
        if not rel <= VAE_TOL:
            raise AssertionError(f"the VAE decode {name} disagrees with {ref_name}: {rel}")
    rel = ((video[:, :, :n_pix] - decoded[ref_name]).norm() / decoded[ref_name].norm()).item()
    log("p2v", f"VAE decode tiled (the main path), its first {n_pix} frames, against {ref_name}: rel L2 {rel:.3e} "
               "(tiles see zeros past their borders; the blend hides the seams, it does not remove the difference)")
    del decoded, out
    torch.backends.cudnn.allow_tf32 = True
    _timed(stages, "VAE decode tiled, cuDNN TF32 on", lambda: decode(lat))
    torch.backends.cudnn.allow_tf32 = False
    ms, gib = stages["VAE decode tiled, cuDNN TF32 on"]
    log("p2v", f"VAE decode tiled with cuDNN TF32 on (the CLI's default): {ms / 1e3:.3f} s, peak {gib:.2f} GiB")

    # the stages' operations (counted on the meta device) against their time
    # and the card's peak for the type they run in
    meta_vae = WanVAE(WanVAEConfig(), device="meta")
    meta_lat = torch.empty(tuple(lat.shape), device="meta")
    meta_part = torch.empty(tuple(part.shape), device="meta")
    flops = {"whole": meta_flops(lambda: decoder_forward(meta_vae.decoder, meta_vae.latent_input(meta_part))),
             "tiled": meta_flops(lambda: make_vae_decoder(args, meta_vae, logging.getLogger("chip_smoke"))(meta_lat)),
             "umt5": meta_flops(lambda: T5Encoder(UMT5_XXL, device="meta")(ids[:1], mask[:1]))}
    for stage, key, peak, peak_name in (
            ("umt5 encode prompt", "umt5", PEAK_F32_FLOPS, "f32"),
            ("VAE decode whole", "whole", PEAK_F32_FLOPS, "f32"),
            ("VAE decode streamed, chunk 1", "whole", PEAK_F32_FLOPS, "f32"),
            ("VAE decode (CLI default: tiled)", "tiled", PEAK_F32_FLOPS, "f32"),
            ("VAE decode tiled, cuDNN TF32 on", "tiled", PEAK_TF32_FLOPS, "TF32")):
        if stage in stages:
            ms = stages[stage][0]
            log("p2v", f"{stage}: {flops[key] / 1e12:.2f} TFLOP, {flops[key] / ms / 1e9:.1f} TFLOP/s, "
                       f"{flops[key] / peak * 1e3 / ms:.3f} of the {peak_name} peak (bound "
                       f"{flops[key] / peak * 1e3:.1f} ms, operations)")

    _, dense_steps = _steps(model, run, ctx, ctx_null, "dense", P2V_STEPS)
    log("p2v", f"dense s a step {[round(s, 4) for s in dense_steps]}")
    encode_s = (stages["umt5 encode prompt"][0] + stages["umt5 encode negative prompt"][0]) / 1e3
    warm50 = WarmupSchedule.from_fractions(kw["first_layers_fp"], kw["first_times_fp"], cfg.num_layers,
                                           FlowUniPC(CLI_STEPS, shift=run.flow_shift).timesteps)
    n_dense = sum(float(t) > warm50.first_times for t in FlowUniPC(CLI_STEPS, shift=run.flow_shift).timesteps)
    for dec_name in ("VAE decode (CLI default: tiled)", "VAE decode tiled, cuDNN TF32 on"):
        dec_s = stages[dec_name][0] / 1e3
        svg_total = encode_s + n_dense * dense_steps[-1] + (CLI_STEPS - n_dense) * svg_steps[-1] + dec_s
        dense_total = encode_s + CLI_STEPS * dense_steps[-1] + dec_s
        log("p2v", f"projected {CLI_STEPS}-step generation at 480x832x81 ({dec_name}): SVG1 {svg_total:.2f} s "
                   f"(encode {encode_s:.3f} + {n_dense} dense warm-up steps x {dense_steps[-1]:.4f} + "
                   f"{CLI_STEPS - n_dense} x {svg_steps[-1]:.4f} + decode {dec_s:.3f}), dense {dense_total:.2f} s")
    del model, vae, video, lat
    torch.cuda.empty_cache()
    return encode_s, check


def phase_i2v(dev, umt5_s: float):
    """Wan 2.1 I2V from an image to a video at the 14B width
    (presets.I2V_PRESETS["14B-i2v-480p-svg"]: dim 5120, 40 heads of 128, FFN
    13,824, in_dim 36, image_dim 1280; LAYERS_I2V of its 40 layers, random
    bf16 weights from a seed) at 480x832x81 (S = 21 x 1,560 = 32,760):
    examples/1/image.jpg decoded by io/image.py on the host and fitted to
    480p; CLIP ViT-H/14 at its full 32 layers (f32, random) through
    io/encoders.CLIPImageEncoder (the cubic resize to 224, the penultimate
    states); random text states of UMT5-XXL's shape; the Wan VAE (dim 96,
    f32, random) encodes [image, zeros...] whole and streamed (held to each
    other, VAE_TOL); build_i2v_condition; I2V_STEPS SVG1 steps (layer 0 the
    dense warm-up, first_layers_fp 0.3) through WanPipeline.generate_latents,
    K1 by mask kind and the fused norms held to expected_launches with no plain-version
    call (the counters set to 0 before the image is read and read after the
    writer); the CLI's default decode (tiled) and the .y4m read back. Each
    stage timed with CUDA events beside its peak memory; then dense steps,
    and the projection of a CLI_STEPS-step generation at 40 layers (UMT5's
    seconds `umt5_s` from phase p2v)."""
    import dataclasses
    import logging

    from sparse_videogen_tpu_torch import _kernels
    from sparse_videogen_tpu_torch.cli._common import make_vae_decoder
    from sparse_videogen_tpu_torch.cli.wan_i2v import _fit_resolution, build_parser, encode_mode
    from sparse_videogen_tpu_torch.config import WarmupSchedule
    from sparse_videogen_tpu_torch.io.encoders import CLIPImageEncoder
    from sparse_videogen_tpu_torch.io.image import load_image
    from sparse_videogen_tpu_torch.io.native import read_y4m
    from sparse_videogen_tpu_torch.models.common.clip import CLIP_VIT_H_14, CLIPVisionModel
    from sparse_videogen_tpu_torch.models.common.resize import resize_cubic
    from sparse_videogen_tpu_torch.models.wan.vae import WanVAE, WanVAEConfig
    from sparse_videogen_tpu_torch.pipelines.wan import build_i2v_condition, export_video, wan_layout
    from sparse_videogen_tpu_torch.presets import I2V_PRESETS
    from sparse_videogen_tpu_torch.schedulers import FlowUniPC
    from sparse_videogen_tpu_torch.scripts.profile_wan import project_steps

    run = I2V_PRESETS["14B-i2v-480p-svg"]
    cfg = dataclasses.replace(run.model, num_layers=LAYERS_I2V)
    args = build_parser().parse_args(["--resolution", "480p"])  # the CLI's defaults: VAE tiling auto, 32 / 8
    lay = wan_layout(cfg, run.height, run.width, run.num_frames)
    timesteps = FlowUniPC(I2V_STEPS, shift=run.flow_shift).timesteps
    kw = run.generate_kwargs()
    warmup = WarmupSchedule.from_fractions(kw["first_layers_fp"], kw["first_times_fp"], cfg.num_layers, timesteps)
    want, want_kinds = expected_launches("SVG", cfg.num_layers, warmup, timesteps, ("none", "band_sink"),
                                         **model_sites(cfg))
    stages = {}
    _kernels.reset_counts()
    t0 = time.perf_counter()
    img = load_image(os.path.join(ROOT, "examples", "1", "image.jpg"))
    read_s = time.perf_counter() - t0
    H, W = _fit_resolution(img.shape[2], img.shape[3], "480p")
    log("i2v", f"examples/1/image.jpg read by io/image.py: {tuple(img.shape)} in {read_s:.3f} s on the host, "
               f"fitted to {H}x{W}; S = {lay.seq_len} ({lay.num_frames} x {lay.frame_size})")
    if (H, W) != (run.height, run.width) or not torch.isfinite(img).all() or img.abs().max() > 1:
        raise AssertionError(f"the image: fitted {H}x{W}, or its values are not in [-1, 1]")

    clip = _timed(stages, "CLIP set-up", lambda: CLIPVisionModel(CLIP_VIT_H_14, device=dev).init_random(
        torch.Generator(device=dev).manual_seed(0)))
    encoder = CLIPImageEncoder(clip)
    clip_stage = "CLIP ViT-H/14 encode (31 of 32 blocks: the penultimate states)"
    clip_fea = _timed(stages, clip_stage, lambda: encoder(img)).to(torch.bfloat16)
    again = _timed(stages, "CLIP ViT-H/14 encode, again (warm)", lambda: encoder(img)).to(torch.bfloat16)
    if not torch.equal(again, clip_fea):
        raise AssertionError("CLIP: a second encode of the same image differs")
    log("i2v", f"CLIP: {sum(p.numel() for p in clip.parameters()) / 1e6:.1f} M params f32, clip_fea "
               f"{tuple(clip_fea.shape)}, finite {bool(torch.isfinite(clip_fea).all())}")
    if tuple(clip_fea.shape) != (1, 257, 1280) or not torch.isfinite(clip_fea).all():
        raise AssertionError("CLIP: features of the wrong shape or not finite")
    del encoder, clip
    g = torch.Generator(device=dev).manual_seed(1)
    ctx, ctx_null = (torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev).to(torch.bfloat16)
                     for _ in range(2))

    vae = WanVAE(WanVAEConfig(), device=dev, encoder=True).init_random(torch.Generator(device=dev).manual_seed(0))
    img_r = resize_cubic(img.to(dev), H, W)
    video = torch.cat([img_r[:, :, None], img_r.new_zeros(1, 3, run.num_frames - 1, H, W)], dim=2)
    torch.cuda.empty_cache()
    which, need = encode_mode(vae.cfg, video.shape, dev)
    encoded = {}
    for name, fn in (("whole", lambda: vae.encode(video)), ("streamed", lambda: vae.encode_streamed(video))):
        encoded[name] = _timed(stages, f"VAE encode {name}", fn)
        ms, gib = stages[f"VAE encode {name}"]
        log("i2v", f"VAE encode {name}: {ms / 1e3:.3f} s, peak {gib:.2f} GiB, latents {tuple(encoded[name].shape)}")
    rel = ((encoded["streamed"] - encoded["whole"]).norm() / encoded["whole"].norm()).item()
    log("i2v", f"VAE encode streamed against whole: rel L2 {rel:.3e} (tol {VAE_TOL}); the CLI's rule would run "
               f"{which} here (whole estimated at {need / 2**30:.1f} GiB, measured "
               f"{stages['VAE encode whole'][1]:.2f} GiB)")
    if not rel <= VAE_TOL or not torch.isfinite(encoded["whole"]).all():
        raise AssertionError(f"the streamed VAE encode disagrees with the whole one: {rel}")
    cond = build_i2v_condition(encoded["streamed"])
    vae.encoder = vae.conv1 = None
    del video, encoded
    torch.cuda.empty_cache()

    model = _new_model(cfg, dev)
    i2v = {"clip_fea": clip_fea, "latent_cond": cond}
    lat, svg_steps = _timed(stages, f"DiT {I2V_STEPS} steps SVG1", lambda: _steps(model, run, ctx, ctx_null, "SVG",
                                                                                 I2V_STEPS, **i2v))
    decode = make_vae_decoder(args, vae, logging.getLogger("chip_smoke"))
    out = _timed(stages, "VAE decode (CLI default: tiled)", lambda: decode(lat))
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "i2v.y4m")
        t0 = time.perf_counter()
        export_video(out, path, fps=16)
        frames, fps = read_y4m(path)
        export_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches, kinds, plain = dict(_kernels.LAUNCHES), dict(_kernels.KIND_LAUNCHES), dict(_kernels.PLAIN_CALLS)
    for name, (ms, gib) in stages.items():
        log("i2v", f"{name}: {ms:.1f} ms, peak {gib:.2f} GiB")
    log("i2v", f"SVG1 s a step {[round(x, 4) for x in svg_steps]} (the first includes the set-up; "
               f"{warmup.first_layers} dense warm-up layer); export + read back {export_s:.2f} s on the host; frames "
               f"{frames.shape} at {fps} fps, mean {frames.mean():.2f}")
    log("i2v", f"launches {launches} (expected {want}), by mask kind {kinds} (expected {dict(want_kinds)}), "
               f"plain-version calls {plain}")
    if launches != want or collections.Counter(kinds) != want_kinds or any(plain.values()):
        raise AssertionError("image -> video: the kernels did not launch as the configuration implies, or a plain "
                             "version ran")
    if frames.shape != (run.num_frames, H, W, 3) or not torch.isfinite(lat).all():
        raise AssertionError(f"image -> video: frames {frames.shape}, or the latents are not finite")

    _, dense_steps = _steps(model, run, ctx, ctx_null, "dense", 2, **i2v)
    log("i2v", f"dense s a step {[round(x, 4) for x in dense_steps]}")
    runs = [{"pattern": "SVG", "per_step_s": svg_steps}, {"pattern": "dense", "per_step_s": dense_steps}]
    proj = project_steps(runs, run, LAYERS_I2V)
    fixed = umt5_s + (stages[clip_stage][0] + stages[f"VAE encode {which}"][0]
                      + stages["VAE decode (CLI default: tiled)"][0]) / 1e3
    log("i2v", f"projected {CLI_STEPS}-step Wan 2.1 I2V 14B at 480x832x81, 40 layers: SVG1 "
               f"{fixed + proj['SVG_s']:.2f} s, dense {fixed + proj['dense_s']:.2f} s (DiT {proj['SVG_s']:.2f} / "
               f"{proj['dense_s']:.2f} s; UMT5 {umt5_s:.3f} s from p2v, CLIP, the {which} encode (the CLI's pick) and "
               f"the tiled decode {fixed - umt5_s:.2f} s)")
    del model, vae, out, lat, cond
    torch.cuda.empty_cache()


def _hy_steps(model, run, text, mask, pooled, steps, **extra):
    """HyVideoPipeline.generate_latents of `run` (a preset; `extra`: I2V's
    image_latents) with per-step CUDA events; returns (latents, [s a step]:
    the first includes the set-up)."""
    from sparse_videogen_tpu_torch.pipelines import HyVideoPipeline

    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()

    def on_step(i, lat):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    lat = HyVideoPipeline(model).generate_latents(text, mask, pooled, prompt_length=int(mask[0].sum()),
                                                  num_inference_steps=steps, seed=0, callback=on_step,
                                                  **run.generate_kwargs(), **extra)
    torch.cuda.synchronize()
    return lat, [events[i].elapsed_time(events[i + 1]) / 1e3 for i in range(steps)]


def _hy_launches(phase, run, cfg, steps):
    """expected_launches of `steps` Euler steps of `run` at cfg's depth (K1's
    hyvideo kind in dense and SVG1 layers alike)."""
    from sparse_videogen_tpu_torch.config import WarmupSchedule
    from sparse_videogen_tpu_torch.schedulers import FlowMatchEuler

    timesteps = FlowMatchEuler(steps, shift=run.flow_shift).timesteps
    warmup = WarmupSchedule.from_fractions(run.first_layers_fp, run.first_times_fp, cfg.num_layers, timesteps)
    return expected_launches(run.pattern, cfg.num_layers, warmup, timesteps, ("hyvideo", "hyvideo"),
                             **model_sites(cfg))


def _check_launches(phase, want, want_kinds):
    from sparse_videogen_tpu_torch import _kernels

    launches, kinds, plain = dict(_kernels.LAUNCHES), dict(_kernels.KIND_LAUNCHES), dict(_kernels.PLAIN_CALLS)
    log(phase, f"launches {launches} (expected {want}), by mask kind {kinds} (expected {dict(want_kinds)}), "
               f"plain-version calls {plain}")
    if launches != want or collections.Counter(kinds) != want_kinds or any(plain.values()):
        raise AssertionError(f"{phase}: the kernels did not launch as the configuration implies, or a plain version "
                             "ran")
    return launches


def phase_hy_p2v(dev):
    """HunyuanVideo T2V from a prompt to a video at full width: the port's
    tokenizer.json reader on LLaMA-3-style and CLIP-style files this script
    writes (bpe_tokenizer_files; the template's special tokens must come
    out as their ids); LLAMA3_8B (30 of its 32 layers: hidden_state_skip_layer
    2; random bf16 weights) and CLIP_L_TEXT (bf16) through
    io/encoders.HyVideoTextEncoders on the CLI's default prompt in the video
    template (crop_start 95 + text_len 256 = 351 tokens; CLIP at 77); the
    DiT (HYVIDEO_T2's width, HY_DOUBLE + HY_SINGLE blocks, random bf16) for
    HY_P2V_STEPS SVG1 steps of presets.HY_720P_SVG at 720x1280x129; the
    full-width VAE (HyVideoVAEConfig(): 128/256/512/512, f32, random)
    through the CLI's default decoder (--vae_tiling auto: 28 tiles of 32 x
    32 latents, overlap 8) on the first HY_DECODE_FRAMES latent frames, with
    cuDNN TF32 on as the CLI leaves it; export_video to a .y4m, read back.
    The kernel counters are set to 0 before the tokenizer and read after the
    writer: K1 and the fused norms launch as expected_launches says, no plain version
    runs. Each stage timed with CUDA events beside its peak memory; the
    encoders' warm times alone. Returns the encoders (LLaMA, CLIP and their
    tokenizers) for phase hy_i2v's Llava, which shares the LLaMA."""
    import logging

    from sparse_videogen_tpu_torch import _kernels
    from sparse_videogen_tpu_torch.cli._common import make_vae_decoder
    from sparse_videogen_tpu_torch.cli.hyvideo_t2v import build_parser
    from sparse_videogen_tpu_torch.io.encoders import (CLIP_TEXT_LEN, CROP_START_VIDEO, PROMPT_TEMPLATE_ENCODE_VIDEO,
                                                       HyVideoTextEncoders)
    from sparse_videogen_tpu_torch.io.native import read_y4m
    from sparse_videogen_tpu_torch.io.tokenizer import HFTokenizerLite
    from sparse_videogen_tpu_torch.models.common.clip import CLIP_L_TEXT, CLIPTextModel
    from sparse_videogen_tpu_torch.models.common.llama import LLAMA3_8B, LlamaModel
    from sparse_videogen_tpu_torch.models.hyvideo.model import HyVideoModel
    from sparse_videogen_tpu_torch.models.hyvideo.vae import HyVideoVAE, HyVideoVAEConfig
    from sparse_videogen_tpu_torch.pipelines.wan import export_video
    from sparse_videogen_tpu_torch.presets import HY_720P_SVG

    run, stages = HY_720P_SVG, {}
    cfg = dataclasses.replace(run.model, mm_double_blocks_depth=HY_DOUBLE, mm_single_blocks_depth=HY_SINGLE)
    args = build_parser().parse_args([])  # the CLI's defaults: prompt, VAE tiling auto, tile 32, overlap 8
    want, want_kinds = _hy_launches("hy_p2v", run, cfg, HY_P2V_STEPS)
    g = torch.Generator(device=dev).manual_seed(0)
    _kernels.reset_counts()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        t0 = time.perf_counter()
        template = PROMPT_TEMPLATE_ENCODE_VIDEO.format(args.prompt)
        lids = bpe_tokenizer_files(os.path.join(tmp, "text_encoder"), [template], "llama")
        cids = bpe_tokenizer_files(os.path.join(tmp, "text_encoder_2"), [args.prompt], "clip")
        ltok = HFTokenizerLite.from_dir(os.path.join(tmp, "text_encoder"))
        ctok = HFTokenizerLite.from_dir(os.path.join(tmp, "text_encoder_2"))
        ids, clip_ids = ltok.encode(template), ctok.encode(args.prompt)
        log("hy_p2v", f"tokenizers: LLaMA-3-style {len(ltok.model.vocab)} + {len(lids)} special tokens, the template "
                      f"{len(ids)} ids; CLIP-style {len(ctok.model.vocab)} tokens, the prompt {len(clip_ids)} ids; "
                      f"{time.perf_counter() - t0:.3f} s on the host (files written and read)")
        specials = [lids[t] for t in ("<|begin_of_text|>", "<|start_header_id|>")]
        if ids[:2] != specials or ids.count(lids["<|eot_id|>"]) != 2 or ids.count(lids["<|end_header_id|>"]) != 2 \
                or clip_ids[0] != cids["<|startoftext|>"] or clip_ids[-1] != cids["<|endoftext|>"]:
            raise AssertionError("tokenizers: the template's or CLIP's special tokens did not come out as their ids")
        llama = _timed(stages, "LLaMA-3-8B set-up (30 of 32 layers, bf16)", lambda: LlamaModel(
            LLAMA3_8B, n_layers=LLAMA3_8B.num_layers - 2, device=dev).init_random(g))
        clip = _timed(stages, "CLIP-L text set-up (bf16)", lambda: CLIPTextModel(
            CLIP_L_TEXT, dtype=torch.bfloat16, device=dev).init_random(g))
        enc = HyVideoTextEncoders(llama, ltok, clip, ctok, text_len=cfg.text_len)
        text, mask, pooled = _timed(stages, "text encoders (tokenizers, LLaMA, CLIP; cold)", lambda: enc([args.prompt]))
        n_tok = CROP_START_VIDEO + cfg.text_len
        l_ids, l_mask = ltok([template], seq_len=n_tok)
        c_ids, c_mask = ctok([args.prompt], seq_len=CLIP_TEXT_LEN)
        _timed(stages, f"LLaMA-3-8B encode {n_tok} tokens (warm)", lambda: llama(l_ids, l_mask))
        _timed(stages, f"CLIP-L text encode {CLIP_TEXT_LEN} tokens (warm)", lambda: clip(c_ids, c_mask))
        live = int(mask[0].sum())
        n_llama = sum(p.numel() for p in llama.parameters())
        log("hy_p2v", f"LLaMA-3-8B {n_llama / 1e9:.3f} B params bf16 ({n_llama * 2 / 2**30:.2f} GiB): states "
                      f"{tuple(text.shape)}, prompt {live} of {cfg.text_len} after the crop, finite "
                      f"{bool(torch.isfinite(text).all())}, std {text[0, :live].float().std().item():.4f}; pooled "
                      f"{tuple(pooled.shape)}")
        if tuple(text.shape) != (1, cfg.text_len, cfg.text_states_dim) or not torch.isfinite(text).all() or \
                not (text[0, live:] == 0).all() or not 0 < live < cfg.text_len or \
                tuple(pooled.shape) != (1, cfg.text_states_dim_2) or not torch.isfinite(pooled).all():
            raise AssertionError("text encoders: states or pooled of the wrong shape, not finite, or not zero past "
                                 "the prompt")

        model = _timed(stages, "DiT set-up", lambda: HyVideoModel(cfg, dtype=torch.bfloat16, device=dev).init_random(g))
        lat, steps_s = _timed(stages, f"DiT {HY_P2V_STEPS} steps SVG1",
                              lambda: _hy_steps(model, run, text, mask, pooled, HY_P2V_STEPS))
        del model
        vae = _timed(stages, "VAE set-up (full width, f32)", lambda: HyVideoVAE(HyVideoVAEConfig(), device=dev)
                     .init_random(g))
        decode = make_vae_decoder(args, vae, logging.getLogger("chip_smoke"))
        torch.backends.cudnn.allow_tf32 = True  # the CLI leaves torch's default on
        try:
            video = _timed(stages, f"VAE decode {HY_DECODE_FRAMES} of {lat.shape[2]} latent frames (CLI default: "
                                   "tiled, TF32)", lambda: decode(lat[:, :, :HY_DECODE_FRAMES]))
        finally:
            torch.backends.cudnn.allow_tf32 = False
        path = os.path.join(tmp, "hy_p2v.y4m")
        t0 = time.perf_counter()
        export_video(video, path, fps=24)
        frames, fps = read_y4m(path)
        export_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = _check_launches("hy_p2v", want, want_kinds)
    for name, (ms, gib) in stages.items():
        log("hy_p2v", f"{name}: {ms:.1f} ms, peak {gib:.2f} GiB")
    n_frames = 1 + 4 * (HY_DECODE_FRAMES - 1)
    log("hy_p2v", f"SVG1 s a step {[round(x, 4) for x in steps_s]} (the first includes the set-up); export + read back "
                  f"{export_s:.2f} s on the host; frames {frames.shape} at {fps} fps, mean {frames.mean():.2f}, std "
                  f"{frames.std():.2f}")
    if frames.shape != (n_frames, run.height, run.width, 3) or frames.std() == 0 or not torch.isfinite(video).all():
        raise AssertionError(f"prompt -> video: frames {frames.shape}, std {frames.std()}")
    del vae, video, lat
    torch.cuda.empty_cache()
    return {"llama": llama, "clip": clip, "ltok": ltok, "ctok": ctok, "launches": launches}


def phase_hy_i2v(dev, enc):
    """HunyuanVideo I2V from an image to a video at full width:
    examples/1/image.jpg read by io/image.py and resized to 720x1280 by
    models/common/resize.py (cubic, the CLI's defaults); the full-width VAE
    encoder on that one frame (f32, random); Llava at full width (CLIP
    ViT-L/14-336, 24 layers, f32; the projector; phase hy_p2v's LLaMA-3-8B,
    shared) through io/encoders.LlavaImageTextEncoder with
    LLAVA_INTERLEAVE (144 image tokens spliced into the 256 text
    positions); the I2V DiT (HYVIDEO_T2 with in_channels 33, HY_DOUBLE +
    HY_SINGLE blocks) for HY_I2V_STEPS dense steps of
    presets["hyvideo-i2v-720p-dense"] with the latent_concat condition. The
    counters are set to 0 before the image is read and read after the
    steps: K1 and the fused norms as expected_launches says, no plain version. Each stage
    timed with CUDA events beside its peak memory."""
    from sparse_videogen_tpu_torch import _kernels
    from sparse_videogen_tpu_torch.cli.hyvideo_i2v import build_parser
    from sparse_videogen_tpu_torch.io.encoders import CLIP_VIT_L_14_336, LlavaImageTextEncoder
    from sparse_videogen_tpu_torch.io.image import load_image
    from sparse_videogen_tpu_torch.models.common.llama import LLAMA3_8B
    from sparse_videogen_tpu_torch.models.common.llava import LlavaModel
    from sparse_videogen_tpu_torch.models.common.resize import resize_cubic
    from sparse_videogen_tpu_torch.models.hyvideo.model import HyVideoModel
    from sparse_videogen_tpu_torch.models.hyvideo.vae import HyVideoVAE, HyVideoVAEConfig
    from sparse_videogen_tpu_torch.presets import HY_PRESETS

    run, stages = HY_PRESETS["hyvideo-i2v-720p-dense"], {}
    cfg = dataclasses.replace(run.model, mm_double_blocks_depth=HY_DOUBLE, mm_single_blocks_depth=HY_SINGLE)
    args = build_parser().parse_args([])  # the CLI's defaults: prompt, 720x1280, dense
    want, want_kinds = _hy_launches("hy_i2v", run, cfg, HY_I2V_STEPS)
    g = torch.Generator(device=dev).manual_seed(3)
    _kernels.reset_counts()
    t0 = time.perf_counter()
    img = load_image(os.path.join(ROOT, "examples", "1", "image.jpg"))
    read_s = time.perf_counter() - t0
    img_px = _timed(stages, "cubic resize to 720x1280", lambda: resize_cubic(img.to(dev), args.height, args.width))
    log("hy_i2v", f"examples/1/image.jpg read by io/image.py: {tuple(img.shape)} in {read_s:.3f} s on the host, "
                  f"resized to {tuple(img_px.shape)}")
    vae = _timed(stages, "VAE set-up (full width, f32)", lambda: HyVideoVAE(HyVideoVAEConfig(), device=dev)
                 .init_random(g))
    img_lat = _timed(stages, "VAE encode 1 frame 720x1280 (f32)", lambda: vae.encode(img_px[:, :, None]))
    del vae
    if tuple(img_lat.shape) != (1, 16, 1, args.height // 8, args.width // 8) or not torch.isfinite(img_lat).all():
        raise AssertionError(f"the VAE encode: latents {tuple(img_lat.shape)} or not finite")
    vcfg = CLIP_VIT_L_14_336
    llava = _timed(stages, "Llava set-up (vision tower f32, projector; LLaMA shared)", lambda: LlavaModel(
        LLAMA3_8B, vcfg, llama=enc["llama"], device=dev).init_random(g))
    lenc = LlavaImageTextEncoder(llava, enc["ltok"], enc["clip"], enc["ctok"], text_len=cfg.text_len,
                                 interleave=LLAVA_INTERLEAVE)
    text, mask, pooled = _timed(stages, f"Llava encode ({vcfg.grid ** 2} patches / {LLAVA_INTERLEAVE} = "
                                        f"{lenc.n_image_tokens} image tokens) + CLIP-L",
                                lambda: lenc([args.prompt], img_px))
    live = int(mask[0].sum())
    log("hy_i2v", f"Llava: vision {sum(p.numel() for p in llava.vision.parameters()) / 1e6:.1f} M params f32, states "
                  f"{tuple(text.shape)}, {live} of {cfg.text_len} positions live ({lenc.n_image_tokens} of them the "
                  f"image), finite {bool(torch.isfinite(text).all())}")
    if tuple(text.shape) != (1, cfg.text_len, cfg.text_states_dim) or not torch.isfinite(text).all() or \
            not (text[0, live:] == 0).all() or live <= lenc.n_image_tokens or not torch.isfinite(pooled).all():
        raise AssertionError("Llava: states of the wrong shape, not finite, not zero past the prompt, or no text")
    del llava, lenc
    enc.clear()
    torch.cuda.empty_cache()
    model = _timed(stages, "I2V DiT set-up (in_channels 33)", lambda: HyVideoModel(cfg, dtype=torch.bfloat16,
                                                                                  device=dev).init_random(g))
    lat, steps_s = _timed(stages, f"DiT {HY_I2V_STEPS} steps dense",
                          lambda: _hy_steps(model, run, text, mask, pooled, HY_I2V_STEPS, image_latents=img_lat))
    torch.cuda.synchronize()
    launches = _check_launches("hy_i2v", want, want_kinds)
    for name, (ms, gib) in stages.items():
        log("hy_i2v", f"{name}: {ms:.1f} ms, peak {gib:.2f} GiB")
    log("hy_i2v", f"dense s a step {[round(x, 4) for x in steps_s]} (the first includes the set-up); latents "
                  f"{tuple(lat.shape)} finite {bool(torch.isfinite(lat).all())}")
    if tuple(lat.shape) != (1, 16, 33, args.height // 8, args.width // 8) or not torch.isfinite(lat).all():
        raise AssertionError(f"image -> video: latents {tuple(lat.shape)} or not finite")
    del model, lat
    torch.cuda.empty_cache()
    return launches


def phase_small_hy_reference(dev):
    """A small LLaMA (GQA, right padding), CLIP text tower, Llava and
    HunyuanVideo VAE (decode whole and tiled, encode) on the card against
    the same modules on the CPU, f32, same weights and inputs (TF32 off):
    the text modules within TEXT_TOL, the VAE within VAE_TOL."""
    import argparse
    import logging

    from sparse_videogen_tpu_torch.cli._common import make_vae_decoder
    from sparse_videogen_tpu_torch.models.common.clip import CLIPTextConfig, CLIPTextModel, CLIPVisionConfig
    from sparse_videogen_tpu_torch.models.common.llama import LlamaConfig, LlamaModel
    from sparse_videogen_tpu_torch.models.common.llava import LlavaModel, llava_encode
    from sparse_videogen_tpu_torch.models.hyvideo.vae import HyVideoVAE, HyVideoVAEConfig

    g = torch.Generator().manual_seed(8)
    cpu = torch.device("cpu")

    def both(name, build, run, tol):
        cpu_m = build(cpu).init_random(g)
        gpu_m = build(dev)
        gpu_m.load_state_dict(cpu_m.state_dict())
        a, b = run(gpu_m, dev), run(cpu_m, cpu)
        rel = ((a.cpu().float() - b.float()).norm() / b.float().norm()).item()
        log("small", f"{name} card vs CPU, f32: rel L2 {rel:.3e} (tol {tol})")
        if not rel <= tol:
            raise AssertionError(f"{name} on the card disagrees with the CPU: {rel}")

    lcfg = LlamaConfig(vocab_size=300, dim=128, ffn_dim=256, num_layers=3, num_heads=4, num_kv_heads=2)
    ids = torch.randint(0, 300, (2, 40), generator=g)
    mask = (torch.arange(40)[None] < torch.tensor([[25], [40]])).int()
    both("LLaMA (2 of 3 layers, GQA 4 on 2, right padding)",
         lambda d: LlamaModel(lcfg, n_layers=2, dtype=torch.float32, device=d),
         lambda m, d: m(ids.to(d), mask.to(d)), TEXT_TOL)
    ccfg = CLIPTextConfig(vocab_size=300, dim=64, ffn_dim=128, num_layers=2, num_heads=4)
    cids = torch.randint(0, 299, (2, 77), generator=g)
    cids[:, 10:] = 299
    both("CLIP text tower (2 layers; pooled)", lambda d: CLIPTextModel(ccfg, device=d),
         lambda m, d: m(cids.to(d), None)[1], TEXT_TOL)
    vcfg = CLIPVisionConfig(image_size=56, patch_size=14, dim=64, ffn_dim=128, num_layers=2, num_heads=4,
                            hidden_act="quick_gelu")
    px = torch.randn(1, 3, 56, 56, generator=g)
    both("Llava (vision, projector, LLaMA; 16 patches / interleave 2 spliced at 3)",
         lambda d: LlavaModel(lcfg, vcfg, n_layers=2, dtype=torch.float32, device=d),
         lambda m, d: llava_encode(m, ids[:1].to(d), mask[:1].to(d), px.to(d), 3, interleave=2)[0], TEXT_TOL)
    hcfg = HyVideoVAEConfig(block_out_channels=(16, 32, 32, 32), layers_per_block=1, norm_num_groups=8)
    z = torch.randn(1, 16, 3, 8, 12, generator=g)
    both("HunyuanVideo VAE (dims 16/32) decode, whole", lambda d: HyVideoVAE(hcfg, device=d),
         lambda m, d: m.decode(z.to(d)), VAE_TOL)
    ns = argparse.Namespace(vae_tiling="on", vae_tile=4, vae_tile_overlap=2, vae_stream_chunk=0)
    both("HunyuanVideo VAE decode, tiled (4 x 4 latents, overlap 2)", lambda d: HyVideoVAE(hcfg, device=d),
         lambda m, d: make_vae_decoder(ns, m, logging.getLogger("chip_smoke"))(z.to(d)), VAE_TOL)
    video = torch.rand(1, 3, 9, 64, 96, generator=g) * 2 - 1
    both("HunyuanVideo VAE encode (9 frames)", lambda d: HyVideoVAE(hcfg, device=d),
         lambda m, d: m.encode(video.to(d)), VAE_TOL)


def phase_small_i2v_reference(dev):
    """A small I2V Wan (the CLI's smoke model, bf16) with clip_fea, a small
    CLIP vision tower and a small Wan VAE encoder (f32) on the card against
    the same modules on the CPU, same weights and inputs: the forward
    (dense, SVG1) within rel L2 3e-2, CLIP within CLIP_TOL, the whole and
    streamed encodes within VAE_TOL of the CPU's whole encode."""
    from sparse_videogen_tpu_torch.cli.wan_i2v import SMOKE_CFG
    from sparse_videogen_tpu_torch.cli.wan_t2v import SMOKE_VAE_CFG
    from sparse_videogen_tpu_torch.io.encoders import CLIPImageEncoder, clip_config_from_hf
    from sparse_videogen_tpu_torch.models.common.clip import CLIPVisionModel
    from sparse_videogen_tpu_torch.models.wan.model import WanConfig, WanModel
    from sparse_videogen_tpu_torch.models.wan.vae import WanVAE, WanVAEConfig
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime, wan_layout

    cfg = WanConfig(**SMOKE_CFG)
    gen = torch.Generator().manual_seed(6)
    cpu_model = WanModel(cfg, dtype=torch.bfloat16).init_random(gen)
    gpu_model = WanModel(cfg, dtype=torch.bfloat16, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    lay = wan_layout(cfg, 96, 128, 9)
    rows = torch.randint(0, lay.seq_len, (cfg.num_layers, 64), generator=gen)
    for pattern in ("dense", "SVG"):
        x = torch.randn(2, cfg.in_dim, lay.num_frames, 12, 16, generator=gen).to(torch.bfloat16)
        ctx = torch.randn(2, cfg.text_len, cfg.text_dim, generator=gen).to(torch.bfloat16)
        clip_fea = torch.randn(2, 257, cfg.image_dim, generator=gen).to(torch.bfloat16)
        t = torch.full((2,), 900.0)
        outs = [m(x.to(d), t.to(d), ctx.to(d), clip_fea=clip_fea.to(d), profile_rows=rows,
                  attention=make_wan_runtime(lay, device=d, pattern=pattern)).cpu()
                for m, d in ((gpu_model, dev), (cpu_model, torch.device("cpu")))]
        rel = ((outs[0] - outs[1]).norm() / outs[1].norm()).item()
        log("small", f"I2V Wan forward with clip_fea, {pattern}: kernels on the card vs plain on the CPU, rel L2 "
                     f"{rel:.3e} (tol 3e-2)")
        if not rel <= 3e-2:
            raise AssertionError(f"the small I2V forward ({pattern}) disagrees with the CPU reference: {rel}")
    ccfg = clip_config_from_hf(TINY_CLIP)
    cpu_clip = CLIPVisionModel(ccfg).init_random(gen)
    gpu_clip = CLIPVisionModel(ccfg, device=dev)
    gpu_clip.load_state_dict(cpu_clip.state_dict())
    px = torch.rand(1, 3, 480, 832, generator=gen) * 2 - 1
    a, b = CLIPImageEncoder(gpu_clip)(px).cpu(), CLIPImageEncoder(cpu_clip)(px)
    rel = ((a - b).norm() / b.norm()).item()
    log("small", f"CLIP vision tower (dim {ccfg.dim}, {ccfg.num_layers} layers) with the cubic resize from 480x832, "
                 f"card vs CPU, f32: rel L2 {rel:.3e} (tol {CLIP_TOL})")
    if not rel <= CLIP_TOL:
        raise AssertionError(f"CLIP on the card disagrees with the CPU: {rel}")
    vcfg = WanVAEConfig(**SMOKE_VAE_CFG)
    cpu_vae = WanVAE(vcfg, encoder=True).init_random(gen)
    gpu_vae = WanVAE(vcfg, device=dev, encoder=True)
    gpu_vae.load_state_dict(cpu_vae.state_dict())
    video = torch.rand(1, 3, 9, 64, 96, generator=gen) * 2 - 1
    ref = cpu_vae.encode(video)
    for name, out in (("whole", gpu_vae.encode(video.to(dev))), ("streamed", gpu_vae.encode_streamed(video.to(dev)))):
        rel = ((out.cpu() - ref).norm() / ref.norm()).item()
        log("small", f"Wan VAE (dim 16) {name} encode card vs CPU whole encode, f32: rel L2 {rel:.3e} (tol {VAE_TOL})")
        if not rel <= VAE_TOL:
            raise AssertionError(f"the VAE encode ({name}) on the card disagrees with the CPU: {rel}")


def phase_small_text_vae_reference(dev):
    """A small UMT5 and a small Wan VAE on the card against the same modules
    on the CPU (f32, same weights and inputs; this script turns TF32 off):
    UMT5 within rel L2 UMT5_TOL, the VAE's whole and streamed decodes within
    VAE_TOL."""
    from sparse_videogen_tpu_torch.cli.wan_t2v import SMOKE_VAE_CFG
    from sparse_videogen_tpu_torch.models.common.t5 import T5Config, T5Encoder
    from sparse_videogen_tpu_torch.models.wan.vae import WanVAE, WanVAEConfig

    g = torch.Generator().manual_seed(4)
    cfg = T5Config(vocab_size=300, dim=64, dim_attn=64, dim_ffn=128, num_heads=2, num_layers=2, num_buckets=8)
    cpu = T5Encoder(cfg, dtype=torch.float32).init_random(g)
    gpu = T5Encoder(cfg, dtype=torch.float32, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    mask = (torch.arange(64)[None] < torch.tensor([[40], [64]])).int()
    a, b = gpu(ids, mask).cpu(), cpu(ids, mask)
    rel = ((a - b).norm() / b.norm()).item()
    log("small", f"UMT5 (2 layers, dim 64) card vs CPU, f32: rel L2 {rel:.3e} (tol {UMT5_TOL})")
    if not rel <= UMT5_TOL:
        raise AssertionError(f"UMT5 on the card disagrees with the CPU: {rel}")
    vcfg = WanVAEConfig(**SMOKE_VAE_CFG)
    cpu_vae = WanVAE(vcfg).init_random(g)
    gpu_vae = WanVAE(vcfg, device=dev)
    gpu_vae.load_state_dict(cpu_vae.state_dict())
    z = torch.randn(1, 16, 3, 12, 16, generator=g)
    ref = cpu_vae.decode(z)
    for name, out in (("whole", gpu_vae.decode(z.to(dev))),
                      ("streamed, chunk 1", gpu_vae.decode_streamed(z.to(dev), 1))):
        rel = ((out.cpu() - ref).norm() / ref.norm()).item()
        log("small", f"Wan VAE (dim 16) {name} decode card vs CPU whole decode, f32: rel L2 {rel:.3e} (tol {VAE_TOL})")
        if not rel <= VAE_TOL:
            raise AssertionError(f"the VAE decode ({name}) on the card disagrees with the CPU: {rel}")


def phase_cog_i2v(dev):
    """CogVideoX 1.5 I2V from an image and a prompt to a video at full width:
    a spiece.model this script writes, read by io/tokenizer.py; T5 v1.1 XXL
    (T5_V1_1_XXL, random bf16) through io/encoders.T5TextEncoder on the
    CLI's prompt and its empty negative prompt at 226 tokens (unmasked, cast
    to bf16 as the CLI does); examples/1/image.jpg decoded by io/image.py
    and resized bilinearly to 768x1360 (models/common/resize.py); the
    full-width VAE (CogVAEConfig(), f32, random) encode of that frame, with
    TF32 off and on, scaled (v1.5: / 0.7); COG_1_5_5B_I2V at COG_LAYERS
    layers for COG_I2V_STEPS SVG1 steps of presets.COG_768P_SVG; the CLI's
    default decoder (--vae_tiling auto: 28 tiles of 32 x 32 latents) on the
    first COG_DECODE_FRAMES of the 21 latent frames with TF32 on, as the CLI
    leaves it; a .y4m at 8 fps, read back. The kernel counters are set to 0
    before the tokenizer and read after the writer: K1 (kinds none and cog)
    and K2 launch as expected_launches says, no plain version runs. Each
    stage timed with CUDA events beside its peak memory."""
    import logging

    from sparse_videogen_tpu_torch import _kernels
    from sparse_videogen_tpu_torch.cli._common import make_vae_decoder
    from sparse_videogen_tpu_torch.cli.cog_i2v import FPS, build_parser
    from sparse_videogen_tpu_torch.config import WarmupSchedule
    from sparse_videogen_tpu_torch.io.encoders import T5TextEncoder
    from sparse_videogen_tpu_torch.io.image import load_image
    from sparse_videogen_tpu_torch.io.native import read_y4m
    from sparse_videogen_tpu_torch.io.tokenizer import T5TokenizerLite
    from sparse_videogen_tpu_torch.models.cog.model import CogModel
    from sparse_videogen_tpu_torch.models.cog.vae import CogVAE, CogVAEConfig, scale_latents
    from sparse_videogen_tpu_torch.models.common.resize import resize_bilinear
    from sparse_videogen_tpu_torch.models.common.t5 import T5_V1_1_XXL, T5Encoder
    from sparse_videogen_tpu_torch.pipelines import CogPipeline
    from sparse_videogen_tpu_torch.pipelines.wan import export_video
    from sparse_videogen_tpu_torch.presets import COG_768P_SVG as run
    from sparse_videogen_tpu_torch.schedulers import CogDDIM

    stages = {}
    cfg = dataclasses.replace(run.model, num_layers=COG_LAYERS)
    args = build_parser().parse_args([])  # the CLI's defaults: prompt, VAE tiling auto, tile 32, overlap 8
    timesteps = CogDDIM(COG_I2V_STEPS).timesteps
    kw = run.generate_kwargs()
    warmup = WarmupSchedule.from_fractions(kw["first_layers_fp"], kw["first_times_fp"], cfg.num_layers, timesteps)
    want, want_kinds = expected_launches("SVG", cfg.num_layers, warmup, timesteps, ("none", "cog"))
    g = torch.Generator(device=dev).manual_seed(0)
    _kernels.reset_counts()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        write_spiece(tmp, synthetic_vocab([args.prompt]), unk_id=2)
        tok = T5TokenizerLite.from_dir(tmp)
        t5 = _timed(stages, "T5 v1.1 XXL set-up (bf16)", lambda: T5Encoder(T5_V1_1_XXL, dtype=torch.bfloat16,
                                                                            device=dev).init_random(g))
        enc = T5TextEncoder(t5, tok, cfg.text_len, mask_output=False)
        ctx, ctx_null = _timed(stages, f"T5 v1.1 XXL encode prompt + negative, {cfg.text_len} tokens each",
                               lambda: [enc([p]).to(torch.bfloat16) for p in (args.prompt, args.negative_prompt)])
        n_t5 = sum(p.numel() for p in t5.parameters())
        log("cog_i2v", f"T5 v1.1 XXL {n_t5 / 1e9:.3f} B params bf16: states {tuple(ctx.shape)}, finite "
                       f"{bool(torch.isfinite(ctx).all())}, std {ctx.float().std().item():.4f}")
        if tuple(ctx.shape) != (1, cfg.text_len, cfg.text_dim) or not torch.isfinite(ctx).all() or \
                not torch.isfinite(ctx_null).all():
            raise AssertionError("T5: states of the wrong shape or not finite")
        del t5, enc
        torch.cuda.empty_cache()
        img = load_image(os.path.join(ROOT, "examples", "1", "image.jpg"))
        pix = _timed(stages, f"bilinear resize {tuple(img.shape[2:])} -> ({run.height}, {run.width})",
                     lambda: resize_bilinear(img.to(dev), run.height, run.width))
        vae = _timed(stages, "VAE set-up (full width, f32)", lambda: CogVAE(CogVAEConfig(), device=dev).init_random(g))
        raw = _timed(stages, "VAE encode of the frame, f32 (TF32 off)", lambda: vae.encode(pix[:, :, None]))
        torch.backends.cudnn.allow_tf32 = True
        try:
            raw_tf32 = _timed(stages, "VAE encode of the frame, TF32", lambda: vae.encode(pix[:, :, None]))
        finally:
            torch.backends.cudnn.allow_tf32 = False
        rel = ((raw_tf32 - raw).norm() / raw.norm()).item()
        img_lat = scale_latents(vae.cfg, raw)
        log("cog_i2v", f"image {tuple(img.shape)} -> {tuple(pix.shape)} -> latents {tuple(img_lat.shape)}, finite "
                       f"{bool(torch.isfinite(img_lat).all())}, std {img_lat.std().item():.4f}; the TF32 encode "
                       f"{rel:.3e} rel L2 from the f32 one")
        if tuple(img_lat.shape) != (1, 16, 1, run.height // 8, run.width // 8) or not torch.isfinite(img_lat).all():
            raise AssertionError("image -> latents: wrong shape or not finite")
        model = _timed(stages, "DiT set-up", lambda: CogModel(cfg, dtype=torch.bfloat16, device=dev).init_random(g))
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def on_step(i, lat):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

        lat = _timed(stages, f"DiT {COG_I2V_STEPS} steps SVG1", lambda: CogPipeline(model).generate_latents(
            ctx, ctx_null, img_lat, num_inference_steps=COG_I2V_STEPS, seed=0, callback=on_step, **kw))
        steps_s = [events[i].elapsed_time(events[i + 1]) / 1e3 for i in range(COG_I2V_STEPS)]
        del model
        torch.cuda.empty_cache()
        decode = make_vae_decoder(args, vae, logging.getLogger("chip_smoke"))
        torch.backends.cudnn.allow_tf32 = True  # the CLI leaves torch's default on
        try:
            video = _timed(stages, f"VAE decode {COG_DECODE_FRAMES} of {lat.shape[2]} latent frames (CLI default: "
                                   "tiled, TF32)", lambda: decode(lat[:, :, :COG_DECODE_FRAMES]))
        finally:
            torch.backends.cudnn.allow_tf32 = False
        path = os.path.join(tmp, "cog_i2v.y4m")
        t0 = time.perf_counter()
        export_video(video, path, fps=FPS)
        frames, fps = read_y4m(path)
        export_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = _check_launches("cog_i2v", want, want_kinds)
    for name, (ms, gib) in stages.items():
        log("cog_i2v", f"{name}: {ms:.1f} ms, peak {gib:.2f} GiB")
    n_frames = 1 + 4 * (COG_DECODE_FRAMES - 1)
    log("cog_i2v", f"SVG1 s a step {[round(x, 4) for x in steps_s]} (the first includes the set-up); export + read "
                   f"back {export_s:.2f} s on the host; frames {frames.shape} at {fps} fps, mean {frames.mean():.2f}, "
                   f"std {frames.std():.2f}")
    if frames.shape != (n_frames, run.height, run.width, 3) or fps != FPS or frames.std() == 0 or \
            not torch.isfinite(video).all():
        raise AssertionError(f"image -> video: frames {frames.shape} at {fps} fps, std {frames.std()}")
    del vae, video, lat
    torch.cuda.empty_cache()
    return launches


def cosmos_dense_steps(run, n_steps: int) -> int:
    """The steps a run of n_steps EDM steps takes dense (the warm-up's
    first_times from WarmupSchedule.from_fractions over c_noise)."""
    from sparse_videogen_tpu_torch.config import WarmupSchedule
    from sparse_videogen_tpu_torch.schedulers import EDMEuler

    ts = EDMEuler(n_steps).timesteps
    w = WarmupSchedule.from_fractions(run.first_layers_fp, run.first_times_fp, run.model.num_layers, ts)
    return int((ts > w.first_times).sum())


def phase_cosmos(dev):
    """Cosmos Text2World from a prompt to a video at full width: a
    spiece.model this script writes; t5-11b's encoder (T5_11B: 24 layers,
    d_model 1024, 128 heads of 128, FFN 65,536; random bf16) through
    io/encoders.T5TextEncoder on the CLI's prompt and empty negative prompt
    at 512 tokens (masked, cast to bf16); COSMOS_7B at full width with
    COSMOS_LAYERS of its 28 layers at 704x1280x121 (S = 56,320) through
    CosmosPipeline.generate_latents, each run through drive_pipeline
    (launches held to expected_launches, no plain version, finite latents):
    dense (cosmos-704p-dense) for COSMOS_STEPS_DENSE steps, SVG1
    (cosmos-704p-svg) for COSMOS_STEPS steps, then the model made organic
    (utils/organic: k := q in every self-attention, norm_q x COSMOS_SAP_GAIN,
    smooth initial latents) for SAP in cluster and tile mode (cosmos-704p-sap:
    QC 300, KC 1000) for COSMOS_STEPS steps, with SAP's densities; the
    full-width CV8x8x8 VAE (random f32) through the CLI's default decoder
    (tiled) on the first COSMOS_DECODE_FRAMES latent frames with TF32 on; a
    .y4m at 30 fps, read back. Prints the s a step by pattern, the dense
    steps a 35-step run takes under each preset (WarmupSchedule's c_noise
    offset), and the projection of a 35-step, 28-layer generation. Returns
    {kernel: launches} of the runs."""
    import logging

    from sparse_videogen_tpu_torch import _kernels
    from sparse_videogen_tpu_torch.cli._common import make_vae_decoder
    from sparse_videogen_tpu_torch.cli.cosmos_t2v import TEXT_LEN, build_parser
    from sparse_videogen_tpu_torch.io.encoders import T5TextEncoder
    from sparse_videogen_tpu_torch.io.native import read_y4m
    from sparse_videogen_tpu_torch.io.tokenizer import T5TokenizerLite
    from sparse_videogen_tpu_torch.models.common.t5 import T5_11B, T5Encoder
    from sparse_videogen_tpu_torch.models.cosmos.model import CosmosModel
    from sparse_videogen_tpu_torch.models.cosmos.vae import COSMOS_VAE_CV8x8x8, CosmosVAE
    from sparse_videogen_tpu_torch.pipelines import CosmosPipeline
    from sparse_videogen_tpu_torch.pipelines.cosmos import cosmos_layout
    from sparse_videogen_tpu_torch.pipelines.wan import export_video
    from sparse_videogen_tpu_torch.presets import COSMOS_PRESETS
    from sparse_videogen_tpu_torch.schedulers import EDMEuler
    from sparse_videogen_tpu_torch.utils.organic import align_self_attn_qk, smooth_latents

    stages, launches = {}, collections.Counter()
    args = build_parser().parse_args([])
    dense_run = COSMOS_PRESETS["cosmos-704p-dense"]
    cfg = dataclasses.replace(dense_run.model, num_layers=COSMOS_LAYERS)
    lay = cosmos_layout(cfg, dense_run.height, dense_run.width, dense_run.num_frames)
    g = torch.Generator(device=dev).manual_seed(0)
    for name, run in COSMOS_PRESETS.items():
        log("cosmos", f"{name}: a 35-step run takes {cosmos_dense_steps(run, 35)} dense steps (first_times_fp "
                      f"{run.first_times_fp} says {int(run.first_times_fp * 35)}: from_fractions' offset of 1.0 on "
                      f"c_noise timesteps); this run's {COSMOS_STEPS} steps take "
                      f"{cosmos_dense_steps(run, COSMOS_STEPS)} dense")
    _kernels.reset_counts()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        write_spiece(tmp, synthetic_vocab([args.prompt]), unk_id=2)
        tok = T5TokenizerLite.from_dir(tmp)
        t5 = _timed(stages, "t5-11b encoder set-up (bf16)", lambda: T5Encoder(T5_11B, dtype=torch.bfloat16,
                                                                               device=dev).init_random(g))
        enc = T5TextEncoder(t5, tok, TEXT_LEN, mask_output=True)
        ctx, ctx_null = _timed(stages, f"t5-11b encode prompt + negative, {TEXT_LEN} tokens each",
                               lambda: [enc([p]).to(torch.bfloat16) for p in (args.prompt, args.negative_prompt)])
        live = int(tok([args.prompt], seq_len=TEXT_LEN)[1].sum())
        n_t5 = sum(p.numel() for p in t5.parameters())
        log("cosmos", f"t5-11b encoder {n_t5 / 1e9:.3f} B params bf16 ({n_t5 * 2 / 2**30:.2f} GiB): states "
                      f"{tuple(ctx.shape)}, prompt {live} tokens, finite {bool(torch.isfinite(ctx).all())}, std "
                      f"{ctx[0, :live].float().std().item():.4f}")
        if tuple(ctx.shape) != (1, TEXT_LEN, cfg.text_embed_dim) or not torch.isfinite(ctx).all() or \
                not (ctx[0, live:] == 0).all() or not (ctx_null[0, 1:] == 0).all():
            raise AssertionError("t5-11b: states of the wrong shape, not finite, or not zero past the prompt")
        del t5, enc
        torch.cuda.empty_cache()
        model = _timed(stages, "DiT set-up", lambda: CosmosModel(cfg, dtype=torch.bfloat16, device=dev).init_random(g))
        log("cosmos", f"COSMOS_7B: {cfg.num_layers} of 28 layers, {cfg.num_attention_heads} heads of "
                      f"{cfg.attention_head_dim}, {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params; "
                      f"S = {lay.seq_len} = {lay.num_frames} x {lay.frame_size}")
        shape = (1, cfg.out_channels, 1 + (dense_run.num_frames - 1) // 8, dense_run.height // 8,
                 dense_run.width // 8)
        per_step, lat = {}, None
        for label, preset, steps in (("dense", "cosmos-704p-dense", COSMOS_STEPS_DENSE),
                                     ("SVG", "cosmos-704p-svg", COSMOS_STEPS),
                                     ("SAP", "cosmos-704p-sap", COSMOS_STEPS),
                                     ("SAP tile", "cosmos-704p-sap-tile", COSMOS_STEPS)):
            run = COSMOS_PRESETS[preset]
            kw = dict(run.generate_kwargs(), num_inference_steps=steps)
            pipe = CosmosPipeline(model)
            sched = EDMEuler(steps)
            if run.pattern == "SAP":
                if label == "SAP":
                    align_self_attn_qk(model, COSMOS_SAP_GAIN, key="attn1")
                lat0 = smooth_latents(torch.Generator(device=dev).manual_seed(3), shape, dtype=torch.float32)
                density = os.path.join(tmp, f"{preset}.jsonl")
                generate = lambda on_step: pipe._denoise(
                    ctx, ctx_null, lat0 * sched.init_noise_sigma, generator=torch.Generator(device=dev).manual_seed(0),
                    callback=on_step, logging_file=density,
                    **{k: v for k, v in kw.items() if k != "fps"})
            else:
                generate = lambda on_step: pipe.generate_latents(ctx, ctx_null, seed=0, callback=on_step, **kw)
            kinds = ("none", "band_sink")
            r = drive_pipeline(f"Cosmos 7B x {cfg.num_layers} layers ({label})",
                               f"{run.height}x{run.width}x{run.num_frames} (S={lay.seq_len}), EDM Euler, CFG batch 2",
                               kw, run.pattern, sched.timesteps, cfg.num_layers, generate, shape, kinds, sap=run.sap,
                               sap_streams=1, rope=False)
            launches.update({k: v for k, v in r["launches"].items() if v})
            launches.update({k: v for k, v in r["kind_launches"].items() if v})
            n_dense = cosmos_dense_steps(dataclasses.replace(run, model=cfg), steps)
            per_step[label] = (r["per_step_s"], n_dense)
            if run.pattern == "SAP":
                rows = [json.loads(line) for line in open(density)]
                log("cosmos", f"{label}: SAP density by (step, layer) "
                              f"{[round(x['avg_density'], 4) for x in rows]} (organic, gain {COSMOS_SAP_GAIN})")
                if not rows or not all(0 < x["avg_density"] <= 1 for x in rows):
                    raise AssertionError(f"Cosmos {label}: no SAP density logged, or one out of (0, 1]")
            lat = r["latents"]
        del model
        torch.cuda.empty_cache()
        vae = _timed(stages, "VAE set-up (CV8x8x8, full width, f32)",
                     lambda: CosmosVAE(COSMOS_VAE_CV8x8x8, device=dev).init_random(g))
        decode = make_vae_decoder(args, vae, logging.getLogger("chip_smoke"))
        torch.backends.cudnn.allow_tf32 = True
        try:
            video = _timed(stages, f"VAE decode {COSMOS_DECODE_FRAMES} of {lat.shape[2]} latent frames (CLI default: "
                                   "tiled, TF32)", lambda: decode(lat[:, :, :COSMOS_DECODE_FRAMES]))
        finally:
            torch.backends.cudnn.allow_tf32 = False
        path = os.path.join(tmp, "cosmos.y4m")
        export_video(video, path, fps=args.fps)
        frames, fps = read_y4m(path)
    for name, (ms, gib) in stages.items():
        log("cosmos", f"{name}: {ms:.1f} ms, peak {gib:.2f} GiB")
    dense_s = float(np.median(per_step["dense"][0][1:]))
    for label, (steps_s, n_dense) in per_step.items():
        sparse = steps_s[n_dense:][1:] if label.startswith("SAP") else steps_s[n_dense:]
        sparse_s = float(np.median(sparse)) if sparse else dense_s
        run = COSMOS_PRESETS[{"dense": "cosmos-704p-dense", "SVG": "cosmos-704p-svg", "SAP": "cosmos-704p-sap",
                              "SAP tile": "cosmos-704p-sap-tile"}[label]]
        n35 = 35 if run.pattern == "dense" else cosmos_dense_steps(run, 35)
        proj = (n35 * dense_s + (35 - n35) * sparse_s) * 28 / cfg.num_layers
        log("cosmos", f"{label}: s a step {[round(x, 4) for x in steps_s]} ({n_dense} dense; the first includes the "
                      f"set-up); a 35-step, 28-layer DiT projects to {proj:.1f} s ({n35} dense steps at {dense_s:.4f} "
                      f"s, {35 - n35} at {sparse_s:.4f} s, x 28 / {cfg.num_layers} layers)")
    n_frames = 1 + 8 * (COSMOS_DECODE_FRAMES - 1)
    log("cosmos", f"frames {frames.shape} at {fps} fps, mean {frames.mean():.2f}, std {frames.std():.2f}")
    if frames.shape != (n_frames, dense_run.height, dense_run.width, 3) or fps != args.fps or frames.std() == 0 or \
            not torch.isfinite(video).all():
        raise AssertionError(f"prompt -> video: frames {frames.shape} at {fps} fps, std {frames.std()}")
    del vae, video, lat
    torch.cuda.empty_cache()
    return dict(launches)


def phase_small_cosmos_cog_reference(dev):
    """Small T5 v1.0 and v1.1, the CogVideoX VAE, the Cosmos DiT and the
    Cosmos VAE on the card against the same modules on the CPU (same weights
    and inputs): T5 in f32 within UMT5_TOL; the VAEs in f32 (decode, encode)
    within VAE_TOL; the CLI's small Cosmos (bf16) over a CFG batch of 2 for
    dense, SVG1 (the same profiler rows) and SAP at full density (the two
    devices' k-means may split near-ties differently; at full density the
    output does not depend on the clustering), rel L2 3e-2."""
    from sparse_videogen_tpu_torch.cli.cog_i2v import SMOKE_VAE_CFG as COG_VAE
    from sparse_videogen_tpu_torch.cli.cosmos_t2v import SMOKE_CFG, SMOKE_VAE_CFG
    from sparse_videogen_tpu_torch.config import SAPConfig
    from sparse_videogen_tpu_torch.models.cog.vae import CogVAE, CogVAEConfig
    from sparse_videogen_tpu_torch.models.common.t5 import T5Config, T5Encoder
    from sparse_videogen_tpu_torch.models.cosmos.model import CosmosConfig, CosmosModel
    from sparse_videogen_tpu_torch.models.cosmos.vae import CosmosVAE, CosmosVAEConfig
    from sparse_videogen_tpu_torch.pipelines.cosmos import cosmos_layout, make_cosmos_runtime

    g = torch.Generator().manual_seed(6)
    for name, kw in (("T5 v1.0 (ReLU)", TINY_COSMOS_T5), ("T5 v1.1 (gated GELU)", TINY_COG_T5)):
        cfg = T5Config(vocab_size=300, **kw)
        cpu = T5Encoder(cfg, dtype=torch.float32).init_random(g)
        gpu = T5Encoder(cfg, dtype=torch.float32, device=dev)
        gpu.load_state_dict(cpu.state_dict())
        ids = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
        mask = (torch.arange(64)[None] < torch.tensor([[40], [64]])).int()
        a, b = gpu(ids, mask).cpu(), cpu(ids, mask)
        rel = ((a - b).norm() / b.norm()).item()
        log("small", f"{name} (2 layers, dim {cfg.dim}) card vs CPU, f32: rel L2 {rel:.3e} (tol {UMT5_TOL})")
        if not rel <= UMT5_TOL:
            raise AssertionError(f"{name} on the card disagrees with the CPU: {rel}")
    for name, vae_cpu, z, video in (
            ("CogVideoX VAE", CogVAE(CogVAEConfig(**COG_VAE)), torch.randn(1, 16, 3, 12, 16, generator=g),
             torch.rand(1, 3, 9, 96, 128, generator=g) * 2 - 1),
            ("Cosmos VAE", CosmosVAE(CosmosVAEConfig(**SMOKE_VAE_CFG)), torch.randn(1, 16, 3, 8, 12, generator=g),
             torch.rand(1, 3, 17, 64, 96, generator=g) * 2 - 1)):
        vae_cpu.init_random(g)
        vae_gpu = type(vae_cpu)(vae_cpu.cfg, device=dev)
        vae_gpu.load_state_dict(vae_cpu.state_dict())
        for what, a, b in (("decode", vae_gpu.decode(z.to(dev)), vae_cpu.decode(z)),
                           ("encode", vae_gpu.encode(video.to(dev)), vae_cpu.encode(video))):
            rel = ((a.cpu() - b).norm() / b.norm()).item()
            log("small", f"{name} {what} card vs CPU, f32: rel L2 {rel:.3e} (tol {VAE_TOL})")
            if not rel <= VAE_TOL:
                raise AssertionError(f"the {name} {what} on the card disagrees with the CPU: {rel}")
    cfg = CosmosConfig(**SMOKE_CFG)
    cpu_model = CosmosModel(cfg, dtype=torch.bfloat16).init_random(g)
    gpu_model = CosmosModel(cfg, dtype=torch.bfloat16, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    lay = cosmos_layout(cfg, 128, 128, 17)
    rows = torch.randint(0, lay.seq_len, (cfg.num_layers, 64), generator=g)
    sap = SAPConfig(num_q_centroids=8, num_k_centroids=12, kmeans_iter_init=8, top_p_kmeans=1.0, min_kc_ratio=1.0)
    x = torch.randn(2, 16, lay.num_frames, 16, 16, generator=g).to(torch.bfloat16)
    ctx = torch.randn(2, 24, cfg.text_embed_dim, generator=g).to(torch.bfloat16)
    t = torch.full((2,), -0.5)
    for pattern in ("dense", "SVG", "SAP"):
        outs = []
        for model, d in ((gpu_model, dev), (cpu_model, torch.device("cpu"))):
            rt = make_cosmos_runtime(lay, device=d, pattern=pattern, sap=sap)
            outs.append(model(x.to(d), t.to(d), ctx.to(d), attention=rt, profile_rows=rows,
                              generator=torch.Generator(device=d).manual_seed(0)).float().cpu())
        rel = ((outs[0] - outs[1]).norm() / outs[1].norm()).item()
        log("small", f"small Cosmos forward, {pattern}: kernels on the card vs plain on the CPU, rel L2 err "
                     f"{rel:.3e} (tol 3e-2)")
        if not rel <= 3e-2:
            raise AssertionError(f"small Cosmos forward ({pattern}) disagrees with the CPU reference: {rel}")


def _start_clis(runs, tmp):
    """Start every CLI run of `runs` ([(label, argv)]) at once, each its own
    process with its output in a file under tmp (they share the card; their
    start-up, ~8 s each, overlaps). Returns {label: (process, log, start)}."""
    procs = {}
    for label, argv in runs:
        out = open(os.path.join(tmp, f"{label}.log"), "w")
        procs[label] = (subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT, stdout=out, stderr=subprocess.STDOUT),
                        out, time.perf_counter())
    return procs


def _wait_clis(procs, kill=False):
    """Wait for (or, with kill, stop) the runs of _start_clis and fail on any
    non-zero exit with its output's tail. Returns {label: seconds}."""
    secs, failed = {}, []
    for label, (proc, out, t0) in procs.items():
        if kill:
            proc.kill()
        try:
            rc = proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        out.close()
        secs[label] = time.perf_counter() - t0
        if rc != 0 and not kill:
            with open(out.name) as f:
                failed.append(f"{label} exited {rc}:\n" + "".join(f.readlines()[-20:]))
    if failed:
        raise AssertionError("CLI runs failed:\n" + "\n".join(failed))
    return secs


def phase_cli_start():
    """The CLIs as a user runs them, all started together: --smoke for each
    pattern (latents to an .npz) of Wan T2V and I2V, HunyuanVideo T2V and
    Cosmos (SVG, dense, SAP, and SAP with --sap_block_mode tile),
    HunyuanVideo I2V (sparse, dense) and CogVideoX (SVG, dense); the Wan
    T2V, HunyuanVideo T2V, CogVideoX and Cosmos smokes with a video name
    (their tiny random VAEs, to a .y4m); CogVideoX from examples/1/image.jpg
    and Cosmos from the prompt on tiny checkpoint dirs (write_tiny_cog_
    checkpoint, write_tiny_cosmos_checkpoint: T5 in HF's names) to a .y4m; the Wan T2V CLI on a checkpoint dir (write_tiny_checkpoint)
    from the prompt to a .y4m; the Wan I2V CLI on an I2V checkpoint dir
    (write_tiny_checkpoint(i2v=True): the VAE's encoder, a CLIP tower in HF's
    names) from examples/1/image.jpg and the prompt to a .y4m (480p fits the
    image to 480x832; 5 frames, 2 steps); the HunyuanVideo T2V CLI on
    write_tiny_hyvideo_checkpoint's dir (tokenizer.json files written by
    hand) and the I2V CLI on its Llava I2V dir with examples/1/image.jpg,
    each at 64x64x5, 2 steps, to a .y4m.
    Returns finish(kill=False): it waits for the runs (or stops them) and
    checks their outputs; the caller runs other work meanwhile."""
    from sparse_videogen_tpu_torch.io.native import read_y4m

    prompt = "a cat on the grass."
    smokes = [(cli, p) for cli in ("wan_t2v", "wan_i2v", "hyvideo_t2v", "cosmos_t2v")
              for p in ("SVG", "dense", "SAP", "SAP-tile")]
    smokes += [("cog_i2v", p) for p in ("SVG", "dense")] + [("hyvideo_i2v", p) for p in ("sparse", "dense")]
    pattern_args = lambda p: ["--pattern", "SAP", "--sap_block_mode", "tile"] if p == "SAP-tile" else ["--pattern", p]
    tmpdir = tempfile.TemporaryDirectory(dir=ROOT)
    tmp = tmpdir.name
    write_tiny_checkpoint(os.path.join(tmp, "ckpt"), prompt)
    write_tiny_checkpoint(os.path.join(tmp, "ckpt_i2v"), prompt, i2v=True)
    write_tiny_hyvideo_checkpoint(os.path.join(tmp, "hy_ckpt"), prompt)
    write_tiny_hyvideo_checkpoint(os.path.join(tmp, "hy_ckpt_i2v"), prompt, i2v=True)
    write_tiny_cog_checkpoint(os.path.join(tmp, "cog_ckpt"), prompt)
    write_tiny_cosmos_checkpoint(os.path.join(tmp, "cosmos_ckpt"), prompt)
    hy_size = ["--height", "64", "--width", "64", "--num_frames", "5", "--num_inference_steps", "2"]
    out = lambda label, ext: os.path.join(tmp, f"{label}.{ext}")
    runs = [(f"{cli}_{p}", [f"sparse_videogen_tpu_torch.cli.{cli}", "--smoke", *pattern_args(p), "--device", "cuda",
                            "--output_path" if cli == "cog_i2v" else "--output_file", out(f"{cli}_{p}", "npz")])
            for cli, p in smokes]
    videos = {"wan_t2v --smoke, a video name": ("t2v_smoke", ["wan_t2v", "--smoke"], (9, 96, 128, 3)),
              "wan_t2v --model_dir (tiny synthetic checkpoint)": (
                  "t2v_ckpt", ["wan_t2v", "--model_dir", os.path.join(tmp, "ckpt"), "--prompt", prompt, "--height",
                               "96", "--width", "128", "--num_frames", "9", "--num_inference_steps", "2"],
                  (9, 96, 128, 3)),
              "wan_i2v --model_dir (tiny synthetic I2V checkpoint) --image_path examples/1/image.jpg": (
                  "i2v_ckpt", ["wan_i2v", "--model_dir", os.path.join(tmp, "ckpt_i2v"), "--image_path",
                               os.path.join(ROOT, "examples", "1", "image.jpg"), "--prompt", prompt,
                               "--resolution", "480p", "--num_frames", "5", "--num_inference_steps", "2"],
                  (5, 480, 832, 3)),
              "hyvideo_t2v --smoke, a video name": ("hy_t2v_smoke", ["hyvideo_t2v", "--smoke"], (9, 96, 128, 3)),
              "hyvideo_t2v --model_dir (tiny synthetic checkpoint, tokenizer.json files by hand)": (
                  "hy_t2v_ckpt", ["hyvideo_t2v", "--model_dir", os.path.join(tmp, "hy_ckpt"), "--prompt", prompt,
                                  *hy_size], (5, 64, 64, 3)),
              "hyvideo_i2v --model_dir (tiny synthetic Llava I2V checkpoint) --image_path examples/1/image.jpg": (
                  "hy_i2v_ckpt", ["hyvideo_i2v", "--model_dir", os.path.join(tmp, "hy_ckpt_i2v"), "--image_path",
                                  os.path.join(ROOT, "examples", "1", "image.jpg"), "--prompt", prompt, *hy_size],
                  (5, 64, 64, 3)),
              "cog_i2v --smoke, a video name": ("cog_smoke", ["cog_i2v", "--smoke"], (17, 96, 128, 3)),
              "cosmos_t2v --smoke, a video name": ("cosmos_smoke", ["cosmos_t2v", "--smoke"], (17, 128, 128, 3)),
              "cog_i2v --model_dir (tiny synthetic checkpoint, T5 in HF's names) --image_path "
              "examples/1/image.jpg": (
                  "cog_ckpt", ["cog_i2v", "--model_dir", os.path.join(tmp, "cog_ckpt"), "--image_path",
                               os.path.join(ROOT, "examples", "1", "image.jpg"), "--prompt", prompt, "--height", "96",
                               "--width", "128", "--num_frames", "9", "--num_step", "2"], (9, 96, 128, 3)),
              "cosmos_t2v --model_dir (tiny synthetic checkpoint, T5 in HF's names)": (
                  "cosmos_ckpt", ["cosmos_t2v", "--model_dir", os.path.join(tmp, "cosmos_ckpt"), "--prompt", prompt,
                                  "--height", "64", "--width", "64", "--num_frames", "9", "--num_inference_steps",
                                  "2"], (9, 64, 64, 3))}
    for label, argv, _ in videos.values():
        runs.append((label, [f"sparse_videogen_tpu_torch.cli.{argv[0]}", *argv[1:], "--device", "cuda",
                             "--output_path" if argv[0] == "cog_i2v" else "--output_file", out(label, "y4m")]))
    t0 = time.perf_counter()
    procs = _start_clis(runs, tmp)

    def finish(kill=False):
        try:
            secs = _wait_clis(procs, kill=kill)
            if kill:
                return
            log("cli", f"{len(runs)} CLI runs started together, all done in {time.perf_counter() - t0:.1f} s")
            for cli, pattern in smokes:
                label = f"{cli}_{pattern}"
                lat = np.load(out(label, "npz"))["latents"]
                finite = bool(np.isfinite(lat).all())
                log("cli", f"{cli} --smoke {' '.join(pattern_args(pattern))}: {label}.npz exists, latents {lat.shape} "
                           f"finite {finite} (done within {secs[label]:.1f} s of the start)")
                if not finite:
                    raise AssertionError(f"CLI smoke ({cli} {pattern}) wrote non-finite latents")
            for what, (label, _, shape) in videos.items():
                frames, fps = read_y4m(out(label, "y4m"))
                log("cli", f"{what}: frames {frames.shape} at {fps} fps, mean {frames.mean():.2f}, std "
                           f"{frames.std():.2f} (done within {secs[label]:.1f} s of the start)")
                if frames.shape != shape or frames.std() == 0:
                    raise AssertionError(f"{what}: frames {frames.shape}, std {frames.std()}")
        finally:
            tmpdir.cleanup()

    return finish


def in_thread(fn):
    """Start fn() in a daemon thread; returns a join that re-raises its error."""
    box = {}

    def body():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised by the join
            box["err"] = e

    t = threading.Thread(target=body, daemon=True)
    t.start()

    def join():
        t.join()
        if "err" in box:
            raise box["err"]
        return box.get("out")

    return join


def main():
    t_start = time.perf_counter()
    phase_device()
    dev = torch.device("cuda", 0)
    # the prompt extender's LM launches no kernel of the port: it runs on the
    # card while nvcc builds the kernels on the host
    extend = in_thread(lambda: phase_prompt_extend(dev))
    phase_build()
    extend()
    marks = [("build", time.perf_counter())]
    log("time", f"build, the prompt_extend phase beside it: {marks[0][1] - t_start:.1f} s")

    def done(name):
        marks.append((name, time.perf_counter()))
        log("time", f"{name}: {marks[-1][1] - marks[-2][1]:.1f} s")

    kernels = {"rope": phase_rope(dev), "block_sparse_attn": phase_attention(dev),
               "block_sparse_attn_runs": phase_sap_attention(dev), "kmeans_wide": phase_kmeans(dev),
               "kmeans_variants": phase_variants(dev), "block_sparse_attn[hyvideo]": phase_hyvideo_attention(dev),
               "rmsnorm": phase_rmsnorm(dev), "dense_qsplit": phase_qsplit(dev),
               "layernorm_mod": phase_layernorm_mod(dev), "qk_norm_rope": phase_qk_norm_rope(dev),
               "block_sparse_attn[cog]": phase_cog_attention(dev)}
    kernels["rope"]["d64"] = phase_cog_rope(dev)
    # Wan I2V 14B at 720p: 40 heads, frame size 3,555 (not a multiple of 128), S = 74,655
    phase_rope(dev, "14B-i2v-720p-svg")
    phase_attention(dev, "14B-i2v-720p-svg")
    kernels["block_sparse_attn[band_sink_perm]"] = phase_inplace_svg1(dev)
    kernels["block_sparse_attn_runs[stats]"] = phase_stats(dev)
    phase_sap_attention(dev, "14B-720p-sap", all_checks=False)
    # Cosmos 704x1280x121: 64 rows, frame size 3,520 (not a multiple of 128), S = 56,320
    kernels["block_sparse_attn[cosmos]"] = phase_cosmos_attention(dev)
    kernels["block_sparse_attn_runs"]["cosmos"] = phase_sap_attention(dev, "cosmos-704p-sap", all_checks=False)
    done("kernels")
    # SAP's tile mode on K1 (Wan 1.3B 480p, 14B 720p at QC 300 / KC 1000) and
    # HunyuanVideo's text-last SAP on K3 and K1
    tile = kernels["block_sparse_attn[none, SAP tile]"] = phase_sap_tile_attention(dev)
    tile["14B-720p"] = phase_sap_tile_attention(dev, "14B-720p-sap", check_blocks=CHECK_BLOCKS)
    hy = phase_hyvideo_sap_attention(dev)
    kernels["block_sparse_attn_runs"]["hyvideo_text_last"], tile["hyvideo_text_last"] = hy["cluster"], hy["tile"]
    done("sap kernels")
    launches = phase_slice(dev)
    launches["block_sparse_attn[none, SAP tile]"] = launches["block_sparse_attn[none]"]  # the Wan 1.3B tile run's
    done("slice")
    kernels["block_sparse_attn[stats]"], ring_launches = phase_ring(dev)
    launches.update(ring_launches)
    done("ring")
    for counts in (phase_probe(dev), phase_slice_14b(dev), phase_kernel_probes(dev)):
        for name, n in counts.items():
            launches.setdefault(name, n)
    done("14B slice and probes")
    launches["block_sparse_attn[hyvideo]"], hy_sap = phase_hyvideo_slice(dev)
    tile["hyvideo_launches"] = hy_sap["tile"]["kind_launches"]["block_sparse_attn[none]"]
    kernels["block_sparse_attn_runs"]["hyvideo_launches"] = hy_sap["cluster"]["launches"]["block_sparse_attn_runs"]
    done("hyvideo slice")
    launches["block_sparse_attn[cog]"], launches["rope"] = phase_cog_slice(dev)
    done("cog slice")
    phase_quant(dev)
    phase_dpm(dev)
    done("quant and dpm")
    phase_ulysses(dev)
    done("ulysses")
    phase_fsdp(dev)
    phase_timer(dev)
    done("fsdp and timer")
    umt5_s, mp4_check = phase_prompt_to_video(dev)
    done("p2v")
    phase_i2v(dev, umt5_s)
    done("i2v")
    # the p2v .mp4's CPU encode and read-back (host cores) beside the phases
    # that keep the card busiest; i2v's host-side read of its image runs alone
    mp4_check = in_thread(mp4_check)
    encoders = phase_hy_p2v(dev)
    done("hy_p2v")
    phase_hy_i2v(dev, encoders)
    done("hy_i2v")
    phase_cog_i2v(dev)
    done("cog_i2v")
    cosmos_launches = phase_cosmos(dev)
    launches["block_sparse_attn[cosmos]"] = sum(n for k, n in cosmos_launches.items()
                                               if k in ("block_sparse_attn[none]", "block_sparse_attn[band_sink]"))
    done("cosmos")
    # the CLI runs (their own processes, mostly start-up on the host) run
    # beside the quality and small-reference phases
    finish_cli = phase_cli_start()
    try:
        phase_quality(dev)
        done("quality, the CLI runs beside it")
        phase_small_reference(dev)
        phase_small_hyvideo_reference(dev)
        phase_small_cog_reference(dev)
        phase_small_text_vae_reference(dev)
        phase_small_i2v_reference(dev)
        phase_small_hy_reference(dev)
        phase_small_cosmos_cog_reference(dev)
        done("small references")
    except BaseException:
        finish_cli(kill=True)
        raise
    finish_cli()
    done("cli")
    mp4_check()
    done("the p2v .mp4's CPU encode and read-back (begun after i2v)")
    log("done", f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
