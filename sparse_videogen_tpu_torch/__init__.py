"""sparse_videogen_tpu_torch — the PyTorch/CUDA port of sparse_videogen_tpu
for one NVIDIA H100 (Hopper, sm_90a).

The JAX package beside it is the reference: every module here mirrors the
JAX module at the same path, and the tests feed both the same numpy inputs.
This package imports torch, numpy and the standard library (triton only
inside the launch of its Triton kernel), and no module of the JAX package:
it keeps its own copy of what it needs (config, CLI flags, density log).

Layering (bottom-up):
  csrc/       hand-written Hopper kernels (CUDA C++, built by _kernels.py;
              one Triton source, compiled at its first launch)
  ops/        kernel wrappers + their plain PyTorch versions, mask
              predicates, chunked-CSR and run-list metadata
  core/       SVG1 mask math, online profiler, placement; SAP k-means,
              dynamic map, permutations
  sparse/     SVG1 plan and the dense / SVG1 / SAP self-attention runtimes
  models/     Wan 2.1, HunyuanVideo, CogVideoX and Cosmos DiTs, their VAEs,
              the text and image encoders (nn.Module)
  schedulers/ FlowUniPC, FlowMatchEuler, CogDDIM, EDMEuler
  pipelines/  Wan, HunyuanVideo, CogVideoX and Cosmos generation pipelines
  io/         checkpoints, tokenizers, images and videos; JAX param pytrees
              -> the port's modules
  cli/        wan_t2v, wan_i2v, hyvideo_t2v, hyvideo_i2v, cog_i2v and
              cosmos_t2v entry points
  scripts/    profiles and kernel probes for the card

On a CUDA tensor every kernel wrapper launches its kernel or raises; the
plain version runs only for tensors on the CPU.
"""

__version__ = "0.1.0"
