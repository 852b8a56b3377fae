"""sparse_videogen_tpu_torch — the PyTorch/CUDA port of sparse_videogen_tpu
for one NVIDIA H100 (Hopper, sm_90a).

The JAX package beside it is the reference: every module here mirrors the
JAX module at the same path, and the tests feed both the same numpy inputs.
This package imports torch, numpy and the standard library, and of the JAX
package only its jax-free `config` and the Wan CLI's argument parser.

Layering (bottom-up):
  csrc/       hand-written Hopper kernels (CUDA C++), built by _kernels.py
  ops/        kernel wrappers + their plain PyTorch versions, mask
              predicates, chunked-CSR metadata
  core/       SVG1 mask math, online profiler, per-head placement
  sparse/     SVG1 plan and the dense / SVG1 self-attention runtimes
  models/     Wan 2.1 DiT (nn.Module)
  schedulers/ FlowUniPC
  pipelines/  Wan T2V generation pipeline
  io/         JAX param pytree -> state_dict
  cli/        wan_t2v entry point

On a CUDA tensor every kernel wrapper launches its kernel or raises; the
plain version runs only for tensors on the CPU.
"""

__version__ = "0.1.0"
