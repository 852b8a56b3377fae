"""The attention runtime of a pattern on one device or a rank group: the
one place that builds a runtime of sparse/runtimes.py, parallel/ring_runtime.py
or parallel/ulysses.py, with the JAX package's composition rules
(its parallel.parallelize_runtime and pipelines' make_*_runtime)."""

from __future__ import annotations

from sparse_videogen_tpu_torch.config import SAPConfig, SparseMode, TextPosition, WarmupSchedule
from sparse_videogen_tpu_torch.parallel.ring_runtime import RingDenseRuntime, RingSAPRuntime
from sparse_videogen_tpu_torch.parallel.ulysses import UlyssesRuntime, UlyssesSAPRuntime
from sparse_videogen_tpu_torch.sparse.runtimes import DenseRuntime, SAPRuntime, SVG1Runtime
from sparse_videogen_tpu_torch.sparse.svg1 import SVG1Plan
from sparse_videogen_tpu_torch.sparse.svg2 import check_sap_config


def make_runtime(plan: SVG1Plan, pattern: str, *, device, sap: SAPConfig | None = None,
                 warmup: WarmupSchedule | None = None, mesh=None, prompt_length: int | None = None):
    """The runtime of `pattern` ("dense", "SVG" or "SAP") over `plan` for
    `mesh`, a rank group (parallel/mesh.make_mesh, parallel/comm.ThreadRanks)
    or None. Its ring (rp > 1) runs dense, and SAP on a video-only layout,
    with the heads over sp (USP); its head axis alone (sp > 1) runs every
    pattern. Text-first SAP (CogVideoX) raises NotImplementedError.
    prompt_length: the dense and SVG1 runtimes' live text (None: the
    layout's context_length, which SAP's dense warm-up always takes)."""
    mode = SparseMode(pattern)
    if mode == SparseMode.SAP:
        check_sap_config(sap, plan.layout)
    rp, sp = (1, 1) if mesh is None else (mesh.rp, mesh.sp)
    if rp > 1:
        if mode == SparseMode.DENSE:
            return RingDenseRuntime(plan, mesh, device=device, prompt_length=prompt_length)
        if mode == SparseMode.SAP and plan.layout.text_position == TextPosition.NONE:
            return RingSAPRuntime(plan, sap, warmup, mesh, device=device)
        raise ValueError(f"pattern={pattern} on a layout with text_position={plan.layout.text_position.value} does "
                         "not compose with ring_degree>1; use --ulysses_degree (head sharding)")
    if mode == SparseMode.SAP:
        return SAPRuntime(plan, sap, warmup, device=device) if sp == 1 else UlyssesSAPRuntime(
            plan, sap, warmup, mesh, device=device)
    rt = (DenseRuntime if mode == SparseMode.DENSE else SVG1Runtime)(plan, device=device, prompt_length=prompt_length)
    return rt if sp == 1 else UlyssesRuntime(rt, mesh)
