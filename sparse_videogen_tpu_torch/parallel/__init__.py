"""Parallelism (counterpart of sparse_videogen_tpu/parallel/): the
communicator (comm.py), torchrun's dp x rp x sp rank grid (mesh.py), the
dense and SAP rings (ring.py, ring_sap.py), their runtimes
(ring_runtime.py), Ulysses head sharding (ulysses.py), FSDP weight
sharding (sharding.py) and `parallelize_runtime`, which wraps a
single-device runtime for a rank group."""

from sparse_videogen_tpu_torch.config import SparseMode, TextPosition


def parallelize_runtime(rt, mesh, plan, *, device, pattern, sap=None, warmup=None, prompt_length=None):
    """Wrap a single-device attention runtime for `mesh` (a rank group of
    parallel/comm.py, or None): the ring over rp for dense and video-only
    SAP (with the heads split over sp: USP), Ulysses over sp alone for every
    pattern. The JAX package's composition rules and messages."""
    if mesh is None:
        return rt
    if mesh.rp > 1:
        from sparse_videogen_tpu_torch.parallel.ring_runtime import RingDenseRuntime, RingSAPRuntime

        mode = SparseMode(pattern)
        if mode == SparseMode.DENSE:
            return RingDenseRuntime(plan, mesh, device=device, prompt_length=prompt_length)
        if (mode == SparseMode.SAP and sap is not None and warmup is not None
                and plan.layout.text_position == TextPosition.NONE):
            return RingSAPRuntime(plan, sap, warmup, mesh, device=device)
        raise ValueError(f"pattern={pattern} does not compose with ring_degree>1 for this layout; use "
                         "--ulysses_degree (head sharding)")
    if mesh.sp > 1:
        from sparse_videogen_tpu_torch.parallel.ulysses import UlyssesRuntime

        return UlyssesRuntime(rt, mesh)
    return rt
