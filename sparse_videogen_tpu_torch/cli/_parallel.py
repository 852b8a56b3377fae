"""The CLIs' parallelism flags (counterpart of
sparse_videogen_tpu/cli/_parallel.py): --ulysses_degree and --ring_degree
run under torchrun, one process a rank (NCCL across cards, gloo with
--device cpu), through parallel/mesh.make_mesh; rank 0 writes. --dp > 1
and --dit_fsdp (data parallelism and FSDP weight sharding) raise."""

from __future__ import annotations

import logging

logger = logging.getLogger("sparse_videogen_tpu_torch")


def add_parallel_flags(p, *, dp: bool = False):
    if dp:
        p.add_argument("--dp", type=int, default=1, help="data-parallel degree (CFG pair / batch); not ported")
    p.add_argument("--ulysses_degree", type=int, default=1,
                   help="head-sharded sequence parallelism (all patterns), under torchrun")
    p.add_argument("--ring_degree", type=int, default=1,
                   help="ring/context parallelism over tokens (dense/SAP where supported), under torchrun")
    p.add_argument("--dit_fsdp", action="store_true",
                   help="shard DiT weights over all devices (FSDP analog); not ported")
    return p


def make_cli_mesh(args, device):
    """(mesh, device): the rp x sp rank group of --ring_degree x
    --ulysses_degree under torchrun (None for a single rank) and this rank's
    device (cuda:LOCAL_RANK on cards). --dp > 1 and --dit_fsdp raise
    NotImplementedError."""
    if getattr(args, "dp", 1) > 1 or args.dit_fsdp:
        raise NotImplementedError("--dp / --dit_fsdp (data parallelism and FSDP weight sharding, the JAX "
                                  "package's parallel/sharding.py) are not ported to the torch package yet "
                                  "(ROADMAP.md section 1)")
    rp, sp = args.ring_degree, args.ulysses_degree
    if rp * sp <= 1:
        return None, device
    import torch

    from sparse_videogen_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(rp, sp, device_type=device.type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    logger.info(f"mesh rp={rp} x sp={sp} over {mesh.size} processes; this is rank {mesh.rank}")
    return mesh, device


def close_mesh(mesh) -> int:
    """Leave the process group; returns this process's rank (0 without a mesh)."""
    if mesh is None:
        return 0
    import torch.distributed as dist

    dist.destroy_process_group()
    return mesh.rank
