"""The ranks of the ring and head axes (counterpart of
sparse_videogen_tpu/parallel/mesh.py, its rp and sp axes; dp stays 1).

`make_mesh(rp, sp)` returns the rank group the parallel runtimes drive
(parallel/comm.py) under `torchrun --nproc_per_node rp*sp`: this process's
rank of a torch.distributed group set up from torchrun's environment, with
a subgroup (`dist.new_group`) for its ring (the ranks of its head index)
and one for its head group (the ranks of its ring index). Global rank
g = i * sp + j, the head axis fastest, as the JAX mesh lays out its
devices. All ranks as threads of one process (one card, or the CPU) are
`comm.ThreadRanks(rp, sp)`. The dp axis and FSDP (sharding.py) are not
ported.
"""

from __future__ import annotations

import os

import torch

from sparse_videogen_tpu_torch.parallel.comm import DistComm, LocalComm, ProcessRanks


def init_process_group(device_type: str) -> DistComm:
    """Join the process group torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL with one card a rank
    (cuda:LOCAL_RANK becomes the current device) or gloo on the CPU. A
    process already in a group keeps it."""
    import torch.distributed as dist

    if not dist.is_initialized():
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(f"no process group: run under torchrun (missing {', '.join(missing)})")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
                                rank=rank, world_size=world)
    return DistComm()


def make_mesh(rp: int = 1, sp: int = 1, *, device_type: str = "cuda") -> ProcessRanks:
    """This process's rank of the torchrun group, which must have rp * sp
    ranks: its communicator over the ring (rp) and over its head group (sp).
    Every process creates every subgroup, in the same order, as
    torch.distributed requires."""
    import torch.distributed as dist

    world = init_process_group(device_type)
    if world.size != rp * sp:
        raise ValueError(f"ring degree {rp} x Ulysses degree {sp} needs {rp * sp} processes (torchrun "
                         f"--nproc_per_node {rp * sp}), got {world.size}")
    i, j = divmod(world.rank, sp)
    if sp == 1:
        return ProcessRanks(world, rank=world.rank, rp=rp, sp=1)
    rings = [dist.new_group([a * sp + b for a in range(rp)]) for b in range(sp)] if rp > 1 else None
    heads = [dist.new_group([a * sp + b for b in range(sp)]) for a in range(rp)]
    comm = DistComm(rings[j]) if rings else LocalComm()
    comm.heads = DistComm(heads[i])
    return ProcessRanks(comm, rank=world.rank, rp=rp, sp=sp)
