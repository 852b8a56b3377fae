"""The rank grid dp x rp x sp (counterpart of
sparse_videogen_tpu/parallel/mesh.py: data, ring and head axes).

`make_mesh(rp, sp, dp=dp)` returns the rank group the parallel runtimes
and FSDP drive (parallel/comm.py, parallel/sharding.py) under `torchrun
--nproc_per_node dp*rp*sp`: this process's rank of a torch.distributed
group set up from torchrun's environment, with a subgroup
(`dist.new_group`) for its ring (the ranks of its dp slice and head index)
and one for its head group (the ranks of its dp slice and ring index); the
default group spans every rank (`comm.world`, FSDP's gathers). Global rank
g = (d * rp + i) * sp + j, the head axis fastest, as the JAX mesh lays out
its devices. All ranks as threads of one process (one card, or the CPU)
are `comm.ThreadRanks(rp, sp, dp=dp)`.
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


def make_mesh(rp: int = 1, sp: int = 1, *, dp: int = 1, device_type: str = "cuda") -> ProcessRanks:
    """This process's rank of the torchrun group, which must have dp * rp *
    sp ranks: its communicator over the ring (rp), over its head group (sp)
    and over every rank. Every process creates every subgroup, in the same
    order, as torch.distributed requires."""
    import torch.distributed as dist

    world = init_process_group(device_type)
    n = dp * rp * sp
    if world.size != n:
        raise ValueError(f"dp {dp} x ring degree {rp} x Ulysses degree {sp} needs {n} processes (torchrun "
                         f"--nproc_per_node {n}), got {world.size}")
    d, rest = divmod(world.rank, rp * sp)
    i, j = divmod(rest, sp)
    at = lambda a, b, c: (a * rp + b) * sp + c  # noqa: E731 - the global rank of grid point (a, b, c)
    if dp == 1 and sp == 1:
        comm = world
    else:
        rings = [[dist.new_group([at(a, r, b) for r in range(rp)]) for b in range(sp)] for a in range(dp)] \
            if rp > 1 else None
        comm = DistComm(rings[d][j]) if rings else LocalComm()
    if sp > 1:
        heads = [[dist.new_group([at(a, r, b) for b in range(sp)]) for r in range(rp)] for a in range(dp)]
        comm.heads = DistComm(heads[d][i])
    comm.world = DistComm() if n > 1 else LocalComm()
    return ProcessRanks(comm, rank=world.rank, rp=rp, sp=sp, dp=dp)
