"""The ring's ranks (counterpart of sparse_videogen_tpu/parallel/mesh.py,
its `rp` axis only).

`make_mesh(rp)` returns the rank group a ring runtime drives
(parallel/comm.py) under `torchrun --nproc_per_node rp`: this process's
rank of a torch.distributed group set up from torchrun's environment. All
rp ranks as threads of one process (one card, or the CPU) are
`comm.ThreadRanks(rp)`. The JAX mesh's dp and sp (Ulysses) axes are not
ported.
"""

from __future__ import annotations

import os

import torch

from sparse_videogen_tpu_torch.parallel.comm import DistComm, ProcessRanks


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


def make_mesh(rp: int, *, device_type: str = "cuda") -> ProcessRanks:
    """This process's rank of the torchrun group, which must have rp ranks."""
    comm = init_process_group(device_type)
    if comm.size != rp:
        raise ValueError(f"ring degree {rp} needs {rp} processes (torchrun --nproc_per_node {rp}), got {comm.size}")
    return ProcessRanks(comm)
