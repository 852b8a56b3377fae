"""The CLIs' parallelism flags (counterpart of
sparse_videogen_tpu/cli/_parallel.py): --dp, --ring_degree and
--ulysses_degree make the dp x rp x sp rank grid, one process a rank under
torchrun (NCCL across cards, gloo with --device cpu), through
parallel/mesh.make_mesh; rank 0 writes. A grid of more than one rank
shards the DiT's weights (FSDP, parallel/sharding.py), and --dit_fsdp alone
puts every rank of the torchrun world on dp; outside torchrun that is one
rank, which runs unsharded (the JAX CLIs' n = dp = len(jax.devices())).
As in the JAX package, each dp rank computes the whole CFG batch."""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("sparse_videogen_tpu_torch")


def add_parallel_flags(p, *, dp: bool = False):
    if dp:
        p.add_argument("--dp", type=int, default=1,
                       help="data-parallel degree: more ranks to shard the weights over, under torchrun")
    p.add_argument("--ulysses_degree", type=int, default=1,
                   help="head-sharded sequence parallelism (all patterns), under torchrun")
    p.add_argument("--ring_degree", type=int, default=1,
                   help="ring/context parallelism over tokens (dense/SAP where supported), under torchrun")
    p.add_argument("--dit_fsdp", action="store_true",
                   help="shard DiT weights over all ranks (FSDP analog; every torchrun rank on dp)")
    return p


def make_cli_mesh(args, device):
    """(mesh, device): the dp x rp x sp rank group of --dp x --ring_degree x
    --ulysses_degree under torchrun (None for a single rank) and this rank's
    device (cuda:LOCAL_RANK on cards). --dit_fsdp with no other degree puts
    every rank of the torchrun world on dp (outside torchrun: one rank)."""
    dp, rp, sp = getattr(args, "dp", 1), args.ring_degree, args.ulysses_degree
    if dp * rp * sp <= 1:
        if not args.dit_fsdp:
            return None, device
        if "WORLD_SIZE" not in os.environ:
            logger.info("--dit_fsdp outside torchrun: one rank, the weights stay whole")
            return None, device
        dp = int(os.environ["WORLD_SIZE"])
    import torch

    from sparse_videogen_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(rp, sp, dp=dp, device_type=device.type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    logger.info(f"mesh dp={dp} x rp={rp} x sp={sp} over {mesh.size} processes; this is rank {mesh.rank}")
    return mesh, device


def shard_cli_model(mesh, model):
    """FSDP-shard the DiT over the grid when it holds more than one rank
    (after --quant, as the JAX CLIs quantize before they shard)."""
    if mesh is None or mesh.size == 1:
        return model
    from sparse_videogen_tpu_torch.parallel.sharding import shard_params

    sharded = shard_params(model, mesh)
    logger.info(f"DiT weights FSDP-sharded over {mesh.size} ranks: {len(sharded.plan)} tensors; rank {mesh.rank} "
                f"keeps {sharded.resident_bytes(mesh.rank) / 2**20:.1f} MiB")
    return sharded


def close_mesh(mesh) -> int:
    """Leave the process group; returns this process's rank (0 without a mesh)."""
    if mesh is None:
        return 0
    import torch.distributed as dist

    dist.destroy_process_group()
    return mesh.rank
