"""FSDP weight sharding (counterpart of sparse_videogen_tpu/parallel/sharding.py).

The JAX package shards every large leaf of the DiT's parameter tree on its
largest divisible axis over all the mesh's devices and lets XLA all-gather
a weight next to each use; the reference does the same with torch FSDP
FULL_SHARD over blocks (wan_orig/distributed/fsdp.py). Here:

- `param_spec(shape, n)` is JAX's rule as a pure shape function. It decides
  on the JAX leaf's shape (blocks stacked on a leading layer axis, linears
  (in, out)), which `io/from_jax.jax_layout` gives for every torch tensor,
  so the same leaves shard, on the same axis, as in the JAX package.
- `shard_params(model, mesh)` keeps on each rank of the rank group `mesh`
  (parallel/comm.py: ThreadRanks or ProcessRanks) only its slice of every
  tensor the rule shards, parameters and buffers (utils/quant.py's int8 /
  fp8 weights and scales) alike; the module keeps an empty placeholder of
  the same dtype and device. Before a block of a stacked nn.ModuleList
  runs, its full tensors are all-gathered over `comm.world` and handed to
  the block through torch.func.functional_call (never written into the
  shared module: thread ranks share it); they are freed when the block
  returns. The tensors outside such blocks, and those of blocks that are
  not called but read (HunyuanVideo's token refiner), are gathered the
  same way around the model's call. An all-gather is exact, so the sharded
  model's outputs equal the unsharded model's bit for bit.

The forward itself runs once per process, as the ring and Ulysses runtimes
do: every dp rank computes the whole CFG batch (the JAX package does not
split the CFG pair over dp either).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.func import functional_call

from sparse_videogen_tpu_torch.io.from_jax import jax_layout

MIN_SIZE = 1 << 18  # JAX's shard_params leaves param_spec's default


def param_spec(shape, n, min_size: int = 1 << 18):
    """JAX's rule for a leaf of `shape` over a grid of `n` ranks (an int, or
    the grid's axis sizes, e.g. (dp, rp, sp)). Returns (axis, over), the
    axis to shard and the grid axes it is split over, or None to replicate:
    - a 2-D leaf with shape[0] >= shape[1] (a row-parallel linear) lowers
      the minimum to 1 << 15;
    - a leaf under the minimum stays whole;
    - a stacked leaf (ndim >= 3) never shards axis 0;
    - the largest axis divisible by the rank count is split over every grid
      axis, the last axis winning ties;
    - otherwise the first such axis divisible by one grid axis's size is
      split over that grid axis alone."""
    grid = (n,) if isinstance(n, int) else tuple(n)
    total = math.prod(grid)
    if len(shape) == 2 and shape[0] >= shape[1]:
        min_size = min(min_size, 1 << 15)
    if math.prod(shape) < min_size:
        return None
    cands = range(1, len(shape)) if len(shape) >= 3 else range(len(shape))
    order = sorted(cands, key=lambda i: (-shape[i], -i))
    for i in order:
        if shape[i] % total == 0:
            return i, tuple(range(len(grid)))
    for i in order:
        for a, size in enumerate(grid):
            if size > 1 and shape[i] % size == 0:
                return i, (a,)
    return None


def shard_plan(module: nn.Module, grid) -> dict:
    """name -> (torch axis, over, parts) for every tensor of `module` the
    rule shards over `grid`. A leaf that JAX would shard on its layer axis
    (no tensor axis holds it) raises ValueError."""
    plan = {}
    for name, (shape, axes) in jax_layout(module).items():
        spec = param_spec(shape, grid, MIN_SIZE)
        if spec is None:
            continue
        jaxis, over = spec
        if axes[jaxis] is None:
            raise ValueError(f"{name}: the JAX leaf {shape} shards on axis {jaxis}, which no axis of the tensor holds")
        plan[name] = (axes[jaxis], over, math.prod(grid[a] for a in over))
    return plan


def _coords(g: int, grid) -> tuple:
    """The grid point of global rank g (the last axis fastest)."""
    out = []
    for size in reversed(grid):
        g, c = divmod(g, size)
        out.append(c)
    return tuple(reversed(out))


def _part(g: int, grid, over) -> int:
    """Which of the leaf's parts rank g holds: its index over the axes `over`."""
    c = _coords(g, grid)
    idx = 0
    for a in over:
        idx = idx * grid[a] + c[a]
    return idx


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def plan_bytes(module: nn.Module, grid) -> dict:
    """Bytes without materializing anything (a module on the meta device
    will do): the whole model, its sharded tensors whole, and what one rank
    keeps (its slices and every replicated tensor)."""
    plan = shard_plan(module, grid)
    total = sharded = per_rank = 0
    for name, t in list(module.named_parameters()) + list(module.named_buffers()):
        b = _nbytes(t)
        total += b
        if name in plan:
            sharded += b
            per_rank += b // plan[name][2]
        else:
            per_rank += b
    return {"total": total, "sharded": sharded, "per_rank": per_rank}


class _ShardedBlock(nn.Module):
    """A called block of a stacked nn.ModuleList whose sharded tensors are
    gathered at each call. The block itself is held outside the module
    tree, so its placeholders are not parameters of the model."""

    def __init__(self, block: nn.Module, owner: "ShardedModel", prefix: str, names):
        super().__init__()
        self.__dict__["inner"] = block
        self.__dict__["_owner"] = owner
        self.prefix, self.names = prefix, list(names)

    def forward(self, *args, **kwargs):
        full = self._owner.gather(self.names)
        return functional_call(self.inner, {n[len(self.prefix):]: t for n, t in full.items()}, args, kwargs)


class ShardedModel:
    """`module` with its large tensors sharded over the rank group `mesh`
    (see the module docstring). Calling it calls the module; other attribute
    reads go to the module (its config, a placeholder's device and dtype).
    `shards[g]` holds rank g's slices for each rank this process holds,
    `plan` name -> (axis, over, parts), `units` the names gathered around
    the model's call ("") and each block's (by its prefix)."""

    def __init__(self, module: nn.Module, mesh):
        self.__dict__.update(module=module, mesh=mesh)
        self.grid = (mesh.dp, mesh.rp, mesh.sp)
        self.plan = shard_plan(module, self.grid)
        self.shards = {g: {} for g in mesh.local_ranks}
        self.replicated_bytes = 0
        owners = {}
        for mod_name, mod in module.named_modules():
            for table in (mod._parameters, mod._buffers):
                for name, t in table.items():
                    if t is not None:
                        owners[f"{mod_name}.{name}" if mod_name else name] = (table, name)
        for name, (table, key) in owners.items():
            t = table[key]
            if name not in self.plan:
                self.replicated_bytes += _nbytes(t)
                continue
            axis, over, parts = self.plan[name]
            pieces = t.detach().split(t.shape[axis] // parts, dim=axis)
            for g in self.shards:
                self.shards[g][name] = pieces[_part(g, self.grid, over)].contiguous().clone()
            empty = torch.empty(0, dtype=t.dtype, device=t.device)
            table[key] = nn.Parameter(empty, requires_grad=False) if isinstance(t, nn.Parameter) else empty
        self.units = {"": []}
        blocks = {}
        for list_name, lst in list(module.named_modules()):
            # a block whose class has no forward of its own is read, not called: it stays a top tensor set
            if isinstance(lst, nn.ModuleList) and all(type(b).forward is not nn.Module.forward for b in lst):
                for i in range(len(lst)):
                    prefix = f"{list_name}.{i}." if list_name else f"{i}."
                    blocks[prefix] = (lst, i)
                    self.units[prefix] = []
        for name in self.plan:
            prefix = next((p for p in blocks if name.startswith(p)), "")
            self.units[prefix].append(name)
        for prefix, (lst, i) in blocks.items():
            lst[i] = _ShardedBlock(lst[i], self, prefix, self.units[prefix])

    def __getattr__(self, name):
        return getattr(self.__dict__["module"], name)

    def gather(self, names) -> dict:
        """The full tensors of `names`, all-gathered over comm.world (on
        thread ranks the exchange hands over references; the concatenation
        is the copy)."""
        if not names:
            return {}

        def rank(comm):
            own = self.shards[comm.world.rank]
            return [comm.world.all_gather(own[n]) for n in names]

        parts = self.mesh.run(rank)[0]
        return {n: self._join(n, p) for n, p in zip(names, parts)}

    def _join(self, name, pieces):
        axis, over, parts = self.plan[name]
        if len(over) < len(self.grid):  # split over one grid axis: the ranks at 0 on the others
            keep = {}
            for g, p in enumerate(pieces):
                c = _coords(g, self.grid)
                if all(c[a] == 0 for a in range(len(self.grid)) if a not in over):
                    keep[_part(g, self.grid, over)] = p
            pieces = [keep[k] for k in range(parts)]
        return torch.cat(pieces, dim=axis)

    def resident_bytes(self, g: int) -> int:
        """What rank g keeps: its slices and every replicated tensor."""
        return self.replicated_bytes + sum(_nbytes(t) for t in self.shards[g].values())

    def __call__(self, *args, **kwargs):
        return functional_call(self.module, self.gather(self.units[""]), args, kwargs)


def shard_params(model: nn.Module, mesh):
    """FSDP over `mesh` (a rank group of parallel/comm.py): a ShardedModel,
    or `model` itself when the group has one rank. The module is changed in
    place (its sharded tensors become placeholders); quantize first, as the
    JAX CLIs do."""
    if mesh is None or mesh.size == 1:
        return model
    return ShardedModel(model, mesh)
