"""The ring's communicator: what the per-rank code of parallel/ring.py,
parallel/ring_sap.py and core/kmeans.py needs from the other ranks (the
collectives the JAX package gets from `shard_map` and a mesh axis).

    comm.rank, comm.size
    comm.rotate(t)          this rank's t goes to rank + 1, rank - 1's comes back
                            (JAX's ppermute j -> j + 1)
    comm.all_reduce_sum(t)  the sum over ranks (psum), the same on every rank
    comm.all_gather(t)      [rank 0's t, rank 1's t, ...]

Two implementations run the same per-rank code:
- `DistComm`: torch.distributed (gloo on the CPU, NCCL across cards), one
  rank a process; the rotation is a batched isend/irecv pair.
- `ThreadComm`: n ranks as threads of one process (on one card, where NCCL
  refuses two ranks of one device): the ranks meet at a barrier and hand
  each other tensors through shared slots, without a copy. They share one
  device and its default stream, so the work one rank enqueued before the
  barrier runs before the work another rank enqueues after it.

A runtime drives the ranks through a rank group: `ProcessRanks` (this
process is one rank) or `ThreadRanks` (all ranks here, in threads);
`group.run(fn)` calls fn(comm) on each rank it holds and returns the
results in rank order. A group is the JAX mesh's dp x rp x sp grid: rank
g = (d * rp + i) * sp + j is data rank d, ring rank i and head rank j.
`comm` is the rank's communicator over the ring axis (its rank i of rp,
within its dp slice), `comm.heads` the one over the head axis (its rank j
of sp, within its dp slice), which the Ulysses and USP runtimes gather
heads over, and `comm.world` the one over every rank (its rank g), which
FSDP gathers weights over (parallel/sharding.py). An axis of one rank has
a `LocalComm`. The ring and head runtimes return rank 0's result; the other
dp slices compute the same (each dp rank runs the whole CFG batch, as in
the JAX package).
"""

from __future__ import annotations

import threading

import torch


class DistComm:
    """A rank of a torch.distributed process group (the default group when
    `group` is None)."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self._dist, self.group = dist, group
        self.rank, self.size = dist.get_rank(group), dist.get_world_size(group)

    def _peer(self, r: int) -> int:
        """The global rank of group rank r % size."""
        r %= self.size
        return r if self.group is None else self._dist.get_global_rank(self.group, r)

    def rotate(self, t):
        t = t.contiguous()
        out = torch.empty_like(t)
        dist = self._dist
        ops = [dist.P2POp(dist.isend, t, self._peer(self.rank + 1), self.group),
               dist.P2POp(dist.irecv, out, self._peer(self.rank - 1), self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def all_reduce_sum(self, t):
        t = t.clone()
        self._dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t):
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        self._dist.all_gather(out, t, group=self.group)
        return out


class LocalComm:
    """The only rank of an axis of one: every collective returns its input."""

    rank, size = 0, 1

    def rotate(self, t):
        return t

    def all_reduce_sum(self, t):
        return t.clone()

    def all_gather(self, t):
        return [t]


class _Slots:
    """What the threads of one ThreadRanks share: a barrier and a slot a rank."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n


class ThreadComm:
    """Rank `rank` of n ranks that are threads of this process."""

    def __init__(self, rank: int, shared: _Slots):
        self.rank, self.size, self._shared = rank, len(shared.slots), shared

    def _exchange(self, t):
        """Every rank's t, in rank order (the second barrier keeps a fast rank
        from overwriting its slot before the others have read it)."""
        sh = self._shared
        sh.slots[self.rank] = t
        sh.barrier.wait()
        out = list(sh.slots)
        sh.barrier.wait()
        return out

    def rotate(self, t):
        return self._exchange(t)[(self.rank - 1) % self.size]

    def all_reduce_sum(self, t):
        vals = self._exchange(t)
        total = vals[0].clone()
        for v in vals[1:]:  # rank order: the same sum on every rank
            total += v
        return total

    def all_gather(self, t):
        return self._exchange(t)


class ProcessRanks:
    """This process is one rank of a dp x rp x sp grid (DistComm): `comm`
    over the ring axis, `comm.heads` over the head axis, `comm.world` over
    every rank; `rank` is the global rank."""

    def __init__(self, comm, *, rank: int = 0, rp: int | None = None, sp: int = 1, dp: int = 1):
        for axis in ("heads", "world"):
            if not hasattr(comm, axis):
                setattr(comm, axis, LocalComm())
        self.comm, self.rank = comm, rank
        self.dp, self.rp, self.sp = dp, comm.size if rp is None else rp, sp
        self.size = self.dp * self.rp * self.sp

    @property
    def local_ranks(self):
        """The global ranks this process holds."""
        return [self.rank]

    def run(self, fn):
        return [fn(self.comm)]


class ThreadRanks:
    """dp x rp x sp ranks in this process, one thread each (ThreadRanks(n)
    is a ring of n); run(fn) returns every rank's result in global rank
    order. Grad mode is a thread's own: each rank runs under no_grad. A rank
    that raises breaks every barrier, so the others stop instead of waiting,
    and run re-raises the first error."""

    def __init__(self, rp: int = 1, sp: int = 1, *, dp: int = 1):
        if rp < 1 or sp < 1 or dp < 1:
            raise ValueError(f"need at least one rank on each axis, got dp={dp}, rp={rp}, sp={sp}")
        self.dp, self.rp, self.sp, self.size = dp, rp, sp, dp * rp * sp

    @property
    def local_ranks(self):
        """The global ranks this process holds: all of them."""
        return list(range(self.size))

    def run(self, fn):
        dp, rp, sp = self.dp, self.rp, self.sp
        rings = [[_Slots(rp) for _ in range(sp)] for _ in range(dp)]  # ring (d, j): ranks (d, i, j) over i
        heads = [[_Slots(sp) for _ in range(rp)] for _ in range(dp)]  # head group (d, i): over j
        world = _Slots(self.size)
        results, errors = [None] * self.size, [None] * self.size
        device = torch.cuda.current_device() if torch.cuda.is_available() else None

        def body(g):
            d, rest = divmod(g, rp * sp)
            i, j = divmod(rest, sp)
            try:
                if device is not None:
                    torch.cuda.set_device(device)
                comm = ThreadComm(i, rings[d][j]) if rp > 1 else LocalComm()
                comm.heads = ThreadComm(j, heads[d][i]) if sp > 1 else LocalComm()
                comm.world = ThreadComm(g, world) if self.size > 1 else LocalComm()
                with torch.no_grad():
                    results[g] = fn(comm)
            except BaseException as e:  # noqa: BLE001 - handed to the caller below
                errors[g] = e
                for slots in [s for grid in rings + heads for s in grid] + [world]:
                    slots.barrier.abort()

        threads = [threading.Thread(target=body, args=(g,), name=f"rank-{g}") for g in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        first = next((e for e in errors if e is not None and not isinstance(e, threading.BrokenBarrierError)),
                     next((e for e in errors if e is not None), None))
        if first is not None:
            raise first
        return results
