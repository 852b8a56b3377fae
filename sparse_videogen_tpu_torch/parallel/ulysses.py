"""Ulysses sequence parallelism: attention sharded over heads (counterpart
of sparse_videogen_tpu/parallel/ulysses.py).

The JAX runtime receives token-sharded activations and lets GSPMD insert
the all-to-all to head-sharded q, k, v at its shard_map. The port keeps the
activations whole on every rank (as its ring does), so the all-to-all is a
head slice in and an all-gather over the head axis out: head rank j of sp
runs the inner runtime on heads [j H/sp, (j+1) H/sp) of every batch
element. SVG1's profiling and SAP's clustering are per head, so the split
changes nothing in either algorithm.

- The SAP state ((B*H, ...) leaves) is sharded on H within each batch
  element, never on the flat B*H axis: with the CFG batch of 2 a split of
  B*H would hand one rank all of cond's heads.
- SVG1's profiler rows are drawn once, here, from the forward's generator,
  and every rank gets them: the single-device draw (JAX replicates its rng).
- SAP's cold k-means start is drawn once (SAPRuntime.carry), at the local
  head count B*H/sp, and every rank gets the same token indices: JAX's
  Ulysses draw (its replicated key drawn per shard at the local shape),
  not the single-device one.
"""

from __future__ import annotations

import dataclasses

import torch

from sparse_videogen_tpu_torch.config import SAPConfig, WarmupSchedule
from sparse_videogen_tpu_torch.sparse.runtimes import SAPRuntime, SVG1Runtime
from sparse_videogen_tpu_torch.sparse.svg1 import SVG1Plan
from sparse_videogen_tpu_torch.sparse.svg2 import SAPState


def check_heads(H: int, sp: int) -> None:
    if H % sp:
        raise ValueError(f"{H} heads do not split over Ulysses degree sp={sp}")


def head_part(x, j: int, sp: int):
    """Heads [j H/sp, (j+1) H/sp) of x (B, H, ...)."""
    h = x.shape[1] // sp
    return x[:, j * h:(j + 1) * h]


def gather_heads(comm, x):
    """(B, H/sp, ...) of every head rank -> (B, H, ...)."""
    return x if comm.heads.size == 1 else torch.cat(comm.heads.all_gather(x.contiguous()), dim=1)


def state_part(state: SAPState, B: int, j: int, sp: int) -> SAPState:
    """Head rank j's share of a (B*H, ...) SAP state."""
    if sp == 1:
        return state
    part = lambda x: head_part(x.reshape(B, -1, *x.shape[1:]), j, sp).reshape(-1, *x.shape[1:]).contiguous()
    return dataclasses.replace(state, q_centroids=part(state.q_centroids), k_centroids=part(state.k_centroids),
                               last_density=part(state.last_density))


def gather_state(comm, state: SAPState, B: int) -> SAPState:
    """The whole (B*H, ...) SAP state from every head rank's share."""
    if comm.heads.size == 1:
        return state
    whole = lambda x: gather_heads(comm, x.reshape(B, -1, *x.shape[1:])).reshape(-1, *x.shape[1:])
    return dataclasses.replace(state, q_centroids=whole(state.q_centroids), k_centroids=whole(state.k_centroids),
                               last_density=whole(state.last_density))


class UlyssesRuntime:
    """Wraps a dense or SVG1 runtime (sparse/runtimes.py) for the head axis
    of `mesh` (a rank group of parallel/comm.py whose sp is the Ulysses
    degree). Takes the runtime call and returns the whole output on every
    rank."""

    def __init__(self, inner, mesh):
        self.inner, self.mesh = inner, mesh

    def __call__(self, q, k, v, t, layer_idx, rows=None, generator=None):
        sp, inner = self.mesh.sp, self.inner
        check_heads(q.shape[1], sp)
        if rows is None and isinstance(inner, SVG1Runtime) and not inner.is_dense(layer_idx, t):
            rows = inner.draw_rows(q.shape[2], generator, q.device)

        def rank(comm):
            j = comm.heads.rank
            return gather_heads(comm, inner(head_part(q, j, sp), head_part(k, j, sp), head_part(v, j, sp), t,
                                            layer_idx, rows=rows))

        return self.mesh.run(rank)[0]


class UlyssesSAPRuntime(SAPRuntime):
    """SAP over the head axis of `mesh`: the whole (B*H) `states`, and
    `kmeans_init` a layer's (q, k) indices at B*H/sp rows, handed to every
    rank; the pipeline swaps them per CFG stream as on one device."""

    def __init__(self, plan: SVG1Plan, cfg: SAPConfig, warmup: WarmupSchedule, mesh, *, device):
        super().__init__(plan, cfg, warmup, device=device)
        self.mesh = mesh

    def rank_attend(self, comm, q, k, v, t, layer_idx, state, init_idx):
        """One rank's (out, new_state) of its head group's q, k, v and state."""
        return self.attend(q, k, v, t, layer_idx, state, init_idx)

    def __call__(self, q, k, v, t, layer_idx, rows=None, generator=None):
        B, H = q.shape[:2]
        sp = self.mesh.sp
        check_heads(H, sp)

        def step(state, init_idx):
            def rank(comm):
                j = comm.heads.rank
                out, new = self.rank_attend(comm, *(head_part(x, j, sp) for x in (q, k, v)), t, layer_idx,
                                            state_part(state, B, j, sp), init_idx)
                return gather_heads(comm, out), gather_state(comm, new, B)

            return self.mesh.run(rank)[0]

        # the cold start is drawn once for all ranks (under torchrun each rank's generator is seeded alike)
        return self.carry(q, t, layer_idx, generator, B * H // sp, step)
