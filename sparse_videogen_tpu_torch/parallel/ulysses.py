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
- SAP's cold k-means start is drawn once, here, at the local head count
  B*H/sp, and every rank gets the same token indices: JAX's Ulysses draw
  (its replicated key drawn per shard at the local shape), not the
  single-device one.
"""

from __future__ import annotations

import dataclasses

import torch

from sparse_videogen_tpu_torch.sparse.runtimes import SAPRuntime, SVG1Runtime
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


def state_part(state: SAPState | None, B: int, j: int, sp: int) -> SAPState | None:
    """Head rank j's share of a (B*H, ...) SAP state."""
    if state is None or sp == 1:
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


def cold_draw(n_tokens: int, rows: int, cfg, generator, device):
    """The cold k-means start's token indices: (q (rows, QC), k (rows, KC)),
    drawn in the order sap_cluster draws them."""
    return tuple(torch.randint(0, n_tokens, (rows, c), generator=generator, device=device)
                 for c in (cfg.num_q_centroids, cfg.num_k_centroids))


class UlyssesRuntime:
    """Wraps a dense, SVG1 or SAP runtime (sparse/runtimes.py) for the head
    axis of `mesh` (a rank group of parallel/comm.py whose sp is the
    Ulysses degree). Takes the runtime call and returns the whole output on
    every rank. A SAP inner runtime keeps the whole (B*H) states and
    `kmeans_init` (here a layer's (q, k) indices at B*H/sp rows, handed to
    every rank), which the pipeline swaps per CFG stream."""

    def __init__(self, inner, mesh):
        self.inner, self.mesh = inner, mesh

    @property
    def states(self):
        return self.inner.states

    @states.setter
    def states(self, value):
        self.inner.states = value

    @property
    def kmeans_init(self):
        return self.inner.kmeans_init

    @kmeans_init.setter
    def kmeans_init(self, value):
        self.inner.kmeans_init = value

    def __call__(self, q, k, v, t, layer_idx, rows=None, generator=None):
        B, H = q.shape[:2]
        sp, inner = self.mesh.sp, self.inner
        check_heads(H, sp)
        if isinstance(inner, SAPRuntime):
            return self._sap(q, k, v, t, layer_idx, generator)
        if rows is None and isinstance(inner, SVG1Runtime) and not inner.is_dense(layer_idx, t):
            rows = inner.draw_rows(q.shape[2], generator, q.device)

        def rank(comm):
            j = comm.heads.rank
            return gather_heads(comm, inner(head_part(q, j, sp), head_part(k, j, sp), head_part(v, j, sp), t,
                                            layer_idx, rows=rows))

        return self.mesh.run(rank)[0]

    def _sap(self, q, k, v, t, layer_idx, generator):
        B, H = q.shape[:2]
        sp, inner = self.mesh.sp, self.inner
        state = inner.states.get(layer_idx)
        init_idx = None
        if (state is None or not state.initialized) and inner.clusters(layer_idx, t):
            init_idx = inner.kmeans_init[layer_idx] if inner.kmeans_init is not None else cold_draw(
                inner.plan.layout.video_length, B * H // sp, inner.cfg, generator, q.device)

        def rank(comm):
            j = comm.heads.rank
            out, new = inner.attend(head_part(q, j, sp), head_part(k, j, sp), head_part(v, j, sp), t, layer_idx,
                                    state_part(state, B, j, sp), init_idx=init_idx)
            return gather_heads(comm, out), gather_state(comm, new, B)

        out, inner.states[layer_idx] = self.mesh.run(rank)[0]
        return out
