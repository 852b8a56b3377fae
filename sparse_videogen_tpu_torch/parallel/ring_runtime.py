"""Ring (context-parallel) attention runtimes (counterpart of
sparse_videogen_tpu/parallel/ring_runtime.py): what makes `--ring_degree`
run from the pipeline.

- dense x ring: RingDenseRuntime (parallel/ring.py, exact);
- SAP x ring: RingSAPRuntime (parallel/ring_sap.py: global Lloyd through
  all-reduces, shard-local permutations); its warm-up layers and steps run
  the dense ring;
- SVG x ring raises (pipelines/wan.py): SVG1's per-head profiling and
  placement read the whole token axis.

Both take the sparse/runtimes.py call, q, k, v (B, H, S, D) whole on every
rank: the activations stay whole on each rank, only attention is
token-sharded, and every rank all-gathers the output. The ranks are a rank
group (parallel/comm.py): under torchrun this process's rank, or all ranks
as threads of this process. With a head axis (the group's sp > 1: USP, the
JAX runtimes' head_axis="sp"), ring rank i and head rank j run the ring of
head group j over token shard i, and the output is gathered over the ring,
then over the heads (parallel/ulysses.py). Token-sharding the rest of the
forward (the JAX package's sharding.py) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sparse_videogen_tpu_torch.config import SAPConfig, WarmupSchedule
from sparse_videogen_tpu_torch.ops import metadata as MD
from sparse_videogen_tpu_torch.parallel.ring import ring_attention, ring_aux, ring_meta
from sparse_videogen_tpu_torch.parallel.ring_sap import check_ring_sap_config, sap_ring_attention
from sparse_videogen_tpu_torch.parallel.ulysses import (check_heads, cold_draw, gather_heads, gather_state,
                                                        head_part, state_part)
from sparse_videogen_tpu_torch.sparse.runtimes import SAPRuntime
from sparse_videogen_tpu_torch.sparse.svg1 import SVG1Plan
from sparse_videogen_tpu_torch.sparse.svg2 import init_sap_state


def _ring_geometry(plan: SVG1Plan, n: int):
    """(S, S_pad): the sequence padded for n token shards, S_pad % (n * block_q) == 0."""
    S = plan.layout.seq_len
    unit = n * plan.block_q
    return S, -(-S // unit) * unit


def _aux01(plan: SVG1Plan, prompt_length):
    """aux[0], aux[1] of the ring's mask scalars (the plan's default_aux)."""
    aux = plan.default_aux(prompt_length)
    return int(aux[0]), int(aux[1])


def _gather_seq(comm, out):
    """The whole sequence from every rank's (B, H, Sl, D) output shard."""
    return torch.cat(comm.all_gather(out), dim=2)


class RingDenseRuntime:
    """Dense attention with the token axis sharded over the ring of `mesh`
    (a rank group of parallel/comm.py; its head axis, when sp > 1, splits
    the heads). The plan's sequence is padded to a multiple of n * block_q;
    a shard's kv chunks are min(block_kv, shard) tokens."""

    def __init__(self, plan: SVG1Plan, mesh, *, device, prompt_length: int | None = None):
        self.plan, self.mesh = plan, mesh
        n = mesh.rp
        S, S_pad = _ring_geometry(plan, n)
        self.shard = S_pad // n
        self.block_kv = min(plan.block_kv, self.shard)
        bm = np.ones((S_pad // plan.block_q, S_pad // MD.SUB), bool)
        counts = MD.kv_counts_for_seq(S, S_pad)[0]
        self.meta_all = torch.as_tensor(ring_meta(bm, counts, n, block_kv=self.block_kv), device=device)
        self.aux_all = ring_aux(n, self.shard, _aux01(plan, prompt_length), device)

    def dense(self, q, k, v):
        """The dense ring over whole (B, H, S, D) q, k, v; every rank returns the whole output."""
        S, Sl, sp = q.shape[2], self.shard, self.mesh.sp
        check_heads(q.shape[1], sp)
        q, k, v = (F.pad(x, (0, 0, 0, Sl * self.mesh.rp - S)) for x in (q, k, v))

        def rank(comm):
            part = slice(comm.rank * Sl, (comm.rank + 1) * Sl)
            qj, kj, vj = (head_part(x, comm.heads.rank, sp)[:, :, part] for x in (q, k, v))
            out = ring_attention(qj, kj, vj, comm, self.meta_all, mask_spec=self.plan.dense_mask_spec,
                                 aux_all=self.aux_all, block_q=self.plan.block_q, block_kv=self.block_kv)
            return gather_heads(comm, _gather_seq(comm, out))

        return self.mesh.run(rank)[0][:, :, :S]

    def __call__(self, q, k, v, t, layer_idx, rows=None, generator=None):
        return self.dense(q, k, v)


class RingSAPRuntime(SAPRuntime):
    """SAP (cluster mode) with the token axis sharded over the ring of
    `mesh` (and the heads over its head axis when sp > 1); warm-up layers
    and steps run the dense ring. The sequence must split evenly (S % n ==
    0). Keeps SAPRuntime's `states` and `kmeans_init` (cold-start token
    indices, here global ones at B*H/sp rows, the same for every head
    group, as the JAX ring draws them inside its shard_map), so the
    pipeline drives it as it drives SAPRuntime; every rank holds the same
    states."""

    def __init__(self, plan: SVG1Plan, cfg: SAPConfig, warmup: WarmupSchedule, mesh, *, device):
        check_ring_sap_config(cfg, plan.layout)
        super().__init__(plan, cfg, warmup, device=device)
        if plan.layout.seq_len % mesh.rp:
            raise ValueError(f"ring SAP needs S % ranks == 0: S={plan.layout.seq_len}, ranks={mesh.rp}")
        self.mesh = mesh
        self.dense_ring = RingDenseRuntime(plan, mesh, device=device)

    def __call__(self, q, k, v, t, layer_idx, rows=None, generator=None):
        if self.is_dense(layer_idx, t):
            return self.dense_ring.dense(q, k, v)
        B, H, S, D = q.shape
        sp = self.mesh.sp
        check_heads(H, sp)
        state = self.states.get(layer_idx)
        if state is None:
            state = init_sap_state(B * H, D, self.cfg, device=q.device)
        init_idx = None
        if not state.initialized:
            # drawn here, once for all ranks (under torchrun each rank's generator is seeded alike)
            init_idx = self.kmeans_init[layer_idx] if self.kmeans_init is not None else cold_draw(
                S, B * H // sp, self.cfg, generator, q.device)
        Sl = S // self.mesh.rp

        def rank(comm):
            part = slice(comm.rank * Sl, (comm.rank + 1) * Sl)
            j = comm.heads.rank
            qj, kj, vj = (head_part(x, j, sp)[:, :, part] for x in (q, k, v))
            out, new_state = sap_ring_attention(qj, kj, vj, state_part(state, B, j, sp), comm,
                                                layout=self.plan.layout, cfg=self.cfg, init_idx=init_idx)
            return gather_heads(comm, _gather_seq(comm, out)), gather_state(comm, new_state, B)

        out, self.states[layer_idx] = self.mesh.run(rank)[0]
        return out
