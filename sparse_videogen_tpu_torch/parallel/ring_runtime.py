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
as threads of this process. Token-sharding the rest of the forward (the
JAX package's sharding.py) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sparse_videogen_tpu_torch.config import SAPConfig, WarmupSchedule
from sparse_videogen_tpu_torch.ops import metadata as MD
from sparse_videogen_tpu_torch.parallel.ring import ring_attention, ring_aux, ring_meta
from sparse_videogen_tpu_torch.parallel.ring_sap import check_ring_sap_config, sap_ring_attention
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
    """Dense attention with the token axis sharded over the ranks of `mesh`
    (a rank group of parallel/comm.py). The plan's sequence is padded to a
    multiple of n * block_q; a shard's kv chunks are min(block_kv, shard)
    tokens."""

    def __init__(self, plan: SVG1Plan, mesh, *, device, prompt_length: int | None = None):
        self.plan, self.mesh = plan, mesh
        n = mesh.size
        S, S_pad = _ring_geometry(plan, n)
        self.shard = S_pad // n
        self.block_kv = min(plan.block_kv, self.shard)
        bm = np.ones((S_pad // plan.block_q, S_pad // MD.SUB), bool)
        counts = MD.kv_counts_for_seq(S, S_pad)[0]
        self.meta_all = torch.as_tensor(ring_meta(bm, counts, n, block_kv=self.block_kv), device=device)
        self.aux_all = ring_aux(n, self.shard, _aux01(plan, prompt_length), device)

    def dense(self, q, k, v):
        """The dense ring over whole (B, H, S, D) q, k, v; every rank returns the whole output."""
        S, Sl = q.shape[2], self.shard
        q, k, v = (F.pad(x, (0, 0, 0, Sl * self.mesh.size - S)) for x in (q, k, v))

        def rank(comm):
            part = slice(comm.rank * Sl, (comm.rank + 1) * Sl)
            out = ring_attention(q[:, :, part], k[:, :, part], v[:, :, part], comm, self.meta_all,
                                 mask_spec=self.plan.dense_mask_spec, aux_all=self.aux_all,
                                 block_q=self.plan.block_q, block_kv=self.block_kv)
            return _gather_seq(comm, out)

        return self.mesh.run(rank)[0][:, :, :S]

    def __call__(self, q, k, v, t, layer_idx, rows=None, generator=None):
        return self.dense(q, k, v)


class RingSAPRuntime(SAPRuntime):
    """SAP (cluster mode) with the token axis sharded over the ranks of
    `mesh`; warm-up layers and steps run the dense ring. The sequence must
    split evenly (S % n == 0). Keeps SAPRuntime's `states` and
    `kmeans_init` (cold-start token indices, here global ones), so the
    pipeline drives it as it drives SAPRuntime; every rank holds the same
    states."""

    def __init__(self, plan: SVG1Plan, cfg: SAPConfig, warmup: WarmupSchedule, mesh, *, device):
        check_ring_sap_config(cfg, plan.layout)
        super().__init__(plan, cfg, warmup, device=device)
        if plan.layout.seq_len % mesh.size:
            raise ValueError(f"ring SAP needs S % ranks == 0: S={plan.layout.seq_len}, ranks={mesh.size}")
        self.mesh = mesh
        self.dense_ring = RingDenseRuntime(plan, mesh, device=device)

    def __call__(self, q, k, v, t, layer_idx, rows=None, generator=None):
        if self.is_dense(layer_idx, t):
            return self.dense_ring.dense(q, k, v)
        B, H, S, D = q.shape
        state = self.states.get(layer_idx)
        if state is None:
            state = init_sap_state(B * H, D, self.cfg, device=q.device)
        init_idx = None
        if not state.initialized:
            if self.kmeans_init is not None:
                init_idx = self.kmeans_init[layer_idx]
            else:  # drawn here, once for all ranks (under torchrun each rank's generator is seeded alike)
                init_idx = tuple(torch.randint(0, S, (B * H, c), generator=generator, device=q.device)
                                 for c in (self.cfg.num_q_centroids, self.cfg.num_k_centroids))
        Sl = S // self.mesh.size

        def rank(comm):
            part = slice(comm.rank * Sl, (comm.rank + 1) * Sl)
            out, new_state = sap_ring_attention(q[:, :, part], k[:, :, part], v[:, :, part], state, comm,
                                                layout=self.plan.layout, cfg=self.cfg, init_idx=init_idx)
            return _gather_seq(comm, out), new_state

        out, self.states[layer_idx] = self.mesh.run(rank)[0]
        return out
