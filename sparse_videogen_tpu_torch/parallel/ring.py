"""Ring (context-parallel) attention over the sequence axis (counterpart of
sparse_videogen_tpu/parallel/ring.py).

Each rank holds a contiguous shard of the (padded) sequence's q, k and v.
The k/v shard rotates around the ring (comm.rotate, rank j -> j + 1); every
rotation runs K1 (ops/attention.block_sparse_attention_kv) with
`return_stats=True` on per-(q shard, kv shard) metadata (`ring_meta`) and
global positions (aux[2] = my * Sl, aux[3] = src * Sl), so the masks see
the same pairs as on one device. The rotations' partial results merge with
their (m, l) stats in f32 (flash attention's two-level rescale). The
per-rank code is the same under torch.distributed and the thread
communicator (parallel/comm.py).
"""

from __future__ import annotations

import numpy as np
import torch

from sparse_videogen_tpu_torch.ops import metadata as MD
from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_kv
from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec


def ring_meta(block_mask: np.ndarray, counts: np.ndarray, n_shards: int, *, block_kv: int) -> np.ndarray:
    """Per-(q shard, kv shard) chunked metadata from a global block mask.

    block_mask (nQ, nsub) bool at (block_q, 128) granularity; counts (nsub,)
    live tokens a sub-block. Chunk indices are local to the kv shard.
    Returns (n, n, nQ / n, L) int32, one row length for all."""
    nQ, nsub = block_mask.shape
    if nQ % n_shards or nsub % n_shards:
        raise ValueError(f"block mask {block_mask.shape} does not split into {n_shards} shards")
    qL, kL = nQ // n_shards, nsub // n_shards
    rows = [[MD.chunk_meta_np(block_mask[None, i * qL:(i + 1) * qL, j * kL:(j + 1) * kL],
                              counts[None, j * kL:(j + 1) * kL], block_kv=block_kv)[0]
             for j in range(n_shards)] for i in range(n_shards)]
    L = max(m.shape[-1] for r in rows for m in r)
    out = np.zeros((n_shards, n_shards, qL, L), np.int32)
    for i in range(n_shards):
        for j in range(n_shards):
            out[i, j, :, :rows[i][j].shape[-1]] = rows[i][j]
    return out


def ring_aux(n: int, shard_len: int, aux01=(0, 0), device="cpu") -> torch.Tensor:
    """(n, n, 4) int32: the mask scalars of q shard i against kv shard j,
    aux01 and the global offsets (i * shard_len, j * shard_len)."""
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    aux = np.stack([np.full_like(i, aux01[0]), np.full_like(i, aux01[1]), i * shard_len, j * shard_len], -1)
    return torch.as_tensor(aux.astype(np.int32), device=device)


def merge_partial(state, o_r, m_r, l_r):
    """Fold one rotation's (o_r normalised, m_r, l_r) into the running (acc,
    m, l), f32: acc holds sum_j o_j l_j exp(m_j - m)."""
    acc, m, l = state
    m_new = torch.maximum(m, m_r)
    a_old, a_r = torch.exp(m - m_new), torch.exp(m_r - m_new)
    acc = acc * a_old[..., None] + o_r.float() * (l_r * a_r)[..., None]
    return acc, m_new, l * a_old + l_r * a_r


def merge_init(rows_shape, D: int, device):
    """The empty (acc, m, l) of `merge_partial` for rows of shape rows_shape."""
    return (torch.zeros(*rows_shape, D, device=device), torch.full(rows_shape, -torch.inf, device=device),
            torch.zeros(rows_shape, device=device))


def ring_attention(q, k, v, comm, meta_all, *, mask_spec: MaskSpec = MaskSpec(), aux_all=None, aux01=(0, 0),
                   block_q: int = 512, block_kv: int = 512, scale: float | None = None):
    """Exact (block-sparse) attention with the sequence sharded over the
    ring: q, k, v are this rank's (B, H, Sl, D) shard (Sl % block_q == 0,
    Sl % 128 == 0); meta_all the (n, n, Sl / block_q, L) int32 ring_meta on
    q's device; aux_all the (n, n, 4) ring_aux (built from aux01 when None).
    Returns this rank's (B, H, Sl, D) output in q's dtype."""
    n, my = comm.size, comm.rank
    B, H, Sl, D = q.shape
    if Sl % block_q or Sl % MD.SUB:
        raise ValueError(f"shard of {Sl} tokens for block_q {block_q}")
    if aux_all is None:
        aux_all = ring_aux(n, Sl, aux01, q.device)
    qf = q.reshape(B * H, Sl, D).contiguous()
    kv = torch.stack([k.reshape(B * H, Sl, D), v.reshape(B * H, Sl, D)])  # one rotation moves both
    state = merge_init((B * H, Sl), D, q.device)
    for r in range(n):
        src = (my - r) % n
        o_r, m_r, l_r = block_sparse_attention_kv(qf, kv[0], kv[1], meta_all[my, src][None], aux_all[my, src],
                                                  block_q=block_q, block_kv=block_kv, mask_spec=mask_spec,
                                                  scale=scale, return_stats=True)
        state = merge_partial(state, o_r, m_r, l_r)
        if r < n - 1:
            kv = comm.rotate(kv)
    acc, _, l = state
    return (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype).reshape(B, H, Sl, D)
