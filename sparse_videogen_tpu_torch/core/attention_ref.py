"""Reference attention (counterpart of sparse_videogen_tpu/core/attention_ref.py):
plain PyTorch oracles for the tests, and the Cosmos DiT's attention when no
runtime is given. Never on the card's main path: the pipelines always hand
the model a runtime, whose kernels run there.

  - dense_attention: softmax in f32 of q k^T scaled;
  - masked_attention: the same under a boolean mask (rows with no allowed
    column give 0);
  - token_cluster_ids / dynamic_block_sparse_ref: SVG2's variable-block
    sparse attention as a masked dense attention (small shapes only).
"""

from __future__ import annotations

import torch


def dense_attention(q, k, v, *, scale=None):
    """q, k, v (..., S, D) -> (..., S, D); the scores in q's dtype, then f32."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = (q @ k.transpose(-1, -2)).float() * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return p.to(q.dtype) @ v


def masked_attention(q, k, v, mask, *, scale=None):
    """mask: boolean, broadcastable to (..., Sq, Sk); True attends."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = ((q @ k.transpose(-1, -2)).float() * scale).masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-12)
    return p.to(q.dtype) @ v


def token_cluster_ids(cluster_sizes, seq_len: int):
    """(..., C) sizes -> (..., seq_len) the cluster of each token position in
    cluster-sorted order (the sizes sum to seq_len)."""
    cum = torch.cumsum(cluster_sizes, dim=-1)
    t = torch.arange(seq_len, device=cluster_sizes.device)
    return (t[..., None, :] >= cum[..., :, None]).sum(-2)


def dynamic_block_sparse_ref(q, k, v, dynamic_map, qc_sizes, kc_sizes, *, scale=None):
    """q, k, v (B, H, S, D) permuted cluster-contiguously; dynamic_map
    (B, H, QC, KC) bool; qc_sizes (B, H, QC), kc_sizes (B, H, KC)."""
    S = q.shape[2]
    q_ids, k_ids = token_cluster_ids(qc_sizes, S), token_cluster_ids(kc_sizes, S)
    rows = torch.gather(dynamic_map, 2, q_ids[..., :, None].expand(*q_ids.shape, dynamic_map.shape[-1]))
    mask = torch.gather(rows, 3, k_ids[..., None, :].expand(*q_ids.shape, S))
    return masked_attention(q, k, v, mask, scale=scale)
