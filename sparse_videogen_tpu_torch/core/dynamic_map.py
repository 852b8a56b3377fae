"""SVG2 cluster-pair selection ("dynamic map") and density telemetry
(counterpart of sparse_videogen_tpu/core/dynamic_map.py).
"""

from __future__ import annotations

import torch


def weighted_softmax(scores, weights):
    """softmax(scores) with per-column multiplicative weights, f32 math,
    returned in scores' dtype."""
    s = scores.float()
    e = weights.float() * torch.exp(s - s.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True).clamp_min(1e-12)).to(scores.dtype)


def identify_dynamic_map(query_centroids, key_centroids, q_cluster_sizes, k_cluster_sizes, top_p: float,
                         min_kc_ratio: float = 0.0):
    """Boolean (B, H, QC, KC) keep-mask over cluster pairs.

    The centroid-level attention softmax(Qc Kc^T / sqrt(D)), weighted by the
    key-cluster sizes, sorted descending (stable); keep the smallest prefix
    whose cumulative mass exceeds top_p (the first entry always), plus a
    forced prefix of min_kc_ratio * KC entries. q_cluster_sizes is unused,
    as in the reference's signature.
    """
    D = query_centroids.shape[-1]
    KC = key_centroids.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", query_centroids.float(), key_centroids.float()) * (D ** -0.5)
    probs = weighted_softmax(scores, k_cluster_sizes[..., None, :])
    neg_sorted, sorted_idx = torch.sort(-probs, dim=-1, stable=True)
    cum = torch.cumsum(-neg_sorted.float(), dim=-1)
    remove = cum > top_p
    # shift right by one so the first cluster crossing top_p is kept
    remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
    if min_kc_ratio > 0:
        remove = remove & (torch.arange(KC, device=remove.device) >= int(min_kc_ratio * KC))
    # keep flags back to column order
    return torch.empty_like(remove).scatter_(-1, sorted_idx, ~remove)


def density_calculation(dynamic_map, q_cluster_sizes, k_cluster_sizes):
    """Per-(batch, head) fraction of the S x S score matrix computed."""
    block = q_cluster_sizes[..., :, None].float() * k_cluster_sizes[..., None, :].float()
    return (block * dynamic_map).sum((-2, -1)) / block.sum((-2, -1))
