"""Block-aligned cluster permutation for SAP (counterpart of
sparse_videogen_tpu/core/permute.py).

Queries are sorted cluster-contiguously with each cluster's span padded to a
multiple of the attention block, so every q block belongs to one query
cluster; the inverse map brings the outputs back. The TPU version builds its
gathers from sorts and one-hot matmuls because element gathers and scatters
are slow there (gather_small_i32); here they are plain indexing. Index
outputs are int64 (torch's index dtype), with the JAX package's values.
"""

from __future__ import annotations

import torch

SUB = 128


def padded_seq_len(seq_len: int, n_clusters: int, block: int) -> int:
    """Static upper bound on sum(ceil(size_c / block) * block)."""
    return -(-(seq_len + n_clusters * (block - 1)) // block) * block


def exclusive_cumsum(x):
    return torch.cumsum(torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1), dim=-1)


def cluster_spans(sizes, block: int):
    """sizes (..., C) -> (start, pad_off, pad_sizes): exclusive starts of the
    clusters unpadded and padded to `block`, and the padded sizes."""
    pad_sizes = -(-sizes // block) * block
    return exclusive_cumsum(sizes), exclusive_cumsum(pad_sizes), pad_sizes


def padded_permutation(labels, sizes, *, n_clusters: int, block: int, s_pad: int):
    """Gather maps of the block-aligned permutation.

    labels (B, N) cluster of each token; sizes (B, C) cluster sizes
    (summing to N). Returns a dict of:
      src (B, s_pad): padded position -> source token (a padding slot
          repeats its cluster's last token);
      valid (B, s_pad) bool: the slot holds a real token;
      pos (B, N): token -> its padded position (the inverse map);
      pad_off (B, C): padded start of each cluster;
      block_to_cluster (B, s_pad // block): the cluster owning each block;
      kv_counts (B, s_pad // block): real tokens in each block.
    """
    B, N = labels.shape
    C = n_clusters
    dev = labels.device
    sizes = sizes.long()
    start, pad_off, pad_sizes = cluster_spans(sizes, block)
    total_pad = pad_off[:, -1] + pad_sizes[:, -1]
    lab_sorted, perm = torch.sort(labels.long(), dim=-1, stable=True)

    nblk = s_pad // block
    b0 = torch.arange(nblk, device=dev) * block
    blk_c = ((b0[None, None, :] >= pad_off[:, :, None]).sum(1) - 1).clamp(0, C - 1)
    blk_size, blk_padoff, blk_start = (t.gather(1, blk_c) for t in (sizes, pad_off, start))
    kv_counts = (blk_size - (b0[None, :] - blk_padoff)).clamp(0, block)
    kv_counts = torch.where(b0[None, :] < total_pad[:, None], kv_counts, 0)

    rep = lambda t: t.repeat_interleave(block, dim=-1)
    j = torch.arange(s_pad, device=dev)[None, :]
    size_s = rep(blk_size)
    r = j - rep(blk_padoff)
    valid = (r < size_s) & (j < total_pad[:, None])
    rank = rep(blk_start) + torch.minimum(r, (size_s - 1).clamp_min(0))
    src = perm.gather(1, rank.clamp(0, N - 1))

    # the token of sorted rank g lands at g + (pad_off - start)[its cluster]
    dest_sorted = torch.arange(N, device=dev)[None, :] + (pad_off - start).gather(1, lab_sorted)
    pos = torch.empty_like(perm).scatter_(1, perm, dest_sorted)
    return dict(src=src, valid=valid, pos=pos, pad_off=pad_off, block_to_cluster=blk_c, kv_counts=kv_counts)


def flat_row_gather(x, idx):
    """Per-batch row gather: x (B, N, D), idx (B, M) in [0, N) -> (B, M, D)."""
    B, N, D = x.shape
    flat = (idx.long() + torch.arange(B, device=x.device)[:, None] * N).reshape(-1)
    return x.reshape(B * N, D)[flat].reshape(B, idx.shape[1], D)


def gather_padded(x, src):
    """x (B, N, D), src (B, s_pad) -> (B, s_pad, D)."""
    return flat_row_gather(x, src)


def ungather_padded(y_pad, pos):
    """y_pad (B, s_pad, D), pos (B, N) -> (B, N, D) (the inverse permutation)."""
    return flat_row_gather(y_pad, pos)
