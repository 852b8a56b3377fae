"""Batched Lloyd k-means over B = batch*heads independent problems
(counterpart of sparse_videogen_tpu/core/kmeans.py).

A Euclidean iteration is one fused pass (ops/kmeans.kmeans_assign_update:
labels, f32 sums, counts) and the mean update below. The cosine and dot
metrics assign by the largest similarity and L2-normalise the updated
centroids; as in the JAX package they run outside the kernel (torch
matmuls and a scatter-add). The iteration count is fixed,
as in the JAX package: no tolerance-based early stop, so no host sync.

Token-sharded (ring SAP, parallel/ring_sap.py): with a communicator `comm`
(parallel/comm.py) each rank holds a shard of the tokens; assignment is
token-local given the centroids, and the update all-reduces the per-cluster
sums and counts first, so every rank holds the global Lloyd centroids (the
JAX package's psum over `axis_name`).
"""

from __future__ import annotations

import torch

from sparse_videogen_tpu_torch.ops.kmeans import kmeans_assign_update


def init_centroids(x, n_clusters: int, generator: torch.Generator | None = None, idx=None):
    """Random tokens as initial centroids. x (B, N, D) -> (B, n_clusters, D).
    `idx` (B, n_clusters) hands in the drawn token indices (tests give the
    JAX package's); otherwise they are drawn from `generator`."""
    B, N, D = x.shape
    if idx is None:
        idx = torch.randint(0, N, (B, n_clusters), generator=generator, device=x.device)
    idx = torch.as_tensor(idx, device=x.device).long()
    return torch.gather(x, 1, idx[..., None].expand(B, n_clusters, D))


def init_centroids_sharded(x, n_clusters: int, comm, idx):
    """Random global tokens as initial centroids when the token axis is
    sharded: x is this rank's (B, N_local, D) shard (every rank's of the same
    N_local), idx (B, n_clusters) the drawn global token indices, the same on
    every rank. Each rank contributes the tokens it owns and an all-reduce
    assembles the set: init_centroids over the gathered sequence."""
    B, N, D = x.shape
    loc = torch.as_tensor(idx, device=x.device).long() - comm.rank * N
    mine = (loc >= 0) & (loc < N)
    take = torch.gather(x, 1, loc.clamp(0, N - 1)[..., None].expand(B, n_clusters, D)).float()
    return comm.all_reduce_sum(torch.where(mine[..., None], take, 0.0)).to(x.dtype)


def label_counts(labels, n_clusters: int):
    """(B, N) labels -> (B, K) int32 tokens a cluster."""
    B = labels.shape[0]
    counts = torch.zeros(B, n_clusters, dtype=torch.int32, device=labels.device)
    return counts.scatter_add_(1, labels.long(), torch.ones_like(labels, dtype=torch.int32))


def _finalize(sums, counts, old_centroids, dtype, comm=None):
    """Mean per cluster; an empty cluster keeps its old centroid. With comm,
    sums and counts are all-reduced first (the global Lloyd update).
    Returns (centroids in `dtype`, counts int32)."""
    if comm is not None:
        sums, counts = comm.all_reduce_sum(sums), comm.all_reduce_sum(counts)
    means = sums / counts.clamp_min(1.0)[..., None]
    new = torch.where((counts == 0)[..., None], old_centroids.float(), means)
    return new.to(dtype), counts.to(torch.int32)


SIM_CHUNK_ELEMS = 1 << 26  # f32 similarities of one token chunk (256 MB)


def _sim_iter(x, c, comm=None):
    """A cosine/dot iteration (the JAX package's _sim_iter): each token to
    its most similar centroid (the first on a tie), the member mean, L2-
    normalised; an empty cluster keeps its centroid. x (B, N, D), c (B, K, D)
    in x's dtype. Returns (labels int32, centroids, sizes int32)."""
    B, N, D = x.shape
    K = c.shape[1]
    cf = c.float()
    step = max(1, SIM_CHUNK_ELEMS // max(B * K, 1))
    labels = torch.cat([torch.einsum("bnd,bkd->bnk", x[:, i:i + step].float(), cf).argmax(-1)
                        for i in range(0, N, step)], dim=1)
    sums = torch.zeros(B, K, D, dtype=torch.float32, device=x.device)
    sums.scatter_add_(1, labels[..., None].expand(B, N, D), x.float())
    new, sizes = _finalize(sums, label_counts(labels, K), c, x.dtype, comm)
    new = new.float() / torch.linalg.vector_norm(new.float(), dim=-1, keepdim=True).clamp_min(1e-12)
    return labels.to(torch.int32), new.to(x.dtype), sizes


def _l2_normalize(v):
    """v over its f32 norm (at least 1e-12) cast to v's dtype, as batch_kmeans_Cosine normalises."""
    return v / torch.linalg.vector_norm(v.float(), dim=-1, keepdim=True).clamp_min(1e-12).to(v.dtype)


def batch_kmeans(x, n_clusters: int, max_iters: int, init, *, metric: str = "euclid", comm=None, axis_name=None):
    """`max_iters` Lloyd iterations from `init` centroids (cast to x's dtype).

    As in the JAX package (and its reference), each iteration assigns against
    the current centroids and then updates them, so the returned labels and
    sizes belong to the last iteration's pre-update centroids and the
    returned centroids are post-update. max_iters <= 0 assigns only and
    returns `init`. comm: x is this rank's token shard; the labels are the
    shard's, the centroids and sizes global (the same on every rank). The
    JAX package's `axis_name` (a mesh axis) has no counterpart: it raises.

    metric: "euclid" (the fused pass), "cosine" (x and init L2-normalised
    first, then as "dot") or "dot" (the largest raw similarity, normalised
    centroid updates).

    Returns (labels (B, N) int32, centroids (B, K, D), sizes (B, K) int32).
    """
    if metric not in ("euclid", "cosine", "dot"):
        raise ValueError(f"k-means metric {metric!r}: one of euclid, cosine, dot")
    if axis_name is not None:
        raise NotImplementedError("k-means shards its tokens through comm= (parallel/comm.py), not a JAX mesh "
                                  "axis name")
    if init.shape[1] != n_clusters:
        raise ValueError(f"init has {init.shape[1]} centroids, n_clusters={n_clusters}")
    if metric == "cosine":
        x, init = _l2_normalize(x), _l2_normalize(init)
    c = init.to(x.dtype)

    def one_iter(c):
        if metric != "euclid":
            return _sim_iter(x, c, comm)
        labels, sums, counts = kmeans_assign_update(x, c)
        return (labels, *_finalize(sums, counts, c, x.dtype, comm))

    if max_iters <= 0:
        labels, _, sizes = one_iter(c)
        return labels, c, sizes
    for _ in range(max_iters):
        labels, c, sizes = one_iter(c)
    return labels, c, sizes
