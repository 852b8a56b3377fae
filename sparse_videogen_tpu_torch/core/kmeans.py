"""Batched Lloyd k-means over B = batch*heads independent problems
(counterpart of sparse_videogen_tpu/core/kmeans.py, metric "euclid").

Every iteration is one fused pass (ops/kmeans.kmeans_assign_update: labels,
f32 sums, counts) and the mean update below. The iteration count is fixed,
as in the JAX package: no tolerance-based early stop, so no host sync.
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


def _finalize(sums, counts, old_centroids, dtype):
    """Mean per cluster; an empty cluster keeps its old centroid. Returns
    (centroids in `dtype`, counts int32)."""
    means = sums / counts.clamp_min(1.0)[..., None]
    new = torch.where((counts == 0)[..., None], old_centroids.float(), means)
    return new.to(dtype), counts.to(torch.int32)


def batch_kmeans(x, n_clusters: int, max_iters: int, init, *, metric: str = "euclid", axis_name=None):
    """`max_iters` Lloyd iterations from `init` centroids (cast to x's dtype).

    As in the JAX package (and its reference), each iteration assigns against
    the current centroids and then updates them, so the returned labels and
    sizes belong to the last iteration's pre-update centroids and the
    returned centroids are post-update. max_iters <= 0 assigns only and
    returns `init`.

    Returns (labels (B, N) int32, centroids (B, K, D), sizes (B, K) int32).
    """
    if metric != "euclid":
        raise NotImplementedError(f"k-means metric {metric!r} is not ported to the torch package yet (ROADMAP.md)")
    if axis_name is not None:
        raise NotImplementedError("token-sharded k-means (axis_name) is not ported to the torch package yet "
                                  "(ROADMAP.md)")
    if init.shape[1] != n_clusters:
        raise ValueError(f"init has {init.shape[1]} centroids, n_clusters={n_clusters}")
    c = init.to(x.dtype)
    if max_iters <= 0:
        labels, sums, counts = kmeans_assign_update(x, c)
        return labels, c, _finalize(sums, counts, c, x.dtype)[1]
    for _ in range(max_iters):
        labels, sums, counts = kmeans_assign_update(x, c)
        c, sizes = _finalize(sums, counts, c, x.dtype)
    return labels, c, sizes
