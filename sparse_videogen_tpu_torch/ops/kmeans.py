"""Fused k-means Lloyd pass (counterpart of sparse_videogen_tpu/ops/kmeans_pallas.py).

One pass over x computes both the nearest-centroid labels and the per-cluster
f32 sums and counts that the centroid update needs (core/kmeans.py).

`kmeans_assign_update` launches the Hopper kernel (csrc/kmeans.cu) for CUDA
tensors and the plain version for CPU tensors; `kmeans_assign_update_plain`
is the plain version itself, the kernel's oracle on the card. The TPU's
padding of K to 128 lanes with +inf distances and of N to the block size has
no counterpart: the kernel bounds-checks both.
"""

from __future__ import annotations

import torch

from sparse_videogen_tpu_torch import _kernels


def _check(x, centroids):
    if x.dim() != 3 or centroids.dim() != 3 or centroids.shape[0] != x.shape[0] or centroids.shape[2] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} and centroids {tuple(centroids.shape)}: need (B, N, D) and (B, K, D)")
    if centroids.shape[1] < 1:
        raise ValueError("need at least one centroid")


def kmeans_assign_update_plain(x, centroids):
    """labels = argmin_k (|c_k|^2 - 2 x.c_k) in f32 (|x|^2 is constant per
    row and left out, as the TPU kernel does), ties to the first index;
    sums = onehot(labels)^T x and counts, both f32. The centroids are cast to
    x's dtype first."""
    _check(x, centroids)
    _kernels.PLAIN_CALLS["kmeans"] += 1
    B, N, D = x.shape
    K = centroids.shape[1]
    cf = centroids.to(x.dtype).float()
    xf = x.float()
    csq = (cf * cf).sum(-1)  # (B, K)
    dist = csq[:, None, :] - 2.0 * torch.bmm(xf, cf.transpose(1, 2))
    labels = torch.argmin(dist, dim=-1)  # the first index among equal minima
    onehot = torch.zeros(B, N, K, dtype=torch.float32, device=x.device)
    onehot.scatter_(2, labels[..., None], 1.0)
    sums = torch.bmm(onehot.transpose(1, 2), xf)
    counts = onehot.sum(1)
    return labels.to(torch.int32), sums, counts


def kmeans_assign_update(x, centroids):
    """x (B, N, D), centroids (B, K, D). Returns (labels (B, N) int32,
    sums (B, K, D) f32, counts (B, K) f32).

    CUDA tensors launch the kernel (bf16, contiguous, D in {64, 128}, K small
    enough for its shared-memory slab: K <= 256 at D = 128 on an H100) and
    raise on anything else; CPU tensors run the plain version."""
    _check(x, centroids)
    if x.device.type == "cpu":
        return kmeans_assign_update_plain(x, centroids)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, N, D = x.shape
    K = centroids.shape[1]
    c = centroids.to(x.dtype).contiguous()
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or c.device != x.device:
        raise ValueError(f"x: need contiguous bf16 on {x.device}, got {x.dtype}, centroids on {c.device}")
    if D not in (64, 128):
        raise ValueError(f"kernel takes D in (64, 128), got {D}")
    lib = _kernels.lib()
    smem = lib.svt_kmeans_smem_bytes(K, D)
    room = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
    if smem > room:
        raise ValueError(f"K={K} at D={D} needs {smem} B of shared memory (the card has {room}); "
                         "wider K is not ported yet (ROADMAP.md)")
    n_slabs = lib.svt_kmeans_num_slabs(B, N)
    labels = torch.empty(B, N, dtype=torch.int32, device=x.device)
    part_sums = torch.empty(B, n_slabs, K, D, dtype=torch.float32, device=x.device)
    part_counts = torch.empty(B, n_slabs, K, dtype=torch.int32, device=x.device)
    sums = torch.empty(B, K, D, dtype=torch.float32, device=x.device)
    counts = torch.empty(B, K, dtype=torch.float32, device=x.device)
    err = lib.svt_kmeans_assign_update(
        x.data_ptr(), c.data_ptr(), labels.data_ptr(), part_sums.data_ptr(), part_counts.data_ptr(),
        sums.data_ptr(), counts.data_ptr(), B, N, K, D, n_slabs, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _kernels.check(err, "kmeans")
    _kernels.LAUNCHES["kmeans"] += 1
    return labels, sums, counts
