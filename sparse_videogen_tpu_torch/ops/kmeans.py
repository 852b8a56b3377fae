"""Fused k-means Lloyd pass (counterpart of sparse_videogen_tpu/ops/kmeans_pallas.py)
and its variant probe (counterpart of scripts/probe_kmeans_variants.py).

One pass over x computes both the nearest-centroid labels and the per-cluster
f32 sums and counts that the centroid update needs (core/kmeans.py).

`kmeans_assign_update` launches K5 for CUDA tensors (csrc/kmeans_lloyd.cu,
any K: a TMA + wgmma assign kernel with a running argmin, then a
deterministic sorted update: a stable counting sort of the token ids by
label and per-cluster segment sums in token order) and the plain version
for CPU tensors. `kmeans_assign_update_plain` is the plain version itself,
the kernel's oracle on the card; `sorted_update_order` is the torch model of
the update's counting sort and segments. The TPU's padding of K to 128
lanes with +inf distances and of N to the block size has no counterpart:
the kernel bounds-checks both.

`kmeans_variant_pass` runs one of the probe's five variants (K8) on K5's
kernel, its variant a template parameter of the assign (csrc/kmeans_lloyd.cu);
`kmeans_variant_pass_plain` is its plain version:
  A  argmin labels; sums and counts from their one-hot: K5's pass itself
  B  the same labels by a two-min tiebreak (per 128-centroid tile the min,
     then the first k at it; tiles merge by a strict <)
  C  B, with the counts as a product on the tensor cores (onehot^T 1)
  D  no labels (all 0); multi-hot dist <= min: a tied token adds to every
     tied cluster (up to D_TIES a token)
  E  argmin labels only; sums and counts 0
A, B and C give the same labels, sums and counts as each other and as K5,
bit for bit.
"""

from __future__ import annotations

import torch

from sparse_videogen_tpu_torch import _kernels

VARIANTS = ("A", "B", "C", "D", "E")
CH, SEG = 1024, 128  # K5's counting-sort chunk and sum segment, in tokens (csrc/kmeans_lloyd.cu)
# tied clusters the kernel keeps per token in variant D, more raise (TIES in csrc/kmeans_lloyd.cu)
D_TIES = 4


def _check(x, centroids):
    if x.dim() != 3 or centroids.dim() != 3 or centroids.shape[0] != x.shape[0] or centroids.shape[2] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} and centroids {tuple(centroids.shape)}: need (B, N, D) and (B, K, D)")
    if centroids.shape[1] < 1:
        raise ValueError("need at least one centroid")


def _plain_pass(x, centroids, variant):
    B, N, D = x.shape
    K = centroids.shape[1]
    cf = centroids.to(x.dtype).float()
    xf = x.float()
    csq = (cf * cf).sum(-1)  # (B, K)
    dist = csq[:, None, :] - 2.0 * torch.bmm(xf, cf.transpose(1, 2))
    if variant in ("A", "E"):
        labels = torch.argmin(dist, dim=-1)  # the first index among equal minima
    else:
        hit = dist <= dist.amin(dim=-1, keepdim=True)
        del dist
        iota = torch.arange(K, dtype=torch.int32, device=x.device)
        labels = torch.where(hit, iota, K).amin(dim=-1) if variant != "D" else torch.zeros(B, N, device=x.device)
    if variant == "E":
        return labels.to(torch.int32), x.new_zeros(B, K, D, dtype=torch.float32), x.new_zeros(B, K, dtype=torch.float32)
    if variant == "D":
        onehot = hit.float()
    else:
        onehot = torch.zeros(B, N, K, dtype=torch.float32, device=x.device)
        onehot.scatter_(2, labels.long()[..., None], 1.0)
    sums = torch.bmm(onehot.transpose(1, 2), xf)
    if variant == "C":
        counts = torch.bmm(torch.ones(B, 1, N, device=x.device), onehot)[:, 0]
    else:
        counts = onehot.sum(1)
    return labels.to(torch.int32), sums, counts


def kmeans_assign_update_plain(x, centroids):
    """labels = argmin_k (|c_k|^2 - 2 x.c_k) in f32 (|x|^2 is constant per
    row and left out, as the TPU kernel does), ties to the first index;
    sums = onehot(labels)^T x and counts, both f32. The centroids are cast to
    x's dtype first."""
    _check(x, centroids)
    _kernels.plain_call("kmeans_wide")
    return _plain_pass(x, centroids, "A")


def kmeans_variant_pass_plain(x, centroids, variant: str):
    """Plain version of probe variant `variant` (module docstring); returns
    (labels (B, N) int32, sums (B, K, D) f32, counts (B, K) f32)."""
    _check(x, centroids)
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    _kernels.plain_call("kmeans_variants")
    return _plain_pass(x, centroids, variant)


def _cuda_args(x, centroids):
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    c = centroids.to(x.dtype).contiguous()
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or c.device != x.device:
        raise ValueError(f"x: need contiguous bf16 on {x.device}, got {x.dtype}, centroids on {c.device}")
    if x.shape[2] not in (64, 128):
        raise ValueError(f"kernel takes D in (64, 128), got {x.shape[2]}")
    if x.data_ptr() % 16 or c.data_ptr() % 16:
        raise ValueError("x and centroids must be 16-byte aligned")
    return c


def sorted_update_order(labels, K: int):
    """The torch model of K5's counting sort (csrc/kmeans_lloyd.cu, passes 1-3).
    labels (B, N) -> (perm (B, N), offs (B, K), counts (B, K), seg_start
    (B, K + 1)), int64: label histograms per chunk of CH tokens, each
    (chunk, label)'s start in the order sorted by (label, token), each token's
    rank among its chunk's tokens of its label, perm[start + rank] = token;
    cluster k holds perm[offs[k] : offs[k] + counts[k]] and its segments of at
    most SEG tokens are seg_start[k] : seg_start[k + 1] ([K] their number)."""
    B, N = labels.shape
    lab = labels.long()
    n_ch = -(-N // CH)
    chunk = torch.arange(N, device=lab.device) // CH
    key = chunk * K + lab  # (B, N)
    hist = torch.zeros(B, n_ch * K, dtype=torch.long, device=lab.device).scatter_add_(1, key, torch.ones_like(key))
    hist = hist.view(B, n_ch, K)
    counts = hist.sum(1)
    offs = counts.cumsum(1) - counts
    start = offs[:, None, :] + hist.cumsum(1) - hist  # (B, n_ch, K)
    # rank: tokens before this one in its chunk with its label
    order = torch.argsort(key, dim=1, stable=True)
    sorted_key = key.gather(1, order)
    first = torch.searchsorted(sorted_key, sorted_key, right=False)
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(N, device=lab.device).expand(B, N) - first)
    pos = start.view(B, -1).gather(1, key) + rank
    perm = torch.empty_like(pos).scatter_(1, pos, torch.arange(N, device=lab.device).expand(B, N))
    nseg = (counts + SEG - 1) // SEG
    seg_start = torch.cat([torch.zeros(B, 1, dtype=torch.long, device=lab.device), nseg.cumsum(1)], dim=1)
    return perm, offs, counts, seg_start


def _lloyd_pass(x, c, variant="A"):
    """One pass of `variant` on K5's kernels: (labels, sums, counts), D's
    labels its tie lists (B, N, D_TIES), ascending and -1 past a token's
    last tied k, after a host sync on their overflow count (the probe's D
    only)."""
    B, N, D = x.shape
    K = c.shape[1]
    if K > 14000:
        raise ValueError(f"K={K}: K5 takes K <= 14000")
    dev = x.device
    lib = _kernels.lib()
    v = VARIANTS.index(variant)
    labels = torch.empty((B, N, D_TIES) if variant == "D" else (B, N), dtype=torch.int32, device=dev)
    sums = torch.empty(B, K, D, dtype=torch.float32, device=dev)
    counts = torch.empty(B, K, dtype=torch.float32, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev) if variant == "D" else None
    work = torch.empty(lib.svt_kmeans_lloyd_workspace(B, N, K, D, v), dtype=torch.uint8, device=dev)
    err = lib.svt_kmeans_lloyd(x.data_ptr(), c.data_ptr(), labels.data_ptr(), sums.data_ptr(), counts.data_ptr(),
                               None if overflow is None else overflow.data_ptr(), work.data_ptr(), B, N, K, D, v,
                               torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(err, "kmeans_wide" if variant == "A" else "kmeans_variants")
    if variant == "D" and int(overflow.item()):
        raise RuntimeError(f"variant D: {int(overflow.item())} tokens tie more than {D_TIES} clusters")
    return labels, sums, counts


def kmeans_assign_update(x, centroids):
    """x (B, N, D), centroids (B, K, D). Returns (labels (B, N) int32,
    sums (B, K, D) f32, counts (B, K) f32).

    CUDA tensors launch K5 (bf16, contiguous, D in {64, 128}, any K up to
    14,000: its scatter keeps 4 K ints in shared memory) and raise on
    anything else; CPU tensors run the plain version. Its launches count
    under "kmeans_wide" (the TPU kernel's wide-K branch, whose design it
    first took)."""
    _check(x, centroids)
    if x.device.type == "cpu":
        return kmeans_assign_update_plain(x, centroids)
    out = _lloyd_pass(x, _cuda_args(x, centroids))
    _kernels.launched("kmeans_wide")
    return out


def kmeans_variant_pass(x, centroids, variant: str):
    """Probe variant `variant` (module docstring) of the pass on K5's kernels
    for CUDA tensors (bf16, contiguous, D in {64, 128}, K <= 14,000); its
    plain version for CPU tensors. Same returns as kmeans_assign_update."""
    _check(x, centroids)
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if x.device.type == "cpu":
        return kmeans_variant_pass_plain(x, centroids, variant)
    labels, sums, counts = _lloyd_pass(x, _cuda_args(x, centroids), variant)
    _kernels.launched("kmeans_variants")
    if variant == "D":  # no labels
        labels = torch.zeros(x.shape[:2], dtype=torch.int32, device=x.device)
    return labels, sums, counts
