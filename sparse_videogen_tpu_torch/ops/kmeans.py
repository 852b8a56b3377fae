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

`kmeans_variant_pass` runs one of the probe's five variants on K5's first
kernel, csrc/kmeans_wide.cu (any K; an assign kernel that streams the
centroids by cp.async into mma.sync, and a K-partitioned update), which K8
keeps; `kmeans_variant_pass_plain` is its plain version:
  A  argmin labels; sums and counts from their one-hot
  B  the same labels by a two-min tiebreak (min, then the first k at it)
  C  B, with the counts as a product (onehot^T 1)
  D  no labels (all 0); multi-hot dist <= min: a tied token adds to every
     tied cluster
  E  argmin labels only; sums and counts 0
A, B and C give the same labels, sums and counts as each other (K5's
labels too, but at near-ties, where the two kernels' f32 sums may round
apart).
"""

from __future__ import annotations

import torch

from sparse_videogen_tpu_torch import _kernels

VARIANTS = ("A", "B", "C", "D", "E")
CH, SEG = 1024, 128  # K5's counting-sort chunk and sum segment, in tokens (csrc/kmeans_lloyd.cu)
# tied clusters the kernel keeps per token in variant D, more raise (TIES in csrc/kmeans_wide.cu)
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


def _wide_pass(x, c, variant):
    B, N, D = x.shape
    K = c.shape[1]
    dev = x.device
    lib = _kernels.lib()
    n_slabs = lib.svt_kmeans_wide_num_slabs(B, N, K)
    csq = torch.empty(B, -(-K // 64) * 64, dtype=torch.float32, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    lab_buf = torch.empty((B, N, D_TIES) if variant == "D" else (B, N), dtype=torch.int32, device=dev)
    outs = [None] * 4  # part_sums, part_counts, sums, counts: E writes none
    if variant != "E":
        outs = [torch.empty(B, n_slabs, K, D, dtype=torch.float32, device=dev),
                torch.empty(B, n_slabs, K, dtype=torch.int32, device=dev),
                torch.empty(B, K, D, dtype=torch.float32, device=dev),
                torch.empty(B, K, dtype=torch.float32, device=dev)]
    err = lib.svt_kmeans_wide(
        x.data_ptr(), c.data_ptr(), csq.data_ptr(), lab_buf.data_ptr(), overflow.data_ptr(),
        *(None if t is None else t.data_ptr() for t in outs), B, N, K, D,
        VARIANTS.index(variant), n_slabs, torch.cuda.current_stream(dev).cuda_stream,
    )
    sums, counts = outs[2:]
    _kernels.check(err, "kmeans_wide")
    if variant == "E":
        return lab_buf, torch.zeros(B, K, D, dtype=torch.float32, device=dev), torch.zeros(B, K, device=dev)
    if variant == "D":
        if int(overflow.item()):  # a host sync: the probe's D only
            raise RuntimeError(f"variant D: {int(overflow.item())} tokens tie more than {D_TIES} clusters")
        return torch.zeros(B, N, dtype=torch.int32, device=dev), sums, counts
    return lab_buf, sums, counts


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


def _lloyd_pass(x, c):
    B, N, D = x.shape
    K = c.shape[1]
    dev = x.device
    lib = _kernels.lib()
    labels = torch.empty(B, N, dtype=torch.int32, device=dev)
    sums = torch.empty(B, K, D, dtype=torch.float32, device=dev)
    counts = torch.empty(B, K, dtype=torch.float32, device=dev)
    work = torch.empty(lib.svt_kmeans_lloyd_workspace(B, N, K, D), dtype=torch.uint8, device=dev)
    err = lib.svt_kmeans_lloyd(x.data_ptr(), c.data_ptr(), labels.data_ptr(), sums.data_ptr(), counts.data_ptr(),
                               work.data_ptr(), B, N, K, D, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(err, "kmeans_wide")
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
    c = _cuda_args(x, centroids)
    if c.shape[1] > 14000:
        raise ValueError(f"K={c.shape[1]}: K5 takes K <= 14000")
    out = _lloyd_pass(x, c)
    _kernels.launched("kmeans_wide")
    return out


def kmeans_variant_pass(x, centroids, variant: str):
    """Probe variant `variant` (module docstring) of the pass on the kernel
    at any K for CUDA tensors (bf16, contiguous, D in {64, 128}); its
    plain version for CPU tensors. Same returns as kmeans_assign_update."""
    _check(x, centroids)
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if x.device.type == "cpu":
        return kmeans_variant_pass_plain(x, centroids, variant)
    out = _wide_pass(x, _cuda_args(x, centroids), variant)
    _kernels.launched("kmeans_variants")
    return out
