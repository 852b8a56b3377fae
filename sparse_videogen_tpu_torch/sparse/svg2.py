"""SVG2 / SAP (counterpart of sparse_videogen_tpu/sparse/svg2.py).

Cluster mode: k-means -> dynamic map -> KV relabel (popularity or pc1) ->
block-aligned q permutation and unpadded cluster-sorted K/V -> run-list
attention -> inverse permutation. Tile mode: the token order (k-means
labels seriated along their centroids' PC1, or each token's own PC1 key)
cut into fixed tiles of block_q queries and tile_grain keys, the map
selected between tile centroids, and the chunked-CSR attention (mask kind
none) over metadata built on the device at every call. A text-last layout
(HunyuanVideo) clusters its video tokens only; its prompt and padding
tokens become two more clusters (or, in tile mode, two more tiles).

The k-means warm start is an explicit carry (SAPState), one per attention
layer and stream, threaded through the denoising loop by the runtime.
Asked to (`keep`), cluster mode hands out its decisions (SAPDecisions: the
labels, sizes and map that the run lists encode), left on the device.
`force_density` pins the dynamic map to a prefix of the key clusters, as
the JAX package's benchmarks do. Text-first layouts (CogVideoX) raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from sparse_videogen_tpu_torch.config import SAPConfig, TextPosition, VideoLayout, WarmupSchedule
from sparse_videogen_tpu_torch.core import permute as core_permute
from sparse_videogen_tpu_torch.core.dynamic_map import density_calculation, identify_dynamic_map
from sparse_videogen_tpu_torch.core.kmeans import batch_kmeans, init_centroids
from sparse_videogen_tpu_torch.ops import metadata as MD
from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_kv, block_sparse_attention_runs
from sparse_videogen_tpu_torch.utils import timer
from sparse_videogen_tpu_torch.utils.timer import time_logging


@dataclasses.dataclass
class SAPState:
    """k-means warm-start carry of one attention layer (and stream).

    last_density is the sparse branch's per-head fraction of the S x S
    scores computed, for the density log (utils/density.py of the JAX
    package); dense warm-up steps leave it as it was.
    """

    q_centroids: torch.Tensor  # (B*H, QC, D)
    k_centroids: torch.Tensor  # (B*H, KC, D)
    initialized: bool
    last_density: torch.Tensor  # (B*H,) f32


@dataclasses.dataclass
class SAPDecisions:
    """What cluster mode decided for one layer, as the run-list attention
    received it: after the KV relabel (and, text last, with the prompt and
    padding clusters), token i of head h attends token j exactly where
    dyn[h, qlab[h, i], klab[h, j]]."""

    qlab: torch.Tensor  # (BH, S) integer: the query cluster of each token
    klab: torch.Tensor  # (BH, S) integer: the key cluster of each token
    qsz: torch.Tensor  # (BH, QC) tokens a query cluster
    ksz: torch.Tensor  # (BH, KC) tokens a key cluster
    dyn: torch.Tensor  # (BH, QC, KC) bool, the map


def init_sap_state(batch_heads: int, head_dim: int, cfg: SAPConfig, device="cpu") -> SAPState:
    """Zero centroids, not initialized. The centroids are kept in bf16
    whatever the model's dtype, as the JAX runtime keeps them."""
    return SAPState(
        q_centroids=torch.zeros(batch_heads, cfg.num_q_centroids, head_dim, dtype=torch.bfloat16, device=device),
        k_centroids=torch.zeros(batch_heads, cfg.num_k_centroids, head_dim, dtype=torch.bfloat16, device=device),
        initialized=False,
        last_density=torch.zeros(batch_heads, dtype=torch.float32, device=device),
    )


def check_sap_config(cfg: SAPConfig, layout: VideoLayout) -> None:
    """Raise NotImplementedError on what this package does not run: text
    first in the sequence (CogVideoX, which the reference and the JAX CLIs
    run with SVG1 or dense only)."""
    if layout.text_position == TextPosition.FIRST and layout.context_length:
        raise NotImplementedError("SAP with the text first in the sequence (CogVideoX): the reference runs it with "
                                  "SVG1 or dense only (the JAX package would treat the text as video tokens)")
    if cfg.block_mode not in ("cluster", "tile") or cfg.tile_order not in ("kmeans", "pc1") or cfg.relabel not in (
            "auto", "popularity", "pc1"):
        raise ValueError(f"SAP block_mode={cfg.block_mode!r}, tile_order={cfg.tile_order!r}, "
                         f"relabel={cfg.relabel!r}")
    if cfg.block_mode == "tile" and (cfg.tile_grain or cfg.block_kv) % MD.SUB:
        raise ValueError(f"tile_grain={cfg.tile_grain} must be a multiple of {MD.SUB}")


def _kmeans_with_warmstart(x, n_clusters, state_centroids, initialized, cfg: SAPConfig, generator, init_idx):
    """Warm: kmeans_iter_step iterations from the carried centroids. Cold:
    random tokens (init_idx, else drawn from generator), kmeans_iter_init
    iterations."""
    iters = cfg.kmeans_iter_step if initialized else cfg.kmeans_iter_init
    if timer.counting():
        timer.count(f"sap.lloyd.{n_clusters}", iters)
    if initialized:
        return batch_kmeans(x, n_clusters, iters, state_centroids.to(x.dtype), metric=cfg.kmeans_metric)
    init = init_centroids(x, n_clusters, generator, idx=init_idx)
    return batch_kmeans(x, n_clusters, iters, init, metric=cfg.kmeans_metric)


def sap_cluster(q, k, state: SAPState, cfg: SAPConfig, generator=None, init_idx=None):
    """Per-head k-means on Q and K, q/k (BH, S, D). init_idx = (q indices
    (BH, QC), k indices (BH, KC)) hands in the cold-start draws. Returns
    (qlab, qcent, qsz), (klab, kcent, ksz), new_state."""
    qi, ki = (None, None) if init_idx is None else init_idx
    with time_logging("sap.kmeans"):
        qlab, qcent, qsz = _kmeans_with_warmstart(q, cfg.num_q_centroids, state.q_centroids, state.initialized,
                                                  cfg, generator, qi)
        klab, kcent, ksz = _kmeans_with_warmstart(k, cfg.num_k_centroids, state.k_centroids, state.initialized,
                                                  cfg, generator, ki)
    new_state = SAPState(qcent.to(state.q_centroids.dtype), kcent.to(state.k_centroids.dtype), True,
                         state.last_density)
    return (qlab, qcent, qsz), (klab, kcent, ksz), new_state


def _reorder_clusters(order, dyn_map, klab, ksz, kcent):
    """Renumber KV clusters so that new cluster i is old order[i]: returns
    (dyn_map, klab, ksz, kcent) in the new order."""
    BH, KC = ksz.shape
    dyn = dyn_map.reshape(BH, -1, KC)
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(KC, device=order.device).expand(BH, KC))
    klab2 = rank.gather(1, klab.long())
    ksz2 = ksz.gather(1, order)
    kcent2 = kcent.gather(1, order[..., None].expand(-1, -1, kcent.shape[-1]))
    dyn2 = dyn.gather(-1, order[:, None, :].expand(-1, dyn.shape[1], -1))
    return dyn2, klab2, ksz2, kcent2


def popularity_relabel(dyn_map, klab, ksz, kcent):
    """Relabel KV clusters by descending keep-popularity (a stable sort:
    popularity is an integer count and ties are common). Layout only: the
    attention output does not change. Returns (dyn_map, klab, ksz, kcent)
    in the new cluster order."""
    BH, KC = ksz.shape
    pop = dyn_map.reshape(BH, -1, KC).sum(-2)  # over q clusters
    return _reorder_clusters(torch.argsort(-pop, dim=-1, stable=True), dyn_map, klab, ksz, kcent)


def _power_pc1(cov_mv, BH, D, device):
    """8 fixed power iterations from ones: v <- cov v / |cov v| (at least
    1e-20), cov_mv the product; (BH, D, 1) f32."""
    v = torch.ones(BH, D, 1, dtype=torch.float32, device=device)
    for _ in range(8):
        v = cov_mv(v)
        v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True).clamp_min(1e-20)
    return v


def pc1_order(cent, sizes):
    """Size-weighted centroid-PC1 seriation: (order new -> old, rank old ->
    new). cent (BH, C, D), sizes (BH, C); PC1 of the size-weighted centroid
    covariance by _power_pc1, clusters sorted by their projection (stable)."""
    w = sizes[..., None].float()
    c = cent.float()
    mu = (c * w).sum(1, keepdim=True) / w.sum(1, keepdim=True).clamp_min(1.0)
    cw = (c - mu) * w.sqrt()
    v = _power_pc1(lambda v: torch.einsum("bkd,bke->bde", cw, cw @ v), c.shape[0], c.shape[-1], c.device)
    key = ((c - mu) @ v)[..., 0]
    order = torch.argsort(key, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return order, rank


def seriate_labels(lab, cent, sizes, n_clusters: int):
    """Relabel tokens so that cluster ids follow the centroids' PC1 order
    (tile mode's ordering: tiles slice the label-sorted tokens, and adjacent
    ids are then similar clusters). Returns (BH, N) int64."""
    return pc1_order(cent, sizes)[1].gather(1, lab.long())


def pc1_relabel(dyn_map, klab, ksz, kcent):
    """Relabel KV clusters along the PC1 of their size-weighted centroids
    (layout only, as popularity_relabel): a row's selected clusters then lie
    in fewer runs. Returns (dyn_map, klab, ksz, kcent) in the new order."""
    BH, KC = ksz.shape
    order, _ = pc1_order(kcent.reshape(BH, KC, -1), ksz.reshape(BH, KC))
    return _reorder_clusters(order, dyn_map, klab, ksz, kcent)


def token_pc1_keys(x):
    """Per-head sort keys of tile_order="pc1": each token's projection on
    the PC1 of the token covariance (_power_pc1), (BH, S, D) -> (BH, S) f32.
    The products are f32 sums of x's values; the keys project x on PC1
    rounded to x's dtype, as the JAX package does."""
    BH, S, D = x.shape
    xf = x.float()
    mu = xf.mean(1)
    cov = torch.einsum("bsd,bse->bde", xf, xf) / S - mu[:, :, None] * mu[:, None, :]
    v = _power_pc1(lambda v: cov @ v, BH, D, x.device)
    return torch.einsum("bsd,bd->bs", xf, v[..., 0].to(x.dtype).float())


def tile_sizes(n_tokens: int, grain: int, n_tiles: int, batch: int, device="cpu"):
    """(batch, n_tiles) int32: `grain` tokens a tile, the last one partial."""
    sizes = (n_tokens - torch.arange(n_tiles, device=device) * grain).clamp(0, grain)
    return sizes[None].expand(batch, n_tiles).to(torch.int32)


def tile_centroids(xs, sizes, grain: int, n_tiles: int):
    """Means over fixed `grain`-token tiles of an already sorted (BH, L, D)
    token array (rows past the tokens are zero padding; sizes exclude them).
    f32 sums, returned in xs's dtype."""
    BH, L, D = xs.shape
    if n_tiles * grain > L:
        xs = F.pad(xs, (0, 0, 0, n_tiles * grain - L))
    sums = xs[:, :n_tiles * grain].reshape(BH, n_tiles, grain, D).float().sum(2)
    return (sums / sizes[..., None].float().clamp_min(1.0)).to(xs.dtype)


def tile_quantize(x, lab, grain: int, n_tiles: int):
    """Tokens re-labelled into fixed `grain`-token tiles of their label-
    sorted order (a stable sort): (tile labels, tile sizes, tile centroids,
    perm new -> old, rank old -> new). A test oracle: sap_prepare composes
    the same pieces around one gather."""
    BH, S, D = x.shape
    perm = torch.sort(lab, dim=-1, stable=True).indices
    rank = torch.argsort(perm, dim=-1)
    sizes = tile_sizes(S, grain, n_tiles, BH, x.device)
    cent = tile_centroids(core_permute.flat_row_gather(x, perm), sizes, grain, n_tiles)
    return (rank // grain).to(torch.int32), sizes, cent, perm, rank


def _extend_text_dyn(dyn_f, layout: VideoLayout, QC: int, KC: int):
    """A (BH, QC, KC) map with the prompt (QC, KC) and padding (QC + 1,
    KC + 1) clusters of a text-last layout: prompt q attends the video and
    the prompt, every video q attends the prompt, padding q attends padding."""
    pl_ = layout.prompt_length
    ul = layout.context_length - pl_
    dyn2 = F.pad(dyn_f, (0, 2, 0, 2))
    if pl_ > 0:
        dyn2[:, QC, :KC + 1] = True
        dyn2[:, :QC, KC] = True
    if ul > 0:
        dyn2[:, QC + 1, KC + 1] = True
    return dyn2


def _extend_text_clusters(dyn_f, qlab, qsz, klab, ksz, layout: VideoLayout):
    """Text-last layouts (HunyuanVideo): the prompt and padding tokens as two
    more clusters (ids C and C + 1, their tokens the unpermuted text tail) of
    the map, labels and sizes, so the cluster path runs unchanged (the
    reference's dynamic_map_post_processing). Returns (dyn, qlab, qsz,
    klab, ksz)."""
    BH = qlab.shape[0]
    pl_ = layout.prompt_length
    ul = layout.context_length - pl_
    QC, KC = qsz.shape[-1], ksz.shape[-1]

    def ext_labels(lab, C):
        return torch.cat([lab.long(), torch.full((BH, pl_), C, dtype=torch.long, device=lab.device),
                          torch.full((BH, ul), C + 1, dtype=torch.long, device=lab.device)], dim=-1)

    def ext_sizes(sz):
        return torch.cat([sz, torch.full((BH, 1), pl_, dtype=sz.dtype, device=sz.device),
                          torch.full((BH, 1), ul, dtype=sz.dtype, device=sz.device)], dim=-1)

    return (_extend_text_dyn(dyn_f, layout, QC, KC), ext_labels(qlab, QC), ext_sizes(qsz), ext_labels(klab, KC),
            ext_sizes(ksz))


@dataclasses.dataclass
class SAPKernelArgs:
    """What SAP's front half hands the attention: the permuted inputs, the
    metadata, the inverse map and the new state. kernel "runs": run lists
    for the run-list kernel (cluster mode); "csr": chunked-CSR rows for the
    chunked-CSR kernel with mask kind none (tile mode)."""

    q: torch.Tensor  # (BH, sq_pad, D) block-aligned permuted queries
    k: torch.Tensor  # (BH, sk_pad, D) permuted keys, zero padding
    v: torch.Tensor  # (BH, sk_pad, D)
    meta: torch.Tensor  # (BH, sq_pad // block_q, 1 + 2*cap) int32
    pos: torch.Tensor  # (BH, S) token -> its row of q
    state: SAPState
    density: torch.Tensor  # (B, H)
    kernel: str = "runs"
    decisions: SAPDecisions | None = None  # cluster mode


def _text_last(layout: VideoLayout) -> bool:
    return layout.text_position == TextPosition.LAST and layout.context_length > 0


def _pad_rows(x, n: int):
    """x (BH, L, D) zero-padded to n rows (unchanged when L >= n)."""
    return F.pad(x, (0, 0, 0, n - x.shape[1])) if n > x.shape[1] else x


def sap_prepare(q, k, v, state: SAPState, *, layout: VideoLayout, cfg: SAPConfig, generator=None,
                init_idx=None) -> SAPKernelArgs:
    """SAP's front half, q, k, v (B, H, S, D): the token order (per-head
    k-means of the video tokens, or their PC1 keys under tile_order "pc1"),
    the dynamic map and its density, then the permutations and metadata of
    cluster mode (run lists) or tile mode (chunked CSR)."""
    check_sap_config(cfg, layout)
    B, H, S, D = q.shape
    vl = layout.video_length if _text_last(layout) else S
    qf, kf, vf = (x.reshape(B * H, S, D).contiguous() for x in (q, k, v))
    if cfg.block_mode == "tile" and cfg.tile_order == "pc1":
        return _tile_prepare(qf, kf, vf, token_pc1_keys(qf[:, :vl]), token_pc1_keys(kf[:, :vl]), state, B, H,
                             layout, cfg)
    qv, kv_ = (x if vl == S else x[:, :vl].contiguous() for x in (qf, kf))
    (qlab, qcent, qsz), (klab, kcent, ksz), new_state = sap_cluster(qv, kv_, state, cfg, generator, init_idx)
    if cfg.block_mode == "tile":
        QC, KC = cfg.num_q_centroids, cfg.num_k_centroids
        return _tile_prepare(qf, kf, vf, seriate_labels(qlab, qcent, qsz, QC), seriate_labels(klab, kcent, ksz, KC),
                             new_state, B, H, layout, cfg)
    return _cluster_prepare(qf, kf, vf, (qlab, qcent, qsz), (klab, kcent, ksz), new_state, B, H, layout, cfg)


def _map_and_density(qcent, kcent, qsz, ksz, state, B, H, cfg):
    """The top-p dynamic map (BH, QC, KC), the density (B, H) and the state
    that records it. cfg.force_density = f pins the map instead to the first
    ceil(f KC) key clusters (or tiles) of every query cluster: a benchmark's
    knob for a chosen density (random weights give flat maps); the k-means,
    the relabel, the metadata and the kernel stay the real computation."""
    QC, KC, D = qsz.shape[-1], ksz.shape[-1], qcent.shape[-1]
    with time_logging("sap.map"):
        if cfg.force_density is not None:
            keep = torch.arange(KC, device=qsz.device) < math.ceil(cfg.force_density * KC)
            dyn = keep.expand(B, H, QC, KC)
        else:
            dyn = identify_dynamic_map(qcent.reshape(B, H, QC, D), kcent.reshape(B, H, KC, D),
                                       qsz.reshape(B, H, QC), ksz.reshape(B, H, KC), cfg.top_p_kmeans,
                                       cfg.min_kc_ratio)
        density = density_calculation(dyn, qsz.reshape(B, H, QC), ksz.reshape(B, H, KC))
        if timer.counting():
            # the real pairs the map allows (density's numerator), exact in int64
            timer.count("sap.pairs", ((dyn * ksz.reshape(B, H, 1, KC)).sum(-1) * qsz.reshape(B, H, QC)).sum())
    return dyn.reshape(B * H, QC, KC), density, dataclasses.replace(state, last_density=density.reshape(-1).float())


def _cluster_prepare(qf, kf, vf, qside, kside, state, B, H, layout, cfg) -> SAPKernelArgs:
    """Cluster mode: KV clusters relabelled (popularity, or pc1), a text-last
    layout's prompt and padding clusters appended, queries block-aligned
    per cluster, K/V cluster-sorted unpadded, run lists expanded to the q
    blocks."""
    (qlab, qcent, qsz), (klab, kcent, ksz) = qside, kside
    BH, S, _ = qf.shape
    bq, bkv = cfg.block_q, cfg.block_kv
    dyn_f, density, new_state = _map_and_density(qcent, kcent, qsz, ksz, state, B, H, cfg)
    relabel = pc1_relabel if cfg.relabel == "pc1" else popularity_relabel
    dyn_f, klab, ksz, _ = relabel(dyn_f, klab, ksz, kcent)
    text_last = _text_last(layout)
    if text_last:
        dyn_f, qlab, qsz, klab, ksz = _extend_text_clusters(dyn_f, qlab, qsz, klab, ksz, layout)
    QC, KC = qsz.shape[-1], ksz.shape[-1]
    sq_pad = core_permute.padded_seq_len(S, QC, bq)
    with time_logging("sap.permute"):
        qmaps = core_permute.padded_permutation(qlab, qsz, n_clusters=QC, block=bq, s_pad=sq_pad)
        qp = core_permute.gather_padded(qf, qmaps["src"])
        kperm = torch.sort(klab, dim=-1, stable=True).indices
        sk_pad = max(-(-S // MD.SUB) * MD.SUB, bkv)
        kp, vp = (_pad_rows(core_permute.flat_row_gather(x, kperm), sk_pad) for x in (kf, vf))
    cap = min((cfg.max_runs or KC) + (2 if text_last else 0), KC)
    meta_c = MD.run_meta(dyn_f, core_permute.exclusive_cumsum(ksz), ksz, block_kv=bkv, cap=cap)
    blk = qmaps["block_to_cluster"]
    meta = meta_c.gather(1, blk[..., None].expand(-1, -1, meta_c.shape[-1])).contiguous()
    meta[..., 0] = torch.where(qmaps["kv_counts"] > 0, meta[..., 0], 0)  # blocks with no real token
    if timer.counting():
        # the rows of the q blocks that hold a real token: each cluster padded to block_q
        timer.count("sap.q_rows", (-(-qsz.long() // bq) * bq).sum())
        timer.count("sap.q_real", BH * S)
    return SAPKernelArgs(qp, kp, vp, meta, qmaps["pos"], new_state, density, "runs",
                         SAPDecisions(qlab, klab, qsz, ksz, dyn_f))


# the static index tensors of a tile layout, made once per (layout, blocks,
# device): a copy from the host at every layer would wait for the device


@functools.lru_cache(maxsize=16)
def _seq_counts(n_tokens: int, nsub: int, device: str):
    """(1, nsub) valid tokens of each sub-block of n_tokens in nsub sub-blocks."""
    return torch.as_tensor(MD.kv_counts_for_seq(n_tokens, nsub * MD.SUB), device=device)


@functools.lru_cache(maxsize=16)
def _text_last_statics(layout: VideoLayout, bq: int, bkv: int, kv_grain: int, device: str):
    """A text-last tile layout's (s2c, counts, qb, valid, cap): the tile
    (video tiles, then prompt n_kc, padding n_kc + 1) and the valid tokens
    of each K/V sub-block, the tile row and the holding of a token of each q
    block, and the chunk cap of a row."""
    vl = layout.video_length
    n_kc, n_qc = -(-vl // kv_grain), -(-vl // bq)
    pl_, ul = layout.prompt_length, layout.context_length - layout.prompt_length
    n_video_pad = n_kc * kv_grain
    pl_pad, ul_pad = (-(-x // MD.SUB) * MD.SUB for x in (pl_, ul))
    nsub = max(n_video_pad + pl_pad + ul_pad, bkv) // MD.SUB
    s2c = np.concatenate([np.repeat(np.arange(n_kc), kv_grain // MD.SUB), np.full(pl_pad // MD.SUB, n_kc),
                          np.full(ul_pad // MD.SUB, n_kc + 1)])
    counts = np.concatenate([MD.kv_counts_for_seq(vl, n_video_pad), MD.kv_counts_for_seq(pl_, pl_pad),
                             MD.kv_counts_for_seq(ul, ul_pad)], axis=-1)
    # padding sub-blocks alias tile 0 with count 0: chunk_meta emits none
    s2c = np.pad(s2c, (0, nsub - len(s2c)))
    counts = np.pad(counts, ((0, 0), (0, nsub - counts.shape[-1])))
    pl_qb, ul_qb = -(-pl_ // bq), -(-ul // bq)
    qb = np.concatenate([np.arange(n_qc), np.full(pl_qb, n_qc), np.full(ul_qb, n_qc + 1)])
    valid = np.concatenate([np.ones(n_qc, bool), np.arange(pl_qb) * bq < pl_, np.arange(ul_qb) * bq < ul])
    cap = min(nsub, n_kc * -(-kv_grain // bkv) + -(-pl_pad // bkv) + -(-ul_pad // bkv) + 4)
    return (*(torch.as_tensor(a, device=device) for a in (s2c, counts, qb, valid)), cap)


def _tile_prepare(qf, kf, vf, qkeys, kkeys, state, B, H, layout, cfg) -> SAPKernelArgs:
    """Tile mode: tokens sorted by their keys (one stable sort a side, the
    sort is the permutation), tiles of block_q queries and tile_grain (else
    block_kv) keys cut from that order, the map selected between tile
    centroids, and chunked-CSR rows for the chunked-CSR kernel (mask kind
    none). A text-last layout keeps a grain-aligned layout: q is the video
    tiles, then the prompt, then the padding, each block_q-aligned; K/V the
    video tiles, then the prompt and the padding, each 128-aligned."""
    BH, S, D = qf.shape
    bq, bkv = cfg.block_q, cfg.block_kv
    kv_grain = cfg.tile_grain or bkv
    text_last = _text_last(layout)
    vl = layout.video_length if text_last else S
    QC, KC = -(-vl // bq), -(-vl // kv_grain)
    with time_logging("sap.permute"):
        qperm = torch.sort(qkeys, dim=-1, stable=True).indices
        kperm = torch.sort(kkeys, dim=-1, stable=True).indices
        qrank = torch.argsort(qperm, dim=-1)
        qp = core_permute.flat_row_gather(qf[:, :vl], qperm)
        kp, vp = (core_permute.flat_row_gather(x[:, :vl], kperm) for x in (kf, vf))
    qsz, ksz = tile_sizes(vl, bq, QC, BH, qf.device), tile_sizes(vl, kv_grain, KC, BH, qf.device)
    dyn_f, density, new_state = _map_and_density(tile_centroids(qp, qsz, bq, QC),
                                                 tile_centroids(kp, ksz, kv_grain, KC), qsz, ksz, state, B, H, cfg)
    qp = _pad_rows(qp, QC * bq)
    if text_last:
        pl_, ul = layout.prompt_length, layout.context_length - layout.prompt_length
        pl_q, ul_q = (-(-x // bq) * bq for x in (pl_, ul))
        pl_k, ul_k = (-(-x // MD.SUB) * MD.SUB for x in (pl_, ul))
        text_pos = torch.cat([torch.arange(pl_, device=qf.device) + QC * bq,
                              torch.arange(ul, device=qf.device) + QC * bq + pl_q])
        pos = torch.cat([qrank, text_pos.expand(BH, -1)], dim=-1)
        qp = torch.cat([qp, _pad_rows(qf[:, vl:vl + pl_], pl_q), _pad_rows(qf[:, vl + pl_:], ul_q)], dim=1)
        s2c, counts, qb, valid, cap = _text_last_statics(layout, bq, bkv, kv_grain, str(qf.device))
        nsub = len(s2c)
        kp, vp = (_pad_rows(torch.cat([_pad_rows(a, KC * kv_grain), _pad_rows(x[:, vl:vl + pl_], pl_k),
                                       _pad_rows(x[:, vl + pl_:], ul_k)], dim=1), nsub * MD.SUB)
                  for a, x in ((kp, kf), (vp, vf)))
        dyn_f = _extend_text_dyn(dyn_f, layout, QC, KC)
        meta_c = MD.chunk_meta(dyn_f[..., s2c], counts.expand(BH, -1), block_kv=bkv, cap=cap)
        meta = meta_c[:, qb].contiguous()
        meta[..., 0] = torch.where(valid, meta[..., 0], 0)
    else:
        pos = qrank
        nsub = max(-(-S // MD.SUB) * MD.SUB, bkv) // MD.SUB
        kp, vp = (_pad_rows(x, nsub * MD.SUB) for x in (kp, vp))
        if kv_grain == bkv:  # each selected tile is one chunk
            meta = MD.tile_meta(dyn_f, block_kv=bkv, n_tokens=S, nsub=nsub, cap=min(KC, nsub))
        else:
            mask = dyn_f.repeat_interleave(kv_grain // MD.SUB, dim=-1)
            mask = F.pad(mask, (0, max(0, nsub - mask.shape[-1])))[..., :nsub]
            cap = min(nsub, KC * -(-kv_grain // bkv) + 2)
            meta = MD.chunk_meta(mask, _seq_counts(S, nsub, str(qf.device)).expand(BH, -1), block_kv=bkv, cap=cap)
    return SAPKernelArgs(qp, kp.contiguous(), vp.contiguous(), meta, pos, new_state, density, "csr")


def sap_sparse_attention(q, k, v, state: SAPState, *, layout: VideoLayout, cfg: SAPConfig, generator=None,
                         init_idx=None, keep=None):
    """The sparse branch. q, k, v (B, H, S, D) -> (out, new_state).

    Any B works (the problems are batched over B*H); the pipeline runs B = 1
    per CFG stream, as the reference requires. `keep`: a list that gets the
    call's SAPDecisions appended (cluster mode)."""
    a = sap_prepare(q, k, v, state, layout=layout, cfg=cfg, generator=generator, init_idx=init_idx)
    if keep is not None and a.decisions is not None:
        keep.append(a.decisions)
    attend = block_sparse_attention_kv if a.kernel == "csr" else block_sparse_attention_runs
    out_pad = attend(a.q, a.k, a.v, a.meta, block_q=cfg.block_q, block_kv=cfg.block_kv)
    with time_logging("sap.permute"):
        out = core_permute.ungather_padded(out_pad, a.pos).reshape(q.shape)
    return out, a.state


def sap_attention(q, k, v, timestep: float, state: SAPState, *, layout: VideoLayout, cfg: SAPConfig,
                  warmup: WarmupSchedule, layer_idx: int, dense_fn, generator=None, init_idx=None, keep=None):
    """SAP with the dense warm-up: layers < warmup.first_layers and steps with
    timestep > warmup.first_times run dense_fn(q, k, v); with
    zero_step_kmeans_init they also cluster, so the first sparse step starts
    warm. `keep` goes to sap_sparse_attention. Returns (out, new_state)."""
    if layer_idx < warmup.first_layers or timestep > warmup.first_times:
        if cfg.zero_step_kmeans_init:
            B, H, S, D = q.shape
            vid = layout.video_length
            qv, kv_ = (x[:, :, :vid].reshape(B * H, vid, D).contiguous() for x in (q, k))
            _, _, state = sap_cluster(qv, kv_, state, cfg, generator, init_idx)
        return dense_fn(q, k, v), state
    return sap_sparse_attention(q, k, v, state, layout=layout, cfg=cfg, generator=generator, init_idx=init_idx,
                                keep=keep)
