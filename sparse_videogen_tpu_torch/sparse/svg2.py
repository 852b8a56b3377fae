"""SVG2 / SAP in cluster mode (counterpart of sparse_videogen_tpu/sparse/svg2.py):
k-means -> dynamic map -> popularity relabel -> block-aligned q permutation
and unpadded cluster-sorted K/V -> run-list attention -> inverse permutation.

The k-means warm start is an explicit carry (SAPState), one per attention
layer and stream, threaded through the denoising loop by the runtime. The
TPU-only options raise NotImplementedError: block_mode="tile" (and its
tile_order), relabel="pc1", text-last layouts (HunyuanVideo) and the
force_density bench override (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from sparse_videogen_tpu_torch.config import SAPConfig, TextPosition, VideoLayout, WarmupSchedule
from sparse_videogen_tpu_torch.core import permute as core_permute
from sparse_videogen_tpu_torch.core.dynamic_map import density_calculation, identify_dynamic_map
from sparse_videogen_tpu_torch.core.kmeans import batch_kmeans, init_centroids
from sparse_videogen_tpu_torch.ops import metadata as MD
from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_runs


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
    """Raise NotImplementedError on the options this package does not run."""
    if cfg.block_mode != "cluster":
        raise NotImplementedError(f"SAP block_mode={cfg.block_mode!r} (tile mode) is not ported to the torch "
                                  "package yet (ROADMAP.md)")
    if cfg.relabel not in ("auto", "popularity"):
        raise NotImplementedError(f"SAP relabel={cfg.relabel!r} is not ported to the torch package yet (ROADMAP.md)")
    if cfg.force_density is not None:
        raise NotImplementedError("SAP force_density (a TPU bench override) is not carried into the torch package")
    if cfg.kmeans_metric != "euclid":
        raise NotImplementedError(f"k-means metric {cfg.kmeans_metric!r} is not ported to the torch package yet "
                                  "(ROADMAP.md)")
    if layout.text_position != TextPosition.NONE or layout.context_length:
        raise NotImplementedError(
            "SAP with text tokens in the sequence (HunyuanVideo's text-last SAP layouts: the text clusters of "
            "svg2.py _extend_text_clusters/_extend_text_dyn and K3 over them; CogVideoX's text first, which the "
            "reference runs with SVG1 or dense only) is not ported to the torch package yet (ROADMAP.md)")


def _kmeans_with_warmstart(x, n_clusters, state_centroids, initialized, cfg: SAPConfig, generator, init_idx):
    """Warm: kmeans_iter_step iterations from the carried centroids. Cold:
    random tokens (init_idx, else drawn from generator), kmeans_iter_init
    iterations."""
    if initialized:
        return batch_kmeans(x, n_clusters, cfg.kmeans_iter_step, state_centroids.to(x.dtype),
                            metric=cfg.kmeans_metric)
    init = init_centroids(x, n_clusters, generator, idx=init_idx)
    return batch_kmeans(x, n_clusters, cfg.kmeans_iter_init, init, metric=cfg.kmeans_metric)


def sap_cluster(q, k, state: SAPState, cfg: SAPConfig, generator=None, init_idx=None):
    """Per-head k-means on Q and K, q/k (BH, S, D). init_idx = (q indices
    (BH, QC), k indices (BH, KC)) hands in the cold-start draws. Returns
    (qlab, qcent, qsz), (klab, kcent, ksz), new_state."""
    qi, ki = (None, None) if init_idx is None else init_idx
    qlab, qcent, qsz = _kmeans_with_warmstart(q, cfg.num_q_centroids, state.q_centroids, state.initialized, cfg,
                                              generator, qi)
    klab, kcent, ksz = _kmeans_with_warmstart(k, cfg.num_k_centroids, state.k_centroids, state.initialized, cfg,
                                              generator, ki)
    new_state = SAPState(qcent.to(state.q_centroids.dtype), kcent.to(state.k_centroids.dtype), True,
                         state.last_density)
    return (qlab, qcent, qsz), (klab, kcent, ksz), new_state


def popularity_relabel(dyn_map, klab, ksz, kcent):
    """Relabel KV clusters by descending keep-popularity (a stable sort:
    popularity is an integer count and ties are common). Layout only: the
    attention output does not change. Returns (dyn_map, klab, ksz, kcent)
    in the new cluster order."""
    BH, KC = ksz.shape
    dyn = dyn_map.reshape(BH, -1, KC)
    pop = dyn.sum(-2)  # over q clusters
    order = torch.argsort(-pop, dim=-1, stable=True)  # new -> old
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(KC, device=order.device).expand(BH, KC))
    klab2 = rank.gather(1, klab.long())
    ksz2 = ksz.gather(1, order)
    kcent2 = kcent.gather(1, order[..., None].expand(-1, -1, kcent.shape[-1]))
    dyn2 = dyn.gather(-1, order[:, None, :].expand(-1, dyn.shape[1], -1))
    return dyn2, klab2, ksz2, kcent2


@dataclasses.dataclass
class SAPKernelArgs:
    """What SAP's front half hands the run-list attention: the permuted
    inputs, the run lists, the inverse map and the new state."""

    q: torch.Tensor  # (BH, sq_pad, D) block-aligned cluster-sorted queries
    k: torch.Tensor  # (BH, sk_pad, D) cluster-sorted keys, unpadded, zero tail
    v: torch.Tensor  # (BH, sk_pad, D)
    meta: torch.Tensor  # (BH, sq_pad // block_q, 1 + 2*cap) int32 run lists
    pos: torch.Tensor  # (BH, S) token -> its row of q
    state: SAPState
    density: torch.Tensor  # (B, H)


def sap_prepare(q, k, v, state: SAPState, *, layout: VideoLayout, cfg: SAPConfig, generator=None,
                init_idx=None) -> SAPKernelArgs:
    """SAP's front half: k-means, dynamic map, relabel, permutations and run
    lists. q, k, v (B, H, S, D)."""
    check_sap_config(cfg, layout)
    B, H, S, D = q.shape
    BH = B * H
    QC, KC = cfg.num_q_centroids, cfg.num_k_centroids
    bq, bkv = cfg.block_q, cfg.block_kv
    qf, kf, vf = (x.reshape(BH, S, D).contiguous() for x in (q, k, v))

    # 1. per-head k-means of Q and K (warm-started after the first call)
    (qlab, qcent, qsz), (klab, kcent, ksz), new_state = sap_cluster(qf, kf, state, cfg, generator, init_idx)

    # 2. cluster-pair top-p selection, and the density it gives
    dyn = identify_dynamic_map(qcent.reshape(B, H, QC, D), kcent.reshape(B, H, KC, D), qsz.reshape(B, H, QC),
                               ksz.reshape(B, H, KC), cfg.top_p_kmeans, cfg.min_kc_ratio)
    density = density_calculation(dyn, qsz.reshape(B, H, QC), ksz.reshape(B, H, KC))
    new_state = dataclasses.replace(new_state, last_density=density.reshape(BH).float())

    # 3. KV clusters in popularity order: each row's runs coalesce
    dyn_f, klab, ksz, _ = popularity_relabel(dyn.reshape(BH, QC, KC), klab, ksz, kcent)

    # 4. queries block-aligned per cluster; K/V cluster-sorted, unpadded
    sq_pad = core_permute.padded_seq_len(S, QC, bq)
    qmaps = core_permute.padded_permutation(qlab, qsz, n_clusters=QC, block=bq, s_pad=sq_pad)
    qp = core_permute.gather_padded(qf, qmaps["src"])
    kperm = torch.sort(klab, dim=-1, stable=True).indices
    sk_pad = max(-(-S // MD.SUB) * MD.SUB, bkv)
    kp, vp = (F.pad(core_permute.flat_row_gather(x, kperm), (0, 0, 0, sk_pad - S)) for x in (kf, vf))

    # 5. run lists per (head, q cluster), expanded to the q blocks
    kstarts = core_permute.exclusive_cumsum(ksz)
    cap = min(cfg.max_runs or KC, KC)
    meta_c = MD.run_meta(dyn_f, kstarts, ksz, block_kv=bkv, cap=cap)
    blk = qmaps["block_to_cluster"]
    meta = meta_c.gather(1, blk[..., None].expand(-1, -1, meta_c.shape[-1])).contiguous()
    meta[..., 0] = torch.where(qmaps["kv_counts"] > 0, meta[..., 0], 0)  # blocks with no real token
    return SAPKernelArgs(qp, kp, vp, meta, qmaps["pos"], new_state, density)


def sap_sparse_attention(q, k, v, state: SAPState, *, layout: VideoLayout, cfg: SAPConfig, generator=None,
                         init_idx=None):
    """The sparse branch. q, k, v (B, H, S, D) -> (out, new_state).

    Any B works (the problems are batched over B*H); the pipeline runs B = 1
    per CFG stream, as the reference requires."""
    a = sap_prepare(q, k, v, state, layout=layout, cfg=cfg, generator=generator, init_idx=init_idx)
    out_pad = block_sparse_attention_runs(a.q, a.k, a.v, a.meta, block_q=cfg.block_q, block_kv=cfg.block_kv)
    return core_permute.ungather_padded(out_pad, a.pos).reshape(q.shape), a.state


def sap_attention(q, k, v, timestep: float, state: SAPState, *, layout: VideoLayout, cfg: SAPConfig,
                  warmup: WarmupSchedule, layer_idx: int, dense_fn, generator=None, init_idx=None):
    """SAP with the dense warm-up: layers < warmup.first_layers and steps with
    timestep > warmup.first_times run dense_fn(q, k, v); with
    zero_step_kmeans_init they also cluster, so the first sparse step starts
    warm. Returns (out, new_state)."""
    if layer_idx < warmup.first_layers or timestep > warmup.first_times:
        if cfg.zero_step_kmeans_init:
            B, H, S, D = q.shape
            vid = layout.video_length
            qv, kv_ = (x[:, :, :vid].reshape(B * H, vid, D).contiguous() for x in (q, k))
            _, _, state = sap_cluster(qv, kv_, state, cfg, generator, init_idx)
        return dense_fn(q, k, v), state
    return sap_sparse_attention(q, k, v, state, layout=layout, cfg=cfg, generator=generator, init_idx=init_idx)
