"""Ring (context-parallel) SAP: the semantic-aware permutation with the
token axis sharded over the ring (counterpart of
sparse_videogen_tpu/parallel/ring_sap.py).

Per rank, on its contiguous token shard:
1. k-means of q and k as global Lloyd without gathering tokens: assignment
   is token-local, the update all-reduces the per-cluster sums and counts
   (core/kmeans.batch_kmeans(comm=)); a cold start draws global token
   indices (init_centroids_sharded).
2. The dynamic map from the replicated centroids and global cluster sizes:
   the same on every rank.
3. The popularity relabel (the same everywhere), then shard-local
   permutations: the shard's q block-aligned per cluster, its k/v sorted by
   cluster.
4. Run lists per kv shard: the shards' cluster sizes are all-gathered (KC
   integers a head), each shard's runs built against its own offsets.
5. The permuted k/v shard rotates around the ring; every rotation runs the
   run-list attention (K3) with `return_stats=True`, and the partial results
   merge with their (m, l) stats in f32 (parallel/ring.merge_partial).
The output equals single-device SAP on the same labels and dynamic map up
to the order of f32 sums.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from sparse_videogen_tpu_torch.config import SAPConfig, VideoLayout
from sparse_videogen_tpu_torch.core import permute as core_permute
from sparse_videogen_tpu_torch.core.dynamic_map import density_calculation, identify_dynamic_map
from sparse_videogen_tpu_torch.core.kmeans import batch_kmeans, init_centroids_sharded, label_counts
from sparse_videogen_tpu_torch.ops import metadata as MD
from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_runs
from sparse_videogen_tpu_torch.parallel.ring import merge_init, merge_partial
from sparse_videogen_tpu_torch.sparse.svg2 import SAPState, check_sap_config, popularity_relabel


def check_ring_sap_config(cfg: SAPConfig, layout: VideoLayout) -> None:
    """check_sap_config, and what the ring (as the JAX package's) does not
    run: tile mode (its tile offsets would differ between shards) and text in
    the sequence (the reference never shards SAP with text). The ring always
    relabels by popularity, as the JAX package's does."""
    check_sap_config(cfg, layout)
    if cfg.block_mode != "cluster" or layout.context_length:
        raise NotImplementedError("ring SAP runs cluster mode on video-only layouts, as the JAX package's ring does")


def _dist_kmeans(x, n_clusters, state_centroids, initialized, cfg: SAPConfig, comm, init_idx):
    """Warm: kmeans_iter_step iterations from the carried centroids. Cold:
    the global tokens init_idx (B, n_clusters), kmeans_iter_init iterations."""
    if initialized:
        return batch_kmeans(x, n_clusters, cfg.kmeans_iter_step, state_centroids.to(x.dtype),
                            metric=cfg.kmeans_metric, comm=comm)
    init = init_centroids_sharded(x, n_clusters, comm, init_idx)
    return batch_kmeans(x, n_clusters, cfg.kmeans_iter_init, init, metric=cfg.kmeans_metric, comm=comm)


def sap_ring_attention(q, k, v, state: SAPState, comm, *, layout: VideoLayout, cfg: SAPConfig, init_idx=None):
    """SAP's sparse branch on this rank's (B, H, Sl, D) token shard (every
    rank's of the same Sl). init_idx = (q indices (B*H, QC), k indices
    (B*H, KC)): the global tokens of a cold start, the same on every rank
    (needed when state.initialized is False). Returns (this rank's output
    (B, H, Sl, D), the new SAPState, the same on every rank)."""
    check_ring_sap_config(cfg, layout)
    B, H, Sl, D = q.shape
    BH = B * H
    QC, KC = cfg.num_q_centroids, cfg.num_k_centroids
    bq, bkv = cfg.block_q, cfg.block_kv
    qf, kf, vf = (x.reshape(BH, Sl, D).contiguous() for x in (q, k, v))
    qi, ki = (None, None) if init_idx is None else init_idx
    if not state.initialized and init_idx is None:
        raise ValueError("a cold start needs init_idx, the global token indices drawn for every rank")

    # 1. distributed k-means: shard-local labels, global centroids and sizes
    qlab, qcent, qsz = _dist_kmeans(qf, QC, state.q_centroids, state.initialized, cfg, comm, qi)
    klab, kcent, ksz = _dist_kmeans(kf, KC, state.k_centroids, state.initialized, cfg, comm, ki)

    # 2. the dynamic map and its density: the same on every rank
    dyn = identify_dynamic_map(qcent.reshape(B, H, QC, D), kcent.reshape(B, H, KC, D), qsz.reshape(B, H, QC),
                               ksz.reshape(B, H, KC), cfg.top_p_kmeans, cfg.min_kc_ratio)
    density = density_calculation(dyn, qsz.reshape(B, H, QC), ksz.reshape(B, H, KC))

    # 3. popularity relabel, then the shard-local permutations
    dyn_f, klab, _, _ = popularity_relabel(dyn.reshape(BH, QC, KC), klab, ksz, kcent)
    sq_pad = core_permute.padded_seq_len(Sl, QC, bq)
    qmaps = core_permute.padded_permutation(qlab, label_counts(qlab, QC), n_clusters=QC, block=bq, s_pad=sq_pad)
    qp = core_permute.gather_padded(qf, qmaps["src"])
    kperm = torch.sort(klab, dim=-1, stable=True).indices
    sk_pad = max(-(-Sl // MD.SUB) * MD.SUB, bkv)
    kv = torch.stack([F.pad(core_permute.flat_row_gather(x, kperm), (0, 0, 0, sk_pad - Sl)) for x in (kf, vf)])

    # 4. run lists against each kv shard's cluster offsets
    cap = min(cfg.max_runs or KC, KC)
    blk = qmaps["block_to_cluster"]
    live = qmaps["kv_counts"] > 0
    metas = []
    for szj in comm.all_gather(label_counts(klab, KC)):
        mc = MD.run_meta(dyn_f, core_permute.exclusive_cumsum(szj), szj, block_kv=bkv, cap=cap)
        mj = mc.gather(1, blk[..., None].expand(-1, -1, mc.shape[-1])).contiguous()
        mj[..., 0] = torch.where(live, mj[..., 0], 0)  # q blocks with no real token
        metas.append(mj)

    # 5. the ring over the kv shards
    state_ml = merge_init((BH, sq_pad), D, q.device)
    n, my = comm.size, comm.rank
    for r in range(n):
        src = (my - r) % n
        o_r, m_r, l_r = block_sparse_attention_runs(qp, kv[0], kv[1], metas[src], block_q=bq, block_kv=bkv,
                                                    return_stats=True)
        state_ml = merge_partial(state_ml, o_r, m_r, l_r)
        if r < n - 1:
            kv = comm.rotate(kv)
    acc, _, l = state_ml
    out_pad = (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype)
    out = core_permute.ungather_padded(out_pad, qmaps["pos"]).reshape(B, H, Sl, D)
    new_state = dataclasses.replace(state, q_centroids=qcent.to(state.q_centroids.dtype),
                                    k_centroids=kcent.to(state.k_centroids.dtype), initialized=True,
                                    last_density=density.reshape(BH).float())
    return out, new_state
