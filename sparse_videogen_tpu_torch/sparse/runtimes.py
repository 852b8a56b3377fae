"""Self-attention runtimes (counterpart of sparse_videogen_tpu/sparse/runtimes.py):
dense, SVG1 and SAP. The model calls one per block:

    runtime(q, k, v, t, layer_idx, rows=None, generator=None) -> out

q, k, v (B, H, S, D); t the step's timestep (0..1000); rows the profiler's
sampled query rows (drawn from `generator` when None). The metadata and the
mask scalars go to the device once, when the runtime is built. The JAX
warm-up `lax.cond` is a Python `if`.

SAP carries a k-means state per layer. JAX threads it through the forward
as an argument; here the runtime holds the states of the stream it runs
(`SAPRuntime.states`, layer -> SAPState), and the pipeline swaps in each
CFG stream's own before that stream's forward, so the call signature above
stays the same for every pattern; `SAPRuntime.carry` keeps them, on one
device and on a rank group (parallel/). `SAPRuntime.record`, set to a dict,
gets each sparse cluster-mode layer's decisions (svg2.SAPDecisions) by layer.
"""

from __future__ import annotations

import numpy as np
import torch

from sparse_videogen_tpu_torch.config import SAPConfig, WarmupSchedule
from sparse_videogen_tpu_torch.core.profiler import sample_rows
from sparse_videogen_tpu_torch.ops import metadata as MD
from sparse_videogen_tpu_torch.sparse.svg1 import SVG1Plan, dense_impl, svg1_sparse_impl, to_device_meta
from sparse_videogen_tpu_torch.sparse.svg2 import SAPState, check_sap_config, init_sap_state, sap_attention


def _classified(meta, spec, plan: SVG1Plan, prompt_length, block_q):
    """Cheap-first metadata (ops/metadata.classify_cheap_np); its aux must
    equal the runtime's aux."""
    return MD.classify_cheap_np(meta, spec, plan.default_aux(prompt_length), block_q=block_q,
                                block_kv=plan.block_kv, seq_q=plan.layout.seq_len)


class DenseRuntime:
    """prompt_length: the live prompt tokens of a text-last layout
    (HunyuanVideo) or a text-first one (CogVideoX: its 226 text tokens);
    None takes the layout's context_length."""

    def __init__(self, plan: SVG1Plan, *, device, prompt_length: int | None = None):
        self.plan = plan
        self.dense_meta = to_device_meta(
            _classified(plan.dense_meta(), plan.dense_mask_spec, plan, prompt_length, plan.dense_block_q), device)
        self.aux = torch.as_tensor(plan.default_aux(prompt_length), device=device)

    def __call__(self, q, k, v, t, layer_idx, rows=None, generator=None):
        return dense_impl(q, k, v, self.dense_meta, self.plan, self.aux)


class SVG1Runtime(DenseRuntime):
    """With plan.inplace_temporal, sparse_meta is the (2, nQ, L) dual stack,
    each half classified cheap-first under its own spec (the JAX runtime
    hands the kernel plan.sparse_meta() there, the single stack, which its
    svg1_sparse_impl then reads as the dual one: ROADMAP.md section 3);
    svg1_sparse_impl picks each head's row from the profiler's classes."""

    def __init__(self, plan: SVG1Plan, *, device, prompt_length: int | None = None):
        super().__init__(plan, device=device, prompt_length=prompt_length)
        if plan.inplace_temporal:
            dual = plan.sparse_meta_dual()
            meta = np.concatenate([_classified(dual[i:i + 1], spec, plan, prompt_length, plan.block_q)
                                   for i, spec in enumerate(plan.mask_spec_dual)])
        else:
            meta = _classified(plan.sparse_meta(), plan.mask_spec, plan, prompt_length, plan.block_q)
        self.sparse_meta = to_device_meta(meta, device)

    def is_dense(self, layer_idx: int, t: float) -> bool:
        w = self.plan.warmup
        return layer_idx < w.first_layers or t > w.first_times

    def draw_rows(self, seq_len: int, generator, device):
        """The profiler's sampled query rows of one sparse layer."""
        c = self.plan.cfg
        return sample_rows(seq_len, num_sampled_rows=c.num_sampled_rows, sample_mse_max_row=c.sample_mse_max_row,
                           generator=generator, device=device)

    def __call__(self, q, k, v, t, layer_idx, rows=None, generator=None):
        if self.is_dense(layer_idx, t):
            return dense_impl(q, k, v, self.dense_meta, self.plan, self.aux)
        if rows is None:
            rows = self.draw_rows(q.shape[2], generator, q.device)
        return svg1_sparse_impl(q, k, v, rows, self.sparse_meta, self.plan, self.aux)


class SAPRuntime(DenseRuntime):
    """SAP (SVG2, cluster or tile mode) with the dense warm-up of the plan's
    dense metadata. `states` maps a layer to its SAPState (a missing layer
    starts cold); `kmeans_init`, when set, maps a layer to the (q, k)
    cold-start token indices for the next forward (tests hand in the JAX
    package's draws); otherwise they are drawn from the forward's generator.
    `record`: None, or a dict that each sparse layer's call fills with its
    decisions (layer -> svg2.SAPDecisions, on the device) until it is set
    back to None; a benchmark's judge reads them.
    On a text-last layout (HunyuanVideo) the warm-up runs the plan's
    `hyvideo` kind with aux[0] = video_length + context_length, as the JAX
    package's SAPRuntime does (its prompt_length is None), so the warm-up
    also attends the text padding. A text-first layout (CogVideoX) raises
    NotImplementedError (svg2.check_sap_config)."""

    def __init__(self, plan: SVG1Plan, cfg: SAPConfig, warmup: WarmupSchedule, *, device):
        check_sap_config(cfg, plan.layout)
        super().__init__(plan, device=device)
        self.cfg = cfg
        self.warmup = warmup
        self.states: dict[int, SAPState] = {}
        self.kmeans_init = None
        self.record: dict | None = None

    def is_dense(self, layer_idx: int, t: float) -> bool:
        return layer_idx < self.warmup.first_layers or t > self.warmup.first_times

    def attend(self, q, k, v, t, layer_idx, state: SAPState, init_idx=None, keep=None):
        """One layer from `state`, without touching `states`: returns (out,
        new_state). `keep` goes to svg2.sap_attention."""
        return sap_attention(
            q, k, v, t, state, layout=self.plan.layout, cfg=self.cfg, warmup=self.warmup, layer_idx=layer_idx,
            dense_fn=lambda q_, k_, v_: dense_impl(q_, k_, v_, self.dense_meta, self.plan, self.aux),
            init_idx=init_idx, keep=keep)

    def clusters(self, layer_idx: int, t: float) -> bool:
        """Whether this call runs k-means (and so draws a cold start)."""
        if self.is_dense(layer_idx, t):
            return self.cfg.zero_step_kmeans_init
        return not (self.cfg.block_mode == "tile" and self.cfg.tile_order == "pc1")

    def carry(self, q, t, layer_idx, generator, rows: int, step):
        """A layer's carry: step(state, init_idx) -> (out, new_state) from its
        state, the new state kept. A call that clusters an uninitialised layer
        gets the cold start (q (rows, QC), k (rows, KC)) video-token indices
        from kmeans_init[layer], else drawn q then k as svg2.sap_cluster draws."""
        B, H, _, D = q.shape
        state = self.states.get(layer_idx)
        if state is None:
            state = init_sap_state(B * H, D, self.cfg, device=q.device)
        init_idx = None
        if not state.initialized and self.clusters(layer_idx, t):
            init_idx = self.kmeans_init[layer_idx] if self.kmeans_init is not None else tuple(
                torch.randint(0, self.plan.layout.video_length, (rows, c), generator=generator, device=q.device)
                for c in (self.cfg.num_q_centroids, self.cfg.num_k_centroids))
        out, self.states[layer_idx] = step(state, init_idx)
        return out

    def __call__(self, q, k, v, t, layer_idx, rows=None, generator=None):
        keep = None if self.record is None else []
        out = self.carry(q, t, layer_idx, generator, q.shape[0] * q.shape[1],
                         lambda state, init_idx: self.attend(q, k, v, t, layer_idx, state, init_idx, keep))
        if keep:
            self.record[layer_idx] = keep[0]
        return out
