"""SVG1: online profiling -> placement -> static block-sparse attention
(counterpart of sparse_videogen_tpu/sparse/svg1.py).

Two ways to run the temporal heads: placement (the default) transposes their
q, k, v to token-major order, runs the one band+sink mask over every head
and transposes the output back; placement-free (`inplace_temporal`, video
only) leaves every head in place and runs the dual per-head spec, band_sink
for the spatial heads and band_sink_perm (the band at permuted positions)
for the temporal ones, on a per-head metadata row taken from the dual stack
(`sparse_meta_dual`).

The plan is static per (layout, config): it builds the numpy metadata once;
the runtimes (sparse/runtimes.py) copy it to the device. The layout fixes
the mask family (`mask_kind`): "band_sink" for a video-only sequence (Wan),
"hyvideo" for text last (HunyuanVideo: the real/fake split of the text
tokens, with the real length video_len + prompt_length in aux[0]), "cog"
for text first (CogVideoX: text rows and columns [0, prompt_length) fully
attended, prompt_length in aux[0]).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from sparse_videogen_tpu_torch.config import SVGConfig, TextPosition, VideoLayout, WarmupSchedule
from sparse_videogen_tpu_torch.core import masks as core_masks
from sparse_videogen_tpu_torch.core.placement import place_heads
from sparse_videogen_tpu_torch.core.profiler import best_mask_idx, sample_mse
from sparse_videogen_tpu_torch.ops import metadata as MD
from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_kv, dual_rows
from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec
from sparse_videogen_tpu_torch.utils.timer import time_logging


@dataclasses.dataclass(frozen=True)
class SVG1Plan:
    layout: VideoLayout
    cfg: SVGConfig
    warmup: WarmupSchedule
    multiplier: float
    block_q: int
    block_kv: int
    inplace_temporal: bool = False

    def __post_init__(self):
        object.__setattr__(self, "_cache", {})

    @property
    def mask_kind(self) -> str:
        """band_sink (video only), hyvideo (text last) or cog (text first)."""
        return _MASK_KINDS[self.layout.text_position]

    @property
    def seq_pad_q(self) -> int:
        return -(-self.layout.seq_len // self.block_q) * self.block_q

    @property
    def seq_pad_kv(self) -> int:
        s = -(-self.layout.seq_len // MD.SUB) * MD.SUB
        return max(s, self.block_kv)

    @property
    def dense_block_q(self) -> int:
        """block_q of the dense path (JAX's dense_exec[0]): up to 2048 for
        unmasked dense attention over long sequences, else block_q (also for
        the masked dense of a text-last layout; a text-first layout's dense
        spec is unmasked)."""
        if self.dense_mask_spec.kind == "none" and self.seq_pad_kv >= 2048:
            return min(2048, -(-self.layout.seq_len // 128) * 128)
        return self.block_q

    @property
    def mask_spec(self) -> MaskSpec:
        lay = self.layout
        if self.mask_kind == "hyvideo":
            # floor-rounded, strict < (the reference's HunyuanVideo mask)
            w = math.floor(self.multiplier * lay.frame_size / 128) * 128
            return MaskSpec(kind="hyvideo", band_width=w, video_len=lay.video_length)
        if self.mask_kind == "cog":
            return MaskSpec(kind="cog", band_width=math.floor(self.multiplier * lay.frame_size / 128) * 128)
        # reference band is |q-kv| <= w (ceil-rounded); the predicate is strict <
        w = math.ceil(self.multiplier * lay.frame_size / 128) * 128
        return MaskSpec(kind="band_sink", band_width=w + 1, sink_size=lay.frame_size)

    @property
    def mask_spec_dual(self) -> tuple[MaskSpec, MaskSpec]:
        """(spatial band_sink, temporal band_sink_perm) of the in-place mode."""
        lay = self.layout
        w = math.ceil(self.multiplier * lay.frame_size / 128) * 128
        spatial = MaskSpec(kind="band_sink", band_width=w + 1, sink_size=lay.frame_size)
        temporal = MaskSpec(kind="band_sink_perm", band_width=w + 1, sink_size=lay.frame_size,
                            frame_size=lay.frame_size, num_frames=lay.num_frames)
        return spatial, temporal

    @property
    def dense_mask_spec(self) -> MaskSpec:
        """Dense attention of a text-last layout keeps the real/fake split
        (the reference runs varlen attention over the real tokens): a band
        wider than any sequence lets every real pair attend. Video only and
        text first: unmasked."""
        if self.mask_kind == "hyvideo":
            return MaskSpec(kind="hyvideo", band_width=1 << 24, video_len=self.layout.video_length)
        return MaskSpec()

    def default_aux(self, prompt_length: int | None = None) -> np.ndarray:
        """(4,) int32 mask scalars. hyvideo: aux[0] = video_len +
        prompt_length (the real tokens); cog: aux[0] = prompt_length; the
        layout's context_length when prompt_length is None. aux[2:4] are the
        global q/k offsets, 0 for an unsharded sequence."""
        aux = np.zeros((4,), np.int32)
        lay = self.layout
        pl = lay.context_length if prompt_length is None else prompt_length
        if self.mask_kind == "hyvideo":
            aux[0] = lay.video_length + pl
        elif self.mask_kind == "cog":
            aux[0] = pl
        return aux

    def _build(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    def sparse_meta(self) -> np.ndarray:
        def build():
            lay = self.layout
            nsub = self.seq_pad_kv // MD.SUB
            bm = core_masks.execution_mask_block(
                lay, self.multiplier, block_q=self.block_q, block_kv=MD.SUB)
            bm = np.pad(bm, ((0, self.seq_pad_q // self.block_q - bm.shape[0]), (0, nsub - bm.shape[1])))
            counts = MD.kv_counts_for_seq(lay.seq_len, self.seq_pad_kv)
            return MD.chunk_meta_np(bm[None], counts, block_kv=self.block_kv)

        return self._build("sparse_meta", build)

    def sparse_meta_dual(self) -> np.ndarray:
        """(2, nQ, L) int32: the spatial heads' metadata (the band+sink
        skeleton) and the temporal heads' (execution_mask_block_perm), padded
        to one row length, for the per-head select of the in-place mode."""
        def build():
            if self.mask_kind != "band_sink":
                raise ValueError(f"inplace_temporal needs a video-only layout, got mask kind {self.mask_kind}")
            lay = self.layout
            nsub = self.seq_pad_kv // MD.SUB
            nq_pad = self.seq_pad_q // self.block_q
            counts = MD.kv_counts_for_seq(lay.seq_len, self.seq_pad_kv)
            metas = []
            for fn in (core_masks.execution_mask_block, core_masks.execution_mask_block_perm):
                bm = fn(lay, self.multiplier, block_q=self.block_q, block_kv=MD.SUB)
                bm = np.pad(bm, ((0, nq_pad - bm.shape[0]), (0, nsub - bm.shape[1])))
                metas.append(MD.chunk_meta_np(bm[None], counts, block_kv=self.block_kv))
            L = max(m.shape[-1] for m in metas)
            return np.concatenate([np.pad(m, ((0, 0), (0, 0), (0, L - m.shape[-1]))) for m in metas])

        return self._build("sparse_meta_dual", build)

    def dense_meta(self) -> np.ndarray:
        def build():
            counts = MD.kv_counts_for_seq(self.layout.seq_len, self.seq_pad_kv)
            nsub = self.seq_pad_kv // MD.SUB
            nq = -(-self.layout.seq_len // self.dense_block_q)
            bm = np.ones((1, nq, nsub), bool)
            return MD.chunk_meta_np(bm, counts, block_kv=self.block_kv)

        return self._build("dense_meta", build)

    def profile_preds(self):
        def build():
            return tuple(core_masks.profile_mask_predicate(self.layout, name, self.cfg.profile_multiplier)
                         for name in ("spatial", "temporal"))

        return self._build("preds", build)


_MASK_KINDS = {TextPosition.NONE: "band_sink", TextPosition.LAST: "hyvideo", TextPosition.FIRST: "cog"}


def make_svg1_plan(
    layout: VideoLayout,
    cfg: SVGConfig = SVGConfig(),
    warmup: WarmupSchedule = WarmupSchedule(),
    *,
    block_q: int | None = None,
    block_kv: int = 1024,
    inplace_temporal: bool = False,
) -> SVG1Plan:
    """The plan of a video-only (Wan: band_sink), text-last (HunyuanVideo:
    hyvideo) or text-first (CogVideoX: cog) layout. block_q defaults to
    1024 at S >= 8192, else 512; block_q and block_kv are clamped to the
    128-padded sequence length. inplace_temporal (video only) runs the
    temporal heads without placement."""
    s_pad = -(-layout.seq_len // 128) * 128
    if block_q is None:
        block_q = 1024 if layout.seq_len >= 8192 else 512
    block_kv = min(block_kv, s_pad)
    block_q = min(block_q, s_pad)
    mul = core_masks.sparsity_to_width(cfg.sparsity, layout.context_length, layout.num_frames, layout.frame_size)
    if inplace_temporal and _MASK_KINDS[layout.text_position] != "band_sink":
        raise ValueError("inplace_temporal runs video-only layouts (mask kind band_sink)")
    return SVG1Plan(layout, cfg, warmup, mul, block_q, block_kv, inplace_temporal)


def _pad_seq(x, s_pad):
    return F.pad(x, (0, 0, 0, s_pad - x.shape[2]))


def _run_kernel(q, k, v, meta, plan: SVG1Plan, mask_spec, aux, *, block_q: int):
    """(B, H, S, D) -> pad q to block_q and k/v to seq_pad_kv, flatten heads,
    run the block-sparse attention, slice the padding off."""
    B, H, S, D = q.shape
    sq_pad = -(-S // block_q) * block_q
    with time_logging("attn.pad"):
        qf = _pad_seq(q, sq_pad).reshape(B * H, sq_pad, D).contiguous()
        kf = _pad_seq(k, plan.seq_pad_kv).reshape(B * H, plan.seq_pad_kv, D).contiguous()
        vf = _pad_seq(v, plan.seq_pad_kv).reshape(B * H, plan.seq_pad_kv, D).contiguous()
    out = block_sparse_attention_kv(qf, kf, vf, meta, aux, block_q=block_q, block_kv=plan.block_kv,
                                    mask_spec=mask_spec)
    with time_logging("attn.pad"):
        return out[:, :S].reshape(B, H, S, D)


def _place(x, is_t, layout: VideoLayout, inverse: bool = False):
    with time_logging("svg1.place"):
        return place_heads(x, is_t, layout, inverse=inverse)


def svg1_sparse_impl(q, k, v, rows, meta, plan: SVG1Plan, aux=None):
    """Profile the sampled `rows`, re-lay-out the temporal heads, run the
    shared sparse attention (band+sink, hyvideo or cog), restore the original
    order. With plan.inplace_temporal, meta is the (2, nQ, L) dual stack
    (sparse_meta_dual): every head stays in place and takes its class's
    metadata row and mask (the dual spec, aux[4 + bh] its class)."""
    with time_logging("svg1.profile"):
        mses = sample_mse(q, k, v, plan.profile_preds(), rows)
        best = best_mask_idx(mses)  # (B, H): 0 spatial, 1 temporal
        is_t = best == 1
    if plan.inplace_temporal:
        with time_logging("svg1.place"):
            meta_bh, aux_bh = dual_rows(meta, best.reshape(-1).to(torch.int32), plan.mask_spec_dual[1],
                                        plan.block_q, aux)
        return _run_kernel(q, k, v, meta_bh, plan, plan.mask_spec_dual, aux_bh, block_q=plan.block_q)
    o = _run_kernel(_place(q, is_t, plan.layout), _place(k, is_t, plan.layout), _place(v, is_t, plan.layout),
                    meta, plan, plan.mask_spec, aux, block_q=plan.block_q)
    return _place(o, is_t, plan.layout, inverse=True)


def dense_impl(q, k, v, meta, plan: SVG1Plan, aux=None):
    """Dense attention through the same kernel (full metadata)."""
    return _run_kernel(q, k, v, meta, plan, plan.dense_mask_spec, aux, block_q=plan.dense_block_q)


def to_device_meta(meta: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(meta, np.int32), device=device)
