"""SVG1 (Sparse VideoGen, Xi et al. 2025) from its description, in plain
PyTorch: each head is profiled on sampled query rows against a spatial and
a temporal mask and then attends under the execution mask of its class.

Layout: `nf` latent frames of `fs` tokens, then `text` text tokens of which
the first `prompt` are live (HunyuanVideo; none for Wan). Token x < nf*fs is
frame x // fs, slot x % fs. A temporal head sees the video tokens in
token-major order, position p(x) = (x % fs) * nf + x // fs; text keeps its
place. The execution mask is a band on those positions:
- video only (Wan): |q - k| <= W with W = width * fs rounded UP to 128, or k
  in the first fs positions (the sink);
- text last (HunyuanVideo): |q - k| < W with W rounded DOWN to 128, or a
  text row or column, among the live tokens; the padding text tokens attend
  only each other.
`width` is the band in frames that gives the sparsity (`band_frames`). The
profiling masks are bands of 128-token blocks, |q // 128 - k // 128| <
floor(profile_multiplier * fs) // 128, with the sink (video only) or the
text (text last).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from svgbench.reference.common import attention


@dataclasses.dataclass(frozen=True)
class Layout:
    nf: int
    fs: int
    text: int = 0  # text tokens after the video
    prompt: int = 0  # live text tokens

    @property
    def vid(self) -> int:
        return self.nf * self.fs

    @property
    def seq(self) -> int:
        return self.vid + self.text


def band_frames(sparsity: float, layout: Layout) -> float:
    """The band (in frames) whose mask keeps `sparsity` of all pairs,
    counting the text rows and columns as kept."""
    total = layout.seq**2
    adj = (sparsity * total - 2 * layout.seq * layout.text) / total
    return layout.seq * (1 - math.sqrt(1 - adj)) / layout.fs


def perm(x, layout: Layout):
    """Token-major position of x (video tokens); text unchanged."""
    v = (x % layout.fs) * layout.nf + x // layout.fs
    return torch.where(x < layout.vid, v, x)


def exec_allow(layout: Layout, width: float, temporal: bool):
    """allow(q, k) of the execution mask (q, k original positions)."""
    fs, vid = layout.fs, layout.vid
    if layout.text == 0:
        w = math.ceil(width * fs / 128) * 128

        def allow(q, k):
            if temporal:
                q, k = perm(q, layout), perm(k, layout)
            return ((q - k).abs() <= w) | (k < fs)
        return allow
    w = math.floor(width * fs / 128) * 128
    real = vid + layout.prompt

    def allow(q, k):
        if temporal:
            q, k = perm(q, layout), perm(k, layout)
        band = (q - k).abs() < w
        q_real, k_real = q < real, k < real
        text_col = (k >= vid) & k_real
        text_row = (q >= vid) & q_real
        return (q_real & k_real & (band | text_col | text_row)) | (~q_real & ~k_real)
    return allow


def band_keys(layout: Layout, width: float):
    """keys(q_pos) for `attention`: the key positions the execution mask can
    allow a block of queries in the order where its band is contiguous: the
    band around the block, the sink (video only) or the text columns (text
    last); a block that holds a text row takes every key."""
    fs, vid, S = layout.fs, layout.vid, layout.seq
    w = math.ceil(width * fs / 128) * 128 + 1 if layout.text == 0 else math.floor(width * fs / 128) * 128
    extra = slice(0, fs) if layout.text == 0 else slice(vid, S)

    def keys(qpos):
        lo, hi = int(qpos.min()), int(qpos.max())
        if layout.text and hi >= vid:
            return torch.arange(S, device=qpos.device)
        sel = torch.zeros(S, dtype=torch.bool, device=qpos.device)
        sel[max(0, lo - w):hi + w + 1] = True
        sel[extra] = True
        return sel.nonzero().flatten()
    return keys


def attend(q, k, v, layout: Layout, width: float, temporal: bool, prec: str = "f32"):
    """Heads of one class (q, k, v (h, S, D) f32) under the execution mask:
    a temporal head's tokens are laid out token-major first, so that its
    band is contiguous, and back after; only the keys the mask can allow
    are scored (`band_keys`)."""
    x = torch.arange(layout.seq, device=q.device)
    if temporal:
        p = perm(x, layout)
        inv = torch.empty_like(x)
        inv[p] = x
        q, k, v = q[:, inv], k[:, inv], v[:, inv]
    o = attention(q, k, v, exec_allow(layout, width, False), prec, keys=band_keys(layout, width))
    return o[:, p] if temporal else o


def profile_allow(layout: Layout, multiplier: float, temporal: bool, block: int = 128):
    fs, nf, vid = layout.fs, layout.nf, layout.vid
    thres = int(multiplier * fs) // block

    def allow(q, k):
        qv, kv = q, k
        if temporal:
            qv = (qv % fs) * nf + qv // fs
            kv = (kv % fs) * nf + kv // fs
        m = (qv // block - kv // block).abs() < thres
        if layout.text:
            return m | (q >= vid) | (k >= vid)
        return m | (kv < fs)
    return allow


def profile_mse(q, k, v, rows, layout: Layout, multiplier: float, prec: str = "f32"):
    """(2, H) f32: per head, the mean squared error on `rows` of the spatial
    and the temporal profiling mask against unmasked attention; q, k, v
    (H, S, D) f32."""
    golden = attention(q[:, rows], k, v, None, prec, rows=rows)
    out = []
    for temporal in (False, True):
        o = attention(q[:, rows], k, v, profile_allow(layout, multiplier, temporal), prec, rows=rows)
        out.append(((o - golden) ** 2).mean(dim=(1, 2)))
    return torch.stack(out)
