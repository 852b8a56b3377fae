"""The reference's self-attention inside the judged forward (`Judge`), and the
control's (`Lowp`), for one batch item.

The program's SVG1 decisions are its own: the reference reads them from
what the program produced and judges them, as one judges a served model's
tokens. At the compared step the benchmark kept, for every layer, the
program's attention output on the sampled query rows R that it handed the
program's profiler. For each head the reference computes the rows R under
the spatial and the temporal execution mask and takes as the program's
class the one whose rows lie closer to the program's. Then:
- `class_gap`: how far the reference's profiling error of that class lies
  above its best class's, as a share of the best (0 where they agree);
- `rows_rel`: the relative L2 gap between the program's rows and the
  reference's rows of that class;
and the reference goes on with that class for the head. Dense layers are
compared on the same rows.
"""

from __future__ import annotations

import torch

from svgbench.reference import svg1 as S
from svgbench.reference.common import attention


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _by_class(q, k, v, cls, layout, width, prec):
    o = torch.empty_like(q)
    for temporal in (False, True):
        hs = (cls == int(temporal)).nonzero().flatten()
        if len(hs):
            o[hs] = S.attend(q[hs], k[hs], v[hs], layout, width, temporal, prec)
    return o


class Judge:
    def __init__(self, pattern: str, layout: S.Layout, width: float, multiplier: float, dense_layers: int,
                 rows: torch.Tensor, program_rows: list):
        """rows (L, R): the sampled rows of each layer; program_rows[l]: the
        program's output rows (H, R, D) of layer l, this batch item."""
        self.pattern, self.layout, self.width, self.mult = pattern, layout, width, multiplier
        self.dense_layers, self.rows, self.program_rows = dense_layers, rows, program_rows
        self.rows_rel: list[float] = []
        self.class_gap: list[float] = []
        self.temporal_heads = 0

    def __call__(self, li, q, k, v):
        rows = self.rows[li]
        prog = self.program_rows[li].float()
        if self.pattern == "dense" or li < self.dense_layers:
            o = attention(q, k, v)
            self.rows_rel.append(_rel(prog, o[:, rows]))
            return o
        mse = S.profile_mse(q, k, v, rows, self.layout, self.mult)
        cand = torch.stack([attention(q[:, rows], k, v, S.exec_allow(self.layout, self.width, t), rows=rows)
                            for t in (False, True)])  # (2, H, R, D)
        cls = ((prog[None] - cand) ** 2).sum(dim=(2, 3)).argmin(0)  # (H,)
        best = mse.min(0).values.clamp_min(1e-30)
        self.class_gap.append(float(((mse.gather(0, cls[None])[0] - best) / best).max()))
        ref_rows = cand.gather(0, cls[None, :, None, None].expand(1, *cand.shape[1:]))[0]
        self.rows_rel.append(_rel(prog, ref_rows))
        self.temporal_heads += int(cls.sum())
        return _by_class(q, k, v, cls, self.layout, self.width, "f32")


class Lowp:
    """The control: the pattern computed in `prec`, deciding its own SVG1
    classes from its own profiling error, keeping its rows as the program's."""

    def __init__(self, pattern: str, layout: S.Layout, width: float, multiplier: float, dense_layers: int,
                 rows: torch.Tensor, prec: str):
        self.pattern, self.layout, self.width, self.mult = pattern, layout, width, multiplier
        self.dense_layers, self.rows, self.prec = dense_layers, rows, prec
        self.out_rows: list = []

    def __call__(self, li, q, k, v):
        rows = self.rows[li]
        if self.pattern == "dense" or li < self.dense_layers:
            o = attention(q, k, v, None, self.prec)
        else:
            cls = S.profile_mse(q, k, v, rows, self.layout, self.mult, self.prec).argmin(0)
            o = _by_class(q, k, v, cls, self.layout, self.width, self.prec)
        self.out_rows.append(o[:, rows].clone())
        return o
