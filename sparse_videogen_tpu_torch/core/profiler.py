"""SVG1 online profiler: per-head spatial/temporal mask selection
(counterpart of sparse_videogen_tpu/core/profiler.py).

The sampled query rows are an argument: the runtime draws them from a
torch.Generator (sample_rows), and a test can hand in the rows JAX drew.
"""

from __future__ import annotations

from typing import Sequence

import torch


def sample_rows(seq_len: int, *, num_sampled_rows: int, sample_mse_max_row: int, generator, device):
    """Uniform rows in [0, min(sample_mse_max_row, S)), int64 on `device`."""
    n_rows = min(num_sampled_rows, seq_len)
    max_row = min(sample_mse_max_row, seq_len)
    return torch.randint(0, max_row, (n_rows,), generator=generator, device=device)


def sample_mse(q, k, v, mask_preds: Sequence, rows):
    """Per-head MSE of each candidate mask against exact attention on the
    sampled rows. q, k, v (B, H, S, D); rows (R,) int. Returns
    (num_masks, B, H) f32."""
    S, D = q.shape[2], q.shape[3]
    rows = rows.to(q.device)
    q_s = q[:, :, rows].float()
    scores = (q_s @ k.float().transpose(-1, -2)) * (D**-0.5)
    # masked softmaxes are renormalisations of the one unmasked softmax
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    golden = (p.to(v.dtype) @ v).float() / p.sum(-1, keepdim=True)
    k_idx = torch.arange(S, device=q.device)[None, :]
    q_idx = rows[:, None]
    mses = []
    for pred in mask_preds:
        pm = torch.where(pred(q_idx, k_idx)[None, None], p, 0.0)
        out = (pm.to(v.dtype) @ v).float() / pm.sum(-1, keepdim=True).clamp_min(1e-20)
        mses.append(((out - golden) ** 2).mean(dim=(2, 3)))
    return torch.stack(mses)


def best_mask_idx(mses):
    """argmin over masks (first on ties) -> (B, H) int32; 0 spatial, 1 temporal."""
    return torch.argmin(mses, dim=0).to(torch.int32)
