"""ASCII picture of block-sparse metadata (counterpart of
sparse_videogen_tpu/utils/visualize.py, after the reference's
visualize_sparse_bsr), on the port's chunked-CSR metadata."""

from __future__ import annotations

import numpy as np

from sparse_videogen_tpu_torch.ops.metadata import SUB, decode_meta


def visualize_meta(meta, *, block_kv: int, seq_kv: int, row: int = 0, max_cells: int = 64) -> str:
    """One metadata row set (index `row`) as a grid of q blocks x 128-token
    kv sub-blocks: '#' all live, '+' some, '.' none; then the block density."""
    if hasattr(meta, "detach"):
        meta = meta.detach().cpu().numpy()
    mask = decode_meta(np.asarray(meta), block_kv=block_kv, seq_kv=seq_kv)[row]
    nQ, S = mask.shape
    nsub = S // SUB
    grid = mask.reshape(nQ, nsub, SUB).any(-1)
    qs = max(1, nQ // max_cells)
    ks = max(1, nsub // max_cells)
    lines = []
    for i in range(0, nQ, qs):
        cells = grid[i: i + qs]
        lines.append("".join("#" if cells[:, j: j + ks].all() else ("+" if cells[:, j: j + ks].any() else ".")
                             for j in range(0, nsub, ks)))
    lines.append(f"block density: {grid.mean():.3f} ({nQ} q-rows x {nsub} kv-subblocks)")
    return "\n".join(lines)
