"""The benchmark's count of a SAP step's work (the yardstick of step_mfu,
attn_roofline and kmeans_roofline in a SAP cell), as svgbench/flops.py
counts the other patterns: padding is never counted, and work that depends
on the inputs is counted as these inputs needed it.

- Self-attention: 4 D a (query, key) pair that the map allows. The pairs
  are the program's `sap.pairs` counter (the map's cluster pairs times
  their sizes, summed over layers, heads and streams) over the window's
  steps; a dense warm-up layer counts every pair. The bytes: q, k, v read
  and o written once, bf16, as for the other patterns.
- K5, a Lloyd pass of k-means over N tokens, K centroids of width D, per
  head: 2 N K D FLOPs (the distances' products) and its bytes, the tokens
  and centroids read once (bf16), the labels written (int32), the f32 sums
  and counts written. The passes are the program's `sap.lloyd.<K>`
  counters over the window's steps.
"""

from __future__ import annotations

from svgbench.flops import BF16, dense_pairs


def kmeans_pass(n: int, k: int, d: int, heads: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one Lloyd pass of `heads` problems."""
    return 2 * n * k * d * heads, heads * (n * d * BF16 + k * d * BF16 + 4 * n + 4 * k * d + 4 * k)


def counts(dense: dict, c: dict, layout, counters: dict, steps: int, dense_layers: int) -> dict:
    """A step's work from `dense`, the family's count of the same step with
    dense self-attention (CFG pair of 2): "flops" with SAP's self-attention
    in place of the dense one, "attn_flops", "attn_bytes", and "kmeans":
    [passes a step, FLOPs a pass, bytes a pass] for each K that ran."""
    H, D = c["num_heads"], c["dim"] // c["num_heads"]
    per = 1 / steps if steps else 0.0
    pairs = counters.get("sap.pairs", 0.0) * per + dense_layers * H * 2 * dense_pairs(layout)
    attn = 4 * D * pairs
    kmeans = [[n * per, *kmeans_pass(layout.vid, int(label.rsplit(".", 1)[1]), D, H)]
              for label, n in sorted(counters.items()) if label.startswith("sap.lloyd.")]
    return {"flops": dense["flops"] - dense["attn_flops"] + attn, "attn_flops": attn,
            "attn_bytes": dense["attn_bytes"], "kmeans": kmeans}
