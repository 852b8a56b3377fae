"""kmeans_roofline (%): K5's share of its roofline. Each Lloyd pass's bound
is the larger of its FLOPs (2 N K D a head) over the bf16 peak and its
bytes over the HBM peak (svgbench/flops_sap.py); the passes a step are the
program's "sap.lloyd.<K>" counters. Over the device time of K5's kernels
(csrc/kmeans_lloyd.cu, kmeans_*_kernel) launched in the runtime's call."""

K5 = ("kmeans_csq_kernel", "kmeans_assign_kernel", "kmeans_scan_kernel", "kmeans_scatter_kernel",
      "kmeans_count_kernel", "kmeans_segsum_kernel", "kmeans_combine_kernel")


def read(t):
    passes = t.counts.get("kmeans")
    ops = [o for o in t.in_span("runtime") if any(k in o.name for k in K5)]
    if not passes or not ops or t.steps == 0:
        return None
    bound = sum(n * max(f / t.peaks["bf16_flops"], b / t.peaks["hbm_bytes_s"]) for n, f, b in passes)
    return 100.0 * bound * t.steps / sum(o.seconds for o in ops)
