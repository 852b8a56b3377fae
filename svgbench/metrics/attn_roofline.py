"""attn_roofline (%): the self-attention's bound time over the device time
of the attention kernels launched in the runtime's call. The bound is the
larger of the step's attention FLOPs (4 D a pair the pattern allows) over
the bf16 peak and its bytes (q, k, v read and o written once) over the HBM
peak; the same work whatever kernel computes it."""


def read(t):
    ops = [o for o in t.in_span("runtime") if t.matches(o, "attention")]
    if not ops or t.steps == 0:
        return None
    bound = max(t.counts["attn_flops"] / t.peaks["bf16_flops"], t.counts["attn_bytes"] / t.peaks["hbm_bytes_s"])
    return 100.0 * bound * t.steps / sum(o.seconds for o in ops)
