"""glue_ms (ms a step): device time of the operations launched inside the
model's forward but outside the attention runtime's call, other than the
cuBLAS matrix products (kernels/gemm.json): the f32 elementwise glue,
norms, RoPE, modulation, softmax of the cross-attention, and copies."""


def read(t):
    ops = [o for o in t.in_span("forward") if not t.matches(o, "gemm")]
    if not ops or t.steps == 0:
        return None
    return 1e3 * sum(o.seconds for o in ops) / t.steps
