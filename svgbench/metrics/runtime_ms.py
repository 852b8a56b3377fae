"""runtime_ms (ms a step): device time of the operations launched inside
the attention runtime's call other than the attention kernels
(kernels/*.json of role attention): SVG1's profiler and placement, SAP's
k-means, maps and permutes, and every runtime's padding and copies."""


def read(t):
    ops = [o for o in t.in_span("runtime") if not t.matches(o, "attention")]
    if t.steps == 0 or not t.in_span("runtime"):
        return None
    return 1e3 * sum(o.seconds for o in ops) / t.steps
