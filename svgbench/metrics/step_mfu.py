"""step_mfu (%): the step's model FLOPs by the benchmark's count
(svgbench/flops.py: linears, the attention pairs the pattern allows,
padding never counted) over the traced run's seconds per step times the
card's published bf16 dense peak."""


def read(t):
    if t.steps == 0:
        return None
    return 100.0 * t.counts["flops"] / (t.step_s * t.peaks["bf16_flops"])
