"""qk_ms (ms a step): device time of the program's "model.qk" regions
(utils/timer.py's CUDA events around the q/k RMSNorm, RoPE and
HunyuanVideo's [video | text] joins of q, k and v) recorded while the
window's profiler ran, over the window's steps."""

from svgbench.program_spans import region_ms


def read(t):
    return region_ms(t, "model.qk")
