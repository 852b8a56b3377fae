"""residual_ms (ms a step): device time of the program's "model.residual"
regions (utils/timer.py's CUDA events around the model's gated residual adds
and their casts) recorded while the window's profiler ran, over the window's
steps."""

from svgbench.program_spans import region_ms


def read(t):
    return region_ms(t, "model.residual")
