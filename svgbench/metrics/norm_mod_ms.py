"""norm_mod_ms (ms a step): device time of the program's "model.norm" regions
(utils/timer.py's CUDA events around the model's f32 LayerNorms, their AdaLN
modulation and the cast back) recorded while the window's profiler ran, over
the window's steps."""

from svgbench.program_spans import region_ms


def read(t):
    return region_ms(t, "model.norm")
