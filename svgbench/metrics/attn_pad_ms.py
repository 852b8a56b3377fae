"""attn_pad_ms (ms a step): device time of the program's "attn.pad" regions
(utils/timer.py's CUDA events around the attention's padding: q, k and v
padded, flattened to heads and made contiguous, and the output sliced back)
recorded while the window's profiler ran, over the window's steps."""

from svgbench.program_spans import region_ms


def read(t):
    return region_ms(t, "attn.pad")
